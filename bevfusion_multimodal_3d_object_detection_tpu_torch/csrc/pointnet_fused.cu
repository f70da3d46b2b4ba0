// Fused PointNet for Hopper (sm_90a): the whole shared-MLP chain plus the
// global max over points, in one pass over the point buffer.
//
// Replaces the TPU kernel `fused_pointnet` (body `_kernel`) of
// bevfusion_multimodal_3d_object_detection_tpu/ops/pointnet_pallas.py:71-183.
// Same function: (B, N, C_in) points -> (B, feat) f32. Every layer is
// Dense + ReLU with inference BatchNorm already folded into the weights,
// accumulated in f32 with an f32 bias and cast to the working type (bf16 or
// f32) before the next layer; the last layer too, before the max. The max
// runs over exactly the N points given: rows this kernel adds for its own
// tiling never take part (the TPU wrapper pads N with zero rows that do, when
// mask_padding is off). With mask_padding, all-zero input rows are excluded
// and a row whose points are all masked gives 0.
//
// Bound on an H100: at the LiDAR shape (35,000 points, 4->64->128->256->
// 512->1024) the chain is ~48.8 GFLOP per sample against ~0.3 MB of input,
// so it is bound by operations (8 samples in bf16 need >= ~0.39 ms at
// 989 TFLOP/s dense; one sample in f32 >= ~0.73 ms at 67 TFLOP/s, the FP32
// rate outside the tensor cores). The radar shape (125 points, 7->32->64->
// 128->256) is ~54 MFLOP per sample and bound by launch latency.
//
// Design, both working types:
// - grid (tiles of P points, batch rows); one CTA of 8 warps pushes its tile
//   through every layer with the activations in shared memory in the working
//   type, so no intermediate ever reaches device memory. Two buffers: A holds
//   the input and the outputs of layers 2, 4, ..., B those of layers 1, 3,
//   ...; each is sized at launch by the widest layer it holds;
// - the last layer's output is never stored: each column is max-reduced over
//   the tile (in registers, then across lanes by shuffles, then across warps
//   in shared memory) into a (B, tiles, feat) f32 partial buffer, and a
//   second small kernel reduces over tiles (deterministic, no float atomics)
//   and maps the all-masked sentinel to 0.
//
// bf16 (128-point tiles, activations row-major):
// - layers whose widths are multiples of 16 run on the tensor cores:
//   mma.sync m16n8k16 (bf16 in, f32 accumulate), A fragments by ldmatrix from
//   the activation buffer, B fragments by ldmatrix.trans from weight slabs
//   that cp.async brings into shared memory. 8 warps as 2 (rows) x 4
//   (columns), each a 64x32 block of a 128x128 output slab. The two row warps
//   on the same 32 columns form a pair with its own ring of kStages slabs
//   (kSlabK rows of K x its 32 columns of N), synchronised by a 64-thread
//   named barrier: a pair's slabs of every tensor-core layer form one stream,
//   so its next slab, N-slab or layer is in flight while its MMAs run, and
//   the pairs never wait on each other inside a layer (one block-wide
//   barrier per slab made all 8 warps drain and refill in step). The
//   epilogue (bias, ReLU, round to bf16) runs in registers and stores
//   straight into the next activation buffer;
// - the thin first layer (C_in = 4 or 7) and any layer whose width is not a
//   multiple of 16 run as f32 FMA loops (fma_layer).
//
// f32 (exact f32: no TF32, no split products; outputs bit-identical to the
// first design's f32 path):
// - 64-point tiles where both activation buffers fit beside the weight ring
//   in 227 KB (the LiDAR chain: (512 + 256) x 64 x 4 B + a 32 KB ring + 2 KB
//   of scratch = 231,488 B), else 32 or 16 (pointnet_fused_tile_points tells
//   the caller, who sizes the partial buffer with it);
// - activations channel-major: point p of channel c at c * P + (p ^ (c & 4)).
//   A thread's points for one k are contiguous and load as float4; the XOR
//   swizzle (the two 16-byte halves of each 32-byte group swap in every
//   other group of 4 channels) spreads the rows an epilogue store phase
//   writes over distinct banks without padding, which would not leave room
//   for the ring;
// - layers with N a multiple of 4 and K of the slab's rows are register-
//   blocked (f32_block_layer): each thread computes 8 points x CT columns
//   (CT = 16 from N = 512, 8 from 256, else 4) of an N-slab of 32 CT
//   columns; per k, two LDS.128 of points and CT / 4 of weights feed 8 CT
//   FMAs (the first design: one load per FMA). The weights stream through
//   one per-CTA cp.async ring of two 16 KB slabs (32 CT columns x 128 / CT
//   rows) over every blocked layer's N-slabs, one block barrier per slab, the
//   next slab in flight while the FMAs run; each thread's chunk offsets are
//   worked out once per layer;
// - the thin first layer and ragged widths run as FMA loops with one thread
//   per point (f32_fma_layer), reading and writing the same layout;
// - every output is fmaf over k in ascending order from 0, then + bias, then
//   ReLU, as in the plain version's arithmetic (in another summation order
//   than cuBLAS's); K is never split across threads.
//
// What these designs replaced, and why (H100 80GB HBM3, 700.00 W):
// - bf16: the first design (64-point tiles, WMMA 16x16x16 with every B
//   fragment loaded straight from L2, the epilogue through an f32 staging
//   tile, the last layer's column max a 64-row serial loop per thread,
//   ~168 KB of shared memory for one CTA per SM) took 8.117 ms for the LiDAR
//   batch, 48 TFLOP/s: 4,376 CTAs each read the 1.39 MB weight chain from L2
//   (~6.1 GB) with no load in flight ahead of the MMAs that needed it, so L2
//   latency set the pace. The 128-point tile halves the weight traffic
//   (2,192 CTAs, ~3.05 GB) and the cp.async rings keep the next slabs in
//   flight: this design takes ~2.0 ms on the same card (~195 TFLOP/s; radar
//   40x125x7 ~0.023 ms of device time against 0.031). Taking the weight
//   loads out saves ~20 % and taking the MMAs out ~50 %, while a shallower
//   ring changes nothing: the pace is now set by the mma.sync issue and its
//   ldmatrix operand traffic (192 B of shared memory per MMA) with 2 warps
//   per scheduler, not by L2.
// - f32: the first design (32-point tiles, row-major activations, one output
//   column and 8 rows per thread, every weight loaded straight from L2 with
//   no load ahead) took 5.196 ms at 1x35000x4 and 17.944 ms at 4x35000x4
//   (14 % of the bound; cuBLAS's f32 matmul/relu/amax chain 1.652 and 5.985):
//   one broadcast shared-memory load per FMA held the FP32 pipe to a quarter
//   of its rate, and each of 4,376 CTAs at 4x35000 read the 2.79 MB chain
//   from L2 (~12 GB). This design takes 1.307 ms and 4.422 ms of device time
//   (37.3 and 44.1 TFLOP/s, 56 % and 66 % of the bound). Its pace is set by
//   shared memory and the wave tail, not by L2: an LDS.128 costs four
//   wavefronts of the 128 bytes a clock shared memory returns, so 8 x 4
//   blocks (3 loads per 32 FMAs) took 1.895 ms, and 1.485 ms with the FMAs
//   taken out; 8 x 16 blocks (6 loads per 128 FMAs) only paid once the
//   producer lost its integer divisions and the slabs doubled to 16 KB
//   (8 KB slabs x 3: 1.502 ms). Taking the weight loads out saves 6.5 %,
//   taking the FMAs out 31 % (0.898 ms of loads, barriers and epilogues
//   remain); an earlier variant that read 8 copies of the weights ran no
//   faster. At 1x35000 the 547 tiles are 4.14 waves of 132 SMs: 4 full waves
//   take 1.050 ms, the last 19 tiles 0.257.
// Numbers: PERF.md (chip_smoke.py phases 5 and 13f; tools/b1_ablation.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;  // masked-row sentinel (pointnet_pallas._NEG)
constexpr int kColLanes = 64;   // FMA path: columns per pass
constexpr int kRowGroups = kThreads / kColLanes;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one block may use
// tensor-core path (bf16): 4 warp pairs, each two row warps on 32 columns
constexpr int kPairs = 4;
constexpr int kPairThreads = kThreads / kPairs;
constexpr int kPairCols = 32;                 // columns of W per pair slab
constexpr int kSlabN = kPairs * kPairCols;    // output columns per N-slab
constexpr int kSlabK = 32;                    // rows of W per slab: two k16 steps
constexpr int kStages = 3;                    // depth of each pair's cp.async ring
constexpr int kSlabElems = kSlabK * kPairCols;  // 2 KB, rows of 4 swizzled 16-byte chunks
// scratch: the FMA path's per-group column maxima, or each pair's maxima of
// its two row warps
constexpr int kScratch = kRowGroups * kColLanes;
static_assert(kScratch == kPairs * 2 * kPairCols, "one scratch region serves both paths");

struct Params {
  const void* points;
  int n;
  int num_layers;
  int width[kMaxLayers + 1];  // width[0] = C_in, width[l + 1] = layer l out
  const void* w[kMaxLayers];  // (width[l], width[l + 1]) row-major
  const float* b[kMaxLayers];
  int mask_padding;
  int tiles;
  int stride_a;    // bf16: row stride (elements) of buffer A: input, layers 2, 4, ...;
                   // f32: its channels (rows of P points)
  int stride_b;    // of buffer B: layers 1, 3, ...
  float* partial;  // (batch, tiles, feat)
};

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kPoints = 128;  // the warp layout (2 x 64 rows) assumes 128
  static constexpr int kPad = 8;
};

// Buffer row stride for the widest layer it holds: padded by one 16-byte
// chunk, so 8 consecutive rows start in distinct bank groups.
template <typename T>
int padded_stride(int width) {
  constexpr int pad = Tile<T>::kPad;
  return width > 0 ? (width + pad - 1) / pad * pad + pad : 0;
}

// One layer as f32 FMA loops. Thread t owns column j0 + t % 64 and rows
// (t / 64) * R .. + R of the tile.
template <typename T, int P>
__device__ void fma_layer(const T* in, int in_stride, T* out, int out_stride, int K,
                          int N, const T* W, const float* B, bool last,
                          const unsigned char* valid, float* colred, float* part) {
  constexpr int R = P / kRowGroups;
  const int lc = threadIdx.x % kColLanes;
  const int grp = threadIdx.x / kColLanes;
  const T* a = in + grp * R * in_stride;
  for (int j0 = 0; j0 < N; j0 += kColLanes) {
    const int j = j0 + lc;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if (j < N) {
      for (int k = 0; k < K; ++k) {
        const float w = to_f(W[static_cast<size_t>(k) * N + j]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(to_f(a[r * in_stride + k]), w, acc[r]);
      }
    }
    const float bias = j < N ? B[j] : 0.f;
    if (!last) {
      if (j < N) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          out[(grp * R + r) * out_stride + j] = from_f<T>(fmaxf(acc[r] + bias, 0.f));
      }
    } else {
      float m = kNeg;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (valid[grp * R + r])
          m = fmaxf(m, to_f(from_f<T>(fmaxf(acc[r] + bias, 0.f))));
      }
      colred[grp * kColLanes + lc] = m;
      __syncthreads();
      if (grp == 0 && j < N) {
        float v = colred[lc];
        for (int g = 1; g < kRowGroups; ++g) v = fmaxf(v, colred[g * kColLanes + lc]);
        part[j] = v;
      }
      __syncthreads();
    }
  }
}

// ---- tensor-core path (bf16) ----------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and receives row l / 4, columns 2 (l % 4) + {0, 1} of each.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, transposed: lane l receives rows 2 (l % 4) + {0, 1}, column l / 4.
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool on_tensor_cores(const Params& p, int l) {
  return p.width[l] % 16 == 0 && p.width[l + 1] % 16 == 0;
}

// Synchronise the 64 threads of warp pair `pair` (barrier 0 is __syncthreads).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(pair + 1), "n"(kPairThreads) : "memory");
}

// The weight stream of one warp pair: its 32 columns of every N-slab of every
// tensor-core layer, in the order the layers consume them (layer, then
// N-slab, then k-slab); N-slabs and layers where the pair has no column are
// skipped. The producer runs kStages - 1 slabs ahead of the consumer; slab i
// lives in slot i % kStages of the pair's own ring, so the pairs never wait
// on each other inside a layer.
struct Ring {
  __nv_bfloat16* slots;  // this pair's kStages slots
  int pair;
  int layer, n0, k0;  // the producer's next slab (layer == num_layers: none)
  int produced, consumed;
};

// The first layer at or after l that runs on the tensor cores and gives
// this pair at least one column.
__device__ __forceinline__ int next_pair_layer(const Params& p, int pair, int l) {
  while (l < p.num_layers && !(on_tensor_cores(p, l) && pair * kPairCols < p.width[l + 1])) ++l;
  return l;
}

// Element (row, col) of a slot: 32 columns as four 16-byte chunks, chunk
// index XOR-swizzled by row / 2, so the 8 rows of an ldmatrix phase hit 8
// distinct bank groups without padding.
__device__ __forceinline__ int slot_index(int row, int chunk) {
  return row * kPairCols + ((chunk ^ ((row >> 1) & 3)) << 3);
}

// Issue the pair's next slab (if any) and commit one cp.async group (empty
// when the stream is done, so every step commits exactly one).
__device__ __forceinline__ void produce(const Params& p, Ring& r) {
  if (r.layer < p.num_layers) {
    const int K = p.width[r.layer], N = p.width[r.layer + 1];
    const int c0 = r.n0 + r.pair * kPairCols;          // the pair's first column
    const int rows = min(kSlabK, K - r.k0);
    const int chunks = min(kPairCols, N - c0) / 8;     // 16-byte chunks per row
    const auto* W = static_cast<const __nv_bfloat16*>(p.w[r.layer]);
    __nv_bfloat16* dst = r.slots + (r.produced % kStages) * kSlabElems;
    const int t = threadIdx.x % kPairThreads;
#pragma unroll
    for (int i = 0; i < kSlabK * (kPairCols / 8) / kPairThreads; ++i) {
      const int e = t + i * kPairThreads;
      const int row = e / (kPairCols / 8), c = e % (kPairCols / 8);
      if (row < rows && c < chunks)
        cp_async16(dst + slot_index(row, c), W + static_cast<size_t>(r.k0 + row) * N + c0 + c * 8);
    }
    ++r.produced;
    r.k0 += kSlabK;
    if (r.k0 >= K) {
      r.k0 = 0;
      r.n0 += kSlabN;
      if (r.n0 + r.pair * kPairCols >= N) {
        r.n0 = 0;
        r.layer = next_pair_layer(p, r.pair, r.layer + 1);
      }
    }
  }
  cp_async_commit();
}

// One bf16 layer on the tensor cores, over the pair's slabs from its ring.
// Warp w (pair w / 2) computes rows 64 (w % 2) .. + 64 and columns
// n0 + 32 (w / 2) .. + 32 of each N-slab.
__device__ __forceinline__ void mma_layer(const Params& p, Ring& ring, const __nv_bfloat16* in,
                                          int in_stride, __nv_bfloat16* out, int out_stride,
                                          int K, int N, const float* B, bool last,
                                          const unsigned char* valid, float* scratch,
                                          float* part) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rw = warp % 2;
  const int r0 = rw * 64;
  const int pair = ring.pair;
  const int cw = pair * kPairCols;
  const int g = lane / 4, t2 = (lane % 4) * 2;  // accumulator row and column pair
  // ldmatrix row addresses: A rows r0 + lane % 16, k + 8 (lane / 16); B
  // (slot) rows lane % 16, chunk 2 jp + lane / 16
  const __nv_bfloat16* a_base = in + (r0 + lane % 16) * in_stride + (lane / 16) * 8;
  const int b_off[2] = {slot_index(lane % 16, lane / 16), slot_index(lane % 16, 2 + lane / 16)};
  float* pair_max = scratch + pair * 2 * kPairCols;  // (2 row warps, 32 columns)

  for (int n0 = 0; n0 < N; n0 += kSlabN) {
    const int cols = min(kPairCols, N - n0 - cw);  // the pair's columns here: 16 or 32
    if (cols <= 0) continue;                       // not in the pair's stream either
    const int pairs = cols / 16;                   // 16-column pairs (1 or 2)
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kSlabK) {
      cp_async_wait<kStages - 2>();  // this thread's copies of the slab landed
      pair_sync(pair);  // the pair's did; and the slot refilled next is free
      const __nv_bfloat16* slab = ring.slots + (ring.consumed % kStages) * kSlabElems;
      ++ring.consumed;
      produce(p, ring);
#pragma unroll
      for (int kk = 0; kk < kSlabK / 16; ++kk) {
        if (k0 + 16 * kk >= K) break;
        unsigned a[4][4], b[2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ldsm_x4(a[i], a_base + 16 * i * in_stride + k0 + 16 * kk);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
          if (jp < pairs) ldsm_x4_trans(b[jp], slab + b_off[jp] + 16 * kk * kPairCols);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j / 2 >= pairs) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_bf16(acc[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);
        }
      }
    }

    if (!last) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j / 2 >= pairs) continue;
        const int col = n0 + cw + 8 * j + t2;
        const float b0 = B[col], b1 = B[col + 1];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 16 * i + 8 * h + g;
            *reinterpret_cast<__nv_bfloat162*>(out + row * out_stride + col) =
                __floats2bfloat162_rn(fmaxf(acc[i][j][2 * h] + b0, 0.f),
                                      fmaxf(acc[i][j][2 * h + 1] + b1, 0.f));
          }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float m0 = kNeg, m1 = kNeg;
        if (j / 2 < pairs) {
          const int col = n0 + cw + 8 * j + t2;
          const float b0 = B[col], b1 = B[col + 1];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!valid[r0 + 16 * i + 8 * h + g]) continue;
              m0 = fmaxf(m0, __bfloat162float(__float2bfloat16(fmaxf(acc[i][j][2 * h] + b0, 0.f))));
              m1 = fmaxf(m1, __bfloat162float(__float2bfloat16(fmaxf(acc[i][j][2 * h + 1] + b1, 0.f))));
            }
        }
        // over the 8 lanes that share these columns (lane % 4)
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
        }
        if (g == 0 && j / 2 < pairs) {
          pair_max[rw * kPairCols + 8 * j + t2] = m0;
          pair_max[rw * kPairCols + 8 * j + t2 + 1] = m1;
        }
      }
      pair_sync(pair);
      // pair_max is next written after the pair's next slab barrier
      if (rw == 0 && lane < cols)
        part[n0 + cw + lane] = fmaxf(pair_max[lane], pair_max[kPairCols + lane]);
    }
  }
}

// ---- exact-f32 path ---------------------------------------------------------

constexpr int kF32Stages = 2;        // depth of the CTA's cp.async ring
constexpr int kF32SlabElems = 4096;  // floats per weight slab (16 KB)
constexpr int kF32MaxCols = 16;      // columns per thread of a blocked layer, at most
constexpr int kF32Scratch = 32 * kF32MaxCols;  // the widest N-slab's half-tile maxima
constexpr int kF32FmaCols = 4;       // FMA loops: columns per thread and pass

// Columns per thread (CT) of a blocked layer of N outputs: 16 from 512
// outputs, 8 from 256, else 4. The 8 x 32 thread grid then covers 32 CT
// columns per N-slab, and a slab holds kF32SlabElems / (32 CT) rows of K x
// those columns.
__device__ __forceinline__ int f32_cols(int N) {
  return N >= 512 && N % 16 == 0 ? 16 : N >= 256 && N % 8 == 0 ? 8 : 4;
}

// Channel c, point p of a tile of P points (the layout of both buffers).
template <int P>
__device__ __forceinline__ int cm(int c, int p) {
  return c * P + (p ^ (c & 4));
}

// V consecutive floats (V = 2 or 4, aligned) between shared memory and registers.
template <int V>
__device__ __forceinline__ void load_vec(float* d, const float* s) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(s);
    d[0] = t.x, d[1] = t.y, d[2] = t.z, d[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(s);
    d[0] = t.x, d[1] = t.y;
  }
}
template <int V>
__device__ __forceinline__ void store_vec(float* d, const float* s) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
  else
    *reinterpret_cast<float2*>(d) = make_float2(s[0], s[1]);
}

// A layer is blocked when N is a multiple of 4 and K of its slab's rows.
__device__ __forceinline__ bool f32_blocked(const Params& p, int l) {
  const int N = p.width[l + 1];
  return N % 4 == 0 && p.width[l] % (kF32SlabElems / (32 * f32_cols(N))) == 0;
}

__device__ __forceinline__ int next_f32_layer(const Params& p, int l) {
  while (l < p.num_layers && !f32_blocked(p, l)) ++l;
  return l;
}

// The CTA's weight stream: every slab of every blocked layer in the order the
// layers consume them (layer, then N-slab, then k-slab). The producer runs
// kF32Stages - 1 slabs ahead of the consumer. Each thread copies the same two
// 16-byte chunks of every slab of a layer, so their offsets are worked out
// once per layer.
constexpr int kF32Chunks = kF32SlabElems / 4 / kThreads;  // per thread and slab
struct F32Ring {
  float* slots;
  int put, take;         // the slots the producer fills and the consumer reads next
  int layer, n0, k0;     // the producer's next slab (layer == num_layers: none)
  int slab_n, slab_k;    // its layer's slab: 32 CT columns x kF32SlabElems / slab_n rows
  int q[kF32Chunks];     // this thread's chunks: 16-byte column q of the slab,
  int off[kF32Chunks];   // at W + off (row * N + 4 q) from the slab's corner
};

// Point the producer at the first blocked layer at or after l.
__device__ __forceinline__ void start_layer(const Params& p, F32Ring& r, int l) {
  r.layer = next_f32_layer(p, l);
  r.n0 = r.k0 = 0;
  if (r.layer == p.num_layers) return;
  const int N = p.width[r.layer + 1];
  const int ct = f32_cols(N);
  const int shift = ct == 16 ? 7 : ct == 8 ? 6 : 5;  // log2 of the chunks per row, 8 CT
  static_assert(kF32SlabElems / 4 % (8 * kF32MaxCols) == 0, "a slab holds whole rows");
  r.slab_n = 32 * ct;
  r.slab_k = kF32SlabElems / r.slab_n;
#pragma unroll
  for (int i = 0; i < kF32Chunks; ++i) {
    const int e = threadIdx.x + i * kThreads;
    r.q[i] = e & ((1 << shift) - 1);
    r.off[i] = (e >> shift) * N + 4 * r.q[i];
  }
}

// Issue the next slab (if any) and commit one cp.async group (empty when the
// stream is done, so every step commits exactly one).
__device__ __forceinline__ void produce_f32(const Params& p, F32Ring& r) {
  if (r.layer < p.num_layers) {
    const int N = p.width[r.layer + 1];
    const int quads = min(r.slab_n, N - r.n0) / 4;  // 16-byte chunks per row
    const float* W = static_cast<const float*>(p.w[r.layer]) + static_cast<size_t>(r.k0) * N + r.n0;
    float* dst = r.slots + r.put * kF32SlabElems;
#pragma unroll
    for (int i = 0; i < kF32Chunks; ++i)
      if (r.q[i] < quads) cp_async16(dst + 4 * (threadIdx.x + i * kThreads), W + r.off[i]);
    r.put = r.put + 1 == kF32Stages ? 0 : r.put + 1;
    r.k0 += r.slab_k;
    if (r.k0 >= p.width[r.layer]) {
      r.k0 = 0;
      r.n0 += r.slab_n;
      if (r.n0 >= N) start_layer(p, r, r.layer + 1);
    }
  }
  cp_async_commit();
}

// One blocked layer, CT = f32_cols(N). Warp w, lane l: points (4 (w % 2) +
// l % 4) * P / 8 .. + P / 8 and columns n0 + CT (8 (w / 2) + l / 4) .. + CT of
// each N-slab of 32 CT columns. Per k a thread loads P / 8 points and CT
// weights for P / 8 x CT FMAs: at P = 64 and CT = 16, 6 LDS.128 for 128 FMAs.
template <int P, int CT>
__device__ __forceinline__ void f32_block_layer(const Params& p, F32Ring& ring, const float* in,
                                                float* out, int K, int N, const float* B,
                                                bool last, const unsigned char* valid,
                                                float* scratch, float* part) {
  constexpr int PT = P / 8;             // points per thread
  constexpr int V = PT < 4 ? PT : 4;    // floats per vector access
  constexpr int SN = 32 * CT;           // columns per N-slab
  constexpr int SK = kF32SlabElems / SN;  // rows per slab
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int half = warp % 2;
  const int q0 = (4 * half + lane % 4) * PT;  // the thread's first point
  const int c0 = CT * (8 * (warp / 2) + lane / 4);  // its first column in the N-slab
  bool ok[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) ok[i] = valid[q0 + i];

  for (int n0 = 0; n0 < N; n0 += SN) {
    const bool active = c0 < N - n0;  // N - n0 is a multiple of CT
    float acc[PT][CT];
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;

    for (int k0 = 0; k0 < K; k0 += SK) {
      cp_async_wait<kF32Stages - 2>();  // this thread's copies of the slab landed
      __syncthreads();  // everyone's did; and the slot refilled next is free
      const float* slab = ring.slots + ring.take * kF32SlabElems;
      ring.take = ring.take + 1 == kF32Stages ? 0 : ring.take + 1;
      produce_f32(p, ring);
      if (!active) continue;
#pragma unroll
      for (int kk = 0; kk < SK; ++kk) {
        const int k = k0 + kk;
        float av[PT], wv[CT];
#pragma unroll
        for (int v = 0; v < PT; v += V) load_vec<V>(av + v, in + k * P + ((q0 + v) ^ (k & 4)));
#pragma unroll
        for (int c = 0; c < CT; c += 4) load_vec<4>(wv + c, slab + kk * SN + c0 + c);
#pragma unroll
        for (int i = 0; i < PT; ++i)
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[i][c] = fmaf(av[i], wv[c], acc[i][c]);
      }
    }

    if (!last) {
      if (active) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int j = n0 + c0 + c;
          const float bias = B[j];
          float v[PT];
#pragma unroll
          for (int i = 0; i < PT; ++i) v[i] = fmaxf(acc[i][c] + bias, 0.f);
#pragma unroll
          for (int u = 0; u < PT; u += V) store_vec<V>(out + j * P + ((q0 + u) ^ (j & 4)), v + u);
        }
      }
    } else {
      // each column over the thread's points, then over the 4 lanes that
      // share it (lane % 4), then over the two warps of the pair (w / 2)
      float m[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        m[c] = kNeg;
        if (active) {
          const float bias = B[n0 + c0 + c];
#pragma unroll
          for (int i = 0; i < PT; ++i)
            if (ok[i]) m[c] = fmaxf(m[c], fmaxf(acc[i][c] + bias, 0.f));
        }
        m[c] = fmaxf(m[c], __shfl_xor_sync(0xffffffffu, m[c], 1));
        m[c] = fmaxf(m[c], __shfl_xor_sync(0xffffffffu, m[c], 2));
      }
      const bool writer = lane % 4 == 0 && active;
      if (writer && half == 1) {
#pragma unroll
        for (int c = 0; c < CT; ++c) scratch[c0 + c] = m[c];
      }
      __syncthreads();  // scratch is next written after the next slab's barrier
      if (writer && half == 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) part[n0 + c0 + c] = fmaxf(m[c], scratch[c0 + c]);
      }
    }
  }
}

// A layer the blocks do not take (the thin first layer, ragged widths) as
// FMA loops in the same order. Thread t owns point t % P and, pass by pass,
// kF32FmaCols columns of its group t / P; each weight is one load shared by
// the group.
template <int P>
__device__ void f32_fma_layer(const float* in, float* out, int K, int N, const float* W,
                              const float* B, bool last, const unsigned char* valid,
                              float* scratch, float* part) {
  constexpr int G = kThreads / P;  // column groups
  constexpr int C = kF32FmaCols;
  constexpr int kWarps = P / 32;   // warps per group (0: a group is part of a warp)
  const int q = threadIdx.x % P;
  const int grp = threadIdx.x / P;
  const int passes = (N + G * C - 1) / (G * C);  // the same for every thread
  for (int pass = 0; pass < passes; ++pass) {
    const int j0 = (pass * G + grp) * C;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float a = in[cm<P>(k, q)];
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[c] = fmaf(a, j0 + c < N ? W[static_cast<size_t>(k) * N + j0 + c] : 0.f, acc[c]);
    }
    if (!last) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (j0 + c < N) out[cm<P>(j0 + c, q)] = fmaxf(acc[c] + B[j0 + c], 0.f);
      continue;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float m = j0 + c < N && valid[q] ? fmaxf(acc[c] + B[j0 + c], 0.f) : kNeg;
      // over the group's points in this warp, then over the group's warps
#pragma unroll
      for (int off = (P < 32 ? P : 32) / 2; off > 0; off /= 2)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if constexpr (kWarps > 1) {
        if (threadIdx.x % 32 == 0) scratch[(threadIdx.x / 32) * C + c] = m;
      } else {
        if (q == 0 && j0 + c < N) part[j0 + c] = m;
      }
    }
    if constexpr (kWarps > 1) {
      __syncthreads();
      if (q < C && j0 + q < N) {
        float v = scratch[grp * kWarps * C + q];
        for (int w = 1; w < kWarps; ++w) v = fmaxf(v, scratch[(grp * kWarps + w) * C + q]);
        part[j0 + q] = v;
      }
      __syncthreads();
    }
  }
}

// Shared memory of the f32 kernel: both buffers (rows_a + rows_b channels of
// P points), the ring, the scratch and the row flags.
size_t f32_smem_bytes(int P, int rows_a, int rows_b) {
  return static_cast<size_t>(P) * (rows_a + rows_b) * sizeof(float) +
         static_cast<size_t>(kF32Stages * kF32SlabElems + kF32Scratch) * sizeof(float) + P;
}

template <int P>
__global__ void __launch_bounds__(kThreads) pointnet_f32_kernel(const __grid_constant__ Params prm) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* buf_a = reinterpret_cast<float*>(smem);
  float* buf_b = buf_a + P * prm.stride_a;
  float* slots = buf_b + P * prm.stride_b;
  float* scratch = slots + kF32Stages * kF32SlabElems;
  unsigned char* valid = reinterpret_cast<unsigned char*>(scratch + kF32Scratch);

  // the first weight slabs go in flight before the points arrive
  F32Ring ring;
  ring.slots = slots;
  ring.put = ring.take = 0;
  start_layer(prm, ring, 0);
  for (int s = 0; s < kF32Stages - 1; ++s) produce_f32(prm, ring);

  const int tile = blockIdx.x;
  const int row = blockIdx.y;
  const int c_in = prm.width[0];
  const int p0 = tile * P;
  const int n_here = min(P, prm.n - p0);
  const float* pts = static_cast<const float*>(prm.points) +
                     (static_cast<size_t>(row) * prm.n + p0) * c_in;
  // rows past N are zero: the blocks compute them (they never join the max)
  for (int e = threadIdx.x; e < P * c_in; e += kThreads) {
    const int q = e / c_in, c = e - q * c_in;
    buf_a[cm<P>(c, q)] = q < n_here ? pts[e] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < P) {
    const int q = threadIdx.x;
    bool v = q < n_here;
    if (v && prm.mask_padding) {
      bool any = false;
      for (int c = 0; c < c_in; ++c) any |= buf_a[cm<P>(c, q)] != 0.f;
      v = any;
    }
    valid[q] = v;
  }
  __syncthreads();

  const int feat = prm.width[prm.num_layers];
  float* part = prm.partial + (static_cast<size_t>(row) * prm.tiles + tile) * feat;
  for (int l = 0; l < prm.num_layers; ++l) {
    const bool even = l % 2 == 0;  // even layers read A and write B
    const float* in = even ? buf_a : buf_b;
    float* out = even ? buf_b : buf_a;
    const int K = prm.width[l];
    const int N = prm.width[l + 1];
    const bool last = l == prm.num_layers - 1;
    if (f32_blocked(prm, l)) {
      const int ct = f32_cols(N);
      if (ct == 16)
        f32_block_layer<P, 16>(prm, ring, in, out, K, N, prm.b[l], last, valid, scratch, part);
      else if (ct == 8)
        f32_block_layer<P, 8>(prm, ring, in, out, K, N, prm.b[l], last, valid, scratch, part);
      else
        f32_block_layer<P, 4>(prm, ring, in, out, K, N, prm.b[l], last, valid, scratch, part);
    } else
      f32_fma_layer<P>(in, out, K, N, static_cast<const float*>(prm.w[l]), prm.b[l], last, valid,
                       scratch, part);
    __syncthreads();
  }
}

template <typename T>
size_t smem_bytes(int stride_a, int stride_b) {
  constexpr int P = Tile<T>::kPoints;
  return static_cast<size_t>(P) * (stride_a + stride_b) * sizeof(T) +
         static_cast<size_t>(kPairs) * kStages * kSlabElems * sizeof(__nv_bfloat16) +
         kScratch * sizeof(float) + P;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pointnet_tile_kernel(const __grid_constant__ Params prm) {
  constexpr int P = Tile<T>::kPoints;
  extern __shared__ __align__(128) unsigned char smem[];
  T* buf_a = reinterpret_cast<T*>(smem);
  T* buf_b = buf_a + P * prm.stride_a;
  auto* slots = reinterpret_cast<__nv_bfloat16*>(buf_b + P * prm.stride_b);
  float* scratch = reinterpret_cast<float*>(slots + kPairs * kStages * kSlabElems);
  unsigned char* valid = reinterpret_cast<unsigned char*>(scratch + kScratch);

  // each pair's first weight slabs go in flight before the points arrive
  const int pair = threadIdx.x / kPairThreads;
  Ring ring{slots + pair * kStages * kSlabElems, pair, next_pair_layer(prm, pair, 0), 0, 0, 0, 0};
  for (int s = 0; s < kStages - 1; ++s) produce(prm, ring);

  const int tile = blockIdx.x;
  const int row = blockIdx.y;
  const int c_in = prm.width[0];
  const int p0 = tile * P;
  const int n_here = min(P, prm.n - p0);
  const T* pts = static_cast<const T*>(prm.points) +
                 (static_cast<size_t>(row) * prm.n + p0) * c_in;
  // rows past N are zero: the tensor cores read them (they never join the max)
  for (int e = threadIdx.x; e < P * c_in; e += kThreads) {
    const int p = e / c_in;
    buf_a[p * prm.stride_a + (e - p * c_in)] = p < n_here ? pts[e] : from_f<T>(0.f);
  }
  __syncthreads();
  if (threadIdx.x < P) {
    const int p = threadIdx.x;
    bool v = p < n_here;
    if (v && prm.mask_padding) {
      bool any = false;
      for (int c = 0; c < c_in; ++c) any |= to_f(buf_a[p * prm.stride_a + c]) != 0.f;
      v = any;
    }
    valid[p] = v;
  }
  __syncthreads();

  const int feat = prm.width[prm.num_layers];
  float* part = prm.partial + (static_cast<size_t>(row) * prm.tiles + tile) * feat;
  for (int l = 0; l < prm.num_layers; ++l) {
    const bool even = l % 2 == 0;  // even layers read A and write B
    const T* in = even ? buf_a : buf_b;
    T* out = even ? buf_b : buf_a;
    const int in_stride = even ? prm.stride_a : prm.stride_b;
    const int out_stride = even ? prm.stride_b : prm.stride_a;
    const int K = prm.width[l];
    const int N = prm.width[l + 1];
    const bool last = l == prm.num_layers - 1;
    const T* W = static_cast<const T*>(prm.w[l]);
    if (on_tensor_cores(prm, l)) {
      mma_layer(prm, ring, in, in_stride, out, out_stride, K, N, prm.b[l], last, valid,
                scratch, part);
    } else {
      fma_layer<T, P>(in, in_stride, out, out_stride, K, N, W, prm.b[l], last, valid,
                      scratch, part);
    }
    __syncthreads();
  }
}

__global__ void reduce_tiles_kernel(const float* partial, int tiles, int feat,
                                    float* out) {
  const int row = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= feat) return;
  const float* p = partial + static_cast<size_t>(row) * tiles * feat + c;
  float m = kNeg;
  for (int t = 0; t < tiles; ++t) m = fmaxf(m, p[static_cast<size_t>(t) * feat]);
  out[static_cast<size_t>(row) * feat + c] = m <= kNeg ? 0.f : m;
}

// The widest layer each buffer holds: A the input and the outputs of layers
// 2, 4, ..., B those of layers 1, 3, ...; the last one is never stored.
void buffer_widths(int num_layers, const int* widths, int& max_a, int& max_b) {
  max_a = widths[0];
  max_b = 0;
  for (int l = 0; l + 1 < num_layers; ++l) {
    int& m = l % 2 == 0 ? max_b : max_a;
    m = widths[l + 1] > m ? widths[l + 1] : m;
  }
}

// f32 points per tile: 64 where both buffers fit beside the ring, else 32 or
// 16 (a chain too wide even for 16 is refused at launch).
int f32_tile_points(int num_layers, const int* widths) {
  int max_a, max_b;
  buffer_widths(num_layers, widths, max_a, max_b);
  int P = 64;
  while (P > 16 && f32_smem_bytes(P, max_a, max_b) > kMaxSmem) P /= 2;
  return P;
}

// Launches the tile kernel with `smem` bytes over (tiles, batch), then the
// reduction over tiles into `out`.
int launch(void (*kernel)(Params), const Params& prm, int batch, size_t smem, float* out,
           cudaStream_t stream) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(prm.tiles, batch), kThreads, smem, stream>>>(prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int feat = prm.width[prm.num_layers];
  constexpr int kReduceThreads = 128;
  reduce_tiles_kernel<<<dim3((feat + kReduceThreads - 1) / kReduceThreads, batch),
                        kReduceThreads, 0, stream>>>(prm.partial, prm.tiles, feat, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Points per tile for the working type (is_bf16 = 0: f32, 1: bf16) and, for
// f32, the chain's widths (num_layers + 1 host ints); the caller sizes the
// (batch, tiles, feat) partial buffer with it.
int pointnet_fused_tile_points(int is_bf16, int num_layers, const int* widths) {
  if (is_bf16) return Tile<__nv_bfloat16>::kPoints;
  return num_layers < 1 || num_layers > kMaxLayers ? 16 : f32_tile_points(num_layers, widths);
}

// Launches both kernels on `stream`; returns the cudaError_t of the launches
// (0 = success). `widths` holds num_layers + 1 host ints; `weights` and
// `biases` hold num_layers device pointers.
int pointnet_fused_forward(int is_bf16, const void* points, int batch, int n,
                           int num_layers, const int* widths,
                           const void* const* weights,
                           const void* const* biases, int mask_padding,
                           void* partial, void* out, void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || batch < 1 || n < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm = {};
  prm.points = points;
  prm.n = n;
  prm.num_layers = num_layers;
  for (int l = 0; l <= num_layers; ++l) prm.width[l] = widths[l];
  for (int l = 0; l < num_layers; ++l) {
    prm.w[l] = weights[l];
    prm.b[l] = static_cast<const float*>(biases[l]);
  }
  prm.mask_padding = mask_padding;
  prm.partial = static_cast<float*>(partial);
  int max_a, max_b;
  buffer_widths(num_layers, widths, max_a, max_b);
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<float*>(out);
  if (is_bf16) {
    using T = __nv_bfloat16;
    prm.tiles = (n + Tile<T>::kPoints - 1) / Tile<T>::kPoints;
    prm.stride_a = padded_stride<T>(max_a);
    prm.stride_b = padded_stride<T>(max_b);
    return launch(&pointnet_tile_kernel<T>, prm, batch, smem_bytes<T>(prm.stride_a, prm.stride_b), o, s);
  }
  const int P = f32_tile_points(num_layers, widths);
  prm.tiles = (n + P - 1) / P;
  prm.stride_a = max_a;  // f32: channels (rows of P points) of each buffer
  prm.stride_b = max_b;
  const size_t smem = f32_smem_bytes(P, max_a, max_b);
  return launch(P == 64 ? &pointnet_f32_kernel<64> : P == 32 ? &pointnet_f32_kernel<32>
                                                              : &pointnet_f32_kernel<16>,
                prm, batch, smem, o, s);
}

const char* pointnet_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
