// BEV pools for Hopper (sm_90a): the camera-to-BEV lift-splat over a sorted
// chunk plan, in one pass, with no gathered tensor and no float atomics.
//
// Replaces two TPU kernels of
// bevfusion_multimodal_3d_object_detection_tpu/ops/bev_pool_pallas.py:
// - B2 `bev_pool_weighted` (:166, body `_make_weighted_kernel` :131):
//     out[cell, c] = sum_p round(w[p]) * feat[p % HW, c]
//   over frustum points p of the plan, features per PIXEL, each weight
//   rounded to the feature type before the product (:150);
// - B3 `bev_pool_sorted` (:290, body `_make_kernel` :256):
//     out[cell, c] = sum_p feat[p, c]
//   features per POINT, no weight.
// Both read the plan of `precompute_bev_chunks` (:62): per row, chunks of T
// entries (point index, window-local cell id) sorted by cell, each chunk
// inside one window of W cells, block_idx (the chunk's window) non-decreasing,
// so a row's entries run in cell order from its first chunk to its last.
// Pads are point index == P and local id == -1 and add nothing. Output is f32
// (rows, num_cells, C); cells >= num_cells are dropped. Every output element
// is written exactly once, unreached cells as 0. The products are exact in
// f32 for bf16 inputs and summed in f32, so these kernels and their plain
// version (`ops/bev_pool.py`) differ only in summation order, which is fixed:
// two launches give the same bits.
//
// What the TPU kernel did and these do not: the TPU has no fast scatter, so
// its wrapper gathers a (n_chunks, T, C) tensor into HBM and every chunk
// becomes a dense (T, W) one-hot matmul on the MXU: 30 MB and ~7.7 GFLOP per
// camera row for a sum whose real work is ~2 * points * C.
//
// Bound on an H100: bytes. At the eval shape (48 rows, 56,000 frustum
// points, 28x50 pixels, C = 256, 50x50 cells) B2 must read ~34 MB of bf16
// features once, ~22 MB of plan and a few MB of weights, and write 123 MB
// of f32 output, against about 1 GFLOP: ~0.055 ms at 3.35 TB/s.
//
// B2: the slice kernel (`slice_kernel`), one block of 32 warps per (camera
// row, channel slice).
// - L2 gathers. Each pixel's features serve ~34 entries of its row (47,600
//   real entries over 1,400 pixels on the ring calibration), and reading a
//   512-byte row from L2 per entry moved ~1.17 GB per call. The block copies
//   its slice of the row's features (a strided box: HW rows of 16 * lanes
//   bytes) into shared memory once with cp.async, so the features come from
//   HBM once (34 MB in all) and every entry reads shared memory. The slice
//   is chosen at launch from the shape: 16-byte units of a pixel's channels,
//   one per lane, up to kMaxLanes (128 bytes: 64 bf16 or 32 f32 channels,
//   179,200 bytes of shared memory at HW = 1,400), halved while a row's
//   slice does not fit, then while the narrower slices' blocks would still
//   fit in one wave of one block per SM (6 rows take 16 channels a slice, 96
//   blocks; 48 rows keep 128 bytes, 192 blocks). A warp sums 32 / lanes
//   entries at a time, one per group of lanes, and adds the groups up with
//   shuffles when a cell ends. Where even 16 bytes a pixel do not fit (HW
//   above ~14,000), B2 takes the gather kernel below: a choice by shape.
// - Long cells and busy windows. On a real calibration a few cells hold
//   thousands of entries (up to 2,464 in a ring row) and one window 25,928
//   of a row's 47,600. The block's warps take segments of the row instead
//   of chunks or windows: runs of whole chunks cut to about the same cost
//   each, estimated from 8 local ids a chunk. A cell cut by a segment
//   boundary is combined in the block: every warp leaves its sum of its
//   segment's first cell in shared memory, and after one barrier the warp
//   that holds the cell's first entry adds the later warps' sums of it in
//   warp order and stores the cell. Each warp zeroes the unreached cells
//   before each cell it owns, the block those before the row's first cell
//   and after its last. A cell's slice is stored by one instruction (two
//   groups of lanes for bf16), so the 123 MB of output go out in whole
//   sectors.
// - Plan and weights are read from L2, 128 entries per warp at a time, two
//   batches ahead of the sums.
// What is left slow (tools/b2_ablation.py): each entry costs a shuffle, a
// 128-byte shared-memory load and ~2 instructions per bf16 channel (unpack,
// FMA), besides its plan, weight and cell bookkeeping, and these per-entry
// costs, not bytes, set the pace; the 192 blocks at the eval shape are 1.45
// waves of one block per SM, so the second wave runs on 60 SMs.
//
// B3, and B2 above the shared-memory limit: the gather kernel
// (`gather_kernel`), one warp per plan chunk, each lane 16 bytes of
// channels, feature rows read straight from device memory (L2); each cell is
// summed and stored by the chunk that holds its first entry, which reads on
// into the next chunks of its window while the cell goes on, and zeroes the
// cells no entry reaches between its previous cell and its own. What it
// leaves slow: the owner of a long cell walks it alone, and every entry
// reads its whole feature row from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kWarps = 4;        // gather kernel: chunks per block, one warp each
constexpr int kSpan = 256;       // plan entries a warp stages per pass
constexpr int kLoadsAhead = 8;   // 16-byte feature loads in flight per lane
constexpr int kSliceWarps = 32;  // slice kernel: warps per block, one segment each
constexpr int kMaxLanes = 8;     // slice kernel: 16-byte units of a pixel per slice
constexpr int kAhead = 4;        // slice kernel: plan entries in flight per lane
constexpr int kProbes = 8;       // slice kernel: plan entries read per chunk to cut segments
constexpr unsigned kAll = 0xffffffffu;
static_assert(kSpan % kLoadsAhead == 0, "a span is whole groups of loads");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Channels per lane: 16 bytes, what one lane loads and sums per entry.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// Channel v of a 16-byte load, as f32 (a bf16 is the top half of an f32;
// element 2i is the low half of word i).
template <typename T>
__device__ __forceinline__ float unpack(const uint4& r, int v) {
  const unsigned w = (&r.x)[v * static_cast<int>(sizeof(T)) / 4];
  if constexpr (sizeof(T) == 4) return __uint_as_float(w);
  return __uint_as_float(v & 1 ? w & 0xffff0000u : w << 16);
}

struct Plan {
  const int* point_idx;  // (rows, n_chunks, t)
  const int* local_ids;  // (rows, n_chunks, t)
  const int* block_idx;  // (rows, n_chunks)
  int n_chunks;
  int t;
  int window;
  int num_cells;
  int num_points;  // P: point indices >= P are pads
};

// The output cell of a plan entry (local id `lid`, point `p`) of a window
// starting at `cell0`, or -1 for a pad, an id outside the window or a cell
// past num_cells.
__device__ __forceinline__ int cell_of(const Plan& plan, int lid, int p, int cell0) {
  const bool real = lid >= 0 && lid < plan.window && p >= 0 && p < plan.num_points &&
                    cell0 + lid < plan.num_cells;
  return real ? cell0 + lid : -1;
}

// The same for plan entry `e`, whose point goes to `point`.
__device__ __forceinline__ int entry_cell(const Plan& plan, size_t e, int cell0, int* point) {
  *point = plan.point_idx[e];
  return cell_of(plan, plan.local_ids[e], *point, cell0);
}

// The last (largest) cell of a chunk's real entries, -1 if it has none.
// Warp-wide: every lane gets the same value.
__device__ int chunk_last_cell(const Plan& plan, size_t begin, int cell0, int lane) {
  int m = -1;
  for (int i = lane; i < plan.t; i += 32) {
    int p;
    m = max(m, entry_cell(plan, begin + i, cell0, &p));
  }
  return __reduce_max_sync(kAll, m);
}

struct Staged {
  int cell[kSpan];  // -1: skip
  int src[kSpan];   // feature row
  float w[kSpan];   // weight, already rounded to the feature type
};

// Stages entries [e, e + n) (n <= kSpan) of a window's stream; entries past
// n are skipped. Returns, warp-wide, whether any staged entry is real.
template <typename T, bool kWeighted>
__device__ bool stage(Staged& s, const Plan& plan, size_t e, int n, int cell0, const T* w_row,
                      int feat_rows, int lane) {
  __syncwarp();  // every lane is done with the previous span
  bool real = false;
  for (int i = lane; i < kSpan; i += 32) {
    int cell = -1, p = 0;
    if (i < n) cell = entry_cell(plan, e + i, cell0, &p);
    s.cell[i] = cell;
    s.src[i] = cell < 0 ? 0 : (kWeighted ? p % feat_rows : p);
    s.w[i] = cell < 0 ? 0.f : (kWeighted ? to_float(w_row[p]) : 1.f);
    real |= cell >= 0;
  }
  __syncwarp();
  return __any_sync(kAll, real);
}

// One lane's running sums over the window's stream, for its kVec channels.
template <typename T>
struct Sum {
  int cur;   // the cell whose sums `acc` holds, -1 before the first
  int next;  // the first cell this warp still has to write
  float acc[kVec<T>];

  __device__ void put(int cell, float* o_row, int channels, bool active, bool zero) {
    if (!active) return;
    float4* o = reinterpret_cast<float4*>(o_row + static_cast<size_t>(cell) * channels);
#pragma unroll
    for (int i = 0; i < kVec<T> / 4; ++i)
      o[i] = zero ? make_float4(0.f, 0.f, 0.f, 0.f)
                  : make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
  __device__ void store(float* o_row, int channels, bool active) {
    if (cur >= 0) {
      put(cur, o_row, channels, active, false);
      next = cur + 1;
    }
  }
  __device__ void zero_until(int end, float* o_row, int channels, bool active) {
    for (; next < end; ++next) put(next, o_row, channels, active, true);
  }
};

// Adds the staged entries to `sum`, skipping entries of cell `skip`. With
// `extend`, only entries of sum.cur are added, and the walk stops (returns
// true) at the first real entry of another cell; otherwise every new cell
// stores the previous one and zeroes the gap before it.
template <typename T>
__device__ bool walk(const Staged& s, int n, int skip, bool extend, Sum<T>& sum, const T* f_row,
                     int channels, bool active, float* o_row) {
  for (int t0 = 0; t0 < n; t0 += kLoadsAhead) {
    uint4 f[kLoadsAhead];
#pragma unroll
    for (int u = 0; u < kLoadsAhead; ++u) {
      const int cell = s.cell[t0 + u];  // t0 + u < kSpan: past n it is -1
      f[u] = active && cell >= 0 && cell != skip
                 ? *reinterpret_cast<const uint4*>(f_row + static_cast<size_t>(s.src[t0 + u]) * channels)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kLoadsAhead; ++u) {
      const int cell = s.cell[t0 + u];
      if (cell < 0 || cell == skip) continue;
      if (cell != sum.cur) {
        if (extend) return true;  // uniform: every lane reads the same cells
        sum.store(o_row, channels, active);
        sum.zero_until(cell, o_row, channels, active);
        sum.cur = cell;
#pragma unroll
        for (int v = 0; v < kVec<T>; ++v) sum.acc[v] = 0.f;
      }
      const float w = s.w[t0 + u];
#pragma unroll
      for (int v = 0; v < kVec<T>; ++v) sum.acc[v] = fmaf(w, unpack<T>(f[u], v), sum.acc[v]);
    }
  }
  return false;
}


// The gather kernel (B3, and B2 where the slice kernel's rows do not fit in
// shared memory). feats: (rows, feat_rows, channels); weights: (rows,
// num_points) or null. channels is a multiple of kVec<T>, feats and out
// 16-byte aligned.
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(32 * kWarps)
    gather_kernel(const T* __restrict__ feats, int feat_rows, const T* __restrict__ weights,
                  Plan plan, int channels, float* __restrict__ out) {
  __shared__ Staged stages[kWarps];

  const int lane = threadIdx.x % 32;
  const int k = blockIdx.x * kWarps + threadIdx.x / 32;
  if (k >= plan.n_chunks) return;  // warp-uniform, as every exit below
  Staged& s = stages[threadIdx.x / 32];
  const int c = (blockIdx.y * 32 + lane) * kVec<T>;
  const bool active = c < channels;
  const int row = blockIdx.z;

  const int* bidx = plan.block_idx + static_cast<size_t>(row) * plan.n_chunks;
  const int win = bidx[k];
  const int cell0 = win * plan.window;
  if (win < 0 || cell0 >= plan.num_cells) return;  // no output cell
  const int cell_end = min(cell0 + plan.window, plan.num_cells);
  const size_t plan_row = static_cast<size_t>(row) * plan.n_chunks * plan.t;
  const T* f_row = feats + static_cast<size_t>(row) * feat_rows * channels + c;
  const T* w_row = kWeighted ? weights + static_cast<size_t>(row) * plan.num_points : nullptr;
  float* o_row = out + static_cast<size_t>(row) * plan.num_cells * channels + c;
  auto chunk = [&](int j) { return plan_row + static_cast<size_t>(j) * plan.t; };

  // The last cell before this chunk in the window (cell0 - 1: none). A
  // chunk with no real entry owns nothing, unless it opens the window: then
  // it zeroes the window when no later chunk of it has an entry either.
  const bool opens = k == 0 || bidx[k - 1] != win;
  const int own_last = chunk_last_cell(plan, chunk(k), cell0, lane);
  if (own_last < 0 && !opens) return;
  int prev = cell0 - 1;
  for (int j = k - 1; own_last >= 0 && j >= 0 && bidx[j] == win; --j) {
    const int m = chunk_last_cell(plan, chunk(j), cell0, lane);
    if (m >= 0) {
      prev = m;
      break;
    }
  }
  if (own_last >= 0 && own_last == prev) return;  // only the tail of an earlier cell

  Sum<T> sum{-1, prev + 1, {}};
  for (int i = 0; i < plan.t; i += kSpan) {
    const int n = min(kSpan, plan.t - i);
    if (stage<T, kWeighted>(s, plan, chunk(k) + i, n, cell0, w_row, feat_rows, lane))
      walk(s, n, prev, false, sum, f_row, channels, active, o_row);
  }
  // The last cell may go on in the next chunks of the window; with no cell
  // yet (an opening chunk with no entry), any entry ends the search.
  bool ended = false;
  for (int j = k + 1; !ended && j < plan.n_chunks && bidx[j] == win; ++j) {
    for (int i = 0; !ended && i < plan.t; i += kSpan) {
      const int n = min(kSpan, plan.t - i);
      if (stage<T, kWeighted>(s, plan, chunk(j) + i, n, cell0, w_row, feat_rows, lane))
        ended = walk(s, n, -1, true, sum, f_row, channels, active, o_row);
    }
  }
  sum.store(o_row, channels, active);
  if (!ended) sum.zero_until(cell_end, o_row, channels, active);  // the window's last cell
}


// ---------------------------------------------------------------------------
// The slice kernel (B2)

// The first cell of window `win`, or -1 for a window with no output cell.
__device__ __forceinline__ int window_start(const Plan& plan, int win) {
  const long long cell0 = static_cast<long long>(win) * plan.window;
  return win >= 0 && cell0 < plan.num_cells ? static_cast<int>(cell0) : -1;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

template <typename T>
__device__ __forceinline__ void add(float (&acc)[kVec<T>], float w, const uint4& f) {
#pragma unroll
  for (int v = 0; v < kVec<T>; ++v) acc[v] = fmaf(w, unpack<T>(f, v), acc[v]);
}

// The entry of lane `from` (its `key` and, for f32, `w`) for a lane of its
// group: the weight in *weight and the lane's 16 bytes of the entry's
// features, unit `unit` of its row in `rows` (`stride` units a row). No
// entry reads a row of zeros with weight 0.
template <typename T>
__device__ __forceinline__ uint4 entry_features(const uint4* rows, int stride, int unit, unsigned key,
                                                float w, int from, float* weight) {
  key = __shfl_sync(kAll, key, from);
  unsigned src;
  if constexpr (sizeof(T) == 2) {
    src = key >> 16;
    *weight = __uint_as_float(key << 16);
  } else {
    src = key;
    *weight = __shfl_sync(kAll, w, from);
  }
  return rows[src * stride + unit];
}

// p mod m for 0 <= p, 0 < m: the quotient from a float reciprocal, then
// corrected (it is off by at most one while p < 2^24 and p / m < 2^21).
__device__ __forceinline__ int mod_by(int p, int m, float inv_m) {
  int r = p - __float2int_rz(__int2float_rn(p) * inv_m) * m;
  while (r < 0) r += m;
  while (r >= m) r -= m;
  return r;
}

// Stores lane group g's part of its kVec sums of `cell`: the first V / 4
// groups of a warp store float4 g of each lane's V sums, so that one store
// instruction covers the slice's bytes of the cell, 16-byte aligned
// (channels and a lane's first channel are multiples of 4).
template <int V>
__device__ __forceinline__ void put(float* o_row, int cell, int channels, const float (&acc)[V], int g) {
  float4 v = make_float4(acc[0], acc[1], acc[2], acc[3]);
  if constexpr (V == 8) {
    if (g == 1) v = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  if (g < V / 4) reinterpret_cast<float4*>(o_row + static_cast<size_t>(cell) * channels)[g] = v;
}

// Zeroes cells [from, to) of the lanes' channels: `n` lane groups take the
// (cell, float4) pairs in turn from group k, V / 4 groups a cell as `put`
// stores it (n is a multiple of V / 4).
template <int V>
__device__ __forceinline__ void zero_cells(float* o_row, int from, int to, int k, int n, int channels) {
  constexpr int parts = V / 4;
  for (int s = k; from + s / parts < to; s += n)
    reinterpret_cast<float4*>(o_row + static_cast<size_t>(from + s / parts) * channels)[s % parts] =
        make_float4(0.f, 0.f, 0.f, 0.f);
}

// Shared memory of a slice block: the slice of the row's features and a
// row of zeros ((feat_rows + 1) x lanes 16-byte units), each warp's sum of
// the first cell of its segment (lanes x 8 floats) and two ints per chunk.
__host__ __device__ constexpr size_t slice_smem(int lanes, int feat_rows, int n_chunks) {
  return (static_cast<size_t>(feat_rows) + 1) * lanes * 16 + static_cast<size_t>(kSliceWarps) * lanes * 32 +
         static_cast<size_t>(n_chunks) * 8;
}

// One warp's batch of kAhead x 32 plan entries, kAhead per lane: each
// entry's cell (-1: none), and, to be shuffled to the lanes that sum it, its
// feature row and weight (bf16: both in `key`, row << 16 | the weight's
// bits; f32: the row in `key`); no entry has the zero row and weight 0.
struct Batch {
  int cell[kAhead];
  unsigned key[kAhead];
  float w[kAhead];
};

// feats: (rows, feat_rows, channels) per pixel; weights: (rows, num_points);
// grid (slices, rows). L lanes sum one entry, 16 bytes of channels each; a
// warp sums G = 32 / L entries at a time.
template <typename T, int L>
__global__ void __launch_bounds__(32 * kSliceWarps, 1)
    slice_kernel(const T* __restrict__ feats, int feat_rows, const T* __restrict__ weights,
                 Plan plan, int channels, float* __restrict__ out) {
  constexpr int V = kVec<T>;
  constexpr int G = 32 / L;
  extern __shared__ uint4 smem[];
  uint4* fs = smem;  // the slice of the row's features, feat_rows x L units, then L of zeros
  float* partial = reinterpret_cast<float*>(fs + static_cast<size_t>(feat_rows + 1) * L);
  int* c_cost = reinterpret_cast<int*>(partial + kSliceWarps * L * 8);  // per chunk: walk cost,
  int* c_cell0 = c_cost + plan.n_chunks;                                 // window start
  __shared__ int s_head[kSliceWarps], s_tail[kSliceWarps];  // per segment, -1: no entry

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / L, q = lane % L;
  const int row = blockIdx.y;
  const int units = channels / V;       // 16-byte units of a pixel's channels
  const int unit = blockIdx.x * L + q;  // this lane's
  const bool active = unit < units;
  const T* f_row = feats + static_cast<size_t>(row) * feat_rows * channels;
  const T* w_row = weights + static_cast<size_t>(row) * plan.num_points;
  float* o_row = out + static_cast<size_t>(row) * plan.num_cells * channels + unit * V;
  const int* bidx = plan.block_idx + static_cast<size_t>(row) * plan.n_chunks;
  const size_t plan_row = static_cast<size_t>(row) * plan.n_chunks * plan.t;

  // The slice of the row's features into shared memory (units past the
  // channels are zero-filled); it lands while the plan is probed.
  for (int i = threadIdx.x; i < feat_rows * L; i += blockDim.x) {
    const int u = blockIdx.x * L + i % L;
    const bool ok = u < units;
    cp_async16(fs + i, f_row + static_cast<size_t>(i / L) * channels + (ok ? u : 0) * V, ok ? 16 : 0);
  }
  const unsigned zero_row = static_cast<unsigned>(feat_rows);
  if (threadIdx.x < L) fs[zero_row * L + threadIdx.x] = make_uint4(0, 0, 0, 0);
  // Each chunk's cost to walk, for the cut into segments: 1 + its real
  // entries among kProbes spread over it (an estimate; every chunk is
  // walked whatever it says), and its window's first cell.
  for (int j = threadIdx.x; j < plan.n_chunks; j += blockDim.x) {
    int lids[kProbes];
#pragma unroll
    for (int k = 0; k < kProbes; ++k)
      lids[k] = plan.local_ids[plan_row + static_cast<size_t>(j) * plan.t + k * plan.t / kProbes];
    int cost = 1;
#pragma unroll
    for (int k = 0; k < kProbes; ++k) cost += lids[k] >= 0;
    c_cost[j] = cost;
    c_cell0[j] = window_start(plan, bidx[j]);
  }
  cp_async_wait_all();
  __syncthreads();

  // This warp's segment [begin, end) of chunks: chunk j goes to warp
  // floor(cost before j * kSliceWarps / cost of the row). Each lane sums a
  // run of chunks; every warp works the same cut out.
  int begin, end;
  {
    const int per = (plan.n_chunks + 31) / 32;
    const int j0 = min(lane * per, plan.n_chunks), j1 = min(j0 + per, plan.n_chunks);
    int mine = 0;
    for (int j = j0; j < j1; ++j) mine += c_cost[j];
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int v = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += v;
    }
    const long long total = __shfl_sync(kAll, incl, 31);
    long long before = incl - mine;
    int below = 0, upto = 0;
    for (int j = j0; j < j1; ++j) {
      const int owner = static_cast<int>(before * kSliceWarps / total);
      below += owner < warp;
      upto += owner <= warp;
      before += c_cost[j];
    }
    begin = __reduce_add_sync(kAll, below);
    end = __reduce_add_sync(kAll, upto);
  }

  // The walk over the segment's chunks, kAhead x 32 entries a batch (lane l
  // holds entries l, l + 32, ...), loads two batches ahead of the sums:
  // `lid` and `point` hold the plan of the batch after next, `next` the next
  // batch with its weights in flight.
  int cj = begin, ci = 0;  // the next batch to load
  int lid[kAhead], point[kAhead], cell0 = 0;
  auto load = [&]() {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      lid[u] = -1;
      point[u] = 0;
    }
    if (cj >= end) return;
    cell0 = c_cell0[cj];
    const size_t base = plan_row + static_cast<size_t>(cj) * plan.t;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = ci + u * 32 + lane;
      if (cell0 >= 0 && i < plan.t) {
        lid[u] = plan.local_ids[base + i];
        point[u] = plan.point_idx[base + i];
      }
    }
    ci += 32 * kAhead;
    if (ci >= plan.t) {
      ci = 0;
      ++cj;
    }
  };
  const float inv_rows = 1.f / feat_rows;
  auto resolve = [&]() {
    Batch b;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      b.cell[u] = cell_of(plan, lid[u], point[u], cell0);
      unsigned src = zero_row;
      b.w[u] = 0.f;
      if (b.cell[u] >= 0) {
        src = static_cast<unsigned>(mod_by(point[u], feat_rows, inv_rows));
        b.w[u] = to_float(w_row[point[u]]);
      }
      b.key[u] = sizeof(T) == 2 ? src << 16 | __float_as_uint(b.w[u]) >> 16 : src;
    }
    return b;
  };

  float acc[V] = {};
  int head = -1, cur = -1;  // the segment's first cell, the cell `acc` sums (-1: none yet)
  // acc summed over the warp's groups (every lane gets the same sum)
  auto reduce = [&]() {
#pragma unroll
    for (int o = L; o < 32; o *= 2)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += __shfl_xor_sync(kAll, acc[v], o);
  };
  // cur has ended: the segment's first cell goes to shared memory (an
  // earlier segment may hold its start), any later one is ours and stored
  auto finish = [&]() {
    reduce();
    if (cur != head) {
      if (active) put<V>(o_row, cur, channels, acc, g);
    } else if (g == 0) {
#pragma unroll
      for (int v = 0; v < V; ++v) partial[(warp * L + q) * 8 + v] = acc[v];
    }
  };

  // Each batch in steps of 32 entries: kAhead steps, the one at [0] taken
  // and the rest moved down, so that the step's code exists once.
  const int n_batches = (end - begin) * ((plan.t + 32 * kAhead - 1) / (32 * kAhead));
  load();
  Batch next = resolve();
  load();
  for (int b = 0; b < n_batches; ++b) {
    Batch e = next;
    next = resolve();
    load();
#pragma unroll 1
    for (int u = 0; u < kAhead; ++u) {
      const int e_cell = e.cell[0];
      const unsigned e_key = e.key[0];
      const float e_w = e.w[0];
#pragma unroll
      for (int v = 0; v + 1 < kAhead; ++v) {
        e.cell[v] = e.cell[v + 1];
        e.key[v] = e.key[v + 1];
        e.w[v] = e.w[v + 1];
      }
      if (!__any_sync(kAll, e_cell >= 0)) continue;
      // G entries at a time, entry k * G + g for group g; where every entry
      // of the step is of the current cell (or none), no cell can end
      if (__all_sync(kAll, e_cell < 0 || e_cell == cur)) {
#pragma unroll
        for (int k = 0; k < L; ++k) {
          float w;
          const uint4 f = entry_features<T>(fs, L, q, e_key, e_w, k * G + g, &w);
          add<T>(acc, w, f);  // no entry adds 0 * 0
        }
        continue;
      }
#pragma unroll 1
      for (int k = 0; k < L; ++k) {
        float w;
        const uint4 f = entry_features<T>(fs, L, q, e_key, e_w, k * G + g, &w);
        const int cell = __shfl_sync(kAll, e_cell, k * G + g);
        if (!__any_sync(kAll, cell > cur)) {
          add<T>(acc, w, f);
          continue;
        }
        // New cells start among these G entries, in group order.
        if (cell == cur) add<T>(acc, w, f);
        for (;;) {
          const int nc = __reduce_min_sync(kAll, cell > cur ? cell : INT_MAX);
          if (nc == INT_MAX) break;
          if (cur >= 0) {
            finish();
            if (active) zero_cells<V>(o_row, cur + 1, nc, g, G, channels);
          } else {
            head = nc;
          }
          cur = nc;
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = 0.f;
          if (cell == cur) add<T>(acc, w, f);
        }
      }
    }
  }

  // The segment's last cell `cur` stays in registers, unless it is its first.
  if (cur >= 0) reduce();
  if (cur >= 0 && cur == head && g == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) partial[(warp * L + q) * 8 + v] = acc[v];
  }
  if (lane == 0) {
    s_head[warp] = head;
    s_tail[warp] = cur;
  }
  __syncthreads();

  // prev: the last cell before this segment (-1: none); the row's first and
  // last cell; whether the next segment with an entry goes on with our last.
  int prev = -1, row_first = INT_MAX, row_last = -1;
  bool tail_cut = false, seen_next = false;
  for (int w = 0; w < kSliceWarps; ++w) {
    const int h = s_head[w], t = s_tail[w];
    if (t < 0) continue;
    row_first = min(row_first, h);
    row_last = max(row_last, t);
    if (w < warp) prev = t;
    if (w > warp && !seen_next) {
      seen_next = true;
      tail_cut = h == cur;
    }
  }
  if (active) {  // the block zeroes the cells before the row's first and after its last
    const int first = warp * G + g, stride = kSliceWarps * G;
    if (row_last < 0) {
      zero_cells<V>(o_row, 0, plan.num_cells, first, stride, channels);
    } else {
      zero_cells<V>(o_row, 0, row_first, first, stride, channels);
      zero_cells<V>(o_row, row_last + 1, plan.num_cells, first, stride, channels);
    }
  }
  if (cur < 0) return;  // no entry in this segment
  // A cell cut at the segment's end is ours where it starts here: ours plus
  // the later segments' sums of it, in warp order.
  auto add_cut = [&](float (&sum)[V]) {
    for (int w = warp + 1; tail_cut && w < kSliceWarps; ++w) {
      if (s_tail[w] < 0) continue;
      if (s_head[w] != cur) break;
#pragma unroll
      for (int v = 0; v < V; ++v) sum[v] += partial[(w * L + q) * 8 + v];
    }
  };
  if (head != prev) {  // the first cell is ours, and the cells after prev up to it
    if (active && prev >= 0) zero_cells<V>(o_row, prev + 1, head, g, G, channels);
    if (g < V / 4) {
      float sum[V];
#pragma unroll
      for (int v = 0; v < V; ++v) sum[v] = partial[(warp * L + q) * 8 + v];
      if (head == cur) add_cut(sum);
      if (active) put<V>(o_row, head, channels, sum, g);
    }
  }
  if (cur != head && g < V / 4) {
    add_cut(acc);
    if (active) put<V>(o_row, cur, channels, acc, g);
  }
}

// ---------------------------------------------------------------------------
// Launch

// Lanes per entry of the slice kernel for B2 (16-byte units of a pixel's
// channels per slice), 0 for the gather kernel: as many as the channels need
// up to kMaxLanes, halved while the slice of a row does not fit in
// `max_smem` bytes, then while the narrower slices' blocks (rows x slices,
// one per SM) still fit in one wave: few rows then run more, shorter blocks.
template <typename T>
int slice_lanes(int rows, int feat_rows, int n_chunks, int channels, int sms, size_t max_smem) {
  const int units = channels / kVec<T>;
  auto blocks = [&](int lanes) { return static_cast<long long>(rows) * ((units + lanes - 1) / lanes); };
  int lanes = 1;
  while (lanes < kMaxLanes && lanes < units) lanes *= 2;
  while (lanes > 1 && slice_smem(lanes, feat_rows, n_chunks) > max_smem) lanes /= 2;
  if (slice_smem(lanes, feat_rows, n_chunks) > max_smem) return 0;
  while (lanes > 1 && blocks(lanes / 2) <= sms) lanes /= 2;
  return lanes;
}

// The device's SM count and the dynamic shared memory a slice block may
// take beside its static arrays.
int device_limits(int* sms, size_t* max_smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *max_smem = static_cast<size_t>(optin) - 2 * kSliceWarps * sizeof(int);
  return static_cast<int>(err);
}

template <typename T, int L>
int launch_slices(const T* f, int feat_rows, const T* w, const Plan& plan, int rows, int channels,
                  float* o, cudaStream_t stream, int* blocks_per_sm) {
  const size_t smem = slice_smem(L, feat_rows, plan.n_chunks);
  auto kernel = slice_kernel<T, L>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_per_sm)  // a query: no launch
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                                          32 * kSliceWarps, smem));
  const int units = channels / kVec<T>;
  const dim3 grid((units + L - 1) / L, rows);
  kernel<<<grid, 32 * kSliceWarps, smem, stream>>>(f, feat_rows, w, plan, channels, o);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_slices(int lanes, const T* f, int feat_rows, const T* w, const Plan& plan, int rows,
                  int channels, float* o, cudaStream_t stream, int* blocks_per_sm = nullptr) {
  switch (lanes) {
    case 1: return launch_slices<T, 1>(f, feat_rows, w, plan, rows, channels, o, stream, blocks_per_sm);
    case 2: return launch_slices<T, 2>(f, feat_rows, w, plan, rows, channels, o, stream, blocks_per_sm);
    case 4: return launch_slices<T, 4>(f, feat_rows, w, plan, rows, channels, o, stream, blocks_per_sm);
    case 8: return launch_slices<T, 8>(f, feat_rows, w, plan, rows, channels, o, stream, blocks_per_sm);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
static_assert(kMaxLanes == 1 || kMaxLanes == 2 || kMaxLanes == 4 || kMaxLanes == 8,
              "launch_slices instantiates 1, 2, 4 and 8 lanes");

template <typename T>
int launch(const void* feats, int feat_rows, const void* weights, const Plan& plan, int rows,
           int channels, void* out, cudaStream_t stream) {
  constexpr int vec = kVec<T>;
  if (channels % vec || reinterpret_cast<size_t>(feats) % 16 || reinterpret_cast<size_t>(out) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto f = static_cast<const T*>(feats);
  const auto w = static_cast<const T*>(weights);
  const auto o = static_cast<float*>(out);
  if (weights) {
    int sms = 0;
    size_t max_smem = 0;
    if (const int err = device_limits(&sms, &max_smem)) return err;
    const int lanes = slice_lanes<T>(rows, feat_rows, plan.n_chunks, channels, sms, max_smem);
    if (lanes) return launch_slices<T>(lanes, f, feat_rows, w, plan, rows, channels, o, stream);
  }
  const dim3 grid((plan.n_chunks + kWarps - 1) / kWarps, (channels + 32 * vec - 1) / (32 * vec),
                  rows);
  if (weights)
    gather_kernel<T, true><<<grid, 32 * kWarps, 0, stream>>>(f, feat_rows, w, plan, channels, o);
  else
    gather_kernel<T, false><<<grid, 32 * kWarps, 0, stream>>>(f, feat_rows, w, plan, channels, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches one pool on `stream`; returns the cudaError_t of the launch
// (0 = success). weights == null: B3 (features (rows, num_points, C) per
// point); otherwise B2 (features (rows, feat_rows, C) per pixel, weights
// (rows, num_points) in the feature type). Plan arrays are int32. C must be
// a multiple of 16 bytes' worth of channels (4 f32, 8 bf16) and the
// features and the output 16-byte aligned.
int bev_pool_forward(int is_bf16, const void* feats, int feat_rows, const void* weights,
                     const void* point_idx, const void* local_ids, const void* block_idx,
                     int rows, int n_chunks, int chunk_points, int window, int num_cells,
                     int num_points, int channels, void* out, void* stream) {
  if (rows < 1 || rows > 65535 || n_chunks < 1 || chunk_points < 1 || window < 1 ||
      num_cells < 1 || num_points < 1 || channels < 1 || feat_rows < 1 ||
      static_cast<long long>(n_chunks) * chunk_points > INT_MAX)  // a row's entries index as int
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan{static_cast<const int*>(point_idx), static_cast<const int*>(local_ids),
                  static_cast<const int*>(block_idx), n_chunks, chunk_points, window,
                  num_cells, num_points};
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(feats, feat_rows, weights, plan, rows, channels, out, s);
  return launch<float>(feats, feat_rows, weights, plan, rows, channels, out, s);
}

// How B2 runs at a shape, launching nothing: config[0] the channels of a
// slice (0: the gather kernel), config[1] slice blocks per SM, config[2]
// their dynamic shared memory in bytes, config[3] the grid's blocks. Returns
// a cudaError_t.
int bev_pool_weighted_config(int is_bf16, int rows, int feat_rows, int n_chunks, int channels,
                             int* config) {
  int sms = 0;
  size_t max_smem = 0;
  if (const int err = device_limits(&sms, &max_smem)) return err;
  const int vec = is_bf16 ? kVec<__nv_bfloat16> : kVec<float>;
  const int lanes = is_bf16 ? slice_lanes<__nv_bfloat16>(rows, feat_rows, n_chunks, channels, sms, max_smem)
                            : slice_lanes<float>(rows, feat_rows, n_chunks, channels, sms, max_smem);
  config[0] = lanes * vec;
  config[1] = config[2] = config[3] = 0;
  if (!lanes) return 0;
  config[2] = static_cast<int>(slice_smem(lanes, feat_rows, n_chunks));
  config[3] = rows * ((channels / vec + lanes - 1) / lanes);
  const Plan plan{nullptr, nullptr, nullptr, n_chunks, 1, 1, 1, 1};
  return is_bf16 ? launch_slices<__nv_bfloat16>(lanes, nullptr, feat_rows, nullptr, plan, rows, channels,
                                                nullptr, nullptr, &config[1])
                 : launch_slices<float>(lanes, nullptr, feat_rows, nullptr, plan, rows, channels, nullptr,
                                        nullptr, &config[1]);
}

const char* bev_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
