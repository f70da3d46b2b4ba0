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
//   above ~14,000), B2 takes the sorted kernel below: a choice by shape.
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
// B3, and B2 above the shared-memory limit: the sorted kernel
// (`sorted_kernel`, then `combine_kernel`).
// - Bound: bytes. No feature row serves two entries (B3 reads each point's
//   row at most once), so nothing is worth staging: at 6 ring rows of
//   56,000 points, C = 256 f32, the 293,888 real entries read 301 MB of
//   rows once, the output is 15.4 MB and the plan 2.8 MB: 0.095 ms at
//   3.35 TB/s. To stream at that rate the card needs ~25 KB of loads in
//   flight per SM (3.35 TB/s x ~1 us / 132 SMs).
// - What PR 2's kernel left slow: one warp per chunk, and a cell summed
//   alone by the warp whose chunk held its first entry, walking on through
//   the later chunks while the cell went on. A ring row's longest cell holds
//   ~2,464 entries: one warp read them one after the other, 8 loads in
//   flight a lane, ~300 dependent rounds of device-memory latency, while the
//   warps of that cell's later chunks sat idle. The kernel was bound by the
//   latency of its longest cell, at 4x the bound.
// - The split. Each row is cut into one segment per warp at equal shares of
//   its estimated walk cost, whatever the cells' lengths: a chunk's real
//   entries are estimated from 8 of its local ids (taken as its first
//   entries), a real entry costs kRealCost and a pad 1, and a cut may fall
//   inside a chunk. A long cell spans many warps; on the ring and long-cell
//   plans the busiest warp takes 1.07-1.10x its row's mean real entries
//   (tools/b3_ablation.py). Every block of a row works out the same cut
//   from one pass of probes into shared memory, with no scan over earlier
//   chunks. The grid is (blocks a row, channel slices,
//   rows), one wave of the card's block slots in all (6 rows: 22 blocks a
//   row, 132 blocks).
// - The walk. A warp reads its segment's plan in batches of 128 entries,
//   two batches ahead, and each entry's channels as whole rows (C = 256 f32:
//   one 1 KB row, 2 x 16 bytes a lane); the rows of kGroup entries are
//   loaded together, one group ahead of the sums, so 8-16 KB a warp are in
//   flight. Cells that begin and end inside the segment are stored at once,
//   and the cells no entry reaches between them zeroed, in whole sectors.
// - The combine, in two steps, each in a fixed order. In the block, as in
//   the slice kernel: every warp leaves its sums of its segment's first
//   cell in shared memory, and after one barrier the warp that holds a
//   cell's first entry in the block adds the later warps' sums of it in warp
//   order. The block's first and last cells may go on in the neighbouring
//   blocks: their sums and ids go to a scratch tensor the wrapper allocates,
//   and the combine kernel, launched after the sorted kernel on the same
//   stream, stores each such cell from the block that holds its first entry,
//   adding the later blocks' sums in block order, and zeroes the cells
//   before the row's first cell, between blocks and after its last. No
//   float atomics, every element written once, the same bits at every
//   launch.
// What is left slow (tools/b3_ablation.py): at 6 ring rows the walk streams
// the feature rows at ~87 % of the card's rate, and a fixed ~0.02 ms goes to
// the probes, the cut and the combine kernel (its launch, the zeros between
// blocks, the cut cells): 0.124 ms against the 0.095 ms bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstddef>

namespace {

constexpr int kSliceWarps = 32;  // slice kernel: warps per block, one segment each
constexpr int kMaxLanes = 8;     // slice kernel: 16-byte units of a pixel per slice
constexpr int kAhead = 4;        // slice kernel: plan entries in flight per lane
constexpr int kProbes = 8;       // plan entries read per chunk to cut segments
constexpr int kPoolWarps = 8;    // sorted kernel: warps per block, one segment each
constexpr int kGroup = 8;        // sorted kernel: entries whose feature rows load together
constexpr int kBatch = 4;        // sorted kernel: plan entries per lane in a batch
constexpr int kRealCost = 4;     // sorted kernel: a real entry's walk cost, in pads
constexpr int kMinSegEntries = 256;  // sorted kernel: plan entries a segment spans, at least on average
constexpr int kMaxRowBlocks = 128;   // sorted kernel: blocks a row, at most
constexpr int kPartsAhead = 16;  // combine kernel: blocks' sums loaded together
constexpr int kZeroTile = 2048;  // combine kernel: cells marked at a time
constexpr unsigned kAll = 0xffffffffu;
static_assert(32 % kGroup == 0 && kBatch > 1, "a batch is rows of 32 entries, whole groups each");

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
// The sorted kernel (B3, and B2 above the shared-memory limit)

// A lane's units of a cell's channels: unit `unit0 + 32 q` of `units` for
// q < U, V channels each, V / 4 float4 a unit; the warp's lanes cover a
// channel slice, so each store instruction writes whole sectors.
template <int U, int V>
__device__ __forceinline__ void store_units(float* cell, int unit0, int units, const float (&acc)[U][V]) {
#pragma unroll
  for (int q = 0; q < U; ++q) {
    if (unit0 + 32 * q >= units) continue;
    float4* o = reinterpret_cast<float4*>(cell + static_cast<size_t>(unit0 + 32 * q) * V);
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      o[i] = make_float4(acc[q][4 * i], acc[q][4 * i + 1], acc[q][4 * i + 2], acc[q][4 * i + 3]);
  }
}

// Zeroes the lane's units of cells [from, to) of a row.
template <int U, int V>
__device__ __forceinline__ void zero_units(float* o_row, int from, int to, int channels, int unit0, int units) {
  const float zero[U][V] = {};
  for (int cell = from; cell < to; ++cell)
    store_units<U, V>(o_row + static_cast<size_t>(cell) * channels, unit0, units, zero);
}

// feats: (rows, feat_rows, channels), per point (B3: feat_rows = P) or per
// pixel (kWeighted, B2: weights (rows, num_points) in the feature type,
// source row p % feat_rows); grid (blocks a row, channel slices, rows), one
// segment of the row per warp; dynamic shared memory: one int a chunk. A
// lane sums U 16-byte units of a channel slice of 32 U units. Scratch, per
// block: partial (rows, blocks a row, 2, channels) f32, the block's sums of
// its first and last cell, and ends (rows, blocks a row, 2) ints, those
// cells (-1: no entry); per segment: entries (rows, segments) ints, its
// real entries.
template <typename T, bool kWeighted, int U>
__global__ void __launch_bounds__(32 * kPoolWarps)
    sorted_kernel(const T* __restrict__ feats, int feat_rows, const T* __restrict__ weights, Plan plan,
                  int channels, float* __restrict__ out, float* __restrict__ partial, int* __restrict__ ends,
                  int* __restrict__ entries) {
  constexpr int V = kVec<T>;
  extern __shared__ int est[];  // per chunk: its real entries, estimated
  __shared__ float s_part[kPoolWarps][U * V][32];  // each warp's sums of its segment's first cell
  __shared__ int s_first[kPoolWarps], s_last[kPoolWarps];  // each segment's first and last cell (-1: none)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.z;
  const int n_seg = gridDim.x * kPoolWarps, s = blockIdx.x * kPoolWarps + warp;
  const int n = plan.n_chunks, t = plan.t;
  const int* bidx = plan.block_idx + static_cast<size_t>(row) * n;
  const size_t plan_row = static_cast<size_t>(row) * n * t;

  // Each chunk's real entries, estimated from kProbes local ids at the
  // middles of its eighths (0 in a window with no output cell).
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int lids[kProbes];
#pragma unroll
    for (int k = 0; k < kProbes; ++k)
      lids[k] = plan.local_ids[plan_row + static_cast<size_t>(j) * t + (2 * k + 1) * static_cast<long long>(t) /
                                                                            (2 * kProbes)];
    int real = 0;
#pragma unroll
    for (int k = 0; k < kProbes; ++k) real += lids[k] >= 0;
    est[j] = window_start(plan, bidx[j]) < 0 ? 0 : static_cast<int>(static_cast<long long>(real) * t / kProbes);
  }
  __syncthreads();

  // This warp's segment [begin, end) of the row's entries (chunk j's entry i
  // is j * t + i): the row cut at equal shares of its estimated walk cost,
  // kRealCost a real entry and 1 a pad, with a chunk's estimated real
  // entries taken as its first. Each lane sums a run of chunks; every warp
  // of the row works out the same cuts.
  auto cost = [&](int j) { return static_cast<long long>(kRealCost - 1) * est[j] + t; };
  const int per = (n + 31) / 32;
  const int j0 = min(lane * per, n), j1 = min(j0 + per, n);
  long long mine = 0;
  for (int j = j0; j < j1; ++j) mine += cost(j);
  long long incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const long long v = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += v;
  }
  const long long total = __shfl_sync(kAll, incl, 31);
  auto cut = [&](int k) {  // the first entry of segment k
    if (k == 0) return 0;
    const long long target = total * k / n_seg;
    long long before = incl - mine;
    int at = -1;
    for (int j = j0; at < 0 && j < j1 && before <= target; ++j) {
      const long long c = cost(j), o = target - before, r = est[j];
      if (o < c) at = j * t + static_cast<int>(o < kRealCost * r ? o / kRealCost : r + o - kRealCost * r);
      before += c;
    }
    at = __reduce_max_sync(kAll, at);
    return at < 0 ? n * t : at;
  };
  const int begin = cut(s), end = cut(s + 1);

  const int units = channels / V;                 // 16-byte units of a row's channels
  const int unit0 = blockIdx.y * 32 * U + lane;   // this lane's first
  const T* f_row = feats + static_cast<size_t>(row) * feat_rows * channels;
  const T* w_row = kWeighted ? weights + static_cast<size_t>(row) * plan.num_points : nullptr;
  float* o_row = out + static_cast<size_t>(row) * plan.num_cells * channels;
  const float inv_rows = 1.f / feat_rows;

  // The plan in batches of 32 x kBatch entries (lane l holds entries l,
  // l + 32, ...), loaded two batches ahead of the sums: `lid`, `point` and
  // `cell0` hold the batch after next.
  int at = begin;
  int lid[kBatch], point[kBatch], cell0[kBatch];
  auto load = [&]() {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = 32 * u + lane;
      lid[u] = -1;
      point[u] = 0;
      cell0[u] = -1;
      if (i < end - at) {
        lid[u] = plan.local_ids[plan_row + at + i];
        point[u] = plan.point_idx[plan_row + at + i];
        cell0[u] = window_start(plan, bidx[(at + i) / t]);
      }
    }
    at += min(32 * kBatch, end - at);
  };
  // A batch's entries: cell (-1: none), feature row and weight, one per lane
  // and batch row u.
  struct Keys {
    int cell[kBatch], src[kBatch];
    float w[kBatch];
  };
  auto resolve = [&]() {
    Keys k;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      k.cell[u] = cell0[u] < 0 ? -1 : cell_of(plan, lid[u], point[u], cell0[u]);
      k.src[u] = 0;
      k.w[u] = 1.f;
      if (k.cell[u] >= 0) {
        k.src[u] = kWeighted ? mod_by(point[u], feat_rows, inv_rows) : point[u];
        if constexpr (kWeighted) k.w[u] = to_float(w_row[point[u]]);
      }
    }
    return k;
  };
  // kGroup consecutive entries, group g of a batch row whose entries the
  // lanes hold in (cell, src, w): every lane's units of their feature rows.
  struct Group {
    uint4 f[kGroup][U];
    int cell[kGroup];
    float w[kGroup];
  };
  auto issue = [&](int cell, int src, float w, int g) {
    Group G;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int from = g * kGroup + j;
      G.cell[j] = __shfl_sync(kAll, cell, from);
      const int r = __shfl_sync(kAll, src, from);
      G.w[j] = kWeighted ? __shfl_sync(kAll, w, from) : 1.f;
      const uint4* f = reinterpret_cast<const uint4*>(f_row + static_cast<size_t>(r) * channels);
#pragma unroll
      for (int q = 0; q < U; ++q)
        G.f[j][q] = G.cell[j] >= 0 && unit0 + 32 * q < units ? __ldcs(f + unit0 + 32 * q) : make_uint4(0, 0, 0, 0);
    }
    return G;
  };

  float acc[U][V] = {};
  int head = -1, cur = -1, count = 0;  // the segment's first cell, the cell `acc` sums (-1: none yet)
  auto keep = [&]() {  // acc, the sums of the segment's first cell, to shared memory
#pragma unroll
    for (int q = 0; q < U; ++q)
#pragma unroll
      for (int v = 0; v < V; ++v) s_part[warp][q * V + v][lane] = acc[q][v];
  };
  auto add_entry = [&](const Group& G, int j) {
#pragma unroll
    for (int q = 0; q < U; ++q)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[q][v] = fmaf(G.w[j], unpack<T>(G.f[j][q], v), acc[q][v]);
  };
  // Adds a group's entries. A cell that ends here and is not the segment's
  // first is the segment's alone: it is stored, and the unreached cells
  // between it and the next are zeroed; the first cell's sums are kept.
  auto sum = [&](const Group& G) {
    int real = 0;
    bool same = true;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      real += G.cell[j] >= 0;
      same &= G.cell[j] < 0 || G.cell[j] == cur;
    }
    count += real;
    if (!real) return;
    if (same) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (G.cell[j] >= 0) add_entry(G, j);
      return;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int c = G.cell[j];
      if (c < 0) continue;
      if (c != cur) {
        if (cur >= 0) {
          if (cur == head) {
            keep();
          } else {
            store_units<U, V>(o_row + static_cast<size_t>(cur) * channels, unit0, units, acc);
          }
          zero_units<U, V>(o_row, cur + 1, c, channels, unit0, units);
        } else {
          head = c;
        }
        cur = c;
#pragma unroll
        for (int q = 0; q < U; ++q)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[q][v] = 0.f;
      }
      add_entry(G, j);
    }
  };

  // The walk: each step loads the rows of the next group and sums the
  // current one; the last group of a batch is followed by the next batch's
  // first. The batch's rows move down one at the end of each, so that the
  // current row is always row 0. A batch with no real entry is skipped.
  constexpr int kRowGroups = 32 / kGroup, kSteps = kBatch * kRowGroups;
  const int n_batches = (end - begin + 32 * kBatch - 1) / (32 * kBatch);
  load();
  Keys now = resolve();
  load();
  Keys next = resolve();
  load();
  Group g_now = issue(now.cell[0], now.src[0], now.w[0], 0);
  for (int b = 0; b < n_batches; ++b) {
    bool real = false;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) real |= now.cell[u] >= 0;
    if (__any_sync(kAll, real)) {
#pragma unroll 1
      for (int step = 1; step <= kSteps; ++step) {
        const bool row_end = step % kRowGroups == 0;
        int c = row_end ? now.cell[1] : now.cell[0], r = row_end ? now.src[1] : now.src[0];
        float w = row_end ? now.w[1] : now.w[0];
        if (step == kSteps) {
          c = next.cell[0];
          r = next.src[0];
          w = next.w[0];
        }
        const Group g_next = issue(c, r, w, step % kRowGroups);
        sum(g_now);
        g_now = g_next;
        if (row_end) {
#pragma unroll
          for (int u = 0; u + 1 < kBatch; ++u) {
            now.cell[u] = now.cell[u + 1];
            now.src[u] = now.src[u + 1];
            now.w[u] = now.w[u + 1];
          }
        }
      }
    } else {
      g_now = issue(next.cell[0], next.src[0], next.w[0], 0);
    }
    now = next;
    next = resolve();
    load();
  }
  if (cur >= 0 && cur == head) keep();
  if (lane == 0) {
    s_first[warp] = head;
    s_last[warp] = cur;
    if (blockIdx.y == 0) entries[static_cast<size_t>(row) * n_seg + s] = count;
  }
  __syncthreads();

  // The block's combine, as the slice kernel's: the warp that holds a
  // cell's first entry in the block adds the later warps' sums of it in warp
  // order. The block's first and last cells may go on in the neighbouring
  // blocks: their sums go to the scratch, for the combine kernel; every other
  // cell is stored, and the unreached cells between warps zeroed.
  int prev = -1, first = -1, last = -1;  // the last cell before this warp's; the block's first and last
  for (int k = 0; k < kPoolWarps; ++k) {
    if (s_last[k] < 0) continue;
    if (first < 0) first = s_first[k];
    last = s_last[k];
    if (k < warp) prev = s_last[k];
  }
  const size_t unit = static_cast<size_t>(row) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && blockIdx.y == 0) {
    ends[unit * 2] = first;
    ends[unit * 2 + 1] = last;
  }
  if (cur < 0) return;
  auto add_later = [&](float (&sum)[U][V], int cell) {  // the later warps' sums of `cell`
    for (int k = warp + 1; k < kPoolWarps; ++k) {
      if (s_last[k] < 0) continue;
      if (s_first[k] != cell) break;
#pragma unroll
      for (int q = 0; q < U; ++q)
#pragma unroll
        for (int v = 0; v < V; ++v) sum[q][v] += s_part[k][q * V + v][lane];
      if (s_last[k] != cell) break;
    }
  };
  auto dest = [&](int cell) {
    return cell == first  ? partial + unit * 2 * channels
           : cell == last ? partial + (unit * 2 + 1) * channels
                          : o_row + static_cast<size_t>(cell) * channels;
  };
  if (head != prev) {  // the first cell starts here
    if (prev >= 0) zero_units<U, V>(o_row, prev + 1, head, channels, unit0, units);
    float sum[U][V];
#pragma unroll
    for (int q = 0; q < U; ++q)
#pragma unroll
      for (int v = 0; v < V; ++v) sum[q][v] = s_part[warp][q * V + v][lane];
    if (head == cur) add_later(sum, head);
    store_units<U, V>(dest(head), unit0, units, sum);
  }
  if (cur != head) {
    add_later(acc, cur);
    store_units<U, V>(dest(cur), unit0, units, acc);
  }
}

// After the sorted kernel, on its grid: block x of a row zeroes the cells in
// its share of the row that no block reaches (before the row's first cell,
// between blocks and after its last), and stores the sorted kernel's block
// x's first and last cell where that block holds the cell's first entry,
// adding the later blocks' sums of it in block order (warps 0 and 1).
template <typename T, int U>
__global__ void __launch_bounds__(32 * kPoolWarps)
    combine_kernel(const float* __restrict__ partial, const int* __restrict__ ends, int num_cells, int channels,
                   float* __restrict__ out) {
  constexpr int V = kVec<T>;
  __shared__ int s_head[kMaxRowBlocks], s_tail[kMaxRowBlocks], s_prev[kMaxRowBlocks + 1];
  __shared__ unsigned char s_zero[kZeroTile];  // per cell of a tile: unreached
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.z, n = gridDim.x, x = blockIdx.x;
  const int units = channels / V, unit0 = blockIdx.y * 32 * U + lane;
  const int* e_row = ends + static_cast<size_t>(row) * n * 2;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_head[i] = e_row[2 * i];
    s_tail[i] = e_row[2 * i + 1];
  }
  __syncthreads();
  // s_prev[b]: the last cell of the blocks before b (-1: none), the largest
  // of their last cells; s_prev[n]: the row's last cell.
  if (warp == 0) {
    const int per = (n + 31) / 32;
    const int b0 = min(lane * per, n), b1 = min(b0 + per, n);
    int run = -1;
    for (int b = b0; b < b1; ++b) run = max(run, s_tail[b]);
    int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int v = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl = max(incl, v);
    }
    int before = __shfl_up_sync(kAll, incl, 1);
    if (lane == 0) before = -1;
    for (int b = b0; b < b1; ++b) {
      s_prev[b] = before;
      before = max(before, s_tail[b]);
    }
    if (lane == 31) s_prev[n] = incl;
  }
  __syncthreads();

  // The unreached cells of the block's share [lo, hi) of the row, kZeroTile
  // at a time: the warps mark the gaps (before each block's first cell, and
  // after the row's last) in shared memory, then every thread zeroes float4s
  // of the marked cells' slice.
  float* o_row = out + static_cast<size_t>(row) * num_cells * channels;
  const int lo = static_cast<int>(static_cast<long long>(x) * num_cells / n);
  const int hi = static_cast<int>(static_cast<long long>(x + 1) * num_cells / n);
  const int slice_unit = blockIdx.y * 32 * U, quads = min(32 * U, units - slice_unit) * (V / 4);
  for (int t0 = lo; t0 < hi; t0 += kZeroTile) {
    const int t1 = min(t0 + kZeroTile, hi);
    for (int i = threadIdx.x; i < t1 - t0; i += blockDim.x) s_zero[i] = 0;
    __syncthreads();
    for (int b = warp; b <= n; b += kPoolWarps) {
      const int h = b < n ? s_head[b] : num_cells;
      if (h < 0) continue;
      for (int cell = max(s_prev[b] + 1, t0) + lane; cell < min(h, t1); cell += 32) s_zero[cell - t0] = 1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (t1 - t0) * quads; i += blockDim.x) {
      const int cell = t0 + i / quads;
      if (s_zero[cell - t0])
        reinterpret_cast<float4*>(o_row + static_cast<size_t>(cell) * channels + slice_unit * V)[i % quads] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
  }

  const int head = s_head[x], tail = s_tail[x];
  // warp 0: block x's first cell, where the block holds its first entry;
  // warp 1: its last cell, where that is another
  const int which = warp;
  const int cell = which == 0 ? head : tail;
  if (warp > 1 || head < 0 || (which == 0 && s_prev[x] == head) || (which == 1 && tail == head)) return;
  const float* p_row = partial + static_cast<size_t>(row) * n * 2 * channels;
  auto part = [&](int b, int k, int q) {  // block b's sums (k = 0: of its first cell, 1: its last), unit q
    return reinterpret_cast<const float4*>(p_row + (static_cast<size_t>(b) * 2 + k) * channels +
                                           static_cast<size_t>(unit0 + 32 * q) * V);
  };
  float acc[U][V];
#pragma unroll
  for (int q = 0; q < U; ++q)
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 v = unit0 + 32 * q < units ? part(x, which, q)[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[q][4 * i] = v.x, acc[q][4 * i + 1] = v.y, acc[q][4 * i + 2] = v.z, acc[q][4 * i + 3] = v.w;
    }
  // The later blocks that hold the cell: up to the first that starts with
  // another cell, or goes on past this one.
  int stop = x + 1;
  for (; stop < n; ++stop) {
    if (s_head[stop] < 0) continue;
    if (s_head[stop] != cell) break;
    if (s_tail[stop] != cell) {
      ++stop;
      break;
    }
  }
  // -0.0 in place of a sum that is not there adds nothing, bit for bit
  for (int b = x + 1; b < stop; b += kPartsAhead) {
    float4 v[kPartsAhead][U][V / 4];
#pragma unroll
    for (int j = 0; j < kPartsAhead; ++j) {
      const bool has = b + j < stop && s_head[b + j] == cell;
#pragma unroll
      for (int q = 0; q < U; ++q)
#pragma unroll
        for (int i = 0; i < V / 4; ++i)
          v[j][q][i] = has && unit0 + 32 * q < units ? part(b + j, 0, q)[i] : make_float4(-0.f, -0.f, -0.f, -0.f);
    }
#pragma unroll
    for (int j = 0; j < kPartsAhead; ++j)
#pragma unroll
      for (int q = 0; q < U; ++q)
#pragma unroll
        for (int i = 0; i < V / 4; ++i) {
          acc[q][4 * i] += v[j][q][i].x;
          acc[q][4 * i + 1] += v[j][q][i].y;
          acc[q][4 * i + 2] += v[j][q][i].z;
          acc[q][4 * i + 3] += v[j][q][i].w;
        }
  }
  store_units<U, V>(o_row + static_cast<size_t>(cell) * channels, unit0, units, acc);
}

// ---------------------------------------------------------------------------
// Launch

// Lanes per entry of the slice kernel for B2 (16-byte units of a pixel's
// channels per slice), 0 for the sorted kernel: as many as the channels need
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


// How the sorted kernel runs at a shape: 16-byte units a lane (1 or 2),
// channel slices of 32 lanes, blocks a row (one segment per warp).
struct SortedShape {
  int lane_units;
  int slices;
  int row_blocks;
  int per_sm;  // resident blocks per SM
  int segments() const { return row_blocks * kPoolWarps; }
};

// One wave of the card's block slots over rows x slices (at least one block
// each), and no more blocks than give each segment kMinSegEntries of plan.
template <typename T>
SortedShape sorted_shape(int rows, int n_chunks, int chunk_points, int channels, long long slots) {
  const int units = channels / kVec<T>;
  SortedShape sh{};
  sh.lane_units = units > 32 ? 2 : 1;
  sh.slices = (units + 32 * sh.lane_units - 1) / (32 * sh.lane_units);
  const long long lines = static_cast<long long>(rows) * sh.slices;
  const long long fill = (static_cast<long long>(n_chunks) * chunk_points + kPoolWarps * kMinSegEntries - 1) /
                         (kPoolWarps * kMinSegEntries);
  sh.row_blocks = static_cast<int>(std::max(1LL, std::min({slots / lines, fill, static_cast<long long>(kMaxRowBlocks)})));
  return sh;
}

// The sorted kernel's scratch: partial, ends, entries (see sorted_kernel).
size_t sorted_scratch(int rows, int channels, const SortedShape& sh) {
  const size_t blocks = static_cast<size_t>(rows) * sh.row_blocks;
  return blocks * 2 * (channels * sizeof(float) + sizeof(int)) + static_cast<size_t>(rows) * sh.segments() * sizeof(int);
}

template <typename T, bool kWeighted, int U>
int launch_sorted(const T* f, int feat_rows, const T* w, const Plan& plan, int rows, int channels, float* o,
                  void* scratch, cudaStream_t stream, int sms, SortedShape* shape) {
  const size_t smem = static_cast<size_t>(plan.n_chunks) * sizeof(int);
  auto kernel = sorted_kernel<T, kWeighted, U>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kPoolWarps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  SortedShape sh = sorted_shape<T>(rows, plan.n_chunks, plan.t, channels, static_cast<long long>(sms) * per_sm);
  sh.per_sm = per_sm;
  if (shape) {  // a query: no launch
    *shape = sh;
    return 0;
  }
  if (!scratch) return static_cast<int>(cudaErrorInvalidValue);
  const size_t blocks = static_cast<size_t>(rows) * sh.row_blocks;
  float* partial = static_cast<float*>(scratch);
  int* ends = reinterpret_cast<int*>(partial + blocks * 2 * channels);
  int* entries = ends + blocks * 2;
  const dim3 grid(sh.row_blocks, sh.slices, rows);
  kernel<<<grid, 32 * kPoolWarps, smem, stream>>>(f, feat_rows, w, plan, channels, o, partial, ends, entries);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  combine_kernel<T, U><<<grid, 32 * kPoolWarps, 0, stream>>>(partial, ends, plan.num_cells, channels, o);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kWeighted>
int launch_sorted(const T* f, int feat_rows, const T* w, const Plan& plan, int rows, int channels, float* o,
                  void* scratch, cudaStream_t stream, int sms, SortedShape* shape = nullptr) {
  if (channels / kVec<T> > 32)
    return launch_sorted<T, kWeighted, 2>(f, feat_rows, w, plan, rows, channels, o, scratch, stream, sms, shape);
  return launch_sorted<T, kWeighted, 1>(f, feat_rows, w, plan, rows, channels, o, scratch, stream, sms, shape);
}

template <typename T>
int launch(const void* feats, int feat_rows, const void* weights, const Plan& plan, int rows,
           int channels, void* out, void* scratch, cudaStream_t stream) {
  constexpr int vec = kVec<T>;
  if (channels % vec || reinterpret_cast<size_t>(feats) % 16 || reinterpret_cast<size_t>(out) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto f = static_cast<const T*>(feats);
  const auto w = static_cast<const T*>(weights);
  const auto o = static_cast<float*>(out);
  int sms = 0;
  size_t max_smem = 0;
  if (const int err = device_limits(&sms, &max_smem)) return err;
  if (!weights) return launch_sorted<T, false>(f, feat_rows, w, plan, rows, channels, o, scratch, stream, sms);
  const int lanes = slice_lanes<T>(rows, feat_rows, plan.n_chunks, channels, sms, max_smem);
  if (lanes) return launch_slices<T>(lanes, f, feat_rows, w, plan, rows, channels, o, stream);
  return launch_sorted<T, true>(f, feat_rows, w, plan, rows, channels, o, scratch, stream, sms);
}

// The sorted kernel's shape for a launch (row_blocks 0: B2 with `weighted`
// takes the slice kernel).
template <typename T>
int sorted_query(int weighted, int rows, int feat_rows, const Plan& plan, int channels, int sms, size_t max_smem,
                 SortedShape* sh) {
  if (!weighted) return launch_sorted<T, false>(nullptr, feat_rows, nullptr, plan, rows, channels, nullptr,
                                                nullptr, nullptr, sms, sh);
  if (slice_lanes<T>(rows, feat_rows, plan.n_chunks, channels, sms, max_smem)) return 0;
  return launch_sorted<T, true>(nullptr, feat_rows, nullptr, plan, rows, channels, nullptr, nullptr, nullptr, sms,
                                sh);
}

bool valid_shape(int rows, int feat_rows, int n_chunks, int chunk_points, int window, int num_cells,
                 int num_points, int channels) {
  return rows >= 1 && rows <= 65535 && n_chunks >= 1 && chunk_points >= 1 && window >= 1 && num_cells >= 1 &&
         num_points >= 1 && channels >= 1 && feat_rows >= 1 &&
         static_cast<long long>(n_chunks) * chunk_points <= INT_MAX;  // a row's entries index as int
}

}  // namespace

extern "C" {

// Launches one pool on `stream`; returns the cudaError_t of the launch
// (0 = success). weights == null: B3 (features (rows, num_points, C) per
// point); otherwise B2 (features (rows, feat_rows, C) per pixel, weights
// (rows, num_points) in the feature type). Plan arrays are int32. C must be
// a multiple of 16 bytes' worth of channels (4 f32, 8 bf16) and the
// features and the output 16-byte aligned. `scratch`: device memory of the
// size `bev_pool_sorted_config` gives, for the launches that take the sorted
// kernel (null where it gives 0 bytes).
int bev_pool_forward(int is_bf16, const void* feats, int feat_rows, const void* weights,
                     const void* point_idx, const void* local_ids, const void* block_idx,
                     int rows, int n_chunks, int chunk_points, int window, int num_cells,
                     int num_points, int channels, void* out, void* stream, void* scratch) {
  if (!valid_shape(rows, feat_rows, n_chunks, chunk_points, window, num_cells, num_points, channels))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan{static_cast<const int*>(point_idx), static_cast<const int*>(local_ids),
                  static_cast<const int*>(block_idx), n_chunks, chunk_points, window,
                  num_cells, num_points};
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(feats, feat_rows, weights, plan, rows, channels, out, scratch, s);
  return launch<float>(feats, feat_rows, weights, plan, rows, channels, out, scratch, s);
}

// How B2 runs at a shape, launching nothing: config[0] the channels of a
// slice (0: the sorted kernel), config[1] slice blocks per SM, config[2]
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

// How a launch runs the sorted kernel (B3, or B2 with `weighted` where its
// rows do not fit the slice kernel), launching nothing: config[0] segments
// (warps) a row, config[1] the grid's blocks, config[2] blocks per SM,
// config[3] the scratch bytes `bev_pool_forward` needs, config[4] channel
// slices; all 0 where B2 takes the slice kernel. Returns a cudaError_t.
int bev_pool_sorted_config(int is_bf16, int weighted, int rows, int feat_rows, int n_chunks,
                           int chunk_points, int channels, long long* config) {
  for (int i = 0; i < 5; ++i) config[i] = 0;
  if (!valid_shape(rows, feat_rows, n_chunks, chunk_points, 1, 1, 1, channels) ||
      channels % (is_bf16 ? kVec<__nv_bfloat16> : kVec<float>))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  size_t max_smem = 0;
  if (const int err = device_limits(&sms, &max_smem)) return err;
  const Plan plan{nullptr, nullptr, nullptr, n_chunks, chunk_points, 1, 1, 1};
  SortedShape sh{};
  const int err = is_bf16 ? sorted_query<__nv_bfloat16>(weighted, rows, feat_rows, plan, channels, sms, max_smem, &sh)
                          : sorted_query<float>(weighted, rows, feat_rows, plan, channels, sms, max_smem, &sh);
  if (err || !sh.row_blocks) return err;
  config[0] = sh.segments();
  config[1] = static_cast<long long>(sh.row_blocks) * sh.slices * rows;
  config[2] = sh.per_sm;
  config[3] = static_cast<long long>(sorted_scratch(rows, channels, sh));
  config[4] = sh.slices;
  return 0;
}

const char* bev_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
