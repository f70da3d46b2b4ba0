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
// inside one window of W cells, block_idx (the chunk's window) non-decreasing.
// Pads are point index == P and local id == -1 and add nothing. Output is f32
// (rows, num_cells, C); cells >= num_cells are dropped. The products are
// exact in f32 for bf16 inputs and summed in f32, so this kernel and its
// plain version (`ops/bev_pool.py`) differ only in summation order.
//
// What the TPU kernel did and this one does not: the TPU has no fast
// scatter, so its wrapper gathers a (n_chunks, T, C) tensor into HBM and
// every chunk becomes a dense (T, W) one-hot matmul on the MXU: 30 MB and
// ~7.7 GFLOP per camera row for a sum whose real work is ~2 * points * C.
//
// Bound on an H100: bytes. At the eval shape (48 rows, 56,000 frustum
// points, 28x50 pixels, C = 256, 50x50 cells) the pool reads ~34 MB of bf16
// features, ~22 MB of plan and a few MB of weights, and writes 123 MB of f32
// output, against about 1 GFLOP: ~0.06 ms at 3.35 TB/s.
//
// Design (simple first):
// - one warp per chunk, each lane 16 bytes of channels (8 bf16 or 4 f32):
//   a feature row is read in 16-byte loads, coalesced across the warp,
//   straight from device memory (a pixel's row serves up to D entries and
//   stays in L2), and the per-entry work (its cell, source row and weight
//   from shared memory, the compare, the address) is paid once per 8 or 4
//   channels. Warps follow the plan's chunks, not its windows: on a real
//   calibration a few windows near the ego hold most entries (25,928 of a
//   ring row's 47,600 in one window), and one block per window made that
//   window the whole kernel;
// - the entries of a window run in cell order across its chunks, so each
//   cell has one owner, the chunk that holds its first entry. The owner
//   sums the cell in registers, reading on into the next chunks of the
//   window while the cell goes on, and stores it once; it also writes 0 to
//   the cells no entry reaches between the previous cell and its own, and,
//   for the window's last cell, up to the window's end (the first chunk of
//   a window with no entry zeroes all of it). So every output element is
//   written exactly once, in a fixed order, with no atomics. The order rests
//   on the plan's sort, which `precompute_bev_chunks` guarantees;
// - a warp stages 256 entries at a time in shared memory (one coalesced
//   pass over the plan and the weights) and issues its feature loads 8
//   entries ahead of the sums.
// What this leaves slow: the owner of a long cell walks it alone (up to
// 2,464 entries in a ring row), and every entry gathers its whole feature
// row from L2, 512 bytes (bf16) for C = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 4;        // chunks per block, one warp each
constexpr int kSpan = 256;       // plan entries a warp stages per pass
constexpr int kLoadsAhead = 8;   // 16-byte feature loads in flight per lane
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

// The output cell of plan entry `e` of a window starting at `cell0`, or -1
// for a pad, an id outside the window or a cell past num_cells.
__device__ __forceinline__ int entry_cell(const Plan& plan, size_t e, int cell0, int* point) {
  const int lid = plan.local_ids[e];
  const int p = plan.point_idx[e];
  *point = p;
  const bool real = lid >= 0 && lid < plan.window && p >= 0 && p < plan.num_points &&
                    cell0 + lid < plan.num_cells;
  return real ? cell0 + lid : -1;
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

// feats: (rows, feat_rows, channels); weights: (rows, num_points) or null.
// channels is a multiple of kVec<T>, feats and out 16-byte aligned.
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(32 * kWarps)
    bev_pool_kernel(const T* __restrict__ feats, int feat_rows, const T* __restrict__ weights,
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

template <typename T>
int launch(const void* feats, int feat_rows, const void* weights, const Plan& plan, int rows,
           int channels, void* out, cudaStream_t stream) {
  constexpr int vec = kVec<T>;
  if (channels % vec || reinterpret_cast<size_t>(feats) % 16 || reinterpret_cast<size_t>(out) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((plan.n_chunks + kWarps - 1) / kWarps, (channels + 32 * vec - 1) / (32 * vec),
                  rows);
  const auto f = static_cast<const T*>(feats);
  const auto w = static_cast<const T*>(weights);
  const auto o = static_cast<float*>(out);
  if (weights)
    bev_pool_kernel<T, true><<<grid, 32 * kWarps, 0, stream>>>(f, feat_rows, w, plan, channels, o);
  else
    bev_pool_kernel<T, false><<<grid, 32 * kWarps, 0, stream>>>(f, feat_rows, w, plan, channels, o);
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
      num_cells < 1 || num_points < 1 || channels < 1 || feat_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan{static_cast<const int*>(point_idx), static_cast<const int*>(local_ids),
                  static_cast<const int*>(block_idx), n_chunks, chunk_points, window,
                  num_cells, num_points};
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(feats, feat_rows, weights, plan, rows, channels, out, s);
  return launch<float>(feats, feat_rows, weights, plan, rows, channels, out, s);
}

const char* bev_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
