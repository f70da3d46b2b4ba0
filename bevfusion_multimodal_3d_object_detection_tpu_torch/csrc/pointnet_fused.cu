// Fused PointNet for Hopper (sm_90a): the whole shared-MLP chain plus the
// global max over points, in one pass over the point buffer.
//
// Replaces the TPU kernel `fused_pointnet` (body `_kernel`) of
// bevfusion_multimodal_3d_object_detection_tpu/ops/pointnet_pallas.py:71-183.
// Same function: (B, N, C_in) points -> (B, feat) f32. Every layer is
// Dense + ReLU with inference BatchNorm already folded into the weights,
// accumulated in f32 with an f32 bias and cast to the working type (bf16 or
// f32) before the next layer. The max runs over exactly the N points given:
// rows this kernel adds for its own tiling never take part (the TPU wrapper
// pads N with zero rows that do, when mask_padding is off). With
// mask_padding, all-zero input rows are excluded and a row whose points are
// all masked gives 0.
//
// Bound on an H100: at the LiDAR shape (35,000 points, 4->64->128->256->
// 512->1024) the chain is ~48.8 GFLOP per sample against ~0.3 MB of input,
// so it is bound by operations (8 samples in bf16 need >= ~0.39 ms at
// 989 TFLOP/s dense). The radar shape (125 points, 7->32->64->128->256) is
// ~54 MFLOP per sample and bound by launch latency.
//
// Design (simple first):
// - grid (tiles of P points, batch rows); one CTA pushes its tile through
//   every layer with the activations in shared memory as ping-pong buffers
//   in the working type, so no intermediate ever reaches device memory;
// - weights are read from global memory (1.4 MB in bf16 for LiDAR, which
//   stays resident in the 50 MB L2);
// - bf16 layers whose widths are multiples of 16 run on the tensor cores
//   (WMMA 16x16x16, f32 accumulate, through an f32 staging tile for the
//   epilogue); the thin first layer (C_in = 4 or 7) and every f32 layer run
//   as f32 FMA loops, so the f32 path is exact f32 (no TF32);
// - the last layer's output is never stored: each column is max-reduced over
//   the tile into a (B, tiles, feat) f32 partial buffer, and a second small
//   kernel reduces over tiles (deterministic, no float atomics) and maps the
//   all-masked sentinel to 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;  // masked-row sentinel (pointnet_pallas._NEG)
constexpr int kStageCols = 128;
constexpr int kStageLd = kStageCols + 4;
constexpr int kColLanes = 64;  // FMA path: columns per pass
constexpr int kRowGroups = kThreads / kColLanes;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one block may use

struct Params {
  const void* points;
  int n;
  int num_layers;
  int width[kMaxLayers + 1];  // width[0] = C_in, width[l + 1] = layer l out
  const void* w[kMaxLayers];  // (width[l], width[l + 1]) row-major
  const float* b[kMaxLayers];
  int mask_padding;
  int tiles;
  int stride;      // activation row stride in elements
  float* partial;  // (batch, tiles, feat)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int kPoints = 32;
  static constexpr int kPad = 4;
  static constexpr bool kWmma = false;
};
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kPoints = 64;  // the WMMA warp layout assumes 64
  static constexpr int kPad = 8;
  static constexpr bool kWmma = true;
};

// One layer as f32 FMA loops. Thread t owns column j0 + t % 64 and rows
// (t / 64) * R .. + R of the tile.
template <typename T, int P>
__device__ void fma_layer(const T* in, T* out, int stride, int K, int N,
                          const T* W, const float* B, bool last,
                          const unsigned char* valid, float* colred,
                          float* part) {
  constexpr int R = P / kRowGroups;
  const int lc = threadIdx.x % kColLanes;
  const int grp = threadIdx.x / kColLanes;
  const T* a = in + grp * R * stride;
  for (int j0 = 0; j0 < N; j0 += kColLanes) {
    const int j = j0 + lc;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if (j < N) {
      for (int k = 0; k < K; ++k) {
        const float w = to_f(W[static_cast<size_t>(k) * N + j]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(to_f(a[r * stride + k]), w, acc[r]);
      }
    }
    const float bias = j < N ? B[j] : 0.f;
    if (!last) {
      if (j < N) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          out[(grp * R + r) * stride + j] = from_f<T>(fmaxf(acc[r] + bias, 0.f));
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

// One bf16 layer on the tensor cores. The 64-row tile times a 128-column
// slab of W is split over 8 warps as 2 (rows) x 4 (columns) blocks of 32x32,
// each 2x2 WMMA fragments. A comes from shared memory, B straight from
// global memory (L2-resident weights).
__device__ void wmma_layer(const __nv_bfloat16* in, __nv_bfloat16* out,
                           int stride, int K, int N, const __nv_bfloat16* W,
                           const float* B, bool last,
                           const unsigned char* valid, float* stage,
                           float* part) {
  using namespace nvcuda;
  constexpr int P = Tile<__nv_bfloat16>::kPoints;
  const int warp = threadIdx.x / 32;
  const int r0 = (warp % 2) * 32;
  for (int n0 = 0; n0 < N; n0 += kStageCols) {
    const int c0 = n0 + (warp / 2) * 32;
    const bool col_ok[2] = {c0 < N, c0 + 16 < N};
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) wmma::fill_fragment(acc[i][jj], 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::load_matrix_sync(a[0], in + r0 * stride + k0, stride);
      wmma::load_matrix_sync(a[1], in + (r0 + 16) * stride + k0, stride);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (!col_ok[jj]) continue;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, W + static_cast<size_t>(k0) * N + c0 + 16 * jj, N);
        wmma::mma_sync(acc[0][jj], a[0], bf, acc[0][jj]);
        wmma::mma_sync(acc[1][jj], a[1], bf, acc[1][jj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        if (col_ok[jj])
          wmma::store_matrix_sync(stage + (r0 + 16 * i) * kStageLd + (c0 - n0) + 16 * jj,
                                  acc[i][jj], kStageLd, wmma::mem_row_major);
    __syncthreads();
    const int width = min(kStageCols, N - n0);
    if (!last) {
      for (int e = threadIdx.x; e < P * width; e += kThreads) {
        const int r = e / width;
        const int c = e - r * width;
        out[r * stride + n0 + c] =
            __float2bfloat16(fmaxf(stage[r * kStageLd + c] + B[n0 + c], 0.f));
      }
    } else if (threadIdx.x < width) {
      const int c = threadIdx.x;
      const float bias = B[n0 + c];
      float m = kNeg;
      for (int r = 0; r < P; ++r) {
        if (valid[r])
          m = fmaxf(m, __bfloat162float(__float2bfloat16(
                           fmaxf(stage[r * kStageLd + c] + bias, 0.f))));
      }
      part[n0 + c] = m;
    }
    __syncthreads();
  }
}

template <typename T>
constexpr size_t smem_bytes(int stride) {
  return 2 * static_cast<size_t>(Tile<T>::kPoints) * stride * sizeof(T) +
         (Tile<T>::kWmma ? static_cast<size_t>(Tile<T>::kPoints) * kStageLd * sizeof(float) : 0) +
         kRowGroups * kColLanes * sizeof(float) + Tile<T>::kPoints;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pointnet_tile_kernel(Params prm) {
  constexpr int P = Tile<T>::kPoints;
  extern __shared__ __align__(128) unsigned char smem[];
  const int stride = prm.stride;
  T* buf0 = reinterpret_cast<T*>(smem);
  T* buf1 = buf0 + P * stride;
  float* stage = reinterpret_cast<float*>(buf1 + P * stride);
  float* colred = stage + (Tile<T>::kWmma ? P * kStageLd : 0);
  unsigned char* valid = reinterpret_cast<unsigned char*>(colred + kRowGroups * kColLanes);

  const int tile = blockIdx.x;
  const int row = blockIdx.y;
  const int c_in = prm.width[0];
  const int p0 = tile * P;
  const int n_here = min(P, prm.n - p0);
  const T* pts = static_cast<const T*>(prm.points) +
                 (static_cast<size_t>(row) * prm.n + p0) * c_in;
  for (int e = threadIdx.x; e < P * c_in; e += kThreads) {
    const int p = e / c_in;
    buf0[p * stride + (e - p * c_in)] = p < n_here ? pts[e] : from_f<T>(0.f);
  }
  __syncthreads();
  if (threadIdx.x < P) {
    const int p = threadIdx.x;
    bool v = p < n_here;
    if (v && prm.mask_padding) {
      bool any = false;
      for (int c = 0; c < c_in; ++c) any |= to_f(buf0[p * stride + c]) != 0.f;
      v = any;
    }
    valid[p] = v;
  }
  __syncthreads();

  const int feat = prm.width[prm.num_layers];
  float* part = prm.partial + (static_cast<size_t>(row) * prm.tiles + tile) * feat;
  T* in = buf0;
  T* out = buf1;
  for (int l = 0; l < prm.num_layers; ++l) {
    const int K = prm.width[l];
    const int N = prm.width[l + 1];
    const bool last = l == prm.num_layers - 1;
    const T* W = static_cast<const T*>(prm.w[l]);
    if constexpr (Tile<T>::kWmma) {
      if (K % 16 == 0 && N % 16 == 0) {
        wmma_layer(in, out, stride, K, N, W, prm.b[l], last, valid, stage, part);
      } else {
        fma_layer<T, P>(in, out, stride, K, N, W, prm.b[l], last, valid, colred, part);
      }
    } else {
      fma_layer<T, P>(in, out, stride, K, N, W, prm.b[l], last, valid, colred, part);
    }
    __syncthreads();
    T* t = in;
    in = out;
    out = t;
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

template <typename T>
int launch(const void* points, int batch, int n, int num_layers,
           const int* widths, const void* const* weights,
           const void* const* biases, int mask_padding, float* partial,
           float* out, cudaStream_t stream) {
  constexpr int P = Tile<T>::kPoints;
  constexpr int pad = Tile<T>::kPad;
  Params prm = {};
  prm.points = points;
  prm.n = n;
  prm.num_layers = num_layers;
  int max_stored = widths[0];
  for (int l = 0; l <= num_layers; ++l) prm.width[l] = widths[l];
  for (int l = 1; l < num_layers; ++l) max_stored = widths[l] > max_stored ? widths[l] : max_stored;
  for (int l = 0; l < num_layers; ++l) {
    prm.w[l] = weights[l];
    prm.b[l] = static_cast<const float*>(biases[l]);
  }
  prm.mask_padding = mask_padding;
  prm.tiles = (n + P - 1) / P;
  prm.stride = (max_stored + pad - 1) / pad * pad + pad;
  prm.partial = partial;
  const size_t smem = smem_bytes<T>(prm.stride);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(pointnet_tile_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pointnet_tile_kernel<T><<<dim3(prm.tiles, batch), kThreads, smem, stream>>>(prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int feat = widths[num_layers];
  constexpr int kReduceThreads = 128;
  reduce_tiles_kernel<<<dim3((feat + kReduceThreads - 1) / kReduceThreads, batch),
                        kReduceThreads, 0, stream>>>(partial, prm.tiles, feat, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Points per tile for the working type (is_bf16 = 0: f32, 1: bf16); the
// caller sizes the (batch, tiles, feat) partial buffer with it.
int pointnet_fused_tile_points(int is_bf16) {
  return is_bf16 ? Tile<__nv_bfloat16>::kPoints : Tile<float>::kPoints;
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
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partial);
  auto o = static_cast<float*>(out);
  if (is_bf16)
    return launch<__nv_bfloat16>(points, batch, n, num_layers, widths, weights, biases,
                                 mask_padding, part, o, s);
  return launch<float>(points, batch, n, num_layers, widths, weights, biases,
                       mask_padding, part, o, s);
}

const char* pointnet_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
