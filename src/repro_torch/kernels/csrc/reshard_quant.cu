// The compressed wire of the reshard data plane for Hopper (sm_90a):
// pack_quant_rows and dequant_scatter_rows.
//
// Replaces: src/repro/kernels/reshard_quant.py, the two TPU Pallas kernels
// pack_quant_rows_pallas (_make_quant_kernel) and dequant_scatter_rows_pallas
// (_make_dequant_scatter_kernel). Each computes what its JAX reference
// computes (src/repro/kernels/ref.py: pack_quant_rows_ref,
// dequant_scatter_rows_ref) bit for bit, on a row-major (rows, C) array, for
// any start:
//   - pack_quant_rows: tile i is the block_rows rows at starts[i]; its scale
//     is max(absmax(tile), 1e-12) * (float)(1/qmax), the reciprocal made in
//     double and rounded once to float, as the reference folds it;
//     q = x / scale by IEEE division; int8 rounds half to even (rintf) and
//     clips to +-127, fp8-e4m3 converts round-to-nearest-even without
//     saturation (|x / scale| <= 448 by construction). The library is built
//     without --use_fast_math, so divisions are IEEE and denormals are kept.
//   - dequant_scatter_rows: dst rows <- (float(q) * scale of q's tile), cast
//     to dst's type (round to nearest even for bf16), overwritten in place.
//
// A TPU grid runs in order, so a repeated start resolves to the last tile;
// a CUDA grid does not. As for scatter_rows, the wrapper
// (repro_torch/kernels/reshard_quant.py) resolves the last writer of every
// destination row on the host and passes segments (buf_row, dst_row, rows)
// that write each row once; a segment may span several tiles, so the kernel
// takes each row's scale from its own tile.
//
// What bounds them on the H100: HBM bandwidth. pack reads each source byte
// twice (once for the tile's absmax, once to quantize) and writes one byte
// per element; dequant_scatter reads one byte per element and writes the
// destination. The design: the absmax pass is split over many blocks per
// tile (each block reduces 4096 elements into a partial maximum), and the
// quantize pass re-reduces the tile's few partials in every block, so a
// stacked-layer row of 4M elements and thousands of 2048-element embedding
// rows both fill the card; no atomics, so the result is deterministic.
// Loads are one element per thread, neighbouring threads on neighbouring
// elements. Vector loads and a single pass that keeps a tile in shared
// memory are left for later.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
constexpr int64_t kFillBlocks = 132 * 16;

constexpr int kInt8 = 0;
constexpr int kFp8 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// a payload byte's value: int8, or fp8-e4m3 (exact in half, exact in float)
template <int FMT>
__device__ __forceinline__ float payload_value(uint8_t bits) {
  if constexpr (FMT == kInt8) {
    return static_cast<float>(static_cast<int8_t>(bits));
  } else {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(bits, __NV_E4M3)));
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// max that propagates NaN, as the reference's jnp.max / jnp.maximum do
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < kThreads / 32 ? red[lane] : 0.f;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, off));
    if (lane == 0) red[0] = x;
  }
  __syncthreads();
  return red[0];
}

// block x's share [lo, hi) of a tile of n elements cut into `chunks` parts
__device__ __forceinline__ void chunk_range(int64_t n, int chunks, int64_t* lo, int64_t* hi) {
  const int64_t per = (n + chunks - 1) / chunks;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * per;
  *lo = start < n ? start : n;
  *hi = *lo + per < n ? *lo + per : n;
}

// pass 1: partial[i * chunks + x] = max |src| over block x's share of tile i
template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_absmax_kernel(const T* __restrict__ src, const int64_t* __restrict__ starts, int64_t nb,
                   int64_t tile_elems, int64_t C, int chunks, float* __restrict__ partial) {
  __shared__ float red[kThreads / 32];
  for (int64_t i = blockIdx.y; i < nb; i += gridDim.y) {
    const T* tile = src + starts[i] * C;
    int64_t lo, hi;
    chunk_range(tile_elems, chunks, &lo, &hi);
    float m = 0.f;
    for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) m = nan_max(m, fabsf(to_float(tile[e])));
    m = block_max(m, red);
    if (threadIdx.x == 0) partial[i * chunks + blockIdx.x] = m;
  }
}

// a payload byte: int8 rounds half to even and clips; fp8-e4m3 converts
// round-to-nearest-even, unsaturated
template <int FMT>
__device__ __forceinline__ uint8_t quantize(float y, float qmax) {
  if constexpr (FMT == kInt8) {
    return static_cast<uint8_t>(static_cast<int8_t>(fminf(fmaxf(rintf(y), -qmax), qmax)));
  } else {
    return static_cast<uint8_t>(__nv_cvt_float_to_fp8(y, __NV_NOSAT, __NV_E4M3));
  }
}

// pass 2: the tile's scale from its partials, then q = x / scale
template <typename T, int FMT>
__global__ void __launch_bounds__(kThreads)
tile_quant_kernel(const T* __restrict__ src, const int64_t* __restrict__ starts, int64_t nb,
                  int64_t tile_elems, int64_t C, int chunks, const float* __restrict__ partial,
                  float inv_qmax, float qmax, uint8_t* __restrict__ out, float* __restrict__ scales) {
  __shared__ float red[kThreads / 32];
  for (int64_t i = blockIdx.y; i < nb; i += gridDim.y) {
    float m = 0.f;
    for (int c = threadIdx.x; c < chunks; c += kThreads) m = nan_max(m, partial[i * chunks + c]);
    const float absmax = block_max(m, red);
    const float scale = nan_max(absmax, 1e-12f) * inv_qmax;
    if (blockIdx.x == 0 && threadIdx.x == 0) scales[i] = scale;
    const T* tile = src + starts[i] * C;
    uint8_t* qt = out + i * tile_elems;
    int64_t lo, hi;
    chunk_range(tile_elems, chunks, &lo, &hi);
    for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) {
      qt[e] = quantize<FMT>(__fdiv_rn(to_float(tile[e]), scale), qmax);
    }
  }
}

// dst[dst_row + r] = (buf[buf_row + r] * scale of its tile) for each segment
template <typename D, int FMT>
__global__ void __launch_bounds__(kThreads)
dequant_scatter_kernel(D* __restrict__ dst, const uint8_t* __restrict__ buf,
                       const float* __restrict__ scales, const int64_t* __restrict__ segs,
                       int64_t n, int64_t block_rows, int64_t C) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = blockIdx.y; i < n; i += gridDim.y) {
    const int64_t* g = segs + 3 * i;
    const int64_t total = g[2] * C;
    const uint8_t* from = buf + g[0] * C;
    D* to = dst + g[1] * C;
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < total;
         e += stride) {
      const float scale = scales[(g[0] + e / C) / block_rows];
      to[e] = from_float<D>(__fmul_rn(payload_value<FMT>(from[e]), scale));
    }
  }
}

template <typename T, int FMT>
cudaError_t launch_pack(const void* src, void* out, float* scales, float* partial,
                        const int64_t* starts, int64_t nb, int64_t block_rows, int64_t C,
                        int chunks, float qmax, cudaStream_t stream) {
  const int64_t tile_elems = block_rows * C;
  const dim3 grid(chunks, static_cast<unsigned>(nb < kMaxGridY ? nb : kMaxGridY));
  tile_absmax_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(src), starts, nb,
                                                       tile_elems, C, chunks, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float inv_qmax = static_cast<float>(1.0 / static_cast<double>(qmax));
  tile_quant_kernel<T, FMT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), starts, nb, tile_elems, C, chunks, partial, inv_qmax, qmax,
      static_cast<uint8_t*>(out), scales);
  return cudaGetLastError();
}

template <typename D, int FMT>
cudaError_t launch_dequant(void* dst, const void* buf, const float* scales, const int64_t* segs,
                           int64_t n, int64_t max_seg_rows, int64_t block_rows, int64_t C,
                           cudaStream_t stream) {
  const int64_t y = n < kMaxGridY ? n : kMaxGridY;
  int64_t x = (max_seg_rows * C + kThreads - 1) / kThreads;
  const int64_t fill = (kFillBlocks + y - 1) / y;
  if (x > fill) x = fill;
  if (x < 1) x = 1;
  dequant_scatter_kernel<D, FMT><<<dim3(static_cast<unsigned>(x), static_cast<unsigned>(y)),
                                   kThreads, 0, stream>>>(
      static_cast<D*>(dst), static_cast<const uint8_t*>(buf), scales, segs, n, block_rows, C);
  return cudaGetLastError();
}

}  // namespace

// src_dtype / dst_dtype: 0 = float32, 1 = bfloat16; fmt: 0 = int8 (qmax
// 127), 1 = fp8-e4m3 (qmax 448); chunks: blocks per tile in pack (the
// wrapper cuts tiles into 4096-element shares and sizes `partial`, nb x
// chunks floats, to match). Each entry launches on `stream` and returns
// cudaGetLastError() (0 on success); n == 0 launches nothing.

extern "C" int repro_pack_quant_rows(const void* src, void* out, float* scales, float* partial,
                                     const int64_t* starts, int64_t nb, int64_t block_rows,
                                     int64_t C, int chunks, int src_dtype, int fmt, void* stream) {
  if (nb < 0 || block_rows <= 0 || C <= 0 || chunks <= 0) return cudaErrorInvalidValue;
  if (nb == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (src_dtype == 0 && fmt == 0)
    return launch_pack<float, kInt8>(src, out, scales, partial, starts, nb, block_rows, C, chunks, 127.f, st);
  if (src_dtype == 0 && fmt == 1)
    return launch_pack<float, kFp8>(src, out, scales, partial, starts, nb, block_rows, C, chunks, 448.f, st);
  if (src_dtype == 1 && fmt == 0)
    return launch_pack<__nv_bfloat16, kInt8>(src, out, scales, partial, starts, nb, block_rows, C, chunks, 127.f, st);
  if (src_dtype == 1 && fmt == 1)
    return launch_pack<__nv_bfloat16, kFp8>(src, out, scales, partial, starts, nb, block_rows, C, chunks, 448.f, st);
  return cudaErrorInvalidValue;
}

extern "C" int repro_dequant_scatter_rows(void* dst, const void* buf, const float* scales,
                                          const int64_t* segs, int64_t n, int64_t max_seg_rows,
                                          int64_t block_rows, int64_t C, int dst_dtype, int fmt,
                                          void* stream) {
  if (n < 0 || max_seg_rows <= 0 || block_rows <= 0 || C <= 0) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dst_dtype == 0 && fmt == 0)
    return launch_dequant<float, kInt8>(dst, buf, scales, segs, n, max_seg_rows, block_rows, C, st);
  if (dst_dtype == 0 && fmt == 1)
    return launch_dequant<float, kFp8>(dst, buf, scales, segs, n, max_seg_rows, block_rows, C, st);
  if (dst_dtype == 1 && fmt == 0)
    return launch_dequant<__nv_bfloat16, kInt8>(dst, buf, scales, segs, n, max_seg_rows, block_rows, C, st);
  if (dst_dtype == 1 && fmt == 1)
    return launch_dequant<__nv_bfloat16, kFp8>(dst, buf, scales, segs, n, max_seg_rows, block_rows, C, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
