// Row RMSNorm for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py, the TPU Pallas kernel
// rmsnorm_pallas (body _rmsnorm_kernel). It computes what that kernel and
// the plain version repro_torch/kernels/ref.py::rmsnorm_ref compute, for x
// (rows, d) and scale (d,):
//   y[r] = (x[r] * 1/sqrt(mean(x[r]^2) + eps)) * scale,   cast to x's dtype,
// with the square sum, the mean and the products in f32. x and y are f32
// or bf16; the scale is f32 or bf16.
//
// What bounds it on the H100: bytes. It reads each row once and writes it
// once (at 4096 x 2560 bf16, 42 MB: 0.0125 ms at 3.35 TB/s) and does ~4
// operations an element. The design:
//   - one warp per row, 8 rows a block, so any row count fills the card
//     and the row's sum is a warp shuffle, with no shared memory and no
//     second pass over blocks;
//   - 16-byte loads and stores (8 bf16 or 4 f32 a lane) where d and the
//     base pointers allow, else one element a lane; any d works;
//   - the warp reads its row twice, once for the square sum and once to
//     scale it: the second read comes from L1/L2 (a 2560-wide bf16 row is
//     5 KB), not from device memory;
//   - 1/sqrt with IEEE sqrt and division (no fast math): the plain
//     version's rsqrt, to the last bits the reduction order allows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// VEC elements of T per lane per step: 16 / sizeof(T) when the row is
// 16-byte aligned, else 1.
template <typename T, typename TS, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const TS* __restrict__ scale, T* __restrict__ y, int64_t rows, int d,
               float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float ss = 0.0f;
  for (int k = lane * VEC; k < d; k += 32 * VEC) {
    alignas(16) T v[VEC];
    if constexpr (VEC > 1) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(xr + k);
    } else {
      v[0] = xr[k];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f(v[e]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

  for (int k = lane * VEC; k < d; k += 32 * VEC) {
    alignas(16) T v[VEC];
    alignas(16) T o[VEC];
    if constexpr (VEC > 1) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(xr + k);
    } else {
      v[0] = xr[k];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = from_f<T>((to_f(v[e]) * r) * to_f(scale[k + e]));
    if constexpr (VEC > 1) {
      *reinterpret_cast<uint4*>(yr + k) = *reinterpret_cast<const uint4*>(o);
    } else {
      yr[k] = o[0];
    }
  }
}

template <typename T, typename TS>
int launch(const void* x, const void* scale, void* y, int64_t rows, int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = d % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
  const T* xp = static_cast<const T*>(x);
  const TS* sp = static_cast<const TS*>(scale);
  T* yp = static_cast<T*>(y);
  if (aligned) {
    rmsnorm_kernel<T, TS, kVec><<<grid, kThreads, 0, stream>>>(xp, sp, yp, rows, d, eps);
  } else {
    rmsnorm_kernel<T, TS, 1><<<grid, kThreads, 0, stream>>>(xp, sp, yp, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype (x and y) and scale_dtype: 0 float32, 1 bfloat16. Returns a
// cudaError_t (0 on success).
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y, int64_t rows, int d, int x_dtype,
                             int scale_dtype, float eps, void* stream) {
  if (rows < 1 || d < 1 || (rows + kWarps - 1) / kWarps > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && scale_dtype == 0) return launch<float, float>(x, scale, y, rows, d, eps, st);
  if (x_dtype == 0 && scale_dtype == 1) return launch<float, __nv_bfloat16>(x, scale, y, rows, d, eps, st);
  if (x_dtype == 1 && scale_dtype == 0) return launch<__nv_bfloat16, float>(x, scale, y, rows, d, eps, st);
  if (x_dtype == 1 && scale_dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d, eps, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
