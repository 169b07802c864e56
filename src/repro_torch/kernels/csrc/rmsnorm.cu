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
//   - one warp per row, so any row count fills the card and the row's sum
//     is a warp shuffle, with no shared memory and no second pass over
//     blocks;
//   - two bodies, both with 16-byte loads and stores (8 bf16 or 4 f32 a
//     lane) where d and the pointers allow:
//     * rmsnorm_regs_kernel<NV>: the warp holds its row in registers, NV
//       16-byte vectors a lane, so the row is read from device memory once
//       and written once, and the scale comes in 16-byte loads. NV is a
//       template parameter up to kMaxVecs (d <= 32 * kMaxVecs * 16 /
//       sizeof(x): 6144 in bf16, 3072 in f32), 4 rows a block. A bf16 row
//       stays packed between the square sum and the scaling (see norm_row),
//       so that a thread needs 56 registers at 10 vectors and an SM holds a
//       warp for each of 4096 rows;
//     * rmsnorm_kernel: for longer or unaligned rows (any d), the warp
//       reads its row twice, once for the square sum and once to scale it,
//       the second time mostly from L1/L2, one element a lane where the
//       row is not aligned, 8 rows a block;
//     the wrapper (repro_torch/kernels/rmsnorm.py::body) picks the body and
//     NV, and the entry refuses a body the row does not allow;
//   - both take the square sum in the same order (lane k sums its elements
//     in address order, then a butterfly of shuffles) and compute
//     (x * r) * scale with r = 1 / sqrt(ss / d + eps), IEEE sqrt and
//     division (no fast math): the plain version's rsqrt, to the last bits
//     the reduction order allows; on an aligned row both bodies give the
//     same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// rows (warps) a block of the register body
constexpr int kRegWarps = 4;
// the most 16-byte vectors of a row a lane of the register body holds; the
// wrapper's REG_VECS (repro_torch/kernels/rmsnorm.py) must equal it
constexpr int kMaxVecs = 24;

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

// N elements of E from src to dst in 16-byte loads (8-byte where N elements
// are 8 bytes); both 16-byte aligned
template <typename E, int N>
__device__ __forceinline__ void load_vec(E (&dst)[N], const E* src) {
  constexpr int kBytes = N * static_cast<int>(sizeof(E));
  static_assert(kBytes % 16 == 0 || kBytes == 8, "a vector of 8 or a multiple of 16 bytes");
  if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
}

// A row's vectors into v: lane l holds vectors l, l + 32, ...,
// l + 32 * (NV - 1) of it (16 bytes each, those at or past d not loaded).
template <typename T, int NV, int VEC>
__device__ __forceinline__ void load_row(T (&v)[NV][VEC], const T* xr, int d, int lane) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = (j * 32 + lane) * VEC;
    if (k < d) load_vec(v[j], xr + k);
  }
}

// The row in v normalised and stored at yr: the square sum in the two-read
// body's order, then the scale in 16-byte loads.
template <typename T, typename TS, int NV, int VEC>
__device__ __forceinline__ void norm_row(T (&v)[NV][VEC], const TS* scale, T* yr, int d, float eps, int lane) {
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if ((j * 32 + lane) * VEC < d) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f(v[j][e]);
        ss = fmaf(f, f, ss);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
  // The compiler would keep the square sum's f32 copies of a bf16 row for
  // the scaling (96 registers a thread at 10 vectors a lane, so too few
  // warps an SM for a row each); an empty asm that may change v ends them
  // here, and the scaling converts v again (56 registers).
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    uint4& q = *reinterpret_cast<uint4*>(v[j]);
    asm volatile("" : "+r"(q.x), "+r"(q.y), "+r"(q.z), "+r"(q.w));
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = (j * 32 + lane) * VEC;
    if (k < d) {
      alignas(16) TS s[VEC];
      alignas(16) T o[VEC];
      load_vec(s, scale + k);
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = from_f<T>((to_f(v[j][e]) * r) * to_f(s[e]));
      *reinterpret_cast<uint4*>(yr + k) = *reinterpret_cast<const uint4*>(o);
    }
  }
}

// The register body: each row read from device memory once, written once.
template <typename T, typename TS, int NV>
__global__ void __launch_bounds__(32 * kRegWarps)
rmsnorm_regs_kernel(const T* __restrict__ x, const TS* __restrict__ scale, T* __restrict__ y, int64_t rows, int d,
                    float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRegWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  alignas(16) T v[NV][VEC];
  load_row(v, x + row * d, d, lane);
  norm_row(v, scale, y + row * d, d, eps, lane);
}

// The register body with nv vectors a lane, for nv in [NV, kMaxVecs].
template <typename T, typename TS, int NV>
void launch_regs(int nv, const T* x, const TS* scale, T* y, int64_t rows, int d, float eps, cudaStream_t stream) {
  if constexpr (NV <= kMaxVecs) {
    if (nv == NV) {
      const dim3 grid(static_cast<unsigned>((rows + kRegWarps - 1) / kRegWarps));
      rmsnorm_regs_kernel<T, TS, NV><<<grid, 32 * kRegWarps, 0, stream>>>(x, scale, y, rows, d, eps);
    } else {
      launch_regs<T, TS, NV + 1>(nv, x, scale, y, rows, d, eps, stream);
    }
  }
}

// nv: the register body with nv vectors a lane, or 0 for the two-read body.
template <typename T, typename TS>
int launch(const void* x, const void* scale, void* y, int64_t rows, int d, float eps, int nv, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = d % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const TS* sp = static_cast<const TS*>(scale);
  T* yp = static_cast<T*>(y);
  if (nv > 0) {
    // the row fits nv vectors a lane, and no fewer; every vector aligned
    const bool fits = nv <= kMaxVecs && (nv - 1) * 32 * kVec < d && d <= nv * 32 * kVec;
    if (!aligned || !fits || reinterpret_cast<uintptr_t>(scale) % 16 != 0) return cudaErrorInvalidValue;
    launch_regs<T, TS, 1>(nv, xp, sp, yp, rows, d, eps, stream);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
  if (aligned) {
    rmsnorm_kernel<T, TS, kVec><<<grid, kThreads, 0, stream>>>(xp, sp, yp, rows, d, eps);
  } else {
    rmsnorm_kernel<T, TS, 1><<<grid, kThreads, 0, stream>>>(xp, sp, yp, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype (x and y) and scale_dtype: 0 float32, 1 bfloat16. nv: the
// register body with nv 16-byte vectors a lane (the fewest that hold the
// row; x, y and the scale 16-byte aligned, d a multiple of 16 / sizeof(x)),
// or 0 for the two-read body. Returns a cudaError_t (0 on success).
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y, int64_t rows, int d, int x_dtype,
                             int scale_dtype, float eps, int nv, void* stream) {
  if (rows < 1 || d < 1 || nv < 0 || (rows + kRegWarps - 1) / kRegWarps > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && scale_dtype == 0) return launch<float, float>(x, scale, y, rows, d, eps, nv, st);
  if (x_dtype == 0 && scale_dtype == 1) return launch<float, __nv_bfloat16>(x, scale, y, rows, d, eps, nv, st);
  if (x_dtype == 1 && scale_dtype == 0) return launch<__nv_bfloat16, float>(x, scale, y, rows, d, eps, nv, st);
  if (x_dtype == 1 && scale_dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d, eps, nv, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The most 16-byte vectors a lane of the register body holds.
extern "C" int repro_rmsnorm_max_vecs() { return kMaxVecs; }

extern "C" const char* repro_rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
