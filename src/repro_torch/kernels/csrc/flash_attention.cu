// Forward flash attention for Hopper (sm_90a), with causal and sliding-window
// masks, GQA head mapping and right-aligned queries.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (kernel body _fa_kernel), the TPU Pallas kernel on the prefill path
// (models/attention.py, attn_forward). It computes what _fa_kernel computes:
// q (b,s,h,d) against k/v (b,t,kh,d), q head hi reads kv head hi / (h/kh),
// queries right-aligned at q_offset = t - s, masking by -1e30, all
// arithmetic in fp32, output in q's dtype.
//
// What bounds it on the H100: at the prefill shapes (s = t = 512, d = 128)
// the inputs are ~50 MB and the causal products ~9 GFLOP, so the card's
// memory would bound an ideal kernel (~15 us at 3.35 TB/s). Doing the
// products in fp32 on the CUDA cores, as the TPU kernel's arithmetic asks,
// this kernel is bound by the fp32 FMA rate instead (67 TFLOP/s, some 0.15 ms
// here), and by the shared-memory loads that feed the FMAs. The design:
//   - one block of 256 threads per (64-query tile, q head, batch); the TPU's
//     sequential k-grid becomes a loop over 64-key tiles inside the block;
//   - the Q tile (pre-scaled) and each K tile are staged transposed in
//     shared memory ([d][64], fp32), each V tile row-major; global loads are
//     16 bytes a thread;
//   - register tiles: a thread scores 4 query rows x 4 keys, from one
//     16-byte load of Q^T and one of K^T per step of d, so each shared-memory
//     load feeds 8 FMAs; for P.V it keeps 4 rows x d/16 output columns,
//     with P passed through shared memory (transposed, 16-byte reads);
//   - the 16 threads of a row group sit in one half-warp, so the running max
//     is reduced by shuffles; max, denominator and accumulator stay fp32;
//   - tiles wholly above the causal diagonal or wholly outside the window
//     are skipped; the ragged edge (any s, t) is masked and zero-filled.
// Speed work beyond this (wgmma on bf16 tiles, TMA loads, a K/V ring) is
// left for later.
//
// The wrapper (repro_torch/kernels/flash_attention.py) checks shapes, types,
// alignment and devices, refuses causal t < s (rows that would see no key),
// allocates the output and passes torch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 row groups x 16 key/column groups
constexpr int kRows = 4;       // query rows per thread
constexpr int kKeys = 4;       // keys per thread in S = Q K^T
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// 16-byte global loads, widened to fp32
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // Q^T [D][64], K^T [D][64], V [64][D], P^T [64 keys][64 rows], all fp32
  return sizeof(float) * (size_t)(D * kBlockQ + D * kBlockK + kBlockK * D + kBlockK * kBlockQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, int s, int t, int h, int kh, int causal, int window,
              float scale) {
  constexpr int N = Vec<T>::N;                 // elements per 16-byte load
  constexpr int kChunks = D / N;               // 16-byte chunks per row
  constexpr int kCols = D / 16;                // output columns per thread
  constexpr int kVec = kCols % 4 == 0 ? 4 : 1;
  constexpr int kGroups = kCols / kVec;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");

  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [D][kBlockQ]
  float* kT = qT + D * kBlockQ;                 // [D][kBlockK]
  float* vs = kT + D * kBlockK;                 // [kBlockK][D]
  float* pT = vs + kBlockK * D;                 // [kBlockK][kBlockQ]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key group in S, column group in O
  const int ty = tid / 16;  // row group: rows 4*ty .. 4*ty+3
  const int q0 = blockIdx.x * kBlockQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int khi = hi / (h / kh);
  const int q_offset = t - s;

  const int64_t q_row = (int64_t)h * D;  // stride between sequence positions
  const int64_t k_row = (int64_t)kh * D;
  const T* qb = q + ((int64_t)bi * s * h + hi) * D;
  const T* kb = k + ((int64_t)bi * t * kh + khi) * D;
  const T* vb = v + ((int64_t)bi * t * kh + khi) * D;
  T* ob = o + ((int64_t)bi * s * h + hi) * D;

  // consecutive threads take consecutive rows, so the transposed stores
  // hit consecutive banks
  for (int idx = tid; idx < kBlockQ * kChunks; idx += kThreads) {
    const int r = idx % kBlockQ, c0 = (idx / kBlockQ) * N;
    float x[N];
    if (q0 + r < s) {
      Vec<T>::load(qb + (q0 + r) * q_row + c0, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) qT[(c0 + e) * kBlockQ + r] = x[e] * scale;
  }

  // key range this q tile can see
  const int q_last = min(q0 + kBlockQ, s) - 1;
  int k_end = t;
  if (causal) k_end = min(t, q_last + q_offset + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1);
  const int kt_begin = k_begin / kBlockK;
  const int kt_end = k_end > 0 ? (k_end + kBlockK - 1) / kBlockK : 0;

  float m[kRows], l[kRows];  // l: this thread's share of each row's denominator
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < kBlockK * kChunks; idx += kThreads) {
      const int r = idx % kBlockK, c0 = (idx / kBlockK) * N;
      float x[N];
      if (k0 + r < t) {
        Vec<T>::load(kb + (k0 + r) * k_row + c0, x);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < N; ++e) kT[(c0 + e) * kBlockK + r] = x[e];
    }
    // V row-major: consecutive threads take consecutive chunks of a row
    for (int idx = tid; idx < kBlockK * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c0 = (idx % kChunks) * N;
      float x[N];
      if (k0 + r < t) {
        Vec<T>::load(vb + (k0 + r) * k_row + c0, x);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < N; e += 4)
        *reinterpret_cast<float4*>(vs + r * D + c0 + e) = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
    __syncthreads();

    // S = (Q * scale) K^T for rows 4ty.., keys 4tx..
    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 qv = lds4(qT + c * kBlockQ + kRows * ty);
      const float4 kv = lds4(kT + c * kBlockK + kKeys * tx);
      const float qa[kRows] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[kKeys] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) sc[i][j] += qa[i] * ka[j];
    }

    // online softmax, one row at a time
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + kRows * ty + i + q_offset;
      unsigned valid = 0;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k0 + kKeys * tx + j;
        bool ok = kpos < t;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (ok) {
          valid |= 1u << j;
          rmax = fmaxf(rmax, sc[i][j]);
        }
      }
      const float m_new = fmaxf(m[i], half_warp_max(rmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        sc[i][j] = (valid >> j) & 1u ? expf(sc[i][j] - m_new) : 0.f;
        psum += sc[i][j];
      }
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
      *reinterpret_cast<float4*>(pT + (kKeys * tx + j) * kBlockQ + kRows * ty) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

    // O += P V for rows 4ty.., columns of group tx
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float4 pv = lds4(pT + j * kBlockQ + kRows * ty);
      const float pa[kRows] = {pv.x, pv.y, pv.z, pv.w};
      const float* vrow = vs + j * D;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if constexpr (kVec == 4) {
          const float4 vv = lds4(vrow + (g * 16 + tx) * 4);
          const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][g * 4 + e] += pa[i] * va[e];
        } else {
          const float vx = vrow[g * 16 + tx];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][g] += pa[i] * vx;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float lt = half_warp_sum(l[i]);
    const float denom = lt == 0.f ? 1.f : lt;
    const int row = q0 + kRows * ty + i;
    if (row < s) {
      T* orow = ob + row * q_row;
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          orow[(g * 16 + tx) * kVec + e] = from_float<T>(acc[i][g * kVec + e] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int s, int t,
                   int h, int kh, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, h, b);
  fa_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, t, h, kh, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int b, int s, int t,
                       int h, int kh, int d, int causal, int window, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, s, t, h, kh, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, s, t, h, kh, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, s, t, h, kh, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, s, t, h, kh, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, b, s, t, h, kh, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int b, int s, int t, int h, int kh, int d, int dtype,
                                         int causal, int window, float scale, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0 || kh <= 0 || h % kh != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, b, s, t, h, kh, d, causal, window, scale, st);
    case 1:
      return dispatch_d<__nv_bfloat16>(q, k, v, o, b, s, t, h, kh, d, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
