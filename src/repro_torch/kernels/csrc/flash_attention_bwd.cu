// Backward flash attention for Hopper (sm_90a): dq, dk and dv of the
// forward in flash_attention.cu, with its causal and sliding-window masks,
// GQA head mapping and right-aligned queries.
//
// Replaces: nothing on the TPU. The TPU kernel this port follows,
// src/repro/kernels/flash_attention.py (flash_attention_pallas), is
// forward-only, and jax.grad through it fails; the JAX package trains
// through the plain jnp version. The port trains through its forward kernel,
// so this kernel is its gradient. It is held against autograd of the plain
// version (repro_torch/kernels/ref.py, flash_attention_ref), which the CPU
// tests hold against jax.grad of repro.kernels.ref.flash_attention_ref.
//
// The math (FlashAttention-2's backward, all in fp32): with Qs = q * scale,
// S = Qs K^T, P = exp(S - lse) (lse = the forward's row log-sum-exp; masked
// entries are 0), D_r = rowsum(dO_r * O_r):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),  dK = dS^T Qs,
//   dQ = scale * dS K.
// dk and dv sum over the q heads of each kv head's GQA group.
//
// Deterministic, with no float atomics: three kernels, each output element
// written by one thread that sums in a fixed order.
//   - bwd_rowdot: D, one warp per (batch, head, query row);
//   - bwd_dkdv:   one block per (32-key tile, kv head, batch); it keeps its
//     K and V tile in shared memory and dk/dv in registers, and loops over
//     the group's q heads and the 32-row q tiles that can see its keys;
//   - bwd_dq:     one block per (32-row q tile, q head, batch), looping over
//     the key tiles its rows can see, recomputing S and dP.
// S and dP are computed twice (once in each of the last two); that is the
// price of writing dq without atomics.
//
// What bounds it on the H100: at the training shape (b 4, s = t = 1024,
// 16 q / 8 kv heads, d 128, causal) the products are ~60 GFLOP and the
// tensors ~0.1 GB, so the fp32 FMA rate on the CUDA cores (67 TFLOP/s)
// bounds this kernel, as it does the forward; an ideal kernel on the bf16
// tensor cores would be bound by the same ~60 GFLOP at 989 TFLOP/s. The
// design is the simple one: 32 x 32 tiles, 256 threads, a 2 x 2 register
// tile per thread for S and dP (float4 loads along d from rows padded by 4
// floats), row-major tiles in shared memory; the score loop sums over d in
// the forward's order, so S matches the forward's bit for bit. wgmma on
// bf16 tiles, TMA loads and a K/V ring are left for later.
//
// The wrapper (repro_torch/kernels/flash_attention.py) checks shapes, types
// and devices, allocates dq, dk, dv and the D scratch, and passes torch's
// current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;        // query rows per tile
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 2 x 2 scores each
constexpr int kPP = kBK + 1;   // row pitch of the P / dS tiles
constexpr unsigned kFullMask = 0xffffffffu;

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// sum += a . b over four lanes, in lane order (the forward's order over d)
__device__ __forceinline__ float dot4(float sum, float4 a, float4 b) {
  sum = fmaf(a.x, b.x, sum);
  sum = fmaf(a.y, b.y, sum);
  sum = fmaf(a.z, b.z, sum);
  return fmaf(a.w, b.w, sum);
}

// rows of `rows` x D elements at `base` (row stride `stride` elements) into
// smem rows of pitch D + 4, times `mul`; rows past `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* base, int64_t stride, int rows,
                                          int valid, float mul) {
  constexpr int N = Vec<T>::N;
  constexpr int kChunks = D / N;
  constexpr int DP = D + 4;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c0 = (idx % kChunks) * N;
    float x[N];
    if (r < valid) {
      Vec<T>::load(base + r * stride + c0, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[r * DP + c0 + e] = x[e] * mul;
  }
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int t, int causal, int window) {
  bool ok = kpos < t;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// D[b, h, r] = sum_c dO[b, r, h, c] * O[b, r, h, c]; one warp per row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_rowdot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
           int64_t rows, int s, int h) {
  const int64_t n = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (n >= rows) return;
  const int lane = threadIdx.x % 32;
  const int64_t bi = n / ((int64_t)h * s);
  const int64_t rem = n % ((int64_t)h * s);
  const int64_t hi = rem / s, r = rem % s;
  const int64_t off = ((bi * s + r) * h + hi) * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += to_float(dout[off + c]) * to_float(o[off + c]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(kFullMask, acc, w);
  if (lane == 0) dsum[n] = acc;
}

template <int D>
constexpr size_t smem_bytes() {
  // four row tiles of pitch D + 4, two P/dS tiles, lse and D of the q rows
  return sizeof(float) * (size_t)(2 * kBK * (D + 4) + 2 * kBQ * (D + 4) + 2 * kBQ * kPP + 2 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
         T* __restrict__ dk, T* __restrict__ dv, int s, int t, int h, int kh, int causal,
         int window, float scale) {
  constexpr int DP = D + 4;
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kBK][DP]
  float* Vs = Ks + kBK * DP;                    // [kBK][DP]
  float* Qs = Vs + kBK * DP;                    // [kBQ][DP], q * scale
  float* dOs = Qs + kBQ * DP;                   // [kBQ][DP]
  float* Ps = dOs + kBQ * DP;                   // [kBQ][kPP]
  float* dSs = Ps + kBQ * kPP;                  // [kBQ][kPP]
  float* lse_s = dSs + kBQ * kPP;               // [kBQ]
  float* d_s = lse_s + kBQ;                     // [kBQ]

  const int tid = threadIdx.x;
  const int a = tid / 16;   // keys 2a, 2a+1 of the tile
  const int bq = tid % 16;  // scores: q rows 2bq, 2bq+1; sums: columns bq + 16 j
  const int k0 = blockIdx.x * kBK;
  const int khi = blockIdx.y;
  const int bi = blockIdx.z;
  const int rep = h / kh;
  const int q_offset = t - s;
  const int64_t q_row = (int64_t)h * D;
  const int64_t k_row = (int64_t)kh * D;

  const T* kb = k + ((int64_t)bi * t * kh + khi) * D + (int64_t)k0 * k_row;
  const T* vb = v + ((int64_t)bi * t * kh + khi) * D + (int64_t)k0 * k_row;
  load_rows<T, D>(Ks, kb, k_row, kBK, t - k0, 1.f);
  load_rows<T, D>(Vs, vb, k_row, kBK, t - k0, 1.f);

  // query rows that can see a key of this tile
  int r_lo = 0, r_hi = s;
  if (causal) r_lo = max(0, k0 - q_offset);
  if (window > 0) r_hi = min(s, k0 + kBK - 1 + window - q_offset);
  const int qt_begin = r_lo / kBQ;
  const int qt_end = r_hi > r_lo ? (r_hi + kBQ - 1) / kBQ : qt_begin;

  float dka[2][kCols], dva[2][kCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int hq = khi * rep; hq < (khi + 1) * rep; ++hq) {
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
      const int64_t qoff = ((int64_t)bi * s * h + hq) * D + (int64_t)q0 * q_row;
      load_rows<T, D>(Qs, q + qoff, q_row, kBQ, s - q0, scale);
      load_rows<T, D>(dOs, dout + qoff, q_row, kBQ, s - q0, 1.f);
      if (tid < kBQ) {
        const int64_t li = ((int64_t)bi * h + hq) * s + q0 + tid;
        lse_s[tid] = q0 + tid < s ? lse[li] : 0.f;
        d_s[tid] = q0 + tid < s ? dsum[li] : 0.f;
      }
      __syncthreads();

      float sv[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        const float4 ka0 = lds4(Ks + (2 * a) * DP + c), ka1 = lds4(Ks + (2 * a + 1) * DP + c);
        const float4 va0 = lds4(Vs + (2 * a) * DP + c), va1 = lds4(Vs + (2 * a + 1) * DP + c);
        const float4 qa0 = lds4(Qs + (2 * bq) * DP + c), qa1 = lds4(Qs + (2 * bq + 1) * DP + c);
        const float4 oa0 = lds4(dOs + (2 * bq) * DP + c), oa1 = lds4(dOs + (2 * bq + 1) * DP + c);
        sv[0][0] = dot4(sv[0][0], qa0, ka0); sv[0][1] = dot4(sv[0][1], qa1, ka0);
        sv[1][0] = dot4(sv[1][0], qa0, ka1); sv[1][1] = dot4(sv[1][1], qa1, ka1);
        dp[0][0] = dot4(dp[0][0], oa0, va0); dp[0][1] = dot4(dp[0][1], oa1, va0);
        dp[1][0] = dot4(dp[1][0], oa0, va1); dp[1][1] = dot4(dp[1][1], oa1, va1);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 2 * bq + j, kk = 2 * a + i;
          const bool ok = q0 + r < s && visible(k0 + kk, q0 + r + q_offset, t, causal, window);
          const float p = ok ? expf(sv[i][j] - lse_s[r]) : 0.f;
          Ps[r * kPP + kk] = p;
          dSs[r * kPP + kk] = p * (dp[i][j] - d_s[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Qs for keys 2a, 2a+1 and columns bq + 16 j
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        const float p0 = Ps[r * kPP + 2 * a], p1 = Ps[r * kPP + 2 * a + 1];
        const float s0 = dSs[r * kPP + 2 * a], s1 = dSs[r * kPP + 2 * a + 1];
        const float* orow = dOs + r * DP;
        const float* qrow = Qs + r * DP;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float ov = orow[bq + 16 * j], qv = qrow[bq + 16 * j];
          dva[0][j] = fmaf(p0, ov, dva[0][j]);
          dva[1][j] = fmaf(p1, ov, dva[1][j]);
          dka[0][j] = fmaf(s0, qv, dka[0][j]);
          dka[1][j] = fmaf(s1, qv, dka[1][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = k0 + 2 * a + i;
    if (kpos < t) {
      const int64_t off = (((int64_t)bi * t + kpos) * kh + khi) * D;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        dk[off + bq + 16 * j] = from_float<T>(dka[i][j]);
        dv[off + bq + 16 * j] = from_float<T>(dva[i][j]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
       T* __restrict__ dq, int s, int t, int h, int kh, int causal, int window, float scale) {
  constexpr int DP = D + 4;
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][DP], q * scale
  float* dOs = Qs + kBQ * DP;                   // [kBQ][DP]
  float* Ks = dOs + kBQ * DP;                   // [kBK][DP]
  float* Vs = Ks + kBK * DP;                    // [kBK][DP]
  float* dSs = Vs + kBK * DP;                   // [kBQ][kPP]
  float* lse_s = dSs + 2 * kBQ * kPP;           // [kBQ] (one P tile's room left unused)
  float* d_s = lse_s + kBQ;                     // [kBQ]

  const int tid = threadIdx.x;
  const int a = tid / 16;   // q rows 2a, 2a+1 of the tile
  const int bq = tid % 16;  // scores: keys 2bq, 2bq+1; sums: columns bq + 16 j
  const int q0 = blockIdx.x * kBQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int khi = hi / (h / kh);
  const int q_offset = t - s;
  const int64_t q_row = (int64_t)h * D;
  const int64_t k_row = (int64_t)kh * D;

  const int64_t qoff = ((int64_t)bi * s * h + hi) * D + (int64_t)q0 * q_row;
  load_rows<T, D>(Qs, q + qoff, q_row, kBQ, s - q0, scale);
  load_rows<T, D>(dOs, dout + qoff, q_row, kBQ, s - q0, 1.f);
  if (tid < kBQ) {
    const int64_t li = ((int64_t)bi * h + hi) * s + q0 + tid;
    lse_s[tid] = q0 + tid < s ? lse[li] : 0.f;
    d_s[tid] = q0 + tid < s ? dsum[li] : 0.f;
  }

  // keys this q tile can see (as in the forward)
  const int q_last = min(q0 + kBQ, s) - 1;
  int k_end = t;
  if (causal) k_end = min(t, q_last + q_offset + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1);
  const int kt_begin = k_begin / kBK;
  const int kt_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  float dqa[2][kCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dqa[i][j] = 0.f;

  const T* kb = k + ((int64_t)bi * t * kh + khi) * D;
  const T* vb = v + ((int64_t)bi * t * kh + khi) * D;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    load_rows<T, D>(Ks, kb + (int64_t)k0 * k_row, k_row, kBK, t - k0, 1.f);
    load_rows<T, D>(Vs, vb + (int64_t)k0 * k_row, k_row, kBK, t - k0, 1.f);
    __syncthreads();

    float sv[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 qa0 = lds4(Qs + (2 * a) * DP + c), qa1 = lds4(Qs + (2 * a + 1) * DP + c);
      const float4 oa0 = lds4(dOs + (2 * a) * DP + c), oa1 = lds4(dOs + (2 * a + 1) * DP + c);
      const float4 ka0 = lds4(Ks + (2 * bq) * DP + c), ka1 = lds4(Ks + (2 * bq + 1) * DP + c);
      const float4 va0 = lds4(Vs + (2 * bq) * DP + c), va1 = lds4(Vs + (2 * bq + 1) * DP + c);
      sv[0][0] = dot4(sv[0][0], qa0, ka0); sv[0][1] = dot4(sv[0][1], qa0, ka1);
      sv[1][0] = dot4(sv[1][0], qa1, ka0); sv[1][1] = dot4(sv[1][1], qa1, ka1);
      dp[0][0] = dot4(dp[0][0], oa0, va0); dp[0][1] = dot4(dp[0][1], oa0, va1);
      dp[1][0] = dot4(dp[1][0], oa1, va0); dp[1][1] = dot4(dp[1][1], oa1, va1);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 2 * a + i, kk = 2 * bq + j;
        const bool ok = q0 + r < s && visible(k0 + kk, q0 + r + q_offset, t, causal, window);
        const float p = ok ? expf(sv[i][j] - lse_s[r]) : 0.f;
        dSs[r * kPP + kk] = p * (dp[i][j] - d_s[r]);
      }
    }
    __syncthreads();

    // dQ += dS K for q rows 2a, 2a+1 and columns bq + 16 j
#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      const float s0 = dSs[(2 * a) * kPP + kk], s1 = dSs[(2 * a + 1) * kPP + kk];
      const float* krow = Ks + kk * DP;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kv = krow[bq + 16 * j];
        dqa[0][j] = fmaf(s0, kv, dqa[0][j]);
        dqa[1][j] = fmaf(s1, kv, dqa[1][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + 2 * a + i;
    if (r < s) {
      const int64_t off = ((int64_t)bi * s * h + hi) * D + (int64_t)r * q_row;
#pragma unroll
      for (int j = 0; j < kCols; ++j) dq[off + bq + 16 * j] = from_float<T>(dqa[i][j] * scale);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* dsum, void* dq, void* dk, void* dv, int b, int s,
                   int t, int h, int kh, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(bwd_dkdv<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int64_t rows = (int64_t)b * h * s;
  const int warps = kThreads / 32;
  bwd_rowdot<T, D><<<(unsigned)((rows + warps - 1) / warps), kThreads, 0, stream>>>(
      static_cast<const T*>(o), dot, dsum, rows, s, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv<T, D><<<dim3((t + kBK - 1) / kBK, kh, b), kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), s, t, h, kh, causal,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq<T, D><<<dim3((s + kBQ - 1) / kBQ, h, b), kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dq), s, t, h, kh, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                       void* dv, int b, int s, int t, int h, int kh, int d, int causal, int window,
                       float scale, cudaStream_t st) {
#define REPRO_BWD_CASE(DIM)                                                                   \
  case DIM:                                                                                   \
    return launch<T, DIM>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, s, t, h, kh, causal,   \
                          window, scale, st);
  switch (d) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(128)
    REPRO_BWD_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o/dout/dq are (b, s, h, d), k/v/dk/dv
// (b, t, kh, d), lse and dsum (b, h, s) fp32; dsum is scratch. Returns the
// cudaError_t of the launches.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         float* dsum, void* dq, void* dk, void* dv, int b, int s,
                                         int t, int h, int kh, int d, int dtype, int causal,
                                         int window, float scale, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0 || kh <= 0 || h % kh != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_d<float>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, s, t, h, kh, d, causal,
                               window, scale, st);
    case 1:
      return dispatch_d<__nv_bfloat16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, s, t, h, kh, d,
                                       causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
