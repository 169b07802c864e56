// The Mamba-2 SSD intra-chunk block for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py, the TPU Pallas kernel
// ssd_intra_chunk_pallas (body _ssd_chunk_kernel). It computes what that
// kernel computes over its (batch, head, chunk) grid, and what the plain
// version repro_torch/kernels/ref.py::ssd_intra_chunk_ref computes: for a
// chunk of q steps of one batch row and one head, with x (q, p), dt and
// cum (q,) (cum = the within-chunk inclusive cumsum of dt*A), B and C
// (q, n) shared by all heads,
//   y[t]  = sum_{s <= t} (C[t].B[s]) * exp(cum[t] - cum[s]) * dt[s] * x[s]
//   S     = sum_s exp(cum[q-1] - cum[s]) * dt[s] * x[s] (outer) B[s]
// written to y (b, s, h, p) f32 and S (b, nc, h, p, n) f32. x is f32 or
// bf16 (upcast on load); every product accumulates in f32.
//
// What bounds it on the H100: at the serving shape (b 8, s 512, h 80,
// p 64, n 128, chunk 64) the function moves ~300 MB (S alone is 168 MB of
// f32), 0.09 ms at 3.35 TB/s; its useful work is ~8.2 GFLOP of f32
// products, ~0.12 ms on the CUDA cores' 67 TFLOP/s. This first kernel
// runs f32 FMAs on the CUDA cores and is bounded by them and by its
// shared-memory loads; wgmma on tf32/bf16 tiles is later work. The design:
//   - one block per (batch row, chunk) and group of kHeadsPerBlock heads.
//     B and C are the same for every head, so the block loads them once
//     and computes C.B^T (q x q) once, then walks its heads; the Pallas
//     grid recomputes C.B^T per head;
//   - L = exp(cum_t - cum_s) grows without bound for s > t (cum
//     decreases along the chunk), so the causal mask selects before the
//     exp: a masked entry is 0.0f, never inf * 0 = NaN;
//   - every product is a 4x4 (y, C.B^T) or 4x8 (S) register tile per
//     thread over shared-memory rows padded to stride n+1 / q+1, so the
//     loads of one warp fall in distinct banks;
//   - shared memory is 83.5 KB (B and C tiles, C.B^T, x and M of one
//     head; x and M reuse C's space once C.B^T is formed), above the
//     48 KB default: the launch opts in with cudaFuncSetAttribute;
//   - the chunk, head and state sizes are runtime values up to kQ, kP, kN;
//     loops run to the real sizes and only real elements are written. A
//     sequence that is not a multiple of the chunk is refused by the
//     wrapper (repro_torch/kernels/ssd_scan.py): ops.ssd_scan pads it
//     with dt = 0 first, as the JAX package does, so no read leaves the
//     arrays.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;   // largest chunk
constexpr int kP = 64;   // largest head dim
constexpr int kN = 128;  // largest state size
constexpr int kThreads = 256;
constexpr int kHeadsPerBlock = 4;
constexpr int kBS = kN + 1;  // row stride of the B and C tiles
constexpr int kMS = kQ + 1;  // row stride of C.B^T and M
// B, C.B^T, (C | x + M), dt, cum, w
constexpr int kSmemFloats = kQ * kBS + kQ * kMS + kQ * kBS + 3 * kQ;
static_assert(kQ * kP + kQ * kMS <= kQ * kBS, "x and M must fit in C's space");
static_assert(kQ == 64 && kP == 64 && kN == 128 && kThreads == 256, "the register tiles assume these sizes");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ cum,
                       const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
                       float* __restrict__ S, int nc, int s_len, int h, int p, int n, int q) {
  extern __shared__ float smem[];
  float* sB = smem;              // (q, n) at stride kBS
  float* sCB = sB + kQ * kBS;    // (q, q) at stride kMS
  float* sC = sCB + kQ * kMS;    // (q, n) at stride kBS, until C.B^T is formed
  float* sX = sC;                // then (q, p) at stride kP ...
  float* sM = sC + kQ * kP;      // ... and (q, q) at stride kMS
  float* sdt = sC + kQ * kBS;
  float* scum = sdt + kQ;
  float* sw = scum + kQ;

  const int bi = blockIdx.x / nc;
  const int ci = blockIdx.x - bi * nc;
  const int h0 = blockIdx.y * kHeadsPerBlock;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int64_t row0 = static_cast<int64_t>(bi) * s_len + static_cast<int64_t>(ci) * q;

  // B and C of this (batch row, chunk): q rows of n contiguous floats
  const float* gB = Bm + row0 * n;
  const float* gC = Cm + row0 * n;
  for (int i = tid; i < q * n; i += kThreads) {
    const int t = i / n, k = i - t * n;
    sB[t * kBS + k] = gB[i];
    sC[t * kBS + k] = gC[i];
  }
  __syncthreads();

  // C.B^T: thread (ty, tx) forms rows ty + 16i, columns tx + 16j
  {
    float acc[4][4] = {};
    for (int k = 0; k < n; ++k) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * kBS + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 16 * j) * kBS + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sCB[(ty + 16 * i) * kMS + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();  // C is dead from here: its space holds x and M

  for (int hh = 0; hh < kHeadsPerBlock; ++hh) {
    const int hi = h0 + hh;
    if (hi >= h) break;  // the same for every thread of the block
    for (int i = tid; i < q * p; i += kThreads) {
      const int t = i / p, c = i - t * p;
      sX[t * kP + c] = to_f(x[((row0 + t) * h + hi) * p + c]);
    }
    if (tid < q) {
      sdt[tid] = dt[(row0 + tid) * h + hi];
      scum[tid] = cum[(row0 + tid) * h + hi];
    }
    __syncthreads();
    if (tid < q) sw[tid] = expf(scum[q - 1] - scum[tid]) * sdt[tid];
    // M[t][s] = C.B^T[t][s] * L[t][s] * dt[s], the mask taken before the exp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + 16 * j;
        float m = 0.0f;
        if (s <= t && t < q) m = sCB[t * kMS + s] * expf(scum[t] - scum[s]) * sdt[s];
        sM[t * kMS + s] = m;
      }
    }
    __syncthreads();

    // y = M . x: rows ty + 16i, columns tx + 16j
    {
      float acc[4][4] = {};
      for (int s = 0; s < q; ++s) {
        float mv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = sM[(ty + 16 * i) * kMS + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sX[s * kP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= q) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (c < p) y[((row0 + t) * h + hi) * p + c] = acc[i][j];
        }
      }
    }

    // S = (w * x)^T . B: rows (head dim) ty + 16i, columns (state) tx + 16j
    {
      float acc[4][8] = {};
      for (int s = 0; s < q; ++s) {
        const float w = sw[s];
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sX[s * kP + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = sB[s * kBS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      float* gS = S + ((static_cast<int64_t>(bi) * nc + ci) * h + hi) * p * n;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ty + 16 * i;
        if (c >= p) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = tx + 16 * j;
          if (k < n) gS[static_cast<int64_t>(c) * n + k] = acc[i][j];
        }
      }
    }
    __syncthreads();  // the next head overwrites x, M, dt, cum and w
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* cum, const void* Bm, const void* Cm, void* y, void* S,
           int b, int s_len, int h, int p, int n, int q, cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_intra_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = s_len / q;
  dim3 grid(b * nc, (h + kHeadsPerBlock - 1) / kHeadsPerBlock);
  ssd_intra_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(cum),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(S), nc, s_len, h, p, n, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype: 0 float32, 1 bfloat16. Returns a cudaError_t (0 on success).
// The limits kQ, kP, kN are the wrapper's MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE.
extern "C" int repro_ssd_intra_chunk(const void* x, const void* dt, const void* cum, const void* Bm, const void* Cm,
                                     void* y, void* S, int b, int s_len, int h, int p, int n, int chunk,
                                     int x_dtype, void* stream) {
  if (chunk < 1 || chunk > kQ || p < 1 || p > kP || n < 1 || n > kN || s_len % chunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch<float>(x, dt, cum, Bm, Cm, y, S, b, s_len, h, p, n, chunk, st);
  if (x_dtype == 1) return launch<__nv_bfloat16>(x, dt, cum, Bm, Cm, y, S, b, s_len, h, p, n, chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
