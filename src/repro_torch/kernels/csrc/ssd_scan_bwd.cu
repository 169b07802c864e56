// The backward of the Mamba-2 SSD intra-chunk block for Hopper (sm_90a).
//
// Replaces: nothing on the TPU. The Pallas kernel src/repro/kernels/ssd_scan.py
// (ssd_intra_chunk_pallas) is forward-only and jax.grad through it fails;
// this is the backward of what it computes, and of csrc/ssd_scan.cu, so that
// mamba2 trains on the card. It computes what autograd of the plain block
// gives, written out in repro_torch/kernels/ref.py::ssd_intra_chunk_bwd_ref.
// For a chunk of q steps of one batch row and one head, with x, dy (q, p),
// dt, cum (q,), B, C (q, n) shared by all heads and dS (p, n):
//   CB[t,s] = C_t.B_s,  L[t,s] = exp(cum_t - cum_s) for s <= t (else 0),
//   w_s = exp(cum_last - cum_s) * dt_s,  G[t,s] = dy_t.x_s,
//   Q[t,s] = CB L G,  D[t,s] = L G dt_s,  M[t,s] = CB L dt_s,
//   dSB_s = dS B_s (p,),  R_s = x_s.dSB_s
//   dx_s   = sum_t M[t,s] dy_t + w_s dSB_s                  (x's dtype)
//   ddt_s  = sum_t Q[t,s] + exp(cum_last - cum_s) R_s
//   dcum_t = sum_s Q[t,s] dt_s - dt_t sum_t' Q[t',t] - w_t R_t
//            (+ sum_s w_s R_s at the chunk's last step)
//   dC_t   = sum_h sum_s D[t,s] B_s
//   dB_s   = sum_h (sum_t D[t,s] C_t + w_s dS^T x_s)
// Every product accumulates in f32 on the CUDA cores.
//
// What bounds it on the H100: at the training shape (b 4, s 1024, h 80,
// p 64, n 128, chunk 64, x bf16) it reads and writes 349 MB (dS alone
// 168 MB, dy 84, x and dx 42 each), 0.10 ms at 3.35 TB/s; its useful work
// is 18.95 GFLOP of f32 products (the causal halves counted once), 0.28 ms
// at the CUDA cores' 67 TFLOP/s, so the operations bound it
// (chip_smoke.py ssd_bwd_flops). This first version is simple and right,
// not fast (1.66 ms there on an H100 at 700 W, PERF.md):
//   - one block per (batch row, chunk) and group of heads. It loads B and C
//     once and forms C.B^T once, then walks its heads in order; a head's x,
//     dy, dS, dt and cum go to shared memory (f32, zero-padded to 64 x 64
//     and 64 x 128), and eight f32 products run from there, each thread a
//     4 x 4 or 4 x 8 tile of the output (rows ty + 16 i, columns tx + 16 j:
//     the 16 lanes of a half warp read 16 consecutive columns);
//   - the row strides are 1 word past a multiple of 32 (65, 129), so that a
//     half warp reading one column of 16 rows hits 16 banks;
//   - L is formed only for s <= t < q: the mask selects before the exp, so
//     an entry above the diagonal is 0.0f, never inf * 0 = NaN, however
//     far cum falls along the chunk;
//   - deterministic: no atomics. dB and dC sum over heads; a block adds its
//     heads' terms in order into registers, writes one partial per head
//     group, and a second launch adds the groups in order (one group writes
//     the result directly). Row sums are sequential loops or a fixed
//     butterfly of shuffles. The same inputs give the same bits.
// A sequence that is not a multiple of the chunk is refused by the wrapper
// (repro_torch/kernels/ssd_scan.py); ops.ssd_scan pads it with dt = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;   // largest chunk
constexpr int kP = 64;   // largest head dim
constexpr int kN = 128;  // largest state size
constexpr int kThreads = 256;
// head groups: enough blocks for this many waves of one block an SM
constexpr int kWaves = 4;
// row strides, in floats
constexpr int kBS = kN + 1;  // B, C and dS rows
constexpr int kLS = kQ + 1;  // the (q, q) tiles
constexpr int kXS = kP + 1;  // x and dy rows
// shared memory, in floats
constexpr int kOffC = kQ * kBS;
constexpr int kOffDS = kOffC + kQ * kBS;
constexpr int kOffCB = kOffDS + kP * kBS;
constexpr int kOffX = kOffCB + kQ * kLS;
constexpr int kOffDy = kOffX + kQ * kXS;
constexpr int kOffQ = kOffDy + kQ * kXS;
constexpr int kOffD = kOffQ + kQ * kLS;
constexpr int kOffM = kOffD + kQ * kLS;
constexpr int kOffVec = kOffM + kQ * kLS;
enum Vec { kDt, kCum, kE, kW, kR, kRowP, kColQ, kVecs };
constexpr int kSmemFloats = kOffVec + kVecs * kQ;
static_assert(kSmemFloats * 4 <= 232448, "one block an SM");
static_assert(kThreads == 256 && kQ == 64 && kP == 64 && kN == 128, "the thread tiles assume these sizes");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// A thread's tile of a product: acc[i][j] += sum over k < K of
// a[(ty + 16 i) * lda + k] * b_at(k, tx + 16 j), b_at reading B as the
// caller lays it out.
template <int J, typename BAt>
__device__ __forceinline__ void tile_product(float (&acc)[4][J], const float* a, int lda, int K, BAt b_at) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < K; ++k) {
    float av[4], bv[J];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < J; ++j) bv[j] = b_at(k, tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// the same with A transposed: a[k * lda + ty + 16 i]
template <int J, typename BAt>
__device__ __forceinline__ void tile_product_t(float (&acc)[4][J], const float* a, int lda, int K, BAt b_at) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < K; ++k) {
    float av[4], bv[J];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[k * lda + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < J; ++j) bv[j] = b_at(k, tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_intra_chunk_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ cum,
                           const float* __restrict__ Bm, const float* __restrict__ Cm,
                           const float* __restrict__ dy, const float* __restrict__ dS, T* __restrict__ dx,
                           float* __restrict__ ddt, float* __restrict__ dcum, float* __restrict__ dBw,
                           float* __restrict__ dCw, int64_t group_stride, int nc, int s_len, int h, int p,
                           int n, int q, int groups, int per) {
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;            // (q, n) at stride kBS
  float* sC = smem + kOffC;    // (q, n)
  float* sDS = smem + kOffDS;  // (p, n), this head's
  float* sCB = smem + kOffCB;  // (q, q) at stride kLS
  float* sX = smem + kOffX;    // (q, p) at stride kXS
  float* sDy = smem + kOffDy;  // (q, p)
  float* sQ = smem + kOffQ;    // (q, q): CB L G
  float* sD = smem + kOffD;    // (q, q): L G dt_s
  float* sM = smem + kOffM;    // (q, q): CB L dt_s
  float* sDt = smem + kOffVec + kDt * kQ;
  float* sCum = smem + kOffVec + kCum * kQ;
  float* sE = smem + kOffVec + kE * kQ;  // exp(cum_last - cum_s)
  float* sW = smem + kOffVec + kW * kQ;  // w_s
  float* sR = smem + kOffVec + kR * kQ;
  float* sRowP = smem + kOffVec + kRowP * kQ;
  float* sColQ = smem + kOffVec + kColQ * kQ;

  const int bc = blockIdx.x / groups, grp = blockIdx.x - bc * groups;
  const int h0 = grp * per;
  const int heads = h - h0 < per ? h - h0 : per;
  const int bi = bc / nc, ci = bc - bi * nc;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t row0 = static_cast<int64_t>(bi) * s_len + static_cast<int64_t>(ci) * q;

  for (int i = tid; i < kQ * kN; i += kThreads) {
    const int r = i / kN, c = i - r * kN;
    const bool in = r < q && c < n;
    sB[r * kBS + c] = in ? Bm[(row0 + r) * n + c] : 0.0f;
    sC[r * kBS + c] = in ? Cm[(row0 + r) * n + c] : 0.0f;
  }
  __syncthreads();
  {  // C.B^T, once for every head
    float acc[4][4] = {};
    tile_product<4>(acc, sC, kBS, n, [&](int k, int s) { return sB[s * kBS + k]; });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sCB[(ty + 16 * i) * kLS + tx + 16 * j] = acc[i][j];
    }
  }

  float accB[4][8] = {}, accC[4][8] = {};  // rows ty + 16 i, columns tx + 16 j
  for (int j = 0; j < heads; ++j) {
    const int hi = h0 + j;
    __syncthreads();  // C.B^T is in; the previous head is done with the tiles
    for (int i = tid; i < kQ * kP; i += kThreads) {
      const int r = i / kP, c = i - r * kP;
      const bool in = r < q && c < p;
      const int64_t g = ((row0 + r) * h + hi) * p + c;
      sX[r * kXS + c] = in ? to_f(x[g]) : 0.0f;
      sDy[r * kXS + c] = in ? dy[g] : 0.0f;
    }
    const float* dSh = dS + ((static_cast<int64_t>(bi) * nc + ci) * h + hi) * static_cast<int64_t>(p) * n;
    for (int i = tid; i < kP * kN; i += kThreads) {
      const int r = i / kN, c = i - r * kN;
      sDS[r * kBS + c] = r < p && c < n ? dSh[r * n + c] : 0.0f;
    }
    if (tid < kQ) {
      const bool in = tid < q;
      sDt[tid] = in ? dt[(row0 + tid) * h + hi] : 0.0f;
      sCum[tid] = in ? cum[(row0 + tid) * h + hi] : 0.0f;
    }
    __syncthreads();
    if (tid < kQ) {
      const float e = tid < q ? expf(sCum[q - 1] - sCum[tid]) : 0.0f;
      sE[tid] = e;
      sW[tid] = e * sDt[tid];
    }
    {  // G = dy.x^T, then Q, D and M, the mask taken before the exp
      float g[4][4] = {};
      tile_product<4>(g, sDy, kXS, p, [&](int k, int s) { return sX[s * kXS + k]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int t = ty + 16 * i, s = tx + 16 * jj;
          const float L = s <= t && t < q ? expf(sCum[t] - sCum[s]) : 0.0f;
          const float lg = L * g[i][jj], cb = sCB[t * kLS + s], d = sDt[s];
          sQ[t * kLS + s] = cb * lg;
          sD[t * kLS + s] = lg * d;
          sM[t * kLS + s] = cb * L * d;
        }
      }
    }
    __syncthreads();
    if (tid < kQ) {  // sum_s P[t,s] = sum_s Q[t,s] dt_s
      float r = 0.0f;
      for (int s = 0; s < q; ++s) r = fmaf(sQ[tid * kLS + s], sDt[s], r);
      sRowP[tid] = r;
    } else if (tid < 2 * kQ) {  // sum_t Q[t,s]
      const int s = tid - kQ;
      float c = 0.0f;
      for (int t = 0; t < q; ++t) c += sQ[t * kLS + s];
      sColQ[s] = c;
    }
    {  // dS B_s, R_s and dx: rows s = ty + 16 i, columns c = tx + 16 j of p
      float sb[4][4] = {}, xa[4][4] = {};
      tile_product<4>(sb, sB, kBS, n, [&](int k, int c) { return sDS[c * kBS + k]; });
      tile_product_t<4>(xa, sM, kLS, q, [&](int t, int c) { return sDy[t * kXS + c]; });
      T* dxh = dx + hi * p;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = ty + 16 * i;
        float r = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) r = fmaf(sX[s * kXS + tx + 16 * jj], sb[i][jj], r);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
        if (tx == 0) sR[s] = r;
        const float w = sW[s];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = tx + 16 * jj;
          if (s < q && c < p) dxh[(row0 + s) * h * p + c] = from_f<T>(fmaf(w, sb[i][jj], xa[i][jj]));
        }
      }
    }
    {  // dB_s += w_s dS^T x_s + sum_t D[t,s] C_t: rows s, columns of n
      float acc[4][8] = {};
      tile_product<8>(acc, sX, kXS, p, [&](int k, int c) { return sDS[k * kBS + c]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = sW[ty + 16 * i];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] *= w;
      }
      tile_product_t<8>(acc, sD, kLS, q, [&](int t, int c) { return sC[t * kBS + c]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) accB[i][jj] += acc[i][jj];
      }
    }
    {  // dC_t += sum_s D[t,s] B_s: rows t, columns of n
      float acc[4][8] = {};
      tile_product<8>(acc, sD, kLS, q, [&](int s, int c) { return sB[s * kBS + c]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) accC[i][jj] += acc[i][jj];
      }
    }
    __syncthreads();  // R, the row and the column sums are in
    if (tid < q) {
      const int t = tid;
      const float R = sR[t], colq = sColQ[t], w = sW[t];
      float dc = sRowP[t] - sDt[t] * colq - w * R;
      if (t == q - 1) {
        float total = 0.0f;
        for (int s = 0; s < q; ++s) total = fmaf(sW[s], sR[s], total);
        dc += total;
      }
      ddt[(row0 + t) * h + hi] = fmaf(sE[t], R, colq);
      dcum[(row0 + t) * h + hi] = dc;
    }
  }
  // this head group's dB and dC (or the result, with one group)
  float* outB = dBw + grp * group_stride;
  float* outC = dCw + grp * group_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = tx + 16 * jj;
      if (r < q && c < n) {
        outB[(row0 + r) * n + c] = accB[i][jj];
        outC[(row0 + r) * n + c] = accC[i][jj];
      }
    }
  }
}

// out[e] = sum over the groups of part[g][e], g in order; blockIdx.y picks
// dB (0) or dC (1)
__global__ void sum_groups_kernel(const float* __restrict__ partB, const float* __restrict__ partC,
                                  float* __restrict__ dB, float* __restrict__ dC, int groups, int64_t count) {
  const float* part = blockIdx.y == 0 ? partB : partC;
  float* out = blockIdx.y == 0 ? dB : dC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < count; e += stride) {
    float acc = part[e];
    for (int g = 1; g < groups; ++g) acc += part[g * count + e];
    out[e] = acc;
  }
}

// The SMs of the current device, read once (0 if it cannot be read).
int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// heads a block takes, for (batch rows x chunks) = bcs: enough groups for
// kWaves waves of one block an SM where the heads allow
int heads_per_block(int64_t bcs, int h) {
  const int sms = sm_count();
  if (sms == 0) return 0;
  int64_t groups = (static_cast<int64_t>(kWaves) * sms + bcs - 1) / bcs;
  groups = groups < 1 ? 1 : groups > h ? h : groups;
  return static_cast<int>((h + groups - 1) / groups);
}

template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

bool bad_shape(int b, int s_len, int h, int p, int n, int chunk) {
  return b < 1 || h < 1 || chunk < 1 || chunk > kQ || p < 1 || p > kP || n < 1 || n > kN || s_len < chunk ||
         s_len % chunk;
}

template <typename T>
int launch(const void* x, const float* dt, const float* cum, const float* Bm, const float* Cm, const float* dy,
           const float* dS, void* dx, float* ddt, float* dcum, float* dB, float* dC, float* part, int b, int s_len,
           int h, int p, int n, int q, cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = allow_smem<ssd_intra_chunk_bwd_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = s_len / q;
  const int64_t bcs = static_cast<int64_t>(b) * nc;
  const int per = heads_per_block(bcs, h);
  if (per == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int groups = (h + per - 1) / per;
  if (bcs * groups >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t count = static_cast<int64_t>(b) * s_len * n;
  if (groups > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* dBw = groups > 1 ? part : dB;
  float* dCw = groups > 1 ? part + groups * count : dC;
  ssd_intra_chunk_bwd_kernel<T><<<static_cast<unsigned>(bcs * groups), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, cum, Bm, Cm, dy, dS, static_cast<T*>(dx), ddt, dcum, dBw, dCw,
      groups > 1 ? count : 0, nc, s_len, h, p, n, q, groups, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return static_cast<int>(err);
  int64_t blocks = (count + 255) / 256;
  blocks = blocks > 4 * 132 ? 4 * 132 : blocks;
  sum_groups_kernel<<<dim3(static_cast<unsigned>(blocks), 2), 256, 0, stream>>>(part, part + groups * count, dB,
                                                                                 dC, groups, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The head groups a launch at this shape uses: the wrapper allocates a
// scratch of 2 x groups x b x s_len x n floats when it is above 1. 0 if the
// shape is refused or the device cannot be read.
extern "C" int repro_ssd_bwd_groups(int b, int s_len, int h, int p, int n, int chunk) {
  if (bad_shape(b, s_len, h, p, n, chunk)) return 0;
  const int per = heads_per_block(static_cast<int64_t>(b) * (s_len / chunk), h);
  return per == 0 ? 0 : (h + per - 1) / per;
}

// x_dtype: 0 float32, 1 bfloat16 (x and dx). Returns a cudaError_t (0 on
// success). The limits kQ, kP, kN are the wrapper's MAX_CHUNK,
// MAX_HEAD_DIM, MAX_STATE.
extern "C" int repro_ssd_intra_chunk_bwd(const void* x, const void* dt, const void* cum, const void* Bm,
                                         const void* Cm, const void* dy, const void* dS, void* dx, void* ddt,
                                         void* dcum, void* dB, void* dC, void* part, int b, int s_len, int h, int p,
                                         int n, int chunk, int x_dtype, void* stream) {
  if (bad_shape(b, s_len, h, p, n, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto m = [](void* v) { return static_cast<float*>(v); };
  if (x_dtype == 0) {
    return launch<float>(x, f(dt), f(cum), f(Bm), f(Cm), f(dy), f(dS), dx, m(ddt), m(dcum), m(dB), m(dC), m(part),
                         b, s_len, h, p, n, chunk, st);
  }
  if (x_dtype == 1) {
    return launch<__nv_bfloat16>(x, f(dt), f(cum), f(Bm), f(Cm), f(dy), f(dS), dx, m(ddt), m(dcum), m(dB), m(dC),
                                 m(part), b, s_len, h, p, n, chunk, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
