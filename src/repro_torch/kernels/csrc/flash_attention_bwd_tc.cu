// Backward flash attention on the H100's bf16 tensor cores (sm_90a): dq,
// dk and dv of the forward in flash_attention_tc.cu, with its causal and
// sliding-window masks, GQA head mapping and right-aligned queries; the
// route for bf16 at head dims 64, 128 and 256 (float32, and bf16 at head
// dims 16 and 32, take flash_attention_bwd.cu on the CUDA cores).
//
// Replaces: nothing on the TPU. The TPU kernel this port follows,
// src/repro/kernels/flash_attention.py (flash_attention_pallas), is
// forward-only; the JAX package trains through its plain jnp version. It is
// held against autograd of the plain version (repro_torch/kernels/ref.py,
// flash_attention_ref).
//
// The math (FlashAttention-2's backward): S = Q K^T (bf16 products, fp32
// sums), P = exp(S * scale - lse) in fp32 (lse = the forward's row
// log-sum-exp; masked entries 0), D_r = rowsum(dO_r * O_r):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//   dK = scale * dS^T Q,  dQ = scale * dS K.
// P and dS are rounded to bf16 as the A operands of their products.
//
// Deterministic, with no float atomics (a lossless resize is checked bit
// for bit against a run that never resized), as flash_attention_bwd.cu:
//   - bwd_rowdot: D, one warp per (batch, head, query row);
//   - bwd_dkdv_tc: one block per (64-key tile, kv head, batch), which keeps
//     K and V in shared memory and dK, dV in fp32 registers, and walks the
//     group's q heads and the 64-row q tiles that see its keys, in order;
//   - bwd_dq_tc: one block per (64-row q tile, q head, batch), which walks
//     the key tiles its rows see, recomputing S and dP.
// That makes 7 products where FlashAttention-2 makes 5 (S and dP twice),
// the price of writing dq without atomics.
//
// Every product is one wgmma.mma_async instruction per 16-deep step,
// m64nNk16 bf16 -> fp32, from one 128B-swizzled tile layout (wgmma.cuh):
//   dkdv: S^T = K Q^T and dP^T = V dO^T: m64n64k16, both operands K-major
//         from shared memory; dV += P^T dO and dK += dS^T Q: m64n{d}k16,
//         P^T and dS^T from registers (the S^T and dP^T accumulators
//         rounded to bf16), dO and Q MN-major from shared memory;
//   dq:   S = Q K^T and dP = dO V^T: m64n64k16, K-major; dQ += dS K:
//         m64n{d}k16, dS from registers, K MN-major.
// Computing S^T (keys as rows) in dkdv puts P^T straight into the register
// layout of the A operand, so nothing is transposed through shared memory.
// At d 256 the fp32 dK and dV (dQ) would not fit one warpgroup's
// registers: the block has two warpgroups that both form S and dP and each
// own half of the output columns.
//
// Tiles come in by 16-byte cp.async copies (zero-filled past the ends) into
// a ring of two stages, so the next tile's copies run under this tile's
// products (Q, dO, lse and D per q tile in dkdv; K and V per key tile in
// dq). Shared memory, d 64 / 128 / 256: dkdv 50 / 98 / 194 KB, dq the same.
// Registers per thread (-Xptxas -v, build.build_log("flash_attention_bwd_tc"),
// printed by chip_smoke.py): dkdv 194 / 254 / 252, dq 147 / 186 / 184,
// rowdot 26, no spills.
//
// What bounds it on the H100: at the training shape (b 4, s = t = 1024,
// 16 q / 8 kv heads of 128, causal) 5 products of 2 d FLOPs per attended
// pair are 43 GFLOP, 0.0435 ms at 989 TFLOP/s; the tensors are ~0.1 GB,
// 0.03 ms: the operations. This kernel does 7 products.
//
// The wrapper (repro_torch/kernels/flash_attention.py) checks shapes, types
// and devices, allocates dq, dk, dv and the D scratch, and passes torch's
// current stream.

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kB = 64;  // keys per dkdv block, query rows per dq block, rows per tile
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// at d 256 two warpgroups split the output columns
template <int D>
constexpr int kWarpgroups = D == 256 ? 2 : 1;

template <int D>
constexpr int smem_bytes() {
  // two resident tiles, two stages of two tiles, two stages of 2 x 64 floats
  return 1024 + 6 * kB * D * 2 + 2 * 2 * kB * 4;
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int t, int causal, int window) {
  bool ok = kpos < t;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// D[b, h, r] = sum_c dO[b, r, h, c] * O[b, r, h, c]; one warp per row
template <int D>
__global__ void __launch_bounds__(256)
bwd_rowdot(const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ dsum,
           int64_t rows, int s, int h) {
  const int64_t n = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  if (n >= rows) return;
  const int lane = threadIdx.x % 32;
  const int64_t bi = n / ((int64_t)h * s);
  const int64_t rem = n % ((int64_t)h * s);
  const int64_t hi = rem / s, r = rem % s;
  const int64_t off = ((bi * s + r) * h + hi) * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += __bfloat162float(dout[off + c]) * __bfloat162float(o[off + c]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(kFullMask, acc, w);
  if (lane == 0) dsum[n] = acc;
}

// lse (as log2 units) and D of 64 query rows into shared memory; rows past
// s get lse = +inf, so that their P is exp2(-inf) = 0
__device__ __forceinline__ void load_rowstats(float* lse2, float* dd, const float* lse,
                                              const float* dsum, int64_t off, int valid, int tid) {
  if (tid < kB) {
    const bool ok = tid < valid;
    lse2[tid] = ok ? lse[off + tid] * kLog2e : __int_as_float(0x7f800000);
    dd[tid] = ok ? dsum[off + tid] : 0.f;
  }
}

// bf16 pairs of a 64 x N fp32 accumulator, times `mul`, into rows
// row_a, row_a + 8 (< valid) at columns c0 + 8 j + col
template <int N>
__device__ __forceinline__ void store_acc(bf16* base, int64_t stride, const float (&x)[N / 2],
                                          int row_a, int valid, int c0, int col, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= valid) continue;
    bf16* p = base + row * stride + c0 + col;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) =
          __floats2bfloat162_rn(x[4 * j + 2 * r] * mul, x[4 * j + 2 * r + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(128 * kWarpgroups<D>, 1)
bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dsum, bf16* __restrict__ dk, bf16* __restrict__ dv, int s,
            int t, int h, int kh, int causal, int window, float scale, float scale_log2) {
  constexpr int NT = 128 * kWarpgroups<D>;
  constexpr int N = D / kWarpgroups<D>;  // output columns of a warpgroup
  constexpr int kTile = kB * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + kTile;
  const uint32_t sQ0 = sV + kTile;  // stage i: Q at sQ0 + 2 i kTile, dO after it
  float* rowbuf = reinterpret_cast<float*>(smem_raw + (sQ0 + 4 * kTile - raw));  // [stage][lse2, D][64]

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int khi = blockIdx.x;
  const int bi = blockIdx.y;
  const int k0 = blockIdx.z * kB;  // causal: the lowest keys, seen by the most rows, first
  const int rep = h / kh;
  const int q_offset = t - s;
  const int64_t q_row = (int64_t)h * D;
  const int64_t k_row = (int64_t)kh * D;

  // query rows that can see a key of this tile
  const int r_lo = causal ? max(0, k0 - q_offset) : 0;
  const int r_hi = window > 0 ? min(s, k0 + kB - 1 + window - q_offset) : s;
  const int qt_begin = r_lo / kB;
  const int nqt = r_hi > r_lo ? (r_hi + kB - 1) / kB - qt_begin : 0;
  const int items = rep * nqt;

  auto load_item = [&](int i, int stage) {
    const int hq = khi * rep + i / nqt;
    const int q0 = (qt_begin + i % nqt) * kB;
    const int64_t qoff = ((int64_t)bi * s * h + hq) * D + (int64_t)q0 * q_row;
    const uint32_t dst = sQ0 + stage * 2 * kTile;
    tc::load_tile<D, kB, NT>(dst, q + qoff, q_row, s - q0, tid);
    tc::load_tile<D, kB, NT>(dst + kTile, dout + qoff, q_row, s - q0, tid);
    float* rb = rowbuf + stage * 2 * kB;
    load_rowstats(rb, rb + kB, lse, dsum, ((int64_t)bi * h + hq) * s + q0, s - q0, tid);
  };
  const int64_t koff = ((int64_t)bi * t * kh + khi) * D + (int64_t)k0 * k_row;
  tc::load_tile<D, kB, NT>(sK, k + koff, k_row, t - k0, tid);
  tc::load_tile<D, kB, NT>(sV, v + koff, k_row, t - k0, tid);
  if (items > 0) load_item(0, 0);
  tc::cp_async_commit();

  float dka[N / 2], dva[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dka[i] = dva[i] = 0.f;
  const int key_a = k0 + warp * 16 + lane / 4;  // rows of S^T: keys key_a, key_a + 8
  const int col = 2 * (lane % 4);               // columns: query rows q0 + 8 j + col (+1)

  for (int i = 0; i < items; ++i) {
    const int stage = i & 1;
    if (i + 1 < items) {
      load_item(i + 1, stage ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_proxy_async();
    __syncthreads();
    const int q0 = (qt_begin + i % nqt) * kB;
    const uint32_t sQ = sQ0 + stage * 2 * kTile, sdO = sQ + kTile;
    const float* lse2 = rowbuf + stage * 2 * kB;
    const float* dd = lse2 + kB;

    float st[32], dpt[32];
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_m64n64(st, tc::desc_kmajor<kB>(sK, 0, ks), tc::desc_kmajor<kB>(sQ, 0, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_m64n64(dpt, tc::desc_kmajor<kB>(sV, 0, ks), tc::desc_kmajor<kB>(sdO, 0, ks), ks > 0);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(st);
    tc::fence_regs(dpt);

    const bool full = (!causal || k0 + kB - 1 <= q0 + q_offset) &&
                      (window == 0 || k0 > q0 + kB - 1 + q_offset - window) && k0 + kB <= t;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int qr = 8 * (j / 4) + col + (j & 1);  // query row in the tile
      float p = tc::ex2(st[j] * scale_log2 - lse2[qr]);
      if (!full && !visible(key_a + (j & 2 ? 8 : 0), q0 + qr + q_offset, t, causal, window)) p = 0.f;
      st[j] = p;
      dpt[j] = p * (dpt[j] - dd[qr]);
    }

    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tc::a_frag(st, kk, pa[kk]);
      tc::a_frag(dpt, kk, sa[kk]);
    }
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_rs<N>(dva, pa[kk], tc::desc_mnmajor<kB>(sdO, wg * (N / 64), kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_rs<N>(dka, sa[kk], tc::desc_mnmajor<kB>(sQ, wg * (N / 64), kk), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(dka);
    tc::fence_regs(dva);
    __syncthreads();  // this stage is free for the item after next
  }
  tc::cp_async_wait<0>();  // no q tile sees these keys: K and V were never waited for

  const int64_t ooff = ((int64_t)bi * t * kh + khi) * D + (int64_t)k0 * k_row;
  store_acc<N>(dk + ooff, k_row, dka, key_a - k0, t - k0, wg * N, col, scale);
  store_acc<N>(dv + ooff, k_row, dva, key_a - k0, t - k0, wg * N, col, 1.f);
}

template <int D>
__global__ void __launch_bounds__(128 * kWarpgroups<D>, 1)
bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, bf16* __restrict__ dq, int s, int t, int h, int kh,
          int causal, int window, float scale, float scale_log2) {
  constexpr int NT = 128 * kWarpgroups<D>;
  constexpr int N = D / kWarpgroups<D>;
  constexpr int kTile = kB * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sdO = sQ + kTile;
  const uint32_t sK0 = sdO + kTile;  // stage i: K at sK0 + 2 i kTile, V after it
  float* lse2 = reinterpret_cast<float*>(smem_raw + (sK0 + 4 * kTile - raw));
  float* dd = lse2 + kB;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kB;  // the most keys first
  const int khi = hi / (h / kh);
  const int q_offset = t - s;
  const int64_t q_row = (int64_t)h * D;
  const int64_t k_row = (int64_t)kh * D;
  const bf16* kb = k + ((int64_t)bi * t * kh + khi) * D;
  const bf16* vb = v + ((int64_t)bi * t * kh + khi) * D;

  // keys this q tile can see (as in the forward)
  const int q_last = min(q0 + kB, s) - 1;
  const int k_end = causal ? min(t, q_last + q_offset + 1) : t;
  const int k_begin = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int kt_begin = k_begin / kB;
  const int kt_end = (k_end + kB - 1) / kB;

  auto load_kv = [&](int kt, int stage) {
    const int kk0 = kt * kB;
    const uint32_t dst = sK0 + stage * 2 * kTile;
    tc::load_tile<D, kB, NT>(dst, kb + (int64_t)kk0 * k_row, k_row, t - kk0, tid);
    tc::load_tile<D, kB, NT>(dst + kTile, vb + (int64_t)kk0 * k_row, k_row, t - kk0, tid);
  };
  const int64_t qoff = ((int64_t)bi * s * h + hi) * D + (int64_t)q0 * q_row;
  tc::load_tile<D, kB, NT>(sQ, q + qoff, q_row, s - q0, tid);
  tc::load_tile<D, kB, NT>(sdO, dout + qoff, q_row, s - q0, tid);
  load_rowstats(lse2, dd, lse, dsum, ((int64_t)bi * h + hi) * s + q0, s - q0, tid);
  load_kv(kt_begin, 0);
  tc::cp_async_commit();

  float dqa[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dqa[i] = 0.f;
  const int row_a = warp * 16 + lane / 4;  // rows of the tile: row_a, row_a + 8
  const int col = 2 * (lane % 4);          // columns: keys k0 + 8 j + col (+1)

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      load_kv(kt + 1, stage ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_proxy_async();
    __syncthreads();
    const int k0 = kt * kB;
    const uint32_t sK = sK0 + stage * 2 * kTile, sV = sK + kTile;

    float sc[32], dp[32];
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_m64n64(sc, tc::desc_kmajor<kB>(sQ, 0, ks), tc::desc_kmajor<kB>(sK, 0, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_m64n64(dp, tc::desc_kmajor<kB>(sdO, 0, ks), tc::desc_kmajor<kB>(sV, 0, ks), ks > 0);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(sc);
    tc::fence_regs(dp);

    const bool full = (!causal || k0 + kB - 1 <= q0 + q_offset) &&
                      (window == 0 || k0 > q_last + q_offset - window) && k0 + kB <= t;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = row_a + (j & 2 ? 8 : 0);
      float p = tc::ex2(sc[j] * scale_log2 - lse2[r]);
      if (!full && !visible(k0 + 8 * (j / 4) + col + (j & 1), q0 + r + q_offset, t, causal, window))
        p = 0.f;
      dp[j] = p * (dp[j] - dd[r]);
    }

    uint32_t sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::a_frag(dp, kk, sa[kk]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_rs<N>(dqa, sa[kk], tc::desc_mnmajor<kB>(sK, wg * (N / 64), kk), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(dqa);
    __syncthreads();  // this stage is free for the tile after next
  }

  store_acc<N>(dq + qoff, q_row, dqa, row_a, s - q0, wg * N, col, scale);
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                   const float* lse, float* dsum, bf16* dq, bf16* dk, bf16* dv, int b, int s,
                   int t, int h, int kh, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  constexpr int nt = 128 * kWarpgroups<D>;
  cudaError_t err = cudaFuncSetAttribute(bwd_dkdv_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  const int64_t rows = (int64_t)b * h * s;
  bwd_rowdot<D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(o, dout, dsum, rows, s, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_tc<D><<<dim3(kh, b, (t + kB - 1) / kB), nt, smem, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, s, t, h, kh, causal, window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_tc<D><<<dim3(h, b, (s + kB - 1) / kB), nt, smem, stream>>>(
      q, k, v, dout, lse, dsum, dq, s, t, h, kh, causal, window, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; d in {64, 128, 256}. q/o/dout/dq are (b, s, h, d), k/v/dk/dv
// (b, t, kh, d), lse and dsum (b, h, s) fp32; dsum is scratch. Returns the
// cudaError_t of the launches.
extern "C" int repro_flash_attention_bwd_tc(const void* q, const void* k, const void* v,
                                            const void* o, const void* dout, const float* lse,
                                            float* dsum, void* dq, void* dk, void* dv, int b,
                                            int s, int t, int h, int kh, int d, int causal,
                                            int window, float scale, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0 || kh <= 0 || h % kh != 0 || b > 65535 || s > 65535 * kB ||
      t > 65535 * kB)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_TC_CASE(DIM)                                                                  \
  case DIM:                                                                                     \
    return launch<DIM>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),               \
                       static_cast<const bf16*>(v), static_cast<const bf16*>(o),               \
                       static_cast<const bf16*>(dout), lse, dsum, static_cast<bf16*>(dq),      \
                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), b, s, t, h, kh, causal, \
                       window, scale, st);
  switch (d) {
    REPRO_BWD_TC_CASE(64)
    REPRO_BWD_TC_CASE(128)
    REPRO_BWD_TC_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_TC_CASE
}

extern "C" const char* repro_flash_bwd_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
