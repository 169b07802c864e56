// Forward flash attention on the H100's bf16 tensor cores (sm_90a), with
// causal and sliding-window masks, GQA head mapping and right-aligned
// queries: the route for bf16 at head dims 64, 128 and 256. float32, and
// bf16 at head dims 16 and 32, take flash_attention.cu (fp32 on the CUDA
// cores); the wrapper chooses by (dtype, head dim).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (kernel body _fa_kernel), the TPU Pallas kernel on the prefill path and in
// every train step (models/attention.py, attn_forward). Same function: q
// (b,s,h,d) against k/v (b,t,kh,d), q head hi reads kv head hi / (h/kh),
// queries right-aligned at q_offset = t - s, softmax statistics in fp32,
// output in q's dtype, and the (b, h, s) fp32 row log-sum-exp
// (lse = m + log l) for the backward when the wrapper passes a buffer.
//
// What bounds it on the H100: at the serving prefill (b 8, s = t = 512,
// 16 q / 8 kv heads of 128, causal) the products are 8.6 GFLOP (8.7 us at
// 989 TFLOP/s) and q, k, v and o are 50 MB (15 us at 3.35 TB/s): the bytes.
// At the training shape (b 4, s = t = 1024) 17.2 GFLOP, 17 us: the
// operations, about as much as the bytes. Every product is one
// wgmma.mma_async per 16-deep step (HGMMA in the SASS).
//
// Design, one block per (q tile, q head, batch), NWG warpgroups of 64
// query rows each, BK keys per tile (d 64: 2 x 64 rows, BK 64; d 128:
// 2 x 64 rows, BK 128; d 256: 1 x 64 rows, BK 64, for registers):
//   - the TPU's sequential k-grid is a loop over the key tiles the block's
//     rows see (tiles wholly above the causal diagonal or outside the
//     window are skipped); every warpgroup walks all of them, so the control
//     flow around wgmma stays uniform (ptxas serialises wgmma in branches
//     it cannot prove uniform), and the mask does the rest;
//   - Q comes in once by 16-byte cp.async copies; K and V come into a
//     ring of three stages by TMA (cp.async.bulk.tensor over a 4-D tensor
//     map of (b, t, kh, d), 128B swizzle, rows past t zero-filled), one
//     copy per 64-column chunk, issued by one thread one tile ahead and
//     completed on the stage's mbarrier. The tensor maps come from
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//     the build needs no -lcuda. (A separate producer warp, with empty
//     barriers in place of the block barrier, was tried and measured
//     slower: PERF.md.)
//   - S = Q.K^T: wgmma.mma_async m64n{BK}k16 bf16 -> fp32, Q and K both
//     K-major from shared memory; S is scaled in fp32 after the product
//     (q * scale is never rounded to bf16);
//   - online softmax in fp32 registers: the mask before the exp (2^x of
//     log2-scaled scores on the special-function unit), the row max across
//     the 4 lanes that share a row;
//   - O += P.V: P rounded to bf16 in registers is the register A operand
//     of wgmma.mma_async m64n{d}k16, V the B operand, MN-major (the
//     transposed layout bf16 wgmma allows) from the same swizzled tile;
//     O stays in fp32 registers. The P.V of tile j is issued with tile
//     j + 1's S and runs under that tile's softmax (hence the third stage);
//   - epilogue: O / l in bf16 (the l == 0 guard of _fa_kernel), lse;
//   - grid (h, b, q tiles), the q tile index reversed, so the tiles with
//     the most keys start first and the causal tail fills the idle SMs.
// Each block loads its kv head's K and V itself: the rep q heads of a GQA
// group do not share the loads.
//
// Shared memory: Q 64 NWG x d + 3 stages x (K + V) BK x d, bf16, + 1 KB of
// alignment (+ 3 mbarriers): 65 / 225 / 225 KB at d 64 / 128 / 256, so one
// block of 256 (d 256: 128) threads per SM at d 128 and 256. Registers per
// thread (-Xptxas -v, build.build_log("flash_attention_tc"), printed by
// chip_smoke.py): 106 / 186 / 202 at d 64 / 128 / 256, no spills.
//
// The wrapper (repro_torch/kernels/flash_attention.py) checks shapes, types,
// alignment and devices, refuses causal t < s (rows that would see no key),
// allocates the outputs and passes torch's current stream.

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the running max before any key
constexpr float kLn2 = 0.69314718055994531f;

// NWG warpgroups of 64 query rows each, BK keys per tile, a ring of ST
// K/V stages
template <int D, int NWG, int BK, int ST>
constexpr int smem_bytes() {
  return 1024 + 64 * NWG * D * 2 + ST * 2 * BK * D * 2;
}

// S of one tile (64 rows x BK keys, fp32) to log2-scaled, masked scores,
// their running max m2 and the rescale factor alpha of each of the
// thread's two rows, then to P = exp2(S - m2) with its row sums.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float (&m2)[2], float (&l)[2],
                                               float (&alpha)[2], bool full, int row_a, int k0,
                                               int col, int t, int q_offset, int causal, int window,
                                               float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = sc[i] * scale_log2;
    if (!full) {
      const int qpos = row_a + (i & 2 ? 8 : 0) + q_offset;
      const int kpos = k0 + 8 * (i / 4) + col + (i & 1);
      bool ok = kpos < t;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      x = ok ? x : __int_as_float(0xff800000);  // -inf
    }
    sc[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m2[r], mx[r]);
    alpha[r] = tc::ex2(m2[r] - m_new);
    m2[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = tc::ex2(sc[i] - m2[r]);  // masked: 2^-inf = 0
    psum[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
}

template <int D, int NWG, int BK, int ST>
__global__ void __launch_bounds__(128 * NWG, 1)
fa_fwd_tc_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, float* __restrict__ lse,
                 int s, int t, int h, int kh, int causal, int window, float scale_log2) {
  constexpr int kBQ = 64 * NWG;  // query rows per block
  constexpr int kThreads = 128 * NWG;
  constexpr int kTile = BK * D * 2;  // bytes of one K or V stage
  constexpr int kSteps = BK / 16;    // k-steps of P.V
  constexpr int kStages = ST;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[ST];  // stage i's K and V have landed
  const uint32_t sQ = (tc::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + kBQ * D * 2;  // stage i: K at sKV + 2 i kTile, V after it

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // the most keys first
  const int khi = hi / (h / kh);
  const int q_offset = t - s;
  const int64_t q_row = (int64_t)h * D;  // stride between sequence positions
  const bf16* qb = q + ((int64_t)bi * s * h + hi) * D;

  // key tiles the block's rows see; every warpgroup walks all of them (the
  // control flow around wgmma stays uniform) and the mask does the rest
  const int q_last = min(q0 + kBQ, s) - 1;
  const int k_end = causal ? min(t, q_last + q_offset + 1) : t;
  const int k_begin = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int kt_end = (k_end + BK - 1) / BK;

  // K and V of tile kt into a stage: one thread issues a TMA copy per
  // 64-column chunk (zero rows past t) and announces the bytes on the
  // stage's barrier
  auto load_kv = [&](int kt, int stage) {
    if (tid == 0) {
      const uint32_t dst = sKV + stage * 2 * kTile;
      const uint32_t bar = tc::smem_addr(&full[stage]);
      tc::mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tc::tma_load_4d(dst + c * (BK * 128), &tm_k, bar, 64 * c, khi, kt * BK, bi);
        tc::tma_load_4d(dst + kTile + c * (BK * 128), &tm_v, bar, 64 * c, khi, kt * BK, bi);
      }
    }
  };
  // every key of tile kt visible to every row of the block?
  auto full_tile = [&](int kt) {
    const int k0 = kt * BK;
    return (!causal || k0 + BK - 1 <= q0 + q_offset) && (window == 0 || k0 > q_last + q_offset - window) &&
           k0 + BK <= t;
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < ST; ++i) tc::mbar_init(tc::smem_addr(&full[i]), 1);
    tc::fence_mbar_init();
  }
  __syncthreads();
  load_kv(kt_begin, 0);
  tc::load_tile<D, kBQ, kThreads>(sQ, qb + (int64_t)q0 * q_row, q_row, s - q0, tid);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  tc::fence_proxy_async();  // Q is published by the first barrier of the loop

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m2[2] = {kNegInf, kNegInf};  // running max of the log2-scaled scores
  float l[2] = {0.f, 0.f};           // this thread's share of the denominator
  float alpha[2];
  const int row_a = q0 + 64 * wg + warp * 16 + lane / 4;  // and row_a + 8
  const int col = 2 * (lane % 4);
  float sc[BK / 2];
  uint32_t pa[kSteps][4];

  // The P.V of tile j runs while tile j + 1's S = Q.K^T is formed and its
  // softmax computed: P_j waits in registers (pa) for iteration j + 1, so
  // tile j's V stays in use one iteration longer; hence three stages,
  // loaded one tile ahead.
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) % kStages;
    __syncthreads();  // tile kt - 2's stage is read by no one
    if (kt + 1 < kt_end) load_kv(kt + 1, (stage + 1) % kStages);
    tc::mbar_wait(tc::smem_addr(&full[stage]), ((kt - kt_begin) / kStages) & 1);  // this tile's K and V
    const uint32_t sK = sKV + stage * 2 * kTile;
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss<BK>(sc, tc::desc_kmajor<kBQ>(sQ, 64 * wg, ks), tc::desc_kmajor<BK>(sK, 0, ks), ks > 0);
    tc::wgmma_commit();
    if (kt > kt_begin) {
      const uint32_t sV_prev = sKV + ((stage + kStages - 1) % kStages) * 2 * kTile + kTile;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) tc::wgmma_rs<D>(acc, pa[kk], tc::desc_mnmajor<BK>(sV_prev, 0, kk), 1);
      tc::wgmma_commit();
      tc::wgmma_wait<1>();  // S is in; the last tile's P.V may still run
    } else {
      tc::wgmma_wait<0>();
    }
    tc::fence_regs(sc);
    online_softmax<BK>(sc, m2, l, alpha, full_tile(kt), row_a, kt * BK, col, t, q_offset, causal, window,
                       scale_log2);
    tc::wgmma_wait<0>();  // the last tile's P.V
    tc::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) tc::a_frag(sc, kk, pa[kk]);
  }
  {
    const uint32_t sV_last = sKV + ((kt_end - 1 - kt_begin) % kStages) * 2 * kTile + kTile;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) tc::wgmma_rs<D>(acc, pa[kk], tc::desc_mnmajor<BK>(sV_last, 0, kk), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);
  }

  bf16* ob = o + ((int64_t)bi * s * h + hi) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = row_a + 8 * r;
    if (row >= s) continue;
    const float denom = lt == 0.f ? 1.f : lt;
    if (lse != nullptr && lane % 4 == 0) lse[((int64_t)bi * h + hi) * s + row] = m2[r] * kLn2 + logf(lt);
    bf16* orow = ob + row * q_row + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
  }
}

template <int D, int NWG, int BK, int ST>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int s,
                   int t, int h, int kh, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, NWG, BK, ST>();
  static_assert(smem + 64 <= 232448, "shared memory above the H100's 227 KB per block");
  CUtensorMap tm_k, tm_v;
  cudaError_t err = tc::make_tensor_map(&tm_k, k, b, t, kh, D, BK);
  if (err != cudaSuccess) return err;
  err = tc::make_tensor_map(&tm_v, v, b, t, kh, D, BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_fwd_tc_kernel<D, NWG, BK, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(h, b, (s + 64 * NWG - 1) / (64 * NWG));
  fa_fwd_tc_kernel<D, NWG, BK, ST><<<grid, 128 * NWG, smem, stream>>>(
      static_cast<const bf16*>(q), tm_k, tm_v, static_cast<bf16*>(o), lse, s, t, h, kh, causal, window,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; d in {64, 128, 256}; lse: (b, h, s) fp32 or null. Returns the
// cudaError_t of the launch.
extern "C" int repro_flash_attention_fwd_tc(const void* q, const void* k, const void* v, void* o,
                                            float* lse, int b, int s, int t, int h, int kh, int d,
                                            int causal, int window, float scale, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0 || kh <= 0 || h % kh != 0 || b > 65535 || s > 65535 * 64)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64, 2, 64, 3>(q, k, v, o, lse, b, s, t, h, kh, causal, window, scale, st);
    case 128: return launch<128, 2, 128, 3>(q, k, v, o, lse, b, s, t, h, kh, causal, window, scale, st);
    case 256: return launch<256, 1, 64, 3>(q, k, v, o, lse, b, s, t, h, kh, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_flash_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
