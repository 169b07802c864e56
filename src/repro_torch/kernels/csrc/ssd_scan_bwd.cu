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
//
// What bounds it on the H100: at the training shape (b 4, s 1024, h 80,
// p 64, n 128, chunk 64, x bf16) it reads and writes 349 MB (dS alone
// 168 MB, dy 84, x and dx 42 each), 0.104 ms at 3.35 TB/s. Its products,
// at f32 accuracy, are three TF32 products each on the tensor cores (495
// TFLOP/s): 13.57 GFLOP of least work (D^T.C and D.B once a block, D
// summed over its heads; chip_smoke.py ssd_bwd_flops), 0.082 ms, where
// forming D^T.C and D.B per head would take 18.95 GFLOP, 0.115 ms. The
// TF32 products it issues, the causal blocks' padding and the products of
// two and three passes counted, come to 35.99 GFLOP (chip_smoke.py
// ssd_bwd_tensor_core_flops). So the bytes bound it, and mma.sync (which
// reaches a fraction of the tensor cores' peak) and the work that feeds
// it, at one block an SM, hold it above that. The design:
//   - every product is mma.sync m16n8k8 TF32 with f32 accumulators, at f32
//     accuracy by the 3xTF32 split of csrc/ssd_scan.cu: an f32 operand a is
//     hi(a) = rna.tf32(a) plus lo(a) = tf32(a - hi(a)), and a.b =
//     lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b), the small terms first (lo.lo,
//     ~2^-21 relative, is dropped); each pass issues all of a k-step's
//     products before the next pass, so that no mma waits on the one
//     before. C.B^T, B.dS^T, M^T.dy, D^T.C and D.B take three products;
//     G = dy.x^T and x.dS take two for a bf16 x (exact in TF32: its lo is
//     zero) and three for an f32 x. The k-steps above the diagonal of a
//     causal operand (L, so Q, D, M) are skipped: the (q, q) products run
//     on the 16 x 16 blocks at or below it; there and in M^T.dy each warp
//     takes two m-tiles paired (i, 3 - i) so that the warps skip alike;
//   - D enters dB and dC only through D^T.C and D.B, linear in D with C
//     and B the same for every head: a block sums D over its heads in the
//     registers that form it, and runs those two products once, after its
//     last head. Per head it runs G, B.dS^T, M^T.dy and x.dS;
//   - one block of 8 warps an SM per (batch row, chunk) and group of heads,
//     one wave: the host takes as many groups as leave every block on its
//     own SM. A block loads B and C once, forms C.B^T once, and walks its
//     heads. The next head's dS (the largest stream), dt and cum go to a
//     second buffer by 16-byte cp.async while the current head computes;
//     its x and dy are issued once the current head's last read of them is
//     done, and land while the block forms the next head's B.dS^T;
//   - shared memory (226,304 bytes of the 232,448 a block may have): B, C
//     (64 x 128 f32), C.B^T, M^T, D (64 x 64; D only for the sum at the
//     end), two dS buffers (64 x 128), dy (64 x 64), x in its own dtype,
//     each row 4 words past a multiple of 32 (at: a row-major fragment by
//     ldmatrix free of bank conflicts, a transposed one at most two lanes a
//     bank; M is stored transposed so that M^T.dy reads it row-major), then
//     dt and cum of two heads, E = exp(cum_last - cum), w and the partial
//     sums. A bf16 x is read a pair of bf16 a word, the pair's two columns
//     in the fragment's k-slots c and c + 4, and the other operand of its
//     products takes its k the same way (bf16_pair);
//   - L = exp(cum_t - cum_s) grows without bound for s > t (cum decreases
//     along the chunk), so the mask (s <= t < q) selects before the exp in
//     every fragment, padded rows included: a masked entry of D and M is
//     0.0f, never inf * 0 = NaN, however far cum falls along the chunk;
//   - the sums come from the accumulator fragments, no thread looping over
//     the chunk: sum_s Q[t,s] dt_s, sum_t Q[t,s] and R_s are summed in each
//     lane, then by a fixed butterfly of shuffles within the quad (rows) or
//     across the groups (columns), and each warp writes its partial to
//     shared memory; two warps add the 4 (or 2) partials in order, form the
//     last step's sum_s w_s R_s by a butterfly, and write ddt, dcum;
//   - deterministic: no atomics. dB and dC sum over heads: a block adds its
//     heads' terms (and D) in order in registers and writes one partial per
//     head group, and a second launch adds the groups in order (one group
//     writes the result directly). Every sum above has a fixed order, so
//     the same inputs give the same bits;
//   - stores: dx (x's dtype), dB and dC go out as 16-byte stores, the
//     accumulators regrouped within a quad by shuffles (quad_columns), a
//     warp writing each 32-byte sector in one store.
// The full shape (chunk 64, head dim 64, state 128, 16-byte aligned arrays)
// takes the asynchronous loads and vector stores; any smaller chunk, head or
// state size up to kQ, kP, kN runs the same products over zero-padded tiles,
// with plain loads and element stores. A sequence that is not a multiple of
// the chunk is refused by the wrapper (repro_torch/kernels/ssd_scan.py);
// ops.ssd_scan pads it with dt = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kQ = 64;   // largest chunk
constexpr int kP = 64;   // largest head dim
constexpr int kN = 128;  // largest state size
constexpr int kThreads = 256;
// x's row stride in elements: 4 words past a multiple of 32
template <typename T>
constexpr int kXS = std::is_same_v<T, float> ? kP + 4 : kP + 8;
// shared memory, in floats: B, C, C.B^T, D, M, two dS buffers, dy, x, then
// the vectors; an f32 tile's rows are kPad words longer than its width (at)
constexpr int kPad = 4;
constexpr int kOffC = kQ * (kN + kPad);
constexpr int kOffCB = kOffC + kQ * (kN + kPad);
constexpr int kOffD = kOffCB + kQ * (kQ + kPad);
constexpr int kOffM = kOffD + kQ * (kQ + kPad);
constexpr int kOffDS = kOffM + kQ * (kQ + kPad);
constexpr int kDSFloats = kP * (kN + kPad);
constexpr int kOffDy = kOffDS + 2 * kDSFloats;
constexpr int kOffX = kOffDy + kQ * (kP + kPad);
constexpr int kOffVec = kOffX + kQ * kXS<float>;
// the vectors: dt and cum of two heads ([buffer][dt | cum][kQ]), E, w, and
// the partial sums over 4 column groups (rows of Q dt, R) or 2 warps (Q's
// columns)
enum Vec { kDtCum = 0, kE = 4 * kQ, kW = 5 * kQ, kRowPart = 6 * kQ, kColPart = 10 * kQ, kRPart = 12 * kQ,
           kVecFloats = 16 * kQ };
constexpr int kSmemFloats = kOffVec + kVecFloats;
static_assert(kQ * kXS<__nv_bfloat16> * 2 <= kQ * kXS<float> * 4, "a bf16 x fits an f32 x's space");
static_assert(kSmemFloats * 4 <= 232448, "one block an SM");
static_assert(kThreads == 256 && kQ == 64 && kP == 64 && kN == 128, "the warp tiles assume these sizes");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// a = hi + lo: hi is a rounded to TF32 to nearest, ties away from zero
// (cvt.rna.tf32.f32's rounding, done as two integer operations, which issue
// at a higher rate than the conversion: half a unit of TF32's last place
// added to the magnitude, the 13 bits below it dropped); lo = a - hi, exact
// in f32, which the tensor core reads as TF32 by dropping its 13 low bits
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i][j] += a_i.b_j at f32 accuracy for the A-fragments FIRST <= i < LAST
// and the J B-fragments of a k-step: 3xTF32, the small terms first,
// lo(a).hi(b), hi(a).lo(b), hi(a).hi(b); EXACT_A / EXACT_B (a bf16 x, exact
// in TF32, its lo zero) drop the term that vanishes. Each pass issues its
// products together, so that no mma waits on the one before it.
template <int I, int J, bool EXACT_A, bool EXACT_B, int FIRST = 0, int LAST = I>
__device__ __forceinline__ void mma3(float (&d)[I][J][4], const uint32_t (&ah)[I][4], const uint32_t (&al)[I][4],
                                     const uint32_t (&bh)[J][2], const uint32_t (&bl)[J][2]) {
  if constexpr (!EXACT_A) {
#pragma unroll
    for (int i = FIRST; i < LAST; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) mma(d[i][j], al[i], bh[j]);
    }
  }
  if constexpr (!EXACT_B) {
#pragma unroll
    for (int i = FIRST; i < LAST; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) mma(d[i][j], ah[i], bl[j]);
    }
  }
#pragma unroll
  for (int i = FIRST; i < LAST; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) mma(d[i][j], ah[i], bh[j]);
  }
}

// Calls f with std::integral_constant<int, 0> if all is true, else with 1:
// the first of a warp's two m-tiles that a causal product reaches, as a
// constant, so that each case is straight-line code
template <typename F>
__device__ __forceinline__ void from_tile(bool all, F&& f) {
  if (all) {
    f(std::integral_constant<int, 0>());
  } else {
    f(std::integral_constant<int, 1>());
  }
}

// The place of element (r, col) in an f32 tile of width W (64 or 128) in
// shared memory: rows kPad = 4 words past a multiple of 32 apart. Fragments
// whose rows run along the lanes' groups g (a row-major A, or a B stored
// [col][k]) are read by ldmatrix, 8 rows of 16 bytes a phase: 32 distinct
// banks. Those whose rows run along the lanes' places c in a quad (a B
// stored [k][col], or an A stored transposed) are read a word a lane, rows
// k0 + c and columns col0 + g: 20 banks, at most two lanes a bank. A column
// swizzle that frees both costs integer work on every fragment element.
template <int W>
__device__ __forceinline__ int at(int r, int col) {
  return r * (W + kPad) + col;
}

// The A operand (16 x 8, row-major) of a tile stored [row][k] at (r0, k0),
// split; lane (g, c): rows g, g + 8, columns c, c + 4. One ldmatrix.x4
// reads it: its four 8 x 8 matrices of 16-bit pairs are the fragment's
// four 8 x 4 f32 quarters, and lane i's word of a matrix is element (i / 4,
// i % 4) of its quarter, the fragment's layout. Lane i gives the address of
// row i % 8 of matrix i / 8 (16-byte rows: the tiles' strides and columns
// are multiples of 4 words).
template <int LD>
__device__ __forceinline__ void load_a(const float* t, int r0, int k0, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int i = threadIdx.x & 31, m = i >> 3;
  const float* row = t + at<LD>(r0 + (i & 7) + 8 * (m & 1), k0 + 4 * (m >> 1));
  uint32_t v[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
#pragma unroll
  for (int e = 0; e < 4; ++e) split(__uint_as_float(v[e]), hi[e], lo[e]);
}

// the A operand read from a tile stored [k][row] (A^T row-major: M^T.dy's
// M, D^T.C's D)
template <int LD>
__device__ __forceinline__ void load_a_t(const float* t, int r0, int k0, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  split(t[at<LD>(k0 + c, r0 + g)], hi[0], lo[0]);
  split(t[at<LD>(k0 + c, r0 + g + 8)], hi[1], lo[1]);
  split(t[at<LD>(k0 + c + 4, r0 + g)], hi[2], lo[2]);
  split(t[at<LD>(k0 + c + 4, r0 + g + 8)], hi[3], lo[3]);
}

// the B operand (8 x 8) of a tile stored [k][col] at (k0, col0), split;
// lane (g, c): k = c, c + 4, column g
template <int LD>
__device__ __forceinline__ void load_b(const float* t, int k0, int col0, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  split(t[at<LD>(k0 + c, col0 + g)], hi[0], lo[0]);
  split(t[at<LD>(k0 + c + 4, col0 + g)], hi[1], lo[1]);
}

// the B operand read from a tile stored [col][k] (B^T row-major: C.B^T's
// B, B.dS^T's dS), by one ldmatrix.x2 (lanes 0-15 give the rows)
template <int LD>
__device__ __forceinline__ void load_b_t(const float* t, int k0, int col0, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int i = threadIdx.x & 15;
  const float* row = t + at<LD>(col0 + (i & 7), k0 + 4 * (i >> 3));
  uint32_t v[2];
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(v[0]), "=r"(v[1])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
  split(__uint_as_float(v[0]), hi[0], lo[0]);
  split(__uint_as_float(v[1]), hi[1], lo[1]);
}

// x's element (r, col), stored [step][column] at stride kXS, as f32 (an
// f32 x's tile is laid out as the other f32 tiles, at<kP>)
template <typename T>
__device__ __forceinline__ float x_at(const T* x, int r, int col) {
  return to_f(x[r * kXS<T> + col]);
}

// A bf16 x is exact in TF32, so its fragments need no split, and it is read
// a 32-bit pair of bf16 at a time: the fragment's k-slots c and c + 4 take
// the pair's columns 2c and 2c + 1. The other operand of its products takes
// its k the same way (load_a_pairs, load_b_pairs); the mma sums the same
// eight terms. A pair's two bf16 -> f32 (its low half first).
__device__ __forceinline__ void bf16_pair(uint32_t w, uint32_t& lo_col, uint32_t& hi_col) {
  lo_col = w << 16;
  hi_col = w & 0xffff0000u;
}

// a bf16 x as the A operand of x.dS (rows r0, columns k0, k-slots paired)
__device__ __forceinline__ void load_a_x_pairs(const __nv_bfloat16* x, int r0, int k0, uint32_t (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  bf16_pair(*reinterpret_cast<const uint32_t*>(x + (r0 + g) * kXS<__nv_bfloat16> + k0 + 2 * c), a[0], a[2]);
  bf16_pair(*reinterpret_cast<const uint32_t*>(x + (r0 + g + 8) * kXS<__nv_bfloat16> + k0 + 2 * c), a[1], a[3]);
}

// a bf16 x^T as the B operand of G = dy.x^T (B[k][s] = x[s][k], k-slots paired)
__device__ __forceinline__ void load_b_x_pairs(const __nv_bfloat16* x, int k0, int col0, uint32_t (&b)[2]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  bf16_pair(*reinterpret_cast<const uint32_t*>(x + (col0 + g) * kXS<__nv_bfloat16> + k0 + 2 * c), b[0], b[1]);
}

// the A operand of a tile stored [row][k], k-slots paired (G's dy against a
// bf16 x), split
template <int LD>
__device__ __forceinline__ void load_a_pairs(const float* t, int r0, int k0, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  const float2 top = *reinterpret_cast<const float2*>(t + at<LD>(r0 + g, k0 + 2 * c));
  const float2 bot = *reinterpret_cast<const float2*>(t + at<LD>(r0 + g + 8, k0 + 2 * c));
  split(top.x, hi[0], lo[0]);
  split(bot.x, hi[1], lo[1]);
  split(top.y, hi[2], lo[2]);
  split(bot.y, hi[3], lo[3]);
}

// the B operand of a tile stored [k][col], k-slots paired (x.dS's dS against
// a bf16 x), split: rows k0 + 2c and k0 + 2c + 1 fall in distinct banks
template <int LD>
__device__ __forceinline__ void load_b_pairs(const float* t, int k0, int col0, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  split(t[at<LD>(k0 + 2 * c, col0 + g)], hi[0], lo[0]);
  split(t[at<LD>(k0 + 2 * c + 1, col0 + g)], hi[1], lo[1]);
}

__device__ __forceinline__ void store2(float* t, int idx, float a, float b) {
  *reinterpret_cast<float2*>(t + idx) = make_float2(a, b);
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(gmem) : "memory");
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two accumulator n-tiles of one row (a = columns 2c, 2c + 1 of the first,
// b of the second; c = this lane's place in its quad) -> this lane's four
// contiguous columns 4c .. 4c + 3 of the 16. Odd lanes swap their tiles,
// then two shuffles a value bring each lane the pairs it needs.
__device__ __forceinline__ float4 quad_columns(float a0, float a1, float b0, float b1) {
  const int c = threadIdx.x & 3, base = (threadIdx.x & 31) & ~3;
  const bool odd = c & 1;
  const float s00 = odd ? b0 : a0, s01 = odd ? b1 : a1;  // slot 0
  const float s10 = odd ? a0 : b0, s11 = odd ? a1 : b1;  // slot 1
  const int half = c >> 1;
  const int from0 = base + 2 * (c & 1) + half, from1 = base + 2 * (c & 1) + (half ^ 1);
  const float r0x = __shfl_sync(0xffffffffu, s00, from0), r0y = __shfl_sync(0xffffffffu, s01, from0);
  const float r1x = __shfl_sync(0xffffffffu, s10, from1), r1y = __shfl_sync(0xffffffffu, s11, from1);
  return half ? make_float4(r1x, r1y, r0x, r0y) : make_float4(r0x, r0y, r1x, r1y);
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stores a warp's accumulators acc[j] (n-tiles j of the 16 x 8J tile at
// (row0, col0)) to out[row * ld + col] in T, rows below rows, columns below
// cols. FULL: 16-byte stores; each quad regroups a row's columns
// (quad_columns) so that a lane holds four contiguous ones, and for a bf16
// out (8 a store) the even lane of a pair takes row g's eight, the odd lane
// row g + 8's. Else one element a store.
template <bool FULL, int J, typename T>
__device__ __forceinline__ void store_tile(T* out, int64_t ld, int row0, int col0, const float (&acc)[J][4],
                                           int rows, int cols) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  if constexpr (FULL) {
#pragma unroll
    for (int j = 0; j < J; j += 2) {
      const float4 top = quad_columns(acc[j][0], acc[j][1], acc[j + 1][0], acc[j + 1][1]);
      const float4 bot = quad_columns(acc[j][2], acc[j][3], acc[j + 1][2], acc[j + 1][3]);
      if constexpr (std::is_same_v<T, float>) {
        const int col = col0 + 8 * j + 4 * c;
        *reinterpret_cast<float4*>(out + (row0 + g) * ld + col) = top;
        *reinterpret_cast<float4*>(out + (row0 + g + 8) * ld + col) = bot;
      } else {
        const uint2 t2 = make_uint2(bf16x2(top.x, top.y), bf16x2(top.z, top.w));
        const uint2 b2 = make_uint2(bf16x2(bot.x, bot.y), bf16x2(bot.z, bot.w));
        const bool odd = c & 1;
        const uint2 send = odd ? t2 : b2;
        const uint2 got = make_uint2(__shfl_xor_sync(0xffffffffu, send.x, 1), __shfl_xor_sync(0xffffffffu, send.y, 1));
        const uint4 v = odd ? make_uint4(got.x, got.y, b2.x, b2.y) : make_uint4(t2.x, t2.y, got.x, got.y);
        *reinterpret_cast<uint4*>(out + (row0 + g + (odd ? 8 : 0)) * ld + col0 + 8 * j + 8 * (c >> 1)) = v;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + g + 8 * (e >> 1), col = col0 + 8 * j + 2 * c + (e & 1);
        if (r < rows && col < cols) {
          if constexpr (std::is_same_v<T, float>) {
            out[r * ld + col] = acc[j][e];
          } else {
            out[r * ld + col] = __float2bfloat16_rn(acc[j][e]);
          }
        }
      }
    }
  }
}

// Loads `rows` x `cols` (stride src_ld) into a zero-padded kRows x kCols
// tile at dst, stride LD. FULL: 16-byte cp.async (rows and cols full); else
// plain loads and zeros.
template <bool FULL, int kRows, int kCols, int LD, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t src_ld, int rows, int cols) {
  if constexpr (FULL) {
    constexpr int kVec = 16 / sizeof(T), kPerRow = kCols / kVec;
    for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
      const int r = i / kPerRow, v = i - r * kPerRow;
      cp_async(dst + r * LD + v * kVec, src + r * src_ld + v * kVec, 16);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, col = i - r * kCols;
      dst[r * LD + col] = r < rows && col < cols ? src[r * src_ld + col] : T(0.0f);
    }
  }
}

template <typename T, bool FULL>
__global__ void __launch_bounds__(kThreads, 1)
ssd_intra_chunk_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ cum,
                           const float* __restrict__ Bm, const float* __restrict__ Cm,
                           const float* __restrict__ dy, const float* __restrict__ dS, T* __restrict__ dx,
                           float* __restrict__ ddt, float* __restrict__ dcum, float* __restrict__ dBw,
                           float* __restrict__ dCw, int64_t group_stride, int nc, int s_len, int h, int p,
                           int n, int q, int groups, int per) {
  constexpr bool kExactX = !std::is_same_v<T, float>;  // a bf16 x is exact in TF32
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;            // (q, n)
  float* sC = smem + kOffC;    // (q, n)
  float* sCB = smem + kOffCB;  // (q, q): C.B^T, the blocks at or below the diagonal
  float* sD = smem + kOffD;    // (q, q): L G dt_s summed over the block's heads, at the end
  float* sM = smem + kOffM;    // (q, q): M^T, [s][t] = CB L dt_s
  float* sDy = smem + kOffDy;  // (q, p)
  T* sX = reinterpret_cast<T*>(smem + kOffX);  // (q, p) at stride kXS
  const float* sXf = smem + kOffX;             // the same, read as f32 where x is f32
  float* sV = smem + kOffVec;
  float* sE = sV + kE;  // exp(cum_last - cum_s)
  float* sW = sV + kW;  // w_s
  float* sRowPart = sV + kRowPart;  // [column group][t]: sum over its 16 s of Q[t,s] dt_s
  float* sColPart = sV + kColPart;  // [warp of the pair][s]: sum over its t of Q[t,s]
  float* sRPart = sV + kRPart;      // [column group][s]: sum over its 16 columns of x_s dSB_s

  const int bc = blockIdx.x / groups, grp = blockIdx.x - bc * groups;
  const int h0 = grp * per;
  const int heads = h - h0 < per ? h - h0 : per;
  const int bi = bc / nc, ci = bc - bi * nc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int64_t row0 = static_cast<int64_t>(bi) * s_len + static_cast<int64_t>(ci) * q;
  const int64_t hp = static_cast<int64_t>(h) * p;
  // the (q, q) and (q, p) tiles: warp w takes m-tiles pi and 3 - pi (rows
  // of 16), columns 16 cg .. +16 (two n-tiles)
  const int pi = warp & 1, cg = warp >> 1;
  // the (q, n) tiles: rows 32 h2 .. +32 (m-tiles 2 h2, 2 h2 + 1), columns
  // n0 .. +32 (four n-tiles)
  const int h2 = warp & 1, n0 = 32 * (warp >> 1);

  // one head's dS, dt and cum into buffer buf; one head's x and dy
  auto load_ds = [&](int hi, int buf) {
    const float* from = dS + ((static_cast<int64_t>(bi) * nc + ci) * h + hi) * static_cast<int64_t>(p) * n;
    load_tile<FULL, kP, kN, kN + kPad>(smem + kOffDS + buf * kDSFloats, from, n, p, n);
    float* d = sV + kDtCum + buf * 2 * kQ;
    if (tid < 2 * kQ) {
      const int t = tid & (kQ - 1);
      const float* src = (tid < kQ ? dt : cum) + (row0 + t) * h + hi;
      if constexpr (FULL) {
        cp_async(d + tid, src, 4);
      } else {
        d[tid] = t < q ? *src : 0.0f;
      }
    }
  };
  auto load_xdy = [&](int hi) {
    load_tile<FULL, kQ, kP, kXS<T>>(sX, x + row0 * hp + hi * p, hp, q, p);
    load_tile<FULL, kQ, kP, kP + kPad>(sDy, dy + row0 * hp + hi * p, hp, q, p);
  };

  // B and C of this (batch row, chunk), shared by every head, and the first
  // head's inputs
  load_tile<FULL, kQ, kN, kN + kPad>(sB, Bm + row0 * n, n, q, n);
  load_tile<FULL, kQ, kN, kN + kPad>(sC, Cm + row0 * n, n, q, n);
  load_ds(h0, 0);
  load_xdy(h0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // C.B^T (K = n) on the blocks at or below the diagonal
  const int mts[2] = {pi, 3 - pi};
  const bool causal[2] = {cg <= pi, cg <= 3 - pi};  // the first implies the second
  if (causal[1]) {
    float acc[2][2][4] = {};
    from_tile(causal[0], [&](auto first) {
      constexpr int kFirst = decltype(first)::value;
#pragma unroll
      for (int k0 = 0; k0 < kN; k0 += 8) {
        uint32_t ah[2][4], al[2][4], bh[2][2], bl[2][2];
#pragma unroll
        for (int i = kFirst; i < 2; ++i) load_a<kN>(sC, 16 * mts[i], k0, ah[i], al[i]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) load_b_t<kN>(sB, k0, 16 * cg + 8 * nt, bh[nt], bl[nt]);
        mma3<2, 2, false, false, kFirst>(acc, ah, al, bh, bl);
      }
    });
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!causal[i]) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int s0 = 16 * cg + 8 * nt + 2 * c;
        store2(sCB, at<kQ>(16 * mts[i] + g, s0), acc[i][nt][0], acc[i][nt][1]);
        store2(sCB, at<kQ>(16 * mts[i] + g + 8, s0), acc[i][nt][2], acc[i][nt][3]);
      }
    }
  }

  // dSB = B.dS^T (K = n) of the head whose dS is in buffer buf: rows s of
  // m-tiles pi, 3 - pi, columns 16 cg of p
  auto dsb = [&](int buf, float (&sb)[2][2][4]) {
    const float* sDS = smem + kOffDS + buf * kDSFloats;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sb[i][nt][e] = 0.0f;
      }
    }
#pragma unroll
    for (int k0 = 0; k0 < kN; k0 += 8) {
      uint32_t ah[2][4], al[2][4], bh[2][2], bl[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) load_a<kN>(sB, 16 * mts[i], k0, ah[i], al[i]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) load_b_t<kN>(sDS, k0, 16 * cg + 8 * nt, bh[nt], bl[nt]);
      mma3<2, 2, false, false>(sb, ah, al, bh, bl);
    }
  };
  float sb[2][2][4];  // the current head's dSB, formed at the end of the head before it
  dsb(0, sb);

  // dB's w_s (x.dS)_s summed over the heads: rows 32 h2 .. +32, columns n0
  // .. +32. D enters dB and dC only through its sum over the heads (D^T.C
  // and D.B are linear in D, C and B the same for every head), so the block
  // sums D on its blocks in registers and forms the two products once.
  float accB[2][4][4] = {};
  float dsum[2][2][2][2] = {};  // [pair][n-tile][half][e], as G's accumulators
  for (int j = 0; j < heads; ++j) {
    const int hi = h0 + j, buf = j & 1;
    cp_wait<0>();
    // this head's x, dy, dS, dt and cum are in; C.B^T is in; the previous
    // head is done with M, the sums, E and w
    __syncthreads();
    if (j + 1 < heads) {
      load_ds(hi + 1, buf ^ 1);
      cp_commit();
    }
    const float* sDS = smem + kOffDS + buf * kDSFloats;  // (p, n)
    const float* sdt = sV + kDtCum + buf * 2 * kQ;
    const float* scum = sdt + kQ;
    if (tid < kQ) {
      const float e = tid < q ? expf(scum[q - 1] - scum[tid]) : 0.0f;
      sE[tid] = e;
      sW[tid] = e * sdt[tid];
    }

    // G = dy.x^T (K = p) on the blocks at or below the diagonal; from it Q,
    // D and M, the mask taken before the exp, and the partial sums of Q
    {
      float colv[2][2] = {};  // this lane's columns 16 cg + 8 nt + 2 c + e: Q summed over its rows
      float acc[2][2][4] = {};
      if (causal[1]) {
        from_tile(causal[0], [&](auto first) {
          constexpr int kFirst = decltype(first)::value;
#pragma unroll
          for (int k0 = 0; k0 < kP; k0 += 8) {
            uint32_t ah[2][4], al[2][4], bh[2][2], bl[2][2];
#pragma unroll
            for (int i = kFirst; i < 2; ++i) {
              if constexpr (kExactX) {
                load_a_pairs<kP>(sDy, 16 * mts[i], k0, ah[i], al[i]);
              } else {
                load_a<kP>(sDy, 16 * mts[i], k0, ah[i], al[i]);
              }
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              if constexpr (kExactX) {
                load_b_x_pairs(sX, k0, 16 * cg + 8 * nt, bh[nt]);
              } else {
                load_b_t<kP>(sXf, k0, 16 * cg + 8 * nt, bh[nt], bl[nt]);
              }
            }
            mma3<2, 2, false, kExactX, kFirst>(acc, ah, al, bh, bl);
          }
        });
      }
      // this lane's columns' cum and dt, read once (the stores below may
      // alias them for all the compiler knows)
      float cum_s[2][2], dt_s[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          cum_s[nt][e] = scum[16 * cg + 8 * nt + 2 * c + e];
          dt_s[nt][e] = sdt[16 * cg + 8 * nt + 2 * c + e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mt = mts[i];
        float rowv[2] = {};  // rows 16 mt + g, + 8: Q dt_s summed over this lane's columns
        if (causal[i]) {
          float cum_t[2], cb[2][2][2], mv[2][2][2];  // [n-tile][half][e]
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            cum_t[half] = scum[16 * mt + g + 8 * half];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const float2 v = *reinterpret_cast<const float2*>(sCB + at<kQ>(16 * mt + g + 8 * half,
                                                                               16 * cg + 8 * nt + 2 * c));
              cb[nt][half][0] = v.x;
              cb[nt][half][1] = v.y;
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int t = 16 * mt + g + 8 * half;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int s = 16 * cg + 8 * nt + 2 * c + e;
                // the mask selects before the exp: exp(-inf) = 0, and no lane branches
                const float L = expf(s <= t && t < q ? cum_t[half] - cum_s[nt][e] : __int_as_float(0xff800000u));
                const float lg = L * acc[i][nt][2 * half + e], cbv = cb[nt][half][e], d = dt_s[nt][e];
                const float qv = cbv * lg;
                dsum[i][nt][half][e] += lg * d;
                mv[nt][half][e] = cbv * L * d;
                rowv[half] = fmaf(qv, d, rowv[half]);
                colv[nt][e] += qv;
              }
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int t = 16 * mt + g + 8 * half, s0 = 16 * cg + 8 * nt + 2 * c;
              sM[at<kQ>(s0, t)] = mv[nt][half][0];  // M^T: rows s0, s0 + 1 fall in distinct banks
              sM[at<kQ>(s0 + 1, t)] = mv[nt][half][1];
            }
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          rowv[half] += __shfl_xor_sync(0xffffffffu, rowv[half], 1);
          rowv[half] += __shfl_xor_sync(0xffffffffu, rowv[half], 2);
        }
        if (c == 0) {
          sRowPart[cg * kQ + 16 * mt + g] = rowv[0];
          sRowPart[cg * kQ + 16 * mt + g + 8] = rowv[1];
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = colv[nt][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) sColPart[pi * kQ + 16 * cg + 8 * nt + 2 * c + e] = v;
        }
      }
    }

    // x.dS (K = p), for dB_s's w_s (x.dS)_s: rows 32 h2, columns n0
    float acc[2][4][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < kP; k0 += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if constexpr (kExactX) {
          load_a_x_pairs(sX, 32 * h2 + 16 * m, k0, ah[m]);
        } else {
          load_a<kP>(sXf, 32 * h2 + 16 * m, k0, ah[m], al[m]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if constexpr (kExactX) {
          load_b_pairs<kN>(sDS, k0, n0 + 8 * nt, bh[nt], bl[nt]);
        } else {
          load_b<kN>(sDS, k0, n0 + 8 * nt, bh[nt], bl[nt]);
        }
      }
      mma3<2, 4, kExactX, false>(acc, ah, al, bh, bl);
    }
    __syncthreads();  // M, the partial sums of Q, E and w are in

    // M^T.dy (K = q, m-tile i from k-step t = 16 i), then dx = M^T.dy + w dSB
    // and the partial sums of R
    {
      float xa[2][2][4] = {};
      auto xa_steps = [&](auto last, int from, int to) {
        constexpr int kLast = decltype(last)::value;
        for (int k0 = from; k0 < to; k0 += 8) {
          uint32_t ah[2][4], al[2][4], bh[2][2], bl[2][2];
#pragma unroll
          for (int i = 0; i < kLast; ++i) load_a<kQ>(sM, 16 * mts[i], k0, ah[i], al[i]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) load_b<kP>(sDy, k0, 16 * cg + 8 * nt, bh[nt], bl[nt]);
          mma3<2, 2, false, false, 0, kLast>(xa, ah, al, bh, bl);
        }
      };
      xa_steps(std::integral_constant<int, 1>(), 16 * mts[0], 16 * mts[1]);
      xa_steps(std::integral_constant<int, 2>(), 16 * mts[1], kQ);
      T* dxh = dx + row0 * hp + hi * p;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mt = mts[i];
        float r[2] = {};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = 16 * mt + g + 8 * (e >> 1), col = 16 * cg + 8 * nt + 2 * c + (e & 1);
            const float v = sb[i][nt][e];
            r[e >> 1] = fmaf(x_at(sX, s, col), v, r[e >> 1]);
            xa[i][nt][e] = fmaf(sW[s], v, xa[i][nt][e]);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          r[half] += __shfl_xor_sync(0xffffffffu, r[half], 1);
          r[half] += __shfl_xor_sync(0xffffffffu, r[half], 2);
          if (c == 0) sRPart[cg * kQ + 16 * mt + g + 8 * half] = r[half];
        }
        store_tile<FULL, 2>(dxh, hp, 16 * mt, 16 * cg, xa[i], q, p);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float w = sW[32 * h2 + 16 * m + g + 8 * (e >> 1)];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) accB[m][nt][e] = fmaf(w, acc[m][nt][e], accB[m][nt][e]);
      }
    }
    if (j + 1 < heads) cp_wait<0>();  // the next head's dS, dt and cum
    // every warp is done with x and dy; R's partial sums and the next head's
    // dS, dt and cum are in
    __syncthreads();
    if (j + 1 < heads) {
      load_xdy(hi + 1);
      cp_commit();
    }

    // ddt and dcum, warps 0 and 1 a step each lane: the partial sums added
    // in order; the last step's sum_s w_s R_s by a butterfly over all 64
    // steps, which both warps form alike
    if (warp < 2) {
      float wr[2], R = 0.0f, colq = 0.0f, dc = 0.0f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = lane + 32 * k;
        const float r = ((sRPart[t] + sRPart[kQ + t]) + sRPart[2 * kQ + t]) + sRPart[3 * kQ + t];
        wr[k] = sW[t] * r;
        if (k == warp) {
          R = r;
          colq = sColPart[t] + sColPart[kQ + t];
          const float rowp = ((sRowPart[t] + sRowPart[kQ + t]) + sRowPart[2 * kQ + t]) + sRowPart[3 * kQ + t];
          dc = rowp - sdt[t] * colq - wr[k];
        }
      }
      float total = wr[0] + wr[1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
      const int t = lane + 32 * warp;
      if (t < q) {
        ddt[(row0 + t) * h + hi] = fmaf(sE[t], R, colq);
        dcum[(row0 + t) * h + hi] = t == q - 1 ? dc + total : dc;
      }
    }
    // the next head's dSB, while its x and dy load
    if (j + 1 < heads) dsb(buf ^ 1, sb);
  }

  // D summed over the heads, then dB_s += sum_t Dsum[t,s] C_t (m-tile i from
  // k-step t = 16 i) and dC_t = sum_s Dsum[t,s] B_s (m-tile i to k-step s =
  // 16 i + 15)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!causal[i]) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        store2(sD, at<kQ>(16 * mts[i] + g + 8 * half, 16 * cg + 8 * nt + 2 * c), dsum[i][nt][half][0],
               dsum[i][nt][half][1]);
      }
    }
  }
  __syncthreads();
  float acc[2][4][4] = {};
  for (int k0 = 32 * h2; k0 < kQ; k0 += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
    const bool second = k0 >= 32 * h2 + 16;  // m-tile 2 h2 + 1 from here
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m == 0 || second) load_a_t<kQ>(sD, 32 * h2 + 16 * m, k0, ah[m], al[m]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) load_b<kN>(sC, k0, n0 + 8 * nt, bh[nt], bl[nt]);
    if (second) {
      mma3<2, 4, false, false>(acc, ah, al, bh, bl);
    } else {
      mma3<2, 4, false, false, 0, 1>(acc, ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accB[m][nt][e] += acc[m][nt][e];
        acc[m][nt][e] = 0.0f;
      }
    }
  }
  for (int k0 = 0; k0 < 32 * h2 + 32; k0 += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
    const bool first = k0 < 32 * h2 + 16;  // m-tile 2 h2 up to here
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m == 1 || first) load_a<kQ>(sD, 32 * h2 + 16 * m, k0, ah[m], al[m]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) load_b<kN>(sB, k0, n0 + 8 * nt, bh[nt], bl[nt]);
    if (first) {
      mma3<2, 4, false, false>(acc, ah, al, bh, bl);
    } else {
      mma3<2, 4, false, false, 1>(acc, ah, al, bh, bl);
    }
  }
  // this head group's dB and dC (or the result, with one group)
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    store_tile<FULL, 4>(dBw + grp * group_stride + row0 * n, n, 32 * h2 + 16 * m, n0, accB[m], q, n);
    store_tile<FULL, 4>(dCw + grp * group_stride + row0 * n, n, 32 * h2 + 16 * m, n0, acc[m], q, n);
  }
}

// out[e] = sum over the groups of part[g][e], g in order; blockIdx.y picks
// dB (0) or dC (1). V = 4: 16-byte loads and stores (count a multiple of 4)
template <int V>
__global__ void sum_groups_kernel(const float* __restrict__ partB, const float* __restrict__ partC,
                                  float* __restrict__ dB, float* __restrict__ dC, int groups, int64_t count) {
  using Vec = std::conditional_t<V == 4, float4, float>;
  const Vec* part = reinterpret_cast<const Vec*>(blockIdx.y == 0 ? partB : partC);
  Vec* out = reinterpret_cast<Vec*>(blockIdx.y == 0 ? dB : dC);
  const int64_t vcount = count / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < vcount; e += stride) {
    Vec acc = part[e];
    for (int g = 1; g < groups; ++g) {
      const Vec v = part[g * vcount + e];
      if constexpr (V == 4) {
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      } else {
        acc += v;
      }
    }
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

// heads a block takes, for (batch rows x chunks) = bcs: as many head groups
// as one wave of one block an SM holds, where the heads allow (fewer groups
// also mean a smaller scratch for dB and dC and a shorter second pass)
int heads_per_block(int64_t bcs, int h) {
  const int sms = sm_count();
  if (sms == 0) return 0;
  int64_t groups = sms / bcs;
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

template <typename T, bool FULL>
int launch(const T* x, const float* dt, const float* cum, const float* Bm, const float* Cm, const float* dy,
           const float* dS, T* dx, float* ddt, float* dcum, float* dB, float* dC, float* part, int b, int s_len,
           int h, int p, int n, int q, cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = allow_smem<ssd_intra_chunk_bwd_kernel<T, FULL>>(smem);
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
  ssd_intra_chunk_bwd_kernel<T, FULL><<<static_cast<unsigned>(bcs * groups), kThreads, smem, stream>>>(
      x, dt, cum, Bm, Cm, dy, dS, dx, ddt, dcum, dBw, dCw, groups > 1 ? count : 0, nc, s_len, h, p, n, q,
      groups, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return static_cast<int>(err);
  const bool vec = FULL && count % 4 == 0;
  int64_t blocks = (count / (vec ? 4 : 1) + 255) / 256;
  blocks = blocks > 4 * 132 ? 4 * 132 : blocks;
  const dim3 grid(static_cast<unsigned>(blocks), 2);
  if (vec) {
    sum_groups_kernel<4><<<grid, 256, 0, stream>>>(part, part + groups * count, dB, dC, groups, count);
  } else {
    sum_groups_kernel<1><<<grid, 256, 0, stream>>>(part, part + groups * count, dB, dC, groups, count);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const void* x, const float* dt, const float* cum, const float* Bm, const float* Cm, const float* dy,
               const float* dS, void* dx, float* ddt, float* dcum, float* dB, float* dC, float* part, int b,
               int s_len, int h, int p, int n, int q, cudaStream_t st) {
  const void* arrays[] = {x, dt, cum, Bm, Cm, dy, dS, dx, ddt, dcum, dB, dC, part};
  bool aligned = true;
  for (const void* a : arrays) aligned &= reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const auto* xt = static_cast<const T*>(x);
  auto* dxt = static_cast<T*>(dx);
  if (aligned && q == kQ && p == kP && n == kN) {
    return launch<T, true>(xt, dt, cum, Bm, Cm, dy, dS, dxt, ddt, dcum, dB, dC, part, b, s_len, h, p, n, q, st);
  }
  return launch<T, false>(xt, dt, cum, Bm, Cm, dy, dS, dxt, ddt, dcum, dB, dC, part, b, s_len, h, p, n, q, st);
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
    return launch_any<float>(x, f(dt), f(cum), f(Bm), f(Cm), f(dy), f(dS), dx, m(ddt), m(dcum), m(dB), m(dC),
                             m(part), b, s_len, h, p, n, chunk, st);
  }
  if (x_dtype == 1) {
    return launch_any<__nv_bfloat16>(x, f(dt), f(cum), f(Bm), f(Cm), f(dy), f(dS), dx, m(ddt), m(dcum), m(dB),
                                     m(dC), m(part), b, s_len, h, p, n, chunk, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
