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
// bf16; every product accumulates in f32.
//
// What bounds it on the H100: at the serving shape (b 8, s 512, h 80,
// p 64, n 128, chunk 64) the function moves ~300 MB (S alone is 168 MB of
// f32, y 84 MB), 0.09 ms at 3.35 TB/s; its useful work is ~6.8 GFLOP of f32
// products, 0.10 ms on the CUDA cores' 67 TFLOP/s, so on the CUDA cores the
// products bound it. Here they run on the tensor cores, and the bytes bound
// it. The design:
//   - the three products (C.B^T, y = M.x with M = C.B^T o L o dt^T, and
//     S = x^T.(w o B) with w = exp(cum_last - cum) * dt) are mma.sync
//     m16n8k8 TF32 with f32 accumulators, at f32 accuracy by the 3xTF32
//     split: an f32 operand a is hi(a) = rna.tf32(a) plus lo(a) =
//     tf32(a - hi(a)), and a.b = hi(a).hi(b) + hi(a).lo(b) + lo(a).hi(b)
//     (lo.lo, ~2^-21 relative, is dropped; split() says how). One TF32 pass keeps ~3 decimal
//     digits, which the tolerances (2e-5 relative) do not allow. Which
//     operand is split: C, B and M always (f32 values); w o B always (w
//     depends on the head, so it is formed and split per fragment); x only
//     when it is f32. A bf16 x (8 significant bits) is exact in TF32 (11),
//     so M.x and x^T.(w o B) take two products, not three;
//   - one block per (batch row, chunk) and group of heads: it loads B and C
//     once, forms C.B^T once, and walks its heads; the host picks the group
//     size so that the grid is one wave of two blocks an SM (105 KB of
//     shared memory each) where the shape allows, and each block
//     double-buffers the next head's x, dt and cum by 16-byte cp.async while
//     the current head computes;
//   - L = exp(cum_t - cum_s) grows without bound for s > t (cum decreases
//     along the chunk), so the causal mask selects before the exp: a masked
//     entry of M is 0.0f, never inf * 0 = NaN. M is formed once a head in
//     shared memory; y's warps take m-tiles in pairs (0, 3) and (1, 2), so
//     that each skips the same number of k-steps above the diagonal;
//   - stores: each warp regroups its accumulators within a quad by shuffles
//     so that a lane holds four contiguous columns and writes them as one
//     16-byte store; a warp writes each row of its tile whole (64 bytes of
//     y, 128 bytes of S: one whole line in two stores), every 32-byte
//     sector in one store;
//   - shared-memory row strides are 4 or 8 words past a multiple of 32, so
//     that every fragment load of a warp falls in distinct banks;
//   - the full shape (chunk 64, head dim 64, state 128, 16-byte aligned
//     arrays) takes the asynchronous loads and vector stores; any smaller
//     chunk, head or state size up to kQ, kP, kN takes the same products
//     over zero-padded tiles, with plain loads and element stores. A
//     sequence that is not a multiple of the chunk is refused by the
//     wrapper (repro_torch/kernels/ssd_scan.py): ops.ssd_scan pads it with
//     dt = 0 first, as the JAX package does, so no read leaves the arrays.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kQ = 64;   // largest chunk
constexpr int kP = 64;   // largest head dim
constexpr int kN = 128;  // largest state size
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 2;
// row strides (in 4-byte words, or bf16 elements for a bf16 x) of the
// shared tiles: B (q, n) and x (q, p) are read as [k][col] fragments (stride
// = 8 mod 32), C and M as [row][k] fragments (stride = 4 mod 32)
constexpr int kBS = kN + 8;
constexpr int kCS = kN + 4;
constexpr int kMS = kQ + 4;
constexpr int kXS = kP + 8;
// shared memory, in floats: B, C.B^T, then two x buffers and M; C (only
// while C.B^T is formed) overlays the second x buffer and M; then dt and cum
// of two heads, and w
constexpr int kXFloats = kQ * kXS;
constexpr int kOffCB = kQ * kBS;
constexpr int kOffX = kOffCB + kQ * kMS;
constexpr int kOffM = kOffX + 2 * kXFloats;
constexpr int kOffC = kOffX + kXFloats;
constexpr int kOffDt = kOffM + kQ * kMS;
constexpr int kOffW = kOffDt + 4 * kQ;
constexpr int kSmemFloats = kOffW + kQ;
static_assert(kOffC + kQ * kCS <= kOffDt, "C must fit over the second x buffer and M");
static_assert(kSmemFloats * 4 * kBlocksPerSM + kBlocksPerSM * 1024 <= 228 * 1024, "two blocks an SM");
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

// d += a.b at f32 accuracy: 3xTF32, the small terms first; with EXACT_B
// (b exact in TF32, its lo zero) two products
template <bool EXACT_B>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  if constexpr (!EXACT_B) mma(d, ah, bl);
  mma(d, ah, bh);
}

// the A operand (16 x 8, row-major) of an f32 tile at (row0, k0), stride ld,
// split; lane (g, c): rows g, g + 8, columns c, c + 4
__device__ __forceinline__ void load_a(const float* t, int ld, int row0, int k0, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  split(t[(row0 + g) * ld + k0 + c], hi[0], lo[0]);
  split(t[(row0 + g + 8) * ld + k0 + c], hi[1], lo[1]);
  split(t[(row0 + g) * ld + k0 + c + 4], hi[2], lo[2]);
  split(t[(row0 + g + 8) * ld + k0 + c + 4], hi[3], lo[3]);
}

// the B operand (8 x 8) read from a tile stored [col][k] (B^T row-major:
// C.B^T's B), split; lane (g, c): k = c, c + 4, column g
__device__ __forceinline__ void load_b_t(const float* t, int ld, int k0, int col0, uint32_t (&hi)[2],
                                         uint32_t (&lo)[2]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  split(t[(col0 + g) * ld + k0 + c], hi[0], lo[0]);
  split(t[(col0 + g) * ld + k0 + c + 4], hi[1], lo[1]);
}

// x's element (k, col) of a tile stored [k][col] at stride kXS, as f32
template <typename T>
__device__ __forceinline__ float x_at(const T* x, int k, int col) {
  return to_f(x[k * kXS + col]);
}

template <typename T>
__device__ __forceinline__ void split_x(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same_v<T, float>) {
    split(v, hi, lo);
  } else {
    hi = __float_as_uint(v);  // a bf16 is exact in TF32
    lo = 0u;
  }
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

// Stores a warp's accumulators acc[j] (n-tiles j of the 16 x 8J tile at
// (row0, col0)) to out[row * ld + col], rows below rows, columns below cols.
// FULL: 16-byte stores of four contiguous columns (quad_columns); else one
// element a store.
template <bool FULL, int J>
__device__ __forceinline__ void store_tile(float* out, int64_t ld, int row0, int col0, const float (&acc)[J][4],
                                           int rows, int cols) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  if constexpr (FULL) {
#pragma unroll
    for (int j = 0; j < J; j += 2) {
      const float4 top = quad_columns(acc[j][0], acc[j][1], acc[j + 1][0], acc[j + 1][1]);
      const float4 bot = quad_columns(acc[j][2], acc[j][3], acc[j + 1][2], acc[j + 1][3]);
      const int col = col0 + 8 * j + 4 * c;
      *reinterpret_cast<float4*>(out + (row0 + g) * ld + col) = top;
      *reinterpret_cast<float4*>(out + (row0 + g + 8) * ld + col) = bot;
    }
  } else {
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + g + 8 * (e >> 1), col = col0 + 8 * j + 2 * c + (e & 1);
        if (r < rows && col < cols) out[r * ld + col] = acc[j][e];
      }
    }
  }
}

// Loads `rows` x `cols` (stride src_ld) into a zero-padded kRows x kCols
// tile at dst (stride ld). FULL: 16-byte cp.async (rows and cols full, cols a
// multiple of the vector); else plain loads and zeros.
template <bool FULL, int kRows, int kCols, typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, int64_t src_ld, int rows, int cols) {
  if constexpr (FULL) {
    constexpr int kVec = 16 / sizeof(T), kPerRow = kCols / kVec;
    for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
      const int r = i / kPerRow, v = i - r * kPerRow;
      cp_async(dst + r * ld + v * kVec, src + r * src_ld + v * kVec, 16);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, col = i - r * kCols;
      dst[r * ld + col] = r < rows && col < cols ? src[r * src_ld + col] : T(0.0f);
    }
  }
}

template <typename T, bool FULL>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
ssd_intra_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ cum,
                       const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
                       float* __restrict__ S, int nc, int s_len, int h, int p, int n, int q, int groups,
                       int heads_per_block) {
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;            // (q, n) at stride kBS
  float* sCB = smem + kOffCB;  // (q, q) at stride kMS
  float* sC = smem + kOffC;    // (q, n) at stride kCS, until C.B^T is formed
  float* sM = smem + kOffM;    // (q, q) at stride kMS, one head's M
  float* sDt = smem + kOffDt;  // dt and cum of two heads: [buffer][dt | cum][kQ]
  float* sW = smem + kOffW;
  T* sX[2] = {reinterpret_cast<T*>(smem + kOffX), reinterpret_cast<T*>(smem + kOffX + kXFloats)};

  const int bc = blockIdx.x / groups;
  const int h0 = (blockIdx.x - bc * groups) * heads_per_block;
  const int heads = h - h0 < heads_per_block ? h - h0 : heads_per_block;
  const int bi = bc / nc, ci = bc - bi * nc;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(bi) * s_len + static_cast<int64_t>(ci) * q;

  // one head's x, dt and cum into buffer `buf`
  auto load_head = [&](int hi, int buf) {
    load_tile<FULL, kQ, kP>(sX[buf], kXS, x + (row0 * h + hi) * p, static_cast<int64_t>(h) * p, q, p);
    float* d = sDt + buf * 2 * kQ;
    if (tid < 2 * kQ) {
      const int t = tid & (kQ - 1);
      const float* from = (tid < kQ ? dt : cum) + (row0 + t) * h + hi;
      if constexpr (FULL) {
        cp_async(d + tid, from, 4);
      } else {
        d[tid] = t < q ? *from : 0.0f;
      }
    }
  };

  // B and C of this (batch row, chunk), shared by every head, and the
  // first head's x, dt and cum
  load_tile<FULL, kQ, kN>(sB, kBS, Bm + row0 * n, n, q, n);
  load_tile<FULL, kQ, kN>(sC, kCS, Cm + row0 * n, n, q, n);
  cp_commit();
  load_head(h0, 0);
  cp_commit();
  cp_wait<1>();
  __syncthreads();

  // C.B^T (q x q, K = n): warp w forms rows 16 (w & 3) .. +16, columns
  // 32 (w >> 2) .. +32 (four n-tiles)
  {
    const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
    float acc[4][4] = {};
    for (int k0 = 0; k0 < kN; k0 += 8) {
      uint32_t ah[4], al[4];
      load_a(sC, kCS, r0, k0, ah, al);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bh[2], bl[2];
        load_b_t(sB, kBS, k0, c0 + 8 * j, bh, bl);
        mma3<false>(acc[j], ah, al, bh, bl);
      }
    }
    const int g = (tid & 31) >> 2, c = tid & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float2*>(sCB + (r0 + g) * kMS + c0 + 8 * j + 2 * c) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(sCB + (r0 + g + 8) * kMS + c0 + 8 * j + 2 * c) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  // C is dead from here: its space holds the second x buffer and M

  const int g = (tid & 31) >> 2, c = tid & 3;
  for (int j = 0; j < heads; ++j) {
    const int hi = h0 + j, buf = j & 1;
    __syncthreads();  // the previous head is done with M, w and the buffer loaded next
    if (j + 1 < heads) {
      load_head(hi + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this head's x, dt and cum are in
    const T* sx = sX[buf];
    const float* sdt = sDt + buf * 2 * kQ;
    const float* scum = sdt + kQ;
    // w, and M[t][s] = C.B^T[t][s] * L[t][s] * dt[s], the mask taken before the exp
    if (tid < kQ) sW[tid] = tid < q ? expf(scum[q - 1] - scum[tid]) * sdt[tid] : 0.0f;
    for (int i = tid; i < kQ * kQ; i += kThreads) {
      const int t = i >> 6, s = i & (kQ - 1);
      sM[t * kMS + s] = s <= t && t < q ? sCB[t * kMS + s] * expf(scum[t] - scum[s]) * sdt[s] : 0.0f;
    }
    __syncthreads();

    // y = M.x (q x p, K = q): warp w takes m-tiles (w & 1) and 3 - (w & 1),
    // columns 16 (w >> 1) .. +16, and only the k-steps at or below the
    // diagonal (2 mt + 2 of them)
    {
      const int col0 = 16 * (warp >> 1);
      float* yh = y + (row0 * h + hi) * p;
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        const int mt = pair == 0 ? (warp & 1) : 3 - (warp & 1);
        float acc[2][4] = {};
        for (int k0 = 0; k0 < 16 * mt + 16; k0 += 8) {
          uint32_t ah[4], al[4];
          load_a(sM, kMS, 16 * mt, k0, ah, al);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t bh[2], bl[2];
            split_x<T>(x_at(sx, k0 + c, col0 + 8 * jj + g), bh[0], bl[0]);
            split_x<T>(x_at(sx, k0 + c + 4, col0 + 8 * jj + g), bh[1], bl[1]);
            mma3<!std::is_same_v<T, float>>(acc[jj], ah, al, bh, bl);
          }
        }
        store_tile<FULL, 2>(yh, static_cast<int64_t>(h) * p, 16 * mt, col0, acc, q, p);
      }
    }

    // S = x^T.(w o B) (p x n, K = q): warp w takes rows 32 (w & 1) .. +32 (two
    // m-tiles) and columns 32 (w >> 1) .. +32 (four n-tiles); A = x^T (split
    // only for an f32 x), B = w o B formed and split per fragment
    {
      const int p0 = 32 * (warp & 1), n0 = 32 * (warp >> 1);
      float acc[2][4][4] = {};
      for (int k0 = 0; k0 < kQ; k0 += 8) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int pr = p0 + 16 * m + g;
          split_x<T>(x_at(sx, k0 + c, pr), ah[m][0], al[m][0]);
          split_x<T>(x_at(sx, k0 + c, pr + 8), ah[m][1], al[m][1]);
          split_x<T>(x_at(sx, k0 + c + 4, pr), ah[m][2], al[m][2]);
          split_x<T>(x_at(sx, k0 + c + 4, pr + 8), ah[m][3], al[m][3]);
        }
        const float w0 = sW[k0 + c], w1 = sW[k0 + c + 4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bh[2], bl[2];
          const int col = n0 + 8 * jj + g;
          split(w0 * sB[(k0 + c) * kBS + col], bh[0], bl[0]);
          split(w1 * sB[(k0 + c + 4) * kBS + col], bh[1], bl[1]);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            // A = x^T: exact for a bf16 x, so its lo products vanish
            if constexpr (std::is_same_v<T, float>) {
              mma(acc[m][jj], al[m], bh);
            }
            mma(acc[m][jj], ah[m], bl);
            mma(acc[m][jj], ah[m], bh);
          }
        }
      }
      float* Sh = S + ((static_cast<int64_t>(bi) * nc + ci) * h + hi) * static_cast<int64_t>(p) * n;
#pragma unroll
      for (int m = 0; m < 2; ++m) store_tile<FULL, 4>(Sh, n, p0 + 16 * m, n0, acc[m], p, n);
    }
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

template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

template <typename T, bool FULL>
int launch(const T* x, const float* dt, const float* cum, const float* Bm, const float* Cm, float* y, float* S,
           int b, int s_len, int h, int p, int n, int q, cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = allow_smem<ssd_intra_chunk_kernel<T, FULL>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  // head groups per (batch row, chunk): one wave of kBlocksPerSM blocks an
  // SM where the shape allows, each group as many heads as that leaves
  const int nc = s_len / q;
  const int64_t bcs = static_cast<int64_t>(b) * nc;
  int64_t groups = kBlocksPerSM * static_cast<int64_t>(sms) / bcs;
  groups = groups < 1 ? 1 : groups > h ? h : groups;
  const int per = static_cast<int>((h + groups - 1) / groups);
  groups = (h + per - 1) / per;
  if (bcs * groups >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  ssd_intra_chunk_kernel<T, FULL><<<static_cast<unsigned>(bcs * groups), kThreads, smem, stream>>>(
      x, dt, cum, Bm, Cm, y, S, nc, s_len, h, p, n, q, static_cast<int>(groups), per);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const void* x, const void* dt, const void* cum, const void* Bm, const void* Cm, void* y, void* S,
               int b, int s_len, int h, int p, int n, int q, cudaStream_t st) {
  const void* arrays[] = {x, dt, cum, Bm, Cm, y, S};
  bool aligned = true;
  for (const void* a : arrays) aligned &= reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const auto* xt = static_cast<const T*>(x);
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  if (aligned && q == kQ && p == kP && n == kN) {
    return launch<T, true>(xt, f(dt), f(cum), f(Bm), f(Cm), static_cast<float*>(y), static_cast<float*>(S), b,
                           s_len, h, p, n, q, st);
  }
  return launch<T, false>(xt, f(dt), f(cum), f(Bm), f(Cm), static_cast<float*>(y), static_cast<float*>(S), b,
                          s_len, h, p, n, q, st);
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
  if (x_dtype == 0) return launch_any<float>(x, dt, cum, Bm, Cm, y, S, b, s_len, h, p, n, chunk, st);
  if (x_dtype == 1) return launch_any<__nv_bfloat16>(x, dt, cum, Bm, Cm, y, S, b, s_len, h, p, n, chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
