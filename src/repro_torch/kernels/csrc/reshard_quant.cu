// The compressed wire of the reshard data plane for Hopper (sm_90a):
// pack_quant_rows and dequant_scatter_rows.
//
// Replaces: src/repro/kernels/reshard_quant.py, the two TPU Pallas kernels
// pack_quant_rows_pallas (_make_quant_kernel) and dequant_scatter_rows_pallas
// (_make_dequant_scatter_kernel). Each computes what its JAX reference
// computes (src/repro/kernels/ref.py: pack_quant_rows_ref,
// dequant_scatter_rows_ref) bit for bit, on a row-major (rows, C) array, for
// any start:
//   - pack_quant_rows: tile i is the block_rows rows at starts[i]; its scale
//     is max(absmax(tile), 1e-12) * (float)(1/qmax), the reciprocal made in
//     double and rounded once to float, as the reference folds it;
//     q = x / scale by IEEE division; int8 rounds half to even (rintf) and
//     clips to +-127, fp8-e4m3 converts round-to-nearest-even without
//     saturation (|x / scale| <= 448 by construction). The library is built
//     without --use_fast_math, so divisions are IEEE and denormals are kept.
//   - dequant_scatter_rows: dst rows <- (float(q) * scale of q's tile), cast
//     to dst's type (round to nearest even for bf16), overwritten in place.
//
// A TPU grid runs in order, so a repeated start resolves to the last tile;
// a CUDA grid does not. dequant_scatter_rows therefore takes one of two
// tables, both by value in the kernel's parameters (row_tables.cuh):
//   - disjoint tiles (the executor's case: distinct rows, block_rows 1):
//     int32 block starts, tile i to dst row start[i] with scales[i];
//   - repeated or overlapping tiles: segments (buf_row, dst_row, rows) that
//     the wrapper (repro_torch/kernels/reshard_quant.py) resolves to the
//     last writer of every destination row, so that each row is written
//     once; a segment may span several tiles, so the kernel walks it tile
//     piece by tile piece, each with its own tile's scale.
// repro_dequant_scatter_rows_list reads the executor's Python list of
// starts straight into the by-value starts and decides here, without a
// sort, whether the tiles are disjoint.
//
// What bounds them on the H100: HBM bandwidth. pack reads each source byte
// twice (once for the tile's absmax, once to quantize) and writes one byte
// per element; dequant_scatter reads one byte per element and writes the
// destination. pack: the absmax pass is split over many blocks per tile
// (each block reduces 4096 elements into a partial maximum), and the
// quantize pass re-reduces the tile's few partials in every block, so a
// stacked-layer row of 4M elements and thousands of 2048-element embedding
// rows both fill the card; no atomics, so the result is deterministic.
// Its loads are one element per thread; vector loads and a single pass
// that keeps a tile in shared memory are left for later. dequant_scatter:
// blockIdx.y walks the tiles (or segments) and the x blocks share each
// one's span; a thread's step is one 16-byte store (4 f32 or 8 bf16 values)
// and the 4 or 8 payload bytes behind it, so that both a warp's loads and
// its stores are contiguous, with kUnroll steps' loads in flight, where C
// is a multiple of the step and both arrays are 16-byte aligned, else one
// element a step; no division per element; x is fitted to the longest span,
// so one 12.58 M-element tile and 4096 tiles of 2048 both fill the SMs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <vector>

#include "row_tables.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
// the most blocks of a dequant_scatter grid: 64 of 256 threads per SM, so a
// thread of a long span makes a few steps
constexpr int64_t kMaxBlocks = 132 * 64;
// 16-byte payload loads a dequant_scatter thread keeps in flight
constexpr int kUnroll = 2;

constexpr int kInt8 = 0;
constexpr int kFp8 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// a payload byte's value: int8, or fp8-e4m3 (exact in half, exact in float)
template <int FMT>
__device__ __forceinline__ float payload_value(uint8_t bits) {
  if constexpr (FMT == kInt8) {
    return static_cast<float>(static_cast<int8_t>(bits));
  } else {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(bits, __NV_E4M3)));
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// max that propagates NaN, as the reference's jnp.max / jnp.maximum do
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < kThreads / 32 ? red[lane] : 0.f;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, off));
    if (lane == 0) red[0] = x;
  }
  __syncthreads();
  return red[0];
}

// block x's share [lo, hi) of a tile of n elements cut into `chunks` parts
__device__ __forceinline__ void chunk_range(int64_t n, int chunks, int64_t* lo, int64_t* hi) {
  const int64_t per = (n + chunks - 1) / chunks;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * per;
  *lo = start < n ? start : n;
  *hi = *lo + per < n ? *lo + per : n;
}

// pass 1: partial[i * chunks + x] = max |src| over block x's share of tile i
template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_absmax_kernel(const T* __restrict__ src, const int64_t* __restrict__ starts, int64_t nb,
                   int64_t tile_elems, int64_t C, int chunks, float* __restrict__ partial) {
  __shared__ float red[kThreads / 32];
  for (int64_t i = blockIdx.y; i < nb; i += gridDim.y) {
    const T* tile = src + starts[i] * C;
    int64_t lo, hi;
    chunk_range(tile_elems, chunks, &lo, &hi);
    float m = 0.f;
    for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) m = nan_max(m, fabsf(to_float(tile[e])));
    m = block_max(m, red);
    if (threadIdx.x == 0) partial[i * chunks + blockIdx.x] = m;
  }
}

// a payload byte: int8 rounds half to even and clips; fp8-e4m3 converts
// round-to-nearest-even, unsaturated
template <int FMT>
__device__ __forceinline__ uint8_t quantize(float y, float qmax) {
  if constexpr (FMT == kInt8) {
    return static_cast<uint8_t>(static_cast<int8_t>(fminf(fmaxf(rintf(y), -qmax), qmax)));
  } else {
    return static_cast<uint8_t>(__nv_cvt_float_to_fp8(y, __NV_NOSAT, __NV_E4M3));
  }
}

// pass 2: the tile's scale from its partials, then q = x / scale
template <typename T, int FMT>
__global__ void __launch_bounds__(kThreads)
tile_quant_kernel(const T* __restrict__ src, const int64_t* __restrict__ starts, int64_t nb,
                  int64_t tile_elems, int64_t C, int chunks, const float* __restrict__ partial,
                  float inv_qmax, float qmax, uint8_t* __restrict__ out, float* __restrict__ scales) {
  __shared__ float red[kThreads / 32];
  for (int64_t i = blockIdx.y; i < nb; i += gridDim.y) {
    float m = 0.f;
    for (int c = threadIdx.x; c < chunks; c += kThreads) m = nan_max(m, partial[i * chunks + c]);
    const float absmax = block_max(m, red);
    const float scale = nan_max(absmax, 1e-12f) * inv_qmax;
    if (blockIdx.x == 0 && threadIdx.x == 0) scales[i] = scale;
    const T* tile = src + starts[i] * C;
    uint8_t* qt = out + i * tile_elems;
    int64_t lo, hi;
    chunk_range(tile_elems, chunks, &lo, &hi);
    for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) {
      qt[e] = quantize<FMT>(__fdiv_rn(to_float(tile[e]), scale), qmax);
    }
  }
}

// A step of the 16-byte body: the payload bytes whose values fill one
// 16-byte store of D (4 for float, 8 for bfloat16).
template <typename D>
struct Step;
template <>
struct Step<float> {
  using Payload = uint32_t;
};
template <>
struct Step<__nv_bfloat16> {
  using Payload = uint2;
};

__device__ __forceinline__ uint32_t payload_word(uint32_t p, int) { return p; }
__device__ __forceinline__ uint32_t payload_word(const uint2& p, int i) { return i == 0 ? p.x : p.y; }

// Step u of a span: its payload p times scale, cast to D, stored as one
// 16-byte vector at to + u * (16 / sizeof(D)).
template <typename D, int FMT>
__device__ __forceinline__ void dequant_step(D* __restrict__ to, int64_t u, const typename Step<D>::Payload& p,
                                             float scale) {
  constexpr int kN = 16 / sizeof(D);
  alignas(16) D o[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const uint8_t bits = static_cast<uint8_t>(payload_word(p, k >> 2) >> (8 * (k & 3)));
    o[k] = from_float<D>(__fmul_rn(payload_value<FMT>(bits), scale));
  }
  reinterpret_cast<uint4*>(to)[u] = *reinterpret_cast<const uint4*>(o);
}

// This block's share of a span of n elements: to[e] = q[e] * scale, cast to
// D. VEC: a thread's step is one 16-byte store of D and the 4 or 8 payload
// bytes behind it, so that a warp's loads and stores are both contiguous,
// with kUnroll steps' loads issued before their stores (to, from and n all
// multiples of a step); else one element a step.
template <typename D, int FMT, bool VEC>
__device__ __forceinline__ void dequant_span(D* __restrict__ to, const uint8_t* __restrict__ from, int64_t n,
                                             float scale) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (VEC) {
    using Payload = typename Step<D>::Payload;
    const Payload* q = reinterpret_cast<const Payload*>(from);
    const int64_t steps = n / (16 / sizeof(D));
    for (; u + (kUnroll - 1) * stride < steps; u += kUnroll * stride) {
      Payload p[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) p[k] = q[u + k * stride];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) dequant_step<D, FMT>(to, u + k * stride, p[k], scale);
    }
    for (; u < steps; u += stride) dequant_step<D, FMT>(to, u, q[u], scale);
  } else {
    for (; u < n; u += stride) to[u] = from_float<D>(__fmul_rn(payload_value<FMT>(from[u]), scale));
  }
}

// Disjoint tiles: tile i, buffer rows [i*block_rows, (i+1)*block_rows), to
// dst rows from start[i], scaled by scales[i]; a tile is contiguous in both.
template <typename D, int FMT, bool VEC, int CAP>
__device__ __forceinline__ void dequant_entries(D* dst, const uint8_t* buf, const float* scales, int64_t C,
                                                int64_t block_rows, const RowStarts<CAP>& t) {
  const int64_t tile = block_rows * C;
  for (int64_t i = blockIdx.y; i < t.n; i += gridDim.y) {
    dequant_span<D, FMT, VEC>(dst + static_cast<int64_t>(t.start[i]) * C, buf + i * tile, tile, scales[i]);
  }
}

// Segments (buf_row, dst_row, rows), each row written once: a segment goes
// piece by piece, a piece being its rows within one tile, with that tile's
// scale.
template <typename D, int FMT, bool VEC, int CAP>
__device__ __forceinline__ void dequant_entries(D* dst, const uint8_t* buf, const float* scales, int64_t C,
                                                int64_t block_rows, const RowTable<CAP>& t) {
  for (int64_t i = blockIdx.y; i < t.n; i += gridDim.y) {
    int64_t from = t.seg[3 * i], to = t.seg[3 * i + 1], left = t.seg[3 * i + 2];
    int64_t tile = from / block_rows;
    int64_t rows = (tile + 1) * block_rows - from;  // the first piece's rows
    while (left > 0) {
      if (rows > left) rows = left;
      dequant_span<D, FMT, VEC>(dst + to * C, buf + from * C, rows * C, scales[tile]);
      from += rows;
      to += rows;
      left -= rows;
      ++tile;
      rows = block_rows;
    }
  }
}

// dst rows <- the buffer's rows times their tile's scale, as the table says
template <typename D, int FMT, bool VEC, typename Table>
__global__ void __launch_bounds__(kThreads)
dequant_scatter_kernel(D* __restrict__ dst, const uint8_t* __restrict__ buf, const float* __restrict__ scales,
                       int64_t C, int64_t block_rows, const __grid_constant__ Table t) {
  dequant_entries<D, FMT, VEC>(dst, buf, scales, C, block_rows, t);
}

// The parameters: three pointers, C, block_rows and the table.
static_assert(3 * sizeof(void*) + 2 * sizeof(int64_t) + sizeof(RowStarts<kParamStarts>) <= kParamBytes,
              "the by-value starts exceed the 32,764 bytes of kernel parameters");
static_assert(3 * sizeof(void*) + 2 * sizeof(int64_t) + sizeof(RowTable<kParamSegs>) <= kParamBytes,
              "the by-value segments exceed the 32,764 bytes of kernel parameters");

template <typename T, int FMT>
cudaError_t launch_pack(const void* src, void* out, float* scales, float* partial,
                        const int64_t* starts, int64_t nb, int64_t block_rows, int64_t C,
                        int chunks, float qmax, cudaStream_t stream) {
  const int64_t tile_elems = block_rows * C;
  const dim3 grid(chunks, static_cast<unsigned>(nb < kMaxGridY ? nb : kMaxGridY));
  tile_absmax_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(src), starts, nb,
                                                       tile_elems, C, chunks, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float inv_qmax = static_cast<float>(1.0 / static_cast<double>(qmax));
  tile_quant_kernel<T, FMT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), starts, nb, tile_elems, C, chunks, partial, inv_qmax, qmax,
      static_cast<uint8_t*>(out), scales);
  return cudaGetLastError();
}

// n entries (tiles or segments) of at most max_span elements: y over the
// entries, x blocks over the longest span's steps (elements_per_step a
// step), kUnroll steps a thread where the step is a vector, at most
// kMaxBlocks in all; a grid of one x block has only the threads its span
// needs (a warp at least), so that thousands of short tiles fill the SMs.
void dequant_grid(int64_t n, int64_t max_span, bool vec, int64_t elements_per_step, dim3* grid, int* threads) {
  const int64_t y = n < kMaxGridY ? n : kMaxGridY;
  const int64_t steps = max_span / elements_per_step;
  const int64_t per_thread = vec ? kUnroll : 1;
  const int64_t need = (steps + per_thread - 1) / per_thread;  // threads the longest span keeps busy
  int64_t x = (need + kThreads - 1) / kThreads;
  const int64_t cap = kMaxBlocks / y;
  if (x > cap) x = cap;
  if (x <= 1) {
    x = 1;
    *threads = need < kThreads ? static_cast<int>((need + 31) / 32 * 32) : kThreads;
  } else {
    *threads = kThreads;
  }
  *grid = dim3(static_cast<unsigned>(x), static_cast<unsigned>(y), 1);
}

// One launch over the host table (starts or segments, by value or through
// dev), with the 16-byte body where C and both arrays allow it: every span
// then starts on a step.
template <typename D, int FMT>
int launch_dequant(bool segments, void* dst, const void* buf, const float* scales, const int32_t* table, int64_t n,
                   int64_t max_rows, int64_t block_rows, int64_t C, int32_t* dev, cudaStream_t s) {
  constexpr int64_t kN = 16 / sizeof(D);
  const bool vec = C % kN == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(buf) % 16 == 0;
  dim3 grid;
  int threads;
  dequant_grid(n, max_rows * C, vec, vec ? kN : 1, &grid, &threads);
  D* d = static_cast<D*>(dst);
  const uint8_t* q = static_cast<const uint8_t*>(buf);
  auto launch = [&](const auto& t) {
    using Table = std::decay_t<decltype(t)>;
    if (vec) {
      dequant_scatter_kernel<D, FMT, true, Table><<<grid, threads, 0, s>>>(d, q, scales, C, block_rows, t);
    } else {
      dequant_scatter_kernel<D, FMT, false, Table><<<grid, threads, 0, s>>>(d, q, scales, C, block_rows, t);
    }
  };
  return segments ? with_segments(table, n, dev, s, launch) : with_starts(table, n, dev, s, launch);
}

int dequant_entry(bool segments, void* dst, const void* buf, const float* scales, const int32_t* table, int64_t n,
                  int64_t max_rows, int64_t block_rows, int64_t C, int dst_dtype, int fmt, int32_t* dev,
                  void* stream) {
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dst_dtype == 0 && fmt == kInt8)
    return launch_dequant<float, kInt8>(segments, dst, buf, scales, table, n, max_rows, block_rows, C, dev, s);
  if (dst_dtype == 0 && fmt == kFp8)
    return launch_dequant<float, kFp8>(segments, dst, buf, scales, table, n, max_rows, block_rows, C, dev, s);
  if (dst_dtype == 1 && fmt == kInt8)
    return launch_dequant<__nv_bfloat16, kInt8>(segments, dst, buf, scales, table, n, max_rows, block_rows, C, dev,
                                                s);
  if (dst_dtype == 1 && fmt == kFp8)
    return launch_dequant<__nv_bfloat16, kFp8>(segments, dst, buf, scales, table, n, max_rows, block_rows, C, dev,
                                               s);
  return cudaErrorInvalidValue;
}

// What repro_dequant_scatter_rows_list returns where it did not find the
// tiles disjoint: the wrapper then takes its own route.
constexpr int kNotDisjoint = -3;
// The most destination rows the list entry's bitmap covers.
constexpr int64_t kBitmapRows = int64_t{1} << 24;

// Whether n tiles of block_rows rows at starts (each inside the array's rows
// rows) share no row: one pass where the starts ascend, else, for tiles of
// one row, a bitmap over the rows. False where neither tells.
bool disjoint_tiles(const int32_t* starts, int64_t n, int64_t block_rows, int64_t rows) {
  if (n * block_rows > rows) return false;
  int64_t i = 1;
  while (i < n && starts[i] - starts[i - 1] >= block_rows) ++i;
  if (i == n) return true;
  if (block_rows != 1 || rows > kBitmapRows) return false;
  // Kept all zero between calls; an entry holds the GIL, so one call at a time.
  static std::vector<uint64_t> seen;
  if (seen.size() < static_cast<size_t>((rows + 63) / 64)) seen.resize((rows + 63) / 64, 0);
  for (i = 0; i < n; ++i) {
    const uint64_t bit = uint64_t{1} << (starts[i] & 63);
    if (seen[starts[i] >> 6] & bit) break;
    seen[starts[i] >> 6] |= bit;
  }
  const bool disjoint = i == n;
  while (i-- > 0) seen[starts[i] >> 6] &= ~(uint64_t{1} << (starts[i] & 63));
  return disjoint;
}

}  // namespace

// src_dtype / dst_dtype: 0 = float32, 1 = bfloat16; fmt: 0 = int8 (qmax
// 127), 1 = fp8-e4m3 (qmax 448); chunks: blocks per tile in pack (the
// wrapper cuts tiles into 4096-element shares and sizes `partial`, nb x
// chunks floats, to match). Each entry launches on `stream` and returns
// cudaGetLastError() (0 on success); n == 0 launches nothing.

extern "C" int repro_pack_quant_rows(const void* src, void* out, float* scales, float* partial,
                                     const int64_t* starts, int64_t nb, int64_t block_rows,
                                     int64_t C, int chunks, int src_dtype, int fmt, void* stream) {
  if (nb < 0 || block_rows <= 0 || C <= 0 || chunks <= 0) return cudaErrorInvalidValue;
  if (nb == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (src_dtype == 0 && fmt == 0)
    return launch_pack<float, kInt8>(src, out, scales, partial, starts, nb, block_rows, C, chunks, 127.f, st);
  if (src_dtype == 0 && fmt == 1)
    return launch_pack<float, kFp8>(src, out, scales, partial, starts, nb, block_rows, C, chunks, 448.f, st);
  if (src_dtype == 1 && fmt == 0)
    return launch_pack<__nv_bfloat16, kInt8>(src, out, scales, partial, starts, nb, block_rows, C, chunks, 127.f, st);
  if (src_dtype == 1 && fmt == 1)
    return launch_pack<__nv_bfloat16, kFp8>(src, out, scales, partial, starts, nb, block_rows, C, chunks, 448.f, st);
  return cudaErrorInvalidValue;
}

// dequant_scatter_rows: the buffer holds buf_rows = n * block_rows rows of C
// payload bytes, scales n floats, dst rows rows of C values (0 = float32, 1
// = bfloat16). Each entry checks its table, then launches once on `stream`
// and returns cudaGetLastError() (0 on success); a table it refuses
// launches nothing and gives cudaErrorInvalidValue. Past the by-value
// capacity (repro_quant_param_starts, repro_quant_param_segs) a table needs
// dev, the device table (row_tables.cuh).

// starts: n int32 starts of disjoint tiles.
extern "C" int repro_dequant_scatter_rows(void* dst, const void* buf, const float* scales, const int32_t* starts,
                                          int64_t n, int64_t block_rows, int64_t C, int64_t rows, int dst_dtype,
                                          int fmt, int32_t* dev, void* stream) {
  if (C <= 0 || !starts_valid(starts, n, block_rows, rows, dev)) return cudaErrorInvalidValue;
  return dequant_entry(false, dst, buf, scales, starts, n, block_rows, block_rows, C, dst_dtype, fmt, dev, stream);
}

// The starts in a Python list of at most kParamStarts ints (the caller's n
// is not used: the length is read here, under the GIL), read straight into
// the by-value starts and checked on the way. A tile that leaves dst's rows
// rows gives kStartOutside, an item that is not an integer (or past int64)
// kPyError with the Python error set, which ctypes raises; tiles that share
// a row, or that this entry cannot tell apart, give kNotDisjoint and launch
// nothing.
extern "C" int repro_dequant_scatter_rows_list(void* dst, const void* buf, const float* scales, PyObject* list,
                                               int64_t n, int64_t block_rows, int64_t C, int64_t rows,
                                               int dst_dtype, int fmt, int32_t* dev, void* stream) {
  n = PyList_Size(list);
  if (n < 0 || n > kParamStarts || block_rows <= 0 || C <= 0) return cudaErrorInvalidValue;
  int32_t starts[kParamStarts];
  const int err = read_start_list(list, n, block_rows, rows, starts);
  if (err != 0) return err;
  if (!disjoint_tiles(starts, n, block_rows, rows)) return kNotDisjoint;
  return dequant_entry(false, dst, buf, scales, starts, n, block_rows, block_rows, C, dst_dtype, fmt, nullptr,
                       stream);
}

// segs: n int32 triples (buf_row, dst_row, rows) that write each dst row at
// most once, read from a buffer of buf_rows rows.
extern "C" int repro_dequant_scatter_segments(void* dst, const void* buf, const float* scales, const int32_t* segs,
                                              int64_t n, int64_t block_rows, int64_t C, int64_t rows,
                                              int64_t buf_rows, int dst_dtype, int fmt, int32_t* dev, void* stream) {
  const int64_t max_rows = segments_max_rows(segs, n, buf_rows, rows, dev);
  if (max_rows < 0 || block_rows <= 0 || C <= 0) return cudaErrorInvalidValue;
  return dequant_entry(true, dst, buf, scales, segs, n, max_rows, block_rows, C, dst_dtype, fmt, dev, stream);
}

// The most starts and segments a by-value table holds.
extern "C" int repro_quant_param_starts() { return kParamStarts; }
extern "C" int repro_quant_param_segs() { return kParamSegs; }

extern "C" const char* repro_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
