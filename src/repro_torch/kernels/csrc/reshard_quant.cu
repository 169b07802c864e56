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
// once where the tile fits on chip and writes one byte per element;
// dequant_scatter reads one byte per element and writes the destination.
//
// pack_quant_rows: the scale needs the whole tile's absmax before any byte is
// written, so a tile is held on chip between the two, by one of three routes
// that the tile's size picks (the wrapper's pure function route(), whose
// limits kWarpBytes and kBlockBytes are exported for it to check):
//   - warp (a tile of at most kWarpBytes, 8 KB: the embedding moments' 2048
//     fp32 rows): one warp a tile, held in registers, 256 bytes a lane in
//     16-byte steps (4 f32 or 8 bf16 values, a lane's steps 512 bytes
//     apart); the absmax by shuffles; each lane writes a step's 4 or 8
//     payload bytes as one store, so a warp's loads and stores are
//     contiguous;
//   - block (at most kBlockBytes, 192 KB): one block of 512 threads a tile,
//     staged in dynamic shared memory by 16-byte cp.async, reduced, then
//     quantized from shared memory;
//   - grid (a larger tile: a stacked moment's 12.58 M fp32 row is 50.3 MB):
//     one cooperative launch of one block an SM. Each block keeps as much
//     of its share of the tile as fits on chip (192 KB in shared memory,
//     128 KB in registers) and streams the rest; the blocks meet at a
//     grid-wide barrier once every share's absmax is in, and the quantize
//     pass reads again only what was streamed, last-read first, from L2.
//     A two-kernel design (an absmax pass over the grid, then a quantize
//     pass walking the tile in reverse for L2 hits) was slower at that row
//     on an NVIDIA H100, alone and in the streamed resize, where training
//     runs beside it (PERF.md). No atomics: deterministic.
// Where rounding to int8 allows, the division is replaced by a product with
// the tile's reciprocal (quantize_x: the same bits, by construction).
// Each route takes its tiles' int32 starts by value in the kernel's
// parameters (RowStarts, row_tables.cuh), and past kParamStarts through the
// stream's device table, in one entry; repro_pack_quant_rows_list reads the
// executor's Python list straight into them. Where C is not a multiple of 8
// (or an array is not 16-byte aligned) every route reads and writes one
// element at a time, and the warp route reads its tile twice (from L1).
//
// dequant_scatter: blockIdx.y walks the tiles (or segments) and the x blocks
// share each one's span; a thread's step is one 16-byte store (4 f32 or 8
// bf16 values) and the 4 or 8 payload bytes behind it, so that both a warp's
// loads and its stores are contiguous, with kUnroll steps' loads in flight,
// where C is a multiple of the step and both arrays are 16-byte aligned, else
// one element a step; no division per element; x is fitted to the longest
// span, so one 12.58 M-element tile and 4096 tiles of 2048 both fill the SMs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <vector>

#include "row_tables.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
// pack_quant_rows' routes: the largest tile (bytes) a warp holds in
// registers (256 bytes a lane) and a block in dynamic shared memory; the
// threads of a block-route block; the threads of the grid route's one block
// an SM, and the bytes of its share a thread holds in registers (8 16-byte
// steps)
constexpr int kWarpBytes = 8192;
constexpr int kBlockBytes = 192 * 1024;
constexpr int kBlockThreads = 512;
constexpr int kGridThreads = 1024;
constexpr int kHeldBytes = 128;
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

template <int THREADS>
__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < THREADS / 32 ? red[lane] : 0.f;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, off));
    if (lane == 0) red[0] = x;
  }
  __syncthreads();
  return red[0];
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

// x / scale quantized as quantize<FMT>(__fdiv_rn(x, scale)) gives it, with
// the tile's rcp = __frcp_rn(scale): for int8, y = x * rcp lies within
// 1.6e-5 of x / scale and RN(x / scale) within 7.6e-6 (|x / scale| <= 127:
// each is one rounding of 2^-24 relative from it), so rint(y) is the
// reference's integer unless y lies within 4e-5 of a half-integer; only
// there, and where y is NaN (a NaN or infinite scale), is the division made.
// fp8 rounds at other points than half-integers: it always divides.
template <int FMT>
__device__ __forceinline__ uint8_t quantize_x(float x, float scale, float rcp, float qmax) {
  if constexpr (FMT == kInt8) {
    const float y = __fmul_rn(x, rcp);
    const float k = rintf(y);
    if (fabsf(y - k) < 0.49996f) return static_cast<uint8_t>(static_cast<int8_t>(fminf(fmaxf(k, -qmax), qmax)));
  }
  return quantize<FMT>(__fdiv_rn(x, scale), qmax);
}

// A step of pack_quant_rows' 16-byte bodies: one 16-byte load of source (4
// float or 8 bfloat16 values), so that a warp's load covers 512 contiguous
// bytes, quantized into one store of 4 or 8 payload bytes (Out).
template <typename T>
struct PackStep;
template <>
struct PackStep<float> {
  static constexpr int kN = 4;
  using Out = uint32_t;
  float4 v;
};
template <>
struct PackStep<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Out = uint2;
  uint4 v;
};

template <typename T>
__device__ __forceinline__ PackStep<T> load_step(const T* tile, int64_t u) {
  return reinterpret_cast<const PackStep<T>*>(tile)[u];
}

__device__ __forceinline__ void step_values(const PackStep<float>& s, float v[4]) {
  v[0] = s.v.x, v[1] = s.v.y, v[2] = s.v.z, v[3] = s.v.w;
}
// a bfloat16 is the upper half of its float
__device__ __forceinline__ void step_values(const PackStep<__nv_bfloat16>& s, float v[8]) {
  const uint32_t w[4] = {s.v.x, s.v.y, s.v.z, s.v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ float step_absmax(const PackStep<T>& s, float m) {
  float v[PackStep<T>::kN];
  step_values(s, v);
#pragma unroll
  for (int k = 0; k < PackStep<T>::kN; ++k) m = nan_max(m, fabsf(v[k]));
  return m;
}

__device__ __forceinline__ uint32_t pack_out(const uint32_t (&w)[1]) { return w[0]; }
__device__ __forceinline__ uint2 pack_out(const uint32_t (&w)[2]) { return make_uint2(w[0], w[1]); }

template <typename T, int FMT>
__device__ __forceinline__ typename PackStep<T>::Out quant_step(const PackStep<T>& s, float scale, float rcp,
                                                                float qmax) {
  constexpr int kN = PackStep<T>::kN;
  float v[kN];
  step_values(s, v);
  uint32_t w[kN / 4] = {};
#pragma unroll
  for (int k = 0; k < kN; ++k) w[k >> 2] |= uint32_t{quantize_x<FMT>(v[k], scale, rcp, qmax)} << (8 * (k & 3));
  return pack_out(w);
}

// step u of a tile's payload
template <typename T>
__device__ __forceinline__ typename PackStep<T>::Out& out_step(uint8_t* qt, int64_t u) {
  return reinterpret_cast<typename PackStep<T>::Out*>(qt)[u];
}

template <typename T>
__device__ __forceinline__ const T* tile_at(const T* src, int64_t start, int64_t C) {
  return src + start * C;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Route warp: warp w of the grid quantizes tiles w, w + warps, ... Where VEC,
// a lane holds steps lane, lane + 32, ... of its tile in registers (kWarpBytes
// / 32 bytes a lane), so that the tile is read once; else one element at a
// time, the tile read twice (the second time from L1).
template <typename T, int FMT, bool VEC, typename Table>
__global__ void __launch_bounds__(kThreads)
pack_quant_warp_kernel(const T* __restrict__ src, uint8_t* __restrict__ out, float* __restrict__ scales,
                       int64_t tile_elems, int64_t C, float inv_qmax, float qmax, const __grid_constant__ Table t) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kSteps = kWarpBytes / 32 / 16;
  const int lane = threadIdx.x % 32;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32; i < t.n; i += warps) {
    const T* tile = tile_at(src, t.start[i], C);
    uint8_t* qt = out + i * tile_elems;
    float m = 0.f;
    if constexpr (VEC) {
      const int64_t steps = tile_elems / PackStep<T>::kN;
      PackStep<T> r[kSteps];
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        if (lane + 32 * k < steps) r[k] = load_step(tile, lane + 32 * k);
      }
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        if (lane + 32 * k < steps) m = step_absmax(r[k], m);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float scale = nan_max(m, 1e-12f) * inv_qmax, rcp = __frcp_rn(scale);
      if (lane == 0) scales[i] = scale;
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        if (lane + 32 * k < steps) out_step<T>(qt, lane + 32 * k) = quant_step<T, FMT>(r[k], scale, rcp, qmax);
      }
    } else {
      for (int64_t e = lane; e < tile_elems; e += 32) m = nan_max(m, fabsf(to_float(tile[e])));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float scale = nan_max(m, 1e-12f) * inv_qmax, rcp = __frcp_rn(scale);
      if (lane == 0) scales[i] = scale;
      for (int64_t e = lane; e < tile_elems; e += 32) qt[e] = quantize_x<FMT>(to_float(tile[e]), scale, rcp, qmax);
    }
  }
}

// Route block: block b quantizes tiles b, b + gridDim.x, ..., each staged
// whole in dynamic shared memory (16-byte cp.async where VEC), then reduced,
// then quantized from there.
template <typename T, int FMT, bool VEC, typename Table>
__global__ void __launch_bounds__(kBlockThreads)
pack_quant_block_kernel(const T* __restrict__ src, uint8_t* __restrict__ out, float* __restrict__ scales,
                        int64_t tile_elems, int64_t C, float inv_qmax, float qmax, const __grid_constant__ Table t) {
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ float red[kBlockThreads / 32];
  for (int64_t i = blockIdx.x; i < t.n; i += gridDim.x) {
    const T* tile = tile_at(src, t.start[i], C);
    uint8_t* qt = out + i * tile_elems;
    float m = 0.f;
    if constexpr (VEC) {
      const int64_t chunks = tile_elems * static_cast<int64_t>(sizeof(T)) / 16;
      for (int64_t c = threadIdx.x; c < chunks; c += kBlockThreads) {
        cp_async16(stage + 16 * c, reinterpret_cast<const char*>(tile) + 16 * c);
      }
      cp_async_wait_all();
      __syncthreads();
      for (int64_t u = threadIdx.x; u < tile_elems / PackStep<T>::kN; u += kBlockThreads) {
        m = step_absmax(load_step(reinterpret_cast<const T*>(stage), u), m);
      }
    } else {
      T* staged = reinterpret_cast<T*>(stage);
      for (int64_t e = threadIdx.x; e < tile_elems; e += kBlockThreads) {
        const T v = tile[e];
        staged[e] = v;
        m = nan_max(m, fabsf(to_float(v)));
      }
    }
    const float scale = nan_max(block_max<kBlockThreads>(m, red), 1e-12f) * inv_qmax;  // its syncs publish the stage
    const float rcp = __frcp_rn(scale);
    if (threadIdx.x == 0) scales[i] = scale;
    if constexpr (VEC) {
      for (int64_t u = threadIdx.x; u < tile_elems / PackStep<T>::kN; u += kBlockThreads) {
        out_step<T>(qt, u) = quant_step<T, FMT>(load_step(reinterpret_cast<const T*>(stage), u), scale, rcp, qmax);
      }
    } else {
      const T* staged = reinterpret_cast<const T*>(stage);
      for (int64_t e = threadIdx.x; e < tile_elems; e += kBlockThreads) {
        qt[e] = quantize_x<FMT>(to_float(staged[e]), scale, rcp, qmax);
      }
    }
    __syncthreads();  // the next tile overwrites the stage
  }
}

// Route grid: one cooperative launch of one block of kGridThreads an SM.
// The blocks cut each tile into equal shares; a block keeps what of its
// share fits on chip, kBlockBytes staged in shared memory by cp.async and
// kHeldBytes a thread in registers, and streams the rest, reducing all
// three; the blocks meet at a grid-wide barrier (which the cooperative
// launch makes safe: every block is resident), each reduces all the partial
// maxima into the scale, then quantizes what it kept and reads the rest
// again, last-read first, where it is likeliest still in L2. partial holds
// two slots of gridDim.x maxima, one for each parity of the tile.
template <typename T, int FMT, bool VEC, typename Table>
__global__ void __launch_bounds__(kGridThreads, 1)
pack_quant_grid_kernel(const T* __restrict__ src, uint8_t* __restrict__ out, float* __restrict__ scales,
                       int64_t tile_elems, int64_t C, float* __restrict__ partial, float inv_qmax, float qmax,
                       const __grid_constant__ Table t) {
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ float red[kGridThreads / 32];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  constexpr int kR = kHeldBytes / 16;  // steps a thread holds
  constexpr int64_t kStaged = kBlockBytes / 16;
  const int blocks = gridDim.x;
  // a share in steps (VEC) or in elements: [lo, hi) = staged, then held,
  // then streamed
  const int64_t units = VEC ? tile_elems / PackStep<T>::kN : tile_elems;
  const int64_t per = (units + blocks - 1) / blocks;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * per < units ? static_cast<int64_t>(blockIdx.x) * per : units;
  const int64_t hi = lo + per < units ? lo + per : units;
  const int64_t held_lo = VEC ? (lo + kStaged < hi ? lo + kStaged : hi) : lo;
  const int64_t rest_lo = VEC ? (held_lo + kR * kGridThreads < hi ? held_lo + kR * kGridThreads : hi) : lo;
  const T* staged = reinterpret_cast<const T*>(stage);
  for (int64_t i = 0; i < t.n; ++i) {
    const T* tile = tile_at(src, t.start[i], C);
    uint8_t* qt = out + i * tile_elems;
    float m = 0.f;
    PackStep<T> r[kR];
    if constexpr (VEC) {
      const int64_t chunks = held_lo - lo;  // a step is 16 bytes
      const char* from = reinterpret_cast<const char*>(tile) + 16 * lo;
      for (int64_t c = threadIdx.x; c < chunks; c += kGridThreads) cp_async16(stage + 16 * c, from + 16 * c);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const int64_t u = held_lo + threadIdx.x + k * kGridThreads;
        if (u < rest_lo) r[k] = load_step(tile, u);
      }
      for (int64_t u = rest_lo + threadIdx.x; u < hi; u += 2 * kGridThreads) {
        const PackStep<T> a = load_step(tile, u);
        if (u + kGridThreads < hi) m = step_absmax(load_step(tile, u + kGridThreads), m);
        m = step_absmax(a, m);
      }
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        if (held_lo + threadIdx.x + k * kGridThreads < rest_lo) m = step_absmax(r[k], m);
      }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      for (int64_t u = threadIdx.x; u < held_lo - lo; u += kGridThreads) m = step_absmax(load_step(staged, u), m);
    } else {
      for (int64_t e = lo + threadIdx.x; e < hi; e += kGridThreads) m = nan_max(m, fabsf(to_float(tile[e])));
    }
    m = block_max<kGridThreads>(m, red);
    float* slot = partial + (i & 1) * blocks;
    if (threadIdx.x == 0) slot[blockIdx.x] = m;
    grid.sync();
    m = 0.f;
    for (int c = threadIdx.x; c < blocks; c += kGridThreads) m = nan_max(m, slot[c]);
    const float scale = nan_max(block_max<kGridThreads>(m, red), 1e-12f) * inv_qmax, rcp = __frcp_rn(scale);
    if (blockIdx.x == 0 && threadIdx.x == 0) scales[i] = scale;
    if constexpr (VEC) {
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const int64_t u = held_lo + threadIdx.x + k * kGridThreads;
        if (u < rest_lo) out_step<T>(qt, u) = quant_step<T, FMT>(r[k], scale, rcp, qmax);
      }
      for (int64_t u = threadIdx.x; u < held_lo - lo; u += kGridThreads) {
        out_step<T>(qt, lo + u) = quant_step<T, FMT>(load_step(staged, u), scale, rcp, qmax);
      }
      for (int64_t u = hi - 1 - threadIdx.x; u >= rest_lo; u -= kGridThreads) {
        out_step<T>(qt, u) = quant_step<T, FMT>(load_step(tile, u), scale, rcp, qmax);
      }
    } else {
      for (int64_t e = hi - 1 - threadIdx.x; e >= lo; e -= kGridThreads) {
        qt[e] = quantize_x<FMT>(to_float(tile[e]), scale, rcp, qmax);
      }
    }
    __syncthreads();  // the next tile overwrites the stage
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

// The parameters: three pointers, C, block_rows and the table (dequant);
// four pointers, tile, C, two floats and the starts (pack).
static_assert(3 * sizeof(void*) + 2 * sizeof(int64_t) + sizeof(RowStarts<kParamStarts>) <= kParamBytes,
              "the by-value starts exceed the 32,764 bytes of kernel parameters");
static_assert(4 * sizeof(void*) + 2 * sizeof(int64_t) + 2 * sizeof(float) + sizeof(RowStarts<kParamStarts>) <=
                  kParamBytes,
              "pack's by-value starts exceed the 32,764 bytes of kernel parameters");
static_assert(3 * sizeof(void*) + 2 * sizeof(int64_t) + sizeof(RowTable<kParamSegs>) <= kParamBytes,
              "the by-value segments exceed the 32,764 bytes of kernel parameters");

// pack_quant_rows' routes, as the wrapper's route() names them
constexpr int kRouteWarp = 0;
constexpr int kRouteBlock = 1;
constexpr int kRouteGrid = 2;

// The route of a tile of tile_bytes, as the wrapper's route() picks it: a
// warp holds at most kWarpBytes in registers, a block kBlockBytes in shared
// memory, and the grid route takes any tile.
int route_of(int64_t tile_bytes) {
  return tile_bytes <= kWarpBytes ? kRouteWarp : tile_bytes <= kBlockBytes ? kRouteBlock : kRouteGrid;
}

// The float scratch a launch needs: the grid route's two slots of one
// maximum a block; none for the others.
int64_t scratch_floats(int route, int blocks) { return route == kRouteGrid ? 2 * static_cast<int64_t>(blocks) : 0; }

// The SMs of the current device, read once (an entry holds the GIL, so one
// call at a time); 0 if it cannot be read.
int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// Sets a kernel's dynamic shared memory limit to kBlockBytes, once per kernel.
template <auto Kernel>
cudaError_t allow_stage() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockBytes);
  done = err == cudaSuccess;
  return err;
}

// One launch of `route` over the n host starts (by value, or through dev
// past the capacity); VEC where C is a multiple of 8 and both arrays are
// 16-byte aligned. scratch holds scratch_n floats.
template <typename T, int FMT>
int launch_pack(int route, const T* src, uint8_t* out, float* scales, float* scratch, int64_t scratch_n,
                const int32_t* starts, int64_t n, int64_t block_rows, int64_t C, int32_t* dev, cudaStream_t s) {
  const int64_t tile = block_rows * C;
  if (route != route_of(tile * static_cast<int64_t>(sizeof(T)))) return cudaErrorInvalidValue;
  const bool vec =
      C % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const float qmax = FMT == kInt8 ? 127.f : 448.f;
  const float inv_qmax = static_cast<float>(1.0 / static_cast<double>(qmax));
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  if (scratch_n < scratch_floats(route, sms) || (route == kRouteGrid && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSuccess;  // a launch's own error (cudaLaunchKernelEx, cudaFuncSetAttribute)
  auto launch = [&](const auto& t) {
    using Table = std::decay_t<decltype(t)>;
    auto go = [&](auto vec_tag) {
      constexpr bool V = decltype(vec_tag)::value;
      if (route == kRouteWarp) {
        const int64_t blocks = (n + kThreads / 32 - 1) / (kThreads / 32);
        pack_quant_warp_kernel<T, FMT, V, Table><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            src, out, scales, tile, C, inv_qmax, qmax, t);
      } else if (route == kRouteBlock) {
        err = allow_stage<pack_quant_block_kernel<T, FMT, V, Table>>();
        if (err != cudaSuccess) return;
        const size_t stage = (tile * sizeof(T) + 15) / 16 * 16;
        pack_quant_block_kernel<T, FMT, V, Table><<<static_cast<unsigned>(n), kBlockThreads, stage, s>>>(
            src, out, scales, tile, C, inv_qmax, qmax, t);
      } else {
        auto kernel = pack_quant_grid_kernel<T, FMT, V, Table>;
        err = allow_stage<pack_quant_grid_kernel<T, FMT, V, Table>>();
        if (err != cudaSuccess) return;
        cudaLaunchConfig_t config = {};
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeCooperative;
        attr[0].val.cooperative = 1;
        config.gridDim = dim3(static_cast<unsigned>(sms));
        config.blockDim = dim3(kGridThreads);
        config.dynamicSmemBytes = kBlockBytes;
        config.stream = s;
        config.attrs = attr;
        config.numAttrs = 1;
        err = cudaLaunchKernelEx(&config, kernel, src, out, scales, tile, C, scratch, inv_qmax, qmax, t);
      }
    };
    if (vec) {
      go(std::true_type{});
    } else {
      go(std::false_type{});
    }
  };
  const cudaError_t last = with_starts(starts, n, dev, s, launch);
  return static_cast<int>(err != cudaSuccess ? err : last);
}

int pack_entry(void* out, float* scales, const void* src, const int32_t* starts, int64_t n, int64_t block_rows,
               int64_t C, int src_dtype, int fmt, int route, float* scratch, int64_t scratch_n, int32_t* dev,
               void* stream) {
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* q = static_cast<uint8_t*>(out);
  if (src_dtype == 0 && fmt == kInt8)
    return launch_pack<float, kInt8>(route, static_cast<const float*>(src), q, scales, scratch, scratch_n, starts,
                                     n, block_rows, C, dev, s);
  if (src_dtype == 0 && fmt == kFp8)
    return launch_pack<float, kFp8>(route, static_cast<const float*>(src), q, scales, scratch, scratch_n, starts, n,
                                    block_rows, C, dev, s);
  if (src_dtype == 1 && fmt == kInt8)
    return launch_pack<__nv_bfloat16, kInt8>(route, static_cast<const __nv_bfloat16*>(src), q, scales, scratch,
                                             scratch_n, starts, n, block_rows, C, dev, s);
  if (src_dtype == 1 && fmt == kFp8)
    return launch_pack<__nv_bfloat16, kFp8>(route, static_cast<const __nv_bfloat16*>(src), q, scales, scratch,
                                            scratch_n, starts, n, block_rows, C, dev, s);
  return cudaErrorInvalidValue;
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

// pack_quant_rows: out gets n * block_rows rows of C payload bytes, scales n
// floats, from src (rows rows of C values; src_dtype 0 = float32, 1 =
// bfloat16); fmt 0 = int8 (qmax 127), 1 = fp8-e4m3 (qmax 448); route 0 warp,
// 1 block, 2 grid (refused where the tile is too large for it); scratch
// holds scratch_n floats (the grid route needs two a block). Each
// entry checks its starts, then launches on `stream` and returns
// cudaGetLastError() (0 on success); n == 0 launches nothing. Past the
// by-value capacity (repro_quant_param_starts) the starts need dev, the
// device table (row_tables.cuh).

// starts: n int32 tile starts, in host memory.
extern "C" int repro_pack_quant_rows(void* out, float* scales, const void* src, const int32_t* starts, int64_t n,
                                     int64_t block_rows, int64_t C, int64_t rows, int src_dtype, int fmt, int route,
                                     float* scratch, int64_t scratch_n, int32_t* dev, void* stream) {
  if (C <= 0 || !starts_valid(starts, n, block_rows, rows, dev)) return cudaErrorInvalidValue;
  return pack_entry(out, scales, src, starts, n, block_rows, C, src_dtype, fmt, route, scratch, scratch_n, dev,
                    stream);
}

// The starts in a Python list of at most kParamStarts ints (the caller's n
// is not used: the length is read here, under the GIL), read straight into
// the by-value starts and checked on the way: a tile that leaves src's rows
// rows gives kStartOutside, an item that is not an integer (or past int64)
// kNotInteger, and neither launches. Starts may repeat or overlap.
extern "C" int repro_pack_quant_rows_list(void* out, float* scales, const void* src, PyObject* list, int64_t n,
                                          int64_t block_rows, int64_t C, int64_t rows, int src_dtype, int fmt,
                                          int route, float* scratch, int64_t scratch_n, int32_t* dev, void* stream) {
  n = PyList_Size(list);
  if (n < 0 || n > kParamStarts || block_rows <= 0 || C <= 0) return cudaErrorInvalidValue;
  int32_t starts[kParamStarts];
  const int err = read_start_list(list, n, block_rows, rows, starts);
  if (err != 0) return err;
  return pack_entry(out, scales, src, starts, n, block_rows, C, src_dtype, fmt, route, scratch, scratch_n, nullptr,
                    stream);
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
// kNotInteger; tiles that share a row, or that this entry cannot tell apart,
// give kNotDisjoint; none of these launches.
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

// The most starts and segments a by-value table holds, and the largest tile
// (in bytes) of the warp and the block route of pack_quant_rows.
extern "C" int repro_quant_param_starts() { return kParamStarts; }
extern "C" int repro_quant_param_segs() { return kParamSegs; }
extern "C" int repro_quant_warp_bytes() { return kWarpBytes; }
extern "C" int repro_quant_block_bytes() { return kBlockBytes; }

extern "C" const char* repro_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
