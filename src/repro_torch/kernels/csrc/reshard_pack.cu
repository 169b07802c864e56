// Row copies of the reshard data plane for Hopper (sm_90a): pack_rows,
// scatter_rows, relayout_rows and unpack_rows.
//
// Replaces: src/repro/kernels/reshard_pack.py, the four TPU Pallas kernels
// of the staging-buffer assembly (pack_rows_pallas, scatter_rows_pallas,
// relayout_rows_pallas, unpack_rows_pallas). Each one computes what its
// JAX reference computes (src/repro/kernels/ref.py: pack_rows_ref,
// scatter_rows_ref, relayout_rows_ref, unpack_rows_ref) on a row-major
// (rows, C) array, for any start, not only the block-aligned starts the
// Pallas index maps take:
//   - pack_rows_kernel     out[i*br + j]         = src[starts[i] + j]
//   - unpack_rows_kernel   out[starts[i] + j]    = buf[i*br + j], into a fresh
//                          output that the entry zero-fills first, so rows no
//                          block covers are zero (as the reference)
//   - scatter_rows_kernel  dst[starts[i] + j]    = buf[i*br + j], in place,
//                          the last block wins where blocks overlap
//   - relayout_rows_kernel dst[starts[i] + j]    = src[starts[i] + j], in place
//
// What bounds them on the H100: they are byte copies, so HBM bandwidth,
// reading each moved byte once and writing it once (3.35 TB/s). The design:
//   - blockIdx.y walks a list of spans of whole rows, each contiguous in
//     both arrays (a block of block_rows rows, or a segment), and the x
//     dimension of the grid strides over one span's bytes. x is fitted to
//     the longest span and to the card (kFillBlocks over the y spans), so
//     one long run (a contiguous row range of hundreds of MB) and thousands
//     of short ones (scattered single rows) both fill the SMs;
//   - every span is copied in 16-byte units when both addresses and its
//     length allow, else in the widest of 8/4/2/1 bytes that does, so the
//     kernels take any dtype and any row pitch; offsets are 64-bit;
//   - the TPU grid runs in order, so a repeated start resolves to the last
//     block there; a CUDA grid does not. A pack writes every output row
//     once whatever its starts. For the others the wrapper
//     (repro_torch/kernels/reshard_pack.py) resolves the last writer of
//     every destination row on the host before the launch and passes
//     segments that never write one row twice, so repeated and overlapping
//     starts give the reference's sequential result and no two threads
//     write one byte. unpack_rows on disjoint blocks needs no segments; on
//     overlapping ones its entry launches scatter_rows_kernel on the
//     segments into the zeroed output.
//
// What bounds a call, as opposed to the kernel: the host work around the
// launch (a moved cache row takes ~5 us on the device). So every table goes
// by value in the kernel's parameters (row_tables.cuh): pack_rows and
// unpack_rows take their block starts (RowStarts); scatter_rows and
// relayout_rows take segments (RowTable; the wrapper merges runs, so a
// contiguous run is one segment). repro_pack_rows_list reads a Python list
// of starts straight into the parameters, so the host reads the list once.
// The wrapper checks shapes, types, devices and the range of every start,
// allocates outputs and tables, and passes torch's current stream; the
// entries check every table entry again before anything is enqueued.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_tables.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
constexpr int64_t kFillBlocks = 132 * 16;  // 16 blocks of 256 threads per SM

template <typename T>
__device__ __forceinline__ void copy_units(char* dst, const char* src, int64_t n) {
  T* d = reinterpret_cast<T*>(dst);
  const T* s = reinterpret_cast<const T*>(src);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) d[i] = s[i];
}

// This block's share of copying nbytes from src to dst, in the widest unit
// that divides both addresses and nbytes.
__device__ __forceinline__ void copy_span(char* dst, const char* src, int64_t nbytes) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
                         static_cast<uintptr_t>(nbytes);
  if ((bits & 15) == 0) {
    copy_units<uint4>(dst, src, nbytes >> 4);
  } else if ((bits & 7) == 0) {
    copy_units<uint2>(dst, src, nbytes >> 3);
  } else if ((bits & 3) == 0) {
    copy_units<uint32_t>(dst, src, nbytes >> 2);
  } else if ((bits & 1) == 0) {
    copy_units<uint16_t>(dst, src, nbytes >> 1);
  } else {
    copy_units<uint8_t>(dst, src, nbytes);
  }
}

// ---------------------------------------------------------------------------
// pack_rows and unpack_rows: block starts
// ---------------------------------------------------------------------------

// The parameters: two pointers, row_bytes, block_rows and the starts.
static_assert(2 * sizeof(void*) + 2 * sizeof(int64_t) + sizeof(RowStarts<kParamStarts>) <= kParamBytes,
              "the by-value starts exceed the 32,764 bytes of kernel parameters");

// The one body of both directions: block i is block_rows rows at row
// start[i] of the array and at row i*block_rows of the buffer. kGather
// (pack) copies it from the array `in` into the buffer `out`, else (unpack)
// from the buffer `in` into the array `out`.
template <bool kGather, typename Starts>
__device__ __forceinline__ void copy_blocks(char* out, const char* in, int64_t row_bytes, int64_t block_rows,
                                            const Starts& t) {
  const int64_t block_bytes = block_rows * row_bytes;
  for (int64_t i = blockIdx.y; i < t.n; i += gridDim.y) {
    const int64_t at = static_cast<int64_t>(t.start[i]) * row_bytes;
    if (kGather) {
      copy_span(out + i * block_bytes, in + at, block_bytes);
    } else {
      copy_span(out + at, in + i * block_bytes, block_bytes);
    }
  }
}

template <typename Starts>
__global__ void pack_rows_kernel(char* __restrict__ out, const char* __restrict__ src, int64_t row_bytes,
                                 int64_t block_rows, const __grid_constant__ Starts t) {
  copy_blocks<true>(out, src, row_bytes, block_rows, t);
}

template <typename Starts>
__global__ void unpack_rows_kernel(char* __restrict__ out, const char* __restrict__ buf, int64_t row_bytes,
                                   int64_t block_rows, const __grid_constant__ Starts t) {
  copy_blocks<false>(out, buf, row_bytes, block_rows, t);
}

// ---------------------------------------------------------------------------
// scatter_rows and relayout_rows (and unpack_rows on overlapping blocks):
// segments (src_row, dst_row, rows)
// ---------------------------------------------------------------------------

// The parameters: two pointers, row_bytes and the table.
static_assert(3 * sizeof(int64_t) + sizeof(RowTable<kParamSegs>) <= kParamBytes,
              "the by-value table exceeds the 32,764 bytes of kernel parameters");

template <typename Table>
__global__ void scatter_rows_kernel(char* __restrict__ dst, const char* __restrict__ buf, int64_t row_bytes,
                                    const __grid_constant__ Table t) {
  for (int64_t i = blockIdx.y; i < t.n; i += gridDim.y) {
    const int64_t from = t.seg[3 * i], to = t.seg[3 * i + 1], rows = t.seg[3 * i + 2];
    copy_span(dst + to * row_bytes, buf + from * row_bytes, rows * row_bytes);
  }
}

// relayout: the same rows of two arrays (src_row == dst_row in every segment).
// Not __restrict__: a destination adopted from its source may be the source.
template <typename Table>
__global__ void relayout_rows_kernel(char* dst, const char* src, int64_t row_bytes,
                                     const __grid_constant__ Table t) {
  for (int64_t i = blockIdx.y; i < t.n; i += gridDim.y) {
    const int64_t from = t.seg[3 * i], to = t.seg[3 * i + 1], rows = t.seg[3 * i + 2];
    copy_span(dst + to * row_bytes, src + from * row_bytes, rows * row_bytes);
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// Grid for n spans of at most max_span_bytes: y over spans, x enough blocks
// to fill the card, but none that would find no 16-byte unit to copy.
dim3 grid_for(int64_t n, int64_t max_span_bytes) {
  const int64_t y = n < kMaxGridY ? n : kMaxGridY;
  const int64_t units = (max_span_bytes + 15) / 16;
  int64_t x = (units + kThreads - 1) / kThreads;
  const int64_t fill = (kFillBlocks + y - 1) / y;
  if (x > fill) x = fill;
  if (x < 1) x = 1;
  return dim3(static_cast<unsigned>(x), static_cast<unsigned>(y), 1);
}

// Each launch takes its table in host memory through with_starts or
// with_segments (row_tables.cuh): by value up to the capacity, through the
// device table past it.

int launch_blocks(bool gather, void* out, const void* in, const int32_t* starts, int64_t n, int64_t block_rows,
                  int64_t row_bytes, int32_t* dev_starts, cudaStream_t s) {
  const dim3 grid = grid_for(n, block_rows * row_bytes);
  char* o = static_cast<char*>(out);
  const char* f = static_cast<const char*>(in);
  return with_starts(starts, n, dev_starts, s, [&](const auto& t) {
    using Starts = std::decay_t<decltype(t)>;
    if (gather) {
      pack_rows_kernel<Starts><<<grid, kThreads, 0, s>>>(o, f, row_bytes, block_rows, t);
    } else {
      unpack_rows_kernel<Starts><<<grid, kThreads, 0, s>>>(o, f, row_bytes, block_rows, t);
    }
  });
}

int launch_rows(bool relayout, void* dst, const void* src, const int32_t* segs, int64_t n, int64_t max_rows,
                int64_t row_bytes, int32_t* dev_segs, cudaStream_t s) {
  const dim3 grid = grid_for(n, max_rows * row_bytes);
  char* d = static_cast<char*>(dst);
  const char* f = static_cast<const char*>(src);
  return with_segments(segs, n, dev_segs, s, [&](const auto& t) {
    using Table = std::decay_t<decltype(t)>;
    if (relayout) {
      relayout_rows_kernel<Table><<<grid, kThreads, 0, s>>>(d, f, row_bytes, t);
    } else {
      scatter_rows_kernel<Table><<<grid, kThreads, 0, s>>>(d, f, row_bytes, t);
    }
  });
}

int segment_entry(bool relayout, void* dst, const void* src, const int32_t* segs, int64_t n, int64_t row_bytes,
                  int32_t* dev_segs, void* stream) {
  const int64_t max_rows = row_bytes > 0 ? segments_max_rows(segs, n, -1, -1, dev_segs) : -1;
  if (max_rows < 0) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  return launch_rows(relayout, dst, src, segs, n, max_rows, row_bytes, dev_segs, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Each entry checks its table, then enqueues its work on `stream` (one
// kernel launch; unpack_rows a memset of the output before it) and returns
// cudaGetLastError() (0 on success); a table it refuses enqueues nothing and
// gives cudaErrorInvalidValue. n == 0 launches nothing. Past the by-value
// capacity (repro_rows_param_starts, repro_rows_param_segs) a table needs
// dev_starts / dev_segs, as above.

// starts: n int32 block starts into src's rows rows.
extern "C" int repro_pack_rows(void* out, const void* src, const int32_t* starts, int64_t n, int64_t block_rows,
                               int64_t row_bytes, int64_t rows, int32_t* dev_starts, void* stream) {
  if (row_bytes <= 0 || !starts_valid(starts, n, block_rows, rows, dev_starts)) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  return launch_blocks(true, out, src, starts, n, block_rows, row_bytes, dev_starts,
                       static_cast<cudaStream_t>(stream));
}

// pack_rows on the starts in a Python list of at most kParamStarts ints
// (the caller's n is not used: the length is read here, under the GIL),
// read straight into the by-value starts and checked on the way, so that
// the host reads the list once. A block that leaves src's rows rows gives
// -1; an item that is not an integer (or past int64) gives -2 with the
// Python error set, which ctypes raises.
extern "C" int repro_pack_rows_list(void* out, const void* src, PyObject* list, int64_t n, int64_t block_rows,
                                    int64_t row_bytes, int64_t rows, int32_t* dev_starts, void* stream) {
  n = PyList_Size(list);
  if (n < 0 || n > kParamStarts || block_rows <= 0 || row_bytes <= 0) return cudaErrorInvalidValue;
  int32_t starts[kParamStarts];
  const int err = read_start_list(list, n, block_rows, rows, starts);
  if (err != 0 || n == 0) return err;
  return launch_blocks(true, out, src, starts, n, block_rows, row_bytes, dev_starts,
                       static_cast<cudaStream_t>(stream));
}

// starts: n int32 block starts, disjoint blocks, into out's rows rows; out
// is zeroed first.
extern "C" int repro_unpack_rows(void* out, const void* buf, const int32_t* starts, int64_t n, int64_t block_rows,
                                 int64_t row_bytes, int64_t rows, int32_t* dev_starts, void* stream) {
  if (row_bytes <= 0 || !starts_valid(starts, n, block_rows, rows, dev_starts)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(out, 0, rows * row_bytes, s);
  if (err != cudaSuccess || n == 0) return err;
  return launch_blocks(false, out, buf, starts, n, block_rows, row_bytes, dev_starts, s);
}

// unpack_rows on overlapping blocks: segments (buf_row, out_row, rows) that
// write every covered row of out's rows rows once, by its last writer; out
// is zeroed first.
extern "C" int repro_unpack_segments(void* out, const void* buf, const int32_t* segs, int64_t n, int64_t row_bytes,
                                     int64_t rows, int32_t* dev_segs, void* stream) {
  const int64_t max_rows = row_bytes > 0 ? segments_max_rows(segs, n, -1, rows, dev_segs) : -1;
  if (max_rows < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(out, 0, rows * row_bytes, s);
  if (err != cudaSuccess || n == 0) return err;
  return launch_rows(false, out, buf, segs, n, max_rows, row_bytes, dev_segs, s);
}

extern "C" int repro_scatter_rows(void* dst, const void* buf, const int32_t* segs, int64_t n, int64_t row_bytes,
                                  int32_t* dev_segs, void* stream) {
  return segment_entry(false, dst, buf, segs, n, row_bytes, dev_segs, stream);
}

extern "C" int repro_relayout_rows(void* dst, const void* src, const int32_t* segs, int64_t n, int64_t row_bytes,
                                   int32_t* dev_segs, void* stream) {
  return segment_entry(true, dst, src, segs, n, row_bytes, dev_segs, stream);
}

// The most block starts and segments a by-value table holds.
extern "C" int repro_rows_param_starts() { return kParamStarts; }
extern "C" int repro_rows_param_segs() { return kParamSegs; }

extern "C" const char* repro_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
