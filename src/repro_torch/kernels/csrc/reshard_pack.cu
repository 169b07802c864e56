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
//   - scatter_rows_kernel  dst[starts[i] + j]    = buf[i*br + j], in place,
//                          the last block wins where blocks overlap
//   - relayout_rows_kernel dst[starts[i] + j]    = src[starts[i] + j], in place
//   - unpack_rows_kernel   as scatter, into a fresh output whose rows no
//                          block covers are zero-filled (as the reference)
//
// What bounds them on the H100: they are byte copies, so HBM bandwidth,
// reading each moved byte once and writing it once (3.35 TB/s). The design:
//   - a copy is a list of segments of whole rows, each contiguous in both
//     arrays; blockIdx.y walks the segments and the x dimension of the grid
//     strides over one segment's bytes, so one long run (a contiguous row
//     range of hundreds of MB) and thousands of short ones (scattered
//     single rows) both fill the card;
//   - every segment is copied in 16-byte units when both addresses and its
//     length allow, else in the widest of 8/4/2/1 bytes that does, so the
//     kernels take any dtype and any row pitch; offsets are 64-bit;
//   - the TPU grid runs in order, so a repeated start resolves to the last
//     block there; a CUDA grid does not. The wrapper
//     (repro_torch/kernels/reshard_pack.py) resolves the last writer of
//     every destination row on the host before the launch and passes
//     segments that never write one row twice, so repeated and overlapping
//     starts give the reference's sequential result and no two threads
//     write one byte.
// The wrapper checks shapes, types, devices and the range of every start,
// allocates outputs and the segment table, and passes torch's current
// stream. Speed work (TMA bulk copies, fewer launches per batch) is later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
constexpr int64_t kFillBlocks = 132 * 16;  // 16 blocks of 256 threads per SM

template <typename T>
__device__ __forceinline__ void copy_units(char* dst, const char* src, int64_t n) {
  T* d = reinterpret_cast<T*>(dst);
  const T* s = reinterpret_cast<const T*>(src);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s != nullptr) {
    for (; i < n; i += stride) d[i] = s[i];
  } else {
    const T zero{};
    for (; i < n; i += stride) d[i] = zero;
  }
}

// This block's share of copying nbytes from src to dst (src == nullptr:
// write zeros), in the widest unit that divides both addresses and nbytes.
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

// pack: segment i is block i of the output, read from row starts[i] of src.
__global__ void pack_rows_kernel(char* __restrict__ out, const char* __restrict__ src,
                                 const int64_t* __restrict__ starts, int64_t nb, int64_t block_rows,
                                 int64_t row_bytes) {
  const int64_t block_bytes = block_rows * row_bytes;
  for (int64_t i = blockIdx.y; i < nb; i += gridDim.y) {
    copy_span(out + i * block_bytes, src + starts[i] * row_bytes, block_bytes);
  }
}

// The other three take segments (src_row, dst_row, rows) as int64 triples.
__global__ void scatter_rows_kernel(char* __restrict__ dst, const char* __restrict__ buf,
                                    const int64_t* __restrict__ segs, int64_t n, int64_t row_bytes) {
  for (int64_t i = blockIdx.y; i < n; i += gridDim.y) {
    const int64_t* g = segs + 3 * i;
    copy_span(dst + g[1] * row_bytes, buf + g[0] * row_bytes, g[2] * row_bytes);
  }
}

// relayout: the same rows of two arrays (src_row == dst_row in every segment).
// Not __restrict__: a destination adopted from its source may be the source.
__global__ void relayout_rows_kernel(char* dst, const char* src,
                                     const int64_t* __restrict__ segs, int64_t n,
                                     int64_t row_bytes) {
  for (int64_t i = blockIdx.y; i < n; i += gridDim.y) {
    const int64_t* g = segs + 3 * i;
    copy_span(dst + g[1] * row_bytes, src + g[0] * row_bytes, g[2] * row_bytes);
  }
}

// unpack: the segments cover every output row once; src_row < 0 zero-fills.
__global__ void unpack_rows_kernel(char* __restrict__ out, const char* __restrict__ buf,
                                   const int64_t* __restrict__ segs, int64_t n, int64_t row_bytes) {
  for (int64_t i = blockIdx.y; i < n; i += gridDim.y) {
    const int64_t* g = segs + 3 * i;
    const char* from = g[0] < 0 ? nullptr : buf + g[0] * row_bytes;
    copy_span(out + g[1] * row_bytes, from, g[2] * row_bytes);
  }
}

// Grid for n segments of at most max_seg_bytes: y over segments, x enough
// blocks to fill the card, but none that would find no 16-byte unit to copy.
dim3 grid_for(int64_t n, int64_t max_seg_bytes) {
  const int64_t y = n < kMaxGridY ? n : kMaxGridY;
  const int64_t units = (max_seg_bytes + 15) / 16;
  int64_t x = (units + kThreads - 1) / kThreads;
  const int64_t fill = (kFillBlocks + y - 1) / y;
  if (x > fill) x = fill;
  if (x < 1) x = 1;
  return dim3(static_cast<unsigned>(x), static_cast<unsigned>(y), 1);
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (0 on success); n == 0 launches nothing.

extern "C" int repro_pack_rows(void* out, const void* src, const int64_t* starts, int64_t nb,
                               int64_t block_rows, int64_t row_bytes, void* stream) {
  if (nb < 0 || block_rows <= 0 || row_bytes <= 0) return cudaErrorInvalidValue;
  if (nb == 0) return 0;
  pack_rows_kernel<<<grid_for(nb, block_rows * row_bytes), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(out), static_cast<const char*>(src), starts, nb, block_rows, row_bytes);
  return cudaGetLastError();
}

extern "C" int repro_scatter_rows(void* dst, const void* buf, const int64_t* segs, int64_t n,
                                  int64_t max_seg_rows, int64_t row_bytes, void* stream) {
  if (n < 0 || max_seg_rows <= 0 || row_bytes <= 0) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  scatter_rows_kernel<<<grid_for(n, max_seg_rows * row_bytes), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(dst), static_cast<const char*>(buf), segs, n, row_bytes);
  return cudaGetLastError();
}

extern "C" int repro_relayout_rows(void* dst, const void* src, const int64_t* segs, int64_t n,
                                   int64_t max_seg_rows, int64_t row_bytes, void* stream) {
  if (n < 0 || max_seg_rows <= 0 || row_bytes <= 0) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  relayout_rows_kernel<<<grid_for(n, max_seg_rows * row_bytes), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(dst), static_cast<const char*>(src), segs, n, row_bytes);
  return cudaGetLastError();
}

extern "C" int repro_unpack_rows(void* out, const void* buf, const int64_t* segs, int64_t n,
                                 int64_t max_seg_rows, int64_t row_bytes, void* stream) {
  if (n < 0 || max_seg_rows <= 0 || row_bytes <= 0) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  unpack_rows_kernel<<<grid_for(n, max_seg_rows * row_bytes), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(out), static_cast<const char*>(buf), segs, n, row_bytes);
  return cudaGetLastError();
}

extern "C" const char* repro_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
