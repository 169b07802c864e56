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
//     strides over one segment's bytes. x is fitted to the longest segment
//     and to the card (kFillBlocks over the y segments), so one long run (a
//     contiguous row range of hundreds of MB) and thousands of short ones
//     (scattered single rows) both fill the SMs;
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
//
// What bounds a call, as opposed to the kernel: the host work around the
// launch (a moved cache row takes ~5 us on the device). So scatter_rows and
// relayout_rows take their segment table (int32 triples; the wrapper merges
// runs, so a contiguous run is one segment) by value, in a
// __grid_constant__ struct in the kernel's parameters (up to 32,764 bytes
// from CUDA 12.1 on sm_70 and later): no allocation, no host-to-device copy,
// no event. Three size classes (kParamClasses) keep a one-segment call's
// parameters small. A table of more than kParamSegs segments is copied by
// the entry, with one cudaMemcpyAsync on the call's stream, from a pinned
// host buffer into a device table that the wrapper keeps per stream, and
// read from there: still one launch. pack_rows and unpack_rows still take an
// int64 table in device memory that the wrapper copies.
// The wrapper checks shapes, types, devices and the range of every start,
// allocates outputs and tables, and passes torch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// scatter and relayout take segments (src_row, dst_row, rows) as int32
// triples in a RowTable: RowTable<CAP> holds up to CAP of them by value,
// RowTable<0> points at a table in device memory.
template <int CAP>
struct RowTable {
  int32_t n;
  int32_t seg[3 * CAP];
};

template <>
struct RowTable<0> {
  int32_t n;
  const int32_t* seg;
};

// The size classes of the by-value table; the last is the capacity. The
// wrapper's PARAM_SEGS (repro_torch/kernels/reshard_pack.py) must equal it.
constexpr int kParamClasses[] = {16, 256, 2720};
constexpr int kParamSegs = kParamClasses[2];
// The parameters: two pointers, row_bytes and the table.
static_assert(3 * sizeof(int64_t) + sizeof(RowTable<kParamSegs>) <= 32764,
              "the by-value table exceeds the 32,764 bytes of kernel parameters");

template <int CAP>
__global__ void scatter_rows_kernel(char* __restrict__ dst, const char* __restrict__ buf, int64_t row_bytes,
                                    const __grid_constant__ RowTable<CAP> t) {
  for (int64_t i = blockIdx.y; i < t.n; i += gridDim.y) {
    const int64_t from = t.seg[3 * i], to = t.seg[3 * i + 1], rows = t.seg[3 * i + 2];
    copy_span(dst + to * row_bytes, buf + from * row_bytes, rows * row_bytes);
  }
}

// relayout: the same rows of two arrays (src_row == dst_row in every segment).
// Not __restrict__: a destination adopted from its source may be the source.
template <int CAP>
__global__ void relayout_rows_kernel(char* dst, const char* src, int64_t row_bytes,
                                     const __grid_constant__ RowTable<CAP> t) {
  for (int64_t i = blockIdx.y; i < t.n; i += gridDim.y) {
    const int64_t from = t.seg[3 * i], to = t.seg[3 * i + 1], rows = t.seg[3 * i + 2];
    copy_span(dst + to * row_bytes, src + from * row_bytes, rows * row_bytes);
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

template <int CAP>
void launch_table(bool relayout, dim3 grid, cudaStream_t stream, char* dst, const char* src,
                  int64_t row_bytes, const RowTable<CAP>& t) {
  if (relayout) {
    relayout_rows_kernel<CAP><<<grid, kThreads, 0, stream>>>(dst, src, row_bytes, t);
  } else {
    scatter_rows_kernel<CAP><<<grid, kThreads, 0, stream>>>(dst, src, row_bytes, t);
  }
}

// The by-value form: the table is copied into the parameters of the
// smallest class that holds it; the launch copies the parameters, so segs
// may go once this returns.
template <int CAP>
void launch_by_value(bool relayout, dim3 grid, cudaStream_t stream, char* dst, const char* src,
                     int64_t row_bytes, const int32_t* segs, int64_t n) {
  RowTable<CAP> t;
  t.n = static_cast<int32_t>(n);
  memcpy(t.seg, segs, sizeof(int32_t) * 3 * n);
  launch_table<CAP>(relayout, grid, stream, dst, src, row_bytes, t);
}

// segs: n int32 triples in host memory. n <= kParamSegs: by value (dev_segs
// unused). Larger: segs must be pinned; one cudaMemcpyAsync on `stream`
// copies it into dev_segs (room for 3n int32), then the kernel reads it
// there. The caller keeps segs until that copy has run and does not write
// dev_segs before the kernel has read it (one device table per stream).
int launch_rows(bool relayout, void* dst, const void* src, const int32_t* segs, int64_t n,
                int64_t row_bytes, int32_t* dev_segs, void* stream) {
  if (n < 0 || row_bytes <= 0 || (n > kParamSegs && dev_segs == nullptr)) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  int64_t max_rows = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t from = segs[3 * i], to = segs[3 * i + 1], rows = segs[3 * i + 2];
    if (from < 0 || to < 0 || rows <= 0) return cudaErrorInvalidValue;
    if (rows > max_rows) max_rows = rows;
  }
  const dim3 grid = grid_for(n, max_rows * row_bytes);
  const auto s = static_cast<cudaStream_t>(stream);
  char* d = static_cast<char*>(dst);
  const char* f = static_cast<const char*>(src);
  if (n <= kParamClasses[0]) {
    launch_by_value<kParamClasses[0]>(relayout, grid, s, d, f, row_bytes, segs, n);
  } else if (n <= kParamClasses[1]) {
    launch_by_value<kParamClasses[1]>(relayout, grid, s, d, f, row_bytes, segs, n);
  } else if (n <= kParamSegs) {
    launch_by_value<kParamSegs>(relayout, grid, s, d, f, row_bytes, segs, n);
  } else {
    const cudaError_t err = cudaMemcpyAsync(dev_segs, segs, sizeof(int32_t) * 3 * n, cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return err;
    RowTable<0> t;
    t.n = static_cast<int32_t>(n);
    t.seg = dev_segs;
    launch_table<0>(relayout, grid, s, d, f, row_bytes, t);
  }
  return cudaGetLastError();
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

extern "C" int repro_scatter_rows(void* dst, const void* buf, const int32_t* segs, int64_t n,
                                  int64_t row_bytes, int32_t* dev_segs, void* stream) {
  return launch_rows(false, dst, buf, segs, n, row_bytes, dev_segs, stream);
}

extern "C" int repro_relayout_rows(void* dst, const void* src, const int32_t* segs, int64_t n,
                                   int64_t row_bytes, int32_t* dev_segs, void* stream) {
  return launch_rows(true, dst, src, segs, n, row_bytes, dev_segs, stream);
}

// The most segments a by-value table holds.
extern "C" int repro_rows_param_segs() { return kParamSegs; }

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
