// Row tables by value in a kernel's parameters, shared by the reshard data
// plane's kernels (reshard_pack.cu, reshard_quant.cu).
//
// A moved row takes microseconds on the device, so the host work around a
// launch decides what a call costs. Every table therefore reaches its kernel
// by value, in a __grid_constant__ struct in the kernel's parameters (up to
// 32,764 bytes from CUDA 12.1 on sm_70 and later): no allocation, no
// host-to-device copy, no event. Two kinds:
//   - RowStarts<CAP>: int32 block starts (block i is block_rows rows at
//     start[i] of the array and at row i*block_rows of the buffer), the
//     counterpart of the Pallas kernels' scalar-prefetch starts;
//   - RowTable<CAP>: int32 segments (src_row, dst_row, rows), each
//     contiguous in both arrays.
// Three size classes of each keep a small call's parameters small. Past the
// last class the entry copies the host table, with one cudaMemcpyAsync on
// the call's stream, from a pinned host buffer into a device table that the
// wrapper keeps per stream, and the kernel reads it there (CAP 0): still one
// launch. The caller keeps the host table until that copy has run and does
// not write the device table before the kernel has read it.
//
// read_start_list reads a Python list of starts straight into the by-value
// starts, so that the host reads the list once. An item that is not an
// integer (a float above all) is refused with kNotInteger, its Python error
// cleared, and the wrapper then raises the port's ValueError naming it, as
// the CPU path does. The wrappers load the libraries into the interpreter
// with ctypes.PyDLL: a call holds the GIL, ctypes raises any Python error the
// call leaves set, and the CPython functions below (stable ABI, declared
// here rather than through Python.h so that the build needs no Python
// headers) resolve against the running interpreter, as an extension
// module's do.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

extern "C" {
typedef struct _object PyObject;
ptrdiff_t PyList_Size(PyObject* list);
PyObject* PyList_GetItem(PyObject* list, ptrdiff_t index);
long long PyLong_AsLongLong(PyObject* obj);
PyObject* PyErr_Occurred(void);
void PyErr_Clear(void);
}

namespace {

// What a kernel's parameters may hold, in bytes.
constexpr size_t kParamBytes = 32764;

// RowStarts<CAP> holds up to CAP int32 block starts by value, RowStarts<0>
// points at them in device memory.
template <int CAP>
struct RowStarts {
  int32_t n;
  int32_t start[CAP];
};

template <>
struct RowStarts<0> {
  int32_t n;
  const int32_t* start;
};

// The size classes of the by-value starts; the last is the capacity. The
// wrappers' PARAM_STARTS (repro_torch/kernels/reshard_pack.py) must equal it.
constexpr int kStartClasses[] = {16, 256, 8160};
constexpr int kParamStarts = kStartClasses[2];

// RowTable<CAP> holds up to CAP int32 triples by value, RowTable<0> points
// at a table in device memory.
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
// wrappers' PARAM_SEGS (repro_torch/kernels/reshard_pack.py) must equal it.
constexpr int kParamClasses[] = {16, 256, 2720};
constexpr int kParamSegs = kParamClasses[2];

// What read_start_list returns for a block that leaves the array, and for an
// item that is not an integer (or past int64); the wrappers name these codes
// _START_OUTSIDE and _NOT_INTEGER.
constexpr int kStartOutside = -1;
constexpr int kNotInteger = -2;

// Reads the n <= kParamStarts items of the Python list `list` into starts,
// each checked on the way: a block of block_rows rows from it lies inside
// the array's rows rows. Returns 0, kStartOutside or kNotInteger (with no
// Python error left set).
inline int read_start_list(PyObject* list, int64_t n, int64_t block_rows, int64_t rows, int32_t* starts) {
  for (int64_t i = 0; i < n; ++i) {
    const long long s = PyLong_AsLongLong(PyList_GetItem(list, i));
    if (s == -1 && PyErr_Occurred() != nullptr) {
      PyErr_Clear();
      return kNotInteger;
    }
    if (s < 0 || s > rows - block_rows) return kStartOutside;
    starts[i] = static_cast<int32_t>(s);
  }
  return 0;
}

// Whether n block starts in host memory are a table the kernels take: every
// block of block_rows rows from a start lies inside the array's rows rows,
// and past the capacity there is a device table.
inline bool starts_valid(const int32_t* starts, int64_t n, int64_t block_rows, int64_t rows, const int32_t* dev) {
  if (n < 0 || block_rows <= 0 || (n > kParamStarts && dev == nullptr)) return false;
  for (int64_t i = 0; i < n; ++i) {
    if (starts[i] < 0 || starts[i] + block_rows > rows) return false;
  }
  return true;
}

// The most rows of n segments in host memory, or -1 if they are not a table
// the kernels take: no negative row, no empty segment, every source row
// below src_rows and every destination row below dst_rows where these are
// >= 0, and past the capacity a device table.
inline int64_t segments_max_rows(const int32_t* segs, int64_t n, int64_t src_rows, int64_t dst_rows,
                                 const int32_t* dev) {
  if (n < 0 || (n > kParamSegs && dev == nullptr)) return -1;
  int64_t max_rows = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t from = segs[3 * i], to = segs[3 * i + 1], rows = segs[3 * i + 2];
    if (from < 0 || to < 0 || rows <= 0) return -1;
    if ((src_rows >= 0 && from + rows > src_rows) || (dst_rows >= 0 && to + rows > dst_rows)) return -1;
    if (rows > max_rows) max_rows = rows;
  }
  return max_rows;
}

template <int CAP, typename Launch>
void starts_by_value(const int32_t* starts, int64_t n, Launch& launch) {
  RowStarts<CAP> t;
  t.n = static_cast<int32_t>(n);
  memcpy(t.start, starts, sizeof(int32_t) * n);
  launch(t);
}

template <int CAP, typename Launch>
void segments_by_value(const int32_t* segs, int64_t n, Launch& launch) {
  RowTable<CAP> t;
  t.n = static_cast<int32_t>(n);
  memcpy(t.seg, segs, sizeof(int32_t) * 3 * n);
  launch(t);
}

// launch(t) with the n host starts in the smallest by-value class that holds
// them (the launch copies the parameters, so the host table may go once this
// returns), or, past the capacity, copied on stream s into dev and read
// there. Returns the copy's error or cudaGetLastError().
template <typename Launch>
cudaError_t with_starts(const int32_t* starts, int64_t n, int32_t* dev, cudaStream_t s, Launch&& launch) {
  if (n <= kStartClasses[0]) {
    starts_by_value<kStartClasses[0]>(starts, n, launch);
  } else if (n <= kStartClasses[1]) {
    starts_by_value<kStartClasses[1]>(starts, n, launch);
  } else if (n <= kParamStarts) {
    starts_by_value<kParamStarts>(starts, n, launch);
  } else {
    const cudaError_t err = cudaMemcpyAsync(dev, starts, sizeof(int32_t) * n, cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return err;
    RowStarts<0> t;
    t.n = static_cast<int32_t>(n);
    t.start = dev;
    launch(t);
  }
  return cudaGetLastError();
}

// The same for n host segments (int32 triples).
template <typename Launch>
cudaError_t with_segments(const int32_t* segs, int64_t n, int32_t* dev, cudaStream_t s, Launch&& launch) {
  if (n <= kParamClasses[0]) {
    segments_by_value<kParamClasses[0]>(segs, n, launch);
  } else if (n <= kParamClasses[1]) {
    segments_by_value<kParamClasses[1]>(segs, n, launch);
  } else if (n <= kParamSegs) {
    segments_by_value<kParamSegs>(segs, n, launch);
  } else {
    const cudaError_t err = cudaMemcpyAsync(dev, segs, sizeof(int32_t) * 3 * n, cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return err;
    RowTable<0> t;
    t.n = static_cast<int32_t>(n);
    t.seg = dev;
    launch(t);
  }
  return cudaGetLastError();
}

}  // namespace
