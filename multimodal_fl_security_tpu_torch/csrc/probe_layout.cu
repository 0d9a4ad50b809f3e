// One strided gather for every layout probe of the Mosaic probe set and for
// the roll of the autodiff probes, for NVIDIA Hopper (sm_90a).
//
// Replaces the layout kernels of benchmarks/mosaic_probe.py (K5: split and
// merge reshapes, row and lane rolls, the iota-masked select, lane slices
// read and written, the major-axis transpose, the major broadcast and the
// lane-slice concatenation; `_call` at :53-54) and the roll of
// benchmarks/ad_in_kernel_probe.py (K6, `droll` at :67-80, whose backward
// is the opposite roll).
//
// out[i0, .., i4] walks an index space of up to five axes, last axis
// fastest, and is written contiguous. Along axis d the source coordinate is
//   t = i + shift, taken modulo `period` when period > 0 (a roll),
// and the source element sits at   start*stride + t*stride   from the base
// pointer (stride 0 broadcasts; two output axes may walk one source axis at
// two scales, which splits it). The element is written as it is when every
// axis has t < limit (limit < 0: no limit; the zero-fill of a slice write)
// and its output index i passes the axis' predicate  lo <= i % mod < hi
// (mod 0: always; the iota-masked select); otherwise it is written as 0.
//
// What bounds it: nothing but bytes. Each output element is one load and one
// store; the probes move at most 1.8 MB, so launch latency bounds them all.
// Elements are copied as raw 2- or 4-byte words, so the result is bitwise the
// source's: layout probes are held exactly.

#include <cuda_runtime.h>

#include <cstdint>

// The spec crosses the C interface, so it lives outside the anonymous
// namespace (a type with internal linkage would hide mft_gather).
constexpr int kMaxAxes = 5;

struct GatherAxis {
  long long n;       // output extent
  long long stride;  // source stride in elements (0 broadcasts)
  long long start;   // source start along this axis, in units of stride
  long long shift;   // added to the output index
  long long period;  // roll modulus; 0 for none
  long long limit;   // source coordinates >= limit read as 0; < 0 for none
  long long mod, lo, hi;  // keep iff lo <= i % mod < hi; mod 0 for always
};

struct GatherSpec {
  GatherAxis ax[kMaxAxes];
  long long total;
  int ndim;
  int pad_;
};

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ src, T* __restrict__ out, GatherSpec s) {
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < s.total; e += static_cast<long long>(gridDim.x) * kThreads) {
    long long rest = e;
    long long off = 0;
    bool live = true;
    for (int d = s.ndim - 1; d >= 0; --d) {
      const GatherAxis& a = s.ax[d];
      const long long i = rest % a.n;
      rest /= a.n;
      long long t = i + a.shift;
      if (a.period > 0) t = ((t % a.period) + a.period) % a.period;
      if (a.limit >= 0 && t >= a.limit) live = false;
      if (a.mod > 0) {
        const long long r = i % a.mod;
        if (r < a.lo || r >= a.hi) live = false;
      }
      off += (a.start + t) * a.stride;
    }
    out[e] = live ? src[off] : T(0);
  }
}

}  // namespace

extern "C" {

// src and out are device pointers; elem_bytes is 2 or 4.
int mft_gather(const void* src, void* out, const GatherSpec* spec,
               int elem_bytes, int device, void* stream) {
  if (spec->ndim < 1 || spec->ndim > kMaxAxes || spec->total <= 0 ||
      (elem_bytes != 2 && elem_bytes != 4)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long want = (spec->total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  auto st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    gather_kernel<uint32_t><<<blocks, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(src), static_cast<uint32_t*>(out), *spec);
  } else {
    gather_kernel<uint16_t><<<blocks, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(src), static_cast<uint16_t*>(out), *spec);
  }
  return cudaGetLastError();
}

const char* mft_probe_layout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
