// Coordinate-wise sorted reduction over the client axis of a client-stacked
// update matrix U [C, D] (f32, row-major), for NVIDIA Hopper (sm_90a):
//   mode 0 (median):  the lower-middle value, sorted row (C-1)/2, per column;
//   mode 1 (trimmed): the mean of sorted rows [t, C-t) per column.
//
// Replaces multimodal_fl_security_tpu/ops/pallas_kernels.py::
// sorted_reduce_pallas (the Pallas TPU kernel of _make_sorted_reduce_kernel):
// the coordinate median, the trimmed mean, the geometric median's Weiszfeld
// start and Bulyan's aggregate all reduce through it (ops/sorted_reduce.py).
//
// What bounds it: on the round's [100, 421,642] U the kernel reads 169 MB
// once (~0.05 ms at the H100 SXM's 3.35 TB/s) but runs a bitonic network of
// 1,792 compare-exchanges per column at a padded C of 128, each two
// shared-memory loads and two stores: ~3e9 shared-memory words, ~0.4 ms at
// 32 words per clock per SM. Shared-memory traffic bounds it, not HBM.
//
// What the design does about it:
//  - Each block stages a tile of 32 columns, all C rows, into shared memory
//    once (a warp reads 32 neighbouring floats of one row: coalesced); U is
//    never padded or copied in HBM, and ragged D edges are masked.
//  - The values are sorted as order-preserving 32-bit keys, so each
//    compare-exchange is one integer min and one max. The key order is
//    torch.sort's: -inf < ... < -0 < +0 < ... < +inf < NaN, and the rows that
//    pad C up to a power of two take a key above NaN, so a pad never sorts
//    ahead of a real value (padding with +inf would put it ahead of a NaN).
//  - Eight warps share each tile: a warp takes every eighth compare-exchange
//    pair of a stage, with its 32 lanes on the 32 columns of one pair of rows
//    (no bank conflicts), and the block synchronises between stages.
//  - The trimmed sum is split the same way: warp g adds rows t+g, t+g+8, ...
//    in f32, and warp 0 adds the eight partials in a fixed order. No atomics,
//    so two calls are bitwise equal.
// The median is the sorted value itself, bit for bit (a NaN comes back as
// the canonical quiet NaN; -0 and +0 are ordered -0 first).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 32;                   // columns per block: one per lane
constexpr int kGroups = 8;                  // warps per block
constexpr int kThreads = kCols * kGroups;   // 256
constexpr int kMaxC = 1024;                 // rows of the largest network
constexpr uint32_t kNanKey = 0xFFFFFFFEu;   // every NaN, after +inf
constexpr uint32_t kPadKey = 0xFFFFFFFFu;   // padding rows, after every NaN

__device__ __forceinline__ uint32_t to_key(float x) {
  if (isnan(x)) return kNanKey;
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  if (k >= kNanKey) return __uint_as_float(0x7FC00000u);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__global__ void __launch_bounds__(kThreads)
sorted_reduce_kernel(const float* __restrict__ u, float* __restrict__ out,
                     int c, int cp, int log_cp, int64_t d, int mode,
                     int trim) {
  extern __shared__ uint32_t keys[];           // [cp][kCols]
  __shared__ float partial[kGroups][kCols];    // trimmed-sum partials
  const int lane = threadIdx.x % kCols;
  const int g = threadIdx.x / kCols;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kCols + lane;
  const bool live = col < d;

  for (int r = g; r < cp; r += kGroups) {
    keys[r * kCols + lane] =
        (live && r < c) ? to_key(__ldg(u + static_cast<int64_t>(r) * d + col))
                        : kPadKey;
  }
  __syncthreads();

  // Bitonic network over cp rows: stage (k, j) compares row i with i + j
  // for every i with bit j clear, ascending where bit k of i is clear.
  const int pairs = cp / 2;
  for (int lk = 1; lk <= log_cp; ++lk) {
    const int k = 1 << lk;
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      for (int p = g; p < pairs; p += kGroups) {
        const int i = ((p >> lj) << (lj + 1)) | (p & (j - 1));
        uint32_t* a = keys + i * kCols + lane;
        uint32_t* b = a + j * kCols;
        const uint32_t x = *a;
        const uint32_t y = *b;
        const uint32_t lo = min(x, y);
        const uint32_t hi = max(x, y);
        const bool ascending = (i & k) == 0;
        *a = ascending ? lo : hi;
        *b = ascending ? hi : lo;
      }
      __syncthreads();
    }
  }

  if (mode == 0) {
    if (g == 0 && live) out[col] = from_key(keys[((c - 1) / 2) * kCols + lane]);
    return;
  }
  float s = 0.f;
  for (int r = trim + g; r < c - trim; r += kGroups) {
    s += from_key(keys[r * kCols + lane]);
  }
  partial[g][lane] = s;
  __syncthreads();
  if (g == 0 && live) {
    float total = 0.f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) total += partial[q][lane];  // fixed order
    out[col] = total / static_cast<float>(c - 2 * trim);
  }
}

}  // namespace

extern "C" {

// Largest C the kernel takes.
int mft_sorted_reduce_max_c() { return kMaxC; }

// out[d] = the median (mode 0) or the trimmed mean over rows [trim, c-trim)
// (mode 1) of each column of u [c, d] (contiguous f32 on `device`), launched
// on `stream`. Returns a cudaError_t: 0 when the launch was accepted.
int mft_sorted_reduce_f32(const float* u, float* out, int c, int64_t d,
                          int mode, int trim, int device, void* stream) {
  if (c <= 0 || c > kMaxC || d <= 0 || (mode != 0 && mode != 1) ||
      (mode == 1 && (trim < 0 || 2 * trim >= c))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int log_cp = 0;
  while ((1 << log_cp) < c) ++log_cp;
  const int cp = 1 << log_cp;
  const size_t smem = static_cast<size_t>(cp) * kCols * sizeof(uint32_t);
  err = cudaFuncSetAttribute(sorted_reduce_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (d + kCols - 1) / kCols;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  sorted_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      u, out, c, cp, log_cp, d, mode, trim);
  return cudaGetLastError();
}

const char* mft_sorted_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
