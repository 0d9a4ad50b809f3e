// The reductions, selects and carried state of the Mosaic probe set and the
// autodiff probes, for NVIDIA Hopper (sm_90a).
//
// Replaces these kernels of benchmarks/mosaic_probe.py (K5, `_call` at
// :53-54 and the inline calls at :310 and :528) and of benchmarks/
// ad_in_kernel_probe.py (K6, `_call` at :60-61):
//  - masked_ce: the masked softmax cross-entropy of softmax_masked and of
//    ad_softmax_ce, with its gradient (softmax * sum(onehot) - onehot) on the
//    valid lanes, times a per-row upstream gradient. One warp
//    per row; max and sums by a fixed xor-shuffle tree.
//  - max2 / max2_bwd: the elementwise maximum of two strided views (the
//    i-pair max of sublane_pool_reshape, the lane max of the pools) and its
//    backward, which splits a tie's gradient equally between the two sides,
//    as JAX's `maximum` and `reduce_max` VJPs do (`torch.max(dim)` would
//    give it all to one side). The maximum is JAX's, bit for bit: a NaN
//    operand is the result (the first if both are), and +0 is above -0.
//    max2 takes f32 only, with 32-bit index arithmetic, on two
//    routes the wrapper chooses before the launch: rows of float4 where the
//    last axis has stride 1 and every row starts 16-byte aligned (the
//    probe's halves, 4 KB apart), one element a thread otherwise. Its
//    launch arguments come packed in one buffer of integers
//    (mft_max2_packed), and the device is made current only when it is
//    not: the wrapper's host work, not the device, bounds a call.
//  - relu_mask / relu_mask_bwd: relu(x) times an iota predicate on one axis
//    (lo <= i % mod < hi), and its backward g * (x > 0) * predicate.
//  - block_fold: out[i, j] = sum_b x[b * brow + i, b * bcol + j], added in b
//    order from 0 (selector_matmul_fold's sum of diagonal blocks).
//  - carry_sum: grid_scratch_persist. One block per client loops over the S
//    steps with the accumulator in registers: the Hopper form of a scratch
//    buffer carried across the sequential grid axis.
//  - scalar_accum: scalar_accum_smem. One block; per step a fixed-order tree
//    sum of the step's elements in shared memory, added to a scalar that
//    stays in shared memory across the steps.
//
// What bounds them: every probe shape is under 1 MB and a few thousand
// operations per row, so launch latency does. Each sum runs in a fixed order,
// so two calls are bitwise equal; carry_sum and block_fold add in the JAX
// kernel's own order.

#include <math_constants.h>

#include "client_common.cuh"

// The extents cross the C interface, so they live outside the anonymous
// namespace (a type with internal linkage would hide the entry points).
struct Dims5 {
  long long n[5];
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Output index e split over the five extents, last axis fastest.
__device__ __forceinline__ void split5(long long e, const Dims5& d,
                                       long long (&i)[5]) {
#pragma unroll
  for (int k = 4; k >= 0; --k) {
    i[k] = e % d.n[k];
    e /= d.n[k];
  }
}

__device__ __forceinline__ long long off5(const MftView& v,
                                          const long long (&i)[5]) {
  return mft_off(v, i[0], i[1], i[2], i[3], i[4]);
}

__host__ __device__ __forceinline__ long long total5(const Dims5& d) {
  return d.n[0] * d.n[1] * d.n[2] * d.n[3] * d.n[4];
}

#define MFT_GRID_STRIDE(e, total)                                          \
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +       \
                     threadIdx.x;                                          \
       e < (total); e += static_cast<long long>(gridDim.x) * kThreads)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// z, onehot, dz: (row, lane); labels, rowgrad: (row). Masked lanes
// (lane >= nvalid) read as -1e30, as the probes' jnp.where does.
__global__ void __launch_bounds__(kThreads)
masked_ce_kernel(MftView z, MftView labels, MftView onehot, MftView rowgrad,
                 float* nll, MftView dz, int rows, int lanes, int nvalid) {
  const int warp = threadIdx.x / 32;
  const int ln = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= rows) return;
  const int label = labels.ptr != nullptr
                        ? static_cast<int>(mft_ld(labels, mft_off(labels, r, 0,
                                                                   0, 0, 0)))
                        : -1;
  auto val = [&](int l) {
    return l < nvalid ? mft_ld(z, mft_off(z, r, l, 0, 0, 0)) : -1e30f;
  };
  auto oh = [&](int l) {
    return onehot.ptr != nullptr
               ? mft_ld(onehot, mft_off(onehot, r, l, 0, 0, 0))
               : (l == label ? 1.f : 0.f);
  };
  float m = -CUDART_INF_F;
  for (int l = ln; l < lanes; l += 32) m = fmaxf(m, val(l));
  m = warp_max(m);
  float s = 0.f, ohs = 0.f, ohz = 0.f;
  for (int l = ln; l < lanes; l += 32) {
    const float v = val(l);
    const float o = oh(l);
    s += expf(v - m);
    ohs += o;
    ohz += o * v;
  }
  s = warp_sum(s);
  ohs = warp_sum(ohs);
  ohz = warp_sum(ohz);
  const float lse = m + logf(s);
  if (nll != nullptr && ln == 0) nll[r] = lse * ohs - ohz;
  if (dz.ptr == nullptr) return;
  const float g = rowgrad.ptr != nullptr
                      ? mft_ld(rowgrad, mft_off(rowgrad, r, 0, 0, 0, 0))
                      : 1.f;
  for (int l = ln; l < lanes; l += 32) {
    const float d = l < nvalid ? g * (expf(val(l) - lse) * ohs - oh(l)) : 0.f;
    mft_st(dz, mft_off(dz, r, l, 0, 0, 0), d);
  }
}

// max2's index space: five extents (the last fastest) and the two
// operands' strides, in elements; the output is dense.
struct Max2Dims {
  int n[5], sa[5], sb[5];
};

// JAX's maximum: a NaN operand wins, the first if both are; of two equal
// values the one without the sign bit (+0 above -0).
__device__ __forceinline__ float max2_of(float x, float y) {
  const bool take_x =
      x != x ||
      (y == y && (x > y || (x == y && !(__float_as_uint(x) >> 31))));
  return take_x ? x : y;
}

// Offsets in a and b of element r * n4 + j, row r over the leading axes.
__device__ __forceinline__ void max2_offsets(const Max2Dims& d, int r, int j,
                                             int& oa, int& ob) {
  oa = j * d.sa[4];
  ob = j * d.sb[4];
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    const int i = r % d.n[k];
    r /= d.n[k];
    oa += i * d.sa[k];
    ob += i * d.sb[k];
  }
}

// The rows route: the last axis at stride 1 with an extent that is a
// multiple of 4, every row 16-byte aligned in a and b; a float4 a thread.
__global__ void __launch_bounds__(kThreads)
max2_rows_kernel(const float* a, const float* b, float4* out, Max2Dims d,
                 int total4) {
  const int q = d.n[4] / 4;  // float4s a row
  for (int u = blockIdx.x * kThreads + threadIdx.x; u < total4;
       u += gridDim.x * kThreads) {
    const int r = u / q;
    int oa, ob;
    max2_offsets(d, r, 4 * (u - r * q), oa, ob);
    const float4 x = *reinterpret_cast<const float4*>(a + oa);
    const float4 y = *reinterpret_cast<const float4*>(b + ob);
    out[u] = make_float4(max2_of(x.x, y.x), max2_of(x.y, y.y),
                         max2_of(x.z, y.z), max2_of(x.w, y.w));
  }
}

// Any strides: one element a thread.
__global__ void __launch_bounds__(kThreads)
max2_any_kernel(const float* a, const float* b, float* out, Max2Dims d,
                int total) {
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < total;
       e += gridDim.x * kThreads) {
    const int r = e / d.n[4];
    int oa, ob;
    max2_offsets(d, r, e - r * d.n[4], oa, ob);
    out[e] = max2_of(a[oa], b[ob]);
  }
}

__global__ void __launch_bounds__(kThreads)
max2_bwd_kernel(MftView a, MftView b, MftView g, MftView ga, MftView gb,
                Dims5 d) {
  MFT_GRID_STRIDE(e, total5(d)) {
    long long i[5];
    split5(e, d, i);
    const float x = mft_ld(a, off5(a, i));
    const float y = mft_ld(b, off5(b, i));
    const float gv = mft_ld(g, off5(g, i));
    const float tie = 0.5f * gv;
    mft_st(ga, off5(ga, i), x > y ? gv : (x == y ? tie : 0.f));
    mft_st(gb, off5(gb, i), y > x ? gv : (x == y ? tie : 0.f));
  }
}

// bwd == 0: out = relu(x) * keep(i[axis]); bwd == 1: out = g where x > 0 and
// keep, else 0.
__global__ void __launch_bounds__(kThreads)
relu_mask_kernel(MftView x, MftView g, MftView out, Dims5 d, int axis,
                 long long mod, long long lo, long long hi, int bwd) {
  MFT_GRID_STRIDE(e, total5(d)) {
    long long i[5];
    split5(e, d, i);
    bool keep = true;
    if (mod > 0) {
      const long long r = i[axis] % mod;
      keep = r >= lo && r < hi;
    }
    const float v = mft_ld(x, off5(x, i));
    float o;
    if (bwd) {
      o = (keep && v > 0.f) ? mft_ld(g, off5(g, i)) : 0.f;
    } else {
      o = (keep && v > 0.f) ? v : 0.f;
    }
    mft_st(out, off5(out, i), o);
  }
}

__global__ void __launch_bounds__(kThreads)
block_fold_kernel(MftView x, MftView out, int rows, int cols, int nb,
                  int brow, int bcol) {
  MFT_GRID_STRIDE(e, static_cast<long long>(rows) * cols) {
    const int i = static_cast<int>(e / cols);
    const int j = static_cast<int>(e % cols);
    float acc = 0.f;
    for (int blk = 0; blk < nb; ++blk) {
      acc += mft_ld(x, mft_off(x, blk * brow + i, blk * bcol + j, 0, 0, 0));
    }
    mft_st(out, mft_off(out, i, j, 0, 0, 0), acc);
  }
}

// x: (client, step, element); out: (client, element).
__global__ void __launch_bounds__(kThreads)
carry_sum_kernel(MftView x, MftView out, int steps, int elems) {
  const int c = blockIdx.x;
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    float acc = 0.f;  // the carried scratch, one register per element
    for (int s = 0; s < steps; ++s) acc += mft_ld(x, mft_off(x, c, s, e, 0, 0));
    mft_st(out, mft_off(out, c, e, 0, 0, 0), acc);
  }
}

// x: (step, element); one block.
__global__ void __launch_bounds__(kThreads)
scalar_accum_kernel(MftView x, float* out, int steps, int elems) {
  __shared__ float part[kThreads];
  __shared__ float acc;  // the scalar carried across the steps
  const int t = threadIdx.x;
  if (t == 0) acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    float p = 0.f;
    for (int e = t; e < elems; e += kThreads) {
      p += mft_ld(x, mft_off(x, s, e, 0, 0, 0));
    }
    part[t] = p;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (t < w) part[t] += part[t + w];
      __syncthreads();
    }
    if (t == 0) acc += part[0];
    __syncthreads();
  }
  if (t == 0) out[0] = acc;
}

int blocks_for(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return static_cast<int>(want < 4096 ? (want > 0 ? want : 1) : 4096);
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

int mft_masked_ce(const MftView* z, const MftView* labels,
                  const MftView* onehot, const MftView* rowgrad, float* nll,
                  const MftView* dz, int rows, int lanes, int nvalid,
                  int device, void* stream) {
  if (rows <= 0 || lanes <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  masked_ce_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                     as_stream(stream)>>>(*z, *labels, *onehot, *rowgrad, nll,
                                          *dz, rows, lanes, nvalid);
  return cudaGetLastError();
}

// max2 from one packed buffer p: the addresses of a, b and the dense f32
// output, the five extents, a's five strides and b's (elements); rows = 1
// takes the rows route. A call whose extents or offsets pass 32 bits, or
// that the route does not take, is refused.
int mft_max2_packed(const long long* p, int rows, int device, void* stream) {
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
  }
  const float* a = reinterpret_cast<const float*>(p[0]);
  const float* b = reinterpret_cast<const float*>(p[1]);
  Max2Dims d;
  long long total = 1, last_a = 0, last_b = 0;  // the last elements' offsets
  for (int k = 0; k < 5; ++k) {
    if (p[3 + k] <= 0 || p[8 + k] < 0 || p[13 + k] < 0) {
      return cudaErrorInvalidValue;
    }
    d.n[k] = static_cast<int>(p[3 + k]);
    d.sa[k] = static_cast<int>(p[8 + k]);
    d.sb[k] = static_cast<int>(p[13 + k]);
    total *= p[3 + k];
    last_a += (p[3 + k] - 1) * p[8 + k];
    last_b += (p[3 + k] - 1) * p[13 + k];
  }
  constexpr long long kMax = 0x7fffffffLL;
  if (total > kMax || last_a > kMax || last_b > kMax) {
    return cudaErrorInvalidValue;
  }
  const int n = static_cast<int>(total);
  if (rows) {
    bool takes = d.sa[4] == 1 && d.sb[4] == 1 && d.n[4] % 4 == 0 &&
                 (p[0] | p[1] | p[2]) % 16 == 0;
    for (int k = 0; k < 4; ++k) {
      takes = takes && d.sa[k] % 4 == 0 && d.sb[k] % 4 == 0;
    }
    if (!takes) return cudaErrorInvalidValue;
    max2_rows_kernel<<<blocks_for(n / 4), kThreads, 0, as_stream(stream)>>>(
        a, b, reinterpret_cast<float4*>(p[2]), d, n / 4);
  } else {
    max2_any_kernel<<<blocks_for(n), kThreads, 0, as_stream(stream)>>>(
        a, b, reinterpret_cast<float*>(p[2]), d, n);
  }
  return cudaGetLastError();
}

int mft_max2_bwd(const MftView* a, const MftView* b, const MftView* g,
                 const MftView* ga, const MftView* gb, const Dims5* d,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  max2_bwd_kernel<<<blocks_for(total5(*d)), kThreads, 0,
                    as_stream(stream)>>>(*a, *b, *g, *ga, *gb, *d);
  return cudaGetLastError();
}

int mft_relu_mask(const MftView* x, const MftView* g, const MftView* out,
                  const Dims5* d, int axis, long long mod, long long lo,
                  long long hi, int bwd, int device, void* stream) {
  if (axis < 0 || axis > 4) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  relu_mask_kernel<<<blocks_for(total5(*d)), kThreads, 0,
                     as_stream(stream)>>>(*x, *g, *out, *d, axis, mod, lo, hi,
                                          bwd);
  return cudaGetLastError();
}

int mft_block_fold(const MftView* x, const MftView* out, int rows, int cols,
                   int nb, int brow, int bcol, int device, void* stream) {
  if (rows <= 0 || cols <= 0 || nb <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  block_fold_kernel<<<blocks_for(static_cast<long long>(rows) * cols),
                      kThreads, 0, as_stream(stream)>>>(*x, *out, rows, cols,
                                                        nb, brow, bcol);
  return cudaGetLastError();
}

int mft_carry_sum(const MftView* x, const MftView* out, int clients,
                  int steps, int elems, int device, void* stream) {
  if (clients <= 0 || steps <= 0 || elems <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  carry_sum_kernel<<<clients, kThreads, 0, as_stream(stream)>>>(*x, *out,
                                                                 steps, elems);
  return cudaGetLastError();
}

int mft_scalar_accum(const MftView* x, float* out, int steps, int elems,
                     int device, void* stream) {
  if (steps <= 0 || elems <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  scalar_accum_kernel<<<1, kThreads, 0, as_stream(stream)>>>(*x, out, steps,
                                                              elems);
  return cudaGetLastError();
}

const char* mft_probe_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
