// One batched strided contraction for every dot of the Mosaic probe set and
// the autodiff probes, for NVIDIA Hopper (sm_90a):
//
//   C[b, m, n] = sum_k A[b, m, k] * B[b, k, n]
//
// Replaces the dot_general kernels of benchmarks/mosaic_probe.py (K5:
// dot_3d_2d, einsum_brl_rlf, batched_dot, outer_wgrad, wgrad_2d,
// outer_wgrad_chunked, the dgrad_rhs_T forms and the bf16 dots; `_call` at
// :53-54, the chunked grid at :396) and of benchmarks/
// ad_in_kernel_probe.py (K6: the batched dot and the 2-D weight gradient,
// forward and both backward products).
//
// Every operand is a strided view: A by (batch, m, k), B by (batch, k, n), C
// by (batch, m, n), and the k axis of A and B may be two axes merged
// (k = ko * kin + ki, each with its own stride), so the transposed-rhs forms,
// einsum_brl_rlf's (r, l) pair and outer_wgrad's contraction over the batch
// axis are read in place, with no copy. A batch stride of 0 reuses an
// operand; the batch axis is the grid's outer axis, which is how
// outer_wgrad_chunked's seven r-chunks run. Operands are f32 or bf16 (their
// products are exact in f32, so Mosaic's HIGHEST and DEFAULT precisions are
// one product here); sums are f32, over k in a fixed order, so two calls are
// bitwise equal.
//
// A block computes a 32 x 32 tile of C, staging 32-deep slices of A and B in
// shared memory, as client_dense.cu does; f32 FMA on the CUDA cores. What
// bounds it: the largest probe, dgrad_rhs_T_big, is 1.06 GFLOP, 0.016 ms at
// the f32 rate and 11 MB of operands (0.003 ms); the others are launch
// latency. Shared-memory reads (two words per FMA) bound the big one here.

#include "client_common.cuh"

// The operands cross the C interface, so they live outside the anonymous
// namespace (a type with internal linkage would hide mft_contract).
// A strided operand: `x` is m for A, n for B and C; ko and ki split k.
struct Operand {
  const void* ptr;
  long long sb, sx, sko, ski;
  int dtype;
  int pad_;
};

struct Output {
  float* ptr;
  long long sb, sm, sn;
};

namespace {

constexpr int kTile = 32;
constexpr int kPad = kTile + 1;
constexpr int kThreads = 256;

__device__ __forceinline__ float ld(const Operand& o, long long off) {
  return o.dtype == kBF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(o.ptr)[off])
             : static_cast<const float*>(o.ptr)[off];
}

__device__ __forceinline__ long long k_off(const Operand& o, int k, int kin) {
  return static_cast<long long>(k / kin) * o.sko +
         static_cast<long long>(k % kin) * o.ski;
}

__global__ void __launch_bounds__(kThreads)
contract_kernel(Operand a, Operand b, Output c, int m, int n, int k,
                int kin) {
  __shared__ float as[kTile][kPad];  // [m][k]
  __shared__ float bs[kTile][kPad];  // [k][n]
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  const long long bat = blockIdx.z;
  const int t = threadIdx.x;
  const int row = t / 8;
  const int nq = (t % 8) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < k; k0 += kTile) {
    for (int i = t; i < kTile * kTile; i += kThreads) {
      const int r = i / kTile;
      const int kk = i % kTile;
      const bool in_k = k0 + kk < k;
      as[r][kk] = (in_k && m0 + r < m)
                      ? ld(a, bat * a.sb + (m0 + r) * a.sx +
                                  k_off(a, k0 + kk, kin))
                      : 0.f;
      // B's tile: element i is (k row i / 32, n column i % 32), so
      // neighbouring threads read neighbouring n.
      const int kb = i / kTile;
      const int nn = i % kTile;
      bs[kb][nn] = (k0 + kb < k && n0 + nn < n)
                       ? ld(b, bat * b.sb + (n0 + nn) * b.sx +
                                   k_off(b, k0 + kb, kin))
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float av = as[row][kk];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(av, bs[kk][nq + q], acc[q]);
    }
    __syncthreads();
  }
  if (m0 + row >= m) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int no = n0 + nq + q;
    if (no < n) {
      c.ptr[bat * c.sb + (m0 + row) * c.sm + no * c.sn] = acc[q];
    }
  }
}

}  // namespace

extern "C" {

int mft_contract(const Operand* a, const Operand* b, const Output* c,
                 int batch, int m, int n, int k, int kin, int device,
                 void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k <= 0 || kin <= 0 || k % kin != 0 ||
      batch > 65535 || (m + kTile - 1) / kTile > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, batch);
  contract_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *a, *b, *c, m, n, k, kin);
  return cudaGetLastError();
}

const char* mft_probe_contract_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
