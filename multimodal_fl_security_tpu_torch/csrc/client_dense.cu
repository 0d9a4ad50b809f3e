// Per-client dense layers of SimpleCNN's local training (fc1 [32, 3136] x
// [3136, 128] and fc2 [32, 128] x [128, 10] per client), for NVIDIA Hopper
// (sm_90a): every client has its own weights, read in place from the flat
// [C, D] parameter buffer, and one launch serves all clients.
//
// Replaces the fc1 and fc2 parts of multimodal_fl_security_tpu/ops/
// fused_kernel.py::fused_local_train (K4; forward_impl's batched dot over
// the pooled map and its head, fused_train.py:407-416, with their VJPs).
//
// Kernels:
//  - dense_fwd: y = x W^T + b, optionally relu, per client. A block computes
//    a 32-row x 32-feature tile, staging 32-deep slices of x and W in shared
//    memory (tiled over K: one client's fc1 weight is 1.6 MB in f32);
//  - dense_bwd: from the output's gradient dz, one block per (32-wide slice
//    of the input features, client) computes dW[:, slice] = dz^T x[:, slice],
//    dx[:, slice] = dz W[:, slice] (optionally times a relu mask), and db in
//    the first slice's block. Sums over the batch run in a fixed order, so
//    two calls are bitwise equal.
//
// What bounds them: fc1 is 2*32*3136*128 = 25.7 MFLOP per client per pass,
// 2.6 GFLOP per step over 100 clients; its weights are 160 MB per step in
// f32, read from the flat buffer. At 67 TFLOP/s (f32 FMA) and 3.35 TB/s that
// is ~0.04 ms of arithmetic against ~0.05 ms of HBM per pass: the weight
// traffic bounds the forward and each backward product. The kernels read
// each weight once per pass and write each gradient once; f32 FMA on the CUDA
// cores, no tensor cores.

#include "client_common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kPad = kTile + 1;  // shared-memory rows padded against conflicts
constexpr int kThreads = 256;

// x (client, row, k), w (client, f, k), b (client, -, f), y (client, row, f).
__global__ void __launch_bounds__(kThreads)
dense_fwd_kernel(MftView x, MftView w, MftView b, MftView y, int rows, int k,
                 int f, int relu, int wdt) {
  __shared__ float xs[kTile][kPad];
  __shared__ float ws[kTile][kPad];
  const int f0 = blockIdx.x * kTile;
  const int r0 = blockIdx.y * kTile;
  const int c = blockIdx.z;
  const int t = threadIdx.x;
  const int row = t / 8;
  const int fq = (t % 8) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < k; k0 += kTile) {
    for (int i = t; i < kTile * kTile; i += kThreads) {
      const int r = i / kTile;
      const int kk = i % kTile;
      const bool in_k = k0 + kk < k;
      xs[r][kk] = (in_k && r0 + r < rows)
                      ? mft_ld(x, mft_off(x, c, r0 + r, k0 + kk, 0, 0))
                      : 0.f;
      ws[r][kk] = (in_k && f0 + r < f)
                      ? mft_round(mft_ld(w, mft_off(w, c, f0 + r, k0 + kk, 0, 0)),
                                  wdt)
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float a = xs[row][kk];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += a * ws[fq + q][kk];
    }
    __syncthreads();
  }
  if (r0 + row >= rows) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int fo = f0 + fq + q;
    if (fo >= f) continue;
    float v = acc[q] + mft_round(mft_ld(b, mft_off(b, c, 0, fo, 0, 0)), wdt);
    if (relu) v = fmaxf(v, 0.f);
    mft_st(y, mft_off(y, c, r0 + row, fo, 0, 0), v);
  }
}

// dz (client, row, f), x (client, row, k), w (client, f, k); writes
// gw (client, f, k) and gb (client, -, f) rounded to gdt, and dx (client,
// row, k) times (mask > 0) when mask.ptr is set. w is rounded to wdt.
__global__ void __launch_bounds__(kThreads)
dense_bwd_kernel(MftView dz, MftView x, MftView w, MftView mask, MftView gw,
                 MftView gb, MftView dx, int rows, int k, int f, int wdt,
                 int gdt) {
  extern __shared__ float smem[];
  float* zs = smem;                 // [rows][f]
  float* xs = zs + rows * f;        // [rows][kPad]
  float* ws = xs + rows * kPad;     // [f][kPad]
  const int k0 = blockIdx.x * kTile;
  const int c = blockIdx.y;
  const int t = threadIdx.x;
  for (int i = t; i < rows * f; i += kThreads) {
    zs[i] = mft_ld(dz, mft_off(dz, c, i / f, i % f, 0, 0));
  }
  for (int i = t; i < rows * kTile; i += kThreads) {
    const int r = i / kTile;
    const int kk = i % kTile;
    xs[r * kPad + kk] =
        k0 + kk < k ? mft_ld(x, mft_off(x, c, r, k0 + kk, 0, 0)) : 0.f;
  }
  for (int i = t; i < f * kTile; i += kThreads) {
    const int fo = i / kTile;
    const int kk = i % kTile;
    ws[fo * kPad + kk] =
        k0 + kk < k
            ? mft_round(mft_ld(w, mft_off(w, c, fo, k0 + kk, 0, 0)), wdt)
            : 0.f;
  }
  __syncthreads();
  for (int i = t; i < f * kTile; i += kThreads) {
    const int fo = i / kTile;
    const int kk = i % kTile;
    if (k0 + kk >= k) continue;
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc += zs[r * f + fo] * xs[r * kPad + kk];
    mft_st(gw, mft_off(gw, c, fo, k0 + kk, 0, 0), mft_round(acc, gdt));
  }
  for (int i = t; i < rows * kTile; i += kThreads) {
    const int r = i / kTile;
    const int kk = i % kTile;
    if (k0 + kk >= k) continue;
    float acc = 0.f;
    for (int fo = 0; fo < f; ++fo) acc += zs[r * f + fo] * ws[fo * kPad + kk];
    const long long o = mft_off(dx, c, r, k0 + kk, 0, 0);
    if (mask.ptr != nullptr) {
      // Round first, then mask: the relu's backward after the cast.
      acc = mft_round(acc, dx.dtype);
      if (!(mft_ld(mask, mft_off(mask, c, r, k0 + kk, 0, 0)) > 0.f)) acc = 0.f;
    }
    mft_st(dx, o, acc);
  }
  if (blockIdx.x == 0) {
    for (int fo = t; fo < f; fo += kThreads) {
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) acc += zs[r * f + fo];
      mft_st(gb, mft_off(gb, c, 0, fo, 0, 0), mft_round(acc, gdt));
    }
  }
}

}  // namespace

extern "C" {

int mft_dense_fwd(const MftView* x, const MftView* w, const MftView* b,
                  const MftView* y, int clients, int rows, int k, int f,
                  int relu, int wdt, int device, void* stream) {
  if (clients <= 0 || rows <= 0 || k <= 0 || f <= 0 || clients > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((f + kTile - 1) / kTile, (rows + kTile - 1) / kTile,
                  clients);
  dense_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *x, *w, *b, *y, rows, k, f, relu, wdt);
  return cudaGetLastError();
}

int mft_dense_bwd(const MftView* dz, const MftView* x, const MftView* w,
                  const MftView* mask, const MftView* gw, const MftView* gb,
                  const MftView* dx, int clients, int rows, int k, int f,
                  int wdt, int gdt, int device, void* stream) {
  if (clients <= 0 || rows <= 0 || k <= 0 || f <= 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(rows) * f + static_cast<size_t>(rows + f) * kPad);
  if (smem > kMftMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = mft_smem_optin(dense_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((k + kTile - 1) / kTile, clients);
  dense_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      *dz, *x, *w, *mask, *gw, *gb, *dx, rows, k, f, wdt, gdt);
  return cudaGetLastError();
}

const char* mft_client_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
