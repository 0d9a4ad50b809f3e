// The loss and the optimizer of SimpleCNN's per-client local training, for
// NVIDIA Hopper (sm_90a).
//
// Replaces, in multimodal_fl_security_tpu (K4, ops/fused_kernel.py::
// fused_local_train): packed_ce (fused_train.py:511-524) with its gradient,
// and the kernel's global-norm clip, momentum and update (fused_kernel.py:
// 447-479), run over the port's flat [C, D] buffers, where each logical
// weight is one element (the clip counts it once).
//
// Kernels:
//  - ce: per client, the masked mean cross-entropy over its rows' logits and
//    dlogits = (softmax - onehot) * mask / max(sum(mask), 1); padded rows
//    (mask 0) add nothing;
//  - sq_norm: per client, block partials of the squared gradient norm over
//    its [D] row, each a fixed-order tree sum;
//  - sgd_update: each block adds its client's partials in order, takes the
//    clip scale min(1, clip / norm), and updates params and momentum in
//    place: m = g * scale + mu * m, then p = p - lr * m. Each product and sum
//    is rounded on its own (no fused multiply-add), as PyTorch's elementwise
//    ops round them.
//
// What bounds them: sgd_update reads params, momentum and gradient and writes
// params and momentum, 5 * 4 bytes per weight: 0.84 GB per step at
// [100, 421,642], 0.25 ms at 3.35 TB/s; sq_norm reads the gradient once
// (0.05 ms). HBM bandwidth bounds both; the design streams each buffer once
// per step with consecutive threads on consecutive addresses. ce is a few KB.

#include <cmath>

#include "client_common.cuh"

namespace {

constexpr int kThreads = 256;

// logits (client, row, class) f32; labels (client, row) int64; mask
// (client, row); dlogits (client, row, class); loss [C].
__global__ void __launch_bounds__(kThreads)
ce_kernel(MftView logits, MftView labels, MftView mask, MftView dlogits,
          float* loss, int rows, int classes) {
  __shared__ float part_loss[kThreads];
  __shared__ float part_cnt[kThreads];
  __shared__ float inv_denom;
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  float lsum = 0.f;
  float cnt = 0.f;
  for (int r = t; r < rows; r += kThreads) {
    const float m = mft_ld(mask, mft_off(mask, c, r, 0, 0, 0));
    const int y = static_cast<int>(mft_ld(labels, mft_off(labels, c, r, 0, 0, 0)));
    float mx = -INFINITY;
    for (int j = 0; j < classes; ++j) {
      mx = fmaxf(mx, mft_ld(logits, mft_off(logits, c, r, j, 0, 0)));
    }
    float se = 0.f;
    for (int j = 0; j < classes; ++j) {
      se += expf(mft_ld(logits, mft_off(logits, c, r, j, 0, 0)) - mx);
    }
    const float lse = mx + logf(se);
    for (int j = 0; j < classes; ++j) {
      const float l = mft_ld(logits, mft_off(logits, c, r, j, 0, 0));
      const float p = expf(l - lse);
      mft_st(dlogits, mft_off(dlogits, c, r, j, 0, 0),
             (p - (j == y ? 1.f : 0.f)) * m);
      if (j == y) lsum += (lse - l) * m;
    }
    cnt += m;
  }
  part_loss[t] = lsum;
  part_cnt[t] = cnt;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
    float n = 0.f;
    for (int i = 0; i < kThreads; ++i) {
      s += part_loss[i];
      n += part_cnt[i];
    }
    const float denom = fmaxf(n, 1.f);
    loss[c] = s / denom;
    inv_denom = 1.f / denom;
  }
  __syncthreads();
  for (int r = t; r < rows; r += kThreads) {
    for (int j = 0; j < classes; ++j) {
      const long long o = mft_off(dlogits, c, r, j, 0, 0);
      mft_st(dlogits, o, mft_ld(dlogits, o) * inv_denom);
    }
  }
}

// grid (parts, clients): partial[c * parts + p] = sum of g^2 over chunk p.
__global__ void __launch_bounds__(kThreads)
sq_norm_kernel(const float* __restrict__ grad, long long row_stride,
               long long d, float* __restrict__ partial) {
  __shared__ float red[kThreads];
  const int p = blockIdx.x;
  const int parts = gridDim.x;
  const int c = blockIdx.y;
  const long long chunk = (d + parts - 1) / parts;
  const long long lo = p * chunk;
  const long long hi = lo + chunk < d ? lo + chunk : d;
  const float* g = grad + c * row_stride;
  float acc = 0.f;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float v = g[i];
    acc += v * v;
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[c * parts + p] = red[0];
}

// grid (blocks, clients); params, momentum and grad rows of `row_stride`.
__global__ void __launch_bounds__(kThreads)
sgd_update_kernel(float* __restrict__ params, float* __restrict__ mom,
                  const float* __restrict__ grad, long long row_stride,
                  long long d, const float* __restrict__ partial, int parts,
                  float lr, float mu, float clip) {
  __shared__ float scale;
  const int c = blockIdx.y;
  if (threadIdx.x == 0) {
    float n2 = 0.f;
    for (int i = 0; i < parts; ++i) n2 += partial[c * parts + i];
    scale = clip > 0.f ? __fdiv_rn(clip, fmaxf(sqrtf(n2), clip)) : 1.f;
  }
  __syncthreads();
  const float s = scale;
  const long long base = c * row_stride;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * kThreads + threadIdx.x; i < d; i += step) {
    const float m = __fadd_rn(__fmul_rn(grad[base + i], s),
                              __fmul_rn(mu, mom[base + i]));
    mom[base + i] = m;
    params[base + i] = __fsub_rn(params[base + i], __fmul_rn(lr, m));
  }
}

}  // namespace

extern "C" {

int mft_ce(const MftView* logits, const MftView* labels, const MftView* mask,
           const MftView* dlogits, float* loss, int clients, int rows,
           int classes, int device, void* stream) {
  if (clients <= 0 || rows <= 0 || classes <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  ce_kernel<<<clients, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *logits, *labels, *mask, *dlogits, loss, rows, classes);
  return cudaGetLastError();
}

int mft_sq_norm(const float* grad, long long row_stride, long long d,
                float* partial, int clients, int parts, int device,
                void* stream) {
  if (clients <= 0 || d <= 0 || parts <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  sq_norm_kernel<<<dim3(parts, clients), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(grad, row_stride, d,
                                                        partial);
  return cudaGetLastError();
}

int mft_sgd_update(float* params, float* mom, const float* grad,
                   long long row_stride, long long d, const float* partial,
                   int parts, int clients, float lr, float mu, float clip,
                   int blocks, int device, void* stream) {
  if (clients <= 0 || d <= 0 || parts <= 0 || blocks <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  sgd_update_kernel<<<dim3(blocks, clients), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      params, mom, grad, row_stride, d, partial, parts, lr, mu, clip);
  return cudaGetLastError();
}

const char* mft_client_sgd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
