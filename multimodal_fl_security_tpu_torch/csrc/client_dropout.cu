// Per-client inverted dropout of SimpleCNN's local training with the mask
// drawn inside the kernel from Philox4x32-10, for NVIDIA Hopper (sm_90a).
//
// Replaces the dropout of multimodal_fl_security_tpu/ops/fused_kernel.py::
// fused_local_train (K4, :403-413): per (client, step) the TPU generator is
// reseeded with (seed, c, s), its bits are kept where bits < uint32(keep *
// 2^32), and the mask (1/keep where kept, in the compute type) multiplies
// the activation; the backward reseeds and multiplies the gradient by the
// same mask. Here the mask is a pure function of (seed, client, step,
// stream, element) (philox.cuh's counter layout), so forward and backward
// regenerate it and nothing is stored.
//
// y[c, b, f] = round(x[c, b, f] * (bits < threshold ? scale : 0)), with x
// read as float (exact for bf16 and f32), `scale` = 1/keep already rounded
// to the compute type, and one rounding to y's dtype: the product and the
// rounding of the plain version (mask in the compute type, then multiplied).
// y is a new buffer, never the input: fc1's input is also the pooled map
// that conv2's gradient kernels read.
//
// One thread takes one Philox call: four consecutive j = b * F + f of one
// client. What bounds it: bytes. At the north star's width, fc1's input
// mask is [100, 32, 3136] (10.0 M elements, 2.5 M Philox calls, 40 MB read
// and written in bf16: ~0.012 ms at 3.35 TB/s); ten rounds are ~100 integer
// operations per call, well under the card's integer rate.
//
// drawn_dropout_kernel takes the mask from uniforms drawn outside instead:
// the engine's round generator draws u [C, B, F] (f32, contiguous) per step
// and layer, as rounds/engine.py's autograd trainer does, and
//   y[c, b, f] = u[c, b, f] < keep ? round(x[c, b, f] / keep) : 0,
// keep in f32, one correctly rounded division (models/simple_cnn.py::
// dropout's x / keep, which PyTorch computes so on the CPU and as x times
// the f32 reciprocal on CUDA: at most a rounding apart) and one rounding to
// y's dtype. The backward applies the same u to the gradient:
// where(mask, g, 0) / keep. What bounds it: bytes,
// x and u read, y written (120 MB in f32 at [100, 32, 3136]: ~0.036 ms at
// 3.35 TB/s).

#include "client_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

// x, y: (client, sample, feature).
__global__ void __launch_bounds__(kThreads)
dropout_kernel(MftView x, MftView y, unsigned long long seed, int batch,
               int feat, int step, int stream, unsigned long long threshold,
               float scale) {
  const long long n = static_cast<long long>(batch) * feat;
  const long long q = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  const int c = blockIdx.y;
  if (4 * q >= n) return;
  const uint4 bits = mft_philox::philox4x32_10(
      make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(c),
                 static_cast<uint32_t>(step), static_cast<uint32_t>(stream)),
      static_cast<uint32_t>(seed & 0xffffffffull),
      static_cast<uint32_t>(seed >> 32));
  for (int w = 0; w < 4; ++w) {
    const long long j = 4 * q + w;
    if (j >= n) break;
    const long long b = j / feat;
    const long long f = j % feat;
    const bool kept = mft_philox::word(bits, w) < threshold;
    const float v = mft_ld(x, mft_off(x, c, b, f, 0, 0));
    mft_st(y, mft_off(y, c, b, f, 0, 0), v * (kept ? scale : 0.f));
  }
}

// x: (client, sample, feature), any strides; u, y: contiguous [C, B, F].
// Thread t of a block takes j = base + w * kThreads + t, w < 4: a warp reads
// u and writes y in 128-byte runs.
__global__ void __launch_bounds__(kThreads)
drawn_dropout_kernel(MftView x, const float* __restrict__ u, MftView y,
                     int batch, int feat, float keep) {
  const long long n = static_cast<long long>(batch) * feat;
  const int c = blockIdx.y;
  const long long base = blockIdx.x * (4ll * kThreads) + threadIdx.x;
  const long long row = static_cast<long long>(c) * n;
  for (int w = 0; w < 4; ++w) {
    const long long j = base + static_cast<long long>(w) * kThreads;
    if (j >= n) break;
    const long long b = j / feat;
    const long long f = j - b * feat;
    const float v = mft_ld(x, mft_off(x, c, b, f, 0, 0));
    mft_st(y, row + j, u[row + j] < keep ? v / keep : 0.f);
  }
}

}  // namespace

extern "C" {

int mft_dropout(const MftView* x, const MftView* y, unsigned long long seed,
                int clients, int batch, int feat, int step, int stream,
                unsigned long long threshold, float scale, int device,
                void* cuda_stream) {
  if (clients <= 0 || batch <= 0 || feat <= 0 || clients > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long quads = (static_cast<long long>(batch) * feat + 3) / 4;
  const dim3 grid(static_cast<unsigned>((quads + kThreads - 1) / kThreads),
                  clients);
  dropout_kernel<<<grid, kThreads, 0,
                   static_cast<cudaStream_t>(cuda_stream)>>>(
      *x, *y, seed, batch, feat, step, stream, threshold, scale);
  return cudaGetLastError();
}

int mft_drawn_dropout(const MftView* x, const float* u, const MftView* y,
                      int clients, int batch, int feat, float keep,
                      int device, void* cuda_stream) {
  if (clients <= 0 || batch <= 0 || feat <= 0 || clients > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(batch) * feat;
  const dim3 grid(static_cast<unsigned>((n + 4 * kThreads - 1) /
                                        (4 * kThreads)),
                  clients);
  drawn_dropout_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(cuda_stream)>>>(
      *x, u, *y, batch, feat, keep);
  return cudaGetLastError();
}

const char* mft_client_dropout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
