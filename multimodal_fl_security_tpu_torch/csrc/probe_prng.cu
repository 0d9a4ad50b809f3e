// The generator probe of the Mosaic probe set on Philox4x32-10, for NVIDIA
// Hopper (sm_90a): draw, reseed, draw again, and keep both draws' raw bits.
//
// Replaces benchmarks/mosaic_probe.py::p_prng (K5, the inline pallas_call at
// :283; pltpu.prng_seed / prng_random_bits, "reseed reproduces bits"). The
// TPU generator keeps a state that a reseed resets; Philox keeps none, so a
// reseed is the same (counter, key) computed again. Each thread draws its
// four words, then draws them again from a fresh key, and writes both draws
// and their equality (1.0 where equal). The bits are those of
// ops/philox.py::philox_bits_plain, which the tests compare bitwise.
//
// Layout: the bits of a [C, B, F] draw at step s on stream t (philox.cuh).
// What bounds it: ten rounds of two 32 x 32 -> 64-bit products per four
// words, about 100 integer operations per thread; launch latency at the
// probe's [32, 256].

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

// out_a, out_b: int64 [C, B, F] (the u32 words); eq: f32 [C, B, F].
__global__ void __launch_bounds__(kThreads)
philox_bits_kernel(long long* out_a, long long* out_b, float* eq,
                   unsigned long long seed, int batch, int feat, int step,
                   int stream) {
  const long long n = static_cast<long long>(batch) * feat;
  const long long q = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  const int c = blockIdx.y;
  if (4 * q >= n) return;
  const uint4 ctr = make_uint4(static_cast<uint32_t>(q),
                               static_cast<uint32_t>(c),
                               static_cast<uint32_t>(step),
                               static_cast<uint32_t>(stream));
  const uint32_t k0 = static_cast<uint32_t>(seed & 0xffffffffull);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  const uint4 first = mft_philox::philox4x32_10(ctr, k0, k1);
  // The reseed: a fresh key from the same seed, the counter from its start.
  const uint4 again = mft_philox::philox4x32_10(
      ctr, static_cast<uint32_t>(seed & 0xffffffffull),
      static_cast<uint32_t>(seed >> 32));
  for (int w = 0; w < 4; ++w) {
    const long long j = 4 * q + w;
    if (j >= n) break;
    const long long o = static_cast<long long>(c) * n + j;
    const uint32_t x = mft_philox::word(first, w);
    const uint32_t y = mft_philox::word(again, w);
    out_a[o] = static_cast<long long>(x);
    out_b[o] = static_cast<long long>(y);
    eq[o] = x == y ? 1.f : 0.f;
  }
}

}  // namespace

extern "C" {

int mft_philox_bits(long long* out_a, long long* out_b, float* eq,
                    unsigned long long seed, int clients, int batch,
                    int feat, int step, int stream, int device,
                    void* cuda_stream) {
  if (clients <= 0 || batch <= 0 || feat <= 0 || clients > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long quads = (static_cast<long long>(batch) * feat + 3) / 4;
  const dim3 grid(static_cast<unsigned>((quads + kThreads - 1) / kThreads),
                  clients);
  philox_bits_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(cuda_stream)>>>(
      out_a, out_b, eq, seed, batch, feat, step, stream);
  return cudaGetLastError();
}

const char* mft_probe_prng_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
