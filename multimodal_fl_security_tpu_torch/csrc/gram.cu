// Centered Gram matrix G = (U - mu)(U - mu)^T of a client-stacked update
// matrix U [C, D] (f32, row-major), for NVIDIA Hopper (sm_90a).
//
// Replaces multimodal_fl_security_tpu/ops/pallas_kernels.py::gram_pallas
// (the Pallas TPU kernel _gram_kernel): Krum's pairwise distances are read
// off this matrix (ops/pairwise.py).
//
// What bounds it: on the north-star round U is [100, 421,642], so the kernel
// reads 169 MB once and does 2*C*C*D = 8.4 GFLOP of f32 multiply-add. At the
// H100 SXM data-sheet rates that is ~0.05 ms of HBM traffic (3.35 TB/s)
// against ~0.13 ms of FMA (67 TFLOP/s f32 outside the tensor cores): the
// arithmetic bounds it, not memory. The tensor cores are not used, because
// TF32 keeps ~3 decimal digits and Krum's scores are compared in f32.
//
// What the design does about it:
//  - The output is symmetric, so only tile pairs (ti <= tj) are computed and
//    the reduce pass mirrors the rest. Each block holds a 64x64 output tile
//    as a 4x4 f32 micro-tile per thread, in registers.
//  - A TPU grid step can carry a sum to the next; Hopper blocks run in no
//    order. So D is split across blocks (grid.y) to fill every SM even at
//    C=100 (3 tile pairs). Each block streams its D-range of the two row
//    tiles through shared memory, subtracting mu while staging, so the
//    centered copy of U is never written to HBM. The next round's loads are
//    issued before the current round's FMAs, and a diagonal pair (one row
//    tile on both sides) loads its rows once.
//  - Each split writes its partial tile to a [splits, C, C] workspace, and a
//    second kernel sums the splits in a fixed order. No float atomics: the
//    result is bitwise reproducible, so Krum's pick does not change between
//    runs on the same card.
//  - Ragged C and D edges are masked in the kernel; any [C, D] is taken.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;        // output tile edge: rows of U per operand
constexpr int kDepth = 32;       // columns of D staged per shared-memory round
constexpr int kThreads = 256;    // 16 x 16 threads per block
constexpr int kMicro = 4;        // each thread owns a 4 x 4 block of outputs
constexpr int kPad = 4;          // row padding; keeps float4 reads aligned
constexpr int kBlocksPerSm = 4;  // blocks in flight per SM when picking splits
constexpr int kMaxSplits = 65535;  // grid.y limit

constexpr int kRowStep = kThreads / kDepth;          // 8 rows per pass
constexpr int kPerThread = kTile * kDepth / kThreads;  // 8 values per operand

static_assert(kTile == 16 * kMicro, "16 x 16 threads cover one tile");
static_assert(kThreads % kDepth == 0, "a warp stages whole rows");

// Loads this thread's share of one staging round, [row tile] x [k0, k0+32),
// minus mu, into registers. A warp reads 32 consecutive columns of one row:
// coalesced. Rows past c and columns past d1 read as 0.
__device__ __forceinline__ void load_round(const float* __restrict__ u,
                                           const float* __restrict__ mu,
                                           int c, int64_t d, int64_t d1,
                                           int tile, int64_t k0, int r0, int k,
                                           float (&v)[kPerThread]) {
  const int64_t col = k0 + k;
  const float m = col < d1 ? __ldg(mu + col) : 0.f;
#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    const int row = tile * kTile + r0 + s * kRowStep;
    v[s] = (col < d1 && row < c)
               ? __ldg(u + static_cast<int64_t>(row) * d + col) - m
               : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ u, const float* __restrict__ mu,
                    float* __restrict__ partial, int c, int64_t d, int tiles,
                    int64_t chunk) {
  // blockIdx.x enumerates the upper-triangle tile pairs row by row.
  int ti = 0;
  int rest = blockIdx.x;
  while (rest >= tiles - ti) {
    rest -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rest;
  const bool diag = ti == tj;  // both operands are the same rows: load once
  const int64_t d0 = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t d1 = d0 + chunk < d ? d0 + chunk : d;

  // Staged transposed, [column][row], so a thread's 4 rows are one float4.
  __shared__ __align__(16) float sa[kDepth][kTile + kPad];
  __shared__ __align__(16) float sb[kDepth][kTile + kPad];
  const float(*sbr)[kTile + kPad] = diag ? sa : sb;

  const int tx = threadIdx.x % 16;  // output columns tj*64 + tx*4 + (0..3)
  const int ty = threadIdx.x / 16;  // output rows    ti*64 + ty*4 + (0..3)
  const int k = threadIdx.x % kDepth;   // staging: this thread's column
  const int r0 = threadIdx.x / kDepth;  // and first row
  float acc[kMicro][kMicro] = {};
  float va[kPerThread];
  float vb[kPerThread];

  // Software pipeline: the next round's global loads are in flight while
  // the current round's FMAs run.
  if (d0 < d1) {
    load_round(u, mu, c, d, d1, ti, d0, r0, k, va);
    if (!diag) load_round(u, mu, c, d, d1, tj, d0, r0, k, vb);
  }
  for (int64_t k0 = d0; k0 < d1; k0 += kDepth) {
#pragma unroll
    for (int s = 0; s < kPerThread; ++s) {
      sa[k][r0 + s * kRowStep] = va[s];
      if (!diag) sb[k][r0 + s * kRowStep] = vb[s];
    }
    __syncthreads();
    if (k0 + kDepth < d1) {
      load_round(u, mu, c, d, d1, ti, k0 + kDepth, r0, k, va);
      if (!diag) load_round(u, mu, c, d, d1, tj, k0 + kDepth, r0, k, vb);
    }
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sa[kk][ty * kMicro]);
      const float4 b = *reinterpret_cast<const float4*>(&sbr[kk][tx * kMicro]);
      const float av[kMicro] = {a.x, a.y, a.z, a.w};
      const float bv[kMicro] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // A split whose D-range is empty writes zeros, so every slot is defined.
  float* out = partial + static_cast<size_t>(blockIdx.y) * c * c;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int row = ti * kTile + ty * kMicro + i;
    if (row >= c) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int col = tj * kTile + tx * kMicro + j;
      if (col < c) out[static_cast<size_t>(row) * c + col] = acc[i][j];
    }
  }
}

__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ g, int c, int splits) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(c) * c) return;
  int row = static_cast<int>(idx / c);
  int col = static_cast<int>(idx % c);
  // Only tile pairs with ti <= tj were written: read the mirror otherwise.
  if (row / kTile > col / kTile) {
    const int t = row;
    row = col;
    col = t;
  }
  const float* p = partial + static_cast<size_t>(row) * c + col;
  const size_t stride = static_cast<size_t>(c) * c;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += p[z * stride];  // fixed order
  g[idx] = s;
}

}  // namespace

extern "C" {

// Number of D-splits (the workspace's leading dimension) for a [c, d] input
// on a card with sm_count SMs.
int mft_gram_splits(int c, int64_t d, int sm_count) {
  if (c <= 0 || d <= 0 || sm_count <= 0) return 0;
  const int64_t tiles = (c + kTile - 1) / kTile;
  const int64_t pairs = tiles * (tiles + 1) / 2;
  int64_t splits = (static_cast<int64_t>(kBlocksPerSm) * sm_count + pairs - 1) / pairs;
  const int64_t rounds = (d + kDepth - 1) / kDepth;  // no split smaller than one round
  if (splits > rounds) splits = rounds;
  if (splits > kMaxSplits) splits = kMaxSplits;
  return static_cast<int>(splits < 1 ? 1 : splits);
}

// g[c, c] = (u - mu)(u - mu)^T on `stream`. u is [c, d] and mu [d], both
// contiguous f32 on `device`; workspace holds splits * c * c floats. Returns
// a cudaError_t: 0 when both launches were accepted.
int mft_gram_f32(const float* u, const float* mu, float* workspace, float* g,
                 int c, int64_t d, int splits, int device, void* stream) {
  if (c <= 0 || d <= 0 || splits <= 0 || splits > kMaxSplits) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (c + kTile - 1) / kTile;
  const int64_t pairs = static_cast<int64_t>(tiles) * (tiles + 1) / 2;
  const int64_t per_split = (d + splits - 1) / splits;
  const int64_t chunk = (per_split + kDepth - 1) / kDepth * kDepth;
  gram_partial_kernel<<<dim3(static_cast<unsigned>(pairs), splits), kThreads, 0, s>>>(
      u, mu, workspace, c, d, tiles, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(c) * c;
  gram_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      workspace, g, c, splits);
  return cudaGetLastError();
}

const char* mft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
