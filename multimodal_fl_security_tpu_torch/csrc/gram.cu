// Centered Gram matrix G = (U - mu)(U - mu)^T of a client-stacked update
// matrix U [C, D] (f32, row-major), for NVIDIA Hopper (sm_90a).
//
// Replaces multimodal_fl_security_tpu/ops/pallas_kernels.py::gram_pallas
// (the Pallas TPU kernel _gram_kernel): Krum's pairwise distances are read
// off this matrix (ops/pairwise.py).
//
// What bounds it: on the north-star round U is [100, 421,642], 169 MB read
// once (0.050 ms at 3.35 TB/s). The products run on the tensor cores in
// 3xTF32: each centered value a is split into hi = tf32(a) and
// lo = tf32(a - hi), both rounded to nearest even, and G is
// lo hi^T + hi lo^T + hi hi^T summed in f32. One TF32 pass keeps ~3 decimal
// digits (Krum's scores are compared in f32); the split keeps the result
// within ~1e-6 of max|G|. The three products are 3 C (C + 1) D = 12.8
// GFLOP, 0.026 ms at 495 TFLOP/s: the bytes bound it.
//
// What the design does about it:
//  - One row tile of 128 rows, so at C <= 128 U is read exactly once; a
//    larger C takes the upper-triangle pairs of 128-row tiles.
//  - wgmma (m64nNk8, tf32), both operands read by the tensor cores from
//    shared memory. Warpgroup 0 takes rows 0-63, warpgroup 1 rows 64-127,
//    each against all 128 rows of the other tile. On a diagonal pair that
//    full square gives two products for three: with B = hi (hi + 2 lo)^T,
//    G = (B + B^T) / 2, taken by the reduce. A first version on
//    mma.sync (m16n8k8, fragments through registers) ran slower than
//    torch.mm of the centered U: its TF32 products held it.
//  - A TPU grid step can carry a sum to the next; Hopper blocks run in no
//    order. So D is split across blocks (grid.y), one block an SM; split z
//    takes the 16-column stages z, z + splits, ... Each block streams its
//    stages through a ring of kStages cp.async copies. U's rows are d * 4
//    bytes apart: at D = 421,642 odd rows are 8-byte aligned only, so they
//    are copied 8 bytes at a time and the even rows 16 (4 bytes at odd D).
//    The mean (taken outside, as gram_pallas does) is staged beside each
//    stage.
//  - One barrier a stage: the wgmmas of stage i are issued, and while they
//    run the block centers and splits stage i + 1 into the other hi / lo
//    buffer (each value once, so the centered U never reaches HBM), then
//    refills the ring. Tiles are laid out as the wgmma's K-major core
//    matrices (8 rows x 4 floats, 128 B), so the split is linear float4
//    work and the copies land in place.
//  - The tensor cores' f32 accumulation does not round to nearest: summed
//    over a split's hundreds of products the first version drifted past
//    the 1e-5 * max|G| gate at [100, 421,642]. So every
//    kPromote stages' wgmmas start a fresh accumulator, added to the running
//    sum with f32 adds (round to nearest); in between the tensor cores run
//    on, waiting only for the stage whose buffer the split overwrites.
//  - Each split writes its partial tile to a [splits, C, C] workspace, and a
//    second kernel sums the splits in a fixed order. No float atomics: the
//    result is bitwise reproducible, so Krum's pick does not change between
//    runs on the same card.
//  - Ragged C and D edges are masked in the kernel; any [C, D] is taken.

#include <cuda_runtime.h>

#include <cstdint>

#include "client_common.cuh"  // mft_tf32_rne: the 3xTF32 split

namespace {

constexpr int kTile = 128;         // rows of U per operand tile
constexpr int kDepth = 16;         // columns of D per stage
constexpr int kStages = 8;         // cp.async stages in the ring
constexpr int kPromote = 4;        // stages summed on the tensor cores
constexpr int kThreads = 256;      // two warpgroups
constexpr int kBlocksPerSm = 1;    // blocks in flight per SM when splitting
constexpr int kMaxSplits = 65535;  // grid.y limit
constexpr int kTileFloats = kTile * kDepth;  // one operand tile of a stage
// Core matrices: 8 rows x 16 bytes, K-major. Element (r, k) of a tile sits
// at float (r / 8) * kSbo + (k / 4) * kLbo + (r % 8) * 4 + k % 4.
constexpr int kLbo = 32;                  // floats to the next 4 columns
constexpr int kSbo = kDepth / 4 * kLbo;   // floats to the next 8 rows

static_assert(kTile * kDepth % (2 * kThreads) == 0 && kDepth % 8 == 0,
              "whole copies a thread a stage, whole k8 steps");
static_assert(kTileFloats % (4 * kThreads) == 0, "whole float4s a thread");

// Floats of shared memory: the raw ring, the staged mean, and hi and lo
// twice (by stage parity), for `tiles` (1 or 2) operand tiles.
constexpr size_t smem_floats(int tiles) {
  return (static_cast<size_t>(kStages) + 4) * tiles * kTileFloats +
         kStages * kDepth;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Float offset of tile element (r, k) in the core-matrix layout.
__device__ __forceinline__ int core_off(int r, int k) {
  return (r >> 3) * kSbo + (k >> 2) * kLbo + (r & 7) * 4 + (k & 3);
}

// A wgmma shared-memory descriptor: K-major, no swizzle; start address,
// LBO and SBO in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffff) >> 4) |
         static_cast<uint64_t>(kLbo * 4 / 16) << 16 |
         static_cast<uint64_t>(kSbo * 4 / 16) << 32;
}

// kBytes (4, 8 or 16; src aligned to it) from src to shared dst, of which
// the first src_bytes are read and the rest zeroed.
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src,
                                         int src_bytes) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(dst), "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :
                 : "r"(dst), "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// d (+)= A (64 x 8) B^T (B: N x 8), both K-major in shared memory: tf32 in,
// f32 sums; scale_d 0 starts d afresh. Asynchronous: wgmma_wait before d is
// read.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// The generic proxy's shared-memory stores, made visible to the wgmmas.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// kW8: 16- and 8-byte copies (d even, U 8-byte aligned); else 4-byte ones.
template <bool kW8>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gram_tc_kernel(const float* __restrict__ u, const float* __restrict__ mu,
               float* __restrict__ partial, int c, int64_t d, int tiles) {
  // blockIdx.x enumerates the upper-triangle tile pairs row by row.
  int ti = 0;
  int rest = blockIdx.x;
  while (rest >= tiles - ti) {
    rest -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rest;
  const bool diag = ti == tj;  // both operands are the same rows: stage once
  const int ops = diag ? 1 : 2;
  const int bufs = tiles > 1 ? 2 : 1;  // operand tiles the smem is laid for
  // Split z takes the stages z, z + splits, z + 2 splits, ... of D.
  const int64_t splits = gridDim.y;
  const int64_t total = (d + kDepth - 1) / kDepth;
  const int nst = blockIdx.y < total
                      ? static_cast<int>((total - 1 - blockIdx.y) / splits + 1)
                      : 0;
  auto stage_col = [&](int i) {  // the first column of this block's stage i
    return (blockIdx.y + i * splits) * kDepth;
  };

  extern __shared__ __align__(128) float smem[];
  float* raw = smem;                               // [slot][op][core layout]
  float* hl = raw + kStages * bufs * kTileFloats;  // [parity][hi, lo][op][..]
  float* mus = hl + 4 * bufs * kTileFloats;        // [slot][k]
  const int hl_size = bufs * kTileFloats;          // one hi or lo buffer

  const int t = threadIdx.x;
  const int wg = t >> 7;          // warpgroup
  const int wt = t & 127;         // thread within it
  const int lane = t & 31;
  const int gq = lane >> 2, tq = lane & 3;

  auto issue = [&](int i) {  // this block's stage i into ring slot i % kStages
    const int slot = i % kStages;
    const int64_t k0 = stage_col(i);
    for (int p = 0; p < ops; ++p) {
      const int rowbase = (p == 0 ? ti : tj) * kTile;
      float* dst = raw + (slot * bufs + p) * kTileFloats;
      if (kW8) {
        // 16-byte chunks of 4 columns: one copy where the row's chunks are
        // 16-byte aligned, two 8-byte copies where not (every other row at
        // D = 421,642); rows past C and columns past D read as 0.
#pragma unroll
        for (int j = 0; j < kTileFloats / 4 / kThreads; ++j) {
          const int idx = t + j * kThreads;
          const int r = idx / (kDepth / 4), q = 4 * (idx % (kDepth / 4));
          const int row = rowbase + r;
          const int64_t col = k0 + q;
          const float* src = u + static_cast<int64_t>(row) * d + col;
          const int64_t left = d - col;
          const int n = row >= c || left <= 0 ? 0
                        : left >= 4           ? 4
                                              : static_cast<int>(left);  // to read
          const uint32_t at = smem_addr(dst + core_off(r, q));
          if (row >= c || (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
            cp_async<16>(at, n > 0 ? src : mu, 4 * n);
          } else {
            cp_async<8>(at, src, 4 * min(n, 2));
            cp_async<8>(at + 8, n > 2 ? src + 2 : src, 4 * max(n - 2, 0));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kTileFloats / kThreads; ++j) {
          const int idx = t + j * kThreads;
          const int r = idx / kDepth, q = idx % kDepth;
          const int row = rowbase + r;
          const int64_t col = k0 + q;
          const bool valid = row < c && col < d;
          cp_async<4>(smem_addr(dst + core_off(r, q)),
                      valid ? u + static_cast<int64_t>(row) * d + col : u,
                      valid ? 4 : 0);
        }
      }
    }
    if (t < kDepth) {
      const int64_t col = k0 + t;
      cp_async<4>(smem_addr(mus + slot * kDepth + t), col < d ? mu + col : mu,
                  col < d ? 4 : 0);
    }
  };

  auto split = [&](int i) {  // center and split stage i, each value once
    const int slot = i % kStages;
    float* hi = hl + (i & 1) * 2 * hl_size;
    const float4* m4 = reinterpret_cast<const float4*>(mus + slot * kDepth);
    for (int p = 0; p < ops; ++p) {
      const int rowbase = (p == 0 ? ti : tj) * kTile;
      const float4* src =
          reinterpret_cast<const float4*>(raw + (slot * bufs + p) * kTileFloats);
      float4* h4 = reinterpret_cast<float4*>(hi + p * kTileFloats);
      float4* l4 = reinterpret_cast<float4*>(hi + hl_size + p * kTileFloats);
#pragma unroll
      for (int j = 0; j < kTileFloats / 4 / kThreads; ++j) {
        const int v = t + j * kThreads;  // float4 v: row r, columns 4 qg ..
        const int r = v / (kSbo / 4) * 8 + v % 8;
        const float4 m = m4[v / 8 % (kDepth / 4)];
        float4 a = src[v];
        if (rowbase + r < c) {
          a = make_float4(a.x - m.x, a.y - m.y, a.z - m.z, a.w - m.w);
        } else {
          a = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        const float4 h = make_float4(mft_tf32_rne(a.x), mft_tf32_rne(a.y),
                                     mft_tf32_rne(a.z), mft_tf32_rne(a.w));
        h4[v] = h;  // lo is stored doubled (exact): see mma_stage
        l4[v] = make_float4(2.f * mft_tf32_rne(a.x - h.x),
                            2.f * mft_tf32_rne(a.y - h.y),
                            2.f * mft_tf32_rne(a.z - h.z),
                            2.f * mft_tf32_rne(a.w - h.w));
      }
    }
  };

  // Warpgroup wg: rows 64 wg .. + 63 of tile ti against the 128 rows of
  // tile tj. No branch guards the wgmmas (ptxas serializes wgmmas on a
  // divergent path): a warpgroup past C multiplies zeros, and on a diagonal
  // pair warpgroup 1 also makes the lower-left block, which the reduce
  // never reads.
  const int aoff = 8 * wg * kSbo;
  const int boff = diag ? 0 : kTileFloats;
  float acc[64] = {};
  float part[64] = {};

  // With lo2 = 2 lo: on a diagonal pair part sums B = hi (hi + lo2)^T, whose
  // symmetric part (B + B^T) / 2 is G; the reduce takes it, so two products
  // make G where three did. Off the diagonal B^T is not computed, and part
  // sums 2G = 2 hi hi^T + hi lo2^T + lo2 hi^T, halved (exactly) when added.
  auto mma_stage = [&](int i) {  // issue stage i's wgmmas into part
    const float* hi = hl + (i & 1) * 2 * hl_size;
    const float* lo2 = hi + hl_size;
    const int fresh = i % kPromote == 0;  // part starts afresh
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kDepth / 8; ++ks) {
      const int k = ks * 2 * kLbo;  // two core matrices a k8 step
      const uint64_t ah = smem_desc(hi + aoff + k);
      const uint64_t bh = smem_desc(hi + boff + k);
      const uint64_t bl = smem_desc(lo2 + boff + k);
      wgmma_n128(part, ah, bl, ks > 0 || !fresh);  // the small terms first
      if (!diag) {
        wgmma_n128(part, smem_desc(lo2 + aoff + k), bh, 1);
        wgmma_n128(part, ah, bh, 1);
      }
      wgmma_n128(part, ah, bh, 1);
    }
    wgmma_commit();
  };
  const float promote = diag ? 1.f : 0.5f;

#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < nst) issue(i);
    cp_async_commit();  // an empty group past the end keeps the count
  }
  cp_async_wait<kStages - 2>();  // stages 0 and 1 have landed
  __syncthreads();
  if (nst > 0) split(0);
  fence_proxy_async();
  __syncthreads();
  for (int i = 0; i < nst; ++i) {
    mma_stage(i);
    wgmma_wait<1>();  // stage i - 1's wgmmas, the last to read this buffer
    if (i + 1 < nst) split(i + 1);  // while the tensor cores run on stage i
    fence_proxy_async();
    if (i + kStages < nst) issue(i + kStages);  // stage i's slot, split at i - 1
    cp_async_commit();
    if (i % kPromote == kPromote - 1 || i + 1 == nst) {
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += promote * part[e];
    }
    cp_async_wait<kStages - 2>();  // stage i + 2 has landed
    __syncthreads();
  }
  cp_async_wait<0>();

  // A split whose D-range is empty writes zeros, so every slot it owns is
  // defined. The reduce reads both (row, col) and (col, row) within a
  // diagonal pair's tile, (row <= col) across tiles: all written.
  // acc[4 j + e]: row 16 (warp % 4) + gq (+ 8 for e >= 2), column 8 j + 2 tq
  // (+ 1 for odd e) of the warpgroup's 64 x 128 block.
  float* out = partial + static_cast<size_t>(blockIdx.y) * c * c;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ti * kTile + 64 * wg + 16 * (wt >> 5) + gq + 8 * h;
      const int col = tj * kTile + 8 * j + 2 * tq;
      if (row >= c) continue;
      if (col < c) out[static_cast<size_t>(row) * c + col] = acc[4 * j + 2 * h];
      if (col + 1 < c) {
        out[static_cast<size_t>(row) * c + col + 1] = acc[4 * j + 2 * h + 1];
      }
    }
  }
}

// g = the sum of the splits' partials, in a fixed order. Within a diagonal
// tile pair the partials hold B over the full square and g is its
// symmetric part; across tiles they hold G above the diagonal, mirrored.
__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ g, int c, int splits) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(c) * c) return;
  const int row = static_cast<int>(idx / c);
  const int col = static_cast<int>(idx % c);
  const int lo = min(row, col), hi = max(row, col);
  const size_t stride = static_cast<size_t>(c) * c;
  const float* p = partial + static_cast<size_t>(lo) * c + hi;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += p[z * stride];  // fixed order
  if (lo / kTile == hi / kTile) {
    const float* q = partial + static_cast<size_t>(hi) * c + lo;
    float t = 0.f;
    for (int z = 0; z < splits; ++z) t += q[z * stride];
    s = 0.5f * (s + t);  // the same for (row, col) and (col, row)
  }
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
  const int64_t rounds = (d + kDepth - 1) / kDepth;  // no split under one stage
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
  const size_t smem = sizeof(float) * smem_floats(tiles > 1 ? 2 : 1);
  const bool w8 = d % 2 == 0 && reinterpret_cast<uintptr_t>(u) % 8 == 0;
  const auto kernel = w8 ? gram_tc_kernel<true> : gram_tc_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(pairs), splits), kThreads, smem, s>>>(
      u, mu, workspace, c, d, tiles);
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
