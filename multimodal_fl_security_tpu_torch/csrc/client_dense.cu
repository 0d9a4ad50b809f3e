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
//  - dense_fwd_tc: the forward for wdtype bf16 (fc1 on the path) on the
//    tensor cores: mma.sync.m16n8k16 with bf16 operands and f32 sums, A = x
//    rows, B = W rows ([f][k], the "col" operand as it is), both through
//    ldmatrix from shared memory, W converted from f32 to bf16 while
//    staged. At fc1's shapes the 160 MB of f32 weights bound it (0.048 ms at
//    3.35 TB/s; the products are 0.003 ms at the bf16 peak), so K is split
//    over a cluster of kDfSplits blocks per (32-row, 64-feature) tile, 1,400
//    blocks over 132 SMs, each streaming its share of W with the next 64-deep
//    slice's loads in flight. Rank 0 adds the ranks' partial sums through
//    distributed shared memory in rank order: no atomics, two calls are
//    bitwise equal.
//  - dense_bwd_tc: the backward for wdtype bf16 (fc1 on the path) on the
//    tensor cores, dense_fwd_tc's design turned around: one block per
//    (128-wide slice of K, client), 2,500 blocks at fc1's shapes; dz staged
//    once per block; dW = dz^T x and dx = dz W by mma.sync.m16n8k16 (bf16
//    operands, f32 sums) through ldmatrix(.trans); W read as float2 and
//    converted to bf16 while staged, the next 64-wide half's loads in flight
//    while the tensor cores run; dW stored as float2. Its bound is bytes: W
//    read and dW written in f32 (321 of the 362 MB a call moves, 0.108 ms at
//    3.35 TB/s; the products are 0.005 ms at the bf16 peak). Every sum lies
//    in one block: two calls are bitwise equal.
//  - dense_fwd_tf32, dense_bwd_tf32: fc1's forward and backward for wdtype
//    f32 (the f32 call's fc1; section "f32 in 3xTF32" below). They replace,
//    in f32, the batched dot over row positions and its sum of forward_impl
//    (fused_train.py:407-410: h4 = relu(x W + b)) and its VJP, reached
//    through jax.grad at fused_kernel.py:433 (dW = dz^T x, db = the sum of
//    dz over rows, dx = dz W^T in the JAX package's [in, out] order).
//    dense_fwd_tc's and dense_bwd_tc's designs carried to f32 on
//    mma.sync.m16n8k8 TF32 in 3xTF32, as conv2_fwd_tf32 forms its
//    products (client_conv.cu): each f32 operand split into hi = tf32(a) and
//    lo = tf32(a - hi) (mft_tf32_rne) once, as it is staged; lo hi + hi lo
//    + hi hi; a fresh accumulator every kTfChunk k8 steps (32 k), added in
//    f32, since the tensor cores' sums do not round to nearest and K =
//    3,136. Their bounds are bytes: 0.060 ms for the forward (W's 160 MB and
//    x's 40 MB at 3.35 TB/s) and 0.120 ms for the backward (W read and dW
//    written, 2 x 160 MB, x read and dx written, 2 x 40 MB); the products
//    are 2.57 GFLOP a pass, 0.016 ms at the 3xTF32 rate (495 / 3 TFLOP/s),
//    0.038 ms at the f32 CUDA-core rate (67 TFLOP/s).
//    Shared memory: the forward stages x's and W's hi and lo for one 64-deep
//    slice of a 32-row x 64-feature tile, 2 x (32 + 64) x 68 x 4 B = 52 KB
//    (rows padded to 4 (mod 32) words, so ldmatrix's eight row addresses fall
//    on distinct banks); K split over a 7-block cluster as in dense_fwd_tc
//    (1,400 blocks at fc1's shapes, 448 k a rank), each block streaming its
//    share of W with the next slice's loads in flight, up to 4 blocks an SM.
//    The backward keeps dz's hi and lo for the block (2 x 32 x 132 x 4 B =
//    33 KB) and stages x and W for 32-wide sub-slices (10 KB and 41 KB as hi
//    and lo), 88 KB with the exchange tile of dx's two feature halves: two
//    blocks an SM, so one block's loads overlap the other's products. A
//    64-wide sub-slice (126 KB) would leave one block an SM with its first
//    loads exposed. dz is split once as it is staged: splitting its
//    fragments as they are read would cost ~8 operations a value on every
//    read, and every warp reads all of dz each sub-slice.
//  - dense_fwd and dense_bwd serve every other f32 call (fc2: F = 10,
//    K = 128; any shape the 3xTF32 kernels do not take).
//
// What bounds the CUDA-core kernels at fc1's shape (their route before the
// 3xTF32 kernels): fc1 is 2*32*3136*128 = 25.7 MFLOP per
// client per pass, 2.6 GFLOP per step over 100 clients; its weights are 160
// MB per step in f32, read from the flat buffer. At 67 TFLOP/s (f32 FMA) and
// 3.35 TB/s that is ~0.04 ms of arithmetic against ~0.05 ms of HBM per pass:
// the weight traffic bounds the forward and each backward product. The
// kernels read each weight once per pass and write each gradient once; f32
// FMA on the CUDA cores.

#include <cooperative_groups.h>

#include "client_common.cuh"

namespace cg = cooperative_groups;

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

// ------------------------------------------------------------ tensor cores

using bf16 = __nv_bfloat16;

constexpr int kDfSplits = 7;           // K splits: the blocks of a cluster
constexpr int kDfRows = 32;            // block tile: rows
constexpr int kDfCols = 64;            // block tile: features
constexpr int kDfK = 64;               // k slice staged at once
constexpr int kDfRow = kDfK + 8;       // bf16 smem rows, 144 B
constexpr int kDfRed = kDfCols + 4;    // f32 partial-sum rows
// The staging and warp maps below are written for exactly these sizes: 8
// x columns and 8 W pairs per thread, 32 W pairs per row, 2 x 4 warps of
// 16 x 16 outputs.
static_assert(kThreads == 256 && kDfRows * kDfK == 8 * kThreads &&
                  kDfCols * kDfK == 16 * kThreads && kDfK == 64 &&
                  kDfRows == 2 * 16 && kDfCols == 4 * 16,
              "dense_fwd_tc_kernel's staging assumes 256 threads and a "
              "32 x 64 x 64 tile");

// One cluster of kDfSplits blocks per (row tile, feature tile, client):
// grid (kDfSplits, row tiles x feature tiles, clients); rank r sums k in
// [r kspan, (r + 1) kspan). Thread t stages x row t / 8, columns 8 (t % 8)
// .. + 7 of a slice and W elements 2 (t + 256 j) .. + 1 (row idx / 32,
// column pair idx % 32), j < 8: out of range, zeros. kVec: x bf16 with
// 16-byte rows and W f32 with 8-byte pairs (the main path: fc1's weight
// rows of an odd client are 8-byte aligned only), read as vectors; else
// element by element, any strides and types. Warp w: rows 16 (w & 1) + [0,
// 16), features 16 (w >> 1) + [0, 16) of the tile.
template <bool kVec>
__global__ void __cluster_dims__(kDfSplits, 1, 1) __launch_bounds__(kThreads)
dense_fwd_tc_kernel(MftView x, MftView w, MftView b, MftView y, int rows,
                    int k, int f, int relu, int kspan) {
  __shared__ __align__(16) bf16 xs[kDfRows * kDfRow];
  __shared__ __align__(16) bf16 ws[kDfCols * kDfRow];
  __shared__ float red[kDfRows * kDfRed];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ftiles = (f + kDfCols - 1) / kDfCols;
  const int r0 = blockIdx.y / ftiles * kDfRows;
  const int f0 = blockIdx.y % ftiles * kDfCols;
  const int c = blockIdx.z;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int li = lane >> 3, lr = lane & 7;
  const int kbeg = rank * kspan;
  const int kend = min(k, kbeg + kspan);
  const int xr = t / 8, xk = 8 * (t % 8);
  float xv[8], wv[16];
  auto load = [&](int k0) {
    const bool x_in = r0 + xr < rows;
    if (kVec) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (x_in && k0 + xk < kend) {
        v = *reinterpret_cast<const uint4*>(
            static_cast<const bf16*>(x.ptr) + c * x.st[0] +
            (r0 + xr) * x.st[1] + k0 + xk);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) xv[e] = mft_bf16_at(v, e);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xv[e] = x_in && k0 + xk + e < kend
                    ? mft_ld(x, mft_off(x, c, r0 + xr, k0 + xk + e, 0, 0))
                    : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = t + j * kThreads;
      const int fr = idx / 32, kk = k0 + 2 * (idx % 32);
      const bool f_in = f0 + fr < f;
      if (kVec) {
        float2 v = make_float2(0.f, 0.f);
        if (f_in && kk < kend) {
          v = *reinterpret_cast<const float2*>(
              static_cast<const float*>(w.ptr) + c * w.st[0] +
              (f0 + fr) * w.st[1] + kk);
        }
        wv[2 * j] = v.x;
        wv[2 * j + 1] = v.y;
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          wv[2 * j + e] = f_in && kk + e < kend
                              ? mft_ld(w, mft_off(w, c, f0 + fr, kk + e, 0, 0))
                              : 0.f;
        }
      }
    }
  };
  // ldmatrix rows (neither transposed). A: x row 16 (warp & 1) + 8 (li & 1)
  // + lr, columns 8 (li >> 1); B: W row 16 (warp >> 1) + 8 (li >> 1) + lr,
  // columns 8 (li & 1).
  const uint32_t a_addr = mft_smem_addr(
      xs + ((warp & 1) * 16 + (li & 1) * 8 + lr) * kDfRow + (li >> 1) * 8);
  const uint32_t b_addr = mft_smem_addr(
      ws + ((warp >> 1) * 16 + (li >> 1) * 8 + lr) * kDfRow + (li & 1) * 8);
  float acc[2][4] = {};
  if (kbeg < kend) load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += kDfK) {
    __syncthreads();  // the previous slice is read
    *reinterpret_cast<uint4*>(xs + xr * kDfRow + xk) =
        make_uint4(mft_pack2(xv[0], xv[1]), mft_pack2(xv[2], xv[3]),
                   mft_pack2(xv[4], xv[5]), mft_pack2(xv[6], xv[7]));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = t + j * kThreads;
      *reinterpret_cast<uint32_t*>(ws + (idx / 32) * kDfRow + 2 * (idx % 32)) =
          mft_pack2(wv[2 * j], wv[2 * j + 1]);
    }
    __syncthreads();
    if (k0 + kDfK < kend) load(k0 + kDfK);
#pragma unroll
    for (int ks = 0; ks < kDfK / 16; ++ks) {
      uint32_t a[4], bb[4];
      ldsm4(a, a_addr + ks * 32);
      ldsm4(bb, b_addr + ks * 32);
      mma16816(acc[0], a, bb[0], bb[1]);
      mma16816(acc[1], a, bb[2], bb[3]);
    }
  }
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[((warp & 1) * 16 + gq + (e >> 1) * 8) * kDfRed + (warp >> 1) * 16 +
          nt * 8 + 2 * tq + (e & 1)] = acc[nt][e];
    }
  }
  cluster.sync();  // every rank's partial sums are in its shared memory
  if (rank == 0) {
    for (int i = t; i < kDfRows * kDfCols; i += kThreads) {
      const int r = i / kDfCols, fc = i % kDfCols;
      if (r0 + r >= rows || f0 + fc >= f) continue;
      const int o = r * kDfRed + fc;
      float s = red[o];
#pragma unroll
      for (int q = 1; q < kDfSplits; ++q) {
        s += cluster.map_shared_rank(&red[0], q)[o];
      }
      float v = s + mft_round(mft_ld(b, mft_off(b, c, 0, f0 + fc, 0, 0)), kBF16);
      if (relu) v = fmaxf(v, 0.f);
      mft_st(y, mft_off(y, c, r0 + r, f0 + fc, 0, 0), v);
    }
  }
  cluster.sync();  // rank 0 has read the others' shared memory
}

constexpr int kDbRows = 32;         // batch rows the backward takes (fc1: 32)
constexpr int kDbF = 128;           // output features it takes (fc1: 128)
constexpr int kDbK = 64;            // k columns staged at once
constexpr int kDbSubs = 2;          // 64-wide sub-slices per block
constexpr int kDbMinBlocks = 1;     // blocks an SM (caps registers)
constexpr int kDbSpan = kDbK * kDbSubs;  // a block's slice of K: 128
constexpr int kDbZRow = kDbF + 8;   // bf16 dz rows in smem, 272 B
constexpr int kDbKRow = kDbK + 8;   // bf16 x and W rows in smem, 144 B
// The staging and warp maps below are written for exactly these sizes: one
// 16-byte x chunk, 16 W pairs and two 16-byte dz chunks per thread; warp w
// owns dW rows 16 w + [0, 16) x 64 columns and dx rows 16 (w & 1) + [0, 16)
// x columns 16 (w >> 1) + [0, 16).
static_assert(kThreads == 256 && kDbRows * kDbK == 8 * kThreads &&
                  kDbF * kDbK == 32 * kThreads &&
                  kDbRows * kDbF == 16 * kThreads && kDbF == 8 * 16 &&
                  kDbK == 4 * 16 && kDbRows == 2 * 16,
              "dense_bwd_tc_kernel's staging assumes 256 threads and a "
              "32 x 128 x 64 tile");

// One block per (128-wide slice of K, client): grid (slices, clients). dz
// ([rows <= 32][f <= 128], bf16) is staged once; the slice's two 64-wide
// halves go through x (bf16) and W (f32, rounded to bf16 while staged), the
// second half's loads in flight while the tensor cores run on the first:
//   dW[:, s] = dz^T x[:, s]  M = 128 features, N = 64, K = 32 rows; A = dz^T
//                            and B = x, both through ldmatrix.trans;
//   dx[:, s] = dz W[:, s]    M = 32 rows, N = 64, K = 128 features; A = dz
//                            through ldmatrix, B = W through ldmatrix.trans.
// db in the slice-0 block, over the rows in order. Every sum lies inside one
// block: two calls are bitwise equal. kVec: the main path's layouts (bf16 dz,
// x and dx with aligned rows, f32 W and dW with 8-byte pairs: fc1's weight
// rows of an odd client are 8-byte aligned only) as vector loads and stores;
// else element by element, any strides. dW rounds to gdt; dx rounds to its
// dtype, then the optional relu mask zeroes it, as dense_bwd_kernel does.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kDbMinBlocks)
dense_bwd_tc_kernel(MftView dz, MftView x, MftView w, MftView mask,
                    MftView gw, MftView gb, MftView dx, int rows, int k,
                    int f, int gdt) {
  __shared__ __align__(16) bf16 zs[kDbRows * kDbZRow];
  __shared__ __align__(16) bf16 xs[kDbRows * kDbKRow];
  __shared__ __align__(16) bf16 ws[kDbF * kDbKRow];
  const int c = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int li = lane >> 3, lr = lane & 7, gq = lane >> 2, tq = lane & 3;
  const int kbeg = blockIdx.x * kDbSpan;
  const int kend = min(k, kbeg + kDbSpan);

#pragma unroll
  for (int j = 0; j < 2; ++j) {  // dz, once: 512 chunks of 8
    const int idx = t + j * kThreads;
    const int r = idx / 16, q = 8 * (idx % 16);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (kVec) {
      if (r < rows && q < f) {
        v = *reinterpret_cast<const uint4*>(
            static_cast<const bf16*>(dz.ptr) + c * dz.st[0] + r * dz.st[1] +
            q);
      }
    } else {
      float e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        e[i] = r < rows && q + i < f
                   ? mft_ld(dz, mft_off(dz, c, r, q + i, 0, 0))
                   : 0.f;
      }
      v = make_uint4(mft_pack2(e[0], e[1]), mft_pack2(e[2], e[3]),
                     mft_pack2(e[4], e[5]), mft_pack2(e[6], e[7]));
    }
    *reinterpret_cast<uint4*>(zs + r * kDbZRow + q) = v;
  }
  __syncthreads();
  if (blockIdx.x == 0) {  // db, over the rows in order
    for (int fo = t; fo < f; fo += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += __bfloat162float(zs[r * kDbZRow + fo]);
      mft_st(gb, mft_off(gb, c, 0, fo, 0, 0), mft_round(s, gdt));
    }
  }

  // Thread t stages x row t / 8, columns 8 (t % 8) .. + 7 of a sub-slice,
  // and W pairs idx = t + 256 j (row idx / 32, columns 2 (idx % 32), + 1).
  const int xr = t >> 3, xk = 8 * (t & 7);
  uint4 xv;
  float wv[32];
  auto load = [&](int k0) {
    if (kVec) {
      xv = make_uint4(0u, 0u, 0u, 0u);
      if (xr < rows && k0 + xk < kend) {
        xv = *reinterpret_cast<const uint4*>(
            static_cast<const bf16*>(x.ptr) + c * x.st[0] + xr * x.st[1] +
            k0 + xk);
      }
    } else {
      float e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        e[i] = xr < rows && k0 + xk + i < kend
                   ? mft_ld(x, mft_off(x, c, xr, k0 + xk + i, 0, 0))
                   : 0.f;
      }
      xv = make_uint4(mft_pack2(e[0], e[1]), mft_pack2(e[2], e[3]),
                      mft_pack2(e[4], e[5]), mft_pack2(e[6], e[7]));
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int idx = t + j * kThreads;
      const int fr = idx >> 5, kk = k0 + 2 * (idx & 31);
      if (kVec) {
        float2 v = make_float2(0.f, 0.f);
        if (fr < f && kk < kend) {
          v = *reinterpret_cast<const float2*>(
              static_cast<const float*>(w.ptr) + c * w.st[0] + fr * w.st[1] +
              kk);
        }
        wv[2 * j] = v.x;
        wv[2 * j + 1] = v.y;
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          wv[2 * j + e] = fr < f && kk + e < kend
                              ? mft_ld(w, mft_off(w, c, fr, kk + e, 0, 0))
                              : 0.f;
        }
      }
    }
  };
  // ldmatrix row addresses. dW: A = dz^T (stored [r][f]: matrix i is rows
  // 8 (i >> 1) + lr, columns 16 warp + 8 (i & 1)), B = x (stored [r][k]:
  // rows 8 (i & 1) + lr, columns 8 (i >> 1) + 16 per n pair). dx: A = dz
  // (rows 16 (warp & 1) + 8 (i & 1) + lr, columns 8 (i >> 1)), B = W
  // (stored [f][k]: rows 8 (i & 1) + lr, columns 16 (warp >> 1) + 8 (i >> 1)).
  const uint32_t aw_addr = mft_smem_addr(
      zs + ((li >> 1) * 8 + lr) * kDbZRow + 16 * warp + (li & 1) * 8);
  const uint32_t bw_addr =
      mft_smem_addr(xs + ((li & 1) * 8 + lr) * kDbKRow + (li >> 1) * 8);
  const uint32_t ax_addr = mft_smem_addr(
      zs + (16 * (warp & 1) + (li & 1) * 8 + lr) * kDbZRow + (li >> 1) * 8);
  const uint32_t bx_addr = mft_smem_addr(
      ws + ((li & 1) * 8 + lr) * kDbKRow + 16 * (warp >> 1) + (li >> 1) * 8);
  constexpr uint32_t kZ16 = 16 * kDbZRow * sizeof(bf16);  // 16 dz rows
  constexpr uint32_t kK16 = 16 * kDbKRow * sizeof(bf16);  // 16 x or W rows

  load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += kDbK) {
    __syncthreads();  // the previous sub-slice is read
    *reinterpret_cast<uint4*>(xs + xr * kDbKRow + xk) = xv;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int idx = t + j * kThreads;
      *reinterpret_cast<uint32_t*>(ws + (idx >> 5) * kDbKRow +
                                   2 * (idx & 31)) =
          mft_pack2(wv[2 * j], wv[2 * j + 1]);
    }
    __syncthreads();
    if (k0 + kDbK < kend) load(k0 + kDbK);

    float aw[8][4] = {};  // dW rows 16 warp + .., columns 8 nt + ..
#pragma unroll
    for (int ks = 0; ks < kDbRows / 16; ++ks) {
      uint32_t a[4];
      ldsm4_t(a, aw_addr + ks * kZ16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ldsm4_t(bb, bw_addr + ks * kK16 + np * 32);
        mma16816(aw[2 * np], a, bb[0], bb[1]);
        mma16816(aw[2 * np + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int fo = 16 * warp + gq + 8 * h;
        const int kk = k0 + 8 * nt + 2 * tq;
        if (fo >= f || kk >= kend) continue;
        const float v0 = mft_round(aw[nt][2 * h], gdt);
        const float v1 = mft_round(aw[nt][2 * h + 1], gdt);
        if (kVec) {
          *reinterpret_cast<float2*>(static_cast<float*>(gw.ptr) +
                                     c * gw.st[0] + fo * gw.st[1] + kk) =
              make_float2(v0, v1);
        } else {
          mft_st(gw, mft_off(gw, c, fo, kk, 0, 0), v0);
          if (kk + 1 < kend) mft_st(gw, mft_off(gw, c, fo, kk + 1, 0, 0), v1);
        }
      }
    }

    float ax[2][4] = {};  // dx rows 16 (warp & 1) + .., columns 16 (warp >> 1) + ..
#pragma unroll
    for (int ks = 0; ks < kDbF / 16; ++ks) {
      uint32_t a[4], bb[4];
      ldsm4(a, ax_addr + ks * 32);
      ldsm4_t(bb, bx_addr + ks * kK16);
      mma16816(ax[0], a, bb[0], bb[1]);
      mma16816(ax[1], a, bb[2], bb[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * (warp & 1) + gq + 8 * h;
        const int kk = k0 + 16 * (warp >> 1) + 8 * nt + 2 * tq;
        if (r >= rows || kk >= kend) continue;
        float v[2] = {ax[nt][2 * h], ax[nt][2 * h + 1]};
        if (mask.ptr != nullptr) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (kk + e >= kend) continue;
            // Round first, then mask: the relu's backward after the cast.
            v[e] = mft_round(v[e], dx.dtype);
            if (!(mft_ld(mask, mft_off(mask, c, r, kk + e, 0, 0)) > 0.f)) {
              v[e] = 0.f;
            }
          }
        }
        if (kVec) {
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dx.ptr) +
                                       c * dx.st[0] + r * dx.st[1] + kk) =
              mft_pack2(v[0], v[1]);
        } else {
          mft_st(dx, mft_off(dx, c, r, kk, 0, 0), v[0]);
          if (kk + 1 < kend) mft_st(dx, mft_off(dx, c, r, kk + 1, 0, 0), v[1]);
        }
      }
    }
  }
}

// ------------------------------------------------------- f32 in 3xTF32

// hi = tf32(v) and lo = tf32(v - hi) of four or two floats, stored to
// shared memory as one vector each.
__device__ __forceinline__ void split4(const float4& v, float* hi,
                                       float* lo) {
  const float4 h = make_float4(mft_tf32_rne(v.x), mft_tf32_rne(v.y),
                               mft_tf32_rne(v.z), mft_tf32_rne(v.w));
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(lo) =
      make_float4(mft_tf32_rne(v.x - h.x), mft_tf32_rne(v.y - h.y),
                  mft_tf32_rne(v.z - h.z), mft_tf32_rne(v.w - h.w));
}

__device__ __forceinline__ void split2(const float2& v, float* hi,
                                       float* lo) {
  const float2 h = make_float2(mft_tf32_rne(v.x), mft_tf32_rne(v.y));
  *reinterpret_cast<float2*>(hi) = h;
  *reinterpret_cast<float2*>(lo) =
      make_float2(mft_tf32_rne(v.x - h.x), mft_tf32_rne(v.y - h.y));
}

// d += a b in 3xTF32 from the operands' hi and lo fragments: the small
// terms first.
__device__ __forceinline__ void mma1688_3xtf32(float (&d)[4],
                                               const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4],
                                               uint32_t bh0, uint32_t bh1,
                                               uint32_t bl0, uint32_t bl1) {
  mma1688_tf32(d, al, bh0, bh1);
  mma1688_tf32(d, ah, bl0, bl1);
  mma1688_tf32(d, ah, bh0, bh1);
}

constexpr int kTfChunk = 4;             // k8 steps a fresh accumulator takes
constexpr int kFtSplits = 7;            // K splits: the blocks of a cluster
constexpr int kFtRows = 32;             // block tile: rows
constexpr int kFtCols = 64;             // block tile: features
constexpr int kFtK = 64;                // k slice staged at once
constexpr int kFtRow = kFtK + 4;        // 68 floats: rows 4 (mod 32) words apart
constexpr size_t kFtSmem =
    sizeof(float) * 2 * (kFtRows + kFtCols) * kFtRow;  // 52,224 bytes
// The staging and warp maps below are written for exactly these sizes: two
// float4 of x and 8 float2 of W a thread; 2 x 4 warps of 16 x 16 outputs.
static_assert(kThreads == 256 && kFtRows * kFtK == 8 * kThreads &&
                  kFtCols * kFtK == 16 * kThreads && kFtK == 64 &&
                  kFtRows == 2 * 16 && kFtCols == 4 * 16 &&
                  kFtK / 8 % kTfChunk == 0,
              "dense_fwd_tf32_kernel's staging assumes 256 threads and a "
              "32 x 64 x 64 tile");

// One cluster of kFtSplits blocks per (row tile, feature tile, client), as
// dense_fwd_tc_kernel: grid (kFtSplits, row tiles x feature tiles,
// clients); rank r sums k in [r kspan, (r + 1) kspan) (kspan a multiple of
// kFtK). x is read as float4 (rows 16-byte aligned), W as float2 (fc1's
// weight rows of an odd client are 8-byte aligned only), both f32; f a
// multiple of kFtCols and k of 8 (mft_dense_fwd_tf32_takes). Thread t
// stages x row t / 8, columns 8 (t % 8) .. + 7 of a slice, and W pairs
// idx = t + 256 j (row idx / 32, columns 2 (idx % 32), + 1). Each operand
// is split into hi and lo once, as it is staged; every fragment comes from
// ldmatrix (lane l gets word l % 4 of row l / 4 of an 8 x 16-byte matrix:
// the TF32 fragment of a [row][k] tile, A = x and B = W alike). Warp w:
// rows 16 (w & 1) + [0, 16), features 16 (w >> 1) + [0, 16) of the tile.
__global__ void __cluster_dims__(kFtSplits, 1, 1) __launch_bounds__(kThreads, 2)
dense_fwd_tf32_kernel(MftView x, MftView w, MftView b, MftView y, int rows,
                      int k, int f, int relu, int kspan) {
  extern __shared__ __align__(16) float fsm[];
  float* xh = fsm;  // [row][k]
  float* xl = xh + kFtRows * kFtRow;
  float* wh = xl + kFtRows * kFtRow;  // [feature][k]
  float* wl = wh + kFtCols * kFtRow;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ftiles = f / kFtCols;
  const int r0 = blockIdx.y / ftiles * kFtRows;
  const int f0 = blockIdx.y % ftiles * kFtCols;
  const int c = blockIdx.z;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int li = lane >> 3, lr = lane & 7;
  const int kbeg = rank * kspan;
  const int kend = min(k, kbeg + kspan);
  const int xr = t >> 3, xk = 8 * (t & 7);
  const bool x_in = r0 + xr < rows;
  const float* xp = static_cast<const float*>(x.ptr) + c * x.st[0] +
                    (r0 + xr) * x.st[1] + xk;
  const float* wp =
      static_cast<const float*>(w.ptr) + c * w.st[0] + f0 * w.st[1];
  float4 xv[2];
  float2 wv[8];
  auto load = [&](int k0) {
    const bool in = x_in && k0 + xk < kend;  // k and kend: multiples of 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xv[h] = in ? *reinterpret_cast<const float4*>(xp + k0 + 4 * h)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = t + j * kThreads;
      const int kk = k0 + 2 * (idx & 31);
      wv[j] = kk < kend ? *reinterpret_cast<const float2*>(
                              wp + (idx >> 5) * w.st[1] + kk)
                        : make_float2(0.f, 0.f);
    }
  };
  // ldmatrix row addresses. A: x row 16 (warp & 1) + 8 (li & 1) + lr,
  // columns 4 (li >> 1); B: W row 16 (warp >> 1) + 8 (li >> 1) + lr,
  // columns 4 (li & 1): b0, b1 of the n8 tile 0, then of tile 1.
  const uint32_t a_off = static_cast<uint32_t>(
      (((warp & 1) * 16 + (li & 1) * 8 + lr) * kFtRow + (li >> 1) * 4) *
      sizeof(float));
  const uint32_t b_off = static_cast<uint32_t>(
      (((warp >> 1) * 16 + (li >> 1) * 8 + lr) * kFtRow + (li & 1) * 4) *
      sizeof(float));
  const uint32_t xh_addr = mft_smem_addr(xh) + a_off;
  const uint32_t xl_addr = mft_smem_addr(xl) + a_off;
  const uint32_t wh_addr = mft_smem_addr(wh) + b_off;
  const uint32_t wl_addr = mft_smem_addr(wl) + b_off;
  float acc[2][4] = {};
  if (kbeg < kend) load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += kFtK) {
    __syncthreads();  // the previous slice is read
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = xr * kFtRow + xk + 4 * h;
      split4(xv[h], xh + at, xl + at);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = t + j * kThreads;
      const int at = (idx >> 5) * kFtRow + 2 * (idx & 31);
      split2(wv[j], wh + at, wl + at);
    }
    __syncthreads();
    if (k0 + kFtK < kend) load(k0 + kFtK);
#pragma unroll
    for (int s0 = 0; s0 < kFtK / 8; s0 += kTfChunk) {
      float part[2][4] = {};  // a fresh accumulator: the sums round down
#pragma unroll
      for (int ds = 0; ds < kTfChunk; ++ds) {
        const uint32_t ko = (s0 + ds) * 8 * sizeof(float);
        uint32_t ah[4], al[4], bh[4], bl[4];
        ldsm4(ah, xh_addr + ko);
        ldsm4(al, xl_addr + ko);
        ldsm4(bh, wh_addr + ko);
        ldsm4(bl, wl_addr + ko);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma1688_3xtf32(part[nt], ah, al, bh[2 * nt], bh[2 * nt + 1],
                         bl[2 * nt], bl[2 * nt + 1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += part[nt][e];
      }
    }
  }
  __syncthreads();  // every warp is done with x's hi: it takes the sums
  float* red = xh;  // [row][feature], rows kFtRow apart
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[((warp & 1) * 16 + gq + (e >> 1) * 8) * kFtRow + (warp >> 1) * 16 +
          nt * 8 + 2 * tq + (e & 1)] = acc[nt][e];
    }
  }
  cluster.sync();  // every rank's partial sums are in its shared memory
  if (rank == 0) {
    for (int i = t; i < kFtRows * kFtCols; i += kThreads) {
      const int r = i / kFtCols, fc = i % kFtCols;
      if (r0 + r >= rows) continue;
      const int o = r * kFtRow + fc;
      float s = red[o];
#pragma unroll
      for (int q = 1; q < kFtSplits; ++q) {
        s += cluster.map_shared_rank(red, q)[o];
      }
      float v = s + mft_ld(b, mft_off(b, c, 0, f0 + fc, 0, 0));
      if (relu) v = fmaxf(v, 0.f);
      mft_st(y, mft_off(y, c, r0 + r, f0 + fc, 0, 0), v);
    }
  }
  cluster.sync();  // rank 0 has read the others' shared memory
}

constexpr int kBtRows = 32;               // batch rows it takes (fc1: 32)
constexpr int kBtF = 128;                 // output features it takes (fc1: 128)
constexpr int kBtK = 32;                  // k columns staged at once
constexpr int kBtSubs = 4;                // sub-slices a block
constexpr int kBtSpan = kBtK * kBtSubs;   // a block's slice of K: 128
constexpr int kBtZRow = kBtF + 4;         // 132 floats: dz [r][f], 4 (mod 32)
constexpr int kBtKRow = kBtK + 8;         // 40 floats: x, W, dx rows, 8 (mod 32)
constexpr size_t kBtSmem =
    sizeof(float) * (2 * kBtRows * kBtZRow + 2 * kBtRows * kBtKRow +
                     2 * kBtF * kBtKRow + kBtRows * kBtKRow);  // 90,112 bytes
// The staging and warp maps below are written for exactly these sizes: 4
// float4 of dz, one float4 of x and 8 float2 of W a thread; warp w owns dW
// rows 16 w + [0, 16) x 32 columns, and dx rows 16 (w & 1) + [0, 16) x
// columns 16 ((w >> 1) & 1) + [0, 16) over features 64 (w >> 2) + [0, 64).
static_assert(kThreads == 256 && kBtRows * kBtF == 16 * kThreads &&
                  kBtRows * kBtK == 4 * kThreads &&
                  kBtF * kBtK == 16 * kThreads && kBtF == 8 * 16 &&
                  kBtK == 4 * 8 && kBtRows == 4 * 8 &&
                  kBtF / 2 / 8 % kTfChunk == 0,
              "dense_bwd_tf32_kernel's staging assumes 256 threads and a "
              "32 x 128 x 32 tile");

// One block per (128-wide slice of K, client): grid (slices, clients), as
// dense_bwd_tc_kernel. dz ([rows <= 32][f <= 128], f32, 16-byte rows) is
// staged once, split; each 32-wide sub-slice of x (float4) and W (float2:
// fc1's weight rows of an odd client are 8-byte aligned only) is split as
// it is staged, the next sub-slice's loads in flight while the tensor
// cores run:
//   dW[:, s] = dz^T x[:, s]  M = 128 features, N = 32, K = 32 rows: one
//                            chunk; dz^T's fragments are the block's, held
//                            in registers;
//   dx[:, s] = dz W[:, s]    M = 32 rows, N = 32, K = 128 features: warps
//                            4-7 sum features 64-127, warps 0-3 features
//                            0-63, each in two chunks; warps 0-3 add the
//                            upper half's sums to theirs.
// Fragments are scalar loads: rows 8 (mod 32) words apart for the [k][n]
// reads of x and W (B: lane (g, t) reads row t, column g), 4 (mod 32) for
// the [m][k] reads of dz (A: row g, column t). db in the slice-0 block,
// over the rows in order, from dz in global memory. dW is stored as
// float2; dx rounds to f32, then the optional relu mask zeroes it, as
// dense_bwd_kernel does. Every sum lies in one block: two calls are
// bitwise equal.
__global__ void __launch_bounds__(kThreads, 2)
dense_bwd_tf32_kernel(MftView dz, MftView x, MftView w, MftView mask,
                      MftView gw, MftView gb, MftView dx, int rows, int k,
                      int f) {
  extern __shared__ __align__(16) float bsm[];
  float* zh = bsm;  // [r][f]
  float* zl = zh + kBtRows * kBtZRow;
  float* xh = zl + kBtRows * kBtZRow;  // [r][k]
  float* xl = xh + kBtRows * kBtKRow;
  float* wh = xl + kBtRows * kBtKRow;  // [f][k]
  float* wl = wh + kBtF * kBtKRow;
  float* red = wl + kBtF * kBtKRow;  // [r][k]: dx over features 64-127
  const int c = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // the fragments' row, column
  const int kbeg = blockIdx.x * kBtSpan;
  const int kend = min(k, kbeg + kBtSpan);

  const float* zp = static_cast<const float*>(dz.ptr) + c * dz.st[0];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // dz, once: 1,024 float4
    const int idx = t + j * kThreads;
    const int r = idx >> 5, q = 4 * (idx & 31);
    const float4 v = r < rows && q < f
                         ? *reinterpret_cast<const float4*>(zp + r * dz.st[1] +
                                                            q)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    split4(v, zh + r * kBtZRow + q, zl + r * kBtZRow + q);
  }
  if (blockIdx.x == 0) {  // db, over the rows in order
    for (int fo = t; fo < f; fo += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += zp[r * dz.st[1] + fo];
      mft_st(gb, mft_off(gb, c, 0, fo, 0, 0), s);
    }
  }

  // Thread t stages x row t / 8, columns 4 (t % 8) .. + 3 of a sub-slice,
  // and W pairs idx = t + 256 j (row idx / 16, columns 2 (idx % 16), + 1).
  const int xr = t >> 3, xk = 4 * (t & 7);
  const float* xp = static_cast<const float*>(x.ptr) + c * x.st[0] +
                    xr * x.st[1] + xk;
  const float* wp = static_cast<const float*>(w.ptr) + c * w.st[0];
  float4 xv;
  float2 wv[8];
  auto load = [&](int k0) {
    xv = xr < rows && k0 + xk < kend  // k and kend: multiples of 8
             ? *reinterpret_cast<const float4*>(xp + k0)
             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = t + j * kThreads;
      const int fr = idx >> 4, kk = k0 + 2 * (idx & 15);
      wv[j] = fr < f && kk < kend
                  ? *reinterpret_cast<const float2*>(wp + fr * w.st[1] + kk)
                  : make_float2(0.f, 0.f);
    }
  };
  load(kbeg);
  __syncthreads();  // dz is staged
  // dW's A = dz^T: a0 .. a3 at (f, r) = (16 warp + gq (+ 8), 8 ks + tq
  // (+ 4)), the same for every sub-slice.
  uint32_t awh[4][4], awl[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (8 * ks + tq + 4 * (e >> 1)) * kBtZRow + 16 * warp + gq +
                     8 * (e & 1);
      awh[ks][e] = __float_as_uint(zh[at]);
      awl[ks][e] = __float_as_uint(zl[at]);
    }
  }
  const int wm = warp & 1, wn = (warp >> 1) & 1, wk = warp >> 2;

  for (int k0 = kbeg; k0 < kend; k0 += kBtK) {
    __syncthreads();  // the previous sub-slice and red are read
    split4(xv, xh + xr * kBtKRow + xk, xl + xr * kBtKRow + xk);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = t + j * kThreads;
      const int at = (idx >> 4) * kBtKRow + 2 * (idx & 15);
      split2(wv[j], wh + at, wl + at);
    }
    __syncthreads();
    if (k0 + kBtK < kend) load(k0 + kBtK);

    float aw[4][4] = {};  // dW rows 16 warp + .., columns 8 nt + ..
#pragma unroll
    for (int ks = 0; ks < kBtRows / 8; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int at = (8 * ks + tq) * kBtKRow + 8 * nt + gq;
        mma1688_3xtf32(aw[nt], awh[ks], awl[ks], __float_as_uint(xh[at]),
                       __float_as_uint(xh[at + 4 * kBtKRow]),
                       __float_as_uint(xl[at]),
                       __float_as_uint(xl[at + 4 * kBtKRow]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int fo = 16 * warp + gq + 8 * h;
        const int kk = k0 + 8 * nt + 2 * tq;
        if (fo < f && kk < kend) {
          *reinterpret_cast<float2*>(static_cast<float*>(gw.ptr) +
                                     c * gw.st[0] + fo * gw.st[1] + kk) =
              make_float2(aw[nt][2 * h], aw[nt][2 * h + 1]);
        }
      }
    }

    float ax[2][4] = {};  // dx rows 16 wm + .., columns 16 wn + 8 nt + ..
#pragma unroll
    for (int s0 = 0; s0 < kBtF / 2 / 8; s0 += kTfChunk) {
      float part[2][4] = {};  // a fresh accumulator: the sums round down
#pragma unroll
      for (int ds = 0; ds < kTfChunk; ++ds) {
        const int fk = 64 * wk + 8 * (s0 + ds);
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = (16 * wm + gq + 8 * (e & 1)) * kBtZRow + fk + tq +
                         4 * (e >> 1);
          ah[e] = __float_as_uint(zh[at]);
          al[e] = __float_as_uint(zl[at]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int at = (fk + tq) * kBtKRow + 16 * wn + 8 * nt + gq;
          mma1688_3xtf32(part[nt], ah, al, __float_as_uint(wh[at]),
                         __float_as_uint(wh[at + 4 * kBtKRow]),
                         __float_as_uint(wl[at]),
                         __float_as_uint(wl[at + 4 * kBtKRow]));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ax[nt][e] += part[nt][e];
      }
    }
    if (wk == 1) {  // the upper features' sums, to warps 0-3
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(
              red + (16 * wm + gq + 8 * h) * kBtKRow + 16 * wn + 8 * nt +
              2 * tq) = make_float2(ax[nt][2 * h], ax[nt][2 * h + 1]);
        }
      }
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wm + gq + 8 * h;
          const int col = 16 * wn + 8 * nt + 2 * tq;
          const int kk = k0 + col;
          if (r >= rows || kk >= kend) continue;
          const float2 up =
              *reinterpret_cast<const float2*>(red + r * kBtKRow + col);
          float v[2] = {ax[nt][2 * h] + up.x, ax[nt][2 * h + 1] + up.y};
          if (mask.ptr != nullptr) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // f32: the rounding before the mask is the identity.
              if (!(mft_ld(mask, mft_off(mask, c, r, kk + e, 0, 0)) > 0.f)) {
                v[e] = 0.f;
              }
            }
          }
          *reinterpret_cast<float2*>(static_cast<float*>(dx.ptr) +
                                     c * dx.st[0] + r * dx.st[1] + kk) =
              make_float2(v[0], v[1]);
        }
      }
    }
  }
}

// Whether a view is f32 with its last axis (column) contiguous and its rows
// and clients `align` floats apart, starting `align` floats aligned.
bool f32_rows(const MftView& v, int align) {
  return v.dtype == kF32 && v.st[2] == 1 && v.st[0] % align == 0 &&
         v.st[1] % align == 0 &&
         reinterpret_cast<uintptr_t>(v.ptr) % (align * sizeof(float)) == 0;
}

// What dense_fwd_tf32_kernel takes: f32 compute (wdt), x f32 with 16-byte
// rows, W f32 with 8-byte pairs, k a multiple of 8 and f of kFtCols.
bool dense_fwd_tf32_takes(const MftView& x, const MftView& w, int clients,
                          int rows, int k, int f, int wdt) {
  return wdt == kF32 && clients > 0 && clients <= 65535 && rows > 0 &&
         k > 0 && k % 8 == 0 && f > 0 && f % kFtCols == 0 &&
         f32_rows(x, 4) && f32_rows(w, 2);
}

// What dense_bwd_tf32_kernel takes: f32 compute and gradients (wdt, gdt), dz
// f32 with 16-byte rows, rows <= kBtRows, f a multiple of 64 up to kBtF, k
// a multiple of 8, x and W as dense_fwd_tf32_takes, dW and dx f32 with
// 8-byte pairs.
bool dense_bwd_tf32_takes(const MftView& dz, const MftView& x,
                          const MftView& w, const MftView& gw,
                          const MftView& dx, int clients, int rows, int k,
                          int f, int wdt, int gdt) {
  return wdt == kF32 && gdt == kF32 && clients > 0 && clients <= 65535 &&
         rows > 0 && rows <= kBtRows && k > 0 && k % 8 == 0 && f > 0 &&
         f % 64 == 0 && f <= kBtF && f32_rows(dz, 4) && f32_rows(x, 4) &&
         f32_rows(w, 2) && f32_rows(gw, 2) && f32_rows(dx, 2);
}

// Whether x (bf16) and w (f32) take dense_fwd_tc_kernel's vector loads: x
// rows 16-byte aligned, W rows 8-byte aligned, k a multiple of 8.
bool dense_vec(const MftView& x, const MftView& w, int k) {
  return x.dtype == kBF16 && k % 8 == 0 && x.st[2] == 1 && x.st[0] % 8 == 0 &&
         x.st[1] % 8 == 0 && reinterpret_cast<uintptr_t>(x.ptr) % 16 == 0 &&
         f32_rows(w, 2);
}

// Whether dense_bwd_tc_kernel takes vector loads and stores: dense_vec's x
// and W, dz bf16 with 16-byte rows (f a multiple of 8), dW f32 with 8-byte
// pairs, dx bf16 with 4-byte pairs.
bool dense_bwd_vec(const MftView& dz, const MftView& x, const MftView& w,
                   const MftView& gw, const MftView& dx, int k, int f) {
  return dense_vec(x, w, k) && dz.dtype == kBF16 && f % 8 == 0 &&
         dz.st[2] == 1 && dz.st[0] % 8 == 0 && dz.st[1] % 8 == 0 &&
         reinterpret_cast<uintptr_t>(dz.ptr) % 16 == 0 && f32_rows(gw, 2) &&
         dx.dtype == kBF16 &&
         dx.st[2] == 1 && dx.st[0] % 2 == 0 && dx.st[1] % 2 == 0 &&
         reinterpret_cast<uintptr_t>(dx.ptr) % 4 == 0;
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

// The forward for wdtype bf16 on the tensor cores: the same arguments as
// mft_dense_fwd without wdt; x must be bf16 (the wrapper refuses others).
int mft_dense_fwd_tc(const MftView* x, const MftView* w, const MftView* b,
                     const MftView* y, int clients, int rows, int k, int f,
                     int relu, int device, void* stream) {
  if (clients <= 0 || rows <= 0 || k <= 0 || f <= 0 || clients > 65535 ||
      x->dtype != kBF16) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int per = (k + kDfSplits - 1) / kDfSplits;
  const int kspan = (per + kDfK - 1) / kDfK * kDfK;
  const dim3 grid(kDfSplits,
                  ((rows + kDfRows - 1) / kDfRows) *
                      ((f + kDfCols - 1) / kDfCols),
                  clients);
  const auto kernel = dense_vec(*x, *w, k) ? dense_fwd_tc_kernel<true>
                                           : dense_fwd_tc_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *x, *w, *b, *y, rows, k, f, relu, kspan);
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

// The backward for wdtype bf16 on the tensor cores: the same arguments as
// mft_dense_bwd without wdt. dz and x must be bf16, rows <= 32 and f <= 128
// (the wrapper refuses others).
int mft_dense_bwd_tc(const MftView* dz, const MftView* x, const MftView* w,
                     const MftView* mask, const MftView* gw, const MftView* gb,
                     const MftView* dx, int clients, int rows, int k, int f,
                     int gdt, int device, void* stream) {
  if (clients <= 0 || rows <= 0 || k <= 0 || f <= 0 || clients > 65535 ||
      rows > kDbRows || f > kDbF || dz->dtype != kBF16 ||
      x->dtype != kBF16) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((k + kDbSpan - 1) / kDbSpan, clients);
  const auto kernel = dense_bwd_vec(*dz, *x, *w, *gw, *dx, k, f)
                          ? dense_bwd_tc_kernel<true>
                          : dense_bwd_tc_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *dz, *x, *w, *mask, *gw, *gb, *dx, rows, k, f, gdt);
  return cudaGetLastError();
}

// fc1's forward for wdtype f32 on the tensor cores in 3xTF32: the same
// arguments as mft_dense_fwd. What mft_dense_fwd_tf32_takes refuses is
// refused, before any launch.
int mft_dense_fwd_tf32_takes(const MftView* x, const MftView* w, int clients,
                             int rows, int k, int f, int wdt) {
  return dense_fwd_tf32_takes(*x, *w, clients, rows, k, f, wdt);
}

int mft_dense_fwd_tf32(const MftView* x, const MftView* w, const MftView* b,
                       const MftView* y, int clients, int rows, int k, int f,
                       int relu, int device, void* stream) {
  if (!dense_fwd_tf32_takes(*x, *w, clients, rows, k, f, kF32)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = mft_smem_optin(dense_fwd_tf32_kernel, kFtSmem);
  if (err != cudaSuccess) return err;
  const int per = (k + kFtSplits - 1) / kFtSplits;
  const int kspan = (per + kFtK - 1) / kFtK * kFtK;
  const dim3 grid(kFtSplits, ((rows + kFtRows - 1) / kFtRows) * (f / kFtCols),
                  clients);
  dense_fwd_tf32_kernel<<<grid, kThreads, kFtSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      *x, *w, *b, *y, rows, k, f, relu, kspan);
  return cudaGetLastError();
}

// fc1's backward for wdtype and gdtype f32 on the tensor cores in 3xTF32:
// the same arguments as mft_dense_bwd. What mft_dense_bwd_tf32_takes
// refuses is refused, before any launch.
int mft_dense_bwd_tf32_takes(const MftView* dz, const MftView* x,
                             const MftView* w, const MftView* gw,
                             const MftView* dx, int clients, int rows, int k,
                             int f, int wdt, int gdt) {
  return dense_bwd_tf32_takes(*dz, *x, *w, *gw, *dx, clients, rows, k, f, wdt,
                              gdt);
}

int mft_dense_bwd_tf32(const MftView* dz, const MftView* x, const MftView* w,
                       const MftView* mask, const MftView* gw,
                       const MftView* gb, const MftView* dx, int clients,
                       int rows, int k, int f, int device, void* stream) {
  if (!dense_bwd_tf32_takes(*dz, *x, *w, *gw, *dx, clients, rows, k, f, kF32,
                            kF32)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = mft_smem_optin(dense_bwd_tf32_kernel, kBtSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((k + kBtSpan - 1) / kBtSpan, clients);
  dense_bwd_tf32_kernel<<<grid, kThreads, kBtSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      *dz, *x, *w, *mask, *gw, *gb, *dx, rows, k, f);
  return cudaGetLastError();
}

const char* mft_client_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
