// Per-client direct convolutions of SimpleCNN's local training, for NVIDIA
// Hopper (sm_90a): every client has its own weights, and one launch serves
// all clients.
//
// Replaces, in multimodal_fl_security_tpu:
//  - ops/client_conv.py::client_stem_conv (K3, the Pallas kernel _stem_kernel):
//    the raw 4x4 stride-2 stem convolution (mode raw) in f32 off K3's own
//    geometry (K3's runs client_stem_raw.cu's kernels);
//  - the convolution parts of ops/fused_kernel.py::fused_local_train (K4):
//    the stem and conv2 of forward_impl with their epilogues, the stem's and
//    conv2's weight gradients (with the stem's fold of its four embedded
//    copies, fold_stem) and conv2's input gradient.
//
// Kernels:
//  - conv_fwd: K x K / stride / pad convolution in f32, raw (K3's contract)
//    off K3's own geometry.
//  - The pooled forward: the convolution, then the 2x2 max-pool epilogue:
//    the max over the four window positions, in (di, dj) order, the first
//    maximum winning, then bias and relu. That is the stem in ConvPoolFused
//    form (a 3x3 SAME conv evaluated at the four pool offsets is the 4x4
//    stride-2 conv on the embedded kernel w4, and the max over its four
//    channel groups) and conv2 + bias + relu + pool. It writes the pooled
//    map and a 2-bit argmax (as one byte) per output: conv2_fwd_tc and
//    stem_fwd_tc for bf16 on the tensor cores, conv2_fwd_tf32 for f32 in
//    3xTF32 and stem_fwd_f32 for f32 on the CUDA cores (their sections
//    below).
//  - The weight gradients: dW and db of one client from the layer's input
//    and the pooled output's gradient, routed through the argmax and the
//    relu inside the kernel. The gradient reaches the 3x3 kernel directly,
//    which is the fold P^T of the four embedded copies. Sums run over the
//    batch in a fixed order, with no atomics: two calls are bitwise equal.
//    conv2_wgrad_tc and stem_wgrad_tc for the compute dtype bf16 on the
//    tensor cores, conv2_wgrad_tf32 and stem_wgrad_tf32 for f32 in 3xTF32
//    (their sections below); no kernel takes another geometry.
//  - conv2_dgrad_tc, conv2_dgrad_tf32: conv2's input gradient in bf16 and
//    in 3xTF32 (the stem needs none).
//  - client_stem_raw.cu's kernels take K3's own geometry.
//
// What bounds conv_fwd: it runs f32 FMA with both operands read from shared
// memory, two shared-memory words per FMA, so shared-memory bandwidth
// (~7e12 words/s over the card) bounds it, far above the HBM and
// tensor-core floors. Design: one block per (client, sample), with the
// client's weights and the sample staged once in shared memory.

#include <cooperative_groups.h>

#include <climits>
#include <cmath>
#include <cstdlib>
#include <type_traits>

#include "client_common.cuh"

namespace cg = cooperative_groups;

// The geometry passed from Python: ConvGeom and MftConvArgs, in
// client_common.cuh.

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(MftView x, MftView w, MftView out, ConvGeom g) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int c = blockIdx.y;
  const int nw = g.k * g.k * g.cin * g.cout;
  float* ws = smem;       // [kh][kw][ci][co]
  float* xs = smem + nw;  // [row][col][ci]
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int co = i % g.cout;
    int r = i / g.cout;
    const int ci = r % g.cin;
    r /= g.cin;
    const int kw = r % g.k;
    const int kh = r / g.k;
    ws[i] = mft_ld(w, mft_off(w, c, co, ci, kh, kw));
  }
  const int nx = g.h * g.w * g.cin;
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    const int ci = i % g.cin;
    const int r = i / g.cin;
    xs[i] = mft_ld(x, mft_off(x, c, n, ci, r / g.w, r % g.w));
  }
  __syncthreads();

  const int nout = g.oh * g.ow * g.cout;
  for (int o = threadIdx.x; o < nout; o += blockDim.x) {
    const int co = o % g.cout;
    const int r = o / g.cout;
    const int ox = r % g.ow;
    const int oy = r / g.ow;
    float acc = 0.f;
    for (int kh = 0; kh < g.k; ++kh) {
      const int iy = oy * g.stride - g.pad + kh;
      if (iy < 0 || iy >= g.h) continue;
      for (int kw = 0; kw < g.k; ++kw) {
        const int ix = ox * g.stride - g.pad + kw;
        if (ix < 0 || ix >= g.w) continue;
        const float* xp = xs + (iy * g.w + ix) * g.cin;
        const float* wp = ws + (kh * g.k + kw) * g.cin * g.cout + co;
        for (int ci = 0; ci < g.cin; ++ci) acc += xp[ci] * wp[ci * g.cout];
      }
    }
    mft_st(out, mft_off(out, c, n, co, oy, ox), acc);
  }
}

// ------------------------------------------------------------ tensor cores
//
// The weight and input gradients for the compute dtype bf16, on Hopper's
// tensor cores: the port's counterpart of the MXU contractions the JAX kernel
// runs for them (kdot3d's VJP, ops/fused_kernel.py:146-156, reached through
// jax.grad at :433 and folded by consolidate_cv2, :262). Each is an implicit
// GEMM on mma.sync.m16n8k16 (bf16 operands, f32 sums) fed by ldmatrix from
// shared-memory tiles; no im2col buffer touches device memory.
//  - conv2_wgrad_tc: dW[co, (kw, ci)] = sum over (n, oy, ox) of
//    dZ[(oy, ox), co] * X[(oy + kh - 1, ox + kw - 1), ci]. One block per
//    (kh, client); A = dZ^T (the dense routed gradient as [64, 196 -> 208]),
//    B = the rows of the zero-bordered input tile [16 x 16, 32] shifted by
//    (kh, kw), through ldmatrix.trans. The sums stay in registers over all
//    the client's samples.
//  - stem_wgrad_tc: the stem's rows (cin <= 8: under ldmatrix's 16 bytes)
//    are materialised as a [256, 9 * cin -> NJP] patch in shared memory, 64
//    pooled windows (256 dense rows, in window order) at a time. A cluster of
//    kStemCluster blocks splits a client's samples; block 0 adds the partials
//    through distributed shared memory, in rank order.
//  - conv2_dgrad_tc: dX[(y, x), ci] = sum over (kh, kw, co) of
//    dZ[(y + 1 - kh, x + 1 - kw), co] * W[co, ci, kh, kw]. One block per
//    (kDgSamples samples, client) stages the client's weights once as
//    [kh][kw][ci][co] bf16; A = the rows of the zero-bordered dZ tile
//    [16 x 16, 64] shifted by (kh, kw).
// dZ is built in shared memory from dp, h and the argmax (the pooled
// gradient through the relu, placed at each window's argmax), and rounded to bf16 (dp is bf16: exact). Every sum runs
// in a fixed order (mma's, then warps', then ranks', in order), with no
// atomics: two calls are bitwise equal.
//
// What bounds them: conv2's weight gradient is 23.1 GFLOP of dense mma over
// 100 clients x 32 samples (0.023 ms at the bf16 peak), its input gradient
// the same, against ~90 MB of operands (0.027 ms at 3.35 TB/s): bytes, by a
// little. What the design leaves as the cost is the staging: every window
// is routed, and every tile element converted from a strided view, by one
// thread. So the main path's layouts (conv2's maps NCHW and its input NHWC,
// the stem's maps NHWC) are read with 16-byte loads, each thread issues all
// its loads of a sample (or of 64 windows) together, into registers, and
// the next sample's loads are in flight while the tensor cores run. Any
// other strides are read one element at a time.

constexpr int kTcThreads = 256;  // 8 warps
constexpr int kTcWarps = kTcThreads / 32;

// conv2's shape: the one the tensor-core conv2 kernels take.
constexpr int kC2In = 32, kC2Out = 64, kC2Hw = 14;
constexpr int kC2Pos = kC2Hw * kC2Hw;             // 196 output positions
constexpr int kC2Pw = kC2Hw / 2;                  // 7
constexpr int kC2Pooled = kC2Pw * kC2Pw;          // 49 windows
constexpr int kC2Wins = kC2Pooled * kC2Out;       // 3136 (co, window) pairs
constexpr int kC2Rows = (kC2Pos + 15) / 16 * 16;  // 208: whole k16 steps
constexpr int kHaloW = kC2Hw + 2;                 // a one-pixel zero border
constexpr int kHaloPix = kHaloW * kHaloW;         // 256
// Row strides (bf16) padded by 16 bytes, so that ldmatrix's eight row
// addresses fall on distinct bank groups.
constexpr int kXRow = kC2In + 8;    // 80 B: [halo pixel][ci] input rows
constexpr int kZRow = kC2Out + 8;   // 144 B: [pixel][co] dZ and weight rows
constexpr int kZCol = kC2Rows + 8;  // 432 B: [co][m] dZ rows
constexpr int kDgSamples = 4;       // samples a dgrad block stages weights for

using bf16 = __nv_bfloat16;

__device__ __forceinline__ bf16 mft_bf16_zero() {
  return __float2bfloat16(0.f);
}

// Element e of 8 packed bytes (e known at compile time once the loops are
// unrolled).
__device__ __forceinline__ int mft_u8_at(const uint2& v, int e) {
  return static_cast<int>(((e < 4 ? v.x : v.y) >> (8 * (e & 3))) & 0xffu);
}

// A view's sample slab (client c, sample n) as a typed pointer.
template <typename T>
__device__ __forceinline__ const T* mft_slab(const MftView& v, int c, int n) {
  return static_cast<const T*>(v.ptr) + c * v.st[0] + n * v.st[1];
}

// conv2's pooled gradient, pooled output (the relu mask) and argmax of one
// sample, as one thread stages them. Window pair i = co * 49 + p (p = oi * 7
// + oj) is routed to route(slot, co, p, q, g): g the gradient through the
// relu, q its argmax's position. Dense: NCHW slabs (dp, h bf16; arg bytes;
// 16-byte aligned), as conv2's forward and fc1's backward write them; the
// thread loads pairs 8 (t + 256 k) .. + 7 with three vector loads each,
// issued together. Otherwise: any strides and types, one element at a time
// when routed.
template <bool kDense>
struct C2Windows;

template <>
struct C2Windows<true> {
  static constexpr int kSlots = 16;
  uint4 dp[2], h[2];
  uint2 q[2];

  __device__ __forceinline__ void load(const MftView& vdp, const MftView& vh,
                                       const MftView& varg, int c, int n) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i0 = 8 * (threadIdx.x + k * kTcThreads);
      if (i0 < kC2Wins) {
        dp[k] = *reinterpret_cast<const uint4*>(mft_slab<bf16>(vdp, c, n) + i0);
        h[k] = *reinterpret_cast<const uint4*>(mft_slab<bf16>(vh, c, n) + i0);
        q[k] = *reinterpret_cast<const uint2*>(
            mft_slab<uint8_t>(varg, c, n) + i0);
      }
    }
  }

  static __device__ __forceinline__ int pair(int slot) {
    return 8 * (threadIdx.x + (slot / 8) * kTcThreads) + slot % 8;
  }

  template <typename Route>
  __device__ __forceinline__ void route(Route&& put) const {
#pragma unroll
    for (int slot = 0; slot < kSlots; ++slot) {
      const int i = pair(slot);
      if (i < kC2Wins) {
        const int k = slot / 8, e = slot % 8;
        const float g =
            mft_bf16_at(h[k], e) > 0.f ? mft_bf16_at(dp[k], e) : 0.f;
        put(slot, i / kC2Pooled, i % kC2Pooled, mft_u8_at(q[k], e), g);
      }
    }
  }
};

template <>
struct C2Windows<false> {
  static constexpr int kSlots = (kC2Wins + kTcThreads - 1) / kTcThreads;
  const MftView *dp_, *h_, *arg_;
  int c_, n_;

  __device__ __forceinline__ void load(const MftView& vdp, const MftView& vh,
                                       const MftView& varg, int c, int n) {
    dp_ = &vdp, h_ = &vh, arg_ = &varg, c_ = c, n_ = n;
  }

  static __device__ __forceinline__ int pair(int slot) {
    return threadIdx.x + slot * kTcThreads;
  }

  template <typename Route>
  __device__ __forceinline__ void route(Route&& put) const {
    for (int slot = 0; slot < kSlots; ++slot) {
      const int i = pair(slot);
      if (i < kC2Wins) {
        const int co = i / kC2Pooled, p = i % kC2Pooled;
        const int oi = p / kC2Pw, oj = p % kC2Pw;
        const float hv = mft_ld(*h_, mft_off(*h_, c_, n_, co, oi, oj));
        const float g =
            hv > 0.f ? mft_ld(*dp_, mft_off(*dp_, c_, n_, co, oi, oj)) : 0.f;
        put(slot, co, p,
            static_cast<int>(mft_ld(*arg_, mft_off(*arg_, c_, n_, co, oi, oj))),
            g);
      }
    }
  }
};

// conv2's input of one sample into the zero-bordered tile xs [halo
// pixel][ci] (bf16). Dense: an NHWC bf16 slab [14][14][32], 16-byte aligned,
// as the stem's forward writes it; four 16-byte chunks a thread, loaded
// together. Otherwise: any strides and types, one element at a time.
template <bool kDense>
struct C2Input;

template <>
struct C2Input<true> {
  static constexpr int kChunks = kC2Pos * kC2In / 8;  // 784
  uint4 v[(kChunks + kTcThreads - 1) / kTcThreads];

  __device__ __forceinline__ void load(const MftView& x, int c, int n) {
#pragma unroll
    for (int k = 0; k < (kChunks + kTcThreads - 1) / kTcThreads; ++k) {
      const int i = threadIdx.x + k * kTcThreads;
      if (i < kChunks) {
        v[k] = *reinterpret_cast<const uint4*>(mft_slab<bf16>(x, c, n) + 8 * i);
      }
    }
  }

  __device__ __forceinline__ void store(bf16* xs) const {
#pragma unroll
    for (int k = 0; k < (kChunks + kTcThreads - 1) / kTcThreads; ++k) {
      const int i = threadIdx.x + k * kTcThreads;
      if (i < kChunks) {
        const int p = i / 4;  // 4 chunks of 8 channels a pixel
        *reinterpret_cast<uint4*>(
            xs + ((p / kC2Hw + 1) * kHaloW + p % kC2Hw + 1) * kXRow +
            8 * (i % 4)) = v[k];
      }
    }
  }
};

template <>
struct C2Input<false> {
  const MftView* x_;
  int c_, n_;

  __device__ __forceinline__ void load(const MftView& x, int c, int n) {
    x_ = &x, c_ = c, n_ = n;
  }

  __device__ __forceinline__ void store(bf16* xs) const {
    for (int i = threadIdx.x; i < kC2Pos * kC2In; i += kTcThreads) {
      const int ci = i % kC2In, p = i / kC2In;
      const int iy = p / kC2Hw, ix = p % kC2Hw;
      xs[((iy + 1) * kHaloW + ix + 1) * kXRow + ci] =
          __float2bfloat16(mft_ld(*x_, mft_off(*x_, c_, n_, ci, iy, ix)));
    }
  }
};

// One block per (kh, client): dW[co, ci, kh, kw] for every co, kw and ci,
// and db (written by the kh = 0 block). Warp w: output channels 16 (w % 4)
// + [0, 16), columns (kw, ci) 48 (w / 4) + [0, 48) of the block's 96. While
// the tensor cores run on sample n, sample n + 1's loads are in flight.
template <bool kDenseX, bool kDenseZ>
__global__ void __launch_bounds__(kTcThreads)
conv2_wgrad_tc_kernel(MftView x, MftView dp, MftView h, MftView arg,
                      MftView gw, MftView gb, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // xs: [halo pixel][ci], the input with its zero border; zs: [co][m],
  // m = oy * 14 + ox, the routed gradient (rows 196.. stay 0).
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* zs = xs + kHaloPix * kXRow;
  const int kh = blockIdx.x;
  const int c = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int li = lane >> 3, lr = lane & 7;  // ldmatrix: matrix, row
  const int co0 = (warp & 3) * 16;
  const int j0 = (warp >> 2) * 48;
  {
    uint32_t* z = reinterpret_cast<uint32_t*>(smem_raw);
    const int words = (kHaloPix * kXRow + kC2Out * kZCol) / 2;
    for (int i = t; i < words; i += kTcThreads) z[i] = 0u;  // borders, pads
  }
  // This lane's ldmatrix rows. A = dZ^T, [co][m]: channel co0 + 8 (li & 1)
  // + lr, positions 8 (li >> 1) + 16 s. B (transposed: rows are positions
  // m): the input pixel under m shifted by (kh, kw), channels ci, for each
  // 16 columns u.
  const uint32_t a_addr = mft_smem_addr(
      zs + (co0 + (li & 1) * 8 + lr) * kZCol + (li >> 1) * 8);
  const uint32_t xs_addr = mft_smem_addr(xs);
  int b_col[3];  // kw * kXRow + ci
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int jj = j0 + 16 * u + (li >> 1) * 8;
    b_col[u] = (jj / kC2In) * kXRow + jj % kC2In;
  }
  C2Input<kDenseX> xr;
  C2Windows<kDenseZ> wr;
  float acc[6][4] = {};
  float db[C2Windows<kDenseZ>::kSlots] = {};  // each slot's sum over samples
  xr.load(x, c, 0);
  wr.load(dp, h, arg, c, 0);
  for (int n = 0; n < batch; ++n) {
    __syncthreads();  // the zero fill, or the previous sample's reads, done
    xr.store(xs);
    // Window (co, p): positions (di, dj) = (0, 0), (0, 1) are adjacent in
    // m, and (1, 0), (1, 1) one row (14) on: two 4-byte stores.
    wr.route([&](int slot, int co, int p, int q, float g) {
      db[slot] += g;
      uint32_t* at = reinterpret_cast<uint32_t*>(
          zs + co * kZCol + 2 * (p / kC2Pw) * kC2Hw + 2 * (p % kC2Pw));
      at[0] = mft_pack2(q == 0 ? g : 0.f, q == 1 ? g : 0.f);
      at[kC2Hw / 2] = mft_pack2(q == 2 ? g : 0.f, q == 3 ? g : 0.f);
    });
    __syncthreads();
    if (n + 1 < batch) {
      xr.load(x, c, n + 1);
      wr.load(dp, h, arg, c, n + 1);
    }
#pragma unroll
    for (int s = 0; s < kC2Rows / 16; ++s) {
      uint32_t a[4];
      ldsm4(a, a_addr + s * 32);
      const int m = s * 16 + (li & 1) * 8 + lr;
      // Pad rows (m >= 196, dZ = 0) read row 0 of the zero border.
      const int base =
          m < kC2Pos ? ((m / kC2Hw + kh) * kHaloW + m % kC2Hw) * kXRow : 0;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        uint32_t b[4];
        ldsm4_t(b, xs_addr + (base + b_col[u]) * 2);
        mma16816(acc[2 * u], a, b[0], b[1]);
        mma16816(acc[2 * u + 1], a, b[2], b[3]);
      }
    }
  }
  const int gq = lane >> 2, tq = lane & 3;  // the accumulators' row, pair
#pragma unroll
  for (int u = 0; u < 6; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = co0 + gq + (e >> 1) * 8;
      const int jj = j0 + 8 * u + 2 * tq + (e & 1);
      mft_st(gw, mft_off(gw, c, co, jj % kC2In, kh, jj / kC2In),
             mft_round(acc[u][e], kBF16));
    }
  }
  if (kh != 0) return;
  __syncthreads();  // the tiles are read: their memory takes the pair sums
  float* red = reinterpret_cast<float*>(smem_raw);  // [co][p]
#pragma unroll
  for (int slot = 0; slot < C2Windows<kDenseZ>::kSlots; ++slot) {
    const int i = C2Windows<kDenseZ>::pair(slot);
    if (i < kC2Wins) red[i] = db[slot];
  }
  __syncthreads();
  if (t < kC2Out) {
    float s = 0.f;
    for (int p = 0; p < kC2Pooled; ++p) s += red[t * kC2Pooled + p];
    mft_st(gb, mft_off(gb, c, 0, t, 0, 0), mft_round(s, kBF16));
  }
}

// ------------------------------------------- conv2's weight gradient, f32
//
// conv2_wgrad_tf32: conv2's dW[co, ci, kh, kw] and db[co] in f32, dW on
// Hopper's tensor cores in 3xTF32 on sparse mma.sp, as stem_wgrad_tf32. It
// replaces, in f32, conv2's weight gradient of fused_local_train (K4;
// multimodal_fl_security_tpu/ops/fused_kernel.py:433, folded by
// consolidate_cv2, :262): dW[co, (kh, kw, ci)] = sum over the dense rows
// (n, oy, ox) of dZ[row, co] X[(oy + kh - 1, ox + kw - 1), ci], and db[co]
// the sum of dZ[row, co]. Per client M = 64, N = 288, K = B x 196.
//  - dZ is sparse in a fixed pattern. With a sample's rows in window order
//    (row 4 p + q: position q = 2 di + dj of pooled window p), a window's
//    four rows hold its gradient at the argmax's q alone, so each pair of
//    rows (q = 0, 1 and 2, 3) holds at most one nonzero: TF32's 1:2
//    structured sparsity. A = dZ^T is staged as its nonzero halves
//    [co][pair] with a 4-bit metadata nibble a pair (0x4 its first row, 0xE
//    its second), and mma.sp.m16n8k16 takes a k16 step (four windows) at
//    1.3x the cost of a dense k8 one (mma.sync on an H100 80GB HBM3: 117 G
//    mma.sp and 153 G dense m16n8k8 TF32 instructions a second). A
//    sample's 49 windows are 13 steps (windows 49-51 hold dZ = 0).
//  - B = the input under each row, shifted by the tap: lane (g, t) of an n8
//    tile holds rows t, t + 4, t + 8, t + 12 of column g, i.e. position t
//    of the step's four windows. The sample's input is staged once, split,
//    as two planes hi and lo [ci][row][col] with its zero border, rows of
//    18 floats and channels of 292 (4 mod 32): each B element is one load
//    from each plane straight into the fragment's registers, and a load's
//    lanes (8 channels x a window's 2 x 2 positions) fall on distinct
//    banks.
//  - Warp w: input channels 8 (w % 4) + [0, 8) at the taps (kh = w / 4,
//    kw = 0..2), 3 n8 tiles, over the four m16 tiles of output channels:
//    each B fragment serves four tiles and each A fragment three. The
//    tiles' dependent mma.sp chains are interleaved.
//  - One block (12 warps) an SM holds the sample's tiles (the input's hi
//    and lo, 2 x 37 KB; dZ's halves, 2 x 27 KB) and a buffer (52 KB) that
//    receives the next sample's input, dp, h and argmax as they are
//    (cp.async) while the tensor cores run: a sample costs two barriers
//    and its staging, by all threads.
//  - db on the CUDA cores, as the windows are routed: thread t sums channel
//    t / 6's windows t % 6 + 6 j over its rank's samples, and the six
//    classes of a channel are then added in order.
//  - A cluster of kWgCluster blocks splits a client's samples; then rank r
//    adds output channels kWgOutCo r + [0, kWgOutCo) of the ranks' sums
//    through distributed shared memory, in rank order, and writes them in
//    dW's own order.
//  - Every operand is split into hi = tf32(a) and lo = tf32(a - hi)
//    (mft_tf32_rne) once, as it is staged; lo hi + hi lo + hi hi. A fresh
//    accumulator takes each kWgChunk steps (12 mma.sp a tile) and is added
//    to the block's sums in f32, chunks and samples in order: the tensor
//    cores' sums do not round to nearest, and a fresh one bounds their
//    truncation. Every sum runs in a fixed order, with no atomics: two
//    calls are bitwise equal.
// What bounds it: 178 MB of operands on the main path (the input, dp and h
// f32, the argmax bytes; 100 clients x 32 samples): 0.053 ms at 3.35 TB/s;
// the routed work is 5.78 GFLOP (0.035 ms in 3xTF32). The design's floor
// is the tensor cores': 18.3 M mma.sp at 117 G a second, 0.156 ms, and
// ~0.19 ms at the rate its step loop reaches alone (~94 G a second). What
// it leaves: the staging between the barriers (a quarter of a block's
// time; splitting the warps so that one half stages while the other runs
// its steps, into a second tile, measured slower), and 7 waves of 16
// clusters for 100 clients (28 samples a block slot, 25 on average).

constexpr int kWgThreads = 384;  // 12 warps
constexpr int kWgCluster = 8;    // blocks splitting a client
constexpr int kWgSteps = 13;     // k16 steps a sample: windows 0-51
constexpr int kWgChunk = 4;      // k16 steps a fresh accumulator takes
constexpr int kWgXRow = kHaloW + 2;            // 18 floats a row
constexpr int kWgXCi = kHaloW * kWgXRow + 4;   // 292 floats a channel
constexpr int kWgZRow = 8 * kWgSteps + 4;      // 108 floats: [co][pair]
constexpr int kWgMetaStep = 4 * 16 + 2;        // metadata words a step
constexpr int kWgTaps = 9 * kC2In;             // 288 columns (tap, ci)
constexpr int kWgRedRow = kWgTaps + 8;         // 296 floats: [co][tap][ci]
constexpr int kWgOutCo = kC2Out / kWgCluster;  // 8 channels a rank writes
constexpr int kWgOutRow = kWgTaps + 1;         // 289 floats: [co][ci][tap]
constexpr int kWgXChunks = kC2Pos * kC2In / 4;  // 1568 16-byte chunks
constexpr int kWgZChunks = kC2Wins / 4;         // 784
constexpr int kWgDbClasses = kWgThreads / kC2Out;  // of a channel's windows
constexpr size_t kWgXBytes = sizeof(float) * kC2In * kWgXCi;
constexpr size_t kWgZBytes = sizeof(float) * kC2Out * kWgZRow;
constexpr size_t kWgTiles = 2 * kWgXBytes + 2 * kWgZBytes;
constexpr size_t kWgMetaBytes =  // whole 16-byte chunks
    (sizeof(uint32_t) * kWgSteps * kWgMetaStep + 15) / 16 * 16;
// The next sample as it is: x [pixel][ci], dp and h [co][window] f32, the
// argmax [co][window] bytes.
constexpr size_t kWgRawX = sizeof(float) * kC2Pos * kC2In;
constexpr size_t kWgRawZ = sizeof(float) * kC2Wins;
constexpr size_t kWgRaw = kWgRawX + 2 * kWgRawZ + kC2Wins;
constexpr size_t kWgSmem = kWgTiles + kWgMetaBytes + kWgRaw;
// Laid over the tiles once the steps are done: the block's sums [co][tap]
// [ci], its db partials [class][co] and db [co], and the rank's outputs.
constexpr size_t kWgSums =
    sizeof(float) * (kC2Out * kWgRedRow + (kWgDbClasses + 1) * kC2Out +
                     kWgOutCo * kWgOutRow);

static_assert(kWgXCi % 32 == 4 && kWgXRow % 4 == 2 &&
                  kWgThreads % kC2Out == 0,
              "a B load's lanes on distinct banks; whole classes a channel");
static_assert(kWgZRow % 8 == 4 && kWgRedRow % 32 == 8,
              "ldmatrix rows and the sums' stores on distinct banks");
static_assert(4 * kWgSteps >= kC2Pooled && kWgSums <= kWgTiles,
              "13 steps a sample; the sums lie over the tiles");
static_assert((kWgTiles + kWgMetaBytes) % 16 == 0 && kWgRawX % 16 == 0 &&
                  kWgRawZ % 16 == 0 && kWgSmem <= kMftMaxSmem,
              "16-byte aligned copies; one block an SM");

// Element e of a float4 (e known at compile time once the loops are
// unrolled).
__device__ __forceinline__ float mft_f4_at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// d += a (16 x 16 with at most one nonzero in each pair of columns, given as
// its 16 x 8 nonzero half; row-major) * b (16 x 8, column-major): tf32 in,
// f32 sums. e: the pairs' metadata, from lanes 4 g and 4 g + 1 (selector
// 0): lane 4 g's nibbles 0-3 for row g and 4-7 for row g + 8 over the
// compressed columns 0-3, lane 4 g + 1's over columns 4-7; a nibble is 0x4
// for a pair's first element, 0xE for its second. The b fragment: lane
// (g, t) holds rows t, t + 4, t + 8, t + 12 of column g.
__device__ __forceinline__ void mma_sp16816_tf32(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 const uint32_t (&b)[4],
                                                 uint32_t e) {
  asm volatile(
      "mma.sp.sync.aligned.m16n8k16.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9, %10, %11}, "
      "{%0, %1, %2, %3}, %12, 0x0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "r"(b[2]), "r"(b[3]), "r"(e));
}

// Grid (client, rank); rank r sums samples [r B / kWgCluster, (r + 1) B /
// kWgCluster) of its client. kDenseX: the input is an NHWC f32 slab
// [14][14][32], 16-byte aligned, as the stem's f32 forward writes it;
// kDenseZ: dp, h and the argmax are NCHW slabs (dp, h f32, arg bytes),
// 16-byte aligned, as fc1's f32 backward and conv2's f32 forward write
// them. Those are copied whole into the buffer by cp.async, a sample ahead;
// other strides and types are read one element at a time as the sample is
// staged.
template <bool kDenseX, bool kDenseZ>
__global__ void __cluster_dims__(1, kWgCluster, 1)
    __launch_bounds__(kWgThreads, 1)
conv2_wgrad_tf32_kernel(MftView x, MftView dp, MftView h, MftView arg,
                        MftView gw, MftView gb, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xh = reinterpret_cast<float*>(smem_raw);  // [ci][row][col]
  float* xl = xh + kC2In * kWgXCi;
  float* zh = xl + kC2In * kWgXCi;  // [co][pair]
  float* zl = zh + kC2Out * kWgZRow;
  unsigned char* meta_b = smem_raw + kWgTiles;
  const uint32_t* meta = reinterpret_cast<const uint32_t*>(meta_b);
  unsigned char* raw = meta_b + kWgMetaBytes;
  const float* raw_x = reinterpret_cast<const float*>(raw);
  const float* raw_dp = reinterpret_cast<const float*>(raw + kWgRawX);
  const float* raw_h = raw_dp + kC2Wins;
  const unsigned char* raw_arg = raw + kWgRawX + 2 * kWgRawZ;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int li = lane >> 3, lr = lane & 7;
  const int gq = lane >> 2, tq = lane & 3;
  const int kh = warp / 4, ci0 = 8 * (warp % 4);
  const int n0 = static_cast<int>(static_cast<long long>(rank) * batch /
                                  kWgCluster);
  const int n1 = static_cast<int>(static_cast<long long>(rank + 1) * batch /
                                  kWgCluster);
  // The input's border (never written again), windows 49-51 (dZ = 0) and
  // every metadata nibble a first element's.
  for (int i = t; i < 2 * kC2In * kWgXCi; i += kWgThreads) xh[i] = 0.f;
  for (int i = t; i < kC2Out * 6; i += kWgThreads) {
    const int at = i / 6 * kWgZRow + 2 * kC2Pooled + i % 6;
    zh[at] = 0.f;
    zl[at] = 0.f;
  }
  for (int i = t; i < kWgSteps * kWgMetaStep; i += kWgThreads) {
    reinterpret_cast<uint32_t*>(meta_b)[i] = 0x44444444u;
  }
  float db = 0.f;  // channel t / 6's windows t % 6 + 6 j over the samples
  // Sample n's dense operands into the buffer, as they are.
  const uint32_t raw_addr = mft_smem_addr(raw);
  auto fetch = [&](int n) {
    if constexpr (kDenseX) {
      const float* xn = mft_slab<float>(x, c, n);
      for (int i = t; i < kWgXChunks; i += kWgThreads) {
        mft_cp_async16(raw_addr + 16 * i, xn + 4 * i, 16);
      }
    }
    if constexpr (kDenseZ) {
      const float* dn = mft_slab<float>(dp, c, n);
      const float* hn = mft_slab<float>(h, c, n);
      const uint8_t* an = mft_slab<uint8_t>(arg, c, n);
      for (int i = t; i < 2 * kWgZChunks + kC2Wins / 16; i += kWgThreads) {
        const void* src =
            i < kWgZChunks ? static_cast<const void*>(dn + 4 * i)
            : i < 2 * kWgZChunks
                ? static_cast<const void*>(hn + 4 * (i - kWgZChunks))
                : static_cast<const void*>(an + 16 * (i - 2 * kWgZChunks));
        mft_cp_async16(raw_addr + kWgRawX + 16 * i, src, 16);
      }
    }
    mft_cp_async_commit();
  };
  // Window (co, p) of the sample, its gradient g at position q: pair 2 p
  // (q = 0, 1) or 2 p + 1 (q = 2, 3) of row co holds g, the other 0; the
  // metadata byte of the window's two pairs lies in word (step p / 4, m16
  // tile co / 16, row co % 8, half (p % 4) / 2), half-word (co % 16) / 8.
  auto put = [&](int co, int p, int q, float g) {
    const float gh = mft_tf32_rne(g), gl = mft_tf32_rne(g - gh);
    const bool top = q < 2;
    const int at = co * kWgZRow + 2 * p;
    *reinterpret_cast<float2*>(zh + at) =
        make_float2(top ? gh : 0.f, top ? 0.f : gh);
    *reinterpret_cast<float2*>(zl + at) =
        make_float2(top ? gl : 0.f, top ? 0.f : gl);
    meta_b[((p / 4) * kWgMetaStep + co / 16 * 16 + co % 8 * 2 + p % 4 / 2) *
               4 +
           co % 16 / 8 * 2 + p % 2] =
        static_cast<unsigned char>((q == 1 ? 0xEu : 0x4u) |
                                   (q == 3 ? 0xE0u : 0x40u));
  };
  // Sample n into the tiles: its input split into xh and xl's interior,
  // and its windows routed (the gradient through the relu, h > 0) into zh,
  // zl and the metadata. The input: thread t takes 16-byte chunks t + 384
  // k, their four elements in the turned order e + cg4 / 2 (mod 4), so that
  // one turn's stores of a warp fall on distinct banks.
  auto stage = [&](int n) {
    if constexpr (kDenseX) {
#pragma unroll 1
      for (int i = t; i < kWgXChunks; i += kWgThreads) {
        const float4 v = reinterpret_cast<const float4*>(raw_x)[i];
        const int px = i / 8, cg4 = i % 8;  // pixel, channels 4 cg4 + [0, 4)
        const int at = 4 * cg4 * kWgXCi + (px / kC2Hw + 1) * kWgXRow +
                       px % kC2Hw + 1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = (e + cg4 / 2) & 3;
          const float a = f == 0 ? v.x : f == 1 ? v.y : f == 2 ? v.z : v.w;
          const float hi = mft_tf32_rne(a);
          xh[at + f * kWgXCi] = hi;
          xl[at + f * kWgXCi] = mft_tf32_rne(a - hi);
        }
      }
    } else {
      for (int i = t; i < kC2In * kC2Pos; i += kWgThreads) {
        const int ci = i / kC2Pos, px = i % kC2Pos;
        const int y = px / kC2Hw, xx = px % kC2Hw;
        const float a = mft_ld(x, mft_off(x, c, n, ci, y, xx));
        const float hi = mft_tf32_rne(a);
        const int at = ci * kWgXCi + (y + 1) * kWgXRow + xx + 1;
        xh[at] = hi;
        xl[at] = mft_tf32_rne(a - hi);
      }
    }
    // Thread t: channel co = t / 6, windows t % 6 + 6 j (a warp's stores of
    // one turn on distinct banks); db its sum of them.
    const int co = t / kWgDbClasses;
#pragma unroll 3
    for (int p = t % kWgDbClasses; p < kC2Pooled; p += kWgDbClasses) {
      float g;
      int q;
      if constexpr (kDenseZ) {
        const int w = co * kC2Pooled + p;
        g = raw_h[w] > 0.f ? raw_dp[w] : 0.f;
        q = raw_arg[w];
      } else {
        const int oi = p / kC2Pw, oj = p % kC2Pw;
        g = mft_ld(h, mft_off(h, c, n, co, oi, oj)) > 0.f
                ? mft_ld(dp, mft_off(dp, c, n, co, oi, oj))
                : 0.f;
        q = static_cast<int>(mft_ld(arg, mft_off(arg, c, n, co, oi, oj)));
      }
      db += g;
      put(co, p, q, g);
    }
  };

  // ldmatrix: A (dZ^T's halves) matrix li is channels 8 (li & 1) + [0, 8)
  // of an m16 tile, pairs 4 (li >> 1) + [0, 4) of a step: a0 .. a3.
  const uint32_t a_off = static_cast<uint32_t>(
      ((8 * (li & 1) + lr) * kWgZRow + 4 * (li >> 1)) * sizeof(float));
  const uint32_t zh_addr = mft_smem_addr(zh) + a_off;
  const uint32_t zl_addr = mft_smem_addr(zl) + a_off;
  constexpr uint32_t kZTile16 = 16 * kWgZRow * sizeof(float);
  // This lane's metadata word of a step and m16 tile (lanes 4 g + 2 and
  // 4 g + 3 read one that the instruction ignores).
  const uint32_t* meta_at = meta + gq * 2 + (tq & 1);
  // B: this lane's column (input channel ci0 + gq) and position tq of a
  // window whose top-left output pixel is (0, 0), at tap (kh, 0); n8 tile
  // u is kw = u.
  const int xb = (ci0 + gq) * kWgXCi + (tq / 2 + kh) * kWgXRow + tq % 2;
  // The block's sums and the current chunk's: [m16 tile][n8 tile (kw)]
  // [fragment].
  float acc[4][3][4] = {}, chunk[4][3][4];

  if (n0 < n1) fetch(n0);
  for (int n = n0; n < n1; ++n) {
    mft_cp_async_wait<0>();  // this thread's copies of sample n
    __syncthreads();  // every copy landed; the previous steps are done
    stage(n);
    __syncthreads();
    if (n + 1 < n1) fetch(n + 1);  // the buffer is read: the next sample
    for (int s = 0; s < kWgSteps; ++s) {
      uint32_t ahi[4][4], alo[4][4], e[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t o = m * kZTile16 + s * 8 * sizeof(float);
        ldsm4(ahi[m], zh_addr + o);
        ldsm4(alo[m], zl_addr + o);
        e[m] = meta_at[s * kWgMetaStep + m * 16];
      }
      int wo[4];  // each window's top-left pixel in the tile, from xb
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int p = min(4 * s + v, kC2Pooled - 1);  // past 48: dZ = 0
        const int oi = (p * 37) >> 8;                 // p / 7 for p < 52
        wo[v] = 2 * oi * kWgXRow + 2 * (p - kC2Pw * oi);
      }
      if (s % kWgChunk == 0) {  // a fresh accumulator
#pragma unroll
        for (int m = 0; m < 4; ++m) {
#pragma unroll
          for (int u = 0; u < 3; ++u) {
#pragma unroll
            for (int q = 0; q < 4; ++q) chunk[m][u][q] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        uint32_t bh[4], bl[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          bh[v] = __float_as_uint(xh[xb + wo[v] + u]);
          bl[v] = __float_as_uint(xl[xb + wo[v] + u]);
        }
        // The four tiles' chains interleaved: a dependent mma.sp waits out
        // the previous one's latency, so each issue goes to another tile.
        // The small terms first.
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          mma_sp16816_tf32(chunk[m][u], alo[m], bh, e[m]);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          mma_sp16816_tf32(chunk[m][u], ahi[m], bl, e[m]);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          mma_sp16816_tf32(chunk[m][u], ahi[m], bh, e[m]);
        }
      }
      if (s % kWgChunk == kWgChunk - 1 || s == kWgSteps - 1) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
#pragma unroll
          for (int u = 0; u < 3; ++u) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[m][u][q] += chunk[m][u][q];
          }
        }
      }
    }
  }

  __syncthreads();  // the tiles are read: their memory takes the sums
  float* red = reinterpret_cast<float*>(smem_raw);  // [co][tap][ci]
  float* dbp = red + kC2Out * kWgRedRow;             // [class][co]
  float* rdb = dbp + kWgDbClasses * kC2Out;          // [co]
  float* out = rdb + kC2Out;                         // [co][ci][tap]
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int co = 16 * m + gq + 8 * r;
        const int j = (3 * kh + u) * kC2In + ci0 + 2 * tq;
        *reinterpret_cast<float2*>(red + co * kWgRedRow + j) =
            make_float2(acc[m][u][2 * r], acc[m][u][2 * r + 1]);
      }
    }
  }
  dbp[t % kWgDbClasses * kC2Out + t / kWgDbClasses] = db;
  __syncthreads();
  if (t < kC2Out) {
    float s = dbp[t];
    for (int g = 1; g < kWgDbClasses; ++g) s += dbp[g * kC2Out + t];
    rdb[t] = s;
  }
  cluster.sync();  // every rank's sums are in its shared memory
  const float* ranks[kWgCluster];
#pragma unroll
  for (int r = 0; r < kWgCluster; ++r) {
    ranks[r] = cluster.map_shared_rank(red, r);
  }
  static_assert(kWgOutCo * kWgTaps % kWgThreads == 0, "whole turns");
#pragma unroll
  for (int k = 0; k < kWgOutCo * kWgTaps / kWgThreads; ++k) {
    const int i = t + k * kWgThreads;
    const int col = i / kWgTaps, j = i % kWgTaps;  // j = tap * 32 + ci
    const int at = (kWgOutCo * rank + col) * kWgRedRow + j;
    float s = ranks[0][at];
#pragma unroll
    for (int r = 1; r < kWgCluster; ++r) s += ranks[r][at];
    out[col * kWgOutRow + j % kC2In * 9 + j / kC2In] = s;
  }
  if (t < kWgOutCo) {
    const int co = kWgOutCo * rank + t;
    float s = cluster.map_shared_rank(rdb, 0)[co];
    for (int r = 1; r < kWgCluster; ++r) {
      s += cluster.map_shared_rank(rdb, r)[co];
    }
    mft_st(gb, mft_off(gb, c, 0, co, 0, 0), s);
  }
  __syncthreads();
  for (int i = t; i < kWgOutCo * kWgTaps; i += kWgThreads) {
    const int col = i / kWgTaps, o = i % kWgTaps;  // o = ci * 9 + tap
    mft_st(gw, mft_off(gw, c, kWgOutCo * rank + col, o / 9, o % 9 / 3, o % 3),
           out[col * kWgOutRow + o]);
  }
  cluster.sync();  // the other ranks have read this one's shared memory
}

// --------------------------------------------- conv2's input gradient, f32
//
// conv2_dgrad_tf32: conv2's input gradient in f32, on warpgroup wgmma TF32
// in 3xTF32. It replaces, in f32, the da of _kdot3d_bwd
// (multimodal_fl_security_tpu/ops/fused_kernel.py:144-154), reached through
// jax.grad at :433 inside fused_local_train (K4): dX[(y, x), ci] = sum over
// (kh, kw, co) of dZ[(y + 1 - kh, x + 1 - kw), co] W[co, ci, kh, kw]; per
// sample M = 196, N = 32, K = 576.
// What bounds it: the routed work (dZ is nonzero at one position of a
// window) is ~5.8 GFLOP over 100 clients x 32 samples at the north star
// (0.035 ms in 3xTF32, 0.086 at the f32 CUDA-core rate) against 178 MB of
// operands (dp, h, the argmax, W, dX: 0.053 ms at 3.35 TB/s): bytes. The
// dense GEMM the tensor cores run is 23.1 GFLOP, 69 GFLOP of TF32 products
// in 3xTF32 (0.14 ms at 495 TFLOP/s).
// What the design does about it:
//  - A client's samples are stacked into one map kDtL = 15 pixels wide:
//    sample n's rows y at stacked rows 15 n + 1 + y, row 15 n and column 14
//    zero, so that a zero row and a zero column border every sample on all
//    four sides. A GEMM row m is a stacked pixel, and tap (kh, kw) reads
//    the A row m + 15 (1 - kh) + (1 - kw): a shift of the whole tile. 196
//    of a sample's 225 rows are outputs (87%), and 64-row tiles run on over
//    sample boundaries.
//  - A (dZ, split into hi and lo once) is staged as planes [4 co][pixel][4
//    co] and read into registers by ldmatrix at the shifted rows (16-byte
//    rows, at any offset); B is W staged [tap][n][co], K-major, W_hi in
//    rows n 0-31 and W_lo in 32-63, a client's hi and lo resident (144 KB).
//    wgmma.m64n32k8 from registers: A_lo W_hi, A_hi W_lo, A_hi W_hi.
//  - An item is 4 tiles (256 rows) of one client; a persistent grid of at
//    most one block an SM walks a contiguous range of the C x ceil((225 B -
//    16) / 256) items (restaging W when the client changes), so the last
//    wave is at most one item short at any (C, B).
//  - Warp-specialised: two producer warpgroups route an item's windows
//    (the relu through h > 0, the position from the argmax) into a ring of
//    two stages of 16 channels each (pixels [m0 - 16, m0 + 272), 36 KB),
//    each owning one slot and holding its next stage's loads in registers,
//    while two consumer warpgroups, two tiles each, run the stage before;
//    named barriers hand the stages over, and setmaxnreg moves registers
//    from the producers to the consumers' wgmma pipeline.
//  - The tensor cores' f32 sums do not round to nearest (gram.cu): a fresh
//    accumulator takes each (stage, tap) of a tile (2 k8 steps) and is
//    added to the sums in f32. Every sum runs in a fixed order, with no
//    atomics: two calls are bitwise equal.

constexpr int kDtThreads = 512;  // two consumer warpgroups, two producers
constexpr int kDtL = kC2Hw + 1;         // 15: a stacked row, column 14 zero
constexpr int kDtSample = kDtL * kDtL;  // 225 stacked pixels a sample
constexpr int kDtTiles = 4;             // 64-row tiles an item
constexpr int kDtRows = 64 * kDtTiles;  // 256
constexpr int kDtReach = kDtL + 1;      // 16: the farthest a tap reaches
constexpr int kDtPix = kDtRows + 2 * kDtReach;  // 288 pixels a stage
constexpr int kDtCo = 16;                       // channels co a stage
constexpr int kDtStages = kC2Out / kDtCo;       // 4 an item
constexpr int kDtLbo = kDtPix * 16;             // A: to the next 4 co
constexpr int kDtPlane = kDtCo / 4 * kDtLbo;    // A's hi, or its lo: 18 KB
constexpr int kDtWSbo = kC2Out / 4 * 128;       // B: to the next 8 rows n
constexpr int kDtWTap = 2 * kC2In * kC2Out * 4;  // a tap's [W_hi | W_lo]
constexpr size_t kDtSmem = 9 * kDtWTap + 2 * 2 * kDtPlane;  // 216 KB
constexpr int kDtFull = 1, kDtEmpty = 3;  // named barriers of slot 0 (+1)
constexpr int kDtBarThreads = 384;        // both consumers and a producer
// setmaxnreg: the producers give registers to the consumers' wgmma pipeline.
constexpr int kDtProducerRegs = 104, kDtConsumerRegs = 152;

static_assert(kDtSmem <= kMftMaxSmem, "one block an SM");
static_assert(kDtCo / 4 * kDtPix % 128 == 0 && kDtStages % 2 == 0,
              "whole float4 tasks a producer thread; fills in pairs");
static_assert(kDtThreads / 2 * (kDtProducerRegs + kDtConsumerRegs) <= 65536,
              "the register file holds both roles' shares");

// Named barriers of the two consumer warpgroups and one producer.
__device__ __forceinline__ void dt_bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kDtBarThreads)
               : "memory");
}

__device__ __forceinline__ void dt_bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kDtBarThreads)
               : "memory");
}

// The sample n, row y and column x of stacked pixel u of a client's map
// (false: a zero pixel: a border, or past the client's samples).
__device__ __forceinline__ bool dt_pixel(int u, int batch, int& n, int& y,
                                         int& x) {
  const int r = u / kDtL;
  x = u - r * kDtL;
  n = r / kDtL;
  y = r - n * kDtL - 1;
  return u >= 0 && x < kC2Hw && y >= 0 && n < batch;
}

// A stage's raw windows in a producer thread's registers: task pt + 128 j
// is (sample, channel quad cq, window p) of the up to 3 samples whose
// pixels the stage holds, 16 channels x 49 windows a sample; the pooled
// gradient and the pooled map of its 4 channels, and their argmax bytes.
constexpr int kDtBlock = kDtCo * kC2Pooled;               // 784 pairs
constexpr int kDtGroups = (3 * kDtBlock / 4 + 127) / 128;  // 5 a thread

struct DtRaw {
  float dp[kDtGroups][4], h[kDtGroups][4];
  uint32_t q[kDtGroups];
};

// The first sample whose pixels stacked pixels u0 + [0, kDtPix) hold.
__device__ __forceinline__ int dt_first_sample(int u0) {
  return u0 > 0 ? u0 / kDtSample : 0;
}

// Loads stage s of the item at stacked pixel u0 of client c into r: 12
// scalar loads a task, a warp's 32 consecutive windows of a channel in one
// 128-byte line. Dense: dp, h and the argmax are NCHW slabs.
template <bool kDenseZ>
__device__ __forceinline__ void dt_load(DtRaw& r, const MftView& dp,
                                        const MftView& h, const MftView& arg,
                                        int c, int batch, int u0, int s,
                                        int pt) {
  const int n0 = dt_first_sample(u0);
#pragma unroll
  for (int j = 0; j < kDtGroups; ++j) {
    const int gi = pt + 128 * j, n = n0 + gi / (kDtBlock / 4);
    const int rem = gi % (kDtBlock / 4), cq = rem / kC2Pooled;
    const int p = rem - cq * kC2Pooled;
    if (gi >= 3 * kDtBlock / 4 || n >= batch) continue;  // dt_route skips
    const int co = kDtCo * s + 4 * cq;
    if (kDenseZ) {
      const int off = co * kC2Pooled + p;
      const float* dps = mft_slab<float>(dp, c, n) + off;
      const float* hs = mft_slab<float>(h, c, n) + off;
      const uint8_t* as = mft_slab<uint8_t>(arg, c, n) + off;
      uint32_t q = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r.dp[j][e] = dps[e * kC2Pooled];
        r.h[j][e] = hs[e * kC2Pooled];
        q |= static_cast<uint32_t>(as[e * kC2Pooled]) << (8 * e);
      }
      r.q[j] = q;
    } else {
      const int wy = p / kC2Pw, wx = p % kC2Pw;
      uint32_t q = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r.dp[j][e] = mft_ld(dp, mft_off(dp, c, n, co + e, wy, wx));
        r.h[j][e] = mft_ld(h, mft_off(h, c, n, co + e, wy, wx));
        q |= static_cast<uint32_t>(
                 mft_ld(arg, mft_off(arg, c, n, co + e, wy, wx)))
             << (8 * e);
      }
      r.q[j] = q;
    }
  }
}

// Stage s of the item at u0 from r into the hi and lo planes [co / 4]
// [pixel][co % 4] of a ring slot: each window's gradient through the relu
// (h > 0) at its argmax's position and 0 at the other three, split into hi
// and lo, 4 channels in one 16-byte store a plane; positions outside the
// stage's pixels are skipped, and a thread visits a window's positions
// starting at its own, so that a warp's stores spread over the banks. The
// first use of a slot in an item (s < 2) first zeroes the borders (column
// 14, each sample's row 0, pixels past the client's samples); later stages
// overwrite only the samples' pixels.
__device__ __forceinline__ void dt_route(float* hi, const DtRaw& r,
                                         int batch, int u0, int s, int pt) {
  float* lo = hi + kDtPlane / 4;
  if (s < 2) {
#pragma unroll
    for (int k = 0; k < kDtCo / 4 * kDtPix / 128; ++k) {
      const int id = pt + 128 * k;
      const int cc = id / kDtPix, v = id - cc * kDtPix;
      int n, y, x;
      if (!dt_pixel(u0 + v, batch, n, y, x)) {
        const int at = cc * (kDtLbo / 4) + v * 4;
        *reinterpret_cast<float4*>(hi + at) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(lo + at) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  const int n0 = dt_first_sample(u0);
#pragma unroll
  for (int j = 0; j < kDtGroups; ++j) {
    const int gi = pt + 128 * j, n = n0 + gi / (kDtBlock / 4);
    if (gi >= 3 * kDtBlock / 4 || n >= batch) continue;
    const int rem = gi % (kDtBlock / 4), cq = rem / kC2Pooled;
    const int p = rem - cq * kC2Pooled, wy = p / kC2Pw, wx = p % kC2Pw;
    float gh[4], gl[4];
    int q[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float g = r.h[j][e] > 0.f ? r.dp[j][e] : 0.f;
      gh[e] = mft_tf32_rne(g);
      gl[e] = mft_tf32_rne(g - gh[e]);
      q[e] = static_cast<int>((r.q[j] >> (8 * e)) & 0xffu);
    }
    const int v0 = kDtSample * n + kDtL * (2 * wy + 1) + 2 * wx - u0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int pos = (k + pt) & 3;
      const int v = v0 + kDtL * (pos >> 1) + (pos & 1);
      if (static_cast<unsigned>(v) < static_cast<unsigned>(kDtPix)) {
        const int at = cq * (kDtLbo / 4) + 4 * v;
        *reinterpret_cast<float4*>(hi + at) = make_float4(
            pos == q[0] ? gh[0] : 0.f, pos == q[1] ? gh[1] : 0.f,
            pos == q[2] ? gh[2] : 0.f, pos == q[3] ? gh[3] : 0.f);
        *reinterpret_cast<float4*>(lo + at) = make_float4(
            pos == q[0] ? gl[0] : 0.f, pos == q[1] ? gl[1] : 0.f,
            pos == q[2] ? gl[2] : 0.f, pos == q[3] ? gl[3] : 0.f);
      }
    }
  }
}

// A fragments of a tile's 2 k8 steps at a tap, hi and lo, by ldmatrix
// (lane l: row 16 (warp) + 8 ((l / 8) & 1) + l % 8 of the tile, k 4 (l /
// 16) + [0, 4)): la is this lane's address in the stage's hi plane.
__device__ __forceinline__ void dt_frags(uint32_t (&ah)[2][4],
                                         uint32_t (&al)[2][4], uint32_t la) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    ldsm4(ah[kk], la + 2 * kk * kDtLbo);
    ldsm4(al[kk], la + 2 * kk * kDtLbo + kDtPlane);
  }
}

// One chunk into d: a tap of a stage for a 64-row tile, 2 k8 steps of
// A_lo W_hi, A_hi W_lo, then A_hi W_hi (the small terms first), the first
// starting d afresh. b: the tap's co chunk in W (W_lo 32 rows on).
__device__ __forceinline__ void dt_chunk(float (&d)[16],
                                         const uint32_t (&ah)[2][4],
                                         const uint32_t (&al)[2][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint32_t bk = b + 2 * kk * 128;
    const uint64_t dbh = mft_wgmma_desc(bk, 128, kDtWSbo);
    const uint64_t dbl = mft_wgmma_desc(bk + 4 * kDtWSbo, 128, kDtWSbo);
    if (kk == 0) {
      mft_wgmma_tf32_n32_rs<false>(d, al[kk], dbh);
    } else {
      mft_wgmma_tf32_n32_rs<true>(d, al[kk], dbh);
    }
    mft_wgmma_tf32_n32_rs<true>(d, ah[kk], dbl);
    mft_wgmma_tf32_n32_rs<true>(d, ah[kk], dbh);
  }
}

// acc += a completed chunk, in f32.
__device__ __forceinline__ void dt_add(float (&acc)[16], float (&d)[16]) {
  mft_wgmma_fence_operands(d);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] += d[i];
}

// Grid: at most one block an SM; block b takes items [b I / G, (b + 1) I /
// G) of the I = clients x items_per_client. Dense dX: an NHWC f32 slab
// [14][14][32], 16-byte aligned, written two channels (8 bytes) a store;
// otherwise any strides and types, one element at a time.
template <bool kDenseZ, bool kDenseX>
__global__ void __launch_bounds__(kDtThreads, 1)
conv2_dgrad_tf32_kernel(MftView dp, MftView h, MftView arg, MftView w,
                        MftView dx, int batch, int items_per_client,
                        long long total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);  // [tap][n][co], K-major
  float* as = ws + 9 * kDtWTap / 4;                // [slot][hi, lo] planes
  const long long i0 = blockIdx.x * total / gridDim.x;
  const int count =
      static_cast<int>((blockIdx.x + 1) * total / gridDim.x - i0);
  const int t = threadIdx.x, wg = t / 128;

  // W[c], split: float4 (tap, n, co / 4) holds co .. co + 3 of row n = ci
  // (hi) and row 32 + ci (lo); 128 consecutive tasks fill 2 KB.
  auto stage_w = [&](int c) {
#pragma unroll 4
    for (int id = t; id < 9 * kC2In * kC2Out / 4; id += kDtThreads) {
      const int ci = (id / 128) % 4 * 8 + id % 8, kq = id / 8 % 16;
      const int tap = id / 512;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = mft_ld(w, mft_off(w, c, 4 * kq + e, ci, tap / 3, tap % 3));
      }
      const float4 hv = make_float4(mft_tf32_rne(v[0]), mft_tf32_rne(v[1]),
                                    mft_tf32_rne(v[2]), mft_tf32_rne(v[3]));
      float* dst =
          ws + tap * (kDtWTap / 4) + ci / 8 * (kDtWSbo / 4) + kq * 32 +
          ci % 8 * 4;
      *reinterpret_cast<float4*>(dst) = hv;
      *reinterpret_cast<float4*>(dst + 4 * (kDtWSbo / 4)) = make_float4(
          mft_tf32_rne(v[0] - hv.x), mft_tf32_rne(v[1] - hv.y),
          mft_tf32_rne(v[2] - hv.z), mft_tf32_rne(v[3] - hv.w));
    }
  };
  // Every thread meets the others here when the client changes: the old
  // W's wgmmas have completed, and the new W is visible to wgmma after.
  int client = -1;
  auto switch_w = [&](int c) {
    if (c == client) return;
    __syncthreads();
    stage_w(c);
    mft_fence_proxy_async();
    __syncthreads();
    client = c;
  };
  const int fills = kDtStages * count;

  if (wg >= 2) {  // producer ph fills slot ph: fills ph, ph + 2, ...
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kDtProducerRegs)
                 : "memory");
    const int pt = t % 128, ph = wg - 2;
    auto at = [&](int k, int& c, int& u0) {
      const long long item = i0 + k / kDtStages;
      c = static_cast<int>(item / items_per_client);
      u0 = static_cast<int>(item % items_per_client) * kDtRows + kDtL -
           kDtReach;
    };
    DtRaw raw;  // the next fill's windows
    int c, u0;
    at(ph, c, u0);
    dt_load<kDenseZ>(raw, dp, h, arg, c, batch, u0, ph, pt);
    for (int k = ph; k < fills; k += 2) {
      at(k, c, u0);
      if (k % kDtStages == ph) switch_w(c);
      if (k >= 2) dt_bar_sync(kDtEmpty + ph);
      dt_route(as + ph * 2 * (kDtPlane / 4), raw, batch, u0, k % kDtStages,
               pt);
      mft_fence_proxy_async();
      dt_bar_arrive(kDtFull + ph);
      if (k + 2 < fills) {
        at(k + 2, c, u0);
        dt_load<kDenseZ>(raw, dp, h, arg, c, batch, u0, (k + 2) % kDtStages,
                         pt);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kDtConsumerRegs)
               : "memory");

  // A consumer: tiles 2 wg and 2 wg + 1 of each item.
  const int wt = t % 128, lane = t % 32, gq = lane / 4, tq = lane % 4;
  const uint32_t w0 = mft_smem_addr(ws);
  const int li = lane / 8, lr = lane % 8;
  const uint32_t l0 =  // this lane's A row of tile 2 wg at tap (1, 1)
      mft_smem_addr(as) + (li / 2) * kDtLbo +
      (2 * wg * 64 + kDtReach + 16 * (wt / 32) + 8 * (li % 2) + lr) * 16;
  float acc0[16], acc1[16], da[16], db[16];
  for (int il = 0; il < count; ++il) {
    const long long item = i0 + il;
    const int c = static_cast<int>(item / items_per_client);
    const int m0 = static_cast<int>(item % items_per_client) * kDtRows + kDtL;
    switch_w(c);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc0[i] = acc1[i] = 0.f;
    // Chunks (stage, tap) in order; a tap's two chunks, tile 0's and tile
    // 1's, in flight together, and each added as it completes.
#pragma unroll 1
    for (int st = 0; st < kDtStages * 9; ++st) {
      const int s = st / 9, tap = st - 9 * s, k = kDtStages * il + s;
      if (tap == 0) dt_bar_sync(kDtFull + (k & 1));
      const int shift = kDtL * (1 - tap / 3) + (1 - tap % 3);
      const uint32_t la = l0 + (k & 1) * 2 * kDtPlane + shift * 16;
      const uint32_t b = w0 + tap * kDtWTap + s * (kDtCo / 4) * 128;
      uint32_t ah0[2][4], al0[2][4], ah1[2][4], al1[2][4];
      dt_frags(ah0, al0, la);
      dt_frags(ah1, al1, la + 64 * 16);
      mft_wgmma_fence();
      dt_chunk(da, ah0, al0, b);
      mft_wgmma_commit();
      dt_chunk(db, ah1, al1, b);
      mft_wgmma_commit();
      mft_wgmma_wait<1>();
      dt_add(acc0, da);
      mft_wgmma_wait<0>();
      dt_add(acc1, db);
      if (tap == 8 && k + 2 < fills) dt_bar_arrive(kDtEmpty + (k & 1));
    }

    // acc[4 j + 2 e + f]: row 16 (wt / 32) + gq + 8 e of the tile, ci
    // 8 j + 2 tq + f; rows off the samples' pixels are not written.
    auto store = [&](const float (&acc)[16], int tile) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + tile * 64 + 16 * (wt / 32) + gq + 8 * e;
        int n, y, x;
        if (!dt_pixel(m, batch, n, y, x)) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = 8 * j + 2 * tq;
          const float v0 = acc[4 * j + 2 * e], v1 = acc[4 * j + 2 * e + 1];
          if (kDenseX) {
            float* out = static_cast<float*>(dx.ptr) + c * dx.st[0] +
                         n * dx.st[1] + (y * kC2Hw + x) * kC2In + ci;
            *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
          } else {
            mft_st(dx, mft_off(dx, c, n, ci, y, x), v0);
            mft_st(dx, mft_off(dx, c, n, ci + 1, y, x), v1);
          }
        }
      }
    };
    store(acc0, 2 * wg);
    store(acc1, 2 * wg + 1);
  }
}

constexpr int kStemOut = 32;
constexpr int kStemCluster = 2;              // blocks splitting a client
constexpr int kStemWindows = 64;             // pooled windows staged at once
constexpr int kStemRows = 4 * kStemWindows;  // 256 dense rows: 16 k16 steps
constexpr int kSZRow = kStemOut + 8;         // 80 B

template <int NJP>
constexpr size_t stem_wgrad_smem() {
  return sizeof(bf16) * kStemRows * (kSZRow + NJP + 8) +
         sizeof(float) * kStemOut * NJP;
}

// The stem's pooled gradient, pooled output and argmax for 64 windows, as
// one thread stages them and writes their four dense rows into zs [row][co]
// (row 4 w + q: position q of window w; windows past `total` give 0).
// Dense: NHWC slabs [.][.][32] (dp, h bf16; arg bytes; 16-byte aligned), as
// conv2's input gradient and the stem's forward write them; thread t takes
// window t / 4, channels 8 (t % 4) .. + 7: three vector loads, four 16-byte
// stores. Otherwise: any strides and types, window slot k = (co, w) = (i %
// 32, i / 32), i = t + 256 k, one element at a time when written.
template <bool kDense>
struct StemWindows;

template <>
struct StemWindows<true> {
  uint4 dp, h;
  uint2 q;
  bool live;

  __device__ __forceinline__ void load(const MftView& vdp, const MftView& vh,
                                       const MftView& varg, int c, int n0,
                                       int per, int /*pw*/, int w0,
                                       int total) {
    const int wi = w0 + threadIdx.x / 4;
    live = wi < total;
    if (live) {
      const int n = n0 + wi / per;
      const long long o = (wi % per) * vdp.st[4] + 8 * (threadIdx.x % 4);
      dp = *reinterpret_cast<const uint4*>(mft_slab<bf16>(vdp, c, n) + o);
      h = *reinterpret_cast<const uint4*>(mft_slab<bf16>(vh, c, n) + o);
      q = *reinterpret_cast<const uint2*>(mft_slab<uint8_t>(varg, c, n) + o);
    }
  }

  __device__ __forceinline__ void store(bf16* zs) const {
    uint32_t rows[4][4];
#pragma unroll
    for (int e2 = 0; e2 < 4; ++e2) {  // channel pairs
      float g[2];
      int qq[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int e = 2 * e2 + b;
        g[b] = live && mft_bf16_at(h, e) > 0.f ? mft_bf16_at(dp, e) : 0.f;
        qq[b] = mft_u8_at(q, e);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        rows[r][e2] =
            mft_pack2(qq[0] == r ? g[0] : 0.f, qq[1] == r ? g[1] : 0.f);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<uint4*>(zs + (threadIdx.x / 4 * 4 + r) * kSZRow +
                                8 * (threadIdx.x % 4)) =
          make_uint4(rows[r][0], rows[r][1], rows[r][2], rows[r][3]);
    }
  }
};

template <>
struct StemWindows<false> {
  const MftView *dp_, *h_, *arg_;
  int c_, n0_, per_, pw_, w0_, total_;

  __device__ __forceinline__ void load(const MftView& vdp, const MftView& vh,
                                       const MftView& varg, int c, int n0,
                                       int per, int pw, int w0, int total) {
    dp_ = &vdp, h_ = &vh, arg_ = &varg;
    c_ = c, n0_ = n0, per_ = per, pw_ = pw, w0_ = w0, total_ = total;
  }

  __device__ __forceinline__ void store(bf16* zs) const {
    for (int i = threadIdx.x; i < kStemWindows * kStemOut; i += kTcThreads) {
      const int co = i % kStemOut, wl = i / kStemOut;
      float g = 0.f;
      int q = 0;
      if (w0_ + wl < total_) {
        const int n = n0_ + (w0_ + wl) / per_, p = (w0_ + wl) % per_;
        const int oi = p / pw_, oj = p % pw_;
        q = static_cast<int>(mft_ld(*arg_, mft_off(*arg_, c_, n, co, oi, oj)));
        g = mft_ld(*h_, mft_off(*h_, c_, n, co, oi, oj)) > 0.f
                ? mft_ld(*dp_, mft_off(*dp_, c_, n, co, oi, oj))
                : 0.f;
      }
      const bf16 v = __float2bfloat16(g);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        zs[(wl * 4 + r) * kSZRow + co] = q == r ? v : mft_bf16_zero();
      }
    }
  }
};

// A cluster of kStemCluster blocks per client; block r sums samples
// [r B / 2, (r + 1) B / 2); two blocks fit an SM. NJP: the 9 * cin columns
// (kh, kw, ci) and one more, padded to whole 16s: column 9 cin of the patch
// is 1, so db comes out of the tensor cores beside dW. The input is f32 (the
// images). Thread t builds patch row t (position t % 4 of window t / 4) in
// registers, one load a column, and stores it as whole 16-byte chunks. Warp
// w takes k16 steps w and w + 8 of each 256 rows. The next rows' loads are
// in flight while the tensor cores run.
template <int NJP, bool kDenseZ>
__global__ void __cluster_dims__(1, kStemCluster, 1)
    __launch_bounds__(kTcThreads, 2)
stem_wgrad_tc_kernel(MftView x, MftView dp, MftView h, MftView arg,
                     MftView gw, MftView gb, ConvGeom g) {
  static_assert(kStemRows == kTcThreads, "one patch row a thread");
  constexpr int kPRow = NJP + 8;  // 16-byte padded patch rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* zs = reinterpret_cast<bf16*>(smem_raw);  // [row][co]
  bf16* ps = zs + kStemRows * kSZRow;            // [row][(kh, kw, ci), 1]
  float* red = reinterpret_cast<float*>(ps + kStemRows * kPRow);  // [co][NJP]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int li = lane >> 3, lr = lane & 7;
  const int nj = 9 * g.cin;
  // j / cin as (j * inv) >> 16: exact for j < 80, cin <= 8
  const int inv = (65536 + g.cin - 1) / g.cin;
  const int pw = g.ow / 2;
  const int per = (g.oh / 2) * pw;
  const int n0 = rank * g.batch / kStemCluster;
  const int total = ((rank + 1) * g.batch / kStemCluster - n0) * per;
  const uint32_t a_addr = mft_smem_addr(
      zs + ((li >> 1) * 8 + lr) * kSZRow + (li & 1) * 8);
  const uint32_t b_addr = mft_smem_addr(
      ps + ((li & 1) * 8 + lr) * kPRow + (li >> 1) * 8);
  // Patch row t's columns; 0 outside the image and past the last window.
  float xv[NJP];
  StemWindows<kDenseZ> wr;
  auto load = [&](int w0) {
    wr.load(dp, h, arg, c, n0, per, pw, w0, total);
    const int wi = w0 + t / 4, q = t % 4;
#pragma unroll
    for (int j = 0; j < NJP; ++j) xv[j] = 0.f;
    if (wi < total) {
      const int n = n0 + wi / per, p = wi % per;
      const int oy = 2 * (p / pw) + (q >> 1) - g.pad;
      const int ox = 2 * (p % pw) + (q & 1) - g.pad;
      const float* xs = mft_slab<float>(x, c, n);
#pragma unroll
      for (int j = 0; j < NJP; ++j) {
        const int tap = (j * inv) >> 16;  // kh * 3 + kw
        const int iy = oy + tap / 3, ix = ox + tap % 3;
        if (j < nj && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w) {
          xv[j] = xs[(j - tap * g.cin) * x.st[2] + iy * x.st[3] +
                     ix * x.st[4]];
        }
      }
    }
  };
  float acc[2][NJP / 8][4] = {};
  if (total > 0) load(0);
  for (int w0 = 0; w0 < total; w0 += kStemWindows) {
    __syncthreads();  // the previous rows are read
    wr.store(zs);
#pragma unroll
    for (int k = 0; k < NJP / 8; ++k) {
      uint32_t v[4];
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) {
        const int j = 8 * k + 2 * e2;
        v[e2] = mft_pack2(j == nj ? 1.f : xv[j], j + 1 == nj ? 1.f : xv[j + 1]);
      }
      *reinterpret_cast<uint4*>(ps + t * kPRow + 8 * k) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    if (w0 + kStemWindows < total) load(w0 + kStemWindows);
    for (int s = warp; s < kStemRows / 16; s += kTcWarps) {
      uint32_t a0[4], a1[4];  // output channels 0-15, 16-31
      ldsm4_t(a0, a_addr + s * 16 * kSZRow * 2);
      ldsm4_t(a1, a_addr + s * 16 * kSZRow * 2 + 32);
#pragma unroll
      for (int ng = 0; ng < NJP / 16; ++ng) {
        uint32_t b[4];
        ldsm4_t(b, b_addr + (s * 16 * kPRow + ng * 16) * 2);
        mma16816(acc[0][2 * ng], a0, b[0], b[1]);
        mma16816(acc[0][2 * ng + 1], a0, b[2], b[3]);
        mma16816(acc[1][2 * ng], a1, b[0], b[1]);
        mma16816(acc[1][2 * ng + 1], a1, b[2], b[3]);
      }
    }
  }
  const int gq = lane >> 2, tq = lane & 3;
  for (int wv = 0; wv < kTcWarps; ++wv) {  // the warps' sums, in warp order
    if (warp == wv) {
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) {
#pragma unroll
        for (int nt = 0; nt < NJP / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& r = red[(ct * 16 + gq + (e >> 1) * 8) * NJP + nt * 8 +
                           2 * tq + (e & 1)];
            r = wv == 0 ? acc[ct][nt][e] : r + acc[ct][nt][e];
          }
        }
      }
    }
    __syncthreads();
  }
  cluster.sync();  // every rank's partials are in its shared memory
  if (rank == 0) {
    for (int i = t; i < kStemOut * NJP; i += kTcThreads) {
      const int co = i / NJP, j = i % NJP;
      if (j > nj) continue;
      float s = red[i];
      for (int r = 1; r < kStemCluster; ++r) {
        s += cluster.map_shared_rank(red, r)[i];
      }
      s = mft_round(s, kBF16);
      if (j == nj) {
        mft_st(gb, mft_off(gb, c, 0, co, 0, 0), s);
      } else {
        const int tap = j / g.cin;
        mft_st(gw, mft_off(gw, c, co, j % g.cin, tap / 3, tap % 3), s);
      }
    }
  }
  cluster.sync();  // rank 0 has read the others' shared memory
}

// One block per (kDgSamples samples, client). Warp w: output rows
// (positions) 16 w and 16 (w + 8) + [0, 16) of the 208, all 32 channels.
// While the tensor cores run on sample n, sample n + 1's loads are in
// flight.
template <bool kDenseZ>
__global__ void __launch_bounds__(kTcThreads)
conv2_dgrad_tc_kernel(MftView dp, MftView h, MftView arg, MftView w,
                      MftView dx, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // ws: [kh * 3 + kw][ci][co]; zs: [halo pixel][co], dZ with its zero border
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);
  bf16* zs = ws + 9 * kC2In * kZRow;
  const int c = blockIdx.y;
  const int n0 = blockIdx.x * kDgSamples;
  const int n1 = min(batch, n0 + kDgSamples);
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int li = lane >> 3, lr = lane & 7;
  C2Windows<kDenseZ> wr;
  wr.load(dp, h, arg, c, n0);
  for (int i = t; i < kHaloPix * kZRow / 2; i += kTcThreads) {
    reinterpret_cast<uint32_t*>(zs)[i] = 0u;
  }
  for (int i = t; i < 9 * kC2In * kC2Out; i += kTcThreads) {
    const int kw = i % 3;  // w's own order: (co, ci, kh, kw), kw fastest
    int r = i / 3;
    const int kh = r % 3;
    r /= 3;
    const int ci = r % kC2In;
    const int co = r / kC2In;
    ws[((kh * 3 + kw) * kC2In + ci) * kZRow + co] =
        __float2bfloat16(mft_ld(w, mft_off(w, c, co, ci, kh, kw)));
  }
  // This lane's ldmatrix rows (neither transposed). A: the dZ pixel under
  // output row p shifted by (kh, kw), channels 8 (li >> 1) + 16 kc; B: ci
  // rows 8 (li >> 1) + lr + 16 ng, channels 8 (li & 1) + 16 kc.
  const uint32_t zs_addr = mft_smem_addr(zs) + (li >> 1) * 8 * 2;
  const uint32_t b_addr = mft_smem_addr(
      ws + ((li >> 1) * 8 + lr) * kZRow + (li & 1) * 8);
  const int gq = lane >> 2, tq = lane & 3;
  for (int n = n0; n < n1; ++n) {
    __syncthreads();  // weights and border staged, or the last sample read
    wr.route([&](int, int co, int p, int q, float g) {
      const bf16 v = __float2bfloat16(g), z = mft_bf16_zero();
      bf16* at = zs + ((2 * (p / kC2Pw) + 1) * kHaloW + 2 * (p % kC2Pw) + 1) *
                          kZRow + co;
      at[0] = q == 0 ? v : z;
      at[kZRow] = q == 1 ? v : z;
      at[kHaloW * kZRow] = q == 2 ? v : z;
      at[(kHaloW + 1) * kZRow] = q == 3 ? v : z;
    });
    __syncthreads();
    if (n + 1 < n1) wr.load(dp, h, arg, c, n + 1);
    for (int mt = warp; mt < kC2Rows / 16; mt += kTcWarps) {
      float acc[4][4] = {};
      const int p = mt * 16 + (li & 1) * 8 + lr;
      // dZ pixel of tap (kh, kw): (y + 2 - kh, x + 2 - kw) in the bordered
      // tile; pad rows (p >= 196) read pixel 0 of the zero border.
      const int pix0 =
          p < kC2Pos ? (p / kC2Hw + 2) * kHaloW + p % kC2Hw + 2 : 0;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int pix = p < kC2Pos ? pix0 - kh * kHaloW - kw : 0;
          const uint32_t arow = zs_addr + pix * kZRow * 2;
          const uint32_t brow = b_addr + (kh * 3 + kw) * kC2In * kZRow * 2;
#pragma unroll
          for (int kc = 0; kc < kC2Out / 16; ++kc) {
            uint32_t a[4];
            ldsm4(a, arow + kc * 32);
#pragma unroll
            for (int ng = 0; ng < 2; ++ng) {
              uint32_t b[4];
              ldsm4(b, brow + ng * 16 * kZRow * 2 + kc * 32);
              mma16816(acc[2 * ng], a, b[0], b[1]);
              mma16816(acc[2 * ng + 1], a, b[2], b[3]);
            }
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + gq + (e >> 1) * 8;
          if (row < kC2Pos) {
            mft_st(dx, mft_off(dx, c, n, nt * 8 + 2 * tq + (e & 1),
                               row / kC2Hw, row % kC2Hw),
                   acc[nt][e]);
          }
        }
      }
    }
  }
}

// ------------------------------------------- the stem's weight gradient, f32
//
// stem_wgrad_tf32: stem_wgrad_tc's GEMM in f32, on Hopper's tensor cores in
// 3xTF32 as conv2_wgrad_tf32 forms its products. It replaces, in f32, the
// stem's weight gradient of fused_local_train (K4;
// multimodal_fl_security_tpu/ops/fused_kernel.py:433, folded over w4's four
// copies by fold_stem): dW[co, (kh, kw, ci)] and db[co] = sum over the dense
// rows (n, oy, ox) of dZ[row, co] times the patch row [x taps, 1]. Per client
// M = 32, N = 9 cin + 1 (-> NJP), K = B x 4 x the pooled windows (25,088 on
// the main path).
//  - dZ is sparse in a fixed pattern: a pooled window's four rows (row 4 w +
//    q: position q of window w) hold its gradient at the argmax's q alone,
//    so each pair of rows (q = 0, 1 and 2, 3) holds at most one nonzero.
//    That is the tensor cores' 1:2 structured sparsity for TF32: A = dZ^T
//    is staged as its nonzero halves [co][pair] with a 4-bit metadata
//    nibble a pair (0x4 its first row, 0xE its second), and
//    mma.sp.m16n8k16 runs each k16 step at the cost of a dense k8 one
//    (its fragments' layouts, read on the card: mma_sp16816_tf32).
//  - A cluster of kStfCluster blocks splits a client's samples; block 0 adds
//    the partials through distributed shared memory, in rank order. Small
//    blocks (4 warps, four an SM) keep 16 warps an SM for the staging's
//    latency.
//  - A block stages kStfWin pooled windows (kStfRows dense rows) at a time:
//    dZ^T's halves as [co][pair] and the patch as [j][row], both with k
//    contiguous, so that ldmatrix gives the TF32 A fragment and the B
//    fragment (lane l: word l % 4 of row l / 4 of an 8 x 16-byte matrix).
//    Rows are padded to 4 (mod 32) words: ldmatrix's eight row addresses
//    fall on distinct banks.
//  - A half-warp routes sixteen windows of one group of eight channels: one
//    8-byte store of a window's two pairs a channel for hi and for lo
//    (conflict-free) and one metadata byte. Thread t stages patch row t:
//    the patch of x is built once a block, its rows on consecutive lanes.
//    Column 9 cin is 1 in every chunk and each column past it reads one
//    row of zeros, so both are written once: db comes out of the tensor
//    cores beside dW. (Rows past the block's last window keep the ones;
//    their dZ is 0.)
//  - Every operand is split into hi = tf32(a) and lo = tf32(a - hi)
//    (mft_tf32_rne) once, as it is staged; lo hi + hi lo + hi hi in f32 sums.
//    Warp w takes k16 steps 2 w and 2 w + 1 of each chunk, each into a fresh
//    accumulator: the tensor cores' sums do not round to nearest, and a
//    fresh one keeps their truncation to the sixteen rows of one step. The
//    sums then go up in f32 through short chains, so that no long chain of
//    roundings builds up: the steps' into the chunk's, the chunks' into a
//    group of kStfGroup, the groups' into the block's, the warps' in warp
//    order and the ranks' in rank order, with no atomics: two calls are
//    bitwise equal.
//  - dp, h and the argmax come through a two-stage ring in shared memory,
//    by async copies issued a chunk ahead, so that they are in flight
//    through a chunk's staging and tensor-core steps; the taps (one input
//    channel) are loaded into registers a chunk ahead. Each thread copies
//    and reads back its own window and channels: no barrier guards a stage.
// What bounds it: 191 MB of operands on the main path (dp and h f32, 80 MB
// each; the argmax 20 MB; the images 10 MB): 0.057 ms at 3.35 TB/s. Its
// dense GEMM is 7.7 GFLOP in 3xTF32 (0.016 ms at the TF32 rate), four times
// the routed work, half of it skipped by the sparsity. What the design
// leaves as the cost is the latency of each block's chunk of loads and its
// staging (the routing, the splits, the shared-memory stores): without the
// loads the staging and the tensor-core steps take about half the kernel's
// time, the loads alone somewhat more.

constexpr int kStfThreads = 128;  // 4 warps
constexpr int kStfWarps = kStfThreads / 32;
constexpr int kStfCluster = 8;                // blocks splitting a client
constexpr int kStfWin = kStfThreads / 4;      // windows a chunk: 32
constexpr int kStfRows = 4 * kStfWin;         // dense rows a chunk: 128
constexpr int kStfRow = kStfRows + 4;         // patch row stride, floats
constexpr int kStfZRow = 2 * kStfWin + 4;     // dZ^T row stride, floats
constexpr int kStfSteps = kStfRows / 16 / kStfWarps;  // a warp's k16 steps
constexpr int kStfPairs = kStfWin * kStemOut / kStfThreads;  // 8 channels
constexpr int kStfGroup = 8;  // chunks whose sums are added before the total
constexpr int kStfStages = 2;  // ring stages: chunks of dZ in flight, + 1
// A ring stage, in bytes: dp and h [window][channel] f32 in rows of 36
// words, the argmax [window][channel] in rows of 40 bytes (a phase's
// windows on distinct banks).
constexpr int kStfRawRow = kStemOut + 4;
constexpr int kStfArgRow = kStemOut + 8;
constexpr int kStfStageH = kStfWin * kStfRawRow * 4;
constexpr int kStfStageArg = 2 * kStfStageH;
constexpr int kStfStage = kStfStageArg + kStfWin * kStfArgRow;
// Metadata words: [k16 step][m16 tile][row gq][half of the step's columns],
// 34 words a step: a half-warp's byte stores (four steps) on distinct banks.
constexpr int kStfMetaStep = 34;
constexpr int kStfMeta = kStfRows / 16 * kStfMetaStep;

// The patch's rows [j][row] held: the 9 cin taps, the ones and one row of
// zeros that every column past the ones reads (at one input channel 11;
// else all NJP).
template <int NJP>
__host__ __device__ constexpr int stem_tf32_prows() {
  return NJP == 16 ? 11 : NJP;
}

template <int NJP>
constexpr size_t stem_tf32_smem() {
  return sizeof(float) * (2 * kStemOut * kStfZRow + kStfMeta +
                          2 * stem_tf32_prows<NJP>() * kStfRow +
                          kStemOut * NJP) +
         kStfStages * kStfStage;
}

// Blocks an SM on the path: as many as its shared memory holds, at most
// 16 warps (128 registers a thread).
constexpr int kStfBySmem =
    static_cast<int>(228 * 1024 / (stem_tf32_smem<16>() + 1024));
constexpr int kStfBlocksPerSm =
    kStfBySmem < 512 / kStfThreads ? kStfBySmem : 512 / kStfThreads;

static_assert(kStfRow % 32 == 4 && kStfZRow % 32 == 4 && kStfPairs == 8,
              "ldmatrix rows on distinct banks; channel groups");
static_assert(kStfBlocksPerSm >= 1 && kStfStage % 16 == 0,
              "a block fits an SM; 16-byte aligned stages");

// 8 bytes from global src (8-byte aligned) to shared dst, of which the
// first src_bytes are read and the rest zeroed; 0 reads nothing.
__device__ __forceinline__ void stf_cp_async8(uint32_t dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

// Grid (client, rank); rank r sums samples [r B / kStfCluster, (r + 1) B /
// kStfCluster) of its client. NJP: the 9 cin columns and the ones, padded
// to 16 (one input channel, the path's) or 80 (up to 8). Warp w: both m16
// tiles of the 32 output channels, every n8 tile of the NJP columns, over
// its k16 steps of each chunk. kDenseZ: dp, h and the argmax are NHWC f32
// slabs (arg bytes), 16-byte aligned, with the samples back to back, as
// conv2's input gradient and the stem's f32 forward write them: a rank's
// windows are one run of memory, copied into the ring from a pointer that
// steps a chunk at a time. Otherwise they are read one element at a time,
// of any strides and types, and stored into the ring. At one input channel
// the next chunk's taps are loaded into registers while the tensor cores
// run (the patch row's place steps a chunk at a time, its nine taps at
// fixed offsets); at more, the patch is loaded as it is staged.
template <int NJP, bool kDenseZ>
__global__ void __cluster_dims__(1, kStfCluster, 1)
    __launch_bounds__(kStfThreads, NJP == 16 ? kStfBlocksPerSm : 1)
stem_wgrad_tf32_kernel(MftView x, MftView dp, MftView h, MftView arg,
                       MftView gw, MftView gb, ConvGeom g) {
  constexpr bool kOne = NJP == 16;  // one input channel: 9 taps
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* zh = reinterpret_cast<float*>(smem_raw);  // [co][pair]
  float* zl = zh + kStemOut * kStfZRow;
  uint32_t* meta = reinterpret_cast<uint32_t*>(zl + kStemOut * kStfZRow);
  float* ph = reinterpret_cast<float*>(meta + kStfMeta);  // [j][row]
  constexpr int kPRows = stem_tf32_prows<NJP>();
  float* pl = ph + kPRows * kStfRow;
  float* red = pl + kPRows * kStfRow;  // [co][NJP]
  unsigned char* ring = reinterpret_cast<unsigned char*>(red + kStemOut * NJP);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int li = lane >> 3, lr = lane & 7;
  const int gq = lane >> 2, tq = lane & 3;
  const int cin = kOne ? 1 : g.cin;
  const int nj = 9 * cin;
  const int pw = g.ow / 2, ph2 = g.oh / 2;
  const int per = ph2 * pw;
  const int n0 = rank * g.batch / kStfCluster;
  const int total = ((rank + 1) * g.batch / kStfCluster - n0) * per;
  // The dZ window and channels this thread routes (a half-warp: sixteen
  // windows of one channel group); its patch row is t.
  const int zw = lane % 16 + 16 * (warp % 2);
  const int zc = 8 * (2 * (warp / 2) + lane / 16);
  // j / cin as (j * inv) >> 16: exact for j < 80, cin <= 8
  const int inv = (65536 + cin - 1) / cin;
  // The ones column and the zero row, the same in every chunk.
  for (int i = t; i < 2 * kStfRows; i += kStfThreads) {
    const int at = (nj + i / kStfRows) * kStfRow + i % kStfRows;
    ph[at] = i < kStfRows ? 1.f : 0.f;
    pl[at] = 0.f;
  }
  // ldmatrix: A (dZ^T's nonzero halves) matrix li is channels 8 (li & 1) +
  // [0, 8), pairs 4 (li >> 1) + [0, 4); B (the patch) matrix li is rows
  // 4 li + [0, 4) of an n8 tile's eight columns (a column past the ones
  // reads the zero row): b0 .. b3.
  const uint32_t a_off = static_cast<uint32_t>(
      (((li & 1) * 8 + lr) * kStfZRow + (li >> 1) * 4) * sizeof(float));
  auto b_off = [&](int nt) {  // n8 tile nt's column for this lane
    const int j = min(8 * nt + lr, nj + 1);
    return static_cast<uint32_t>((j * kStfRow + li * 4) * sizeof(float));
  };
  const uint32_t zh_addr = mft_smem_addr(zh) + a_off;
  const uint32_t zl_addr = mft_smem_addr(zl) + a_off;
  const uint32_t ph_addr = mft_smem_addr(ph);
  const uint32_t pl_addr = mft_smem_addr(pl);
  constexpr uint32_t kZTile16 = 16 * kStfZRow * sizeof(float);
  // This lane's metadata word of a k16 step and m16 tile (lanes 4 g + 2 and
  // 4 g + 3 read one that the instruction ignores).
  const uint32_t* meta_at = meta + gq * 2 + (tq & 1);

  // This thread's window of the rank's first chunk, on the dense path: a
  // pointer into each of dp, h and arg (chunk i is kStfWin windows on).
  const long long zoff = static_cast<long long>(zw) * kStemOut + zc;
  const float* zdp = mft_slab<float>(dp, c, n0) + zoff;
  const float* zh_in = mft_slab<float>(h, c, n0) + zoff;
  const uint8_t* zarg = mft_slab<uint8_t>(arg, c, n0) + zoff;
  // The patch row's window (n, oi, oj), stepped kStfWin windows a chunk,
  // and, at one input channel, its nine taps' offsets from the row's first.
  int pn = n0 + (t / 4) / per, poi = (t / 4) % per / pw, poj = (t / 4) % pw;
  const int pdy = (t % 4) / 2 - g.pad, pdx = t % 2 - g.pad;
  // (In-sample offsets fit 32 bits: mft_stem_wgrad_tf32_takes.)
  const int xs3 = static_cast<int>(x.st[3]), xs4 = static_cast<int>(x.st[4]);
  int tap_off[kOne ? 9 : 1];
#pragma unroll
  for (int j = 0; j < (kOne ? 9 : 1); ++j) {
    tap_off[j] = (j / 3) * xs3 + (j % 3) * xs4;
  }
  auto step_row = [&]() {
    poj += kStfWin;
    while (poj >= pw) {
      poj -= pw;
      if (++poi == ph2) poi = 0, ++pn;
    }
  };
  // Tap j of patch row t at the row's current window, or 0 outside the
  // image or past the rank's last window (live).
  auto tap = [&](int j, bool live) {
    const int kk = kOne ? j : (j * inv) >> 16;  // kh * 3 + kw
    const int ci = kOne ? 0 : j - kk * cin;
    const int iy = 2 * poi + pdy + kk / 3, ix = 2 * poj + pdx + kk % 3;
    if (!live || iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) return 0.f;
    const float* xs = mft_slab<float>(x, c, pn);
    return kOne ? xs[(2 * poi + pdy) * xs3 + (2 * poj + pdx) * xs4 +
                     tap_off[kOne ? j : 0]]
                : xs[ci * x.st[2] + iy * x.st[3] + ix * x.st[4]];
  };
  auto put = [&](int j, float v) {
    const float hi = mft_tf32_rne(v);
    ph[j * kStfRow + t] = hi;
    pl[j * kStfRow + t] = mft_tf32_rne(v - hi);
  };

  // This thread's places in a ring stage: its window's eight channels.
  const int raw_at = zw * kStfRawRow + zc;                 // floats
  const int arg_at = kStfStageArg + zw * kStfArgRow + zc;  // bytes
  const uint32_t ring_addr = mft_smem_addr(ring);
  // Chunk i's windows (this thread's eight channels) into ring stage s:
  // async copies on the dense path, else loads and stores.
  auto issue = [&](int i, int s) {
    const int w0 = i * kStfWin;
    const bool live = w0 + zw < total;
    unsigned char* stage = ring + s * kStfStage;
    if (kDenseZ) {
      const uint32_t st = ring_addr + s * kStfStage;
      const long long o = static_cast<long long>(w0) * kStemOut;
      const int b = live ? 16 : 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        mft_cp_async16(st + (raw_at + 4 * k) * 4, zdp + (live ? o : 0) + 4 * k,
                       b);
        mft_cp_async16(st + kStfStageH + (raw_at + 4 * k) * 4,
                       zh_in + (live ? o : 0) + 4 * k, b);
      }
      stf_cp_async8(st + arg_at, zarg + (live ? o : 0), live ? 8 : 0);
    } else {
      const int wi = w0 + zw;
      const int n = n0 + (live ? wi / per : 0), p = live ? wi % per : 0;
      const int oi = p / pw, oj = p % pw;
      float* rd = reinterpret_cast<float*>(stage) + raw_at;
      float* rh = reinterpret_cast<float*>(stage + kStfStageH) + raw_at;
#pragma unroll
      for (int e = 0; e < kStfPairs; ++e) {
        const int co = zc + e;
        rd[e] = live ? mft_ld(dp, mft_off(dp, c, n, co, oi, oj)) : 0.f;
        rh[e] = live ? mft_ld(h, mft_off(h, c, n, co, oi, oj)) : 0.f;
        stage[arg_at + e] = static_cast<unsigned char>(
            live ? mft_ld(arg, mft_off(arg, c, n, co, oi, oj)) : 0.f);
      }
    }
  };
  // The next chunk's taps (one input channel), in registers.
  float xv[kOne ? 9 : 1];
  auto load_taps = [&](int i) {
    if (kOne) {
      const bool plive = i * kStfWin + t / 4 < total;
#pragma unroll
      for (int j = 0; j < 9; ++j) xv[j] = tap(j, plive);
    }
  };

  // This thread's metadata bytes: window zw's place in its k16 step's
  // words (half = which four pairs, then its byte), channel co's word (row
  // gq of m16 tile co / 16) and half-word (row gq or gq + 8).
  unsigned char* meta_b = reinterpret_cast<unsigned char*>(meta) +
                          (zw / 4 * kStfMetaStep + zw % 4 / 2) * 4 + zw % 2;
  // The block's sums, and those of the current group of kStfGroup chunks.
  float acc[2][NJP / 8][4] = {}, grp[2][NJP / 8][4] = {};
  int grouped = 0;
  const int chunks = (total + kStfWin - 1) / kStfWin;
#pragma unroll
  for (int i = 0; i < kStfStages - 1; ++i) {
    if (i < chunks) issue(i, i);
    mft_cp_async_commit();
  }
  if (chunks > 0) load_taps(0);
  for (int i = 0; i < chunks; ++i) {
    if (i + kStfStages - 1 < chunks) {
      issue(i + kStfStages - 1, (i + kStfStages - 1) % kStfStages);
    }
    mft_cp_async_commit();
    mft_cp_async_wait<kStfStages - 1>();  // this thread's copies of chunk i
    const unsigned char* stage = ring + (i % kStfStages) * kStfStage;
    float4 rdp[2], rh[2];
    uint32_t rq[2];
    {
      const float* rd = reinterpret_cast<const float*>(stage) + raw_at;
      const float* rhh =
          reinterpret_cast<const float*>(stage + kStfStageH) + raw_at;
      const uint2 q2 = *reinterpret_cast<const uint2*>(stage + arg_at);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        rdp[k] = *reinterpret_cast<const float4*>(rd + 4 * k);
        rh[k] = *reinterpret_cast<const float4*>(rhh + 4 * k);
      }
      rq[0] = q2.x, rq[1] = q2.y;
    }
    __syncthreads();  // the previous chunk is read
    // Window zw, channel co: the pooled gradient g through the relu at
    // position q of the window's four rows, i.e. in pair q / 2 at place
    // q % 2; the other pair holds 0.
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = zc + 4 * k + e;
        const float gv =
            mft_f4_at(rh[k], e) > 0.f ? mft_f4_at(rdp[k], e) : 0.f;
        const int qq = static_cast<int>((rq[k] >> (8 * e)) & 0xffu);
        const float gh = mft_tf32_rne(gv), gl = mft_tf32_rne(gv - gh);
        const bool first = qq < 2;
        const int at = co * kStfZRow + 2 * zw;
        *reinterpret_cast<float2*>(zh + at) =
            make_float2(first ? gh : 0.f, first ? 0.f : gh);
        *reinterpret_cast<float2*>(zl + at) =
            make_float2(first ? gl : 0.f, first ? 0.f : gl);
        meta_b[((co / 16) * 8 + co % 8) * 2 * 4 + (co % 16) / 8 * 2] =
            static_cast<unsigned char>((qq == 1 ? 0xEu : 0x4u) |
                                       (qq == 3 ? 0xE0u : 0x40u));
      }
    }
    if (kOne) {
#pragma unroll
      for (int j = 0; j < 9; ++j) put(j, xv[j]);
    } else {
      const bool plive = i * kStfWin + t / 4 < total;
      for (int j = 0; j < nj; ++j) put(j, tap(j, plive));
    }
    __syncthreads();
    step_row();
    if (i + 1 < chunks) load_taps(i + 1);
#pragma unroll
    for (int v = 0; v < NJP / 16; ++v) {
      float chunk[2][2][4];  // this chunk's sums
#pragma unroll
      for (int s = 0; s < kStfSteps; ++s) {
        const int kk = warp * kStfSteps + s;  // the k16 step
        uint32_t bh[2][4], bl[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint32_t o = b_off(2 * v + nt) + kk * 16 * sizeof(float);
          ldsm4(bh[nt], ph_addr + o);
          ldsm4(bl[nt], pl_addr + o);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t ahi[4], alo[4];
          const uint32_t o = m * kZTile16 + kk * 8 * sizeof(float);
          ldsm4(ahi, zh_addr + o);
          ldsm4(alo, zl_addr + o);
          const uint32_t e = meta_at[kk * kStfMetaStep + m * 8 * 2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float part[4] = {};
            // the small terms first
            mma_sp16816_tf32(part, alo, bh[nt], e);
            mma_sp16816_tf32(part, ahi, bl[nt], e);
            mma_sp16816_tf32(part, ahi, bh[nt], e);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              chunk[m][nt][q] = s == 0 ? part[q] : chunk[m][nt][q] + part[q];
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) grp[m][2 * v + nt][q] += chunk[m][nt][q];
        }
      }
    }
    if (++grouped == kStfGroup || i + 1 == chunks) {
      grouped = 0;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int nt = 0; nt < NJP / 8; ++nt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[m][nt][q] += grp[m][nt][q];
            grp[m][nt][q] = 0.f;
          }
        }
      }
    }
  }
  for (int wv = 0; wv < kStfWarps; ++wv) {  // the warps' sums, in warp order
    if (warp == wv) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int nt = 0; nt < NJP / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& r = red[(m * 16 + gq + (e >> 1) * 8) * NJP + nt * 8 +
                           2 * tq + (e & 1)];
            r = wv == 0 ? acc[m][nt][e] : r + acc[m][nt][e];
          }
        }
      }
    }
    __syncthreads();
  }
  cluster.sync();  // every rank's partials are in its shared memory
  if (rank == 0) {
    for (int i = t; i < kStemOut * NJP; i += kStfThreads) {
      const int co = i / NJP, j = i % NJP;
      if (j > nj) continue;
      float s = red[i];
      for (int r = 1; r < kStfCluster; ++r) {
        s += cluster.map_shared_rank(red, r)[i];
      }
      if (j == nj) {
        mft_st(gb, mft_off(gb, c, 0, co, 0, 0), s);
      } else {
        const int tap = j / cin;
        mft_st(gw, mft_off(gw, c, co, j % cin, tap / 3, tap % 3), s);
      }
    }
  }
  cluster.sync();  // rank 0 has read the others' shared memory
}

// ------------------------------------------------- tensor-core forwards
//
// The forward for the compute dtype bf16, on the tensor cores: the port's
// counterpart of forward_impl's stem and conv2 GEMMs (fused_train.py:
// 361-403, through kdot3d, fused_kernel.py:137-159). Each is an implicit
// GEMM on mma.sync.m16n8k16 (bf16 operands, f32 sums) with the pooled
// epilogue: the max over each 2 x 2 window's four f32 sums, the first
// maximum in (di, dj) order winning, then the bias rounded to bf16, relu,
// one rounding to bf16 on the store and the argmax byte.
//  - conv2_fwd_tc: Z[m, co] = sum over (kh, kw, ci) of X[(oy + kh - 1,
//    ox + kw - 1), ci] * W[co, ci, kh, kw], M = 196 (-> 208) positions, N =
//    64, K = 288 per sample. One block per (kFwSamples samples, client)
//    stages the client's weights once as [kh * 3 + kw][co][ci] bf16; A = the
//    rows of the zero-bordered input tile [16 x 16, 32] shifted by (kh, kw).
//    Windows straddle the m16 tiles, so the f32 sums go through a [co][m]
//    tile in shared memory (over the input tile, which is read by then) and
//    each thread pools 8 adjacent (co, window) pairs into one 16-byte store
//    of the NCHW map.
//  - stem_fwd_tc: the stem's rows (cin <= 8) as a [256, 9 * cin -> NJP]
//    patch of 64 pooled windows (row 4 w + q: position q of window w), as
//    stem_wgrad_tc builds it; B = the weights [32][NJP] held in registers.
//    A window's four rows are four lanes of one accumulator fragment, so the
//    max is two shuffles; the pooled NHWC pixels (64 bytes each) leave
//    through a tile in shared memory as 16-byte stores.
//
// What bounds them: conv2's forward is 23.1 GFLOP over 100 clients x 32
// samples (0.023 ms at the bf16 peak) against ~30 MB of operands and
// outputs: operations. The stem's is 1.4 GFLOP against ~70 MB (10 MB of f32
// images in, 40 MB of bf16 maps and 20 MB of argmax out): bytes (0.021
// ms). The design keeps the sums in registers and the tiles in shared
// memory; what it leaves as the cost is the staging and the epilogue, one
// thread per pair, as in the gradient kernels. The main path's layouts
// (conv2's input NHWC and its maps NCHW, the stem's maps NHWC) are read and
// written with 16-byte accesses; any other strides one element at a time.

constexpr int kFwSamples = 4;  // samples a conv2 forward block stages weights for
// f32 [co][m] rows of conv2's pre-pool sums: 212 = 4 (mod 16) words puts
// the fragments' (row gq, column 2 tq) stores on 32 distinct banks.
constexpr int kZfRow = 212;
constexpr int kBorderChunks = 60 * kC2In / 8;  // the halo's 60 pixels, 16 B each

template <typename T>
__device__ __forceinline__ T* mft_slab_w(const MftView& v, int c, int n) {
  return static_cast<T*>(v.ptr) + c * v.st[0] + n * v.st[1];
}

// conv2's pooled epilogue for pair i = co * 49 + p of the sums zf [co][m]:
// the window's value through bias and relu, and its argmax in q.
__device__ __forceinline__ float c2_pool(const float* zf, const float* bs,
                                         int i, int& q) {
  const int co = i / kC2Pooled, p = i % kC2Pooled;
  const float* z = zf + co * kZfRow + 2 * (p / kC2Pw) * kC2Hw + 2 * (p % kC2Pw);
  const float v[4] = {z[0], z[1], z[kC2Hw], z[kC2Hw + 1]};
  float best = v[0];
  q = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (v[k] > best) {  // ties: the first in (di, dj) order
      best = v[k];
      q = k;
    }
  }
  return fmaxf(best + bs[co], 0.f);
}

// Warp w: output rows (positions) 16 w and 16 (w + 8) + [0, 16) of the 208
// (warps 5-7 have one tile), all 64 channels, sharing each B fragment
// between its two tiles. While the tensor cores run on sample n, sample
// n + 1's loads are in flight.
template <bool kDenseX, bool kDenseOut>
__global__ void __launch_bounds__(kTcThreads, 2)
conv2_fwd_tc_kernel(MftView x, MftView w, MftView b, MftView out, MftView arg,
                    int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // ws: [kh * 3 + kw][co][ci]; bs: the bias rounded to bf16; xs: [halo
  // pixel][ci], the input with its zero border; zf: [co][m], the f32 sums,
  // over xs once the tensor cores have read it.
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);
  float* bs = reinterpret_cast<float*>(ws + 9 * kC2Out * kXRow);
  bf16* xs = reinterpret_cast<bf16*>(bs + kC2Out);
  float* zf = reinterpret_cast<float*>(xs);
  const int c = blockIdx.y;
  const int n0 = blockIdx.x * kFwSamples;
  const int n1 = min(batch, n0 + kFwSamples);
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int li = lane >> 3, lr = lane & 7;
  C2Input<kDenseX> xr;
  xr.load(x, c, n0);
  // Thread i reads the 9 taps of (co, ci) = (i / 32, i % 32), adjacent in
  // w's own order; a warp's lanes write adjacent ci.
  for (int i = t; i < kC2Out * kC2In; i += kTcThreads) {
    const int co = i / kC2In, ci = i % kC2In;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      ws[(tap * kC2Out + co) * kXRow + ci] = __float2bfloat16(
          mft_ld(w, mft_off(w, c, co, ci, tap / 3, tap % 3)));
    }
  }
  if (t < kC2Out) bs[t] = mft_round(mft_ld(b, mft_off(b, c, 0, t, 0, 0)), kBF16);
  // This lane's ldmatrix rows (neither transposed). A: the halo pixel under
  // output row m, shifted by the tap, channels 8 (li >> 1) + 16 kc; pad rows
  // (m >= 196) read any pixel, and their sums are never used. B: co rows
  // 8 (li >> 1) + lr + 16 ng of the tap's block, channels 8 (li & 1) + 16 kc.
  const bool two = warp + kTcWarps < kC2Rows / 16;
  int pix[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int m = (warp + u * kTcWarps) * 16 + (li & 1) * 8 + lr;
    pix[u] = m < kC2Pos ? (m / kC2Hw) * kHaloW + m % kC2Hw : 0;
  }
  const uint32_t xs_addr = mft_smem_addr(xs) + (li >> 1) * 8 * 2;
  const uint32_t b_addr = mft_smem_addr(
      ws + ((li >> 1) * 8 + lr) * kXRow + (li & 1) * 8);
  const int gq = lane >> 2, tq = lane & 3;
  for (int n = n0; n < n1; ++n) {
    __syncthreads();  // weights staged, or the last sample's sums read
    if (t < kBorderChunks) {  // zf overwrote the border: zero it again
      const int bp = t / 4;
      const int pix_b = bp < 16   ? bp
                        : bp < 32 ? (kHaloW - 1) * kHaloW + bp - 16
                        : bp < 46 ? (bp - 31) * kHaloW
                                  : (bp - 45) * kHaloW + kHaloW - 1;
      *reinterpret_cast<uint4*>(xs + pix_b * kXRow + 8 * (t % 4)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    xr.store(xs);
    __syncthreads();
    if (n + 1 < n1) xr.load(x, c, n + 1);
    float acc[2][8][4] = {};
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * kHaloW + tap % 3;
#pragma unroll
      for (int kc = 0; kc < kC2In / 16; ++kc) {
        uint32_t a0[4], a1[4];
        ldsm4(a0, xs_addr + ((pix[0] + shift) * kXRow + kc * 16) * 2);
        if (two) ldsm4(a1, xs_addr + ((pix[1] + shift) * kXRow + kc * 16) * 2);
#pragma unroll
        for (int ng = 0; ng < kC2Out / 16; ++ng) {
          uint32_t bb[4];
          ldsm4(bb, b_addr + ((tap * kC2Out + ng * 16) * kXRow + kc * 16) * 2);
          mma16816(acc[0][2 * ng], a0, bb[0], bb[1]);
          mma16816(acc[0][2 * ng + 1], a0, bb[2], bb[3]);
          if (two) {
            mma16816(acc[1][2 * ng], a1, bb[0], bb[1]);
            mma16816(acc[1][2 * ng + 1], a1, bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp has read xs: the sums go over it
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = (warp + u * kTcWarps) * 16 + gq + (e >> 1) * 8;
          zf[(nt * 8 + 2 * tq + (e & 1)) * kZfRow + row] = acc[u][nt][e];
        }
      }
    }
    __syncthreads();
    if (kDenseOut) {
      // Pairs 8 (t + 256 k) .. + 7: one 16-byte and one 8-byte store each.
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i0 = 8 * (t + k * kTcThreads);
        if (i0 < kC2Wins) {
          float v[8];
          int q[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = c2_pool(zf, bs, i0 + e, q[e]);
          *reinterpret_cast<uint4*>(mft_slab_w<bf16>(out, c, n) + i0) =
              make_uint4(mft_pack2(v[0], v[1]), mft_pack2(v[2], v[3]),
                         mft_pack2(v[4], v[5]), mft_pack2(v[6], v[7]));
          uint32_t qw[2] = {0u, 0u};
#pragma unroll
          for (int e = 0; e < 8; ++e) qw[e / 4] |= static_cast<uint32_t>(q[e]) << (8 * (e % 4));
          *reinterpret_cast<uint2*>(mft_slab_w<uint8_t>(arg, c, n) + i0) =
              make_uint2(qw[0], qw[1]);
        }
      }
    } else {
      for (int i = t; i < kC2Wins; i += kTcThreads) {
        int q;
        const float v = c2_pool(zf, bs, i, q);
        const int co = i / kC2Pooled, p = i % kC2Pooled;
        mft_st(out, mft_off(out, c, n, co, p / kC2Pw, p % kC2Pw), v);
        mft_st(arg, mft_off(arg, c, n, co, p / kC2Pw, p % kC2Pw),
               static_cast<float>(q));
      }
    }
  }
}

constexpr int kSfChunks = 4;            // 64-window chunks a stem block runs
constexpr int kSORow = kStemOut + 8;    // bf16 output tile rows, 80 B
constexpr int kSARow = kStemOut + 16;   // argmax tile rows, 48 B

template <int NJP>
constexpr size_t stem_fwd_smem() {
  return sizeof(bf16) * (kStemRows + kStemOut) * (NJP + 8) +
         sizeof(bf16) * kStemWindows * kSORow + kStemWindows * kSARow;
}

// One block per (kSfChunks * 64 of a client's pooled windows, client), the
// windows in (sample, row, column) order. Thread t builds patch row t
// (position t % 4 of window t / 4) in registers, as bf16 pairs, and stores
// it as whole 16-byte chunks; the next rows' loads are in flight while the
// tensor cores run. Warp w: rows 16 w and 16 (w + 8) + [0, 16), all 32
// channels. The input is f32 (the images), of any strides.
template <int NJP, bool kDenseOut>
__global__ void __launch_bounds__(kTcThreads)
stem_fwd_tc_kernel(MftView x, MftView w, MftView b, MftView out, MftView arg,
                   ConvGeom g) {
  static_assert(kStemRows == kTcThreads, "one patch row a thread");
  constexpr int kPRow = NJP + 8;  // 16-byte padded patch and weight rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ps = reinterpret_cast<bf16*>(smem_raw);  // [row][(kh, kw, ci)]
  bf16* ws = ps + kStemRows * kPRow;             // [co][(kh, kw, ci)]
  bf16* os = ws + kStemOut * kPRow;              // [window][co], pooled
  uint8_t* as = reinterpret_cast<uint8_t*>(os + kStemWindows * kSORow);
  const int c = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int li = lane >> 3, lr = lane & 7;
  const int gq = lane >> 2, tq = lane & 3;
  const int nj = 9 * g.cin;
  // j / cin as (j * inv) >> 16: exact for j < 80, cin <= 8
  const int inv = (65536 + g.cin - 1) / g.cin;
  const int pw = g.ow / 2;
  const int per = (g.oh / 2) * pw;
  const int wbeg = blockIdx.x * kSfChunks * kStemWindows;
  const int wend = min(g.batch * per, wbeg + kSfChunks * kStemWindows);
  for (int i = t; i < kStemOut * NJP; i += kTcThreads) {
    const int co = i / NJP, j = i % NJP;
    float v = 0.f;
    if (j < nj) {
      const int tap = j / g.cin;
      v = mft_ld(w, mft_off(w, c, co, j % g.cin, tap / 3, tap % 3));
    }
    ws[co * kPRow + j] = __float2bfloat16(v);
  }
  float bias[4][2];  // this lane's channels nt * 8 + 2 tq + e
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bias[nt][e] = mft_round(
          mft_ld(b, mft_off(b, c, 0, nt * 8 + 2 * tq + e, 0, 0)), kBF16);
    }
  }
  // Patch row t's columns as bf16 pairs; 0 outside the image and past the
  // last window.
  uint32_t xv[NJP / 2];
  auto load = [&](int w0) {
    const int wi = w0 + t / 4, q = t % 4;
#pragma unroll
    for (int j2 = 0; j2 < NJP / 2; ++j2) xv[j2] = 0u;
    if (wi < wend) {
      const int n = wi / per, p = wi % per;
      const int oy = 2 * (p / pw) + (q >> 1) - 1;
      const int ox = 2 * (p % pw) + (q & 1) - 1;
      const float* xs = mft_slab<float>(x, c, n);
#pragma unroll
      for (int j2 = 0; j2 < NJP / 2; ++j2) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 2 * j2 + e;
          const int tap = (j * inv) >> 16;  // kh * 3 + kw
          const int iy = oy + tap / 3, ix = ox + tap % 3;
          v[e] = j < nj && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w
                     ? xs[(j - tap * g.cin) * x.st[2] + iy * x.st[3] +
                          ix * x.st[4]]
                     : 0.f;
        }
        xv[j2] = mft_pack2(v[0], v[1]);
      }
    }
  };
  if (wbeg < wend) load(wbeg);
  __syncthreads();  // the weights are staged
  // B for every k16 step and 16 channels, kept in registers: ldmatrix rows
  // co = 8 (li >> 1) + lr + 16 ng, columns 8 (li & 1) + 16 ks.
  uint32_t bw[NJP / 16][2][4];
  {
    const uint32_t b_addr = mft_smem_addr(
        ws + ((li >> 1) * 8 + lr) * kPRow + (li & 1) * 8);
#pragma unroll
    for (int ks = 0; ks < NJP / 16; ++ks) {
#pragma unroll
      for (int ng = 0; ng < 2; ++ng) {
        ldsm4(bw[ks][ng], b_addr + (ng * 16 * kPRow + ks * 16) * 2);
      }
    }
  }
  const uint32_t a_addr = mft_smem_addr(
      ps + ((li & 1) * 8 + lr) * kPRow + (li >> 1) * 8);
  for (int w0 = wbeg; w0 < wend; w0 += kStemWindows) {
    __syncthreads();  // the previous rows and output tile are read
#pragma unroll
    for (int k = 0; k < NJP / 8; ++k) {
      *reinterpret_cast<uint4*>(ps + t * kPRow + 8 * k) =
          make_uint4(xv[4 * k], xv[4 * k + 1], xv[4 * k + 2], xv[4 * k + 3]);
    }
    __syncthreads();
    if (w0 + kStemWindows < wend) load(w0 + kStemWindows);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int mt = warp + u * kTcWarps;
      float acc[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < NJP / 16; ++ks) {
        uint32_t a[4];
        ldsm4(a, a_addr + (mt * 16 * kPRow + ks * 16) * 2);
#pragma unroll
        for (int ng = 0; ng < 2; ++ng) {
          mma16816(acc[2 * ng], a, bw[ks][ng][0], bw[ks][ng][1]);
          mma16816(acc[2 * ng + 1], a, bw[ks][ng][2], bw[ks][ng][3]);
        }
      }
      // Rows gq and gq + 8 are position q = gq % 4 of windows 4 mt + gq / 4
      // and 4 mt + gq / 4 + 2: the four positions of a window sit in lanes
      // 4 apart. The larger sum wins, a tie the lower q: the first maximum.
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = acc[nt][e];
          int q = gq & 3;
#pragma unroll
          for (int s = 4; s <= 8; s *= 2) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, s);
            const int oq = __shfl_xor_sync(0xffffffffu, q, s);
            if (ov > v || (ov == v && oq < q)) {
              v = ov;
              q = oq;
            }
          }
          if ((gq & 3) == 0) {
            const int r = mt * 4 + gq / 4 + (e >> 1) * 2;
            const int co = nt * 8 + 2 * tq + (e & 1);
            os[r * kSORow + co] =
                __float2bfloat16(fmaxf(v + bias[nt][e & 1], 0.f));
            as[r * kSARow + co] = static_cast<uint8_t>(q);
          }
        }
      }
    }
    __syncthreads();
    if (kDenseOut) {
      // Thread t: 8 channels of window t / 4; threads < 128: 16 argmax
      // bytes of window t / 2.
      const int wi = w0 + t / 4;
      if (wi < wend) {
        *reinterpret_cast<uint4*>(mft_slab_w<bf16>(out, c, wi / per) +
                                  (wi % per) * kStemOut + 8 * (t % 4)) =
            *reinterpret_cast<const uint4*>(os + (t / 4) * kSORow +
                                            8 * (t % 4));
      }
      const int wa = w0 + t / 2;
      if (t < 2 * kStemWindows && wa < wend) {
        *reinterpret_cast<uint4*>(mft_slab_w<uint8_t>(arg, c, wa / per) +
                                  (wa % per) * kStemOut + 16 * (t % 2)) =
            *reinterpret_cast<const uint4*>(as + (t / 2) * kSARow +
                                            16 * (t % 2));
      }
    } else {
      for (int i = t; i < kStemWindows * kStemOut; i += kTcThreads) {
        const int r = i / kStemOut, co = i % kStemOut;
        const int wi = w0 + r;
        if (wi >= wend) continue;
        const int n = wi / per, p = wi % per;
        mft_st(out, mft_off(out, c, n, co, p / pw, p % pw),
               __bfloat162float(os[r * kSORow + co]));
        mft_st(arg, mft_off(arg, c, n, co, p / pw, p % pw),
               static_cast<float>(as[r * kSARow + co]));
      }
    }
  }
}

// ------------------------------------------------- conv2's forward, f32
//
// conv2_fwd_tf32: conv2_fwd_tc's implicit GEMM in f32, on mma.sync.m16n8k8
// TF32 in 3xTF32 as dense_fwd_tf32 forms its products. It replaces, in
// f32, conv2 with its bias, relu and 2 x 2 pool in forward_impl
// (multimodal_fl_security_tpu/ops/fused_train.py:383-401, through kdot3d,
// fused_kernel.py:136-139, whose f32 dots take f32 sums) inside
// fused_local_train (K4): Z[m, co] = sum over (kh, kw, ci) of
// X[(oy + kh - 1, ox + kw - 1), ci] W[co, ci, kh, kw]; per sample N = 64,
// K = 288, and M = 224 positions m = oy * 16 + ox on the halo's 16-wide
// rows (ox = 14, 15 are computed and dropped: 14 m16 tiles).
//  - Both operands have k = ci contiguous: A is the rows [halo pixel][ci]
//    of the zero-bordered input tile shifted by the tap (position m at tap
//    (kh, kw) reads pixel m + 16 kh + kw, so a tile's eight-row matrices
//    never straddle a halo row), B the weights staged [tap][co][ci]. Plain
//    ldmatrix gives lane l word l % 4 of row l / 4 of an 8 x 16-byte
//    matrix: the TF32 fragment of a [row][k] tile for A and of an [n][k]
//    tile for B.
//  - The budget: W's hi and lo (2 x 81 KB, rows padded to 36 words) stay
//    resident while a block runs its samples; a whole 32-channel input
//    tile as hi and lo (2 x 37 KB) would take the block over the 227 KB it
//    may use. So the tile holds one 16-channel half (2 x 20 KB, rows padded
//    to 20 words) and a sample is two passes over K, ci in [0, 16) and then
//    [16, 32), its sums kept in registers between them. Beside it, a 12 KB
//    buffer receives the next pass's half as it is (NHWC f32, by cp.async)
//    while the tensor cores run; once both passes are read, the f32 sums go
//    through a [co][m] tile (29 KB) laid over the input tile into the
//    pooled epilogue, 32 output channels at a time. 215 KB: one block an
//    SM.
//  - Each operand is split into hi = tf32(a) and lo = tf32(a - hi)
//    (mft_tf32_rne) once, as it is staged; lo hi + hi lo + hi hi in f32
//    sums. A fresh accumulator takes each (channel half, tap) (2 k8 steps,
//    6 mma an n8 tile) and is added to the sums in f32: the tensor cores'
//    sums do not round to nearest.
//  - Warp w: m16 tiles w and w + 8 (warps 6 and 7 one), all 64 channels,
//    sharing each B fragment between its two tiles.
//  - One block an SM, each running a contiguous range of the C x B
//    (client, sample) pairs in order and staging a client's weights when
//    its range reaches it: the last wave is as full as the others. Every
//    sum runs in a fixed order, with no atomics: two calls are bitwise
//    equal.
// What bounds it: 23.1 GFLOP over 100 clients x 32 samples, 69 GFLOP of
// TF32 mma in 3xTF32 (0.140 ms at 495 TFLOP/s), against ~138 MB of
// operands and outputs (0.041 ms at 3.35 TB/s): operations. Each k8 step
// of a two-tile warp reads its fragments with 12 ldmatrix (6 KB) for 48
// mma, so shared memory (128 B a clock an SM) is about as near its limit
// as the tensor cores.

constexpr int kTfZPos = kC2Hw * kHaloW;  // 224 positions m = oy * 16 + ox
constexpr int kTfZRow = kTfZPos + 4;     // 228 floats: [co][m]
constexpr int kFtHalf = kC2In / 2;      // 16 input channels a pass
constexpr int kFtXRow = kFtHalf + 4;    // 20 floats: [halo pixel][ci] rows
constexpr int kFtXPix = kHaloPix + 4;   // m + 16 kh + kw reaches pixel 257
constexpr int kFtWRow = kC2In + 4;      // 36 floats: [tap][co][ci] rows
constexpr int kFtTiles = kTfZPos / 16;  // 14 m16 tiles of positions
constexpr int kFtPoolCo = kC2Out / 2;   // output channels pooled at a time
constexpr size_t kFtWBytes = sizeof(float) * 2 * 9 * kC2Out * kFtWRow;
constexpr size_t kFtXBytes = sizeof(float) * 2 * kFtXPix * kFtXRow;
constexpr size_t kFtRawBytes = sizeof(float) * kC2Pos * kFtHalf;
constexpr size_t kFtSmem =
    kFtWBytes + sizeof(float) * kC2Out + kFtXBytes + kFtRawBytes;

static_assert(kFtSmem <= kMftMaxSmem, "one block an SM");
static_assert(sizeof(float) * kFtPoolCo * kTfZRow <= kFtXBytes,
              "the sums' tile lies within the input tile");
static_assert(kFtTiles <= 2 * kTcWarps, "two m16 tiles a warp at most");

// One channel half of conv2's input of one sample, split, into the
// zero-bordered tiles xh, xl [halo pixel][ci of the half]. Dense: an NHWC
// f32 slab [14][14][32], 16-byte aligned, as the stem's f32 forward writes
// it; load copies a thread's four 16-byte chunks into raw [pixel][ci of
// the half] by cp.async, and store splits the same chunks (no barrier
// between: each thread waits for its own copies). Otherwise: any strides
// and types, one element at a time.
template <bool kDense>
struct C2HalfInputF32;

template <>
struct C2HalfInputF32<true> {
  static constexpr int kChunks = kC2Pos * kFtHalf / 4;  // 784
  static constexpr int kLoads = (kChunks + kTcThreads - 1) / kTcThreads;
  float* raw;

  __device__ __forceinline__ void load(const MftView& x, int c, int n,
                                       int half) {
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = threadIdx.x + k * kTcThreads;
      if (i < kChunks) {  // pixel i / 4, channels half * 16 + 4 (i % 4)
        mft_cp_async16(mft_smem_addr(raw + 4 * i),
                       mft_slab<float>(x, c, n) + (i / 4) * kC2In +
                           half * kFtHalf + 4 * (i % 4),
                       16);
      }
    }
    mft_cp_async_commit();
  }

  __device__ __forceinline__ void store(float* xh, float* xl) const {
    mft_cp_async_wait<0>();
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = threadIdx.x + k * kTcThreads;
      if (i < kChunks) {
        const int p = i / 4;
        const int at =
            ((p / kC2Hw + 1) * kHaloW + p % kC2Hw + 1) * kFtXRow + 4 * (i % 4);
        const float4 v = *reinterpret_cast<const float4*>(raw + 4 * i);
        float hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = mft_f4_at(v, e);
          hi[e] = mft_tf32_rne(a);
          lo[e] = mft_tf32_rne(a - hi[e]);
        }
        *reinterpret_cast<float4*>(xh + at) =
            make_float4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<float4*>(xl + at) =
            make_float4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }
};

template <>
struct C2HalfInputF32<false> {
  float* raw;  // unused
  const MftView* x_;
  int c_, n_, half_;

  __device__ __forceinline__ void load(const MftView& x, int c, int n,
                                       int half) {
    x_ = &x, c_ = c, n_ = n, half_ = half;
  }

  __device__ __forceinline__ void store(float* xh, float* xl) const {
    for (int i = threadIdx.x; i < kC2Pos * kFtHalf; i += kTcThreads) {
      const int ci = i % kFtHalf, p = i / kFtHalf;
      const int iy = p / kC2Hw, ix = p % kC2Hw;
      const float a =
          mft_ld(*x_, mft_off(*x_, c_, n_, half_ * kFtHalf + ci, iy, ix));
      const float hi = mft_tf32_rne(a);
      const int at = ((iy + 1) * kHaloW + ix + 1) * kFtXRow + ci;
      xh[at] = hi;
      xl[at] = mft_tf32_rne(a - hi);
    }
  }
};

// One pass of conv2_fwd_tf32 over K for a warp's kTiles m16 tiles: the nine
// taps of the staged channel half, each tap's 2 k8 steps into a fresh
// accumulator added to acc in f32. The fresh accumulator is taken 16
// output channels at a time, so that it holds 16 words, not 64: the order
// of each output's sums is the same. a_hi, a_lo: this lane's ldmatrix
// addresses in the input tile at tap (0, 0) of its first tile (the second
// is 8 tiles, 128 pixels, on); b_hi, b_lo: its addresses in W's tap 0 at
// the pass's channels.
template <int kTiles>
__device__ __forceinline__ void c2_fwd_pass(float (&acc)[2][8][4],
                                            uint32_t a_hi, uint32_t a_lo,
                                            uint32_t b_hi, uint32_t b_lo) {
  constexpr int kSteps = kFtHalf / 8;  // k8 steps of a tap
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const uint32_t a_tap =
        ((tap / 3) * kHaloW + tap % 3) * kFtXRow * sizeof(float);
    const uint32_t b_tap = tap * kC2Out * kFtWRow * sizeof(float);
    uint32_t ah[kSteps][kTiles][4], al[kSteps][kTiles][4];
#pragma unroll
    for (int kc = 0; kc < kSteps; ++kc) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const uint32_t off =
            a_tap + (j * 8 * 16 * kFtXRow + kc * 8) * sizeof(float);
        ldsm4(ah[kc][j], a_hi + off);
        ldsm4(al[kc][j], a_lo + off);
      }
    }
#pragma unroll
    for (int ng = 0; ng < kC2Out / 16; ++ng) {
      float part[kTiles][2][4] = {};
#pragma unroll
      for (int kc = 0; kc < kSteps; ++kc) {
        // co 16 ng + [0, 16): b0, b1 of the n8 tile 2 ng, then 2 ng + 1.
        const uint32_t off =
            b_tap + (ng * 16 * kFtWRow + kc * 8) * sizeof(float);
        uint32_t bh[4], bl[4];
        ldsm4(bh, b_hi + off);
        ldsm4(bl, b_lo + off);
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            float(&d)[4] = part[j][s];
            mma1688_tf32(d, al[kc][j], bh[2 * s], bh[2 * s + 1]);  // small
            mma1688_tf32(d, ah[kc][j], bl[2 * s], bl[2 * s + 1]);  // first
            mma1688_tf32(d, ah[kc][j], bh[2 * s], bh[2 * s + 1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][2 * ng + s][e] += part[j][s][e];
        }
      }
    }
  }
}

// conv2_fwd_tf32's pooled epilogue for pair i = co * 49 + p of the f32
// sums zf [co][m], m = oy * 16 + ox (co counted from the tile's first
// channel, as bs is): the window's value through the f32 bias and relu, and
// its argmax in q.
__device__ __forceinline__ float c2_pool_f32(const float* zf, const float* bs,
                                             int i, int& q) {
  const int co = i / kC2Pooled, p = i % kC2Pooled;
  const float* z =
      zf + co * kTfZRow + 2 * (p / kC2Pw) * kHaloW + 2 * (p % kC2Pw);
  const float v[4] = {z[0], z[1], z[kHaloW], z[kHaloW + 1]};
  float best = v[0];
  q = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (v[k] > best) {  // ties: the first in (di, dj) order
      best = v[k];
      q = k;
    }
  }
  return fmaxf(best + bs[co], 0.f);
}

// Block b runs (client, sample) pairs [b S / G, (b + 1) S / G) of the S =
// C x B, G = gridDim.x, sample-fastest. Dense x: cp.async into the raw
// buffer while the tensor cores run (C2HalfInputF32). Dense out and arg:
// NCHW slabs [64][7][7] (f32, bytes; 16-byte aligned), four pairs a thread
// written as one 16-byte and one 4-byte store; otherwise any strides and
// types, one element at a time.
template <bool kDenseX, bool kDenseOut>
__global__ void __launch_bounds__(kTcThreads, 1)
conv2_fwd_tf32_kernel(MftView x, MftView w, MftView b, MftView out,
                      MftView arg, int batch, int samples) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* wh = reinterpret_cast<float*>(smem_raw);  // [tap][co][ci]
  float* wl = wh + 9 * kC2Out * kFtWRow;
  float* bs = wl + 9 * kC2Out * kFtWRow;  // the bias
  float* xh = bs + kC2Out;                // [halo pixel][ci of the pass]
  float* xl = xh + kFtXPix * kFtXRow;
  float* zf = xh;  // [co][m], 32 channels' sums, over xh, xl once read
  const int s0 = static_cast<int>(static_cast<long long>(blockIdx.x) *
                                  samples / gridDim.x);
  const int s1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                                  samples / gridDim.x);
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int li = lane >> 3, lr = lane & 7;  // ldmatrix: matrix, row
  const int gq = lane >> 2, tq = lane & 3;  // the accumulators' row, pair
  // A (ldmatrix x4): matrix li is rows 8 (li & 1) + [0, 8) of a tile, k
  // 4 (li >> 1) + [0, 4); this lane's row of tile `warp` is position (and,
  // at tap (0, 0), pixel) 16 warp + 8 (li & 1) + lr.
  const bool two = warp + kTcWarps < kFtTiles;  // warp-uniform
  const uint32_t a_row =
      ((warp * 16 + (li & 1) * 8 + lr) * kFtXRow + (li >> 1) * 4) *
      sizeof(float);
  const uint32_t a_hi = mft_smem_addr(xh) + a_row;
  const uint32_t a_lo = mft_smem_addr(xl) + a_row;
  // B (ldmatrix x4): matrix li is co 8 (li >> 1) + [0, 8), k 4 (li & 1)
  // + [0, 4).
  const uint32_t b_row =
      (((li >> 1) * 8 + lr) * kFtWRow + (li & 1) * 4) * sizeof(float);
  const uint32_t b_hi = mft_smem_addr(wh) + b_row;
  const uint32_t b_lo = mft_smem_addr(wl) + b_row;
  C2HalfInputF32<kDenseX> xr;
  xr.raw = xl + kFtXPix * kFtXRow;  // [pixel][ci], the next pass's as read
  if (s0 < s1) xr.load(x, s0 / batch, s0 % batch, 0);
  int staged = -1;  // the client whose weights are in wh, wl and bs
  for (int s = s0; s < s1; ++s) {
    const int c = s / batch, n = s % batch;
    float acc[2][8][4] = {};
    for (int half = 0; half < 2; ++half) {
      __syncthreads();  // the last pass's tiles, or the last sample's sums,
                        // read
      if (half == 0) {
        if (c != staged) {
          // Thread i stages the 9 taps of (co, ci) = (i / 32, i % 32),
          // adjacent in w's own order; a warp's lanes write adjacent ci.
          for (int i = t; i < kC2Out * kC2In; i += kTcThreads) {
            const int co = i / kC2In, ci = i % kC2In;
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
              const float a =
                  mft_ld(w, mft_off(w, c, co, ci, tap / 3, tap % 3));
              const float hi = mft_tf32_rne(a);
              const int at = (tap * kC2Out + co) * kFtWRow + ci;
              wh[at] = hi;
              wl[at] = mft_tf32_rne(a - hi);
            }
          }
          if (t < kC2Out) bs[t] = mft_ld(b, mft_off(b, c, 0, t, 0, 0));
          staged = c;
        }
        // The sums overwrote the border: zero its 60 pixels again.
        if (t < 60 * kFtHalf / 4) {
          const int bp = t / 4;
          const int pix = bp < 16   ? bp
                          : bp < 32 ? (kHaloW - 1) * kHaloW + bp - 16
                          : bp < 46 ? (bp - 31) * kHaloW
                                    : (bp - 45) * kHaloW + kHaloW - 1;
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(xh + pix * kFtXRow + 4 * (t % 4)) = z;
          *reinterpret_cast<float4*>(xl + pix * kFtXRow + 4 * (t % 4)) = z;
        }
      }
      xr.store(xh, xl);
      __syncthreads();
      if (half == 0) {
        xr.load(x, c, n, 1);
      } else if (s + 1 < s1) {
        xr.load(x, (s + 1) / batch, (s + 1) % batch, 0);
      }
      const uint32_t b_half = half * kFtHalf * sizeof(float);
      if (two) {
        c2_fwd_pass<2>(acc, a_hi, a_lo, b_hi + b_half, b_lo + b_half);
      } else {
        c2_fwd_pass<1>(acc, a_hi, a_lo, b_hi + b_half, b_lo + b_half);
      }
    }
    // The pooled epilogue, 32 output channels at a time.
#pragma unroll
    for (int ch = 0; ch < kC2Out / kFtPoolCo; ++ch) {
      __syncthreads();  // every warp has read the tiles, or the last sums
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j == 1 && !two) break;
#pragma unroll
        for (int nt = 0; nt < kFtPoolCo / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = (warp + j * kTcWarps) * 16 + gq + (e >> 1) * 8;
            zf[(nt * 8 + 2 * tq + (e & 1)) * kTfZRow + m] =
                acc[j][ch * kFtPoolCo / 8 + nt][e];
          }
        }
      }
      __syncthreads();
      constexpr int kPairs = kFtPoolCo * kC2Pooled;  // 1568
      const float* bh = bs + ch * kFtPoolCo;
      if (kDenseOut) {
        // Pairs 4 (t + 256 k) .. + 3 of the 32 channels: one 16-byte and
        // one 4-byte store each.
#pragma unroll
        for (int k = 0; k < (kPairs / 4 + kTcThreads - 1) / kTcThreads; ++k) {
          const int i0 = 4 * (t + k * kTcThreads);
          if (i0 < kPairs) {
            float v[4];
            int q[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              v[e] = c2_pool_f32(zf, bh, i0 + e, q[e]);
            }
            const int at = ch * kPairs + i0;
            *reinterpret_cast<float4*>(mft_slab_w<float>(out, c, n) + at) =
                make_float4(v[0], v[1], v[2], v[3]);
            *reinterpret_cast<uint32_t*>(mft_slab_w<uint8_t>(arg, c, n) +
                                         at) =
                static_cast<uint32_t>(q[0]) |
                static_cast<uint32_t>(q[1]) << 8 |
                static_cast<uint32_t>(q[2]) << 16 |
                static_cast<uint32_t>(q[3]) << 24;
          }
        }
      } else {
        for (int i = t; i < kPairs; i += kTcThreads) {
          int q;
          const float v = c2_pool_f32(zf, bh, i, q);
          const int co = ch * kFtPoolCo + i / kC2Pooled, p = i % kC2Pooled;
          mft_st(out, mft_off(out, c, n, co, p / kC2Pw, p % kC2Pw), v);
          mft_st(arg, mft_off(arg, c, n, co, p / kC2Pw, p % kC2Pw),
                 static_cast<float>(q));
        }
      }
    }
  }
}

// ------------------------------------------------ the stem's forward, f32
//
// stem_fwd_f32: the stem's pooled forward in f32, exact f32 FMA on the
// CUDA cores. It replaces, in f32, forward_impl's stem
// (multimodal_fl_security_tpu/ops/fused_train.py:361-381: ConvPoolFused,
// the 4x4 stride-2 conv on the embedded kernel w4, the max over its four
// channel groups, bias and relu, through kdot3d's f32 sums) inside
// fused_local_train (K4). At K = 9 cin the tensor cores buy nothing: K
// pads to a k8 step and each product takes three mma in 3xTF32
// (stem_fwd_tc runs at 9x its bound in bf16).
//  - Thread t of a block: window t / 4 of the block's 64 at a time (the
//    windows of a client in (sample, row, column) order) and output
//    channels c0 + [0, 4) and 16 + c0 + [0, 4), c0 = 4 (t % 4). Per input
//    channel it holds the window's 4 x 4 patch in registers (0 outside the
//    image; the window's four threads load the same words) and runs its 4
//    positions x 8 channels x 9 taps: each tap's 8 weights are two float4
//    loads from shared memory (one address for eight lanes), 32 FMA. The
//    sums run over (ci, kh, kw) in that order. The next patch's loads are
//    in flight while this one's FMA run.
//  - The max over the four positions (the first maximum in (di, dj)
//    order), the bias and relu in registers. NHWC maps (the main path's):
//    each of a thread's two 16-byte stores of the f32 map and two 4-byte
//    argmax stores writes, with the window's other three threads, a
//    contiguous run of the window's pixel; otherwise any strides and
//    types, one element at a time.
// What bounds it: 1.44 GFLOP over 100 clients x 32 samples at cin = 1
// (0.022 ms at the f32 CUDA-core rate) against ~110 MB (10 MB of images in,
// 80 MB of maps and 20 MB of argmax out: 0.033 ms at 3.35 TB/s): bytes.

constexpr int kSfWins = kTcThreads / 4;  // windows a block runs at once
constexpr int kSf32Chunks = 4;           // kSfWins-window chunks a block runs

template <bool kDenseOut>
__global__ void __launch_bounds__(kTcThreads, 2)
stem_fwd_f32_kernel(MftView x, MftView w, MftView b, MftView out, MftView arg,
                    ConvGeom g) {
  __shared__ __align__(16) float ws[8 * 9 * kStemOut];  // [ci][tap][co]
  __shared__ __align__(16) float bs[kStemOut];
  const int c = blockIdx.y;
  const int t = threadIdx.x;
  for (int i = t; i < 9 * g.cin * kStemOut; i += kTcThreads) {
    const int co = i % kStemOut, j = i / kStemOut;  // j = ci * 9 + tap
    const int ci = j / 9, tap = j % 9;
    ws[i] = mft_ld(w, mft_off(w, c, co, ci, tap / 3, tap % 3));
  }
  if (t < kStemOut) bs[t] = mft_ld(b, mft_off(b, c, 0, t, 0, 0));
  const int c0 = 4 * (t % 4);  // channels c0 + [0, 4), 16 + c0 + [0, 4)
  const int pw = g.ow / 2;
  const int per = (g.oh / 2) * pw;
  const int total = g.batch * per;
  const int w0 = blockIdx.x * kSf32Chunks * kSfWins + t / 4;
  // One input channel's patch of window wi: rows 2 oi - 1 + r, columns
  // 2 oj - 1 + u.
  float v[4][4];
  auto load = [&](int wi, int ci) {
    const int n = wi / per, p = wi % per;
    const int oi = p / pw, oj = p % pw;
    const float* xs = mft_slab<float>(x, c, n) + ci * x.st[2];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int iy = 2 * oi - 1 + r;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ix = 2 * oj - 1 + u;
        v[r][u] = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w
                      ? xs[iy * x.st[3] + ix * x.st[4]]
                      : 0.f;
      }
    }
  };
  if (w0 < total) load(w0, 0);
  __syncthreads();  // the weights and bias are staged
  const float4* wv = reinterpret_cast<const float4*>(ws) + c0 / 4;
  for (int k = 0; k < kSf32Chunks; ++k) {
    const int wi = w0 + k * kSfWins;
    if (wi >= total) return;
    float acc[4][8] = {};
    for (int ci = 0; ci < g.cin; ++ci) {
      float cur[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int u = 0; u < 4; ++u) cur[r][u] = v[r][u];
      }
      if (ci + 1 < g.cin) {
        load(wi, ci + 1);
      } else if (k + 1 < kSf32Chunks && wi + kSfWins < total) {
        load(wi + kSfWins, 0);
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float4 wa = wv[(ci * 9 + tap) * (kStemOut / 4)];
        const float4 wb = wv[(ci * 9 + tap) * (kStemOut / 4) + 4];
        const float wt[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // position (di, dj) = (q / 2, q % 2)
          const float xv = cur[q / 2 + tap / 3][q % 2 + tap % 3];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[q][e] = fmaf(xv, wt[e], acc[q][e]);
        }
      }
    }
    float val[8];
    uint32_t qw[2] = {0u, 0u};  // the argmax bytes of c0 + [0, 4), 16 + ...
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float best = acc[0][e];
      uint32_t q = 0;
#pragma unroll
      for (int qq = 1; qq < 4; ++qq) {
        if (acc[qq][e] > best) {  // ties: the first in (di, dj) order
          best = acc[qq][e];
          q = qq;
        }
      }
      val[e] = fmaxf(best + bs[c0 + (e / 4) * 16 + e % 4], 0.f);
      qw[e / 4] |= q << (8 * (e % 4));
    }
    const int n = wi / per, p = wi % per;
    if (kDenseOut) {
      float* o = mft_slab_w<float>(out, c, n) + p * kStemOut + c0;
      *reinterpret_cast<float4*>(o) =
          make_float4(val[0], val[1], val[2], val[3]);
      *reinterpret_cast<float4*>(o + 16) =
          make_float4(val[4], val[5], val[6], val[7]);
      uint8_t* a = mft_slab_w<uint8_t>(arg, c, n) + p * kStemOut + c0;
      *reinterpret_cast<uint32_t*>(a) = qw[0];
      *reinterpret_cast<uint32_t*>(a + 16) = qw[1];
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int co = c0 + (e / 4) * 16 + e % 4;
        mft_st(out, mft_off(out, c, n, co, p / pw, p % pw), val[e]);
        mft_st(arg, mft_off(arg, c, n, co, p / pw, p % pw),
               static_cast<float>(qw[e / 4] >> (8 * (e % 4)) & 0xffu));
      }
    }
  }
}

// What the tensor-core kernels take: bf16, a pooled 3 x 3 SAME convolution
// at stride 1 with conv2's shape or, given its f32 input x (weight gradient
// only), a stem's (1 <= cin <= 8 -> 32: 9 cin columns and the ones column
// in at most 80), and dp in bf16.
enum TcKind : int { kTcNone = 0, kTcConv2 = 1, kTcStem = 2 };

TcKind tc_kind(const ConvGeom& g, const MftView& dp, const MftView* x) {
  if (g.cdt != kBF16 || g.k != 3 || g.stride != 1 || g.pad != 1 || !g.pool ||
      g.oh != g.h || g.ow != g.w || g.h % 2 || g.w % 2 || dp.dtype != kBF16) {
    return kTcNone;
  }
  if (g.cin == kC2In && g.cout == kC2Out && g.h == kC2Hw && g.w == kC2Hw) {
    return kTcConv2;
  }
  if (x && x->dtype == kF32 && g.cout == kStemOut && g.cin >= 1 &&
      9 * g.cin < 80) {
    return kTcStem;
  }
  return kTcNone;
}

// The forward's: bf16, pooled 3 x 3 SAME at stride 1, conv2's shape or a
// stem's (1 <= cin <= 8 -> 32, its input x in f32).
TcKind fwd_tc_kind(const ConvGeom& g, const MftView& x) {
  if (g.cdt != kBF16 || g.k != 3 || g.stride != 1 || g.pad != 1 || !g.pool ||
      g.oh != g.h || g.ow != g.w || g.h % 2 || g.w % 2) {
    return kTcNone;
  }
  if (g.cin == kC2In && g.cout == kC2Out && g.h == kC2Hw && g.w == kC2Hw) {
    return kTcConv2;
  }
  if (x.dtype == kF32 && g.cout == kStemOut && g.cin >= 1 && g.cin <= 8) {
    return kTcStem;
  }
  return kTcNone;
}

// Whether view v's sample slabs are dense with (channel, row, column)
// strides (s2, s3, s4), of `dtype`, and 16-byte aligned (sample and client
// strides too): the layouts the kernels read with vector loads.
bool dense_slab(const MftView& v, int dtype, long long s2, long long s3,
                long long s4) {
  const long long per16 = dtype == kU8 ? 16 : 8;  // elements in 16 bytes
  return v.dtype == dtype && v.st[2] == s2 && v.st[3] == s3 &&
         v.st[4] == s4 && v.st[0] % per16 == 0 && v.st[1] % per16 == 0 &&
         reinterpret_cast<uintptr_t>(v.ptr) % 16 == 0;
}

// dp, h and the argmax as dense NCHW (conv2) or NHWC (stem) slabs.
bool dense_windows(const MftView& dp, const MftView& h, const MftView& arg,
                   const ConvGeom& g, bool nhwc) {
  const long long pw = g.ow / 2, ph = g.oh / 2;
  const long long s2 = nhwc ? 1 : ph * pw, s3 = nhwc ? pw * g.cout : pw,
                  s4 = nhwc ? g.cout : 1;
  return dense_slab(dp, kBF16, s2, s3, s4) &&
         dense_slab(h, kBF16, s2, s3, s4) && dense_slab(arg, kU8, s2, s3, s4);
}

template <typename Kernel, typename... Views>
cudaError_t launch_tc(Kernel kernel, dim3 grid, size_t smem,
                      cudaStream_t stream, int batch, const Views*... v) {
  cudaError_t err = mft_smem_optin(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcThreads, smem, stream>>>(*v..., batch);
  return cudaGetLastError();
}

template <int NJP, bool kDenseZ>
cudaError_t launch_stem(const MftView* x, const MftView* dp, const MftView* h,
                        const MftView* arg, const MftView* gw,
                        const MftView* gb, const MftConvArgs* a,
                        cudaStream_t stream) {
  constexpr size_t smem = stem_wgrad_smem<NJP>();
  const auto kernel = stem_wgrad_tc_kernel<NJP, kDenseZ>;
  cudaError_t err = mft_smem_optin(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a->clients, kStemCluster), kTcThreads, smem, stream>>>(
      *x, *dp, *h, *arg, *gw, *gb, a->g);
  return cudaGetLastError();
}

template <bool kDenseZ>
cudaError_t launch_stem(const MftView* x, const MftView* dp, const MftView* h,
                        const MftView* arg, const MftView* gw,
                        const MftView* gb, const MftConvArgs* a,
                        cudaStream_t st) {
  // The columns and the ones: 16 for the path's one channel, else 80 (up
  // to 8 channels; two sizes keep the build short).
  return a->g.cin == 1
             ? launch_stem<16, kDenseZ>(x, dp, h, arg, gw, gb, a, st)
             : launch_stem<80, kDenseZ>(x, dp, h, arg, gw, gb, a, st);
}

template <int NJP, bool kDenseZ>
cudaError_t launch_stem_tf32(const MftView* x, const MftView* dp,
                             const MftView* h, const MftView* arg,
                             const MftView* gw, const MftView* gb,
                             const MftConvArgs* a, cudaStream_t stream) {
  constexpr size_t smem = stem_tf32_smem<NJP>();
  const auto kernel = stem_wgrad_tf32_kernel<NJP, kDenseZ>;
  cudaError_t err = mft_smem_optin(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a->clients, kStfCluster), kStfThreads, smem, stream>>>(
      *x, *dp, *h, *arg, *gw, *gb, a->g);
  return cudaGetLastError();
}

template <bool kDenseZ>
cudaError_t launch_stem_tf32(const MftView* x, const MftView* dp,
                             const MftView* h, const MftView* arg,
                             const MftView* gw, const MftView* gb,
                             const MftConvArgs* a, cudaStream_t st) {
  // The columns and the ones: 16 for the path's one channel, else 80.
  return a->g.cin == 1
             ? launch_stem_tf32<16, kDenseZ>(x, dp, h, arg, gw, gb, a, st)
             : launch_stem_tf32<80, kDenseZ>(x, dp, h, arg, gw, gb, a, st);
}

template <int NJP, bool kDenseOut>
cudaError_t launch_stem_fwd(const MftView* x, const MftView* w,
                            const MftView* b, const MftView* out,
                            const MftView* arg, const MftConvArgs* a,
                            cudaStream_t stream) {
  constexpr size_t smem = stem_fwd_smem<NJP>();
  const auto kernel = stem_fwd_tc_kernel<NJP, kDenseOut>;
  cudaError_t err = mft_smem_optin(kernel, smem);
  if (err != cudaSuccess) return err;
  const int windows = a->g.batch * (a->g.oh / 2) * (a->g.ow / 2);
  const int per_block = kSfChunks * kStemWindows;
  kernel<<<dim3((windows + per_block - 1) / per_block, a->clients),
           kTcThreads, smem, stream>>>(*x, *w, *b, *out, *arg, a->g);
  return cudaGetLastError();
}

template <bool kDenseOut>
cudaError_t launch_stem_fwd(const MftView* x, const MftView* w,
                            const MftView* b, const MftView* out,
                            const MftView* arg, const MftConvArgs* a,
                            cudaStream_t st) {
  // The 9 cin columns padded to 16 for the path's one channel, else 80.
  return a->g.cin == 1
             ? launch_stem_fwd<16, kDenseOut>(x, w, b, out, arg, a, st)
             : launch_stem_fwd<80, kDenseOut>(x, w, b, out, arg, a, st);
}

// What conv2_wgrad_tf32 and conv2_dgrad_tf32 take: f32 compute, a pooled
// 3 x 3 SAME convolution at stride 1 with conv2's shape; operands of any
// strides and types.
bool conv2_tf32_takes(const ConvGeom& g) {
  return g.cdt == kF32 && g.k == 3 && g.stride == 1 && g.pad == 1 && g.pool &&
         g.cin == kC2In && g.cout == kC2Out && g.h == kC2Hw &&
         g.w == kC2Hw && g.oh == kC2Hw && g.ow == kC2Hw;
}

// What stem_fwd_f32 and stem_wgrad_tf32 take: f32 compute, a pooled 3 x 3
// SAME convolution at stride 1 with a stem's shape (1 <= cin <= 8 -> 32
// channels, even sizes), its input x in f32; the other operands of any
// strides and types.
bool stem_f32_takes(const ConvGeom& g, const MftView& x) {
  return g.cdt == kF32 && g.k == 3 && g.stride == 1 && g.pad == 1 && g.pool &&
         g.oh == g.h && g.ow == g.w && g.h % 2 == 0 && g.w % 2 == 0 &&
         g.cout == kStemOut && g.cin >= 1 && g.cin <= 8 && x.dtype == kF32;
}

// What stem_wgrad_tf32 takes: stem_fwd_f32's geometry, with the input's
// offsets inside a sample in 32 bits.
bool stem_wgrad_tf32_takes(const ConvGeom& g, const MftView& x) {
  const long long span = (g.cin - 1) * std::llabs(x.st[2]) +
                         (g.h - 1) * std::llabs(x.st[3]) +
                         (g.w - 1) * std::llabs(x.st[4]);
  return stem_f32_takes(g, x) && span <= INT_MAX;
}

}  // namespace

extern "C" {

// The raw forward in f32: x (client, sample, channel, row, col), w (client,
// co, ci, kh, kw); out (client, sample, co, row, col). A pooled or bf16 call
// is refused: the pooled forward runs conv2_fwd_tf32 and stem_fwd_f32 in
// f32 (mft_conv2_fwd_tf32, mft_stem_fwd_f32).
int mft_conv_fwd(const MftView* x, const MftView* w, const MftView* out,
                 const MftConvArgs* a, int device, void* stream) {
  const ConvGeom& g = a->g;
  if (a->clients <= 0 || g.batch <= 0 || g.cin <= 0 || g.cout <= 0 ||
      g.pool || g.cdt != kF32) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(g.k) * g.k * g.cin * g.cout +
       static_cast<size_t>(g.h) * g.w * g.cin);
  if (smem > kMftMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = mft_smem_optin(conv_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  conv_fwd_kernel<<<dim3(g.batch, a->clients), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(*x, *w, *out, g);
  return cudaGetLastError();
}

// The tensor-core kernels for the compute dtype bf16. The weight gradient:
// x is the layer's input, dp the pooled output's gradient, h the pooled
// output (relu mask), arg its argmax; it writes gw (client, co, ci, kh, kw)
// and gb (client, -, co). The input gradient writes dx (client, sample, ci,
// row, col) from dp, h and arg, read the same way, and the weights w. What they do not take (mft_conv_tc_kind 0, with x null for
// the input gradient) is refused, never handed to another kernel.
int mft_conv_tc_kind(const MftConvArgs* a, const MftView* dp,
                     const MftView* x) {
  return tc_kind(a->g, *dp, x);
}

int mft_conv_wgrad_tc(const MftView* x, const MftView* dp, const MftView* h,
                      const MftView* arg, const MftView* gw,
                      const MftView* gb, const MftConvArgs* a, int device,
                      void* stream) {
  const ConvGeom& g = a->g;
  const TcKind kind = tc_kind(g, *dp, x);
  if (a->clients <= 0 || g.batch <= 0 || kind == kTcNone) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == kTcStem) {
    return dense_windows(*dp, *h, *arg, g, true)
               ? launch_stem<true>(x, dp, h, arg, gw, gb, a, st)
               : launch_stem<false>(x, dp, h, arg, gw, gb, a, st);
  }
  const bool dx = dense_slab(*x, kBF16, 1, kC2Hw * kC2In, kC2In);
  const bool dz = dense_windows(*dp, *h, *arg, g, false);
  const size_t smem = sizeof(bf16) * (kHaloPix * kXRow + kC2Out * kZCol);
  const auto kernel = dx ? (dz ? conv2_wgrad_tc_kernel<true, true>
                                : conv2_wgrad_tc_kernel<true, false>)
                          : (dz ? conv2_wgrad_tc_kernel<false, true>
                                : conv2_wgrad_tc_kernel<false, false>);
  return launch_tc(kernel, dim3(3, a->clients), smem, st, g.batch, x, dp, h,
                   arg, gw, gb);
}

int mft_conv_dgrad_tc(const MftView* dp, const MftView* h, const MftView* arg,
                      const MftView* w, const MftView* dx,
                      const MftConvArgs* a, int device, void* stream) {
  const ConvGeom& g = a->g;
  if (a->clients <= 0 || g.batch <= 0 || tc_kind(g, *dp, nullptr) != kTcConv2) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(bf16) * (9 * kC2In * kZRow + kHaloPix * kZRow);
  const dim3 grid((g.batch + kDgSamples - 1) / kDgSamples, a->clients);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = dense_windows(*dp, *h, *arg, g, false)
                          ? conv2_dgrad_tc_kernel<true>
                          : conv2_dgrad_tc_kernel<false>;
  return launch_tc(kernel, grid, smem, st, g.batch, dp, h, arg, w, dx);
}

// conv2's weight gradient for the compute dtype f32, in 3xTF32: the same
// arguments as mft_conv_wgrad_tc. What mft_conv2_wgrad_tf32_takes refuses is
// refused, never handed to another kernel.
int mft_conv2_wgrad_tf32_takes(const MftConvArgs* a) {
  return conv2_tf32_takes(a->g);
}

int mft_conv2_wgrad_tf32(const MftView* x, const MftView* dp,
                         const MftView* h, const MftView* arg,
                         const MftView* gw, const MftView* gb,
                         const MftConvArgs* a, int device, void* stream) {
  const ConvGeom& g = a->g;
  if (a->clients <= 0 || g.batch <= 0 || !conv2_tf32_takes(g)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // The main path's layouts: the input NHWC and the maps NCHW, f32.
  const bool dx = dense_slab(*x, kF32, 1, kC2Hw * kC2In, kC2In);
  const bool dz = dense_slab(*dp, kF32, kC2Pooled, kC2Pw, 1) &&
                  dense_slab(*h, kF32, kC2Pooled, kC2Pw, 1) &&
                  dense_slab(*arg, kU8, kC2Pooled, kC2Pw, 1);
  const auto kernel = dx ? (dz ? conv2_wgrad_tf32_kernel<true, true>
                               : conv2_wgrad_tf32_kernel<true, false>)
                         : (dz ? conv2_wgrad_tf32_kernel<false, true>
                               : conv2_wgrad_tf32_kernel<false, false>);
  err = mft_smem_optin(kernel, kWgSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a->clients, kWgCluster), kWgThreads, kWgSmem,
           static_cast<cudaStream_t>(stream)>>>(*x, *dp, *h, *arg, *gw, *gb,
                                                g.batch);
  return cudaGetLastError();
}

// The stem's weight gradient for the compute dtype f32, in 3xTF32: the same
// arguments as mft_conv_wgrad_tc. What mft_stem_wgrad_tf32_takes refuses is
// refused, never handed to another kernel.
int mft_stem_wgrad_tf32_takes(const MftConvArgs* a, const MftView* x) {
  return stem_wgrad_tf32_takes(a->g, *x);
}

int mft_stem_wgrad_tf32(const MftView* x, const MftView* dp,
                        const MftView* h, const MftView* arg,
                        const MftView* gw, const MftView* gb,
                        const MftConvArgs* a, int device, void* stream) {
  const ConvGeom& g = a->g;
  const long long windows =
      static_cast<long long>(g.batch) * (g.oh / 2) * (g.ow / 2);
  if (a->clients <= 0 || g.batch <= 0 || windows > INT_MAX ||
      !stem_wgrad_tf32_takes(g, *x)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // The main path's layout: the maps NHWC, f32, the samples back to back.
  const long long pw = g.ow / 2, per = (g.oh / 2) * pw * kStemOut;
  const bool dz = dense_slab(*dp, kF32, 1, pw * kStemOut, kStemOut) &&
                  dense_slab(*h, kF32, 1, pw * kStemOut, kStemOut) &&
                  dense_slab(*arg, kU8, 1, pw * kStemOut, kStemOut) &&
                  dp->st[1] == per && h->st[1] == per && arg->st[1] == per;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dz ? launch_stem_tf32<true>(x, dp, h, arg, gw, gb, a, st)
            : launch_stem_tf32<false>(x, dp, h, arg, gw, gb, a, st);
}

// conv2's input gradient for the compute dtype f32, in 3xTF32: the same
// arguments as mft_conv_dgrad_tc. What mft_conv2_dgrad_tf32_takes refuses is
// refused, never handed to another kernel.
int mft_conv2_dgrad_tf32_takes(const MftConvArgs* a) {
  return conv2_tf32_takes(a->g);
}

int mft_conv2_dgrad_tf32(const MftView* dp, const MftView* h,
                         const MftView* arg, const MftView* w,
                         const MftView* dx, const MftConvArgs* a, int device,
                         void* stream) {
  const ConvGeom& g = a->g;
  if (a->clients <= 0 || g.batch <= 0 || !conv2_tf32_takes(g)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // The main path's layouts: the maps NCHW, f32, and dX NHWC.
  const bool dz = dense_slab(*dp, kF32, kC2Pooled, kC2Pw, 1) &&
                  dense_slab(*h, kF32, kC2Pooled, kC2Pw, 1) &&
                  dense_slab(*arg, kU8, kC2Pooled, kC2Pw, 1);
  const bool dout = dense_slab(*dx, kF32, 1, kC2Hw * kC2In, kC2In);
  const auto kernel = dz ? (dout ? conv2_dgrad_tf32_kernel<true, true>
                                 : conv2_dgrad_tf32_kernel<true, false>)
                         : (dout ? conv2_dgrad_tf32_kernel<false, true>
                                 : conv2_dgrad_tf32_kernel<false, false>);
  // Items of 256 stacked rows: rows 15 .. 225 B - 2 hold a client's pixels.
  const long long rows = static_cast<long long>(kDtSample) * g.batch - 1 - kDtL;
  const int items = static_cast<int>((rows + kDtRows - 1) / kDtRows);
  const long long total = static_cast<long long>(a->clients) * items;
  const long long grid = total < sms ? total : sms;
  err = mft_smem_optin(kernel, kDtSmem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(grid), kDtThreads, kDtSmem,
           static_cast<cudaStream_t>(stream)>>>(*dp, *h, *arg, *w, *dx,
                                                g.batch, items, total);
  return cudaGetLastError();
}

// The forward's tensor-core kernels, for the compute dtype bf16: the same
// arguments as mft_conv_fwd. mft_conv_fwd_tc_kind says which takes a call
// (1 conv2, 2 the stem, 0 none); what none takes is refused.
int mft_conv_fwd_tc_kind(const MftConvArgs* a, const MftView* x) {
  return fwd_tc_kind(a->g, *x);
}

int mft_conv_fwd_tc(const MftView* x, const MftView* w, const MftView* b,
                    const MftView* out, const MftView* arg,
                    const MftConvArgs* a, int device, void* stream) {
  const ConvGeom& g = a->g;
  const TcKind kind = fwd_tc_kind(g, *x);
  if (a->clients <= 0 || g.batch <= 0 || kind == kTcNone) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == kTcStem) {
    const long long pw = g.ow / 2;
    const bool dense = dense_slab(*out, kBF16, 1, pw * kStemOut, kStemOut) &&
                       dense_slab(*arg, kU8, 1, pw * kStemOut, kStemOut);
    return dense ? launch_stem_fwd<true>(x, w, b, out, arg, a, st)
                 : launch_stem_fwd<false>(x, w, b, out, arg, a, st);
  }
  const bool dx = dense_slab(*x, kBF16, 1, kC2Hw * kC2In, kC2In);
  const bool dout = dense_slab(*out, kBF16, kC2Pooled, kC2Pw, 1) &&
                    dense_slab(*arg, kU8, kC2Pooled, kC2Pw, 1);
  const size_t smem = sizeof(bf16) * 9 * kC2Out * kXRow +
                      sizeof(float) * kC2Out +
                      sizeof(float) * kC2Out * kZfRow;  // zf over xs
  static_assert(sizeof(float) * kC2Out * kZfRow >=
                    sizeof(bf16) * kHaloPix * kXRow,
                "the sums' tile covers the input tile");
  const auto kernel = dx ? (dout ? conv2_fwd_tc_kernel<true, true>
                                 : conv2_fwd_tc_kernel<true, false>)
                         : (dout ? conv2_fwd_tc_kernel<false, true>
                                 : conv2_fwd_tc_kernel<false, false>);
  const dim3 grid((g.batch + kFwSamples - 1) / kFwSamples, a->clients);
  return launch_tc(kernel, grid, smem, st, g.batch, x, w, b, out, arg);
}

// The pooled forward for the compute dtype f32: the same arguments as
// mft_conv_fwd_tc. conv2's geometry runs conv2_fwd_tf32 (3xTF32), a stem's
// stem_fwd_f32 (CUDA cores); what mft_conv2_fwd_tf32_takes or
// mft_stem_fwd_f32_takes refuses is refused, never handed to another
// kernel.
int mft_conv2_fwd_tf32_takes(const MftConvArgs* a) {
  return conv2_tf32_takes(a->g);
}

int mft_conv2_fwd_tf32(const MftView* x, const MftView* w, const MftView* b,
                       const MftView* out, const MftView* arg,
                       const MftConvArgs* a, int device, void* stream) {
  const ConvGeom& g = a->g;
  const long long samples = static_cast<long long>(a->clients) * g.batch;
  if (a->clients <= 0 || g.batch <= 0 || samples > INT_MAX ||
      !conv2_tf32_takes(g)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // The main path's layouts: the input NHWC and the maps NCHW, f32.
  const bool dx = dense_slab(*x, kF32, 1, kC2Hw * kC2In, kC2In);
  const bool dout = dense_slab(*out, kF32, kC2Pooled, kC2Pw, 1) &&
                    dense_slab(*arg, kU8, kC2Pooled, kC2Pw, 1);
  const auto kernel = dx ? (dout ? conv2_fwd_tf32_kernel<true, true>
                                 : conv2_fwd_tf32_kernel<true, false>)
                         : (dout ? conv2_fwd_tf32_kernel<false, true>
                                 : conv2_fwd_tf32_kernel<false, false>);
  err = mft_smem_optin(kernel, kFtSmem);
  if (err != cudaSuccess) return err;
  const int blocks = static_cast<int>(samples < sms ? samples : sms);
  kernel<<<blocks, kTcThreads, kFtSmem, static_cast<cudaStream_t>(stream)>>>(
      *x, *w, *b, *out, *arg, g.batch, static_cast<int>(samples));
  return cudaGetLastError();
}

int mft_stem_fwd_f32_takes(const MftConvArgs* a, const MftView* x) {
  return stem_f32_takes(a->g, *x);
}

int mft_stem_fwd_f32(const MftView* x, const MftView* w, const MftView* b,
                     const MftView* out, const MftView* arg,
                     const MftConvArgs* a, int device, void* stream) {
  const ConvGeom& g = a->g;
  const long long windows =
      static_cast<long long>(g.batch) * (g.oh / 2) * (g.ow / 2);
  if (a->clients <= 0 || g.batch <= 0 || windows > INT_MAX ||
      !stem_f32_takes(g, *x)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // The main path's layout: the maps NHWC.
  const long long pw = g.ow / 2;
  const bool dense = dense_slab(*out, kF32, 1, pw * kStemOut, kStemOut) &&
                     dense_slab(*arg, kU8, 1, pw * kStemOut, kStemOut);
  const int per_block = kSf32Chunks * kSfWins;
  const dim3 grid(static_cast<unsigned>((windows + per_block - 1) / per_block),
                  a->clients);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dense) {
    stem_fwd_f32_kernel<true><<<grid, kTcThreads, 0, st>>>(*x, *w, *b, *out,
                                                           *arg, g);
  } else {
    stem_fwd_f32_kernel<false><<<grid, kTcThreads, 0, st>>>(*x, *w, *b, *out,
                                                            *arg, g);
  }
  return cudaGetLastError();
}

const char* mft_client_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
