// Per-client direct convolutions of SimpleCNN's local training, for NVIDIA
// Hopper (sm_90a): every client has its own weights, and one launch serves
// all clients.
//
// Replaces, in multimodal_fl_security_tpu:
//  - ops/client_conv.py::client_stem_conv (K3, the Pallas kernel _stem_kernel):
//    the raw 4x4 stride-2 stem convolution (mode raw);
//  - the convolution parts of ops/fused_kernel.py::fused_local_train (K4):
//    the stem and conv2 of forward_impl with their epilogues, the stem's and
//    conv2's weight gradients (with the stem's fold of its four embedded
//    copies, fold_stem) and conv2's input gradient.
//
// Kernels:
//  - conv_fwd: K x K / stride / pad convolution, then either nothing (raw) or
//    the 2x2 max-pool epilogue: the max over the four window positions, in
//    (di, dj) order, the first maximum winning, then bias and relu. That is
//    the stem in ConvPoolFused form (a 3x3 SAME conv evaluated at the four
//    pool offsets is the 4x4 stride-2 conv on the embedded kernel w4, and the
//    max over its four channel groups) and conv2 + bias + relu + pool. It
//    writes the pooled map and a 2-bit argmax (as one byte) per output.
//  - conv_wgrad: dW and db of one client from the layer's input and the
//    pooled output's gradient, routed through the argmax and the relu inside
//    the kernel. The gradient reaches the 3x3 kernel directly, which is the
//    fold P^T of the four embedded copies. Sums run over the batch in a fixed
//    order, with no atomics: two calls are bitwise equal.
//  - conv_dgrad: the input gradient (conv2 only; the stem needs none).
//
// What bounds them: at the north-star shapes (100 clients x 32 samples per
// step) conv2's forward is 2*9*32*64*196 = 7.2 MFLOP per sample (the pooled
// form evaluates each of the 14x14 positions once), 23 GFLOP per step; the
// bytes it must move are ~80 MB. The kernels run f32 FMA on the CUDA cores
// with both operands read from shared memory: two shared-memory words per
// FMA, so shared-memory bandwidth (~7e12 words/s over the card) bounds them
// at ~3 ms per conv2 pass, far above the HBM and tensor-core floors.
// Design: one block per (client, sample) for the forward and the input
// gradient, with the client's weights (conv2: 72 KB in f32) and the sample
// (conv2: 25 KB) staged once in shared memory; one block per (client,
// output channel) for the weight gradient, whose threads split the weights
// and the batch and add their partial sums in a fixed order. Tensor cores
// are left to a later version.

#include <cmath>

#include "client_common.cuh"

// The geometry passed from Python (ctypes mirrors this layout).
struct ConvGeom {
  int batch, cin, h, w;      // input: samples per client, channels, rows, cols
  int cout, k, stride, pad;  // the convolution
  int oh, ow;                // its output size (before any pooling)
  int pool;                  // 1: 2x2 max + bias + relu epilogue; 0: raw
  int cdt;                   // compute dtype: operands rounded to it
};

struct MftConvArgs {
  int clients;
  ConvGeom g;
};

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(MftView x, MftView w, MftView b, MftView out, MftView arg,
                ConvGeom g) {
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
    ws[i] = mft_round(mft_ld(w, mft_off(w, c, co, ci, kh, kw)), g.cdt);
  }
  const int nx = g.h * g.w * g.cin;
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    const int ci = i % g.cin;
    const int r = i / g.cin;
    xs[i] = mft_round(mft_ld(x, mft_off(x, c, n, ci, r / g.w, r % g.w)),
                      g.cdt);
  }
  __syncthreads();

  const int ph = g.pool ? g.oh / 2 : g.oh;
  const int pw = g.pool ? g.ow / 2 : g.ow;
  const int npos = g.pool ? 4 : 1;
  const int nout = ph * pw * g.cout;
  for (int o = threadIdx.x; o < nout; o += blockDim.x) {
    const int co = o % g.cout;
    const int r = o / g.cout;
    const int oj = r % pw;
    const int oi = r / pw;
    float best = 0.f;
    int besti = 0;
    for (int q = 0; q < npos; ++q) {
      const int oy = g.pool ? 2 * oi + (q >> 1) : oi;
      const int ox = g.pool ? 2 * oj + (q & 1) : oj;
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
      if (q == 0 || acc > best) {  // ties: the first in (di, dj) order
        best = acc;
        besti = q;
      }
    }
    float v = best;
    if (g.pool) {
      v = fmaxf(v + mft_round(mft_ld(b, mft_off(b, c, 0, co, 0, 0)), g.cdt),
                0.f);
      mft_st(arg, mft_off(arg, c, n, co, oi, oj), static_cast<float>(besti));
    }
    mft_st(out, mft_off(out, c, n, co, oi, oj), v);
  }
}

// One block per (output channel, client). Thread t < nwb * splits sums
// weight t % nwb (the bias when it is nw) over samples [n0, n1) of split
// t / nwb; the splits are then added in order.
__global__ void conv_wgrad_kernel(MftView x, MftView dp, MftView h,
                                  MftView arg, MftView gw, MftView gb,
                                  ConvGeom g, int splits) {
  extern __shared__ float smem[];
  const int co = blockIdx.x;
  const int c = blockIdx.y;
  const int pw = g.ow / 2;
  const int per = (g.oh / 2) * pw;
  const int m = g.batch * per;
  const int nw = g.k * g.k * g.cin;
  const int nwb = nw + 1;
  float* gs = smem;        // pooled gradient through the relu, [n][oi][oj]
  float* red = gs + m;     // [splits][nwb]
  uint8_t* as = reinterpret_cast<uint8_t*>(red + splits * nwb);  // argmax
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int n = i / per;
    const int r = i % per;
    const int oi = r / pw;
    const int oj = r % pw;
    const float hv = mft_ld(h, mft_off(h, c, n, co, oi, oj));
    gs[i] = hv > 0.f ? mft_ld(dp, mft_off(dp, c, n, co, oi, oj)) : 0.f;
    as[i] = static_cast<uint8_t>(mft_ld(arg, mft_off(arg, c, n, co, oi, oj)));
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < nwb * splits) {
    const int wi = t % nwb;
    const int s = t / nwb;
    const int n0 = s * g.batch / splits;
    const int n1 = (s + 1) * g.batch / splits;
    float acc = 0.f;
    if (wi == nw) {
      for (int i = n0 * per; i < n1 * per; ++i) acc += gs[i];
    } else {
      const int ci = wi % g.cin;  // weights in (kh, kw, ci) order, ci fastest
      const int kw = (wi / g.cin) % g.k;
      const int kh = wi / g.cin / g.k;
      for (int n = n0; n < n1; ++n) {
        for (int r = 0; r < per; ++r) {
          const float gv = gs[n * per + r];
          if (gv == 0.f) continue;  // the same branch across a split
          const int q = as[n * per + r];
          const int oy = 2 * (r / pw) + (q >> 1);
          const int ox = 2 * (r % pw) + (q & 1);
          const int iy = oy * g.stride - g.pad + kh;
          const int ix = ox * g.stride - g.pad + kw;
          if (iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) continue;
          acc += gv * mft_round(mft_ld(x, mft_off(x, c, n, ci, iy, ix)),
                                g.cdt);
        }
      }
    }
    red[s * nwb + wi] = acc;
  }
  __syncthreads();
  if (t < nwb) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += red[s * nwb + t];
    sum = mft_round(sum, g.cdt);
    if (t == nw) {
      mft_st(gb, mft_off(gb, c, 0, co, 0, 0), sum);
    } else {
      const int ci = t % g.cin;
      const int kw = (t / g.cin) % g.k;
      const int kh = t / g.cin / g.k;
      mft_st(gw, mft_off(gw, c, co, ci, kh, kw), sum);
    }
  }
}

// One block per (sample, client); stride 1 only.
__global__ void __launch_bounds__(kThreads)
conv_dgrad_kernel(MftView dp, MftView h, MftView arg, MftView w, MftView dx,
                  ConvGeom g) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int c = blockIdx.y;
  const int nw = g.k * g.k * g.cout * g.cin;
  float* ws = smem;       // [kh][kw][co][ci]
  float* dz = smem + nw;  // [oy][ox][co], the conv output's gradient
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int ci = i % g.cin;
    int r = i / g.cin;
    const int co = r % g.cout;
    r /= g.cout;
    const int kw = r % g.k;
    const int kh = r / g.k;
    ws[i] = mft_round(mft_ld(w, mft_off(w, c, co, ci, kh, kw)), g.cdt);
  }
  const int nz = g.oh * g.ow * g.cout;
  for (int i = threadIdx.x; i < nz; i += blockDim.x) dz[i] = 0.f;
  __syncthreads();
  const int pw = g.ow / 2;
  const int np = (g.oh / 2) * pw * g.cout;
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    const int co = i % g.cout;
    const int r = i / g.cout;
    const int oi = r / pw;
    const int oj = r % pw;
    if (!(mft_ld(h, mft_off(h, c, n, co, oi, oj)) > 0.f)) continue;
    const int q = static_cast<int>(mft_ld(arg, mft_off(arg, c, n, co, oi, oj)));
    const int oy = 2 * oi + (q >> 1);
    const int ox = 2 * oj + (q & 1);
    dz[(oy * g.ow + ox) * g.cout + co] =
        mft_ld(dp, mft_off(dp, c, n, co, oi, oj));
  }
  __syncthreads();
  const int nx = g.h * g.w * g.cin;
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    const int ci = i % g.cin;
    const int r = i / g.cin;
    const int y = r / g.w;
    const int xx = r % g.w;
    float acc = 0.f;
    for (int kh = 0; kh < g.k; ++kh) {
      const int oy = y + g.pad - kh;
      if (oy < 0 || oy >= g.oh) continue;
      for (int kw = 0; kw < g.k; ++kw) {
        const int ox = xx + g.pad - kw;
        if (ox < 0 || ox >= g.ow) continue;
        const float* zp = dz + (oy * g.ow + ox) * g.cout;
        const float* wp = ws + (kh * g.k + kw) * g.cout * g.cin + ci;
        for (int co = 0; co < g.cout; ++co) acc += zp[co] * wp[co * g.cin];
      }
    }
    mft_st(dx, mft_off(dx, c, n, ci, y, xx), acc);
  }
}

}  // namespace

extern "C" {

// Forward: x (client, sample, channel, row, col), w (client, co, ci, kh, kw),
// b (client, -, co) read only when pooling; out and arg (client, sample, co,
// row, col) of the pooled (or raw) output.
int mft_conv_fwd(const MftView* x, const MftView* w, const MftView* b,
                 const MftView* out, const MftView* arg,
                 const MftConvArgs* a, int device, void* stream) {
  const ConvGeom& g = a->g;
  if (a->clients <= 0 || g.batch <= 0 || g.cin <= 0 || g.cout <= 0 ||
      (g.pool && (g.oh % 2 || g.ow % 2))) {
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
                    static_cast<cudaStream_t>(stream)>>>(*x, *w, *b, *out,
                                                         *arg, g);
  return cudaGetLastError();
}

// Weight gradient of a pooled conv layer: x is the layer's input, dp the
// pooled output's gradient, h the pooled output (relu mask), arg its argmax;
// writes gw (client, co, ci, kh, kw) and gb (client, -, co).
int mft_conv_wgrad(const MftView* x, const MftView* dp, const MftView* h,
                   const MftView* arg, const MftView* gw, const MftView* gb,
                   const MftConvArgs* a, int device, void* stream) {
  const ConvGeom& g = a->g;
  if (a->clients <= 0 || g.batch <= 0 || !g.pool || g.oh % 2 || g.ow % 2) {
    return cudaErrorInvalidValue;
  }
  const int nwb = g.k * g.k * g.cin + 1;
  if (nwb > 1024) return cudaErrorInvalidValue;
  int splits = 512 / nwb;
  if (splits < 1) splits = 1;
  if (splits > g.batch) splits = g.batch;
  const int threads = ((nwb * splits + 31) / 32) * 32;
  const size_t m = static_cast<size_t>(g.batch) * (g.oh / 2) * (g.ow / 2);
  const size_t smem = sizeof(float) * (m + static_cast<size_t>(splits) * nwb) + m;
  if (smem > kMftMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = mft_smem_optin(conv_wgrad_kernel, smem);
  if (err != cudaSuccess) return err;
  conv_wgrad_kernel<<<dim3(g.cout, a->clients), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      *x, *dp, *h, *arg, *gw, *gb, g, splits);
  return cudaGetLastError();
}

// Input gradient of a pooled stride-1 conv layer: dx (client, sample, ci,
// row, col) from dp, h and arg as above and the weights w.
int mft_conv_dgrad(const MftView* dp, const MftView* h, const MftView* arg,
                   const MftView* w, const MftView* dx, const MftConvArgs* a,
                   int device, void* stream) {
  const ConvGeom& g = a->g;
  if (a->clients <= 0 || g.batch <= 0 || !g.pool || g.stride != 1 ||
      g.oh % 2 || g.ow % 2) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(g.k) * g.k * g.cin * g.cout +
       static_cast<size_t>(g.oh) * g.ow * g.cout);
  if (smem > kMftMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = mft_smem_optin(conv_dgrad_kernel, smem);
  if (err != cudaSuccess) return err;
  conv_dgrad_kernel<<<dim3(g.batch, a->clients), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(*dp, *h, *arg, *w,
                                                           *dx, g);
  return cudaGetLastError();
}

const char* mft_client_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
