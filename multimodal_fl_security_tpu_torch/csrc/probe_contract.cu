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
// Every operand is a strided view: A by (batch, m, k), B by (batch, k, n),
// and the k axis of A and B may be two axes merged (k = ko * kin + ki, each
// with its own stride), so the transposed-rhs forms, einsum_brl_rlf's
// (r, l) pair and outer_wgrad's contraction over the batch axis are read in
// place, with no copy. A batch stride of 0 reuses an operand. Operands are
// f32 or bf16 (their products are exact in f32, so Mosaic's HIGHEST and
// DEFAULT precisions are one product here); C is a contiguous f32
// [batch, m, n].
//
// What bounds it: the largest probe, dgrad_rhs_T_big ([1792, 256] x
// [256, 1152]), is 1.06 GFLOP, 0.016 ms at the f32 CUDA-core rate, against
// 11 MB of operands (0.003 ms): operations. The others are a few MFLOP and
// bound by their launch. The first version (a 32 x 32 tile, 4 outputs a
// thread) read both operands from shared memory for every FMA (5 loads per
// 4 FMAs), and ran one block per output tile, so einsum_brl_rlf (m 32, n
// 128, k 14,336) ran on 4 blocks of 132 SMs.
//
// What the design does about it:
//  - Register tiles. A block computes a 64 x 64 tile of C, each thread a
//    4 x 4 block of it, from 16-deep k-slices of A and B staged k-major in
//    shared memory ([k][m], [k][n]): per k, one float4 of A and one of B
//    feed 16 FMAs. A warp's threads span 4 rows and 8 columns of float4s,
//    so its reads touch 64 + 128 distinct bytes and never conflict.
//  - Two slices in flight: slice s + 1 is copied while slice s is summed.
//    An operand whose x axis (m of A, n of B) has stride 1, 16-byte aligned
//    in f32, goes by cp.async 16 bytes at a time straight into place (the
//    ragged edge zero-filled by the copy); a bf16 one by 8-byte loads,
//    converted while stored. One whose k axis has stride 1 (dgrad_rhs_T's
//    both operands, einsum_brl_rlf's A) is read 4 k at a time and
//    transposed while stored. Any other strides: one element at a time.
//  - A fixed-order split over k. When batch x tiles is under the card's
//    132 SMs, the caller (ops/probe_contract.py::plan_splits, from the shape
//    alone) cuts k into `splits` chunks of `chunk` (a multiple of 16): each
//    block sums one chunk into an f32 partial in a scratch buffer, and a
//    second kernel adds the partials in chunk order. No atomics: every sum
//    runs in one order, so two calls are bitwise equal.

#include "client_common.cuh"

// The operands cross the C interface, so they live outside the anonymous
// namespace (a type with internal linkage would hide mft_contract).
// A strided operand: `x` is m for A, n for B; ko and ki split k.
struct Operand {
  const void* ptr;
  long long sb, sx, sko, ski;
  int dtype;
  int pad_;
};

namespace {

constexpr int kTile = 64;   // rows and columns of C a block computes
constexpr int kDepth = 16;  // k per staged slice
constexpr int kThreads = 256;
constexpr int kSlice = kDepth * kTile;  // floats of one operand's slice

// How an operand's slice is read: 4 consecutive x (x stride 1), 4
// consecutive k (ki stride 1), or one element at a time.
enum Mode : int { kVecX = 0, kVecK = 1, kScalar = 2 };

// One operand's view from one block: its batch slab, the tile's first x and
// the x extent, k split as ko * kin + ki.
struct View {
  const char* base;  // the batch slab
  long long sx, sko, ski;
  int x0, xn, kin, bf16;

  __device__ __forceinline__ long long off(int x, int k) const {
    return x * sx + static_cast<long long>(k / kin) * sko +
           static_cast<long long>(k % kin) * ski;
  }
  __device__ __forceinline__ float ld(long long i) const {
    return bf16 ? __bfloat162float(
                      reinterpret_cast<const __nv_bfloat16*>(base)[i])
                : reinterpret_cast<const float*>(base)[i];
  }
};

// Four bf16 (8 bytes) as floats.
__device__ __forceinline__ float4 bf16x4(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// A thread's share of one slice of an operand: 4 elements, loaded by
// issue() into registers (or copied by cp.async) and stored by land() into
// the [k][x] slice in shared memory.
template <int kMode>
struct Stager {
  float r[4];

  __device__ __forceinline__ void set(float4 v) {
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  }

  // Slice [k0, k0 + 16) of the chunk ending at kend, into dst.
  __device__ __forceinline__ void issue(const View& o, float* dst, int k0,
                                        int kend) {
    const int t = threadIdx.x;
    if constexpr (kMode == kVecX) {
      const int kk = t / (kTile / 4), xq = 4 * (t % (kTile / 4));
      const int x = o.x0 + xq, k = k0 + kk;
      const int nx = k < kend ? min(4, max(o.xn - x, 0)) : 0;  // in range
      const long long i = nx ? o.off(x, k) : 0;
      if (!o.bf16) {
        mft_cp_async16(mft_smem_addr(dst + kk * kTile + xq),
                       reinterpret_cast<const float*>(o.base) + i, 4 * nx);
      } else if (nx == 4) {
        set(bf16x4(*reinterpret_cast<const uint2*>(
            reinterpret_cast<const __nv_bfloat16*>(o.base) + i)));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] = j < nx ? o.ld(i + j) : 0.f;
      }
    } else if constexpr (kMode == kVecK) {
      const int xl = t % kTile, kq = 4 * (t / kTile);
      const int x = o.x0 + xl, k = k0 + kq;
      const int nk = x < o.xn ? min(4, max(kend - k, 0)) : 0;
      if (nk == 4) {  // k .. k + 3 share one ko: kin % 4 == 0, k % 4 == 0
        const long long i = o.off(x, k);
        set(o.bf16 ? bf16x4(*reinterpret_cast<const uint2*>(
                         reinterpret_cast<const __nv_bfloat16*>(o.base) + i))
                   : *reinterpret_cast<const float4*>(
                         reinterpret_cast<const float*>(o.base) + i));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] = j < nk ? o.ld(o.off(x, k + j)) : 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = t + j * kThreads;
        const int x = o.x0 + idx % kTile, k = k0 + idx / kTile;
        r[j] = x < o.xn && k < kend ? o.ld(o.off(x, k)) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void land(const View& o, float* dst) const {
    const int t = threadIdx.x;
    if constexpr (kMode == kVecX) {
      if (o.bf16) {
        *reinterpret_cast<float4*>(dst + (t / (kTile / 4)) * kTile +
                                   4 * (t % (kTile / 4))) =
            make_float4(r[0], r[1], r[2], r[3]);
      }
    } else if constexpr (kMode == kVecK) {
      float* d = dst + 4 * (t / kTile) * kTile + t % kTile;
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j * kTile] = r[j];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[t + j * kThreads] = r[j];
    }
  }
};

__device__ __forceinline__ View view_of(const Operand& o, int bat, int x0,
                                        int xn, int kin) {
  const int elem = o.dtype == kBF16 ? 2 : 4;
  return View{static_cast<const char*>(o.ptr) + bat * o.sb * elem,
              o.sx, o.sko, o.ski, x0, xn, kin, o.dtype == kBF16};
}

// grid (n tiles, m tiles, batch * splits); block z = bat * splits + split
// sums k in [split * chunk, min(k, (split + 1) * chunk)) into
// out[split][bat] (out is [splits, batch, m, n], or C itself at 1 split).
template <int kModeA, int kModeB>
__global__ void __launch_bounds__(kThreads)
contract_kernel(Operand a, Operand b, float* __restrict__ out, int batch,
                int m, int n, int k, int kin, int chunk, int splits) {
  __shared__ __align__(16) float as[2][kSlice];  // [k][m]
  __shared__ __align__(16) float bs[2][kSlice];  // [k][n]
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  const int bat = blockIdx.z / splits, split = blockIdx.z % splits;
  const int kbeg = split * chunk, kend = min(k, kbeg + chunk);
  const int slices = (kend - kbeg + kDepth - 1) / kDepth;
  const View va = view_of(a, bat, m0, m, kin);
  const View vb = view_of(b, bat, n0, n, kin);
  Stager<kModeA> sa;
  Stager<kModeB> sb;

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int tx = (warp & 1) * 8 + (lane & 7);    // columns 4 tx .. + 3
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // rows 4 ty .. + 3
  float acc[4][4] = {};

  sa.issue(va, as[0], kbeg, kend);
  sb.issue(vb, bs[0], kbeg, kend);
  mft_cp_async_commit();
  sa.land(va, as[0]);
  sb.land(vb, bs[0]);
  mft_cp_async_wait<0>();
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    const bool next = s + 1 < slices;
    if (next) {  // the other buffer was last read before the barrier
      sa.issue(va, as[cur ^ 1], kbeg + (s + 1) * kDepth, kend);
      sb.issue(vb, bs[cur ^ 1], kbeg + (s + 1) * kDepth, kend);
    }
    mft_cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 av =
          *reinterpret_cast<const float4*>(&as[cur][kk * kTile + 4 * ty]);
      const float4 bv =
          *reinterpret_cast<const float4*>(&bs[cur][kk * kTile + 4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    if (next) {
      sa.land(va, as[cur ^ 1]);
      sb.land(vb, bs[cur ^ 1]);
    }
    mft_cp_async_wait<0>();
    __syncthreads();
  }

  float* c = out + (static_cast<long long>(split) * batch + bat) * m * n;
  const int col = n0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= m) break;
    float* dst = c + static_cast<long long>(row) * n + col;
    if (n % 4 == 0 && col + 3 < n) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col + j < n) dst[j] = acc[i][j];
      }
    }
  }
}

// c[i] = the sum of part[s][i] over the splits, in split order.
__global__ void contract_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ c,
                                       long long count, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int z = 0; z < splits; ++z) s += part[z * count + i];
    c[i] = s;
  }
}

// The fastest way in for operand o (see Mode): vector reads need the unit
// stride, every other stride a multiple of 4 elements and the base aligned
// to the vector (16 bytes in f32, 8 in bf16).
Mode mode_of(const Operand& o, int kin) {
  const uintptr_t align = o.dtype == kBF16 ? 8 : 16;
  const bool aligned = reinterpret_cast<uintptr_t>(o.ptr) % align == 0 &&
                       o.sb % 4 == 0 && o.sko % 4 == 0;
  if (aligned && o.sx == 1 && o.ski % 4 == 0) return kVecX;
  if (aligned && o.ski == 1 && o.sx % 4 == 0 && kin % 4 == 0) return kVecK;
  return kScalar;
}

using ContractFn = void (*)(Operand, Operand, float*, int, int, int, int, int,
                            int, int);

template <int kModeA>
ContractFn pick(Mode b) {
  return b == kVecX   ? contract_kernel<kModeA, kVecX>
         : b == kVecK ? contract_kernel<kModeA, kVecK>
                      : contract_kernel<kModeA, kScalar>;
}

}  // namespace

extern "C" {

// c [batch, m, n] (contiguous f32) = a [batch, m, k] x b [batch, k, n]. With
// splits > 1, k is cut into chunks of `chunk` (a multiple of 16; the last
// may be short, none empty) and scratch holds splits * batch * m * n floats.
int mft_contract(const Operand* a, const Operand* b, float* c, float* scratch,
                 int batch, int m, int n, int k, int kin, int chunk,
                 int splits, int device, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k <= 0 || kin <= 0 || k % kin != 0 ||
      splits <= 0 || chunk <= 0 || (splits > 1 && chunk % kDepth != 0) ||
      static_cast<long long>(splits - 1) * chunk >= k ||
      static_cast<long long>(splits) * chunk < k ||
      static_cast<long long>(batch) * splits > 65535 ||
      (m + kTile - 1) / kTile > 65535 || (splits > 1 && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mode ma = mode_of(*a, kin), mb = mode_of(*b, kin);
  const ContractFn kernel = ma == kVecX   ? pick<kVecX>(mb)
                            : ma == kVecK ? pick<kVecK>(mb)
                                          : pick<kScalar>(mb);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile,
                  batch * splits);
  kernel<<<grid, kThreads, 0, s>>>(*a, *b, splits > 1 ? scratch : c, batch,
                                   m, n, k, kin, chunk, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long count = static_cast<long long>(batch) * m * n;
  const long long blocks = (count + 255) / 256;
  contract_reduce_kernel<<<static_cast<unsigned>(blocks < 65535 ? blocks
                                                                : 65535),
                           256, 0, s>>>(scratch, c, count, splits);
  return cudaGetLastError();
}

const char* mft_probe_contract_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
