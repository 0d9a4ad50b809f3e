// Shared pieces of the per-client local-training kernels (client_conv.cu,
// client_dense.cu, client_sgd.cu): a strided tensor view that the Python
// wrappers fill from torch's own strides, typed loads and stores, and the
// rounding to the compute type.
//
// Every kernel reads its operands as float, rounded to the compute type
// (bf16 or f32) where the plain PyTorch version casts them, accumulates in
// f32, and stores through the view's own dtype, which rounds once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

enum MftDtype : int { kF32 = 0, kBF16 = 1, kU8 = 2, kI64 = 3 };

// A view of up to five axes, in the order (client, sample, channel, row,
// column); strides in elements, 0 for an axis the tensor does not have.
struct MftView {
  void* ptr;
  long long st[5];
  int dtype;
  int pad_;
};

__device__ __forceinline__ long long mft_off(const MftView& v, long long a,
                                             long long b, long long c,
                                             long long d, long long e) {
  return a * v.st[0] + b * v.st[1] + c * v.st[2] + d * v.st[3] + e * v.st[4];
}

__device__ __forceinline__ float mft_ld(const MftView& v, long long i) {
  switch (v.dtype) {
    case kF32: return static_cast<const float*>(v.ptr)[i];
    case kBF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(v.ptr)[i]);
    case kU8: return static_cast<float>(static_cast<const uint8_t*>(v.ptr)[i]);
    default: return static_cast<float>(static_cast<const int64_t*>(v.ptr)[i]);
  }
}

__device__ __forceinline__ void mft_st(const MftView& v, long long i,
                                       float x) {
  switch (v.dtype) {
    case kF32: static_cast<float*>(v.ptr)[i] = x; break;
    case kBF16:
      static_cast<__nv_bfloat16*>(v.ptr)[i] = __float2bfloat16(x);
      break;
    default: static_cast<uint8_t*>(v.ptr)[i] = static_cast<uint8_t>(x);
  }
}

// x rounded to the compute type `dtype` (round to nearest even), as float.
__device__ __forceinline__ float mft_round(float x, int dtype) {
  return dtype == kBF16 ? __bfloat162float(__float2bfloat16(x)) : x;
}

// Opt in to `bytes` of dynamic shared memory when it is over the 48 KB that
// needs no opt-in; a launch that asks for more without it is refused.
template <typename Kernel>
inline cudaError_t mft_smem_optin(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

constexpr size_t kMftMaxSmem = 227 * 1024;

// ------------------------------------------------ tensor-core building blocks
// (the bf16 kernels of client_conv.cu and client_dense.cu)

__device__ __forceinline__ uint32_t mft_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i .. 8i + 7 give the
// row addresses of matrix i; `_t` transposes each matrix.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major): bf16 in, f32 sums.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16, packed as one 32-bit word (lo in the low half).
__device__ __forceinline__ uint32_t mft_pack2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
             << 16;
}

// Element e of 8 packed bf16 (e known at compile time once the loops are
// unrolled).
__device__ __forceinline__ float mft_bf16_at(const uint4& v, int e) {
  const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return __bfloat162float(__ushort_as_bfloat16(
      static_cast<unsigned short>(e & 1 ? w >> 16 : w & 0xffffu)));
}

// ------------------------------------------------ 3xTF32
// (the f32 tensor-core kernels of gram.cu, client_stem_raw.cu,
// client_conv.cu and client_dense.cu)

// x rounded to TF32 (10 mantissa bits), to nearest even, as an f32 whose low
// 13 bits are zero. An f32 operand a is split into hi = tf32(a) and
// lo = tf32(a - hi); a b is then lo hi + hi lo + hi hi to ~2^-22 |a b|.
__device__ __forceinline__ float mft_tf32_rne(float x) {
  uint32_t b = __float_as_uint(x);
  b += 0xfffu + ((b >> 13) & 1u);
  return __uint_as_float(b & 0xffffe000u);
}

// d += a (16 x 8, row-major) * b (8 x 8, column-major): tf32 in, f32 sums.
__device__ __forceinline__ void mma1688_tf32(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------ copies and wgmma
// (client_stem_raw.cu, client_conv.cu and probe_contract.cu)

// 16 bytes from global src (16-byte aligned) to shared dst, of which the
// first src_bytes are read and the rest zeroed; 0 reads nothing.
__device__ __forceinline__ void mft_cp_async16(uint32_t dst, const void* src,
                                               int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void mft_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void mft_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The generic proxy's shared-memory writes (stores, cp.async), made
// visible to the async proxy (wgmma's operand reads).
__device__ __forceinline__ void mft_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mft_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mft_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void mft_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// A wgmma shared-memory descriptor without swizzle (core matrices of 8 rows
// x 16 bytes): the start address, and the byte distances to the next core
// matrix along K (lbo) and along M or N (sbo).
__device__ __forceinline__ uint64_t mft_wgmma_desc(uint32_t addr, int lbo,
                                                   int sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}

// TF32 wgmma, A from shared memory (a descriptor) or from registers (_RS).
// kAccumulate false writes d (scale-d 0) and reads nothing of it.
#define MFT_WGMMA_TF32(N, REGS, P, D, C)                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" \
               REGS "}, %" #D ", %" #C ", p, 1, 1;\n}\n"
#define MFT_WGMMA_TF32_RS(N, REGS, AREGS, P, C)                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" \
               REGS "}, {" AREGS "}, %" #C ", p, 1, 1;\n}\n"
#define MFT_R16                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define MFT_R32                                                              \
  MFT_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
          "%28, %29, %30, %31"
#define MFT_O16(C, d)                                                        \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]),   \
      C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]),   \
      C(d[15])
#define MFT_RW(x) "+f"(x)
#define MFT_W(x) "=f"(x)

// d (+)= A (64 x 8) B^T (B: 64 x 8), both K-major in shared memory: tf32 in,
// f32 sums.
template <bool kAccumulate>
__device__ __forceinline__ void mft_wgmma_tf32_n64(float (&d)[32],
                                                   uint64_t da, uint64_t db) {
  if constexpr (kAccumulate) {
    MFT_WGMMA_TF32(64, MFT_R32, 34, 32, 33)
                 : MFT_O16(MFT_RW, d), MFT_O16(MFT_RW, (d + 16))
                 : "l"(da), "l"(db), "r"(1));
  } else {
    MFT_WGMMA_TF32(64, MFT_R32, 34, 32, 33)
                 : MFT_O16(MFT_W, d), MFT_O16(MFT_W, (d + 16))
                 : "l"(da), "l"(db), "r"(0));
  }
}

// d (+)= A (64 x 8, from registers) B^T (B: 32 x 8, K-major in shared
// memory): tf32 in, f32 sums. a: this thread's A fragment, as mma.sync's
// m16n8k8 A fragment of the warp's 16 rows (warp w of the warpgroup: rows
// 16 w ..); it is read asynchronously, so it stays unchanged until the
// wgmma is waited for.
template <bool kAccumulate>
__device__ __forceinline__ void mft_wgmma_tf32_n32_rs(float (&d)[16],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  if constexpr (kAccumulate) {
    MFT_WGMMA_TF32_RS(32, MFT_R16, "%16, %17, %18, %19", 21, 20)
                 : MFT_O16(MFT_RW, d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  } else {
    MFT_WGMMA_TF32_RS(32, MFT_R16, "%16, %17, %18, %19", 21, 20)
                 : MFT_O16(MFT_W, d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(0));
  }
}

#undef MFT_W
#undef MFT_RW
#undef MFT_O16
#undef MFT_R32
#undef MFT_R16
#undef MFT_WGMMA_TF32_RS
#undef MFT_WGMMA_TF32

// Keeps the compiler from moving reads of d above the wgmma wait that
// completes the wgmmas writing it.
template <int kN>
__device__ __forceinline__ void mft_wgmma_fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int e = 0; e < kN; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// ------------------------------------------------ convolution arguments
// (client_conv.cu and client_stem_raw.cu; ctypes mirrors this layout)

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
