// K3's raw stem convolution in bf16 on Hopper's tensor cores (sm_90a): every
// client's 4 x 4, stride-2, pad-1 convolution of a 28 x 28 x 8 NHWC image
// into 14 x 14 x 128, each output rounded once to bf16.
//
// Replaces multimodal_fl_security_tpu/ops/client_conv.py::client_stem_conv
// (:97; the Pallas kernel _stem_kernel, :63), which builds the 16 stride-2
// taps of a client's images in VMEM and contracts them in one MXU GEMM. f32
// calls stay on client_conv.cu's conv_fwd, the checking mode.
//
// The function is one GEMM per client: rows are output pixels (n, oy, ox),
// B * 196 of them; the depth is the 16 taps (di, dj) x 8 channels = 128;
// the width the 128 output channels. Row (n, oy, ox)'s tap (di, dj) is the
// 16 bytes of input pixel (2 oy - 1 + di, 2 ox - 1 + dj), or zeros off the
// border. At the north star's [100, 32, 6272] x [100, 4, 4, 8, 128] that is
// 20.6 GFLOP (0.021 ms at the bf16 peak) against 204 MB (0.061 ms at
// 3.35 TB/s), of which 160.6 MB is the bf16 output: the bytes bound it. The
// first version (conv_fwd, one block per sample and client, scalar FMAs on
// the CUDA cores from shared memory) ran 95x above that.
//
// What the design does about it:
//  - wgmma.m64n128k16 (bf16 in, f32 sums): two warpgroups cover a 128-row
//    tile in 8 k-steps, both operands read from shared memory. Both tiles
//    are K-major core matrices (8 rows x 16 bytes) without swizzle: one
//    16-byte tap of one pixel is exactly one core-matrix row, so the copy
//    engine builds the im2col tile with no register pass.
//  - Persistent blocks, two an SM: each walks a contiguous range of
//    (client, 128-row tile) pairs (4,900 tiles at the north star, ~19 a
//    block, spanning at most two clients) and restages W only when the
//    client changes. W[c] ([k = (di, dj, ci)][n] in w4's HWIO) is
//    transposed into its K-major tile while staged, 8 channels a store.
//  - A ring of two A tiles: tile i + 1's 16-byte cp.async copies are in
//    flight while the tensor cores run tile i and its outputs are stored;
//    a copy of src-size 0 zero-fills the padded border and the rows past a
//    ragged last tile. A thread copies one tap of 8 rows 8 apart, so a
//    warp writes 8 consecutive rows of 4 taps: no bank conflict.
//  - Epilogue: each f32 sum rounded once to bf16 and written, 16-byte
//    chunks XOR-swizzled by row, into the warpgroup's own rows of the A
//    tile just read (only its own wgmmas read them), then stored to the
//    NHWC output with coalesced 16-byte stores: a 128-row tile is 32 KB of
//    contiguous output.
//  - Every sum runs in one order (the wgmma's, over k): two calls are
//    bitwise equal.

#include "client_common.cuh"

namespace {

constexpr int kHw = 28, kOut = 14, kCin = 8, kCout = 128, kTaps = 16;
constexpr int kPix = kOut * kOut;  // output pixels a sample
constexpr int kRows = 128;         // GEMM rows a tile
constexpr int kDepth = kTaps * kCin;
constexpr int kThreads = 256;  // two warpgroups
constexpr int kBlocksPerSm = 2;
// Element (r, k) of a K-major tile sits at byte
// (r / 8) * kSbo + (k / 8) * kLbo + (r % 8) * 16 + (k % 8) * 2.
constexpr int kLbo = 128;               // to the next 8 k (the next tap)
constexpr int kSbo = kTaps * kLbo;      // to the next 8 rows
constexpr int kTileBytes = kRows * kDepth * 2;  // 32 KB: W, an A tile
constexpr size_t kSmem = 3 * kTileBytes;        // W and the ring of two
constexpr int kRowBytes = kCout * 2;            // an output row, 256 B

static_assert(kRows * kRowBytes == kTileBytes, "the output tile fits an A tile");

using bf16 = __nv_bfloat16;

// d (+)= A (64 x 16) B^T (B: 128 x 16), both K-major in shared memory:
// bf16 in, f32 sums. kAccumulate false writes d = A B^T (scale-d 0) and
// reads nothing of d, so the sums are not live before a tile's first k-step.
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da,
                                                uint64_t db) {
#define MFT_WGMMA_N128(C)                                                      \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
      "%58, %59, %60, %61, %62, %63 "                                          \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                       \
      : C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]),         \
        C(d[7]), C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]),     \
        C(d[14]), C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]),  \
        C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]),  \
        C(d[28]), C(d[29]), C(d[30]), C(d[31]), C(d[32]), C(d[33]), C(d[34]),  \
        C(d[35]), C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]),  \
        C(d[42]), C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]),  \
        C(d[49]), C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), C(d[55]),  \
        C(d[56]), C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]),  \
        C(d[63])                                                               \
      : "l"(da), "l"(db), "r"(kAccumulate ? 1 : 0))
#define MFT_RW(x) "+f"(x)
#define MFT_W(x) "=f"(x)
  if constexpr (kAccumulate) {
    MFT_WGMMA_N128(MFT_RW);
  } else {
    MFT_WGMMA_N128(MFT_W);
  }
#undef MFT_W
#undef MFT_RW
#undef MFT_WGMMA_N128
}

// A barrier of one warpgroup (ids 1 and 2; __syncthreads is 0).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// x: the NHWC input as (client, sample, channel, row, col), dense within a
// sample (strides 1, 224, 8) and 16-byte aligned; w: (client, co, ci, kh,
// kw), any strides, bf16 or f32 (rounded to bf16); out: the NHWC output,
// dense, as [C, B * 196, 128] rows. Block b takes tiles [b T / G,
// (b + 1) T / G) of the T = C * tiles_per_client.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
stem_raw_tc_kernel(MftView x, MftView w, bf16* __restrict__ out, int batch,
                   int tiles_per_client, long long total) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ws = smem;               // W, [n][k] K-major
  uint8_t* as = smem + kTileBytes;  // the ring: [slot][rows][k] K-major
  const long long t0 = blockIdx.x * total / gridDim.x;
  const long long count = (blockIdx.x + 1) * total / gridDim.x - t0;
  const int rows = batch * kPix;  // GEMM rows of a client
  const int t = threadIdx.x, wg = t / 128, wt = t % 128;

  // This thread's copies: tap (di, dj) of rows (t / 128 + 2 j) * 8 + t % 8.
  const int r8 = t % 8, tap = (t / 8) % kTaps, di = tap / 4, dj = tap % 4;
  const uint32_t a_off = (t / 128) * kSbo + tap * kLbo + r8 * 16;
  auto issue = [&](long long tile, int slot) {
    const int c = static_cast<int>(tile / tiles_per_client);
    const int r0 = static_cast<int>(tile % tiles_per_client) * kRows;
    const bf16* xc = static_cast<const bf16*>(x.ptr) + c * x.st[0];
    const uint32_t dst = mft_smem_addr(as + slot * kTileBytes) + a_off;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = r0 + (t / 128 + 2 * j) * 8 + r8;
      const int p = row % kPix;
      const int iy = 2 * (p / kOut) - 1 + di, ix = 2 * (p % kOut) - 1 + dj;
      const bool in = row < rows && iy >= 0 && iy < kHw && ix >= 0 && ix < kHw;
      const bf16* src =
          in ? xc + (row / kPix) * x.st[1] + (iy * kHw + ix) * kCin : xc;
      mft_cp_async16(dst + j * 2 * kSbo, src, in ? 16 : 0);
    }
  };
  // W[c]: chunk (n, tap) holds w[c, n, 0..7, di, dj], 8 channels in one
  // 16-byte store.
  auto stage_w = [&](int c) {
#pragma unroll 2
    for (int j = 0; j < kCout * kTaps / kThreads; ++j) {
      const int q = t + j * kThreads;
      const int n = q % kCout, tp = q / kCout;
      uint32_t v[4];
#pragma unroll
      for (int ci = 0; ci < kCin; ci += 2) {
        v[ci / 2] = mft_pack2(
            mft_ld(w, mft_off(w, c, n, ci, tp / 4, tp % 4)),
            mft_ld(w, mft_off(w, c, n, ci + 1, tp / 4, tp % 4)));
      }
      *reinterpret_cast<uint4*>(ws + (n / 8) * kSbo + tp * kLbo +
                                (n % 8) * 16) = make_uint4(v[0], v[1], v[2],
                                                           v[3]);
    }
  };

  const int lane = t % 32, gq = lane / 4, tq = lane % 4;
  const int row_w = 64 * wg + 16 * (wt / 32) + gq;  // acc's rows: + 8 h
  float acc[64];
  int client = -1;
  issue(t0, 0);
  mft_cp_async_commit();
  for (long long i = 0; i < count; ++i) {
    const long long tile = t0 + i;
    const int slot = static_cast<int>(i & 1);
    __syncthreads();  // the other slot's last reads (tile i - 1) are done
    if (i + 1 < count) issue(tile + 1, slot ^ 1);
    mft_cp_async_commit();
    const int c = static_cast<int>(tile / tiles_per_client);
    if (c != client) {  // every wgmma that read the old W has completed
      stage_w(c);
      client = c;
    }
    mft_cp_async_wait<1>();  // tile i's copies
    mft_fence_proxy_async();
    __syncthreads();

    uint8_t* at = as + slot * kTileBytes;
    const uint32_t a0 = mft_smem_addr(at) + wg * 8 * kSbo;  // its 64 rows
    const uint32_t b0 = mft_smem_addr(ws);
    mft_wgmma_fence();
    wgmma_bf16_n128<false>(acc, mft_wgmma_desc(a0, kLbo, kSbo),
                           mft_wgmma_desc(b0, kLbo, kSbo));
#pragma unroll
    for (int ks = 1; ks < kDepth / 16; ++ks) {
      wgmma_bf16_n128<true>(acc,
                            mft_wgmma_desc(a0 + ks * 2 * kLbo, kLbo, kSbo),
                            mft_wgmma_desc(b0 + ks * 2 * kLbo, kLbo, kSbo));
    }
    mft_wgmma_commit();
    mft_wgmma_wait<0>();

    // acc[4 j + 2 h + e]: row row_w + 8 h, column 8 j + 2 tq + e. Row r's
    // 16-byte chunk j goes to chunk j ^ (r % 8) of its 256 bytes.
#pragma unroll
    for (int j = 0; j < kCout / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row_w + 8 * h;
        *reinterpret_cast<uint32_t*>(at + r * kRowBytes +
                                     ((j ^ (r & 7)) * 16) + tq * 4) =
            mft_pack2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    warpgroup_sync(wg);
    const int r0 = static_cast<int>(tile % tiles_per_client) * kRows;
    bf16* orow = out + (static_cast<long long>(c) * rows + r0) * kCout;
#pragma unroll
    for (int j = 0; j < 64 * kRowBytes / 16 / 128; ++j) {
      const int q = wt + j * 128;
      const int r = 64 * wg + q / 16, cc = q % 16;
      if (r0 + r < rows) {
        *reinterpret_cast<uint4*>(orow + r * kCout + cc * 8) =
            *reinterpret_cast<const uint4*>(at + r * kRowBytes +
                                            ((cc ^ (r & 7)) * 16));
      }
    }
  }
  mft_cp_async_wait<0>();
}

// What stem_raw_tc takes: bf16 compute, raw (no epilogue), K3's geometry
// (4 x 4, stride 2, pad 1, 28 x 28 x 8 -> 14 x 14 x 128) and x in bf16,
// NHWC dense within a sample, its samples' and clients' rows 16-byte
// aligned.
bool takes(const MftConvArgs& a, const MftView& x) {
  const ConvGeom& g = a.g;
  return a.clients > 0 && g.batch > 0 && g.cdt == kBF16 && !g.pool &&
         g.cin == kCin && g.h == kHw && g.w == kHw && g.cout == kCout &&
         g.k == 4 && g.stride == 2 && g.pad == 1 && g.oh == kOut &&
         g.ow == kOut && x.dtype == kBF16 && x.st[2] == 1 &&
         x.st[3] == kHw * kCin && x.st[4] == kCin && x.st[0] % 8 == 0 &&
         x.st[1] % 8 == 0 && reinterpret_cast<uintptr_t>(x.ptr) % 16 == 0;
}

}  // namespace

extern "C" {

int mft_stem_raw_tc_takes(const MftConvArgs* a, const MftView* x) {
  return takes(*a, *x);
}

// out: (client, sample, channel, row, col) of a dense NHWC bf16 [C, B, 14,
// 14, 128]. Returns a cudaError_t; what takes() refuses is
// cudaErrorInvalidValue, never handed to another kernel.
int mft_stem_raw_tc(const MftView* x, const MftView* w, const MftView* out,
                    const MftConvArgs* a, int device, void* stream) {
  const long long rows = static_cast<long long>(a->g.batch) * kPix;
  const MftView& o = *out;
  if (!takes(*a, *x) || (w->dtype != kBF16 && w->dtype != kF32) ||
      o.dtype != kBF16 || o.st[2] != 1 || o.st[4] != kCout ||
      o.st[3] != kOut * kCout || o.st[1] != kPix * kCout ||
      o.st[0] != rows * kCout || reinterpret_cast<uintptr_t>(o.ptr) % 16) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles_per_client = static_cast<int>((rows + kRows - 1) / kRows);
  const long long total =
      static_cast<long long>(a->clients) * tiles_per_client;
  const long long grid = total < static_cast<long long>(sms) * kBlocksPerSm
                             ? total
                             : static_cast<long long>(sms) * kBlocksPerSm;
  err = mft_smem_optin(stem_raw_tc_kernel, kSmem);
  if (err != cudaSuccess) return err;
  stem_raw_tc_kernel<<<static_cast<unsigned>(grid), kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      *x, *w, static_cast<bf16*>(o.ptr), a->g.batch, tiles_per_client, total);
  return cudaGetLastError();
}

const char* mft_client_stem_raw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
