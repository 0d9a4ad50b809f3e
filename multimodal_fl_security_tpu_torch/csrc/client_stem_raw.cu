// K3's raw stem convolution on Hopper's tensor cores (sm_90a): every
// client's 4 x 4, stride-2, pad-1 convolution of a 28 x 28 x 8 NHWC image
// into 14 x 14 x 128, in bf16 (stem_raw_tc, each output rounded once to
// bf16) and in f32 (stem_raw_tf32, 3xTF32; its section below).
//
// Replaces multimodal_fl_security_tpu/ops/client_conv.py::client_stem_conv
// (:97; the Pallas kernel _stem_kernel, :63), which builds the 16 stride-2
// taps of a client's images in VMEM and contracts them in one MXU GEMM.
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
//
// stem_raw_tf32, the same function in f32: the same GEMM, 20.6 GFLOP, whose
// f32 products take 0.307 ms at the f32 CUDA-core rate (67 TFLOP/s) and
// 0.125 ms in 3xTF32 on the tensor cores (3 products at 495 TFLOP/s),
// against 408 MB moved (x 80.3, w4 6.6, the f32 output 321.1: 0.122 ms).
// The first version (conv_fwd) ran 47x above that. Each f32 operand a is
// split into hi = tf32(a) and lo = tf32(a - hi), rounded to nearest even,
// and a b is summed as lo hi + hi lo + hi hi with f32 sums: the dropped
// lo lo is ~2^-22 |a b|, so the output keeps f32's accuracy.
//  - wgmma.m64n64k8 (tf32 in, f32 sums). TF32 takes both operands K-major
//    only, so W is transposed while staged, as above. An f32 core matrix
//    row is 4 floats: one NHWC tap (8 channels, 32 bytes) is two rows of one
//    k8 step's two core matrices, so the A tile is built by 16-byte
//    cp.async copies as in bf16.
//  - Shared memory: W's hi and lo stay resident (2 x 64 KB); a 64-row A
//    tile as hi and lo (2 x 32 KB) and the next tile's raw copies (32 KB):
//    224 KB, one block an SM. Both warpgroups read the same A tile, each
//    against 64 of W's 128 columns; a persistent block walks ~74 tiles of
//    at most two clients and splits W when the client changes.
//  - Per tile: the raw copies land, every thread splits them into hi and
//    lo (each value once), then the next tile's copies are issued and land
//    while the tensor cores run and the outputs are stored.
//  - The tensor cores' f32 sums do not round to nearest (gram.cu): the 48
//    wgmmas of a tile (16 k8 steps x 3) run as 4 chunks, each into a fresh
//    accumulator, added in chunk order in f32 while the next chunk runs.
//  - Outputs go from registers to the NHWC rows: a quad writes 32
//    contiguous bytes, one sector; nothing is left in shared memory for an
//    epilogue tile.

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

// What stem_raw_tc (dtype bf16) and stem_raw_tf32 (f32) take: that compute
// dtype, raw (no epilogue), K3's geometry (4 x 4, stride 2, pad 1, 28 x 28 x
// 8 -> 14 x 14 x 128) and x in that dtype, NHWC dense within a sample, its
// samples' and clients' rows 16-byte aligned.
bool takes(const MftConvArgs& a, const MftView& x, int dtype) {
  const ConvGeom& g = a.g;
  const long long per16 = dtype == kBF16 ? 8 : 4;  // elements in 16 bytes
  return a.clients > 0 && g.batch > 0 && g.cdt == dtype && !g.pool &&
         g.cin == kCin && g.h == kHw && g.w == kHw && g.cout == kCout &&
         g.k == 4 && g.stride == 2 && g.pad == 1 && g.oh == kOut &&
         g.ow == kOut && x.dtype == dtype && x.st[2] == 1 &&
         x.st[3] == kHw * kCin && x.st[4] == kCin && x.st[0] % per16 == 0 &&
         x.st[1] % per16 == 0 &&
         reinterpret_cast<uintptr_t>(x.ptr) % 16 == 0;
}

// ------------------------------------------------------------ f32, 3xTF32

constexpr int kTfRows = 64;  // GEMM rows a tile
// Element (r, k) of a K-major f32 tile sits at byte
// (r / 8) * kTfSbo + (k / 4) * kTfLbo + (r % 8) * 16 + (k % 4) * 4.
constexpr int kTfLbo = 128;                    // to the next 4 k
constexpr int kTfSbo = kDepth / 4 * kTfLbo;    // to the next 8 rows, 4 KB
constexpr int kTfWBytes = kCout * kDepth * 4;  // 64 KB: W's hi, or its lo
constexpr int kTfABytes = kTfRows * kDepth * 4;  // 32 KB: an A tile's hi, lo, raw
constexpr size_t kTfSmem = 2 * kTfWBytes + 3 * kTfABytes;  // 224 KB
constexpr int kTfPromote = 4;  // k8 steps a fresh accumulator takes
constexpr int kTfChunks = kDepth / 8 / kTfPromote;

static_assert(kTfSmem <= kMftMaxSmem, "one block an SM");
static_assert(kTfChunks == 4, "the chunk sequence below is written for 4");

// One chunk's 3 kTfPromote wgmmas into d: for each k8 step, A_lo W_hi,
// A_hi W_lo, then A_hi W_hi (the small terms first); the first starts d
// afresh.
__device__ __forceinline__ void tf32_chunk(float (&d)[32], int ch,
                                           uint32_t ah, uint32_t al,
                                           uint32_t bh, uint32_t bl) {
#pragma unroll
  for (int s = 0; s < kTfPromote; ++s) {
    const int k = (ch * kTfPromote + s) * 2 * kTfLbo;  // a k8 step: two
    const uint64_t dah = mft_wgmma_desc(ah + k, kTfLbo, kTfSbo);
    const uint64_t dbh = mft_wgmma_desc(bh + k, kTfLbo, kTfSbo);
    const uint64_t dal = mft_wgmma_desc(al + k, kTfLbo, kTfSbo);
    if (s == 0) {
      mft_wgmma_tf32_n64<false>(d, dal, dbh);
    } else {
      mft_wgmma_tf32_n64<true>(d, dal, dbh);
    }
    mft_wgmma_tf32_n64<true>(d, dah, mft_wgmma_desc(bl + k, kTfLbo, kTfSbo));
    mft_wgmma_tf32_n64<true>(d, dah, dbh);
  }
}

// hi and lo of n4 float4s of src (any layout: element for element).
__device__ __forceinline__ void tf32_split(const float* src, float* hi,
                                           float* lo, int n4) {
  for (int v = threadIdx.x; v < n4; v += kThreads) {
    const float4 a = reinterpret_cast<const float4*>(src)[v];
    const float4 h = make_float4(mft_tf32_rne(a.x), mft_tf32_rne(a.y),
                                 mft_tf32_rne(a.z), mft_tf32_rne(a.w));
    reinterpret_cast<float4*>(hi)[v] = h;
    reinterpret_cast<float4*>(lo)[v] =
        make_float4(mft_tf32_rne(a.x - h.x), mft_tf32_rne(a.y - h.y),
                    mft_tf32_rne(a.z - h.z), mft_tf32_rne(a.w - h.w));
  }
}

// x: the NHWC f32 input as (client, sample, channel, row, col), dense
// within a sample (strides 1, 224, 8), 16-byte aligned; w: (client, co, ci,
// kh, kw), any strides, f32 or bf16; out: the dense NHWC f32 output as
// [C, B * 196, 128] rows. Block b takes tiles [b T / G, (b + 1) T / G) of
// the T = C * tiles_per_client 64-row tiles.
__global__ void __launch_bounds__(kThreads, 1)
stem_raw_tf32_kernel(MftView x, MftView w, float* __restrict__ out,
                     int batch, int tiles_per_client, long long total) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* whi = reinterpret_cast<float*>(smem);  // W, [n][k] K-major
  float* wlo = whi + kTfWBytes / 4;
  float* ahi = wlo + kTfWBytes / 4;             // the tile, [r][k] K-major
  float* alo = ahi + kTfABytes / 4;
  float* araw = alo + kTfABytes / 4;            // the next tile's copies
  const long long t0 = blockIdx.x * total / gridDim.x;
  const long long count = (blockIdx.x + 1) * total / gridDim.x - t0;
  const int rows = batch * kPix;  // GEMM rows of a client
  const int t = threadIdx.x, wg = t / 128, wt = t % 128;

  // This thread's copies: channels 4 (kc % 2) .. + 3 of tap kc / 2 (the
  // k core matrix kc), rows 8 j + t % 8.
  const int r8 = t % 8, kc = t / 8, tap = kc / 2, di = tap / 4, dj = tap % 4;
  const uint32_t a_dst = mft_smem_addr(araw) + kc * kTfLbo + r8 * 16;
  auto issue = [&](long long tile) {
    const int c = static_cast<int>(tile / tiles_per_client);
    const int r0 = static_cast<int>(tile % tiles_per_client) * kTfRows;
    const float* xc = static_cast<const float*>(x.ptr) + c * x.st[0];
#pragma unroll
    for (int j = 0; j < kTfRows / 8; ++j) {
      const int row = r0 + 8 * j + r8;
      const int p = row % kPix;
      const int iy = 2 * (p / kOut) - 1 + di, ix = 2 * (p % kOut) - 1 + dj;
      const bool in = row < rows && iy >= 0 && iy < kHw && ix >= 0 && ix < kHw;
      const float* src =
          in ? xc + (row / kPix) * x.st[1] + (iy * kHw + ix) * kCin +
                   4 * (kc % 2)
             : xc;
      mft_cp_async16(a_dst + j * kTfSbo, src, in ? 16 : 0);
    }
  };
  // W[c], split: float4 (n, kq) holds w[c, n, ci0 .. ci0 + 3, di, dj] for
  // k = 4 kq .. + 3, tap kq / 2, ci0 = 4 (kq % 2).
  auto stage_w = [&](int c) {
    for (int q = t; q < kCout * kDepth / 4; q += kThreads) {
      const int n = q % kCout, kq = q / kCout;
      const int tp = kq / 2, ci0 = 4 * (kq % 2);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = mft_ld(w, mft_off(w, c, n, ci0 + e, tp / 4, tp % 4));
      }
      const float4 h = make_float4(mft_tf32_rne(v[0]), mft_tf32_rne(v[1]),
                                   mft_tf32_rne(v[2]), mft_tf32_rne(v[3]));
      const int off = (n / 8) * (kTfSbo / 4) + kq * (kTfLbo / 4) + (n % 8) * 4;
      *reinterpret_cast<float4*>(whi + off) = h;
      *reinterpret_cast<float4*>(wlo + off) = make_float4(
          mft_tf32_rne(v[0] - h.x), mft_tf32_rne(v[1] - h.y),
          mft_tf32_rne(v[2] - h.z), mft_tf32_rne(v[3] - h.w));
    }
  };

  const int lane = t % 32, gq = lane / 4, tq = lane % 4;
  const int row_w = 16 * (wt / 32) + gq;  // the sums' rows: + 8 h
  const int col_w = 64 * wg + 2 * tq;     // columns: + 8 j + e
  const uint32_t ah = mft_smem_addr(ahi), al = mft_smem_addr(alo);
  const uint32_t bh = mft_smem_addr(whi) + wg * 8 * kTfSbo;  // its 64 n
  const uint32_t bl = mft_smem_addr(wlo) + wg * 8 * kTfSbo;
  float acc[32], p0[32], p1[32];
  int client = -1;
  if (count > 0) issue(t0);
  mft_cp_async_commit();
  for (long long i = 0; i < count; ++i) {
    const long long tile = t0 + i;
    const int c = static_cast<int>(tile / tiles_per_client);
    mft_cp_async_wait<0>();  // tile i's copies
    __syncthreads();         // ... everyone's; tile i - 1's wgmmas are done
    if (c != client) {
      stage_w(c);
      client = c;
    }
    tf32_split(araw, ahi, alo, kTfABytes / 16);
    mft_fence_proxy_async();
    __syncthreads();  // the split is visible to the wgmmas; araw is read
    if (i + 1 < count) issue(tile + 1);  // lands while the tensor cores run
    mft_cp_async_commit();

    // Four chunks of 4 k8 steps, each into a fresh accumulator (p0 and p1
    // in turn), added to acc in chunk order while the next chunk runs.
    mft_wgmma_fence();
    tf32_chunk(p0, 0, ah, al, bh, bl);
    mft_wgmma_commit();
    tf32_chunk(p1, 1, ah, al, bh, bl);
    mft_wgmma_commit();
    mft_wgmma_wait<1>();
    mft_wgmma_fence_operands(p0);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = p0[e];
    mft_wgmma_fence();
    tf32_chunk(p0, 2, ah, al, bh, bl);
    mft_wgmma_commit();
    mft_wgmma_wait<1>();
    mft_wgmma_fence_operands(p1);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += p1[e];
    mft_wgmma_fence();
    tf32_chunk(p1, 3, ah, al, bh, bl);
    mft_wgmma_commit();
    mft_wgmma_wait<1>();
    mft_wgmma_fence_operands(p0);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += p0[e];
    mft_wgmma_wait<0>();
    mft_wgmma_fence_operands(p1);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += p1[e];

    // acc[4 j + 2 h + e]: row row_w + 8 h, column col_w + 8 j + e; a quad
    // writes 32 contiguous bytes of a row.
    const int r0 = static_cast<int>(tile % tiles_per_client) * kTfRows;
    float* orow = out + (static_cast<long long>(c) * rows + r0) * kCout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_w + 8 * h;
      if (r0 + r < rows) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<float2*>(orow + r * kCout + col_w + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
  mft_cp_async_wait<0>();
}

}  // namespace

extern "C" {

int mft_stem_raw_tc_takes(const MftConvArgs* a, const MftView* x) {
  return takes(*a, *x, kBF16);
}

// out: (client, sample, channel, row, col) of a dense NHWC bf16 [C, B, 14,
// 14, 128]. Returns a cudaError_t; what takes() refuses is
// cudaErrorInvalidValue, never handed to another kernel.
int mft_stem_raw_tc(const MftView* x, const MftView* w, const MftView* out,
                    const MftConvArgs* a, int device, void* stream) {
  const long long rows = static_cast<long long>(a->g.batch) * kPix;
  const MftView& o = *out;
  if (!takes(*a, *x, kBF16) || (w->dtype != kBF16 && w->dtype != kF32) ||
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

int mft_stem_raw_tf32_takes(const MftConvArgs* a, const MftView* x) {
  return takes(*a, *x, kF32);
}

// out: (client, sample, channel, row, col) of a dense NHWC f32 [C, B, 14,
// 14, 128]. Returns a cudaError_t; what takes() refuses is
// cudaErrorInvalidValue, never handed to another kernel.
int mft_stem_raw_tf32(const MftView* x, const MftView* w, const MftView* out,
                      const MftConvArgs* a, int device, void* stream) {
  const long long rows = static_cast<long long>(a->g.batch) * kPix;
  const MftView& o = *out;
  if (!takes(*a, *x, kF32) || (w->dtype != kBF16 && w->dtype != kF32) ||
      o.dtype != kF32 || o.st[2] != 1 || o.st[4] != kCout ||
      o.st[3] != kOut * kCout || o.st[1] != kPix * kCout ||
      o.st[0] != rows * kCout || reinterpret_cast<uintptr_t>(o.ptr) % 16) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles_per_client = static_cast<int>((rows + kTfRows - 1) / kTfRows);
  const long long total =
      static_cast<long long>(a->clients) * tiles_per_client;
  const long long grid = total < sms ? total : sms;
  err = mft_smem_optin(stem_raw_tf32_kernel, kTfSmem);
  if (err != cudaSuccess) return err;
  stem_raw_tf32_kernel<<<static_cast<unsigned>(grid), kThreads, kTfSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      *x, *w, static_cast<float*>(o.ptr), a->g.batch, tiles_per_client,
      total);
  return cudaGetLastError();
}

const char* mft_client_stem_raw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
