// Packed fused DoubleConv for Hopper (sm_90a): conv3x3 (pad 1) -> PReLU ->
// conv3x3 (pad 1), optionally followed by a 1x1 conv (the UNet's outc head),
// on the wide channel-packed tensors of models/packed.py (g problems packed
// into the channel axis: 32 to 288 input channels, 32 or 128 mid and out
// channels at g = 16; 64 to 576 and 256 at g = 32; 128 to 1152 and 512 at
// g = 64, the widest at which the TPU kernel runs).
//
// Replaces the TPU kernel helmnet_tpu/ops/pallas_unet.py:175
// (fused_double_conv, body `_kernel` at :89, taps `_conv_taps` at :60). The
// TPU design flattens the plane to [H*W, C] rows, pads channels to 128
// lanes, rolls rows for each tap and tiles the plane to a VMEM budget; none
// of that is carried over. Here each block computes one TH x TW output tile
// of one sample as implicit GEMMs on the tensor cores (bf16 operands, f32
// sums): M = pixels, N = output channels, K = 9 taps x input channels.
//   1. conv1 over the (TH+2) x (TW+2) intermediate tile (the output tile
//      and its 1-pixel ring). The input channels are streamed in chunks of
//      16, each one k16 step a tap. A chunk's (TH+4) x (TW+4) input tile
//      (2-pixel halo) is loaded into registers while the chunk before it is
//      on the tensor cores, then rounded to bf16 into one of two shared
//      buffers. Up to three input parts are read through separate pointers
//      in part-major channel order, so no concatenated copy is written.
//   2. The weights come as chunks of 9 taps x [rows x 16] bf16, each tap's
//      block in 8 x 8 core matrices (prepared once per rollout,
//      ops/packed_double_conv.prepare): at 128 rows a chunk is 36 KB, and
//      the c1 weights of a call are up to 576 KB. They stream through a
//      ring of 4 shared-memory stages fed by cp.async 16-byte copies:
//      chunk q + 2 is in flight while chunk q is multiplied.
//      Conv2's weight chunks follow conv1's through the same ring.
//   3. The products are wgmma m64nNk16 on two warpgroups: A (64 pixels x
//      16 channels of one tap) from registers, loaded with ldmatrix, each
//      lane's row address absorbing the tap's shift and the halo (a shared
//      memory descriptor cannot: a shifted window of a halo'd tile has no
//      uniform stride between its 8-row groups); B (the tap's weight block)
//      from shared memory through a descriptor, K-major without swizzle. Up
//      to two taps' products stay in flight, across chunk boundaries too.
//      Conv1: each warpgroup takes every m64 tile and half of N; conv2:
//      half of the m64 tiles and all of N where their count is even.
//   4. bias + PReLU (ReLU without a slope), rounded to bf16 once and kept
//      in shared memory for all mid channels (49 KB at 128 channels and
//      8 x 16). Conv2's zero padding means the intermediate is ZERO outside
//      the image, not conv1 evaluated in the ring: the ring is masked on
//      every edge tile.
//   5. conv2 from that intermediate, + bias, written as NHWC f32; or, with
//      the head, rounded to bf16 and taken through the 1x1 (mma.sync).
// Precision follows the TPU kernel: x, h1 and h2 (before the head) are
// rounded to bf16 where they enter a product, weights are bf16, and sums,
// biases and PReLU are f32.
//
// What bounds it on this card. The 128-wide instance: one packed step at
// 256^2, g = 16, does 178.9 GFLOP in its 14 calls and moves about 350 MB,
// so the function is bound by operations at the bf16 tensor-core rate
// (0.181 ms a step at 989 TFLOP/s, against 0.105 ms for the bytes at
// 3.35 TB/s). The output tile is chosen by the level's size
// (ops/packed_double_conv.tile_for): 8 x 16 at 256^2 and 128^2 (3 m64
// tiles in conv1, 2 in conv2), 4 x 8 at 64^2 and below (1 and 1, half of
// conv2's rows padding), where 8 x 16 would give 2 to 32 blocks for 132
// SMs. Both keep one block on each SM (169 and 214 KiB of shared memory).
//
// Mid, out and head widths above 128 take the cluster instance below. Its
// function is bound by operations too (a 256^2 step: 0.725 ms at g = 32,
// 2.90 ms at g = 64), but what limits a kernel there is the weight bytes
// it reads from L2: every tile reads all of w1 and w2 once. A block that
// computed all of N for its tile would have to hold the mid tile of every
// mid channel (62 KB at 512 channels and 4 x 8), so only small tiles fit,
// and small tiles mean many reads of the weights (21.7 GB from L2 for one
// g = 64 call at 256^2 on 4 x 8 tiles, at about 4.4 TB/s). The cluster
// splits N over its CTAs instead, each holding one 128-channel slice of the
// mid tile, so every width takes the 8 x 16 tile: a tile's weights are
// read once across its cluster, for 4x (g = 64) or 2x (g = 32) the pixels
// of a 4 x 8 or 8 x 8 tile, and conv1's ring of padding rows falls to 1.5x
// its output rows. The peers' mid chunks cross the cluster's distributed
// shared memory (5.6 KB a chunk at 8 x 16), not L2.
//
// Plain C entry point, bound from Python with ctypes
// (ops/packed_double_conv.py). It launches on the caller's stream, does not
// synchronise, allocates nothing, and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int CK = 16;            // channels per K chunk: one k16 step a tap
constexpr int XS = CK + 8;        // input tile pixel stride (bf16, 48 bytes)
constexpr int WROW = 9 * CK;      // a weight row of one chunk (bf16)
constexpr int THREADS = 256;      // 8 warps
constexpr int MAX_PARTS = 3;
constexpr int MAX_WIDTH = 128;    // mid, out and head channels

struct Args {
  const float* x[MAX_PARTS];  // [B, H, W, c[i]] f32
  int c[MAX_PARTS];
  const bf16* w1;     // [nck1][9][CMP / 8][2][8][8] (ops/packed_double_conv)
  const float* b1;    // [cm]
  const float* slope; // [1] or null (ReLU)
  const bf16* w2;     // [CMP / CK][9][COP / 8][2][8][8]
  const float* b2;    // [co]
  const bf16* w3;     // [cep][COP] or null
  const float* b3;    // [ce]
  float* out;         // [B, H, W, ce] with the head, else [B, H, W, co]
  int H, W, cm, co, ce, cep, nck1, vec;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// PReLU as the TPU kernel computes it, max(v, 0) + slope * min(v, 0) (ReLU
// at slope 0), keeping a NaN as jnp.maximum and jnp.minimum do: fmaxf and
// fminf return the operand that is not a NaN, so without the test a NaN
// would leave conv1 as 0. For every other v, +-inf and +-0 included, this
// is the fmaxf/fminf form bit for bit.
__device__ __forceinline__ float prelu(float v, float slope) {
  return isnan(v) ? v : fmaxf(v, 0.f) + slope * fminf(v, 0.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void fence_proxy_async() {  // generic -> async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the waits that complete them.
template <int K>
__device__ __forceinline__ void fence_regs(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (m64 x N f32, this thread's N / 2) += A (m64 x k16 bf16, from this
// warp's registers: the mma.m16n8k16 A fragment of its 16 rows) x B (k16 x
// N bf16, K-major in shared memory, descriptor `db`). Asynchronous: the
// caller commits and waits.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A(16x16, row-major) * B(16x8, column-major); bf16 in, f32 sums.
// Fragments (PTX ISA, mma.m16n8k16), g = lane / 4, t = lane % 4:
//   a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   d0, d1 = D[g][2t, 2t+1], d2, d3 = D[g+8][2t, 2t+1]
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ const float* channel_ptr(const Args& a, size_t pix,
                                                   int cc) {
  if (cc < a.c[0]) return a.x[0] + pix * a.c[0] + cc;
  cc -= a.c[0];
  if (cc < a.c[1]) return a.x[1] + pix * a.c[1] + cc;
  return a.x[2] + pix * a.c[2] + (cc - a.c[1]);
}

// Sizes of one instance: TH x TW output tile, CMP and COP mid and out
// channels (32 or 128), STAGES weight stages.
template <int TH, int TW, int CMP, int COP, int STAGES>
struct Cfg {
  static constexpr int MH = TH + 2, MW = TW + 2, IH = TH + 4, IW = TW + 4;
  static constexpr int M1 = MH * MW, M2 = TH * TW;
  // m64 tiles of conv1 and conv2; each warpgroup takes every tile and half
  // of N. Rows past M1 or M2 are padding.
  static constexpr int G1 = (M1 + 63) / 64, G2 = (M2 + 63) / 64;
  static constexpr int N1 = CMP / 2;
  // conv2's tiles are split between the warpgroups, each with all of N,
  // where their count is even (SPLIT2)
  static constexpr bool SPLIT2 = G2 % 2 == 0;
  static constexpr int T2 = SPLIT2 ? G2 / 2 : G2, N2 = SPLIT2 ? COP : COP / 2;
  // the head (mma.sync): M2 rows as WM2 x MPW2 m16 tiles, WN2 warp columns
  static constexpr int MT2 = M2 / 16;
  static constexpr int WM2 = MT2 >= 4 ? 4 : MT2, WN2 = 8 / WM2;
  static constexpr int MPW2 = MT2 / WM2;
  static constexpr int XT = IH * IW * XS;             // one input buffer
  static constexpr int WB = (CMP > COP ? CMP : COP) * WROW;
  static constexpr int SB = WB > MAX_WIDTH * (COP + 8) ? WB : MAX_WIDTH * (COP + 8);
  static constexpr int HSTR = CMP + 8;                // intermediate stride
  static constexpr int HS = M1 * HSTR;
  static constexpr size_t BYTES = (size_t)(2 * XT + STAGES * SB + HS) * sizeof(bf16);
  // input groups of 4 channels a chunk, and how many a thread loads
  static constexpr int NG = IH * IW * (CK / 4);
  static constexpr int LV = (NG + THREADS - 1) / THREADS;
  static_assert(M2 % 16 == 0 && MT2 % WM2 == 0, "whole m16 tiles");
  static_assert(M2 * (COP + 8) <= SB && STAGES >= 2,
                "the head's h2 and weights fit a ring stage each");
};

// Input channels [k*CK, k*CK + CK) of the tile, with every part a multiple
// of 4 channels and 16-byte aligned (`vec`): into registers, as float4
// groups, zero outside the image (conv1's padding) and beyond the last
// channel. Stored later, rounded to bf16, by store_input.
template <class C>
__device__ __forceinline__ void load_input(float4 (&buf)[C::LV], const Args& a,
                                           int n, int y0, int x0, int k,
                                           int cin) {
#pragma unroll
  for (int i = 0; i < C::LV; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int p = idx / (CK / 4), c4 = (idx % (CK / 4)) * 4;
    const int gy = y0 - 2 + p / C::IW, gx = x0 - 2 + p % C::IW;
    const int cc = k * CK + c4;
    buf[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (idx < C::NG && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && cc < cin) {
      const size_t pix = ((size_t)n * a.H + gy) * a.W + gx;
      buf[i] = __ldg(reinterpret_cast<const float4*>(channel_ptr(a, pix, cc)));
    }
  }
}

template <class C>
__device__ __forceinline__ void store_input(bf16* xs, const float4 (&buf)[C::LV]) {
#pragma unroll
  for (int i = 0; i < C::LV; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (idx >= C::NG) break;
    const int p = idx / (CK / 4), c4 = (idx % (CK / 4)) * 4;
    *reinterpret_cast<uint2*>(xs + p * XS + c4) =
        make_uint2(pack_bf16(buf[i].x, buf[i].y), pack_bf16(buf[i].z, buf[i].w));
  }
}

// The same for any channel counts and alignments, one element at a time,
// loaded and stored in one go (no prefetch).
template <class C>
__device__ __forceinline__ void stage_input_scalar(bf16* xs, const Args& a,
                                                   int n, int y0, int x0,
                                                   int k, int cin) {
#pragma unroll 1
  for (int e = threadIdx.x; e < C::NG * 4; e += THREADS) {
    const int p = e / CK, c = e % CK;
    const int gy = y0 - 2 + p / C::IW, gx = x0 - 2 + p % C::IW;
    const int cc = k * CK + c;
    float v = 0.f;
    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && cc < cin)
      v = __ldg(channel_ptr(a, ((size_t)n * a.H + gy) * a.W + gx, cc));
    xs[p * XS + c] = __float2bfloat16(v);
  }
}

// Weight chunk q of the stream (conv1's chunks, then conv2's) into ring
// stage `dst`: rows x 9 x 16 bf16, one straight run of 16-byte cp.async
// copies; then commit a group (empty past the last chunk, so every thread
// counts the same groups).
template <int CMP, int COP>
__device__ __forceinline__ void issue_weights(bf16* dst, const Args& a, int q,
                                              int total) {
  if (q < total) {
    const bool c1 = q < a.nck1;
    const int vecs = (c1 ? CMP : COP) * WROW / 8;
    const bf16* src = c1 ? a.w1 + (size_t)q * CMP * WROW
                         : a.w2 + (size_t)(q - a.nck1) * COP * WROW;
    const uint32_t base = smem_addr(dst);
#pragma unroll 1
    for (int i = threadIdx.x; i < vecs; i += THREADS)
      cp_async16(base + i * 16, src + i * 8);
  }
  cp_async_commit();
}

// The weight chunk in shared memory, as prepared: for each tap a [ROWS x
// 16] block of 8 x 8 core matrices, core (n / 8, k / 8) at byte
// (n / 8) * 256 + (k / 8) * 128, its 8 rows 16 bytes apart. That is
// wgmma's K-major layout without swizzle (LBO 128 bytes between the two k
// halves, SBO 256 between 8-row groups of N), and 8 rows of one core are
// one conflict-free ldmatrix phase.
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// One chunk, 9 taps, on wgmma: G m64 tiles of this warpgroup, N columns
// (the warpgroup's half) from b_tap0 (shared address of its first n-group
// in tap 0). A comes from registers (ldmatrix at a_base[i] + the tap's
// shift), in three buffers used in turn (tap % 3: the same in every chunk,
// as 9 taps fill 3 rounds), so that up to two taps' products are in flight
// while the next tap's fragments load. Returns with at most the last two
// taps' products in flight. A's row stride is ASTR x `astr` bf16 (`astr`
// for strides known only at run time).
template <int G, int N, int ROWW, int ASTR, int TAPB>
__device__ __forceinline__ void chunk_wgmma(float (&acc)[G][N / 2],
                                            uint32_t (&af)[3][G][4],
                                            const uint32_t (&a_base)[G],
                                            uint32_t b_tap0, int astr = 1) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int aoff = ((tap / 3) * ROWW + tap % 3) * ASTR * astr * 2;
    uint32_t (&ab)[G][4] = af[tap % 3];
    wgmma_wait<2>();  // the products that read `ab` three taps ago are done
#pragma unroll
    for (int i = 0; i < G; ++i) ldmatrix_x4(ab[i], a_base[i] + aoff);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < G; ++i) wgmma_rs<N>(acc[i], ab[i], b_desc(b_tap0 + tap * TAPB));
    wgmma_commit();
  }
}

template <int G, int N>
__device__ __forceinline__ void wgmma_drain(float (&acc)[G][N / 2]) {
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < G; ++i) fence_regs<N / 2>(acc[i]);
}

template <int TH, int TW, int CMP, int COP, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
packed_double_conv_kernel(const __grid_constant__ Args a) {
  using C = Cfg<TH, TW, CMP, COP, STAGES>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // 2 x [IH*IW][XS]
  bf16* ring = xs + 2 * C::XT;                   // STAGES x SB
  bf16* hs = ring + STAGES * C::SB;              // [M1][HSTR]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int cin = a.c[0] + a.c[1] + a.c[2];
  const int total = a.nck1 + CMP / CK;
  // ldmatrix lanes: A row (lane & 7) + 8 ((lane >> 3) & 1), channel half
  // lane >> 4. Warpgroup wg takes half of N; its warp wl rows 16 wl .. of
  // each m64 tile, and the sums of rows g, g + 8 of those, columns 2t, 2t + 1
  // of each n8 block.
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, ahalf = lane >> 4;
  const int wg = warp >> 2, wl = warp & 3;

  // Weight chunk q + D is issued while chunk q is multiplied, into the
  // stage of chunk q - 2, whose products all finished before any warp
  // passed tap 2 of chunk q - 1, so before the barrier of chunk q.
  constexpr int D = STAGES - 2;
#pragma unroll
  for (int s = 0; s < D; ++s) issue_weights<CMP, COP>(ring + s * C::SB, a, s, total);
  float4 buf[C::LV];
  if (a.vec) {
    load_input<C>(buf, a, n, y0, x0, 0, cin);
    store_input<C>(xs, buf);
  } else {
    stage_input_scalar<C>(xs, a, n, y0, x0, 0, cin);
  }

  // ---- conv1: [M1 rows] x [9 * cin] x [CMP] ------------------------------
  // Row r of the intermediate tile is pixel (r / MW, r % MW); its tap (0, 0)
  // is input pixel (r / MW) * IW + r % MW.
  int pa[C::G1];
#pragma unroll
  for (int i = 0; i < C::G1; ++i) {
    const int r = i * 64 + wl * 16 + arow;
    pa[i] = r < C::M1 ? (r / C::MW) * C::IW + r % C::MW : 0;
  }
  float acc1[C::G1][C::N1 / 2];
#pragma unroll
  for (int i = 0; i < C::G1; ++i)
#pragma unroll
    for (int e = 0; e < C::N1 / 2; ++e) acc1[i][e] = 0.f;
  uint32_t af1[3][C::G1][4];  // A fragments, three buffers
#pragma unroll 1
  for (int k = 0; k < a.nck1; ++k) {
    cp_async_wait<D - 1>();  // this thread's copies of chunk k landed
    fence_proxy_async();     // ... and are visible to wgmma
    __syncthreads();  // everyone's; the readers of xs[(k + 1) & 1] are done
    issue_weights<CMP, COP>(ring + ((k + D) % STAGES) * C::SB, a, k + D, total);
    const bool more = k + 1 < a.nck1;
    if (more && a.vec) load_input<C>(buf, a, n, y0, x0, k + 1, cin);
    const bf16* xk = xs + (k & 1) * C::XT;
    uint32_t a_base[C::G1];
#pragma unroll
    for (int i = 0; i < C::G1; ++i) a_base[i] = smem_addr(xk + pa[i] * XS + ahalf * 8);
    const uint32_t wk = smem_addr(ring + (k % STAGES) * C::SB) + wg * (C::N1 / 8) * 256;
    chunk_wgmma<C::G1, C::N1, C::IW, XS, CMP * 32>(acc1, af1, a_base, wk);
    bf16* xnext = xs + ((k + 1) & 1) * C::XT;
    if (more && a.vec) store_input<C>(xnext, buf);
    if (more && !a.vec) stage_input_scalar<C>(xnext, a, n, y0, x0, k + 1, cin);
  }
  wgmma_drain<C::G1, C::N1>(acc1);

  // bias + PReLU, rounded to bf16; zero outside the image (conv2's padding)
  const float slope = a.slope != nullptr ? __ldg(a.slope) : 0.f;
#pragma unroll
  for (int i = 0; i < C::G1; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * 64 + wl * 16 + g + 8 * h;
      if (r >= C::M1) continue;
      const int gy = y0 - 1 + r / C::MW, gx = x0 - 1 + r % C::MW;
      const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
      for (int j = 0; j < C::N1 / 8; ++j) {
        const int c = wg * C::N1 + j * 8 + 2 * t;
        float v0 = 0.f, v1 = 0.f;
        if (inside) {
          v0 = acc1[i][4 * j + 2 * h] + (c < a.cm ? __ldg(a.b1 + c) : 0.f);
          v1 = acc1[i][4 * j + 2 * h + 1] + (c + 1 < a.cm ? __ldg(a.b1 + c + 1) : 0.f);
          v0 = prelu(v0, slope);
          v1 = prelu(v1, slope);
        }
        *reinterpret_cast<uint32_t*>(hs + r * C::HSTR + c) = pack_bf16(v0, v1);
      }
    }

  // ---- conv2: [M2 output pixels] x [9 * CMP] x [COP] ---------------------
  // Output row r is pixel (r / TW, r % TW); its tap (0, 0) is intermediate
  // pixel (r / TW) * MW + r % TW.
  const int t2 = C::SPLIT2 ? wg * C::T2 : 0;  // this warpgroup's first m64
  const int ncol2 = C::SPLIT2 ? 0 : wg;        // and block of N2 columns
  int ph[C::T2];
#pragma unroll
  for (int i = 0; i < C::T2; ++i) {
    const int r = (t2 + i) * 64 + wl * 16 + arow;
    ph[i] = r < C::M2 ? (r / TW) * C::MW + r % TW : 0;
  }
  float acc2[C::T2][C::N2 / 2];
#pragma unroll
  for (int i = 0; i < C::T2; ++i)
#pragma unroll
    for (int e = 0; e < C::N2 / 2; ++e) acc2[i][e] = 0.f;
  uint32_t af2[3][C::T2][4];
#pragma unroll 1
  for (int k2 = 0; k2 < CMP / CK; ++k2) {
    const int q = a.nck1 + k2;
    cp_async_wait<D - 1>();
    fence_proxy_async();
    __syncthreads();  // also: the intermediate is written
    issue_weights<CMP, COP>(ring + ((q + D) % STAGES) * C::SB, a, q + D, total);
    uint32_t a_base[C::T2];
#pragma unroll
    for (int i = 0; i < C::T2; ++i)
      a_base[i] = smem_addr(hs + ph[i] * C::HSTR + k2 * CK + ahalf * 8);
    const uint32_t wk = smem_addr(ring + (q % STAGES) * C::SB) + ncol2 * (C::N2 / 8) * 256;
    chunk_wgmma<C::T2, C::N2, C::MW, C::HSTR, COP * 32>(acc2, af2, a_base, wk);
  }
  wgmma_drain<C::T2, C::N2>(acc2);

  if (a.w3 == nullptr) {  // conv2 + bias is the output
#pragma unroll
    for (int i = 0; i < C::T2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (t2 + i) * 64 + wl * 16 + g + 8 * h;
        const int gy = y0 + r / TW, gx = x0 + r % TW;
        if (r >= C::M2 || gy >= a.H || gx >= a.W) continue;
        float* op = a.out + (((size_t)n * a.H + gy) * a.W + gx) * a.co;
#pragma unroll
        for (int j = 0; j < C::N2 / 8; ++j) {
          const int c = ncol2 * C::N2 + j * 8 + 2 * t;
          if (c < a.co) op[c] = acc2[i][4 * j + 2 * h] + __ldg(a.b2 + c);
          if (c + 1 < a.co) op[c + 1] = acc2[i][4 * j + 2 * h + 1] + __ldg(a.b2 + c + 1);
        }
      }
    return;
  }

  // ---- the 1x1 head: bf16(h2 + b2) [M2] x [COP] x [cep] ------------------
  cp_async_wait<0>();
  __syncthreads();  // every warp's reads of the ring are done
  bf16* h2s = ring;          // [M2][COP + 8]
  bf16* w3s = ring + C::SB;  // [cep][COP + 8]
#pragma unroll
  for (int i = 0; i < C::T2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (t2 + i) * 64 + wl * 16 + g + 8 * h;
      if (r >= C::M2) continue;
#pragma unroll
      for (int j = 0; j < C::N2 / 8; ++j) {
        const int c = ncol2 * C::N2 + j * 8 + 2 * t;
        const float v0 = c < a.co ? acc2[i][4 * j + 2 * h] + __ldg(a.b2 + c) : 0.f;
        const float v1 = c + 1 < a.co ? acc2[i][4 * j + 2 * h + 1] + __ldg(a.b2 + c + 1) : 0.f;
        *reinterpret_cast<uint32_t*>(h2s + r * (COP + 8) + c) = pack_bf16(v0, v1);
      }
    }
  {
    const uint4* s = reinterpret_cast<const uint4*>(a.w3);
    for (int i = threadIdx.x; i < a.cep * (COP / 8); i += THREADS) {
      const int r = i / (COP / 8), v = i % (COP / 8);
      reinterpret_cast<uint4*>(w3s + r * (COP + 8))[v] = s[i];
    }
  }
  __syncthreads();
  // the head's products on mma.sync: M2 rows as WM2 x MPW2 m16 tiles
  const int hm = warp % C::WM2, hn = warp / C::WM2;
  for (int nt = hn; nt < a.cep / 8; nt += C::WN2) {
    float acc3[C::MPW2][4];
#pragma unroll
    for (int i = 0; i < C::MPW2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc3[i][e] = 0.f;
    const bf16* wp0 = w3s + (nt * 8 + g) * (COP + 8) + 2 * t;
#pragma unroll
    for (int ks = 0; ks < COP / 16; ++ks) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wp0 + ks * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wp0 + ks * 16 + 8);
#pragma unroll
      for (int i = 0; i < C::MPW2; ++i) {
        uint32_t af[4];
        ldmatrix_x4(af, smem_addr(h2s + ((hm * C::MPW2 + i) * 16 + arow) * (COP + 8) +
                                  ks * 16 + ahalf * 8));
        mma16816(acc3[i], af, b0, b1);
      }
    }
    const int e = nt * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < C::MPW2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (hm * C::MPW2 + i) * 16 + g + 8 * h;
        const int gy = y0 + r / TW, gx = x0 + r % TW;
        if (gy >= a.H || gx >= a.W) continue;
        float* op = a.out + (((size_t)n * a.H + gy) * a.W + gx) * a.ce;
        if (e < a.ce) op[e] = acc3[i][2 * h] + __ldg(a.b3 + e);
        if (e + 1 < a.ce) op[e + 1] = acc3[i][2 * h + 1] + __ldg(a.b3 + e + 1);
      }
  }
}

template <int TH, int TW, int CMP, int COP, int STAGES>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<TH, TW, CMP, COP, STAGES>;
  auto kernel = packed_double_conv_kernel<TH, TW, CMP, COP, STAGES>;
  // Raise the instance's shared-memory limit once for each device, so no
  // attribute call falls inside a CUDA-graph capture after the first launch.
  static unsigned long long devices_done = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!((devices_done >> device) & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::BYTES);
    if (err != cudaSuccess) return err;
    devices_done |= 1ull << device;
  }
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, B);
  kernel<<<grid, THREADS, C::BYTES, stream>>>(a);
  return cudaGetLastError();
}

// The output tiles (ops/packed_double_conv.TILES), largest first: 0 is
// 8 x 16, 1 is 8 x 8 (the cluster instance only), 2 is 4 x 8; RING weight
// stages each. TILE_H: their heights.
constexpr int RING = 4;
constexpr int TILE_H[3] = {8, 8, 4};

template <int CMP, int COP>
cudaError_t launch_tile(const Args& a, int B, int tile, cudaStream_t s) {
  if (tile == 0) return launch<8, 16, CMP, COP, RING>(a, B, s);
  return launch<4, 8, CMP, COP, RING>(a, B, s);
}

bool valid_pad(int padded, int c) {
  return (padded == 32 || padded == 128) && c > 0 && c <= padded;
}

// ---- the cluster instance: mid, out or head widths above 128 ---------------
// One thread-block cluster of NS = max(cmp, cop) / SW CTAs computes one
// output tile. CTA r is the 128-wide instance above at CMP = COP = SW for
// slice r of N (same chunks, ring, wgmma shapes and epilogues):
//   conv1: mid channels [r SW, r SW + SW) from w1's slice r, over input
//     chunks it streams once, into its own mid slice in shared memory;
//   barrier.cluster: every mid slice is written;
//   conv2: out channels [r SW, r SW + SW) from w2's slice r, over every
//     mid chunk: its own slice's first, from local shared memory, then the
//     peers' slices in turn, each 16-channel chunk copied from the peer's
//     shared memory (mapa + ld.shared::cluster) into one of two local
//     buffers (the input buffers, free after conv1) one chunk ahead of the
//     wgmma; the cluster barrier is waited for only before the first
//     peer's chunk, so the own chunks cover the CTAs' skew;
//   the head, where there is one: bf16(h2 + b2) of each out slice into its
//     CTA's ring (free after conv2), barrier.cluster, every peer's slice
//     copied into the same place of the local ring, and CTA r takes head
//     columns n8 tile rank * WN2 + hn, + NS * WN2, ... over all slices
//     (mma.sync, w3 from L2), one n8 tile at a time at any head width;
//   a last barrier.cluster before any CTA exits, as peers read its shared
//     memory until then.
// A CTA past the mid slices (cmp < cop) skips conv1, one past the out
// slices (cop < cmp) conv2; both take part in every barrier.
// The weights come slice-major: w1 as [cmp / SW][nck1][9][SW / 8][2][8][8],
// w2 as [cop / SW][cmp / CK][9][SW / 8][2][8][8], so CTA r's chunks are one
// contiguous run of each. Shared memory is the 128-wide instance's at any
// width (the mid tile holds one slice), 219,456 B at 8 x 16.
constexpr int SW = 128;           // N columns of one CTA: one slice
constexpr int CPS = SW / CK;      // mid chunks a slice
constexpr int MAX_WIDE = 512;
constexpr int MAX_CLUSTER = MAX_WIDE / SW;

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// barrier.cluster: arrive releases this thread's writes to the cluster,
// wait acquires those of every thread that arrived; every thread of every
// CTA of the cluster takes part, in the same order.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The address of the same shared-memory byte in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t saddr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(saddr), "r"(rank));
  return r;
}

__device__ __forceinline__ uint4 ld_peer(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// Conv2's mid slice at step j of a CTA whose first is `first`: the slices
// in turn, CPS chunks each.
__device__ __forceinline__ int mid_slice(int j, int first, int ns1) {
  return (first + j / CPS) % ns1;
}

// Chunk q of a CTA's weight stream (its nq1 conv1 chunks from w1s, then
// conv2's from w2s in mid_slice order), SW rows each, into ring stage `dst`;
// then commit a group (empty past the last chunk).
__device__ __forceinline__ void issue_slice_weights(bf16* dst, const bf16* w1s,
                                                    const bf16* w2s, int q, int nq1,
                                                    int total, int first, int ns1) {
  if (q < total) {
    const int j = q - nq1;
    const bf16* src = q < nq1 ? w1s + (size_t)q * SW * WROW
                              : w2s + (size_t)(mid_slice(j, first, ns1) * CPS + j % CPS) *
                                          SW * WROW;
    const uint32_t base = smem_addr(dst);
#pragma unroll 1
    for (int i = threadIdx.x; i < SW * WROW / 8; i += THREADS)
      cp_async16(base + i * 16, src + i * 8);
  }
  cp_async_commit();
}

// Mid chunk c (16 channels) of the M1 pixels of CTA `rank`'s mid slice
// (local address `hs` mapped to that CTA), two 16-byte halves a pixel, into
// registers; store_peer_chunk puts them into a local buffer of stride XS.
template <int LP, int M1, int HSTR>
__device__ __forceinline__ void load_peer_chunk(uint4 (&v)[LP], uint32_t hs, int rank,
                                                int c) {
#pragma unroll
  for (int i = 0; i < LP; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (idx < M1 * 2)
      v[i] = ld_peer(peer_addr(hs + ((idx >> 1) * HSTR + c * CK + (idx & 1) * 8) * 2, rank));
  }
}

template <int LP, int M1>
__device__ __forceinline__ void store_peer_chunk(bf16* buf, const uint4 (&v)[LP]) {
#pragma unroll
  for (int i = 0; i < LP; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (idx < M1 * 2) *reinterpret_cast<uint4*>(buf + (idx >> 1) * XS + (idx & 1) * 8) = v[i];
  }
}

template <int TH, int TW, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
cluster_double_conv_kernel(const __grid_constant__ Args a, int cmp, int cop) {
  using C = Cfg<TH, TW, SW, SW, STAGES>;
  constexpr int PB = C::M1 * XS;                         // one peer chunk buffer
  constexpr int LP = (C::M1 * 2 + THREADS - 1) / THREADS;  // its 16-byte loads a thread
  constexpr int H2STR = SW + 8, H2S = C::M2 * H2STR;     // one h2 slice
  static_assert(PB <= C::XT, "two peer chunks fit the input buffers");
  static_assert(MAX_CLUSTER * H2S <= STAGES * C::SB, "every h2 slice fits the ring");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // 2 x [IH*IW][XS]; conv2: 2 x [M1][XS]
  bf16* ring = xs + 2 * C::XT;                   // STAGES x SB; the head: [ns2][M2][H2STR]
  bf16* hs = ring + STAGES * C::SB;              // [M1][HSTR]: this CTA's mid slice

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ns1 = cmp / SW, ns2 = cop / SW, ns = ns1 > ns2 ? ns1 : ns2;
  const int rank = cluster_rank();
  const int n = blockIdx.z, y0 = blockIdx.y * TH, x0 = (blockIdx.x / ns) * TW;
  const int cin = a.c[0] + a.c[1] + a.c[2];
  const int nck2 = cmp / CK;
  const bool has1 = rank < ns1, has2 = rank < ns2;  // a mid slice, an out slice
  const int nq1 = has1 ? a.nck1 : 0, total = nq1 + (has2 ? nck2 : 0);
  const int first = has1 ? rank : rank % ns1;  // conv2's first mid slice
  const bf16* w1s = a.w1 + (size_t)rank * a.nck1 * SW * WROW;
  const bf16* w2s = a.w2 + (size_t)rank * nck2 * SW * WROW;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, ahalf = lane >> 4;
  const int wg = warp >> 2, wl = warp & 3;

  constexpr int D = STAGES - 2;
#pragma unroll
  for (int s = 0; s < D; ++s)
    issue_slice_weights(ring + s * C::SB, w1s, w2s, s, nq1, total, first, ns1);

  // ---- conv1: this CTA's SW mid channels, as the 128-wide instance --------
  if (has1) {
    float4 buf[C::LV];
    if (a.vec) {
      load_input<C>(buf, a, n, y0, x0, 0, cin);
      store_input<C>(xs, buf);
    } else {
      stage_input_scalar<C>(xs, a, n, y0, x0, 0, cin);
    }
    int pa[C::G1];
#pragma unroll
    for (int i = 0; i < C::G1; ++i) {
      const int r = i * 64 + wl * 16 + arow;
      pa[i] = r < C::M1 ? (r / C::MW) * C::IW + r % C::MW : 0;
    }
    float acc1[C::G1][C::N1 / 2];
#pragma unroll
    for (int i = 0; i < C::G1; ++i)
#pragma unroll
      for (int e = 0; e < C::N1 / 2; ++e) acc1[i][e] = 0.f;
    uint32_t af1[3][C::G1][4];
#pragma unroll 1
    for (int k = 0; k < a.nck1; ++k) {
      cp_async_wait<D - 1>();
      fence_proxy_async();
      __syncthreads();
      issue_slice_weights(ring + ((k + D) % STAGES) * C::SB, w1s, w2s, k + D, nq1, total,
                          first, ns1);
      const bool more = k + 1 < a.nck1;
      if (more && a.vec) load_input<C>(buf, a, n, y0, x0, k + 1, cin);
      const bf16* xk = xs + (k & 1) * C::XT;
      uint32_t a_base[C::G1];
#pragma unroll
      for (int i = 0; i < C::G1; ++i) a_base[i] = smem_addr(xk + pa[i] * XS + ahalf * 8);
      const uint32_t wk = smem_addr(ring + (k % STAGES) * C::SB) + wg * (C::N1 / 8) * 256;
      chunk_wgmma<C::G1, C::N1, C::IW, XS, SW * 32>(acc1, af1, a_base, wk);
      bf16* xnext = xs + ((k + 1) & 1) * C::XT;
      if (more && a.vec) store_input<C>(xnext, buf);
      if (more && !a.vec) stage_input_scalar<C>(xnext, a, n, y0, x0, k + 1, cin);
    }
    wgmma_drain<C::G1, C::N1>(acc1);

    // bias + PReLU, rounded to bf16; zero outside the image (conv2's padding)
    const float slope = a.slope != nullptr ? __ldg(a.slope) : 0.f;
#pragma unroll
    for (int i = 0; i < C::G1; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = i * 64 + wl * 16 + g + 8 * h;
        if (r >= C::M1) continue;
        const int gy = y0 - 1 + r / C::MW, gx = x0 - 1 + r % C::MW;
        const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
        for (int j = 0; j < C::N1 / 8; ++j) {
          const int c = wg * C::N1 + j * 8 + 2 * t, cmid = rank * SW + c;
          float v0 = 0.f, v1 = 0.f;
          if (inside) {
            v0 = acc1[i][4 * j + 2 * h] + (cmid < a.cm ? __ldg(a.b1 + cmid) : 0.f);
            v1 = acc1[i][4 * j + 2 * h + 1] + (cmid + 1 < a.cm ? __ldg(a.b1 + cmid + 1) : 0.f);
            v0 = prelu(v0, slope);
            v1 = prelu(v1, slope);
          }
          *reinterpret_cast<uint32_t*>(hs + r * C::HSTR + c) = pack_bf16(v0, v1);
        }
      }
  }
  cluster_arrive();  // this CTA's mid slice is written

  // ---- conv2: this CTA's SW out channels over every mid slice -------------
  const int t2 = C::SPLIT2 ? wg * C::T2 : 0;  // this warpgroup's first m64
  const int ncol2 = C::SPLIT2 ? 0 : wg;        // and block of N2 columns
  float acc2[C::T2][C::N2 / 2];
  bool waited = false;  // for the mid slices to be written
  if (has2) {
    int ph[C::T2];
#pragma unroll
    for (int i = 0; i < C::T2; ++i) {
      const int r = (t2 + i) * 64 + wl * 16 + arow;
      ph[i] = r < C::M2 ? (r / TW) * C::MW + r % TW : 0;
    }
#pragma unroll
    for (int i = 0; i < C::T2; ++i)
#pragma unroll
      for (int e = 0; e < C::N2 / 2; ++e) acc2[i][e] = 0.f;
    uint32_t af2[3][C::T2][4];
    uint4 pv[LP];
    const uint32_t hs_addr = smem_addr(hs);
    if (first != rank) {  // no mid slice of its own: a peer's chunk first
      cluster_wait();
      waited = true;
      load_peer_chunk<LP, C::M1, C::HSTR>(pv, hs_addr, first, 0);
      store_peer_chunk<LP, C::M1>(xs, pv);
    }
#pragma unroll 1
    for (int j = 0; j < nck2; ++j) {
      const int q = nq1 + j;
      cp_async_wait<D - 1>();
      fence_proxy_async();
      __syncthreads();  // also: the mid slice and chunk j's peer buffer are written
      issue_slice_weights(ring + ((q + D) % STAGES) * C::SB, w1s, w2s, q + D, nq1, total,
                          first, ns1);
      const int s = mid_slice(j, first, ns1), c = j % CPS;
      const int sn = mid_slice(j + 1, first, ns1);
      const bool fetch = j + 1 < nck2 && sn != rank;
      if (fetch) {
        if (!waited) {
          cluster_wait();
          waited = true;
        }
        load_peer_chunk<LP, C::M1, C::HSTR>(pv, hs_addr, sn, (j + 1) % CPS);
      }
      uint32_t a_base[C::T2];
      int astr = XS;
      if (s == rank) {
        astr = C::HSTR;
#pragma unroll
        for (int i = 0; i < C::T2; ++i)
          a_base[i] = smem_addr(hs + ph[i] * C::HSTR + c * CK + ahalf * 8);
      } else {
        const bf16* pb = xs + (j & 1) * PB;
#pragma unroll
        for (int i = 0; i < C::T2; ++i) a_base[i] = smem_addr(pb + ph[i] * XS + ahalf * 8);
      }
      const uint32_t wk = smem_addr(ring + (q % STAGES) * C::SB) + ncol2 * (C::N2 / 8) * 256;
      chunk_wgmma<C::T2, C::N2, C::MW, 1, SW * 32>(acc2, af2, a_base, wk, astr);
      if (fetch) store_peer_chunk<LP, C::M1>(xs + ((j + 1) & 1) * PB, pv);
    }
    wgmma_drain<C::T2, C::N2>(acc2);
  }
  if (!waited) cluster_wait();

  if (a.w3 == nullptr) {  // conv2 + bias is the output
    cluster_arrive();  // done reading the peers' mid slices
    if (has2) {
#pragma unroll
      for (int i = 0; i < C::T2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (t2 + i) * 64 + wl * 16 + g + 8 * h;
          const int gy = y0 + r / TW, gx = x0 + r % TW;
          if (r >= C::M2 || gy >= a.H || gx >= a.W) continue;
          float* op = a.out + (((size_t)n * a.H + gy) * a.W + gx) * a.co;
#pragma unroll
          for (int j = 0; j < C::N2 / 8; ++j) {
            const int c = rank * SW + ncol2 * C::N2 + j * 8 + 2 * t;
            if (c < a.co) op[c] = acc2[i][4 * j + 2 * h] + __ldg(a.b2 + c);
            if (c + 1 < a.co) op[c + 1] = acc2[i][4 * j + 2 * h + 1] + __ldg(a.b2 + c + 1);
          }
        }
    }
    cluster_wait();  // ... and so are the peers, before this CTA's shared memory goes
    return;
  }

  // ---- the 1x1 head: bf16(h2 + b2) [M2] x [cop] x [cep] ------------------
  cp_async_wait<0>();
  __syncthreads();   // every warp's reads of the ring are done
  bf16* h2s = ring;  // out slice s at h2s + s * H2S, in every CTA
  if (has2) {
#pragma unroll
    for (int i = 0; i < C::T2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (t2 + i) * 64 + wl * 16 + g + 8 * h;
        if (r >= C::M2) continue;
#pragma unroll
        for (int j = 0; j < C::N2 / 8; ++j) {
          const int cl = ncol2 * C::N2 + j * 8 + 2 * t, c = rank * SW + cl;
          const float v0 = c < a.co ? acc2[i][4 * j + 2 * h] + __ldg(a.b2 + c) : 0.f;
          const float v1 = c + 1 < a.co ? acc2[i][4 * j + 2 * h + 1] + __ldg(a.b2 + c + 1) : 0.f;
          *reinterpret_cast<uint32_t*>(h2s + rank * H2S + r * H2STR + cl) = pack_bf16(v0, v1);
        }
      }
  }
  cluster_arrive();
  cluster_wait();  // every out slice's h2 is written; every mid slice read
  for (int s = 0; s < ns2; ++s) {
    if (s == rank) continue;
#pragma unroll 4
    for (int i = threadIdx.x; i < C::M2 * (SW / 8); i += THREADS) {
      bf16* dst = h2s + s * H2S + (i / (SW / 8)) * H2STR + (i % (SW / 8)) * 8;
      *reinterpret_cast<uint4*>(dst) = ld_peer(peer_addr(smem_addr(dst), s));
    }
  }
  cluster_arrive();  // done reading the peers' h2
  __syncthreads();   // the copies are visible to every warp
  // the head's products on mma.sync: M2 rows as WM2 x MPW2 m16 tiles; this
  // CTA's n8 tiles of the head, one at a time, over all cop channels
  const int hm = warp % C::WM2, hn = warp / C::WM2;
#pragma unroll 1
  for (int nt = rank * C::WN2 + hn; nt < a.cep / 8; nt += ns * C::WN2) {
    float acc3[C::MPW2][4];
#pragma unroll
    for (int i = 0; i < C::MPW2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc3[i][e] = 0.f;
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(a.w3 + (size_t)(nt * 8 + g) * cop + 2 * t);
#pragma unroll 4
    for (int ks = 0; ks < cop / 16; ++ks) {
      const uint32_t b0 = __ldg(wp + ks * 8), b1 = __ldg(wp + ks * 8 + 4);
      const bf16* h2k = h2s + (ks / CPS) * H2S + (ks % CPS) * 16 + ahalf * 8;
#pragma unroll
      for (int i = 0; i < C::MPW2; ++i) {
        uint32_t af[4];
        ldmatrix_x4(af, smem_addr(h2k + ((hm * C::MPW2 + i) * 16 + arow) * H2STR));
        mma16816(acc3[i], af, b0, b1);
      }
    }
    const int e = nt * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < C::MPW2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (hm * C::MPW2 + i) * 16 + g + 8 * h;
        const int gy = y0 + r / TW, gx = x0 + r % TW;
        if (gy >= a.H || gx >= a.W) continue;
        float* op = a.out + (((size_t)n * a.H + gy) * a.W + gx) * a.ce;
        if (e < a.ce) op[e] = acc3[i][2 * h] + __ldg(a.b3 + e);
        if (e + 1 < a.ce) op[e + 1] = acc3[i][2 * h + 1] + __ldg(a.b3 + e + 1);
      }
  }
  cluster_wait();  // the peers are done reading this CTA's h2
}

// The launch of one cluster instance: ns CTAs a cluster along x, on a grid
// of ns x (tiles along x) by tiles along y by B. Once for each cluster size
// on each device, before its first launch (so no such call falls inside a
// CUDA-graph capture after it): raises the instance's shared-memory limit
// and checks that the card holds at least one of its clusters
// (cudaOccupancyMaxActiveClusters), or fails, and the wrapper raises;
// nothing falls back to another instance.
template <int TH, int TW>
cudaError_t launch_cluster(const Args& a, int B, int cmp, int cop, cudaStream_t stream) {
  using C = Cfg<TH, TW, SW, SW, RING>;
  const int ns = (cmp > cop ? cmp : cop) / SW;
  static unsigned long long ready[MAX_CLUSTER + 1] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ns);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::BYTES;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!((ready[ns] >> device) & 1ull)) {
    err = cudaFuncSetAttribute(cluster_double_conv_kernel<TH, TW, RING>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::BYTES);
    if (err != cudaSuccess) return err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, cluster_double_conv_kernel<TH, TW, RING>,
                                         &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    ready[ns] |= 1ull << device;
  }
  cfg.gridDim = dim3((a.W + TW - 1) / TW * ns, (a.H + TH - 1) / TH, B);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, cluster_double_conv_kernel<TH, TW, RING>, a, cmp, cop);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool valid_wide(int padded, int c) {
  return padded % SW == 0 && padded <= MAX_WIDE && c > 0 && c <= padded;
}

}  // namespace

// The dynamic shared memory of one instance, in bytes (tile as below), or
// -1 for widths or a tile it does not take.
extern "C" int hn_packed_double_conv_smem(int tile, int cmp, int cop) {
#define HN_SMEM(M, O)                                                    \
  if (cmp == M && cop == O && tile != 1)                                 \
    return tile == 0 ? (int)Cfg<8, 16, M, O, RING>::BYTES                \
                     : (int)Cfg<4, 8, M, O, RING>::BYTES;
  HN_SMEM(32, 32) HN_SMEM(32, 128) HN_SMEM(128, 32) HN_SMEM(128, 128)
#undef HN_SMEM
  if (!valid_wide(cmp, cmp) || !valid_wide(cop, cop)) return -1;
  if (tile == 0) return (int)Cfg<8, 16, SW, SW, RING>::BYTES;
  if (tile == 1) return (int)Cfg<8, 8, SW, SW, RING>::BYTES;
  if (tile == 2) return (int)Cfg<4, 8, SW, SW, RING>::BYTES;
  return -1;
}

// x0, x1, x2: [B, H, W, c0|c1|c2] f32 (x1 and x2 may be null with c = 0);
// w1: bf16 [ceil((c0+c1+c2)/16)][9][cmp/8][2][8][8] (chunk, tap, 8 x 8 core
//     matrix (n/8, k/8), n % 8, k % 8), the c1 weights of the
//     part-major channel concatenation; b1: [cm]; slope: [1] or null (ReLU);
// w2: bf16 [cmp/16][9][cop/8][2][8][8]; b2: [co];
// w3: bf16 [cep][cop] and b3: [ce] (the 1x1 head), or null with ce = 0;
// out: [B, H, W, ce] with the head, else [B, H, W, co]. f32 contiguous.
// cmp, cop: cm and co padded to 32 or 128, or, where cm, co or ce is above
// 128, each to a multiple of 128 up to 512 (the cluster instance; w1 and w2
// then slice-major, see above); cep: ce padded to 8.
// vec: every part's channel count is a multiple of 4 and its pointer 16-byte
// aligned (vector loads of the input). tile: 0 for 8 x 16 output tiles, 1
// for 8 x 8 (the cluster instance only), 2 for 4 x 8
// (ops/packed_double_conv.tile_for).
extern "C" int hn_packed_double_conv(
    const float* x0, int c0, const float* x1, int c1, const float* x2, int c2,
    const void* w1, const float* b1, const float* slope, const void* w2,
    const float* b2, const void* w3, const float* b3, float* out, int B,
    int H, int W, int cm, int co, int ce, int cmp, int cop, int cep, int vec,
    int tile, void* stream) {
  // the cluster instance takes any widths above 128 (as multiples of SW)
  const bool wide = cmp > MAX_WIDTH || cop > MAX_WIDTH || ce > MAX_WIDTH;
  const int tile_h = tile >= 0 && tile < 3 ? TILE_H[tile] : 1;
  const bool widths_ok =
      wide ? valid_wide(cmp, cm) && valid_wide(cop, co) && tile >= 0 && tile < 3
           : valid_pad(cmp, cm) && valid_pad(cop, co) && (tile == 0 || tile == 2);
  if (x0 == nullptr || c0 <= 0 || c1 < 0 || c2 < 0 ||
      (c1 > 0 && x1 == nullptr) || (c2 > 0 && (x2 == nullptr || c1 == 0)) ||
      w1 == nullptr || b1 == nullptr || w2 == nullptr || b2 == nullptr ||
      out == nullptr || !widths_ok || B <= 0 || B > 65535 || H <= 0 ||
      W <= 0 || (H + tile_h - 1) / tile_h > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (w3 == nullptr) {
    if (ce != 0 || cep != 0) return (int)cudaErrorInvalidValue;
  } else if (ce <= 0 || ce > (wide ? MAX_WIDE : MAX_WIDTH) ||
             cep != (ce + 7) / 8 * 8 || b3 == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.x[0] = x0;
  a.x[1] = x1;
  a.x[2] = x2;
  a.c[0] = c0;
  a.c[1] = c1;
  a.c[2] = c2;
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = b1;
  a.slope = slope;
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = b2;
  a.w3 = static_cast<const bf16*>(w3);
  a.b3 = b3;
  a.out = out;
  a.H = H;
  a.W = W;
  a.cm = cm;
  a.co = co;
  a.ce = ce;
  a.cep = cep;
  a.nck1 = (c0 + c1 + c2 + CK - 1) / CK;
  a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    if (tile == 0) return (int)launch_cluster<8, 16>(a, B, cmp, cop, s);
    if (tile == 1) return (int)launch_cluster<8, 8>(a, B, cmp, cop, s);
    return (int)launch_cluster<4, 8>(a, B, cmp, cop, s);
  }
  if (cmp == 32 && cop == 32) return (int)launch_tile<32, 32>(a, B, tile, s);
  if (cmp == 32 && cop == 128) return (int)launch_tile<32, 128>(a, B, tile, s);
  if (cmp == 128 && cop == 32) return (int)launch_tile<128, 32>(a, B, tile, s);
  return (int)launch_tile<128, 128>(a, B, tile, s);
}
