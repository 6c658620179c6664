// Packed fused DoubleConv for Hopper (sm_90a): conv3x3 (pad 1) -> PReLU ->
// conv3x3 (pad 1), optionally followed by a 1x1 conv (the UNet's outc head),
// on the wide channel-packed tensors of models/packed.py (g problems packed
// into the channel axis: 32 to 288 input channels, 32 or 128 mid and out
// channels at g = 16).
//
// Replaces the TPU kernel helmnet_tpu/ops/pallas_unet.py:175
// (fused_double_conv, body `_kernel` at :89, taps `_conv_taps` at :60). The
// TPU design flattens the plane to [H*W, C] rows, pads channels to 128
// lanes, rolls rows for each tap and tiles the plane to a VMEM budget; none
// of that is carried over. Here each block computes one 8x16 output tile of
// one sample as implicit GEMMs on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 sums): M = pixels, N = output channels, K = 9 taps x
// input channels.
//   1. conv1 over the 10x18 intermediate tile (the output tile and its
//      1-pixel ring). The input channels are streamed in chunks of 16: each
//      chunk stages its 12x20 input tile (2-pixel halo, rounded to bf16)
//      and its [cmid][9][16] weight slice in shared memory, then runs one
//      k16 step per tap. Up to three input parts (wavefield, residual and
//      sigma, or signal and state or skip) are read through separate
//      pointers in part-major channel order, so no concatenated copy is
//      written. The c1 weights (up to 576 KB in bf16 at g = 16) never fit
//      shared memory whole; one chunk is 39 KB.
//   2. bias + PReLU (ReLU without a slope), rounded to bf16 once and kept
//      in shared memory for all mid channels (49 KB at 128 channels).
//      Conv2's zero padding means the intermediate is ZERO outside the
//      image, not conv1 evaluated in the ring: the ring is masked on every
//      edge tile.
//   3. conv2 from that intermediate, its weights streamed in chunks of 16
//      mid channels the same way, + bias, written as NHWC f32; or, with the
//      head, rounded to bf16 and taken through the 1x1 (another mma pass).
// Precision follows the TPU kernel: x, h1 and h2 (before the head) are
// rounded to bf16 where they enter a product, weights are bf16, and sums,
// biases and PReLU are f32.
//
// What bounds it on this card: one packed step at 256^2, g = 16, does
// 178.9 GFLOP in its 14 calls and moves about 350 MB, so the function is
// bound by operations at the bf16 tensor-core rate (0.181 ms a step at
// 989 TFLOP/s, against 0.105 ms for the bytes at 3.35 TB/s). This first
// version uses warp-level mma.sync, loads fragments from shared memory with
// 32-bit loads (row strides padded so a warp's loads hit 32 distinct
// banks), and stages each chunk synchronously; wgmma, TMA and a pipelined
// ring of chunks are later work. The weights come prepared once per rollout
// as bf16 in the chunked layout above (ops/packed_double_conv.prepare), so
// staging a chunk is a straight 16-byte copy.
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

constexpr int TH = 8, TW = 16;          // output tile
constexpr int MH = TH + 2, MW = TW + 2; // intermediate tile (1-pixel ring)
constexpr int IH = TH + 4, IW = TW + 4; // input tile (2-pixel halo)
constexpr int M1 = MH * MW;             // 180 intermediate pixels
constexpr int M2 = TH * TW;             // 128 output pixels
constexpr int CK = 16;                  // channels per K chunk: one k16 step a tap
constexpr int XS = CK + 8;              // input tile row stride (bf16)
constexpr int WROW = 9 * CK;            // a weight row of one chunk (bf16)
constexpr int WS = WROW + 8;            // its shared-memory stride
constexpr int THREADS = 256;            // 8 warps: 4 along M x 2 along N
constexpr int MT1 = 3;                  // m16 tiles a warp in conv1 (4*3*16 >= 180)
constexpr int MT2 = 2;                  // m16 tiles a warp in conv2 (4*2*16 = 128)
constexpr int MAX_PARTS = 3;
constexpr int MAX_WIDTH = 128;          // mid, out and head channels

struct Args {
  const float* x[MAX_PARTS];  // [B, H, W, c[i]] f32
  int c[MAX_PARTS];
  const bf16* w1;     // [nck1][CMP][9][CK]
  const float* b1;    // [cm]
  const float* slope; // [1] or null (ReLU)
  const bf16* w2;     // [CMP / CK][COP][9][CK]
  const float* b2;    // [co]
  const bf16* w3;     // [cep][COP] or null
  const float* b3;    // [ce]
  float* out;         // [B, H, W, ce] with the head, else [B, H, W, co]
  int H, W, cm, co, ce, cep, nck1, vec;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

// rows x (8 * vecs) bf16, contiguous in device memory -> shared memory rows
// `stride` bf16 apart; 16-byte copies.
__device__ __forceinline__ void stage_rows(bf16* dst, int stride,
                                           const bf16* src, int rows,
                                           int vecs) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < rows * vecs; i += THREADS) {
    const int r = i / vecs, v = i % vecs;
    reinterpret_cast<uint4*>(dst + r * stride)[v] = s[i];
  }
}

__device__ __forceinline__ const float* channel_ptr(const Args& a, size_t pix,
                                                   int cc) {
  if (cc < a.c[0]) return a.x[0] + pix * a.c[0] + cc;
  cc -= a.c[0];
  if (cc < a.c[1]) return a.x[1] + pix * a.c[1] + cc;
  return a.x[2] + pix * a.c[2] + (cc - a.c[1]);
}

// Input channels [k*CK, k*CK + CK) of the 12x20 tile, rounded to bf16; zero
// outside the image (conv1's padding) and beyond the last channel.
__device__ __forceinline__ void stage_input(const Args& a, bf16* xs, int n,
                                            int y0, int x0, int k, int cin) {
  if (a.vec) {  // every part a multiple of 4 channels, 16-byte aligned
    for (int i = threadIdx.x; i < IH * IW * (CK / 4); i += THREADS) {
      const int p = i / (CK / 4), c4 = (i % (CK / 4)) * 4;
      const int gy = y0 - 2 + p / IW, gx = x0 - 2 + p % IW;
      const int cc = k * CK + c4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && cc < cin) {
        const size_t pix = ((size_t)n * a.H + gy) * a.W + gx;
        v = *reinterpret_cast<const float4*>(channel_ptr(a, pix, cc));
      }
      *reinterpret_cast<uint2*>(xs + p * XS + c4) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  } else {
    for (int i = threadIdx.x; i < IH * IW * CK; i += THREADS) {
      const int p = i / CK, c = i % CK;
      const int gy = y0 - 2 + p / IW, gx = x0 - 2 + p % IW;
      const int cc = k * CK + c;
      float v = 0.f;
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && cc < cin) {
        v = *channel_ptr(a, ((size_t)n * a.H + gy) * a.W + gx, cc);
      }
      xs[p * XS + c] = __float2bfloat16(v);
    }
  }
}

template <int CMP, int COP>
struct Smem {
  static constexpr int WB = (CMP > COP ? CMP : COP) * WS;   // weight chunk
  static constexpr int H2 = M2 * (COP + 8);                 // h2 before the head
  static constexpr int REGB = WB > H2 ? WB : H2;
  static constexpr int HS = M1 * (CMP + 8);                 // intermediate
  __host__ __device__ static int region_a(int cep) {  // input tile or head weights
    const int w3 = cep * (COP + 8);
    return w3 > IH * IW * XS ? w3 : IH * IW * XS;
  }
  __host__ __device__ static size_t bytes(int cep) {
    return (size_t)(region_a(cep) + REGB + HS) * sizeof(bf16);
  }
};

// CMP, COP: mid and out channels padded to 32 or 128 (zero weights in the
// padding). Each warp takes CMP/2 (conv1) or COP/2 (conv2) channels.
template <int CMP, int COP>
__global__ void __launch_bounds__(THREADS, 1)
packed_double_conv_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using S = Smem<CMP, COP>;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [IH*IW][XS]; later w3
  bf16* wb = xs + S::region_a(a.cep);            // [rows][WS]; later h2
  bf16* hs = wb + S::REGB;                       // [M1][CMP + 8]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int n = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int cin = a.c[0] + a.c[1] + a.c[2];

  // ---- conv1: [192 rows of the 10x18 tile] x [9 * cin] x [CMP] ----------
  constexpr int NT1 = CMP / 16;  // n8 tiles of this warp
  float acc1[MT1][NT1][4];
#pragma unroll
  for (int i = 0; i < MT1; ++i)
#pragma unroll
    for (int j = 0; j < NT1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][j][e] = 0.f;
  int pb[MT1][2];  // input tile pixel of tap (0, 0) for the two rows g, g+8
#pragma unroll
  for (int i = 0; i < MT1; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MT1 + i) * 16 + g + 8 * h;
      pb[i][h] = r < M1 ? (r / MW) * IW + r % MW : 0;  // rows >= 180: unused
    }
  const bf16* w1b = wb + (wn * (CMP / 2) + g) * WS + 2 * t;
  for (int k = 0; k < a.nck1; ++k) {
    __syncthreads();  // the last chunk's fragments are read
    stage_input(a, xs, n, y0, x0, k, cin);
    stage_rows(wb, WS, a.w1 + (size_t)k * CMP * WROW, CMP, WROW / 8);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * IW + tap % 3;
      uint32_t af[MT1][4];
#pragma unroll
      for (int i = 0; i < MT1; ++i) {
        const bf16* r0 = xs + (pb[i][0] + off) * XS + 2 * t;
        const bf16* r1 = xs + (pb[i][1] + off) * XS + 2 * t;
        af[i][0] = ld32(r0);
        af[i][1] = ld32(r1);
        af[i][2] = ld32(r0 + 8);
        af[i][3] = ld32(r1 + 8);
      }
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
        const bf16* wp = w1b + j * 8 * WS + tap * CK;
        const uint32_t b0 = ld32(wp), b1 = ld32(wp + 8);
#pragma unroll
        for (int i = 0; i < MT1; ++i) mma16816(acc1[i][j], af[i], b0, b1);
      }
    }
  }

  // bias + PReLU, rounded to bf16; zero outside the image (conv2's padding)
  const float slope = a.slope != nullptr ? *a.slope : 0.f;
#pragma unroll
  for (int i = 0; i < MT1; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MT1 + i) * 16 + g + 8 * h;
      if (r >= M1) continue;
      const int gy = y0 - 1 + r / MW, gx = x0 - 1 + r % MW;
      const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
        const int c = wn * (CMP / 2) + j * 8 + 2 * t;
        float v0 = 0.f, v1 = 0.f;
        if (inside) {
          v0 = acc1[i][j][2 * h] + (c < a.cm ? a.b1[c] : 0.f);
          v1 = acc1[i][j][2 * h + 1] + (c + 1 < a.cm ? a.b1[c + 1] : 0.f);
          v0 = fmaxf(v0, 0.f) + slope * fminf(v0, 0.f);
          v1 = fmaxf(v1, 0.f) + slope * fminf(v1, 0.f);
        }
        *reinterpret_cast<uint32_t*>(hs + r * (CMP + 8) + c) = pack_bf16(v0, v1);
      }
    }

  // ---- conv2: [128 output pixels] x [9 * CMP] x [COP] ---------------------
  // m16 tile wm*MT2 + i is output row oy of the tile; its rows g, g+8 are
  // output columns g, g+8.
  constexpr int NT2 = COP / 16;
  float acc2[MT2][NT2][4];
#pragma unroll
  for (int i = 0; i < MT2; ++i)
#pragma unroll
    for (int j = 0; j < NT2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[i][j][e] = 0.f;
  const bf16* w2b = wb + (wn * (COP / 2) + g) * WS + 2 * t;
#pragma unroll 1
  for (int k = 0; k < CMP / CK; ++k) {
    __syncthreads();  // conv1's (or the last chunk's) reads of wb are done
    stage_rows(wb, WS, a.w2 + (size_t)k * COP * WROW, COP, WROW / 8);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * MW + tap % 3;
      uint32_t af[MT2][4];
#pragma unroll
      for (int i = 0; i < MT2; ++i) {
        const int q0 = (wm * MT2 + i) * MW + g + off;
        const bf16* r0 = hs + q0 * (CMP + 8) + k * CK + 2 * t;
        const bf16* r1 = r0 + 8 * (CMP + 8);
        af[i][0] = ld32(r0);
        af[i][1] = ld32(r1);
        af[i][2] = ld32(r0 + 8);
        af[i][3] = ld32(r1 + 8);
      }
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        const bf16* wp = w2b + j * 8 * WS + tap * CK;
        const uint32_t b0 = ld32(wp), b1 = ld32(wp + 8);
#pragma unroll
        for (int i = 0; i < MT2; ++i) mma16816(acc2[i][j], af[i], b0, b1);
      }
    }
  }

  if (a.w3 == nullptr) {  // conv2 + bias is the output
#pragma unroll
    for (int i = 0; i < MT2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gy = y0 + wm * MT2 + i, gx = x0 + g + 8 * h;
        if (gy >= a.H || gx >= a.W) continue;
        float* op = a.out + (((size_t)n * a.H + gy) * a.W + gx) * a.co;
#pragma unroll
        for (int j = 0; j < NT2; ++j) {
          const int c = wn * (COP / 2) + j * 8 + 2 * t;
          if (c < a.co) op[c] = acc2[i][j][2 * h] + a.b2[c];
          if (c + 1 < a.co) op[c + 1] = acc2[i][j][2 * h + 1] + a.b2[c + 1];
        }
      }
    return;
  }

  // ---- the 1x1 head: bf16(h2 + b2) [128] x [COP] x [cep] ------------------
  __syncthreads();  // every warp's reads of the last w2 chunk are done
  bf16* h2s = wb;   // [M2][COP + 8]
  bf16* w3s = xs;   // [cep][COP + 8]
#pragma unroll
  for (int i = 0; i < MT2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MT2 + i) * 16 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        const int c = wn * (COP / 2) + j * 8 + 2 * t;
        const float v0 = c < a.co ? acc2[i][j][2 * h] + a.b2[c] : 0.f;
        const float v1 = c + 1 < a.co ? acc2[i][j][2 * h + 1] + a.b2[c + 1] : 0.f;
        *reinterpret_cast<uint32_t*>(h2s + r * (COP + 8) + c) = pack_bf16(v0, v1);
      }
    }
  stage_rows(w3s, COP + 8, a.w3, a.cep, COP / 8);
  __syncthreads();
  for (int nt = wn; nt < a.cep / 8; nt += 2) {
    float acc3[MT2][4];
#pragma unroll
    for (int i = 0; i < MT2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc3[i][e] = 0.f;
    const bf16* wp0 = w3s + (nt * 8 + g) * (COP + 8) + 2 * t;
#pragma unroll
    for (int ks = 0; ks < COP / 16; ++ks) {
      const uint32_t b0 = ld32(wp0 + ks * 16), b1 = ld32(wp0 + ks * 16 + 8);
#pragma unroll
      for (int i = 0; i < MT2; ++i) {
        const bf16* r0 = h2s + ((wm * MT2 + i) * 16 + g) * (COP + 8) + ks * 16 + 2 * t;
        const bf16* r1 = r0 + 8 * (COP + 8);
        const uint32_t af[4] = {ld32(r0), ld32(r1), ld32(r0 + 8), ld32(r1 + 8)};
        mma16816(acc3[i], af, b0, b1);
      }
    }
    const int e = nt * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < MT2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gy = y0 + wm * MT2 + i, gx = x0 + g + 8 * h;
        if (gy >= a.H || gx >= a.W) continue;
        float* op = a.out + (((size_t)n * a.H + gy) * a.W + gx) * a.ce;
        if (e < a.ce) op[e] = acc3[i][2 * h] + a.b3[e];
        if (e + 1 < a.ce) op[e + 1] = acc3[i][2 * h + 1] + a.b3[e + 1];
      }
  }
}

template <int CMP, int COP>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  // Raise the instance's shared-memory limit to the most it can use, once
  // for each device, so no attribute call falls inside a CUDA-graph capture
  // after the first launch.
  static unsigned long long devices_done = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!((devices_done >> device) & 1ull)) {
    err = cudaFuncSetAttribute(packed_double_conv_kernel<CMP, COP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Smem<CMP, COP>::bytes(MAX_WIDTH));
    if (err != cudaSuccess) return err;
    devices_done |= 1ull << device;
  }
  const size_t bytes = Smem<CMP, COP>::bytes(a.cep);
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, B);
  packed_double_conv_kernel<CMP, COP><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

bool valid_pad(int padded, int c) {
  return (padded == 32 || padded == 128) && c > 0 && c <= padded;
}

}  // namespace

// x0, x1, x2: [B, H, W, c0|c1|c2] f32 (x1 and x2 may be null with c = 0);
// w1: bf16 [ceil((c0+c1+c2)/16)][cmp][9][16], the c1 weights of the
//     part-major channel concatenation; b1: [cm]; slope: [1] or null (ReLU);
// w2: bf16 [cmp/16][cop][9][16]; b2: [co];
// w3: bf16 [cep][cop] and b3: [ce] (the 1x1 head), or null with ce = 0;
// out: [B, H, W, ce] with the head, else [B, H, W, co]. f32 contiguous.
// cmp, cop: cm and co padded to 32 or 128; cep: ce padded to 8.
// vec: every part's channel count is a multiple of 4 and its pointer 16-byte
// aligned (vector loads of the input).
extern "C" int hn_packed_double_conv(
    const float* x0, int c0, const float* x1, int c1, const float* x2, int c2,
    const void* w1, const float* b1, const float* slope, const void* w2,
    const float* b2, const void* w3, const float* b3, float* out, int B,
    int H, int W, int cm, int co, int ce, int cmp, int cop, int cep, int vec,
    void* stream) {
  if (x0 == nullptr || c0 <= 0 || c1 < 0 || c2 < 0 ||
      (c1 > 0 && x1 == nullptr) || (c2 > 0 && (x2 == nullptr || c1 == 0)) ||
      w1 == nullptr || b1 == nullptr || w2 == nullptr || b2 == nullptr ||
      out == nullptr || !valid_pad(cmp, cm) || !valid_pad(cop, co) ||
      B <= 0 || B > 65535 || H <= 0 || W <= 0 ||
      (H + TH - 1) / TH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (w3 == nullptr) {
    if (ce != 0 || cep != 0) return (int)cudaErrorInvalidValue;
  } else if (ce <= 0 || ce > MAX_WIDTH || cep != (ce + 7) / 8 * 8 ||
             b3 == nullptr) {
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
  if (cmp == 32 && cop == 32) return (int)launch<32, 32>(a, B, s);
  if (cmp == 32 && cop == 128) return (int)launch<32, 128>(a, B, s);
  if (cmp == 128 && cop == 32) return (int)launch<128, 32>(a, B, s);
  return (int)launch<128, 128>(a, B, s);
}
