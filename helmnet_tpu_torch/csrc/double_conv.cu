// Fused DoubleConv for Hopper (sm_90a): conv3x3 (pad 1) -> PReLU -> conv3x3
// (pad 1), optionally followed by a 1x1 conv (the UNet's outc head), for
// at most 16 channels in, mid, out and head.
//
// Replaces the TPU kernel helmnet_tpu/ops/pallas_pixconv.py:251
// (fused_double_conv_pix, body `_kernel` at :149). The TPU design packs 16
// pixels per 128-lane row with banded block-Toeplitz weights and an edge
// block built with pltpu.roll, all to fill the MXU's lanes; none of that
// is carried over. Here one thread block computes one TH x TW output tile
// of one sample, both convolutions as implicit GEMMs on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sums):
//   1. each lane loads its B fragments (the weights, prepared once per
//      rollout by ops/double_conv.prepare as bf16 in fragment order) into
//      registers: coalesced 32-bit loads, no shared memory and no
//      conversion in the block;
//   2. the input tile with its 2-pixel halo is staged in shared memory as
//      bf16, 8 or 16 channels a pixel (CS), from up to two parts read
//      through separate pointers with 16-, 8- or 4-byte vector loads;
//      zero outside the image (conv1's padding) and in the padded channels;
//   3. conv1: M = the (TH+2) x (TW+2) intermediate pixels in m16 tiles
//      spread over the warps, N = the mid width padded to 8 or 16, K = 9
//      taps x CS channels in k16 steps (a trailing k8 step when 9 x CS / 8
//      is odd). A fragments come from the staged tile with ldmatrix: each
//      lane's row address absorbs the tap's shift and the halo;
//   4. bias + PReLU (ReLU without a slope), rounded to bf16 into shared
//      memory. Conv2's zero padding means the intermediate is ZERO outside
//      the image, not conv1 evaluated in the ring: the ring is masked on
//      every edge tile;
//   5. conv2 the same way from the intermediate, + bias; with the head,
//      h2 is rounded to bf16 and its accumulator fragments become the A
//      fragments of the 1x1 product in registers. Written as NHWC f32.
// Precision follows the TPU kernel: x, h1 and h2 (before the head) are
// rounded to bf16 where they enter a product, weights are bf16, and sums,
// biases and PReLU are f32.
//
// What bounds it on this card: at 96^2 x B32 the decode[0] call (8+8 -> 8
// -> 8 channels, 1x1 head to 2) moves about 21 MB and does about 1 GFLOP
// of bf16 products: 6.3 us at 3.35 TB/s against 1.0 us at 989 TFLOP/s, so
// the function is bound by bytes, and N = 8 leaves no use for wgmma. The
// design keeps the bytes to one read of each input and one write of the
// output (the halo is re-read from L2), keeps the per-block set-up short
// (no weight conversion, bf16 tiles of at most 35 KB so several blocks
// share an SM), and picks the tile by the level's size
// (ops/double_conv.tile_for): 16 x 16 where the grid has blocks enough to
// fill the card, 8 x 8 at the small levels so that small grids launch
// more, shorter blocks.
//
// Plain C entry point, bound from Python with ctypes (ops/double_conv.py).
// It launches on the caller's stream, does not synchronise, allocates
// nothing, and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_C = 16;

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

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += A(16x16, row-major) * B(16x8, column-major); bf16 in, f32 sums.
// Fragments (PTX ISA, mma.m16n8k16), g = lane / 4, t = lane % 4:
//   a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   d0, d1 = D[g][2t, 2t+1], d2, d3 = D[g+8][2t, 2t+1]
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The k8 form: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], b0 = B[2t..2t+1][g].
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2],
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// Shared-memory pixel stride (bf16) of a tile with CH channels a pixel:
// 16 bytes at 8 channels; 48 bytes at 16, so the 8 rows of an ldmatrix
// phase (consecutive pixels) fall in 8 distinct 16-byte bank groups.
template <int CH>
struct PixStride {
  static constexpr int value = CH == 8 ? 8 : 24;
};

// Element offset of K chunk j (8 channels of one tap) in a tile of rows
// ROWW pixels wide: tap = j / (CH / 8), channel half = j % (CH / 8).
template <int CH, int ROWW>
__device__ __forceinline__ int chunk_offset(int j) {
  constexpr int PS = PixStride<CH>::value;
  const int tap = j / (CH / 8), half = j % (CH / 8);
  return ((tap / 3) * ROWW + tap % 3) * PS + half * 8;
}

// acc[i][nt] += the 3x3 conv of `src` (CH channels a pixel, rows ROWW
// pixels wide) for this warp's m16 tiles. pbase[i]: the pixel of tap
// (0, 0) for the row this lane addresses in ldmatrix (row l % 8 + 8 *
// ((l / 8) % 2) of tile i); tiles at i >= ntiles are skipped (warp-uniform).
// bw[nt][j]: this lane's B fragment of K chunk j, n-tile nt.
template <int CH, int ROWW, int NT, int MPW>
__device__ __forceinline__ void conv3x3(float (&acc)[MPW][NT][4],
                                        const bf16* src, const int (&pbase)[MPW],
                                        int ntiles,
                                        const uint32_t (&bw)[NT][9 * CH / 8]) {
  constexpr int PS = PixStride<CH>::value;
  constexpr int NC = 9 * CH / 8;
  const int hi = (threadIdx.x >> 4) & 1;  // lanes 16-31: the second k8 chunk
  uint32_t base[MPW];
#pragma unroll
  for (int i = 0; i < MPW; ++i) base[i] = smem_addr(src + pbase[i] * PS);
#pragma unroll
  for (int s = 0; s < NC / 2; ++s) {
    const int off = hi ? chunk_offset<CH, ROWW>(2 * s + 1)
                       : chunk_offset<CH, ROWW>(2 * s);
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (i >= ntiles) break;
      uint32_t a[4];
      ldmatrix_x4(a, base[i] + 2 * off);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_k16(acc[i][nt], a, bw[nt][2 * s], bw[nt][2 * s + 1]);
    }
  }
  if constexpr (NC % 2 == 1) {
    const int off = chunk_offset<CH, ROWW>(NC - 1);
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (i >= ntiles) break;
      uint32_t a[2];
      ldmatrix_x2(a, base[i] + 2 * off);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_k8(acc[i][nt], a, bw[nt][NC - 1]);
    }
  }
}

// This lane's B fragments: w[nt][j][lane] (u32 = two bf16), as
// ops/double_conv.prepare lays them out.
template <int NT, int NC>
__device__ __forceinline__ void load_frags(uint32_t (&bw)[NT][NC],
                                           const uint32_t* __restrict__ w) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < NC; ++j) bw[nt][j] = __ldg(w + (nt * NC + j) * 32 + lane);
}

struct Args {
  const float* x[2];  // [B, H, W, c[i]] f32
  int c[2];           // channels of each part (c[1] = 0: one part)
  int v[2];           // vector width of each part's loads: 4, 2 or 1
  const uint32_t* w1;  // prepared fragments, bf16 pairs
  const uint32_t* w2;
  const uint32_t* w3;  // or null
  const float* b1;     // [CMP], zero-padded
  const float* b2;     // [COP]
  const float* b3;     // [16] or null
  const float* slope;  // [1] or null (ReLU)
  float* out;          // [B, H, W, co] or, with the head, [B, H, W, ce]
  int H, W, co, ce, nte;
};

// One part's channels [coff, coff + c) of the pixels this thread owns,
// rounded to bf16. V floats per load (16-, 8- or 4-byte vectors).
template <int V, int SLOTS, int IW, int PS, int THREADS>
__device__ __forceinline__ void stage_part(bf16* xs, const float* __restrict__ x,
                                           int c, int coff, int n, int y0,
                                           int x0, int H, int W, int npix) {
  constexpr int MAXQ = MAX_C / V;
  using Vec = typename std::conditional<
      V == 4, float4, typename std::conditional<V == 2, float2, float>::type>::type;
  const int nq = c / V;
  Vec buf[SLOTS][MAXQ];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int p = threadIdx.x + s * THREADS;
    const int gy = y0 - 2 + p / IW, gx = x0 - 2 + p % IW;
    const bool in = p < npix && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const Vec* src = reinterpret_cast<const Vec*>(
        x + (((size_t)n * H + (in ? gy : 0)) * W + (in ? gx : 0)) * c);
#pragma unroll
    for (int q = 0; q < MAXQ; ++q)
      if (in && q < nq) buf[s][q] = __ldg(src + q);
  }
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int p = threadIdx.x + s * THREADS;
    const int gy = y0 - 2 + p / IW, gx = x0 - 2 + p % IW;
    const bool in = p < npix && gy >= 0 && gy < H && gx >= 0 && gx < W;
    if (!in) continue;
    bf16* dst = xs + p * PS + coff;
#pragma unroll
    for (int q = 0; q < MAXQ; ++q) {
      if (q >= nq) break;
      if constexpr (V == 4) {
        const float4 f = buf[s][q];
        *reinterpret_cast<uint2*>(dst + 4 * q) =
            make_uint2(pack_bf16(f.x, f.y), pack_bf16(f.z, f.w));
      } else if constexpr (V == 2) {
        const float2 f = buf[s][q];
        *reinterpret_cast<uint32_t*>(dst + 2 * q) = pack_bf16(f.x, f.y);
      } else {
        dst[q] = __float2bfloat16(buf[s][q]);
      }
    }
  }
}

template <int SLOTS, int IW, int PS, int THREADS>
__device__ __forceinline__ void stage_any(bf16* xs, const float* x, int c,
                                          int v, int coff, int n, int y0,
                                          int x0, int H, int W, int npix) {
  if (v == 4)
    stage_part<4, SLOTS, IW, PS, THREADS>(xs, x, c, coff, n, y0, x0, H, W, npix);
  else if (v == 2)
    stage_part<2, SLOTS, IW, PS, THREADS>(xs, x, c, coff, n, y0, x0, H, W, npix);
  else
    stage_part<1, SLOTS, IW, PS, THREADS>(xs, x, c, coff, n, y0, x0, H, W, npix);
}

// TH x TW output tile, NW warps; CS, CMP, COP: input, mid and out channels
// padded to 8 or 16.
// At least 768 resident threads an SM: 85 registers a thread, so the base
// model's instances do not spill (at 1024 threads and 64 they did).
template <int TH, int TW, int NW, int CS, int CMP, int COP>
__global__ void __launch_bounds__(NW * 32, 768 / (NW * 32))
double_conv_kernel(const __grid_constant__ Args a) {
  constexpr int THREADS = NW * 32;
  constexpr int MH = TH + 2, MW = TW + 2, IH = TH + 4, IW = TW + 4;
  constexpr int M1 = MH * MW, M2 = TH * TW;
  constexpr int MT1 = (M1 + 15) / 16, MT2 = M2 / 16;
  constexpr int MPW1 = (MT1 + NW - 1) / NW, MPW2 = (MT2 + NW - 1) / NW;
  constexpr int PS = PixStride<CS>::value, MPS = PixStride<CMP>::value;
  constexpr int NT1 = CMP / 8, NT2 = COP / 8;
  constexpr int NC1 = 9 * CS / 8, NC2 = 9 * CMP / 8;
  constexpr int SLOTS = (IH * IW + THREADS - 1) / THREADS;
  static_assert(M2 % 16 == 0, "the output tile is whole m16 tiles");
  __shared__ __align__(16) bf16 xs[IH * IW * PS];  // input tile
  __shared__ __align__(16) bf16 hs[M1 * MPS];      // intermediate

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  uint32_t bw1[NT1][NC1];
  load_frags(bw1, a.w1);

  // ---- stage the input tile ---------------------------------------------
  // Each thread owns whole pixels: it zeroes their CS channels, then writes
  // the parts' channels over them, so no barrier falls between the two.
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int p = threadIdx.x + s * THREADS;
    if (p < IH * IW) {
#pragma unroll
      for (int q = 0; q < CS / 8; ++q)
        reinterpret_cast<uint4*>(xs + p * PS)[q] = make_uint4(0, 0, 0, 0);
    }
  }
  stage_any<SLOTS, IW, PS, THREADS>(xs, a.x[0], a.c[0], a.v[0], 0, n, y0, x0,
                                    a.H, a.W, IH * IW);
  if (a.c[1] > 0)
    stage_any<SLOTS, IW, PS, THREADS>(xs, a.x[1], a.c[1], a.v[1], a.c[0], n,
                                      y0, x0, a.H, a.W, IH * IW);
  __syncthreads();

  // ---- conv1 over the intermediate tile ---------------------------------
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row
  const int nt1 = warp < MT1 ? (MT1 - warp + NW - 1) / NW : 0;
  float acc1[MPW1][NT1][4] = {};
  {
    int pbase[MPW1];
#pragma unroll
    for (int i = 0; i < MPW1; ++i) {
      const int r = (warp + i * NW) * 16 + lrow;
      pbase[i] = r < M1 ? (r / MW) * IW + r % MW : 0;  // rows >= M1: unused
    }
    conv3x3<CS, IW, NT1, MPW1>(acc1, xs, pbase, nt1, bw1);
  }
  uint32_t bw2[NT2][NC2];
  load_frags(bw2, a.w2);

  const float slope = a.slope != nullptr ? __ldg(a.slope) : 0.f;
#pragma unroll
  for (int i = 0; i < MPW1; ++i) {
    if (i >= nt1) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (warp + i * NW) * 16 + g + 8 * h;
      if (r >= M1) continue;
      const int gy = y0 - 1 + r / MW, gx = x0 - 1 + r % MW;
      const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt) {
        const int c = nt * 8 + 2 * t;
        float v0 = 0.f, v1 = 0.f;
        if (inside) {
          v0 = acc1[i][nt][2 * h] + __ldg(a.b1 + c);
          v1 = acc1[i][nt][2 * h + 1] + __ldg(a.b1 + c + 1);
          v0 = prelu(v0, slope);
          v1 = prelu(v1, slope);
        }
        *reinterpret_cast<uint32_t*>(hs + r * MPS + c) = pack_bf16(v0, v1);
      }
    }
  }
  __syncthreads();

  // ---- conv2 over the output tile ----------------------------------------
  const int nt2 = warp < MT2 ? (MT2 - warp + NW - 1) / NW : 0;
  float acc2[MPW2][NT2][4] = {};
  {
    int pbase[MPW2];
#pragma unroll
    for (int i = 0; i < MPW2; ++i) {
      const int r = (warp + i * NW) * 16 + lrow;
      pbase[i] = (r / TW) * MW + r % TW;
    }
    conv3x3<CMP, MW, NT2, MPW2>(acc2, hs, pbase, nt2, bw2);
  }

  const size_t img = (size_t)n * a.H;
  if (a.w3 == nullptr) {  // conv2 + bias is the output
    const bool pairs = (a.co & 1) == 0;
#pragma unroll
    for (int i = 0; i < MPW2; ++i) {
      if (i >= nt2) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (warp + i * NW) * 16 + g + 8 * h;
        const int gy = y0 + r / TW, gx = x0 + r % TW;
        if (gy >= a.H || gx >= a.W) continue;
        float* op = a.out + ((img + gy) * a.W + gx) * a.co;
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt) {
          const int c = nt * 8 + 2 * t;
          const float v0 = acc2[i][nt][2 * h] + __ldg(a.b2 + c);
          const float v1 = acc2[i][nt][2 * h + 1] + __ldg(a.b2 + c + 1);
          if (pairs && c + 1 < a.co) {
            *reinterpret_cast<float2*>(op + c) = make_float2(v0, v1);
          } else {
            if (c < a.co) op[c] = v0;
            if (c + 1 < a.co) op[c + 1] = v1;
          }
        }
      }
    }
    return;
  }

  // ---- the 1x1 head, from the accumulators in registers ------------------
  // bf16(h2 + b2) as D fragments is the A fragment of the next product:
  // n-tile nt of D holds k = 8 nt + 2t, +1 for rows g and g + 8.
  uint32_t ah[MPW2][NT2][2];
#pragma unroll
  for (int i = 0; i < MPW2; ++i)
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt) {
      const int c = nt * 8 + 2 * t;
      const float b0 = __ldg(a.b2 + c), b1 = __ldg(a.b2 + c + 1);
      ah[i][nt][0] = pack_bf16(acc2[i][nt][0] + b0, acc2[i][nt][1] + b1);
      ah[i][nt][1] = pack_bf16(acc2[i][nt][2] + b0, acc2[i][nt][3] + b1);
    }
  const bool pairs = (a.ce & 1) == 0;
  for (int e = 0; e < a.nte; ++e) {
    uint32_t bw3[NT2];
#pragma unroll
    for (int j = 0; j < NT2; ++j) bw3[j] = __ldg(a.w3 + (e * NT2 + j) * 32 + lane);
    const int c = e * 8 + 2 * t;
    const float b0 = __ldg(a.b3 + c), b1 = __ldg(a.b3 + c + 1);
#pragma unroll
    for (int i = 0; i < MPW2; ++i) {
      if (i >= nt2) break;
      float acc3[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (NT2 == 2) {
        const uint32_t af[4] = {ah[i][0][0], ah[i][0][1], ah[i][1][0], ah[i][1][1]};
        mma_k16(acc3, af, bw3[0], bw3[NT2 - 1]);
      } else {
        const uint32_t af[2] = {ah[i][0][0], ah[i][0][1]};
        mma_k8(acc3, af, bw3[0]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (warp + i * NW) * 16 + g + 8 * h;
        const int gy = y0 + r / TW, gx = x0 + r % TW;
        if (gy >= a.H || gx >= a.W) continue;
        float* op = a.out + ((img + gy) * a.W + gx) * a.ce;
        const float v0 = acc3[2 * h] + b0, v1 = acc3[2 * h + 1] + b1;
        if (pairs && c + 1 < a.ce) {
          *reinterpret_cast<float2*>(op + c) = make_float2(v0, v1);
        } else {
          if (c < a.ce) op[c] = v0;
          if (c + 1 < a.ce) op[c + 1] = v1;
        }
      }
    }
  }
}

template <int TH, int TW, int NW, int CS, int CMP, int COP>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, B);
  double_conv_kernel<TH, TW, NW, CS, CMP, COP><<<grid, NW * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int TH, int TW, int NW>
cudaError_t dispatch(const Args& a, int B, int cs, int cmp, int cop,
                     cudaStream_t s) {
#define HN_CASE(C, M, O)                                  \
  if (cs == C && cmp == M && cop == O)                    \
    return launch<TH, TW, NW, C, M, O>(a, B, s);
  HN_CASE(8, 8, 8) HN_CASE(8, 8, 16) HN_CASE(8, 16, 8) HN_CASE(8, 16, 16)
  HN_CASE(16, 8, 8) HN_CASE(16, 8, 16) HN_CASE(16, 16, 8) HN_CASE(16, 16, 16)
#undef HN_CASE
  return cudaErrorInvalidValue;
}

bool valid_pad(int p) { return p == 8 || p == 16; }

}  // namespace

// x1: [B, H, W, c1] and x2: [B, H, W, c2] f32 (x2 may be null with c2 = 0);
// v1, v2: their load vector widths (4: c % 4 == 0, channel offset % 4 == 0
// and the pointer 16-byte aligned; 2: the same for 2 and 8 bytes; else 1);
// w1, w2, w3: bf16 fragments from ops/double_conv.prepare, as pairs
// ([cmp/8][9*cs/8][32], [cop/8][9*cmp/8][32], [cep/8][cop/8][32]);
// b1 [cmp], b2 [cop], b3 [cep] f32 zero-padded; slope [1] or null (ReLU);
// w3 and b3 null without the head (then ce = co, cep = 0);
// out: [B, H, W, ce] f32. cs, cmp, cop: input, mid and out widths padded to
// 8 or 16; cep: the head's width padded to 8 or 16. tile: 0 for 16 x 16
// output tiles, 1 for 8 x 8 (ops/double_conv.tile_for).
extern "C" int hn_double_conv(const float* x1, int c1, int v1, const float* x2,
                              int c2, int v2, const void* w1, const float* b1,
                              const float* slope, const void* w2,
                              const float* b2, const void* w3, const float* b3,
                              float* out, int B, int H, int W, int cs, int cmp,
                              int cop, int co, int ce, int cep, int tile,
                              void* stream) {
  const int tile_h = tile == 0 ? 16 : 8;
  if (x1 == nullptr || c1 <= 0 || c2 < 0 || (c2 > 0 && x2 == nullptr) ||
      c1 + c2 > cs || !valid_pad(cs) || !valid_pad(cmp) || !valid_pad(cop) ||
      co <= 0 || co > cop || w1 == nullptr || w2 == nullptr || b1 == nullptr ||
      b2 == nullptr || out == nullptr || (tile != 0 && tile != 1) || B <= 0 ||
      B > 65535 || H <= 0 || W <= 0 || (H + tile_h - 1) / tile_h > 65535 ||
      (v1 != 1 && v1 != 2 && v1 != 4) || (v2 != 1 && v2 != 2 && v2 != 4) ||
      c1 % v1 != 0 || (c2 > 0 && (c2 % v2 != 0 || c1 % v2 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  if (w3 == nullptr) {
    if (b3 != nullptr || cep != 0 || ce != co) return (int)cudaErrorInvalidValue;
  } else if (b3 == nullptr || !valid_pad(cep) || ce <= 0 || ce > cep) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.x[0] = x1;
  a.x[1] = x2;
  a.c[0] = c1;
  a.c[1] = c2;
  a.v[0] = v1;
  a.v[1] = v2;
  a.w1 = static_cast<const uint32_t*>(w1);
  a.w2 = static_cast<const uint32_t*>(w2);
  a.w3 = static_cast<const uint32_t*>(w3);
  a.b1 = b1;
  a.b2 = b2;
  a.b3 = b3;
  a.slope = slope;
  a.out = out;
  a.H = H;
  a.W = W;
  a.co = co;
  a.ce = ce;
  a.nte = cep / 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 0) return (int)dispatch<16, 16, 8>(a, B, cs, cmp, cop, s);
  return (int)dispatch<8, 8, 4>(a, B, cs, cmp, cop, s);
}
