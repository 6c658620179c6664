// Fused FD-stencil PML Helmholtz residual for Hopper (sm_90a):
//
//   r[y, x] = sum_t cx[t, x] u[y, x + t - R] + cy[t, y] u[y + t - R, x]
//             + k2[y, x] u[y, x] - s[y, x]
//
// complex, with periodic wrap on both axes, R = 1 or 2 (stencil orders 2
// and 4). Fields are [B, H, W] planes of f32; the coefficient tables are
// [2R+1, W] (x taps) and [2R+1, H] (y taps), split re/im.
//
// Two kernels compute this one function:
//
// 1. stencil_residual_kernel replaces the TPU kernels
//    helmnet_tpu/ops/pallas_stencil.py:212 (residual_planes, K2a: a whole
//    plane per grid step) and :161 (residual_planes_tiled, K2b: row tiles
//    with an 8-row halo brought in by DMA). The TPU split them for its VMEM
//    budget, which does not exist here. One block takes a 32 x 32 output
//    tile and stages the u tile with an R-cell periodic halo on both axes
//    (wrap indices mod H and W, so any H, W >= 1 goes; ragged edge tiles
//    are masked) and its slices of the tap tables in shared memory. k2 and
//    s are read once, coalesced, without staging; r is written once.
//    Bound: bytes. Per point it reads u (2 planes), k2 and s (2) and writes
//    r (2): 28 bytes against about 84 flops, far below the card's
//    operations-per-byte line. The design therefore spends nothing on the
//    arithmetic: the taps run on the CUDA cores, each product and sum
//    rounded on its own (__fmul_rn, __fadd_rn, no FMA contraction) in the
//    order of the plain version (ops/stencil_residual.residual_planes_plain),
//    so the two agree to the bit; the halo rows and columns are re-read from
//    L2, not from device memory. TMA and pipelining are later work.
//
// 2. stencil_residual_mma_kernel replaces helmnet_tpu/ops/pallas_stencil.py
//    :452 (residual_planes_mxu, K2c), whose x taps are a banded [W, W]
//    matmul on the MXU. Here the x taps are a product with the same banded
//    matrices (ops/stencil_residual.banded_matrices, cached on the operator)
//    on the tensor cores, mma.sync m16n8k8 TF32, restricted to the band:
//    output columns [c0, c0+8) need input columns [c0-R, c0+8+R), which sit
//    in the 16-column window [c0-4, c0+12) (two k8 steps, not W/8). Only
//    the band's entries of that window are read; the rest are zeros. The
//    products use the 3xTF32 split (a = a_hi + a_lo; a_hi b_hi + a_hi b_lo
//    + a_lo b_hi summed in f32), about 1e-6 relative, inside K2c's atol
//    2e-4 (tests/test_pallas_stencil.py:116), where plain TF32 (11 bits)
//    would err by about 1e-2. The y taps, k2 u - s and the store run on the
//    CUDA cores as in `_residual_kernel_mxu`. Bound: bytes, as above; the
//    band products, 3 x 4 x 2 x 2 mma per 16 x 8 outputs, are about 0.8
//    GFLOP at 512^2 x 8, a few microseconds at the TF32 rate. The band
//    picks each tap once only when W >= 2R + 1 (the wrapper refuses less).
//
// Each plane is a pointer, a batch stride and an element stride (1 for a
// split plane, 2 for one half of a channel pair or of a complex64 tensor
// viewed as real pairs): element (b, y, x) is at p[b * bs + (y * W + x) * es].
// So the channel-pair wrapper and GMRES's complex matvec launch without any
// split or stack copy. A null s means zero and is not read. A k2 batch
// stride of 0 broadcasts one k2 plane over the batch.
//
// Plain C entry points, bound from Python with ctypes
// (ops/stencil_residual.py). They launch on the caller's stream, do not
// synchronise, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Planes {
  const float* ur;
  const float* ui;
  long long ubs;
  int uxs;
  const float* k2;
  long long kbs;
  const float* sr;  // null: s = 0
  const float* si;
  long long sbs;
  int sxs;
  float* rr;
  float* ri;
  long long rbs;
  int rxs;
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// acc + c * v, each step rounded on its own (what the plain version does)
__device__ __forceinline__ float add_mul(float acc, float c, float v) {
  return __fadd_rn(acc, __fmul_rn(c, v));
}
__device__ __forceinline__ float sub_mul(float acc, float c, float v) {
  return __fsub_rn(acc, __fmul_rn(c, v));
}

// acc += (c_r + i c_i)(v_r + i v_i), in the plain version's order:
// acc_r = acc_r + c_r v_r - c_i v_i; acc_i = acc_i + c_r v_i + c_i v_r.
__device__ __forceinline__ void cmac(float& ar, float& ai, float cr, float ci,
                                     float vr, float vi) {
  ar = sub_mul(add_mul(ar, cr, vr), ci, vi);
  ai = add_mul(add_mul(ai, cr, vi), ci, vr);
}

// k2 u - s at one pixel (s may be null)
__device__ __forceinline__ void diag_term(const Planes& p, int b, long long pix,
                                          float vr, float vi, float& ar,
                                          float& ai) {
  const float k = p.k2[b * p.kbs + pix];
  ar = __fmul_rn(k, vr);
  ai = __fmul_rn(k, vi);
  if (p.sr != nullptr) {
    const long long o = b * p.sbs + pix * p.sxs;
    ar = __fsub_rn(ar, p.sr[o]);
    ai = __fsub_rn(ai, p.si[o]);
  }
}

// ---------------------------------------------------------------------------
// 1. CUDA-core stencil (K2a, K2b)
// ---------------------------------------------------------------------------

constexpr int TW = 32;              // tile columns: one warp across
constexpr int TH = 32;              // tile rows
constexpr int TY = 8;               // thread rows; each thread does TH / TY rows
constexpr int THREADS = TW * TY;

template <int R>
__global__ void __launch_bounds__(THREADS)
stencil_residual_kernel(Planes p, const float* __restrict__ cxr,
                        const float* __restrict__ cxi,
                        const float* __restrict__ cyr,
                        const float* __restrict__ cyi, int H, int W) {
  constexpr int NT = 2 * R + 1;
  constexpr int SW = TW + 2 * R;
  constexpr int SH = TH + 2 * R;
  __shared__ float s_ur[SH][SW];
  __shared__ float s_ui[SH][SW];
  __shared__ float s_cx[2][NT][TW];
  __shared__ float s_cy[2][NT][TH];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  const float* ur = p.ur + b * p.ubs;
  const float* ui = p.ui + b * p.ubs;

  for (int i = tid; i < SH * SW; i += THREADS) {
    const int ly = i / SW, lx = i - ly * SW;
    const int gy = wrap(y0 + ly - R, H), gx = wrap(x0 + lx - R, W);
    const long long o = ((long long)gy * W + gx) * p.uxs;
    s_ur[ly][lx] = ur[o];
    s_ui[ly][lx] = ui[o];
  }
  for (int i = tid; i < NT * TW; i += THREADS) {
    const int t = i / TW, lx = i - t * TW;
    const int gx = min(x0 + lx, W - 1);
    s_cx[0][t][lx] = cxr[t * W + gx];
    s_cx[1][t][lx] = cxi[t * W + gx];
  }
  for (int i = tid; i < NT * TH; i += THREADS) {
    const int t = i / TH, ly = i - t * TH;
    const int gy = min(y0 + ly, H - 1);
    s_cy[0][t][ly] = cyr[t * H + gy];
    s_cy[1][t][ly] = cyi[t * H + gy];
  }
  __syncthreads();

  const int gx = x0 + tx;
  if (gx >= W) return;
#pragma unroll
  for (int k = 0; k < TH / TY; ++k) {
    const int ly = ty + k * TY;
    const int gy = y0 + ly;
    if (gy >= H) break;
    const long long pix = (long long)gy * W + gx;
    float ar, ai;
    diag_term(p, b, pix, s_ur[ly + R][tx + R], s_ui[ly + R][tx + R], ar, ai);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      // x tap: column x + t - R; y tap: row y + t - R
      cmac(ar, ai, s_cx[0][t][tx], s_cx[1][t][tx], s_ur[ly + R][tx + t],
           s_ui[ly + R][tx + t]);
      cmac(ar, ai, s_cy[0][t][ly], s_cy[1][t][ly], s_ur[ly + t][tx + R],
           s_ui[ly + t][tx + R]);
    }
    const long long o = b * p.rbs + pix * p.rxs;
    p.rr[o] = ar;
    p.ri[o] = ai;
  }
}

// ---------------------------------------------------------------------------
// 2. Tensor-core x taps on the band (K2c)
// ---------------------------------------------------------------------------

constexpr int MT = 32;            // tile rows: two m16 tiles
constexpr int MW = 32;            // tile columns: four n8 tiles
constexpr int MWIN = 4;           // window columns left of c0 (R <= 4)
constexpr int MSW = MW + 2 * MWIN;  // staged columns [c0 - 4, c0 + 36)
constexpr int MSWP = MSW + 4;     // row stride 44: conflict-free A loads
constexpr int MWARPS = (MT / 16) * (MW / 8);
constexpr int MTHREADS = 32 * MWARPS;

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// Fragments (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4, t = lane % 4:
// A[16x8]: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
// B[8x8]: b0 (t, g), b1 (t+4, g);
// C[16x8]: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B in 3xTF32: the small cross terms first, then hi x hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bhi0,
                                     uint32_t bhi1, uint32_t blo0,
                                     uint32_t blo1) {
  mma1688(d, alo, bhi0, bhi1);
  mma1688(d, ahi, blo0, blo1);
  mma1688(d, ahi, bhi0, bhi1);
}

template <int R>
__global__ void __launch_bounds__(MTHREADS)
stencil_residual_mma_kernel(Planes p, const float* __restrict__ btr,
                            const float* __restrict__ bti,
                            const float* __restrict__ cyr,
                            const float* __restrict__ cyi, int H, int W) {
  constexpr int NT = 2 * R + 1;
  constexpr int SH = MT + 2 * R;
  __shared__ float s_ur[SH][MSWP];
  __shared__ float s_ui[SH][MSWP];
  __shared__ float s_cy[2][NT][MT];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * MW, y0 = blockIdx.y * MT, b = blockIdx.z;
  const float* ur = p.ur + b * p.ubs;
  const float* ui = p.ui + b * p.ubs;

  // rows [y0 - R, y0 + MT + R), columns [c0 - 4, c0 + MW + 4), wrapped
  for (int i = tid; i < SH * MSW; i += MTHREADS) {
    const int ly = i / MSW, lx = i - ly * MSW;
    const int gy = wrap(y0 + ly - R, H), gx = wrap(c0 + lx - MWIN, W);
    const long long o = ((long long)gy * W + gx) * p.uxs;
    s_ur[ly][lx] = ur[o];
    s_ui[ly][lx] = ui[o];
  }
  for (int i = tid; i < NT * MT; i += MTHREADS) {
    const int tt = i / MT, ly = i - tt * MT;
    const int gy = min(y0 + ly, H - 1);
    s_cy[0][tt][ly] = cyr[tt * H + gy];
    s_cy[1][tt][ly] = cyi[tt * H + gy];
  }

  // this warp's 16 x 8 output tile: rows m0.., local columns n0..
  const int m0 = (warp / (MW / 8)) * 16;
  const int n0 = (warp % (MW / 8)) * 8;
  // B fragments of the band: B[k][n] = Bt[(c0 + n0 - 4 + k) mod W, c0 + n0 + n]
  // where the tap offset k - 4 - n lies in [-R, R], else 0.
  uint32_t brh[2][2], brl[2][2], bih[2][2], bil[2][2], nih[2][2], nil[2][2];
  {
    const int c = c0 + n0 + g;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = ks * 8 + t + 4 * h;
        const int off = k - MWIN - g;
        float vr = 0.f, vi = 0.f;
        if (c < W && off >= -R && off <= R) {
          const long long j = wrap(c + off, W);
          vr = btr[j * W + c];
          vi = bti[j * W + c];
        }
        split(vr, brh[ks][h], brl[ks][h]);
        split(vi, bih[ks][h], bil[ks][h]);
        split(-vi, nih[ks][h], nil[ks][h]);
      }
    }
  }
  __syncthreads();

  // X = U Bt on the window: Xr = Ur Btr - Ui Bti, Xi = Ur Bti + Ui Btr
  float xr[4] = {0.f, 0.f, 0.f, 0.f}, xi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int col = n0 + ks * 8 + t;
    const int row = R + m0 + g;
    uint32_t rh[4], rl[4], ih[4], il[4];
    split(s_ur[row][col], rh[0], rl[0]);
    split(s_ur[row + 8][col], rh[1], rl[1]);
    split(s_ur[row][col + 4], rh[2], rl[2]);
    split(s_ur[row + 8][col + 4], rh[3], rl[3]);
    split(s_ui[row][col], ih[0], il[0]);
    split(s_ui[row + 8][col], ih[1], il[1]);
    split(s_ui[row][col + 4], ih[2], il[2]);
    split(s_ui[row + 8][col + 4], ih[3], il[3]);
    mma3(xr, rh, rl, brh[ks][0], brh[ks][1], brl[ks][0], brl[ks][1]);
    mma3(xr, ih, il, nih[ks][0], nih[ks][1], nil[ks][0], nil[ks][1]);
    mma3(xi, rh, rl, bih[ks][0], bih[ks][1], bil[ks][0], bil[ks][1]);
    mma3(xi, ih, il, brh[ks][0], brh[ks][1], brl[ks][0], brl[ks][1]);
  }

  // epilogue on the CUDA cores, in `_residual_kernel_mxu`'s order:
  // acc = X + k2 u - s, then the y taps
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ly = m0 + g + 8 * (e >> 1);
    const int lx = n0 + 2 * t + (e & 1);
    const int gy = y0 + ly, gx = c0 + lx;
    if (gy >= H || gx >= W) continue;
    const long long pix = (long long)gy * W + gx;
    const float vr = s_ur[ly + R][lx + MWIN], vi = s_ui[ly + R][lx + MWIN];
    float dr, di;
    diag_term(p, b, pix, vr, vi, dr, di);
    float ar = __fadd_rn(xr[e], dr), ai = __fadd_rn(xi[e], di);
#pragma unroll
    for (int tt = 0; tt < NT; ++tt) {
      cmac(ar, ai, s_cy[0][tt][ly], s_cy[1][tt][ly], s_ur[ly + tt][lx + MWIN],
           s_ui[ly + tt][lx + MWIN]);
    }
    const long long o = b * p.rbs + pix * p.rxs;
    p.rr[o] = ar;
    p.ri[o] = ai;
  }
}

bool valid(const Planes& p, int B, int H, int W, int radius) {
  const bool s_ok = (p.sr == nullptr) == (p.si == nullptr);
  const bool strides = (p.uxs == 1 || p.uxs == 2) && (p.rxs == 1 || p.rxs == 2) &&
                       (p.sr == nullptr || p.sxs == 1 || p.sxs == 2) &&
                       p.ubs >= 0 && p.kbs >= 0 && p.sbs >= 0 && p.rbs >= 0;
  return p.ur != nullptr && p.ui != nullptr && p.k2 != nullptr &&
         p.rr != nullptr && p.ri != nullptr && s_ok && strides &&
         (radius == 1 || radius == 2) && B > 0 && B <= 65535 && H > 0 && W > 0 &&
         (H + 31) / 32 <= 65535;
}

Planes planes(const float* ur, const float* ui, long long ubs, int uxs,
              const float* k2, long long kbs, const float* sr, const float* si,
              long long sbs, int sxs, float* rr, float* ri, long long rbs,
              int rxs) {
  Planes p;
  p.ur = ur;
  p.ui = ui;
  p.ubs = ubs;
  p.uxs = uxs;
  p.k2 = k2;
  p.kbs = kbs;
  p.sr = sr;
  p.si = si;
  p.sbs = sbs;
  p.sxs = sxs;
  p.rr = rr;
  p.ri = ri;
  p.rbs = rbs;
  p.rxs = rxs;
  return p;
}

}  // namespace

// K2a / K2b. Strides in elements; radius 1 or 2.
extern "C" int hn_stencil_residual(
    const float* ur, const float* ui, long long ubs, int uxs, const float* k2,
    long long kbs, const float* sr, const float* si, long long sbs, int sxs,
    float* rr, float* ri, long long rbs, int rxs, const float* cxr,
    const float* cxi, const float* cyr, const float* cyi, int B, int H, int W,
    int radius, void* stream) {
  const Planes p = planes(ur, ui, ubs, uxs, k2, kbs, sr, si, sbs, sxs, rr, ri,
                          rbs, rxs);
  if (!valid(p, B, H, W, radius) || cxr == nullptr || cxi == nullptr ||
      cyr == nullptr || cyi == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const dim3 block(TW, TY);
  if (radius == 1) {
    stencil_residual_kernel<1><<<grid, block, 0, s>>>(p, cxr, cxi, cyr, cyi, H, W);
  } else {
    stencil_residual_kernel<2><<<grid, block, 0, s>>>(p, cxr, cxi, cyr, cyi, H, W);
  }
  return (int)cudaGetLastError();
}

// K2c. btr, bti: the banded [W, W] x-tap matrices, Bt[j, c] the coefficient
// of input column j for output column c; needs W >= 2 * radius + 1.
extern "C" int hn_stencil_residual_mma(
    const float* ur, const float* ui, long long ubs, int uxs, const float* k2,
    long long kbs, const float* sr, const float* si, long long sbs, int sxs,
    float* rr, float* ri, long long rbs, int rxs, const float* btr,
    const float* bti, const float* cyr, const float* cyi, int B, int H, int W,
    int radius, void* stream) {
  const Planes p = planes(ur, ui, ubs, uxs, k2, kbs, sr, si, sbs, sxs, rr, ri,
                          rbs, rxs);
  if (!valid(p, B, H, W, radius) || W < 2 * radius + 1 || btr == nullptr ||
      bti == nullptr || cyr == nullptr || cyi == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + MW - 1) / MW, (H + MT - 1) / MT, B);
  if (radius == 1) {
    stencil_residual_mma_kernel<1><<<grid, MTHREADS, 0, s>>>(p, btr, bti, cyr,
                                                            cyi, H, W);
  } else {
    stencil_residual_mma_kernel<2><<<grid, MTHREADS, 0, s>>>(p, btr, bti, cyr,
                                                            cyi, H, W);
  }
  return (int)cudaGetLastError();
}
