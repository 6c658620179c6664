// Fused FD-stencil PML Helmholtz residual for Hopper (sm_90a):
//
//   r[y, x] = sum_t cx[t, x] u[y, x + t - R] + cy[t, y] u[y + t - R, x]
//             + k2[y, x] u[y, x] - s[y, x]
//
// complex, with periodic wrap on both axes, R = 1 or 2 (stencil orders 2
// and 4). Fields are [B, H, W] planes of f32; the coefficient tables are
// [2R+1, W] (x taps) and [2R+1, H] (y taps), split re/im.
//
// One kernel, stencil_residual_kernel, replaces the three TPU kernels of
// helmnet_tpu/ops/pallas_stencil.py: :212 (residual_planes, K2a: a whole
// plane per grid step), :161 (residual_planes_tiled, K2b: row tiles with
// a halo brought in by DMA) and :452 (residual_planes_mxu, K2c: the x taps
// as a banded [W, W] product on the MXU). The TPU split K2a and K2b for its
// VMEM budget, which does not exist here. It put K2c's x taps on the MXU
// because lane shifts are dear on its vector unit; on this card a shifted
// read from shared memory is cheap, and the band product would spend the
// tensor cores on 2R+1 nonzeros of every [W] column. The function is bound
// by bytes: per point it reads u (2 floats), k2 and s (2) and writes r (2),
// 28 bytes against about 84 flops. So K2c's entry point launches this
// kernel with the tap tables, the values its band matrices hold.
//
// Instances (template MODE), chosen by the wrapper before the launch
// (ops/stencil_residual.stencil_variant) from shapes, strides and the
// alignment of every pointer; a launch whose operands do not fit its
// instance is refused, never redirected:
//
// - PLANES: split planes (element stride 1), W % 4 == 0, every plane
//   16-byte aligned. A thread owns 4 adjacent points; u, s, r move as
//   float4 per plane, k2 as float4.
// - PAIRS: re and im interleaved in one buffer (view_as_real of complex64,
//   or the channel-pair wrapper's [B, H, W, 2]) for u, s and r, W even;
//   u, s, r 16-byte aligned, k2 8-byte aligned. A thread owns 2 adjacent
//   points; one float4 moves (re, im, re, im) of both, k2 moves as float2.
//   Only the re pointers are read: the im pointer is base + 4 bytes.
// - SCALAR: anything else (ragged widths such as 33, misaligned views, a
//   plane narrower than the halo); 4-byte accesses, one point a thread.
//
// Staging: the block's u tile with its halo (R rows above and below; one
// 16-byte chunk left and right in the vector instances, so every copy is
// aligned; R points in the scalar one) goes to shared memory by cp.async
// (16-byte .cg copies, 4-byte in the scalar instance), in NY parts of TY
// rows, each with its own commit group. Each thread owns one row of each
// part. Part j+1's copies, and its k2 and s into registers, are started
// before part j is waited for, so one part is in flight while another is
// computed: the taps from shared memory after one wait and one barrier a
// part, and vector stores. (Starting all of a tile's copies before the
// first wait measured slower, tools/k2_variants.py AHEAD=4: the warps sat
// in their long copy queues, and the taps, 84 separately rounded flops a
// point, hardly overlapped the memory.) A block is 256 threads on 32 rows
// (4 parts of 8) by 32 V points: 512 blocks, about 4 an SM, at GMRES's
// matvec (16 x 256^2, PAIRS) and at 512^2 x 8 (PLANES). The
// tap tables' slices go to shared memory by plain loads while the first
// part flies. Interior tiles index straight; edge tiles wrap each chunk
// with one conditional add, which is exact because W is a multiple of the
// chunk and H >= R there (the wrapper picks SCALAR otherwise, whose wrap()
// takes any period).
//
// Bit-equality: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn; no FMA contraction) in the order of the plain
// version (ops/stencil_residual.residual_planes_plain): k2 u - s, then per
// tap the x and the y term. Vector accesses change no point's arithmetic,
// so all instances agree with the plain version to the bit, and K2c with
// its banded plain version to about 1e-6 (the x taps summed in another
// order), inside its atol 2e-4 (tests/test_pallas_stencil.py:116).
//
// Each plane is a pointer, a batch stride and an element stride (1 for a
// split plane, 2 for one half of a channel pair or of a complex64 tensor
// viewed as real pairs): element (b, y, x) is at p[b * bs + (y * W + x) * es].
// A null s means zero and is not read. A k2 batch stride of 0 broadcasts
// one k2 plane over the batch.
//
// Plain C entry point, bound from Python with ctypes
// (ops/stencil_residual.py). It launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScalar = 0;
constexpr int kPlanes = 1;
constexpr int kPairs = 2;

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

// Tile of one block: TX x TY threads, each owning V adjacent points in x
// on NY rows, one in each of the tile's NY parts of TY rows.
template <int MODE>
struct Tile {
  static constexpr int V = MODE == kPlanes ? 4 : MODE == kPairs ? 2 : 1;
  static constexpr int NY = 4;
  static constexpr int AHEAD = 1;  // parts staged ahead of the one computed
  static constexpr int TX = 32;
  static constexpr int TY = 8;
  static constexpr int THREADS = TX * TY;
  static constexpr int TH = TY * NY;  // tile rows
  static constexpr int TW = TX * V;   // tile columns (points)
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// one periodic step: i in [-n, 2n)
__device__ __forceinline__ int wrap1(int i, int n) {
  return i + (i < 0 ? n : (i >= n ? -n : 0));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's groups are in flight (n < 8; a
// constant once the caller's loop is unrolled)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
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

// Shared-memory layout of a block's u tile: SH rows of SW points, R rows
// and HX points of halo around TH x TW. PLANES, SCALAR: the re plane, then
// the im plane; PAIRS: one plane of (re, im) pairs.
template <int R, int MODE>
struct Staged {
  using T = Tile<MODE>;
  static constexpr bool VEC = MODE != kScalar;
  static constexpr int HX = VEC ? T::V : R;  // halo points each side
  static constexpr int SH = T::TH + 2 * R;
  static constexpr int SW = T::TW + 2 * HX;
  static constexpr int FLOATS = 2 * SH * SW;
};

// cp.async of staged rows [r0, r1) of the tile at (x0, y0) of plane b:
// whole 16-byte chunks in the vector instances, floats in the scalar one.
// Interior tiles index straight; edge tiles wrap, and skip what no output
// of the plane reads.
template <int R, int MODE>
__device__ __forceinline__ void stage_rows(float* s_u, const Planes& p,
                                           const float* ur, const float* ui,
                                           int r0, int r1, int x0, int y0,
                                           bool interior, int H, int W) {
  using S = Staged<R, MODE>;
  constexpr int SH = S::SH, SW = S::SW, HX = S::HX;
  const int tid = threadIdx.x;
  if constexpr (S::VEC) {
    constexpr int CH = MODE == kPairs ? 2 : 4;  // points a 16-byte chunk
    constexpr int NCH = SW / CH;                // chunks a staged row
    constexpr int NP = MODE == kPlanes ? 2 : 1;  // planes staged
    const int n = (r1 - r0) * NCH;
    for (int i = tid; i < NP * n; i += Tile<MODE>::THREADS) {
      const int pl = NP == 1 ? 0 : i / n;
      const int rem = i - pl * n;
      const int ly = r0 + rem / NCH, c = rem % NCH;
      int gy = y0 + ly - R, gx = x0 + c * CH - HX;
      if (!interior) {
        if (gy >= H + R || gx >= W + HX) continue;
        gy = wrap1(gy, H);
        gx = wrap1(gx, W);
      }
      const long long pix = (long long)gy * W + gx;
      if constexpr (MODE == kPlanes) {
        cp_async16(s_u + pl * SH * SW + ly * SW + c * CH, (pl ? ui : ur) + pix);
      } else {
        cp_async16(s_u + 2 * (ly * SW + c * CH), ur + 2 * pix);
      }
    }
  } else {
    for (int i = tid; i < (r1 - r0) * SW; i += Tile<MODE>::THREADS) {
      const int ly = r0 + i / SW, lx = i % SW;
      int gy = y0 + ly - R, gx = x0 + lx - R;
      if (!interior) {
        if (gy >= H + R || gx >= W + R) continue;
        gy = wrap(gy, H);
        gx = wrap(gx, W);
      }
      const long long o = ((long long)gy * W + gx) * p.uxs;
      cp_async4(s_u + ly * SW + lx, ur + o);
      cp_async4(s_u + SH * SW + ly * SW + lx, ui + o);
    }
  }
}

template <int R, int MODE>
__global__ void __launch_bounds__(Tile<MODE>::THREADS)
stencil_residual_kernel(Planes p, const float* __restrict__ cxr,
                        const float* __restrict__ cxi,
                        const float* __restrict__ cyr,
                        const float* __restrict__ cyi, int H, int W) {
  using T = Tile<MODE>;
  using S = Staged<R, MODE>;
  constexpr int V = T::V, NY = T::NY, TY = T::TY, TH = T::TH, TW = T::TW;
  constexpr int NT = 2 * R + 1;
  constexpr int SH = S::SH, SW = S::SW;
  __shared__ __align__(16) float s_u[S::FLOATS];
  __shared__ __align__(16) float s_cx[2][NT][TW];
  __shared__ float s_cy[2][NT][TH];

  const int tid = threadIdx.x;
  const int tx = tid % T::TX, ty = tid / T::TX;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  const bool interior =
      x0 >= S::HX && x0 + TW + S::HX <= W && y0 >= R && y0 + TH + R <= H;
  const float* ur = p.ur + b * p.ubs;
  const float* ui = p.ui + b * p.ubs;

  // 1. the u tile, by cp.async, part by part: part j (output rows
  // [j TY, (j+1) TY)) needs staged rows [j TY, (j+1) TY + 2R), so group 0
  // holds rows [0, TY + 2R) and group j the TY rows after group j-1. Up
  // to AHEAD parts are in flight while one is computed; each thread's k2
  // and s of a part go to registers when its rows are staged.
  const int gx = x0 + tx * V;
  const bool has_s = p.sr != nullptr;
  float kv[NY][V] = {}, svr[NY][V] = {}, svi[NY][V] = {};
  auto stage_part = [&](int j) {
    stage_rows<R, MODE>(s_u, p, ur, ui, j == 0 ? 0 : j * TY + 2 * R,
                        (j + 1) * TY + 2 * R, x0, y0, interior, H, W);
    cp_async_commit();
    const int gy = y0 + j * TY + ty;
    if (gx >= W || gy >= H) return;
    const long long pix = (long long)gy * W + gx;
    const float* k2 = p.k2 + b * p.kbs + pix;
    if constexpr (MODE == kPlanes) {
      const float4 k = __ldg(reinterpret_cast<const float4*>(k2));
      kv[j][0] = k.x, kv[j][1] = k.y, kv[j][2] = k.z, kv[j][3] = k.w;
      if (has_s) {
        const long long o = b * p.sbs + pix;
        const float4 a = __ldg(reinterpret_cast<const float4*>(p.sr + o));
        const float4 c = __ldg(reinterpret_cast<const float4*>(p.si + o));
        svr[j][0] = a.x, svr[j][1] = a.y, svr[j][2] = a.z, svr[j][3] = a.w;
        svi[j][0] = c.x, svi[j][1] = c.y, svi[j][2] = c.z, svi[j][3] = c.w;
      }
    } else if constexpr (MODE == kPairs) {
      const float2 k = __ldg(reinterpret_cast<const float2*>(k2));
      kv[j][0] = k.x, kv[j][1] = k.y;
      if (has_s) {
        const float4 a =
            __ldg(reinterpret_cast<const float4*>(p.sr + b * p.sbs + 2 * pix));
        svr[j][0] = a.x, svi[j][0] = a.y, svr[j][1] = a.z, svi[j][1] = a.w;
      }
    } else {
      kv[j][0] = __ldg(k2);
      if (has_s) {
        const long long o = b * p.sbs + pix * p.sxs;
        svr[j][0] = __ldg(p.sr + o);
        svi[j][0] = __ldg(p.si + o);
      }
    }
  };
  constexpr int AHEAD = T::AHEAD < NY ? T::AHEAD : NY;
#pragma unroll
  for (int j = 0; j < AHEAD; ++j) stage_part(j);

  // 2. the tap tables' slices into shared memory
  for (int i = tid; i < NT * TW; i += T::THREADS) {
    const int t = i / TW, lx = i - t * TW;
    const int c = min(x0 + lx, W - 1);
    s_cx[0][t][lx] = __ldg(cxr + t * W + c);
    s_cx[1][t][lx] = __ldg(cxi + t * W + c);
  }
  for (int i = tid; i < NT * TH; i += T::THREADS) {
    const int t = i / TH, ly = i - t * TH;
    const int c = min(y0 + ly, H - 1);
    s_cy[0][t][ly] = __ldg(cyr + t * H + c);
    s_cy[1][t][ly] = __ldg(cyi + t * H + c);
  }

  // 3. part by part, as its rows land: the taps from shared memory
  constexpr int WL = S::VEC ? 3 * V : NT;  // window of a row for the x taps
  constexpr int WO = S::VEC ? V : R;       // the thread's first point in it
  const int col = S::HX + tx * V;          // staged column of that point
#pragma unroll
  for (int j = 0; j < NY; ++j) {
    if (j + AHEAD < NY) stage_part(j + AHEAD);
    // groups committed: min(j + 1 + AHEAD, NY); part j's is complete when at
    // most the later ones are pending
    cp_async_wait((j + 1 + AHEAD < NY ? j + 1 + AHEAD : NY) - (j + 1));
    __syncthreads();
    const int ly = j * TY + ty;
    const int gy = y0 + ly;
    if (gx >= W || gy >= H) continue;
    const int row = ly + R;
    float wr[WL], wi[WL];
    if constexpr (MODE == kPlanes) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 a =
            *reinterpret_cast<const float4*>(s_u + row * SW + col - V + c * V);
        const float4 d = *reinterpret_cast<const float4*>(
            s_u + SH * SW + row * SW + col - V + c * V);
        wr[4 * c] = a.x, wr[4 * c + 1] = a.y, wr[4 * c + 2] = a.z, wr[4 * c + 3] = a.w;
        wi[4 * c] = d.x, wi[4 * c + 1] = d.y, wi[4 * c + 2] = d.z, wi[4 * c + 3] = d.w;
      }
    } else if constexpr (MODE == kPairs) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 a =
            *reinterpret_cast<const float4*>(s_u + 2 * (row * SW + col - V + c * V));
        wr[2 * c] = a.x, wi[2 * c] = a.y, wr[2 * c + 1] = a.z, wi[2 * c + 1] = a.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        wr[c] = s_u[row * SW + col - R + c];
        wi[c] = s_u[SH * SW + row * SW + col - R + c];
      }
    }

    float ar[V], ai[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      ar[v] = __fmul_rn(kv[j][v], wr[WO + v]);
      ai[v] = __fmul_rn(kv[j][v], wi[WO + v]);
      if (has_s) {
        ar[v] = __fsub_rn(ar[v], svr[j][v]);
        ai[v] = __fsub_rn(ai[v], svi[j][v]);
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      // x tap: column x + t - R
      float cr[V], ci[V];
      if constexpr (MODE == kPlanes) {
        const float4 a = *reinterpret_cast<const float4*>(&s_cx[0][t][tx * V]);
        const float4 d = *reinterpret_cast<const float4*>(&s_cx[1][t][tx * V]);
        cr[0] = a.x, cr[1] = a.y, cr[2] = a.z, cr[3] = a.w;
        ci[0] = d.x, ci[1] = d.y, ci[2] = d.z, ci[3] = d.w;
      } else if constexpr (MODE == kPairs) {
        const float2 a = *reinterpret_cast<const float2*>(&s_cx[0][t][tx * V]);
        const float2 d = *reinterpret_cast<const float2*>(&s_cx[1][t][tx * V]);
        cr[0] = a.x, cr[1] = a.y;
        ci[0] = d.x, ci[1] = d.y;
      } else {
        cr[0] = s_cx[0][t][tx];
        ci[0] = s_cx[1][t][tx];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        cmac(ar[v], ai[v], cr[v], ci[v], wr[WO + v + t - R], wi[WO + v + t - R]);
      }
      // y tap: row y + t - R
      float vr[V], vi[V];
      if (t == R) {
#pragma unroll
        for (int v = 0; v < V; ++v) vr[v] = wr[WO + v], vi[v] = wi[WO + v];
      } else if constexpr (MODE == kPlanes) {
        const float4 a = *reinterpret_cast<const float4*>(s_u + (ly + t) * SW + col);
        const float4 d =
            *reinterpret_cast<const float4*>(s_u + SH * SW + (ly + t) * SW + col);
        vr[0] = a.x, vr[1] = a.y, vr[2] = a.z, vr[3] = a.w;
        vi[0] = d.x, vi[1] = d.y, vi[2] = d.z, vi[3] = d.w;
      } else if constexpr (MODE == kPairs) {
        const float4 a =
            *reinterpret_cast<const float4*>(s_u + 2 * ((ly + t) * SW + col));
        vr[0] = a.x, vi[0] = a.y, vr[1] = a.z, vi[1] = a.w;
      } else {
        vr[0] = s_u[(ly + t) * SW + col];
        vi[0] = s_u[SH * SW + (ly + t) * SW + col];
      }
      const float yr = s_cy[0][t][ly], yi = s_cy[1][t][ly];
#pragma unroll
      for (int v = 0; v < V; ++v) cmac(ar[v], ai[v], yr, yi, vr[v], vi[v]);
    }

    const long long pix = (long long)gy * W + gx;
    if constexpr (MODE == kPlanes) {
      const long long o = b * p.rbs + pix;
      *reinterpret_cast<float4*>(p.rr + o) = make_float4(ar[0], ar[1], ar[2], ar[3]);
      *reinterpret_cast<float4*>(p.ri + o) = make_float4(ai[0], ai[1], ai[2], ai[3]);
    } else if constexpr (MODE == kPairs) {
      *reinterpret_cast<float4*>(p.rr + b * p.rbs + 2 * pix) =
          make_float4(ar[0], ai[0], ar[1], ai[1]);
    } else {
      const long long o = b * p.rbs + pix * p.rxs;
      p.rr[o] = ar[0];
      p.ri[o] = ai[0];
    }
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// Whether the operands fit the instance the wrapper chose (it checks the
// same; this refuses a launch that would read out of line).
bool fits(const Planes& p, int mode, int H, int W, int radius) {
  const bool s = p.sr != nullptr;
  if (mode == kScalar) return true;
  if (H < radius) return false;
  if (mode == kPlanes) {
    return W % 4 == 0 && p.uxs == 1 && p.rxs == 1 && (!s || p.sxs == 1) &&
           aligned(p.ur, 16) && aligned(p.ui, 16) && aligned(p.k2, 16) &&
           aligned(p.rr, 16) && aligned(p.ri, 16) &&
           (!s || (aligned(p.sr, 16) && aligned(p.si, 16) && p.sbs % 4 == 0)) &&
           p.ubs % 4 == 0 && p.kbs % 4 == 0 && p.rbs % 4 == 0;
  }
  if (mode == kPairs) {
    return W % 2 == 0 && p.uxs == 2 && p.rxs == 2 && p.ui == p.ur + 1 &&
           p.ri == p.rr + 1 &&
           (!s || (p.sxs == 2 && p.si == p.sr + 1 && aligned(p.sr, 16) &&
                   p.sbs % 4 == 0)) &&
           aligned(p.ur, 16) && aligned(p.rr, 16) && aligned(p.k2, 8) &&
           p.ubs % 4 == 0 && p.kbs % 2 == 0 && p.rbs % 4 == 0;
  }
  return false;
}

bool valid(const Planes& p, int B, int H, int W, int radius) {
  const bool s_ok = (p.sr == nullptr) == (p.si == nullptr);
  const bool strides = (p.uxs == 1 || p.uxs == 2) && (p.rxs == 1 || p.rxs == 2) &&
                       (p.sr == nullptr || p.sxs == 1 || p.sxs == 2) &&
                       p.ubs >= 0 && p.kbs >= 0 && p.sbs >= 0 && p.rbs >= 0;
  return p.ur != nullptr && p.ui != nullptr && p.k2 != nullptr &&
         p.rr != nullptr && p.ri != nullptr && s_ok && strides &&
         (radius == 1 || radius == 2) && B > 0 && B <= 65535 && H > 0 && W > 0;
}

template <int R, int MODE>
int launch(const Planes& p, const float* cxr, const float* cxi,
           const float* cyr, const float* cyi, int B, int H, int W,
           cudaStream_t stream) {
  using T = Tile<MODE>;
  const dim3 grid((W + T::TW - 1) / T::TW, (H + T::TH - 1) / T::TH, B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  stencil_residual_kernel<R, MODE>
      <<<grid, T::THREADS, 0, stream>>>(p, cxr, cxi, cyr, cyi, H, W);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_radius(const Planes& p, const float* cxr, const float* cxi,
                  const float* cyr, const float* cyi, int B, int H, int W,
                  int radius, cudaStream_t stream) {
  return radius == 1
             ? launch<1, MODE>(p, cxr, cxi, cyr, cyi, B, H, W, stream)
             : launch<2, MODE>(p, cxr, cxi, cyr, cyi, B, H, W, stream);
}

}  // namespace

// K2a, K2b and K2c. Strides in elements; radius 1 or 2; mode 0 (scalar),
// 1 (planes) or 2 (pairs), as ops/stencil_residual.stencil_variant picks.
extern "C" int hn_stencil_residual(
    const float* ur, const float* ui, long long ubs, int uxs, const float* k2,
    long long kbs, const float* sr, const float* si, long long sbs, int sxs,
    float* rr, float* ri, long long rbs, int rxs, const float* cxr,
    const float* cxi, const float* cyr, const float* cyi, int B, int H, int W,
    int radius, int mode, void* stream) {
  Planes p;
  p.ur = ur, p.ui = ui, p.ubs = ubs, p.uxs = uxs;
  p.k2 = k2, p.kbs = kbs;
  p.sr = sr, p.si = si, p.sbs = sbs, p.sxs = sxs;
  p.rr = rr, p.ri = ri, p.rbs = rbs, p.rxs = rxs;
  if (!valid(p, B, H, W, radius) || !fits(p, mode, H, W, radius) ||
      cxr == nullptr || cxi == nullptr || cyr == nullptr || cyi == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlanes:
      return launch_radius<kPlanes>(p, cxr, cxi, cyr, cyi, B, H, W, radius, s);
    case kPairs:
      return launch_radius<kPairs>(p, cxr, cxi, cyr, cyi, B, H, W, radius, s);
    default:
      return launch_radius<kScalar>(p, cxr, cxi, cyr, cyi, B, H, W, radius, s);
  }
}
