// Fused DoubleConv for Hopper (sm_90a): conv3x3 (pad 1) -> PReLU -> conv3x3
// (pad 1), optionally followed by a 1x1 conv (the UNet's outc head).
//
// Replaces the TPU kernel helmnet_tpu/ops/pallas_pixconv.py:251
// (fused_double_conv_pix, body `_kernel` at :149). The TPU design packs 16
// pixels per 128-lane row with banded block-Toeplitz weights and an edge
// block built with pltpu.roll, all to fill the MXU's lanes; none of that
// is carried over. Here one thread block computes one 16x16 output tile of
// one sample:
//   1. stage both weight sets (rounded to bf16) and the input tile with a
//      2-pixel halo (20x20, rounded to bf16) in shared memory. The input
//      may come in two channel parts (signal and skip or state), read
//      through separate pointers, so no concatenated copy exists in device
//      memory;
//   2. conv1 + bias + PReLU on the 18x18 intermediate, kept in shared
//      memory. Conv2's zero padding means the intermediate is ZERO outside
//      the image (not conv1 evaluated in the padding ring): the ring is
//      masked on every edge tile;
//   3. conv2 + bias, then optionally the 1x1 head + bias, written as NHWC.
// Precision follows the TPU kernel: x, h1 and h2 (before the head) are
// rounded to bf16 where they enter a product, weights are bf16, and
// accumulation, bias and PReLU are f32.
//
// What bounds it on this card: at 96^2 x B32 the decode[0] call (8+8 -> 8
// -> 8 channels, 1x1 head to 2) moves about 21 MB and does about 1 GFLOP
// of bf16 x bf16 products with f32 sums: 6.3 us of HBM traffic at
// 3.35 TB/s against 1.0 us on the tensor cores at 989 TFLOP/s, so the
// function is bound by bytes. This first version runs the FMAs on the
// CUDA cores (67 TFLOP/s in f32, 15 us for that call) with the weights
// broadcast from shared memory, so the design itself is bound by
// operations; moving the taps onto the tensor cores (mma / wgmma on the
// bf16 operands) is later work.
//
// Plain C entry point, bound from Python with ctypes (ops/double_conv.py).
// It launches on the caller's stream, does not synchronise, allocates
// nothing, and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE = 16;                 // output tile edge
constexpr int MID = TILE + 2;            // intermediate tile edge
constexpr int IN = TILE + 4;             // input tile edge (2-pixel halo)
constexpr int IN_PLANE = IN * IN + 1;    // odd plane strides spread banks
constexpr int MID_PLANE = MID * MID + 1;
constexpr int THREADS = TILE * TILE;
constexpr int MAX_C = 16;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// CMP, COP: mid and out channel counts padded to 4, 8 or 16 (zero weights
// in the padding), so accumulators live in registers and weight rows load
// as float4 broadcasts.
template <int CMP, int COP>
__global__ void __launch_bounds__(THREADS)
double_conv_kernel(const float* __restrict__ x1, int c1,
                   const float* __restrict__ x2, int c2,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ slope,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ w3, const float* __restrict__ b3,
                   float* __restrict__ out, int H, int W, int cm, int co,
                   int ce) {
  extern __shared__ __align__(16) float smem[];
  const int cin = c1 + c2;
  float* w1s = smem;                   // [cin * 9][CMP]
  float* w2s = w1s + cin * 9 * CMP;    // [CMP * 9][COP]
  float* w3s = w2s + CMP * 9 * COP;    // [MAX_C][COP]
  float* b1s = w3s + MAX_C * COP;      // [CMP]
  float* b2s = b1s + CMP;              // [COP]
  float* xs = b2s + COP;               // [cin][IN_PLANE]
  float* hs = xs + cin * IN_PLANE;     // [CMP][MID_PLANE]

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;

  // weights, OIHW in device memory -> [tap-row][out] in shared memory
  for (int i = tid; i < cin * 9 * CMP; i += THREADS) {
    const int m = i % CMP, r = i / CMP;  // r = ci * 9 + tap
    w1s[i] = m < cm ? bf16r(w1[(m * cin + r / 9) * 9 + r % 9]) : 0.f;
  }
  for (int i = tid; i < CMP * 9 * COP; i += THREADS) {
    const int o = i % COP, r = i / COP;  // r = m * 9 + tap
    const int m = r / 9;
    w2s[i] = (o < co && m < cm) ? bf16r(w2[(o * cm + m) * 9 + r % 9]) : 0.f;
  }
  if (w3 != nullptr) {
    for (int i = tid; i < ce * COP; i += THREADS) {
      const int o = i % COP, e = i / COP;
      w3s[i] = o < co ? bf16r(w3[e * co + o]) : 0.f;
    }
  }
  if (tid < CMP) b1s[tid] = tid < cm ? b1[tid] : 0.f;
  if (tid < COP) b2s[tid] = tid < co ? b2[tid] : 0.f;
  const float a = slope != nullptr ? *slope : 0.f;  // no slope: ReLU

  // input tile with its halo; zero outside the image (conv1's padding)
  for (int i = tid; i < IN * IN * cin; i += THREADS) {
    const int c = i % cin, p = i / cin;
    const int gy = y0 - 2 + p / IN, gx = x0 - 2 + p % IN;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t pix = ((size_t)n * H + gy) * W + gx;
      v = c < c1 ? x1[pix * c1 + c] : x2[pix * c2 + (c - c1)];
    }
    xs[c * IN_PLANE + p] = bf16r(v);
  }
  __syncthreads();

  // conv1 + bias + PReLU over the 18x18 intermediate
  for (int q = tid; q < MID * MID; q += THREADS) {
    const int qy = q / MID, qx = q % MID;
    const int gy = y0 - 1 + qy, gx = x0 - 1 + qx;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float acc[CMP];
#pragma unroll
    for (int m = 0; m < CMP; ++m) acc[m] = 0.f;
    if (inside) {
      for (int ci = 0; ci < cin; ++ci) {
        const float* xp = xs + ci * IN_PLANE + qy * IN + qx;
        const float* wp = w1s + ci * 9 * CMP;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float v = xp[(t / 3) * IN + t % 3];
#pragma unroll
          for (int m = 0; m < CMP; m += 4) {
            const float4 w = *reinterpret_cast<const float4*>(wp + t * CMP + m);
            acc[m] = fmaf(v, w.x, acc[m]);
            acc[m + 1] = fmaf(v, w.y, acc[m + 1]);
            acc[m + 2] = fmaf(v, w.z, acc[m + 2]);
            acc[m + 3] = fmaf(v, w.w, acc[m + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < CMP; ++m) {
      const float h = acc[m] + b1s[m];
      const float act = fmaxf(h, 0.f) + a * fminf(h, 0.f);
      hs[m * MID_PLANE + q] = inside ? bf16r(act) : 0.f;
    }
  }
  __syncthreads();

  // conv2 + bias (+ 1x1 head) for this thread's output pixel
  const int ty = tid / TILE, tx = tid % TILE;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy >= H || gx >= W) return;
  float acc[COP];
#pragma unroll
  for (int o = 0; o < COP; ++o) acc[o] = 0.f;
#pragma unroll
  for (int m = 0; m < CMP; ++m) {
    const float* hp = hs + m * MID_PLANE + ty * MID + tx;
    const float* wp = w2s + m * 9 * COP;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float v = hp[(t / 3) * MID + t % 3];
#pragma unroll
      for (int o = 0; o < COP; o += 4) {
        const float4 w = *reinterpret_cast<const float4*>(wp + t * COP + o);
        acc[o] = fmaf(v, w.x, acc[o]);
        acc[o + 1] = fmaf(v, w.y, acc[o + 1]);
        acc[o + 2] = fmaf(v, w.z, acc[o + 2]);
        acc[o + 3] = fmaf(v, w.w, acc[o + 3]);
      }
    }
  }
  const size_t pix = ((size_t)n * H + gy) * W + gx;
  if (w3 != nullptr) {
    float h2[COP];
#pragma unroll
    for (int o = 0; o < COP; ++o) h2[o] = bf16r(acc[o] + b2s[o]);
    for (int e = 0; e < ce; ++e) {
      float s = 0.f;
#pragma unroll
      for (int o = 0; o < COP; ++o) s = fmaf(h2[o], w3s[e * COP + o], s);
      out[pix * ce + e] = s + b3[e];
    }
  } else {
#pragma unroll
    for (int o = 0; o < COP; ++o) {
      if (o < co) out[pix * co + o] = acc[o] + b2s[o];
    }
  }
}

int pad_channels(int c) { return c <= 4 ? 4 : (c <= 8 ? 8 : 16); }

template <int CMP, int COP>
cudaError_t launch(const float* x1, int c1, const float* x2, int c2,
                   const float* w1, const float* b1, const float* slope,
                   const float* w2, const float* b2, const float* w3,
                   const float* b3, float* out, int B, int H, int W, int cm,
                   int co, int ce, cudaStream_t stream) {
  const int cin = c1 + c2;
  const size_t floats = (size_t)cin * 9 * CMP + CMP * 9 * COP + MAX_C * COP +
                        CMP + COP + (size_t)cin * IN_PLANE + CMP * MID_PLANE;
  const size_t bytes = floats * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        double_conv_kernel<CMP, COP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  double_conv_kernel<CMP, COP><<<grid, THREADS, bytes, stream>>>(
      x1, c1, x2, c2, w1, b1, slope, w2, b2, w3, b3, out, H, W, cm, co, ce);
  return cudaGetLastError();
}

}  // namespace

// x1: [B, H, W, c1] and x2: [B, H, W, c2] (x2 may be null with c2 = 0);
// w1: [cm, c1 + c2, 3, 3], b1: [cm]; slope: [1] or null (ReLU);
// w2: [co, cm, 3, 3], b2: [co]; w3: [ce, co] and b3: [ce], or both null;
// out: [B, H, W, ce] (ce = co without the head). All f32, contiguous.
extern "C" int hn_double_conv(const float* x1, int c1, const float* x2, int c2,
                              const float* w1, const float* b1,
                              const float* slope, const float* w2,
                              const float* b2, const float* w3,
                              const float* b3, float* out, int B, int H, int W,
                              int cm, int co, int ce, void* stream) {
  if (x1 == nullptr || c1 <= 0 || c2 < 0 || (c2 > 0 && x2 == nullptr) ||
      c1 + c2 > MAX_C || cm <= 0 || cm > MAX_C || co <= 0 || co > MAX_C ||
      B <= 0 || B > 65535 || H <= 0 || W <= 0 || (H + TILE - 1) / TILE > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (w3 == nullptr) {
    ce = co;
  } else if (ce <= 0 || ce > MAX_C || b3 == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HN_CASE(M, O)                                                        \
  if (pad_channels(cm) == M && pad_channels(co) == O)                        \
    return (int)launch<M, O>(x1, c1, x2, c2, w1, b1, slope, w2, b2, w3, b3, \
                             out, B, H, W, cm, co, ce, s);
  HN_CASE(4, 4) HN_CASE(4, 8) HN_CASE(4, 16)
  HN_CASE(8, 4) HN_CASE(8, 8) HN_CASE(8, 16)
  HN_CASE(16, 4) HN_CASE(16, 8) HN_CASE(16, 16)
#undef HN_CASE
  return (int)cudaErrorInvalidValue;
}
