// One pyramidal Lucas-Kanade level for N features, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel stereoslam_tpu/ops/lk_pallas.py::lk_level_pallas
// (and the shipped TPU path for the same step, ops/lk_batched.py
// track_level_batched, whose semantics it matches): an 11x11 bilinear
// template with central-difference gradients taken at +-0.5 px, the 2x2
// structure matrix and its min-eigenvalue gate, then up to `iters`
// inverse-compositional Gauss-Newton steps on the next image, each step's
// flow clipped to +-12 px around the level's initial flow.  Bilinear taps use
// integer indices clamped to the image, which replicates the edge.
//
// What bounds it on this card: each iteration of each feature reads the
// 4 bilinear taps of 121 window samples from the next image — about
// 400 features x 121 samples x 4 taps per iteration at the main-path shapes,
// plus 121 x 3 x 4 taps per feature for the template and its two gradients.
// A 376x1241 f32 level is 1.9 MB and stays resident in the 50 MB L2, so the
// reads are L2 hits: the kernel is bound by gather latency and by the
// dependent chain of 20 iterations, not by DRAM bandwidth or FLOPs.
//
// Design: one warp per feature.  Each lane keeps ~4 of the 121 window samples
// of T, Ix and Iy in registers for the whole level; per-iteration sums
// (b1, b2) and the structure matrix use xor-shuffle butterflies, so every
// lane holds the same bit-identical total and the per-feature early exit on
// convergence is warp-uniform (the TPU kernel had to run every iteration
// masked; here a converged feature simply stops).  Image reads go through
// the read-only cache (__ldg).  Shared-memory windows, several features per
// warp and fusing levels are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 11;
constexpr int kRadius = kWindow / 2;
constexpr int kSamples = kWindow * kWindow;         // 121
constexpr int kPerLane = (kSamples + 31) / 32;      // 4
constexpr float kBound = 12.0f;                     // lk_batched.py BOUND
constexpr int kWarpsPerBlock = 4;

// Integer part (clamped to a range where int conversion is defined; taps are
// clamped to the image afterwards, so the clamp changes no sample) and
// fractional part of a coordinate.
__device__ __forceinline__ void split(float v, int& base, float& frac) {
  const float f = floorf(v);
  frac = v - f;
  base = static_cast<int>(fminf(fmaxf(f, -64.0f), 16777216.0f));
}

__device__ __forceinline__ float tap(const float* __restrict__ img, int H, int W, int y, int x) {
  y = min(max(y, 0), H - 1);
  x = min(max(x, 0), W - 1);
  return __ldg(img + static_cast<size_t>(y) * W + x);
}

__device__ __forceinline__ float sample(const float* __restrict__ img, int H, int W,
                                        int by, int bx, float fy, float fx) {
  const float p00 = tap(img, H, W, by, bx);
  const float p01 = tap(img, H, W, by, bx + 1);
  const float p10 = tap(img, H, W, by + 1, bx);
  const float p11 = tap(img, H, W, by + 1, bx + 1);
  return p00 * (1.0f - fy) * (1.0f - fx) + p01 * (1.0f - fy) * fx +
         p10 * fy * (1.0f - fx) + p11 * fy * fx;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ next, int H, int W,
                const float* __restrict__ pts, const float* __restrict__ flow_in,
                float* __restrict__ flow_out, uint8_t* __restrict__ good_out,
                int N, int iters, float eps2, float min_eig) {
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= N) return;  // f is warp-uniform: the whole warp leaves together

  const float px = pts[2 * f], py = pts[2 * f + 1];
  const float fx0 = flow_in[2 * f], fy0 = flow_in[2 * f + 1];

  int bx, by, bxm, bxp, bym, byp;
  float ax, ay, axm, axp, aym, ayp;
  split(px, bx, ax);
  split(py, by, ay);
  split(px - 0.5f, bxm, axm);
  split(px + 0.5f, bxp, axp);
  split(py - 0.5f, bym, aym);
  split(py + 0.5f, byp, ayp);

  float T[kPerLane], Ix[kPerLane], Iy[kPerLane];
  int oy[kPerLane], ox[kPerLane];
  float g11 = 0.0f, g12 = 0.0f, g22 = 0.0f;
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int k = lane + 32 * s;
    const bool active = k < kSamples;
    oy[s] = active ? k / kWindow - kRadius : 0;
    ox[s] = active ? k % kWindow - kRadius : 0;
    const float t = sample(prev, H, W, by + oy[s], bx + ox[s], ay, ax);
    const float gx = sample(prev, H, W, by + oy[s], bxp + ox[s], ay, axp) -
                     sample(prev, H, W, by + oy[s], bxm + ox[s], ay, axm);
    const float gy = sample(prev, H, W, byp + oy[s], bx + ox[s], ayp, ax) -
                     sample(prev, H, W, bym + oy[s], bx + ox[s], aym, ax);
    T[s] = active ? t : 0.0f;
    Ix[s] = active ? gx : 0.0f;
    Iy[s] = active ? gy : 0.0f;
    g11 += Ix[s] * Ix[s];
    g12 += Ix[s] * Iy[s];
    g22 += Iy[s] * Iy[s];
  }
  g11 = warp_sum(g11);
  g12 = warp_sum(g12);
  g22 = warp_sum(g22);

  const float det = g11 * g22 - g12 * g12;
  const float trace = g11 + g22;
  const float min_eig_val = (trace - sqrtf(fmaxf(trace * trace - 4.0f * det, 0.0f))) * 0.5f;
  const bool good = min_eig_val / static_cast<float>(kSamples) > min_eig;
  const float det_safe = fabsf(det) < 1e-12f ? 1e-12f : det;
  const float inv11 = g22 / det_safe, inv12 = -g12 / det_safe, inv22 = g11 / det_safe;

  float flx = fx0, fly = fy0;
  if (good) {
    for (int it = 0; it < iters; ++it) {
      int jx, jy;
      float ajx, ajy;
      split(px + flx, jx, ajx);
      split(py + fly, jy, ajy);
      float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
      for (int s = 0; s < kPerLane; ++s) {
        if (lane + 32 * s < kSamples) {
          const float r = sample(next, H, W, jy + oy[s], jx + ox[s], ajy, ajx) - T[s];
          b1 += r * Ix[s];
          b2 += r * Iy[s];
        }
      }
      b1 = warp_sum(b1);
      b2 = warp_sum(b2);
      const float dx = -(inv11 * b1 + inv12 * b2);
      const float dy = -(inv12 * b1 + inv22 * b2);
      flx = fminf(fmaxf(flx + dx, fx0 - kBound), fx0 + kBound);
      fly = fminf(fmaxf(fly + dy, fy0 - kBound), fy0 + kBound);
      if (dx * dx + dy * dy < eps2) break;  // warp-uniform: b1, b2 agree on every lane
    }
  }
  if (lane == 0) {
    flow_out[2 * f] = flx;
    flow_out[2 * f + 1] = fly;
    good_out[f] = good ? 1 : 0;
  }
}

// Mean |J - T| over the window at the given flow (ops/lk.py _final_error).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lk_final_error_kernel(const float* __restrict__ prev, const float* __restrict__ next, int H, int W,
                      const float* __restrict__ pts, const float* __restrict__ flow,
                      float* __restrict__ err_out, int N) {
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= N) return;

  const float px = pts[2 * f], py = pts[2 * f + 1];
  int bx, by, jx, jy;
  float ax, ay, ajx, ajy;
  split(px, bx, ax);
  split(py, by, ay);
  split(px + flow[2 * f], jx, ajx);
  split(py + flow[2 * f + 1], jy, ajy);

  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int k = lane + 32 * s;
    if (k < kSamples) {
      const int i = k / kWindow - kRadius, j = k % kWindow - kRadius;
      acc += fabsf(sample(next, H, W, jy + i, jx + j, ajy, ajx) -
                   sample(prev, H, W, by + i, bx + j, ay, ax));
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) err_out[f] = acc / static_cast<float>(kSamples);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream` and
// returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int lk_level_launch(const float* prev, const float* next, int H, int W,
                               const float* pts, const float* flow_in, float* flow_out,
                               uint8_t* good_out, int N, int iters, float eps2, float min_eig,
                               void* stream) {
  if (N > 0) {
    const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
    lk_level_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        prev, next, H, W, pts, flow_in, flow_out, good_out, N, iters, eps2, min_eig);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lk_final_error_launch(const float* prev, const float* next, int H, int W,
                                     const float* pts, const float* flow, float* err_out, int N,
                                     void* stream) {
  if (N > 0) {
    const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
    lk_final_error_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        prev, next, H, W, pts, flow, err_out, N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lk_window() { return kWindow; }
