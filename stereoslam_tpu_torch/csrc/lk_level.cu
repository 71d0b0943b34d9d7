// Pyramidal Lucas-Kanade for N features, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel stereoslam_tpu/ops/lk_pallas.py::lk_level_pallas,
// with the semantics of the shipped TPU path for the same step
// (ops/lk_batched.py track_level_batched, and final_error_batched for the
// final error): an 11x11 bilinear template with central-difference gradients
// taken at +-0.5 px, the 2x2 structure matrix and its min-eigenvalue gate,
// then up to `iters` inverse-compositional Gauss-Newton steps on the next
// image, each step's flow clipped to +-12 px around the level's initial flow.
// Bilinear taps use integer indices clamped to the image, which replicates
// the edge.
//
// Entry points, all on the same device code:
//   lk_pyramid_launch      B whole pyramidal-LK calls of one shape (ops/lk.py
//                          pyramidal_lk; B = 1 for a single call, B > 1 for
//                          the sequences of a batch, the JAX package's vmap
//                          of the call): every level coarse to fine, the
//                          final error, the status, and with forward_backward
//                          > 0 the backward pass and the round-trip test;
//                          optionally gated by a device flag a sequence.
//                          The grid's second dimension is the sequence, each
//                          level a contiguous (B, H, W) stack, the points
//                          (B, N, 2).  A sequence's result is that of its own
//                          single launch, bit for bit: the per-feature code
//                          is the same and reads only its sequence's slices;
//   lk_level_launch        one level, no fusion;
//   lk_final_error_launch  the mean |J - T| over the window at a given flow.
// The main path launches only lk_pyramid; the per-level entries exist to hold
// the device code against its plain version level by level.
//
// What bounds it on this card.  Bytes: each feature needs a 14x14 template
// region of `prev` and a 36x36 search region of `next` per level, about
// 400 x 1,492 x 4 B = 2.4 MB at a 376x1241 level 0 and 3.5 MB for a
// 3-level call, about 1 us at 3.35 TB/s; the arithmetic (about 1,500 flops a
// feature-iteration) is less.  Beside the roofline, each feature's
// iterations are a dependent chain (sample, reduce, solve, clip, test),
// levels long: that chain, not bandwidth, sets the time at N = 400.
//
// Design.  One warp per feature, four features a block.  At each level the
// warp stages the template region of `prev` and the search region of `next`
// into shared memory with cp.async, the 32 lanes loading neighbouring
// addresses and clamping to the image edge once while staging.  The search
// region is centred on the level's start position; the +-12 px clip keeps
// every later tap inside it, so the iteration loop reads shared memory with
// no clamp and no global address arithmetic.  The rows of both regions are
// 43 floats apart (43 = 11 mod 32), which puts window sample k on bank
// k mod 32: the 32 lanes never collide.  Sums use xor-shuffle butterflies so
// every lane holds the same bits and the per-feature early exit is
// warp-uniform.  The flow stays in registers between levels, the final error
// reuses the level-0 template and window, and the backward pass runs in the
// same warp, so a pyramidal-LK call is one launch.
//
// Exactness.  The lane-to-sample assignment (lane + 32 s), the bilinear
// formula, the butterflies, the clip-then-test exit and the integer bases
// clamped to [-64, 2^24] are those of the first (global-memory) version of
// this kernel, and the staged values are the very taps it read, so a
// level's result is the same bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 11;
constexpr int kRadius = kWindow / 2;
constexpr int kSamples = kWindow * kWindow;         // 121
constexpr int kPerLane = (kSamples + 31) / 32;      // 4
constexpr float kBound = 12.0f;                     // lk_batched.py BOUND
constexpr int kBoundPx = 12;
constexpr int kMaxLevels = 8;
// Features (warps) a block.  One, two and four were within 0.6% of each
// other on the card and eight was 15% slower (PERF.md, Findings).
constexpr int kFeaturesPerBlock = 4;

// Staged regions of one feature at one level (ops/lk_level.py window_plan).
// Template: rows and columns base-6 .. base+7 of `prev` (the window, the
// +-0.5 px gradient taps and the second bilinear tap).  Search: base-18 ..
// base+19 of `next` around the level's start base (the window, +-12 px of
// clip, one px of rounding margin each side and the second bilinear tap).
// Both regions keep rows 43 floats apart (43 = 11 mod 32): window sample k
// of either then falls on bank k mod 32, and the 32 lanes never collide.
constexpr int kTmplPad = kRadius + 1;                       // 6
constexpr int kTmplSide = kWindow + 3;                      // 14
constexpr int kSearchPad = kRadius + kBoundPx + 1;          // 18
constexpr int kSearchSide = kWindow + 2 * kBoundPx + 3;     // 38
constexpr int kPitch = 43;                                  // >= 38 and = 11 mod 32
constexpr int kFeatureFloats = (kTmplSide + kSearchSide) * kPitch;
constexpr int kFeatureBytes = kFeatureFloats * 4;
static_assert(kPitch >= kSearchSide && kPitch % 32 == kWindow, "bank layout");
// A block's windows fit the 48 KB of dynamic shared memory a launch may
// take without raising the kernel's cap.
static_assert(kFeaturesPerBlock * kFeatureBytes <= 48 * 1024, "shared memory a block");

struct Pyramid {
  const float* img[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

struct Pass {
  int iters;
  float eps2, min_eig, max_error;
};

// One feature's lane and its slice of shared memory.
struct Ctx {
  int lane;
  float* tmpl;
  float* win;
};

// Integer part (clamped to a range where int conversion is defined; taps are
// clamped to the image afterwards, so the clamp changes no sample) and
// fractional part of a coordinate.
__device__ __forceinline__ void split(float v, int& base, float& frac) {
  const float f = floorf(v);
  frac = v - f;
  base = static_cast<int>(fminf(fmaxf(f, -64.0f), 16777216.0f));
}

__device__ __forceinline__ float bilinear(const float* s, int pitch, int i, float fy, float fx) {
  const float p00 = s[i], p01 = s[i + 1], p10 = s[i + pitch], p11 = s[i + pitch + 1];
  return p00 * (1.0f - fy) * (1.0f - fx) + p01 * (1.0f - fy) * fx +
         p10 * fy * (1.0f - fx) + p11 * fy * fx;
}

// The sum over the warp; every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ void cp_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// Copy rows/cols [y0, y0 + kSide) x [x0, x0 + kSide) of img, clamped to the
// image, into dst (row pitch kPitch).  Consecutive lanes take consecutive
// columns of a row; a lane keeps its columns (clamped once) for every row
// it copies, and the row loop is unrolled, so the copies issue back to back
// (one warp per scheduler has no other warp to hide a dependent chain).  A
// region narrower than the warp takes several rows per pass.
template <int kSide>
__device__ __forceinline__ void stage(const Ctx& c, float* dst, const float* __restrict__ img,
                                      int H, int W, int y0, int x0) {
  constexpr bool kNarrow = 32 >= kSide;
  constexpr int kRowsPerPass = kNarrow ? 32 / kSide : 1;
  constexpr int kPasses = (kSide + kRowsPerPass - 1) / kRowsPerPass;
  constexpr int kColsPerLane = kNarrow ? 1 : (kSide + 31) / 32;
  const int r0 = kNarrow ? c.lane / kSide : 0;
  const int q0 = kNarrow ? c.lane % kSide : c.lane;
  if (r0 >= kRowsPerPass) return;  // past the last whole row of a pass
  int x[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) x[j] = min(max(x0 + q0 + j * 32, 0), W - 1);
  const unsigned d0 = static_cast<unsigned>(__cvta_generic_to_shared(dst + q0));
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = r0 + i * kRowsPerPass;
    if (r < kSide) {
      const int row = min(max(y0 + r, 0), H - 1) * W;  // 32-bit: an image has < 2^31 pixels
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        if (q0 + j * 32 < kSide) {
          cp_async4(d0 + 4 * (r * kPitch + j * 32), img + (row + x[j]));
        }
      }
    }
  }
}

// A level's per-lane state: the template samples, their offsets in the
// search window, the window's origin and the structure matrix's inverse.
struct Level {
  float T[kPerLane], Ix[kPerLane], Iy[kPerLane];
  int off[kPerLane];
  int sy0, sx0;
  float inv11, inv12, inv22;
  bool good;
};

// Stage the template region around (px, py) and the search region around
// (px + flx, py + fly), then build the template, its gradients and the
// structure matrix.
__device__ __forceinline__ void begin_level(const Ctx& c, Level& L, const float* __restrict__ prev,
                                            const float* __restrict__ next, int H, int W,
                                            float px, float py, float flx, float fly,
                                            float min_eig) {
  int bx, by, bxm, bxp, bym, byp, cx, cy;
  float ax, ay, axm, axp, aym, ayp, acx, acy;
  split(px, bx, ax);
  split(py, by, ay);
  split(px - 0.5f, bxm, axm);
  split(px + 0.5f, bxp, axp);
  split(py - 0.5f, bym, aym);
  split(py + 0.5f, byp, ayp);
  split(px + flx, cx, acx);
  split(py + fly, cy, acy);
  L.sy0 = cy - kSearchPad;
  L.sx0 = cx - kSearchPad;

  __syncwarp();  // every lane is done with the previous level's windows
  // Two copy groups: the template is built while the search window lands.
  stage<kTmplSide>(c, c.tmpl, prev, H, W, by - kTmplPad, bx - kTmplPad);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage<kSearchSide>(c, c.win, next, H, W, L.sy0, L.sx0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncwarp();

  float g11 = 0.0f, g12 = 0.0f, g22 = 0.0f;
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int k = c.lane + 32 * s;
    const bool active = k < kSamples;
    const int oy = active ? k / kWindow - kRadius : 0;
    const int ox = active ? k % kWindow - kRadius : 0;
    L.off[s] = oy * kPitch + ox;
    // (by + oy, bx + ox) in the staged template; bxm, bxp, bym, byp differ
    // from bx, by by at most one.
    const int i = (kTmplPad + oy) * kPitch + kTmplPad + ox;
    const float t = bilinear(c.tmpl, kPitch, i, ay, ax);
    const float gx = bilinear(c.tmpl, kPitch, i + (bxp - bx), ay, axp) -
                     bilinear(c.tmpl, kPitch, i + (bxm - bx), ay, axm);
    const float gy = bilinear(c.tmpl, kPitch, i + (byp - by) * kPitch, ayp, ax) -
                     bilinear(c.tmpl, kPitch, i + (bym - by) * kPitch, aym, ax);
    L.T[s] = active ? t : 0.0f;
    L.Ix[s] = active ? gx : 0.0f;
    L.Iy[s] = active ? gy : 0.0f;
    g11 += L.Ix[s] * L.Ix[s];
    g12 += L.Ix[s] * L.Iy[s];
    g22 += L.Iy[s] * L.Iy[s];
  }
  g11 = warp_sum(g11);
  g12 = warp_sum(g12);
  g22 = warp_sum(g22);
  const float det = g11 * g22 - g12 * g12;
  const float trace = g11 + g22;
  const float min_eig_val = (trace - sqrtf(fmaxf(trace * trace - 4.0f * det, 0.0f))) * 0.5f;
  L.good = min_eig_val / static_cast<float>(kSamples) > min_eig;
  const float det_safe = fabsf(det) < 1e-12f ? 1e-12f : det;
  L.inv11 = g22 / det_safe;
  L.inv12 = -g12 / det_safe;
  L.inv22 = g11 / det_safe;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// Index in the staged search window of the bilinear base at (x, y).  The
// clip keeps it inside [kRadius, kSearchSide - kRadius - 2]; the clamp only
// guards memory.
__device__ __forceinline__ int window_base(const Level& L, float x, float y, float& ajx,
                                           float& ajy) {
  int jx, jy;
  split(x, jx, ajx);
  split(y, jy, ajy);
  const int ry = min(max(jy - L.sy0, kRadius), kSearchSide - kRadius - 2);
  const int rx = min(max(jx - L.sx0, kRadius), kSearchSide - kRadius - 2);
  return ry * kPitch + rx;
}

// Up to `iters` Gauss-Newton steps from the level's initial flow (fx0, fy0).
// A lane's slot past the 121st sample holds T = Ix = Iy = 0 and reads a
// valid window position, so it adds r * 0 = +-0 to sums that are never -0:
// the sums equal those that skip the slot, and the loop has no divergent
// branch.
__device__ __forceinline__ void iterate(const Ctx& c, const Level& L, float px, float py,
                                        float& flx, float& fly, int iters, float eps2) {
  const float fx0 = flx, fy0 = fly;
  if (!L.good) return;
  for (int it = 0; it < iters; ++it) {
    float ajx, ajy;
    const int base = window_base(L, px + flx, py + fly, ajx, ajy);
    float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
    for (int s = 0; s < kPerLane; ++s) {
      const float r = bilinear(c.win, kPitch, base + L.off[s], ajy, ajx) - L.T[s];
      b1 += r * L.Ix[s];
      b2 += r * L.Iy[s];
    }
    b1 = warp_sum(b1);
    b2 = warp_sum(b2);
    const float dx = -(L.inv11 * b1 + L.inv12 * b2);
    const float dy = -(L.inv12 * b1 + L.inv22 * b2);
    flx = fminf(fmaxf(flx + dx, fx0 - kBound), fx0 + kBound);
    fly = fminf(fmaxf(fly + dy, fy0 - kBound), fy0 + kBound);
    if (dx * dx + dy * dy < eps2) break;  // uniform: every lane holds the same sums
  }
}

// Mean |J - T| over the window at flow (flx, fly), from the staged windows.
// A slot past the 121st sample adds 0 * |J - T| = +0.
__device__ __forceinline__ float final_error(const Ctx& c, const Level& L, float px, float py,
                                             float flx, float fly) {
  float ajx, ajy;
  const int base = window_base(L, px + flx, py + fly, ajx, ajy);
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const float used = c.lane + 32 * s < kSamples ? 1.0f : 0.0f;
    acc += used * fabsf(bilinear(c.win, kPitch, base + L.off[s], ajy, ajx) - L.T[s]);
  }
  return warp_sum(acc) / static_cast<float>(kSamples);
}

// Sequence `seq`'s image at level `lvl` of a pyramid whose levels are
// contiguous (B, H, W) stacks (B = 1 for a single call).
__device__ __forceinline__ const float* level_image(const Pyramid& p, int lvl, int seq) {
  return p.img[lvl] + static_cast<size_t>(seq) * p.h[lvl] * p.w[lvl];
}

// One pyramidal-LK pass (ops/lk.py lk_pyramid without forward-backward):
// track (px, py) from pyramid a to pyramid b seeded at (ix, iy), in
// sequence `seq` of the pyramids' stacks.
__device__ __forceinline__ void pyramid_pass(const Ctx& c, const Pyramid& a, const Pyramid& b,
                                             int seq, int n_levels, float px, float py, float ix,
                                             float iy, const Pass& p, float& qx, float& qy,
                                             bool& status, float& err) {
  const float top = static_cast<float>(1 << (n_levels - 1));
  float flx = (ix - px) / top, fly = (iy - py) / top;
  Level L;
  for (int lvl = n_levels - 1; lvl >= 0; --lvl) {
    const float scale = static_cast<float>(1 << lvl);
    const float lx = px / scale, ly = py / scale;
    begin_level(c, L, level_image(a, lvl, seq), level_image(b, lvl, seq), a.h[lvl], a.w[lvl],
                lx, ly, flx, fly, p.min_eig);
    iterate(c, L, lx, ly, flx, fly, p.iters, p.eps2);
    if (lvl > 0) {
      flx *= 2.0f;
      fly *= 2.0f;
    }
  }
  qx = px + flx;
  qy = py + fly;
  const bool in_bounds = qx >= static_cast<float>(kRadius) &&
                         qx < static_cast<float>(a.w[0] - kRadius) &&
                         qy >= static_cast<float>(kRadius) &&
                         qy < static_cast<float>(a.h[0] - kRadius);
  err = final_error(c, L, px, py, flx, fly);
  status = L.good && in_bounds && err < p.max_error;
}

// This lane's feature and its warp's slice of shared memory; false past N.
__device__ __forceinline__ bool make_ctx(Ctx& c, int& f, int N) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  c.lane = threadIdx.x & 31;
  c.tmpl = smem + warp * kFeatureFloats;
  c.win = c.tmpl + kTmplSide * kPitch;
  f = blockIdx.x * kFeaturesPerBlock + warp;
  return f < N;  // uniform over the warp: its lanes leave together
}

// blockIdx.y is the sequence; every pointer below is moved to its slice.
__global__ void lk_pyramid_kernel(Pyramid a, Pyramid b, int n_levels, int fb_levels,
                                  const float* __restrict__ pts_prev,
                                  const float* __restrict__ pts_init, int N, Pass fwd, Pass bwd,
                                  float fb_threshold, const uint8_t* __restrict__ gate,
                                  float* __restrict__ pts_out,
                                  uint8_t* __restrict__ status_out, float* __restrict__ err_out) {
  Ctx c;
  int f;
  if (!make_ctx(c, f, N)) return;
  const int seq = blockIdx.y;
  pts_prev += static_cast<size_t>(seq) * 2 * N;
  pts_init += static_cast<size_t>(seq) * 2 * N;
  pts_out += static_cast<size_t>(seq) * 2 * N;
  status_out += static_cast<size_t>(seq) * N;
  err_out += static_cast<size_t>(seq) * N;
  if (gate != nullptr && gate[seq] == 0) {
    // Gated off: the call keeps no track (points at their seeds, error 0).
    if (c.lane == 0) {
      pts_out[2 * f] = pts_init[2 * f];
      pts_out[2 * f + 1] = pts_init[2 * f + 1];
      status_out[f] = 0;
      err_out[f] = 0.0f;
    }
    return;
  }
  const float px = pts_prev[2 * f], py = pts_prev[2 * f + 1];
  float qx, qy, err;
  bool status;
  pyramid_pass(c, a, b, seq, n_levels, px, py, pts_init[2 * f], pts_init[2 * f + 1], fwd, qx,
               qy, status, err);
  if (fb_threshold > 0.0f) {
    // Re-track back from (qx, qy) at zero flow over the finest fb_levels.
    const int nb = fb_levels > 0 ? min(fb_levels, n_levels) : n_levels;
    float rx, ry, err_back;
    bool status_back;
    pyramid_pass(c, b, a, seq, nb, qx, qy, qx, qy, bwd, rx, ry, status_back, err_back);
    const float dx = rx - px, dy = ry - py;
    status = status && status_back && sqrtf(dx * dx + dy * dy) <= fb_threshold;
  }
  if (c.lane == 0) {
    pts_out[2 * f] = qx;
    pts_out[2 * f + 1] = qy;
    status_out[f] = status ? 1 : 0;
    err_out[f] = err;
  }
}

__global__ void lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ next,
                                int H, int W, const float* __restrict__ pts,
                                const float* __restrict__ flow_in, float* __restrict__ flow_out,
                                uint8_t* __restrict__ good_out, int N, int iters, float eps2,
                                float min_eig) {
  Ctx c;
  int f;
  if (!make_ctx(c, f, N)) return;
  const float px = pts[2 * f], py = pts[2 * f + 1];
  float flx = flow_in[2 * f], fly = flow_in[2 * f + 1];
  Level L;
  begin_level(c, L, prev, next, H, W, px, py, flx, fly, min_eig);
  iterate(c, L, px, py, flx, fly, iters, eps2);
  if (c.lane == 0) {
    flow_out[2 * f] = flx;
    flow_out[2 * f + 1] = fly;
    good_out[f] = L.good ? 1 : 0;
  }
}

__global__ void lk_final_error_kernel(const float* __restrict__ prev,
                                      const float* __restrict__ next, int H, int W,
                                      const float* __restrict__ pts,
                                      const float* __restrict__ flow, float* __restrict__ err_out,
                                      int N) {
  Ctx c;
  int f;
  if (!make_ctx(c, f, N)) return;
  const float px = pts[2 * f], py = pts[2 * f + 1];
  const float flx = flow[2 * f], fly = flow[2 * f + 1];
  Level L;
  begin_level(c, L, prev, next, H, W, px, py, flx, fly, 0.0f);
  const float err = final_error(c, L, px, py, flx, fly);
  if (c.lane == 0) err_out[f] = err;
}

// The launch shape for N features, or false when the caller's size of the
// staged windows disagrees with the kernel's.
bool launch_shape(int N, int smem_bytes_per_feature, dim3& grid, dim3& block, size_t& smem) {
  if (smem_bytes_per_feature != kFeatureBytes) return false;
  grid = dim3((N + kFeaturesPerBlock - 1) / kFeaturesPerBlock);
  block = dim3(32 * kFeaturesPerBlock);
  smem = static_cast<size_t>(kFeaturesPerBlock) * kFeatureBytes;
  return true;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream` and
// returns a CUDA error code (cudaGetLastError() after the launch) so the
// caller can raise on a refused launch.  `smem_bytes_per_feature` is the
// caller's size of the staged windows; a mismatch is refused.  `gate`, where
// not null, points to one byte on the device (one a sequence for a batched
// launch) that the kernel reads first: 0 makes the call keep no track
// (status 0, points at pts_init, error 0) without touching the images, so a
// host-free caller can launch a conditional call unconditionally; null or
// nonzero runs the call as is.
extern "C" int lk_pyramid_launch(const void* const* prev, const void* const* next, const int* hs,
                                 const int* ws, int n_levels, int fb_levels, const float* pts_prev,
                                 const float* pts_init, int B, int N, int iters, int fb_iters,
                                 float eps2, float min_eig, float max_error, float fb_threshold,
                                 const uint8_t* gate, float* pts_out, uint8_t* status_out,
                                 float* err_out, int smem_bytes_per_feature, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N <= 0 || B <= 0) return 0;
  Pyramid a{}, b{};
  for (int l = 0; l < n_levels; ++l) {
    a.img[l] = static_cast<const float*>(prev[l]);
    b.img[l] = static_cast<const float*>(next[l]);
    a.h[l] = b.h[l] = hs[l];
    a.w[l] = b.w[l] = ws[l];
  }
  const Pass fwd{iters, eps2, min_eig, max_error};
  const Pass bwd{fb_iters, eps2, min_eig, max_error};
  dim3 grid, block;
  size_t smem;
  if (!launch_shape(N, smem_bytes_per_feature, grid, block, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  grid.y = B;
  lk_pyramid_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      a, b, n_levels, fb_levels, pts_prev, pts_init, N, fwd, bwd, fb_threshold, gate, pts_out,
      status_out, err_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lk_level_launch(const float* prev, const float* next, int H, int W,
                               const float* pts, const float* flow_in, float* flow_out,
                               uint8_t* good_out, int N, int iters, float eps2, float min_eig,
                               int smem_bytes_per_feature, void* stream) {
  if (N <= 0) return 0;
  dim3 grid, block;
  size_t smem;
  if (!launch_shape(N, smem_bytes_per_feature, grid, block, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lk_level_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      prev, next, H, W, pts, flow_in, flow_out, good_out, N, iters, eps2, min_eig);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lk_final_error_launch(const float* prev, const float* next, int H, int W,
                                     const float* pts, const float* flow, float* err_out, int N,
                                     int smem_bytes_per_feature, void* stream) {
  if (N <= 0) return 0;
  dim3 grid, block;
  size_t smem;
  if (!launch_shape(N, smem_bytes_per_feature, grid, block, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lk_final_error_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      prev, next, H, W, pts, flow, err_out, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lk_window() { return kWindow; }
extern "C" int lk_max_levels() { return kMaxLevels; }
