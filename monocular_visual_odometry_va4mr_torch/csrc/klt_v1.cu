// The v1 translation-only Lucas-Kanade tracker, one warp per feature.
//
// Replaces the TPU kernel ops/klt_pallas.py::_klt_kernel of the JAX package
// (launched by _run_klt_kernel, klt_pallas.py:315-339).  It computes what that
// kernel computes, per feature, in the same float32 operation order:
//   * a slab of 48 x 256 px of the planes edge-padded by 16 px, its base
//     y0 = clip(floor_div(floor(min(py, qy)) + 16 - 12, 8) * 8, 0, Hp - 48),
//     x0 = clip(floor_div(floor(min(px, qx)) + 16 - 96, 128) * 128, 0,
//     Wp - 256), with Hp, Wp the reference's padded plane size;
//   * window origins relative to the slab, ty = (py - 7) - (y0 - 16) for the
//     template and ((qy + gy) - 7) - (y0 - 16) for the search, the integer
//     origin clipped to [0, 31] x [0, 239] and the window blended at the
//     phase of the UNCLIPPED origin;
//   * the 15 x 15 template and its central-difference gradients, the 2x2
//     structure tensor and its min eigenvalue;
//   * num_iters Gauss-Newton updates of g (from 0): the update is applied,
//     THEN the feature freezes once |delta|^2 < eps^2 (a frozen feature never
//     moves again, so the loop stops there);
//   * the final mean absolute residual and the gate
//     ok = in-image & in-slab & min_eig / 225 > thr & resid < max & valid.
// v1 has no +-8 px drift guard and does not sanitise its input positions.
//
// What it does not carry over: the TPU layout (one DMA of a stacked slab per
// feature into VMEM, 8-row aligned loads and the circular sublane / lane rolls
// that re-register them).  It reads the (H, W) planes directly and clamps every
// coordinate to the image, which equals the reference's edge padding for every
// slab row and column.  One departure, by design: the reference's circular
// roll makes row 0 of the template's upward gradient read slab row yi + 23
// when yi % 8 == 0; this kernel reads the true row yi - 1 (ROADMAP.md,
// Queue 3).
//
// Float -> int conversions go through floor_int: NaN gives 0 and values clamp
// to +-1e8, which is what the reference's conversion gives for NaN and, after
// the clips, for any finite input.  min() propagates NaN as jnp.minimum does.
//
// What bounds it on an H100: per-feature latency of dependent, data-addressed
// gathers, as for klt_lk.cu: a 376x1241 f32 plane is 1.9 MB against 50 MB of
// L2, there is little arithmetic per byte, and each Gauss-Newton iteration
// waits on the gathers of the previous one.  The design keeps each warp's
// template, gradients and partial sums in registers (at most 8 of the 225
// window pixels per lane), reduces with __shfl_xor_sync, reads through the
// read-only path (__ldg) and runs 4 features per 128-thread block so many
// warps are in flight to hide the gather latency.
//
// Entry point: klt_v1_launch (plain C, loaded with ctypes).  It launches on
// the given stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kWin = 15;
constexpr int kR = (kWin - 1) / 2;
constexpr int kNpix = kWin * kWin;
constexpr int kMaxPixPerLane = (kNpix + 31) / 32;  // 8
constexpr int kRows = 48;
constexpr int kLanes = 256;
constexpr int kPad = 16;

__device__ __forceinline__ int floor_int(float v) {
  if (v != v) return 0;
  v = fminf(fmaxf(v, -1e8f), 1e8f);
  return static_cast<int>(floorf(v));
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;  // NaN in either operand gives NaN
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ float pix(const float* __restrict__ img, int H,
                                     int W, int y, int x) {
  y = clampi(y, 0, H - 1);
  x = clampi(x, 0, W - 1);
  return __ldg(img + static_cast<size_t>(y) * W + x);
}

// Bilinear sample with integer corner (y, x) and weights (fy, fx), in the
// reference's operation order.
__device__ __forceinline__ float blend(const float* __restrict__ img, int H,
                                       int W, int y, int x, float fy,
                                       float fx) {
  const float t = pix(img, H, W, y, x);
  const float t01 = pix(img, H, W, y, x + 1);
  const float t10 = pix(img, H, W, y + 1, x);
  const float t11 = pix(img, H, W, y + 1, x + 1);
  return t * (1.0f - fx) * (1.0f - fy) + t01 * fx * (1.0f - fy) +
         t10 * (1.0f - fx) * fy + t11 * fx * fy;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// meta row: [py, px, qy, qx, valid]
// out row:  [x, y, ok, resid, min_eig]
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    klt_v1_kernel(const float* __restrict__ tmpl,
                  const float* __restrict__ srch, int H, int W, int Hp,
                  int Wp, const float* __restrict__ meta, int n,
                  int num_iters, float eps2, float min_eig_thr,
                  float max_resid, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= n) return;  // warp-uniform

  const float* m = meta + 5 * f;
  const float py = m[0];
  const float px = m[1];
  const float qy = m[2];
  const float qx = m[3];
  const bool valid = m[4] > 0.5f;

  // Slab base in padded coordinates, and the slab origin in image ones.
  const int y0 = clampi(floor_div(floor_int(nan_min(py, qy)) + kPad - 12, 8) * 8,
                        0, Hp - kRows);
  const int x0 = clampi(
      floor_div(floor_int(nan_min(px, qx)) + kPad - 96, 128) * 128, 0,
      Wp - kLanes);
  const float y0f = static_cast<float>(y0) - static_cast<float>(kPad);
  const float x0f = static_cast<float>(x0) - static_cast<float>(kPad);
  const int hi_y = kRows - kWin - 2;
  const int hi_x = kLanes - kWin - 2;

  // Template origin (image coordinates) and phase.
  const float ty = (py - static_cast<float>(kR)) - y0f;
  const float tx = (px - static_cast<float>(kR)) - x0f;
  const int oy = y0 - kPad + clampi(floor_int(ty), 0, hi_y);
  const int ox = x0 - kPad + clampi(floor_int(tx), 0, hi_x);
  const float phy = ty - floorf(ty);
  const float phx = tx - floorf(tx);

  // Template and its gradients, this lane's pixels k = lane + 32 m.
  float wt[kMaxPixPerLane], ix[kMaxPixPerLane], iy[kMaxPixPerLane];
  float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
#pragma unroll
  for (int m_ = 0; m_ < kMaxPixPerLane; ++m_) {
    const int k = lane + 32 * m_;
    wt[m_] = 0.0f;
    ix[m_] = 0.0f;
    iy[m_] = 0.0f;
    if (k < kNpix) {
      const int y = oy + k / kWin;
      const int x = ox + k % kWin;
      const float c = blend(tmpl, H, W, y, x, phy, phx);
      const float r = blend(tmpl, H, W, y, x + 1, phy, phx);
      const float l = blend(tmpl, H, W, y, x - 1, phy, phx);
      const float d = blend(tmpl, H, W, y + 1, x, phy, phx);
      const float u = blend(tmpl, H, W, y - 1, x, phy, phx);
      wt[m_] = c;
      ix[m_] = 0.5f * (r - l);
      iy[m_] = 0.5f * (d - u);
      sxx += ix[m_] * ix[m_];
      sxy += ix[m_] * iy[m_];
      syy += iy[m_] * iy[m_];
    }
  }
  const float gxx = warp_sum(sxx);
  const float gxy = warp_sum(sxy);
  const float gyy = warp_sum(syy);
  const float det = gxx * gyy - gxy * gxy;
  const float tr = gxx + gyy;
  const float min_eig =
      0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f)));
  const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;

  // Sums over the window of f(diff) for the search window at offset g.
  auto search = [&](float g_x, float g_y, float* b0, float* b1, float* ad) {
    const float sy = ((qy + g_y) - static_cast<float>(kR)) - y0f;
    const float sx = ((qx + g_x) - static_cast<float>(kR)) - x0f;
    const int by = y0 - kPad + clampi(floor_int(sy), 0, hi_y);
    const int bx = x0 - kPad + clampi(floor_int(sx), 0, hi_x);
    const float ay = sy - floorf(sy);
    const float ax = sx - floorf(sx);
    float s0 = 0.0f, s1 = 0.0f, sa = 0.0f;
#pragma unroll
    for (int m_ = 0; m_ < kMaxPixPerLane; ++m_) {
      const int k = lane + 32 * m_;
      if (k < kNpix) {
        const float cur =
            blend(srch, H, W, by + k / kWin, bx + k % kWin, ay, ax);
        const float diff = cur - wt[m_];
        s0 += diff * ix[m_];
        s1 += diff * iy[m_];
        sa += fabsf(diff);
      }
    }
    *b0 = s0;
    *b1 = s1;
    *ad = sa;
  };

  float gx = 0.0f, gy = 0.0f;
  for (int it = 0; it < num_iters; ++it) {
    float b0, b1, unused;
    search(gx, gy, &b0, &b1, &unused);
    b0 = warp_sum(b0);
    b1 = warp_sum(b1);
    const float d0 = -(gyy * b0 - gxy * b1) * inv_det;
    const float d1 = -(-gxy * b0 + gxx * b1) * inv_det;
    gx = gx + d0;
    gy = gy + d1;
    if (d0 * d0 + d1 * d1 < eps2) break;  // frozen: g never moves again
  }

  float unused0, unused1, sad;
  search(gx, gy, &unused0, &unused1, &sad);
  const float resid = warp_sum(sad) / static_cast<float>(kNpix);

  if (lane == 0) {
    const float new_x = qx + gx;
    const float new_y = qy + gy;
    const float fr = static_cast<float>(kR);
    const bool inb = new_x >= fr && new_x <= static_cast<float>(W - 1 - kR) &&
                     new_y >= fr && new_y <= static_cast<float>(H - 1 - kR);
    const float sy = ((qy + gy) - fr) - y0f;
    const float sx = ((qx + gx) - fr) - x0f;
    const bool in_slab = sx >= 0.0f && sx < static_cast<float>(kLanes - kWin - 1) &&
                         sy >= 0.0f && sy < static_cast<float>(kRows - kWin - 1);
    const bool eig_ok = (min_eig / static_cast<float>(kNpix)) > min_eig_thr;
    const bool ok = inb && in_slab && eig_ok && resid < max_resid && valid;
    float* o = out + 5 * f;
    o[0] = new_x;
    o[1] = new_y;
    o[2] = ok ? 1.0f : 0.0f;
    o[3] = resid;
    o[4] = min_eig;
  }
}

}  // namespace

extern "C" int klt_v1_launch(const float* tmpl, const float* srch, int H,
                             int W, int Hp, int Wp, const float* meta, int n,
                             int num_iters, float eps2, float min_eig_thr,
                             float max_resid, float* out,
                             cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    klt_v1_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        tmpl, srch, H, W, Hp, Wp, meta, n, num_iters, eps2, min_eig_thr,
        max_resid, out);
  }
  return static_cast<int>(cudaGetLastError());
}
