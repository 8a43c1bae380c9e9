// A simpler design of the v1 LK kernel, kept only as the yardstick that
// kernel_ab.py times against csrc/klt_v1.cu:
//
//     python3 kernel_ab.py --base-src klt_v1=variants/klt_v1_one_box.cu
//
// The package does not build or load this file.  It computes what
// csrc/klt_v1.cu computes (see the note there), bit for bit, in the layout
// of csrc/klt_lk.cu: one 128-thread block (four warps) per feature, the
// template and ONE 32 x 32 search box staged in shared memory, each thread
// writing its two pixels' terms to shared memory and warp 0 summing them in
// the one-warp order.  A round whose window leaves the box (v1's search is
// clipped only to its 48 x 256 slab) reads its pixels from global memory at
// the same clamped coordinates the box holds.  PERF.md has its times: at
// full resolution it is slower than a one-warp kernel that gathers every
// pixel from global memory, so csrc/klt_v1.cu keeps two warps and restages
// a wide box instead.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps per feature (one block)
constexpr int kThreads = kWarps * 32;
constexpr int kWin = 15;
constexpr int kR = (kWin - 1) / 2;
constexpr int kNpix = kWin * kWin;
constexpr int kPixSlots = 8;                       // k = lane + 32 m, m < 8
constexpr int kSlotsPerWarp = kPixSlots / kWarps;  // 2
constexpr int kRows = 48;
constexpr int kLanes = 256;
constexpr int kPad = 16;
constexpr int kTmplSide = kWin + 3;  // window, gradient ring, corner
constexpr int kGrid = kWin + 2;      // the interpolated template's grid
constexpr int kGridPerThread = (kGrid * kGrid + kThreads - 1) / kThreads;
constexpr int kBox = kWin + 1 + 16;  // 32: offsets -8..8, window, corner
constexpr int kPitch = kWin + 32;    // 47: window pixel k in bank k mod 32
constexpr int kTmplLoads = (kTmplSide + kWarps - 1) / kWarps;
constexpr int kBoxLoads = kBox / kWarps;

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

// Bilinear blend of the corners t (y, x), t01 (y, x+1), t10 (y+1, x) and
// t11 (y+1, x+1) with weights (fy, fx), in the reference's operation order.
__device__ __forceinline__ float blend(float t, float t01, float t10,
                                       float t11, float fy, float fx) {
  return t * (1.0f - fx) * (1.0f - fy) + t01 * fx * (1.0f - fy) +
         t10 * (1.0f - fx) * fy + t11 * fx * fy;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Window sums of NQ quantities terms[q * kPixSlots + m][lane] in the
// one-warp order: lane l adds its pixels k = l + 32 m for m = 0..7 in turn,
// then the warp butterfly.  Every lane of the calling warp gets the sums.
template <int NQ>
__device__ __forceinline__ void window_sums(const float (*terms)[32],
                                            int lane, float* out) {
  float s[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) s[q] = 0.0f;
#pragma unroll
  for (int m = 0; m < kPixSlots; ++m)
    if (lane + 32 * m < kNpix) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) s[q] += terms[q * kPixSlots + m][lane];
    }
#pragma unroll
  for (int q = 0; q < NQ; ++q) out[q] = warp_sum(s[q]);
}

// meta row: [py, px, qy, qx, valid]
// out row:  [x, y, ok, resid, min_eig]
__global__ void __launch_bounds__(kThreads, 8)
    klt_v1_kernel(const float* __restrict__ tmpl,
                  const float* __restrict__ srch, int H, int W, int Hp,
                  int Wp, const float* __restrict__ meta, int num_iters,
                  float eps2, float min_eig_thr, float max_resid,
                  float* __restrict__ out) {
  __shared__ float tb[kTmplSide * kPitch];
  __shared__ float sb[kBox * kPitch];
  __shared__ float terms[3 * kPixSlots][32];
  __shared__ int win_y, win_x;  // the search window warp 0 publishes
  __shared__ float win_ay, win_ax;
  __shared__ bool win_last;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int f = blockIdx.x;

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

  // The search window at offset g: its integer origin in image coordinates
  // and its phase.  `last`: the round reads the residual.
  float gx = 0.0f, gy = 0.0f;
  auto publish = [&](bool last) {
    if (lane == 0) {
      const float sy = ((qy + gy) - static_cast<float>(kR)) - y0f;
      const float sx = ((qx + gx) - static_cast<float>(kR)) - x0f;
      win_y = y0 - kPad + clampi(floor_int(sy), 0, hi_y);
      win_x = x0 - kPad + clampi(floor_int(sx), 0, hi_x);
      win_ay = sy - floorf(sy);
      win_ax = sx - floorf(sx);
      win_last = last;
    }
  };

  // The box around the g = 0 window: rows and cols -8 .. +23 of its origin.
  const int box_y = y0 - kPad + clampi(
      floor_int((qy - static_cast<float>(kR)) - y0f), 0, hi_y) - 8;
  const int box_x = x0 - kPad + clampi(
      floor_int((qx - static_cast<float>(kR)) - x0f), 0, hi_x) - 8;

  // Stage both blocks, row r by warp r % 4 and column c by lane c: every
  // load issued before the first store.
  {
    const int t_x = clampi(ox - 1 + lane, 0, W - 1);
    const int s_x = clampi(box_x + lane, 0, W - 1);
    float vt[kTmplLoads], vs[kBoxLoads];
#pragma unroll
    for (int j = 0; j < kTmplLoads; ++j) {
      const int r = w + kWarps * j;
      const int y = clampi(oy - 1 + r, 0, H - 1);
      vt[j] = (r < kTmplSide && lane < kTmplSide)
                  ? __ldg(tmpl + static_cast<size_t>(y) * W + t_x) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBoxLoads; ++j) {
      const int y = clampi(box_y + w + kWarps * j, 0, H - 1);
      vs[j] = __ldg(srch + static_cast<size_t>(y) * W + s_x);
    }
#pragma unroll
    for (int j = 0; j < kTmplLoads; ++j) {
      const int r = w + kWarps * j;
      if (r < kTmplSide && lane < kTmplSide) tb[r * kPitch + lane] = vt[j];
    }
#pragma unroll
    for (int j = 0; j < kBoxLoads; ++j)
      sb[(w + kWarps * j) * kPitch + lane] = vs[j];
  }
  __syncthreads();

  // The interpolated template on its 17 x 17 grid: grid (i, j) is the blend
  // at image (oy - 1 + i, ox - 1 + j), written over the raw block once every
  // thread has read it.
  {
    float v[kGridPerThread];
#pragma unroll
    for (int j = 0; j < kGridPerThread; ++j) {
      const int idx = threadIdx.x + kThreads * j;
      const float* s = tb + (idx / kGrid) * kPitch + idx % kGrid;
      v[j] = idx < kGrid * kGrid
                 ? blend(s[0], s[1], s[kPitch], s[kPitch + 1], phy, phx)
                 : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kGridPerThread; ++j) {
      const int idx = threadIdx.x + kThreads * j;
      if (idx < kGrid * kGrid) tb[(idx / kGrid) * kPitch + idx % kGrid] = v[j];
    }
  }
  __syncthreads();

  // Template and its gradients at this thread's pixels k = lane + 32 m,
  // m = 2w, 2w+1; off[i] is pixel k's place in a block of row pitch kPitch.
  float wt[kSlotsPerWarp], ix[kSlotsPerWarp], iy[kSlotsPerWarp];
  int off[kSlotsPerWarp];
  bool on[kSlotsPerWarp];
#pragma unroll
  for (int i = 0; i < kSlotsPerWarp; ++i) {
    const int mm = kSlotsPerWarp * w + i;
    const int k = lane + 32 * mm;
    on[i] = k < kNpix;
    off[i] = on[i] ? (k / kWin) * kPitch + k % kWin : 0;
    wt[i] = ix[i] = iy[i] = 0.0f;
    if (on[i]) {
      const float* t = tb + off[i] + kPitch + 1;  // grid (r + 1, c + 1)
      wt[i] = t[0];
      ix[i] = 0.5f * (t[1] - t[-1]);
      iy[i] = 0.5f * (t[kPitch] - t[-kPitch]);
      terms[mm][lane] = ix[i] * ix[i];
      terms[kPixSlots + mm][lane] = ix[i] * iy[i];
      terms[2 * kPixSlots + mm][lane] = iy[i] * iy[i];
    }
  }
  __syncthreads();

  // From here warp 0 owns the feature's state: the structure tensor, the
  // offset g and the iteration count.  Each round, every thread writes the
  // terms of its pixels for the window warp 0 published, and warp 0 sums
  // them, updates g and publishes the next window; two barriers a round.
  float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f, min_eig = 0.0f, inv_det = 0.0f;
  int it = 0;
  if (w == 0) {
    float st[3];
    window_sums<3>(terms, lane, st);
    gxx = st[0];
    gxy = st[1];
    gyy = st[2];
    const float det = gxx * gyy - gxy * gxy;
    const float tr = gxx + gyy;
    min_eig = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f)));
    inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
    publish(num_iters == 0);
  }
  __syncthreads();

  while (true) {
    const int wy = win_y, wx = win_x;
    const float ay = win_ay, ax = win_ax;
    const bool last = win_last;
    const bool in_box = wy - box_y >= 0 && wy - box_y <= kBox - kWin - 1 &&
                        wx - box_x >= 0 && wx - box_x <= kBox - kWin - 1;
    const float* s = sb + (wy - box_y) * kPitch + (wx - box_x);
#pragma unroll
    for (int i = 0; i < kSlotsPerWarp; ++i) {
      const int mm = kSlotsPerWarp * w + i;
      if (on[i]) {
        float v;
        if (in_box) {
          const float* p = s + off[i];
          v = blend(p[0], p[1], p[kPitch], p[kPitch + 1], ay, ax);
        } else {  // the same clamped pixels, from global memory
          const int k = lane + 32 * mm;
          const float* r0 =
              srch + static_cast<size_t>(clampi(wy + k / kWin, 0, H - 1)) * W;
          const float* r1 =
              srch +
              static_cast<size_t>(clampi(wy + k / kWin + 1, 0, H - 1)) * W;
          const int c0 = clampi(wx + k % kWin, 0, W - 1);
          const int c1 = clampi(wx + k % kWin + 1, 0, W - 1);
          v = blend(__ldg(r0 + c0), __ldg(r0 + c1), __ldg(r1 + c0),
                    __ldg(r1 + c1), ay, ax);
        }
        const float diff = v - wt[i];
        if (last) {
          terms[mm][lane] = fabsf(diff);
        } else {
          terms[mm][lane] = diff * ix[i];
          terms[kPixSlots + mm][lane] = diff * iy[i];
        }
      }
    }
    __syncthreads();
    if (last) break;
    if (w == 0) {
      float b[2];
      window_sums<2>(terms, lane, b);
      const float d0 = -(gyy * b[0] - gxy * b[1]) * inv_det;
      const float d1 = -(-gxy * b[0] + gxx * b[1]) * inv_det;
      gx = gx + d0;
      gy = gy + d1;
      ++it;
      // A frozen feature never moves again: its next round is the last.
      publish(d0 * d0 + d1 * d1 < eps2 || it == num_iters);
    }
    __syncthreads();
  }

  if (w == 0) {
    float sad;
    window_sums<1>(terms, lane, &sad);
    const float resid = sad / static_cast<float>(kNpix);
    if (lane == 0) {
      const float new_x = qx + gx;
      const float new_y = qy + gy;
      const float fr = static_cast<float>(kR);
      const bool inb = new_x >= fr && new_x <= static_cast<float>(W - 1 - kR) &&
                       new_y >= fr && new_y <= static_cast<float>(H - 1 - kR);
      const float sy = ((qy + gy) - fr) - y0f;
      const float sx = ((qx + gx) - fr) - x0f;
      const bool in_slab =
          sx >= 0.0f && sx < static_cast<float>(kLanes - kWin - 1) &&
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
}

}  // namespace

extern "C" int klt_v1_launch(const float* tmpl, const float* srch, int H,
                             int W, int Hp, int Wp, const float* meta, int n,
                             int num_iters, float eps2, float min_eig_thr,
                             float max_resid, float* out,
                             cudaStream_t stream) {
  if (n > 0) {
    klt_v1_kernel<<<n, kThreads, 0, stream>>>(tmpl, srch, H, W, Hp, Wp, meta,
                                              num_iters, eps2, min_eig_thr,
                                              max_resid, out);
  }
  return static_cast<int>(cudaGetLastError());
}
