// The v1 translation-only Lucas-Kanade tracker: one 64-thread block (two
// warps) per feature, the feature's pixels staged in shared memory.  A launch
// takes B problems (gridDim.y = B, gridDim.x = n): block (f, b) tracks feature
// f of problem b on problem b's planes, rows b * n + f of the (B, n) tables,
// as the TPU kernel's extra grid axis under jax.vmap does.  A launch of B = 1
// runs the instance without the batch axis (kBatched = false), the code of a
// launch before it.
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
// slab row and column.
//
// It reads the rows and columns the TPU kernel reads, wrapped ones included.
// The TPU kernel's circular rolls, by line of ops/klt_pallas.py, for a window
// at slab row yi (clipped to 0..31) and column xi (0..239):
//   * :206, :207, the registration: the 24 rows loaded from yi8 = yi - yi % 8
//     roll up by yi % 8 and the 256 lanes left by xi, so registered row p is
//     slab row yi8 + (p + yi % 8) mod 24 and lane l slab lane (l + xi) mod 256;
//   * :212, :213, :217, the blend's rolls by one row or lane, and :248,
//     :250, Txp's and Typ's rolls up or left by one: every read that the
//     window mask keeps lies in registered rows 0..16 and lanes 0..16,
//     inside both rings;
//   * :251, Tym's roll down by one: row 0 of the upward gradient reads
//     registered row -1, which is slab row yi + 23 when yi % 8 == 0;
//   * :249, Txm's roll right by one: column 0 of the leftward gradient reads
//     registered lane -1, which is slab lane 255 when xi == 0 (a template
//     more than 8 px left of the image; the wrapper does not clip).
// So the template block's first row is image row oy + 23 when yi % 8 == 0,
// and its first column image column x0 - 16 + 255 when xi == 0 (each then
// clamped); the search reads no wrapped row or lane.
//
// Float -> int conversions go through floor_int: NaN gives 0 and values clamp
// to +-1e8, which is what the reference's conversion gives for NaN and, after
// the clips, for any finite input.  min() propagates NaN as jnp.minimum does.
//
// What bounds it on an H100: ~2.4 MB and ~38 MFLOP per call (a 0.73 us
// bound), but each feature is a chain of its meta row, its pixels and
// num_iters dependent Gauss-Newton rounds, nearly every feature runs all of
// them, and the call lasts as long as the slowest chain on the busiest SM.
// Two things set that (PERF.md has the measurements):
//   * the SM's shared-memory and shuffle traffic, which the 8 features an SM
//     holds at N = 1024 share.  Per round a feature reads its 225 blends from
//     shared memory and reduces two sums; the design keeps everything else
//     out of that path.  Two warps share a feature: warp w owns the window
//     pixels k = lane + 32 m for m = 4w .. 4w+3 and keeps their terms in
//     registers.  Warp 0 adds lane l's terms m = 0..3 from 0 and hands that
//     one partial per lane over in shared memory; warp 1 continues it with
//     m = 4..7 and reduces across lanes with the __shfl_xor_sync butterfly.
//     That is the order of one warp per feature with 8 pixels a lane, so
//     with -fmad=false the outputs are bit-equal to such a kernel.  Warp 1
//     keeps the feature's state (structure tensor, g, the iteration count)
//     and publishes each round's window; two barriers a round;
//   * features whose search runs away: v1's origin is clipped only to the
//     slab, so a poorly conditioned feature moves 10-40 px a round, mostly
//     sideways, and every round that leaves the staged pixels waits for a
//     round trip to L2.  The first box is the 32 x 32 pixels that offsets of
//     up to +-8 px around the g = 0 window reach.  A window that leaves it
//     gets a box 64 px wide that reaches 8 px behind the window and 40 px
//     ahead in the direction the window moved (centred if it did not move
//     sideways), rows +-8 px as before.  On bench.py's frames no feature
//     then leaves a box more than twice in six rounds (it was six times
//     with a 32 x 32 box around every new window).  The test depends on the
//     feature only, so the block takes the branch together, and a box holds
//     the same clamped pixels that a read from global memory gives, so the
//     result does not depend on where the boxes lie.  The simpler design,
//     one box and global reads outside it in csrc/klt_lk.cu's four-warp
//     layout, is variants/klt_v1_one_box.cu: kernel_ab.py times it slower
//     at full resolution than a one-warp kernel that stages nothing.
// The feature's pixels are staged with coalesced row loads (lane c loads
// column c, every load of a thread issued before its first store); the
// interpolated template is computed once on its 17 x 17 grid with the
// gradients as differences of it; rows are pitched by 15 mod 32 (47 for the
// template, 79 for the search box), so a warp's 32 consecutive window pixels
// never share a bank.
// Occupancy: 1024 features make 1024 blocks of 64 threads, at most 8 per SM
// on 132 SMs; a block holds 13.9 KB of shared memory and
// __launch_bounds__(64, 8) lets a thread use up to 128 registers, so every
// feature is resident at once.
//
// Entry point: klt_v1_launch (plain C, loaded with ctypes).  It launches on
// the given stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 2;  // warps per feature (one block)
constexpr int kThreads = kWarps * 32;
constexpr int kWin = 15;
constexpr int kR = (kWin - 1) / 2;
constexpr int kNpix = kWin * kWin;
constexpr int kPixSlots = (kNpix + 31) / 32;       // 8 per lane
constexpr int kSlotsPerWarp = kPixSlots / kWarps;  // 4
constexpr int kRows = 48;
constexpr int kLanes = 256;
constexpr int kPad = 16;
constexpr int kTmplRows = 24;  // rows the template's gradients roll within
constexpr int kTmplSide = kWin + 3;  // window, gradient ring, corner
constexpr int kGrid = kWin + 2;      // the interpolated template's grid
constexpr int kGridPerThread = (kGrid * kGrid + kThreads - 1) / kThreads;
constexpr int kReach = 8;            // offsets staged behind a window
constexpr int kBox = kWin + 1 + 2 * kReach;  // 32: rows, first box's columns
constexpr int kWideBox = 64;         // columns of a box staged on leaving one
constexpr int kPitch = kWin + 32;    // 47: the template block's row pitch
constexpr int kBoxPitch = kWideBox + kWin;  // 79: the search box's
constexpr int kTmplLoads = (kTmplSide + kWarps - 1) / kWarps;  // 9 rows
constexpr int kBoxLoads = kBox / kWarps;                       // 16 rows

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

// Blend whose corner t lies at s in a staged block of row pitch P.
template <int P>
__device__ __forceinline__ float blend_at(const float* s, float fy,
                                          float fx) {
  return blend(s[0], s[1], s[P], s[P + 1], fy, fx);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stages the kBox x kCols search box at image (y, x) into sb (row pitch
// kBoxPitch): row r by warp r % 2, column c by lane c % 32, coordinates
// clamped to the image, every load issued before the first store.
template <int kCols>
__device__ __forceinline__ void stage_box(float* sb,
                                          const float* __restrict__ srch,
                                          int H, int W, int y, int x, int w,
                                          int lane) {
  constexpr int kChunks = kCols / 32;
  float v[kBoxLoads][kChunks];
#pragma unroll
  for (int j = 0; j < kBoxLoads; ++j) {
    const float* row =
        srch + static_cast<size_t>(clampi(y + w + kWarps * j, 0, H - 1)) * W;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      v[j][c] = __ldg(row + clampi(x + 32 * c + lane, 0, W - 1));
  }
#pragma unroll
  for (int j = 0; j < kBoxLoads; ++j)
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      sb[(w + kWarps * j) * kBoxPitch + 32 * c + lane] = v[j][c];
}

// The search window's integer origin (image coordinates) and phase.
struct Window {
  int y, x;
  float ay, ax;
};

// meta row: [py, px, qy, qx, valid]
// out row:  [x, y, ok, resid, min_eig]
template <bool kBatched>
__global__ void __launch_bounds__(kThreads, 8)
    klt_v1_kernel(const float* __restrict__ tmpl,
                  const float* __restrict__ srch, int H, int W, int Hp,
                  int Wp, const float* __restrict__ meta, int num_iters,
                  float eps2, float min_eig_thr, float max_resid,
                  float* __restrict__ out) {
  __shared__ float tb[kTmplSide * kPitch];
  __shared__ float sb[kBox * kBoxPitch];
  __shared__ float part[3][32];  // warp 0's partial sums, lane by lane
  __shared__ Window win;         // the search window warp 1 publishes
  __shared__ int win_last;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  // Feature f of problem b: its planes and its row of the (B, n) tables.
  // A launch of one problem takes the code of a launch with no batch axis.
  if (kBatched) {
    const size_t plane = static_cast<size_t>(blockIdx.y) * H * W;
    tmpl += plane;
    srch += plane;
  }
  const int f = kBatched ? blockIdx.y * gridDim.x + blockIdx.x : blockIdx.x;

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

  // Template origin (slab and image coordinates) and phase.
  const float ty = (py - static_cast<float>(kR)) - y0f;
  const float tx = (px - static_cast<float>(kR)) - x0f;
  const int yi = clampi(floor_int(ty), 0, hi_y);
  const int xi = clampi(floor_int(tx), 0, hi_x);
  const int oy = y0 - kPad + yi;
  const int ox = x0 - kPad + xi;
  const float phy = ty - floorf(ty);
  const float phx = tx - floorf(tx);

  auto window = [&](float g_x, float g_y) {
    const float sy = ((qy + g_y) - static_cast<float>(kR)) - y0f;
    const float sx = ((qx + g_x) - static_cast<float>(kR)) - x0f;
    return Window{y0 - kPad + clampi(floor_int(sy), 0, hi_y),
                  x0 - kPad + clampi(floor_int(sx), 0, hi_x),
                  sy - floorf(sy), sx - floorf(sx)};
  };

  // Stage the template block, rows oy-1 .. oy+16 and cols ox-1 .. ox+16 as
  // the reference's rolls read them (row oy+23 for oy-1 when yi % 8 == 0,
  // column x0-16+255 for ox-1 when xi == 0), and the first search box, rows
  // and cols -8 .. +23 around the g = 0 window.
  const Window w0 = window(0.0f, 0.0f);
  int box_y = w0.y - kReach, box_x = w0.x - kReach, box_w = kBox;
  {
    const bool t_on = lane < kTmplSide;
    const int t_x = clampi(lane == 0 && xi == 0 ? x0 - kPad + kLanes - 1
                                                : ox - 1 + lane,
                           0, W - 1);
    float vt[kTmplLoads];
#pragma unroll
    for (int j = 0; j < kTmplLoads; ++j) {
      const int r = w + kWarps * j;
      const int y = clampi(r == 0 && yi % 8 == 0 ? oy - 1 + kTmplRows
                                                 : oy - 1 + r,
                           0, H - 1);
      vt[j] = (r < kTmplSide && t_on)
                  ? __ldg(tmpl + static_cast<size_t>(y) * W + t_x) : 0.0f;
    }
    stage_box<kBox>(sb, srch, H, W, box_y, box_x, w, lane);
#pragma unroll
    for (int j = 0; j < kTmplLoads; ++j) {
      const int r = w + kWarps * j;
      if (r < kTmplSide && t_on) tb[r * kPitch + lane] = vt[j];
    }
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
      v[j] = idx < kGrid * kGrid
                 ? blend_at<kPitch>(tb + (idx / kGrid) * kPitch + idx % kGrid,
                                    phy, phx)
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
  // m = 4w .. 4w+3; off[i] is pixel k's place in the search box.
  float wt[kSlotsPerWarp], ix[kSlotsPerWarp], iy[kSlotsPerWarp];
  int off[kSlotsPerWarp];
  bool on[kSlotsPerWarp];
#pragma unroll
  for (int i = 0; i < kSlotsPerWarp; ++i) {
    const int k = lane + 32 * (kSlotsPerWarp * w + i);
    on[i] = k < kNpix;
    off[i] = on[i] ? (k / kWin) * kBoxPitch + k % kWin : 0;
    wt[i] = ix[i] = iy[i] = 0.0f;
    if (on[i]) {
      const float* t = tb + (k / kWin + 1) * kPitch + k % kWin + 1;
      wt[i] = t[0];
      ix[i] = 0.5f * (t[1] - t[-1]);
      iy[i] = 0.5f * (t[kPitch] - t[-kPitch]);
    }
  }

  // Warp 0 adds its terms of lane l from 0 and hands the partial over; warp
  // 1 continues it and reduces (the one-warp order), then owns the state.
  float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f, min_eig = 0.0f, inv_det = 0.0f;
  float gx = 0.0f, gy = 0.0f;
  int it = 0;
  if (w == 0) {
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kSlotsPerWarp; ++i)
      if (on[i]) {
        s0 += ix[i] * ix[i];
        s1 += ix[i] * iy[i];
        s2 += iy[i] * iy[i];
      }
    part[0][lane] = s0;
    part[1][lane] = s1;
    part[2][lane] = s2;
  }
  __syncthreads();
  if (w == 1) {
    float s0 = part[0][lane], s1 = part[1][lane], s2 = part[2][lane];
#pragma unroll
    for (int i = 0; i < kSlotsPerWarp; ++i)
      if (on[i]) {
        s0 += ix[i] * ix[i];
        s1 += ix[i] * iy[i];
        s2 += iy[i] * iy[i];
      }
    gxx = warp_sum(s0);
    gxy = warp_sum(s1);
    gyy = warp_sum(s2);
    const float det = gxx * gyy - gxy * gxy;
    const float tr = gxx + gyy;
    min_eig = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f)));
    inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
    if (lane == 0) {
      win = w0;
      win_last = num_iters == 0;  // the round reads the residual
    }
  }
  __syncthreads();

  // Each round, both warps blend their pixels for the window warp 1
  // published; warp 0 hands its partial sums over and warp 1 finishes them,
  // updates g and publishes the next window.
  int prev_x = w0.x;
  while (true) {
    const Window sw = win;
    const bool last = win_last != 0;
    if (sw.y - box_y < 0 || sw.y - box_y > kBox - kWin - 1 ||
        sw.x - box_x < 0 || sw.x - box_x > box_w - kWin - 1) {
      // The window left the box: a wide box reaching ahead of it.
      const int dx = sw.x - prev_x;
      box_y = sw.y - kReach;
      box_x = dx > 0   ? sw.x - kReach
              : dx < 0 ? sw.x + kWin + 1 + kReach - kWideBox
                       : sw.x - (kWideBox - kWin - 1) / 2;
      box_w = kWideBox;
      stage_box<kWideBox>(sb, srch, H, W, box_y, box_x, w, lane);
      __syncthreads();
    }
    prev_x = sw.x;
    const float* s = sb + (sw.y - box_y) * kBoxPitch + (sw.x - box_x);
    float t0[kSlotsPerWarp], t1[kSlotsPerWarp];
#pragma unroll
    for (int i = 0; i < kSlotsPerWarp; ++i) {
      t0[i] = t1[i] = 0.0f;
      if (on[i]) {
        const float diff =
            blend_at<kBoxPitch>(s + off[i], sw.ay, sw.ax) - wt[i];
        if (last) {
          t0[i] = fabsf(diff);
        } else {
          t0[i] = diff * ix[i];
          t1[i] = diff * iy[i];
        }
      }
    }
    if (w == 0) {
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int i = 0; i < kSlotsPerWarp; ++i)
        if (on[i]) {
          s0 += t0[i];
          s1 += t1[i];
        }
      part[0][lane] = s0;
      part[1][lane] = s1;
    }
    __syncthreads();
    if (w == 1) {
      float s0 = part[0][lane], s1 = part[1][lane];
#pragma unroll
      for (int i = 0; i < kSlotsPerWarp; ++i)
        if (on[i]) {
          s0 += t0[i];
          s1 += t1[i];
        }
      if (last) {
        const float resid = warp_sum(s0) / static_cast<float>(kNpix);
        if (lane == 0) {
          const float new_x = qx + gx;
          const float new_y = qy + gy;
          const float fr = static_cast<float>(kR);
          const bool inb = new_x >= fr &&
                           new_x <= static_cast<float>(W - 1 - kR) &&
                           new_y >= fr &&
                           new_y <= static_cast<float>(H - 1 - kR);
          const float sy = ((qy + gy) - fr) - y0f;
          const float sx = ((qx + gx) - fr) - x0f;
          const bool in_slab =
              sx >= 0.0f && sx < static_cast<float>(kLanes - kWin - 1) &&
              sy >= 0.0f && sy < static_cast<float>(kRows - kWin - 1);
          const bool eig_ok =
              (min_eig / static_cast<float>(kNpix)) > min_eig_thr;
          const bool ok =
              inb && in_slab && eig_ok && resid < max_resid && valid;
          float* o = out + 5 * f;
          o[0] = new_x;
          o[1] = new_y;
          o[2] = ok ? 1.0f : 0.0f;
          o[3] = resid;
          o[4] = min_eig;
        }
      } else {
        const float b0 = warp_sum(s0);
        const float b1 = warp_sum(s1);
        const float d0 = -(gyy * b0 - gxy * b1) * inv_det;
        const float d1 = -(-gxy * b0 + gxx * b1) * inv_det;
        gx = gx + d0;
        gy = gy + d1;
        ++it;
        if (lane == 0) {
          win = window(gx, gy);
          // A frozen feature never moves again: its next round is the last.
          win_last = d0 * d0 + d1 * d1 < eps2 || it == num_iters;
        }
      }
    }
    if (last) break;
    __syncthreads();
  }
}

}  // namespace

// tmpl, srch: (B, H, W); meta: (B, n, 5); out: (B, n, 5).
extern "C" int klt_v1_launch(const float* tmpl, const float* srch, int B,
                             int H, int W, int Hp, int Wp, const float* meta,
                             int n, int num_iters, float eps2,
                             float min_eig_thr, float max_resid, float* out,
                             cudaStream_t stream) {
  if (n > 0 && B > 0) {
    if (B == 1) {
      klt_v1_kernel<false><<<n, kThreads, 0, stream>>>(
          tmpl, srch, H, W, Hp, Wp, meta, num_iters, eps2, min_eig_thr,
          max_resid, out);
    } else {
      klt_v1_kernel<true><<<dim3(n, B), kThreads, 0, stream>>>(
          tmpl, srch, H, W, Hp, Wp, meta, num_iters, eps2, min_eig_thr,
          max_resid, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
