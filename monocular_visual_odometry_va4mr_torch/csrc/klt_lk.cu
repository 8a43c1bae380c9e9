// Translation-only Lucas-Kanade with a fixed template: one 128-thread block
// per feature, the feature's pixels staged in shared memory.  A launch takes
// B problems (gridDim.y = B, gridDim.x = n): block (f, b) tracks feature f of
// problem b on problem b's planes, rows b * n + f of the (B, n) tables.  That
// is the TPU kernel's extra grid axis under jax.vmap.  A launch of B = 1 runs
// the instance without the batch axis (kBatched = false), the code of a launch
// before it.
//
// Replaces the TPU kernel ops/klt_pallas2.py::_klt2_kernel of the JAX
// package (launched by _run_klt2, klt_pallas2.py:237-267).  It computes what
// that kernel computes, per feature:
//   * a bilinear win x win template at the template's sub-pixel phase, with
//     central-difference gradients OF THE INTERPOLATED TEMPLATE (so it reads
//     a one-pixel ring around the window);
//   * the 2x2 structure tensor and its min eigenvalue;
//   * up to num_iters Gauss-Newton updates of the offset g from the search
//     origin; the update is applied, THEN the feature freezes once
//     |delta|^2 < eps^2 (a frozen feature never moves again, so the loop
//     stops there);
//   * the search window's integer offset n = clip(floor(g), -8, 7), blended
//     at the fraction g - n, which leaves [0, 1] and extrapolates when g
//     lies outside [-8, 8), exactly like the TPU kernel;
//   * the final mean absolute residual and the gate
//     ok = |g| < 7.99 & min_eig / win^2 > thr & resid < max_resid & valid.
//
// What it does not carry over: the TPU layout (4 lane-shifted padded image
// copies, packed DMA descriptors and their image-size cap, butterfly rolls,
// 4-per-tile lane packing, block-diagonal MXU reduce).  It reads the (H, W)
// float planes directly and clamps every coordinate to the image, which
// equals the reference's edge padding of 32 px for every read that the
// wrapper's clipped inputs can reach.
//
// Where the TPU kernel's circular rolls wrap, this kernel reads the true
// image, by decision.  Those rolls, at the inputs its wrapper admits
// (positions clipped to [-8, W+8], n in [-8, 7], win odd 5..15), by line of
// ops/klt_pallas2.py:
//   * :120, the registration's row roll: registered row p is slab row
//     (p + sub) mod 32, sub = by - y0 in 0..7 with by the window's padded
//     top row minus 8 and y0 = floor(by / 8) * 8.  The template reads
//     registered rows 7 .. win+9 <= 24, so its rows never wrap; the search
//     reads registered rows 8 + n .. 8 + n + win in 0..30, which wrap when
//     8 + n + win + sub >= 32 (at win 15: sub + n > 8; never at win <= 9),
//     and then read the image row 32 above the true one;
//   * :191, :193, the search's row pre-shift and shifts: their composition
//     is the shift by n, within 0..30 of the 32 rows: no wrap of their own;
//   * :122, :131, :194, :196, the lane rolls: registered lanes 0..31 are
//     slab lanes r .. r + 31 <= 62 of 128, each slot's 32 lanes are moved
//     whole, the template reads in-slot lanes 7 .. win + 9 and the search
//     lanes 8 + n .. 8 + n + win, all within 0..30: none wraps;
//   * :162-164, :171-172, the blend's and the gradients' rolls by one row
//     or lane: every read that the window mask keeps stays inside its slot
//     and below row 32 (template) or row 24 of the search's 24 rows.
// Besides, the TPU kernel sums 4 features' window terms in one matmul by a
// block-diagonal 0/1 matrix (gsum, :151-155), so once one feature's sum is
// not finite (a search that ran away and overflowed), inf * 0 makes the
// sums of all 4 NaN; here each feature's sums are its own.  A plain
// version with both of the TPU kernel's readings, held against it feature
// for feature, is stress_diag.py's reference_read_lk.  With those readings
// the port fails chip_smoke.py's hard-realism gate on the card (seed 0),
// so it keeps the true read (PERF.md; ROADMAP.md, Queue 3).
//
// What bounds it on an H100: latency, not bytes or operations.  One call
// reads ~2.4 MB and does ~38 MFLOP (a 0.73 us bound), but each feature is a
// chain: its row, then its pixels, then up to num_iters Gauss-Newton
// iterations that each wait on the previous one's reduced update, and the
// call lasts as long as the slowest chain on the busiest SM, plus the
// launch.  The design shortens the chain:
//   * every pixel the feature can read is staged once in shared memory, with
//     coalesced rows (lane c loads column c of a row, all of a thread's
//     loads issued before its first store), so the feature pays one round
//     trip to L2 instead of one per iteration: the template block, rows
//     ty-1 .. ty+win+1 and cols tx-1 .. tx+win+1, (win+3)^2 <= 18^2 floats,
//     and the search block: n is clipped to [-8, 7] and the blend reads one
//     pixel past the window, so every search lies in rows qy-8 .. qy+win+7
//     and cols qx-8 .. qx+win+7, (win+16)^2 <= 31^2 floats.  Clamped
//     coordinates make the staged blocks equal the unstaged reads, so
//     staging is exact;
//   * the interpolated template is computed once on its (win+2)^2 grid and
//     the gradients are differences of that grid: the same floats that a
//     blend per neighbour gives;
//   * four warps share a feature (one 128-thread block), so a thread blends
//     2 window pixels a round instead of 8.  Warp w owns pixels
//     k = lane + 32 m for m = 2w, 2w+1; each thread writes its pixels' terms
//     to shared memory and warp 0 sums lane l's 8 terms in the order
//     m = 0..7, then reduces across lanes with the __shfl_xor_sync
//     butterfly.  That is the order of one warp per feature with 8 pixels a
//     lane, so with the -fmad=false build the outputs are bit-equal to such
//     a kernel.  Warp 0 keeps the feature's state (structure tensor, g, the
//     iteration count) and publishes each round's window, two barriers a
//     round;
//   * win is a template argument (odd, 5..15), so every index is a constant
//     expression, and both blocks have a row pitch of win + 32, so window
//     pixel k lies in bank k mod 32 (plus a constant) and a warp's 32
//     consecutive pixels never share a bank.
// Occupancy: 1024 features make 1024 blocks, at most 8 per SM on 132 SMs; a
// block holds <= 12.3 KB of shared memory and __launch_bounds__(128, 8) caps
// a thread at 64 registers, so all 8 fit and every feature is resident at
// once.  What is left: with 8 features an SM, their rounds share the SM
// (its shared-memory and shuffle traffic above all), so a round takes longer
// at N = 1024 than for 8 features alone (PERF.md has both).
//
// Entry point: klt_lk_launch (plain C, loaded with ctypes).  It launches on
// the given stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps per feature (one block)
constexpr int kThreads = kWarps * 32;
constexpr int kPixSlots = 8;  // pixels k = lane + 32 m, m < 8: win <= 15
constexpr int kSlotsPerWarp = kPixSlots / kWarps;  // 2

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
template <int NQ, int kNpix>
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

// feat row: [tx, ty, fx, fy, qx, qy, gx0, gy0]
//   (tx, ty): integer template origin (window top-left), (fx, fy) its phase;
//   (qx, qy): integer search origin, (gx0, gy0) the initial offset.
// out row:  [gx, gy, ok, resid, min_eig]
template <int kWin, bool kBatched>
__global__ void __launch_bounds__(kThreads, 8)
    klt_lk_kernel(const float* __restrict__ tmpl,
                  const float* __restrict__ srch, int H, int W,
                  const float* __restrict__ feat,
                  const unsigned char* __restrict__ valid, int num_iters,
                  float eps2, float min_eig_thr, float max_resid,
                  float* __restrict__ out) {
  constexpr int kNpix = kWin * kWin;
  constexpr int kPitch = kWin + 32;    // window pixel k in bank k mod 32
  constexpr int kTmplSide = kWin + 3;  // window, gradient ring, corner
  constexpr int kSrchSide = kWin + 16;  // offsets -8..7, window, corner
  constexpr int kGrid = kWin + 2;       // the interpolated template's grid
  constexpr int kGridPerThread = (kGrid * kGrid + kThreads - 1) / kThreads;
  constexpr int kTmplLoads = (kTmplSide + kWarps - 1) / kWarps;
  constexpr int kSrchLoads = (kSrchSide + kWarps - 1) / kWarps;
  __shared__ float tb[kTmplSide * kPitch];
  __shared__ float sb[kSrchSide * kPitch];
  __shared__ float terms[3 * kPixSlots][32];
  __shared__ int win_off;  // the search window warp 0 publishes
  __shared__ float win_ay, win_ax;
  __shared__ bool win_last;
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

  const float* fe = feat + 8 * f;
  const int tx = static_cast<int>(fe[0]);
  const int ty = static_cast<int>(fe[1]);
  const float phx = fe[2];
  const float phy = fe[3];
  const int qx = static_cast<int>(fe[4]);
  const int qy = static_cast<int>(fe[5]);
  float gx = fe[6];
  float gy = fe[7];
  const bool is_valid = valid[f] != 0;

  // Stage both (square) blocks, row r by warp r % 4 and column c by lane c:
  // every load issued before the first store.
  {
    const int t_x = min(max(tx - 1 + lane, 0), W - 1);
    const int s_x = min(max(qx - 8 + lane, 0), W - 1);
    float vt[kTmplLoads], vs[kSrchLoads];
#pragma unroll
    for (int j = 0; j < kTmplLoads; ++j) {
      const int r = w + kWarps * j;
      const int y = min(max(ty - 1 + r, 0), H - 1);
      vt[j] = (r < kTmplSide && lane < kTmplSide)
                  ? __ldg(tmpl + static_cast<size_t>(y) * W + t_x) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kSrchLoads; ++j) {
      const int r = w + kWarps * j;
      const int y = min(max(qy - 8 + r, 0), H - 1);
      vs[j] = (r < kSrchSide && lane < kSrchSide)
                  ? __ldg(srch + static_cast<size_t>(y) * W + s_x) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kTmplLoads; ++j) {
      const int r = w + kWarps * j;
      if (r < kTmplSide && lane < kTmplSide) tb[r * kPitch + lane] = vt[j];
    }
#pragma unroll
    for (int j = 0; j < kSrchLoads; ++j) {
      const int r = w + kWarps * j;
      if (r < kSrchSide && lane < kSrchSide) sb[r * kPitch + lane] = vs[j];
    }
  }
  __syncthreads();

  // The interpolated template on its (win+2)^2 grid: grid (i, j) is the
  // blend at image (ty - 1 + i, tx - 1 + j), written over the raw block
  // once every thread has read it.
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
    const int m = kSlotsPerWarp * w + i;
    const int k = lane + 32 * m;
    on[i] = k < kNpix;
    off[i] = on[i] ? (k / kWin) * kPitch + k % kWin : 0;
    wt[i] = ix[i] = iy[i] = 0.0f;
    if (on[i]) {
      const float* t = tb + off[i] + kPitch + 1;  // grid (r + 1, c + 1)
      wt[i] = t[0];
      ix[i] = 0.5f * (t[1] - t[-1]);
      iy[i] = 0.5f * (t[kPitch] - t[-kPitch]);
      terms[m][lane] = ix[i] * ix[i];
      terms[kPixSlots + m][lane] = ix[i] * iy[i];
      terms[2 * kPixSlots + m][lane] = iy[i] * iy[i];
    }
  }
  __syncthreads();

  // From here warp 0 owns the feature's state: the structure tensor, the
  // offset g and the iteration count.  Each round, every thread writes the
  // terms of its pixels for the window warp 0 published, and warp 0 sums
  // them, updates g and publishes the next window; two barriers a round.
  float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f, min_eig = 0.0f, inv_det = 0.0f;
  int it = 0;
  // The search window at offset g: n = clip(floor(g), -8, 7), blended at
  // g - n; the staged block's (0, 0) is (qy - 8, qx - 8), so offset n
  // starts at (n_y + 8, n_x + 8).  `last`: the round reads the residual.
  auto publish = [&](bool last) {
    if (lane == 0) {
      const float ny = fminf(fmaxf(floorf(gy), -8.0f), 7.0f);
      const float nx = fminf(fmaxf(floorf(gx), -8.0f), 7.0f);
      win_off = (static_cast<int>(ny) + 8) * kPitch + static_cast<int>(nx) + 8;
      win_ay = gy - ny;
      win_ax = gx - nx;
      win_last = last;
    }
  };
  if (w == 0) {
    float st[3];
    window_sums<3, kNpix>(terms, lane, st);
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
    const float* s = sb + win_off;
    const float ay = win_ay, ax = win_ax;
    const bool last = win_last;
#pragma unroll
    for (int i = 0; i < kSlotsPerWarp; ++i) {
      const int m = kSlotsPerWarp * w + i;
      if (on[i]) {
        const float* p = s + off[i];
        const float diff =
            blend(p[0], p[1], p[kPitch], p[kPitch + 1], ay, ax) - wt[i];
        if (last) {
          terms[m][lane] = fabsf(diff);
        } else {
          terms[m][lane] = diff * ix[i];
          terms[kPixSlots + m][lane] = diff * iy[i];
        }
      }
    }
    __syncthreads();
    if (last) break;
    if (w == 0) {
      float b[2];
      window_sums<2, kNpix>(terms, lane, b);
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
    window_sums<1, kNpix>(terms, lane, &sad);
    const float resid = sad / static_cast<float>(kNpix);
    if (lane == 0) {
      const bool drift_ok = gx > -7.99f && gx < 7.99f && gy > -7.99f &&
                            gy < 7.99f;
      const bool eig_ok = (min_eig / static_cast<float>(kNpix)) > min_eig_thr;
      const bool ok = drift_ok && eig_ok && resid < max_resid && is_valid;
      float* o = out + 5 * f;
      o[0] = gx;
      o[1] = gy;
      o[2] = ok ? 1.0f : 0.0f;
      o[3] = resid;
      o[4] = min_eig;
    }
  }
}

template <int kWin>
void launch(const float* tmpl, const float* srch, int B, int H, int W,
            const float* feat, const unsigned char* valid, int n,
            int num_iters, float eps2, float min_eig_thr, float max_resid,
            float* out, cudaStream_t stream) {
  if (B == 1) {
    klt_lk_kernel<kWin, false><<<n, kThreads, 0, stream>>>(
        tmpl, srch, H, W, feat, valid, num_iters, eps2, min_eig_thr,
        max_resid, out);
  } else {
    klt_lk_kernel<kWin, true><<<dim3(n, B), kThreads, 0, stream>>>(
        tmpl, srch, H, W, feat, valid, num_iters, eps2, min_eig_thr,
        max_resid, out);
  }
}

}  // namespace

// tmpl, srch: (B, H, W); feat: (B, n, 8); valid: (B, n); out: (B, n, 5).
extern "C" int klt_lk_launch(const float* tmpl, const float* srch, int B,
                             int H, int W, const float* feat,
                             const unsigned char* valid, int n, int win,
                             int num_iters, float eps2, float min_eig_thr,
                             float max_resid, float* out,
                             cudaStream_t stream) {
  if (n > 0 && B > 0) {
    switch (win) {  // the wrapper admits odd windows 5..15
#define KLT_LK_WIN(k)                                                     \
  case k:                                                                 \
    launch<k>(tmpl, srch, B, H, W, feat, valid, n, num_iters, eps2,       \
              min_eig_thr, max_resid, out, stream);                       \
    break;
      KLT_LK_WIN(5) KLT_LK_WIN(7) KLT_LK_WIN(9) KLT_LK_WIN(11)
      KLT_LK_WIN(13) KLT_LK_WIN(15)
#undef KLT_LK_WIN
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
