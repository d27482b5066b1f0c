// K1: 4-level bilinear correlation-window lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   vipe_tpu/ops/pallas_corr.py::corr_lookup_pyramid_pallas
// (ViPE's corr_index_forward, applied per pyramid level).
//
// What it computes, for every edge e, source pixel p = (y1, x1) and level l
// (volume V_l of shape (E, h1, w1, h2_l, w2_l)):
//   (u, v) = coords[e, p] / 2^l,  x0 = floor(u), y0 = floor(v),
//   fx = u - x0, fy = v - y0,
//   out[e, p, l*49 + dy*7 + dx] =
//       sum over corners (cy, cx) in {0,1}^2 of
//       w(cy, cx) * V_l[e, p, y0 - 3 + dy + cy, x0 - 3 + dx + cx]
//   with w = (cy ? fy : 1-fy) * (cx ? fx : 1-fx); a corner outside the
//   h2_l x w2_l plane adds 0.  Accumulation is f32.  For int8 volumes the
//   per-edge, per-level scale multiplies the result (dequantisation folded
//   into the output: the window sum is linear in the volume).
//
// What bounds it on this card: memory bytes.  Each output element costs 8
// flops, each read 2 bytes (bf16) or 1 (int8), two orders of magnitude
// below the H100's ~295 flop/byte ridge.  At the frontend shape (E = 48,
// 41x73 grid, levels 41x73 / 20x36 / 10x18 / 5x9) it writes 112.6 MB of f32
// output and reads at most 73.6 MB of bf16 window values: the bound is
// ~0.05 ms at 3.35 TB/s (chip_smoke.py::_lookup_bound counts this run's
// data).  Every pixel owns its own planes, so nothing is shared between
// pixels; what a kernel can waste is instructions and partial sectors.
//
// Design: one warp per source pixel, one lane per (level, window row):
// lane 8l + r owns row y0_l - 3 + r of the pixel's level-l plane, columns
// x0_l - 3 .. x0_l + 4 (out-of-plane values are 0); levels that do not
// exist leave their lanes idle.
// - Loads: the 8 elements of a row span a few aligned 4-byte words (5 for
//   bf16, 3 for int8, 8 for f32).  The warp's 32 rows are read as those
//   words with word i of the warp going to lane i % 32, so one load
//   instruction covers a few whole rows (a few cache lines) where one
//   element per lane would touch 32 scattered lines.  All loads are issued
//   before any is used; a word is read only if it holds an element of the
//   row, so no read leaves the volume.  The words go to shared memory and
//   each lane reads its row's elements back at their unaligned offset.
// - Addressing: one 64-bit plane base per pixel and level, 32-bit offsets
//   inside the plane, no division on the hot path; level parameters are
//   selected by comparison so they stay in the constant bank (no stack).
// - Arithmetic: the lane lerps horizontally (h[dx] = (1-fx) v[dx] +
//   fx v[dx+1]); one __shfl_down_sync brings row r+1's h, and lane r < 7
//   forms output row dy = r by the vertical lerp.  That is the four-corner
//   sum above in another rounding order (an out-of-plane corner is 0 in
//   both).  The int8 scale multiplies the result.
// - Stores: the warp stages its 196 outputs in shared memory and writes the
//   784-byte row as 49 float4 stores (16-byte aligned at 4 levels), so each
//   output byte is written once, coalesced.
// Coordinates are floored before the integer cast and clamped at +-2^20;
// level sizes come from each level's own shape.  bf16, f32 and int8 share
// one templated body.  No registers spill and there is no stack frame
// (nvcc -Xptxas -v: 32 registers; 11.4 KB shared memory per 8-warp block
// for bf16).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W, frontend shape):
// 0.12 ms against the 0.050 ms bound, where grid_sample takes 0.26 ms; the
// measured run's exact numbers are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

constexpr int kRadius = 3;
constexpr int kSpan = 2 * kRadius + 2;  // 8 window rows and columns read
constexpr int kWin = 2 * kRadius + 1;   // 7
constexpr int kTaps = kWin * kWin;      // 49
constexpr int kMaxLevels = 4;
constexpr int kWarps = 8;               // source pixels per block
constexpr float kCoordClamp = 1048576.0f;  // 2^20: far outside any plane

struct Levels {
  const void* vol[kMaxLevels];
  const float* scale[kMaxLevels];  // per-edge (E,) or null
  int h2[kMaxLevels];
  int w2[kMaxLevels];
};

// A kernel parameter indexed by a runtime level would be copied to local
// memory; selecting by comparisons keeps it in the constant bank.
template <typename X>
__device__ __forceinline__ X pick(const X (&a)[kMaxLevels], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_kernel(Levels lv, const float* __restrict__ coords,
                   float* __restrict__ out, int64_t n_pix, int64_t pix_per_edge,
                   int n_levels) {
  // A window row of 8 elements spans kWords aligned 4-byte words.
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));
  constexpr int kWords = (kSpan + 2 * (kPerWord - 1)) / kPerWord;  // bf16 5, int8 3, f32 8
  __shared__ uint32_t words[kWarps][32 * kWords];
  __shared__ __align__(16) float stage[kWarps][kMaxLevels * kTaps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (pix >= n_pix) return;  // the whole warp leaves together; no block barrier
  const int level = lane >> 3;
  const int r = lane & 7;
  const bool active = level < n_levels;
  const int lvl = active ? level : 0;

  // --- this lane's row: level lvl, row y0 - 3 + r, columns x0 - 3 .. x0 + 4
  const float inv = 1.0f / static_cast<float>(1 << lvl);
  const float u = coords[2 * pix] * inv;
  const float v = coords[2 * pix + 1] * inv;
  const float xf = fminf(fmaxf(floorf(u), -kCoordClamp), kCoordClamp);
  const float yf = fminf(fmaxf(floorf(v), -kCoordClamp), kCoordClamp);
  const float fx = u - xf;
  const float fy = v - yf;
  const int x0 = static_cast<int>(xf) - kRadius;
  const int y = static_cast<int>(yf) - kRadius + r;
  const int h2 = pick(lv.h2, lvl);
  const int w2 = pick(lv.w2, lvl);
  const int ja = min(max(-x0, 0), kSpan);       // window columns [ja, jb) lie in the row
  const int jb = max(min(w2 - x0, kSpan), ja);
  const bool row_ok = active && y >= 0 && y < h2 && ja < jb;
  uintptr_t first = 0;  // byte address of the window's column 0 (may precede the row)
  int lead = 0;         // elements between the aligned word and column 0
  if (row_ok) {
    const T* row = static_cast<const T*>(pick(lv.vol, lvl)) +
                   pix * (static_cast<int64_t>(h2) * w2) + y * w2;
    first = reinterpret_cast<uintptr_t>(row) + static_cast<intptr_t>(x0) * sizeof(T);
    lead = static_cast<int>(first & 3) / static_cast<int>(sizeof(T));
  }
  const uintptr_t word0 = first & ~static_cast<uintptr_t>(3);
  const int packed = row_ok ? (1 << 12) | (jb << 8) | (ja << 4) | lead : 0;

  // --- the warp's 32 rows as 4-byte words: load i takes word i % kWords of
  // row i / kWords, so one load instruction covers a few whole rows (a few
  // cache lines) instead of 32 scattered ones.  A word is read only if it
  // holds an element of the row, so no read leaves the volume.
  uint32_t* wbuf = words[warp];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int i = 32 * k + lane;
    const int src = i / kWords;
    const int wd = i - src * kWords;
    const uint32_t lo = __shfl_sync(0xffffffffu, static_cast<uint32_t>(word0), src);
    const uint32_t hi = __shfl_sync(0xffffffffu, static_cast<uint32_t>(word0 >> 32), src);
    const int pk = __shfl_sync(0xffffffffu, packed, src);
    uint32_t val = 0;
    const int s0 = (pk & 15) + ((pk >> 4) & 15);  // first in-row element, from the word base
    const int s1 = (pk & 15) + ((pk >> 8) & 15);  // one past the last
    if ((pk >> 12) && wd * kPerWord < s1 && (wd + 1) * kPerWord > s0) {
      const uintptr_t a = ((static_cast<uintptr_t>(hi) << 32) | lo) + 4 * wd;
      val = __ldg(reinterpret_cast<const unsigned int*>(a));
    }
    wbuf[i] = val;
  }
  __syncwarp();

  float val[kSpan];
  const T* mine = reinterpret_cast<const T*>(wbuf + lane * kWords) + lead;
#pragma unroll
  for (int j = 0; j < kSpan; ++j)
    val[j] = (row_ok && j >= ja && j < jb) ? to_float(mine[j]) : 0.0f;

  float scale = 1.0f;
  if (active) {
    const float* sc = pick(lv.scale, lvl);
    if (sc != nullptr) scale = sc[pix / pix_per_edge];
  }

  // --- horizontal lerp in the lane, vertical lerp with row r + 1 by shuffle
  float* st = stage[warp];
#pragma unroll
  for (int dx = 0; dx < kWin; ++dx) {
    const float h = (1.0f - fx) * val[dx] + fx * val[dx + 1];
    const float below = __shfl_down_sync(0xffffffffu, h, 1);
    if (active && r < kWin)
      st[level * kTaps + r * kWin + dx] = ((1.0f - fy) * h + fy * below) * scale;
  }
  __syncwarp();

  const int channels = n_levels * kTaps;
  float* dst = out + pix * channels;
  if (channels % 4 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(st);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int i = lane; i < channels / 4; i += 32) dst4[i] = src4[i];
  } else {
    for (int i = lane; i < channels; i += 32) dst[i] = st[i];
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = f32, 2 = int8.  Pointers of unused levels and absent
// scales are null.  Returns the cudaError_t of the launch (0 = success).
extern "C" int vipe_corr_lookup(int dtype, const void* v0, const void* v1,
                                const void* v2, const void* v3, int h0, int w0,
                                int h1, int w1, int h2, int w2, int h3, int w3,
                                const void* s0, const void* s1, const void* s2,
                                const void* s3, const void* coords, void* out,
                                long long n_pix, long long pix_per_edge,
                                int n_levels, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  Levels lv;
  const void* vols[kMaxLevels] = {v0, v1, v2, v3};
  const void* scales[kMaxLevels] = {s0, s1, s2, s3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.vol[l] = vols[l];
    lv.scale[l] = static_cast<const float*>(scales[l]);
    lv.h2[l] = hs[l];
    lv.w2[l] = ws[l];
  }
  if (n_pix == 0) return cudaSuccess;
  const int64_t blocks = (static_cast<int64_t>(n_pix) + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(coords);
  float* of = static_cast<float*>(out);
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (dtype) {
    case 0:
      corr_lookup_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
          lv, cf, of, n_pix, pix_per_edge, n_levels);
      break;
    case 1:
      corr_lookup_kernel<float><<<grid, kWarps * 32, 0, s>>>(
          lv, cf, of, n_pix, pix_per_edge, n_levels);
      break;
    case 2:
      corr_lookup_kernel<int8_t><<<grid, kWarps * 32, 0, s>>>(
          lv, cf, of, n_pix, pix_per_edge, n_levels);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
