// K2: 4-level on-the-fly correlation-window lookup (altcorr) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   vipe_tpu/ops/pallas_corr.py::corr_fused_pallas
// (ViPE's altcorr_forward, applied per pyramid level).
//
// What it computes, for every edge e, source pixel p = (y1, x1) and level l
// (bf16 features f1 of shape (E, h1, w1, C) and f2_l of shape
// (E, h2_l, w2_l, C), both already carrying the /4 scaling):
//   (u, v) = coords[e, p] / 2^l,  x0 = floor(u), y0 = floor(v),
//   fx = u - x0, fy = v - y0,
//   D[r][j] = sum_c f1[e, p, c] * f2_l[e, y0 - 3 + r, x0 - 3 + j, c]
//             for the 8 x 8 integer neighbours r, j in [0, 8), f32;
//   out[e, p, l*49 + dy*7 + dx] =
//       sum over corners (cy, cx) in {0,1}^2 of
//       w(cy, cx) * D[dy + cy][dx + cx]
//   with w = (cy ? fy : 1-fy) * (cx ? fx : 1-fx); a corner outside the
//   h2_l x w2_l plane adds 0.  No correlation volume is ever stored.
//
// What bounds it on this card: at the frontend shape (E = 48, 41x73 grid,
// C = 128, levels 41x73 / 20x36 / 10x18 / 5x9) it must read f1 (36.8 MB),
// the f2 rows the neighbourhoods touch (at most each edge's pyramid) and
// write 112.6 MB of f32 output, about 0.2 GB: ~60 us at 3.35 TB/s.  The
// dots are at most 9.4 GFLOP, ~10 us on the bf16 tensor cores but ~140 us
// on the f32 CUDA cores this first version uses, so as written it is bound
// by operations, not bytes.
//
// Design (simple, correct first; the TPU body's loop over every target row,
// which Mosaic forced, is not carried over: each pixel needs only 64 dots
// per level): one warp per source pixel, all levels in one launch.  The
// pixel's f1 sits in registers, two channels per 32-bit load and lane, so a
// warp reads a 256-byte f2 row in coalesced 128-byte pieces.  For each row
// of the 8 x 8 neighbourhood every lane accumulates its partial sums of the
// 8 dots in f32; one butterfly (9 shuffles instead of 8 x 5) reduces the 8
// across the warp.  The 64 dots go to shared memory and the 49 bilinear taps
// are formed from them in f32.  Out-of-plane neighbours are skipped (rows
// and columns are warp-uniform), corners are checked against the plane, so a
// pixel whose window lies outside gives exactly 0.  Coordinates are floored
// before the integer cast and clamped at +-2^20; edge offsets are 64-bit;
// each level's size comes from its own shape (tiny grids clamp to 1 px).
//
// Making it fast is later work: stage each edge's f2 neighbourhoods in
// shared memory (cp.async / TMA) for the pixels that share them, and form
// the dots as mma / wgmma tiles over those pixels on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 3;
constexpr int kSpan = 2 * kRadius + 2;  // 8 integer neighbours per axis
constexpr int kWin = 2 * kRadius + 1;   // 7
constexpr int kTaps = kWin * kWin;      // 49
constexpr int kMaxLevels = 4;
constexpr int kWarps = 4;               // source pixels per block
constexpr float kCoordClamp = 1048576.0f;  // 2^20: far outside any plane

struct Pyramid {
  const __nv_bfloat16* f2[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// Sum over the warp of each lane's v[0..7].  Afterwards every lane holds the
// sum of v[(lane >> 2) & 7]: each exchange halves the values a lane keeps.
__device__ __forceinline__ float reduce8(float (&v)[kSpan], int lane) {
  const bool hi16 = lane & 16;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = hi16 ? v[k] : v[k + 4];
    const float keep = hi16 ? v[k + 4] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  const bool hi8 = lane & 8;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = hi8 ? v[k] : v[k + 2];
    const float keep = hi8 ? v[k + 2] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const bool hi4 = lane & 4;
  const float send = hi4 ? v[0] : v[1];
  float s = (hi4 ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

// kPairs: bf16 channel pairs per lane, ceil(C / 64).
template <int kPairs>
__global__ void __launch_bounds__(kWarps * 32)
corr_fused_kernel(const __nv_bfloat16* __restrict__ f1, Pyramid pyr,
                  const float* __restrict__ coords, float* __restrict__ out,
                  int64_t n_pix, int64_t pix_per_edge, int channels_c,
                  int n_levels) {
  __shared__ float dots[kWarps][kSpan * kSpan];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (pix >= n_pix) return;  // the whole warp leaves together
  const int64_t edge = pix / pix_per_edge;
  const int pairs = channels_c / 2;

  float2 a[kPairs];
  const __nv_bfloat162* f1p =
      reinterpret_cast<const __nv_bfloat162*>(f1 + pix * channels_c);
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int q = lane + 32 * k;
    a[k] = q < pairs ? __bfloat1622float2(f1p[q]) : make_float2(0.0f, 0.0f);
  }
  const float cu = coords[2 * pix];
  const float cv = coords[2 * pix + 1];
  float* d = dots[warp];
  const int out_channels = n_levels * kTaps;
  float* out_pix = out + pix * out_channels;

  for (int level = 0; level < n_levels; ++level) {
    const float inv = 1.0f / static_cast<float>(1 << level);
    const float u = cu * inv;
    const float v = cv * inv;
    const float xf = fminf(fmaxf(floorf(u), -kCoordClamp), kCoordClamp);
    const float yf = fminf(fmaxf(floorf(v), -kCoordClamp), kCoordClamp);
    const float fx = u - xf;
    const float fy = v - yf;
    const int x0 = static_cast<int>(xf) - kRadius;
    const int y0 = static_cast<int>(yf) - kRadius;
    const int h = pyr.h[level];
    const int w = pyr.w[level];
    const __nv_bfloat162* plane = reinterpret_cast<const __nv_bfloat162*>(
        pyr.f2[level] + edge * h * w * channels_c);

#pragma unroll 1
    for (int r = 0; r < kSpan; ++r) {
      const int y = y0 + r;
      float part[kSpan];
#pragma unroll
      for (int j = 0; j < kSpan; ++j) part[j] = 0.0f;
      if (y >= 0 && y < h) {  // warp-uniform
#pragma unroll
        for (int j = 0; j < kSpan; ++j) {
          const int x = x0 + j;
          if (x < 0 || x >= w) continue;  // warp-uniform
          const __nv_bfloat162* row =
              plane + (static_cast<int64_t>(y) * w + x) * pairs;
#pragma unroll
          for (int k = 0; k < kPairs; ++k) {
            const int q = lane + 32 * k;
            if (q < pairs) {
              const float2 b = __bfloat1622float2(row[q]);
              part[j] = fmaf(a[k].x, b.x, part[j]);
              part[j] = fmaf(a[k].y, b.y, part[j]);
            }
          }
        }
      }
      const float s = reduce8(part, lane);
      if ((lane & 3) == 0) d[r * kSpan + ((lane >> 2) & 7)] = s;
    }
    __syncwarp();

    for (int t = lane; t < kTaps; t += 32) {
      const int dy = t / kWin;
      const int dx = t - dy * kWin;
      float acc = 0.0f;
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const int yy = y0 + dy + cy;
        if (yy < 0 || yy >= h) continue;
        const float wy = cy ? fy : 1.0f - fy;
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) {
          const int xx = x0 + dx + cx;
          if (xx < 0 || xx >= w) continue;
          const float wx = cx ? fx : 1.0f - fx;
          acc += wy * wx * d[(dy + cy) * kSpan + dx + cx];
        }
      }
      out_pix[level * kTaps + t] = acc;
    }
    __syncwarp();  // the next level overwrites d
  }
}

template <int kPairs>
cudaError_t launch(const __nv_bfloat16* f1, const Pyramid& pyr,
                   const float* coords, float* out, int64_t n_pix,
                   int64_t pix_per_edge, int c, int n_levels,
                   cudaStream_t stream) {
  const int64_t blocks = (n_pix + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  corr_fused_kernel<kPairs><<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
      f1, pyr, coords, out, n_pix, pix_per_edge, c, n_levels);
  return cudaGetLastError();
}

}  // namespace

// f1 and the f2 levels are contiguous bf16 (4-byte aligned), C even and at
// most 256.  Pointers of unused levels are null.  Returns the cudaError_t of
// the launch (0 = success).
extern "C" int vipe_corr_fused(const void* f1, const void* f2_0, const void* f2_1,
                               const void* f2_2, const void* f2_3, int h0, int w0,
                               int h1, int w1, int h2, int w2, int h3, int w3,
                               const void* coords, void* out, long long n_pix,
                               long long pix_per_edge, int c, int n_levels,
                               void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (c < 2 || c > 256 || (c & 1)) return cudaErrorInvalidValue;
  Pyramid pyr;
  const void* f2s[kMaxLevels] = {f2_0, f2_1, f2_2, f2_3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  for (int l = 0; l < kMaxLevels; ++l) {
    pyr.f2[l] = static_cast<const __nv_bfloat16*>(f2s[l]);
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
  }
  if (n_pix == 0) return cudaSuccess;
  const auto* f1b = static_cast<const __nv_bfloat16*>(f1);
  const auto* cf = static_cast<const float*>(coords);
  auto* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((c / 2 + 31) / 32) {
    case 1: return static_cast<int>(launch<1>(f1b, pyr, cf, of, n_pix, pix_per_edge, c, n_levels, s));
    case 2: return static_cast<int>(launch<2>(f1b, pyr, cf, of, n_pix, pix_per_edge, c, n_levels, s));
    case 3: return static_cast<int>(launch<3>(f1b, pyr, cf, of, n_pix, pix_per_edge, c, n_levels, s));
    default: return static_cast<int>(launch<4>(f1b, pyr, cf, of, n_pix, pix_per_edge, c, n_levels, s));
  }
}
