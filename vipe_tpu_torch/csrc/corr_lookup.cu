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
// What bounds it on this card: memory bytes.  Each output element costs 16
// flops, each read 2 bytes (bf16) or 1 (int8), so the kernel sits two
// orders of magnitude below the H100's ~295 flop/byte ridge.  At the
// frontend shape (E = 48, 41x73 grid, levels 41x73 / 20x36 / 10x18 / 5x9)
// it writes 112.6 MB of f32 output and must read at least 73.6 MB of bf16
// window values (the 8x8 neighbourhoods), about 186 MB: ~56 us at 3.35 TB/s.
//
// Design (simple, correct first): one launch covers all levels; one thread
// per output element, threads ordered so that neighbouring threads write
// neighbouring channels of the 196-wide f32 output row (coalesced stores),
// and the 7 taps of one window row read neighbouring volume addresses.
// Every corner read is bounds-checked.  Offsets are 64-bit: backend volumes
// exceed 2^31 elements.  The element type is a template parameter, so
// bf16, f32 and int8 share one body.  Staging window rows in shared memory
// (cp.async / TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 3;
constexpr int kWin = 2 * kRadius + 1;  // 7
constexpr int kTaps = kWin * kWin;     // 49
constexpr int kMaxLevels = 4;
constexpr float kCoordClamp = 1048576.0f;  // 2^20: far outside any plane

struct Levels {
  const void* vol[kMaxLevels];
  const float* scale[kMaxLevels];  // per-edge (E,) or null
  int h2[kMaxLevels];
  int w2[kMaxLevels];
};

__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_as_float(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_as_float(const int8_t* p, int64_t i) {
  return static_cast<float>(p[i]);
}

template <typename T>
__global__ void corr_lookup_kernel(Levels lv, const float* __restrict__ coords,
                                   float* __restrict__ out, int64_t n_pix,
                                   int64_t pix_per_edge, int n_levels) {
  const int channels = n_levels * kTaps;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_pix * channels) return;
  const int64_t pix = idx / channels;  // e * (h1 * w1) + p
  const int c = static_cast<int>(idx - pix * channels);
  const int level = c / kTaps;
  const int tap = c - level * kTaps;
  const int dy = tap / kWin;
  const int dx = tap - dy * kWin;

  const float inv = 1.0f / static_cast<float>(1 << level);
  const float u = coords[2 * pix] * inv;
  const float v = coords[2 * pix + 1] * inv;
  const float xf = fminf(fmaxf(floorf(u), -kCoordClamp), kCoordClamp);
  const float yf = fminf(fmaxf(floorf(v), -kCoordClamp), kCoordClamp);
  const float fx = u - xf;
  const float fy = v - yf;
  const int x = static_cast<int>(xf) - kRadius + dx;
  const int y = static_cast<int>(yf) - kRadius + dy;

  const int h2 = lv.h2[level];
  const int w2 = lv.w2[level];
  const T* vol = static_cast<const T*>(lv.vol[level]);
  const int64_t plane = static_cast<int64_t>(h2) * w2;
  const int64_t base = pix * plane;

  float acc = 0.0f;
#pragma unroll
  for (int cy = 0; cy < 2; ++cy) {
    const int yy = y + cy;
    if (yy < 0 || yy >= h2) continue;
    const float wy = cy ? fy : 1.0f - fy;
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const int xx = x + cx;
      if (xx < 0 || xx >= w2) continue;
      const float wx = cx ? fx : 1.0f - fx;
      acc += wy * wx * load_as_float(vol, base + static_cast<int64_t>(yy) * w2 + xx);
    }
  }
  if (lv.scale[level] != nullptr) acc *= lv.scale[level][pix / pix_per_edge];
  out[idx] = acc;
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
  const int64_t total = static_cast<int64_t>(n_pix) * n_levels * kTaps;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(coords);
  float* of = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      corr_lookup_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
          lv, cf, of, n_pix, pix_per_edge, n_levels);
      break;
    case 1:
      corr_lookup_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
          lv, cf, of, n_pix, pix_per_edge, n_levels);
      break;
    case 2:
      corr_lookup_kernel<int8_t><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
          lv, cf, of, n_pix, pix_per_edge, n_levels);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
