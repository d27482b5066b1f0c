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
// What bounds it on this card: bytes.  At the frontend shape (E = 48, 41x73
// grid, C = 128, levels 41x73 / 20x36 / 10x18 / 5x9) it must read f1
// (36.8 MB) and the f2 rows the neighbourhoods touch, and write 112.6 MB of
// f32 output: ~0.2 GB, ~0.06 ms at 3.35 TB/s.  The 7 GFLOP of needed dots
// take ~7 us on the bf16 tensor cores but 0.1 ms on f32 CUDA cores, which is
// why the dots go to the tensor cores here.
//
// Design: one block per tile of 8 x 8 neighbouring source pixels of one
// edge (ragged tiles at the grid's edge are masked; a tile never straddles
// two edges), two warpgroups.
// - The tile's f1 goes to shared memory once by cp.async (64 x C bf16,
//   channels zero-padded to Cp, a multiple of 16).  With C = 128 each warp
//   then keeps its 16 pixels' f1 fragments in registers for the whole tile.
// - Set-up, for all levels at once: each pixel's 8 x 8 neighbourhood is
//   clipped to the plane; a level's box is the union of the neighbourhoods
//   that are not empty, so a far-out pixel neither widens it nor gets a dot
//   (its output is exactly 0).
// - The boxes' f2 rows are staged by cp.async in chunks of 64 positions,
//   one flat sequence over the levels, three buffers deep (two chunks in
//   flight while one is used), in the non-swizzled core-matrix layout that
//   wgmma reads: 16-byte copies when C*2 is a multiple of 16, else 4-byte
//   copies; positions past the box are zero-filled.
// - Each chunk's dots are a 64 x 64 x Cp product on the tensor cores:
//   wgmma.mma_async m64n32k16 per warpgroup (half of the chunk's columns),
//   bf16 inputs, f32 accumulators, A from registers, B from shared memory
//   by descriptor.  The accumulators go to shared memory and each (pixel,
//   window row) copies the dots of its row that the chunk holds, so each
//   pixel keeps its 64 dots (0 where a neighbour is out of the plane).
// - Per level, the 49 bilinear taps are formed in f32 from those dots, one
//   output row (7 taps) per thread, staged in shared memory and written
//   with neighbouring lanes on neighbouring floats.
// One code path is right for any coords; an incoherent tile only takes
// more chunks.  bf16 products are exact in f32; only the order of the f32
// sums differs from the plain version.  Coordinates are floored before the
// integer cast and clamped at +-2^20; edge offsets are 64-bit; each level's
// size comes from its own shape.  Nothing is allocated but shared memory
// (99 KB dynamic + 4 KB static at C = 128: two blocks per SM); no spills,
// no stack frame (nvcc -Xptxas -v: 127 registers at C = 128, 102 for
// other C).
//
// What still holds it back: staging.  Neighbouring tiles' boxes overlap
// (about 10x at level 0 for 8 x 8 tiles), so the chunks bring ~0.8 GB from
// L2 for 49 MB of distinct f2, near the L2's bandwidth; an 8 x 16 tile
// stages less per pixel but fits only one block per SM and ran slower.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W, frontend shape):
// 0.42 ms against the 0.059 ms bound (1.39 ms before this design); the
// measured run's exact numbers are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 3;
constexpr int kSpan = 2 * kRadius + 2;  // 8 integer neighbours per axis
constexpr int kNbr = kSpan * kSpan;     // 64 dots per pixel and level
constexpr int kWin = 2 * kRadius + 1;   // 7
constexpr int kTaps = kWin * kWin;      // 49
constexpr int kMaxLevels = 4;
constexpr int kTileH = 8;
constexpr int kTileW = 8;
constexpr int kTile = kTileH * kTileW;  // 64 source pixels: the wgmma's M
constexpr int kThreads = 256;           // 2 warpgroups, each half of a chunk's columns
constexpr int kChunk = 64;              // f2 positions staged per chunk
constexpr int kHalf = kChunk / 2;       // a warpgroup's columns: the wgmma's N
constexpr int kStages = 3;              // chunk buffers: two chunks in flight while one is used
constexpr int kPad = 8;                 // bf16 pad per f1 row (conflict-free ldmatrix)
constexpr int kLdD = kChunk + 8;        // f32 per row of a chunk's dots (conflict-free float2)
constexpr int kFar = 1 << 28;           // neighbourhood origin of a masked pixel
constexpr float kCoordClamp = 1048576.0f;  // 2^20: far outside any plane
static_assert(kTile * kSpan == 2 * kThreads, "two (pixel, window row) units per thread");

struct Pyramid {
  const __nv_bfloat16* f2[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src_bytes == 0 zero-fills the destination without reading the source.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// wgmma descriptor of a K-major bf16 tile in the non-swizzled layout: core
// matrices of 8 rows x 16 bytes, k-neighbours 128 bytes apart (LBO), 8-row
// groups sbo bytes apart (SBO).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// d += a * b for the warpgroup: a 64 x 16 bf16 slice of A in registers (each
// warp its 16 rows, mma.m16n8k16 fragment order), a 16 x 32 slice of B from
// shared memory by descriptor, f32 accumulators.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes (cp.async, st.shared) visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// floor(k / d) for 0 <= k < 2^24 and d >= 1, given inv = 1 / d: a multiply
// and an exact correction instead of an integer division.
__device__ __forceinline__ int div_by(int k, int d, float inv) {
  int q = static_cast<int>((static_cast<float>(k) + 0.5f) * inv);
  q -= q * d > k;
  q += (q + 1) * d <= k;
  return q;
}

// a[l] for l in [0, kMaxLevels).  An array (kernel parameter or local)
// indexed by a runtime level would go to local memory; comparisons keep it
// in registers or the constant bank.
template <typename X, int N>
__device__ __forceinline__ X pick(const X (&a)[N], int l) {
  static_assert(N >= kMaxLevels, "one entry per level");
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// kSteps > 0: Cp == 16 * kSteps and each warp keeps its f1 fragments in
// registers for the whole tile; kSteps == 0: any Cp, fragments reloaded from
// shared memory at every step.
template <int kSteps>
__global__ void __launch_bounds__(kThreads, 2)
corr_fused_kernel(const __nv_bfloat16* __restrict__ f1, Pyramid pyr,
                  const float* __restrict__ coords, float* __restrict__ out,
                  int h1, int w1, int tiles_x, int tiles_per_edge, int C, int Cp,
                  int n_levels, bool copy16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Cp + kPad;             // bf16 per f1 row
  const uint32_t sbo = Cp * 16;         // bytes between 8-position groups of a chunk
  const int chunk_bytes = kChunk * Cp * 2;
  __nv_bfloat16* f1s = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* f2s = smem + kTile * ld * 2;                       // kStages chunk buffers
  float* dots = reinterpret_cast<float*>(f2s + kStages * chunk_bytes);  // kTile x kNbr
  float* dtile = dots + kTile * kNbr;  // one chunk's kTile x kChunk dots, rows of kLdD
  __shared__ float s_fx[kMaxLevels][kTile], s_fy[kMaxLevels][kTile];
  __shared__ int s_x0[kMaxLevels][kTile], s_y0[kMaxLevels][kTile];
  __shared__ int s_box[2 * kMaxLevels][4];  // per warp: ylo, xlo, yhi, xhi

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t edge = blockIdx.x / tiles_per_edge;
  const int tile = static_cast<int>(blockIdx.x - edge * tiles_per_edge);
  const int ty0 = (tile / tiles_x) * kTileH;
  const int tx0 = (tile % tiles_x) * kTileW;
  const int64_t edge_pix = edge * h1 * w1;
  const int out_ch = n_levels * kTaps;
  const int step = copy16 ? 8 : 2;  // bf16 per cp.async
  const int per_row = C / step;
  const float inv_per_row = 1.0f / static_cast<float>(per_row);

  // --- the tile's f1 by cp.async (zero rows for masked pixels), zero pads
  for (int i = tid; i < kTile * per_row; i += kThreads) {
    const int p = div_by(i, per_row, inv_per_row), piece = i - p * per_row;
    const int y = ty0 + p / kTileW, x = tx0 + p % kTileW;
    const bool ok = y < h1 && x < w1;
    const __nv_bfloat16* src =
        ok ? f1 + (edge_pix + static_cast<int64_t>(y) * w1 + x) * C + piece * step : f1;
    const uint32_t d = smem_addr(f1s + p * ld + piece * step);
    if (copy16)
      cp_async16(d, src, ok ? 16 : 0);
    else
      cp_async4(d, src, ok ? 4 : 0);
  }
  cp_async_commit();
  {
    const int pad_words = (Cp - C) / 2;  // f1 channels [C, Cp)
    for (int i = tid; i < kTile * pad_words; i += kThreads) {
      const int row = i / pad_words, q = i - row * pad_words;
      reinterpret_cast<uint32_t*>(f1s + row * ld + C)[q] = 0u;
    }
    // chunk buffers all zero: cp.async writes only channels [0, C)
    uint4* z = reinterpret_cast<uint4*>(f2s);
    for (int i = tid; i < kStages * chunk_bytes / 16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < kTile * kNbr; i += kThreads) dots[i] = 0.0f;
  }

  // --- per (level, pixel), one per thread: neighbourhood origin, fractions,
  // clipped extent; each level's box is the union over its two warps
  {
    const int level = tid / kTile, p = tid % kTile;  // warps 2l, 2l + 1 hold level l
    int ylo = INT_MAX, xlo = INT_MAX, yhi = INT_MIN, xhi = INT_MIN;
    if (level < n_levels) {
      const int y = ty0 + p / kTileW, x = tx0 + p % kTileW;
      const bool ok = y < h1 && x < w1;
      const int64_t pix = edge_pix + static_cast<int64_t>(y) * w1 + x;
      const float inv = 1.0f / static_cast<float>(1 << level);
      const float u = ok ? coords[2 * pix] * inv : 0.0f;
      const float v = ok ? coords[2 * pix + 1] * inv : 0.0f;
      const float xf = fminf(fmaxf(floorf(u), -kCoordClamp), kCoordClamp);
      const float yf = fminf(fmaxf(floorf(v), -kCoordClamp), kCoordClamp);
      const int nx = static_cast<int>(xf) - kRadius;
      const int ny = static_cast<int>(yf) - kRadius;
      const int h = pick(pyr.h, level), w = pick(pyr.w, level);
      const int cy0 = max(ny, 0), cy1 = min(ny + kSpan, h);
      const int cx0 = max(nx, 0), cx1 = min(nx + kSpan, w);
      const bool any = ok && cy0 < cy1 && cx0 < cx1;
      s_fx[level][p] = u - xf;
      s_fy[level][p] = v - yf;
      s_x0[level][p] = any ? nx : kFar;
      s_y0[level][p] = any ? ny : kFar;
      if (any) {
        ylo = cy0;
        xlo = cx0;
        yhi = cy1;
        xhi = cx1;
      }
    }
    ylo = __reduce_min_sync(0xffffffffu, ylo);
    xlo = __reduce_min_sync(0xffffffffu, xlo);
    yhi = __reduce_max_sync(0xffffffffu, yhi);
    xhi = __reduce_max_sync(0xffffffffu, xhi);
    if (lane == 0) {
      s_box[warp][0] = ylo;
      s_box[warp][1] = xlo;
      s_box[warp][2] = yhi;
      s_box[warp][3] = xhi;
    }
  }
  __syncthreads();

  // every thread derives each level's box and the chunk count before it
  int box_y[kMaxLevels], box_x[kMaxLevels], box_w[kMaxLevels], box_n[kMaxLevels];
  int first_chunk[kMaxLevels + 1];
  first_chunk[0] = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    const int ylo = min(s_box[2 * l][0], s_box[2 * l + 1][0]);
    const int xlo = min(s_box[2 * l][1], s_box[2 * l + 1][1]);
    const int yhi = max(s_box[2 * l][2], s_box[2 * l + 1][2]);
    const int xhi = max(s_box[2 * l][3], s_box[2 * l + 1][3]);
    const bool any = l < n_levels && ylo < yhi;
    box_y[l] = any ? ylo : 0;
    box_x[l] = any ? xlo : 0;
    box_w[l] = any ? xhi - xlo : 1;
    box_n[l] = any ? (yhi - ylo) * (xhi - xlo) : 0;
    first_chunk[l + 1] = first_chunk[l] + (box_n[l] + kChunk - 1) / kChunk;
  }
  const int n_chunks = first_chunk[kMaxLevels];

  // stage chunk g of the flat (level, chunk) sequence into buffer g % kStages,
  // in the wgmma layout (position r, channel k at byte (r/8)*sbo + (k/8)*128 +
  // (r%8)*16 + (k%8)*2); lanes take neighbouring positions, so the 16-byte
  // shared writes do not collide.  One commit group per call, empty past the end.
  auto stage = [&](int g) {
    if (g < n_chunks) {
      int l = 0;
#pragma unroll
      for (int q = 1; q < kMaxLevels; ++q) l += g >= first_chunk[q];
      const int by = pick(box_y, l), bx = pick(box_x, l), bw = pick(box_w, l);
      const int bn = pick(box_n, l);
      const int w = pick(pyr.w, l);
      const __nv_bfloat16* plane = pick(pyr.f2, l) + edge * pick(pyr.h, l) * w * C;
      const uint32_t dst = smem_addr(f2s + (g % kStages) * chunk_bytes);
      const int k0 = (g - pick(first_chunk, l)) * kChunk;
      const float inv_bw = 1.0f / static_cast<float>(bw);
      for (int i = tid; i < kChunk * per_row; i += kThreads) {
        const int rest = i >> 3;
        const int grp = div_by(rest, per_row, inv_per_row);
        const int piece = rest - grp * per_row;
        const int row = grp * 8 + (i & 7);
        const int k = k0 + row;
        const bool in = k < bn;
        const int ky = in ? div_by(k, bw, inv_bw) : 0;
        const int yy = by + ky, xx = bx + (in ? k - ky * bw : 0);
        const __nv_bfloat16* src =
            plane + (static_cast<int64_t>(yy) * w + xx) * C + piece * step;
        const int ch = piece * step;  // first channel of the piece
        const uint32_t d = dst + grp * sbo + (ch >> 3) * 128 + (i & 7) * 16 + (ch & 7) * 2;
        if (copy16)
          cp_async16(d, src, in ? 16 : 0);
        else
          cp_async4(d, src, in ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // warpgroup g takes chunk columns [32 g, +32); its warp w the 16 pixels
  // from 16 (w % 4)
  const int ncol = (warp >> 2) * kHalf;
  const int mrow = (warp & 3) * 16;
  const uint32_t a_addr =
      smem_addr(f1s + (mrow + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8);
  const int p0 = mrow + (lane >> 2), p1 = p0 + 8;  // this thread's accumulator rows
  const int col0 = ncol + (lane & 3) * 2;          // and first column

#pragma unroll 1
  for (int g = 0; g < kStages - 1; ++g) stage(g);
  uint32_t afrag[kSteps > 0 ? kSteps : 1][4];
  if (kSteps > 0) {
    cp_async_wait<kStages - 1>();  // the f1 group, committed before the chunks
    __syncthreads();
#pragma unroll
    for (int s = 0; s < (kSteps > 0 ? kSteps : 1); ++s) ldmatrix_x4(a_addr + s * 32, afrag[s]);
  }

  int g = 0;
#pragma unroll 1
  for (int level = 0; level < n_levels; ++level) {
    const int by = pick(box_y, level), bx = pick(box_x, level), bw = pick(box_w, level);
    const int bn = pick(box_n, level);

    // extraction units (pixel, window row), two per thread: the row's box
    // index at window column 0 and its in-box columns [ja, jb)
    int run[2], ja[2], jb[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = tid + q * kThreads;
      const int p = u >> 3, r = u & 7;
      const int ry = s_y0[level][p] + r - by;  // box row (kFar: masked / empty)
      const int cx = s_x0[level][p] - bx;      // box column of window column 0
      const bool ok = bn > 0 && ry >= 0 && ry < bn / bw;
      ja[q] = ok ? min(max(-cx, 0), kSpan) : 0;
      jb[q] = ok ? max(min(bw - cx, kSpan), ja[q]) : 0;
      run[q] = ok ? ry * bw + cx : 0;
    }
#pragma unroll 1
    for (int k0 = 0; k0 < bn; k0 += kChunk, ++g) {
      stage(g + kStages - 1);
      cp_async_wait<kStages - 1>();  // f1 and chunk g have landed for this thread
      fence_async_shared();
      __syncthreads();               // ... and for every thread and the tensor cores

      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
      const uint32_t b_base = smem_addr(f2s + (g % kStages) * chunk_bytes) + (ncol / 8) * sbo;
      wgmma_fence();
      if (kSteps > 0) {
#pragma unroll
        for (int s = 0; s < (kSteps > 0 ? kSteps : 1); ++s)
          wgmma_m64n32k16(acc, afrag[s], smem_desc(b_base + s * 256, sbo));
      } else {
        for (int s = 0; s < Cp / 16; ++s) {
          uint32_t a[4];
          ldmatrix_x4(a_addr + s * 32, a);
          wgmma_fence();  // a was written outside wgmma
          wgmma_m64n32k16(acc, a, smem_desc(b_base + s * 256, sbo));
        }
      }
      wgmma_commit_and_wait();

      // the chunk's dots to shared memory, then each (pixel, window row)
      // copies the part of its row that this chunk holds
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + 8 * j;
        *reinterpret_cast<float2*>(dtile + p0 * kLdD + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(dtile + p1 * kLdD + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int lo = max(run[q] + ja[q], k0), hi = min(run[q] + jb[q], k0 + kChunk);
        if (lo >= hi) continue;
        const int u = tid + q * kThreads;
        const int p = u >> 3, r = u & 7;
        const float* src = dtile + p * kLdD + (run[q] - k0);
        float* dst = dots + p * kNbr + r * kSpan;
#pragma unroll
        for (int j = 0; j < kSpan; ++j) {
          const int k = run[q] + j;
          if (k >= lo && k < hi) dst[j] = src[j];
        }
      }
      __syncthreads();  // buffer g % kStages is free again; the dots are complete
    }
    if (bn == 0) __syncthreads();  // zeroed dots visible; the last write-out is done

    // --- the 49 bilinear taps per pixel in f32, one output row (7 taps) per
    // unit, into shared memory; the next chunks' copies stay in flight
    for (int u = tid; u < kTile * kWin; u += kThreads) {
      const int p = u / kWin, dy = u - p * kWin;
      const float4* d = reinterpret_cast<const float4*>(dots + p * kNbr + dy * kSpan);
      const float4 a0 = d[0], a1 = d[1], b0 = d[2], b1 = d[3];  // rows dy, dy + 1
      const float top[kSpan] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bot[kSpan] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float fx = s_fx[level][p], fy = s_fy[level][p];
      float* o = dtile + p * kLdD + dy * kWin;
#pragma unroll
      for (int dx = 0; dx < kWin; ++dx) {
        const float t = (1.0f - fx) * top[dx] + fx * top[dx + 1];
        const float b = (1.0f - fx) * bot[dx] + fx * bot[dx + 1];
        o[dx] = (1.0f - fy) * t + fy * b;
      }
    }
    __syncthreads();  // taps staged; the dots are read
    // each pixel's 49 outputs of this level, neighbouring lanes on
    // neighbouring floats (a 4-byte store per lane would scatter sectors)
    for (int i = tid; i < kTile * kTaps; i += kThreads) {
      const int p = i / kTaps, t = i - p * kTaps;
      const int y = ty0 + p / kTileW, x = tx0 + p % kTileW;
      if (y >= h1 || x >= w1) continue;
      const int64_t pix = edge_pix + static_cast<int64_t>(y) * w1 + x;
      out[pix * out_ch + level * kTaps + t] = dtile[p * kLdD + t];
    }
    for (int i = tid; i < kTile * kNbr; i += kThreads) dots[i] = 0.0f;
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <int kSteps>
cudaError_t launch(const __nv_bfloat16* f1, const Pyramid& pyr, const float* coords,
                   float* out, int64_t blocks, int h1, int w1, int tiles_x,
                   int tiles_per_edge, int c, int cp, int n_levels, bool copy16,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTile) * (cp + kPad) * 2 +
                      static_cast<size_t>(kStages) * kChunk * cp * 2 +
                      static_cast<size_t>(kTile) * (kNbr + kLdD) * 4;
  cudaError_t err = cudaFuncSetAttribute(corr_fused_kernel<kSteps>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  corr_fused_kernel<kSteps><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      f1, pyr, coords, out, h1, w1, tiles_x, tiles_per_edge, c, cp, n_levels, copy16);
  return cudaGetLastError();
}

}  // namespace

// f1 and the f2 levels are contiguous bf16 (4-byte aligned), C even and at
// most 256.  Pointers of unused levels are null.  Returns the cudaError_t of
// the launch (0 = success).
extern "C" int vipe_corr_fused(const void* f1, const void* f2_0, const void* f2_1,
                               const void* f2_2, const void* f2_3, int h0, int w0,
                               int h1, int w1, int h2, int w2, int h3, int w3,
                               const void* coords, void* out, long long n_edges,
                               int grid_h, int grid_w, int c, int n_levels,
                               void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (c < 2 || c > 256 || (c & 1)) return cudaErrorInvalidValue;
  Pyramid pyr;
  const void* f2s[kMaxLevels] = {f2_0, f2_1, f2_2, f2_3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  bool copy16 = c % 8 == 0 && reinterpret_cast<uintptr_t>(f1) % 16 == 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    pyr.f2[l] = static_cast<const __nv_bfloat16*>(f2s[l]);
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
    if (l < n_levels && reinterpret_cast<uintptr_t>(f2s[l]) % 16) copy16 = false;
  }
  if (n_edges == 0 || grid_h == 0 || grid_w == 0) return cudaSuccess;
  const int tiles_x = (grid_w + kTileW - 1) / kTileW;
  const int tiles_per_edge = ((grid_h + kTileH - 1) / kTileH) * tiles_x;
  const int64_t blocks = static_cast<int64_t>(n_edges) * tiles_per_edge;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const int cp = (c + 15) / 16 * 16;
  const auto* f1b = static_cast<const __nv_bfloat16*>(f1);
  const auto* cf = static_cast<const float*>(coords);
  auto* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cp == 128 ? launch<8>(f1b, pyr, cf, of, blocks, grid_h, grid_w, tiles_x, tiles_per_edge,
                            c, cp, n_levels, copy16, s)
                : launch<0>(f1b, pyr, cf, of, blocks, grid_h, grid_w, tiles_x, tiles_per_edge,
                            c, cp, n_levels, copy16, s);
  return static_cast<int>(err);
}
