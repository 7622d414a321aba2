// raster_common.cuh -- what the rasterizer's forward and backward kernels
// share: the face-row layout, the 16x16 pixel tile, and the block-uniform
// face culling with its in-order compaction.  Both kernels include this
// header, so the set of (tile, face) pairs the backward differentiates is
// exactly the set the forward summed.
#pragma once

#include <cuda_runtime.h>

namespace mm {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr int R = 26;       // floats per face row
constexpr int CHUNK = 256;  // faces tested per pass, one per thread
constexpr float SOFT_MARGIN = 0.035f;
constexpr float P_CLAMP = 1.0f - 1e-7f;
// where sigma * d^2 >= 88 the soft term is below 1e-38 and changes no float sum
constexpr float E_SKIP = 88.0f;

// column order of magicmirror_torch/ops/face_rows.py (rasterize_v4.py:45-49)
enum Col {
  A0X, A0Y, A0C, A1X, A1Y, A1C, A2X, A2Y, A2C, ZX, ZY, ZC,
  BXMIN, BXMAX, BYMIN, BYMAX, FID, UX, UY, UC, VX, VY, VC, NXR, NYR, NZR
};

// NDC pixel centres as rasterize_v4.py:1017-1018 computes them
__device__ __forceinline__ float pixel_x(int col, int W) {
  return col * (float)(2.0 / W) + (float)(1.0 / W - 1.0);
}
__device__ __forceinline__ float pixel_y(int row, int H) {
  return row * (float)(-2.0 / H) + (float)(1.0 - 1.0 / H);
}

// The tile's pixel-edge extent widened by the soft margin, as _overlap_cells
// bins faces into cells (rasterize_v4.py:195-217).
struct TileBounds {
  float x_lo, x_hi, y_lo, y_hi;
};

__device__ __forceinline__ TileBounds tile_bounds(int tile_x, int tile_y, int H, int W) {
  const int c0 = tile_x * TILE, c1 = min(c0 + TILE, W);
  const int r0 = tile_y * TILE, r1 = min(r0 + TILE, H);
  TileBounds t;
  t.x_lo = -1.f + 2.f * c0 / W - SOFT_MARGIN;
  t.x_hi = -1.f + 2.f * c1 / W + SOFT_MARGIN;
  t.y_hi = 1.f - 2.f * r0 / H + SOFT_MARGIN;
  t.y_lo = 1.f - 2.f * r1 / H - SOFT_MARGIN;
  return t;
}

// A face is kept for a tile iff it faces the camera and its bbox, widened by
// the margin, meets the tile.  The test reads the cull table, one float4 a
// face (xmin, xmax, ymin, ymax; a face that faces away holds an empty box,
// magicmirror_torch/ops/face_rows.py::face_cull), not the 26-float row: a
// tile tests every face of the mesh and keeps a few percent, and on a dense
// template (13,776 faces, 54 passes a tile) reading whole rows for that test
// was most of the forward kernel's time.
__device__ __forceinline__ bool face_live(const float4 box, const TileBounds& t) {
  return box.y >= t.x_lo && box.x <= t.x_hi && box.w >= t.y_lo && box.z <= t.y_hi;
}

// Compact the threads whose `live` is set into s_list, in thread order, and
// return their number.  Every thread of the block calls it; s_warp holds
// THREADS / 32 ints.  Ends with a barrier: s_list is readable on return.
__device__ __forceinline__ int compact_live(bool live, int* s_list, int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, live);
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int c = s_warp[w];
    off += (w < warp) ? c : 0;
    total += c;
  }
  if (live) s_list[off + __popc(m & ((1u << lane) - 1u))] = tid;
  __syncthreads();
  return total;
}

}  // namespace mm
