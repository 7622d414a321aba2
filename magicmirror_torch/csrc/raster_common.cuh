// raster_common.cuh -- what the rasterizer's forward and backward kernels
// share: the face-row layout, the 16x16 pixel tile, and the block-uniform
// face culling that builds a tile's list of surviving faces.  Both kernels
// include this header, so the set of (tile, face) pairs the backward
// differentiates is exactly the set the forward summed.
#pragma once

#include <cuda_runtime.h>

namespace mm {

constexpr int TILE = 16;
constexpr int R = 26;       // floats per face row
constexpr float SOFT_MARGIN = 0.035f;
constexpr float P_CLAMP = 1.0f - 1e-7f;
// where sigma * d^2 >= 88 the soft term is below 1e-38 and changes no float sum
constexpr float E_SKIP = 88.0f;
// exp(-e) is taken as exp2(-e * log2(e)): sigma is scaled once, and the skip
// threshold with it
constexpr float LOG2E = 1.4426950408889634f;
constexpr float E2_SKIP = E_SKIP * LOG2E;
constexpr unsigned FULL = 0xffffffffu;

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
// template (13,776 faces) reading whole rows for that test was most of the
// forward kernel's time.
__device__ __forceinline__ bool face_live(const float4 box, const TileBounds& t) {
  return box.y >= t.x_lo && box.x <= t.x_hi && box.w >= t.y_lo && box.z <= t.y_hi;
}

// Collect the next batch of the tile's surviving faces, in id order.  Warp w
// of NT / 32 walks the faces of its own slab (the w-th contiguous share of
// the ids) 32 at a time, one ballot a step and four steps' cull boxes
// loaded at once, with no barrier, into its own region of s_regions (REG
// ids), until the region would overflow or the slab runs out.  `group` is
// the warp's cursor (in 32-face steps; it starts at slab_start), and `kept`
// the ids its region still holds for a later batch; both persist from
// batch to batch.  Then one barrier: the batch is the regions of the warps
// up to and including the first that has faces left in its slab, one after
// the other, so it is a prefix of the tile's survivors in id order; the
// warps after that one keep their regions for a later batch and do not
// scan again until those are taken (on sphere.obj no region overflows: one
// batch).  Returns the batch's size; batch_id finds its k-th id from the
// counts in `cnt`; `more` (block-uniform) says whether another batch
// follows.  Every thread of the block calls it; it begins with a barrier,
// so the regions the last batch took are free, and s_cnt holds 2 * NT / 32
// ints.
template <int NT>
__device__ __forceinline__ int slab_start(int F) {
  return (threadIdx.x >> 5) * ((F + NT - 1) / NT);
}

template <int NT, int REG>
__device__ __forceinline__ int collect_survivors(const float4* __restrict__ cb, int F,
                                                 const TileBounds& t, int& group, int& kept,
                                                 int* s_regions, int* s_cnt,
                                                 int (&cnt)[NT / 32], bool& more) {
  constexpr int NW = NT / 32, DEPTH = 4;
  static_assert(REG >= DEPTH * 32, "a warp's region holds a whole step");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const float4 none = make_float4(1.f, -1.f, 1.f, -1.f);  // an empty box
  const int end = min((warp + 1) * ((F + NT - 1) / NT) * 32, F);
  int* region = s_regions + warp * REG;
  int c = kept;
  __syncthreads();
  while (kept == 0 && group * 32 < end && c + DEPTH * 32 <= REG) {
    float4 box[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const int f = (group + u) * 32 + lane;
      box[u] = f < end ? cb[f] : none;
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const int f = (group + u) * 32 + lane;
      const bool live = f < end && face_live(box[u], t);
      const unsigned m = __ballot_sync(FULL, live);
      if (live) region[c + __popc(m & below)] = f;
      c += __popc(m);
    }
    group += DEPTH;
  }
  if (lane == 0) {
    s_cnt[warp] = c;
    s_cnt[NW + warp] = group * 32 < end;
  }
  __syncthreads();
  int n = 0;
  bool cut = false;  // an earlier warp has faces left: the later ones wait
  more = false;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    cnt[w] = cut ? 0 : s_cnt[w];
    n += cnt[w];
    if (w == warp) kept = cut ? s_cnt[w] : 0;
    more |= cut || s_cnt[NW + w] != 0;
    cut |= s_cnt[NW + w] != 0;
  }
  return n;
}

// The k-th id of a batch that collect_survivors returned with counts cnt.
template <int NW, int REG>
__device__ __forceinline__ int batch_id(const int* s_regions, const int (&cnt)[NW], int k) {
  int w = 0;
#pragma unroll
  for (int v = 0; v < NW - 1; ++v) {
    const bool past = w == v && k >= cnt[v];
    k -= past ? cnt[v] : 0;
    w += past ? 1 : 0;
  }
  return s_regions[w * REG + k];
}

}  // namespace mm
