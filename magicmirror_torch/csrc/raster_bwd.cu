// raster_bwd.cu -- soft-silhouette backward of the DIB-R 'line' rasterizer for
// Hopper (sm_90a).
//
// Replaces: magicmirror/ops/pallas/rasterize_v4.py::_bwd_stream_kernel (the
// stream backward, reached through _soft_backward from the custom VJPs of
// rasterize_fused_v5 / rasterize_plain_v4).  The same function is computed by
// rasterize_v4.py::_bwd_kernel (static capacity) and rasterize_v6.py::
// _bwd6_kernel (dense templates).
//
// What it computes: with g[p] the cotangent of sumlog at pixel p, for each
// front-facing face f and each pixel p near it,
//   d0, d1, d2 = the affine edge-line distances, dl = max(d0, d1, d2),
//   dbx = max(xmin - px, px - xmax), dby likewise,
//   dpos = max(dl, dbx, dby, 0),  ps = (1 - 1e-7) * exp(-sigma * dpos^2),
//   gl = g[p] * 2 * sigma * dpos * ps / (1 - ps),
// and gl goes to the one term that is active in the max (ties: a line if
// dl >= dbx and dl >= dby, d0 before d1 before d2; else x if dbx >= dby; the
// min side with sign + if xmin - px >= px - xmax, else the max side with sign
// -).  The 13 outputs per face are sum(w_i * px), sum(w_i * py), sum(w_i) for
// the three lines and sum(w) for xmin, xmax, ymin, ymax: the cotangents of
// the 13 coefficients of face_rows.coeffs13, whose autograd carries them on
// to the vertices.  A pixel inside a face has dpos = 0 and adds nothing.
// G (B, F, 13) f32 must be zero on entry; rows are K1's (B, F + 1, 26).
//
// What bounds it on this card: arithmetic and the atomics, not bytes.  A
// launch reads the rows (133 KB a mesh, L2 resident) and g (4 B a pixel) and
// writes 52 B a face; per (pixel, surviving face) pair it does ~45 flops and
// an exp.  The TPU kernel walked a host-built stream of (cell, 128-face
// window) items with a static capacity and transposed g through the MXU;
// none of that is carried over.  Here a block owns a 16x16 pixel tile of one
// image, stages the tile's g in shared memory and leaves at once when all of
// it is zero (background far from the silhouette, or interior where
// soft = 1).  Faces are culled block-uniformly with the forward kernel's own
// rule (raster_common.cuh).  The survivors of a 256-face pass are split into
// (face, 32-pixel slice) items over the block's threads; each item keeps its
// 13 sums in registers and adds them into a shared-memory accumulator, and
// the block ends the pass with one global atomicAdd per nonzero
// (face, coefficient).  The order of the atomic sums varies from run to run,
// so G is reproducible only to float rounding.

#include "raster_common.cuh"

namespace {

using namespace mm;

constexpr int NCOEF = 13;
constexpr int SLICES = THREADS / 32;  // 32-pixel slices of a tile

// row column of coefficient k of coeffs13: A0X..A2C, then the bbox
__device__ __forceinline__ int coef_col(int k) { return k < 9 ? k : k + 3; }

__global__ void __launch_bounds__(THREADS)
raster_bwd_kernel(const float* __restrict__ rows, const float* __restrict__ g_sumlog,
                  int F1, int H, int W, float sigmainv, float* __restrict__ G) {
  __shared__ float s_g[THREADS];
  __shared__ float s_px[THREADS];
  __shared__ float s_py[THREADS];
  __shared__ float s_coef[CHUNK * NCOEF];
  __shared__ float s_acc[CHUNK * NCOEF];
  __shared__ int s_list[CHUNK];
  __shared__ int s_warp[THREADS / 32];

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int col = blockIdx.x * TILE + tid % TILE;
  const int row = blockIdx.y * TILE + tid / TILE;
  const bool in_image = col < W && row < H;
  const float g = in_image ? g_sumlog[((size_t)b * H + row) * W + col] : 0.f;
  s_g[tid] = g;
  s_px[tid] = pixel_x(col, W);
  s_py[tid] = pixel_y(row, H);
  if (!__syncthreads_or(g != 0.f)) return;

  const TileBounds tile = tile_bounds(blockIdx.x, blockIdx.y, H, W);
  const float* rb = rows + (size_t)b * F1 * R;
  float* Gb = G + (size_t)b * (F1 - 1) * NCOEF;  // the sentinel row has no output
  const float two_sigma = 2.f * sigmainv;

  for (int base = 0; base < F1; base += CHUNK) {
    const int n = min(CHUNK, F1 - base);
    const bool live = tid < n && face_live(rb + (size_t)(base + tid) * R, tile);
    const int total = compact_live(live, s_list, s_warp);
    for (int i = tid; i < total * NCOEF; i += THREADS) {
      const int k = i % NCOEF;
      s_coef[i] = rb[(size_t)(base + s_list[i / NCOEF]) * R + coef_col(k)];
      s_acc[i] = 0.f;
    }
    __syncthreads();

    for (int item = tid; item < total * SLICES; item += THREADS) {
      const int j = item / SLICES;
      const int slice = item % SLICES;
      const float* c = s_coef + j * NCOEF;
      const float a0x = c[0], a0y = c[1], a0c = c[2];
      const float a1x = c[3], a1y = c[4], a1c = c[5];
      const float a2x = c[6], a2y = c[7], a2c = c[8];
      const float xmin = c[9], xmax = c[10], ymin = c[11], ymax = c[12];
      float acc[NCOEF];
#pragma unroll
      for (int k = 0; k < NCOEF; ++k) acc[k] = 0.f;
      bool any = false;
      for (int q = 0; q < 32; ++q) {
        // the slices of a warp start 4 pixels apart: distinct shared-memory banks
        const int p = slice * 32 + ((q + 4 * slice) & 31);
        const float gp = s_g[p];
        if (gp == 0.f) continue;
        const float px = s_px[p], py = s_py[p];
        const float d0 = a0x * px + a0y * py + a0c;
        const float d1 = a1x * px + a1y * py + a1c;
        const float d2 = a2x * px + a2y * py + a2c;
        const float dl = fmaxf(fmaxf(d0, d1), d2);
        const float ex_lo = xmin - px, ex_hi = px - xmax;
        const float ey_lo = ymin - py, ey_hi = py - ymax;
        const float dbx = fmaxf(ex_lo, ex_hi);
        const float dby = fmaxf(ey_lo, ey_hi);
        const float dpos = fmaxf(fmaxf(dl, fmaxf(dbx, dby)), 0.f);
        const float e = dpos * dpos * sigmainv;
        if (dpos <= 0.f || e >= E_SKIP) continue;
        const float ps = P_CLAMP * expf(-e);
        const float gl = gp * two_sigma * dpos * (ps / (1.f - ps));
        any = true;
        if (dl >= dbx && dl >= dby) {
          const int i = (d0 >= d1 && d0 >= d2) ? 0 : (d1 >= d2 ? 1 : 2);
          // a runtime index would put acc into local memory: select instead
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float w = (i == k) ? gl : 0.f;
            acc[3 * k + 0] += w * px;
            acc[3 * k + 1] += w * py;
            acc[3 * k + 2] += w;
          }
        } else if (dbx >= dby) {
          if (ex_lo >= ex_hi) acc[9] += gl; else acc[10] -= gl;
        } else {
          if (ey_lo >= ey_hi) acc[11] += gl; else acc[12] -= gl;
        }
      }
      if (any) {
#pragma unroll
        for (int k = 0; k < NCOEF; ++k)
          if (acc[k] != 0.f) atomicAdd(&s_acc[j * NCOEF + k], acc[k]);
      }
    }
    __syncthreads();

    for (int i = tid; i < total * NCOEF; i += THREADS) {
      const float v = s_acc[i];
      if (v != 0.f)
        atomicAdd(&Gb[(size_t)(base + s_list[i / NCOEF]) * NCOEF + i % NCOEF], v);
    }
    __syncthreads();  // s_list, s_coef and s_acc are rewritten by the next pass
  }
}

}  // namespace

extern "C" int raster_bwd(const float* rows, const float* g_sumlog, int B, int F1,
                          int H, int W, float sigmainv, float* G, void* stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  raster_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      rows, g_sumlog, F1, H, W, sigmainv, G);
  return (int)cudaGetLastError();
}
