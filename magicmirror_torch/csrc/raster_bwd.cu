// raster_bwd.cu -- soft-silhouette backward of the DIB-R 'line' rasterizer for
// Hopper (sm_90a).
//
// Replaces: magicmirror/ops/pallas/rasterize_v4.py::_bwd_stream_kernel (the
// stream backward, reached through _soft_backward from the custom VJPs of
// rasterize_fused_v5 / rasterize_plain_v4).  The same function is computed by
// rasterize_v4.py::_bwd_kernel (static capacity) and rasterize_v6.py::
// _bwd6_kernel (dense templates, F >= 2048: a tile here culls its own faces
// and has no capacity, so the dense template runs this kernel as it is).
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
// What bounds it on this card: arithmetic, not bytes.  A launch reads the
// rows (133 KB a mesh, L2 resident) and g (4 B a pixel) and writes 52 B a
// face; per (pixel, surviving face) pair it does ~46 flops and an exp.  The
// TPU kernel walked a host-built stream of (cell, 128-face window) items with
// a static capacity and transposed g through the MXU; none of that is
// carried over.  Here a block owns a 16x16 pixel tile of one image and
// leaves at once when g is zero on all of it (interior where soft = 1).  It
// collects the tile's surviving faces with the forward kernel's culling rule
// and scan (raster_common.cuh), and its eight warps share them out, face by
// face (eight, not four: a tile that thousands of faces reach, as on the
// dense template seen from afar, sets the pace of a launch).  A warp holds
// the whole tile, eight pixels a lane (one column, every other row), so a
// face's 13 sums over the tile are one warp's, and the warp loads its next
// face's row while it computes this one.  A lane sums its eight pixels'
// terms in registers, branch-free (the active term of the max chosen by
// selects; the sum of w px as px times the sum of w); the warp then reduces
// the 13 sums (padded to 16) across its lanes by halving exchanges (8 + 4 +
// 2 + 1 + 1 shuffles, each lane keeping the half its lane bit names), and
// lane 2k adds sum k into G with one global atomicAdd where it is nonzero.
// No pixel is walked serially and no shared-memory atomic is taken.  What
// is left is the arithmetic of eight pixels a face a lane and the reduction,
// and the scan.  The
// order of the global sums varies from run to run, so G is reproducible
// only to float rounding.

#include "raster_common.cuh"

namespace {

using namespace mm;

constexpr int NCOEF = 13;
constexpr int NT = 256;     // threads a block: eight warps, each over the whole tile
constexpr int NW = NT / 32;
constexpr int REG = 512;    // survivor ids a warp's region holds
constexpr int PPL = 8;      // pixels a lane: rows (lane >> 4) + 2i of column lane & 15

// the 13 coefficients of coeffs13 in a face row: the edge lines (columns
// 0-8, ZX riding along with A2C) and the bbox (12-15); a row is 8-byte
// aligned
struct Coefs {
  float2 c[7];
};

__device__ __forceinline__ Coefs load_coefs(const float* rb, int f) {
  const float2* r2 = reinterpret_cast<const float2*>(rb + (size_t)f * R);
  Coefs k;
#pragma unroll
  for (int i = 0; i < 5; ++i) k.c[i] = __ldg(r2 + i);
  k.c[5] = __ldg(r2 + 6);
  k.c[6] = __ldg(r2 + 7);
  return k;
}

__device__ __forceinline__ float line_distance(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// at most 64 registers a thread: four blocks an SM
__global__ void __launch_bounds__(NT, 4)
raster_bwd_kernel(const float* __restrict__ rows, const float4* __restrict__ cull,
                  const float* __restrict__ g_sumlog, int F1, int H, int W, float sigmainv,
                  float* __restrict__ G) {
  __shared__ int s_regions[NW * REG];
  __shared__ int s_cnt[2 * NW];

  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * TILE + (lane & 15);
  const float px = pixel_x(col, W);
  const float two_sigma = 2.f * sigmainv;
  float g2[PPL], py[PPL];  // 2 sigma g, and the row's centre
  bool any = false;
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const int row = blockIdx.y * TILE + (lane >> 4) + 2 * i;
    const float g = (col < W && row < H) ? g_sumlog[((size_t)b * H + row) * W + col] : 0.f;
    g2[i] = g * two_sigma;
    py[i] = pixel_y(row, H);
    any |= g != 0.f;
  }
  if (!__syncthreads_or(any)) return;

  const TileBounds tile = tile_bounds(blockIdx.x, blockIdx.y, H, W);
  const float* rb = rows + (size_t)b * F1 * R;
  const float4* cb = cull + (size_t)b * F1;
  float* Gb = G + (size_t)b * (F1 - 1) * NCOEF;  // the sentinel row has no output
  int group = slab_start<NT>(F1), kept = 0;  // this warp's place in the scan
  bool more = true;
  while (more) {
    int cnt[NW];
    const int n = collect_survivors<NT, REG>(cb, F1, tile, group, kept, s_regions, s_cnt, cnt,
                                             more);
    // a warp's faces are j = warp, warp + NW, ...; the next one's row loads
    // while this one is computed
    Coefs next;
    if (warp < n) next = load_coefs(rb, batch_id<NW, REG>(s_regions, cnt, warp));
    for (int j = warp; j < n; j += NW) {
      const int f = batch_id<NW, REG>(s_regions, cnt, j);
      const Coefs cur = next;
      if (j + NW < n) next = load_coefs(rb, batch_id<NW, REG>(s_regions, cnt, j + NW));
      const float2 c01 = cur.c[0], c23 = cur.c[1], c45 = cur.c[2], c67 = cur.c[3];
      const float2 c89 = cur.c[4], bx = cur.c[5], by = cur.c[6];
      // what depends on the column only: the x gap, and which x side is the
      // nearer
      const float ex_lo = bx.x - px, ex_hi = px - bx.y;
      const float dbx = fmaxf(ex_lo, ex_hi);
      // per line the sums of w and w py (the sum of w px is px times the
      // first), the x side's sum and the y sides'
      float s0 = 0.f, y0 = 0.f, s1 = 0.f, y1 = 0.f, sl2 = 0.f, y2 = 0.f;
      float sx = 0.f, ylo = 0.f, yhi = 0.f;
#pragma unroll
      for (int i = 0; i < PPL; ++i) {
        const float pyi = py[i];
        // each product and sum rounded on its own, as the plain version
        // (a * px + b * py + c in torch) rounds them: where an edge line and
        // the bbox tie (the gradient goes to the line), both fall the same way
        const float d0 = line_distance(c01.x, c01.y, c23.x, px, pyi);
        const float d1 = line_distance(c23.y, c45.x, c45.y, px, pyi);
        const float d2 = line_distance(c67.x, c67.y, c89.x, px, pyi);
        const float dl = fmaxf(fmaxf(d0, d1), d2);
        const float ey_lo = by.x - pyi, ey_hi = pyi - by.y;
        const float dby = fmaxf(ey_lo, ey_hi);
        const float m = fmaxf(dbx, dby);
        const float dpos = fmaxf(fmaxf(dl, m), 0.f);
        // the plain version's own exp and argument: on a covered pixel within
        // ~1e-6 of another face's edge, 1 - p is ~1e-7 and turns on the last
        // bit of exp(-e), and the term weighs up to ~2e5 times g
        const float e = dpos * dpos * sigmainv;
        const float ps = P_CLAMP * expf(-e);
        const float gl = (dpos > 0.f && e < E_SKIP)
                             ? g2[i] * dpos * __fdividef(ps, 1.f - ps) : 0.f;
        // the active term of the max, ties as _bwd_stream_kernel resolves
        // them: a line if dl >= dbx and dl >= dby (d0 before d1 before d2),
        // else x if dbx >= dby; on an axis the min side where its gap is the
        // larger or equal
        const bool line = dl >= m;
        const float wl = line ? gl : 0.f, wb = line ? 0.f : gl;
        const float w0 = d0 == dl ? wl : 0.f;
        const float w1 = d0 != dl && d1 == dl ? wl : 0.f;
        const float w2 = wl - w0 - w1;
        s0 += w0;
        y0 += w0 * pyi;
        s1 += w1;
        y1 += w1 * pyi;
        sl2 += w2;
        y2 += w2 * pyi;
        const float wx = dbx >= dby ? wb : 0.f, wy = wb - wx;
        sx += wx;
        const bool lo = ey_lo >= ey_hi;
        ylo += lo ? wy : 0.f;
        yhi += lo ? 0.f : wy;
      }
      if (!__any_sync(FULL, s0 != 0.f || s1 != 0.f || sl2 != 0.f || sx != 0.f ||
                                ylo != 0.f || yhi != 0.f))
        continue;  // warp-uniform
      const bool xlo = ex_lo >= ex_hi;
      float v[16] = {px * s0, y0, s0, px * s1, y1, s1, px * sl2, y2, sl2,
                     xlo ? sx : 0.f, xlo ? 0.f : -sx, ylo, -yhi, 0.f, 0.f, 0.f};
      // halving exchanges: at offset o (16, 8, 4, 2) a lane keeps the half of
      // its sums that its bit o names and adds its partner's copy of it; then
      // lane l holds the warp's sum of coefficient l >> 1
#pragma unroll
      for (int o = 16, h = 8; o >= 2; o >>= 1, h >>= 1) {
        const bool upper = lane & o;
#pragma unroll
        for (int k = 0; k < h; ++k) {
          const float send = upper ? v[k] : v[k + h];
          const float keep = upper ? v[k + h] : v[k];
          v[k] = keep + __shfl_xor_sync(FULL, send, o);
        }
      }
      const float sum = v[0] + __shfl_xor_sync(FULL, v[0], 1);
      const int k = lane >> 1;
      if ((lane & 1) == 0 && k < NCOEF && sum != 0.f)
        atomicAdd(&Gb[(size_t)f * NCOEF + k], sum);
    }
    // the next collection rewrites the regions only past a barrier that
    // every warp reaches when it is done with this batch
  }
}

}  // namespace

extern "C" int raster_bwd(const float* rows, const float* cull, const float* g_sumlog,
                          int B, int F1, int H, int W, float sigmainv, float* G,
                          void* stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  raster_bwd_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      rows, reinterpret_cast<const float4*>(cull), g_sumlog, F1, H, W, sigmainv, G);
  return (int)cudaGetLastError();
}
