// raster_fwd.cu -- DIB-R 'line' soft rasterizer forward for Hopper (sm_90a).
//
// Replaces: magicmirror/ops/pallas/rasterize_v4.py::_fwd_stream_kernel (the
// v5 stream forward, reached through rasterize_fused_v5).  The same function
// is computed by rasterize_v6.py::_fwd6_kernel (dense templates),
// rasterize_v4.py::_fwd_kernel (the static-capacity schedule, whose plain
// variant is this kernel's plain mode) and the phase-1 half of
// rasterize_tpu.py::_image_kernel_fused; this kernel covers their 'line' mode.
//
// What it computes, per pixel of each image: among the faces in ascending id,
//   d_i = affine edge-line distances (positive outside), dl = max(d0, d1, d2),
//   z   = affine camera z;
//   winner: the face with dl <= 0 and the strictly largest z (lowest id on
//           ties); covered iff best z > -1e29 (degenerate faces carry z=-1e30);
//   sumlog = sum log(1 - (1 - 1e-7) * exp(-sigma * max(dl, d_bbox, 0)^2));
//   outputs idx (-1 on background), soft = 1 - exp(sumlog), the winner's
//   affine uv and face normal, and hard = covered.
// The face rows (B, F, 26) f32 come from magicmirror_torch/ops/face_rows.py
// in the JAX column order A0X..FID, UX..NZR (rasterize_v4.py:45-49).
//
// What bounds it on this card: arithmetic, not bytes.  The rows of a mesh
// are F*104 bytes (133 KB for 1280 faces) and stay in L2; each pixel does
// ~40 FMA/select per face it sees plus an exp and a log1p for faces near it.
// The TPU kernel binned faces into cells on the host side of the kernel (XLA
// sort/one-hot gathers) with a static capacity; here a block owns a 16x16
// pixel tile, stages the faces through shared memory 256 at a time, and
// drops, block-uniformly, every face that is back-facing or whose bbox
// +- 0.035 (_SOFT_MARGIN) misses the tile.  A culled face cannot cover a
// pixel of the tile, so the z-test is exact and no face is ever dropped for
// capacity (dropped is always 0); it lies more than 0.035 plus half a pixel
// from every pixel centre, so its soft term is < 2e-4 at sigma = 7000 (and
// < 3e-5 at 256^2), the TPU kernel's own culling rule.  The survivors are
// compacted in id order (warp ballots), so ties resolve as in the reference.
// The culling and the compaction live in raster_common.cuh, shared with the
// backward kernel.
// Per face, the exp/log1p pair is skipped where sigma*d^2 >= 88, where p is
// below 1e-38 and the term does not change the float sum.

#include "raster_common.cuh"

namespace {

using namespace mm;

constexpr float Z_INIT = -3.0e38f;
constexpr float Z_FLOOR = -1.0e29f;

// FUSED: the winner's uv and normal, soft = 1 - exp(sumlog) and hard are
// stored; else (the plain mode) only idx and, in `soft`, sumlog itself.
template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
raster_fwd_kernel(const float* __restrict__ rows, int F, int H, int W,
                  float sigmainv, int* __restrict__ idx,
                  float* __restrict__ soft, float* __restrict__ uv,
                  float* __restrict__ normal, float* __restrict__ hard) {
  __shared__ float s_rows[CHUNK * R];
  __shared__ int s_list[CHUNK];
  __shared__ int s_warp[THREADS / 32];

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int col = blockIdx.x * TILE + tid % TILE;
  const int row = blockIdx.y * TILE + tid / TILE;
  const float px = pixel_x(col, W);
  const float py = pixel_y(row, H);
  const TileBounds tile = tile_bounds(blockIdx.x, blockIdx.y, H, W);

  float best_z = Z_INIT, sumlog = 0.f;
  int best_f = -1;
  float bu = 0.f, bv = 0.f, bnx = 0.f, bny = 0.f, bnz = 0.f;
  const float* rb = rows + (size_t)b * F * R;

  for (int base = 0; base < F; base += CHUNK) {
    const int n = min(CHUNK, F - base);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < n * R; i += THREADS) s_rows[i] = rb[(size_t)base * R + i];
    __syncthreads();

    const bool live = tid < n && face_live(s_rows + tid * R, tile);
    const int total = compact_live(live, s_list, s_warp);

    for (int k = 0; k < total; ++k) {
      const int j = s_list[k];
      const float* r = s_rows + j * R;
      const float d0 = r[A0X] * px + r[A0Y] * py + r[A0C];
      const float d1 = r[A1X] * px + r[A1Y] * py + r[A1C];
      const float d2 = r[A2X] * px + r[A2Y] * py + r[A2C];
      const float dl = fmaxf(fmaxf(d0, d1), d2);
      const float z = r[ZX] * px + r[ZY] * py + r[ZC];
      if (dl <= 0.f && z > best_z) {
        best_z = z;
        best_f = base + j;
        if (FUSED) {
          bu = r[UX] * px + r[UY] * py + r[UC];
          bv = r[VX] * px + r[VY] * py + r[VC];
          bnx = r[NXR];
          bny = r[NYR];
          bnz = r[NZR];
        }
      }
      const float dbx = fmaxf(r[BXMIN] - px, px - r[BXMAX]);
      const float dby = fmaxf(r[BYMIN] - py, py - r[BYMAX]);
      const float dpos = fmaxf(fmaxf(dl, fmaxf(dbx, dby)), 0.f);
      const float e = dpos * dpos * sigmainv;
      if (e < E_SKIP) sumlog += log1pf(-P_CLAMP * expf(-e));
    }
  }

  if (col < W && row < H) {
    const size_t p = ((size_t)b * H + row) * W + col;
    const bool covered = best_z > Z_FLOOR;
    idx[p] = covered ? best_f : -1;
    if (!FUSED) {
      soft[p] = sumlog;
      return;
    }
    soft[p] = 1.f - expf(sumlog);
    hard[p] = covered ? 1.f : 0.f;
    uv[2 * p + 0] = covered ? bu : 0.f;
    uv[2 * p + 1] = covered ? bv : 0.f;
    normal[3 * p + 0] = covered ? bnx : 0.f;
    normal[3 * p + 1] = covered ? bny : 0.f;
    normal[3 * p + 2] = covered ? bnz : 0.f;
  }
}

}  // namespace

extern "C" int raster_fwd(const float* rows, int B, int F, int H, int W,
                          float sigmainv, int* idx, float* soft, float* uv,
                          float* normal, float* hard, void* stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  raster_fwd_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      rows, F, H, W, sigmainv, idx, soft, uv, normal, hard);
  return (int)cudaGetLastError();
}

// The plain mode: idx and sumlog only (rasterize_v4.py::_fwd_kernel with
// fused=False, reached through rasterize_plain_v4).
extern "C" int raster_fwd_plain(const float* rows, int B, int F, int H, int W,
                                float sigmainv, int* idx, float* sumlog, void* stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  raster_fwd_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      rows, F, H, W, sigmainv, idx, sumlog, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}
