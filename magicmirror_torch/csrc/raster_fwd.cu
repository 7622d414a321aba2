// raster_fwd.cu -- DIB-R soft rasterizer forward for Hopper (sm_90a), in the
// 'line' and the 'exact' soft mode, each fused or plain.
//
// Replaces, in 'line' mode: magicmirror/ops/pallas/rasterize_v4.py::
// _fwd_stream_kernel (the v5 stream forward, reached through
// rasterize_fused_v5); rasterize_v6.py::_fwd6_kernel (the same function for
// dense templates, F >= 2048: what made it a separate TPU kernel was the
// static capacity of a cell, which a tile here never had, so the dense
// template runs this kernel as it is); rasterize_v4.py::_fwd_kernel (the
// static-capacity schedule, whose plain variant is this kernel's plain mode).
// Replaces, in 'exact' mode: rasterize_tpu.py::_kernel, _banded_kernel and
// _image_kernel (three schedules of one function, phase 1 = winner id and
// sumlog: the plain instantiation) and rasterize_tpu.py::_image_kernel_fused
// (phase 1 plus the winner's uv and normal: the fused instantiation).  Those
// four TPU kernels also run in 'line' mode, which is this kernel's.
//
// What it computes, per pixel of each image: among the faces in ascending id,
//   d_i = affine edge-line distances (positive outside), dl = max(d0, d1, d2),
//   z   = affine camera z;
//   winner: the face with dl <= 0 and the strictly largest z (lowest id on
//           ties); covered iff best z > -1e29 (degenerate faces carry z=-1e30);
//   sumlog = sum log(1 - (1 - 1e-7) * exp(-sigma * d^2)), with
//     'line':  d = max(dl, d_bbox, 0);
//     'exact': d^2 = 0 where the face covers the pixel, else the least of the
//              squared distances to its three edge segments (t clipped to
//              [0, 1], 1e-12 in the denominator: kaolin's rule,
//              magicmirror/ops/rasterize.py:42-52), from the second table
//              verts (B, F, 6) f32 = ax, ay, bx, by, cx, cy;
//   outputs idx (-1 on background), soft = 1 - exp(sumlog), the winner's
//   affine uv and face normal, and hard = covered.
// The face rows (B, F, 26) f32 come from magicmirror_torch/ops/face_rows.py
// in the JAX column order A0X..FID, UX..NZR (rasterize_v4.py:45-49).
//
// What bounds it on this card: arithmetic, not bytes.  The rows of a mesh
// are F*104 bytes (133 KB for 1280 faces) and stay in L2; each (pixel,
// surviving face) pair costs ~34 fp32 operations and an exp2.  The TPU kernel
// binned faces into cells on the host side of the kernel (XLA sort/one-hot
// gathers) with a static capacity; here a block owns a 16x16 pixel tile and
// first collects the tile's surviving faces, in id order: every face that is
// back-facing or whose bbox +- 0.035 (_SOFT_MARGIN) misses the tile is
// dropped, block-uniformly, by a test of the cull table (16 B a face), each
// warp over its own quarter of the ids with no barrier (raster_common.cuh:
// collect_survivors).  A culled face cannot cover a pixel of the tile, so
// the z-test is exact and no face is ever dropped for capacity (dropped is
// always 0); it lies more than 0.035 plus half a pixel from every pixel
// centre, so its soft term is < 2e-4 at sigma = 7000 (and < 3e-5 at 256^2),
// the TPU kernel's own culling rule.  Ties resolve as in the reference: the
// list is walked in id order with a strict z test.  Then:
//   * 128 threads, two pixels each (rows r and r + 8 of one column), so each
//     row read from shared memory feeds two pixels, two independent chains
//     hide the SFU's latency, and the bbox's x gap is taken once for both;
//   * the survivors' first 16 columns (edge lines, z plane, bbox) are copied
//     into a two-slot ring in shared memory with cp.async, 64 faces a slot:
//     the next slot loads while this one is computed; the winner's uv and
//     normal are read from its row once, after the walk;
//   * soft is a running product of (1 - p) a pixel, its exponent kept aside
//     (renormalised every fourth face, so the product never leaves the
//     normal range: each factor is >= 2^-23), with p = (1 - 1e-7) *
//     exp2(-sigma log2(e) d^2); the fused mode stores 1 - prod * 2^exp, the
//     plain mode log(prod) + exp * ln 2: one log a pixel, none per pair.
// What is left is the walk's arithmetic and the scan: at b32 the cull test
// alone (every face culled) takes a large share of a launch, the larger at
// 256^2, where 8,192 tiles each test all 1,281 faces.
// Per face, the term is skipped where sigma*d^2 >= 88, where p is below
// 1e-38 and does not change the float sum.

#include "raster_common.cuh"

namespace {

using namespace mm;

constexpr float Z_INIT = -3.0e38f;
constexpr float Z_FLOOR = -1.0e29f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int NT = 128;    // threads a block, two pixels each
constexpr int NW = NT / 32;
constexpr int REG = 1024;  // survivor ids a warp's region holds
constexpr int SB = 64;     // faces a stage of the row ring
constexpr int RS = 16;     // floats staged a face: A0X..BYMAX
constexpr int NV = 6;      // floats per face of the vertex table
constexpr int VS = 8;      // floats staged a face of it

// squared distance from (px, py) to the segment q -> r
__device__ __forceinline__ float segment_d2(float px, float py, float qx, float qy,
                                            float rx, float ry) {
  const float ex = rx - qx, ey = ry - qy;
  const float ax = px - qx, ay = py - qy;
  float t = (ax * ex + ay * ey) / (ex * ex + ey * ey + 1e-12f);
  t = fminf(fmaxf(t, 0.f), 1.f);
  const float dx = ax - t * ex, dy = ay - t * ey;
  return dx * dx + dy * dy;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// move the exponent of the positive normal `p` into `e`: p * 2^e is kept,
// p returns to [1, 2)
__device__ __forceinline__ void renorm(float& p, int& e) {
  const int bits = __float_as_int(p);
  e += (bits >> 23) - 127;
  p = __int_as_float((bits & 0x007fffff) | 0x3f800000);
}

// Copy stage `s` of the batch (SB faces) into ring slot s & 1: each face's
// id, and in 8-byte pieces (a row starts 104 B after the last: 8-byte
// aligned) the 16 first columns of its row and in 'exact' mode its 6 vertex
// floats.
template <bool EXACT>
__device__ __forceinline__ void stage_rows(int s, int n, const int* s_regions,
                                           const int (&cnt)[NW], const float* rb,
                                           const float* vb, float* s_rows, float* s_verts,
                                           int* s_ring_ids) {
  const int k0 = s * SB, kn = min(SB, n - k0), slot = s & 1;
  for (int k = threadIdx.x; k < kn; k += NT) {
    const int f = batch_id<NW, REG>(s_regions, cnt, k0 + k);
    s_ring_ids[slot * SB + k] = f;
    float* dst = s_rows + (slot * SB + k) * RS;
#pragma unroll
    for (int q = 0; q < RS / 2; ++q) cp_async8(dst + 2 * q, rb + (size_t)f * R + 2 * q);
    if (EXACT) {
      float* vdst = s_verts + (slot * SB + k) * VS;
#pragma unroll
      for (int q = 0; q < NV / 2; ++q) cp_async8(vdst + 2 * q, vb + (size_t)f * NV + 2 * q);
    }
  }
}

// The bbox's x gap depends on the column only, shared by a thread's two
// pixels.  (The edge lines and z are evaluated whole at each pixel, in the
// form a * px + b * py + c: split into a column part and a py part they
// round differently at a pixel centre on an edge, and coverage there would
// part from the plain version's.)
// One (pixel, face) pair: the z test and the soft factor.
template <bool EXACT>
__device__ __forceinline__ void pixel_face(float px, float py, float dbx, const float4 a,
                                           const float4 b, const float4 c, const float4 d,
                                           const float* q, int f, float s2, float& best_z,
                                           int& best_f, float& prod) {
  // a = A0X A0Y A0C A1X, b = A1Y A1C A2X A2Y, c = A2C ZX ZY ZC, d = the bbox
  const float d0 = a.x * px + a.y * py + a.z;
  const float d1 = a.w * px + b.x * py + b.y;
  const float d2 = b.z * px + b.w * py + c.x;
  const float dl = fmaxf(fmaxf(d0, d1), d2);
  const float z = c.y * px + c.z * py + c.w;
  const bool win = dl <= 0.f && z > best_z;  // the list is in id order
  best_z = win ? z : best_z;
  best_f = win ? f : best_f;
  float e;
  if (EXACT) {
    const float dd = fminf(fminf(segment_d2(px, py, q[0], q[1], q[2], q[3]),
                                 segment_d2(px, py, q[2], q[3], q[4], q[5])),
                           segment_d2(px, py, q[4], q[5], q[0], q[1]));
    // a degenerate face (z = -1e30) covers nothing and keeps its distance
    e = (dl <= 0.f && z > Z_FLOOR) ? 0.f : dd * s2;
  } else {
    const float dby = fmaxf(d.z - py, py - d.w);
    const float dpos = fmaxf(fmaxf(dl, fmaxf(dbx, dby)), 0.f);
    e = dpos * dpos * s2;
  }
  prod *= e < E2_SKIP ? fmaf(-P_CLAMP, exp2f(-e), 1.f) : 1.f;
}

// FUSED: the winner's uv and normal, soft = 1 - exp(sumlog) and hard are
// stored; else (the plain mode) only idx and, in `soft`, sumlog itself.
// EXACT: the segment distance from `verts`; else the line distance.
template <bool FUSED, bool EXACT>
__global__ void __launch_bounds__(NT)
raster_fwd_kernel(const float* __restrict__ rows, const float4* __restrict__ cull,
                  const float* __restrict__ verts, int F, int H, int W,
                  float sigmainv, int* __restrict__ idx,
                  float* __restrict__ soft, float* __restrict__ uv,
                  float* __restrict__ normal, float* __restrict__ hard) {
  __shared__ int s_regions[NW * REG];
  __shared__ int s_cnt[2 * NW];
  __shared__ int s_ring_ids[2 * SB];
  __shared__ __align__(16) float s_rows[2 * SB * RS];
  __shared__ __align__(16) float s_verts[EXACT ? 2 * SB * VS : 4];

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int col = blockIdx.x * TILE + tid % TILE;
  const int row0 = blockIdx.y * TILE + tid / TILE;
  const int row1 = row0 + TILE / 2;
  const float px = pixel_x(col, W);
  const float py0 = pixel_y(row0, H), py1 = pixel_y(row1, H);
  const TileBounds tile = tile_bounds(blockIdx.x, blockIdx.y, H, W);
  const float s2 = sigmainv * LOG2E;

  float best_z0 = Z_INIT, best_z1 = Z_INIT, prod0 = 1.f, prod1 = 1.f;
  int best_f0 = -1, best_f1 = -1, ex0 = 0, ex1 = 0;
  const float* rb = rows + (size_t)b * F * R;
  const float4* cb = cull + (size_t)b * F;
  const float* vb = EXACT ? verts + (size_t)b * F * NV : nullptr;

  int group = slab_start<NT>(F), kept = 0;  // this warp's place in the scan
  bool more = true;
  while (more) {
    int cnt[NW];
    const int n = collect_survivors<NT, REG>(cb, F, tile, group, kept, s_regions, s_cnt, cnt,
                                             more);
    const int stages = (n + SB - 1) / SB;
    if (stages > 0)
      stage_rows<EXACT>(0, n, s_regions, cnt, rb, vb, s_rows, s_verts, s_ring_ids);
    cp_async_commit();
    for (int s = 0; s < stages; ++s) {
      if (s + 1 < stages)
        stage_rows<EXACT>(s + 1, n, s_regions, cnt, rb, vb, s_rows, s_verts, s_ring_ids);
      cp_async_commit();  // an empty group when nothing is left to copy
      cp_async_wait_one();
      __syncthreads();    // stage s has landed, from every thread's copies
      const float* sr = s_rows + (s & 1) * SB * RS;
      const float* sv = s_verts + (s & 1) * SB * VS;
      const int* si = s_ring_ids + (s & 1) * SB;
      const int kn = min(SB, n - s * SB);
      for (int k = 0; k < kn; ++k) {
        const float4* r4 = reinterpret_cast<const float4*>(sr + k * RS);
        const float4 a = r4[0], bb = r4[1], c = r4[2], d = r4[3];
        const int f = si[k];
        const float* q = sv + k * VS;
        const float dbx = fmaxf(d.x - px, px - d.y);
        pixel_face<EXACT>(px, py0, dbx, a, bb, c, d, q, f, s2, best_z0, best_f0, prod0);
        pixel_face<EXACT>(px, py1, dbx, a, bb, c, d, q, f, s2, best_z1, best_f1, prod1);
        if ((k & 3) == 3) {
          renorm(prod0, ex0);
          renorm(prod1, ex1);
        }
      }
      renorm(prod0, ex0);
      renorm(prod1, ex1);
      __syncthreads();  // slot s & 1 is refilled by stage s + 2
    }
  }

  if (col >= W) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? row1 : row0;
    if (row >= H) continue;
    const float py = i ? py1 : py0;
    const float best_z = i ? best_z1 : best_z0;
    const int best_f = i ? best_f1 : best_f0;
    const float prod = i ? prod1 : prod0;
    const int ex = i ? ex1 : ex0;
    const size_t p = ((size_t)b * H + row) * W + col;
    const bool covered = best_z > Z_FLOOR;
    idx[p] = covered ? best_f : -1;
    if (!FUSED) {
      soft[p] = logf(prod) + (float)ex * LN2;  // sumlog
      continue;
    }
    soft[p] = 1.f - ldexpf(prod, ex);  // 1 - exp(sumlog)
    hard[p] = covered ? 1.f : 0.f;
    float bu = 0.f, bv = 0.f, bnx = 0.f, bny = 0.f, bnz = 0.f;
    if (covered) {
      const float* r = rb + (size_t)best_f * R;
      bu = r[UX] * px + r[UY] * py + r[UC];
      bv = r[VX] * px + r[VY] * py + r[VC];
      bnx = r[NXR];
      bny = r[NYR];
      bnz = r[NZR];
    }
    uv[2 * p + 0] = bu;
    uv[2 * p + 1] = bv;
    normal[3 * p + 0] = bnx;
    normal[3 * p + 1] = bny;
    normal[3 * p + 2] = bnz;
  }
}

template <bool FUSED, bool EXACT>
int launch(const float* rows, const float* cull, const float* verts, int B, int F, int H,
           int W,
           float sigmainv, int* idx, float* soft, float* uv, float* normal,
           float* hard, void* stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  raster_fwd_kernel<FUSED, EXACT><<<grid, NT, 0, (cudaStream_t)stream>>>(
      rows, reinterpret_cast<const float4*>(cull), verts, F, H, W, sigmainv, idx, soft, uv,
      normal, hard);
  return (int)cudaGetLastError();
}

}  // namespace

// rows (B, F, 26), F counting the sentinel row; cull (B, F, 4), 16-byte
// aligned; verts (B, F, 6) in 'exact' mode, unused (may be null) in 'line'
// mode.
extern "C" int raster_fwd(const float* rows, const float* cull, const float* verts,
                          int exact, int B, int F, int H, int W, float sigmainv, int* idx,
                          float* soft, float* uv, float* normal, float* hard, void* stream) {
  return exact ? launch<true, true>(rows, cull, verts, B, F, H, W, sigmainv, idx, soft, uv,
                                    normal, hard, stream)
               : launch<true, false>(rows, cull, nullptr, B, F, H, W, sigmainv, idx, soft,
                                     uv, normal, hard, stream);
}

// The plain mode: idx and sumlog only (rasterize_v4.py::_fwd_kernel with
// fused=False, reached through rasterize_plain_v4; in 'exact' mode the three
// phase-1 kernels of rasterize_tpu.py, reached through
// rasterize_phase1_pallas).
extern "C" int raster_fwd_plain(const float* rows, const float* cull, const float* verts,
                                int exact, int B, int F, int H, int W, float sigmainv,
                                int* idx, float* sumlog, void* stream) {
  return exact ? launch<false, true>(rows, cull, verts, B, F, H, W, sigmainv, idx, sumlog,
                                     nullptr, nullptr, nullptr, stream)
               : launch<false, false>(rows, cull, nullptr, B, F, H, W, sigmainv, idx, sumlog,
                                      nullptr, nullptr, nullptr, stream);
}
