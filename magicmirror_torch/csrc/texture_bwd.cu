// texture_bwd.cu -- backward of the bilinear UV texture sampling for Hopper
// (sm_90a), masked or unmasked.
//
// Replaces: magicmirror/ops/pallas/texture_cells.py::_tex_bwd_kernel (the
// streamed VJP of texture_render) together with the uv -> texel chain rule
// that the JAX package takes through _prep_cells / _uv_to_texels.  With a
// null mask pointer (every pixel sampled) it is the backward of the unmasked
// sampler texture_tpu.py::_kernel, which the JAX package leaves to autodiff
// of its gather path (ops/sampling.py:283-288).
//
// What it computes, per pixel with cotangent g (3 channels): nothing where
// mask <= 0.5 (d_uv = 0); elsewhere, with the forward kernel's arithmetic
// (u, v clipped to [0, 1], x = u*Wt - 0.5, y = (1 - v)*Ht - 0.5, the four
// taps (y0, x0) .. (y0+1, x0+1) with weights (1-wx)(1-wy) .. wx*wy, zeros
// padding):
//   d_tex[tap, c] += w_tap * g[c]           (taps outside the texture skipped)
//   d_x = sum_c g[c] * ((t01 - t00)(1 - wy) + (t11 - t10) wy)
//   d_y = sum_c g[c] * ((t10 - t00)(1 - wx) + (t11 - t01) wx)
//   d_u = d_x * Wt * clip'(u),  d_v = -d_y * Ht * clip'(v),
// where clip' is 1 inside (0, 1), 0 outside and 1/2 at exactly 0 or 1, the
// gradient of jnp.clip (a min of a max, each splitting a tie evenly).  A
// pixel whose cotangent is zero adds nothing.  Every element of d_tex
// (B, Ht, Wt, 3) f32 and d_uv (B, H, W, 2) f32 is written: neither needs
// zeroing first.  The mask gets no gradient.
//
// What bounds it on this card: the bytes, and the adds.  d_tex is 12.6 MB at
// b32 with a 256x128 texture and is written whole, mostly zeros (a view sees
// half the texture at most); per covered pixel it reads 4 B of mask, 8 B of
// uv, 12 B of g and 4 taps x 12 B of texture (from the L2: neighbouring
// pixels share texels), writes 8 B of d_uv and adds 12 products into d_tex.
// The TPU kernel scattered through bf16 tent-weight matmuls over a host-built
// chunk stream.
//
// The design: a cluster of CLUSTER = 8 blocks owns one image (fewer blocks
// an image were slower; PERF.md gives the times).  Each block first zeroes a
// band of ceil(Ht / 8) rows of the image's d_tex in 16 B stores; a cluster
// barrier (release / acquire at cluster scope) orders those stores before
// any add of the cluster; then the blocks share the image's pixels, write
// their d_uv, and add each pixel's products into d_tex with Hopper's vector
// reductions (red.global.add.v4.f32 and .v2.f32, resolved in the L2): the
// two taps of a tap row are six consecutive floats, which two or three
// aligned vector adds cover (padded with +0.0 inside the image's own,
// zeroed, rows), in place of twelve scalar atomics a pixel.  So there is no
// memset launch, and a third of the adds.  The adds come in no fixed order:
// d_tex is reproducible to float rounding, not bit for bit.
//
// Tried and left (PERF.md gives the times): summing each image's d_tex in
// shared memory across the cluster (distributed shared memory) and writing
// it once was several times slower than the one-thread-per-pixel scatter it
// was to replace: on sm_90 a float add to shared memory compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN; ATOM.E.CAST.SPIN across the
// cluster), while a float add to global memory is one reduction in the L2.
// A warp-wide sum by shuffles where all 32 lanes tap the same texels did not
// pay on the render's cotangents, which are zero off the mask.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int CLUSTER = 8;  // the blocks an image: the portable cluster size

__device__ __forceinline__ float clip_grad(float t) {
  return (t > 0.f && t < 1.f) ? 1.f : ((t == 0.f || t == 1.f) ? 0.5f : 0.f);
}

__device__ __forceinline__ void red1(float* a, float x) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(a), "f"(x) : "memory");
}
__device__ __forceinline__ void red2(float* a, float x, float y) {  // a: 8 B aligned
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(a), "f"(x), "f"(y) : "memory");
}
__device__ __forceinline__ void red4(float* a, float x, float y, float z, float w) {  // 16 B
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(a), "f"(x), "f"(y),
               "f"(z), "f"(w)
               : "memory");
}

// Add a (3 floats) at element o and b at o + 3 of d_tex, where o is the
// first channel of a tap (y, x0) and o + 3 of (y, x0 + 1); has_a / has_b:
// whether each tap is inside the texture.  [lo, hi): the image's elements,
// where padding with +0.0 is allowed (they were zeroed, and are added to
// only by this cluster).
__device__ __forceinline__ void add_row(float* d_tex, long long o, long long lo, long long hi,
                                        bool has_a, bool has_b, float a0, float a1, float a2,
                                        float b0, float b1, float b2) {
  if (has_a && has_b && o >= lo + 1 && o + 7 <= hi) {
    float* p = d_tex + o;
    switch ((int)(o & 3)) {  // d_tex is 16 B aligned: element o is at 4 (o & 3) mod 16 B
      case 0: red4(p, a0, a1, a2, b0); red2(p + 4, b1, b2); break;
      case 1: red4(p - 1, 0.f, a0, a1, a2); red4(p + 3, b0, b1, b2, 0.f); break;
      case 2: red2(p, a0, a1); red4(p + 2, a2, b0, b1, b2); break;
      default: red2(p - 1, 0.f, a0); red4(p + 1, a1, a2, b0, b1); red2(p + 5, b2, 0.f); break;
    }
    return;
  }
  if (has_a) {
    red1(d_tex + o, a0);
    red1(d_tex + o + 1, a1);
    red1(d_tex + o + 2, a2);
  }
  if (has_b) {
    red1(d_tex + o + 3, b0);
    red1(d_tex + o + 4, b1);
    red1(d_tex + o + 5, b2);
  }
}

// One pixel's inputs, its taps and the texels under them.
struct Pixel {
  size_t p;
  bool sampled;
  float u_in, v_in, g0, g1, g2;
  float wx, wy;
  int xi, yi;   // the tap (y0, x0); x0 and y0 may be -1, x0 + 1 = Wt, y0 + 1 = Ht
  float t[12];  // the texels (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)

  __device__ __forceinline__ void load(const float* __restrict__ uv,
                                       const float* __restrict__ g) {
    u_in = v_in = g0 = g1 = g2 = 0.f;
    if (sampled) {
      const float2 c = reinterpret_cast<const float2*>(uv)[p];
      u_in = c.x;
      v_in = c.y;
      g0 = g[3 * p + 0];
      g1 = g[3 * p + 1];
      g2 = g[3 * p + 2];
    }
  }

  // the forward kernel's arithmetic; the texels read where sampled and inside
  __device__ __forceinline__ void taps(const float* __restrict__ tex_b, int Ht, int Wt) {
    const float u = fminf(fmaxf(u_in, 0.f), 1.f);
    const float v = fminf(fmaxf(v_in, 0.f), 1.f);
    const float gx = u * 2.f - 1.f;
    const float gy = -(v * 2.f - 1.f);
    // each step rounded on its own, as the plain version rounds it: an FMA
    // of (gx + 1) * Wt - 1 moves x by an ulp where Wt is not a power of two
    // (1.5e-5 in the output at Ht 320, the ATR recipe's texture)
    const float x = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gx, 1.f), (float)Wt), 1.f), 0.5f);
    const float y = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gy, 1.f), (float)Ht), 1.f), 0.5f);
    const float x0 = floorf(x), y0 = floorf(y);
    wx = x - x0;
    wy = y - y0;
    xi = (int)x0;
    yi = (int)y0;
    const bool in_x0 = xi >= 0 && xi < Wt, in_x1 = xi + 1 >= 0 && xi + 1 < Wt;
    const bool in_y0 = yi >= 0 && yi < Ht, in_y1 = yi + 1 >= 0 && yi + 1 < Ht;
    const long long o00 = ((long long)yi * Wt + xi) * 3, o10 = o00 + (long long)Wt * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      t[c] = (sampled && in_y0 && in_x0) ? tex_b[o00 + c] : 0.f;
      t[3 + c] = (sampled && in_y0 && in_x1) ? tex_b[o00 + 3 + c] : 0.f;
      t[6 + c] = (sampled && in_y1 && in_x0) ? tex_b[o10 + c] : 0.f;
      t[9 + c] = (sampled && in_y1 && in_x1) ? tex_b[o10 + 3 + c] : 0.f;
    }
  }

  __device__ __forceinline__ float2 d_uv(int Ht, int Wt) const {
    if (!sampled) return make_float2(0.f, 0.f);
    const float gc[3] = {g0, g1, g2};
    float dx = 0.f, dy = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t00 = t[c], t01 = t[3 + c], t10 = t[6 + c], t11 = t[9 + c];
      dx += gc[c] * ((t01 - t00) * (1.f - wy) + (t11 - t10) * wy);
      dy += gc[c] * ((t10 - t00) * (1.f - wx) + (t11 - t01) * wx);
    }
    return make_float2(dx * (float)Wt * clip_grad(u_in), -dy * (float)Ht * clip_grad(v_in));
  }
};

// blockIdx.x: the block's rank in its cluster; blockIdx.y: the image.
__global__ void __launch_bounds__(THREADS)
texture_bwd_kernel(const float* __restrict__ g, const float* __restrict__ uv,
                   const float* __restrict__ mask, const float* __restrict__ tex, int H, int W,
                   int Ht, int Wt, float* __restrict__ d_tex, float* __restrict__ d_uv) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int row_floats = Wt * 3;
  const long long img_lo = (long long)b * Ht * row_floats;
  const long long img_hi = img_lo + (long long)Ht * row_floats;

  // zero this block's band of the image's rows, then wait for the cluster
  const int rows = (Ht + CLUSTER - 1) / CLUSTER;
  const int band_row0 = min(Ht, rank * rows);
  const int n = (min(Ht, band_row0 + rows) - band_row0) * row_floats;
  float* band = d_tex + img_lo + (size_t)band_row0 * row_floats;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(band) & 15) == 0) {
    float4* band4 = reinterpret_cast<float4*>(band);
    for (int i = threadIdx.x; i < n / 4; i += THREADS)
      band4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    done = n & ~3;
  }
  for (int i = done + threadIdx.x; i < n; i += THREADS) band[i] = 0.f;
  cluster.sync();

  const int P = H * W;
  const int share = (P + CLUSTER - 1) / CLUSTER;
  const int p_begin = rank * share;
  const int p_end = min(P, p_begin + share);
  const size_t img = (size_t)b * P;
  const float* tex_b = tex + img_lo;

  for (int i = p_begin + threadIdx.x; i < p_end; i += THREADS) {
    Pixel q;
    q.p = img + (size_t)i;
    q.sampled = mask == nullptr || mask[q.p] > 0.5f;
    q.load(uv, g);
    q.taps(tex_b, Ht, Wt);
    reinterpret_cast<float2*>(d_uv)[q.p] = q.d_uv(Ht, Wt);
    if (!q.sampled || (q.g0 == 0.f && q.g1 == 0.f && q.g2 == 0.f)) continue;

    const float w00 = (1.f - q.wx) * (1.f - q.wy), w01 = q.wx * (1.f - q.wy);
    const float w10 = (1.f - q.wx) * q.wy, w11 = q.wx * q.wy;
    // x0 and y0 are at least -1, x0 + 1 and y0 + 1 at most Wt and Ht
    const bool in_x0 = q.xi >= 0, in_x1 = q.xi + 1 < Wt;
    const long long o00 = img_lo + ((long long)q.yi * Wt + q.xi) * 3;
    if (q.yi >= 0)
      add_row(d_tex, o00, img_lo, img_hi, in_x0, in_x1, w00 * q.g0, w00 * q.g1, w00 * q.g2,
              w01 * q.g0, w01 * q.g1, w01 * q.g2);
    if (q.yi + 1 < Ht)
      add_row(d_tex, o00 + row_floats, img_lo, img_hi, in_x0, in_x1, w10 * q.g0, w10 * q.g1,
              w10 * q.g2, w11 * q.g0, w11 * q.g1, w11 * q.g2);
  }
}

}  // namespace

// mask may be null: the unmasked mode.
extern "C" int texture_bwd(const float* g, const float* uv, const float* mask,
                           const float* tex, int B, int H, int W, int Ht, int Wt, float* d_tex,
                           float* d_uv, void* stream) {
  if (B > 65535 || (reinterpret_cast<uintptr_t>(d_tex) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)CLUSTER, (unsigned)B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, texture_bwd_kernel, g, uv, mask, tex, H, W, Ht, Wt, d_tex, d_uv);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
