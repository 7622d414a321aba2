// texture_bwd.cu -- backward of the masked bilinear UV texture sampling for
// Hopper (sm_90a).
//
// Replaces: magicmirror/ops/pallas/texture_cells.py::_tex_bwd_kernel (the
// streamed VJP of texture_render) together with the uv -> texel chain rule
// that the JAX package takes through _prep_cells / _uv_to_texels.
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
// gradient of jnp.clip (a min of a max, each splitting a tie evenly).
// d_tex (B, Ht, Wt, 3) f32 must be zero on entry; d_uv (B, H, W, 2) is
// written at every pixel.  The mask gets no gradient.
//
// What bounds it on this card: the atomics.  Per covered pixel it reads 8 B
// of uv, 4 B of mask, 12 B of g and 4 taps x 12 B of texture, writes 8 B and
// makes 12 atomicAdds with ~60 flops; the texture and its gradient (384 KB
// each at 256x128) stay in L2, where the atomics resolve.  Neighbouring
// pixels hit neighbouring texels, so the adds of a warp spread over few
// cache lines without piling onto one address.  The TPU kernel scattered
// through bf16 tent-weight matmuls over a host-built chunk stream, with a
// dense fallback on overflow; a GPU adds in place: one thread per pixel,
// fp32 throughout, no stream, no capacity, nothing dropped.  The order of
// the atomic sums varies from run to run, so d_tex is reproducible only to
// float rounding.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float clip_grad(float t) {
  return (t > 0.f && t < 1.f) ? 1.f : ((t == 0.f || t == 1.f) ? 0.5f : 0.f);
}

__global__ void __launch_bounds__(THREADS)
texture_bwd_kernel(const float* __restrict__ g, const float* __restrict__ uv,
                   const float* __restrict__ mask, const float* __restrict__ tex,
                   int B, int H, int W, int Ht, int Wt, float* __restrict__ d_tex,
                   float* __restrict__ d_uv) {
  const size_t n = (size_t)B * H * W;
  const size_t p = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= n) return;
  if (!(mask[p] > 0.5f)) {
    d_uv[2 * p + 0] = 0.f;
    d_uv[2 * p + 1] = 0.f;
    return;
  }
  const int b = (int)(p / ((size_t)H * W));
  const float u_in = uv[2 * p + 0], v_in = uv[2 * p + 1];
  const float u = fminf(fmaxf(u_in, 0.f), 1.f);
  const float v = fminf(fmaxf(v_in, 0.f), 1.f);
  const float gx = u * 2.f - 1.f;
  const float gy = -(v * 2.f - 1.f);
  const float x = ((gx + 1.f) * (float)Wt - 1.f) * 0.5f;
  const float y = ((gy + 1.f) * (float)Ht - 1.f) * 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx = x - x0, wy = y - y0;
  const int xi = (int)x0, yi = (int)y0;
  const bool in_x0 = xi >= 0 && xi < Wt, in_x1 = xi + 1 >= 0 && xi + 1 < Wt;
  const bool in_y0 = yi >= 0 && yi < Ht, in_y1 = yi + 1 >= 0 && yi + 1 < Ht;
  const size_t img = (size_t)b * Ht * Wt * 3;
  // offsets of the four taps; used only where the tap is inside the texture
  const size_t o00 = img + ((size_t)yi * Wt + xi) * 3;
  const size_t o01 = o00 + 3;
  const size_t o10 = o00 + (size_t)Wt * 3;
  const size_t o11 = o10 + 3;
  const float w00 = (1.f - wx) * (1.f - wy), w01 = wx * (1.f - wy);
  const float w10 = (1.f - wx) * wy, w11 = wx * wy;
  float dx = 0.f, dy = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gc = g[3 * p + c];
    const float t00 = (in_y0 && in_x0) ? tex[o00 + c] : 0.f;
    const float t01 = (in_y0 && in_x1) ? tex[o01 + c] : 0.f;
    const float t10 = (in_y1 && in_x0) ? tex[o10 + c] : 0.f;
    const float t11 = (in_y1 && in_x1) ? tex[o11 + c] : 0.f;
    dx += gc * ((t01 - t00) * (1.f - wy) + (t11 - t10) * wy);
    dy += gc * ((t10 - t00) * (1.f - wx) + (t11 - t01) * wx);
    if (in_y0 && in_x0) atomicAdd(&d_tex[o00 + c], w00 * gc);
    if (in_y0 && in_x1) atomicAdd(&d_tex[o01 + c], w01 * gc);
    if (in_y1 && in_x0) atomicAdd(&d_tex[o10 + c], w10 * gc);
    if (in_y1 && in_x1) atomicAdd(&d_tex[o11 + c], w11 * gc);
  }
  d_uv[2 * p + 0] = dx * (float)Wt * clip_grad(u_in);
  d_uv[2 * p + 1] = -dy * (float)Ht * clip_grad(v_in);
}

}  // namespace

extern "C" int texture_bwd(const float* g, const float* uv, const float* mask,
                           const float* tex, int B, int H, int W, int Ht, int Wt,
                           float* d_tex, float* d_uv, void* stream) {
  const size_t n = (size_t)B * H * W;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  texture_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      g, uv, mask, tex, B, H, W, Ht, Wt, d_tex, d_uv);
  return (int)cudaGetLastError();
}
