// texture_fwd.cu -- masked bilinear UV texture sampling for Hopper (sm_90a).
//
// Replaces: magicmirror/ops/pallas/texture_cells.py::_tex_kernel (reached
// through texture_render).  With the mask test dropped it is also the
// function of magicmirror/ops/pallas/texture_tpu.py::_kernel (unmasked dense
// bilinear), which a later unmasked mode of this kernel will cover.
//
// What it computes, per output pixel: 0 where mask <= 0.5; elsewhere
// texture_mapping(uv) in exactly the arithmetic of the JAX golden path
// (magicmirror/ops/sampling.py:318-356): uv clipped to [0, 1],
// x = u*Wt - 0.5, y = (1 - v)*Ht - 0.5, a 4-tap bilinear sample with zeros
// padding.  uv (B, H, W, 2), mask (B, H, W), texture (B, Ht, Wt, 3) and the
// output (B, H, W, 3) are fp32 NHWC.  The TPU kernel sampled a bf16 texture
// through cell-windowed MXU matmuls; this one is fp32, held to the fp32
// golden path.
//
// What bounds it on this card: memory latency of the gathers.  Per covered
// pixel it reads 8 B of uv, 4 B of mask and 4 taps x 12 B of texture and
// writes 12 B, with ~30 flops.  A texture of 256x128x3 fp32 (384 KB) stays
// in L2, so the taps are L2 hits; the TPU needed the chunk stream to turn
// its serial row gathers into matmuls, a GPU gathers directly.  One thread
// per pixel, consecutive threads on consecutive pixels, so the uv, mask and
// output streams coalesce; no shared memory, no stream of chunks.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float tap(const float* t, int Ht, int Wt, int y, int x, int c) {
  return (x >= 0 && x < Wt && y >= 0 && y < Ht) ? t[((size_t)y * Wt + x) * 3 + c] : 0.f;
}

__global__ void __launch_bounds__(THREADS)
texture_fwd_kernel(const float* __restrict__ uv, const float* __restrict__ mask,
                   const float* __restrict__ tex, int B, int H, int W, int Ht,
                   int Wt, float* __restrict__ out) {
  const size_t n = (size_t)B * H * W;
  const size_t p = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= n) return;
  float* o = out + 3 * p;
  if (!(mask[p] > 0.5f)) {
    o[0] = 0.f;
    o[1] = 0.f;
    o[2] = 0.f;
    return;
  }
  const int b = (int)(p / ((size_t)H * W));
  const float u = fminf(fmaxf(uv[2 * p + 0], 0.f), 1.f);
  const float v = fminf(fmaxf(uv[2 * p + 1], 0.f), 1.f);
  const float gx = u * 2.f - 1.f;
  const float gy = -(v * 2.f - 1.f);
  const float x = ((gx + 1.f) * (float)Wt - 1.f) * 0.5f;
  const float y = ((gy + 1.f) * (float)Ht - 1.f) * 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx = x - x0, wy = y - y0;
  const int xi = (int)x0, yi = (int)y0;
  const float* t = tex + (size_t)b * Ht * Wt * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t00 = tap(t, Ht, Wt, yi, xi, c);
    const float t01 = tap(t, Ht, Wt, yi, xi + 1, c);
    const float t10 = tap(t, Ht, Wt, yi + 1, xi, c);
    const float t11 = tap(t, Ht, Wt, yi + 1, xi + 1, c);
    o[c] = t00 * (1.f - wx) * (1.f - wy) + t01 * wx * (1.f - wy) +
           t10 * (1.f - wx) * wy + t11 * wx * wy;
  }
}

}  // namespace

extern "C" int texture_fwd(const float* uv, const float* mask, const float* tex,
                           int B, int H, int W, int Ht, int Wt, float* out,
                           void* stream) {
  const size_t n = (size_t)B * H * W;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  texture_fwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      uv, mask, tex, B, H, W, Ht, Wt, out);
  return (int)cudaGetLastError();
}

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
