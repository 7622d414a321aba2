// texture_fwd.cu -- bilinear UV texture sampling for Hopper (sm_90a), masked
// or unmasked.
//
// Replaces, masked: magicmirror/ops/pallas/texture_cells.py::_tex_kernel
// (reached through texture_render).  Replaces, unmasked (a null mask
// pointer: every pixel is sampled): magicmirror/ops/pallas/texture_tpu.py::
// _kernel (the dense tent-matmul bilinear sampler, reached through
// texture_bilinear_pallas from ops/sampling.texture_mapping).
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
//
// The body by level (texture_parts): also replaces
// benchmarks/bench_texcells_parts.py::make_kernel.kern, a probe that times
// K3's TPU body cut short.  LEVEL is a template parameter: 5 is the kernel
// above (texture_fwd launches that instantiation); 1 reads the mask and
// writes zeros; 4 adds the uv read and clip, the tap coordinates and the 12
// texel gathers with their weights, and still writes zeros.  What a level
// computes and does not write (level 1's mask, level 4's sum) is stored only
// where it equals ``never``, a runtime argument the wrapper sets to NaN,
// which nothing equals: the compiler cannot know that, so it must load and
// compute the value to make the test (a never-set flag would not do: the
// loads could move under the flag's branch).  Below 5 the output is zeros,
// as the TPU probe writes.  The probe's levels 2 and
// 3 (tent weights and block gathers of the chunk stream) have no
// counterpart: this kernel has no chunk stream.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float tap(const float* t, int Ht, int Wt, int y, int x, int c) {
  return (x >= 0 && x < Wt && y >= 0 && y < Ht) ? t[((size_t)y * Wt + x) * 3 + c] : 0.f;
}

template <int LEVEL>
__global__ void __launch_bounds__(THREADS)
texture_fwd_kernel(const float* __restrict__ uv, const float* __restrict__ mask,
                   const float* __restrict__ tex, int B, int H, int W, int Ht,
                   int Wt, float* __restrict__ out, float never) {
  const size_t n = (size_t)B * H * W;
  const size_t p = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= n) return;
  float* o = out + 3 * p;
  if (LEVEL < 4) {  // the mask is read; it is stored only where it equals NaN
    const float m = mask[p];
    o[0] = m == never ? m : 0.f;
    o[1] = 0.f;
    o[2] = 0.f;
    return;
  }
  if (mask != nullptr && !(mask[p] > 0.5f)) {
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
  // each step rounded on its own, as the plain version rounds it: an FMA
  // of (gx + 1) * Wt - 1 moves x by an ulp where Wt is not a power of two
  // (1.5e-5 in the output at Ht 320, the ATR recipe's texture)
  const float x = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gx, 1.f), (float)Wt), 1.f), 0.5f);
  const float y = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gy, 1.f), (float)Ht), 1.f), 0.5f);
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
    const float sum = t00 * (1.f - wx) * (1.f - wy) + t01 * wx * (1.f - wy) +
                      t10 * (1.f - wx) * wy + t11 * wx * wy;
    o[c] = (LEVEL == 5 || sum == never) ? sum : 0.f;
  }
}

unsigned blocks_for(int B, int H, int W) {
  return (unsigned)(((size_t)B * H * W + THREADS - 1) / THREADS);
}

}  // namespace

// mask may be null: the unmasked mode.
extern "C" int texture_fwd(const float* uv, const float* mask, const float* tex,
                           int B, int H, int W, int Ht, int Wt, float* out,
                           void* stream) {
  texture_fwd_kernel<5><<<blocks_for(B, H, W), THREADS, 0, (cudaStream_t)stream>>>(
      uv, mask, tex, B, H, W, Ht, Wt, out, 0.f);
  return (int)cudaGetLastError();
}

// The masked kernel's body by level (1, 4 or 5); level 5 is texture_fwd's
// own instantiation.  ``never`` is NaN (see the top of the file).  Any other
// level is refused with cudaErrorInvalidValue.
extern "C" int texture_parts(const float* uv, const float* mask, const float* tex,
                             int B, int H, int W, int Ht, int Wt, int level,
                             float never, float* out, void* stream) {
  const unsigned blocks = blocks_for(B, H, W);
  cudaStream_t s = (cudaStream_t)stream;
  if (level == 1) {
    texture_fwd_kernel<1><<<blocks, THREADS, 0, s>>>(uv, mask, tex, B, H, W, Ht, Wt, out, never);
  } else if (level == 4) {
    texture_fwd_kernel<4><<<blocks, THREADS, 0, s>>>(uv, mask, tex, B, H, W, Ht, Wt, out, never);
  } else if (level == 5) {
    texture_fwd_kernel<5><<<blocks, THREADS, 0, s>>>(uv, mask, tex, B, H, W, Ht, Wt, out, never);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
