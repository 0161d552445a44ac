// Bilinear disparity warp with torch grid_sample parity, for Hopper.
//
// Replaces: decnet_tpu/ops/pallas/warp.py::_hwarp_kernel (launched by
// _hwarp_rows) together with the XLA vertical pass _vert_interp that runs
// before it — warp_by_disparity_fast, the Refinement warp of DecNet's three
// fine stages.
//
// out[b,c,h,w] samples feat[b,c] at
//   x = (w - clip(disp[b,h,w], -16, max_disp)) * W/(W-1) - 0.5,
//   y = h * H/(H-1) - 0.5,
// bilinearly, with zero padding outside the image: the vertical pair of
// rows first, then the horizontal tent weights max(0, 1 - |col - x|), in
// f32, as the TPU kernel's two passes do.  The output has feat's dtype.
//
// Bound on this card: bytes.  Each output element needs its four taps
// (neighbouring threads read neighbouring columns, so the taps of a warp
// fall in a few cache lines), one disparity (shared by the C channels,
// served from L1/L2) and one write: at the stage-3 shape (C = 8, 540x972,
// bf16) ~19 MB, ~6 us at 3.35 TB/s.
//
// Design: one thread per output element, W fastest, so reads and writes
// coalesce.  The TPU kernel's banded one-hot matrix product answered a
// TPU's slow gather; a GPU gathers directly, so this is a plain 4-tap
// sample with no staging.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const T* __restrict__ feat, const float* __restrict__ disp,
            T* __restrict__ out, int C, int H, int W, int total,
            float lo, float hi, float sx, float sy) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int w = i % W;
  int t = i / W;
  const int h = t % H;
  t /= H;                                    // t = b * C + c
  const int b = t / C;
  const float d = fminf(fmaxf(disp[((size_t)b * H + h) * W + w], lo), hi);
  // positions as one fused multiply-add, the weights with explicit
  // roundings in the plain version's order: f32 results match it exactly
  const float x = __fmaf_rn((float)w - d, sx, -0.5f);
  const float y = __fmaf_rn((float)h, sy, -0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  const float wy1 = y - y0;
  const float wy0 = 1.f - wy1;
  const int xi = (int)x0, yi = (int)y0;
  const T* plane = feat + (size_t)t * H * W;
  const bool r0 = yi >= 0 && yi < H, r1 = yi + 1 >= 0 && yi + 1 < H;
  float v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int col = xi + k;
    float a = 0.f, c = 0.f;
    if (col >= 0 && col < W) {
      if (r0) a = to_f32(plane[(size_t)yi * W + col]);
      if (r1) c = to_f32(plane[(size_t)(yi + 1) * W + col]);
    }
    v[k] = __fadd_rn(__fmul_rn(a, wy0), __fmul_rn(c, wy1));
  }
  const float wx0 = fmaxf(0.f, 1.f - fabsf(x0 - x));
  const float wx1 = fmaxf(0.f, 1.f - fabsf(x0 + 1.f - x));
  out[i] = from_f32<T>(__fadd_rn(__fmul_rn(wx0, v[0]), __fmul_rn(wx1, v[1])));
}

}  // namespace

// feat (B,C,H,W) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// disp (B,H,W) f32; out like feat.  Returns a cudaError_t.
extern "C" int warp_disparity(const void* feat, const void* disp, void* out,
                              int B, int C, int H, int W, int max_disp,
                              int neg_margin, int is_bf16, void* stream) {
  const long long total = (long long)B * C * H * W;
  if (B <= 0 || C <= 0 || H < 2 || W < 2 || total >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const float sx = (float)(W / (W - 1.0));
  const float sy = (float)(H / (H - 1.0));
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    warp_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feat),
        static_cast<const float*>(disp), static_cast<__nv_bfloat16*>(out), C,
        H, W, (int)total, -(float)neg_margin, (float)max_disp, sx, sy);
  else
    warp_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(feat), static_cast<const float*>(disp),
        static_cast<float*>(out), C, H, W, (int)total, -(float)neg_margin,
        (float)max_disp, sx, sy);
  return (int)cudaGetLastError();
}
