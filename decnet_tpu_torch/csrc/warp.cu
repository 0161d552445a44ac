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
// Row shards (the mesh's tile axis, parallel/mesh.py).  The output may be
// rows [row0, row0 + H) of an image of Hg rows, and then h and H above are
// the global row and Hg.  feat then holds rows [row0 - halo, row0 + H +
// halo): the shard's rows with `halo` (0 or 1) neighbour rows each side,
// which is every row y can reach.  A row outside [0, Hg) is never read.
// The unsplit launch is Hg = H, row0 = 0, halo = 0.
//
// Bound on this card: bytes.  One read of the features and the disparity
// and one write of the output: at the serving stage-3 shape (C = 8,
// 540x972, bf16) ~19 MB, ~5.6 us at 3.35 TB/s.
//
// Design.  The sample row pair depends only on h, and the column position
// only on (b, h, w), not on c.  So:
//   * A block owns one (b, h) output row of `cg` channels (all of them
//     unless the rows leave fewer than two blocks per SM; the plan is
//     ops/kernels/warp.py::warp_plan).
//   * It stages the source rows y0 and y0 + 1 of its channels and the
//     disparity row with 16-byte cp.async copies, all in flight at once
//     (staging.cuh: a row pitch of 972 bf16 is not a multiple of 16
//     bytes), skipping a source row outside the image.
//   * Each column reads its disparity once and computes x, x0 and the two
//     tent weights once, then loops over the block's channels, taking the
//     vertical blends and the two horizontal taps from shared memory and
//     storing each output where it is computed: a warp's 32 neighbouring
//     columns of a channel fill whole 32-byte sectors.  A shared output
//     tile written back by 16-byte vectors, several output rows a block
//     (sharing their source rows) and staging in two halves were each
//     slower at the stage shapes (PERF.md).
// phases(warp_disparity): issue rows warp
// The arithmetic is the plain version's (positions as one fused
// multiply-add, then explicit roundings in its order), so f32 results
// match ops/kernels/warp.py::warp_plain exactly.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "stamps.cuh"
#include "staging.cuh"

namespace {

using staging::align16;
using staging::kMapGE;
using staging::row_stride;
using staging::stage_lead;

constexpr int kMaxThreads = 256;

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

// Dynamic shared memory of one block: the source rows y0 and y0 + 1 of cg
// channels and the disparity row; ops/kernels/warp.py::warp_plan computes
// the same.
template <typename T>
size_t smem_bytes(int cg, int W, long long hw) {
  constexpr int GE = staging::kGranBytes / (int)sizeof(T);
  return 2 * align16(sizeof(T) * cg * row_stride(W, GE, hw))
         + align16(4 * row_stride(W, kMapGE, 0));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
warp_kernel(const T* __restrict__ feat, const float* __restrict__ disp,
            T* __restrict__ out, int C, int H, int W, int cg, float lo,
            float hi, float sx, float sy, int Hf, int Hg, int row0,
            int first) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int GE = staging::kGranBytes / (int)sizeof(T);
  const long long hw = (long long)H * W;      // an output plane
  const long long hw_in = (long long)Hf * W;  // a feature plane
  const int stride = row_stride(W, GE, hw_in);
  const size_t rows_bytes = align16(sizeof(T) * cg * stride);
  T* r0_s = reinterpret_cast<T*>(smem);
  T* r1_s = reinterpret_cast<T*>(smem + rows_bytes);
  float* d_s = reinterpret_cast<float*>(smem + 2 * rows_bytes);

  const int c0 = blockIdx.x * cg, nc = min(cg, C - c0);
  const int h = blockIdx.y, b = blockIdx.z;
  const long long plane0 = ((long long)b * C + c0) * hw;   // channel c0
  const long long plane0_in = ((long long)b * C + c0) * hw_in;
  const long long n_total = (long long)gridDim.z * C * hw_in;
  const float y = __fmaf_rn((float)(row0 + h), sy, -0.5f);
  const float y0 = floorf(y);
  const float wy1 = y - y0;
  const float wy0 = 1.f - wy1;
  const int yi = (int)y0;                     // -1 <= yi <= Hg - 1
  const int li = yi - first;                  // its row in feat
  const bool ok0 = yi >= 0 && yi < Hg && li >= 0 && li < Hf;
  const bool ok1 = yi + 1 < Hg && li + 1 >= 0 && li + 1 < Hf;
  const long long base0 = plane0_in + (long long)li * W;
  const long long base1 = base0 + W;
  const long long dbase = ((long long)b * H + h) * W;       // (B,H,W) disp
  DECNET_STAMP(0);
  staging::stage_rows(d_s, row_stride(W, kMapGE, 0), disp, dbase, 0,
                      (long long)gridDim.z * hw, 1, 0, W);
  if (ok0) staging::stage_rows(r0_s, stride, feat, base0, hw_in, n_total, nc, 0, W);
  if (ok1) staging::stage_rows(r1_s, stride, feat, base1, hw_in, n_total, nc, 0, W);
  staging::cp_async_commit();

  const T* a_s = r0_s + (ok0 ? stage_lead<T>(base0, 0) : 0);
  const T* c_s = r1_s + (ok1 ? stage_lead<T>(base1, 0) : 0);
  const float* drow = d_s + stage_lead<float>(dbase, 0);
  T* o_row = out + plane0 + (long long)h * W;
  DECNET_STAMP_SYNC(1);
  staging::cp_async_wait<0>();
  __syncthreads();
  DECNET_STAMP(2);

  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const float d = fminf(fmaxf(drow[w], lo), hi);
    // positions as one fused multiply-add, the weights with explicit
    // roundings in the plain version's order
    const float x = __fmaf_rn((float)w - d, sx, -0.5f);
    const float x0 = floorf(x);
    const int xi = (int)x0;
    const float wx0 = fmaxf(0.f, 1.f - fabsf(x0 - x));
    const float wx1 = fmaxf(0.f, 1.f - fabsf(x0 + 1.f - x));
    const bool in0 = xi >= 0 && xi < W, in1 = xi + 1 >= 0 && xi + 1 < W;
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      const int row = c * stride;
      float v[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const bool in = k ? in1 : in0;
        const int col = row + xi + k;
        const float a = in && ok0 ? to_f32(a_s[col]) : 0.f;
        const float cc = in && ok1 ? to_f32(c_s[col]) : 0.f;
        v[k] = __fadd_rn(__fmul_rn(a, wy0), __fmul_rn(cc, wy1));
      }
      o_row[c * hw + w] =
          from_f32<T>(__fadd_rn(__fmul_rn(wx0, v[0]), __fmul_rn(wx1, v[1])));
    }
  }
  DECNET_STAMP_SYNC(3);
}

template <typename T>
int launch(const void* feat, const void* disp, void* out, int B, int C,
           int H, int W, int cg, int threads, int smem, float lo, float hi,
           float sx, float sy, int Hf, int Hg, int row0, int first,
           cudaStream_t s) {
  // The plan's numbers, checked against what this kernel needs.
  if (cg < 1 || cg > C || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 ||
      (size_t)smem != smem_bytes<T>(cg, W, (long long)Hf * W) ||
      smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        warp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((C + cg - 1) / cg, H, B);
  warp_kernel<T><<<grid, threads, smem, s>>>(
      static_cast<const T*>(feat), static_cast<const float*>(disp),
      static_cast<T*>(out), C, H, W, cg, lo, hi, sx, sy, Hf, Hg, row0,
      first);
  return (int)cudaGetLastError();
}

}  // namespace

// feat (B,C,H + 2 halo,W) contiguous, f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); disp (B,H,W) f32; out (B,C,H,W) like feat; their data on
// 16 bytes.  The output rows are rows [row0, row0 + H) of an image of Hg
// rows (Hg = H, row0 = 0, halo = 0 unsplit).  cg, threads and smem are
// warp_plan's.  Returns a cudaError_t.
extern "C" int warp_disparity(const void* feat, const void* disp, void* out,
                              int B, int C, int H, int W, int max_disp,
                              int neg_margin, int is_bf16, int cg,
                              int threads, int smem, int Hg, int row0,
                              int halo, void* stream) {
  const int Hf = H + 2 * halo;
  const long long total = (long long)B * C * Hf * W;
  if (B <= 0 || C <= 0 || H < 1 || W < 2 || Hg < 2 || total >= (1LL << 31) ||
      H > 65535 || B > 65535 || row0 < 0 || row0 + H > Hg || halo < 0 ||
      halo > 1)
    return (int)cudaErrorInvalidValue;
  const float sx = (float)(W / (W - 1.0));
  const float sy = (float)(Hg / (Hg - 1.0));
  const float lo = -(float)neg_margin, hi = (float)max_disp;
  const int first = row0 - halo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(feat, disp, out, B, C, H, W, cg, threads,
                                 smem, lo, hi, sx, sy, Hf, Hg, row0, first, s);
  return launch<float>(feat, disp, out, B, C, H, W, cg, threads, smem, lo, hi,
                       sx, sy, Hf, Hg, row0, first, s);
}
