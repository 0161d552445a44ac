// Gradient of the query features of sparse stereo matching (dRef), for
// Hopper.
//
// Replaces: decnet_tpu/ops/pallas/spamat.py::_dref_kernel (launched by
// _spamat_backward_rows_impl), half of the backward of the fused matching
// + variance op on the three fine stages of DecNet in training.  Its twin
// dTar is in spamat_dtar.cu.
//
// With w[q] = g[q] / sum_sim[q] on queries with ref_mask != 0 (0 elsewhere;
// the wrapper computes it), and for every candidate pair of the forward --
// key k = q - d, d in [0, D), k >= 0, tar_mask[k] != 0, and
// |d - center[q]| <= window when window > 0 -- the score
// s(q,k) = sum_c ref[c,q] * tar[c,k] in f32 and e = exp(s - max_cost[q]):
//   grad_ref[q] = sum_k e * (d - out[q]) * w[q] * tar[k],
// zero at inactive queries (w == 0).
//
// NaN safety.  A pair is gated by the query weight and the key mask BEFORE
// the exp, never by multiplying afterwards: a masked-out key may outscore
// max_cost (it took no part in the forward max), and a query with
// ref_mask == 0 has max_cost == 0, so exp could overflow to inf and inf * 0
// is NaN.  A query with no candidate has w = 1e6 * g but visits no pair.
// The scores are recomputed with the forward kernel's arithmetic (fmaf over
// c ascending from 0), so a visited pair has s <= max_cost.
//
// Bound on this card: bytes.  At the training stage-3 shape (B = 8, C = 8,
// 162x486, D = 216, bf16 features) the kernel reads both feature maps and
// four f32 maps and writes one bf16 gradient once: ~40 MB, ~12 us at
// 3.35 TB/s; the 4C + ~8 flops of the candidate pairs that ~20%-dense masks
// leave are a few times fewer.  This simple version sits well above that
// bound (PERF.md has its times): its staging loop waits for each load
// before the next, and a thread walks its pairs one by one, with an exp
// and 2C FMAs each.
//
// Design.  The TPU kernel builds a dense (rows x 128 x band) score tile on
// the MXU; here the work is sparse, so the kernel follows the forward
// kernel's second version: one block per (b, row, 128 queries) stages the
// key window (128 + D - 1) x C in shared memory (f32) and the key mask as
// one bit per slot, queues its active queries (w != 0) so that whole warps
// hold active queries, and each thread walks the set key bits of its
// query's band, d ascending, with the query's features and its C gradient
// sums in registers.  C is a template bound, one per model stage (8, 24 or
// 72: the register arrays need a compile-time size); the runtime C <= that
// bound, and a wider C is refused.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kT = 128;  // queries (dRef) or keys (dTar) per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Queue the block's active threads in column order: returns this block's
// number of active threads; queue[i] is the i-th active thread's index.
__device__ __forceinline__ int queue_active(bool active, int* queue,
                                            int* warp_count) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const unsigned act = __ballot_sync(0xffffffffu, active);
  if (lane == 0) warp_count[wid] = __popc(act);
  __syncthreads();
  int base = 0, n = 0;
  for (int i = 0; i < kT / 32; ++i) {
    base += i < wid ? warp_count[i] : 0;
    n += warp_count[i];
  }
  if (active) queue[base + __popc(act & ((1u << lane) - 1u))] = tid;
  __syncthreads();
  return n;
}

template <typename T>
__device__ __forceinline__ void zero_column(T* grad, size_t base,
                                            size_t plane, int C) {
  for (int c = 0; c < C; ++c) store(grad + base + (size_t)c * plane, 0.f);
}

template <typename T, int CT>
__global__ void __launch_bounds__(kT)
dref_kernel(const T* __restrict__ ref, const T* __restrict__ tar,
            const float* __restrict__ tar_mask,
            const float* __restrict__ max_cost,
            const float* __restrict__ out, const float* __restrict__ wq,
            const float* __restrict__ center, T* __restrict__ gref,
            int C, int H, int W, int D, int window) {
  extern __shared__ float smem[];
  __shared__ int warp_count[kT / 32];
  const int KW = kT + D - 1;
  const int n_words = (KW + 31) / 32;
  float* k_s = smem;                                          // [C][KW]
  unsigned* key_bits = reinterpret_cast<unsigned*>(k_s + C * KW);
  int* queue = reinterpret_cast<int*>(key_bits + n_words);    // [kT]

  const int tid = threadIdx.x, lane = tid & 31;
  const int w0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int w = w0 + tid;
  const bool in_row = w < W;
  const size_t row = ((size_t)b * H + h) * W;                 // (B,H,W) maps
  const size_t plane = (size_t)H * W;
  const size_t feat_row = (size_t)b * C * plane + (size_t)h * W;
  const bool active = in_row && wq[row + w] != 0.f;

  if (in_row && !active) zero_column(gref, feat_row + w, plane, C);
  if (!__syncthreads_or(active)) return;

  // Stage the key window and its mask bits.
  const int k0 = w0 - (D - 1);       // column of key slot 0
  for (int j = tid; j < n_words * 32; j += kT) {              // warp-uniform
    const int col = k0 + j;
    const bool ok = j < KW && col >= 0 && col < W && tar_mask[row + col] != 0.f;
    const unsigned bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) key_bits[j >> 5] = bits;
  }
  for (int c = 0; c < C; ++c) {
    const T* src = tar + feat_row + (size_t)c * plane;
    for (int j = tid; j < KW; j += kT) {
      const int col = k0 + j;
      k_s[c * KW + j] = (col >= 0 && col < W) ? to_f32(src[col]) : 0.f;
    }
  }
  const int n_active = queue_active(active, queue, warp_count);
  if (tid >= n_active) return;

  const int qt = queue[tid];
  const int qw = w0 + qt;
  float q[CT], acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    q[c] = c < C ? to_f32(ref[feat_row + (size_t)c * plane + qw]) : 0.f;
    acc[c] = 0.f;
  }
  const float mc = max_cost[row + qw], o = out[row + qw], wv = wq[row + qw];
  const float cen = window > 0 ? center[row + qw] : 0.f;
  const float win = (float)window;
  const int hi = qt + D - 1;                    // key slot of d = 0
  const int lo = qt + D - min(D, qw + 1);       // slot of the largest d
  for (int wi = hi >> 5; wi >= (lo >> 5); --wi) {
    const int s0 = wi << 5;
    unsigned bits = key_bits[wi];
    if (hi - s0 < 31) bits &= (2u << (hi - s0)) - 1u;
    if (lo > s0) bits &= ~((1u << (lo - s0)) - 1u);
    while (bits) {                              // highest slot first: d up
      const int bit = 31 - __clz(bits);
      bits &= ~(1u << bit);
      const int j = s0 + bit;
      const float fd = (float)(hi - j);
      if (window > 0 && fabsf(fd - cen) > win) continue;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CT; ++c)
        if (c < C) s = fmaf(q[c], k_s[c * KW + j], s);
      const float coef = expf(s - mc) * (fd - o) * wv;
#pragma unroll
      for (int c = 0; c < CT; ++c)
        if (c < C) acc[c] = fmaf(coef, k_s[c * KW + j], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < CT; ++c)
    if (c < C) store(gref + feat_row + (size_t)c * plane + qw, acc[c]);
}

template <typename T, int CT>
int launch_ct(const void* own, const void* other, const void* tar_mask,
              const void* max_cost, const void* out, const void* w,
              const void* center, void* grad, int B, int C, int H, int W,
              int D, int window, cudaStream_t stream) {
  const size_t span = kT + D - 1;
  const size_t smem = sizeof(float) * C * span
                      + sizeof(unsigned) * ((span + 31) / 32)
                      + sizeof(int) * kT;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = dref_kernel<T, CT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + kT - 1) / kT, H, B);
  kernel<<<grid, kT, smem, stream>>>(
      static_cast<const T*>(own), static_cast<const T*>(other),
      static_cast<const float*>(tar_mask), static_cast<const float*>(max_cost),
      static_cast<const float*>(out), static_cast<const float*>(w),
      static_cast<const float*>(center), static_cast<T*>(grad), C, H, W, D,
      window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* own, const void* other, const void* tar_mask,
           const void* max_cost, const void* out, const void* w,
           const void* center, void* grad, int B, int C, int H, int W, int D,
           int window, cudaStream_t s) {
#define DECNET_BWD_CT(CT)                                                   \
  if (C <= CT)                                                              \
    return launch_ct<T, CT>(own, other, tar_mask, max_cost, out, w, center, \
                            grad, B, C, H, W, D, window, s);
  DECNET_BWD_CT(8)
  DECNET_BWD_CT(24)
  DECNET_BWD_CT(72)
#undef DECNET_BWD_CT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ref/tar and grad_ref (B,C,H,W) contiguous, f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); tar_mask, max_cost, out, w (B,H,W) f32; center (B,H,W) f32,
// read only when window > 0.  Returns a cudaError_t.
extern "C" int spamat_dref(const void* ref, const void* tar,
                           const void* tar_mask, const void* max_cost,
                           const void* out, const void* w, const void* center,
                           void* grad_ref, int B, int C, int H, int W,
                           int max_disp, int window, int is_bf16,
                           void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || max_disp <= 0 || window < 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(ref, tar, tar_mask, max_cost, out, w, center,
                                 grad_ref, B, C, H, W, max_disp, window, s);
  return launch<float>(ref, tar, tar_mask, max_cost, out, w, center, grad_ref,
                       B, C, H, W, max_disp, window, s);
}
