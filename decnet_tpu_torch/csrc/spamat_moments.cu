// Banded masked-softmax moments of sparse stereo matching, for Hopper.
//
// Replaces: decnet_tpu/ops/pallas/spamat.py::_moments_kernel (launched by
// _moments_rows_impl), the forward of SpaMat/SpaVar on the three fine
// stages of DecNet.
//
// For every query (b, h, w) with ref_mask != 0, over the band d in [0, D)
// of keys tar[.., h, w - d] with tar_mask != 0 (and |d - center| <= window
// when window > 0), with the score s(d) = sum_c ref[c] * tar[c] in f32:
//   m    = max(max_d s(d), 1e-6)
//   se   = sum_d exp(s(d) - m),  sed = sum_d exp(..) * d,
//   sed2 = sum_d exp(..) * d^2.
// A query with no candidate gets m = 1e-6 and zero sums (the callers then
// output exactly 1.0).  A block whose 128 queries are all inactive writes
// zeros and exits, like the TPU kernel's per-tile skip; an inactive query
// inside an active block also gets zeros (every consumer gates by ref_mask).
//
// Bound on this card: bytes.  At the stage-3 shape (C = 8, 540x972,
// D = 216, bf16) one read of both feature maps and masks and one write of
// the four f32 maps is ~29 MB, ~9 us at 3.35 TB/s, while the score FMAs of
// the candidates that ~20%-dense masks leave are under 0.1 GFLOP.  This
// version is still well above that bound (PERF.md has its times); the
// suspects are the staging loads, each waited for before the next, and the
// serial walk of one warp per block (an exp per candidate), with only 60
// blocks at stage 1.
//
// Design: one block per (b, row, tile of 128 query columns).  The block
// stages the key window tar[:, h, w0-D+1 .. w0+127] (C x (128+D-1) values,
// converted to f32) and the 128 queries in shared memory, the key mask as
// one bit per key slot (warp ballots), and queues its active queries in
// column order.  Thread i takes the i-th active query, so whole warps walk
// bands instead of every warp carrying ~80% idle lanes, and it visits only
// the set bits of its band, highest slot first: d ascending, the order of
// the plain version (the lax.scan of the JAX package's ops/matching.py:
// 67-112), with the same online-softmax recurrence, rescaled to the
// clamped max at the end.  K = C is 72, 24 or 8, too small to feed the
// tensor cores well; CUDA-core FMAs serve.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTQ = 128;            // queries per block
constexpr float kEps = 1e-6f;
constexpr float kNeg = -3.0e38f;    // the JAX package's _NEG

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kTQ)
moments_kernel(const T* __restrict__ ref, const T* __restrict__ tar,
               const float* __restrict__ ref_mask,
               const float* __restrict__ tar_mask,
               const float* __restrict__ center,
               float* __restrict__ out_m, float* __restrict__ out_se,
               float* __restrict__ out_sed, float* __restrict__ out_sed2,
               int C, int H, int W, int D, int window) {
  extern __shared__ float smem[];
  __shared__ int warp_count[kTQ / 32];
  const int KW = kTQ + D - 1;
  const int n_words = (KW + 31) / 32;
  float* k_s = smem;                                   // [C][KW] keys
  float* q_s = k_s + C * KW;                           // [C][kTQ] queries
  unsigned* key_bits = reinterpret_cast<unsigned*>(q_s + C * kTQ);
  int* queue = reinterpret_cast<int*>(key_bits + n_words);  // active tids

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int w0 = blockIdx.x * kTQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int w = w0 + tid;
  const bool in_row = w < W;
  const size_t row = ((size_t)b * H + h) * W;           // (B,H,W) maps
  const bool active = in_row && ref_mask[row + w] != 0.f;

  if (!__syncthreads_or(active)) {
    if (in_row) {
      out_m[row + w] = 0.f; out_se[row + w] = 0.f;
      out_sed[row + w] = 0.f; out_sed2[row + w] = 0.f;
    }
    return;
  }
  if (in_row && !active) {
    out_m[row + w] = 0.f; out_se[row + w] = 0.f;
    out_sed[row + w] = 0.f; out_sed2[row + w] = 0.f;
  }

  // Stage the key window (coalesced rows of C channels), its mask as one
  // bit per key slot, and the queries.
  const size_t plane = (size_t)H * W;
  const size_t feat_row = (size_t)b * C * plane + (size_t)h * W;
  const int k0 = w0 - (D - 1);       // column of key slot 0
  for (int j = tid; j < n_words * 32; j += kTQ) {      // warp-uniform trips
    const int col = k0 + j;
    const bool ok = j < KW && col >= 0 && col < W && tar_mask[row + col] != 0.f;
    const unsigned bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) key_bits[j >> 5] = bits;
  }
  for (int c = 0; c < C; ++c) {
    const T* src = tar + feat_row + (size_t)c * plane;
    for (int j = tid; j < KW; j += kTQ) {
      const int col = k0 + j;
      k_s[c * KW + j] = (col >= 0 && col < W) ? to_f32(src[col]) : 0.f;
    }
    q_s[c * kTQ + tid] =
        in_row ? to_f32(ref[feat_row + (size_t)c * plane + w]) : 0.f;
  }
  // Queue the active queries, in column order, so that whole warps walk
  // bands and idle lanes do not ride along.
  const unsigned act = __ballot_sync(0xffffffffu, active);
  if (lane == 0) warp_count[wid] = __popc(act);
  __syncthreads();
  int base = 0, n_active = 0;
  for (int i = 0; i < kTQ / 32; ++i) {
    base += i < wid ? warp_count[i] : 0;
    n_active += warp_count[i];
  }
  if (active) queue[base + __popc(act & ((1u << lane) - 1u))] = tid;
  __syncthreads();
  if (tid >= n_active) return;

  const int qt = queue[tid];          // this thread's query column in the tile
  const int qw = w0 + qt;
  const float cen = window > 0 ? center[row + qw] : 0.f;
  const float win = (float)window;
  const int hi = qt + D - 1;          // key slot of d = 0
  const int lo = qt + D - min(D, qw + 1);  // slot of the largest d in the image
  float m = kNeg, se = 0.f, sed = 0.f, sed2 = 0.f;
  // Visit only the set bits of the band, highest slot first: d ascending,
  // the order of the plain version's loop.
  for (int wi = hi >> 5; wi >= (lo >> 5); --wi) {
    const int s0 = wi << 5;
    unsigned bits = key_bits[wi];
    if (hi - s0 < 31) bits &= (2u << (hi - s0)) - 1u;
    if (lo > s0) bits &= ~((1u << (lo - s0)) - 1u);
    while (bits) {
      const int bit = 31 - __clz(bits);
      bits &= ~(1u << bit);
      const int j = s0 + bit;
      const float fd = (float)(hi - j);
      if (window > 0 && fabsf(fd - cen) > win) continue;
      float s = 0.f;
      for (int c = 0; c < C; ++c)
        s = fmaf(q_s[c * kTQ + qt], k_s[c * KW + j], s);
      if (s > m) {                    // new max: rescale what was summed
        const float sc = expf(m - s);
        se = se * sc + 1.f;
        sed = sed * sc + fd;
        sed2 = sed2 * sc + fd * fd;
        m = s;
      } else {
        const float e = expf(s - m);
        se += e;
        sed += e * fd;
        sed2 += e * fd * fd;
      }
    }
  }
  const float m_c = fmaxf(m, kEps);  // the reference's max-cost floor
  const float r = expf(m - m_c);
  out_m[row + qw] = m_c;
  out_se[row + qw] = se * r;
  out_sed[row + qw] = sed * r;
  out_sed2[row + qw] = sed2 * r;
}

template <typename T>
int launch(const void* ref, const void* tar, const void* ref_mask,
           const void* tar_mask, const void* center, void* m, void* se,
           void* sed, void* sed2, int B, int C, int H, int W, int D,
           int window, cudaStream_t stream) {
  const size_t kw = kTQ + D - 1;
  const size_t smem = sizeof(float) * (C * (kw + kTQ))       // keys, queries
                      + sizeof(unsigned) * ((kw + 31) / 32)  // key mask bits
                      + sizeof(int) * kTQ;                   // query queue
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        moments_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + kTQ - 1) / kTQ, H, B);
  moments_kernel<T><<<grid, kTQ, smem, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(tar),
      static_cast<const float*>(ref_mask), static_cast<const float*>(tar_mask),
      static_cast<const float*>(center), static_cast<float*>(m),
      static_cast<float*>(se), static_cast<float*>(sed),
      static_cast<float*>(sed2), C, H, W, D, window);
  return (int)cudaGetLastError();
}

}  // namespace

// ref/tar (B,C,H,W) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// ref_mask/tar_mask (B,H,W) f32; center (B,H,W) f32, read only when
// window > 0; m/se/sed/sed2 (B,H,W) f32 outputs.  Returns a cudaError_t.
extern "C" int spamat_moments(const void* ref, const void* tar,
                              const void* ref_mask, const void* tar_mask,
                              const void* center, void* m, void* se,
                              void* sed, void* sed2, int B, int C, int H,
                              int W, int max_disp, int window, int is_bf16,
                              void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || max_disp <= 0 || window < 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(ref, tar, ref_mask, tar_mask, center, m, se,
                                 sed, sed2, B, C, H, W, max_disp, window, s);
  return launch<float>(ref, tar, ref_mask, tar_mask, center, m, se, sed, sed2,
                       B, C, H, W, max_disp, window, s);
}
