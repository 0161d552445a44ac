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
// s(q,k) = sum_c ref[c,q] * tar[c,k] in f32 and
// e = exp(min(s - max_cost[q], 0)):
//   grad_ref[q] = sum_k e * (d - out[q]) * w[q] * tar[k],
// zero at inactive queries (w == 0).
//
// NaN safety.  A pair is gated by the query weight, the key mask and the
// window BEFORE the exp, never by multiplying afterwards: a masked-out key
// may outscore max_cost (it took no part in the forward max), and a query
// with ref_mask == 0 has max_cost == 0, so exp could overflow to inf and
// inf * 0 is NaN.  A query with no candidate has w = 1e6 * g but visits no
// pair.  Within the gate, the chunk lanes sum a score in another order than
// the forward's fmaf chain, so it may exceed max_cost by a few ulps: the
// exponent is clamped at 0 (e <= 1), as in dTar.
//
// Bound on this card: bytes.  At the training stage-3 shape (B = 8, C = 8,
// 162x486, D = 216, bf16 features) the kernel reads both feature maps and
// four f32 maps and writes one bf16 gradient once: ~40 MB, ~12 us at
// 3.35 TB/s; the 4C + ~8 flops of the candidate pairs that ~20%-dense masks
// leave are a few times fewer.
//
// Design: dTar's (spamat_dtar.cu) with the sides swapped, tiled as the
// moments kernel is.
//   * A block owns `tile` query columns of one (b, h) row, [q0, q1), and
//     the key window [max(0, q0 - D + 1), q1): a whole row when the rows
//     fill the card (ops/kernels/spamat.py::dref_plan).
//   * 16-byte cp.async copies (staging.cuh) of the key mask and the query
//     maps (w, max_cost, out, and center when windowed) in one group, of
//     both feature rows in a second.  While the features arrive, the set
//     keys are compacted in slot order -- a query's candidates are then one
//     run of that list -- and the active queries (w != 0) are queued.  The
//     set keys' features are then copied slot-major, 8 channels per vector.
//   * A group of `lanes` lanes owns one active query: NL chunk lanes (each
//     holds 8 of the C channels of the query and of its gradient sums in
//     registers; NL = 1, 4, 16 for the instances C <= 8, 24, 72) times
//     candidate lanes (a power of two near D / 32 that fits the warp), each
//     taking every few-th candidate of the run.  The chunk lanes of a
//     candidate add their partial scores by shuffles; at the end the
//     candidate lanes add their gradient sums.  No lane holds more than 16
//     floats of a query, at any C.
//   * The gradient tile takes the place of the staged query rows (a
//     query's group reads its 8-channel slices before it writes them back)
//     and leaves in coalesced rows, with zeros at the inactive queries.  (A
//     write-back by 16-byte vectors, after zeroing the inactive queries in
//     the tile, was slower; PERF.md has the times.)
// phases(spamat_dref): issue maps queue features transpose walk stores
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
using staging::Vec8;

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Lanes per query for the instance of NL chunk lanes: NL times a power of
// two of candidate lanes near D / 32 (so each walks a few candidates), at
// most a warp; ops/kernels/spamat.py::dref_lanes computes the same.
inline int lanes_for(int nl, int D) {
  int gc = 1;
  while (gc * nl < 32 && gc * 32 < D) gc *= 2;
  return gc * nl;
}

// Dynamic shared memory of one block, in the order the kernel carves it;
// ops/kernels/spamat.py::dref_plan computes the same sum.
template <typename T>
size_t smem_bytes(int C, long long hw, int tile, int span) {
  constexpr int GE = staging::kGranBytes / (int)sizeof(T);
  const int cp = (C + 7) / 8 * 8;
  return align16(sizeof(T) * C * row_stride(tile, GE, hw))    // queries
         + align16(sizeof(T) * C * row_stride(span, GE, hw))  // keys
         + align16(sizeof(T) * cp * span)              // set keys, by slot
         + align16(4 * row_stride(span, kMapGE, 0))           // tar_mask
         + 4 * align16(4 * row_stride(tile, kMapGE, 0))   // the 4 query maps
         + align16(4 * (span + 1))                        // key positions
         + align16(4 * span)                              // set key slots
         + align16(4 * tile);                             // query queue
}

template <typename T, int NL>
__global__ void __launch_bounds__(kMaxThreads)
dref_kernel(const T* __restrict__ ref, const T* __restrict__ tar,
            const float* __restrict__ tar_mask,
            const float* __restrict__ max_cost,
            const float* __restrict__ out, const float* __restrict__ wq,
            const float* __restrict__ center, T* __restrict__ gref,
            int C, int H, int W, int D, int window, int tile, int span,
            int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_count[2 * 32];
  constexpr int GE = staging::kGranBytes / (int)sizeof(T);
  const long long hw = (long long)H * W;
  const int nch = (C + 7) / 8, cp = nch * 8;
  const int qs = row_stride(tile, GE, hw), ks = row_stride(span, GE, hw);
  const int ms = row_stride(tile, kMapGE, 0);
  const int kms = row_stride(span, kMapGE, 0);
  unsigned char* p = smem;
  T* q_s = reinterpret_cast<T*>(p);           p += align16(sizeof(T) * C * qs);
  T* k_s = reinterpret_cast<T*>(p);           p += align16(sizeof(T) * C * ks);
  T* kc_s = reinterpret_cast<T*>(p);          // set keys, slot-major
  p += align16(sizeof(T) * cp * span);
  float* tm_s = reinterpret_cast<float*>(p);  p += align16(4 * kms);
  float* w_s = reinterpret_cast<float*>(p);   p += align16(4 * ms);
  float* mc_s = reinterpret_cast<float*>(p);  p += align16(4 * ms);
  float* out_s = reinterpret_cast<float*>(p); p += align16(4 * ms);
  float* cen_s = reinterpret_cast<float*>(p); p += align16(4 * ms);
  int* key_pos = reinterpret_cast<int*>(p);   p += align16(4 * (span + 1));
  int* key_slot = reinterpret_cast<int*>(p);  p += align16(4 * span);
  int* queue = reinterpret_cast<int*>(p);

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * tile, q1 = min(q0 + tile, W);
  const int kc0 = max(0, q0 - D + 1);            // column of key slot 0
  const int nq = q1 - q0, nk = q1 - kc0;
  const long long mrow = ((long long)b * H + h) * W;      // (B,H,W) maps
  const long long frow = (long long)b * C * hw + (long long)h * W;
  const long long n_maps = (long long)gridDim.z * hw;
  DECNET_STAMP(0);

  // Every copy in flight: the key mask and the query maps, then the
  // features.
  staging::stage_rows(tm_s, kms, tar_mask, mrow, 0, n_maps, 1, kc0, q1);
  staging::stage_rows(w_s, ms, wq, mrow, 0, n_maps, 1, q0, q1);
  staging::stage_rows(mc_s, ms, max_cost, mrow, 0, n_maps, 1, q0, q1);
  staging::stage_rows(out_s, ms, out, mrow, 0, n_maps, 1, q0, q1);
  if (window > 0)
    staging::stage_rows(cen_s, ms, center, mrow, 0, n_maps, 1, q0, q1);
  staging::cp_async_commit();
  staging::stage_rows(q_s, qs, ref, frow, hw, n_maps * C, C, q0, q1);
  staging::stage_rows(k_s, ks, tar, frow, hw, n_maps * C, C, kc0, q1);
  staging::cp_async_commit();
  DECNET_STAMP_SYNC(1);
  staging::cp_async_wait<1>();
  __syncthreads();
  DECNET_STAMP(2);

  // While the features arrive: the set keys compacted in slot order (a
  // query's candidates are then one run of that list), the active queries
  // queued in column order.
  const int m_l = stage_lead<float>(mrow, q0);
  const int tm_l = stage_lead<float>(mrow, kc0);
  const staging::Counts n = staging::compact_slots(
      key_slot, key_pos, nk, [&](int j) { return tm_s[tm_l + j] != 0.f; },
      queue, nq, [&](int j) { return w_s[m_l + j] != 0.f; }, warp_count);
  const int n_keys = n.a, n_active = n.b;
  DECNET_STAMP(3);
  staging::cp_async_wait<0>();
  __syncthreads();
  DECNET_STAMP(4);
  // The set keys slot-major: a lane reads its 8 channels of a pair as one
  // vector.
  staging::gather_slot_major(kc_s, k_s, ks, stage_lead<T>(frow, kc0), C,
                             key_slot, n_keys);
  __syncthreads();
  DECNET_STAMP(5);

  // A group of `lanes` lanes per active query: NL chunk lanes (lane owns
  // channels 8 ch .. 8 ch + 7) times `lanes / NL` candidate lanes, each of
  // which takes every (lanes / NL)-th candidate of the query's run.  The
  // chunk lanes of a candidate add their partial scores; at the end the
  // candidate lanes add their gradient sums.  Every loop that holds a
  // shuffle runs the same number of times in all lanes of a warp (the
  // groups of a warp walk as many rounds as the longest run needs), so each
  // shuffle is one converged, full-warp exchange.
  T* qf = q_s + stage_lead<T>(frow, q0);       // (c, slot) at c * qs + slot
  const int gc = lanes / NL;
  const int lane = threadIdx.x & 31, sub = lane & (lanes - 1);
  const int ch = sub & (NL - 1), ci = sub / NL;
  const int n_groups = blockDim.x / lanes, group = threadIdx.x / lanes;
  const bool has = ch < nch;                     // lane owns a chunk
  const float win = (float)window;
  for (int i0 = 0; i0 < n_active; i0 += n_groups) {
    const bool act = i0 + group < n_active;
    const int qt = act ? queue[i0 + group] : 0;  // query slot
    const int qw = q0 + qt;
    float qv[8], acc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = ch * 8 + u;
      qv[u] = act && has && c < C ? to_f32(qf[c * qs + qt]) : 0.f;
      acc[u] = 0.f;
    }
    const int j = m_l + qt;
    const float mc = mc_s[j], o = out_s[j], wv = w_s[j];
    const float cen = window > 0 ? cen_s[j] : 0.f;
    // candidates: the set keys of slots lo .. hi (d = hi - slot)
    const int hi = qw - kc0;                     // key slot of d = 0
    const int lo = max(qw - D + 1, 0) - kc0;     // slot of the largest d
    const int t0 = act ? key_pos[lo] : 0;
    const int t1 = act ? key_pos[hi + 1] : 0;
    const int rounds =
        __reduce_max_sync(0xffffffffu, (t1 - t0 + gc - 1) / gc);
    for (int r = 0; r < rounds; ++r) {
      const int t = t0 + ci + r * gc;
      bool valid = t < t1;
      const float fd = valid ? (float)(hi - key_slot[t]) : 0.f;
      if (window > 0 && fabsf(fd - cen) > win) valid = false;
      Vec8<T> k;
      float s = 0.f;
      if (valid && has) {
        k = *reinterpret_cast<const Vec8<T>*>(kc_s + (size_t)t * cp + ch * 8);
#pragma unroll
        for (int u = 0; u < 8; ++u) s = fmaf(qv[u], to_f32(k.v[u]), s);
      }
#pragma unroll
      for (int off = NL >> 1; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (valid && has) {
        const float coef = expf(fminf(s - mc, 0.f)) * (fd - o) * wv;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          acc[u] = fmaf(coef, to_f32(k.v[u]), acc[u]);
      }
    }
    for (int off = NL; off < lanes; off <<= 1)
#pragma unroll
      for (int u = 0; u < 8; ++u)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
    if (act && ci == 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = ch * 8 + u;
        if (has && c < C) from_f32(qf + c * qs + qt, acc[u]);
      }
    }
  }
  __syncthreads();
  DECNET_STAMP(6);
  for (int j = threadIdx.x; j < nq; j += blockDim.x) {
    const bool act = w_s[m_l + j] != 0.f;        // inactive queries: zero
    for (int c = 0; c < C; ++c)
      gref[frow + c * hw + q0 + j] = act ? qf[c * qs + j] : T(0.f);
  }
  DECNET_STAMP_SYNC(7);
}

template <typename T, int NL>
int launch_nl(const void* ref, const void* tar, const void* tar_mask,
              const void* max_cost, const void* out, const void* w,
              const void* center, void* grad, int B, int C, int H, int W,
              int D, int window, int tile, int span, int threads, int lanes,
              int smem, cudaStream_t stream) {
  if (lanes != lanes_for(NL, D)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dref_kernel<T, NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + tile - 1) / tile, H, B);
  dref_kernel<T, NL><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(tar),
      static_cast<const float*>(tar_mask), static_cast<const float*>(max_cost),
      static_cast<const float*>(out), static_cast<const float*>(w),
      static_cast<const float*>(center), static_cast<T*>(grad), C, H, W, D,
      window, tile, span, lanes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* ref, const void* tar, const void* tar_mask,
           const void* max_cost, const void* out, const void* w,
           const void* center, void* grad, int B, int C, int H, int W, int D,
           int window, int tile, int span, int threads, int lanes, int smem,
           cudaStream_t stream) {
  // The plan's numbers, checked against what this kernel needs.
  if (tile < 1 || span != min(tile + D - 1, W) || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (size_t)smem != smem_bytes<T>(C, (long long)H * W, tile, span) ||
      smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  // one instance per model stage: C <= 8, 24, 72 (1, 4, 16 chunk lanes)
#define DECNET_DREF_NL(CT, NL)                                              \
  if (C <= CT)                                                              \
    return launch_nl<T, NL>(ref, tar, tar_mask, max_cost, out, w, center,   \
                            grad, B, C, H, W, D, window, tile, span,        \
                            threads, lanes, smem, stream);
  DECNET_DREF_NL(8, 1)
  DECNET_DREF_NL(24, 4)
  DECNET_DREF_NL(72, 16)
#undef DECNET_DREF_NL
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ref/tar and grad_ref (B,C,H,W) contiguous, f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1), C <= 72; tar_mask, max_cost, out, w (B,H,W) f32; center
// (B,H,W) f32, read only when window > 0.  tile, span, threads, lanes and
// smem are dref_plan's.  grad_ref is zero at queries with w == 0.  Returns
// a cudaError_t.
extern "C" int spamat_dref(const void* ref, const void* tar,
                           const void* tar_mask, const void* max_cost,
                           const void* out, const void* w, const void* center,
                           void* grad_ref, int B, int C, int H, int W,
                           int max_disp, int window, int is_bf16, int tile,
                           int span, int threads, int lanes, int smem,
                           void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || max_disp <= 0 || window < 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(ref, tar, tar_mask, max_cost, out, w, center,
                                 grad_ref, B, C, H, W, max_disp, window, tile,
                                 span, threads, lanes, smem, s);
  return launch<float>(ref, tar, tar_mask, max_cost, out, w, center, grad_ref,
                       B, C, H, W, max_disp, window, tile, span, threads,
                       lanes, smem, s);
}
