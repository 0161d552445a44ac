// Gradient of the key features of sparse stereo matching (dTar), for Hopper.
//
// Replaces: decnet_tpu/ops/pallas/spamat.py::_dtar_kernel (launched by
// _spamat_backward_rows_impl), half of the backward of the fused matching
// + variance op on the three fine stages of DecNet in training.  Its twin
// dRef is in spamat_backward.cu.
//
// With w[q] = g[q] / sum_sim[q] on queries with ref_mask != 0 (0 elsewhere;
// the wrapper computes it), and for every candidate pair of the forward --
// key k = q - d, d in [0, D), k >= 0, tar_mask[k] != 0, and
// |d - center[q]| <= window when window > 0 -- the score
// s(q,k) = sum_c ref[c,q] * tar[c,k] in f32 and
// e = exp(min(s - max_cost[q], 0)):
//   grad_tar[k] = sum_q e * (d - out[q]) * w[q] * ref[q],
// zero at masked-out keys (and at keys no active query reaches).
//
// NaN safety.  A pair is gated by the query weight and the key mask BEFORE
// the exp: a masked-out key may outscore max_cost (it took no part in the
// forward max), and a query with ref_mask == 0 has max_cost == 0, so exp
// could overflow to inf and inf * 0 is NaN.  Within the gate, a score
// summed in another order than the forward's may exceed max_cost by a few
// ulps, so the exponent is clamped at 0 (e <= 1).
//
// Bound on this card: bytes.  At the training stage-3 shape (B = 8, C = 8,
// 162x486, D = 216, bf16 features) the kernel reads both feature maps and
// four f32 maps and writes one bf16 gradient once: ~40 MB, ~12 us at
// 3.35 TB/s; the 4C + ~8 flops of the candidate pairs that ~20%-dense masks
// leave are a few times fewer.
//
// Design: the gather form (every output written by one lane, no atomics,
// deterministic results), staged like the moments kernel.
//   * A block owns `tile` key columns of one (b, h) row, [k0, k1), and the
//     query window [k0, min(k1 + D - 1, W)): a whole row when the rows fill
//     the card (ops/kernels/spamat.py::dtar_plan).
//   * 16-byte cp.async copies (staging.cuh) of the key mask and the four
//     per-query maps (max_cost, out, w, center) in one group, of both
//     feature rows in a second.  While the features arrive, the active
//     queries (w != 0) are compacted in slot order -- a key's candidates
//     are then one run of that list -- with their four maps packed in one
//     16-byte vector each, and the unmasked keys are queued.  The active
//     queries' features are then copied slot-major, 8 channels per vector.
//   * A group of `lanes` lanes owns one key: chunk lanes (each holds 8 of
//     the C channels of the key and of its gradient sums in registers: 1
//     at C = 8, 4 at C = 24, 16 at C = 72) times candidate lanes (a power
//     of two near D / 32 that fits the warp), each taking every few-th
//     candidate of the run.  The chunk lanes of a candidate add their
//     partial scores by shuffles; at the end the candidate lanes add their
//     gradient sums.  No lane holds more than 16 floats of a key, at any
//     C, and the lanes of a group stay busy however uneven the masks are
//     (PERF.md has the per-block phase split, `cli/phase_split.py`).
//   * The gradient tile takes the place of the keys' staged rows (a key's
//     group reads its 8-channel slices before it writes them back) and
//     leaves in coalesced rows, with zeros at the masked keys.
// phases(spamat_dtar): issue maps queue features transpose walk stores
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

// Lanes per key: a power of two that leaves each lane one chunk of 8
// channels, times a power of two of candidate lanes near D / 32 (so each
// walks a few candidates); at most a warp (0 when C needs more).
__host__ __device__ inline int chunk_lanes(int C) {
  int g = 1;
  while (g * 8 < C) g *= 2;
  return g;
}
inline int lanes_for(int C, int D) {
  int gc = 1;
  while (gc * chunk_lanes(C) < 32 && gc * 32 < D) gc *= 2;
  return chunk_lanes(C) <= 32 ? gc * chunk_lanes(C) : 0;
}

// Dynamic shared memory of one block, in the order the kernel carves it;
// ops/kernels/spamat.py::dtar_plan computes the same sum.
template <typename T>
size_t smem_bytes(int C, long long hw, int tile, int span) {
  constexpr int GE = staging::kGranBytes / (int)sizeof(T);
  const int cp = (C + 7) / 8 * 8;
  return align16(sizeof(T) * C * row_stride(tile, GE, hw))    // keys
         + align16(sizeof(T) * C * row_stride(span, GE, hw))  // queries
         + align16(sizeof(T) * cp * span)          // active queries, by slot
         + align16(4 * row_stride(tile, kMapGE, 0))           // tar_mask
         + 4 * align16(4 * row_stride(span, kMapGE, 0))   // the 4 query maps
         + align16(16 * span)                   // the 4, of active queries
         + align16(4 * (span + 1))                        // query positions
         + align16(4 * span)                              // active query slots
         + align16(4 * tile);                             // key queue
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
dtar_kernel(const T* __restrict__ tar, const T* __restrict__ ref,
            const float* __restrict__ tar_mask,
            const float* __restrict__ max_cost,
            const float* __restrict__ out, const float* __restrict__ wq,
            const float* __restrict__ center, T* __restrict__ gtar,
            int C, int H, int W, int D, int window, int tile, int span,
            int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_count[2 * 32];
  constexpr int GE = staging::kGranBytes / (int)sizeof(T);
  const long long hw = (long long)H * W;
  const int nch = (C + 7) / 8, cp = nch * 8;
  const int ks = row_stride(tile, GE, hw), qs = row_stride(span, GE, hw);
  const int ms = row_stride(tile, kMapGE, 0);
  const int qms = row_stride(span, kMapGE, 0);
  unsigned char* p = smem;
  T* k_s = reinterpret_cast<T*>(p);           p += align16(sizeof(T) * C * ks);
  T* q_s = reinterpret_cast<T*>(p);           p += align16(sizeof(T) * C * qs);
  T* qc_s = reinterpret_cast<T*>(p);          // active queries, slot-major
  p += align16(sizeof(T) * cp * span);
  float* tm_s = reinterpret_cast<float*>(p);  p += align16(4 * ms);
  float* mc_s = reinterpret_cast<float*>(p);  p += align16(4 * qms);
  float* out_s = reinterpret_cast<float*>(p); p += align16(4 * qms);
  float* w_s = reinterpret_cast<float*>(p);   p += align16(4 * qms);
  float* cen_s = reinterpret_cast<float*>(p); p += align16(4 * qms);
  float4* qm_s = reinterpret_cast<float4*>(p); p += align16(16 * span);
  int* q_pos = reinterpret_cast<int*>(p);     p += align16(4 * (span + 1));
  int* q_slot = reinterpret_cast<int*>(p);    p += align16(4 * span);
  int* queue = reinterpret_cast<int*>(p);

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * tile, k1 = min(k0 + tile, W);
  const int qe = min(k1 + D - 1, W);             // queries [k0, qe)
  const int nk = k1 - k0, nq = qe - k0;
  const long long mrow = ((long long)b * H + h) * W;
  const long long frow = (long long)b * C * hw + (long long)h * W;
  const long long n_maps = (long long)gridDim.z * hw;
  DECNET_STAMP(0);

  staging::stage_rows(tm_s, ms, tar_mask, mrow, 0, n_maps, 1, k0, k1);
  staging::stage_rows(mc_s, qms, max_cost, mrow, 0, n_maps, 1, k0, qe);
  staging::stage_rows(out_s, qms, out, mrow, 0, n_maps, 1, k0, qe);
  staging::stage_rows(w_s, qms, wq, mrow, 0, n_maps, 1, k0, qe);
  if (window > 0)
    staging::stage_rows(cen_s, qms, center, mrow, 0, n_maps, 1, k0, qe);
  staging::cp_async_commit();
  staging::stage_rows(k_s, ks, tar, frow, hw, n_maps * C, C, k0, k1);
  staging::stage_rows(q_s, qs, ref, frow, hw, n_maps * C, C, k0, qe);
  staging::cp_async_commit();
  DECNET_STAMP_SYNC(1);
  staging::cp_async_wait<1>();
  __syncthreads();
  DECNET_STAMP(2);

  // While the features arrive: the active queries (w != 0) compacted in
  // slot order (a key's candidates are then one run of that list) with
  // their four maps packed in one vector each, the unmasked keys queued in
  // order.
  const int m_l = stage_lead<float>(mrow, k0);    // every map's lead
  const staging::Counts n = staging::compact_slots(
      q_slot, q_pos, nq, [&](int j) { return w_s[m_l + j] != 0.f; },
      queue, nk, [&](int j) { return tm_s[m_l + j] != 0.f; }, warp_count);
  const int n_q = n.a, n_keys = n.b;
  for (int r = threadIdx.x; r < n_q; r += blockDim.x) {
    const int j = m_l + q_slot[r];
    qm_s[r] = make_float4(mc_s[j], out_s[j], w_s[j],
                          window > 0 ? cen_s[j] : 0.f);
  }
  DECNET_STAMP(3);
  staging::cp_async_wait<0>();
  __syncthreads();
  DECNET_STAMP(4);
  // The active queries slot-major: a lane reads its 8 channels of a pair
  // as one vector.
  const int k_l = stage_lead<T>(frow, k0);
  staging::gather_slot_major(qc_s, q_s, qs, stage_lead<T>(frow, k0), C,
                             q_slot, n_q);
  __syncthreads();
  DECNET_STAMP(5);

  // A group of `lanes` lanes per key: nl chunk lanes (lane owns channels
  // 8 ch .. 8 ch + 7) times `lanes / nl` candidate lanes, each of which
  // takes every (lanes / nl)-th candidate of the key's run.  The chunk
  // lanes of a candidate add their partial scores; at the end the
  // candidate lanes add their gradient sums.  Every loop that holds a
  // shuffle runs the same number of times in all lanes of a warp (the
  // groups of a warp walk as many rounds as the longest run needs), so
  // each shuffle is one converged, full-warp exchange.
  T* kf = k_s + k_l;                  // (c, slot) at c * ks + slot
  const int nl = chunk_lanes(C), gc = lanes / nl;
  const int lane = threadIdx.x & 31, sub = lane & (lanes - 1);
  const int ch = sub & (nl - 1), ci = sub / nl;
  const int n_groups = blockDim.x / lanes, group = threadIdx.x / lanes;
  const bool has = ch < nch;                      // lane owns a chunk
  const float win = (float)window;
  for (int i0 = 0; i0 < n_keys; i0 += n_groups) {
    const bool key = i0 + group < n_keys;
    const int kt = key ? queue[i0 + group] : 0;   // key slot
    float kv[8], acc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = ch * 8 + u;
      kv[u] = key && has && c < C ? to_f32(kf[c * ks + kt]) : 0.f;
      acc[u] = 0.f;
    }
    // candidates: the active queries of slots kt .. kt + min(D, W - kc) - 1
    const int t0 = key ? q_pos[kt] : 0;
    const int t1 = key ? q_pos[kt + min(D, W - k0 - kt)] : 0;
    const int rounds =
        __reduce_max_sync(0xffffffffu, (t1 - t0 + gc - 1) / gc);
    for (int r = 0; r < rounds; ++r) {
      const int t = t0 + ci + r * gc;
      bool valid = t < t1;
      const float4 mq = valid ? qm_s[t] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float fd = valid ? (float)(q_slot[t] - kt) : 0.f;
      if (window > 0 && fabsf(fd - mq.w) > win) valid = false;
      Vec8<T> q;
      float s = 0.f;
      if (valid && has) {
        q = *reinterpret_cast<const Vec8<T>*>(qc_s + (size_t)t * cp + ch * 8);
#pragma unroll
        for (int u = 0; u < 8; ++u) s = fmaf(to_f32(q.v[u]), kv[u], s);
      }
      for (int off = nl >> 1; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (valid && has) {
        const float coef = expf(fminf(s - mq.x, 0.f)) * (fd - mq.y) * mq.z;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          acc[u] = fmaf(coef, to_f32(q.v[u]), acc[u]);
      }
    }
    for (int off = nl; off < lanes; off <<= 1)
#pragma unroll
      for (int u = 0; u < 8; ++u)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
    if (key && ci == 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = ch * 8 + u;
        if (has && c < C) from_f32(kf + c * ks + kt, acc[u]);
      }
    }
  }
  __syncthreads();
  DECNET_STAMP(6);
  for (int j = threadIdx.x; j < nk; j += blockDim.x) {
    const bool key = tm_s[m_l + j] != 0.f;        // masked keys: zero
    for (int c = 0; c < C; ++c)
      gtar[frow + c * hw + k0 + j] = key ? kf[c * ks + j] : T(0.f);
  }
  DECNET_STAMP_SYNC(7);
}

template <typename T>
int launch(const void* tar, const void* ref, const void* tar_mask,
           const void* max_cost, const void* out, const void* w,
           const void* center, void* grad, int B, int C, int H, int W, int D,
           int window, int tile, int span, int threads, int lanes, int smem,
           cudaStream_t stream) {
  // The plan's numbers, checked against what this kernel needs.
  if (tile < 1 || span != min(tile + D - 1, W) || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      lanes != lanes_for(C, D) || lanes == 0 ||
      (size_t)smem != smem_bytes<T>(C, (long long)H * W, tile, span) ||
      smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dtar_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + tile - 1) / tile, H, B);
  dtar_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(tar), static_cast<const T*>(ref),
      static_cast<const float*>(tar_mask), static_cast<const float*>(max_cost),
      static_cast<const float*>(out), static_cast<const float*>(w),
      static_cast<const float*>(center), static_cast<T*>(grad), C, H, W, D,
      window, tile, span, lanes);
  return (int)cudaGetLastError();
}

}  // namespace

// tar/ref and grad_tar (B,C,H,W) contiguous, f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); tar_mask, max_cost, out, w (B,H,W) f32; center (B,H,W)
// f32, read only when window > 0.  tile, span, threads, lanes and smem are
// dtar_plan's.  grad_tar is zero at keys with tar_mask == 0.  Returns a
// cudaError_t.
extern "C" int spamat_dtar(const void* tar, const void* ref,
                           const void* tar_mask, const void* max_cost,
                           const void* out, const void* w, const void* center,
                           void* grad_tar, int B, int C, int H, int W,
                           int max_disp, int window, int is_bf16, int tile,
                           int span, int threads, int lanes, int smem,
                           void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || max_disp <= 0 || window < 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(tar, ref, tar_mask, max_cost, out, w, center,
                                 grad_tar, B, C, H, W, max_disp, window, tile,
                                 span, threads, lanes, smem, s);
  return launch<float>(tar, ref, tar_mask, max_cost, out, w, center, grad_tar,
                       B, C, H, W, max_disp, window, tile, span, threads,
                       lanes, smem, s);
}
