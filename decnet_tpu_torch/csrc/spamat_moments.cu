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
// output exactly 1.0); an inactive query gets zeros (every consumer gates
// by ref_mask).
//
// Bound on this card: bytes.  At the stage-3 shape (C = 8, 540x972,
// D = 216, bf16) one read of both feature maps and masks and one write of
// the four f32 maps is ~29 MB, ~9 us at 3.35 TB/s, while the score FMAs of
// the candidates that ~20%-dense masks leave are under 0.1 GFLOP.
//
// Design.  A block's time goes to staging its rows and to walking the
// candidate pairs; `python -m decnet_tpu_torch.cli.phase_split` splits it
// by phase (PERF.md).  So:
//   * A block owns `tile` query columns of one (b, h) row, [q0, q1), and
//     the key window [max(0, q0 - D + 1), q1) -- the whole row when the
//     row count fills the card, so each byte is read once; the plan
//     (ops/kernels/spamat.py::moments_plan) splits rows into segments only
//     when B*H is too small for two blocks per SM, or when a row does not
//     fit its shared-memory budget.
//   * Every staging copy is a 16-byte cp.async (staging.cuh), all in
//     flight before the first wait: the masks in one group, the features
//     in a second, so the key list and the query queue are built from the
//     masks while the features are still arriving.  Features stay in their
//     own type in shared memory and are converted on use (exact).
//   * The set keys are compacted in slot order, so a query's candidates
//     are one run of that list, and copied slot-major (8 channels in one
//     16-byte vector).  A group of `lanes` lanes (a power of two near
//     D / 32) takes one active query: the query's features sit in
//     registers, each lane takes every lanes-th candidate of the run with
//     its own online softmax, and the group merges the lanes' (max, sums)
//     by shuffles.  Lanes of a group read consecutive keys, so the vector
//     loads do not collide in the banks.
//   * Each score is an fmaf chain over c ascending from 0 on exactly
//     converted values (zero channels pad C to a multiple of 8 and add
//     nothing), and the merged max is exact.  The sums are taken in
//     another order than the plain version's loop over d, which moves
//     them by a few ulps.  (dRef and dTar sum their scores in chunk
//     lanes, in another order, and clamp their exponents at 0.)
//   * The query's registers need a compile-time chunk count: one instance
//     for C <= 8, 24 and 72 (the model's stages); a wider C is refused.
// Tensor cores are not used: with ~20% x 20% masks a dense score tile does
// ~25x the needed pairs, and its exps alone cost more than the bytes bound.
// phases(spamat_moments): issue masks queue features transpose walk
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
constexpr float kEps = 1e-6f;
constexpr float kNeg = -3.0e38f;    // the JAX package's _NEG

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Lanes per query: a power of two near D / 32, so that each lane walks a
// few candidates of ~20%-dense masks before the lanes' sums are merged.
inline int lanes_for(int D) {
  int g = 1;
  while (g < 32 && g * 32 < D) g *= 2;
  return g;
}

// Dynamic shared memory of one block, in the order the kernel carves it;
// ops/kernels/spamat.py::moments_plan computes the same sum.
template <typename T>
size_t smem_bytes(int C, long long hw, int tile, int span) {
  constexpr int GE = staging::kGranBytes / (int)sizeof(T);
  const int cp = (C + 7) / 8 * 8;
  return align16(sizeof(T) * C * row_stride(tile, GE, hw))    // queries
         + align16(sizeof(T) * C * row_stride(span, GE, hw))  // keys
         + align16(sizeof(T) * cp * span)              // set keys, by slot
         + 2 * align16(4 * row_stride(tile, kMapGE, 0))   // ref_mask, center
         + align16(4 * row_stride(span, kMapGE, 0))       // tar_mask
         + align16(4 * (span + 1))                        // key positions
         + align16(4 * span)                              // set key slots
         + align16(4 * tile);                             // query queue
}

template <typename T, int NCH>
__global__ void __launch_bounds__(kMaxThreads)
moments_kernel(const T* __restrict__ ref, const T* __restrict__ tar,
               const float* __restrict__ ref_mask,
               const float* __restrict__ tar_mask,
               const float* __restrict__ center,
               float* __restrict__ out_m, float* __restrict__ out_se,
               float* __restrict__ out_sed, float* __restrict__ out_sed2,
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
  T* q_s = reinterpret_cast<T*>(p);        p += align16(sizeof(T) * C * qs);
  T* k_s = reinterpret_cast<T*>(p);        p += align16(sizeof(T) * C * ks);
  T* kc_s = reinterpret_cast<T*>(p);       p += align16(sizeof(T) * cp * span);
  float* rm_s = reinterpret_cast<float*>(p);  p += align16(4 * ms);
  float* cen_s = reinterpret_cast<float*>(p); p += align16(4 * ms);
  float* tm_s = reinterpret_cast<float*>(p);  p += align16(4 * kms);
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

  // Every copy in flight: the masks (and center), then the features.
  staging::stage_rows(rm_s, ms, ref_mask, mrow, 0, n_maps, 1, q0, q1);
  staging::stage_rows(tm_s, kms, tar_mask, mrow, 0, n_maps, 1, kc0, q1);
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
  // queued in column order, zeros for the inactive ones.
  const int rm_l = stage_lead<float>(mrow, q0);
  const int tm_l = stage_lead<float>(mrow, kc0);
  const staging::Counts n = staging::compact_slots(
      key_slot, key_pos, nk, [&](int j) { return tm_s[tm_l + j] != 0.f; },
      queue, nq, [&](int j) { return rm_s[rm_l + j] != 0.f; }, warp_count);
  const int n_keys = n.a, n_active = n.b;
  for (int j = threadIdx.x; j < nq; j += blockDim.x)
    if (rm_s[rm_l + j] == 0.f) {
      out_m[mrow + q0 + j] = 0.f; out_se[mrow + q0 + j] = 0.f;
      out_sed[mrow + q0 + j] = 0.f; out_sed2[mrow + q0 + j] = 0.f;
    }
  DECNET_STAMP(3);
  staging::cp_async_wait<0>();
  __syncthreads();
  DECNET_STAMP(4);
  // The set keys slot-major: a pair reads 8 channels as one vector.
  staging::gather_slot_major(kc_s, k_s, ks, stage_lead<T>(frow, kc0), C,
                             key_slot, n_keys);
  __syncthreads();
  DECNET_STAMP(5);

  // A group of `lanes` lanes per query; lane `sub` takes every lanes-th
  // candidate of the query's run, keeps its own online softmax (d
  // descending), and the group merges the lanes' sums at the end.  All
  // groups of the block walk the same number of rounds, so the merge's
  // shuffles are converged, full-warp exchanges.
  const T* qf = q_s + stage_lead<T>(frow, q0);   // (c, slot) at c * qs + slot
  const int sub = threadIdx.x & (lanes - 1);
  const int n_groups = blockDim.x / lanes, group = threadIdx.x / lanes;
  const float win = (float)window;
  for (int i0 = 0; i0 < n_active; i0 += n_groups) {
    const bool act = i0 + group < n_active;
    const int qt = act ? queue[i0 + group] : 0;  // query slot
    const int qw = q0 + qt;
    const float cen = window > 0 ? cen_s[rm_l + qt] : 0.f;
    Vec8<T> q[NCH];                            // zero past C
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = ch * 8 + u;
        q[ch].v[u] = c < C ? qf[c * qs + qt] : T(0.f);
      }
    const int hi = qw - kc0;                   // key slot of d = 0
    const int lo = max(qw - D + 1, 0) - kc0;   // slot of the largest d
    const int t_end = act ? key_pos[hi + 1] : 0;
    float m = kNeg, se = 0.f, sed = 0.f, sed2 = 0.f;
    for (int t = key_pos[lo] + sub; t < t_end; t += lanes) {
      const float fd = (float)(hi - key_slot[t]);
      if (window > 0 && fabsf(fd - cen) > win) continue;
      // fmaf over c ascending from 0; the zero channels past C add
      // exactly nothing
      const T* kr = kc_s + (size_t)t * cp;
      float s = 0.f;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        if (ch < nch) {
          const Vec8<T> k = *reinterpret_cast<const Vec8<T>*>(kr + ch * 8);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            s = fmaf(to_f32(q[ch].v[u]), to_f32(k.v[u]), s);
        }
      }
      if (s > m) {                  // new max: rescale what was summed
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
    // Merge the lanes' (max, sums): every lane ends with the same values,
    // the max exact.
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float se2 = __shfl_xor_sync(0xffffffffu, se, off);
      const float sed_2 = __shfl_xor_sync(0xffffffffu, sed, off);
      const float sed2_2 = __shfl_xor_sync(0xffffffffu, sed2, off);
      const float mn = fmaxf(m, m2);
      const float e1 = expf(m - mn), e2 = expf(m2 - mn);
      se = se * e1 + se2 * e2;
      sed = sed * e1 + sed_2 * e2;
      sed2 = sed2 * e1 + sed2_2 * e2;
      m = mn;
    }
    if (act && sub == 0) {
      const float m_c = fmaxf(m, kEps);  // the reference's max-cost floor
      const float r = expf(m - m_c);
      out_m[mrow + qw] = m_c;
      out_se[mrow + qw] = se * r;
      out_sed[mrow + qw] = sed * r;
      out_sed2[mrow + qw] = sed2 * r;
    }
  }
  DECNET_STAMP_SYNC(6);
}

template <typename T, int NCH>
int launch_nch(const void* ref, const void* tar, const void* ref_mask,
               const void* tar_mask, const void* center, void* m, void* se,
               void* sed, void* sed2, int B, int C, int H, int W, int D,
               int window, int tile, int span, int threads, int lanes,
               int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        moments_kernel<T, NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + tile - 1) / tile, H, B);
  moments_kernel<T, NCH><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(tar),
      static_cast<const float*>(ref_mask), static_cast<const float*>(tar_mask),
      static_cast<const float*>(center), static_cast<float*>(m),
      static_cast<float*>(se), static_cast<float*>(sed),
      static_cast<float*>(sed2), C, H, W, D, window, tile, span, lanes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* ref, const void* tar, const void* ref_mask,
           const void* tar_mask, const void* center, void* m, void* se,
           void* sed, void* sed2, int B, int C, int H, int W, int D,
           int window, int tile, int span, int threads, int lanes, int smem,
           cudaStream_t stream) {
  // The plan's numbers, checked against what this kernel needs.
  if (tile < 1 || span != min(tile + D - 1, W) || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || lanes != lanes_for(D) ||
      (size_t)smem != smem_bytes<T>(C, (long long)H * W, tile, span) ||
      smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  // one instance per model stage's chunk count: C = 8, 24, 72
#define DECNET_MOMENTS_NCH(N)                                                \
  if (C <= 8 * N)                                                            \
    return launch_nch<T, N>(ref, tar, ref_mask, tar_mask, center, m, se, sed, \
                            sed2, B, C, H, W, D, window, tile, span, threads, \
                            lanes, smem, stream);
  DECNET_MOMENTS_NCH(1)
  DECNET_MOMENTS_NCH(3)
  DECNET_MOMENTS_NCH(9)
#undef DECNET_MOMENTS_NCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ref/tar (B,C,H,W) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// C <= 72; ref_mask/tar_mask (B,H,W) f32; center (B,H,W) f32, read only
// when window > 0; m/se/sed/sed2 (B,H,W) f32 outputs.  tile, span,
// threads, lanes and smem are moments_plan's.  Returns a cudaError_t.
extern "C" int spamat_moments(const void* ref, const void* tar,
                              const void* ref_mask, const void* tar_mask,
                              const void* center, void* m, void* se,
                              void* sed, void* sed2, int B, int C, int H,
                              int W, int max_disp, int window, int is_bf16,
                              int tile, int span, int threads, int lanes,
                              int smem, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || max_disp <= 0 || window < 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(ref, tar, ref_mask, tar_mask, center, m, se,
                                 sed, sed2, B, C, H, W, max_disp, window, tile,
                                 span, threads, lanes, smem, s);
  return launch<float>(ref, tar, ref_mask, tar_mask, center, m, se, sed, sed2,
                       B, C, H, W, max_disp, window, tile, span, threads,
                       lanes, smem, s);
}
