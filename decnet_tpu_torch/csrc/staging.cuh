// Staging of feature and map rows into shared memory with cp.async, shared
// by the moments, dRef, dTar and warp kernels.  The layout math is mirrored
// in Python (ops/kernels/staging.py: row_stride, stage_lead, stage_copies),
// where the CPU tests check it.
//
// A block copies columns [a, e) of `rows` rows of a tensor, row r starting
// at global element base0 + r * pitch (the C channel planes of one image
// row, or one row of a (B,H,W) map), in 16-byte granules: every copy is in
// flight before the block waits once for all of them.  The rows' pitch in
// bytes is never a multiple of 16 at the model's shapes (TMA needs that),
// and the window's first column is often odd, so a granule starts at the
// granule-aligned element at or below column a.  Each shared row therefore
// begins `lead` elements in (lead = GE + (base0 + a) mod GE, GE the
// granule's elements), and its stride is congruent to the pitch modulo GE,
// so that every granule lands granule-aligned in every row.  Column a + j
// of row r is at sm[r * stride + lead + j].  The elements a granule brings
// from outside [a, e) are never read.  A granule that would run past the
// tensor's end is copied element by element instead.  The tensors' data
// pointers are 16-byte aligned (the wrappers see to it).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace staging {

constexpr int kGranBytes = 16;
constexpr int kMapGE = kGranBytes / 4;   // a granule of an f32 map's row

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared elements per staged row of n columns in granules of ge elements.
__host__ __device__ inline int row_stride(int n, int ge, long long pitch) {
  return (n + 3 * ge + ge - 1) / ge * ge + (int)(pitch % ge);
}

template <typename T>
__host__ __device__ inline int stage_lead(long long base0, int a) {
  constexpr int GE = kGranBytes / (int)sizeof(T);
  return GE + (int)((base0 + a) % GE);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of columns [a, e) of `rows` rows (see above); every
// thread of the block calls it.  n_total is the tensor's element count.
template <typename T>
__device__ __forceinline__ void stage_rows(T* sm, int stride,
                                           const T* __restrict__ src,
                                           long long base0, long long pitch,
                                           long long n_total, int rows, int a,
                                           int e) {
  constexpr int GE = kGranBytes / (int)sizeof(T);
  if (e <= a) return;
  const int ng = (e - a + GE - 1) / GE + 1;   // granules a row touches, at most
  const int lead = stage_lead<T>(base0, a);
  for (int i = threadIdx.x; i < rows * ng; i += blockDim.x) {
    const int r = i / ng, g = i - r * ng;
    const long long start = base0 + r * pitch + a;   // element of column a
    const long long end = start + (e - a);
    const long long x = (start / GE + g) * GE;        // the granule's first
    if (x >= end) continue;
    T* dst = sm + (long long)r * stride + lead + (x - start);
    if (x + GE <= n_total) {
      cp_async16(dst, src + x);
    } else {
      for (long long y = x; y < end; ++y) dst[y - x] = src[y];
    }
  }
}

// Eight consecutive channels of one slot: 16 bytes in bf16, 32 in f32.
template <typename T>
struct alignas(16) Vec8 {
  T v[8];
};

// Gather the n slots slots[0..n) of C staged channel rows (column a + j of
// channel c at src[c * stride + lead + j]) slot-major and compacted:
// dst[r * cp + c] is channel c of slot slots[r], cp = C rounded up to a
// multiple of 8, zero for c >= C.  One thread per (slot, chunk of 8
// channels); each write is one vector.
template <typename T>
__device__ __forceinline__ void gather_slot_major(T* dst, const T* src,
                                                  int stride, int lead,
                                                  int C, const int* slots,
                                                  int n) {
  const int chunks = (C + 7) / 8;
  for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {
    const int ch = i / n, r = i - ch * n;
    const T* col = src + lead + slots[r];
    Vec8<T> v;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = ch * 8 + u;
      v.v[u] = c < C ? col[c * stride] : T(0.f);
    }
    *reinterpret_cast<Vec8<T>*>(dst + (size_t)r * chunks * 8 + ch * 8) = v;
  }
}

// Compact two sets of slots in one pass over j < n: list_a[r] = the r-th
// slot j < n_a with flag_a(j) set, in order, and pos_a[j] = how many come
// before slot j (pos_a[n_a] = their count); list_b likewise for flag_b on
// j < n_b, without positions.  Returns the two counts, with the lists
// visible to the whole block; every thread of the block calls it
// (blockDim.x a multiple of 32, warp_count[2 * 32] in shared memory).
struct Counts {
  int a, b;
};

template <typename FA, typename FB>
__device__ __forceinline__ Counts compact_slots(int* list_a, int* pos_a,
                                                int n_a, FA flag_a,
                                                int* list_b, int n_b,
                                                FB flag_b, int* warp_count) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  Counts done = {0, 0};
  for (int j0 = 0; j0 < max(n_a, n_b); j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool fa = j < n_a && flag_a(j), fb = j < n_b && flag_b(j);
    const unsigned ma = __ballot_sync(0xffffffffu, fa);
    const unsigned mb = __ballot_sync(0xffffffffu, fb);
    if (lane == 0) {
      warp_count[wid] = __popc(ma);
      warp_count[32 + wid] = __popc(mb);
    }
    __syncthreads();
    int base_a = 0, base_b = 0, tot_a = 0, tot_b = 0;
    for (int i = 0; i < nw; ++i) {
      base_a += i < wid ? warp_count[i] : 0;
      base_b += i < wid ? warp_count[32 + i] : 0;
      tot_a += warp_count[i];
      tot_b += warp_count[32 + i];
    }
    __syncthreads();
    const int ra = done.a + base_a + __popc(ma & below);
    if (j < n_a) pos_a[j] = ra;
    if (fa) list_a[ra] = j;
    if (fb) list_b[done.b + base_b + __popc(mb & below)] = j;
    done.a += tot_a;
    done.b += tot_b;
  }
  if (threadIdx.x == 0) pos_a[n_a] = done.a;
  __syncthreads();         // the lists and positions, visible to all
  return done;
}

}  // namespace staging
