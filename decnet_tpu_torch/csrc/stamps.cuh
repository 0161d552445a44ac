// Phase stamps for the port's kernels: clock64() readings per block, taken
// only in a build with -DDECNET_STAMPS (`python -m
// decnet_tpu_torch.cli.phase_split` makes that build and reads them).  In
// the normal build the macros are empty and the kernels are unchanged.
//
// Each block owns kStampSlots 64-bit slots of a device buffer that the
// reader zeroes and binds with decnet_stamps_bind() before a launch.
// DECNET_STAMP(k) records thread 0's clock at slot k (place it after a
// __syncthreads(), so it marks the whole block); DECNET_STAMP_SYNC(k)
// reconverges the warp and synchronises the block first (in the stamped
// build only);
// DECNET_STAMP_ALL(k) keeps the latest clock of any thread that passes it
// (atomicMax).  Slot 0 is the
// block's start.  clock64() counts SM cycles: differences are valid within
// a block, never across SMs.  A source lists its slots' names in a comment
// of the form `phases(<launcher>): name1 name2 ...` (slot 1, 2, ...).
#pragma once

#ifdef DECNET_STAMPS
constexpr int kStampSlots = 8;
__device__ unsigned long long* decnet_stamp_buf = nullptr;

__device__ __forceinline__ unsigned long long* decnet_stamp_slot(int k) {
  const size_t blk = blockIdx.x + (size_t)gridDim.x *
                     (blockIdx.y + (size_t)gridDim.y * blockIdx.z);
  return decnet_stamp_buf + blk * kStampSlots + k;
}

#define DECNET_STAMP(k)                                                    \
  do {                                                                     \
    if (threadIdx.x == 0 && decnet_stamp_buf)                              \
      *decnet_stamp_slot(k) = (unsigned long long)clock64();               \
  } while (0)
#define DECNET_STAMP_SYNC(k)                                               \
  do {                                                                     \
    __syncwarp();                                                          \
    __syncthreads();                                                       \
    DECNET_STAMP(k);                                                       \
  } while (0)
#define DECNET_STAMP_ALL(k)                                                \
  do {                                                                     \
    if (decnet_stamp_buf)                                                  \
      atomicMax(decnet_stamp_slot(k), (unsigned long long)clock64());      \
  } while (0)

// Binds the stamp buffer (kStampSlots slots per block of the next
// launches); returns a cudaError_t.
extern "C" int decnet_stamps_bind(void* buf) {
  return (int)cudaMemcpyToSymbol(decnet_stamp_buf, &buf, sizeof(buf));
}
#else
#define DECNET_STAMP(k) ((void)0)
#define DECNET_STAMP_SYNC(k) ((void)0)
#define DECNET_STAMP_ALL(k) ((void)0)
#endif
