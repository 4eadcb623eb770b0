// The max of a value over every thread of a launch, in the launch itself:
// each block reduces its threads' values by warp shuffles and folds the
// result into one 64-bit key in device memory with atomicMax; the block
// that takes the last ticket (an atomic with release and acquire order,
// lighter than __threadfence's sequentially consistent fence) turns the key
// back into the value and resets key and ticket for the next launch. So
// the launch's tail is two round trips, whatever its number of blocks. A
// NaN wins, as in torch.max and torch.maximum, and of two zeros +0 is the
// larger, so the result does not depend on the order in which the blocks
// finish. Shared by the SIA kernels (sia_thermo.cu, sia_iso.cu), whose
// wrappers take max(D) from it.
//
// On an ensemble's member axis a launch takes one max per member: a key per
// member (a block folds into its member's), one ticket for the launch, and
// the last block's threads turn all the keys back into values at once, so
// it is still two round trips, whatever the number of members.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

__device__ __forceinline__ bool sign_set(float x) { return __float_as_int(x) < 0; }
__device__ __forceinline__ bool sign_set(double x) {
  return __double_as_longlong(x) < 0;
}

// the larger of two values: a NaN wins (torch.max, torch.maximum), and of
// two zeros +0
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a > b) return a;
  if (b > a) return b;
  return sign_set(a) ? b : a;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max_nan(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// v as a 64-bit key that orders as max_nan does: a NaN above +inf, +0
// above -0 (the bits of a float taken as an integer order the positive
// values; flipping all but the sign bit of a negative one orders those)
__device__ __forceinline__ long long max_key(float v) {
  if (v != v) return LLONG_MAX;
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ long long max_key(double v) {
  if (v != v) return LLONG_MAX;
  const long long b = __double_as_longlong(v);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
}

// the value of a key (a NaN comes back as the card's NaN, all mantissa
// bits set, which its arithmetic makes)
template <typename T>
__device__ __forceinline__ T from_key(long long k);
template <>
__device__ __forceinline__ float from_key<float>(long long k) {
  if (k == LLONG_MAX) return __int_as_float(0x7fffffff);
  const int b = (int)k;
  return __int_as_float(b >= 0 ? b : b ^ 0x7fffffff);
}
template <>
__device__ __forceinline__ double from_key<double>(long long k) {
  if (k == LLONG_MAX) return __longlong_as_double(0x7fffffffffffffffLL);
  return __longlong_as_double(k >= 0 ? k : k ^ 0x7fffffffffffffffLL);
}

// the ticket's old value after adding 1, with release and acquire order at
// device scope: this thread's earlier writes (its atomicMax) are seen by
// whoever takes a later ticket, and it sees theirs of earlier tickets
__device__ __forceinline__ unsigned long long take_ticket(
    unsigned long long* ticket) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;"
               : "=l"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// the max over the block of each thread's v, in thread 0
template <typename T, int NT>
__device__ __forceinline__ T block_max(T v) {
  __shared__ T wmax[NT / 32];
  const int t = threadIdx.x + threadIdx.y * blockDim.x;
  v = warp_max(v);
  if ((t & 31) == 0) wmax[t >> 5] = v;
  __syncthreads();
  if (t == 0)
    for (int w = 1; w < NT / 32; ++w) v = max_nan(v, wmax[w]);
  return v;
}

// max of v over the blocks of member `member` into out[member], for each
// of the launch's nkeys members. work: a ticket (0) and the members' keys
// (LLONG_MIN each) between launches. Thread 0 of each block adds its
// block's key with atomicMax and takes a ticket; the threads of the block
// that takes the last read the keys, write the maxima and put every word
// back. Every thread of every block calls it; NT = threads per block, a
// multiple of 32.
template <typename T, int NT>
__device__ __forceinline__ void grid_max(T v, unsigned long long* work,
                                         T* out, int member = 0,
                                         int nkeys = 1) {
  __shared__ bool last;
  v = block_max<T, NT>(v);
  const int t = threadIdx.x + threadIdx.y * blockDim.x;
  long long* key = (long long*)(work + 1);
  if (t == 0) {
    atomicMax(key + member, max_key(v));
    last = take_ticket(work) ==
           (unsigned long long)gridDim.x * gridDim.y * gridDim.z - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int m = t; m < nkeys; m += NT)
    out[m] = from_key<T>((long long)atomicExch(
        (unsigned long long*)(key + m), (unsigned long long)LLONG_MIN));
  if (t == 0) work[0] = 0ull;
}

}  // namespace
