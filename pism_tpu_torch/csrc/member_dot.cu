// Per-member dot products of the SSA's Krylov solver on an ensemble's
// member axis, for Hopper (sm_90a): out[m] = sum(a0 b0) + sum(a1 b1) over
// member m's (My, Mx) cells, for pairs of (B, My, Mx) fields.
//
// Stands in for the dot products of the JAX package's BiCGStab
// (pism_tpu/ops/ssa.py bicgstab_solve, dot) under jax.vmap, which XLA
// reduces member by member. Torch's own sum over the last dims of a (B, N)
// tensor picks its block shape and its split across blocks by B, so the
// order in which a member's products are added, and with it the rounding,
// would change with the number of members; the SSA solve turns such a
// change into 1e-5 of max |u|. Here the order is fixed: one block per
// member, thread t adds the products of cells t, t + kThreads, ... in turn,
// then a tree in shared memory adds the threads' sums, the same tree for
// any B. So a member's dot products, and its whole solve, are those of the
// same member in any batch, a batch of one included.
//
// What bounds it: it reads four fields once, 16 bytes a cell in float32
// (0.17 MB a member at the 20 km grid, 17 MB for 100 members, 5 us at 3.35
// TB/s); at 100 members the launch is near that, with fewer members the
// latency of one block's pass over its member's cells sets its time.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// the launch (0 = success). The kernel allocates nothing and launches on the
// stream it is given.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// In: the fields' type; Acc: the type the products are formed and summed in
// (double for float fields with float64 dot products).
template <typename In, typename Acc>
__global__ void __launch_bounds__(kThreads) member_dot_kernel(
    const In* __restrict__ a0, const In* __restrict__ b0,
    const In* __restrict__ a1, const In* __restrict__ b1,
    Acc* __restrict__ out, long long n) {
  __shared__ Acc s0[kThreads], s1[kThreads];
  const size_t m = (size_t)blockIdx.x * (size_t)n;
  a0 += m; b0 += m; a1 += m; b1 += m;
  const int t = threadIdx.x;
  Acc p0 = Acc(0), p1 = Acc(0);
  for (long long k = t; k < n; k += kThreads) {
    p0 += Acc(a0[k]) * Acc(b0[k]);
    p1 += Acc(a1[k]) * Acc(b1[k]);
  }
  s0[t] = p0;
  s1[t] = p1;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s /= 2) {
    if (t < s) {
      s0[t] += s0[t + s];
      s1[t] += s1[t + s];
    }
    __syncthreads();
  }
  if (t == 0) out[blockIdx.x] = s0[0] + s1[0];
}

template <typename In, typename Acc>
int launch(const void* a0, const void* b0, const void* a1, const void* b1,
           void* out, long long n, int members, void* stream) {
  if (members <= 0) return 0;
  member_dot_kernel<In, Acc><<<members, kThreads, 0, (cudaStream_t)stream>>>(
      (const In*)a0, (const In*)b0, (const In*)a1, (const In*)b1, (Acc*)out,
      n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a0, b0, a1, b1: (members, n) fields of one type; out: (members,).
int pism_member_dot_f32(const void* a0, const void* b0, const void* a1,
                        const void* b1, void* out, long long n, int members,
                        void* stream) {
  return launch<float, float>(a0, b0, a1, b1, out, n, members, stream);
}

int pism_member_dot_f64(const void* a0, const void* b0, const void* a1,
                        const void* b1, void* out, long long n, int members,
                        void* stream) {
  return launch<double, double>(a0, b0, a1, b1, out, n, members, stream);
}

// float fields, the products and sums in double
int pism_member_dot_f32_f64(const void* a0, const void* b0, const void* a1,
                            const void* b1, void* out, long long n,
                            int members, void* stream) {
  return launch<float, double>(a0, b0, a1, b1, out, n, members, stream);
}

}  // extern "C"
