// Batched tridiagonal solves by parallel cyclic reduction (PCR) for Hopper
// (sm_90a), float and double.
//
// Replaces the TPU kernels of pism_tpu/ops/pallas_kernels.py:
//   pcr_fused_sub / _pcr_kernel_sub  (system on axis -2, lines strided by
//                                     the batch width)  -> pism_pcr_lines_sub_*
//   pcr_fused / _pcr_kernel          (system on the last axis, lines
//                                     contiguous)        -> pism_pcr_lines_*
// One PCR core serves both; only the global load and store differ.
//
// System per line: a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k], k < n.
// It computes exactly the elimination of the TPU kernels and of
// pism_tpu_torch/util/tridiag.solve_batched_pcr, in their order of rounding:
//   a[0] = 0 and c[n-1] = 0;
//   ceil(log2 n) rounds, stride s = 1, 2, 4, ...:
//     alpha = -a[k] / b[k-s],  gamma = -c[k] / b[k+s]
//     b' = (b[k] + alpha c[k-s]) + gamma a[k+s]
//     d' = (d[k] + alpha d[k-s]) + gamma d[k+s]
//     a' = alpha a[k-s],  c' = gamma c[k+s]
//   where a neighbour outside the line reads b = 1 and a = c = d = 0;
//   x = d / b after the last round.
// Every product, sum and quotient is rounded on its own (the _rn
// intrinsics), so nvcc does not contract them into fused multiply-adds and
// the result is the plain torch version's, operation for operation.
//
// Design: a block owns W adjacent lines and keeps their four arrays in
// shared memory through all rounds, double-buffered: a round reads one copy
// and writes the other, and one __syncthreads() per round separates them,
// so no thread reads a neighbour that another thread is overwriting. Device
// memory is read once and written once per solve (the plain torch version
// makes some twenty passes per round). At the chain's shapes (lines of
// 76-561, 76-561 lines) the solve moves 0.2-3.4 MB in float32 and is bound
// by the ceil(log2 n) dependent rounds and the launch, not by bandwidth; W
// is chosen so that the grid has about one block per SM (132 on an H100).
// Shared memory per line is 8 n sizeof(T) (18 KB at n = 561 in float32,
// 36 KB in float64); W is capped so a block stays within the 227 KB limit.
// Thomas per thread would touch memory less but rounds in another order; it
// is left to a later redesign.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// the launch (0 = success), or cudaErrorInvalidValue when one line does not
// fit in shared memory. The kernel allocates nothing and launches on the
// stream it is given.

#include <algorithm>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may use
constexpr int kTargetBlocks = 132;  // one block per SM of an H100

__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }
__device__ __forceinline__ double div_rn(double x, double y) { return __ddiv_rn(x, y); }

// Lines [line0, line0 + nl) of the batch; kSub: line l is column l of an
// (n, batch) array, else row l of a (batch, n) array. Shared memory holds
// two copies of (a, b, c, d), each slot (k, l) at k * W + l.
template <typename T, bool kSub>
__global__ void pcr_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           const T* __restrict__ c, const T* __restrict__ d,
                           T* __restrict__ x, int n, int batch, int W,
                           int rounds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int line0 = blockIdx.x * W;
  const int nl = min(W, batch - line0);
  const int cnt = n * W;
  const int total = n * nl;

  // global index of slot (k, l)
  auto gidx = [&](int k, int l) -> size_t {
    return kSub ? (size_t)k * batch + line0 + l : (size_t)(line0 + l) * n + k;
  };
  // the load and store walk the slots so that neighbouring threads touch
  // neighbouring addresses of device memory
  auto slot = [&](int idx, int* k, int* l) {
    if (kSub) { *k = idx / nl; *l = idx % nl; }
    else      { *l = idx / n;  *k = idx % n;  }
  };

  {
    T* A = smem; T* B = A + cnt; T* C = B + cnt; T* D = C + cnt;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      int k, l;
      slot(idx, &k, &l);
      const size_t g = gidx(k, l);
      const int s = k * W + l;
      A[s] = k == 0 ? T(0) : a[g];
      B[s] = b[g];
      C[s] = k == n - 1 ? T(0) : c[g];
      D[s] = d[g];
    }
  }
  __syncthreads();

  int cur = 0;
  for (int r = 0, st = 1; r < rounds; ++r, st *= 2) {
    const T* A = smem + cur * 4 * cnt;
    const T* B = A + cnt; const T* C = B + cnt; const T* D = C + cnt;
    T* A2 = smem + (1 - cur) * 4 * cnt;
    T* B2 = A2 + cnt; T* C2 = B2 + cnt; T* D2 = C2 + cnt;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int k = idx / nl, l = idx % nl;
      const int s = k * W + l;
      const bool lo = k - st >= 0, hi = k + st < n;
      const int sm = s - st * W, sp = s + st * W;
      const T b_m = lo ? B[sm] : T(1);
      const T b_p = hi ? B[sp] : T(1);
      const T alpha = div_rn(-A[s], b_m);
      const T gamma = div_rn(-C[s], b_p);
      const T a_m = lo ? A[sm] : T(0), c_m = lo ? C[sm] : T(0);
      const T d_m = lo ? D[sm] : T(0);
      const T a_p = hi ? A[sp] : T(0), c_p = hi ? C[sp] : T(0);
      const T d_p = hi ? D[sp] : T(0);
      B2[s] = add_rn(add_rn(B[s], mul_rn(alpha, c_m)), mul_rn(gamma, a_p));
      D2[s] = add_rn(add_rn(D[s], mul_rn(alpha, d_m)), mul_rn(gamma, d_p));
      A2[s] = mul_rn(alpha, a_m);
      C2[s] = mul_rn(gamma, c_p);
    }
    __syncthreads();
    cur = 1 - cur;
  }

  const T* B = smem + cur * 4 * cnt + cnt;
  const T* D = B + 2 * cnt;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int k, l;
    slot(idx, &k, &l);
    const int s = k * W + l;
    x[gidx(k, l)] = div_rn(D[s], B[s]);
  }
}

template <typename T, bool kSub>
int launch_pcr(const void* a, const void* b, const void* c, const void* d,
               void* x, int n, int batch, void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  const size_t per_line = 8 * (size_t)n * sizeof(T);
  if (per_line > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int rounds = 0;
  while ((1 << rounds) < n) ++rounds;   // ceil(log2 n); 0 for n = 1
  int W = (batch + kTargetBlocks - 1) / kTargetBlocks;
  W = std::min(W, (int)(kMaxSmem / per_line));
  const int blocks = (batch + W - 1) / W;
  const size_t smem = per_line * W;
  int threads = ((n * W + 31) / 32) * 32;
  threads = std::min(threads, 1024);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pcr_kernel<T, kSub>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pcr_kernel<T, kSub><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (const T*)c, (const T*)d, (T*)x, n, batch, W,
      rounds);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (batch, n) arrays: the system runs along the last, contiguous axis.
int pism_pcr_lines_f32(const void* a, const void* b, const void* c,
                       const void* d, void* x, int n, int batch,
                       void* stream) {
  return launch_pcr<float, false>(a, b, c, d, x, n, batch, stream);
}

int pism_pcr_lines_f64(const void* a, const void* b, const void* c,
                       const void* d, void* x, int n, int batch,
                       void* stream) {
  return launch_pcr<double, false>(a, b, c, d, x, n, batch, stream);
}

// (n, batch) arrays: the system runs along axis -2, lines strided by batch.
int pism_pcr_lines_sub_f32(const void* a, const void* b, const void* c,
                           const void* d, void* x, int n, int batch,
                           void* stream) {
  return launch_pcr<float, true>(a, b, c, d, x, n, batch, stream);
}

int pism_pcr_lines_sub_f64(const void* a, const void* b, const void* c,
                           const void* d, void* x, int n, int batch,
                           void* stream) {
  return launch_pcr<double, true>(a, b, c, d, x, n, batch, stream);
}

}  // extern "C"
