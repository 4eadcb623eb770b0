// Batched tridiagonal solves by parallel cyclic reduction (PCR) for Hopper
// (sm_90a), float and double: the line systems are factored once and then
// applied to many right-hand sides.
//
// Replaces the TPU kernels of pism_tpu/ops/pallas_kernels.py:
//   pcr_fused_sub / _pcr_kernel_sub  (system on axis -2, lines strided by
//       the batch width)  -> pism_pcr_factor_lines_sub_* + pism_pcr_apply_lines_sub_*
//   pcr_fused / _pcr_kernel          (system on the last axis, lines
//       contiguous)       -> pism_pcr_factor_lines_*     + pism_pcr_apply_lines_*
// One factor core and one apply core serve both layouts; only the map from
// a slot to its address in device memory differs.
//
// System per line: a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k], k < n.
// Factor and apply together compute exactly the elimination of the TPU
// kernels and of pism_tpu_torch/util/tridiag.solve_batched_pcr, in their
// order of rounding:
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
// What bounds it, and what the design does about it. The line
// preconditioner keeps a, b, c from one build to the next and solves some
// twenty to thirty right-hand sides in between, and only the d recurrence
// depends on the right-hand side. So
//   factor (a, b or unit, c) -> table: runs the a, b, c recurrences once
//     and writes alpha and gamma of every round and b of the last one,
//     2 ceil(log2 n) + 1 planes;
//   apply (table, r, scale or none) -> x: d = r / scale at load, then per
//     round the one d recurrence with alpha and gamma read from the table,
//     then x = d / b.
// An apply moves r, scale and x once and streams the table, (2 rounds + 1)
// times the field (0.7 MB at 141 x 76 and 14 MB at 561 x 301 in float32; it
// stays in the 50 MB L2 between applications). It does no division per
// round and keeps only d in shared memory, 2 n elements per line against
// the 8 n of a solve that carries a, b, c along. Measured on an H100
// (chip_smoke.py, phase 1): on the short lines of the 20 km grid the
// launch and the ceil(log2 n) dependent rounds set its time (2.4-2.9 us, of
// which 0.9 is an empty launch); on the 5 km grid the table's stream from
// L2 does (6.0-6.9 us with contiguous lines, 9.3-10.5 with the system on
// axis -2, whose reads of r, scale and x are one element per row; 1.2 to
// 1.9 times that when the table has to come from device memory). So the
// design spends on latency and on keeping loads in flight:
//   - a block owns one line, so several blocks are resident per SM and the
//     grid covers all SMs; one block's loads overlap another's rounds.
//     With the system on axis -2 a block that owned 2, 4 or 8 adjacent
//     lines would read that many adjacent elements of each row; measured
//     at 561 x 301 this changed the apply by 5% at most and made the factor
//     1.3 to 2.7 times slower, so both layouts take one line per block;
//   - a thread owns the same kItems slots through all rounds, one slot
//     wherever the line fits a block's 1024 threads (more threads in flight
//     beat more slots per thread at every shape), and keeps their d in
//     registers; a round reads the two neighbours from shared
//     memory and writes the new d to the other of two buffers, one
//     __syncthreads() per round, none after the last;
//   - alpha and gamma are loaded four rounds ahead of their use, the
//     first four rounds' together with r and the last b, so a round waits
//     for shared memory and the barrier, not for the table;
//   - the table is stored line by line whatever the layout of a, c, r and
//     x, so its reads and writes are contiguous.
//
// Table layout: 2 rounds + 1 planes of batch * n elements; planes 2 r and
// 2 r + 1 hold alpha and gamma of round r, plane 2 rounds the last b.
// Within a plane element k of line l lies at l * n + k in both layouts.
//
// Shared memory: factor 6 n elements (a, b, c, two copies), apply 2 n.
// One line must fit in the 227 KB a block may use: a factor takes lines up
// to n = 9,685 in float32 and 4,842 in float64 (the one-shot solve that
// carried d along stopped at 7,264 and 3,632), an apply up to 29,056 and
// 14,528.
//
// The member axis of an ensemble, (B, My, Mx) arrays, in one launch:
//   - the systems on the last axis (K2b): member b's line y is line b My + y
//     of a (B My, Mx) array, the same address as in a (batch, n) array of
//     B My lines, so the wrapper folds the members into the batch and the
//     entries above take them as they are;
//   - the systems on axis -2 (K2): (B, n, batch) is no (n, B batch) array,
//     so the *_sub_members entries take a member stride, blockIdx.y the
//     member and gridDim.y = B; member m's line l is table line m batch + l.
// A member's line is then a single launch's line, the same operations in the
// same order, so each member equals a single launch on its own systems to
// the bit; a single launch is the case B = 1.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// the launch (0 = success), or cudaErrorInvalidValue when a line does not
// fit in shared memory.
// The kernels allocate nothing and launch on the stream they are given.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may use
constexpr int kMaxThreads = 1024;
constexpr int kFactorThreads = 512;

__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }
__device__ __forceinline__ double div_rn(double x, double y) { return __ddiv_rn(x, y); }

// Address of element k of line `line` of member blockIdx.y in the (n,
// batch) or (batch, n) arrays of each member. kSub: the line is a column of
// an (n, batch) array, else a row of a (batch, n) array.
template <bool kSub>
__device__ __forceinline__ size_t element_address(int k, int n, int batch,
                                                  int line) {
  return (size_t)blockIdx.y * n * batch +
         (kSub ? (size_t)k * batch + line : (size_t)line * n + k);
}

// Row (member blockIdx.y, line) of the table's planes of gridDim.y batch n
// elements: the planes hold the members' lines in turn.
__device__ __forceinline__ size_t table_line(int n, int batch, int line) {
  return ((size_t)blockIdx.y * batch + line) * n;
}

// The a, b, c recurrences of one line, all rounds; b == nullptr is the unit
// diagonal. Shared memory holds two copies of (a, b, c): a round reads one
// and writes the other.
template <typename T, bool kSub>
__global__ void pcr_factor_kernel(const T* __restrict__ a,
                                  const T* __restrict__ b,
                                  const T* __restrict__ c,
                                  T* __restrict__ table, int n, int batch,
                                  int rounds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int slots = n;
  const int line = blockIdx.x;
  const size_t plane = (size_t)n * batch * gridDim.y;
  T* tq = table + table_line(n, batch, line);

  {
    T* A = smem; T* B = A + slots; T* C = B + slots;
    for (int idx = threadIdx.x; idx < slots; idx += blockDim.x) {
      const size_t g = element_address<kSub>(idx, n, batch, line);
      A[idx] = idx > 0 ? a[g] : T(0);
      B[idx] = b != nullptr ? b[g] : T(1);
      C[idx] = idx < slots - 1 ? c[g] : T(0);
    }
  }
  __syncthreads();

  int cur = 0;
  for (int rd = 0, o = 1; rd < rounds; ++rd, o *= 2) {
    const T* A = smem + cur * 3 * slots;
    const T* B = A + slots; const T* C = B + slots;
    T* A2 = smem + (1 - cur) * 3 * slots;
    T* B2 = A2 + slots; T* C2 = B2 + slots;
    T* t_alpha = tq + (size_t)(2 * rd) * plane;
    T* t_gamma = t_alpha + plane;
    for (int idx = threadIdx.x; idx < slots; idx += blockDim.x) {
      const bool lo = idx >= o, hi = idx + o < slots;
      const T b_m = lo ? B[idx - o] : T(1);
      const T b_p = hi ? B[idx + o] : T(1);
      const T alpha = div_rn(-A[idx], b_m);
      const T gamma = div_rn(-C[idx], b_p);
      const T a_m = lo ? A[idx - o] : T(0), c_m = lo ? C[idx - o] : T(0);
      const T a_p = hi ? A[idx + o] : T(0), c_p = hi ? C[idx + o] : T(0);
      t_alpha[idx] = alpha;
      t_gamma[idx] = gamma;
      B2[idx] = add_rn(add_rn(B[idx], mul_rn(alpha, c_m)), mul_rn(gamma, a_p));
      A2[idx] = mul_rn(alpha, a_m);
      C2[idx] = mul_rn(gamma, c_p);
    }
    __syncthreads();
    cur = 1 - cur;
  }

  const T* B = smem + cur * 3 * slots + slots;
  T* t_b = tq + (size_t)(2 * rounds) * plane;
  for (int idx = threadIdx.x; idx < slots; idx += blockDim.x) t_b[idx] = B[idx];
}

// Rounds of alpha and gamma a thread holds in registers ahead of their
// use: four, fewer where a thread owns so many slots that they would take
// more than 16 registers each. Measured on an H100 with 1, 2, 4, 8 and 16
// rounds ahead: one round leaves the short lines of the 20 km grid waiting
// for the table (3.2 us against 2.3 at n = 76); eight or sixteen cost the
// long lines of the 5 km grid registers and a burst of loads ahead of r
// (11.9 us against 10.8 at n = 561 on axis -2).
template <typename T, int kItems>
struct RoundsAhead {
  static constexpr int kRaw = 64 / (kItems * (int)sizeof(T));
  static constexpr int kValue = kRaw < 1 ? 1 : kRaw > 4 ? 4 : kRaw;
};

// The d recurrence of one line with the factor's table; scale == nullptr
// applies to r as it is. Thread t owns slots t, t + blockDim.x, ...: their
// d, the last b and kAhead rounds of alpha and gamma stay in registers (in
// local memory for kItems = 32, the variant for lines too long for
// registers; kItems is 1, 4 or 32). The coefficients of the first kAhead
// rounds are loaded with r, and round rd loads those of round rd + kAhead
// into the registers it has just read, so the table's latency lies kAhead
// rounds ahead of its use. The refill stands after the round's arithmetic:
// written before it, nvcc loads into spare registers and copies them at the
// end of the round, which waits for the table in every round (measured: 3.0
// against 2.6 us at n = 76 and 12.0 against 10.8 at n = 561 on axis -2).
// A block may have 1024 threads, so a thread may take 64 registers.
template <typename T, bool kSub, int kItems>
__global__ void __launch_bounds__(kMaxThreads)
pcr_apply_kernel(const T* __restrict__ table, const T* __restrict__ r,
                 const T* __restrict__ scale, T* __restrict__ x, int n,
                 int batch, int rounds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cur = reinterpret_cast<T*>(smem_raw);
  const int slots = n;
  T* nxt = cur + slots;
  const int line = blockIdx.x;
  const size_t plane = (size_t)n * batch * gridDim.y;
  const T* tq = table + table_line(n, batch, line);
  constexpr int kUnroll = kItems <= 8 ? kItems : 1;
  constexpr int kAhead = RoundsAhead<T, kItems>::kValue;
  T d[kItems], b_last[kItems], alpha[kAhead][kItems], gamma[kAhead][kItems];

#pragma unroll (kUnroll)
  for (int i = 0; i < kItems; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    if (idx < slots) {
      const size_t g = element_address<kSub>(idx, n, batch, line);
      T v = r[g];
      if (scale != nullptr) v = div_rn(v, scale[g]);
      b_last[i] = tq[(size_t)(2 * rounds) * plane + idx];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (j < rounds) {
          alpha[j][i] = tq[(size_t)(2 * j) * plane + idx];
          gamma[j][i] = tq[(size_t)(2 * j + 1) * plane + idx];
        }
      }
      if (rounds > 0) cur[idx] = v;
      d[i] = v;
    }
  }
  if (rounds > 0) __syncthreads();

  for (int rd0 = 0, o = 1; rd0 < rounds; rd0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int rd = rd0 + j;
      if (rd < rounds) {   // the same for every thread of the block
        const bool more = rd + 1 < rounds, refill = rd + kAhead < rounds;
        const T* t_next = tq + (size_t)(2 * (rd + kAhead)) * plane;
#pragma unroll (kUnroll)
        for (int i = 0; i < kItems; ++i) {
          const int idx = threadIdx.x + i * blockDim.x;
          if (idx < slots) {
            const T d_m = idx >= o ? cur[idx - o] : T(0);
            const T d_p = idx + o < slots ? cur[idx + o] : T(0);
            d[i] = add_rn(add_rn(d[i], mul_rn(alpha[j][i], d_m)),
                          mul_rn(gamma[j][i], d_p));
            if (more) nxt[idx] = d[i];
            if (refill) {   // in flight while kAhead rounds compute
              alpha[j][i] = t_next[idx];
              gamma[j][i] = t_next[plane + idx];
            }
          }
        }
        if (more) __syncthreads();
        T* t = cur; cur = nxt; nxt = t;
        o *= 2;
      }
    }
  }

#pragma unroll (kUnroll)
  for (int i = 0; i < kItems; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    if (idx < slots)
      x[element_address<kSub>(idx, n, batch, line)] = div_rn(d[i], b_last[i]);
  }
}

int ceil_log2(int n) {
  int rounds = 0;
  while ((1 << rounds) < n) ++rounds;   // 0 for n = 1
  return rounds;
}

// Raises the kernel's limit of dynamic shared memory where it must; an
// error code where a line does not fit.
template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

template <typename T, bool kSub>
int launch_factor(const void* a, const void* b, const void* c, void* table,
                  int n, int batch, void* stream, int members = 1) {
  if (n <= 0 || batch <= 0 || members <= 0) return 0;
  const size_t smem = 6 * (size_t)n * sizeof(T);
  const int err = prepare(pcr_factor_kernel<T, kSub>, smem);
  if (err != 0) return err;
  int threads = (n + 31) / 32 * 32;
  if (threads > kFactorThreads) threads = kFactorThreads;
  pcr_factor_kernel<T, kSub>
      <<<dim3(batch, members), threads, smem, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (const T*)c, (T*)table, n, batch,
      ceil_log2(n));
  return (int)cudaGetLastError();
}

template <typename T, bool kSub, int kItems>
int launch_apply_items(const void* table, const void* r, const void* scale,
                       void* x, int n, int batch, void* stream, int members) {
  const size_t smem = 2 * (size_t)n * sizeof(T);
  const int err = prepare(pcr_apply_kernel<T, kSub, kItems>, smem);
  if (err != 0) return err;
  const int threads = ((n + kItems - 1) / kItems + 31) / 32 * 32;
  pcr_apply_kernel<T, kSub, kItems>
      <<<dim3(batch, members), threads, smem, (cudaStream_t)stream>>>(
          (const T*)table, (const T*)r, (const T*)scale, (T*)x, n, batch,
          ceil_log2(n));
  return (int)cudaGetLastError();
}

// One slot per thread where the line fits a block's 1024 threads, else 4,
// else 32 (a line that fits in shared memory has fewer than 32,768 slots).
template <typename T, bool kSub>
int launch_apply(const void* table, const void* r, const void* scale, void* x,
                 int n, int batch, void* stream, int members = 1) {
  if (n <= 0 || batch <= 0 || members <= 0) return 0;
  if (n <= kMaxThreads)
    return launch_apply_items<T, kSub, 1>(table, r, scale, x, n, batch,
                                          stream, members);
  if (n <= 4 * kMaxThreads)
    return launch_apply_items<T, kSub, 4>(table, r, scale, x, n, batch,
                                          stream, members);
  return launch_apply_items<T, kSub, 32>(table, r, scale, x, n, batch,
                                         stream, members);
}

}  // namespace

extern "C" {

// Factor: a, c and b (or a null pointer for the unit diagonal) in, the
// table of 2 ceil(log2 n) + 1 planes out. Apply: the table, r and scale
// (or a null pointer) in, x out. (batch, n) arrays: the system runs along
// the last, contiguous axis.
int pism_pcr_factor_lines_f32(const void* a, const void* b, const void* c,
                              void* table, int n, int batch, void* stream) {
  return launch_factor<float, false>(a, b, c, table, n, batch, stream);
}

int pism_pcr_factor_lines_f64(const void* a, const void* b, const void* c,
                              void* table, int n, int batch, void* stream) {
  return launch_factor<double, false>(a, b, c, table, n, batch, stream);
}

int pism_pcr_apply_lines_f32(const void* table, const void* r,
                             const void* scale, void* x, int n, int batch,
                             void* stream) {
  return launch_apply<float, false>(table, r, scale, x, n, batch, stream);
}

int pism_pcr_apply_lines_f64(const void* table, const void* r,
                             const void* scale, void* x, int n, int batch,
                             void* stream) {
  return launch_apply<double, false>(table, r, scale, x, n, batch, stream);
}

// (n, batch) arrays: the system runs along axis -2, lines strided by batch.
int pism_pcr_factor_lines_sub_f32(const void* a, const void* b, const void* c,
                                  void* table, int n, int batch, void* stream) {
  return launch_factor<float, true>(a, b, c, table, n, batch, stream);
}

int pism_pcr_factor_lines_sub_f64(const void* a, const void* b, const void* c,
                                  void* table, int n, int batch, void* stream) {
  return launch_factor<double, true>(a, b, c, table, n, batch, stream);
}

int pism_pcr_apply_lines_sub_f32(const void* table, const void* r,
                                 const void* scale, void* x, int n, int batch,
                                 void* stream) {
  return launch_apply<float, true>(table, r, scale, x, n, batch, stream);
}

int pism_pcr_apply_lines_sub_f64(const void* table, const void* r,
                                 const void* scale, void* x, int n, int batch,
                                 void* stream) {
  return launch_apply<double, true>(table, r, scale, x, n, batch, stream);
}

// (B, n, batch) arrays, the systems along axis -2 of each member: one
// launch for the B members; the table holds B batch lines a plane.
int pism_pcr_factor_lines_sub_members_f32(const void* a, const void* b,
                                          const void* c, void* table, int n,
                                          int batch, int members,
                                          void* stream) {
  return launch_factor<float, true>(a, b, c, table, n, batch, stream, members);
}

int pism_pcr_factor_lines_sub_members_f64(const void* a, const void* b,
                                          const void* c, void* table, int n,
                                          int batch, int members,
                                          void* stream) {
  return launch_factor<double, true>(a, b, c, table, n, batch, stream,
                                     members);
}

int pism_pcr_apply_lines_sub_members_f32(const void* table, const void* r,
                                         const void* scale, void* x, int n,
                                         int batch, int members,
                                         void* stream) {
  return launch_apply<float, true>(table, r, scale, x, n, batch, stream,
                                   members);
}

int pism_pcr_apply_lines_sub_members_f64(const void* table, const void* r,
                                         const void* scale, void* x, int n,
                                         int batch, int members,
                                         void* stream) {
  return launch_apply<double, true>(table, r, scale, x, n, batch, stream,
                                    members);
}

}  // extern "C"
