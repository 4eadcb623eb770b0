// Variants of the isothermal SIA kernel (K4) for
// scripts/sia_kernels_study.py, built with -I pism_tpu_torch/csrc:
//
// - the kernel of sia_iso.cu at the tiles BX x BY threads x RY cells of a
//   column per thread: 32x8x1 (the earlier kernel's shape), 32x4x1, 16x8x1,
//   32x4x2, 32x8x2, 32x4x4, 32x16x1, 32x8x4 and 64x4x2, each with its
//   shortcuts (pow(x, 1) left out for n = 3 in float32, pow(0, n+2) on
//   ice-free faces: study_iso_<BX>x<BY>x<RY>_fast_*) and with every pow
//   (study_iso_<BX>x<BY>x<RY>_pow_*); the C entry points take the
//   arguments of pism_sia_flux_*;
// - probe kernels for SASS counts: a pow, an exp and an IEEE division per
//   thread (probe_{pow,exp,div}_*) and a baseline that reads and writes the
//   same values (probe_base_*);
// - pow1_check_f32 (every float32 bit pattern) and pow1_check_f64 (a
//   sample of float64 bit patterns, from all doubles or from the squared
//   slopes' range), which count the x for which pow(x, 1) differs from x
//   in its bits (NaN: in its NaN-ness only).

#include "sia_iso.cu"

namespace {

template <typename T>
__global__ void probe_pow_kernel(const T* __restrict__ x,
                                 const T* __restrict__ y, T* __restrict__ out,
                                 int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = pow(x[i], y[i]);
}

template <typename T>
__global__ void probe_exp_kernel(const T* __restrict__ x,
                                 const T* __restrict__ y, T* __restrict__ out,
                                 int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = exp(x[i]) + y[i];
}

template <typename T>
__global__ void probe_div_kernel(const T* __restrict__ x,
                                 const T* __restrict__ y, T* __restrict__ out,
                                 int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = div_rn(x[i], y[i]);
}

template <typename T>
__global__ void probe_base_kernel(const T* __restrict__ x,
                                  const T* __restrict__ y, T* __restrict__ out,
                                  int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + y[i];
}

template <typename T>
int probes(const void* x, const void* y, void* out, int n, void* stream) {
  const int g = (n + 255) / 256;
  cudaStream_t st = (cudaStream_t)stream;
  probe_pow_kernel<T><<<g, 256, 0, st>>>((const T*)x, (const T*)y, (T*)out, n);
  probe_exp_kernel<T><<<g, 256, 0, st>>>((const T*)x, (const T*)y, (T*)out, n);
  probe_div_kernel<T><<<g, 256, 0, st>>>((const T*)x, (const T*)y, (T*)out, n);
  probe_base_kernel<T><<<g, 256, 0, st>>>((const T*)x, (const T*)y, (T*)out,
                                          n);
  return (int)cudaGetLastError();
}

__global__ void pow1_f32_kernel(unsigned long long start,
                                unsigned long long count,
                                unsigned long long* bad,
                                unsigned long long* nan_bits) {
  unsigned long long k = blockIdx.x * (unsigned long long)blockDim.x +
                         threadIdx.x;
  const unsigned long long stride =
      (unsigned long long)gridDim.x * blockDim.x;
  unsigned long long nb = 0, nn = 0;
  for (; k < count; k += stride) {
    const float x = __int_as_float((int)(unsigned)(start + k));
    const float y = pow(x, 1.0f);
    if (x != x) {
      nb += (y == y);
      nn += __float_as_int(y) != __float_as_int(x);
    } else {
      nb += __float_as_int(y) != __float_as_int(x);
    }
  }
  atomicAdd(bad, nb);
  atomicAdd(nan_bits, nn);
}

// splitmix64: a bit pattern per index
__device__ __forceinline__ unsigned long long mix(unsigned long long z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

// patterns drawn from all doubles (mode 0) or from [2^-60, 2^10) (mode 1),
// the squared slopes of ice sheets and more
__global__ void pow1_f64_kernel(unsigned long long count, int mode,
                                unsigned long long* bad,
                                unsigned long long* nan_bits) {
  unsigned long long k = blockIdx.x * (unsigned long long)blockDim.x +
                         threadIdx.x;
  const unsigned long long stride =
      (unsigned long long)gridDim.x * blockDim.x;
  unsigned long long nb = 0, nn = 0;
  for (; k < count; k += stride) {
    unsigned long long b = mix(k);
    if (mode == 1)
      b = (b & 0x000fffffffffffffull) |
          ((unsigned long long)(1023 - 60 + (b >> 57) % 70) << 52);
    const double x = __longlong_as_double((long long)b);
    const double y = pow(x, 1.0);
    if (x != x) {
      nb += (y == y);
      nn += __double_as_longlong(y) != __double_as_longlong(x);
    } else {
      nb += __double_as_longlong(y) != __double_as_longlong(x);
    }
  }
  atomicAdd(bad, nb);
  atomicAdd(nan_bits, nn);
}

}  // namespace

#define STUDY(BX, BY, RY, kind, always_pow, T, prec)                          \
  int study_iso_##BX##x##BY##x##RY##_##kind##_##prec(                         \
      const void* H, const void* s, void* qe, void* qn, void* De, void* Dn,   \
      void* work, void* maxD, int My, int Mx, const double* c,                \
      void* stream) {                                                         \
    return launch_tile<T, BX, BY, RY>(H, s, qe, qn, De, Dn, work, maxD, My,   \
                                      Mx, c, (cudaStream_t)stream,            \
                                      always_pow);                            \
  }

#define STUDY_SHAPE(BX, BY, RY)                   \
  STUDY(BX, BY, RY, fast, false, float, f32)      \
  STUDY(BX, BY, RY, fast, false, double, f64)     \
  STUDY(BX, BY, RY, pow, true, float, f32)        \
  STUDY(BX, BY, RY, pow, true, double, f64)

extern "C" {
STUDY_SHAPE(32, 8, 1)
STUDY_SHAPE(32, 4, 1)
STUDY_SHAPE(16, 8, 1)
STUDY_SHAPE(32, 4, 2)
STUDY_SHAPE(32, 8, 2)
STUDY_SHAPE(32, 4, 4)
STUDY_SHAPE(32, 16, 1)
STUDY_SHAPE(32, 8, 4)
STUDY_SHAPE(64, 4, 2)

int probes_f32(const void* x, const void* y, void* out, int n, void* s) {
  return probes<float>(x, y, out, n, s);
}

int probes_f64(const void* x, const void* y, void* out, int n, void* s) {
  return probes<double>(x, y, out, n, s);
}

// counts[0]: patterns whose pow(x, 1) is not x; counts[1]: NaNs whose
// pow(x, 1) is a NaN with other bits
int pow1_check_f32(void* counts, void* stream) {
  pow1_f32_kernel<<<2048, 256, 0, (cudaStream_t)stream>>>(
      0ull, 1ull << 32, (unsigned long long*)counts,
      (unsigned long long*)counts + 1);
  return (int)cudaGetLastError();
}

int pow1_check_f64(unsigned long long count, int mode, void* counts,
                   void* stream) {
  pow1_f64_kernel<<<2048, 256, 0, (cudaStream_t)stream>>>(
      count, mode, (unsigned long long*)counts,
      (unsigned long long*)counts + 1);
  return (int)cudaGetLastError();
}
}
