// Variants of the thermomechanical SIA kernel (K3) for
// scripts/sia_kernels_study.py, built with -I pism_tpu_torch/csrc:
//
// - the level kernel of sia_thermo.cu at the block shapes 32x8, 32x16,
//   16x16, 16x32, 8x32 and 8x64 (cells of one row x threads along the
//   levels) and its column kernel (a thread per cell), each with the skip
//   of the integrand above the ice where it is exact
//   (study_thermo_<TX>x<TY>_skip_*, study_thermo_column_skip_*) and without
//   it (..._full_*); the C entry points take the arguments of
//   pism_sia_flux_thermo_*;
// - probe kernels for the SASS count of the integrand: probe_f_level_*
//   evaluates f_level once per thread, probe_f_base_* reads and writes the
//   same values without it.

#include "sia_thermo.cu"

namespace {

template <typename T>
__global__ void probe_f_level_kernel(const T* __restrict__ Hf,
                                     const T* __restrict__ z,
                                     const T* __restrict__ E,
                                     T* __restrict__ out, int n,
                                     Params<T> p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = f_level(p, Hf[i], z[i], E[i]);
}

template <typename T>
__global__ void probe_f_base_kernel(const T* __restrict__ Hf,
                                    const T* __restrict__ z,
                                    const T* __restrict__ E,
                                    T* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = Hf[i] + z[i] + E[i];
}

template <typename T>
int probe(const void* Hf, const void* z, const void* E, void* out, int n,
          const double* c, void* stream) {
  const Params<T> p = params_from<T>(c);
  probe_f_level_kernel<T><<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const T*)Hf, (const T*)z, (const T*)E, (T*)out, n, p);
  probe_f_base_kernel<T><<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const T*)Hf, (const T*)z, (const T*)E, (T*)out, n);
  return (int)cudaGetLastError();
}

// TX = 0: the column kernel
template <typename T, int TX, int TY>
int study(const Launch& a, const double* c, bool skip) {
  if (a.My <= 0 || a.Mx <= 0) return 0;
  if (!launchable(a)) return (int)cudaErrorInvalidValue;
  const Params<T> p = params_from<T>(c);
  skip = skip && skip_exact(c);
  if constexpr (TX == 0)
    return launch_columns<T>(a, p, skip);
  else
    return launch_levels<T, TX, TY>(a, p, skip);
}

}  // namespace

#define STUDY(name, TX, TY, kind, skip, T, prec)                              \
  int study_thermo_##name##_##kind##_##prec(                                  \
      const void* H, const void* s, const void* E, const void* z, void* qe,   \
      void* qn, void* De, void* Dn, void* work, void* maxD,                   \
      int My, int Mx, int Mz, long long sy, long long sx, long long sz,       \
      const double* c, void* stream) {                                        \
    return study<T, TX, TY>(Launch{H, s, E, z, qe, qn, De, Dn, work, maxD,    \
                                   My, Mx, Mz, sy, sx, sz,                    \
                                   (cudaStream_t)stream},                     \
                            c, skip);                                         \
  }

#define STUDY_VARIANT(name, TX, TY)                         \
  STUDY(name, TX, TY, skip, true, float, f32)              \
  STUDY(name, TX, TY, skip, true, double, f64)             \
  STUDY(name, TX, TY, full, false, float, f32)             \
  STUDY(name, TX, TY, full, false, double, f64)

#define STUDY_SHAPE(TX, TY) \
  STUDY_VARIANT(TX##x##TY, TX, TY)

extern "C" {
STUDY_SHAPE(32, 8)
STUDY_SHAPE(32, 16)
STUDY_SHAPE(16, 16)
STUDY_SHAPE(16, 32)
STUDY_SHAPE(8, 32)
STUDY_SHAPE(8, 64)
STUDY_VARIANT(column, 0, 1)

int probe_f_level_f32(const void* Hf, const void* z, const void* E,
                      void* out, int n, const double* c, void* stream) {
  return probe<float>(Hf, z, E, out, n, c, stream);
}

int probe_f_level_f64(const void* Hf, const void* z, const void* E,
                      void* out, int n, const double* c, void* stream) {
  return probe<double>(Hf, z, E, out, n, c, stream);
}
}
