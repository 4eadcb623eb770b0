// Fused thermomechanical SIA diffusivity and flux for Hopper (sm_90a),
// float and double.
//
// Replaces the TPU kernel sia_flux_thermo_pallas_padded of
// pism_tpu/ops/pallas_kernels.py (body _sia_thermo_body, called through
// sia_flux_thermo_pallas). It computes what that kernel computes, one thread
// per cell for both its east and its north face:
//
//   Mahaffy face gradients of s (one-sided across the face, 4-point average
//   along it); face thickness and face enthalpy as two-cell averages;
//   per level k: depth = max(H - z_k, 0), p = 101325 + rho g depth,
//     T_m = T_melting - beta p, E_s = c_i (T_m - T_ref),
//     T = E < E_s ? T_ref + E / c_i : T_m, T_pa = T - T_m + T_melting,
//     A = (T_pa < T_crit ? A_cold : A_warm) exp(-Q / (R T_pa)) (Q likewise),
//     omega = min(clip((E - E_s) / L, 0, 1), omega_max),
//     f_k = A (1 + c_w omega) depth^(n+1)
//   (A_cold and A_warm carry the enhancement factor; c_w = omega_max = 0
//   for the Paterson-Budd law, which makes the water term 1);
//   K = sum_k 0.5 (f_k + f_k+1) (min(z_k+1, H) - min(z_k, H)), so levels
//   above the ice get weight 0;
//   D = min(C |grad s|^(n-1) K, d_cap) with C = 2 (rho g)^n, q = -D s_x on
//   east faces and -D s_y on north faces.
// Clamped neighbour indexing replaces the TPU kernel's edge-padded copies.
// E is read in the (My, Mx, Mz) layout and the levels z come as a device
// array (the TPU kernel rebuilds them in closed form). No fast math: exp and
// pow are the accurate library functions.
//
// What bounds it: per cell it reads 2 Mz enthalpies of its own column and of
// the east and north columns (3 Mz values, 0.7 KB at Mz = 61 in float32)
// and evaluates 2 Mz exponentials and powers. At EISMINT II's 61x61x61 it
// touches 0.9 MB and is bound by the launch; at 561x301x41 (28 MB of E)
// by reading E through the cache, with neighbouring threads Mz apart. A
// level-major layout or a shared-memory tile of E would coalesce the reads;
// that is left to a later redesign.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// the launch (0 = success). The kernel allocates nothing and launches on the
// stream it is given. The constants come as a host array of doubles in the
// order of struct Params below.

#include <cuda_runtime.h>

namespace {

constexpr int kParams = 19;

template <typename T>
struct Params {
  T n1;          // n + 1, the depth exponent
  T slope_pow;   // (n - 1) / 2, the exponent of |grad s|^2
  T C;           // 2 (rho g)^n
  T dx, dy;
  T T_melting, T_ref, c_i, L0, beta, rho_g;
  T A_cold, A_warm, Q_cold, Q_warm, T_crit, R;   // A_* times enhancement
  T wfc, wfl;    // water-fraction coefficient and its cap of omega
  T d_cap;       // infinity when D is not capped
};

// NaN in x passes through, as in jnp.maximum / jnp.minimum
template <typename T>
__device__ __forceinline__ T max0(T x, T y) { return x < y ? y : x; }
template <typename T>
__device__ __forceinline__ T min0(T x, T y) { return x > y ? y : x; }

__device__ __forceinline__ int clampi(int k, int n) {
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

// the integrand A(E, p) (1 + c_w omega) depth^(n+1) at one level
template <typename T>
__device__ __forceinline__ T f_level(const Params<T>& p, T Hf, T zk, T Ek) {
  const T depth = max0(Hf - zk, T(0));
  const T pr = T(101325) + p.rho_g * depth;
  const T Tm = p.T_melting - p.beta * pr;
  const T Es = p.c_i * (Tm - p.T_ref);
  const T Tk = Ek < Es ? p.T_ref + Ek / p.c_i : Tm;
  const T T_pa = Tk - Tm + p.T_melting;
  const bool cold = T_pa < p.T_crit;
  const T A = cold ? p.A_cold : p.A_warm;
  const T Q = cold ? p.Q_cold : p.Q_warm;
  const T soft = A * exp(-Q / (p.R * T_pa));
  const T omega = min0(min0(max0((Ek - Es) / p.L0, T(0)), T(1)), p.wfl);
  return soft * (T(1) + p.wfc * omega) * pow(depth, p.n1);
}

template <typename T>
__global__ void sia_thermo_kernel(
    const T* __restrict__ H, const T* __restrict__ s, const T* __restrict__ E,
    const T* __restrict__ z, T* __restrict__ qe, T* __restrict__ qn,
    T* __restrict__ De, T* __restrict__ Dn, int My, int Mx, int Mz,
    Params<T> p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Mx || j >= My) return;
  const int jn = clampi(j + 1, My), js = clampi(j - 1, My);
  const int ie = clampi(i + 1, Mx), iw = clampi(i - 1, Mx);
  const size_t c = (size_t)j * Mx + i;
  const size_t e = (size_t)j * Mx + ie, w = (size_t)j * Mx + iw;
  const size_t n = (size_t)jn * Mx + i, ne = (size_t)jn * Mx + ie;
  const size_t nw = (size_t)jn * Mx + iw;
  const size_t so = (size_t)js * Mx + i, se = (size_t)js * Mx + ie;

  const T H_e = T(0.5) * (H[c] + H[e]);
  const T H_n = T(0.5) * (H[c] + H[n]);
  const T sx_e = (s[e] - s[c]) / p.dx;
  const T sy_e = (s[n] + s[ne] - s[so] - s[se]) / (T(4) * p.dy);
  const T sy_n = (s[n] - s[c]) / p.dy;
  const T sx_n = (s[e] + s[ne] - s[w] - s[nw]) / (T(4) * p.dx);

  const T* Ec = E + c * Mz;
  const T* Ee = E + e * Mz;
  const T* En = E + n * Mz;
  T Ke = T(0), Kn = T(0);
  T z_lo = z[0];
  T fe_lo = f_level(p, H_e, z_lo, T(0.5) * (Ec[0] + Ee[0]));
  T fn_lo = f_level(p, H_n, z_lo, T(0.5) * (Ec[0] + En[0]));
  for (int k = 0; k + 1 < Mz; ++k) {
    const T z_hi = z[k + 1];
    const T fe_hi = f_level(p, H_e, z_hi, T(0.5) * (Ec[k + 1] + Ee[k + 1]));
    const T fn_hi = f_level(p, H_n, z_hi, T(0.5) * (Ec[k + 1] + En[k + 1]));
    Ke = Ke + T(0.5) * (fe_lo + fe_hi) * (min0(z_hi, H_e) - min0(z_lo, H_e));
    Kn = Kn + T(0.5) * (fn_lo + fn_hi) * (min0(z_hi, H_n) - min0(z_lo, H_n));
    fe_lo = fe_hi;
    fn_lo = fn_hi;
    z_lo = z_hi;
  }

  const T slope2_e = sx_e * sx_e + sy_e * sy_e;
  const T slope2_n = sx_n * sx_n + sy_n * sy_n;
  const T De_ = min0(p.C * pow(slope2_e, p.slope_pow) * Ke, p.d_cap);
  const T Dn_ = min0(p.C * pow(slope2_n, p.slope_pow) * Kn, p.d_cap);
  De[c] = De_;
  Dn[c] = Dn_;
  qe[c] = -De_ * sx_e;
  qn[c] = -Dn_ * sy_n;
}

template <typename T>
int launch_sia_thermo(const void* H, const void* s, const void* E,
                      const void* z, void* qe, void* qn, void* De, void* Dn,
                      int My, int Mx, int Mz, const double* c, void* stream) {
  if (My <= 0 || Mx <= 0) return 0;
  if (Mz < 1) return (int)cudaErrorInvalidValue;
  Params<T> p;
  const double n = c[0];
  p.n1 = T(n + 1.0);
  p.slope_pow = T((n - 1.0) / 2.0);
  p.C = T(c[1]);
  p.dx = T(c[2]);
  p.dy = T(c[3]);
  p.T_melting = T(c[4]);
  p.T_ref = T(c[5]);
  p.c_i = T(c[6]);
  p.L0 = T(c[7]);
  p.beta = T(c[8]);
  p.rho_g = T(c[9]);
  p.A_cold = T(c[10]);
  p.A_warm = T(c[11]);
  p.Q_cold = T(c[12]);
  p.Q_warm = T(c[13]);
  p.T_crit = T(c[14]);
  p.R = T(c[15]);
  p.wfc = T(c[16]);
  p.wfl = T(c[17]);
  p.d_cap = T(c[18]);
  const dim3 block(32, 8);
  const dim3 grid((Mx + block.x - 1) / block.x, (My + block.y - 1) / block.y);
  sia_thermo_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)H, (const T*)s, (const T*)E, (const T*)z, (T*)qe, (T*)qn,
      (T*)De, (T*)Dn, My, Mx, Mz, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pism_sia_thermo_nparams() { return kParams; }

int pism_sia_flux_thermo_f32(const void* H, const void* s, const void* E,
                             const void* z, void* qe, void* qn, void* De,
                             void* Dn, int My, int Mx, int Mz,
                             const double* params, void* stream) {
  return launch_sia_thermo<float>(H, s, E, z, qe, qn, De, Dn, My, Mx, Mz,
                                  params, stream);
}

int pism_sia_flux_thermo_f64(const void* H, const void* s, const void* E,
                             const void* z, void* qe, void* qn, void* De,
                             void* Dn, int My, int Mx, int Mz,
                             const double* params, void* stream) {
  return launch_sia_thermo<double>(H, s, E, z, qe, qn, De, Dn, My, Mx, Mz,
                                   params, stream);
}

}  // extern "C"
