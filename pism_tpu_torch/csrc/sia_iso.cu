// Fused isothermal SIA diffusivity and flux for Hopper (sm_90a), float and
// double.
//
// Replaces the TPU kernel sia_flux_pallas_padded of
// pism_tpu/ops/pallas_kernels.py (body _sia_kernel, called through
// sia_flux_pallas). It computes what that kernel computes, one thread per
// cell for both its east and its north face:
//
//   H_e = (H + H_east) / 2, H_n = (H + H_north) / 2;
//   Mahaffy face gradients of s: one-sided across the face, the 4-point
//   average along it (divided by 4 dx or 4 dy);
//   D = min(gamma H_f^(n+2) |grad s|^(n-1), d_cap) on each face, with
//   gamma = 2 e A (rho g)^n / (n + 2);
//   q_e = -D_e ds/dx, q_n = -D_n ds/dy.
//
// H and s are read unpadded with clamped neighbour indices, which is the
// edge semantics of the TPU kernel's jnp.pad(mode="edge") copies, so the
// two pad launches disappear. The wrapper takes max(D) outside the kernel,
// as the JAX wrapper does.
//
// Rounding: every sum, difference, product and quotient goes through the
// _rn intrinsics, so nvcc cannot contract a product and a sum into one
// fused multiply-add; the kernel then rounds as the plain torch version
// (ops/kernels/sia_iso.py sia_flux_plain) does, statement for statement.
// No fast math: pow is the accurate library function, and pow(0, n+2) = 0
// on ice-free faces.
//
// What bounds it: per cell it reads H and s (the neighbours come through
// the cache) and writes four values, 24 bytes in float32; at 601 x 601
// that is 8.7 MB, 2.6 us at 3.35 TB/s. It does about 40 operations per
// cell (four of them pow), far below the card's float32 rate, so memory
// bounds it. Neighbouring threads take neighbouring x, so every read and
// write is coalesced.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// the launch (0 = success). The kernel allocates nothing and launches on
// the stream it is given. The constants come as a host array of doubles in
// the order of struct Params below.

#include <cuda_runtime.h>

namespace {

constexpr int kParams = 8;

template <typename T>
struct Params {
  T gamma;       // 2 e A (rho g)^n / (n + 2)
  T np2;         // n + 2, the exponent of H
  T slope_pow;   // (n - 1) / 2, the exponent of |grad s|^2
  T dx, dy;
  T four_dx, four_dy;
  T d_cap;       // infinity when D is not capped
};

__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double sub_rn(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }
__device__ __forceinline__ double div_rn(double x, double y) { return __ddiv_rn(x, y); }

// NaN in x passes through, as in jnp.minimum / torch.minimum
template <typename T>
__device__ __forceinline__ T min0(T x, T y) { return x > y ? y : x; }

__device__ __forceinline__ int clampi(int k, int n) {
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

template <typename T>
__global__ void sia_iso_kernel(const T* __restrict__ H,
                               const T* __restrict__ s, T* __restrict__ qe,
                               T* __restrict__ qn, T* __restrict__ De,
                               T* __restrict__ Dn, int My, int Mx,
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

  const T H_e = mul_rn(T(0.5), add_rn(H[c], H[e]));
  const T H_n = mul_rn(T(0.5), add_rn(H[c], H[n]));

  const T sx_e = div_rn(sub_rn(s[e], s[c]), p.dx);
  const T sy_e = div_rn(sub_rn(sub_rn(add_rn(s[n], s[ne]), s[so]), s[se]),
                        p.four_dy);
  const T sy_n = div_rn(sub_rn(s[n], s[c]), p.dy);
  const T sx_n = div_rn(sub_rn(sub_rn(add_rn(s[e], s[ne]), s[w]), s[nw]),
                        p.four_dx);

  const T slope2_e = add_rn(mul_rn(sx_e, sx_e), mul_rn(sy_e, sy_e));
  const T slope2_n = add_rn(mul_rn(sx_n, sx_n), mul_rn(sy_n, sy_n));

  const T De_ = min0(mul_rn(mul_rn(p.gamma, pow(H_e, p.np2)),
                            pow(slope2_e, p.slope_pow)), p.d_cap);
  const T Dn_ = min0(mul_rn(mul_rn(p.gamma, pow(H_n, p.np2)),
                            pow(slope2_n, p.slope_pow)), p.d_cap);
  De[c] = De_;
  Dn[c] = Dn_;
  qe[c] = mul_rn(-De_, sx_e);
  qn[c] = mul_rn(-Dn_, sy_n);
}

template <typename T>
int launch_sia_iso(const void* H, const void* s, void* qe, void* qn,
                   void* De, void* Dn, int My, int Mx, const double* c,
                   void* stream) {
  if (My <= 0 || Mx <= 0) return 0;
  Params<T> p;
  p.gamma = T(c[0]);
  p.np2 = T(c[1]);
  p.slope_pow = T(c[2]);
  p.dx = T(c[3]);
  p.dy = T(c[4]);
  p.four_dx = T(c[5]);
  p.four_dy = T(c[6]);
  p.d_cap = T(c[7]);
  const dim3 block(32, 8);
  const dim3 grid((Mx + block.x - 1) / block.x, (My + block.y - 1) / block.y);
  sia_iso_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)H, (const T*)s, (T*)qe, (T*)qn, (T*)De, (T*)Dn, My, Mx, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pism_sia_iso_nparams() { return kParams; }

int pism_sia_flux_f32(const void* H, const void* s, void* qe, void* qn,
                      void* De, void* Dn, int My, int Mx,
                      const double* params, void* stream) {
  return launch_sia_iso<float>(H, s, qe, qn, De, Dn, My, Mx, params, stream);
}

int pism_sia_flux_f64(const void* H, const void* s, void* qe, void* qn,
                      void* De, void* Dn, int My, int Mx,
                      const double* params, void* stream) {
  return launch_sia_iso<double>(H, s, qe, qn, De, Dn, My, Mx, params, stream);
}

}  // extern "C"
