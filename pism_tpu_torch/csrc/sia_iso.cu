// Fused isothermal SIA diffusivity and flux for Hopper (sm_90a), float and
// double.
//
// Replaces the TPU kernel sia_flux_pallas_padded of
// pism_tpu/ops/pallas_kernels.py (body _sia_kernel, called through
// sia_flux_pallas). It computes what that kernel computes, on the east and
// the north face of every cell:
//
//   H_e = (H + H_east) / 2, H_n = (H + H_north) / 2;
//   Mahaffy face gradients of s: one-sided across the face, the 4-point
//   average along it (divided by 4 dx or 4 dy);
//   D = min(gamma H_f^(n+2) |grad s|^(n-1), d_cap) on each face, with
//   gamma = 2 e A (rho g)^n / (n + 2);
//   q_e = -D_e ds/dx, q_n = -D_n ds/dy;
//
// and, in the same launch, max(D) over both faces of every cell
// (grid_max.cuh), which the TPU wrapper takes after its kernel. H and s are
// read unpadded with clamped neighbour indices, which is the edge semantics
// of the TPU kernel's jnp.pad(mode="edge") copies.
//
// Rounding: every sum, difference, product and quotient goes through the
// _rn intrinsics, so nvcc cannot contract a product and a sum into one
// fused multiply-add; the kernel then rounds as the plain torch version
// (ops/kernels/sia_iso.py sia_flux_plain) does, statement for statement.
// No fast math: pow is the accurate library function, called only where
// its value is not known exactly without it. For n = 3 the slope's
// exponent (n - 1) / 2 is 1, and in float32 pow(x, 1) returns x to the bit
// (scripts/sia_kernels_study.py checks every float32 pattern on the card),
// so a float32 launch with n = 3 leaves out two of the four pow calls; not
// in float64, where the library's pow(x, 1) differs from x for some x (the
// same script counts them). On an ice-free face pow(0, n + 2) is 0, its
// sign as C99 sets it, so the kernel writes that without the call.
//
// What bounds it: per cell it reads H and s and writes four values, 24
// bytes in float32; at 601 x 601 that is 8.7 MB, 2.6 us at 3.35 TB/s. Its
// arithmetic, four pow calls and four IEEE divisions a cell, takes the
// longer at the paths' sizes, and a launch of few cells its latency. So
// the kernel saves pow calls (above) and spreads the work: a block of
// kIsoX x kIsoY threads walks tiles of cells, one or two cells of a column
// per thread (two where the cells outnumber the threads the card holds);
// a thread reads the rows of s and H it needs at once (three columns of s
// over its rows and the two beside them, two of H over its rows and the
// one above), so the cells of a column share their reads, and works down
// the column. The grid is the blocks the card holds at once, so that the
// max of D is taken once per resident block. Neighbouring threads take
// neighbouring x, so every read and write is coalesced.
//
// An ensemble's members (the JAX package vmaps this kernel, and pallas_call
// gives each member its own grid steps) are blockIdx.y: B members of one
// grid in one launch, H, s and the outputs (B, My, Mx) contiguous, each
// member's tiles walked by its own blocks (the resident blocks shared out
// among the members), and a max of D per member. A member's cells compute
// what a launch of that member alone computes.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// the launch (0 = success). The kernel allocates nothing and launches on
// the stream it is given; the caller gives it grid_max's two words of work
// (or a null max pointer). The constants come as a host array of doubles
// in the order of struct Params below.

#include <cuda_runtime.h>
#include <math.h>

#include "grid_max.cuh"

namespace {

constexpr int kParams = 8;
constexpr int kIsoX = 32;      // threads along x per block
constexpr int kIsoY = 8;       // threads along y per block
// cells per SM from which a thread takes two cells of its column
constexpr int kIsoTwoRowsCellsPerSM = 2048;

template <typename T>
struct Params {
  T gamma;       // 2 e A (rho g)^n / (n + 2)
  T np2;         // n + 2, the exponent of H
  T slope_pow;   // (n - 1) / 2, the exponent of |grad s|^2
  T dx, dy;
  T four_dx, four_dy;
  T d_cap;       // infinity when D is not capped
  int h_zero;    // pow(0, n+2): 0 call pow, 1 it is +0, 2 it is the zero
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

// |grad s|^(n-1) from the squared slope; Pow1: the exponent is 1
template <bool Pow1, typename T>
__device__ __forceinline__ T slope_term(T slope2, T slope_pow) {
  return Pow1 ? slope2 : pow(slope2, slope_pow);
}

// H_f^(n+2); on an ice-free face (H_f = +-0) the value pow gives there
// without calling it: for n + 2 > 0, +0, or the zero itself where n + 2 is
// an odd integer (C99 and the CUDA math library)
template <typename T>
__device__ __forceinline__ T thickness_term(T Hf, const Params<T>& p) {
  if (p.h_zero != 0 && Hf == T(0)) return p.h_zero == 2 ? Hf : T(0);
  return pow(Hf, p.np2);
}

// D, q of the RY cells of column i, rows j0 .. j0+RY-1, that lie in the
// grid; returns their max of D (-inf if none)
template <typename T, int RY, bool Pow1>
__device__ __forceinline__ T iso_cells(const T* __restrict__ H,
                                       const T* __restrict__ s,
                                       T* __restrict__ qe, T* __restrict__ qn,
                                       T* __restrict__ De, T* __restrict__ Dn,
                                       int i, int j0, int My, int Mx,
                                       const Params<T>& p) {
  const bool col = i < Mx;
  const int ic = col ? i : Mx - 1;
  const int ie = clampi(i + 1, Mx), iw = clampi(i - 1, Mx);

  // s at columns iw, i, ie of rows j0-1 .. j0+RY (slot r: row j0-1+r), H at
  // columns i, ie of rows j0 .. j0+RY (slot r: row j0+r), clamped
  T sw[RY + 2], sc[RY + 2], sE[RY + 2], hc[RY + 1], hE[RY + 1];
#pragma unroll
  for (int r = 0; r < RY + 2; ++r) {
    const size_t row = (size_t)clampi(j0 - 1 + r, My) * Mx;
    sw[r] = s[row + iw];
    sc[r] = s[row + ic];
    sE[r] = s[row + ie];
  }
#pragma unroll
  for (int r = 0; r < RY + 1; ++r) {
    const size_t row = (size_t)clampi(j0 + r, My) * Mx;
    hc[r] = H[row + ic];
    hE[r] = H[row + ie];
  }

  T D = -T(INFINITY);
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int j = j0 + r;
    if (!col || j >= My) continue;
    // the cell's own row is slot r + 1 of s, its north row r + 2, its
    // south row r; of H its own row is slot r, its north row r + 1
    const T H_e = mul_rn(T(0.5), add_rn(hc[r], hE[r]));
    const T H_n = mul_rn(T(0.5), add_rn(hc[r], hc[r + 1]));

    const T sx_e = div_rn(sub_rn(sE[r + 1], sc[r + 1]), p.dx);
    const T sy_e = div_rn(sub_rn(sub_rn(add_rn(sc[r + 2], sE[r + 2]), sc[r]),
                                 sE[r]), p.four_dy);
    const T sy_n = div_rn(sub_rn(sc[r + 2], sc[r + 1]), p.dy);
    const T sx_n = div_rn(sub_rn(sub_rn(add_rn(sE[r + 1], sE[r + 2]),
                                        sw[r + 1]), sw[r + 2]), p.four_dx);

    const T slope2_e = add_rn(mul_rn(sx_e, sx_e), mul_rn(sy_e, sy_e));
    const T slope2_n = add_rn(mul_rn(sx_n, sx_n), mul_rn(sy_n, sy_n));

    const T De_ = min0(mul_rn(mul_rn(p.gamma, thickness_term(H_e, p)),
                              slope_term<Pow1>(slope2_e, p.slope_pow)),
                       p.d_cap);
    const T Dn_ = min0(mul_rn(mul_rn(p.gamma, thickness_term(H_n, p)),
                              slope_term<Pow1>(slope2_n, p.slope_pow)),
                       p.d_cap);
    const size_t c = (size_t)j * Mx + i;
    De[c] = De_;
    Dn[c] = Dn_;
    qe[c] = mul_rn(-De_, sx_e);
    qn[c] = mul_rn(-Dn_, sy_n);
    D = max_nan(D, max_nan(De_, Dn_));
  }
  return D;
}

// A block walks the tiles of BX x (BY RY) cells blockIdx.x, blockIdx.x +
// gridDim.x, ... of member blockIdx.y: a grid of the blocks the card holds
// at once, so that the max of D is taken once per resident block
template <typename T, int BX, int BY, int RY, bool Pow1>
__global__ void __launch_bounds__(BX * BY) sia_iso_kernel(
    const T* __restrict__ H, const T* __restrict__ s, T* __restrict__ qe,
    T* __restrict__ qn, T* __restrict__ De, T* __restrict__ Dn,
    unsigned long long* __restrict__ work, T* __restrict__ maxD, int B,
    int My, int Mx, int tiles_x, int tiles,
    Params<T> p) {
  const size_t m = (size_t)blockIdx.y * My * Mx;   // the member's offset
  H += m;
  s += m;
  qe += m;
  qn += m;
  De += m;
  Dn += m;
  T D = -T(INFINITY);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i = (t % tiles_x) * BX + threadIdx.x;
    const int j0 = ((t / tiles_x) * BY + threadIdx.y) * RY;
    D = max_nan(D, iso_cells<T, RY, Pow1>(H, s, qe, qn, De, Dn, i, j0, My, Mx,
                                          p));
  }
  if (maxD != nullptr) grid_max<T, BX * BY>(D, work, maxD, blockIdx.y, B);
}

// fast: pow(0, n + 2) without pow where exact (see thickness_term)
template <typename T>
Params<T> params_from(const double* c, bool fast) {
  Params<T> p;
  p.gamma = T(c[0]);
  p.np2 = T(c[1]);
  p.slope_pow = T(c[2]);
  p.dx = T(c[3]);
  p.dy = T(c[4]);
  p.four_dx = T(c[5]);
  p.four_dy = T(c[6]);
  p.d_cap = T(c[7]);
  const double np2 = c[1];
  const bool odd = np2 == floor(np2) && fmod(np2, 2.0) == 1.0;
  p.h_zero = !fast || !(np2 > 0.0) ? 0 : (odd ? 2 : 1);
  return p;
}

// the tiles of a launch: along x, and in all
int2 iso_tiles(int My, int Mx, int BX, int BY, int RY) {
  const int tx = (Mx + BX - 1) / BX, ty = (My + BY * RY - 1) / (BY * RY);
  return make_int2(tx, tx * ty);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0 &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) !=
          cudaSuccess)
    sms = 132;
  return sms;
}

// the resident blocks shared out among the B members, at least one each
template <typename T, int BX, int BY, int RY, bool Pow1>
int launch_iso(const void* H, const void* s, void* qe, void* qn, void* De,
               void* Dn, void* work, void* maxD, int B, int My, int Mx,
               const Params<T>& p, cudaStream_t stream) {
  static int per_sm = 0;
  if (per_sm == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sia_iso_kernel<T, BX, BY, RY, Pow1>, BX * BY, 0) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  const int2 t = iso_tiles(My, Mx, BX, BY, RY);
  const int blocks = min(t.y, max(per_sm * sm_count() / B, 1));
  sia_iso_kernel<T, BX, BY, RY, Pow1>
      <<<dim3(blocks, B), dim3(BX, BY), 0, stream>>>(
          (const T*)H, (const T*)s, (T*)qe, (T*)qn, (T*)De, (T*)Dn,
          (unsigned long long*)work, (T*)maxD, B, My, Mx, t.x, t.y, p);
  return (int)cudaGetLastError();
}

// the tile BX x BY x RY; unless always_pow, pow(x, 1) left out for n = 3
// in float32 and pow(0, n + 2) on ice-free faces
template <typename T, int BX, int BY, int RY>
int launch_tile(const void* H, const void* s, void* qe, void* qn, void* De,
                void* Dn, void* work, void* maxD, int B, int My, int Mx,
                const double* c, cudaStream_t stream, bool always_pow) {
  if (B <= 0 || My <= 0 || Mx <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const Params<T> p = params_from<T>(c, !always_pow);
  if (!always_pow && sizeof(T) == sizeof(float) && c[2] == 1.0)
    return launch_iso<T, BX, BY, RY, true>(H, s, qe, qn, De, Dn, work, maxD,
                                           B, My, Mx, p, stream);
  return launch_iso<T, BX, BY, RY, false>(H, s, qe, qn, De, Dn, work, maxD,
                                          B, My, Mx, p, stream);
}

// two rows a thread where the cells (of all members) are more than the
// card holds threads, else one (PERF.md has the times)
template <typename T>
int launch_sia_iso(const void* H, const void* s, void* qe, void* qn,
                   void* De, void* Dn, void* work, void* maxD, int B, int My,
                   int Mx, const double* c, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if ((long long)B * My * Mx >=
      (long long)sm_count() * kIsoTwoRowsCellsPerSM)
    return launch_tile<T, kIsoX, kIsoY, 2>(H, s, qe, qn, De, Dn, work, maxD,
                                           B, My, Mx, c, st, false);
  return launch_tile<T, kIsoX, kIsoY, 1>(H, s, qe, qn, De, Dn, work, maxD, B,
                                         My, Mx, c, st, false);
}

}  // namespace

extern "C" {

int pism_sia_iso_nparams() { return kParams; }

// maxD (one value) may be null, and then work is not touched
int pism_sia_flux_f32(const void* H, const void* s, void* qe, void* qn,
                      void* De, void* Dn, void* work, void* maxD, int My,
                      int Mx, const double* params, void* stream) {
  return launch_sia_iso<float>(H, s, qe, qn, De, Dn, work, maxD, 1, My, Mx,
                               params, stream);
}

int pism_sia_flux_f64(const void* H, const void* s, void* qe, void* qn,
                      void* De, void* Dn, void* work, void* maxD, int My,
                      int Mx, const double* params, void* stream) {
  return launch_sia_iso<double>(H, s, qe, qn, De, Dn, work, maxD, 1, My, Mx,
                                params, stream);
}

// B members in one launch, every array (B, My, Mx) contiguous; maxD (B
// values) may be null, and then work (a ticket and B keys) is not touched
int pism_sia_flux_members_f32(const void* H, const void* s, void* qe,
                              void* qn, void* De, void* Dn, void* work,
                              void* maxD, int B, int My, int Mx,
                              const double* params, void* stream) {
  return launch_sia_iso<float>(H, s, qe, qn, De, Dn, work, maxD, B, My, Mx,
                               params, stream);
}

int pism_sia_flux_members_f64(const void* H, const void* s, void* qe,
                              void* qn, void* De, void* Dn, void* work,
                              void* maxD, int B, int My, int Mx,
                              const double* params, void* stream) {
  return launch_sia_iso<double>(H, s, qe, qn, De, Dn, work, maxD, B, My, Mx,
                                params, stream);
}

}  // extern "C"
