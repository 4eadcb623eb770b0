// Fused thermomechanical SIA diffusivity and flux for Hopper (sm_90a),
// float and double.
//
// Replaces the TPU kernel sia_flux_thermo_pallas_padded of
// pism_tpu/ops/pallas_kernels.py (body _sia_thermo_body, called through
// sia_flux_thermo_pallas). It computes what that kernel computes, on the
// east and the north face of every cell:
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
//   east faces and -D s_y on north faces;
// and, in the same launch, max(D) over both faces of every cell.
// Clamped neighbour indexing replaces the TPU kernel's edge-padded copies.
// The levels z come as a device array (the TPU kernel rebuilds them in
// closed form). No fast math: exp and pow are the accurate library
// functions.
//
// Design. What bounds it is the integrand: 2 Mz evaluations per cell, each
// with an exp, a pow and three IEEE divisions (about 180 instructions
// outside their slow paths), against 3 Mz enthalpies read per cell; and at
// the paths' sizes (61 x 61 cells, 33 x 33 per shard of a 2x2 mesh) the
// latency of few cells. The level kernel spreads the levels over threads:
// a block is a strip of cells of one row and all the levels; its threads
// lie with the cell index fastest and step through the levels, so each
// thread evaluates the integrand of both faces at its (cell, level) and a
// warp reads a row of E at one level. The values go to shared memory;
// after a barrier one thread per (cell, face) adds the trapezoid in the
// order k = 0 .. Mz-2, the order of a thread that walks the column alone,
// and finishes D and q. The levels pass through shared memory kChunk at a
// time, the summing thread carrying its partial sum and the last level's
// value, so any Mz fits and the order of the sum does not change. Where
// the cells alone fill the card, the column kernel takes a thread per cell
// that walks its column as the TPU kernel's body does; route_for picks the
// kernel and the level block from the cells per SM. Both keep the
// expressions of a thread per cell (the squared slope's rounding written
// out), so the result is that kernel's to the bit. Where a level lies at
// or above the face's ice (depth 0) and the face enthalpy is not below 0,
// the integrand is exactly +0 for the flow laws' constants (pow(0, n+1) =
// 0 times a finite softness), so the thread stores 0 without the exp and
// the pow; the launcher allows that only for constants under which it is
// exact (skip_exact), and a NaN enthalpy still goes through the integrand.
//
// E is read through its three element strides, so the level-major layout
// the energy step leaves ((Mz, My, Mx) in memory, (My, Mx, Mz) as viewed)
// needs no copy and its rows at one level are read coalesced; a contiguous
// (My, Mx, Mz) array goes through the same kernel.
//
// The max of D comes from grid_max.cuh in the same launch. Without a max
// pointer (one shard of a mesh, whose ghost cells must not count) that
// step is left out.
//
// An ensemble's members (the JAX package vmaps this kernel, and pallas_call
// gives each member its own grid steps) are blockIdx.z: B members of one
// grid in one launch, H, s and the outputs (B, My, Mx) contiguous, E with
// a member stride beside its three others, and a max of D per member. A
// member's cells compute what a launch of that member alone computes, the
// same expressions in the same order; the route is picked by the cells of
// all members, and every route gives a thread per cell's bits.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// the launch (0 = success). The kernel allocates nothing and launches on the
// stream it is given; the caller gives it grid_max's two words of work
// (which each launch leaves as it found them). The constants come as a
// host array of doubles in the order of struct Params below.

#include <cuda_runtime.h>

#include "grid_max.cuh"

namespace {

constexpr int kParams = 19;
constexpr int kChunk = 64;     // levels per pass through shared memory
// the level kernel's blocks: cells of one row x threads along the levels
constexpr int kNarrowX = 8, kNarrowY = 32;
constexpr int kWideX = 32, kWideY = 8;
constexpr int kColumnX = 32, kColumnY = 8;   // the column kernel's block
// cells per SM from which a launch takes the wide block, the column kernel
constexpr int kNarrowCellsPerSM = 48;
constexpr int kColumnCellsPerSM = 640;

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

__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float fma_rn(float x, float y, float z) {
  return __fmaf_rn(x, y, z);
}
__device__ __forceinline__ double fma_rn(double x, double y, double z) {
  return __fma_rn(x, y, z);
}

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

// f_level, or its exact +0 without the exp and the pow where the level is
// at or above the face's ice and E >= 0 (NaN fails both tests)
template <bool Skip, typename T>
__device__ __forceinline__ T f_face(const Params<T>& p, T Hf, T zk, T Ek) {
  if (Skip && max0(Hf - zk, T(0)) == T(0) && Ek >= T(0)) return T(0);
  return f_level(p, Hf, zk, Ek);
}

// offsets of a cell (j, i) and of the neighbours its two faces read,
// clamped to the grid
struct Stencil {
  int ie, jn;
  size_t c, e, w, n, ne, nw, so, se;
  __device__ __forceinline__ Stencil(int j, int i, int My, int Mx) {
    jn = clampi(j + 1, My);
    ie = clampi(i + 1, Mx);
    const int js = clampi(j - 1, My), iw = clampi(i - 1, Mx);
    c = (size_t)j * Mx + i;
    e = (size_t)j * Mx + ie;
    w = (size_t)j * Mx + iw;
    n = (size_t)jn * Mx + i;
    ne = (size_t)jn * Mx + ie;
    nw = (size_t)jn * Mx + iw;
    so = (size_t)js * Mx + i;
    se = (size_t)js * Mx + ie;
  }
};

// the values of s a face's gradient reads: across the face, then along it
// (east: e, c, n, ne, so, se; north: n, c, e, ne, w, nw). In the squared
// slope a^2 + b^2 the compiler may fuse either product into the sum, and
// chooses by the code around it; the faces fix one rounding (the
// across-face square fused, the along-face one rounded first, as nvcc
// compiled a thread per cell), so that every kernel here gives its bits.
template <typename T>
__device__ __forceinline__ void face_s(const T* s, const Stencil& x,
                                       bool north, T v[6]) {
  v[0] = s[north ? x.n : x.e];
  v[1] = s[x.c];
  v[2] = s[north ? x.e : x.n];
  v[3] = s[x.ne];
  v[4] = s[north ? x.w : x.so];
  v[5] = s[north ? x.nw : x.se];
}

// D and q of the east face from its integral K and face_s; returns D
template <typename T>
__device__ __forceinline__ T east_face(const Params<T>& p, const T v[6], T K,
                                       T& q) {
  const T sx_e = (v[0] - v[1]) / p.dx;
  const T sy_e = (v[2] + v[3] - v[4] - v[5]) / (T(4) * p.dy);
  const T slope2_e = fma_rn(sx_e, sx_e, mul_rn(sy_e, sy_e));
  const T D = min0(p.C * pow(slope2_e, p.slope_pow) * K, p.d_cap);
  q = -D * sx_e;
  return D;
}

// D and q of the north face from its integral K and face_s; returns D
template <typename T>
__device__ __forceinline__ T north_face(const Params<T>& p, const T v[6], T K,
                                        T& q) {
  const T sy_n = (v[0] - v[1]) / p.dy;
  const T sx_n = (v[2] + v[3] - v[4] - v[5]) / (T(4) * p.dx);
  const T slope2_n = fma_rn(sy_n, sy_n, mul_rn(sx_n, sx_n));
  const T D = min0(p.C * pow(slope2_n, p.slope_pow) * K, p.d_cap);
  q = -D * sy_n;
  return D;
}

// The levels in parallel: a block is TX cells of row blockIdx.y, its
// threads (tx, ty) evaluate levels ty, ty + TY, ... of cell tx
template <typename T, int TX, int TY, bool Skip>
__global__ void __launch_bounds__(TX * TY) sia_thermo_kernel(
    const T* __restrict__ H, const T* __restrict__ s, const T* __restrict__ E,
    const T* __restrict__ z, T* __restrict__ qe, T* __restrict__ qn,
    T* __restrict__ De, T* __restrict__ Dn, unsigned long long* __restrict__ work,
    T* __restrict__ maxD, int B, int My, int Mx,
    int Mz, long long sb, long long sy, long long sx, long long sz,
    Params<T> p) {
  // the integrand of the chunk's levels, [face][level][cell], and the
  // chunk's levels
  __shared__ T f[2][kChunk][TX];
  __shared__ T zs[kChunk];
  const size_t m = (size_t)blockIdx.z * My * Mx;   // the member's offset
  H += m;
  s += m;
  E += blockIdx.z * sb;
  qe += m;
  qn += m;
  De += m;
  Dn += m;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = blockIdx.x * TX + tx, j = blockIdx.y;
  const bool in = i < Mx;
  const Stencil x(j, i, My, Mx);
  // ty 0 sums the east face of cell i, ty 1 the north face; they read the
  // face's s before the levels, so that the read is not waited for after
  const bool summer = in && ty < 2;
  T sv[6];
  if (summer) face_s(s, x, ty == 1, sv);

  T H_e = T(0), H_n = T(0);
  if (in) {
    H_e = T(0.5) * (H[x.c] + H[x.e]);
    H_n = T(0.5) * (H[x.c] + H[x.n]);
  }
  const T* Ec = E + j * sy + i * sx;
  const T* Ee = E + j * sy + x.ie * sx;
  const T* En = E + x.jn * sy + i * sx;

  const T Hf = ty == 0 ? H_e : H_n;
  T K = T(0), f_lo = T(0), z_lo = T(0);
  for (int k0 = 0; k0 < Mz; k0 += kChunk) {
    const int kn = min(kChunk, Mz - k0);
    for (int kk = ty; kk < kn; kk += TY) {
      const long long k = k0 + kk;
      const T zk = z[k];
      if (tx == 0) zs[kk] = zk;
      if (in) {
        const T Eck = Ec[k * sz];
        f[0][kk][tx] = f_face<Skip>(p, H_e, zk, T(0.5) * (Eck + Ee[k * sz]));
        f[1][kk][tx] = f_face<Skip>(p, H_n, zk, T(0.5) * (Eck + En[k * sz]));
      }
    }
    __syncthreads();
    if (summer) {
      int kk = 0;
      if (k0 == 0) {
        f_lo = f[ty][0][tx];
        z_lo = zs[0];
        kk = 1;
      }
#pragma unroll 8
      for (; kk < kn; ++kk) {
        const T z_hi = zs[kk];
        const T f_hi = f[ty][kk][tx];
        K = K + T(0.5) * (f_lo + f_hi) * (min0(z_hi, Hf) - min0(z_lo, Hf));
        f_lo = f_hi;
        z_lo = z_hi;
      }
    }
    __syncthreads();
  }

  T D = -T(INFINITY);
  if (summer) {
    T q;
    if (ty == 0) {
      D = east_face(p, sv, K, q);
      De[x.c] = D;
      qe[x.c] = q;
    } else {
      D = north_face(p, sv, K, q);
      Dn[x.c] = D;
      qn[x.c] = q;
    }
  }
  if (maxD != nullptr) grid_max<T, TX * TY>(D, work, maxD, blockIdx.z, B);
}

// A thread per cell walks the column, both faces at once: for launches of
// more cells than the card holds threads, where the levels need not be
// spread
template <typename T, bool Skip>
__global__ void __launch_bounds__(kColumnX * kColumnY) sia_thermo_column_kernel(
    const T* __restrict__ H, const T* __restrict__ s, const T* __restrict__ E,
    const T* __restrict__ z, T* __restrict__ qe, T* __restrict__ qn,
    T* __restrict__ De, T* __restrict__ Dn, unsigned long long* __restrict__ work,
    T* __restrict__ maxD, int B, int My, int Mx,
    int Mz, long long sb, long long sy, long long sx, long long sz,
    Params<T> p) {
  const size_t m = (size_t)blockIdx.z * My * Mx;   // the member's offset
  H += m;
  s += m;
  E += blockIdx.z * sb;
  qe += m;
  qn += m;
  De += m;
  Dn += m;
  const int i = blockIdx.x * kColumnX + threadIdx.x;
  const int j = blockIdx.y * kColumnY + threadIdx.y;
  T D = -T(INFINITY);
  if (i < Mx && j < My) {
    const Stencil x(j, i, My, Mx);
    const T H_e = T(0.5) * (H[x.c] + H[x.e]);
    const T H_n = T(0.5) * (H[x.c] + H[x.n]);
    const T* Ec = E + j * sy + i * sx;
    const T* Ee = E + j * sy + x.ie * sx;
    const T* En = E + x.jn * sy + i * sx;
    T Ke = T(0), Kn = T(0);
    T z_lo = z[0];
    T fe_lo = f_face<Skip>(p, H_e, z_lo, T(0.5) * (Ec[0] + Ee[0]));
    T fn_lo = f_face<Skip>(p, H_n, z_lo, T(0.5) * (Ec[0] + En[0]));
    for (long long k = 1; k < Mz; ++k) {
      const T z_hi = z[k];
      const T Eck = Ec[k * sz];
      const T fe_hi = f_face<Skip>(p, H_e, z_hi, T(0.5) * (Eck + Ee[k * sz]));
      const T fn_hi = f_face<Skip>(p, H_n, z_hi, T(0.5) * (Eck + En[k * sz]));
      Ke = Ke + T(0.5) * (fe_lo + fe_hi) * (min0(z_hi, H_e) - min0(z_lo, H_e));
      Kn = Kn + T(0.5) * (fn_lo + fn_hi) * (min0(z_hi, H_n) - min0(z_lo, H_n));
      fe_lo = fe_hi;
      fn_lo = fn_hi;
      z_lo = z_hi;
    }
    T ve[6], vn[6], q_e, q_n;
    face_s(s, x, false, ve);
    face_s(s, x, true, vn);
    const T De_ = east_face(p, ve, Ke, q_e);
    const T Dn_ = north_face(p, vn, Kn, q_n);
    De[x.c] = De_;
    qe[x.c] = q_e;
    Dn[x.c] = Dn_;
    qn[x.c] = q_n;
    D = max_nan(De_, Dn_);
  }
  if (maxD != nullptr)
    grid_max<T, kColumnX * kColumnY>(D, work, maxD, blockIdx.z, B);
}

template <typename T>
Params<T> params_from(const double* c) {
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
  return p;
}

// True when the integrand is exactly +0 at depth 0 for every E >= 0: the
// depth exponent is positive, so pow(0, n+1) = +0, and the factor before
// it is finite and not negative: c_i, L, R > 0, Q >= 0 and T_pa >= 1 K at
// depth 0 and E = 0 (T_pa only grows with E), so exp(-Q / (R T_pa)) <= 1;
// 0 <= A, c_w, omega_max <= 1e10 (omega <= 1), so the product stays
// finite in float. A NaN constant fails one of the tests.
bool skip_exact(const double* c) {
  const double n1 = c[0] + 1.0, T_melting = c[4], T_ref = c[5], c_i = c[6];
  const double L0 = c[7], beta = c[8], A_cold = c[10], A_warm = c[11];
  const double Q_cold = c[12], Q_warm = c[13], R = c[15], wfc = c[16];
  const double wfl = c[17];
  const double T_pa0 = T_ref - (T_melting - beta * 101325.0) + T_melting;
  return n1 > 0.0 && c_i > 0.0 && L0 > 0.0 && R > 0.0 && Q_cold >= 0.0 &&
         Q_warm >= 0.0 && A_cold >= 0.0 && A_cold <= 1e10 &&
         A_warm >= 0.0 && A_warm <= 1e10 && wfc >= 0.0 && wfc <= 1e10 &&
         wfl >= 0.0 && wfl <= 1e10 && T_pa0 >= 1.0 && R * T_pa0 >= 1e-30;
}

// What one launch reads and writes (E with its element strides, sb
// between members); work and maxD as grid_max takes them (B values), maxD
// null for no max
struct Launch {
  const void *H, *s, *E, *z;
  void *qe, *qn, *De, *Dn, *work, *maxD;
  int B, My, Mx, Mz;
  long long sb, sy, sx, sz;
  cudaStream_t stream;
};

int sm_count() {
  static int sms = 0;
  if (sms == 0 &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) !=
          cudaSuccess)
    sms = 132;
  return sms;
}

// The kernel and block of a launch, by its cells per SM (of all its
// members): the level kernel
// with a narrow block (8 cells x 32 level threads) while the cells are few,
// with a wide one (32 x 8) where a block's fixed cost (the serial sum, the
// block's max) weighs more than the parallel levels save, and a thread per
// column where the cells alone fill the card (PERF.md has the times)
enum class Route { kNarrow, kWide, kColumns };

Route route_for(int B, int My, int Mx) {
  const long long cells = (long long)B * My * Mx, sms = sm_count();
  if (cells < sms * kNarrowCellsPerSM) return Route::kNarrow;
  if (cells < sms * kColumnCellsPerSM) return Route::kWide;
  return Route::kColumns;
}

dim3 level_grid(int B, int My, int Mx, int TX) {
  return dim3((Mx + TX - 1) / TX, My, B);
}

dim3 column_grid(int B, int My, int Mx) {
  return dim3((Mx + kColumnX - 1) / kColumnX, (My + kColumnY - 1) / kColumnY,
              B);
}

template <typename T, int TX, int TY>
int launch_levels(const Launch& a, const Params<T>& p, bool skip) {
  const dim3 grid = level_grid(a.B, a.My, a.Mx, TX), block(TX, TY);
  const T *H = (const T*)a.H, *s = (const T*)a.s, *E = (const T*)a.E;
  const T* z = (const T*)a.z;
  T *qe = (T*)a.qe, *qn = (T*)a.qn, *De = (T*)a.De, *Dn = (T*)a.Dn;
  T* maxD = (T*)a.maxD;
  unsigned long long* work = (unsigned long long*)a.work;
  if (skip)
    sia_thermo_kernel<T, TX, TY, true><<<grid, block, 0, a.stream>>>(
        H, s, E, z, qe, qn, De, Dn, work, maxD, a.B, a.My, a.Mx, a.Mz,
        a.sb, a.sy, a.sx, a.sz, p);
  else
    sia_thermo_kernel<T, TX, TY, false><<<grid, block, 0, a.stream>>>(
        H, s, E, z, qe, qn, De, Dn, work, maxD, a.B, a.My, a.Mx, a.Mz,
        a.sb, a.sy, a.sx, a.sz, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_columns(const Launch& a, const Params<T>& p, bool skip) {
  const dim3 grid = column_grid(a.B, a.My, a.Mx), block(kColumnX, kColumnY);
  const T *H = (const T*)a.H, *s = (const T*)a.s, *E = (const T*)a.E;
  const T* z = (const T*)a.z;
  T *qe = (T*)a.qe, *qn = (T*)a.qn, *De = (T*)a.De, *Dn = (T*)a.Dn;
  T* maxD = (T*)a.maxD;
  unsigned long long* work = (unsigned long long*)a.work;
  if (skip)
    sia_thermo_column_kernel<T, true><<<grid, block, 0, a.stream>>>(
        H, s, E, z, qe, qn, De, Dn, work, maxD, a.B, a.My, a.Mx, a.Mz,
        a.sb, a.sy, a.sx, a.sz, p);
  else
    sia_thermo_column_kernel<T, false><<<grid, block, 0, a.stream>>>(
        H, s, E, z, qe, qn, De, Dn, work, maxD, a.B, a.My, a.Mx, a.Mz,
        a.sb, a.sy, a.sx, a.sz, p);
  return (int)cudaGetLastError();
}

bool launchable(const Launch& a) {
  return a.My > 0 && a.Mx > 0 && a.Mz >= 1 && a.My <= 65535 && a.B <= 65535;
}

template <typename T>
int launch_sia_thermo(const Launch& a, const double* c) {
  if (a.B <= 0 || a.My <= 0 || a.Mx <= 0) return 0;
  if (!launchable(a)) return (int)cudaErrorInvalidValue;
  const Params<T> p = params_from<T>(c);
  const bool skip = skip_exact(c);
  switch (route_for(a.B, a.My, a.Mx)) {
    case Route::kNarrow:
      return launch_levels<T, kNarrowX, kNarrowY>(a, p, skip);
    case Route::kWide: return launch_levels<T, kWideX, kWideY>(a, p, skip);
    default: return launch_columns<T>(a, p, skip);
  }
}

}  // namespace

extern "C" {

int pism_sia_thermo_nparams() { return kParams; }

// E (My, Mx, Mz) with element strides sy, sx, sz; maxD (one value) may be
// null, and then work is not touched
int pism_sia_flux_thermo_f32(const void* H, const void* s, const void* E,
                             const void* z, void* qe, void* qn, void* De,
                             void* Dn, void* work, void* maxD, int My, int Mx,
                             int Mz, long long sy, long long sx, long long sz,
                             const double* params, void* stream) {
  return launch_sia_thermo<float>(
      Launch{H, s, E, z, qe, qn, De, Dn, work, maxD, 1, My, Mx, Mz, 0, sy, sx,
             sz, (cudaStream_t)stream},
      params);
}

int pism_sia_flux_thermo_f64(const void* H, const void* s, const void* E,
                             const void* z, void* qe, void* qn, void* De,
                             void* Dn, void* work, void* maxD, int My, int Mx,
                             int Mz, long long sy, long long sx, long long sz,
                             const double* params, void* stream) {
  return launch_sia_thermo<double>(
      Launch{H, s, E, z, qe, qn, De, Dn, work, maxD, 1, My, Mx, Mz, 0, sy, sx,
             sz, (cudaStream_t)stream},
      params);
}

// B members in one launch: H, s and the outputs (B, My, Mx) contiguous, E
// (B, My, Mx, Mz) with element strides sb, sy, sx, sz; maxD (B values) may
// be null, and then work (a ticket and B keys) is not touched
int pism_sia_flux_thermo_members_f32(const void* H, const void* s,
                                     const void* E, const void* z, void* qe,
                                     void* qn, void* De, void* Dn, void* work,
                                     void* maxD, int B, int My, int Mx,
                                     int Mz, long long sb, long long sy,
                                     long long sx, long long sz,
                                     const double* params, void* stream) {
  return launch_sia_thermo<float>(
      Launch{H, s, E, z, qe, qn, De, Dn, work, maxD, B, My, Mx, Mz, sb, sy,
             sx, sz, (cudaStream_t)stream},
      params);
}

int pism_sia_flux_thermo_members_f64(const void* H, const void* s,
                                     const void* E, const void* z, void* qe,
                                     void* qn, void* De, void* Dn, void* work,
                                     void* maxD, int B, int My, int Mx,
                                     int Mz, long long sb, long long sy,
                                     long long sx, long long sz,
                                     const double* params, void* stream) {
  return launch_sia_thermo<double>(
      Launch{H, s, E, z, qe, qn, De, Dn, work, maxD, B, My, Mx, Mz, sb, sy,
             sx, sz, (cudaStream_t)stream},
      params);
}

}  // extern "C"
