// SSA membrane-operator matvec for Hopper (sm_90a), float and double.
//
// K1 replaces the TPU kernel _ssa_matvec_kernel of
// pism_tpu/ops/pallas_kernels.py (called through _ssa_matvec_raw /
// ssa_matvec_pallas and its custom JVP). It computes what that kernel
// computes, one thread per cell:
//
//   A(u, v) = -div T + beta (u, v)
//
// with east-face stresses Txx_e = 2 nuH_e (2 u_x + v_y), Txy_e = nuH_e
// (u_y + v_x) and north-face stresses Txy_n = nuH_n (u_y + v_x), Tyy_n =
// 2 nuH_n (2 v_y + u_x); face gradients are one-sided across the face and
// 4-point averages along it. Clamped neighbour indexing replaces the edge
// padding of the TPU kernel, and the west and south face stresses are
// recomputed in the thread at the clamped indices i-1 and j-1: at i = 0 the
// west stress is the east stress itself, so that term of the divergence is
// exactly 0 (likewise at j = 0), which is the closure of the TPU kernel's
// shift_w / shift_s.
//
// K5 replaces _ssa_matvec_sharded_kernel of pism_tpu/ops/pallas_sharded.py
// (reached through _ssa_matvec_sharded_raw): the same operator on one shard
// of a mesh, read from blocks padded with ghost cells (two for u and v, one
// for nuH; beta has none) that the halo exchange filled. Its neighbour
// indices are offsets into the padded block instead of clamped indices, so
// the west/south face stresses of the shard's first column/row come from
// the neighbouring shard; where the shard owns the grid's west (south)
// edge, a flag restores the clamp (the TPU kernel's wclamp / sclamp). The
// face stresses and the divergence are the same device code as K1's, so on
// one card K5 over any mesh gives K1's result on the whole field, bit for
// bit.
//
// The JVP entry points fuse the forward-mode derivative of the operator,
// which is bilinear in ((u, v), (nuH, beta)):
//
//   J(d) = [A(du, dv; nuH, beta)] + [A(u, v; dnuH, dbeta)]
//
// in one pass, so a Newton matvec is one launch instead of two.
//
// What bounds them: per cell the plain matvec reads u, v, nuH_e, nuH_n, beta
// and writes Au, Av, 28 bytes in float32 (0.3 MB at the 20 km grid, 4.7 MB
// at 5 km; 80 KB per shard of the 20 km grid on a 2x2 mesh). Neighbour
// reads hit L1/L2. At these shapes the kernels are bound by launch latency,
// not by the 3.35 TB/s of device memory; the design therefore spends
// nothing on tiling or shared memory, and the next step is to cut launches
// (a CUDA graph over a Krylov iteration).
//
// C interface for ctypes: every function returns cudaGetLastError() after
// the launch (0 = success). The kernels allocate nothing and launch on the
// stream they are given.

#include <cuda_runtime.h>

namespace {

template <typename T>
struct FaceStress {
  T txx_e, txy_e, txy_n, tyy_n;
};

__device__ __forceinline__ int clampi(int k, int n) {
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

// Offset of cell (j, i) in a whole (My, Mx) field, clamped to the grid (K1).
struct ClampedIndex {
  int My, Mx;
  __device__ __forceinline__ size_t operator()(int j, int i) const {
    return (size_t)clampi(j, My) * Mx + clampi(i, Mx);
  }
};

// Offset of shard cell (j, i) in its block padded with `ghosts` cells on
// every side, of row length `pitch` (K5).
struct PaddedIndex {
  int pitch, ghosts;
  __device__ __forceinline__ size_t operator()(int j, int i) const {
    return (size_t)(j + ghosts) * pitch + (i + ghosts);
  }
};

// Stresses on the east face and the north face of cell (j, i); `at` gives
// the offsets of the velocities, `nu_at` those of nuH.
template <typename T, typename VelIndex, typename NuIndex>
__device__ __forceinline__ FaceStress<T> face_stress(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ nuHe, const T* __restrict__ nuHn,
    int j, int i, VelIndex at, NuIndex nu_at, T dx, T dy) {
  const size_t c = at(j, i);
  const size_t e = at(j, i + 1), w = at(j, i - 1);
  const size_t n = at(j + 1, i), ne = at(j + 1, i + 1);
  const size_t nw = at(j + 1, i - 1);
  const size_t s = at(j - 1, i), se = at(j - 1, i + 1);

  const T ux_e = (u[e] - u[c]) / dx;
  const T vx_e = (v[e] - v[c]) / dx;
  const T uy_e = (u[n] + u[ne] - u[s] - u[se]) / (T(4) * dy);
  const T vy_e = (v[n] + v[ne] - v[s] - v[se]) / (T(4) * dy);
  const T uy_n = (u[n] - u[c]) / dy;
  const T vy_n = (v[n] - v[c]) / dy;
  const T ux_n = (u[e] + u[ne] - u[w] - u[nw]) / (T(4) * dx);
  const T vx_n = (v[e] + v[ne] - v[w] - v[nw]) / (T(4) * dx);

  const size_t k = nu_at(j, i);
  const T nue = nuHe[k], nun = nuHn[k];
  FaceStress<T> f;
  f.txx_e = T(2) * nue * (T(2) * ux_e + vy_e);
  f.txy_n = nun * (uy_n + vx_n);
  f.tyy_n = T(2) * nun * (T(2) * vy_n + ux_n);
  f.txy_e = nue * (uy_e + vx_e);
  return f;
}

// -div T at (j, i) from the stresses of the four faces around the cell; the
// west face is the east face of cell (j, iw), the south face the north face
// of cell (js, i).
template <typename T, typename VelIndex, typename NuIndex>
__device__ __forceinline__ void minus_div(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ nuHe, const T* __restrict__ nuHn,
    int j, int i, int iw, int js, VelIndex at, NuIndex nu_at, T dx, T dy,
    T* mdx, T* mdy) {
  const FaceStress<T> c = face_stress(u, v, nuHe, nuHn, j, i, at, nu_at, dx, dy);
  const FaceStress<T> w = face_stress(u, v, nuHe, nuHn, j, iw, at, nu_at, dx, dy);
  const FaceStress<T> s = face_stress(u, v, nuHe, nuHn, js, i, at, nu_at, dx, dy);
  const T div_x = (c.txx_e - w.txx_e) / dx + (c.txy_n - s.txy_n) / dy;
  const T div_y = (c.txy_e - w.txy_e) / dx + (c.tyy_n - s.tyy_n) / dy;
  *mdx = -div_x;
  *mdy = -div_y;
}

template <typename T>
__global__ void ssa_matvec_kernel(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ nuHe, const T* __restrict__ nuHn,
    const T* __restrict__ beta, T* __restrict__ Au, T* __restrict__ Av,
    int My, int Mx, T dx, T dy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Mx || j >= My) return;
  const ClampedIndex at{My, Mx};
  T mx, my;
  minus_div(u, v, nuHe, nuHn, j, i, i > 0 ? i - 1 : 0, j > 0 ? j - 1 : 0, at,
            at, dx, dy, &mx, &my);
  const size_t k = (size_t)j * Mx + i;
  Au[k] = mx + beta[k] * u[k];
  Av[k] = my + beta[k] * v[k];
}

// J(d) = A(du, dv; nuH, beta) + A(u, v; dnuH, dbeta); dbeta may be null
// (a frozen drag coefficient).
template <typename T>
__global__ void ssa_matvec_jvp_kernel(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ du, const T* __restrict__ dv,
    const T* __restrict__ nuHe, const T* __restrict__ nuHn,
    const T* __restrict__ dnuHe, const T* __restrict__ dnuHn,
    const T* __restrict__ beta, const T* __restrict__ dbeta,
    T* __restrict__ Ju, T* __restrict__ Jv, int My, int Mx, T dx, T dy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Mx || j >= My) return;
  const size_t k = (size_t)j * Mx + i;
  const ClampedIndex at{My, Mx};
  const int iw = i > 0 ? i - 1 : 0, js = j > 0 ? j - 1 : 0;
  T mx1, my1, mx2, my2;
  minus_div(du, dv, nuHe, nuHn, j, i, iw, js, at, at, dx, dy, &mx1, &my1);
  minus_div(u, v, dnuHe, dnuHn, j, i, iw, js, at, at, dx, dy, &mx2, &my2);
  const T t1u = mx1 + beta[k] * du[k];
  const T t1v = my1 + beta[k] * dv[k];
  T t2u = mx2, t2v = my2;
  if (dbeta != nullptr) {
    t2u = mx2 + dbeta[k] * u[k];
    t2v = my2 + dbeta[k] * v[k];
  }
  Ju[k] = t1u + t2u;
  Jv[k] = t1v + t2v;
}

// K5: A(u, v) on one shard of my x mx cells. up, vp: (my+4, mx+4) blocks
// with two ghosts; nuHe, nuHn: (my+2, mx+2) with one; beta, Au, Av:
// (my, mx). west/south: the shard owns the grid's west/south edge.
template <typename T>
__global__ void ssa_matvec_halo_kernel(
    const T* __restrict__ up, const T* __restrict__ vp,
    const T* __restrict__ nuHe, const T* __restrict__ nuHn,
    const T* __restrict__ beta, T* __restrict__ Au, T* __restrict__ Av,
    int my, int mx, int west, int south, T dx, T dy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= mx || j >= my) return;
  const PaddedIndex at{mx + 4, 2}, nu_at{mx + 2, 1};
  T rx, ry;
  minus_div(up, vp, nuHe, nuHn, j, i, (west && i == 0) ? 0 : i - 1,
            (south && j == 0) ? 0 : j - 1, at, nu_at, dx, dy, &rx, &ry);
  const size_t k = (size_t)j * mx + i, c = at(j, i);
  Au[k] = rx + beta[k] * up[c];
  Av[k] = ry + beta[k] * vp[c];
}

// K5's JVP on one shard, the blocks as for K5 (du, dv with two ghosts,
// dnuH with one); dbeta may be null.
template <typename T>
__global__ void ssa_matvec_halo_jvp_kernel(
    const T* __restrict__ up, const T* __restrict__ vp,
    const T* __restrict__ dup, const T* __restrict__ dvp,
    const T* __restrict__ nuHe, const T* __restrict__ nuHn,
    const T* __restrict__ dnuHe, const T* __restrict__ dnuHn,
    const T* __restrict__ beta, const T* __restrict__ dbeta,
    T* __restrict__ Ju, T* __restrict__ Jv, int my, int mx, int west,
    int south, T dx, T dy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= mx || j >= my) return;
  const PaddedIndex at{mx + 4, 2}, nu_at{mx + 2, 1};
  const int iw = (west && i == 0) ? 0 : i - 1;
  const int js = (south && j == 0) ? 0 : j - 1;
  const size_t k = (size_t)j * mx + i, c = at(j, i);
  T mx1, my1, mx2, my2;
  minus_div(dup, dvp, nuHe, nuHn, j, i, iw, js, at, nu_at, dx, dy, &mx1, &my1);
  minus_div(up, vp, dnuHe, dnuHn, j, i, iw, js, at, nu_at, dx, dy, &mx2, &my2);
  const T t1u = mx1 + beta[k] * dup[c];
  const T t1v = my1 + beta[k] * dvp[c];
  T t2u = mx2, t2v = my2;
  if (dbeta != nullptr) {
    t2u = mx2 + dbeta[k] * up[c];
    t2v = my2 + dbeta[k] * vp[c];
  }
  Ju[k] = t1u + t2u;
  Jv[k] = t1v + t2v;
}

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

dim3 grid_for(int My, int Mx) {
  return dim3((Mx + kBlockX - 1) / kBlockX, (My + kBlockY - 1) / kBlockY);
}

template <typename T>
int launch_matvec(const void* u, const void* v, const void* nuHe,
                  const void* nuHn, const void* beta, void* Au, void* Av,
                  int My, int Mx, double dx, double dy, void* stream) {
  ssa_matvec_kernel<T><<<grid_for(My, Mx), dim3(kBlockX, kBlockY), 0,
                         (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)nuHe, (const T*)nuHn,
      (const T*)beta, (T*)Au, (T*)Av, My, Mx, (T)dx, (T)dy);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_jvp(const void* u, const void* v, const void* du, const void* dv,
               const void* nuHe, const void* nuHn, const void* dnuHe,
               const void* dnuHn, const void* beta, const void* dbeta,
               void* Ju, void* Jv, int My, int Mx, double dx, double dy,
               void* stream) {
  ssa_matvec_jvp_kernel<T><<<grid_for(My, Mx), dim3(kBlockX, kBlockY), 0,
                             (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)du, (const T*)dv, (const T*)nuHe,
      (const T*)nuHn, (const T*)dnuHe, (const T*)dnuHn, (const T*)beta,
      (const T*)dbeta, (T*)Ju, (T*)Jv, My, Mx, (T)dx, (T)dy);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_halo(const void* up, const void* vp, const void* nuHe,
                const void* nuHn, const void* beta, void* Au, void* Av, int my,
                int mx, int west, int south, double dx, double dy,
                void* stream) {
  ssa_matvec_halo_kernel<T><<<grid_for(my, mx), dim3(kBlockX, kBlockY), 0,
                              (cudaStream_t)stream>>>(
      (const T*)up, (const T*)vp, (const T*)nuHe, (const T*)nuHn,
      (const T*)beta, (T*)Au, (T*)Av, my, mx, west, south, (T)dx, (T)dy);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_halo_jvp(const void* up, const void* vp, const void* dup,
                    const void* dvp, const void* nuHe, const void* nuHn,
                    const void* dnuHe, const void* dnuHn, const void* beta,
                    const void* dbeta, void* Ju, void* Jv, int my, int mx,
                    int west, int south, double dx, double dy, void* stream) {
  ssa_matvec_halo_jvp_kernel<T><<<grid_for(my, mx), dim3(kBlockX, kBlockY), 0,
                                  (cudaStream_t)stream>>>(
      (const T*)up, (const T*)vp, (const T*)dup, (const T*)dvp,
      (const T*)nuHe, (const T*)nuHn, (const T*)dnuHe, (const T*)dnuHn,
      (const T*)beta, (const T*)dbeta, (T*)Ju, (T*)Jv, my, mx, west, south,
      (T)dx, (T)dy);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pism_ssa_matvec_f32(const void* u, const void* v, const void* nuHe,
                        const void* nuHn, const void* beta, void* Au,
                        void* Av, int My, int Mx, double dx, double dy,
                        void* stream) {
  return launch_matvec<float>(u, v, nuHe, nuHn, beta, Au, Av, My, Mx, dx, dy,
                              stream);
}

int pism_ssa_matvec_f64(const void* u, const void* v, const void* nuHe,
                        const void* nuHn, const void* beta, void* Au,
                        void* Av, int My, int Mx, double dx, double dy,
                        void* stream) {
  return launch_matvec<double>(u, v, nuHe, nuHn, beta, Au, Av, My, Mx, dx,
                               dy, stream);
}

int pism_ssa_matvec_jvp_f32(const void* u, const void* v, const void* du,
                            const void* dv, const void* nuHe,
                            const void* nuHn, const void* dnuHe,
                            const void* dnuHn, const void* beta,
                            const void* dbeta, void* Ju, void* Jv, int My,
                            int Mx, double dx, double dy, void* stream) {
  return launch_jvp<float>(u, v, du, dv, nuHe, nuHn, dnuHe, dnuHn, beta,
                           dbeta, Ju, Jv, My, Mx, dx, dy, stream);
}

int pism_ssa_matvec_jvp_f64(const void* u, const void* v, const void* du,
                            const void* dv, const void* nuHe,
                            const void* nuHn, const void* dnuHe,
                            const void* dnuHn, const void* beta,
                            const void* dbeta, void* Ju, void* Jv, int My,
                            int Mx, double dx, double dy, void* stream) {
  return launch_jvp<double>(u, v, du, dv, nuHe, nuHn, dnuHe, dnuHn, beta,
                            dbeta, Ju, Jv, My, Mx, dx, dy, stream);
}

int pism_ssa_matvec_halo_f32(const void* up, const void* vp,
                             const void* nuHe, const void* nuHn,
                             const void* beta, void* Au, void* Av, int my,
                             int mx, int west, int south, double dx,
                             double dy, void* stream) {
  return launch_halo<float>(up, vp, nuHe, nuHn, beta, Au, Av, my, mx, west,
                            south, dx, dy, stream);
}

int pism_ssa_matvec_halo_f64(const void* up, const void* vp,
                             const void* nuHe, const void* nuHn,
                             const void* beta, void* Au, void* Av, int my,
                             int mx, int west, int south, double dx,
                             double dy, void* stream) {
  return launch_halo<double>(up, vp, nuHe, nuHn, beta, Au, Av, my, mx, west,
                             south, dx, dy, stream);
}

int pism_ssa_matvec_halo_jvp_f32(const void* up, const void* vp,
                                 const void* dup, const void* dvp,
                                 const void* nuHe, const void* nuHn,
                                 const void* dnuHe, const void* dnuHn,
                                 const void* beta, const void* dbeta,
                                 void* Ju, void* Jv, int my, int mx, int west,
                                 int south, double dx, double dy,
                                 void* stream) {
  return launch_halo_jvp<float>(up, vp, dup, dvp, nuHe, nuHn, dnuHe, dnuHn,
                                beta, dbeta, Ju, Jv, my, mx, west, south, dx,
                                dy, stream);
}

int pism_ssa_matvec_halo_jvp_f64(const void* up, const void* vp,
                                 const void* dup, const void* dvp,
                                 const void* nuHe, const void* nuHn,
                                 const void* dnuHe, const void* dnuHn,
                                 const void* beta, const void* dbeta,
                                 void* Ju, void* Jv, int my, int mx, int west,
                                 int south, double dx, double dy,
                                 void* stream) {
  return launch_halo_jvp<double>(up, vp, dup, dvp, nuHe, nuHn, dnuHe, dnuHn,
                                 beta, dbeta, Ju, Jv, my, mx, west, south, dx,
                                 dy, stream);
}

}  // extern "C"
