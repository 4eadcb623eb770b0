// Reverse mode of the SSA operator matvec for Hopper (sm_90a), float and
// double.
//
// K1 (ssa_matvec.cu) computes A(u, v; nuH_e, nuH_n, beta) = -div T + beta
// (u, v), with the east-face stresses Txx_e = 2 nuH_e (2 u_x + v_y), Txy_e =
// nuH_e (u_y + v_x) and the north-face stresses Txy_n = nuH_n (u_y + v_x),
// Tyy_n = 2 nuH_n (2 v_y + u_x). The JAX package has no kernel for its
// reverse mode: XLA transposes the plain operator (apply_operator, reached
// from the inverse toolkit's adjoint at pism_tpu/inverse/ssa_inverse.py:101).
// This kernel is that transpose. Given the cotangents (gu, gv) of (Au, Av) it
// returns
//
//   (ubar, vbar) = A^T (gu, gv)          the transposed stencil,
//   nuHe_bar, nuHn_bar                   each face's stresses' cotangents
//                                        times u's face strain terms,
//   beta_bar     = gu u + gv v,
//
// and writes only the outputs whose pointer is not null (the tau_c design
// needs beta_bar alone, the hardness design the face cotangents alone).
//
// Gather form, no atomics, so the result is the same on every run: a thread
// owns one cell of ubar/vbar (and of the face and beta cotangents where that
// cell has one) and visits the 3x3 east faces and 3x3 north faces around
// it. For each face it forms the cotangents of the face's two stresses from
// gu, gv of the two output cells beside the face, then adds the weight of
// every tap of that face's strain stencils that lands on its cell. A tap's
// cell goes through the layout's offset map, so K1's clamped neighbours
// (a tap past the grid's edge lands on the edge cell) are folded in by
// comparing offsets.
//
// Two instances, as K1 has: Clamped, whole (My, Mx) fields (the whole-field
// K1), and Padded, the padded-block layout of K5 (velocities with two ghost
// cells, nuH with one) that the periodic route launches on the wrap-padded
// field. In the padded layout the outputs are the cotangents of the padded
// blocks themselves: ubar/vbar (my+4, mx+4), nuH_bar (my+2, mx+2), beta_bar
// (my, mx); the wrap-pad's own transpose, which folds the ghosts'
// cotangents back onto the field, is left to the caller (plain torch
// indexing under autograd). At a closed edge (Clamped's west and south
// edges, Padded's with its west / south flag) the divergence's west (south)
// face is the cell's own east (north) face, so that cell gives its faces no
// cotangent, as in the forward kernel.
//
// What bounds it: it reads u, v, nuH_e, nuH_n, beta, gu, gv once and writes
// up to five fields, 96 bytes a cell in float64 (40 in float32 for the
// outputs of one design), 1.0 MB at 141x76, 16.2 MB at 561x301: 0.31 and
// 4.8 us at 3.35 TB/s. A thread recomputes the cotangents of the 18 faces
// around its cell (each face is so computed by ~6 threads) and reads its
// neighbours' values again through L1; it is a simple kernel that is right,
// not a fast one (a fused transpose of the whole Newton matvec is later
// work).
//
// C interface for ctypes: every function returns cudaGetLastError() after
// the launch (0 = success). The kernels allocate nothing and launch on the
// stream they are given.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int k, int n) {
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

// K1's layout: whole (ny, nx) fields, neighbours clamped to the grid; a
// thread per cell; faces and cells share one offset.
struct Clamped {
  int ny, nx;
  static constexpr int kGhosts = 0;   // the threads cover cells 0 .. n-1
  __device__ __forceinline__ size_t cell(int j, int i) const {
    return (size_t)clampi(j, ny) * nx + clampi(i, nx);
  }
  __device__ __forceinline__ bool has_face(int j, int i) const {
    return j >= 0 && j < ny && i >= 0 && i < nx;
  }
  __device__ __forceinline__ size_t face(int j, int i) const {
    return (size_t)j * nx + i;
  }
  __device__ __forceinline__ bool west_edge(int i) const { return i == 0; }
  __device__ __forceinline__ bool south_edge(int j) const { return j == 0; }
};

// K5's layout: the (ny, nx) output cells in blocks with two ghosts (u, v
// and their cotangents) and one (nuH and its cotangents); a thread per
// cell of the velocity block, -2 .. n+1.
struct Padded {
  int ny, nx, west, south;
  static constexpr int kGhosts = 2;
  __device__ __forceinline__ size_t cell(int j, int i) const {
    return (size_t)(j + 2) * (nx + 4) + (i + 2);
  }
  __device__ __forceinline__ bool has_face(int j, int i) const {
    return j >= -1 && j <= ny && i >= -1 && i <= nx;
  }
  __device__ __forceinline__ size_t face(int j, int i) const {
    return (size_t)(j + 1) * (nx + 2) + (i + 1);
  }
  __device__ __forceinline__ bool west_edge(int i) const {
    return west && i == 0;
  }
  __device__ __forceinline__ bool south_edge(int j) const {
    return south && j == 0;
  }
};

// The cotangents of the two stresses on one face
template <typename T>
struct Cot {
  T a, b;
};

template <typename T, typename Layout>
struct Args {
  const T *u, *v, *nuHe, *nuHn, *beta, *gu, *gv;
  T dx, dy;
  Layout L;

  // gu, gv of output cell (j, i), or 0 off the output cells and where the
  // cell's west (south) divergence term is closed
  __device__ __forceinline__ Cot<T> g_west(int j, int i) const {
    if (j < 0 || j >= L.ny || i < 0 || i >= L.nx || L.west_edge(i))
      return {T(0), T(0)};
    const size_t k = (size_t)j * L.nx + i;
    return {gu[k], gv[k]};
  }
  __device__ __forceinline__ Cot<T> g_south(int j, int i) const {
    if (j < 0 || j >= L.ny || i < 0 || i >= L.nx || L.south_edge(j))
      return {T(0), T(0)};
    const size_t k = (size_t)j * L.nx + i;
    return {gu[k], gv[k]};
  }
  // (Txx_e, Txy_e) cotangents of east face (j, i): Au(j, i) = -(Txx_e(j,
  // i) - Txx_e(j, i-1)) / dx - ..., Av likewise with Txy_e
  __device__ __forceinline__ Cot<T> east(int j, int i) const {
    const Cot<T> g0 = g_west(j, i), g1 = g_west(j, i + 1);
    return {(g1.a - g0.a) / dx, (g1.b - g0.b) / dx};
  }
  // (Txy_n, Tyy_n) cotangents of north face (j, i)
  __device__ __forceinline__ Cot<T> north(int j, int i) const {
    const Cot<T> g0 = g_south(j, i), g1 = g_south(j + 1, i);
    return {(g1.a - g0.a) / dy, (g1.b - g0.b) / dy};
  }
};

template <typename T, typename Layout>
__global__ void ssa_matvec_vjp_kernel(Args<T, Layout> A, T* __restrict__ ub,
                                      T* __restrict__ vb,
                                      T* __restrict__ nuHe_b,
                                      T* __restrict__ nuHn_b,
                                      T* __restrict__ beta_b) {
  const Layout& L = A.L;
  const int g = Layout::kGhosts;
  const int i = blockIdx.x * blockDim.x + threadIdx.x - g;
  const int j = blockIdx.y * blockDim.y + threadIdx.y - g;
  if (i >= L.nx + g || j >= L.ny + g) return;
  const size_t o = L.cell(j, i);
  const T dx = A.dx, dy = A.dy;

  if (ub != nullptr) {
    // the taps of every face within one cell of (j, i) that land on it
    T su = T(0), sv = T(0);
    for (int jf = j - 1; jf <= j + 1; ++jf) {
      for (int jif = i - 1; jif <= i + 1; ++jif) {
        if (!L.has_face(jf, jif)) continue;
        const size_t f = L.face(jf, jif);
        {  // east face: ux_e, vx_e across it; uy_e, vy_e along it
          const Cot<T> t = A.east(jf, jif);
          const T nu = A.nuHe[f];
          const T cux = T(4) * nu * t.a, cvy = T(2) * nu * t.a;
          const T cxy = nu * t.b;   // of uy_e and of vx_e
          const T wx = T(1) / dx, wy = T(1) / (T(4) * dy);
          if (L.cell(jf, jif + 1) == o) { su += cux * wx; sv += cxy * wx; }
          if (L.cell(jf, jif) == o) { su -= cux * wx; sv -= cxy * wx; }
          if (L.cell(jf + 1, jif) == o) { su += cxy * wy; sv += cvy * wy; }
          if (L.cell(jf + 1, jif + 1) == o) { su += cxy * wy; sv += cvy * wy; }
          if (L.cell(jf - 1, jif) == o) { su -= cxy * wy; sv -= cvy * wy; }
          if (L.cell(jf - 1, jif + 1) == o) { su -= cxy * wy; sv -= cvy * wy; }
        }
        {  // north face: uy_n, vy_n across it; ux_n, vx_n along it
          const Cot<T> t = A.north(jf, jif);
          const T nu = A.nuHn[f];
          const T cxy = nu * t.a;   // of uy_n and of vx_n
          const T cvy = T(4) * nu * t.b, cux = T(2) * nu * t.b;
          const T wy = T(1) / dy, wx = T(1) / (T(4) * dx);
          if (L.cell(jf + 1, jif) == o) { su += cxy * wy; sv += cvy * wy; }
          if (L.cell(jf, jif) == o) { su -= cxy * wy; sv -= cvy * wy; }
          if (L.cell(jf, jif + 1) == o) { su += cux * wx; sv += cxy * wx; }
          if (L.cell(jf + 1, jif + 1) == o) { su += cux * wx; sv += cxy * wx; }
          if (L.cell(jf, jif - 1) == o) { su -= cux * wx; sv -= cxy * wx; }
          if (L.cell(jf + 1, jif - 1) == o) { su -= cux * wx; sv -= cxy * wx; }
        }
      }
    }
    if (j >= 0 && j < L.ny && i >= 0 && i < L.nx) {   // beta (u, v)
      const size_t k = (size_t)j * L.nx + i;
      su += A.beta[k] * A.gu[k];
      sv += A.beta[k] * A.gv[k];
    }
    ub[o] = su;
    vb[o] = sv;
  }

  if (nuHe_b != nullptr && L.has_face(j, i)) {
    // the cotangents of the cell's own faces times u's strain terms there
    const T* u = A.u;
    const T* v = A.v;
    const size_t c = L.cell(j, i), e = L.cell(j, i + 1), w = L.cell(j, i - 1);
    const size_t n = L.cell(j + 1, i), ne = L.cell(j + 1, i + 1);
    const size_t nw = L.cell(j + 1, i - 1);
    const size_t s = L.cell(j - 1, i), se = L.cell(j - 1, i + 1);
    const T ux_e = (u[e] - u[c]) / dx;
    const T vx_e = (v[e] - v[c]) / dx;
    const T uy_e = (u[n] + u[ne] - u[s] - u[se]) / (T(4) * dy);
    const T vy_e = (v[n] + v[ne] - v[s] - v[se]) / (T(4) * dy);
    const T uy_n = (u[n] - u[c]) / dy;
    const T vy_n = (v[n] - v[c]) / dy;
    const T ux_n = (u[e] + u[ne] - u[w] - u[nw]) / (T(4) * dx);
    const T vx_n = (v[e] + v[ne] - v[w] - v[nw]) / (T(4) * dx);
    const Cot<T> te = A.east(j, i), tn = A.north(j, i);
    const size_t f = L.face(j, i);
    nuHe_b[f] = te.a * (T(2) * (T(2) * ux_e + vy_e)) + te.b * (uy_e + vx_e);
    nuHn_b[f] = tn.a * (uy_n + vx_n) + tn.b * (T(2) * (T(2) * vy_n + ux_n));
  }

  if (beta_b != nullptr && j >= 0 && j < L.ny && i >= 0 && i < L.nx) {
    const size_t k = (size_t)j * L.nx + i, c = L.cell(j, i);
    beta_b[k] = A.gu[k] * A.u[c] + A.gv[k] * A.v[c];
  }
}

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <typename T, typename Layout>
int launch(const void* u, const void* v, const void* nuHe, const void* nuHn,
           const void* beta, const void* gu, const void* gv, void* ub,
           void* vb, void* nuHe_b, void* nuHn_b, void* beta_b, Layout L,
           double dx, double dy, void* stream) {
  const int ey = L.ny + 2 * Layout::kGhosts, ex = L.nx + 2 * Layout::kGhosts;
  const dim3 grid((ex + kBlockX - 1) / kBlockX, (ey + kBlockY - 1) / kBlockY);
  Args<T, Layout> A{(const T*)u,    (const T*)v,  (const T*)nuHe,
                    (const T*)nuHn, (const T*)beta, (const T*)gu,
                    (const T*)gv,   (T)dx,        (T)dy,
                    L};
  ssa_matvec_vjp_kernel<T, Layout>
      <<<grid, dim3(kBlockX, kBlockY), 0, (cudaStream_t)stream>>>(
          A, (T*)ub, (T*)vb, (T*)nuHe_b, (T*)nuHn_b, (T*)beta_b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Whole (My, Mx) fields; every output (My, Mx) or null. ubar and vbar are
// written together (both or neither), as are the two face cotangents.
int pism_ssa_matvec_vjp_f32(const void* u, const void* v, const void* nuHe,
                            const void* nuHn, const void* beta,
                            const void* gu, const void* gv, void* ub,
                            void* vb, void* nuHe_b, void* nuHn_b,
                            void* beta_b, int My, int Mx, double dx,
                            double dy, void* stream) {
  return launch<float>(u, v, nuHe, nuHn, beta, gu, gv, ub, vb, nuHe_b,
                       nuHn_b, beta_b, Clamped{My, Mx}, dx, dy, stream);
}

int pism_ssa_matvec_vjp_f64(const void* u, const void* v, const void* nuHe,
                            const void* nuHn, const void* beta,
                            const void* gu, const void* gv, void* ub,
                            void* vb, void* nuHe_b, void* nuHn_b,
                            void* beta_b, int My, int Mx, double dx,
                            double dy, void* stream) {
  return launch<double>(u, v, nuHe, nuHn, beta, gu, gv, ub, vb, nuHe_b,
                        nuHn_b, beta_b, Clamped{My, Mx}, dx, dy, stream);
}

// K5's blocks of one my x mx region: up, vp, ub, vb (my+4, mx+4); nuHe,
// nuHn, nuHe_b, nuHn_b (my+2, mx+2); beta, gu, gv, beta_b (my, mx).
// west/south: the region owns the grid's west/south edge (closed there).
int pism_ssa_matvec_halo_vjp_f32(const void* up, const void* vp,
                                 const void* nuHe, const void* nuHn,
                                 const void* beta, const void* gu,
                                 const void* gv, void* ub, void* vb,
                                 void* nuHe_b, void* nuHn_b, void* beta_b,
                                 int my, int mx, int west, int south,
                                 double dx, double dy, void* stream) {
  return launch<float>(up, vp, nuHe, nuHn, beta, gu, gv, ub, vb, nuHe_b,
                       nuHn_b, beta_b, Padded{my, mx, west, south}, dx, dy,
                       stream);
}

int pism_ssa_matvec_halo_vjp_f64(const void* up, const void* vp,
                                 const void* nuHe, const void* nuHn,
                                 const void* beta, const void* gu,
                                 const void* gv, void* ub, void* vb,
                                 void* nuHe_b, void* nuHn_b, void* beta_b,
                                 int my, int mx, int west, int south,
                                 double dx, double dy, void* stream) {
  return launch<double>(up, vp, nuHe, nuHn, beta, gu, gv, ub, vb, nuHe_b,
                        nuHn_b, beta_b, Padded{my, mx, west, south}, dx, dy,
                        stream);
}

}  // extern "C"
