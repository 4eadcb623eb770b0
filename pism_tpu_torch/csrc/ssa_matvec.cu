// SSA membrane-operator matvec for Hopper (sm_90a), float and double.
//
// K1 replaces the TPU kernel _ssa_matvec_kernel of
// pism_tpu/ops/pallas_kernels.py (called through _ssa_matvec_raw /
// ssa_matvec_pallas and its custom JVP); K5 replaces its sharded twin
// _ssa_matvec_sharded_kernel of pism_tpu/ops/pallas_sharded.py (reached
// through _ssa_matvec_sharded_raw). Both compute
//
//   A(u, v) = -div T + beta (u, v)
//
// with east-face stresses Txx_e = 2 nuH_e (2 u_x + v_y), Txy_e = nuH_e
// (u_y + v_x) and north-face stresses Txy_n = nuH_n (u_y + v_x), Tyy_n =
// 2 nuH_n (2 v_y + u_x); face gradients are one-sided across the face and
// 4-point averages along it. K1 reads whole (My, Mx) fields with its
// neighbours clamped to the grid, which replaces the edge padding of the
// TPU kernel. K5 reads one shard of a mesh from blocks padded with ghost
// cells (two for u and v, one for nuH; beta has none) that the halo
// exchange filled, so the west/south faces of the shard's first
// column/row come from the neighbouring shard; where the shard owns the
// grid's west (south) edge, a flag restores the clamp (the TPU kernel's
// wclamp / sclamp).
//
// One kernel template, ssa_matvec_tile_kernel, serves both; a layout
// struct (Clamped for K1, Padded for K5) turns a cell or a face into an
// offset. A block is a 32x4 tile of cells, a warp one row of it, a thread
// one cell. Each thread reads its 3x3 neighbourhood of u and v, the nuH of
// its faces and beta at once (one round trip to memory), then computes
// its cell's east and north face stresses. The west face is the east face
// of the lane beside, passed by __shfl_up_sync; the south face is the
// north face of the row below, passed through shared memory (one
// barrier); the tile's first column (row) computes its west (south) face
// from the same neighbourhood. At a closed grid edge the west (south) face
// is the cell's own east (north) face, so that term of the divergence is
// exactly 0: the closure of the TPU kernel's shift_w / shift_s. So each
// face is computed once (the tile's west column and south row twice): 21
// loads and 13 divisions a cell with the divergence's 4, where a thread
// that also computed the faces of its west and south neighbours spent 57
// loads and 28 divisions. The face stresses and the divergence keep the expressions of
// face_stress and minus_div below, in their order (no division turned
// into a product), so nvcc rounds and contracts them alike: the result is
// the per-cell kernel's to the bit, and K5 over any mesh of one card gives
// K1's result on the whole field, bit for bit.
//
// What bounds them: per cell they read u, v, nuH_e, nuH_n, beta and write
// Au, Av, 28 bytes in float32 (0.3 MB at the 20 km grid, 4.7 MB at 5 km;
// 80 KB per shard of the 20 km grid on a 2x2 mesh), 0.09, 1.41 and 0.02
// us at 3.35 TB/s. None of the paths' launches comes near that: at the 20
// km grid and its shards a launch is bound by its latency (one round trip,
// the face arithmetic, a barrier, the divergence; 108 blocks of 128
// threads at 141x76, fewer than the card's 132 SMs), at 5 km by the issue
// of the face arithmetic. The
// tile shape and the register design were chosen by timing (PERF.md): a
// variant that stages the tile in shared memory was slower at three of
// the paths' four shapes and no faster at the fourth.
//
// The JVP entry points fuse the forward-mode derivative of the operator,
// which is bilinear in ((u, v), (nuH, beta)):
//
//   J(d) = [A(du, dv; nuH, beta)] + [A(u, v; dnuH, dbeta)]
//
// in one pass (SSAMatvec.jvp), one thread per cell through face_stress
// and minus_div. The SSA solve's Newton sweeps call the Newton matvec
// further down instead, which also forms dnuH and the Dirichlet rows (the
// TPU package's _ssa_matvec_jvp and _ssa_matvec_sharded_jvp of
// pallas_kernels.py:407 / pallas_sharded.py:225 reached through
// jax.linearize of the residual).
//
// The member axis of an ensemble: K1 and the Newton matvec also take (B,
// My, Mx) fields (coefficient planes (B, My, Mx, 4)), all members in one
// launch (pism_ssa_matvec_members_*, pism_ssa_newton_matvec_members_*):
// blockIdx.z is the member, whose fields start My Mx cells further on
// (its coefficient planes 4 My Mx). The layout ClampedMembers says so; the
// member's tile is then K1's, the same expressions on the same values, so
// member b of the launch equals a single launch on member b to the bit.
// The single-field layouts keep kMembers false and compile as before.
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

// ---------------------------------------------------------------------------
// K1 and K5: the operator matvec, one tiled body for both layouts

// K1's layout: whole (My, Mx) fields, neighbours clamped to the grid; a
// cell's velocities and its faces share one offset, and the grid's own
// west/south edges close the divergence.
struct Clamped {
  static constexpr bool kMembers = false;
  int My, Mx;
  __device__ __forceinline__ size_t cell(int j, int i) const {
    return (size_t)clampi(j, My) * Mx + clampi(i, Mx);
  }
  __device__ __forceinline__ size_t face(int j, int i) const {
    return cell(j, i);
  }
  __device__ __forceinline__ bool west_edge(int i) const { return i == 0; }
  __device__ __forceinline__ bool south_edge(int j) const { return j == 0; }
};

// K1's layout on an ensemble's member axis: (B, My, Mx) fields, member
// blockIdx.z at My Mx cells a member; within a member, Clamped's offsets.
struct ClampedMembers : Clamped {
  static constexpr bool kMembers = true;
};

// K5's layout: one shard's (my, mx) cells in blocks with two ghosts (the
// velocities; in the Newton matvec also du, dv, bc) and one (nuH; the
// Newton coefficients); offsets past the ghosts (cells of a ragged tile
// that produce no output) are clamped into the block.
struct Padded {
  static constexpr bool kMembers = false;
  int my, mx, west, south;
  __device__ __forceinline__ static int clamp_to(int k, int lo, int hi) {
    return k < lo ? lo : (k > hi ? hi : k);
  }
  __device__ __forceinline__ size_t cell(int j, int i) const {
    return (size_t)(clamp_to(j, -2, my + 1) + 2) * (mx + 4) +
           (clamp_to(i, -2, mx + 1) + 2);
  }
  __device__ __forceinline__ size_t face(int j, int i) const {
    return (size_t)(clamp_to(j, -1, my) + 1) * (mx + 2) +
           (clamp_to(i, -1, mx) + 1);
  }
  __device__ __forceinline__ bool west_edge(int i) const {
    return west && i == 0;
  }
  __device__ __forceinline__ bool south_edge(int j) const {
    return south && j == 0;
  }
};

// (d/dx, d/dy) of one field on a face
template <typename T>
struct Grad {
  T x, y;
};

// the gradients of face_stress on the east / north face of cell (r, c) of
// a 2D array s of one field (a neighbourhood in registers, a tile in
// shared memory): one-sided across the face, 4-point averages along it
template <typename T, typename S>
__device__ __forceinline__ Grad<T> grad_east(const S& s, int r, int c, T dx,
                                             T dy) {
  return {(s[r][c + 1] - s[r][c]) / dx,
          (s[r + 1][c] + s[r + 1][c + 1] - s[r - 1][c] - s[r - 1][c + 1]) /
              (T(4) * dy)};
}

template <typename T, typename S>
__device__ __forceinline__ Grad<T> grad_north(const S& s, int r, int c, T dx,
                                              T dy) {
  return {(s[r][c + 1] + s[r + 1][c + 1] - s[r][c - 1] - s[r + 1][c - 1]) /
              (T(4) * dx),
          (s[r + 1][c] - s[r][c]) / dy};
}

// the stresses on one face of a cell: (Txx_e, Txy_e) on an east face,
// (Txy_n, Tyy_n) on a north face
template <typename T>
struct EastFace {
  T xx, xy;
};

template <typename T>
struct NorthFace {
  T xy, yy;
};

// face_stress's expressions on the east / north face of cell (r, c) of
// the neighbourhoods nbu (u) and nbv (v), with that face's nuH
template <typename T, typename S>
__device__ __forceinline__ EastFace<T> east_face_stress(const S& nbu,
                                                        const S& nbv, int r,
                                                        int c, T nu, T dx,
                                                        T dy) {
  const Grad<T> gu = grad_east(nbu, r, c, dx, dy);
  const Grad<T> gv = grad_east(nbv, r, c, dx, dy);
  return {T(2) * nu * (T(2) * gu.x + gv.y), nu * (gu.y + gv.x)};
}

template <typename T, typename S>
__device__ __forceinline__ NorthFace<T> north_face_stress(const S& nbu,
                                                          const S& nbv, int r,
                                                          int c, T nu, T dx,
                                                          T dy) {
  const Grad<T> gu = grad_north(nbu, r, c, dx, dy);
  const Grad<T> gv = grad_north(nbv, r, c, dx, dy);
  return {nu * (gu.y + gv.x), T(2) * nu * (T(2) * gv.y + gu.x)};
}

// A(u, v) of the (ny, nx) cells that get an output; beta, Au, Av are
// (ny, nx), u, v, nuHe, nuHn as the layout says. A block is a BX x BY tile
// (BX divides the warp, so a warp holds whole rows of it) and a thread one
// cell: it reads its 3x3 neighbourhood of u and v and computes its cell's
// east and north faces; the west face is the east face of the lane beside
// (__shfl_up_sync), the south face the north face of the row below
// (shared memory, one barrier). The tile's first column (row) computes its
// west (south) faces itself, from the same neighbourhood.
template <typename T, typename Layout, int BX, int BY>
__global__ void __launch_bounds__(BX * BY) ssa_matvec_tile_kernel(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ nuHe, const T* __restrict__ nuHn,
    const T* __restrict__ beta, T* __restrict__ Au, T* __restrict__ Av,
    Layout L, int ny, int nx, T dx, T dy) {
  static_assert(32 % BX == 0, "a warp holds whole rows of the tile");
  __shared__ T s_xy[BY][BX], s_yy[BY][BX];   // the tile's north faces
  if (Layout::kMembers) {   // member blockIdx.z: its fields
    const size_t m = (size_t)blockIdx.z * ny * nx;
    u += m; v += m; nuHe += m; nuHn += m; beta += m; Au += m; Av += m;
  }
  const int tc = threadIdx.x, tr = threadIdx.y;
  const int i = blockIdx.x * BX + tc, j = blockIdx.y * BY + tr;

  // every read of device memory at once, so that a thread waits for one
  // round trip: the neighbourhoods, the nuH of the cell's faces (and of
  // its west / south face in the tile's first column / row) and beta
  T nbu[3][3], nbv[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const size_t a = L.cell(j - 1 + r, i - 1 + c);
      nbu[r][c] = u[a];
      nbv[r][c] = v[a];
    }
  }
  const size_t o = L.face(j, i);
  const T nu_e = nuHe[o], nu_n = nuHn[o];
  const T nu_w = tc == 0 ? nuHe[L.face(j, i - 1)] : T(0);
  const T nu_s = tr == 0 ? nuHn[L.face(j - 1, i)] : T(0);
  const bool owned = i < nx && j < ny;
  const size_t k = (size_t)j * nx + i;
  const T b = owned ? beta[k] : T(0);

  const EastFace<T> e = east_face_stress(nbu, nbv, 1, 1, nu_e, dx, dy);
  const NorthFace<T> n = north_face_stress(nbu, nbv, 1, 1, nu_n, dx, dy);
  s_xy[tr][tc] = n.xy;
  s_yy[tr][tc] = n.yy;
  EastFace<T> w = {__shfl_up_sync(0xffffffffu, e.xx, 1),
                   __shfl_up_sync(0xffffffffu, e.xy, 1)};
  if (tc == 0) w = east_face_stress(nbu, nbv, 1, 0, nu_w, dx, dy);
  NorthFace<T> s = {T(0), T(0)};
  if (tr == 0) s = north_face_stress(nbu, nbv, 0, 1, nu_s, dx, dy);
  __syncthreads();
  if (tr > 0) s = {s_xy[tr - 1][tc], s_yy[tr - 1][tc]};

  if (!owned) return;
  // at a closed edge the west (south) face is the cell's own east (north)
  // face, so that term of the divergence is exactly 0 (K1's clamp)
  if (L.west_edge(i)) w = e;
  if (L.south_edge(j)) s = n;
  const T div_x = (e.xx - w.xx) / dx + (n.xy - s.xy) / dy;
  const T div_y = (e.xy - w.xy) / dx + (n.yy - s.yy) / dy;
  const T mx = -div_x, my = -div_y;
  Au[k] = mx + b * nbu[1][1];
  Av[k] = my + b * nbv[1][1];
}

// The tile of K1 and K5, chosen by timing 32x8, 32x4, 16x8 and 16x4 at the
// paths' shapes, beside a variant that stages the tile in shared memory
// (scripts/ssa_matvec_tiles.py; the times are in PERF.md).
constexpr int kMatvecX = 32;
constexpr int kMatvecY = 4;

template <typename T, int BX = kMatvecX, int BY = kMatvecY, typename Layout>
int launch_matvec(const void* u, const void* v, const void* nuHe,
                  const void* nuHn, const void* beta, void* Au, void* Av,
                  Layout L, int ny, int nx, double dx, double dy,
                  void* stream, int members = 1) {
  if (members <= 0) return 0;
  ssa_matvec_tile_kernel<T, Layout, BX, BY>
      <<<dim3((nx + BX - 1) / BX, (ny + BY - 1) / BY, members), dim3(BX, BY),
         0, (cudaStream_t)stream>>>(
          (const T*)u, (const T*)v, (const T*)nuHe, (const T*)nuHn,
          (const T*)beta, (T*)Au, (T*)Av, L, ny, nx, (T)dx, (T)dy);
  return (int)cudaGetLastError();
}

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

dim3 grid_for(int My, int Mx) {
  return dim3((Mx + kBlockX - 1) / kBlockX, (My + kBlockY - 1) / kBlockY);
}

// ---------------------------------------------------------------------------
// The Newton matvec: K1's JVP and K5's JVP redesigned as the whole matvec
// of a Newton sweep, one launch per call:
//
//   fd     = d where ~bc else 0
//   dnuH_f = ((a1_f dux_f + a2_f dvy_f) + a3_f (duy_f + dvx_f)) k_f
//   J      = A(fd; nuH, beta) + A(u, v; dnuH, 0)
//   out    = d where bc else J
//
// with (dux, dvy, duy, dvx)_f the face strain rates of fd and (a1, a2, a3,
// k)_f the per-face tangent coefficients of the sweep's linearization
// (ops/ssa.py linearize_nuH; k carries the icy-face mask). It replaces a
// plain torch tangent (~95 device ops), the fused JVP launch and the
// Dirichlet selects. A block owns a 32x8 tile of cells: it stages the
// tile's fd, u and v with two ghost cells in shared memory (bc applied on
// load), computes every east and north face of the tile plus the west
// column and the south row of faces once (dnuH and the two stress terms),
// then forms the divergence from the faces in shared memory. The old JVP
// kernels evaluate six face stencils per cell, each reading its eight
// neighbours from device memory.
//
// Rounding: dnuH is the plain torch tangent statement for statement. On
// the card torch divides a tensor by a Python scalar as a product with the
// scalar's reciprocal (rounded in the field dtype), and runs each statement
// as its own rounded op, so the tangent is written with _rn intrinsics
// (no FMA contraction) and the reciprocals come from the launcher. The
// stresses and the divergence are K1's expressions, so the result is the
// composition it replaces (tangent, fused JVP launch, selects) to the bit.
//
// What bounds it: per cell it reads u, v, du, dv, nuH_e, nuH_n, beta, the
// 8 coefficients and bc, and writes two values: 69 bytes in float32, 0.74
// MB at the 20 km grid and 11.6 MB at 5 km. The 5 km launch is bound by
// device memory (3.5 us at 3.35 TB/s), the 20 km one by launch latency.
//
// The drag tangent (the exact drag Jacobian, drag_jacobian = exact): with a
// per-cell plane c = 2 dbeta/d|u|^2 of the sweep (physics/basal.py
// dbeta_coef), the free rows gain the dbeta (u, v) term of the TPU
// kernel's JVP with dbeta formed here from the direction,
//
//   J += dbeta (u, v),   dbeta = c (u fu + v fv),
//
// u, v the linearization point (Dirichlet values included) and (fu, fv)
// the freed direction. It is a template flag (kDrag): the instances
// without it are the code they were, so they keep their bits, and the
// launcher picks the drag instance when it is given a plane. The term is
// written with _rn intrinsics in the plain version's order, c (u fu + v
// fv), then (mx2 + dbeta u), then t1 + that, so that it adds no rounding
// of its own beside the plain version's. One more field is read: 77 bytes
// a cell in float32, 150 in float64.

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// the staged tile: cells j0-2 .. j0+kBlockY, i0-2 .. i0+kBlockX
constexpr int kTileW = kBlockX + 3;
constexpr int kTileH = kBlockY + 3;

template <typename T>
using Tile = T[kTileH][kTileW];

// the same gradients as the plain tangent rounds them (ops/stencils.py
// grad_x_east, grad_y_east, grad_x_north, grad_y_north on the card)
template <typename T>
__device__ __forceinline__ Grad<T> grad_east_rn(const Tile<T>& s, int r, int c,
                                                T inv_dx, T inv_4dy) {
  return {mul_rn(sub_rn(s[r][c + 1], s[r][c]), inv_dx),
          mul_rn(sub_rn(sub_rn(add_rn(s[r + 1][c], s[r + 1][c + 1]),
                               s[r - 1][c]), s[r - 1][c + 1]), inv_4dy)};
}

template <typename T>
__device__ __forceinline__ Grad<T> grad_north_rn(const Tile<T>& s, int r,
                                                 int c, T inv_4dx, T inv_dy) {
  return {mul_rn(sub_rn(sub_rn(add_rn(s[r][c + 1], s[r + 1][c + 1]),
                               s[r][c - 1]), s[r + 1][c - 1]), inv_4dx),
          mul_rn(sub_rn(s[r + 1][c], s[r][c]), inv_dy)};
}

// dnuH = ((a1 dux + a2 dvy) + a3 (duy + dvx)) k; cf = (a1, a2, a3, k)
template <typename T>
__device__ __forceinline__ T tangent(const T* __restrict__ cf, Grad<T> du,
                                     Grad<T> dv) {
  return mul_rn(add_rn(add_rn(mul_rn(cf[0], du.x), mul_rn(cf[1], dv.y)),
                       mul_rn(cf[2], add_rn(du.y, dv.x))),
                cf[3]);
}

// The faces of a tile in shared memory: east faces of tile columns -1 ..
// kBlockX-1 (slot c+1), north faces of tile rows -1 .. kBlockY-1 (slot
// r+1); term 1 is the direction's stresses with nuH, term 2 the
// linearization point's with dnuH.
template <typename T>
struct Faces {
  T xx1[kBlockY][kBlockX + 1], xy1[kBlockY][kBlockX + 1];
  T xx2[kBlockY][kBlockX + 1], xy2[kBlockY][kBlockX + 1];
  T nxy1[kBlockY + 1][kBlockX], yy1[kBlockY + 1][kBlockX];
  T nxy2[kBlockY + 1][kBlockX], yy2[kBlockY + 1][kBlockX];
};

template <typename T>
struct Steps {
  T dx, dy, inv_dx, inv_dy, inv_4dx, inv_4dy;
};

// east face of tile cell (tr, tc) (tile-array row tr+2, column tc+2);
// cf: its four coefficients
template <typename T>
__device__ __forceinline__ void east_face(
    const Tile<T>& fu, const Tile<T>& fv, const Tile<T>& u, const Tile<T>& v,
    T nu, const T* __restrict__ cf, int tr, int tc, Steps<T> h, Faces<T>& f) {
  const int r = tr + 2, c = tc + 2;
  const T dnu = tangent(cf, grad_east_rn(fu, r, c, h.inv_dx, h.inv_4dy),
                        grad_east_rn(fv, r, c, h.inv_dx, h.inv_4dy));
  const Grad<T> fu_ = grad_east(fu, r, c, h.dx, h.dy);
  const Grad<T> fv_ = grad_east(fv, r, c, h.dx, h.dy);
  const Grad<T> u_ = grad_east(u, r, c, h.dx, h.dy);
  const Grad<T> v_ = grad_east(v, r, c, h.dx, h.dy);
  f.xx1[tr][tc + 1] = T(2) * nu * (T(2) * fu_.x + fv_.y);
  f.xy1[tr][tc + 1] = nu * (fu_.y + fv_.x);
  f.xx2[tr][tc + 1] = T(2) * dnu * (T(2) * u_.x + v_.y);
  f.xy2[tr][tc + 1] = dnu * (u_.y + v_.x);
}

template <typename T>
__device__ __forceinline__ void north_face(
    const Tile<T>& fu, const Tile<T>& fv, const Tile<T>& u, const Tile<T>& v,
    T nu, const T* __restrict__ cf, int tr, int tc, Steps<T> h, Faces<T>& f) {
  const int r = tr + 2, c = tc + 2;
  const T dnu = tangent(cf, grad_north_rn(fu, r, c, h.inv_4dx, h.inv_dy),
                        grad_north_rn(fv, r, c, h.inv_4dx, h.inv_dy));
  const Grad<T> fu_ = grad_north(fu, r, c, h.dx, h.dy);
  const Grad<T> fv_ = grad_north(fv, r, c, h.dx, h.dy);
  const Grad<T> u_ = grad_north(u, r, c, h.dx, h.dy);
  const Grad<T> v_ = grad_north(v, r, c, h.dx, h.dy);
  f.nxy1[tr + 1][tc] = nu * (fu_.y + fv_.x);
  f.yy1[tr + 1][tc] = T(2) * nu * (T(2) * fv_.y + fu_.x);
  f.nxy2[tr + 1][tc] = dnu * (u_.y + v_.x);
  f.yy2[tr + 1][tc] = T(2) * dnu * (T(2) * v_.y + u_.x);
}

// ny, nx: the cells that get an output; beta, Ju, Jv are (ny, nx).
// coef_e, coef_n: (a1, a2, a3, k) per face, on a last axis of 4.
// drag: the drag-tangent plane c, (ny, nx) as beta; read with kDrag only.
template <typename T, typename Layout, bool kDrag>
__global__ void __launch_bounds__(kBlockX * kBlockY) ssa_newton_matvec_kernel(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ du, const T* __restrict__ dv,
    const T* __restrict__ nuHe, const T* __restrict__ nuHn,
    const T* __restrict__ coef_e, const T* __restrict__ coef_n,
    const T* __restrict__ beta, const T* __restrict__ drag,
    const unsigned char* __restrict__ bc, T* __restrict__ Ju,
    T* __restrict__ Jv, Layout L, int ny, int nx, Steps<T> h) {
  __shared__ Tile<T> s_fu, s_fv, s_u, s_v;
  __shared__ Faces<T> f;
  if (Layout::kMembers) {   // member blockIdx.z: its fields and planes
    const size_t m = (size_t)blockIdx.z * ny * nx;
    u += m; v += m; du += m; dv += m; nuHe += m; nuHn += m; beta += m;
    bc += m; Ju += m; Jv += m; coef_e += 4 * m; coef_n += 4 * m;
    if (kDrag) drag += m;
  }
  const int tc = threadIdx.x, tr = threadIdx.y;
  const int i0 = blockIdx.x * kBlockX, j0 = blockIdx.y * kBlockY;

  for (int k = tr * kBlockX + tc; k < kTileH * kTileW;
       k += kBlockX * kBlockY) {
    const int r = k / kTileW, c = k - r * kTileW;
    const size_t o = L.cell(j0 - 2 + r, i0 - 2 + c);
    const bool fixed = bc[o] != 0;
    s_fu[r][c] = fixed ? T(0) : du[o];
    s_fv[r][c] = fixed ? T(0) : dv[o];
    s_u[r][c] = u[o];
    s_v[r][c] = v[o];
  }
  __syncthreads();

  const int j = j0 + tr, i = i0 + tc;
  size_t o = L.face(j, i);
  east_face(s_fu, s_fv, s_u, s_v, nuHe[o], coef_e + 4 * o, tr, tc, h, f);
  north_face(s_fu, s_fv, s_u, s_v, nuHn[o], coef_n + 4 * o, tr, tc, h, f);
  if (tc == 0) {   // the west column of faces
    o = L.face(j, i0 - 1);
    east_face(s_fu, s_fv, s_u, s_v, nuHe[o], coef_e + 4 * o, tr, -1, h, f);
  }
  if (tr == 0) {   // the south row of faces
    o = L.face(j0 - 1, i);
    north_face(s_fu, s_fv, s_u, s_v, nuHn[o], coef_n + 4 * o, -1, tc, h, f);
  }
  __syncthreads();

  if (i >= nx || j >= ny) return;
  // at a closed edge the west (south) face is the cell's own east (north)
  // face, so that term of the divergence is exactly 0 (K1's clamp)
  const int we = L.west_edge(i) ? tc + 1 : tc;
  const int so = L.south_edge(j) ? tr + 1 : tr;
  const T div_x1 = (f.xx1[tr][tc + 1] - f.xx1[tr][we]) / h.dx +
                   (f.nxy1[tr + 1][tc] - f.nxy1[so][tc]) / h.dy;
  const T div_y1 = (f.xy1[tr][tc + 1] - f.xy1[tr][we]) / h.dx +
                   (f.yy1[tr + 1][tc] - f.yy1[so][tc]) / h.dy;
  const T div_x2 = (f.xx2[tr][tc + 1] - f.xx2[tr][we]) / h.dx +
                   (f.nxy2[tr + 1][tc] - f.nxy2[so][tc]) / h.dy;
  const T div_y2 = (f.xy2[tr][tc + 1] - f.xy2[tr][we]) / h.dx +
                   (f.yy2[tr + 1][tc] - f.yy2[so][tc]) / h.dy;
  const T mx1 = -div_x1, my1 = -div_y1, mx2 = -div_x2, my2 = -div_y2;
  const size_t k = (size_t)j * nx + i, c = L.cell(j, i);
  const T t1u = mx1 + beta[k] * s_fu[tr + 2][tc + 2];
  const T t1v = my1 + beta[k] * s_fv[tr + 2][tc + 2];
  const bool fixed = bc[c] != 0;
  if (kDrag) {
    // dbeta (u, v), dbeta = c (u fu + v fv), in the plain version's order
    const T uc = s_u[tr + 2][tc + 2], vc = s_v[tr + 2][tc + 2];
    const T db = mul_rn(drag[k], add_rn(mul_rn(uc, s_fu[tr + 2][tc + 2]),
                                        mul_rn(vc, s_fv[tr + 2][tc + 2])));
    Ju[k] = fixed ? du[c] : add_rn(t1u, add_rn(mx2, mul_rn(db, uc)));
    Jv[k] = fixed ? dv[c] : add_rn(t1v, add_rn(my2, mul_rn(db, vc)));
  } else {
    Ju[k] = fixed ? du[c] : t1u + mx2;
    Jv[k] = fixed ? dv[c] : t1v + my2;
  }
}

// the steps in the field dtype and their reciprocals as torch forms them
// on the host for a tensor divided by a Python scalar
template <typename T>
Steps<T> steps(double dx, double dy) {
  return {T(dx), T(dy), T(1) / T(dx), T(1) / T(dy), T(1) / T(4.0 * dx),
          T(1) / T(4.0 * dy)};
}

// drag: the drag-tangent plane, or null for the instance without it
template <typename T, typename Layout>
int launch_newton(const void* u, const void* v, const void* du,
                  const void* dv, const void* nuHe, const void* nuHn,
                  const void* coef_e, const void* coef_n, const void* beta,
                  const void* drag, const void* bc, void* Ju, void* Jv,
                  Layout L, int ny, int nx, double dx, double dy,
                  void* stream, int members = 1) {
  if (members <= 0) return 0;
  dim3 grid = grid_for(ny, nx);
  grid.z = members;
  const dim3 block(kBlockX, kBlockY);
  cudaStream_t st = (cudaStream_t)stream;
  if (drag != nullptr) {
    ssa_newton_matvec_kernel<T, Layout, true><<<grid, block, 0, st>>>(
        (const T*)u, (const T*)v, (const T*)du, (const T*)dv,
        (const T*)nuHe, (const T*)nuHn, (const T*)coef_e, (const T*)coef_n,
        (const T*)beta, (const T*)drag, (const unsigned char*)bc, (T*)Ju,
        (T*)Jv, L, ny, nx, steps<T>(dx, dy));
  } else {
    ssa_newton_matvec_kernel<T, Layout, false><<<grid, block, 0, st>>>(
        (const T*)u, (const T*)v, (const T*)du, (const T*)dv,
        (const T*)nuHe, (const T*)nuHn, (const T*)coef_e, (const T*)coef_n,
        (const T*)beta, nullptr, (const unsigned char*)bc, (T*)Ju, (T*)Jv,
        L, ny, nx, steps<T>(dx, dy));
  }
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

// The Newton matvec on whole (My, Mx) fields (K1's clamped indexing);
// coef_e, coef_n: (My, Mx, 4); bc: (My, Mx) bytes, nonzero on Dirichlet rows;
// drag: the drag-tangent plane (My, Mx), or null (beta frozen). The halo and
// member entry points take it as the whole-field one, with beta's shape.
int pism_ssa_newton_matvec_f32(const void* u, const void* v, const void* du,
                               const void* dv, const void* nuHe,
                               const void* nuHn, const void* coef_e,
                               const void* coef_n, const void* beta,
                               const void* drag, const void* bc, void* Ju,
                               void* Jv, int My, int Mx, double dx,
                               double dy, void* stream) {
  return launch_newton<float>(u, v, du, dv, nuHe, nuHn, coef_e, coef_n, beta,
                              drag, bc, Ju, Jv, Clamped{My, Mx}, My, Mx, dx,
                              dy, stream);
}

int pism_ssa_newton_matvec_f64(const void* u, const void* v, const void* du,
                               const void* dv, const void* nuHe,
                               const void* nuHn, const void* coef_e,
                               const void* coef_n, const void* beta,
                               const void* drag, const void* bc, void* Ju,
                               void* Jv, int My, int Mx, double dx,
                               double dy, void* stream) {
  return launch_newton<double>(u, v, du, dv, nuHe, nuHn, coef_e, coef_n,
                               beta, drag, bc, Ju, Jv, Clamped{My, Mx}, My,
                               Mx, dx, dy, stream);
}

// The Newton matvec on one shard of my x mx cells (K5's blocks): up, vp,
// dup, dvp, bcp with two ghosts; nuHe, nuHn, coef_e, coef_n with one; beta,
// Ju, Jv (my, mx). west/south: the shard owns the grid's west/south edge.
int pism_ssa_newton_matvec_halo_f32(const void* up, const void* vp,
                                    const void* dup, const void* dvp,
                                    const void* nuHe, const void* nuHn,
                                    const void* coef_e, const void* coef_n,
                                    const void* beta, const void* drag,
                                    const void* bcp, void* Ju, void* Jv,
                                    int my, int mx,
                                    int west, int south, double dx,
                                    double dy, void* stream) {
  return launch_newton<float>(up, vp, dup, dvp, nuHe, nuHn, coef_e, coef_n,
                              beta, drag, bcp, Ju, Jv,
                              Padded{my, mx, west, south}, my, mx, dx,
                              dy, stream);
}

int pism_ssa_newton_matvec_halo_f64(const void* up, const void* vp,
                                    const void* dup, const void* dvp,
                                    const void* nuHe, const void* nuHn,
                                    const void* coef_e, const void* coef_n,
                                    const void* beta, const void* drag,
                                    const void* bcp, void* Ju, void* Jv,
                                    int my, int mx,
                                    int west, int south, double dx,
                                    double dy, void* stream) {
  return launch_newton<double>(up, vp, dup, dvp, nuHe, nuHn, coef_e, coef_n,
                               beta, drag, bcp, Ju, Jv,
                               Padded{my, mx, west, south}, my, mx, dx,
                               dy, stream);
}

// K1 and the Newton matvec on an ensemble's member axis: (B, My, Mx)
// fields, coef_e, coef_n (B, My, Mx, 4), bc (B, My, Mx) bytes; one launch
// for the B members.
int pism_ssa_matvec_members_f32(const void* u, const void* v,
                                const void* nuHe, const void* nuHn,
                                const void* beta, void* Au, void* Av, int B,
                                int My, int Mx, double dx, double dy,
                                void* stream) {
  return launch_matvec<float>(u, v, nuHe, nuHn, beta, Au, Av,
                              ClampedMembers{{My, Mx}}, My, Mx, dx, dy,
                              stream, B);
}

int pism_ssa_matvec_members_f64(const void* u, const void* v,
                                const void* nuHe, const void* nuHn,
                                const void* beta, void* Au, void* Av, int B,
                                int My, int Mx, double dx, double dy,
                                void* stream) {
  return launch_matvec<double>(u, v, nuHe, nuHn, beta, Au, Av,
                               ClampedMembers{{My, Mx}}, My, Mx, dx, dy,
                               stream, B);
}

int pism_ssa_newton_matvec_members_f32(
    const void* u, const void* v, const void* du, const void* dv,
    const void* nuHe, const void* nuHn, const void* coef_e,
    const void* coef_n, const void* beta, const void* drag, const void* bc,
    void* Ju, void* Jv, int B, int My, int Mx, double dx, double dy,
    void* stream) {
  return launch_newton<float>(u, v, du, dv, nuHe, nuHn, coef_e, coef_n, beta,
                              drag, bc, Ju, Jv, ClampedMembers{{My, Mx}}, My,
                              Mx, dx, dy, stream, B);
}

int pism_ssa_newton_matvec_members_f64(
    const void* u, const void* v, const void* du, const void* dv,
    const void* nuHe, const void* nuHn, const void* coef_e,
    const void* coef_n, const void* beta, const void* drag, const void* bc,
    void* Ju, void* Jv, int B, int My, int Mx, double dx, double dy,
    void* stream) {
  return launch_newton<double>(u, v, du, dv, nuHe, nuHn, coef_e, coef_n,
                               beta, drag, bc, Ju, Jv,
                               ClampedMembers{{My, Mx}}, My, Mx, dx, dy,
                               stream, B);
}

int pism_ssa_matvec_f32(const void* u, const void* v, const void* nuHe,
                        const void* nuHn, const void* beta, void* Au,
                        void* Av, int My, int Mx, double dx, double dy,
                        void* stream) {
  return launch_matvec<float>(u, v, nuHe, nuHn, beta, Au, Av,
                              Clamped{My, Mx}, My, Mx, dx, dy, stream);
}

int pism_ssa_matvec_f64(const void* u, const void* v, const void* nuHe,
                        const void* nuHn, const void* beta, void* Au,
                        void* Av, int My, int Mx, double dx, double dy,
                        void* stream) {
  return launch_matvec<double>(u, v, nuHe, nuHn, beta, Au, Av,
                               Clamped{My, Mx}, My, Mx, dx, dy, stream);
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
  return launch_matvec<float>(up, vp, nuHe, nuHn, beta, Au, Av,
                              Padded{my, mx, west, south}, my, mx, dx, dy,
                              stream);
}

int pism_ssa_matvec_halo_f64(const void* up, const void* vp,
                             const void* nuHe, const void* nuHn,
                             const void* beta, void* Au, void* Av, int my,
                             int mx, int west, int south, double dx,
                             double dy, void* stream) {
  return launch_matvec<double>(up, vp, nuHe, nuHn, beta, Au, Av,
                               Padded{my, mx, west, south}, my, mx, dx, dy,
                               stream);
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
