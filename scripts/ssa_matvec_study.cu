// Variants of the SSA operator matvec (K1, K5) for
// scripts/ssa_matvec_tiles.py, built with -I pism_tpu_torch/csrc:
//
// - the kernel of ssa_matvec.cu, ssa_matvec_tile_kernel, at the tile shapes
//   32x8, 32x4, 16x8 and 16x4 (study_regs_<BX>x<BY>_{matvec,halo}_*): one
//   thread per cell, its 3x3 neighbourhood in registers, the west face by
//   __shfl_up_sync and the south face through shared memory;
// - a variant that stages the tile in shared memory, at the same shapes
//   (study_smem_<BX>x<BY>_{matvec,halo}_*): the block's u and v with one
//   ring of neighbours, read at once; every thread writes its cell's east
//   and north face stresses to shared memory (the first column and row
//   also the west column and south row of faces), and after a second
//   barrier each cell forms the divergence from the faces there.
//
// Both keep the expressions of face_stress and minus_div, so they give
// the same bits. The C entry points take the arguments of
// pism_ssa_matvec_* and pism_ssa_matvec_halo_*.

#include "ssa_matvec.cu"

namespace {

// The tile of a BX x BY block in shared memory: u and v of cells j0-1 ..
// j0+BY by i0-1 .. i0+BX (all the faces read), the east-face stresses of
// tile columns -1 .. BX-1 (slot c+1) and the north-face stresses of tile
// rows -1 .. BY-1 (slot r+1).
template <typename T, int BX, int BY>
struct MatvecTile {
  T u[BY + 2][BX + 2], v[BY + 2][BX + 2];
  T xx[BY][BX + 1], xy[BY][BX + 1];
  T nxy[BY + 1][BX], yy[BY + 1][BX];
};

// Txx_e, Txy_e of tile cell (tr, tc) (tile-array row tr+1, column tc+1)
template <typename T, int BX, int BY>
__device__ __forceinline__ void matvec_east(MatvecTile<T, BX, BY>& s, T nu,
                                            int tr, int tc, T dx, T dy) {
  const Grad<T> u = grad_east(s.u, tr + 1, tc + 1, dx, dy);
  const Grad<T> v = grad_east(s.v, tr + 1, tc + 1, dx, dy);
  s.xx[tr][tc + 1] = T(2) * nu * (T(2) * u.x + v.y);
  s.xy[tr][tc + 1] = nu * (u.y + v.x);
}

// Txy_n, Tyy_n of tile cell (tr, tc)
template <typename T, int BX, int BY>
__device__ __forceinline__ void matvec_north(MatvecTile<T, BX, BY>& s, T nu,
                                             int tr, int tc, T dx, T dy) {
  const Grad<T> u = grad_north(s.u, tr + 1, tc + 1, dx, dy);
  const Grad<T> v = grad_north(s.v, tr + 1, tc + 1, dx, dy);
  s.nxy[tr + 1][tc] = nu * (u.y + v.x);
  s.yy[tr + 1][tc] = T(2) * nu * (T(2) * v.y + u.x);
}

// A(u, v) as ssa_matvec_tile_kernel computes it, with the tile's u and v
// staged in shared memory and every face stress written there.
template <typename T, typename Layout, int BX, int BY>
__global__ void __launch_bounds__(BX * BY) ssa_matvec_smem_kernel(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ nuHe, const T* __restrict__ nuHn,
    const T* __restrict__ beta, T* __restrict__ Au, T* __restrict__ Av,
    Layout L, int ny, int nx, T dx, T dy) {
  __shared__ MatvecTile<T, BX, BY> s;
  const int tc = threadIdx.x, tr = threadIdx.y;
  const int i0 = blockIdx.x * BX, j0 = blockIdx.y * BY;
  const int j = j0 + tr, i = i0 + tc;

  // Every read of device memory is issued at once, before the first
  // barrier, so that the block waits for one round trip: this thread's
  // nuH, the nuH of the west (south) face for the first column (row),
  // beta, and its share of the tile, held in registers until all of them
  // are in flight.
  constexpr int kCells = (BY + 2) * (BX + 2);
  constexpr int kShare = (kCells + BX * BY - 1) / (BX * BY);
  const size_t o = L.face(j, i);
  const T nu_e = nuHe[o], nu_n = nuHn[o];
  const T nu_w = tc == 0 ? nuHe[L.face(j, i0 - 1)] : T(0);
  const T nu_s = tr == 0 ? nuHn[L.face(j0 - 1, i)] : T(0);
  const bool owned = i < nx && j < ny;
  const size_t k = (size_t)j * nx + i;
  const T b = owned ? beta[k] : T(0);
  T su[kShare], sv[kShare];
#pragma unroll
  for (int n = 0; n < kShare; ++n) {
    const int t = tr * BX + tc + n * BX * BY;
    if (t < kCells) {
      const int r = t / (BX + 2), c = t - r * (BX + 2);
      const size_t a = L.cell(j0 - 1 + r, i0 - 1 + c);
      su[n] = u[a];
      sv[n] = v[a];
    }
  }
#pragma unroll
  for (int n = 0; n < kShare; ++n) {
    const int t = tr * BX + tc + n * BX * BY;
    if (t < kCells) {
      const int r = t / (BX + 2), c = t - r * (BX + 2);
      s.u[r][c] = su[n];
      s.v[r][c] = sv[n];
    }
  }
  __syncthreads();

  matvec_east(s, nu_e, tr, tc, dx, dy);
  matvec_north(s, nu_n, tr, tc, dx, dy);
  if (tc == 0) matvec_east(s, nu_w, tr, -1, dx, dy);    // the west column
  if (tr == 0) matvec_north(s, nu_s, -1, tc, dx, dy);   // the south row
  __syncthreads();

  if (!owned) return;
  // at a closed edge the west (south) face is the cell's own east (north)
  // face, so that term of the divergence is exactly 0 (K1's clamp)
  const int we = L.west_edge(i) ? tc + 1 : tc;
  const int so = L.south_edge(j) ? tr + 1 : tr;
  const T div_x = (s.xx[tr][tc + 1] - s.xx[tr][we]) / dx +
                  (s.nxy[tr + 1][tc] - s.nxy[so][tc]) / dy;
  const T div_y = (s.xy[tr][tc + 1] - s.xy[tr][we]) / dx +
                  (s.yy[tr + 1][tc] - s.yy[so][tc]) / dy;
  const T mx = -div_x, my = -div_y;
  Au[k] = mx + b * s.u[tr + 1][tc + 1];
  Av[k] = my + b * s.v[tr + 1][tc + 1];
}

template <typename T, int BX, int BY, typename Layout>
int launch_smem(const void* u, const void* v, const void* nuHe,
                const void* nuHn, const void* beta, void* Au, void* Av,
                Layout L, int ny, int nx, double dx, double dy,
                void* stream) {
  ssa_matvec_smem_kernel<T, Layout, BX, BY>
      <<<dim3((nx + BX - 1) / BX, (ny + BY - 1) / BY), dim3(BX, BY), 0,
         (cudaStream_t)stream>>>(
          (const T*)u, (const T*)v, (const T*)nuHe, (const T*)nuHn,
          (const T*)beta, (T*)Au, (T*)Av, L, ny, nx, (T)dx, (T)dy);
  return (int)cudaGetLastError();
}

}  // namespace

#define STUDY(kind, launch, BX, BY, T, prec)                                  \
  int study_##kind##_##BX##x##BY##_matvec_##prec(                             \
      const void* u, const void* v, const void* ne, const void* nn,           \
      const void* b, void* Au, void* Av, int My, int Mx, double dx,           \
      double dy, void* s) {                                                   \
    return launch<T, BX, BY>(u, v, ne, nn, b, Au, Av, Clamped{My, Mx}, My,    \
                             Mx, dx, dy, s);                                  \
  }                                                                           \
  int study_##kind##_##BX##x##BY##_halo_##prec(                               \
      const void* u, const void* v, const void* ne, const void* nn,           \
      const void* b, void* Au, void* Av, int my, int mx, int west, int south, \
      double dx, double dy, void* s) {                                        \
    return launch<T, BX, BY>(u, v, ne, nn, b, Au, Av,                         \
                             Padded{my, mx, west, south}, my, mx, dx, dy, s); \
  }

#define STUDY_SHAPE(BX, BY)                      \
  STUDY(regs, launch_matvec, BX, BY, float, f32)  \
  STUDY(regs, launch_matvec, BX, BY, double, f64) \
  STUDY(smem, launch_smem, BX, BY, float, f32)    \
  STUDY(smem, launch_smem, BX, BY, double, f64)

extern "C" {
STUDY_SHAPE(32, 8)
STUDY_SHAPE(32, 4)
STUDY_SHAPE(16, 8)
STUDY_SHAPE(16, 4)
}
