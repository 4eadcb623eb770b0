// Per-member sums of an ensemble's member axis, for Hopper (sm_90a): the
// dot products of the SSA's Krylov solver, out[m] = sum(a0 b0) + sum(a1 b1)
// over member m's (My, Mx) cells for pairs of (B, My, Mx) fields; the
// three dots x.x, x.y, y.y of two pairs in one pass (the Krylov loop's
// paired dots); and the sum of one field per member (PICO's basin sums).
//
// Stands in for the dot products of the JAX package's BiCGStab
// (pism_tpu/ops/ssa.py bicgstab_solve, dot) and PICO's basin sums
// (pism_tpu/coupler/pico.py _per_basin_mean, segment_sum) under jax.vmap,
// which XLA reduces member by member. Torch's own sum over the last dims of
// a (B, N) tensor picks its block shape and its split across blocks by B,
// so the order in which a member's products are added, and with it the
// rounding, would change with the number of members; the SSA solve turns
// such a change into 1e-5 of max |u|. Here the order is fixed by the
// member's cell count n alone:
//   - a member's cells fall into C = ceil(n / W) chunks of W cells, W a
//     constant of the form (Chunk::kCells below), so C does not depend on B;
//   - block (c, m) of a (C, B) grid adds chunk c of member m: thread t
//     loads cells t, t + kThreads, ... of the chunk (all of them before it
//     adds any, so its loads are in flight together) and adds them in that
//     order; a fixed shuffle tree adds a warp's threads, and thread 0 the
//     warps in turn;
//   - each block writes its sum to the workspace and takes a ticket of its
//     member (release and acquire order, as in grid_max.cuh); the block
//     that takes the member's last ticket adds the member's C sums in
//     chunk order 0, 1, ..., C - 1 and puts the ticket back to 0 for the
//     next launch, so one launch does the whole sum and can be captured in
//     a CUDA graph.
// So a member's sums are those of the same member in any batch, a batch of
// one included. A dot rounds each product and sums each pair of fields
// apart, sum(a0 b0) + sum(a1 b1), as its plain version does (no fused
// multiply-add); the three dots of `dots` add each pair exactly as `dot`
// adds it (a product does not depend on its operands' order), so each
// equals the single dot to the bit.
// Loads are scalar: a member's base offset is m n elements, which for n odd
// is not 16-byte aligned, and a vector load would change a thread's cells.
//
// What bounds it: the bytes it reads, each field once (16 bytes a cell in
// float32 for a dot or the dots of two pairs, 4 for a sum; 100.8 MB for
// 100 members of 251 x 251, 30 us at 3.35 TB/s). C blocks a member fill
// the card at any B (31 at 251 x 251 and 6 at 141 x 76 for the dots, 16
// and 3 for a sum), each thread keeps 16-32 loads in flight, a member's last
// block adds its C sums while other members' blocks still read, so only the
// last member's pass over its sums (one L2 round trip a tile) is exposed.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// the launch (0 = success). The kernel allocates nothing and launches on the
// stream it is given; `work` holds B C S + B 64-bit words (S sums kept a
// member: 2 for a dot, 6 for the dots, 1 for a sum; pism_member_chunk_cells
// gives W): B tickets that are 0 between launches, then scratch. Launches
// that share it run in stream order and have one member count B: with
// another B, one launch's scratch would lie where the other's tickets are.

#include <cuda_runtime.h>

namespace {

// The launch shape: threads a block, and the cells a thread takes of each
// field in a chunk (kDotPer for the dots, kSumPer for a sum), so that 32
// loads of a thread are in flight for a dot and 16 for a sum. Each sets
// the chunk width W and with it every member's order of addition.
// PERF.md keeps what other shapes took.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDotPer = 8;
constexpr int kSumPer = 16;

// a product rounded on its own: never contracted into a fused multiply-add
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// The forms: F fields read a cell, S sums kept a member, D results a
// member, kPer cells a thread takes of each field in a chunk. add() folds
// one cell's values v into the sums p; result(s, d) forms result d of a
// member's finished sums s.

// (a0, b0, a1, b1): sum(a0 b0) + sum(a1 b1)
struct Dot {
  static constexpr int F = 4, S = 2, D = 1, kPer = kDotPer;
  template <typename In, typename Acc>
  __device__ static void add(const In (&v)[F], Acc (&p)[S]) {
    p[0] += mul_rn(Acc(v[0]), Acc(v[1]));
    p[1] += mul_rn(Acc(v[2]), Acc(v[3]));
  }
  template <typename Acc>
  __device__ static Acc result(const Acc* s, int) { return s[0] + s[1]; }
};

// (x0, x1, y0, y1): x.x, x.y, y.y, each pair added as Dot adds it
struct Gram {
  static constexpr int F = 4, S = 6, D = 3, kPer = kDotPer;
  template <typename In, typename Acc>
  __device__ static void add(const In (&v)[F], Acc (&p)[S]) {
    const Acc x0 = Acc(v[0]), x1 = Acc(v[1]), y0 = Acc(v[2]), y1 = Acc(v[3]);
    p[0] += mul_rn(x0, x0);
    p[1] += mul_rn(x1, x1);
    p[2] += mul_rn(x0, y0);
    p[3] += mul_rn(x1, y1);
    p[4] += mul_rn(y0, y0);
    p[5] += mul_rn(y1, y1);
  }
  template <typename Acc>
  __device__ static Acc result(const Acc* s, int d) {
    return s[2 * d] + s[2 * d + 1];
  }
};

// (x): the sum of x
struct Sum {
  static constexpr int F = 1, S = 1, D = 1, kPer = kSumPer;
  template <typename In, typename Acc>
  __device__ static void add(const In (&v)[F], Acc (&p)[S]) {
    p[0] += Acc(v[0]);
  }
  template <typename Acc>
  __device__ static Acc result(const Acc* s, int) { return s[0]; }
};

template <typename Form>
struct Chunk {
  static constexpr int kCells = kThreads * Form::kPer;
};

template <typename In, int F>
struct Fields {
  const In* p[F];
};

// where the D sums of a member go: out[d][m], or nowhere if out[d] is null
template <typename Acc, int D>
struct Outs {
  Acc* p[D];
};

// the ticket's old value after adding 1, with release and acquire order at
// device scope (grid_max.cuh's take_ticket)
__device__ __forceinline__ unsigned long long take_ticket(
    unsigned long long* ticket) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;"
               : "=l"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// grid (C, B): block (c, m) adds chunk c of member m into the workspace
// (work: B tickets, then the (B, C, S) sums of the chunks); the block that
// takes member m's last ticket adds its chunks in order and writes its
// results into out
template <typename In, typename Acc, typename Form>
__global__ void __launch_bounds__(kThreads) member_sums_kernel(
    Fields<In, Form::F> f, Outs<Acc, Form::D> out, long long n,
    unsigned long long* __restrict__ work) {
  constexpr int F = Form::F, S = Form::S, kPer = Form::kPer;
  constexpr int W = Chunk<Form>::kCells;
  constexpr int kTile = (kThreads / S) * S;   // whole chunks' S sums
  __shared__ Acc wsum[S][kWarps];
  __shared__ Acc tile[kTile];
  __shared__ Acc fin[S];
  __shared__ bool last;
  const int t = threadIdx.x, c = blockIdx.x, m = blockIdx.y;
  const int chunks = gridDim.x, members = gridDim.y;
  const long long first = (long long)c * W;
  const long long left = n - first;   // this member's cells from `first` on
  const size_t base = (size_t)m * (size_t)n + (size_t)first;

  In v[kPer][F];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = t + j * kThreads;
#pragma unroll
    for (int i = 0; i < F; ++i)
      v[j][i] = k < left ? __ldg(f.p[i] + base + k) : In(0);
  }
  Acc p[S];
#pragma unroll
  for (int i = 0; i < S; ++i) p[i] = Acc(0);
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (t + j * kThreads < left) Form::add(v[j], p);

  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    Acc q = p[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) q += __shfl_down_sync(0xffffffffu, q, o);
    if (lane == 0) wsum[i][warp] = q;
  }
  __syncthreads();
  unsigned long long* ticket = work + m;
  Acc* part = (Acc*)(work + members) + (size_t)m * chunks * S;
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      Acc s = wsum[i][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += wsum[i][w];
      part[(size_t)c * S + i] = s;
    }
    last = take_ticket(ticket) == (unsigned long long)chunks - 1;
  }
  __syncthreads();
  if (!last) return;
  // member m's chunk sums, read from L2 (ld.global.cg; ordered after the
  // other blocks' release by thread 0's acquire and the barrier) a tile at
  // a time, sum i added by thread i in chunk order
  Acc s = Acc(0);
  const int total = chunks * S;
  for (int b0 = 0; b0 < total; b0 += kTile) {
    const int len = min(total - b0, kTile);
    if (t < len) tile[t] = __ldcg(part + b0 + t);
    __syncthreads();
    if (t < S)
      for (int k = t; k < len; k += S) s += tile[k];
    __syncthreads();
  }
  if (t < S) fin[t] = s;
  __syncthreads();
  if (t < Form::D && out.p[t] != nullptr)
    out.p[t][m] = Form::template result<Acc>(fin, t);
  if (t == 0) *ticket = 0ull;
}

template <typename In, typename Acc, typename Form>
int launch(Fields<In, Form::F> f, Outs<Acc, Form::D> out, long long n,
           int members, void* work, void* stream) {
  if (members <= 0 || n <= 0) return 0;
  const long long chunks = (n + Chunk<Form>::kCells - 1) / Chunk<Form>::kCells;
  member_sums_kernel<In, Acc, Form>
      <<<dim3((unsigned)chunks, (unsigned)members), kThreads, 0,
         (cudaStream_t)stream>>>(f, out, n, (unsigned long long*)work);
  return (int)cudaGetLastError();
}

template <typename In, typename Acc>
int dot(const void* a0, const void* b0, const void* a1, const void* b1,
        void* out, long long n, int members, void* work, void* stream) {
  Fields<In, 4> f{{(const In*)a0, (const In*)b0, (const In*)a1,
                   (const In*)b1}};
  return launch<In, Acc, Dot>(f, Outs<Acc, 1>{{(Acc*)out}}, n, members, work,
                              stream);
}

template <typename In, typename Acc>
int dots(const void* x0, const void* x1, const void* y0, const void* y1,
         void* xx, void* xy, void* yy, long long n, int members, void* work,
         void* stream) {
  Fields<In, 4> f{{(const In*)x0, (const In*)x1, (const In*)y0,
                   (const In*)y1}};
  return launch<In, Acc, Gram>(f, Outs<Acc, 3>{{(Acc*)xx, (Acc*)xy, (Acc*)yy}},
                               n, members, work, stream);
}

template <typename In, typename Acc>
int sum(const void* x, void* out, long long n, int members, void* work,
        void* stream) {
  Fields<In, 1> f{{(const In*)x}};
  return launch<In, Acc, Sum>(f, Outs<Acc, 1>{{(Acc*)out}}, n, members, work,
                              stream);
}

}  // namespace

extern "C" {

// W, the cells of a chunk, of form 0 (dot), 1 (dots) or 2 (sum)
int pism_member_chunk_cells(int form) {
  return form == 2 ? Chunk<Sum>::kCells
                   : form == 1 ? Chunk<Gram>::kCells : Chunk<Dot>::kCells;
}

// a0, b0, a1, b1: (members, n) fields of one type; out: (members,).
int pism_member_dot_f32(const void* a0, const void* b0, const void* a1,
                        const void* b1, void* out, long long n, int members,
                        void* work, void* stream) {
  return dot<float, float>(a0, b0, a1, b1, out, n, members, work, stream);
}

int pism_member_dot_f64(const void* a0, const void* b0, const void* a1,
                        const void* b1, void* out, long long n, int members,
                        void* work, void* stream) {
  return dot<double, double>(a0, b0, a1, b1, out, n, members, work, stream);
}

// float fields, the products and sums in double
int pism_member_dot_f32_f64(const void* a0, const void* b0, const void* a1,
                            const void* b1, void* out, long long n,
                            int members, void* work, void* stream) {
  return dot<float, double>(a0, b0, a1, b1, out, n, members, work, stream);
}

// x = (x0, x1), y = (y0, y1): (members, n) fields of one type; xx, xy, yy:
// (members,) each, or null for a dot not wanted.
int pism_member_dots_f32(const void* x0, const void* x1, const void* y0,
                         const void* y1, void* xx, void* xy, void* yy,
                         long long n, int members, void* work, void* stream) {
  return dots<float, float>(x0, x1, y0, y1, xx, xy, yy, n, members, work,
                            stream);
}

int pism_member_dots_f64(const void* x0, const void* x1, const void* y0,
                         const void* y1, void* xx, void* xy, void* yy,
                         long long n, int members, void* work, void* stream) {
  return dots<double, double>(x0, x1, y0, y1, xx, xy, yy, n, members, work,
                              stream);
}

int pism_member_dots_f32_f64(const void* x0, const void* x1, const void* y0,
                             const void* y1, void* xx, void* xy, void* yy,
                             long long n, int members, void* work,
                             void* stream) {
  return dots<float, double>(x0, x1, y0, y1, xx, xy, yy, n, members, work,
                             stream);
}

// x: (members, n); out: (members,).
int pism_member_sum_f32(const void* x, void* out, long long n, int members,
                        void* work, void* stream) {
  return sum<float, float>(x, out, n, members, work, stream);
}

int pism_member_sum_f64(const void* x, void* out, long long n, int members,
                        void* work, void* stream) {
  return sum<double, double>(x, out, n, members, work, stream);
}

}  // extern "C"
