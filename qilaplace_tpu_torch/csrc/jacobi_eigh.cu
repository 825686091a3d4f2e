// Batched Hermitian eigensolver by parallel-order cyclic Jacobi (kernel K2).
//
// Replaces the Pallas TPU kernel qilaplace_tpu/ops/jacobi.py:302
// (_jacobi_kernel, launched by jacobi_eigh_pallas at :420). For each of B
// Hermitian matrices H [m, m], complex64 (interleaved float2) or real float32,
// m even, 2 <= m <= 512: sweeps * (m - 1) Brent-Luk rounds, each applying m/2
// independent 2x2 rotations
//   J_i = [[c, -z], [conj(z), c]],  z = w t c / |w|,  w = G[2i, 2i+1],
// with t from tau = (G[2i,2i] - G[2i+1,2i+1]) / (2 |w|) as in the plain version
// (ops/jacobi.py, _pair_rotations: the tie tau >= 0 takes t = +1, a pair with
// w = 0 gets the identity), as G <- J^H G J and V <- V J. Output: the
// eigenvalues ascending and V with its columns in the same order.
//
// What bounds it on an H100: a round is O(m^2) work (30 m^2 flops complex,
// 9 m^2 real), but the rounds form a dependent chain: 115 / 234 / 474 rounds
// at the QFT path's m = 24 / 40 / 80, 1,113 at the gate path's m = 160 (7
// sweeps), at B = 1. A round's latency bounds the kernel, hundreds of times
// above its flop bound: the chain of sqrt and division that makes a
// rotation, the shared-memory traffic of the O(m^2) update through an SM's
// 128 bytes a cycle (at m = 80 about 200 KB a round for G and V; at m = 160
// 410 KB for G alone) and the barrier. A batch fills more SMs.
//
// Common to every variant:
//  * pair-adjacent positions, as the plain version keeps them: pair i sits at
//    positions (2i, 2i+1) in every round, and the round writes its output at
//    the next round's positions, p -> dst[p] (the inverse of the tournament
//    permutation sigma; the wrapper hands the table over, m ints), into a
//    second buffer: G_{r+1}[dst[a], dst[b]] = (J^H G_r J)[a, b] and
//    V_{r+1}[:, dst[b]] = (V_r J)[:, b]. After every full sweep the positions
//    are the indices again;
//  * columns are stored even positions first, then odd (position p at column
//    slot p/2 + (p%2) c, c = m/2). A pair's two columns are then two slots c
//    apart, neighbouring pairs neighbouring slots, and the tournament's moves
//    (2K -> 2K+2, 2K+1 -> 2K-1 inside the list) become shifts by one slot, so
//    a warp's loads and stores are each one dense run: no bank conflicts;
//  * one synchronisation a round: G is double-buffered, and the round also
//    makes the NEXT round's rotations: warps of their own, one thread a
//    pair, rebuild the pair's next diagonal block from G_r and this round's
//    rotations (three entries of J^H G_r J, by the same arithmetic as the
//    update) and run the rotation's chain of sqrt and division while the
//    other warps update G. The end of the round (a block barrier, or the
//    cluster's exchange below) publishes G_{r+1} and the rotations together
//    (a double-buffered table);
//  * no division in the round: thread (K, y) owns column pair K and row pairs
//    y, y + Y, ...; its destinations are computed once;
//  * a real variant (the template's element type): float32 input stays real,
//    9 m^2 flops a round and half the memory;
//  * the same numbers as the plain version: the rotation with IEEE sqrtf and
//    division (no fast math), each product and sum rounded as
//    _pair_rotations rounds it, and each entry of J^H G J and V J summed as
//    the plain version's matrix products sum it (k ascending: the first
//    nonzero term rounded, the second fused onto it). Splitting the work
//    changes who computes an entry, never how: on the card every variant
//    reproduces the plain version bit for bit.
//
// Three variants, by m, each held by the latency of a round (measured on an
// H100, scripts/port/k2_variants.py and chip_smoke.py):
//  * m <= SMEM_MAX_M = 84: one block a matrix holds G and V, both
//    double-buffered (32 m^2 bytes complex), in dynamic shared memory
//    (225,792 of the 232,448 bytes a block may opt in to at m = 84), and
//    updates V beside G in the same round. Up to 1,024 threads: m = 80 is
//    40 x 20 threads, two row pairs each, and two warps of rotation makers.
//    A round, 0.7-1.5 us, is the block's own chain: the rotation, the
//    update, a barrier;
//  * SMEM_MAX_M < m <= CLUSTER_MAX_M = 320: G alone, double-buffered, in
//    the distributed shared memory of a cluster of nb <= 8 blocks (one
//    cluster a matrix). Block k owns the column pairs [k w, (k+1) w) (about
//    PAIRS_PER_BLOCK of them, at most MAX_CLUSTER blocks), both slots of
//    each pair, in all m rows: a cluster of 8 at m = 160 (51,200 bytes of G
//    a block) and at m = 288 (165,888). The left product (rows p, q of a
//    pair) and the right product (a pair's two columns) are then local;
//    only the tournament's one-slot shift at each range's edge (one column
//    each way) and the makers' reads of diagonal blocks across an edge
//    reach a neighbour's shared memory. The maker of pair i puts the
//    rotation into every block's table; it lives in the block that owns
//    pair i, except where one of the columns it reads crossed an edge in
//    the last round: then in the block that column crossed into, so that a
//    block reads in another only what that block wrote itself.
//    No cluster barrier: that costs 0.7 us on the H100 with the
//    release/acquire ordering the remote stores need (0.12 us without).
//    The remote stores are st.async instead, each counting its bytes on the
//    receiving block's mbarrier; a block waits on its own mbarrier for what
//    it is owed, after a block barrier for its own stores (see the cluster
//    kernel for why nothing is overwritten early or read too soon). V
//    leaves the chain: its rows never move and V_{r+1} = V_r J_r needs only
//    the rotations, so the makers also log each round's rotations (c of
//    them, 1,280 bytes at m = 160) to device memory, and a second kernel
//    applies them to V, a row a warp (rows are independent: no block
//    barrier a round), with the log staged through shared memory V_CHUNK
//    rounds at a time. It also ranks the eigenvalues and writes V in their
//    order. At m = 160 a round takes 1.68 us, about 1.4 us of it in the
//    cluster kernel, where the update's own share is about 0.29 us and the
//    rotation's chain about 0.22 us; the rest is the exchange (the makers'
//    reads across an edge, the st.async of rotations into eight blocks,
//    the wait). The vector pass adds 0.26 us a round, a latency chain of
//    one warp (more SMs do not help). At m = 288 the update grows to about
//    0.8 us a round: w = 18 pairs of 144 rows a block;
//  * m > CLUSTER_MAX_M: G in c64 is 2 MiB at m = 512, more than a portable
//    cluster (1.86 MB) or one of 16 (3.72 MB) holds twice. The cluster's
//    storage and schedule run instead on a group of nb <= MAX_GROUP blocks
//    of GROUP_PAIRS column pairs (32 blocks of 8 at m = 512, 172,164 bytes
//    a block) that a cooperative launch makes resident together, trading
//    through device memory (L2): each block also keeps, twice, the columns
//    of the pair beside each edge (a ghost pair), so that every maker reads
//    its own shared memory; the owners store each output column that a
//    neighbour keeps into that neighbour's inbox (of a ghost pair's
//    columns only the rows its makers read), the makers log the rotations,
//    and each round ends with one fenced flag a block, which every block
//    waits for before it reads the log (the next rotations) and its inbox
//    (see the group kernel), each thread issuing all its loads before its
//    first store. The vector pass is the cluster variant's. A flag barrier
//    across 32 blocks costs 1.1 us on the H100 (a flag's round trip
//    between two blocks 1.24 us), 2.0 us with four columns of m = 512
//    aboard; a round of the group kernel costs 3.5 us at c64 m = 512, 3.2
//    us without the update: the exchange and the makers' chain behind it
//    hold the round. The vector pass adds 0.57 us a round at m = 512 (8
//    column pairs a lane): 14.5 ms in all at 7 sweeps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_M = 512;
constexpr int SMEM_MAX_M = 84;  // largest m whose G and V buffers fit in shared
constexpr int CLUSTER_MAX_M = 320;  // largest m whose G a cluster holds
constexpr int MAX_CLUSTER = 8;      // blocks a cluster (the portable limit)
constexpr int PAIRS_PER_BLOCK = 10;  // column pairs a cluster block aims at
constexpr int GROUP_PAIRS = 8;  // column pairs a group block aims at
constexpr int MAX_GROUP = 32;   // blocks a group (one warp reads their flags)
constexpr int RECV_UNROLL = 2;  // received rows a group thread loads at once
constexpr int V_WARPS = 8;   // rows of V a block of the vector pass
constexpr int V_CHUNK = 16;  // rounds of rotations it stages at a time
constexpr int MAX_THREADS = 1024;
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_OPT_IN = 232448;  // dynamic shared memory a block may use

// Element types. left(): rows (p, q) of J^H G in one column; right():
// columns (0, 1) of X J in one row. Each entry is summed as the plain
// version's matrix products sum it: over k ascending, the first nonzero
// term rounded, the second fused onto it.

// complex64: one element is a float2
struct C64 {
  using T = float2;
  static __device__ __forceinline__ float re(T a) { return a.x; }
  static __device__ __forceinline__ float absval(T w) { return hypotf(w.x, w.y); }
  static __device__ __forceinline__ T scale(float s, T a) {
    return make_float2(s * a.x, s * a.y);
  }
  static __device__ __forceinline__ T eye(bool diag) {
    return make_float2(diag ? 1.f : 0.f, 0.f);
  }
  static __device__ __forceinline__ void left(float c, T z, T gp, T gq, T& xp, T& xq) {
    xp = make_float2(fmaf(-z.y, gq.y, fmaf(z.x, gq.x, __fmul_rn(c, gp.x))),
                     fmaf(z.y, gq.x, fmaf(z.x, gq.y, __fmul_rn(c, gp.y))));
    xq = make_float2(fmaf(c, gq.x, fmaf(-z.y, gp.y, __fmul_rn(-z.x, gp.x))),
                     fmaf(c, gq.y, fmaf(z.y, gp.x, __fmul_rn(-z.x, gp.y))));
  }
  static __device__ __forceinline__ void right(float c, T z, T x0, T x1, T& y0, T& y1) {
    y0 = make_float2(fmaf(-x1.y, -z.y, fmaf(x1.x, z.x, __fmul_rn(x0.x, c))),
                     fmaf(x1.y, z.x, fmaf(x1.x, -z.y, __fmul_rn(x0.y, c))));
    y1 = make_float2(fmaf(x1.x, c, fmaf(-x0.y, -z.y, __fmul_rn(x0.x, -z.x))),
                     fmaf(x1.y, c, fmaf(x0.y, -z.x, __fmul_rn(x0.x, -z.y))));
  }
};

// float32: the real variant
struct F32 {
  using T = float;
  static __device__ __forceinline__ float re(T a) { return a; }
  static __device__ __forceinline__ float absval(T w) { return fabsf(w); }
  static __device__ __forceinline__ T scale(float s, T a) { return s * a; }
  static __device__ __forceinline__ T eye(bool diag) { return diag ? 1.f : 0.f; }
  static __device__ __forceinline__ void left(float c, T z, T gp, T gq, T& xp, T& xq) {
    xp = fmaf(z, gq, __fmul_rn(c, gp));
    xq = fmaf(c, gq, __fmul_rn(-z, gp));
  }
  static __device__ __forceinline__ void right(float c, T z, T x0, T x1, T& y0, T& y1) {
    y0 = fmaf(x1, z, __fmul_rn(x0, c));
    y1 = fmaf(x1, c, __fmul_rn(x0, -z));
  }
};

template <typename E>
struct alignas(2 * sizeof(typename E::T)) Rot {
  float c;
  typename E::T z;
};

// column slot of position p: even positions first, then odd
__device__ __forceinline__ int slot(int p, int c) { return (p >> 1) + (p & 1) * c; }

// the rotation of a pair with diagonal (a, d) and coupling w, as
// _pair_rotations computes it
template <typename E>
__device__ __forceinline__ Rot<E> rotation(float a, float d, typename E::T w) {
  const float absw = E::absval(w);
  Rot<E> r;
  if (absw > 0.f) {
    const float tau = __fdiv_rn(__fsub_rn(a, d), __fmul_rn(2.f, absw));
    const float sgn = tau >= 0.f ? 1.f : -1.f;
    const float t = __fdiv_rn(
        sgn, __fadd_rn(fabsf(tau), __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(tau, tau)))));
    r.c = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(t, t))));
    r.z = E::scale(__fdiv_rn(__fmul_rn(t, r.c), absw), w);
  } else {
    r.c = 1.f;
    r.z = E::eye(false);
  }
  return r;
}

// entry (s, t) of J_P^H G[pair P, pair Q] J_Q: what the update writes for it.
// g points at G[2P, slot Q]; rows are `ld` elements apart and the pair's
// second column `odd` elements after its first
template <typename E>
__device__ __forceinline__ typename E::T entry(const typename E::T* g, int ld, int odd,
                                               int s, int t, const Rot<E>& rP,
                                               const Rot<E>& rQ) {
  using T = typename E::T;
  T x00, x10, x01, x11, y0, y1;
  E::left(rP.c, rP.z, g[0], g[ld], x00, x10);
  E::left(rP.c, rP.z, g[odd], g[ld + odd], x01, x11);
  if (s) {
    E::right(rQ.c, rQ.z, x10, x11, y0, y1);
  } else {
    E::right(rQ.c, rQ.z, x00, x01, y0, y1);
  }
  return t ? y1 : y0;
}

// strict total order for the final sort: ascending, NaN last, ties by index
__device__ __forceinline__ bool before(float x, int i, float y, int j) {
  const bool nx = x != x, ny = y != y;
  if (nx || ny) return (nx && ny) ? i < j : ny;
  return x < y || (x == y && i < j);
}

template <typename E>
__global__ void __launch_bounds__(MAX_THREADS)
jacobi_eigh_kernel(const typename E::T* __restrict__ h_in, float* __restrict__ lam_out,
                   typename E::T* __restrict__ v_out, const int* __restrict__ dst_in,
                   int m, int Y, int sweeps) {
  using T = typename E::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = m / 2;
  const int mm = m * m;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  // once per launch: thread (K, y) owns column pair K and row pairs
  // y, y + Y, ..., J of them; threads with y >= Y pad the last such warp.
  // The warps after those (threads from `makers` on) make the rotations.
  const int K = tid % c;
  const int y = tid / c;
  const int J = (c + Y - 1) / Y;
  const bool owner = y < Y;
  const int makers = (c * Y + 31) / 32 * 32;

  T* G0 = reinterpret_cast<T*>(smem);
  Rot<E>* R = reinterpret_cast<Rot<E>*>(smem + 4 * mm * sizeof(T));
  int* dst = reinterpret_cast<int*>(R + 2 * c);
  int* src = dst + m;
  int* perm = src + m;
  T* Gc = G0;          // G_r
  T* Gn = G0 + mm;     // G_{r+1}
  T* Vc = G0 + 2 * mm; // V_r
  T* Vn = G0 + 3 * mm; // V_{r+1}

  const T* H = h_in + b * mm;
  for (int j = tid; j < m; j += nthr) dst[j] = dst_in[j];
  if (owner) {
    for (int row = y; row < m; row += Y) {
      for (int col = K; col < m; col += c) {
        Gc[row * m + slot(col, c)] = H[row * m + col];
        Vc[row * m + slot(col, c)] = E::eye(row == col);
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < m; j += nthr) src[dst[j]] = j;
  for (int j = tid; j < c; j += nthr) {
    R[j] = rotation<E>(E::re(Gc[2 * j * m + j]), E::re(Gc[(2 * j + 1) * m + c + j]),
                       Gc[2 * j * m + c + j]);
  }
  __syncthreads();

  // this thread's destination column slots
  const int sK0 = slot(dst[2 * K], c), sK1 = slot(dst[2 * K + 1], c);
  // maker i rebuilds pair i's next diagonal block, whose positions
  // (2i, 2i + 1) hold this round's positions a and bb
  const int i = tid - makers;
  const bool maker = i >= 0 && i < c;
  const int a = maker ? src[2 * i] : 0, bb = maker ? src[2 * i + 1] : 1;
  const int A = a >> 1, sa = a & 1, B = bb >> 1, sb = bb & 1;

  const int rounds = sweeps * (m - 1);
  for (int r = 0; r < rounds; ++r) {
    const Rot<E>* Rc = R + (r & 1) * c;
    if (maker && r + 1 < rounds) {
      const Rot<E> rA = Rc[A], rB = Rc[B];
      const float d0 = E::re(entry<E>(Gc + 2 * A * m + A, m, c, sa, sa, rA, rA));
      const float d1 = E::re(entry<E>(Gc + 2 * B * m + B, m, c, sb, sb, rB, rB));
      const T w = entry<E>(Gc + 2 * A * m + B, m, c, sa, sb, rA, rB);
      R[((r + 1) & 1) * c + i] = rotation<E>(d0, d1, w);
    }
    if (owner) {
      const Rot<E> rk = Rc[K];
      for (int j = 0; j < J; ++j) {
        const int I = y + j * Y;
        if (I >= c) break;
        const Rot<E> ri = Rc[I];
        const int p = 2 * I, q = p + 1;
        const int2 dI = *reinterpret_cast<const int2*>(dst + p);
        T x0, x1, y0, y1, xq0, xq1;
        // G: rows p, q of J_I^H G in columns 2K, 2K+1, then times J_K
        E::left(ri.c, ri.z, Gc[p * m + K], Gc[q * m + K], x0, xq0);
        E::left(ri.c, ri.z, Gc[p * m + c + K], Gc[q * m + c + K], x1, xq1);
        E::right(rk.c, rk.z, x0, x1, y0, y1);
        Gn[dI.x * m + sK0] = y0;
        Gn[dI.x * m + sK1] = y1;
        E::right(rk.c, rk.z, xq0, xq1, y0, y1);
        Gn[dI.y * m + sK0] = y0;
        Gn[dI.y * m + sK1] = y1;
        // V: rows p, q times J_K (V's rows never move)
        E::right(rk.c, rk.z, Vc[p * m + K], Vc[p * m + c + K], y0, y1);
        Vn[p * m + sK0] = y0;
        Vn[p * m + sK1] = y1;
        E::right(rk.c, rk.z, Vc[q * m + K], Vc[q * m + c + K], y0, y1);
        Vn[q * m + sK0] = y0;
        Vn[q * m + sK1] = y1;
      }
    }
    T* t = Gc; Gc = Gn; Gn = t;
    t = Vc; Vc = Vn; Vn = t;
    __syncthreads();
  }

  // eigenvalues ascending: rank each diagonal entry, then gather V's columns
  for (int j = tid; j < m; j += nthr) {
    const float lj = E::re(Gc[j * m + slot(j, c)]);
    int rank = 0;
    for (int k = 0; k < m; ++k) rank += before(E::re(Gc[k * m + slot(k, c)]), k, lj, j);
    perm[rank] = j;
    lam_out[b * m + rank] = lj;
  }
  __syncthreads();
  T* Vo = v_out + b * mm;
  if (owner) {
    for (int row = y; row < m; row += Y) {
      for (int col = K; col < m; col += c) {
        Vo[row * m + col] = Vc[row * m + slot(perm[col], c)];
      }
    }
  }
}

// --------------------- the cluster variant (84 < m <= 320) ---------------------

// the block of a cluster that owns column slot s (pair s mod c), and the
// slot's column in that block's rows of 2w: its w even slots, then its odd
__device__ __forceinline__ int slot_block(int s, int c, int w) {
  return (s < c ? s : s - c) / w;
}
__device__ __forceinline__ int slot_col(int s, int c, int w) {
  return s < c ? s % w : (s - c) % w + w;
}

// p (in this block's shared memory) as the same offset in block q's: the
// block's own address where q is this block k, so that the access stays in
// the SM, else the cluster's window onto q
template <typename P>
__device__ __forceinline__ P* in_block(cg::cluster_group cluster, P* p, int q,
                                       int k) {
  return q == k ? p : cluster.map_shared_rank(p, q);
}

// the block of a cluster of blocks of w column pairs that makes pair i's
// rotations: the one that holds a column of i's next diagonal block (the
// columns of pairs A and B, whose positions move to i's) that crossed a
// block edge in the last round, else the one that owns i. The crossed
// column came by st.async, which completes on its holder's mbarrier only;
// every other column is read where its holder's own owners wrote it. With
// w >= 2 no maker needs two crossed columns in two blocks (a trap if so)
__device__ __forceinline__ int maker_block(const int* src, int i, int c, int w) {
  const int A = src[2 * i] >> 1, B = src[2 * i + 1] >> 1;
  int at = -1;
  for (int e = 0; e < 4; ++e) {
    const int pos = 2 * (e < 2 ? A : B) + e % 2;
    const int held = slot_block(slot(pos, c), c, w);
    if (held != (src[pos] >> 1) / w) {  // written by another block's owner
      if (at >= 0 && at != held) __trap();
      at = held;
    }
  }
  return at >= 0 ? at : i / w;
}

// shared::cta address of p, and the shared::cluster address of the same
// offset in block q
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int q) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(q));
  return out;
}

// st.async: store into a block of the cluster (shared::cluster address a)
// and count the bytes on that block's mbarrier (address bar), which makes
// them visible to whoever waits on it
__device__ __forceinline__ void st_async(unsigned a, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];"
               ::"r"(a), "f"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(unsigned a, float2 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
      ::"r"(a), "f"(v.x), "f"(v.y), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(unsigned a, const Rot<C64>& r, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(a), "f"(r.c), "f"(0.f), "f"(r.z.x), "f"(r.z.y), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(unsigned a, const Rot<F32>& r, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
      ::"r"(a), "f"(r.c), "f"(r.z), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}
// the one arrival of the barrier's phase, with the bytes it is to receive
__device__ __forceinline__ void mbar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}
// wait for the barrier's phase of this parity to complete; an exchange
// still missing after a second traps (the launch fails) instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  unsigned long long t0 = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (t0 == 0) t0 = now;
    if (now - t0 > 1000000000ull) __trap();
  }
}

// G's rounds on a cluster of nb blocks (one cluster a matrix): block k holds
// rows 0..m-1 of the slots of its column pairs [k w, k w + wk), twice. Writes
// every round's rotations to rot_log [B, rounds, c] and the final diagonal to
// diag [B, m] (by position, unsorted) for the vector pass.
//
// The exchange of a round, with no cluster barrier: an owner whose output
// column lies in another block (one column each way at a range's edge)
// stores it there by st.async, and each maker, once its block's round is
// done (a block barrier), stores the next rotation into every block's table
// the same way; every block then waits on its own mbarrier for the bytes
// it is owed (the rotations, and its edge columns). Two mbarriers alternate
// by round, as a block can be at most one round ahead of another. Nothing
// is overwritten while it may still be read: a block enters round r + 1
// only with every block's rotations for it, which each block sends only
// after all of its reads of round r. Nothing is read before it is written:
// a maker reads in another block only what that block's owners wrote
// before its block barrier, and the rotations it sent after that barrier
// (their mbarrier's release, the wait's acquire) order that write before
// the read; an edge column that crossed into a block is read only there,
// after its own wait (maker_block).
template <typename E>
__global__ void __launch_bounds__(MAX_THREADS)
jacobi_cluster_kernel(const typename E::T* __restrict__ h_in, float* __restrict__ diag,
                      Rot<E>* __restrict__ rot_log, const int* __restrict__ dst_in,
                      int m, int w, int Y, int sweeps) {
  using T = typename E::T;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = m / 2;
  const int L = 2 * w;  // a row of this block's G
  const int nb = (int)cluster.num_blocks();
  const int k = (int)cluster.block_rank();
  const size_t b = blockIdx.x / nb;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int k0 = k * w;            // this block's first column pair
  const int wk = min(w, c - k0);   // and how many it owns
  const int rounds = sweeps * (m - 1);
  const int buf = m * L;           // elements of one G buffer

  T* G0 = reinterpret_cast<T*>(smem);  // G_r, G_{r+1}: buffers r & 1, 1 - (r & 1)
  Rot<E>* R = reinterpret_cast<Rot<E>*>(G0 + 2 * buf);
  int* dst = reinterpret_cast<int*>(R + 2 * c);
  int* src = dst + m;
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(src + m);
  const T* H = h_in + b * m * m;
  Rot<E>* rots = rot_log + b * rounds * c;

  for (int j = tid; j < m; j += nthr) dst[j] = dst_in[j];
  for (int e = tid; e < m * 2 * wk; e += nthr) {
    const int row = e / (2 * wk), l = e % (2 * wk);
    const bool odd = l >= wk;
    const int pair = k0 + (odd ? l - wk : l);
    G0[row * L + (odd ? l - wk + w : l)] = H[row * m + 2 * pair + odd];
  }
  // round 0's rotations, from H: every block makes all of them
  for (int j = tid; j < c; j += nthr) {
    const Rot<E> r0 = rotation<E>(E::re(H[2 * j * m + 2 * j]),
                                  E::re(H[(2 * j + 1) * m + 2 * j + 1]),
                                  H[2 * j * m + 2 * j + 1]);
    R[j] = r0;
    if (k == 0 && rounds > 0) rots[j] = r0;
  }
  if (tid == 0) {
    mbar_init(smem_addr(mbar));
    mbar_init(smem_addr(mbar + 1));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int j = tid; j < m; j += nthr) src[dst[j]] = j;
  // the bytes of edge columns other blocks' owners store here each round
  int edge_bytes = 0;
  for (int K = 0; K < c && tid == 0; ++K) {
    for (int e = 0; e < 2; ++e) {
      if (K / w != k && slot_block(slot(dst[2 * K + e], c), c, w) == k) {
        edge_bytes += m * (int)sizeof(T);
      }
    }
  }
  cluster.sync();  // every block runs, its mbarriers initialised

  // owner (K, y): column pair k0 + K, row pairs y, y + Y, ...; its two
  // destination columns: here, or in the block that owns them (its
  // shared::cluster address in buffer 0, and that block's first mbarrier)
  const int K = tid % w, y = tid / w;
  const int J = (c + Y - 1) / Y;
  const bool owner = y < Y && K < wk;
  const int makers = (w * Y + 31) / 32 * 32;
  const int s0 = slot(dst[2 * min(k0 + K, c - 1)], c);
  const int s1 = slot(dst[2 * min(k0 + K, c - 1) + 1], c);
  const int b0 = slot_block(s0, c, w), b1 = slot_block(s1, c, w);
  const int l0 = slot_col(s0, c, w), l1 = slot_col(s1, c, w);
  const unsigned far0 = cluster_addr(smem_addr(G0 + l0), b0);
  const unsigned far1 = cluster_addr(smem_addr(G0 + l1), b1);
  const unsigned bar0 = cluster_addr(smem_addr(mbar), b0);
  const unsigned bar1 = cluster_addr(smem_addr(mbar), b1);
  // maker j of this block takes the j-th pair i (of this block's and its
  // neighbours' edge pairs) that maker_block gives to this block, and
  // rebuilds its next diagonal block from positions a and bb of this
  // round: rows of pair A at the columns of A, rows of B and of A at the
  // columns of B, in the blocks that hold them
  int i = -1;
  for (int p = max(k0 - 1, 0), j = tid - makers; j >= 0 && p < min(k0 + wk + 1, c); ++p) {
    if (maker_block(src, p, c, w) == k && j-- == 0) i = p;
  }
  const bool maker = i >= 0;
  const int a = maker ? src[2 * i] : 0, bb = maker ? src[2 * i + 1] : 1;
  const int A = a >> 1, sa = a & 1, B = bb >> 1, sb = bb & 1;
  const T* const gAA = in_block(cluster, G0, A / w, k) + 2 * A * L + A % w;
  const T* const gBB = in_block(cluster, G0, B / w, k) + 2 * B * L + B % w;
  const T* const gAB = in_block(cluster, G0, B / w, k) + 2 * A * L + B % w;

  for (int r = 0; r < rounds; ++r) {
    const int n = r & 1, t = r + 1;  // G_r in buffer n; round t's data
    const Rot<E>* Rc = R + n * c;
    const bool make = maker && t < rounds;
    if (tid == 0) {
      mbar_expect(smem_addr(mbar + (t & 1)),
                  (t < rounds ? c * (int)sizeof(Rot<E>) : 0) + edge_bytes);
    }
    Rot<E> next;
    if (make) {
      const Rot<E> rA = Rc[A], rB = Rc[B];
      const int off = n * buf;  // buffer n sits at the same offset in every block
      const float d0 = E::re(entry<E>(gAA + off, L, w, sa, sa, rA, rA));
      const float d1 = E::re(entry<E>(gBB + off, L, w, sb, sb, rB, rB));
      const T wv = entry<E>(gAB + off, L, w, sa, sb, rA, rB);
      next = rotation<E>(d0, d1, wv);
    }
    if (owner) {
      const T* Gc = G0 + n * buf;
      T* Gn = G0 + (1 - n) * buf;
      const unsigned far = (1 - n) * buf * (unsigned)sizeof(T), bar = (t & 1) * 8;
      const Rot<E> rk = Rc[k0 + K];
      for (int j = 0; j < J; ++j) {
        const int I = y + j * Y;
        if (I >= c) break;
        const Rot<E> ri = Rc[I];
        const int p = 2 * I, q = p + 1;
        const int2 dI = *reinterpret_cast<const int2*>(dst + p);
        T x0, x1, y0, y1, xq0, xq1;
        // rows p, q of J_I^H G in the pair's two columns, then times J_K
        E::left(ri.c, ri.z, Gc[p * L + K], Gc[q * L + K], x0, xq0);
        E::left(ri.c, ri.z, Gc[p * L + w + K], Gc[q * L + w + K], x1, xq1);
        for (int h = 0; h < 2; ++h) {
          const int row = h ? dI.y : dI.x;
          E::right(rk.c, rk.z, h ? xq0 : x0, h ? xq1 : x1, y0, y1);
          if (b0 == k) {
            Gn[row * L + l0] = y0;
          } else {
            st_async(far0 + far + row * L * (unsigned)sizeof(T), y0, bar0 + bar);
          }
          if (b1 == k) {
            Gn[row * L + l1] = y1;
          } else {
            st_async(far1 + far + row * L * (unsigned)sizeof(T), y1, bar1 + bar);
          }
        }
      }
    }
    __syncthreads();  // this block's round is done: G_{r+1} here, reads over
    if (make) {
      const unsigned to = smem_addr(R + (t & 1) * c + i), bar = smem_addr(mbar + (t & 1));
      for (int q = 0; q < nb; ++q) st_async(cluster_addr(to, q), next, cluster_addr(bar, q));
      rots[t * c + i] = next;
    }
    mbar_wait(smem_addr(mbar + (t & 1)), ((t - 1) >> 1) & 1);
  }

  // the diagonal at this block's positions (local reads only)
  const T* Gf = G0 + (rounds & 1) * buf;
  for (int l = tid; l < 2 * wk; l += nthr) {
    const bool odd = l >= wk;
    const int pos = 2 * (k0 + (odd ? l - wk : l)) + odd;
    diag[b * m + pos] = E::re(Gf[pos * L + (odd ? l - wk + w : l)]);
  }
  cluster.sync();  // no block leaves while another may reach its memory
}

// ---------------------- the group variant (320 < m <= 512) ----------------------

// The cluster's storage and schedule on a group of nb co-resident blocks
// (launched cooperatively, so every block of the grid runs at once), with
// device memory (L2) in place of distributed shared memory. Block k owns
// the column pairs [k w, k w + wk) as a cluster block does and keeps, twice,
// the columns of the pairs [k w - 1, k w + wk]: its own and one ghost pair
// on each side. A row of this storage is L = 2 (w + 2) elements: the w + 2
// even slots, then the odd ones; pair P at index P - k w + 1. A pair's
// next diagonal block depends only on the columns of the pairs beside it
// (the tournament moves a column by at most one pair), so every maker
// reads its own block's shared memory, and each round's update writes
// every column of the storage (a column whose position comes from another
// block's pair arrives from that block's owners).

// the storage's column of slot s in a block whose first pair is k0
__device__ __forceinline__ int ext_col(int s, int c, int k0, int W2) {
  return s < c ? s - k0 + 1 : s - c - k0 + 1 + W2;
}

// the rows of pair P's columns that a block of pairs [n0, n0 + wk) needs
// from a neighbour: all of an own pair's, and of a ghost pair's only those
// its makers read (the rows of pairs P - 2 to P + 1)
__device__ __forceinline__ int2 rows_needed(int P, int n0, int wk, int m) {
  if (P >= n0 && P < n0 + wk) return make_int2(0, m);
  return make_int2(max(2 * (P - 2), 0), min(2 * (P + 2), m));
}

// the inbox column of pair P's even (odd = 0) or odd slot in block n, of
// first pair n0 and wk pairs: the slots of its first two storage pairs,
// then of its last two (only those come from a neighbour)
__device__ __forceinline__ int inbox_col(int P, int odd, int n0, int wk) {
  const int lp = P - n0 + 1;
  return 2 * (lp <= 1 ? lp : lp - wk + 2) + odd;
}

// a load from device memory that skips this SM's L1, which may hold an
// older copy of a line that another SM wrote
__device__ __forceinline__ Rot<C64> load_l2(const Rot<C64>* p) {
  const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
  Rot<C64> r;
  r.c = v.x;
  r.z = make_float2(v.z, v.w);
  return r;
}
__device__ __forceinline__ Rot<F32> load_l2(const Rot<F32>* p) {
  const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
  Rot<F32> r;
  r.c = v.x;
  r.z = v.y;
  return r;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// one warp: wait until each of the group's nb (<= 32) flags reaches seq;
// a block still missing after a second traps (the launch fails) instead
// of hanging the card
__device__ __forceinline__ void group_wait(const unsigned* flag, int nb, unsigned seq) {
  const int lane = threadIdx.x & 31;
  unsigned long long t0 = 0;
  for (;;) {
    const bool done = lane >= nb || ld_acquire(flag + lane) >= seq;
    if (__all_sync(0xffffffffu, done)) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (t0 == 0) t0 = now;
    if (now - t0 > 1000000000ull) __trap();
  }
}

// G's rounds on groups of nb blocks: group g takes the matrices g, g + G,
// ... (G groups in the grid) one after another. Writes every round's
// rotations to rot_log [B, rounds, c] and the final diagonal to diag [B, m]
// (by position, unsorted) for the vector pass. inbox: per block, two
// parities of 8 columns of m elements; flags: per block a count of the
// rounds it has published (zeroed before the launch).
//
// A round in block k: the makers make the next round's rotations from this
// round's G and rotations (all in this block's shared memory) while the
// owners update G, storing each output column here and, where its pair is
// in a neighbour's storage, also into that neighbour's inbox; the makers
// log their rotations. Then a block barrier, and one thread publishes the
// round (a fence, then its flag = seq, the block's count of rounds). One
// warp waits until every flag of the group reaches seq; after a block
// barrier every thread reads the next rotations from the log and the
// columns its neighbours stored into its inbox, into shared memory (loads
// that skip L1). Nothing is read before it is written: the writes precede
// their block's fence and flag, the reads follow the acquire of that flag.
// Nothing is overwritten while it may still be read: a block writes an
// inbox parity again two rounds later, after every block has published the
// round in between, which it does only after its reads of that parity.
// The log is written once a round and never overwritten.
template <typename E>
__global__ void __launch_bounds__(MAX_THREADS)
jacobi_group_kernel(const typename E::T* __restrict__ h_in, float* __restrict__ diag,
                    Rot<E>* rot_log, typename E::T* inbox, unsigned* flags,
                    const int* __restrict__ dst_in, int batch, int m, int w, int Y,
                    int sweeps) {
  using T = typename E::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = m / 2;
  const int nb = (c + w - 1) / w;
  const int groups = gridDim.x / nb;
  const int g = blockIdx.x / nb, k = blockIdx.x % nb;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int k0 = k * w;           // this block's first column pair
  const int wk = min(w, c - k0);  // and how many it owns
  const int W2 = w + 2, L = 2 * W2;
  const int rounds = sweeps * (m - 1);
  const int buf = m * L;          // elements of one G buffer

  T* G0 = reinterpret_cast<T*>(smem);  // G_r, G_{r+1}: buffers r & 1, 1 - (r & 1)
  Rot<E>* R = reinterpret_cast<Rot<E>*>(G0 + 2 * buf);  // this round's rotations
  int* dst = reinterpret_cast<int*>(R + c);
  int* src = dst + m;
  // received: inbox columns, storage columns, first rows, and where each
  // column's rows start in the list of all received rows; their count
  int* recv = src + m;
  unsigned* flag = flags + g * nb;
  const size_t box = (size_t)8 * m;  // elements of one inbox parity
  const T* mine = inbox + (size_t)(g * nb + k) * 2 * box;

  for (int j = tid; j < m; j += nthr) dst[j] = dst_in[j];
  __syncthreads();
  for (int j = tid; j < m; j += nthr) src[dst[j]] = j;
  __syncthreads();
  if (tid == 0) {  // the storage's columns that a neighbour's owners write
    int n = 0, rows_in = 0;
    for (int lp = 0; lp < wk + 2; ++lp) {
      const int P = k0 - 1 + lp;
      for (int odd = 0; odd < 2 && P >= 0 && P < c; ++odd) {
        const int kw = (src[2 * P + odd] >> 1) / w;
        if (kw == k) continue;
        const int col = inbox_col(P, odd, k0, wk);
        if ((kw != k - 1 && kw != k + 1) || n == 8 || col < 0 || col >= 8) __trap();
        const int2 rows = rows_needed(P, k0, wk, m);
        recv[n] = col;
        recv[8 + n] = lp + odd * W2;
        recv[16 + n] = rows.x;
        recv[24 + n] = rows_in;
        rows_in += rows.y - rows.x;
        ++n;
      }
    }
    for (int j = n; j < 8; ++j) recv[24 + j] = rows_in;
    recv[32] = rows_in;
  }

  // owner (K, y): column pair k0 + K, row pairs y, y + Y, ...; its two
  // destination columns here, and where a neighbour keeps one of them too,
  // that neighbour's inbox column (without the parity) and the rows it needs
  const int K = tid % w, y = tid / w;
  const int J = (c + Y - 1) / Y;
  const bool owner = y < Y && K < wk;
  const int makers = (w * Y + 31) / 32 * 32;
  const int Kp = k0 + min(K, wk - 1);
  int lcol[2];
  int2 sent[2];
  T* out[2];
  for (int e = 0; e < 2; ++e) {
    const int s = slot(dst[2 * Kp + e], c);
    const int P = s < c ? s : s - c;
    const int n = k > 0 && P <= k0 ? k - 1 : k + 1 < nb && P >= k0 + wk - 1 ? k + 1 : -1;
    const int wn = min(w, c - n * w);
    lcol[e] = ext_col(s, c, k0, W2);
    sent[e] = n < 0 ? make_int2(0, 0) : rows_needed(P, n * w, wn, m);
    out[e] = n < 0 ? nullptr
                   : inbox + (size_t)(g * nb + n) * 2 * box +
                         (size_t)inbox_col(P, s >= c, n * w, wn) * m;
  }
  // maker j of this block: pair k0 + j, whose next diagonal block comes
  // from positions a and bb of this round, in pairs A and B beside it
  const int i = k0 + tid - makers;
  const bool maker = tid >= makers && i < k0 + wk;
  const int a = maker ? src[2 * i] : 2 * k0, bb = maker ? src[2 * i + 1] : 2 * k0 + 1;
  const int A = a >> 1, sa = a & 1, B = bb >> 1, sb = bb & 1;
  if (maker && (A < k0 - 1 || A > k0 + wk || B < k0 - 1 || B > k0 + wk)) __trap();
  const int oAA = 2 * A * L + A - k0 + 1, oBB = 2 * B * L + B - k0 + 1;
  const int oAB = 2 * A * L + B - k0 + 1;

  unsigned seq = 0;
  for (int b = g; b < batch; b += groups) {
    const T* H = h_in + (size_t)b * m * m;
    Rot<E>* rots = rot_log + (size_t)b * rounds * c;
    __syncthreads();  // the last matrix's diagonal is read
    for (int e = tid; e < buf; e += nthr) {
      const int row = e / L, l = e % L;
      const int odd = l >= W2, lp = l - odd * W2, P = k0 - 1 + lp;
      if (P >= 0 && P < c && lp <= wk + 1) G0[e] = H[row * m + 2 * P + odd];
    }
    // round 0's rotations, from H: every block makes all of them
    for (int j = tid; j < c; j += nthr) {
      const Rot<E> r0 = rotation<E>(E::re(H[2 * j * m + 2 * j]),
                                    E::re(H[(2 * j + 1) * m + 2 * j + 1]),
                                    H[2 * j * m + 2 * j + 1]);
      R[j] = r0;
      if (k == 0 && rounds > 0) rots[j] = r0;
    }
    __syncthreads();

    for (int r = 0; r < rounds; ++r) {
      const int n = r & 1, t = r + 1;  // G_r in buffer n; round t's data
      const size_t par = (size_t)(++seq & 1) * box;
      const T* Gc = G0 + n * buf;
      T* Gn = G0 + (1 - n) * buf;
      const bool make = maker && t < rounds;
      Rot<E> next;
      if (make) {
        const Rot<E> rA = R[A], rB = R[B];
        const float d0 = E::re(entry<E>(Gc + oAA, L, W2, sa, sa, rA, rA));
        const float d1 = E::re(entry<E>(Gc + oBB, L, W2, sb, sb, rB, rB));
        const T wv = entry<E>(Gc + oAB, L, W2, sa, sb, rA, rB);
        next = rotation<E>(d0, d1, wv);
      }
      if (owner) {
        const Rot<E> rk = R[Kp];
        for (int j = 0; j < J; ++j) {
          const int I = y + j * Y;
          if (I >= c) break;
          const Rot<E> ri = R[I];
          const int p = 2 * I, q = p + 1;
          const int2 dI = *reinterpret_cast<const int2*>(dst + p);
          T x0, x1, y0, y1, xq0, xq1;
          // rows p, q of J_I^H G in the pair's two columns, then times J_K
          E::left(ri.c, ri.z, Gc[p * L + K + 1], Gc[q * L + K + 1], x0, xq0);
          E::left(ri.c, ri.z, Gc[p * L + W2 + K + 1], Gc[q * L + W2 + K + 1], x1, xq1);
          for (int h = 0; h < 2; ++h) {
            const int row = h ? dI.y : dI.x;
            E::right(rk.c, rk.z, h ? xq0 : x0, h ? xq1 : x1, y0, y1);
            Gn[row * L + lcol[0]] = y0;
            Gn[row * L + lcol[1]] = y1;
            if (row >= sent[0].x && row < sent[0].y) out[0][par + row] = y0;
            if (row >= sent[1].x && row < sent[1].y) out[1][par + row] = y1;
          }
        }
      }
      if (make) rots[t * c + i] = next;
      __syncthreads();  // this block's round is written
      if (tid == 0) {
        __threadfence();
        st_relaxed(flag + k, seq);
      }
      if (tid < 32) group_wait(flag, nb, seq);
      __syncthreads();  // every block's round is written
      // this thread's share of the next rotations and of the received rows,
      // every load issued before the first store (one trip to L2)
      Rot<E> rnext;
      const bool take = t < rounds && tid < c;
      if (take) rnext = load_l2(rots + t * c + tid);
      for (int e0 = 0; e0 < recv[32]; e0 += RECV_UNROLL * nthr) {
        T v[RECV_UNROLL];
        int at[RECV_UNROLL];
#pragma unroll
        for (int u = 0; u < RECV_UNROLL; ++u) {
          const int e = e0 + u * nthr + tid;
          at[u] = -1;
          if (e < recv[32]) {
            int j = 0;
            while (j < 7 && recv[25 + j] <= e) ++j;
            const int row = recv[16 + j] + e - recv[24 + j];
            v[u] = __ldcg(mine + par + (size_t)recv[j] * m + row);
            at[u] = row * L + recv[8 + j];
          }
        }
#pragma unroll
        for (int u = 0; u < RECV_UNROLL; ++u) {
          if (at[u] >= 0) Gn[at[u]] = v[u];
        }
      }
      if (take) R[tid] = rnext;
      if (t < rounds) {  // (every launch has c <= threads)
        for (int j = tid + nthr; j < c; j += nthr) R[j] = load_l2(rots + t * c + j);
      }
      __syncthreads();
    }

    // the diagonal at this block's positions
    const T* Gf = G0 + (rounds & 1) * buf;
    for (int l = tid; l < 2 * wk; l += nthr) {
      const int odd = l >= wk, Kl = l - odd * wk;
      const int pos = 2 * (k0 + Kl) + odd;
      diag[(size_t)b * m + pos] = E::re(Gf[pos * L + Kl + 1 + odd * W2]);
    }
  }
}

__device__ __forceinline__ void cp_async8(void* s, const void* g) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sa), "l"(g));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// V's rounds from the rotation log: block (row group, matrix) gives each of
// its V_WARPS warps one row of V (double-buffered, in slots); every round a
// lane applies J_K to its column pairs K = lane, lane + 32, ... (at most
// KMAX of them) and stores them at their next slots. Rows are independent, so a round ends with a
// warp barrier; the block waits together only to stage the next V_CHUNK
// rounds of rotations (cp.async, double-buffered). Then the eigenvalues are
// ranked (each block ranks all m) and the rows written in their order.
template <typename E, int KMAX>
__global__ void __launch_bounds__(32 * V_WARPS)
jacobi_vectors_kernel(const float* __restrict__ diag, const Rot<E>* __restrict__ rot_log,
                      float* __restrict__ lam_out, typename E::T* __restrict__ v_out,
                      const int* __restrict__ dst_in, int m, int rounds) {
  using T = typename E::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = m / 2;
  const int groups = (m + V_WARPS - 1) / V_WARPS;
  const size_t b = blockIdx.x / groups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = (blockIdx.x % groups) * V_WARPS + warp;
  Rot<E>* stage = reinterpret_cast<Rot<E>*>(smem);  // [2][V_CHUNK][c]
  T* Vall = reinterpret_cast<T*>(stage + 2 * V_CHUNK * c);
  T* Vb = Vall + warp * 2 * m;  // this warp's row, twice
  int* dst = reinterpret_cast<int*>(Vall + V_WARPS * 2 * m);
  int* perm = dst + m;
  float* lam = reinterpret_cast<float*>(perm + m);

  const Rot<E>* rots = rot_log + b * rounds * c;
  const int chunks = (rounds + V_CHUNK - 1) / V_CHUNK;
  auto stage_chunk = [&](int t) {
    const int r0 = t * V_CHUNK, nr = min(V_CHUNK, rounds - r0);
    const char* g = reinterpret_cast<const char*>(rots + r0 * c);
    char* s = reinterpret_cast<char*>(stage + (t & 1) * V_CHUNK * c);
    const int units = nr * c * (int)sizeof(Rot<E>) / 8;
    for (int u = tid; u < units; u += blockDim.x) cp_async8(s + 8 * u, g + 8 * u);
    cp_async_commit();
  };
  if (chunks > 0) stage_chunk(0);
  for (int j = tid; j < m; j += blockDim.x) {
    dst[j] = dst_in[j];
    lam[j] = diag[b * m + j];
  }
  if (row < m) {
    for (int col = lane; col < m; col += 32) Vb[slot(col, c)] = E::eye(row == col);
  }
  __syncthreads();
  for (int j = tid; j < m; j += blockDim.x) {
    const float lj = lam[j];
    int rank = 0;
    for (int k = 0; k < m; ++k) rank += before(lam[k], k, lj, j);
    perm[rank] = j;
    if (blockIdx.x % groups == 0) lam_out[b * m + rank] = lj;
  }
  int s0[KMAX], s1[KMAX];
#pragma unroll
  for (int u = 0; u < KMAX; ++u) {
    const int K = min(lane + 32 * u, c - 1);
    s0[u] = slot(dst[2 * K], c);
    s1[u] = slot(dst[2 * K + 1], c);
  }

  for (int t = 0; t < chunks; ++t) {
    cp_async_wait_all();
    __syncthreads();  // chunk t landed; every warp is done with chunk t - 1
    if (t + 1 < chunks) stage_chunk(t + 1);
    if (row >= m) continue;
    const Rot<E>* Rs = stage + (t & 1) * V_CHUNK * c;
    const int r0 = t * V_CHUNK, nr = min(V_CHUNK, rounds - r0);
    for (int rr = 0; rr < nr; ++rr) {
      const int r = r0 + rr;
      const T* Vc = Vb + (r & 1) * m;
      T* Vn = Vb + ((r + 1) & 1) * m;
      const Rot<E>* Rr = Rs + rr * c;
#pragma unroll
      for (int u = 0; u < KMAX; ++u) {
        const int K = lane + 32 * u;
        if (K < c) {
          const Rot<E> rk = Rr[K];
          T y0, y1;
          E::right(rk.c, rk.z, Vc[K], Vc[c + K], y0, y1);
          Vn[s0[u]] = y0;
          Vn[s1[u]] = y1;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();  // perm
  if (row < m) {
    const T* Vf = Vb + (rounds & 1) * m;
    T* out = v_out + (b * m + row) * m;
    for (int col = lane; col < m; col += 32) out[col] = Vf[slot(perm[col], c)];
  }
}

// ------------------------------- host side ------------------------------------

// launch geometry: the fewest row pairs a thread (J) such that w columns
// pairs of Y = ceil(c / J) threads, rounded up to whole warps, and the w
// rotation makers, in whole warps, fit in one block (w = c: one block a
// matrix)
void row_pairs(int c, int w, int* Y, int* threads) {
  const int makers = (w + 31) / 32 * 32;
  for (int J = (c * w + MAX_THREADS - 1) / MAX_THREADS;; ++J) {
    *Y = (c + J - 1) / J;
    *threads = (w * *Y + 31) / 32 * 32 + makers;
    if (*threads <= MAX_THREADS) return;
  }
}

// dynamic shared memory of the one-block variant (m <= SMEM_MAX_M): G and V
// (double-buffered), the rotations of two rounds, and dst, src and the
// final order (m ints each)
template <typename E>
constexpr size_t smem_bytes(int m) {
  return 4 * (size_t)m * m * sizeof(typename E::T) + (size_t)m * sizeof(Rot<E>) +
         3 * (size_t)m * sizeof(int);
}

// a cluster block's: its G (m rows of 2w, double-buffered), the rotations of
// two rounds, dst and src, and two mbarriers
template <typename E>
constexpr size_t cluster_smem(int m, int w) {
  return 4 * (size_t)m * w * sizeof(typename E::T) + (size_t)m * sizeof(Rot<E>) +
         2 * (size_t)m * sizeof(int) + 16;
}

// a group block's: its storage (m rows of 2 (w + 2), double-buffered), one
// round's rotations, dst and src, and the received columns (33 ints)
template <typename E>
constexpr size_t group_smem(int m, int w) {
  return 4 * (size_t)m * (w + 2) * sizeof(typename E::T) + (size_t)(m / 2) * sizeof(Rot<E>) +
         (2 * (size_t)m + 33) * sizeof(int);
}

// the vector pass's column pairs a lane, for m up to `most`
constexpr int lane_pairs(int most) { return (most / 2 + 31) / 32; }

// the vector pass's: two stages of rotations, V_WARPS rows twice, dst, the
// order and the diagonal
template <typename E>
constexpr size_t vector_smem(int m) {
  return 2 * (size_t)V_CHUNK * (m / 2) * sizeof(Rot<E>) +
         2 * (size_t)V_WARPS * m * sizeof(typename E::T) + 3 * (size_t)m * 4;
}

// nb blocks of w column pairs: about `pairs` a block, at most `most`
// blocks, and no empty block (the cluster variant: PAIRS_PER_BLOCK and
// MAX_CLUSTER; the group variant: GROUP_PAIRS and MAX_GROUP)
void split_shape(int m, int pairs, int most, int* nb, int* w) {
  const int c = m / 2;
  const int n = min((c + pairs - 1) / pairs, most);
  *w = (c + n - 1) / n;
  *nb = (c + *w - 1) / *w;
}

// split_shape's w is at most the larger of `pairs` and ceil(c / most); the
// shared memory grows with m and w, and a block's one warp of makers takes
// up to w + 2 pairs (maker_block) in a cluster, w in a group
constexpr int MAX_W = PAIRS_PER_BLOCK > (CLUSTER_MAX_M / 2 + MAX_CLUSTER - 1) / MAX_CLUSTER
                          ? PAIRS_PER_BLOCK
                          : (CLUSTER_MAX_M / 2 + MAX_CLUSTER - 1) / MAX_CLUSTER;
static_assert(cluster_smem<C64>(CLUSTER_MAX_M, MAX_W) <= SMEM_OPT_IN,
              "every cluster block's G fits in its shared memory");
static_assert(MAX_W + 2 <= 32, "a cluster block's makers fit in one warp");
static_assert(MAX_M / 2 <= GROUP_PAIRS * MAX_GROUP && MAX_GROUP <= 32,
              "a group block takes at most GROUP_PAIRS pairs, and one warp "
              "reads the group's flags");
static_assert(group_smem<C64>(MAX_M, GROUP_PAIRS) <= SMEM_OPT_IN,
              "every group block's storage fits in its shared memory");
static_assert(vector_smem<C64>(MAX_M) <= SMEM_OPT_IN,
              "the vector pass's rows and stages fit in its shared memory");

// device scratch of the cluster and group variants, in bytes from its
// start: the rotation log [B, rounds, c], the diagonal [B, m] and, for the
// group variant, the inboxes [B, nb, 2, 8, m] of h's type and the flags
// [B, nb] (sized for B groups; a launch uses at most B)
struct Scratch {
  size_t diag, inbox, flags, total;
};

constexpr size_t align256(size_t n) { return (n + 255) / 256 * 256; }

template <typename E>
Scratch scratch(int batch, int m, int sweeps) {
  Scratch s = {};
  const size_t B = batch;
  s.diag = align256(B * sweeps * (m - 1) * (m / 2) * sizeof(Rot<E>));
  s.inbox = align256(s.diag + B * m * sizeof(float));
  s.flags = s.total = s.inbox;
  if (m > CLUSTER_MAX_M) {
    int nb = 0, w = 0;
    split_shape(m, GROUP_PAIRS, MAX_GROUP, &nb, &w);
    s.flags = align256(s.inbox + B * nb * 16 * m * sizeof(typename E::T));
    s.total = s.flags + B * nb * sizeof(unsigned);
  }
  return s;
}

template <typename E>
size_t work_bytes(int batch, int m, int sweeps) {
  return m <= SMEM_MAX_M ? 0 : scratch<E>(batch, m, sweeps).total;
}

template <typename E>
int launch(const void* h, void* lam, void* v, void* work, const int* dst, int batch,
           int m, int sweeps, int dev, cudaStream_t stream) {
  using T = typename E::T;
  // opt in, once per device, to the most dynamic shared memory any m needs
  static bool opted_in[MAX_DEVICES] = {};
  if (!opted_in[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        jacobi_eigh_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<E>(SMEM_MAX_M));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(jacobi_cluster_kernel<E>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_OPT_IN);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(jacobi_group_kernel<E>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_OPT_IN);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(jacobi_vectors_kernel<E, lane_pairs(CLUSTER_MAX_M)>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)vector_smem<E>(CLUSTER_MAX_M));
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(jacobi_vectors_kernel<E, lane_pairs(MAX_M)>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)vector_smem<E>(MAX_M));
    }
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const T* H = static_cast<const T*>(h);
  const int c = m / 2;
  int rows = 0, threads = 0;
  if (m <= SMEM_MAX_M) {
    row_pairs(c, c, &rows, &threads);
    jacobi_eigh_kernel<E><<<batch, threads, smem_bytes<E>(m), stream>>>(
        H, static_cast<float*>(lam), static_cast<T*>(v), dst, m, rows, sweeps);
    return (int)cudaGetLastError();
  }
  const int rounds = sweeps * (m - 1);
  const Scratch s = scratch<E>(batch, m, sweeps);
  char* base = static_cast<char*>(work);
  Rot<E>* rot_log = reinterpret_cast<Rot<E>*>(base);
  float* diag = reinterpret_cast<float*>(base + s.diag);
  int nb = 0, w = 0;
  cudaError_t err;
  if (m <= CLUSTER_MAX_M) {
    split_shape(m, PAIRS_PER_BLOCK, MAX_CLUSTER, &nb, &w);
    row_pairs(c, w, &rows, &threads);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nb * batch);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = cluster_smem<E>(m, w);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nb;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, jacobi_cluster_kernel<E>, H, diag, rot_log, dst, m, w,
                             rows, sweeps);
  } else {
    // every block of a group must run at once: as many groups as the card
    // holds resident (a cooperative launch refuses a grid that does not fit,
    // where an ordinary one could hang), each taking its matrices in turn
    split_shape(m, GROUP_PAIRS, MAX_GROUP, &nb, &w);
    row_pairs(c, w, &rows, &threads);
    const size_t smem = group_smem<E>(m, w);
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jacobi_group_kernel<E>,
                                                        threads, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int ngroups = min(batch, per_sm * sms / nb);
    if (ngroups < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    // each block's flag counts its rounds over its group's matrices
    if ((unsigned long long)((batch + ngroups - 1) / ngroups) * rounds >= 0xffffffffull) {
      return (int)cudaErrorInvalidValue;
    }
    T* inbox = reinterpret_cast<T*>(base + s.inbox);
    unsigned* flags = reinterpret_cast<unsigned*>(base + s.flags);
    err = cudaMemsetAsync(flags, 0, (size_t)ngroups * nb * sizeof(unsigned), stream);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {(void*)&H,     (void*)&diag, (void*)&rot_log, (void*)&inbox,
                    (void*)&flags, (void*)&dst,  (void*)&batch,   (void*)&m,
                    (void*)&w,     (void*)&rows, (void*)&sweeps};
    err = cudaLaunchCooperativeKernel((const void*)jacobi_group_kernel<E>, dim3(ngroups * nb),
                                      dim3(threads), args, smem, stream);
  }
  if (err != cudaSuccess) return (int)err;
  // the cluster variant's m keep the vector pass's registers of 5 pairs a
  // lane (8 would cost its rounds 2-3 %)
  const auto vectors = m <= CLUSTER_MAX_M ? jacobi_vectors_kernel<E, lane_pairs(CLUSTER_MAX_M)>
                                          : jacobi_vectors_kernel<E, lane_pairs(MAX_M)>;
  const int groups = (m + V_WARPS - 1) / V_WARPS;
  vectors<<<groups * batch, 32 * V_WARPS, vector_smem<E>(m), stream>>>(
      diag, rot_log, static_cast<float*>(lam), static_cast<T*>(v), dst, m, rounds);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of device scratch (`work`) that qlt_jacobi_eigh needs for these
// arguments: 0 for m <= 84; above, the rotation log and the diagonal, B
// (sweeps (m - 1) (m / 2) rotations + m floats); above 320 also the group
// variant's inboxes and flags, B nb (16 m elements of h's type + 1 int).
extern "C" size_t qlt_jacobi_eigh_work_bytes(int is_complex, int batch, int m,
                                             int sweeps) {
  if (batch <= 0 || m < 2 || m > MAX_M || m % 2 != 0 || sweeps < 0) return 0;
  return is_complex ? work_bytes<C64>(batch, m, sweeps) : work_bytes<F32>(batch, m, sweeps);
}

// h [B, m, m] Hermitian, complex64 (is_complex = 1) or float32; lam [B, m]
// float32; v [B, m, m] of h's type; dst [m] int32, the position moves of one
// round; work: qlt_jacobi_eigh_work_bytes bytes of device memory, 16-byte
// aligned (null where that is 0). All on device `device`; launches on
// `stream` (one kernel for m <= 84; above, the cluster or group kernel,
// after zeroing the group's flags, and the vector pass) and returns the
// CUDA error of the launch (0 on success): a group launch the card cannot
// hold resident is refused (cudaErrorCooperativeLaunchTooLarge).
extern "C" int qlt_jacobi_eigh(const void* h, void* lam, void* v, void* work,
                               const void* dst, int is_complex, int batch, int m,
                               int sweeps, int device, void* stream) {
  if (batch <= 0 || m < 2 || m > MAX_M || m % 2 != 0 || sweeps < 0 ||
      dst == nullptr || device < 0 || device >= MAX_DEVICES) {
    return (int)cudaErrorInvalidValue;
  }
  if (m > SMEM_MAX_M && work == nullptr) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const int* d = static_cast<const int*>(dst);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int out = is_complex
                      ? launch<C64>(h, lam, v, work, d, batch, m, sweeps, device, s)
                      : launch<F32>(h, lam, v, work, d, batch, m, sweeps, device, s);
  if (prev != device) cudaSetDevice(prev);
  return out;
}
