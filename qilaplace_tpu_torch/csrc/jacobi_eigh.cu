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
// 9 m^2 real), but the rounds form a dependent chain on the one SM that holds
// the matrix: 115 / 234 / 474 rounds at the QFT path's m = 24 / 40 / 80, at
// B = 1. A round's latency bounds the kernel, hundreds of times above its
// flop bound: the chain of sqrt and division that makes a rotation, the
// shared-memory traffic of the O(m^2) update (at m = 80 about 200 KB a round
// through the SM's 128 bytes a cycle) and the barrier. A batch fills more SMs
// (one block per matrix).
//
// Design against that latency:
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
//  * one barrier a round: G and V are double-buffered, and the round also
//    makes the NEXT round's rotations: warps of their own, one thread a
//    pair, rebuild the pair's next diagonal block from G_r and this round's
//    rotations (three entries of J^H G_r J, by the same arithmetic as the
//    update) and run the rotation's chain of sqrt and division while the
//    other warps update G and V. The one __syncthreads at the end of the
//    round publishes G_{r+1}, V_{r+1} and the rotations together (a
//    double-buffered table);
//  * no division in the round: thread (K, y) (tid = y c + K) owns column pair
//    K and row pairs y, y + Y, ...; its destinations are computed once. Up to
//    1,024 threads: m = 80 is 40 x 20 threads, two row pairs each, and two
//    warps of rotation makers;
//  * a real variant (the template's element type): float32 input stays real,
//    9 m^2 flops a round and half the shared memory;
//  * the same numbers as the plain version: the rotation with IEEE sqrtf and
//    division (no fast math), each product and sum rounded as
//    _pair_rotations rounds it, and each entry of J^H G J and V J summed as
//    the plain version's matrix products sum it (k ascending: the first
//    nonzero term rounded, the second fused onto it). On the card the kernel
//    then reproduces its plain version bit for bit;
//  * the double-buffered G and V (32 m^2 bytes complex) live in dynamic
//    shared memory up to m = SMEM_MAX_M = 84 (225,792 of the 232,448 bytes a
//    block may opt in to, plus 2,352 bytes of tables); above, the same code
//    runs on buffers in device memory (scratch from the wrapper; 8 MiB at
//    m = 512, L2-resident).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_M = 512;
constexpr int SMEM_MAX_M = 84;  // largest m whose G and V buffers fit in shared
constexpr int MAX_THREADS = 1024;
constexpr int MAX_DEVICES = 64;

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

// entry (s, t) of J_P^H G[pair P, pair Q] J_Q: what the update writes for it
template <typename E>
__device__ __forceinline__ typename E::T entry(const typename E::T* G, int P, int Q, int s,
                                               int t, const Rot<E>& rP, const Rot<E>& rQ,
                                               int m, int c) {
  using T = typename E::T;
  const T* g = G + 2 * P * m + Q;
  T x00, x10, x01, x11, y0, y1;
  E::left(rP.c, rP.z, g[0], g[m], x00, x10);
  E::left(rP.c, rP.z, g[c], g[m + c], x01, x11);
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

template <typename E, bool IN_SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
jacobi_eigh_kernel(const typename E::T* __restrict__ h_in, float* __restrict__ lam_out,
                   typename E::T* __restrict__ v_out, typename E::T* work,
                   const int* __restrict__ dst_in, int m, int Y, int sweeps) {
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

  T* G0 = IN_SMEM ? reinterpret_cast<T*>(smem) : work + b * 4 * mm;
  Rot<E>* R = reinterpret_cast<Rot<E>*>(IN_SMEM ? smem + 4 * mm * sizeof(T) : smem);
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
      const float d0 = E::re(entry<E>(Gc, A, A, sa, sa, rA, rA, m, c));
      const float d1 = E::re(entry<E>(Gc, B, B, sb, sb, rB, rB, m, c));
      const T w = entry<E>(Gc, A, B, sa, sb, rA, rB, m, c);
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

// launch geometry: the fewest row pairs a thread (J) such that c columns of
// Y = ceil(c / J) threads, rounded up to whole warps, and the c rotation
// makers, in whole warps, fit in one block
void row_pairs(int c, int* Y, int* threads) {
  const int makers = (c + 31) / 32 * 32;
  for (int J = (c * c + MAX_THREADS - 1) / MAX_THREADS;; ++J) {
    *Y = (c + J - 1) / J;
    *threads = (c * *Y + 31) / 32 * 32 + makers;
    if (*threads <= MAX_THREADS) return;
  }
}

// dynamic shared memory: G and V (double-buffered) while m <= SMEM_MAX_M,
// the rotations of two rounds, and dst, src and the final order (m ints each)
template <typename E>
constexpr size_t smem_bytes(int m) {
  return (m <= SMEM_MAX_M ? 4 * (size_t)m * m * sizeof(typename E::T) : 0) +
         (size_t)m * sizeof(Rot<E>) + 3 * (size_t)m * sizeof(int);
}

template <typename E>
int launch(const void* h, void* lam, void* v, void* work, const int* dst, int batch,
           int m, int sweeps, int dev, cudaStream_t stream) {
  // opt in, once per device, to the most dynamic shared memory any m needs
  static bool opted_in[MAX_DEVICES] = {};
  if (!opted_in[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi_eigh_kernel<E, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<E>(SMEM_MAX_M));
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  using T = typename E::T;
  const int c = m / 2;
  int rows = 0, threads = 0;
  row_pairs(c, &rows, &threads);
  const auto kernel = m <= SMEM_MAX_M ? jacobi_eigh_kernel<E, true>
                                     : jacobi_eigh_kernel<E, false>;
  kernel<<<batch, threads, smem_bytes<E>(m), stream>>>(
      static_cast<const T*>(h), static_cast<float*>(lam), static_cast<T*>(v),
      static_cast<T*>(work), dst, m, rows, sweeps);
  return (int)cudaGetLastError();
}

}  // namespace

// h [B, m, m] Hermitian, complex64 (is_complex = 1) or float32; lam [B, m]
// float32; v [B, m, m] of h's type; dst [m] int32, the position moves of one
// round; for m > 84, work is [B, 4, m, m] of h's type (else unused, may be
// null). All on device `device`; launches on `stream` and returns
// cudaGetLastError() (0 on success).
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
