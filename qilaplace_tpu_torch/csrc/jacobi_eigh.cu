// Batched Hermitian eigensolver by parallel-order cyclic Jacobi (kernel K2).
//
// Replaces the Pallas TPU kernel qilaplace_tpu/ops/jacobi.py::_jacobi_kernel
// (called by jacobi_eigh_pallas). For each of B Hermitian matrices H [m, m]
// (complex64 as interleaved float2; a real input arrives with zero imaginary
// part and leaves with a real V), m even, 2 <= m <= 512: sweeps * (m - 1)
// Brent-Luk rounds, each applying m/2 independent 2x2 rotations
//   J_i = [[c, -z], [conj(z), c]],  z = s u,  u = w / |w|,  w = G[p_i, q_i],
// with (c, s) from tau = (G[p,p] - G[q,q]) / (2 |w|) as in the plain version
// (ops/jacobi.py), as G <- J^H G J and V <- V J. Output: the eigenvalues
// ascending and V with its columns in the same order.
//
// What bounds it on an H100: one round is O(m^2) work (about 40 m^2 fp32
// flops), but the rounds are a dependent chain: sweeps * (m - 1) of them, two
// block barriers each, on the one SM that holds the matrix. At m = 80 with 6
// sweeps that is 474 rounds and ~1.5e8 flops, ~2 us at the card's 67 TFLOP/s
// fp32, while the chain of barriers and shared-memory round trips takes some
// hundred times that. So latency on one of 132 SMs bounds it at B = 1; a batch
// fills more SMs (one block per matrix). Batching sibling solves and graph
// capture are later work.
//
// Design, kept simple and exact first:
//  * no TPU carry-over: the TPU kernel built each round's rotation as a dense
//    m x m matrix, folded the tournament permutation into it and spent ~14
//    MXU matmuls (O(m^3)) per round. Here the m/2 rotations are applied
//    directly: thread t owns one 2x2 block (I, K) of G and applies J_I^H on
//    the left and J_K on the right; V's column pairs are updated likewise. No
//    two threads touch the same entry, so each phase needs no atomics;
//  * each pair's (c, z) is computed once, by one thread, from G's diagonal and
//    the coupling G[p, q], so the partner disagreement the TPU kernel
//    symmetrizes away cannot arise. The TPU kernel's tau == 0 parity
//    tie-break gave the pair the even member's sign, +1; that is the plain
//    version's tau >= 0 rule used here;
//  * the tournament permutation is an index map, not data movement: G and V
//    stay in original index order, and round r pairs the elements
//    (L_r[i], L_r[m-1-i]) of the round-robin list L_r[0] = 0,
//    L_r[j] = pi_inv(1 + ((j - 1 - r) mod (m - 1))), which is exactly the
//    plain version's position arrangement. A final rank sort orders (lam, v);
//  * c = 1 / sqrtf(1 + t^2) and sqrtf / division as the compiler gives them
//    without fast math (IEEE), so no Newton steps are needed;
//  * G and V (16 m^2 bytes) plus the round's parameters live in dynamic
//    shared memory up to m = 120 (230,400 + 1,200 bytes of the 232,448 a block
//    may opt in to); above that the same code runs on G and V in device memory
//    (4 MiB at m = 512, L2-resident), with only the parameters in shared.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_M = 512;
constexpr int SMEM_MAX_M = 120;  // largest m whose G and V fit in shared
constexpr int MAX_THREADS = 512;
constexpr int MAX_DEVICES = 64;

// dynamic shared memory of one block: G and V while m <= SMEM_MAX_M, plus
// the round's parameters (z, c and the pair's two members per pair)
constexpr size_t smem_bytes(int m) {
  return (m <= SMEM_MAX_M ? 2 * (size_t)m * m * sizeof(float2) : 0) +
         (size_t)(m / 2) * (sizeof(float2) + sizeof(float) + 2 * sizeof(int));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cscale(float s, float2 a) {
  return make_float2(s * a.x, s * a.y);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 conjf2(float2 a) {
  return make_float2(a.x, -a.y);
}

// element held at round-robin list slot j in round r (0 <= r < m - 1)
__device__ __forceinline__ int slot_element(int j, int r, int m) {
  const int c = m / 2;
  int k = 0;
  if (j > 0) k = 1 + (((j - 1 - r) % (m - 1)) + (m - 1)) % (m - 1);
  return k < c ? 2 * k : 2 * (m - 1 - k) + 1;
}

// strict total order for the final sort: ascending, NaN last, ties by index
__device__ __forceinline__ bool before(float x, int i, float y, int j) {
  const bool nx = x != x, ny = y != y;
  if (nx || ny) return (nx && ny) ? i < j : ny;
  return x < y || (x == y && i < j);
}

__global__ void __launch_bounds__(MAX_THREADS)
jacobi_eigh_kernel(const float2* __restrict__ h_in, float* __restrict__ lam_out,
                   float2* __restrict__ v_out, float2* g_work, float2* v_work,
                   int m, int sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = m / 2;
  const size_t mm = (size_t)m * m;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  float2* G;
  float2* V;
  unsigned char* tail;
  if (m <= SMEM_MAX_M) {
    G = reinterpret_cast<float2*>(smem);
    V = G + mm;
    tail = reinterpret_cast<unsigned char*>(V + mm);
  } else {
    G = g_work + b * mm;
    V = v_work + b * mm;
    tail = smem;
  }
  float2* rz = reinterpret_cast<float2*>(tail);  // [c] z = s u
  float* rc = reinterpret_cast<float*>(rz + c);  // [c] c
  int* rp = reinterpret_cast<int*>(rc + c);      // [c] even member
  int* rq = rp + c;                              // [c] odd member

  const float2* H = h_in + b * mm;
  for (size_t idx = tid; idx < mm; idx += nthr) {
    G[idx] = H[idx];
    V[idx] = make_float2(idx / m == idx % m ? 1.f : 0.f, 0.f);
  }
  __syncthreads();

  const int rounds = sweeps * (m - 1);
  const int nblk = c * c;
  const int work = nblk + m * c;
  for (int r = 0; r < rounds; ++r) {
    const int rr = r % (m - 1);
    // phase 1: one rotation per pair, from the diagonal and the coupling
    for (int i = tid; i < c; i += nthr) {
      const int p = slot_element(i, rr, m);
      const int q = slot_element(m - 1 - i, rr, m);
      const float a = G[(size_t)p * m + p].x;
      const float d = G[(size_t)q * m + q].x;
      const float2 w = G[(size_t)p * m + q];
      const float absw = hypotf(w.x, w.y);
      float cs = 1.f;
      float2 z = make_float2(0.f, 0.f);
      if (absw > 0.f) {
        const float tau = (a - d) / (2.f * absw);
        const float sgn = tau >= 0.f ? 1.f : -1.f;
        const float t = sgn / (fabsf(tau) + sqrtf(1.f + tau * tau));
        cs = 1.f / sqrtf(1.f + t * t);
        const float s = t * cs;
        z = make_float2(s * (w.x / absw), s * (w.y / absw));
      }
      rp[i] = p;
      rq[i] = q;
      rc[i] = cs;
      rz[i] = z;
    }
    __syncthreads();
    // phase 2: G <- J^H G J by 2x2 blocks (I, K); V <- V J by (row, pair)
    for (int idx = tid; idx < work; idx += nthr) {
      if (idx < nblk) {
        const int I = idx / c, K = idx % c;
        const int pI = rp[I], qI = rq[I], pK = rp[K], qK = rq[K];
        const float cI = rc[I], cK = rc[K];
        const float2 zI = rz[I], zK = rz[K];
        float2* Gp = G + (size_t)pI * m;
        float2* Gq = G + (size_t)qI * m;
        const float2 gpp = Gp[pK], gpq = Gp[qK], gqp = Gq[pK], gqq = Gq[qK];
        // left: X = J_I^H G (rows p, q)
        const float2 nczI = make_float2(-zI.x, zI.y);  // -conj(z_I)
        const float2 xpp = cadd(cscale(cI, gpp), cmul(zI, gqp));
        const float2 xpq = cadd(cscale(cI, gpq), cmul(zI, gqq));
        const float2 xqp = cadd(cscale(cI, gqp), cmul(nczI, gpp));
        const float2 xqq = cadd(cscale(cI, gqq), cmul(nczI, gpq));
        // right: Y = X J_K (columns p, q)
        const float2 czK = conjf2(zK);
        const float2 nzK = make_float2(-zK.x, -zK.y);
        Gp[pK] = cadd(cscale(cK, xpp), cmul(xpq, czK));
        Gp[qK] = cadd(cmul(xpp, nzK), cscale(cK, xpq));
        Gq[pK] = cadd(cscale(cK, xqp), cmul(xqq, czK));
        Gq[qK] = cadd(cmul(xqp, nzK), cscale(cK, xqq));
      } else {
        const int t = idx - nblk;
        const int row = t / c, K = t % c;
        const int pK = rp[K], qK = rq[K];
        const float cK = rc[K];
        const float2 zK = rz[K];
        float2* Vr = V + (size_t)row * m;
        const float2 vp = Vr[pK], vq = Vr[qK];
        Vr[pK] = cadd(cscale(cK, vp), cmul(vq, conjf2(zK)));
        Vr[qK] = cadd(cmul(vp, make_float2(-zK.x, -zK.y)), cscale(cK, vq));
      }
    }
    __syncthreads();
  }

  // eigenvalues ascending: rank each diagonal entry, then gather V's columns
  int* perm = rp;  // rp and rq together hold m ints
  for (int j = tid; j < m; j += nthr) {
    const float lj = G[(size_t)j * m + j].x;
    int rank = 0;
    for (int k = 0; k < m; ++k) rank += before(G[(size_t)k * m + k].x, k, lj, j);
    perm[rank] = j;
    lam_out[b * m + rank] = lj;
  }
  __syncthreads();
  float2* Vo = v_out + b * mm;
  for (size_t idx = tid; idx < mm; idx += nthr) {
    Vo[idx] = V[(idx / m) * m + perm[idx % m]];
  }
}

}  // namespace

// h [B, m, m] complex64 Hermitian, lam [B, m] float32, v [B, m, m] complex64;
// for m > 120, g_work and v_work are [B, m, m] complex64 scratch (else unused,
// may be null). All on the device; launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int qlt_jacobi_eigh(const void* h, void* lam, void* v, void* g_work,
                               void* v_work, int batch, int m, int sweeps,
                               void* stream) {
  if (batch <= 0 || m < 2 || m > MAX_M || m % 2 != 0 || sweeps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const bool in_smem = m <= SMEM_MAX_M;
  if (!in_smem && (g_work == nullptr || v_work == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // opt in, once per device, to the most dynamic shared memory any m needs
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool opted_in[MAX_DEVICES] = {};
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(jacobi_eigh_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(SMEM_MAX_M));
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const int c = m / 2;
  const size_t smem = smem_bytes(m);
  const int work = c * c + m * c;
  int threads = ((work + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  jacobi_eigh_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(h), static_cast<float*>(lam),
      static_cast<float2*>(v), static_cast<float2*>(g_work),
      static_cast<float2*>(v_work), m, sweeps);
  return (int)cudaGetLastError();
}
