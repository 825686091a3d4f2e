// Batched coefficient readout of a matrix-product chain (kernel K1).
//
// Replaces the Pallas TPU kernel qilaplace_tpu/ops/pallas_kernels.py::_kernel
// (called by coefficient_batch_pallas). For each of B bit configurations:
//   v = e_0;  for site s: v <- v . A[s, :, bit_s, :];  out = amp * v[0]
// with A the chain's complex64 cores (interleaved float2) and the
// configurations [B, n] int32.
//
// Input. The wrapper (ops/readout_kernels.py) first permutes the lanes of
// every bond so that its live lanes come first, in their order (lane k of an
// inner bond s is live iff column k of site s-1 and row k of site s hold a
// nonzero; at bonds 0 and n only lane 0): an exact gauge permutation. The
// kernel takes that chain as [n, cp, 2, cp] (cp a multiple of 64) with the
// live widths w[0..n], and multiplies only rows k < w_s by columns
// j < round_up(w_{s+1}, 64) at site s. Every dropped term is an exact zero,
// so the result does not depend on how much dead padding the chain had.
//
// What bounds it on an H100: the live work, 8 B sum_s w_s w_{s+1} fp32
// flops (24 % of the padded 8 B n chi^2 on the n=30 zT chain: 0.45 ms at
// 67 TFLOP/s), issued as FMAs fed from shared memory. Each FMA needs its
// operands from shared memory (v broadcast to the warp, A spread over the
// lanes), so the load/store pipe, not only the FMA pipe, sets the pace; and
// at 32 rows a block (B = 4096 fills 128 SMs once) each SM holds eight
// warps to hide that latency. L2 traffic (each block streams the live
// cores, about 17 MB on that chain) is not the limit: sharing the chunks
// between the blocks of a cluster by multicast made the kernel slower (the
// blocks then wait for each other at every chunk), so every block streams
// its own.
//
// Design:
//  * one launch walks all n sites; a block owns TB = 32 configurations whose
//    running vectors (v transposed: vT[k][slot]) stay in shared memory;
//  * rows grouped by bit: at every site a warp ballot places the bit-0 rows
//    in slots [0, g0) and the bit-1 rows in [g0, g0 + g1), so of the four
//    8-slot register tiles at most one holds both bits. H = 2 consumer
//    warps share a tile, each with half of every 64-column chunk:
//    per k a warp loads its R rows of v (broadcast 16-byte loads) and one
//    complex column a chunk of its branch (8 bytes a lane), and issues
//    4 R FMAs a chunk with no select. The mixed tile is compiled for its
//    split point (rows < m take branch 0): it loads both branches' columns
//    and still issues only the FMAs of each row's own branch. Eight warps,
//    two on each scheduler, the k loop unrolled 4 times;
//  * write-back by map: each row's new vector goes straight to the slot it
//    takes at the next site (grouped by the next bit), so there is no
//    regrouping pass; the last site writes amp * v[0] to the row's output;
//  * cores staged asynchronously: a producer warp streams k-chunks of the
//    site's live cores (rows k < w_s, both branches, round_up(w_{s+1}, 64)
//    columns; up to 64 KB a chunk) into two stages of shared memory, one
//    2-D TMA tile a chunk (a tensor map for each padded width) completing
//    on an mbarrier, across site boundaries, while the consumers multiply
//    the other stage. Chunks this large halve the per-chunk hand-offs of
//    four 32 KB stages, which cost more than the deeper ring saved;
//  * fp32 FMA with fp32 accumulation, k ascending; no tensor cores.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_CHI = 256;     // widest bond the launch takes
constexpr int TB = 32;           // configurations per block (one ballot word)
constexpr int R = 8;             // rows (slots) of a register tile
constexpr int H = 2;             // consumer warps that share a tile (1 or 2)
constexpr int CPL = 2 / H;       // complex columns a lane, a 64-column chunk
constexpr int TILES = TB / R * H;  // consumer warps
constexpr int SLOT_STRIDE = TB + 2;  // vT row: 16-byte aligned, fewer bank conflicts
constexpr int LANE_TILE = 64;    // columns of a chunk (2 / H complex a lane)
constexpr int STAGES = 2;
constexpr int STAGE_BYTES = 65536;
constexpr int CONSUMERS = TILES * 32;
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int STAGE_F2 = STAGE_BYTES / 8;
constexpr int VT_BYTES = MAX_CHI * SLOT_STRIDE * 8;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + VT_BYTES + 2 * STAGES * 8 +
                           (4 * TB + 4) * 4;

struct Shared {
  float2* ring;         // [STAGES][rows][2][wc]
  float2* vT;           // [MAX_CHI][SLOT_STRIDE]
  uint64_t* full;       // [STAGES]
  uint64_t* empty;      // [STAGES]
  int* slot_of_row;     // [2][TB], -1 for rows past the batch
  int* row_of_slot;     // [2][TB], -1 for empty slots
  int* groups;          // [2][2]: g0, g1
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "K1_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra K1_WAIT;\n\t}"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// one 2-D tile of `map` at (column 0, row `row`) into dst, completing on bar
__device__ __forceinline__ void tile_load(void* dst, const CUtensorMap* map,
                                          int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0),
         "r"(row), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ int padded(int w) {
  return (w + LANE_TILE - 1) / LANE_TILE * LANE_TILE;
}

// k rows of a chunk at padded width wc (> 0): as many as fill a stage
__host__ __device__ constexpr int chunk_rows(int wc) {
  return STAGE_BYTES / (16 * wc);
}

struct Maps {
  CUtensorMap m[MAX_CHI / LANE_TILE];  // by padded width / 64 - 1
};

// warp 0: place the block's rows by their bit at one site into buffer `buf`
__device__ __forceinline__ void group_rows(const Shared& sh, int lane,
                                           bool valid, int bit, int buf) {
  const unsigned m1 = __ballot_sync(0xffffffffu, valid && bit);
  const unsigned m0 = __ballot_sync(0xffffffffu, valid && !bit);
  const int g0 = __popc(m0);
  const unsigned below = (1u << lane) - 1u;
  const int slot = !valid ? -1
                   : bit  ? g0 + __popc(m1 & below)
                          : __popc(m0 & below);
  int* ros = sh.row_of_slot + buf * TB;
  ros[lane] = -1;
  __syncwarp();
  if (slot >= 0) ros[slot] = lane;
  sh.slot_of_row[buf * TB + lane] = slot;
  if (lane == 0) {
    sh.groups[2 * buf] = g0;
    sh.groups[2 * buf + 1] = __popc(m1);
  }
}

// acc += v[k0:k0 + rows, tile's slots]^T . A[k0:k0 + rows, branch, cols]
// for one staged chunk. M = 0: every row takes the branch at A0; M > 0: the
// mixed tile, rows < M take A0 (branch 0), the others A1 (branch 1).
template <int QN, int M>
__device__ __forceinline__ void tile_product(float2 (&acc)[R][QN][CPL],
                                             const float2* A0,
                                             const float2* A1,
                                             const float2* v, int rows) {
  constexpr int WC = QN * LANE_TILE;
#pragma unroll 4
  for (int kk = 0; kk < rows; ++kk) {
    float2 x[R];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const float4 p =
          *reinterpret_cast<const float4*>(v + kk * SLOT_STRIDE + 2 * i);
      x[2 * i] = make_float2(p.x, p.y);
      x[2 * i + 1] = make_float2(p.z, p.w);
    }
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      float2 a0[CPL], a1[CPL];
      const int off = kk * 2 * WC + q * LANE_TILE;
      if constexpr (CPL == 2) {
        const float4 p = *reinterpret_cast<const float4*>(A0 + off);
        a0[0] = make_float2(p.x, p.y);
        a0[CPL - 1] = make_float2(p.z, p.w);
      } else {
        a0[0] = A0[off];
      }
#pragma unroll
      for (int t = 0; t < CPL; ++t) a1[t] = a0[t];
      if constexpr (M > 0) {
        if constexpr (CPL == 2) {
          const float4 p = *reinterpret_cast<const float4*>(A1 + off);
          a1[0] = make_float2(p.x, p.y);
          a1[CPL - 1] = make_float2(p.z, p.w);
        } else {
          a1[0] = A1[off];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          const float2 a = (M == 0 || r < M) ? a0[t] : a1[t];
          float2& y = acc[r][q][t];
          y.x = fmaf(x[r].x, a.x, y.x);
          y.x = fmaf(-x[r].y, a.y, y.x);
          y.y = fmaf(x[r].x, a.y, y.y);
          y.y = fmaf(x[r].y, a.x, y.y);
        }
    }
  }
}

// the mixed tile's product, compiled for its split point
template <int QN, int M = 1>
__device__ __forceinline__ void mixed_product(int split,
                                              float2 (&acc)[R][QN][CPL],
                                              const float2* A,
                                              const float2* v, int rows) {
  constexpr int WC = QN * LANE_TILE;
  if constexpr (M < R) {
    if (split == M) {
      tile_product<QN, M>(acc, A, A + WC, v, rows);
    } else {
      mixed_product<QN, M + 1>(split, acc, A, v, rows);
    }
  }
}

// One site for consumer warp `warp`, at QN 64-column chunks: the chunked
// block product over k < ws, then the write-back into the next site's slots
// (or, at the last site, the outputs).
template <int QN>
__device__ __forceinline__ void site_pass(const Shared& sh, int warp,
                                          int lane, int ws, int cur,
                                          bool last, int& c, float amp,
                                          float2* __restrict__ out, int b0) {
  constexpr int WC = QN * LANE_TILE;
  constexpr int KC = chunk_rows(WC);
  const int tile = warp / H, half = warp % H;
  const int g0 = sh.groups[2 * cur], g1 = sh.groups[2 * cur + 1];
  const int lo = R * tile;
  const bool live = lo < g0 + g1;
  // split point of the mixed tile (rows < split take branch 0), else 0
  const int split = (lo < g0 && g0 < lo + R) ? g0 - lo : 0;
  const int br = lo < g0 ? 0 : 1;  // the branch of a one-bit tile
  const int col = (LANE_TILE / H) * half + CPL * lane;  // in each chunk

  float2 acc[R][QN][CPL];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < QN; ++q)
#pragma unroll
      for (int t = 0; t < CPL; ++t) acc[r][q][t] = make_float2(0.f, 0.f);

  for (int k0 = 0; k0 < ws; k0 += KC, ++c) {
    const int st = c % STAGES;
    mbar_wait(&sh.full[st], (c / STAGES) & 1);
    if (live) {
      const int rows = min(KC, ws - k0);
      const float2* A = sh.ring + st * STAGE_F2 + col;
      const float2* v = sh.vT + k0 * SLOT_STRIDE + lo;
      if (split == 0) {
        tile_product<QN, 0>(acc, A + br * WC, A, v, rows);
      } else {
        mixed_product<QN>(split, acc, A, v, rows);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sh.empty[st]);
  }

  consumer_sync();  // every tile has read vT; the next site's map is placed
  if (live) {
    const int* ros = sh.row_of_slot + cur * TB;
    const int* sor = sh.slot_of_row + (cur ^ 1) * TB;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = ros[lo + r];
      if (row < 0) continue;
      if (last) {
        if (col == 0) {
          out[b0 + row] = make_float2(amp * acc[r][0][0].x,
                                      amp * acc[r][0][0].y);
        }
        continue;
      }
      const int ns = sor[row];
#pragma unroll
      for (int q = 0; q < QN; ++q)
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          const int j = q * LANE_TILE + col + t;
          sh.vT[j * SLOT_STRIDE + ns] = acc[r][q][t];
        }
    }
  }
  consumer_sync();  // the new vectors are in place
}

__global__ void __launch_bounds__(THREADS, 1)
coefficient_batch_kernel(const __grid_constant__ Maps maps,
                         const int* __restrict__ widths,
                         const int* __restrict__ configs,
                         const float* __restrict__ amp,
                         float2* __restrict__ out, int B, int n, int cp) {
  extern __shared__ __align__(128) unsigned char smem[];
  Shared sh;
  sh.ring = reinterpret_cast<float2*>(smem);
  sh.vT = reinterpret_cast<float2*>(smem + STAGES * STAGE_BYTES);
  sh.full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES +
                                        VT_BYTES);
  sh.empty = sh.full + STAGES;
  sh.slot_of_row = reinterpret_cast<int*>(sh.empty + STAGES);
  sh.row_of_slot = sh.slot_of_row + 2 * TB;
  sh.groups = sh.row_of_slot + 2 * TB;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * TB;
  const bool valid = b0 + lane < B;
  const int* my_bits = configs + (size_t)(valid ? b0 + lane : 0) * n;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&sh.full[i], 1);
      mbar_init(&sh.empty[i], TILES);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // e_0 in every slot: row k = 0 of vT
  for (int i = threadIdx.x; i < SLOT_STRIDE; i += THREADS) {
    sh.vT[i] = make_float2(1.f, 0.f);
  }
  int next_bit = 0;  // warp 0: the bit of the site after the next
  if (warp == 0) {
    group_rows(sh, lane, valid, valid ? my_bits[0] != 0 : 0, 0);
    next_bit = (valid && n > 1) ? my_bits[1] != 0 : 0;
  }
  __syncthreads();  // barriers, vT and the first map in place

  if (warp == TILES) {  // producer
    if (lane == 0) {
      int c = 0;
      for (int s = 0; s < n; ++s) {
        const int ws = widths[s];
        const int wc = padded(widths[s + 1]);
        if (wc == 0) continue;
        const int kc = chunk_rows(wc);
        const CUtensorMap* map = &maps.m[wc / LANE_TILE - 1];
        for (int k0 = 0; k0 < ws; k0 += kc, ++c) {
          const int st = c % STAGES;
          mbar_wait(&sh.empty[st], ((c / STAGES) & 1) ^ 1);
          mbar_expect_tx(&sh.full[st], 2 * kc * wc * 8);
          tile_load(sh.ring + st * STAGE_F2, map, 2 * (s * cp + k0),
                    &sh.full[st]);
        }
      }
    }
    __syncwarp();
  } else {  // consumers
    const float a = *amp;
    int c = 0;
    for (int s = 0; s < n; ++s) {
      const int cur = s & 1;
      if (warp == 0 && s + 1 < n) {
        group_rows(sh, lane, valid, next_bit, cur ^ 1);
        next_bit = (valid && s + 2 < n) ? my_bits[s + 2] != 0 : 0;
      }
      const int ws = widths[s];
      const bool last = s + 1 == n;
      switch (padded(widths[s + 1]) / LANE_TILE) {
        case 1: site_pass<1>(sh, warp, lane, ws, cur, last, c, a, out, b0); break;
        case 2: site_pass<2>(sh, warp, lane, ws, cur, last, c, a, out, b0); break;
        case 3: site_pass<3>(sh, warp, lane, ws, cur, last, c, a, out, b0); break;
        case 4: site_pass<4>(sh, warp, lane, ws, cur, last, c, a, out, b0); break;
        default:  // no live lane at bond s + 1: nothing to multiply
          consumer_sync();
          consumer_sync();
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// tensor maps of the packed chain seen as [n cp 2 rows, cp] 8-byte elements,
// a tile of 2 kc rows by wc columns for each padded width wc <= cp
cudaError_t encode_maps(Maps* maps, const void* cores, int n, int cp) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorNotSupported;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  for (int q = 1; q * LANE_TILE <= cp; ++q) {
    const int wc = q * LANE_TILE;
    const cuuint64_t dims[2] = {(cuuint64_t)cp, (cuuint64_t)n * cp * 2};
    const cuuint64_t strides[1] = {(cuuint64_t)cp * 8};
    const cuuint32_t box[2] = {(cuuint32_t)wc,
                               (cuuint32_t)(2 * chunk_rows(wc))};
    const cuuint32_t step[2] = {1, 1};
    const CUresult res = encode(
        &maps->m[q - 1], CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 2,
        const_cast<void*>(cores), dims, strides, box, step,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

cudaError_t launch(const void* cores, const void* widths, const void* configs,
                   const void* amp, void* out, int B, int n, int cp,
                   cudaStream_t stream) {
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && !opted_in[dev]) {
    err = cudaFuncSetAttribute(coefficient_batch_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  Maps maps;
  err = encode_maps(&maps, cores, n, cp);
  if (err != cudaSuccess) return err;
  coefficient_batch_kernel<<<(B + TB - 1) / TB, THREADS, SMEM_BYTES, stream>>>(
      maps, static_cast<const int*>(widths), static_cast<const int*>(configs),
      static_cast<const float*>(amp), static_cast<float2*>(out), B, n, cp);
  return cudaGetLastError();
}

}  // namespace

// cores [n, cp, 2, cp] complex64 with the live lanes of every bond first,
// widths [n + 1] int32 (the live widths, each <= cp), configs [B, n] int32,
// amp one float32, out [B] complex64, all on the device; cp a multiple of
// 64 up to 256. Launches on `stream` and returns the launch's CUDA error
// (0 on success).
extern "C" int qlt_coefficient_batch(const void* cores, const void* widths,
                                     const void* configs, const void* amp,
                                     void* out, int B, int n, int cp,
                                     void* stream) {
  if (B <= 0 || n <= 0 || cp <= 0 || cp > MAX_CHI || cp % LANE_TILE) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch(cores, widths, configs, amp, out, B, n, cp,
                     static_cast<cudaStream_t>(stream));
}
