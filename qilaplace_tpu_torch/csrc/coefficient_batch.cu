// Batched coefficient readout of a matrix-product chain (kernel K1).
//
// Replaces the Pallas TPU kernel qilaplace_tpu/ops/pallas_kernels.py::_kernel
// (called by coefficient_batch_pallas). For each of B bit configurations:
//   v = e_0 (1 x chi);  for site s: v <- v . A[s, :, bit_s, :];  out = amp * v[0]
// with A the [n, chi, 2, chi] complex64 cores (interleaved float2) and the
// configurations [B, n] int32.
//
// What bounds it on an H100: at the pole-scan shape (B = 4096 configurations,
// n = 60 chain sites, chi = 256) the chain costs B * n * chi^2 complex MACs,
// about 1.3e11 fp32 flops, and every block streams each site's core (1 MiB at
// chi 256, 63 MB for the chain, which fits the 50 MB L2 only in part) from
// L2. So FMA throughput and L2 bandwidth bound it, not HBM.
//
// Design, kept simple and exact first:
//  * one launch walks all n sites in a loop inside the block; that loop takes
//    the place of the TPU's sequential site-chunk calls, so there is no site
//    chunking and no identity padding;
//  * a block owns a tile of TB = 32 configurations; the running vectors of the
//    tile (TB x chi float2, 64 KiB at chi 256) live in dynamic shared memory,
//    ping-ponged between two buffers so one __syncthreads per site suffices;
//  * thread j produces column j for all TB rows: for each k it loads
//    A[s, k, 0, j] and A[s, k, 1, j] once (coalesced over j) and feeds every
//    row only the branch its bit selects, so each row costs one complex MAC
//    per (k, j), half of the TPU kernel's evaluate-both-and-select;
//  * the tile's bits for the next site are gathered by warp 0 into one 32-bit
//    ballot mask while the other warps compute, so a row's bit is one shift;
//  * plain fp32 FMA with fp32 accumulation; no tensor cores.
// Each block re-reads every core from L2: B / TB re-reads of the chain. A
// faster design (3xTF32 tensor cores, rows grouped by bit, TMA, wgmma) is
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 32;        // configurations per block (one ballot word)
constexpr int MAX_CHI = 256;  // widest chain the launch takes

__global__ void __launch_bounds__(MAX_CHI)
coefficient_batch_kernel(const float2* __restrict__ cores,
                         const int* __restrict__ configs,
                         const float* __restrict__ amp,
                         float2* __restrict__ out,
                         int B, int n, int chi) {
  extern __shared__ float2 smem[];
  __shared__ unsigned mask[2];
  float2* vin = smem;
  float2* vout = smem + TB * chi;

  const int j = threadIdx.x;
  const int b0 = blockIdx.x * TB;
  const int lane = threadIdx.x & 31;
  const bool warp0 = threadIdx.x < 32;

  // warp 0 packs bit `site` of the tile's TB rows into one word; rows past
  // the ragged end of the batch take bit 0 and are never written out
  auto gather_bits = [&](int site) {
    const int row = b0 + lane;
    const int bit = row < B ? configs[(size_t)row * n + site] : 0;
    const unsigned m = __ballot_sync(0xffffffffu, bit != 0);
    if (lane == 0) mask[site & 1] = m;
  };

  for (int idx = threadIdx.x; idx < TB * chi; idx += blockDim.x) {
    vin[idx] = make_float2((idx % chi) == 0 ? 1.f : 0.f, 0.f);
  }
  if (warp0) gather_bits(0);
  __syncthreads();

  for (int site = 0; site < n; ++site) {
    if (warp0 && site + 1 < n) gather_bits(site + 1);
    const unsigned m = mask[site & 1];
    if (j < chi) {
      const float2* As = cores + (size_t)site * chi * 2 * chi;
      float2 acc[TB];
#pragma unroll
      for (int r = 0; r < TB; ++r) acc[r] = make_float2(0.f, 0.f);
#pragma unroll 2
      for (int k = 0; k < chi; ++k) {
        const float2 a0 = As[(size_t)(2 * k) * chi + j];
        const float2 a1 = As[(size_t)(2 * k + 1) * chi + j];
#pragma unroll
        for (int r = 0; r < TB; ++r) {
          const float2 x = vin[r * chi + k];  // same address warp-wide
          const float2 a = ((m >> r) & 1u) ? a1 : a0;
          acc[r].x = fmaf(x.x, a.x, acc[r].x);
          acc[r].x = fmaf(-x.y, a.y, acc[r].x);
          acc[r].y = fmaf(x.x, a.y, acc[r].y);
          acc[r].y = fmaf(x.y, a.x, acc[r].y);
        }
      }
#pragma unroll
      for (int r = 0; r < TB; ++r) vout[r * chi + j] = acc[r];
    }
    __syncthreads();
    float2* t = vin;
    vin = vout;
    vout = t;
  }

  if (warp0 && b0 + lane < B) {
    const float2 v = vin[lane * chi];
    const float a = *amp;
    out[b0 + lane] = make_float2(a * v.x, a * v.y);
  }
}

}  // namespace

// cores [n, chi, 2, chi] complex64, configs [B, n] int32, amp one float32,
// out [B] complex64, all on the device; launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int qlt_coefficient_batch(const void* cores, const void* configs,
                                     const void* amp, void* out, int B, int n,
                                     int chi, void* stream) {
  if (B <= 0 || n <= 0 || chi <= 0 || chi > MAX_CHI) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = 2 * (size_t)TB * chi * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      coefficient_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((chi + 31) / 32) * 32;
  const int blocks = (B + TB - 1) / TB;
  coefficient_batch_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(cores), static_cast<const int*>(configs),
      static_cast<const float*>(amp), static_cast<float2*>(out), B, n, chi);
  return (int)cudaGetLastError();
}
