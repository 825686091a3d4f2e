// The exchange primitives of kernel K2's group and cluster variants
// (qilaplace_tpu_torch/csrc/jacobi_eigh.cu), each timed alone in a loop:
//
//  * qlt_l2_loop, launched cooperatively (every block resident at once):
//    mode 0, a flag round trip through L2 between two blocks (block 0
//    publishes i, block 1 waits for it and publishes i back); mode 1, the
//    group variant's round without its arithmetic: every block stores
//    `words` elements into its right neighbour's inbox, a block barrier,
//    one thread fences and publishes its flag, one warp waits for all nb
//    flags, a block barrier, every thread reads its own inbox (loads that
//    skip L1), a block barrier; mode 2, the same with one counter in place
//    of the flags (a fenced atomic add, polled until it reaches nb i);
//  * qlt_cluster_loop: a cluster of nb blocks (nb > 8 only where the card
//    allows a non-portable size) passing one float a block each iteration
//    by st.async into the neighbours' shared memory (mode 0: both
//    neighbours) or every block's (mode 1: the cluster variant's rotation
//    broadcast), each block waiting on its own mbarrier; and
//    qlt_cluster_fit, how many such clusters the card holds at once.
//
// A wait still open after a second traps instead of hanging the card.
// Built by ops/kernel_build.py beside the kernels; timed by chip_smoke.py
// (phase_k2_primitives) and scripts/port/k2_variants.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void trap_after_a_second(unsigned long long& t0) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (t0 == 0) t0 = now;
  if (now - t0 > 1000000000ull) __trap();
}

// thread 0 waits until *p >= v
__device__ __forceinline__ void spin_until(const unsigned* p, unsigned v) {
  unsigned long long t0 = 0;
  while (ld_acquire(p) < v) trap_after_a_second(t0);
}

__global__ void l2_loop(int mode, int iters, int words, unsigned* flags, float2* boxes,
                        float* sink) {
  const int nb = gridDim.x, k = blockIdx.x, tid = threadIdx.x;
  float acc = 0.f;
  for (int i = 1; i <= iters; ++i) {
    if (mode == 0) {
      if (tid == 0) {
        if (k == 0) {
          __threadfence();
          st_relaxed(flags, i);
          spin_until(flags + 1, i);
        } else if (k == 1) {
          spin_until(flags, i);
          __threadfence();
          st_relaxed(flags + 1, i);
        }
      }
      continue;
    }
    float2* out = boxes + (size_t)(((k + 1) % nb) * 2 + (i & 1)) * words;
    for (int j = tid; j < words; j += blockDim.x) out[j] = make_float2((float)i, (float)j);
    __syncthreads();
    if (mode == 1) {
      if (tid == 0) {
        __threadfence();
        st_relaxed(flags + k, i);
      }
      if (tid < 32) {
        unsigned long long t0 = 0;
        for (;;) {
          const bool done = tid >= nb || ld_acquire(flags + tid) >= (unsigned)i;
          if (__all_sync(0xffffffffu, done)) break;
          trap_after_a_second(t0);
        }
      }
    } else if (tid == 0) {
      __threadfence();
      atomicAdd(flags, 1u);
      spin_until(flags, (unsigned)(nb * i));
    }
    __syncthreads();
    const float2* in = boxes + (size_t)(k * 2 + (i & 1)) * words;
    for (int j = tid; j < words; j += blockDim.x) acc += __ldcg(in + j).x;
    __syncthreads();
  }
  if (acc == -1.f) *sink = acc;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int q) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(q));
  return out;
}

__global__ void cluster_loop(int mode, int iters, float* sink) {
  __shared__ float slots[2][32];
  __shared__ unsigned long long bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int e = 0; e < 2; ++e) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar + e)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  // mode 0: the two neighbours on a ring; mode 1: every block
  const int sends = mode ? nb : (nb > 2 ? 2 : 1);
  for (int i = 0; i < iters; ++i) {
    const int par = i & 1;
    const unsigned b = smem_addr(bar + par);
    if (tid == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
                   "r"(sends * 4) : "memory");
    }
    if (tid < sends) {
      const int q = mode ? tid : (tid ? (k + nb - 1) % nb : (k + 1) % nb);
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];" ::"r"(
              cluster_addr(smem_addr(&slots[par][k]), q)),
          "f"((float)i), "r"(cluster_addr(b, q))
          : "memory");
    }
    unsigned long long t0 = 0;
    for (;;) {
      unsigned done;
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done) : "r"(b), "r"((i >> 1) & 1) : "memory");
      if (done) break;
      trap_after_a_second(t0);
    }
  }
  cluster.sync();
  if (tid == 0 && slots[0][0] == -1.f) *sink = slots[0][0];
}

cudaLaunchConfig_t cluster_config(int nb, int threads, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// flags: nb unsigned, zeroed here; boxes: 2 nb words float2; sink: 1 float
extern "C" int qlt_l2_loop(int mode, int nb, int threads, int iters, int words, void* flags,
                           void* boxes, void* sink, void* stream) {
  if (nb < 2 || nb > 32 || iters < 1 || words < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flags, 0, nb * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  unsigned* f = static_cast<unsigned*>(flags);
  float2* b = static_cast<float2*>(boxes);
  float* k = static_cast<float*>(sink);
  void* args[] = {&mode, &iters, &words, &f, &b, &k};
  return (int)cudaLaunchCooperativeKernel((const void*)l2_loop, dim3(nb), dim3(threads), args,
                                          0, s);
}

// clusters of nb blocks that the card holds at once (0: none)
extern "C" int qlt_cluster_fit(int nb, int threads) {
  if (nb > 8 && cudaFuncSetAttribute(cluster_loop,
                                     cudaFuncAttributeNonPortableClusterSizeAllowed,
                                     1) != cudaSuccess) {
    return 0;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(nb, threads, 0, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, cluster_loop, &cfg) != cudaSuccess) return 0;
  return n;
}

extern "C" int qlt_cluster_loop(int mode, int nb, int threads, int iters, void* sink,
                                void* stream) {
  if (nb < 2 || nb > 32 || iters < 1) return (int)cudaErrorInvalidValue;
  if (nb > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_loop, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(nb, threads, static_cast<cudaStream_t>(stream), attr);
  return (int)cudaLaunchKernelEx(&cfg, cluster_loop, mode, iters, static_cast<float*>(sink));
}
