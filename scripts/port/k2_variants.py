"""Kernel K2's cluster (84 < m <= 320) and group (m > 320) variants timed
against variants of their source, and their exchange primitives timed
alone.

Each variant is the committed ``csrc/jacobi_eigh.cu`` with text
substitutions, written to ``build/k2_variants/``, built as the kernels are
(``ops/kernel_build.py``: one ``nvcc`` each, all at once) and launched
through its own ``qlt_jacobi_eigh``:

- ``base``: the source as it is;
- ``ppb-20``: 20 column pairs a cluster block (a cluster of 4 at m = 160;
  the source aims at 10, a cluster of 8);
- ``vchunk-8``, ``vchunk-32``: the vector pass stages 8 or 32 rounds of
  rotations at a time (the source: 16);
- ``vwarps-2``, ``vwarps-4``: 2 or 4 rows of V a block of the vector pass
  (the source: 8), so more SMs share its shared-memory traffic;
- ``no-vectors``: the cluster kernel alone, without the vector pass (which
  writes the eigenvalues and V: timed, not checked): G's share of the time;
- ``no-update``, ``no-rotation``: the owners skip their update of G (they
  still store, and send their edge columns), or the makers their rotation's
  chain of sqrt and division (timed, not checked): each one's share of a
  round;
- ``no-edges``: no edge column crosses to a neighbour (timed, not
  checked); ``exchange-only``: neither the update nor the makers'
  arithmetic, only the round's stores and exchange (timed, not checked);
- ``test-wait``: the mbarrier polled with ``test_wait`` instead of the
  suspending ``try_wait``;
- ``group-pairs-11``: 11 column pairs a group block (24 blocks at m = 512;
  the source aims at 8, 32 blocks);
- ``recv-unroll-1``, ``recv-unroll-4``: a group thread loads 1 or 4 of
  the rows its block received before it stores them (the source: 2);
- ``group-no-update``: the group's owners skip their update of G (they
  still store, and send their columns; timed, not checked): the exchange's
  share of a round.

A name ending in ``.cu`` is taken as a whole source (named by its stem), so
an earlier design of the kernel can be timed beside the committed one.

Every checked variant's eigenvalues are held against the plain version
on the card (same sweeps, same dtype) and must be bit-identical to it, a
second run must repeat the first bit for bit, and V is held to
``jacobi_kernels.rounding_bar``. Each shape is then timed
(CUDA events, in turns, median of 4 batches of 5 launches; of 1 for the
plain version) beside the plain version and ``torch.linalg.eigh``, with
the time a Jacobi round.

Before that, ``barrier``: a kernel that runs 10,000 block barriers
(``__syncthreads``) or cluster barriers in a loop, at 832 threads a block
(the block of a cluster of 4 at m = 160) and clusters of 1-8 blocks, gives
each one's latency: ``cluster.sync()`` of cooperative groups (what the
kernel calls), ``barrier.cluster.arrive.release.aligned`` /
``wait.acquire.aligned`` and the relaxed arrive (no memory ordering: the
floor). Then the group variant's primitives (``chip_smoke.py``
``phase_k2_primitives``: a flag round trip through L2, flag and counter
barriers across 16-32 co-resident blocks) and the cluster exchange of
``scripts/port/k2_primitives.cu`` at 8 and 16 blocks (16 only where the
card schedules a non-portable cluster of 16): one float a block by
``st.async`` to both neighbours, or to every block.

Arguments: ``--m 384,512`` times only those m; the rest are the variants
to run (default all). Run from the repository root on the card:
python scripts/port/k2_variants.py
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SOURCE = ROOT / "qilaplace_tpu_torch" / "csrc" / "jacobi_eigh.cu"
OUT = ROOT / "build" / "k2_variants"


def ppb(n):
    return [("constexpr int PAIRS_PER_BLOCK = 10;",
             f"constexpr int PAIRS_PER_BLOCK = {n};")]


def vchunk(n):
    return [("constexpr int V_CHUNK = 16;", f"constexpr int V_CHUNK = {n};")]


VARIANTS = {
    "base": [],
    "ppb-20": ppb(20),
    "vchunk-8": vchunk(8),
    "vchunk-32": vchunk(32),
    "no-vectors": [("  const int groups = (m + V_WARPS - 1) / V_WARPS;\n"
                    "  vectors<<<",
                    "  const int groups = 0;\n"
                    "  if (groups) vectors<<<")],
}
VARIANTS["no-update"] = [
    ("        E::left(ri.c, ri.z, Gc[p * L + K], Gc[q * L + K], x0, xq0);\n"
     "        E::left(ri.c, ri.z, Gc[p * L + w + K], Gc[q * L + w + K], x1, xq1);",
     "        x0 = x1 = xq0 = xq1 = E::eye(false);"),
    ("\n          E::right(rk.c, rk.z, h ? xq0 : x0, h ? xq1 : x1, y0, y1);",
     "\n          y0 = y1 = E::eye(false);")]
VARIANTS["no-rotation"] = [(
    "\n      next = rotation<E>(d0, d1, wv);",
    "\n      next.c = d0 + d1;\n      next.z = wv;")]
VARIANTS["no-edges"] = [
    ("        edge_bytes += m * (int)sizeof(T);", "        edge_bytes += 0;"),
    ("            st_async(far0 + far + row * L * (unsigned)sizeof(T), y0, bar0 + bar);",
     "            (void)far0;"),
    ("            st_async(far1 + far + row * L * (unsigned)sizeof(T), y1, bar1 + bar);",
     "            (void)far1;")]
VARIANTS["exchange-only"] = VARIANTS["no-update"] + [(
    "      const float d0 = E::re(entry<E>(gAA + off, L, w, sa, sa, rA, rA));\n"
    "      const float d1 = E::re(entry<E>(gBB + off, L, w, sb, sb, rB, rB));\n"
    "      const T wv = entry<E>(gAB + off, L, w, sa, sb, rA, rB);\n"
    "      next = rotation<E>(d0, d1, wv);",
    "      next = rA; (void)rB; (void)off;")]
VARIANTS["test-wait"] = [(
    " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;",
    " mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;")]
for n in (2, 4):
    VARIANTS[f"vwarps-{n}"] = [("constexpr int V_WARPS = 8;",
                                f"constexpr int V_WARPS = {n};")]
VARIANTS["group-pairs-11"] = [("constexpr int GROUP_PAIRS = 8;",
                               "constexpr int GROUP_PAIRS = 11;")]
for n in (1, 4):
    VARIANTS[f"recv-unroll-{n}"] = [("constexpr int RECV_UNROLL = 2;",
                                     f"constexpr int RECV_UNROLL = {n};")]
VARIANTS["group-no-update"] = [
    ("          E::left(ri.c, ri.z, Gc[p * L + K + 1], Gc[q * L + K + 1], x0, xq0);\n"
     "          E::left(ri.c, ri.z, Gc[p * L + W2 + K + 1], Gc[q * L + W2 + K + 1], x1, "
     "xq1);",
     "          x0 = x1 = xq0 = xq1 = E::eye(false);"),
    ("\n            E::right(rk.c, rk.z, h ? xq0 : x0, h ? xq1 : x1, y0, y1);",
     "\n            y0 = y1 = E::eye(false);")]
UNCHECKED = {"no-vectors", "no-update", "no-rotation", "no-edges",
             "exchange-only", "group-no-update"}

# (m, B, complex, sweeps): the gate path's cluster shapes, the largest
# complex64 solve below cutoff 1e-10, the real variant, route edges; the
# group variant at the dft tutorial's m = 512 (7 sweeps), the default
# profile at m = 384, the real variant and B = 4
SHAPES = [(160, 1, True, 7), (160, 1, True, 4), (160, 1, True, 6),
          (288, 1, True, 7), (160, 1, False, 6), (86, 1, True, 9),
          (128, 1, True, 9), (320, 1, True, 7), (288, 3, True, 7),
          (512, 1, True, 7), (384, 1, True, 11), (512, 1, False, 7),
          (512, 4, True, 7), (322, 1, True, 7)]

BARRIER = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void barrier_loop(int iters, int mode, int* sink) {
  int acc = threadIdx.x;
  for (int i = 0; i < iters; ++i) {
    if (mode == 0) {
      __syncthreads();
    } else if (mode == 1) {
      cg::this_cluster().sync();
    } else if (mode == 2) {
      asm volatile("barrier.cluster.arrive.release.aligned;\n"
                   "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    } else {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
                   "barrier.cluster.wait.aligned;\n" ::: "memory");
    }
    acc += i;
  }
  if (acc == -1) *sink = acc;
}

extern "C" int qlt_barrier_loop(int nb, int threads, int iters, int mode,
                                void* sink, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, barrier_loop, iters, mode,
                                 static_cast<int*>(sink));
}
"""


def build(names):
    """Variant name -> (launch, work_bytes) of its library, and the barrier
    loop's launch function, all built at once."""
    import ctypes

    from qilaplace_tpu_torch.ops import jacobi_kernels as jk
    from qilaplace_tpu_torch.ops.kernel_build import build_kernels, load_kernel

    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    paths = {}
    for name in names:
        text = src
        if name.endswith(".cu"):
            text, name = Path(name).read_text(), Path(name).stem
        for old, new in VARIANTS.get(name, []):
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: anchor not found once")
            text = text.replace(old, new)
        paths[name] = str(OUT / f"{name}.cu")
        Path(paths[name]).write_text(text)
    barrier = OUT / "barrier.cu"
    barrier.write_text(BARRIER)
    infos = build_kernels(*paths.values(), str(barrier), str(cs.K2_PRIMITIVES))
    for name, path in paths.items():
        lines = [ln.split("Compiling entry function")[-1].split("for")[0]
                 .strip(" '") if "Compiling entry" in ln else ln.split(":")[-1]
                 .strip() for ln in infos[path]["log"].splitlines()
                 if "Compiling entry" in ln or "spill" in ln or "Used" in ln]
        print(f"[build] {name}: " + " | ".join(lines), flush=True)
    loop = load_kernel(str(barrier)).qlt_barrier_loop
    loop.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    loop.restype = ctypes.c_int
    return {name: jk.bind(load_kernel(path)) for name, path in paths.items()}, loop


def barrier_latency(loop, smi, threads=832, iters=10000):
    """Microseconds a barrier: a block barrier, then cluster barriers of
    1-8 blocks."""
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    kinds = {1: "cluster.sync()", 2: "arrive.release/wait.acquire .aligned",
             3: "arrive.relaxed/wait .aligned (no ordering)"}
    for nb, mode, what in [(1, 0, "__syncthreads, 1 block")] + [
            (nb, mode, f"cluster barrier {kind}, {nb} blocks")
            for mode, kind in kinds.items() for nb in (1, 2, 4, 8)]:
        def run():
            err = loop(nb, threads, iters, mode, sink.data_ptr(), stream)
            cs.check(err == 0, f"barrier loop: CUDA error {err}")
        run()
        torch.cuda.synchronize()
        ms = float(np.median([cs.event_ms(run, reps=3) for _ in range(3)]))
        print(f"[barrier] {what}, {threads} threads: {1e3 * ms / iters:.4f} us "
              f"a barrier ({iters} in {ms:.3f} ms); card {smi}", flush=True)


def cluster_exchange(smi, iters=10000, threads=736):
    """Microseconds an iteration of the cluster exchange of
    k2_primitives.cu: one float a block by st.async to both neighbours
    (mode 0) or to every block (mode 1), at 8 and 16 blocks, where the
    card holds such a cluster at all (qlt_cluster_fit)."""
    import ctypes

    from qilaplace_tpu_torch.ops.kernel_build import load_kernel

    lib = load_kernel(str(cs.K2_PRIMITIVES))
    fit, loop = lib.qlt_cluster_fit, lib.qlt_cluster_loop
    fit.argtypes, fit.restype = [ctypes.c_int] * 2, ctypes.c_int
    loop.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    loop.restype = ctypes.c_int
    sink = torch.zeros(1, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for nb in (8, 16):
        n = fit(nb, threads)
        print(f"[prim] clusters of {nb} blocks of {threads} threads the card "
              f"holds at once: {n}", flush=True)
        if n < 1:
            continue
        for mode, what in ((0, "both neighbours"), (1, "every block")):
            def run():
                err = loop(mode, nb, threads, iters, sink.data_ptr(), stream)
                cs.check(err == 0, f"cluster loop: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            ms = float(np.median([cs.event_ms(run, reps=1) for _ in range(3)]))
            print(f"[prim] cluster of {nb}, st.async to {what}: "
                  f"{1e3 * ms / iters:.4f} us an iteration; card {smi}",
                  flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("k2_variants: no CUDA device")
    import qilaplace_tpu_torch  # noqa: F401  (sets full-fp32 matmuls)
    from qilaplace_tpu_torch.ops import jacobi_kernels as jk

    args = sys.argv[1:]
    only = None
    if "--m" in args:
        at = args.index("--m")
        only = {int(x) for x in args[at + 1].split(",")}
        del args[at:at + 2]
    names = args or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    libs, loop = build(names)
    print(f"[build] {len(libs)} variants and the barrier loop in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    barrier_latency(loop, smi)
    cs.phase_k2_primitives(smi)
    cluster_exchange(smi)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(6)
    for m, B, cplx, sweeps in SHAPES:
        if only is not None and m not in only:
            continue
        H = torch.from_numpy(cs.hermitian(rng, B, m, complex_=cplx)).to(
            dev).contiguous()  # the kernel reads H row by row
        dst = jk._dst_table(m, dev)
        outs = {}

        def launcher(name):
            launch, work_bytes = libs[name]
            lam = torch.empty(B, m, dtype=torch.float32, device=dev)
            V = torch.zeros_like(H)
            nbytes = work_bytes(int(cplx), B, m, sweeps)
            work = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)
            outs[name] = (lam, V)

            def run():
                err = launch(H.data_ptr(), lam.data_ptr(), V.data_ptr(),
                             work.data_ptr(), dst.data_ptr(), int(cplx), B, m,
                             sweeps, 0, stream)
                cs.check(err == 0, f"variant {name}: CUDA error {err}")
            return run

        runs = {name: launcher(name) for name in libs}
        lam_p, V_p = jk.jacobi_eigh_k2_reference(H, sweeps=sweeps)
        plain = jk.figures(H, lam_p, V_p)
        shape = f"{'c64' if cplx else 'f32'} m={m} B={B} sweeps={sweeps}"
        for name, run in runs.items():
            run()
            torch.cuda.synchronize()
            if name in UNCHECKED:
                continue
            lam, V = outs[name]
            differ = int((lam != lam_p).sum())
            first = lam.clone(), V.clone()
            run()  # a second run must repeat the first bit for bit
            torch.cuda.synchronize()
            again = torch.equal(lam, first[0]) and torch.equal(V, first[1])
            got = jk.figures(H, lam, V)
            print(f"[check] {name} {shape}: lam bit-identical "
                  f"{1 - differ / lam.numel():.1%} ({differ} of {lam.numel()} "
                  f"differ), V {float((V == V_p).double().mean()):.1%}, "
                  f"second run equal: {again}; " + "; ".join(
                      f"{k} {v:.2e} plain {plain[k]:.2e}"
                      for k, v in got.items()), flush=True)
            cs.check(differ == 0, f"variant {name} {shape}: eigenvalues differ "
                     "from the plain version")
            cs.check(again, f"variant {name} {shape}: a second run differs")
            for k, v in got.items():
                cs.check(v <= jk.rounding_bar(m, plain[k]),
                         f"variant {name} {shape}: {k} {v:.2e}")
        runs["torch.linalg.eigh"] = lambda: torch.linalg.eigh(H)
        runs["plain"] = lambda: jk.jacobi_eigh_k2_reference(H, sweeps=sweeps)
        runs["torch.linalg.eigh"]()
        ms = {k: [] for k in runs}
        keys = list(runs)
        for turn in range(4):
            for k in (keys if turn % 2 == 0 else keys[::-1]):
                ms[k].append(cs.event_ms(runs[k], reps=1 if k == "plain" else 5))
        rounds = sweeps * (m - 1)
        for k, v in ms.items():
            med = float(np.median(v))
            print(f"[time] {shape} {k}: {med:.4f} ms ({1e3 * med / rounds:.3f} "
                  f"us a round; runs {', '.join(f'{x:.4f}' for x in v)})",
                  flush=True)
        print(f"[time] card {smi}", flush=True)


if __name__ == "__main__":
    main()
