"""Kernel K1's time split by part, from variants of its source.

Each variant is the committed ``csrc/coefficient_batch.cu`` with one text
substitution, written to ``build/k1_variants/``, built as the kernels are
(``ops/kernel_build.py``: one ``nvcc`` each, all at once) and timed alone
(CUDA events, in turns, median of 4 batches of 10 launches) on the packed
n=30 zT chain of ``chip_smoke.py`` (``zt_operands``), beside the wrapper
(pre-pass included), the pre-pass alone and the plain complex64 version:

- ``base``: the source as it is (8-row register tiles, each shared by
  two warps; two 64 KB stages; the k loop unrolled 4 times);
- ``no-compute``: the consumers skip the block product (they still wait
  for every chunk and free it): the time of the staging pipeline, the
  barriers and the write-back;
- ``no-copy``: the producer issues no copy (it only arms each stage): the
  time of the block product on whatever the ring holds, and the barriers;
- ``r4h2`` (16 warps, and ``r4h2-no-copy``), ``r8h1`` (4 warps), ``r4h1``
  (8 warps): R-row register tiles shared by H warps;
- ``unroll-2``: the k loop unrolled 2 times;
- ``stages-4``, ``stages-2x72``: the ring as 4 stages of 32 KB or 2 of
  72 KB.

A name ending in ``.cu`` is taken as a whole source (named by its stem),
so an earlier step of the kernel's design can be timed the same way. The
variants with wrong numbers (``no-compute`` and the ``no-copy`` ones) are
timed, not checked. An anchor that is not found once in the source fails
the run. Arguments: the variants to run (default all). Run from the
repository root on the card: python scripts/port/k1_variants.py
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

SOURCE = ROOT / "qilaplace_tpu_torch" / "csrc" / "coefficient_batch.cu"
OUT = ROOT / "build" / "k1_variants"

NO_COMPUTE = [("    if (live) {\n      const int rows = min(KC, ws - k0);",
               "    if (false) {\n      const int rows = min(KC, ws - k0);")]
NO_COPY = [("mbar_expect_tx(&sh.full[st], 2 * kc * wc * 8);\n          tile_load",
            "mbar_expect_tx(&sh.full[st], 0);\n          if (false) tile_load")]
R4 = [("constexpr int R = 8; ", "constexpr int R = 4; ")]
H1 = [("constexpr int H = 2; ", "constexpr int H = 1; ")]


def ring(stages, kib):
    return [("constexpr int STAGES = 2;\nconstexpr int STAGE_BYTES = 65536;",
             f"constexpr int STAGES = {stages};\n"
             f"constexpr int STAGE_BYTES = {kib * 1024};")]


VARIANTS = {
    "base": [],
    "no-compute": NO_COMPUTE,
    "no-copy": NO_COPY,
    "r4h2": R4,
    "r4h2-no-copy": R4 + NO_COPY,
    "r8h1": H1,
    "r4h1": R4 + H1,
    "unroll-2": [("#pragma unroll 4\n  for (int kk = 0; kk < rows; ++kk)",
                  "#pragma unroll 2\n  for (int kk = 0; kk < rows; ++kk)")],
    "stages-4": ring(4, 32),
    "stages-2x72": ring(2, 72),
}


def build(names):
    """Variant name -> its bound launch function, all built at once."""
    from qilaplace_tpu_torch.ops import readout_kernels as rk
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
    infos = build_kernels(rk.SOURCE, *paths.values())  # the wrapper's too
    for name, path in paths.items():
        log = infos[path]["log"].splitlines()
        regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                       for ln in log if "Used" in ln})
        spills = sorted({ln.strip() for ln in log if "spill" in ln})
        print(f"[build] {name}: {regs}; {spills}", flush=True)
    return {name: rk.bind(load_kernel(path)) for name, path in paths.items()}


def main():
    if not torch.cuda.is_available():
        sys.exit("k1_variants: no CUDA device")
    import qilaplace_tpu_torch as qt
    from qilaplace_tpu_torch.ops import readout_kernels as rk

    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    fns = build(names)
    print(f"[build] {len(fns)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = torch.device("cuda", 0)
    _, _, cfg_np = cs.scan_samples(cs.N_BITS)
    cfg = torch.from_numpy(cfg_np).to(dev)
    W, psi, _ = cs.zt_operands(dev)
    chain = qt.zipper_chain(W, psi)
    packed, widths = rk.pack_live_lanes(chain.cores)
    ref = rk.coefficient_batch_k1_reference(chain.to(dtype=torch.complex128),
                                            cfg)
    amp = chain.amplitude.to(device=dev, dtype=torch.float32).reshape(1)
    stream = torch.cuda.current_stream().cuda_stream
    outs = {name: torch.empty(cfg.shape[0], dtype=torch.complex64, device=dev)
            for name in fns}

    def launch(name):
        err = fns[name](packed.data_ptr(), widths.data_ptr(), cfg.data_ptr(),
                        amp.data_ptr(), outs[name].data_ptr(), cfg.shape[0],
                        chain.n, packed.shape[1], stream)
        if err:
            raise RuntimeError(f"variant {name}: CUDA error {err}")

    runs = {nm: (lambda nm=nm: launch(nm)) for nm in fns}
    for name, f in runs.items():
        f()
        torch.cuda.synchronize()
        if "no-co" not in name:
            rel = float((outs[name].to(torch.complex128) - ref).abs().max()
                        / ref.abs().max())
            print(f"[check] {name}: rel {rel:.3e}", flush=True)
            cs.check(rel <= cs.K1_TOL, f"variant {name} disagrees")
    runs["wrapper (pre-pass included)"] = (
        lambda: rk.coefficient_batch_k1(chain, cfg))
    runs["pre-pass"] = lambda: rk.pack_live_lanes(chain.cores)
    runs["plain c64"] = lambda: rk.coefficient_batch_k1_reference(chain, cfg)
    for f in list(runs.values())[len(fns):]:
        f()  # warm-up
    ms = {k: [] for k in runs}
    keys = list(runs)
    for turn in range(4):
        for k in (keys if turn % 2 == 0 else keys[::-1]):
            ms[k].append(cs.event_ms(runs[k]))
    w = widths.double()
    flops = 8.0 * cfg.shape[0] * float((w[:-1] * w[1:]).sum())
    for nm, v in ms.items():
        print(f"[time] {nm}: {float(np.median(v)):.4f} ms (runs "
              f"{', '.join(f'{x:.4f}' for x in v)})", flush=True)
    print(f"[time] bound {1e3 * flops / cs.PEAK_FP32:.4f} ms (live work, "
          f"8 B sum w_s w_s+1 = {flops:.4e} flops); card {smi}", flush=True)


if __name__ == "__main__":
    main()
