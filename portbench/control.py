"""The readings that the limits of ``correct`` are set from: a cell's runs
on several seeds in one process, as the program runs them or as the
control. The control computes in TF32, the nearest precision below the
configuration's float32 (which the program's import sets, TF32 off): TF32
on for every float32 matmul, and K1, a hand-written float32 kernel that
TF32 does not reach, replaced by its plain torch version
(``coefficient_batch_k1_reference``), whose matmuls it does.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> --precision float32|tf32 [--out <file.jsonl>]

Prints one JSON line a seed: the seed, the precision, the checks and the
end-to-end metrics. The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def set_precision(precision: str) -> None:
    """float32: the program's own setting (no TF32); tf32: TF32 on for
    every float32 matmul and convolution."""
    import torch

    import qilaplace_tpu_torch  # noqa: F401  (its import sets float32)

    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def control_patches() -> dict:
    """K1's wrapper -> its plain torch version, in every module of the
    port."""
    from qilaplace_tpu_torch.ops import readout_kernels as rk

    return {rk.coefficient_batch_k1: rk.coefficient_batch_k1_reference}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--precision", choices=("float32", "tf32"),
                        default="tf32")
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import torch

    from portbench.harness import core, spec

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    from portbench.harness.trace import patched

    bench = spec.load_benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        set_precision(args.precision)
        t0 = time.perf_counter()
        with patched(control_patches() if args.precision == "tf32" else {}):
            out = core.run_cell(bench, args.workload, seed=seed,
                                seconds=args.seconds, trace=False,
                                device="cuda:0", t_start=t0)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "precision": args.precision,
                           "correct": out["correct"],
                           "attempted": out["attempted"],
                           "checks": out["checks"],
                           "metrics": out["metrics"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
