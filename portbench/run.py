"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the cell's cards. Exits
nonzero, printing no result, when the program cannot be imported, without
CUDA or with fewer cards than the cell asks for, and when JAX or the JAX
package is loaded once the window has closed. The last lines of
standard error, and the ``checks`` key that comes last in the result line,
give each number compared with its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench.harness import core, spec

    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, args.workload)
    import torch

    import qilaplace_tpu_torch  # noqa: F401  (a checkout without it fails here)

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = core.run_cell(bench, args.workload, seed=args.seed,
                        seconds=args.seconds, trace=bool(args.trace),
                        device="cuda:0", t_start=T_START)
    found = core.forbidden_modules()
    if found:
        print("portbench: loaded in this process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    lat = sorted(1e3 * s for s in out.pop("latencies_s"))
    print(f"portbench: {len(lat)} requests, latency ms min {lat[0]:.3f} "
          f"median {lat[len(lat) // 2]:.3f} max {lat[-1]:.3f}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
