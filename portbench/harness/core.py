"""One run of one cell: set-up, the measured window, the reference check
and the result line.

The window is a closed loop with one client. Request i's inputs are made
first (``entry.prepare(i)``, outside its latency); the request then runs
and ends synchronised. Requests start while less than ``seconds`` have
passed since the first one started, and the window runs from the first
request's start to the last one's end, so no request is cut. Rates are all
the work over the window; tails are over every request.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
import traceback

from portbench.harness import spec
from portbench.harness.trace import DeviceTrace, HostSpans, breakdown, patched
from portbench.harness.yardstick import busy_seconds

FORBIDDEN = ("jax", "jaxlib", "flax", "qilaplace_tpu")


@dataclasses.dataclass
class Request:
    t0: float
    t1: float
    units: float
    ok: bool

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Record:
    """What a metric reader reads: the requests of the window, the host
    spans and device events of a traced run, and the counters' movement
    over the window."""

    cell: dict
    config: dict
    mix: dict
    setup_s: float
    requests: list
    window: tuple
    spans: list
    events: list
    counters: dict

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def span_seconds(self, name: str) -> list[float]:
        return [t1 - t0 for nm, t0, t1 in self.spans if nm == name]


class Context:
    """What an entry gets: its configuration, mix, seed and device; the
    directory for the program's artifact caches (``cache_dir``, at a fixed
    path in the checkout, so that only a checkout's first run builds what
    it caches); ``span(name)``,
    which in a traced run records a host span that ends synchronised (and
    does nothing otherwise); ``sync()``."""

    def __init__(self, config, mix, seed, device, traced, spans, cache_dir):
        self.config, self.mix, self.seed = config, mix, seed
        self.device, self.traced, self.spans = device, traced, spans
        self.cache_dir = cache_dir

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        return self.spans.span(name, sync=self.sync)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def run_cell(bench: dict, workload: str, *, seed: int, seconds: float,
             trace: bool, device, t_start: float, root=spec.PORTBENCH,
             cache_dir=spec.CACHE) -> dict:
    """Run ``workload`` once and return its result line as a dict (the
    checks' numbers under ``checks``, last)."""
    import torch

    device = torch.device(device)
    seed &= 2**64 - 1  # any whole number; numpy's generators take these
    cell = spec.find_cell(bench, workload)
    config = spec.load_config(bench, cell["config"])
    mix = spec.load_traffic(cell["traffic"], root)
    module = spec.load_entry(mix["entry"], root)
    spans = HostSpans()
    ctx = Context(config, mix, seed, device, trace, spans, str(cache_dir))
    entry = module.Entry(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    reqs, events, counters = _window(entry, ctx, seconds, trace)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    entry.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = entry.check()
    window = (reqs[0].t0, reqs[-1].t1)
    record = Record(cell, config, mix, setup_s, reqs, window, spans.spans,
                    events, counters)
    metrics = {}
    for m in spec.metrics_for(bench, workload, trace):
        value = spec.load_metric(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(not r.ok for r in reqs)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    out = {"correct": failed == 0 and all(v <= lim for v, lim
                                          in checks.values()),
           "attempted": len(reqs), "failed": failed, "metrics": metrics,
           "device": dev}
    if trace:
        dev["busy_s"] = busy_seconds(events, *window)
        dev["window_s"] = record.window_s
        out["breakdown"] = breakdown(events, spans.spans, *window)
    out["latencies_s"] = [r.seconds for r in reqs]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def _window(entry, ctx, seconds, trace):
    """The measured loop; with ``trace``, under the device trace, the
    entry's host-span hooks and its counters."""
    hooks = entry.trace_hooks() if trace else {}
    tracer = DeviceTrace(ctx.device) if trace else None
    reqs: list[Request] = []
    with patched(hooks):
        before = entry.counters() if trace else {}
        if tracer:
            tracer.start()
        i = 0
        while not reqs or time.perf_counter() - reqs[0].t0 < seconds:
            entry.prepare(i)
            t0 = time.perf_counter()
            ok, units = True, 0.0
            try:
                with ctx.spans.span("request") if trace else \
                        contextlib.nullcontext():
                    units = entry.request(i)
                    ctx.sync()
            except Exception:  # a failed request is counted, the run goes on
                traceback.print_exc(file=sys.stderr)
                ok = False
            reqs.append(Request(t0, time.perf_counter(), units, ok))
            i += 1
        ctx.sync()
        if tracer:
            tracer.stop()
        after = entry.counters() if trace else {}
    counters = {k: (v[len(before[k]):] if isinstance(v, list)
                    else v - before[k]) for k, v in after.items()}
    return reqs, (tracer.events if tracer else []), counters
