"""The device trace of a traced run, and the host spans beside it.

``torch.profiler`` records the card's activity only (no host operator
events, which would cost more than the work they describe). A marker
kernel launched right after a synchronisation ties the device's clock to
the host's, so every device interval can be laid beside the benchmark's
own host spans. From both come ``busy_s``, the device operations that took
most time and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import collections
import contextlib
import sys
import time


class DeviceTrace:
    """Profile the card between :meth:`start` and :meth:`stop`; ``events``
    then holds (name, start, end) of every device operation, in
    ``time.perf_counter`` seconds."""

    def __init__(self, device):
        self.device = device
        self.events: list[tuple[str, float, float]] = []
        self._prof = None
        self._mark = 0.0

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize(self.device)
        self._mark = time.perf_counter()
        torch.empty(1, device=self.device).fill_(0)  # the marker
        torch.cuda.synchronize(self.device)

    def stop(self):
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize(self.device)
        self._prof.stop()
        # the raw events: building the profiler's own event list takes
        # minutes for the hundreds of thousands of kernels of a window
        raw = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in self._prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
        self._prof = None
        if not raw:
            return
        origin = raw[0][0]  # the marker: launched at self._mark
        self.events = [(name, self._mark + (t0 - origin) * 1e-9,
                        self._mark + (t1 - origin) * 1e-9)
                       for t0, t1, name in raw[1:]]


class HostSpans:
    """Spans on the host clock: (name, start, end), nested by time."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """Record ``name`` around the block; ``sync`` (a callable) runs
        before the end is read, so that the span covers the device work."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            self.spans.append((name, t0, time.perf_counter()))

    def wrapped(self, name: str, fn, after=None):
        """``fn`` behind a span named ``name``; ``after(result, args)``, if
        given, runs after each call. Attributes read or set on the wrapper
        are the function's own, so a function that counts its calls in an
        attribute of its own global name counts on."""
        return _Wrapped(self.spans, name, fn, after)


class _Wrapped:
    def __init__(self, spans, name, fn, after):
        object.__setattr__(self, "_w", (spans, name, fn, after))

    def __call__(self, *args, **kw):
        spans, name, fn, after = self._w
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kw)
            if after is not None:
                after(out, args)
            return out
        finally:
            spans.append((name, t0, time.perf_counter()))

    def __getattr__(self, attr):
        return getattr(self._w[2], attr)

    def __setattr__(self, attr, value):
        setattr(self._w[2], attr, value)


@contextlib.contextmanager
def patched(replacements: dict):
    """Within the block, every module of the port that holds one of the
    ``replacements``' keys (a function object) under some name holds its
    value instead, so every call through a module's global name reaches
    the replacement. Restored after."""
    done = []
    for name, module in list(sys.modules.items()):
        if not name.startswith("qilaplace_tpu_torch") or module is None:
            continue
        for attr, value in list(vars(module).items()):
            for real, repl in replacements.items():
                if value is real:
                    setattr(module, attr, repl)
                    done.append((module, attr, real))
    try:
        yield
    finally:
        for obj, attr, real in reversed(done):
            setattr(obj, attr, real)


def breakdown(events, spans, lo: float, hi: float, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of the
    card within [lo, hi] by what the host was doing: each gap is named by
    the spans that cover its middle, outermost first ("between requests"
    where none does), and the gaps of one name are summed."""
    from portbench.harness.yardstick import clip, union

    ops = collections.Counter()
    for name, t0, t1 in events:
        ops[name[:120]] += max(0.0, min(t1, hi) - max(t0, lo))
    busy = clip(union((t0, t1) for _, t0, t1 in events), lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = collections.Counter()
    ordered = sorted(spans, key=lambda s: (s[1], -s[2]))
    gaps = sorted(((a + b) / 2, b - a) for a, b in zip(edges[::2], edges[1::2])
                  if b > a)
    active, nxt = [], 0
    for mid, length in gaps:  # one sweep: spans open at each gap's middle
        while nxt < len(ordered) and ordered[nxt][1] <= mid:
            active.append(ordered[nxt])
            nxt += 1
        active = [s for s in active if s[2] >= mid]
        idle[" / ".join(s[0] for s in active) or "between requests"] += length
    return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}
