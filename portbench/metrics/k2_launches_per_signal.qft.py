"""k2_launches_per_signal.qft: K2 launches over the traced window (the
program's own counter), per signal."""


def read(rec):
    signals = sum(r.units for r in rec.requests if r.ok)
    if "k2_launches" not in rec.counters or not signals:
        return None
    return rec.counters["k2_launches"] / signals
