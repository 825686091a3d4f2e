"""zt_grid_p95_ms: the 95th percentile of every request's latency (one pole
search's three grids)."""

from portbench.harness.yardstick import p95


def read(rec):
    return 1e3 * p95(r.seconds for r in rec.requests)
