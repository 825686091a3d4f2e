"""device_ms_per_request.zt: milliseconds in which some device operation
ran, over the traced window, per request (one pole search's three grids)."""

from portbench.harness.yardstick import busy_seconds


def read(rec):
    if not rec.events:
        return None
    return 1e3 * busy_seconds(rec.events, *rec.window) / len(rec.requests)
