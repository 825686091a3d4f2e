"""device_idle_pct: the share of the traced window in which no device
operation ran. Read for every ``device_idle_pct.<split>`` that has no file
of its own (``.zt``, ``.qft``)."""

from portbench.harness.yardstick import busy_seconds


def read(rec):
    if not rec.events:
        return None
    return 100.0 * (1.0 - busy_seconds(rec.events, *rec.window) / rec.window_s)
