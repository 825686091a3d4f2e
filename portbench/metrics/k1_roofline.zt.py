"""k1_roofline.zt: the least time the card could take for every K1 launch
of the traced window (its operations at the float32 peak or its bytes at
the memory rate, from the rows, sites and live widths of each launch) over
the device time of K1's kernel, in percent."""

from portbench.harness.yardstick import bound_s, k1_counts


def read(rec):
    calls = rec.counters.get("k1_calls", [])
    device_s = sum(t1 - t0 for name, t0, t1 in rec.events
                   if "coefficient_batch_kernel" in name)
    if not calls or device_s <= 0:
        return None
    least = sum(bound_s(*k1_counts(B, n, widths.tolist()))
                for B, n, widths in calls)
    return 100.0 * least / device_s
