"""k2_roofline.qft: the least time the card could take for every K2 launch
of the traced window (from the program's count of launches by m, batch,
dtype and sweeps) over the device time of K2's kernels, in percent."""

from portbench.harness.yardstick import bound_s, k2_counts


def read(rec):
    shapes = rec.counters.get("k2_by_shape", {})
    device_s = sum(t1 - t0 for name, t0, t1 in rec.events if "jacobi_" in name)
    if not shapes or device_s <= 0:
        return None
    least = sum(count * bound_s(*k2_counts(*key))
                for key, count in shapes.items())
    return 100.0 * least / device_s
