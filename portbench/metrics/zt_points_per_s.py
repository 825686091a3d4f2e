"""zt_points_per_s: z-plane points read by requests that succeeded, over the
window's seconds."""

from portbench.harness.yardstick import units_per_s as read  # noqa: F401
