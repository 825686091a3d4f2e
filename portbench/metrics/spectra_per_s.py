"""spectra_per_s: signals encoded, transformed and read by requests that
succeeded, over the window's seconds."""

from portbench.harness.yardstick import units_per_s as read  # noqa: F401
