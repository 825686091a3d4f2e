"""device_ms_per_request.zt_apply: milliseconds in which some device
operation ran, over the traced window, per request (one rsvd encode and
one pole search on the apply readout), as device_ms_per_request.zt reads
it, so its reader."""

from portbench.harness import spec

read = spec.load_metric("device_ms_per_request.zt")
