"""k2_roofline.zt_apply: the least time the card could take for every K2
launch of the traced window over the device time of K2's kernels, in
percent, from the same counter (``k2_by_shape``) and kernels as
k2_roofline.qft, so its reader: here the rsvd encode's and the two zip-up
applies' eigensolves of each pole search."""

from portbench.harness import spec

read = spec.load_metric("k2_roofline.qft")
