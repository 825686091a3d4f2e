"""k1_roofline.zt_apply: the least time the card could take for every K1
launch of the traced window over the device time of K1's kernel, in
percent, from the same record (``k1_calls``) and kernel as k1_roofline.zt,
so its reader: here K1's reads of the three grids of each pole search on
the zip-up's product states."""

from portbench.harness import spec

read = spec.load_metric("k1_roofline.zt")
