"""expand_topr_roofline.stacked: the fused stage-1 kernel's share of its
roofline in the stacked searcher, read as ``expand_topr_roofline`` is."""

from hnswbench import spec

_base = spec.module("metrics", "expand_topr_roofline")
before, after, read = _base.before, _base.after, _base.read
