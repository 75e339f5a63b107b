"""extrema_roofline.reg: share of its roofline that the detect layer (the
extrema stencil) reached over the traced calls of the registration
cells, in percent: the least time of its work (_roofline.py) over the
summed device time of its kernels."""

from benchmark.metrics import _roofline

LAYER = "detect"
KERNELS = ("extrema_kernel",)


def read(run):
    return _roofline.share(run, LAYER, KERNELS)
