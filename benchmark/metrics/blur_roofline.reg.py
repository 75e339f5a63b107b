"""blur_roofline.reg: share of its roofline that the pyramid layer (the
blur levels and the DoG) reached over the traced calls of the
registration cells, in percent: the least time of its work
(_roofline.py) over the summed device time of its kernels."""

from benchmark.metrics import _roofline

LAYER = "pyramid"
KERNELS = ("blur_x_kernel", "blur_yz_dog_kernel",)


def read(run):
    return _roofline.share(run, LAYER, KERNELS)
