"""The roofline yardstick counts work from shapes and counts alone."""

import math
import types

import numpy as np
import pytest

from benchmark.checks import _sift3d
from benchmark.metrics import _roofline
from benchmark.reference import sift3d_plain as ref

CONFIG = {"units": [1.0, 1.0, 1.0], "detector": {}}


def test_bound_is_the_larger_of_bytes_and_operations():
    assert _roofline.bound(3.35e12, 0) == pytest.approx(1.0)
    assert _roofline.bound(0, 67e12) == pytest.approx(1.0)
    assert _roofline.bound(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_pyramid_work_from_the_shape_alone():
    plan = _sift3d.plan_for(CONFIG, 64)
    nbytes, ops = _roofline.pyramid_work(plan)
    L = plan.levels
    vox = [64 ** 3 / 8 ** o for o in range(len(plan.octave_dims))]
    # Octave 0 blurs L levels (the first without a DoG), deeper octaves
    # L - 1 levels, each with its DoG.
    want = 8 * vox[0] * L + 4 * vox[0] * (L - 1) + sum(
        12 * v * (L - 1) for v in vox[1:])
    assert nbytes == pytest.approx(want)
    assert ops > 2 * 3 * 3 * sum(vox)
    assert _roofline.pyramid_work(_sift3d.plan_for(CONFIG, 64)) == \
        (nbytes, ops)


def test_extrema_work_from_counts():
    plan = _sift3d.plan_for(CONFIG, 32)
    nl = plan.params.num_kp_levels
    cands = [(np.zeros((5, 3)), np.zeros(5, int)),
             (np.zeros((2, 3)), np.zeros(2, int))]
    nbytes, ops = _roofline.extrema_work(plan, cands)
    assert nbytes == 4 * nl * (32 ** 3 + 16 ** 3) + 8 * 7
    assert ops == 2 * nl * (32 ** 3 + 16 ** 3) + 16 * 7


def test_window_work_from_coordinates_and_scales():
    plan = _sift3d.plan_for(CONFIG, 64)
    coords = np.array([[32, 32, 32], [1, 1, 1]])
    cands = [(coords, np.array([0, 2]))]
    b1, o1 = _roofline.orientation_work(plan, cands)
    b2, o2 = _roofline.orientation_work(plan, [(coords[:1], np.array([0]))])
    assert 0 < b2 < b1 and 0 < o2 < o1          # the edge clips the box
    kp = types.SimpleNamespace(coords=coords.astype(float),
                               octave=np.array([0, 0]),
                               sd=np.array([1.6, 1.6]))
    nb, ops = _roofline.descriptor_work(plan, kp)
    assert nb > 2 * 4 * 768 and ops > 0
    empty = types.SimpleNamespace(coords=np.zeros((0, 3)),
                                  octave=np.zeros(0, int), sd=np.zeros(0))
    assert _roofline.descriptor_work(plan, empty) == (0.0, 0.0)


def test_sphere_cube_fraction_matches_a_grid_count():
    g = (np.arange(200) + 0.5) / 100 - 1            # cell centres in [-1, 1]
    x, y, z = np.meshgrid(g, g, g, indexing="ij", sparse=True)
    a = 1 / math.sqrt(2)
    inside = ((x * x + y * y + z * z <= 1) & (abs(x) <= a) & (abs(y) <= a)
              & (abs(z) <= a))
    assert _roofline.sphere_cube_fraction() == pytest.approx(inside.mean(),
                                                             rel=1e-2)


def test_share_reads_nothing_without_the_kernels():
    run = types.SimpleNamespace(trace={"kernel_s": {"other": 1.0}},
                                work={"pyramid": (3.35e12, 0.0)})
    assert _roofline.share(run, "pyramid", ("blur_x_kernel",)) is None
    run.trace["kernel_s"]["blur_x_kernel"] = 2.0
    assert _roofline.share(run, "pyramid", ("blur_x_kernel",)) == \
        pytest.approx(50.0)
    assert _roofline.share(types.SimpleNamespace(trace=None, work=None),
                           "pyramid", ("blur_x_kernel",)) is None


def test_reference_plan_bands_are_shapes_only():
    plan = ref.make_plan((40, 40, 40), (1, 1, 1), ref.Params())
    assert set(plan.bands) == {(0, i) for i in range(plan.levels)} | {
        (o, i) for o in range(1, len(plan.octave_dims))
        for i in range(1, plan.levels)}
