"""Port pyramid (plain blur chain + DoG + dogmax) vs the JAX reference.

The JAX side runs the reference's sequential program order eagerly
(build_gpyr_incremental + build_dog), op by op, so its arithmetic is the
multiply-then-add of pyramid._diag_pass; the port must match it bit for
bit."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sift3d_tpu import pyramid as jpyr  # noqa: E402
from sift3d_tpu.params import DetectorParams as JaxParams  # noqa: E402
from sift3d_tpu_torch import pyramid as tpyr  # noqa: E402
from sift3d_tpu_torch.params import from_jax_params  # noqa: E402

JP = JaxParams(gpyr_impl="incremental", extrema_impl="xla")
TP = from_jax_params(dataclasses.asdict(JP))

CASES = [((48, 40, 36), (1.0, 1.0, 1.0)),
         ((48, 40, 36), (1.0, 1.0, 1.5)),
         ((40, 36, 45), (1.0, 1.0, 1.0))]   # z not a multiple of 8


@pytest.mark.parametrize("shape, units", CASES)
def test_plan_matches_jax(shape, units):
    jp = jpyr.make_plan(shape, units, JP)
    tp = tpyr.make_plan(shape, units, TP)
    assert tp.octave_dims == jp.octave_dims
    assert tp.scales == jp.scales
    assert tp.first_taps == jp.first_taps
    assert tp.level_taps == jp.level_taps
    for o in range(tp.num_octaves):
        for i in range(1, tp.num_gpyr_levels):
            for (wa, la), (wb, lb) in zip(jp.conv_diags(o, jp.level_taps[i]),
                                          tp.conv_diags(o, tp.level_taps[i])):
                assert la == lb and np.array_equal(wa, wb)


@pytest.mark.parametrize("shape, units", CASES)
def test_gpyr_dog_bit_exact_vs_jax(shape, units):
    vol = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    jplan = jpyr.make_plan(shape, units, JP)
    x = jpyr.scale_to_unit(jnp.asarray(vol))
    jg = jpyr.build_gpyr_incremental(x, jplan)
    jd = jpyr.build_dog(jg)

    tplan = tpyr.make_plan(shape, units, TP)
    tx = tpyr.scale_to_unit(torch.from_numpy(vol))
    assert np.array_equal(tx.numpy(), np.asarray(x))
    tg, td, tm = tpyr.build_gpyr_and_dog(tx, tplan)
    assert len(tg) == jplan.num_octaves
    for o in range(jplan.num_octaves):
        assert np.array_equal(tg[o].numpy(), np.asarray(jg[o])), o
        assert np.array_equal(td[o].numpy(), np.asarray(jd[o])), o
        assert np.array_equal(
            tm[o].numpy(), np.abs(np.asarray(jd[o])).max(axis=(1, 2, 3))), o


def test_downsample_and_scale_match_jax():
    vol = np.random.default_rng(2).standard_normal((17, 12, 9)) \
        .astype(np.float32)
    assert np.array_equal(tpyr.downsample_2x(torch.from_numpy(vol)).numpy(),
                          np.asarray(jpyr.downsample_2x(jnp.asarray(vol))))
    zero = torch.zeros((8, 8, 8))
    assert torch.equal(tpyr.scale_to_unit(zero), zero)


def test_axis_pass_plain_matches_dense_matrix():
    """The banded pass equals the dense operator of filters.conv_matrix
    (f64 reference, f32 tolerance)."""
    from sift3d_tpu.filters import conv_matrix
    from sift3d_tpu_torch.filters import conv_diagonals
    from sift3d_tpu_torch.ops.blur_kernel import axis_pass_plain
    rng = np.random.default_rng(5)
    vol = rng.standard_normal((20, 18, 22)).astype(np.float32)
    taps = np.asarray(tpyr.make_plan((20, 18, 22), (1, 1, 1), TP)
                      .level_taps[3], np.float32)
    for axis in range(3):
        n = vol.shape[axis]
        wd, lo = conv_diagonals(n, taps, 0.5)
        out = axis_pass_plain(torch.from_numpy(vol), torch.from_numpy(wd),
                              lo, axis).numpy()
        W = conv_matrix(n, taps, 0.5).astype(np.float64)
        ref = np.moveaxis(np.tensordot(W, np.moveaxis(vol, axis, 0), 1),
                          0, axis)
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)
