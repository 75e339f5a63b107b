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
         ((40, 36, 45), (1.0, 1.0, 1.0)),   # z not a multiple of 8
         ((40, 36, 44), (0.5, 0.5, 1.0))]   # 34-tap bands in x and y


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


@pytest.mark.parametrize("dims, units", [
    ((256, 256, 256), (1.0, 1.0, 1.0)),
    ((192, 192, 192), (1.0, 1.0, 1.0)),
    ((128, 128, 128), (1.0, 1.0, 2.5)),
    ((128, 128, 128), (0.5, 0.5, 1.0)),
])
def test_blur_tiles_fit_shared_memory(dims, units):
    """For every blur make_plan makes (every octave, every level), the
    tile picker of the two blur kernels gives tiles the kernels take
    (csrc/blur.cu), no larger than the octave allows, within the 227 KB a
    block may use."""
    from sift3d_tpu_torch.ops import blur_kernel as bk
    plan = tpyr.make_plan(dims, units, TP)
    widest = 0
    for o in range(plan.num_octaves):
        nx, ny, nz = plan.octave_dims[o]
        for i in range(0 if o == 0 else 1, plan.num_gpyr_levels):
            taps = plan.first_taps if i == 0 else plan.level_taps[i]
            (wx, _), (wy, _), (wz, _) = plan.conv_diags(o, taps)
            bx, by, bz = wx.shape[1], wy.shape[1], wz.shape[1]
            widest = max(widest, bx, by, bz)
            tx, xb = bk.x_tile(nx, bx)
            ty, tz, xs, yzb = bk.yz_tile(nx, ny, nz, by, bz)
            # Tiles are whole blocks of 4 rows, at most one block past the
            # axis; tz is a warp or two.
            for t, n in ((tx, nx), (ty, ny)):
                assert t % 4 == 0 and 4 <= t < n + 4, (t, n)
            assert ty <= 32 and tz in (32, 64) and tz < 2 * max(nz, 32)
            assert 1 <= xs <= 4
            assert xb == bk.x_smem_bytes(tx, bx) <= bk.SMEM_MAX
            assert yzb == bk.yz_smem_bytes(ty, tz, by, bz) <= bk.SMEM_MAX
    assert widest == (34 if units[0] == 0.5 else 18)
