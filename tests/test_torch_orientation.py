"""Port orientation (moments, eigh3x3, R and acceptance) vs JAX."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sift3d_tpu import orientation as jori  # noqa: E402
from sift3d_tpu import pyramid as jpyr  # noqa: E402
from sift3d_tpu.params import DetectorParams as JaxParams  # noqa: E402
from sift3d_tpu.windows import window_extent  # noqa: E402
from sift3d_tpu_torch import orientation as tori  # noqa: E402
from sift3d_tpu_torch import pyramid as tpyr  # noqa: E402
from sift3d_tpu_torch.detect import detect_extrema_octave  # noqa: E402
from sift3d_tpu_torch.ops.ori_kernel import ori_moments  # noqa: E402
from sift3d_tpu_torch.params import from_jax_params  # noqa: E402

JP = JaxParams(gpyr_impl="incremental", extrema_impl="xla")
TP = from_jax_params(dataclasses.asdict(JP))


def _rel_close(got, ref, rel):
    """Per keypoint: max |got - ref| <= rel * max |ref| (f32 sums taken in
    another order)."""
    got, ref = np.asarray(got), np.asarray(ref)
    K = ref.shape[0]
    err = np.abs(got - ref).reshape(K, -1).max(axis=1)
    scale = np.abs(ref).reshape(K, -1).max(axis=1)
    assert np.all(err <= rel * scale), (err / scale).max()


def _moment_inputs(units, K=16, n=48, seed=3):
    rng = np.random.default_rng(seed)
    levels = rng.normal(size=(2, n, n, n)).astype(np.float32)
    coords = rng.integers(2, n - 2, (K, 3)).astype(np.int32)
    lvl = rng.integers(0, 2, (K,)).astype(np.int32)
    plan = jpyr.make_plan((n, n, n), units, JP)
    sd = np.asarray([plan.scales[0][1], plan.scales[0][2]], np.float32)[lvl]
    return levels, coords, lvl, sd


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.0, 1.5)])
def test_moments_match_xla_window_moments(units):
    levels, coords, lvl, sd = _moment_inputs(units)
    rad = JP.ori_sig_fctr * float(sd.max()) * JP.ori_rad_fctr
    extents = tuple(window_extent(rad / units[a], 48) for a in range(3))
    A_ref, vd_ref = jax.vmap(
        lambda co, s, lv: jori._window_moments(
            jnp.asarray(levels), co, co.astype(jnp.float32), s, units,
            extents, JP, lvl=lv))(
        jnp.asarray(coords), jnp.asarray(sd), jnp.asarray(lvl))
    fp = np.concatenate([coords.astype(np.float32), sd[:, None]], axis=1)
    A, vd = ori_moments(torch.from_numpy(levels), torch.from_numpy(lvl),
                        torch.from_numpy(fp), units, TP.ori_sig_fctr,
                        TP.ori_rad_fctr)
    _rel_close(A.numpy(), A_ref, 1e-5)
    _rel_close(vd.numpy(), vd_ref, 1e-5)


def test_moments_match_pallas_kernel_interpret():
    from sift3d_tpu.ops.ori_kernel import ori_moments_pallas
    units = (1.0, 1.0, 1.0)
    levels, coords, lvl, sd = _moment_inputs(units, K=8, seed=5)
    rad = JP.ori_sig_fctr * float(sd.max()) * JP.ori_rad_fctr
    extents = tuple(window_extent(rad, 48) for _ in range(3))
    fp = np.concatenate([coords.astype(np.float32), sd[:, None]], axis=1)
    A_ref, vd_ref = ori_moments_pallas(
        jnp.asarray(levels), jnp.asarray(lvl), jnp.asarray(coords),
        jnp.asarray(fp), extents, units, JP, interpret=True)
    A, vd = ori_moments(torch.from_numpy(levels), torch.from_numpy(lvl),
                        torch.from_numpy(fp), units, TP.ori_sig_fctr,
                        TP.ori_rad_fctr)
    _rel_close(A.numpy(), A_ref, 1e-5)
    _rel_close(vd.numpy(), vd_ref, 1e-5)


def test_eigh3x3_matches_jax_including_degenerate_and_nan():
    rng = np.random.default_rng(8)
    M = rng.normal(size=(32, 3, 3)).astype(np.float32)
    A = np.einsum("kij,klj->kil", M, M)
    A = np.concatenate([
        A,
        np.eye(3, dtype=np.float32)[None],                      # degenerate
        np.diag([1.0, 1.0, 2.0]).astype(np.float32)[None],      # repeated
        np.zeros((1, 3, 3), np.float32),                        # zero
        np.full((1, 3, 3), np.nan, np.float32),                 # NaN
    ])
    w_ref, V_ref = jori.eigh3x3(jnp.asarray(A))
    w, V = tori.eigh3x3(torch.from_numpy(A))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-6,
                               atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(V.numpy(), np.asarray(V_ref), rtol=1e-6,
                               atol=1e-6, equal_nan=True)
    assert np.all(np.diff(w.numpy()[:-1], axis=1) >= 0)   # ascending


@pytest.fixture(scope="module")
def octave_candidates():
    """Octave-0 candidates of the 64^3 phantom, from the port's pyramid
    (bit-identical to the JAX one, test_torch_pyramid)."""
    from conftest import make_phantom
    vol = make_phantom(64)
    out = {}
    for units in [(1.0, 1.0, 1.0), (1.0, 1.0, 1.5)]:
        plan = tpyr.make_plan(vol.shape, units, TP)
        g, d, m = tpyr.build_gpyr_and_dog(
            tpyr.scale_to_unit(torch.from_numpy(vol)), plan)
        cand = detect_extrema_octave(d[0], m[0], TP)
        out[units] = (plan, g[0], cand)
    return out


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.0, 1.5)])
def test_assign_orientations_match_jax(octave_candidates, units):
    plan, gp, cand = octave_candidates[units]
    nl = TP.num_kp_levels
    scales = np.asarray(plan.scales[0][1:1 + nl], np.float32)
    lvl = cand.level.numpy()
    K = len(lvl)
    assert K > 8
    got = tori.assign_orientations(
        gp[1:1 + nl], cand.level, cand.coords,
        torch.from_numpy(scales[lvl]), units, TP)
    ref = jori.assign_orientations(
        jnp.asarray(gp[1:1 + nl].numpy()),
        jnp.asarray(cand.coords.numpy().astype(np.int32)),
        jnp.ones((K,), bool), jnp.asarray(scales[lvl]), units, JP,
        sd_max=float(scales.max()),
        level_index=jnp.asarray(lvl.astype(np.int32)),
        fractional_centers=False)
    acc = np.asarray(ref.accepted)
    assert 0 < acc.sum() < K
    assert np.array_equal(got.accepted.numpy(), acc)
    for name in ("reject_grad", "reject_ratio", "reject_corner"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    assert np.abs(got.R.numpy()[acc] - np.asarray(ref.R)[acc]).max() <= 1e-5
