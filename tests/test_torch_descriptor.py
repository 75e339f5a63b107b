"""Port descriptors vs the JAX XLA path, on the JAX pyramid.

The JAX pyramid enters the port through SIFT3D.load_pyramid, so these
tests hold the window prep, the histogram and the normalization alone."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from conftest import make_phantom  # noqa: E402

from sift3d_tpu import descriptor as jdesc  # noqa: E402
from sift3d_tpu import pyramid as jpyr  # noqa: E402
from sift3d_tpu.params import DetectorParams as JaxParams  # noqa: E402
from sift3d_tpu.windows import window_extent  # noqa: E402
from sift3d_tpu_torch import SIFT3D, Keypoints  # noqa: E402
from sift3d_tpu_torch.descriptor import prep_windows  # noqa: E402
from sift3d_tpu_torch.ops.desc_kernel import desc_hist  # noqa: E402
from sift3d_tpu_torch.params import from_jax_params  # noqa: E402

JP = JaxParams(gpyr_impl="incremental", extrema_impl="xla")
TP = from_jax_params(dataclasses.asdict(JP))
UNITS = [(1.0, 1.0, 1.0), (1.0, 1.0, 1.5)]


def _rel_l2(got, ref):
    """Relative L2 error; an all-zero reference (a keypoint in a flat
    region) must be matched by zeros."""
    nrm = np.linalg.norm(ref)
    diff = np.linalg.norm(got - ref)
    return diff / nrm if nrm > 0 else diff


def _rotations(rng, K):
    Q, Rr = np.linalg.qr(rng.normal(size=(K, 3, 3)))
    Q = Q * np.sign(np.diagonal(Rr, axis1=1, axis2=2))[:, None, :]
    Q[np.linalg.det(Q) < 0, :, 2] *= -1
    return Q.astype(np.float32)


@pytest.fixture(scope="module", params=UNITS)
def case(request):
    """JAX pyramid of the 64^3 phantom and 12 keypoints per octave at
    random voxels of the central region, levels and orientations."""
    units = request.param
    vol = make_phantom(64)
    plan = jpyr.make_plan(vol.shape, units, JP)
    gpyr = [np.asarray(g) for g in jpyr.build_gpyr_incremental(
        jpyr.scale_to_unit(jnp.asarray(vol)), plan)]
    rng = np.random.default_rng(17)
    nl = JP.num_kp_levels
    kps = []
    for o in range(2):
        n = plan.octave_dims[o]
        K = 12
        coords = np.stack([rng.integers(n[a] // 5, n[a] - n[a] // 5, K)
                           for a in range(3)],
                          axis=1).astype(np.float64)
        lvl = rng.integers(0, nl, K).astype(np.int32)
        sd = np.asarray(plan.scales[o], np.float64)[lvl + 1]
        kps.append(Keypoints(coords=coords, octave=np.full(K, o, np.int32),
                             level=lvl, sd=sd, strength=np.ones(K),
                             R=_rotations(rng, K)))
    return units, plan, gpyr, kps


def test_histograms_match_xla_extract_one(case):
    units, plan, gpyr, kps = case
    nl = JP.num_kp_levels
    for o, kp in enumerate(kps):
        lv = gpyr[o][1:1 + nl]
        lu = plan.level_units(o)
        sd_max = plan.scales[o][nl]
        rad = jdesc._level_radius(sd_max, JP)
        extents = tuple(window_extent(rad / lu[a], lv.shape[1 + a])
                        for a in range(3))
        coords = kp.coords.astype(np.int64)
        grot, vbins = prep_windows(
            torch.from_numpy(lv), torch.from_numpy(kp.level.astype(np.int64)),
            torch.from_numpy(coords),
            torch.from_numpy(kp.coords.astype(np.float32)),
            torch.from_numpy(kp.R), torch.from_numpy(kp.sd.astype(np.float32)),
            lu, extents, TP)
        got = desc_hist(grot, vbins, TP.bary_eps).numpy().reshape(-1, 64, 12)
        for k in range(len(kp)):
            ref = np.asarray(jdesc._extract_one(
                jnp.asarray(lv), jnp.asarray(coords[k].astype(np.int32)),
                jnp.asarray(kp.coords[k].astype(np.float32)),
                jnp.asarray(kp.R[k]), jnp.float32(kp.sd[k]), lu, extents,
                65536, JP, lvl=jnp.int32(kp.level[k])))
            assert _rel_l2(got[k], ref) <= 1e-5, (o, k)


def test_descriptors_match_xla_path_through_load_pyramid(case):
    units, plan, gpyr, kps = case
    nl = JP.num_kp_levels
    det = SIFT3D(TP, "cpu")
    det.load_pyramid(gpyr, plan.input_dims, units)
    for o, kp in enumerate(kps):
        got = det.extract_descriptors(kp)
        K = len(kp)
        ref = jdesc.extract_descriptors(
            jnp.asarray(gpyr[o][1:1 + nl]),
            jnp.asarray(kp.coords.astype(np.int32)), jnp.asarray(kp.R),
            jnp.ones((K,), bool), jnp.asarray(kp.sd.astype(np.float32)), o,
            plan.level_units(o), JP,
            centers=jnp.asarray(kp.coords.astype(np.float32)),
            sd_max=plan.scales[o][nl], use_pallas=False,
            level_index=jnp.asarray(kp.level), fractional_centers=False)
        rd = np.asarray(ref.desc)
        err = [_rel_l2(a, b) for a, b in zip(got.data, rd)]
        assert max(err) <= 1e-5, err
        assert np.array_equal(got.xyz, np.asarray(ref.xyz))
        assert np.array_equal(got.sd, np.asarray(ref.sd))


def test_load_pyramid_rejects_wrong_shapes(case):
    units, plan, gpyr, _ = case
    det = SIFT3D(TP, "cpu")
    with pytest.raises(ValueError):
        det.load_pyramid([g[:, :-1] for g in gpyr], plan.input_dims, units)
