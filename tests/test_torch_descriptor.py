"""Port descriptors vs the JAX XLA path, on the JAX pyramid.

The JAX pyramid enters the port through SIFT3D.load_pyramid, so these
tests hold the window prep, the histogram and the normalization alone.
On the CPU ops.desc_kernel.desc_fused runs its plain version (prep_windows
+ desc_hist_plain), the spec that the fused CUDA kernel is held to on the
card (test_torch_cuda)."""

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
from sift3d_tpu_torch.ops import desc_kernel as tdk  # noqa: E402
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
        got = tdk.desc_fused(
            torch.from_numpy(lv), torch.from_numpy(kp.level.astype(np.int64)),
            torch.from_numpy(kp.coords.astype(np.float32)),
            torch.from_numpy(kp.R), torch.from_numpy(kp.sd.astype(np.float32)),
            lu, TP, sd_max).numpy().reshape(-1, 64, 12)
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


def _box_and_window(dims, units, params, sd, centers):
    """The fused kernel's loop-bound box (csrc/desc.cu, the f32 arithmetic
    of prep_windows) and the plain version's window interior, per
    keypoint: i64[K, 3] each of lo, hi, interior lo, interior hi."""
    from sift3d_tpu_torch.windows import window_starts
    sd_max = float(sd.max())
    extents = tdk.window_extents(sd_max, units, dims, params)
    sigma = sd * float(np.float32(params.desc_sig_fctr))
    win_radius = sigma * float(np.float32(params.desc_rad_fctr))
    lo, hi = [], []
    for a in range(3):
        ra = win_radius / torch.tensor(np.float32(units[a]))
        c = centers[:, a]
        lo.append(torch.clamp(torch.floor(c - ra), min=1.0).long())
        hi.append(torch.clamp(torch.ceil(c + ra), max=float(dims[a] - 2))
                  .long())
    start = window_starts(centers.long(), extents, dims)
    return (torch.stack(lo, 1), torch.stack(hi, 1), start + 1,
            start + torch.tensor(extents) - 2)


@pytest.mark.parametrize("size, units", [(256, (1.0, 1.0, 1.0)),
                                         (192, (1.0, 1.0, 1.0)),
                                         (128, (1.0, 1.0, 1.5)),
                                         (64, (0.7, 1.0, 1.3))])
def test_loop_bound_box_lies_inside_window_interior(size, units):
    """The fused kernel walks each keypoint's loop-bound box; the plain
    version sees only the voxels of its gathered window. Every box lies in
    its window's interior, at every level of every octave, for centers on
    and next to the borders (where the window's start is clipped) and in
    the middle, so both walk the same voxels."""
    plan = jpyr.make_plan((size, size, size), units, JP)
    nl = JP.num_kp_levels
    for o in range(plan.num_octaves):
        dims = plan.octave_dims[o]
        lu = plan.level_units(o)
        pos = [sorted({0, 1, 2, 3, n // 3, n // 2, n - 4, n - 3, n - 2,
                       n - 1}) for n in dims]
        grid = np.stack(np.meshgrid(*pos, indexing="ij"), -1).reshape(-1, 3)
        for lv in range(nl):
            sd = torch.full((len(grid),), np.float32(plan.scales[o][lv + 1]))
            sd[0] = float(np.float32(plan.scales[o][nl]))   # sizes windows
            lo, hi, ilo, ihi = _box_and_window(
                dims, lu, TP, sd, torch.from_numpy(grid.astype(np.float32)))
            assert bool((lo >= ilo).all()) and bool((hi <= ihi).all()), \
                (o, lv)
