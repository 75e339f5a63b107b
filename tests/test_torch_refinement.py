"""The port's subvoxel refinement and Hessian edge rejection vs JAX, and
the orientation and descriptor paths with fractional centers.

In-process tests hold each module's plain PyTorch version (what the CUDA
wrappers take on a CPU tensor) to the JAX XLA path on numpy-seeded inputs:
the refinement core within 1e-6 abs (offsets, ds) with identical edge
decisions, a singular Hessian included; orientation with identical
predicates, A/vd rel 1e-5 and R 1e-5; descriptors rel-L2 1e-5. The end-to-
end test runs the JAX SIFT3D in a child process with XLA:CPU capped at
SSE4.2, as tests/test_torch_pipeline.py does, and holds the port's refined
detect + describe of the 64^3 phantom to it."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import make_phantom  # noqa: E402

from sift3d_tpu import descriptor as jdesc  # noqa: E402
from sift3d_tpu import orientation as jori  # noqa: E402
from sift3d_tpu import refinement as jref  # noqa: E402
from sift3d_tpu.params import DetectorParams as JaxParams  # noqa: E402
from sift3d_tpu.windows import window_extent  # noqa: E402
from sift3d_tpu_torch import SIFT3D, Volume, from_jax_params  # noqa: E402
from sift3d_tpu_torch import descriptor as tdesc  # noqa: E402
from sift3d_tpu_torch import orientation as tori  # noqa: E402
from sift3d_tpu_torch import pyramid as tpyr  # noqa: E402
from sift3d_tpu_torch import refinement as tref  # noqa: E402
from sift3d_tpu_torch.detect import detect_extrema_octave  # noqa: E402
from sift3d_tpu_torch.ops import ori_kernel as tok  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
BASE = dict(gpyr_impl="incremental", extrema_impl="xla")
JP = JaxParams(**BASE)
TP = from_jax_params(dataclasses.asdict(JP))
# The refined configuration of tests/test_refinement.py:63-85.
REFINED = dict(refine_subvoxel=True, edge_thresh=10.0)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The port's CPU work here on two threads, restored afterwards: the
    suite runs six test files at once on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _params(**kw):
    jp = JaxParams(**BASE, **kw)
    return jp, from_jax_params(dataclasses.asdict(jp))


def _neighbourhoods(K=256, seed=21):
    """K neighbourhoods f32[K, 3, 3, 3], each a candidate's: a strict
    extremum of its 26 neighbours. Three quarters are DoG-like peaks and
    troughs (a quadratic bowl off centre plus noise), a quarter noise with
    the centre moved past every neighbour; at the end three with a
    Hessian that is exactly singular in f32 after the 1e-12 I (rank 2,
    rank 1) or flat. Also the level triple's centres dp, dn and a valid
    mask."""
    rng = np.random.default_rng(seed)
    x = np.arange(3.0) - 1.0
    X = np.stack(np.meshgrid(x, x, x, indexing="ij"))       # [3, 3, 3, 3]
    curv = rng.uniform(0.1, 0.5, (K, 3, 1, 1, 1))
    ctr = rng.uniform(-0.6, 0.6, (K, 3, 1, 1, 1))
    sgn = rng.choice([-1.0, 1.0], (K, 1, 1, 1))
    nb = sgn * (1.0 - (curv * (X[None] - ctr) ** 2).sum(axis=1))
    nb += rng.normal(0.0, 0.02, nb.shape)
    noise = rng.normal(size=(K // 4, 3, 3, 3))
    noise[:, 1, 1, 1] = np.abs(noise).reshape(K // 4, -1).max(axis=1) + 0.1
    nb[:K // 4] = noise * sgn[:K // 4]
    # Hessians [[1,1,0],[1,1,0],[0,0,1]] and [[1,1,0],[1,1,0],[0,0,0]]
    # (1e-12 I vanishes against 1), gradient (0.25, 0, 0.25), and a flat
    # neighbourhood. Every value is exact in f32.
    nb[-3:] = 0.0
    for k, (zp, zm) in ((K - 2, (0.75, 0.25)), (K - 1, (0.25, -0.25))):
        nb[k, 2, 1, 1], nb[k, 0, 1, 1] = 0.75, 0.25    # hxx = 1
        nb[k, 1, 2, 1] = nb[k, 1, 0, 1] = 0.5          # hyy = 1
        nb[k, 2, 2, 1] = nb[k, 0, 0, 1] = 2.0          # hxy = 1
        nb[k, 1, 1, 2], nb[k, 1, 1, 0] = zp, zm        # hzz = 1, 0
    nb = nb.astype(np.float32)
    c0 = nb[:, 1, 1, 1]
    dp = (c0 * rng.uniform(0.6, 1.0, K)).astype(np.float32)
    dn = (c0 * rng.uniform(0.6, 1.0, K)).astype(np.float32)
    dn[-1] = dp[-1] = c0[-1]                  # flat along scale: hss = 0
    valid = rng.random(K) < 0.9
    valid[-3:] = True
    return nb, dp, dn, valid


@pytest.mark.parametrize("ext", [dict(refine_subvoxel=True, edge_thresh=10.0),
                                 dict(refine_subvoxel=True),
                                 dict(edge_thresh=4.0),
                                 dict()])
def test_refine_core_matches_jax(ext):
    jp, tp = _params(**ext)
    nb, dp, dn, valid = _neighbourhoods()
    ref = jref._refine_core(jnp.asarray(nb), jnp.asarray(dp), jnp.asarray(dn),
                            jnp.asarray(valid), jp)
    got = tref._refine_core(torch.from_numpy(nb), torch.from_numpy(dp),
                            torch.from_numpy(dn), torch.from_numpy(valid), tp)
    np.testing.assert_allclose(got.offset.numpy(), np.asarray(ref.offset),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.ds.numpy(), np.asarray(ref.ds), rtol=0,
                               atol=1e-6)
    assert np.array_equal(got.edge_ok.numpy(), np.asarray(ref.edge_ok))
    if "edge_thresh" in ext:
        assert 0 < int(got.edge_ok.sum()) < len(valid)
    if ext.get("refine_subvoxel"):
        # The singular systems end as JAX's nan_to_num + clip leaves them.
        _, H = tref.derivatives(torch.from_numpy(nb[-3:]))
        info = torch.linalg.lu_factor_ex(H + 1e-12 * torch.eye(3)).info
        assert info.tolist()[1:] == [2, 2]
        off = got.offset.numpy()
        assert np.all(np.abs(off) <= 1.0) and np.abs(off[-2:]).max() == 1.0


def test_refine_candidates_octave_matches_jax():
    """Neighbourhood gathers from a seeded 32^3 DoG stack around candidates
    on every keypoint level, the outermost interior voxels included."""
    jp, tp = _params(refine_subvoxel=True, edge_thresh=10.0)
    rng = np.random.default_rng(5)
    dog = rng.normal(size=(5, 32, 32, 32)).astype(np.float32)
    K = 96
    coords = rng.integers(1, 31, (K, 3))
    coords[:6] = [[1, 1, 1], [30, 30, 30], [1, 30, 15], [30, 1, 2],
                  [15, 15, 1], [2, 29, 30]]
    lvl = rng.integers(0, 3, K)
    valid = rng.random(K) < 0.8
    ref = jref.refine_candidates_octave(
        jnp.asarray(dog), jnp.asarray(coords.astype(np.int32)),
        jnp.asarray(lvl.astype(np.int32)), jnp.asarray(valid), jp)
    got = tref.refine_candidates_octave(
        torch.from_numpy(dog), torch.from_numpy(coords),
        torch.from_numpy(lvl), tp, torch.from_numpy(valid))
    np.testing.assert_allclose(got.offset.numpy(), np.asarray(ref.offset),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.ds.numpy(), np.asarray(ref.ds), rtol=0,
                               atol=1e-6)
    assert np.array_equal(got.edge_ok.numpy(), np.asarray(ref.edge_ok))


@pytest.fixture(scope="module")
def fractional_keypoints():
    """16 of the octave-0 candidates of the 64^3 phantom (the port's
    pyramid, bit-identical to the JAX one) at units 1 and (1, 1, 1.5),
    those that the integer-center orientation accepts first, moved by
    seeded offsets in [-1, 1] and with scales times 2^(ds / nl), ds in
    [-1, 1]."""
    vol = make_phantom(64)
    nl = TP.num_kp_levels
    out = {}
    for units in [(1.0, 1.0, 1.0), (1.0, 1.0, 1.5)]:
        plan = tpyr.make_plan(vol.shape, units, TP)
        g, d, m = tpyr.build_gpyr_and_dog(
            tpyr.scale_to_unit(torch.from_numpy(vol)), plan)
        cand = detect_extrema_octave(d[0], m[0], TP)
        scales = torch.tensor(plan.scales[0][1:1 + nl], dtype=torch.float32)
        acc = tori.assign_orientations(g[0][1:1 + nl], cand.level,
                                       cand.coords, scales[cand.level],
                                       units, TP).accepted
        pick = torch.argsort((~acc).to(torch.int8), stable=True)[:16]
        cand = cand._replace(coords=cand.coords[pick], level=cand.level[pick],
                             strength=cand.strength[pick])
        K = len(pick)
        rng = np.random.default_rng(31)
        off = rng.uniform(-1, 1, (K, 3)).astype(np.float32)
        ds = rng.uniform(-1, 1, K).astype(np.float32)
        sd = scales[cand.level] * torch.exp2(torch.from_numpy(ds) / nl)
        centers = cand.coords.to(torch.float32) + torch.from_numpy(off)
        out[units] = (plan, g[0][1:1 + nl], cand, centers, sd,
                      plan.scales[0][nl] * 2.0 ** (1.0 / nl))
    return out


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.0, 1.5)])
def test_orientation_fractional_matches_jax(fractional_keypoints, units):
    plan, levels, cand, centers, sd, sd_max = fractional_keypoints[units]
    K = len(sd)
    assert K > 8
    lvl = cand.level.numpy().astype(np.int32)
    anchors = cand.coords.numpy().astype(np.int32)
    got = tori.assign_orientations(levels, cand.level, cand.coords, sd,
                                   units, TP, centers=centers, sd_max=sd_max,
                                   fractional=True)
    ref = jori.assign_orientations(
        jnp.asarray(levels.numpy()), jnp.asarray(anchors),
        jnp.ones((K,), bool), jnp.asarray(sd.numpy()), units, JP,
        centers=jnp.asarray(centers.numpy()), sd_max=sd_max,
        level_index=jnp.asarray(lvl), fractional_centers=True,
        use_pallas=False)
    acc = np.asarray(ref.accepted)
    assert 0 < acc.sum() < K
    for name in ("accepted", "reject_grad", "reject_ratio", "reject_corner"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    assert np.abs(got.R.numpy()[acc] - np.asarray(ref.R)[acc]).max() <= 1e-5

    # The moments themselves, against the JAX window sums.
    rad = JP.ori_sig_fctr * sd_max * JP.ori_rad_fctr
    extents = tuple(window_extent(rad / units[a], levels.shape[1 + a], 4)
                    for a in range(3))
    A_ref, vd_ref = jax.vmap(
        lambda co, c, s, lv: jori._window_moments(
            jnp.asarray(levels.numpy()), co, c, s, units, extents, JP,
            lvl=lv))(jnp.asarray(anchors), jnp.asarray(centers.numpy()),
                     jnp.asarray(sd.numpy()), jnp.asarray(lvl))
    o = tok.orient(levels, cand.level, cand.coords, sd, units, TP,
                   centers=centers, sd_max=sd_max, fractional=True)
    for a, b in ((o.A.numpy(), np.asarray(A_ref)),
                 (o.vd.numpy(), np.asarray(vd_ref))):
        err = np.abs(a - b).reshape(K, -1).max(axis=1)
        scale = np.abs(b).reshape(K, -1).max(axis=1)
        assert np.all(err <= 1e-5 * scale), (err / scale).max()


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.0, 1.5)])
def test_descriptors_fractional_match_jax(fractional_keypoints, units):
    plan, levels, cand, centers, sd, sd_max = fractional_keypoints[units]
    K = len(sd)
    rng = np.random.default_rng(41)
    Q, Rr = np.linalg.qr(rng.normal(size=(K, 3, 3)))
    Q = (Q * np.sign(np.diagonal(Rr, axis1=1, axis2=2))[:, None, :]) \
        .astype(np.float32)
    hist, xyz = tdesc.octave_histograms(
        levels, cand.level, centers, torch.from_numpy(Q), sd, 0, units, TP,
        sd_max, fractional=True)
    desc = tdesc.normalize(hist, TP)
    ref = jdesc.extract_descriptors(
        jnp.asarray(levels.numpy()),
        jnp.asarray(np.rint(centers.numpy()).astype(np.int32)),
        jnp.asarray(Q), jnp.ones((K,), bool), jnp.asarray(sd.numpy()), 0,
        units, JP, centers=jnp.asarray(centers.numpy()), sd_max=sd_max,
        use_pallas=False, level_index=jnp.asarray(cand.level.numpy()
                                                  .astype(np.int32)),
        fractional_centers=True)
    rd = np.asarray(ref.desc)
    nrm = np.linalg.norm(rd, axis=1)
    assert np.all(nrm > 0)
    err = np.linalg.norm(desc.numpy() - rd, axis=1) / nrm
    assert err.max() <= 1e-5, err.max()
    assert np.array_equal(xyz.numpy(), np.asarray(ref.xyz))


_CHILD = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tests")
from conftest import make_phantom
from sift3d_tpu import DetectorParams, SIFT3D
cfg = json.loads(sys.argv[1])
det = SIFT3D(DetectorParams(**cfg["params"]))
kp = det.detect_keypoints(make_phantom(64))
d = det.extract_descriptors(kp)
np.savez(cfg["out"], coords=kp.coords, octave=kp.octave, level=kp.level,
         sd=kp.sd, strength=kp.strength, R=kp.R, desc=d.data, xyz=d.xyz,
         dsd=d.sd)
"""


@pytest.fixture(scope="module")
def jax_refined(tmp_path_factory):
    """JAX keypoints and descriptors of the 64^3 phantom, refined, from a
    child process."""
    out = tmp_path_factory.mktemp("jax_refined") / "refined.npz"
    cfg = dict(params=dict(BASE, **REFINED), out=str(out))
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=SSE4_2").strip())
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(cfg)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    return out


def test_refined_sift3d_matches_jax(jax_refined):
    """Same rows, order, octave and level; coords within 1e-5 abs, sd 1e-6
    rel, strength exact (the true strengths); R 1e-5; every descriptor
    within 1% rel-L2."""
    ref = np.load(jax_refined)
    _, tp = _params(**REFINED)
    det = SIFT3D(tp, "cpu")
    kp = det.detect_keypoints(Volume.from_array(make_phantom(64)))
    assert len(kp) == len(ref["coords"]) > 0
    assert np.array_equal(kp.octave, ref["octave"])
    assert np.array_equal(kp.level, ref["level"])
    assert np.abs(kp.coords - ref["coords"]).max() <= 1e-5
    assert np.any(kp.coords != np.rint(kp.coords))
    assert np.all(np.abs(kp.sd - ref["sd"]) <= 1e-6 * ref["sd"])
    assert np.array_equal(kp.strength, ref["strength"])
    assert np.abs(kp.R - ref["R"]).max() <= 1e-5
    d = det.extract_descriptors(kp)
    err = (np.linalg.norm(d.data - ref["desc"], axis=1)
           / np.linalg.norm(ref["desc"], axis=1))
    assert np.all(err <= 0.01), err.max()
    np.testing.assert_allclose(d.xyz, ref["xyz"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(d.sd, ref["dsd"], rtol=1e-6)


def test_edge_only_keeps_default_keypoints_that_pass_the_edge_test():
    """Edge rejection alone (as the JAX package runs it: orientation
    windows with the fractional margin, integer centers, descriptor
    windows without) keeps exactly the default configuration's keypoints
    whose Hessian passes, with their true strengths, R within 1e-5 and the
    same descriptors."""
    vol = Volume.from_array(make_phantom(64))
    _, tp = _params(edge_thresh=4.0)
    det = SIFT3D(tp, "cpu")
    kp = det.detect_keypoints(vol)
    base = SIFT3D(TP, "cpu", stale_strength_compat=False)
    kb = base.detect_keypoints(vol)
    # The default keypoints' edge decisions, from their DoG neighbourhoods.
    plan = tpyr.make_plan(vol.shape, vol.units, TP)
    _, dogs, _ = tpyr.build_gpyr_and_dog(tpyr.scale_to_unit(vol.data), plan)
    keep = np.zeros(len(kb), bool)
    for o in np.unique(kb.octave):
        i = np.nonzero(kb.octave == o)[0]
        ref = tref.refine_candidates_octave(
            dogs[o], torch.from_numpy(kb.coords[i].astype(np.int64)),
            torch.from_numpy(kb.level[i].astype(np.int64)), tp)
        keep[i] = ref.edge_ok.numpy()
    assert 0 < keep.sum() < len(kb)
    assert np.array_equal(kp.coords, kb.coords[keep])
    np.testing.assert_allclose(kp.sd, kb.sd[keep], rtol=1e-7)  # f32 there
    assert np.array_equal(kp.strength, kb.strength[keep])
    assert np.abs(kp.R - kb.R[keep]).max() <= 1e-5
    d, db = det.extract_descriptors(kp), base.extract_descriptors(kb[keep])
    assert np.abs(d.data - db.data).max() <= 1e-5


def test_f64_sum_yardstick_at_fractional_centers(fractional_keypoints):
    """The refined golden's R64 (tools/torch_golden.py f64_sum_R around
    fractional centers, anchored at rint(center)) is within 1e-5 of the
    port's f32 R on every accepted keypoint, and is not that R."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_golden", REPO / "tools" / "torch_golden.py")
    tg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tg)
    units = (1.0, 1.0, 1.0)
    plan, levels, cand, centers, sd, sd_max = fractional_keypoints[units]
    o32 = tok.orient_plain(levels, cand.level, cand.coords, sd, units, TP,
                           centers=centers, sd_max=sd_max, fractional=True)
    R64 = tg.f64_sum_R(levels.numpy(), cand.level.numpy(),
                       np.rint(centers.numpy()), sd.numpy(), units, JP,
                       sd_max, centers=centers.numpy())
    acc = o32.accepted.numpy()
    assert acc.any()
    R32 = o32.R.numpy()[acc]
    assert np.abs(R32 - R64[acc]).max() <= 1e-5
    assert not np.array_equal(R32, R64[acc])
