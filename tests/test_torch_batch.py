"""The port's batch path vs the JAX package's, and vs itself volume by
volume, on the CPU.

SIFT3D.detect_keypoints_batch + extract_descriptors_batch on two distinct
48^3 phantoms are held to JAX's batch path at the reference bars of
tests/test_torch_pipeline.py (identical rows, stale strength within
1.2e-7 relative, R within 1e-5, descriptors within 1% relative L2), and
register_batch on two pairs, one of them with a featureless fixed volume,
to JAX's register_batch: the same matches, and, with RANSAC fed JAX's own
hypothesis indices (_sample_distinct4(PRNGKey(seed), num_iter, n_b) per
pair), the same inliers and A within 1e-4. JAX runs in a child process
with XLA:CPU capped at SSE4.2, as tests/test_torch_pipeline.py runs it.

Port against port: the batch equals each volume alone bit for bit, a
forced sub-batch of one changes nothing, register_batch[b] equals
register(pair b), and the batched plain versions of the blur and extrema
kernels equal their per-volume plain versions. The refined batch against
JAX is tests/test_torch_batch_refined.py."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import make_phantom  # noqa: E402

import sift3d_tpu_torch as st  # noqa: E402
from sift3d_tpu_torch import pipeline  # noqa: E402
from sift3d_tpu_torch import registration as treg  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N = 48
NUM_ITER = 500
REFINED = {"refine_subvoxel": True, "edge_thresh": 10.0}

_CHILD = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from sift3d_tpu import DetectorParams, SIFT3D
from sift3d_tpu import registration as jreg
cfg = json.loads(sys.argv[1])
inp = np.load(cfg["inputs"])
params = DetectorParams(gpyr_impl="incremental", extrema_impl="xla",
                        **cfg["ext"])
out = {}
det = SIFT3D(params)
kps = det.detect_keypoints_batch(inp["vols"])
for b, (kp, ds) in enumerate(zip(kps, det.extract_descriptors_batch(kps))):
    for f in ("coords", "octave", "level", "sd", "strength", "R"):
        out[f"{b}_{f}"] = np.asarray(getattr(kp, f))
    out[f"{b}_desc"], out[f"{b}_xyz"] = np.asarray(ds.data), np.asarray(ds.xyz)
if cfg["register"]:
    # A fresh detector: no batch hint, the program of the first call.
    res = jreg.register_batch(inp["fixed"], inp["moving"],
                              num_iter=cfg["num_iter"], det=SIFT3D(params))
    for b, r in enumerate(res):
        out[f"reg{b}_matches"] = np.int32(r.num_matches)
        out[f"reg{b}_inliers"] = np.int32(r.num_inliers)
        out[f"reg{b}_fixed"] = np.asarray(r.matches_fixed)
        out[f"reg{b}_moving"] = np.asarray(r.matches_moving)
        out[f"reg{b}_mask"] = np.asarray(r.inlier_mask)
        if r.affine is not None:
            out[f"reg{b}_affine"] = np.asarray(r.affine)
            out[f"reg{b}_idx"] = np.asarray(jreg._sample_distinct4(
                jax.random.PRNGKey(0), cfg["num_iter"],
                jax.numpy.int32(r.num_matches)))
np.savez(cfg["out"], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The port's CPU work here on two threads, restored afterwards: the
    suite runs six test files at once on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def true_affine(n):
    """7 degrees about z around the center, shifted."""
    th = np.deg2rad(7.0)
    Rz = np.array([[np.cos(th), -np.sin(th), 0],
                   [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    c = np.array([(n - 1) / 2.0] * 3)
    A = np.zeros((3, 4), np.float32)
    A[:, :3] = Rz
    A[:, 3] = c - Rz @ c + np.array([1.5, -2.0, 1.0])
    return A


def batch_inputs(n=N):
    """Two distinct phantoms; the pairs (phantom 0, its warped copy) and
    (a featureless volume, phantom 1)."""
    a = make_phantom(n, nblobs=60, seed=11)
    b = make_phantom(n, nblobs=40, seed=12)
    moving = treg.warp_volume(st.Volume.from_array(a), true_affine(n),
                              (n,) * 3, "cpu").data.numpy()
    return dict(vols=np.stack([a, b]), fixed=np.stack([a, np.zeros_like(a)]),
                moving=np.stack([moving, b]))


def run_jax_child(tmp, ext, register):
    """JAX's batch outputs for batch_inputs(), from a child process."""
    inputs = batch_inputs()
    np.savez(tmp / "in.npz", **inputs)
    cfg = dict(inputs=str(tmp / "in.npz"), out=str(tmp / "jax.npz"),
               ext=ext, register=register, num_iter=NUM_ITER)
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=SSE4_2").strip())
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(cfg)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    return inputs, np.load(tmp / "jax.npz")


def check_batch_against_jax(inputs, ref, ext):
    """The port's batch path vs JAX's, volume by volume, to the reference
    bars (refined: coordinates within 1e-5, sd 1e-6 relative, the true
    strengths exact)."""
    det = st.SIFT3D(st.DetectorParams(**ext), "cpu")
    kps = det.detect_keypoints_batch(inputs["vols"])
    dss = det.extract_descriptors_batch(kps)
    assert len(kps) == len(dss) == 2
    for b, (kp, ds) in enumerate(zip(kps, dss)):
        g = {f: ref[f"{b}_{f}"] for f in ("coords", "octave", "level", "sd",
                                          "strength", "R", "desc", "xyz")}
        assert len(kp) == len(g["coords"]) > 5
        assert np.array_equal(kp.octave, g["octave"])
        assert np.array_equal(kp.level, g["level"])
        if ext:
            assert np.abs(kp.coords - g["coords"]).max() <= 1e-5
            assert np.max(np.abs(kp.sd - g["sd"]) / g["sd"]) <= 1e-6
            assert np.array_equal(kp.strength, g["strength"])
            assert np.abs(ds.xyz - g["xyz"]).max() <= 1e-5 * 2 ** 3
        else:
            assert np.array_equal(kp.coords, g["coords"])
            assert np.array_equal(kp.sd, g["sd"])
            rel = np.abs(kp.strength - g["strength"]) / np.abs(g["strength"])
            assert rel.max() <= 1.2e-7
            assert np.array_equal(ds.xyz, g["xyz"])
        assert np.abs(kp.R - g["R"]).max() <= 1e-5
        err = (np.linalg.norm(ds.data - g["desc"], axis=1)
               / np.linalg.norm(g["desc"], axis=1))
        assert np.all(err <= 0.01), err.max()


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax_child(tmp_path_factory.mktemp("jax_batch"), {}, True)


def test_batch_matches_jax_to_reference_bars(jax_ref):
    check_batch_against_jax(*jax_ref, {})


def test_register_batch_matches_jax_on_jax_indices(jax_ref, monkeypatch):
    """Matches equal to JAX's; RANSAC on JAX's hypothesis indices gives
    JAX's inliers and A within 1e-4; the pair with a featureless fixed
    volume gives no affine in both."""
    inputs, ref = jax_ref
    idx = {int(ref[f"reg{b}_matches"]): ref[f"reg{b}_idx"] for b in range(2)
           if f"reg{b}_idx" in ref.files}
    monkeypatch.setattr(treg, "_sample_distinct4", lambda gen, num_iter, n:
                        torch.from_numpy(idx[n].astype(np.int64)))
    res = st.register_batch(inputs["fixed"], inputs["moving"],
                            num_iter=NUM_ITER, device="cpu")
    assert len(res) == 2
    for b, r in enumerate(res):
        assert r.num_matches == int(ref[f"reg{b}_matches"])
        assert np.array_equal(r.matches_fixed, ref[f"reg{b}_fixed"])
        assert np.array_equal(r.matches_moving, ref[f"reg{b}_moving"])
        assert r.num_inliers == int(ref[f"reg{b}_inliers"])
        assert np.array_equal(r.inlier_mask, ref[f"reg{b}_mask"])
    assert res[0].num_matches >= 8 and res[0].num_inliers >= 6
    np.testing.assert_allclose(res[0].affine, ref["reg0_affine"], rtol=0,
                               atol=1e-4)
    assert res[1].affine is None and res[1].num_matches == 0
    assert res[1].inlier_mask.shape == (0,)


def _same_rows(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("coords", "octave", "level", "sd", "strength", "R"))


def _same_desc(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("xyz", "sd", "data"))


@pytest.mark.parametrize("ext", [{}, REFINED], ids=["default", "refined"])
def test_batch_equals_each_volume_alone(ext, monkeypatch):
    """Rows and descriptors of the batch equal each volume's own
    detect_keypoints + extract_descriptors bit for bit (the stale
    strength column per volume), and a forced sub-batch of one gives the
    same; a featureless volume in the batch gives empty results."""
    vols = np.stack([make_phantom(40, nblobs=40, seed=s) for s in (11, 12)]
                    + [np.zeros((40, 40, 40), np.float32)])
    p = st.DetectorParams(**ext)
    det = st.SIFT3D(p, "cpu")
    kps = det.detect_keypoints_batch(vols)
    dss = det.extract_descriptors_batch(kps)
    for b in range(2):
        one = st.SIFT3D(p, "cpu")
        kp = one.detect_keypoints(vols[b])
        assert len(kp) > 3 and _same_rows(kps[b], kp)
        assert _same_desc(dss[b], one.extract_descriptors(kp))
    assert len(kps[2]) == 0 and dss[2].data.shape == (0, 768)
    with pytest.raises(ValueError, match="batch"):
        det.extract_descriptors(kps[0])
    with pytest.raises(ValueError, match="keypoint lists"):
        det.extract_descriptors_batch(kps[:2])
    monkeypatch.setattr(pipeline, "SUB_BATCH", 1)
    kps1 = det.detect_keypoints_batch(vols)
    dss1 = det.extract_descriptors_batch(kps1)
    assert all(_same_rows(a, b) for a, b in zip(kps, kps1))
    assert all(_same_desc(a, b) for a, b in zip(dss, dss1))


def test_register_batch_equals_register_per_pair():
    """register_batch(...)[b] is register(pair b): the same matches,
    inliers and affine (RANSAC draws each pair's hypotheses from the same
    seed, for its own match count)."""
    inputs = batch_inputs(40)
    fixed = np.concatenate([inputs["fixed"], inputs["moving"][:1]])
    moving = np.concatenate([inputs["moving"], inputs["fixed"][:1]])
    res = st.register_batch(fixed, moving, device="cpu")
    assert res[0].num_inliers >= 6 and res[1].affine is None
    for b, rb in enumerate(res):
        r1 = st.register(fixed[b], moving[b], device="cpu")
        assert rb.num_matches == r1.num_matches
        assert rb.num_inliers == r1.num_inliers
        for f in ("matches_fixed", "matches_moving", "inlier_mask"):
            assert np.array_equal(getattr(rb, f), getattr(r1, f)), f
        assert (rb.affine is None) == (r1.affine is None)
        if r1.affine is not None:
            assert np.array_equal(rb.affine, r1.affine)


def test_batched_plain_kernels_equal_per_volume():
    """The batch's plain versions: chain_octave of [B, ...] equals each
    volume's chain bit for bit (levels, DoG, max |DoG| per volume), and the
    batched extrema candidates are each volume's keys offset by b times
    the volume's key range, counts [B, nl]."""
    from sift3d_tpu_torch.ops import blur_kernel as bk
    from sift3d_tpu_torch.ops import extrema_kernel as ek
    from sift3d_tpu_torch.pyramid import make_plan, scale_to_unit
    vols = torch.from_numpy(np.stack(
        [make_phantom(24, nblobs=20, seed=s) for s in (3, 4, 5)]))
    x = scale_to_unit(vols)
    for b in range(3):
        assert torch.equal(x[b], scale_to_unit(vols[b]))
    params = st.DetectorParams()
    plan = make_plan((24, 24, 24), (1.0, 1.0, 1.5), params)
    g, d, m = bk.chain_octave(x, plan, 0)
    assert g.shape[:2] == (3, 6) and m.shape == (3, 5)
    nl = params.num_kp_levels
    thr = (params.peak_thresh * m[:, 1:1 + nl]).contiguous()
    keys, counts = ek.extrema_candidates(d, thr)
    assert counts.shape == (3, nl)
    per = nl * 24 ** 3
    for b in range(3):
        gb, db, mb = bk.chain_octave(x[b], plan, 0)
        assert torch.equal(g[b], gb) and torch.equal(d[b], db)
        assert torch.equal(m[b], mb)
        kb, cb = ek.extrema_candidates(db, thr[b])
        mine = keys[(keys >= b * per) & (keys < (b + 1) * per)] - b * per
        assert torch.equal(torch.sort(mine).values, torch.sort(kb).values)
        assert torch.equal(counts[b], cb)
    assert int(counts.sum()) > 0
