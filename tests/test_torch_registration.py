"""The port's registration (match + RANSAC + warp, register, the
regsift3d-torch CLI) vs the JAX package, on the CPU.

Matching gives the identical pairs on seeded descriptors with exact
duplicates and near-ties. JAX's PRNG and torch's draw different RANSAC
hypotheses, so the RANSAC core is held to JAX with JAX's own hypothesis
indices fed to both (a coplanar, singular sample among them): the same
inliers, A within 1e-4. The warp agrees within 1e-6. End to end, the JAX
register runs in a child process with XLA:CPU capped at SSE4.2 (as
tests/test_torch_pipeline.py runs JAX's pyramid) on the 64^3 pair of
tests/test_registration.py::test_register_end_to_end; the port's affine
meets that test's 2.5-voxel bar and lies within 0.25 voxel (mean corner
displacement) of JAX's."""

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

from sift3d_tpu import registration as jreg  # noqa: E402
from sift3d_tpu.keypoints import Descriptors as JaxDescriptors  # noqa: E402
from sift3d_tpu.volume import Volume as JaxVolume  # noqa: E402
from sift3d_tpu_torch import Volume, register  # noqa: E402
from sift3d_tpu_torch import registration as treg  # noqa: E402
from sift3d_tpu_torch.io import write_volume  # noqa: E402
from sift3d_tpu_torch.keypoints import Descriptors  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from bench_registration import affine_corner_error  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The port's CPU work here on two threads, restored afterwards: the
    suite runs six test files at once on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _descriptor_sets():
    """Unit-norm descriptors: set 2 holds noisy copies of 30 rows of set 1
    (matchable), 10 fresh rows, two exact duplicates of one copy (a tie:
    the ratio test rejects it) and a near-tie of another (noise 1e-4)."""
    rng = np.random.default_rng(12)
    d1 = rng.normal(size=(50, 768)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    perm = rng.permutation(50)[:30]
    d2 = np.concatenate([
        d1[perm] + rng.normal(0, 0.04, (30, 768)).astype(np.float32),
        rng.normal(size=(10, 768)).astype(np.float32)])
    d2 = np.concatenate([d2, d2[[3, 3]],
                         d2[[7]] + rng.normal(0, 1e-4, (1, 768))])
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    return d1, d2


@pytest.mark.parametrize("nn_thresh", [0.8, 0.95])
def test_match_descriptors_matches_jax(nn_thresh):
    d1, d2 = _descriptor_sets()

    def desc(cls, d):
        n = len(d)
        return cls(xyz=np.zeros((n, 3), np.float32),
                   sd=np.ones(n, np.float32), data=d)
    j1, j2 = jreg.match_descriptors(desc(JaxDescriptors, d1),
                                    desc(JaxDescriptors, d2), nn_thresh)
    i1, i2 = treg.match_descriptors(desc(Descriptors, d1),
                                    desc(Descriptors, d2), nn_thresh,
                                    device="cpu")
    assert 10 < len(i1) < 50
    assert np.array_equal(i1, j1) and np.array_equal(i2, j2)
    # The duplicated and the near-tied rows of set 2 are never matched.
    assert not np.isin(i2, [3, 7, 40, 41, 42]).any()


def test_sample_distinct4_distinct_and_in_range():
    for seed in range(4):
        for n in range(4, 41):
            idx = treg._sample_distinct4(torch.Generator().manual_seed(seed),
                                         300, n).numpy()
            assert idx.shape == (300, 4)
            assert idx.min() >= 0 and idx.max() < n
            assert all(len(set(row)) == 4 for row in idx)
    idx = treg._sample_distinct4(torch.Generator().manual_seed(0), 4000, 8)
    freq = np.bincount(idx.numpy().ravel(), minlength=8) / (4000 * 4)
    assert np.abs(freq - 1 / 8).max() < 0.02


def _correspondences(seed=4):
    """60 correspondences under an affine, 20 of them outliers; a third of
    the points on the plane z = 3 at integer x, y (coplanar samples), the
    first 8 at x, y in {0, 1, 2}, where elimination is exact in f32 and a
    coplanar sample gives an exactly zero pivot."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 64, (60, 3)).astype(np.float32)
    src[:20] = np.c_[rng.integers(0, 64, (20, 2)), np.full(20, 3)]
    src[:8, :2] = [[0, 0], [1, 0], [0, 1], [1, 1], [2, 0], [0, 2], [2, 2],
                   [1, 2]]
    A = np.array([[0.98, -0.14, 0.02, 3.0],
                  [0.14, 0.98, 0.0, -2.0],
                  [0.01, 0.0, 1.02, 1.0]], np.float32)
    dst = src @ A[:, :3].T + A[:, 3] + rng.normal(0, 0.2, (60, 3))
    out = rng.choice(60, 20, replace=False)
    dst[out] += rng.uniform(-30, 30, (20, 3))
    w = 1.0 / (4.0 ** rng.integers(0, 3, 60) + 1.0)
    return src, dst.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 7])
def test_ransac_core_matches_jax_on_jax_indices(monkeypatch, seed):
    src, dst, w = _correspondences()
    M, N = len(src), 500
    idx = np.array(jreg._sample_distinct4(jax.random.PRNGKey(seed), N,
                                           jnp.int32(M)))
    # Two coplanar samples (z = 3) whose 4x4 systems are exactly singular.
    idx[:2] = [[0, 1, 2, 3], [4, 5, 6, 7]]
    monkeypatch.setattr(jreg, "_sample_distinct4",
                        lambda key, num_iter, n: jnp.asarray(idx))
    A_ref, n_ref, inl_ref = jreg._ransac_core(
        jnp.asarray(src), jnp.asarray(dst), jnp.ones(M, bool), M,
        jax.random.PRNGKey(seed), N, 2.0, w=jnp.asarray(w))
    X = np.c_[src, np.ones(M)].astype(np.float32)
    As, info = torch.linalg.solve_ex(torch.from_numpy(X[idx[:2]]),
                                     torch.from_numpy(dst[idx[:2]]))
    assert info.tolist() == [4, 4]              # the last pivot is 0
    A, n, inl = treg._ransac_core(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(idx.astype(np.int64)), 2.0, torch.from_numpy(w))
    assert n == int(n_ref) and 30 <= n <= 40
    assert np.array_equal(inl.numpy(), np.asarray(inl_ref))
    np.testing.assert_allclose(A.numpy(), np.asarray(A_ref), rtol=0,
                               atol=1e-4)


def test_ransac_affine_needs_four_points():
    for m in (0, 3):
        A, mask = treg.ransac_affine(np.zeros((m, 3)), np.zeros((m, 3)),
                                     device="cpu")
        assert A is None and mask.shape == (m,) and not mask.any()
    src, dst, _ = _correspondences()
    A, mask = treg.ransac_affine(src, dst, 2.0, device="cpu")
    assert A.shape == (3, 4) and 30 <= mask.sum() <= 40


def test_warp_volume_matches_jax():
    rng = np.random.default_rng(9)
    vol = make_phantom(24)
    A = np.eye(3, 4, dtype=np.float32)
    A[:, :3] += rng.normal(0, 0.08, (3, 3))
    A[:, 3] = rng.uniform(-3, 3, 3)
    ref = np.asarray(jreg.warp_volume(JaxVolume.from_array(vol), A,
                                      (24, 26, 22)).data)
    got = treg.warp_volume(Volume.from_array(vol), A, (24, 26, 22), "cpu")
    assert got.data.shape == (24, 26, 22)
    assert (ref == 0).any() and (ref != 0).mean() > 0.5   # some outside
    assert np.abs(got.data.numpy() - ref).max() <= 1e-6


_CHILD = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tests")
from conftest import make_phantom
from sift3d_tpu import SIFT3D
from sift3d_tpu.registration import register, warp_volume
from sift3d_tpu.volume import Volume
cfg = json.loads(sys.argv[1])
A_true = np.asarray(cfg["A_true"], np.float32)
fixed = Volume.from_array(make_phantom(64, nblobs=60, seed=11))
moving = warp_volume(fixed, A_true, (64, 64, 64))
# A detector pair takes the per-pair path, whose numerics the batched one
# repeats (sift3d_tpu/registration.py:207-210); it compiles less.
res = register(fixed, moving, num_iter=500, detectors=(SIFT3D(), SIFT3D()))
np.savez(cfg["out"], affine=res.affine, matches=res.num_matches,
         inliers=res.num_inliers, moving=np.asarray(moving.data))
"""


def _true_affine():
    """tests/test_registration.py:181-189: 8 degrees about z, shifted."""
    th = np.deg2rad(8.0)
    Rz = np.array([[np.cos(th), -np.sin(th), 0],
                   [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    c = np.array([31.5] * 3)
    A = np.zeros((3, 4), np.float32)
    A[:, :3] = Rz
    A[:, 3] = c - Rz @ c + np.array([2.0, -3.0, 1.5])
    return A


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The 64^3 pair (moving warped by the port) and the JAX registration
    of the JAX-warped pair from a child process."""
    out = tmp_path_factory.mktemp("jax_register")
    A_true = _true_affine()
    cfg = dict(A_true=A_true.tolist(), out=str(out / "jax.npz"))
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=SSE4_2").strip())
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(cfg)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    fixed = Volume.from_array(make_phantom(64, nblobs=60, seed=11))
    moving = treg.warp_volume(fixed, A_true, (64, 64, 64), "cpu")
    return fixed, moving, A_true, np.load(out / "jax.npz")


def _to_truth(affine, A_true):
    """Max displacement over 100 points of [16, 48]^3 between the affine
    (moving -> fixed) and the inverse of the warp."""
    A4 = np.eye(4)
    A4[:3, :] = A_true
    A_inv = np.linalg.inv(A4)[:3, :]
    pts = np.c_[np.random.default_rng(0).uniform(16, 48, (100, 3)),
                np.ones(100)].T
    return np.abs(affine @ pts - A_inv @ pts).max()


def test_register_end_to_end_matches_jax(pair):
    fixed, moving, A_true, ref = pair
    assert np.abs(moving.data.numpy() - ref["moving"]).max() <= 1e-6
    res = register(fixed, moving, num_iter=500, device="cpu")
    assert res.num_matches >= 20 and res.num_inliers >= 15
    assert res.inlier_mask.shape == (res.num_matches,)
    assert _to_truth(res.affine, A_true) < 2.5
    assert _to_truth(ref["affine"], A_true) < 2.5
    assert affine_corner_error(res.affine, ref["affine"], 64) <= 0.25
    assert abs(res.num_matches - int(ref["matches"])) <= 2


def test_regsift3d_torch_cli(tmp_path, capsys):
    """regsift3d-torch --device cpu on a 40^3 phantom against itself: every
    keypoint matches its twin, the matrix written ('%f') is the identity
    and the warped volume the input inside its border, within 1e-3 (a
    source point a hair outside the volume reads 0); with the default
    device and no GPU it fails with a message."""
    from sift3d_tpu_torch.cli import register_main
    from sift3d_tpu_torch.io import read_volume
    vol = make_phantom(40, nblobs=30, seed=3)
    write_volume(tmp_path / "v.nii", vol)
    mat, warped = tmp_path / "A.csv", tmp_path / "w.nii"
    assert register_main([str(tmp_path / "v.nii"), str(tmp_path / "v.nii"),
                          "--device", "cpu", "--matrix", str(mat),
                          "--warped", str(warped)]) == 0
    assert "inliers" in capsys.readouterr().out
    A = np.loadtxt(mat, delimiter=",")
    np.testing.assert_allclose(A, np.eye(3, 4), atol=1e-3)
    w = read_volume(warped)
    assert w.shape == vol.shape
    inner = (slice(1, -1),) * 3
    np.testing.assert_allclose(w.data.numpy()[inner], vol[inner], rtol=0,
                               atol=1e-3)
    if not torch.cuda.is_available():
        assert register_main([str(tmp_path / "v.nii"),
                              str(tmp_path / "v.nii")]) == 1
        assert "no CUDA GPU" in capsys.readouterr().err


def test_register_featureless_volume_gives_no_affine():
    res = register(np.zeros((32, 32, 32), np.float32),
                   make_phantom(32, nblobs=5, seed=1), device="cpu")
    assert res.affine is None and res.num_matches == 0
    assert res.inlier_mask.shape == (0,)
