"""The port's SIFT3D end to end vs the JAX SIFT3D, to the reference bars:
identical keypoint rows (coordinates, octave, level, order), the stale
strength column within 1.2e-7 relative, R within 1e-5, and every
descriptor within 1% relative L2.

The JAX side runs in a child process whose XLA:CPU is capped at SSE4.2.
On a CPU with FMA, jitted XLA contracts the blur's multiply-then-add
chain (sift3d_tpu/pyramid.py:182 _diag_pass) into fused multiply-adds,
which moves the pyramid by ulps away from the eager arithmetic that the
port reproduces bit for bit (test_torch_pyramid); without FMA the jitted
program is bit-identical to the eager one."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import make_phantom, make_sphere_phantom  # noqa: E402

import sift3d_tpu_torch as st  # noqa: E402
from sift3d_tpu_torch.io import write_volume  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CASES = {
    "sphere": (make_sphere_phantom, (1.0, 1.0, 1.0)),
    "phantom": (make_phantom, (1.0, 1.0, 1.0)),
    "aniso": (make_phantom, (1.0, 1.0, 1.5)),
}
JAX_PARAMS = dict(gpyr_impl="incremental", extrema_impl="xla")

_CHILD = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tests")
from conftest import make_phantom, make_sphere_phantom
from sift3d_tpu import DetectorParams, SIFT3D
from sift3d_tpu.cli import main as cli_main
from sift3d_tpu.volume import Volume
cfg = json.loads(sys.argv[1])
params = DetectorParams(**cfg["params"])
make = {"sphere": make_sphere_phantom, "phantom": make_phantom}
for name, (maker, units) in cfg["cases"].items():
    det = SIFT3D(params)
    kp = det.detect_keypoints(Volume.from_array(make[maker](64), units))
    out = dict(coords=kp.coords, octave=kp.octave, level=kp.level,
               sd=kp.sd, strength=kp.strength, R=kp.R)
    if len(kp):
        d = det.extract_descriptors(kp)
        out.update(desc=d.data, xyz=d.xyz, dsd=d.sd)
    np.savez(f"{cfg['out']}/{name}.npz", **out)
sys.exit(cli_main(["--keys", cfg["out"] + "/jax_keys.csv",
                   "--desc", cfg["out"] + "/jax_desc.csv",
                   cfg["nifti"]]))
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """JAX outputs for every case plus the kpsift3d CSVs, from one child
    process."""
    out = tmp_path_factory.mktemp("jax_ref")
    nifti = out / "phantom.nii"
    write_volume(nifti, make_phantom(64))
    cases = {k: ("sphere" if m is make_sphere_phantom else "phantom", u)
             for k, (m, u) in CASES.items()}
    cfg = dict(params=JAX_PARAMS, out=str(out), nifti=str(nifti),
               cases=cases)
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=SSE4_2").strip())
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(cfg)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    return out


def _params():
    from sift3d_tpu.params import DetectorParams as JaxParams
    return st.from_jax_params(dataclasses.asdict(JaxParams(**JAX_PARAMS)))


@pytest.mark.parametrize("name", list(CASES))
def test_sift3d_matches_jax_to_reference_bars(jax_ref, name):
    maker, units = CASES[name]
    ref = np.load(jax_ref / f"{name}.npz")
    det = st.SIFT3D(_params(), "cpu")
    kp = det.detect_keypoints(st.Volume.from_array(maker(64), units))

    assert len(kp) == len(ref["coords"])
    assert np.array_equal(kp.coords, ref["coords"])
    assert np.array_equal(kp.octave, ref["octave"])
    assert np.array_equal(kp.level, ref["level"])
    assert np.array_equal(kp.sd, ref["sd"])
    if not len(kp):
        with pytest.raises(ValueError, match="no keypoints"):
            det.extract_descriptors(kp)
        return
    rel = np.abs(kp.strength - ref["strength"]) / np.abs(ref["strength"])
    assert rel.max() <= 1.2e-7
    assert np.abs(kp.R - ref["R"]).max() <= 1e-5

    d = det.extract_descriptors(kp)
    err = (np.linalg.norm(d.data - ref["desc"], axis=1)
           / np.linalg.norm(ref["desc"], axis=1))
    assert np.all(err <= 0.01), err.max()
    assert np.array_equal(d.xyz, ref["xyz"])
    assert np.array_equal(d.sd, ref["dsd"])


def test_api_matches_sift3d_object():
    vol = make_phantom(48)
    kp, desc = st.detect_and_extract(vol, _params(), device="cpu", limit=5)
    det = st.SIFT3D(_params(), "cpu")
    ref = st.detect_keypoints(vol, detector=det).sort_by_strength(5)
    assert len(kp) == 5
    assert np.array_equal(kp.coords, ref.coords)
    assert np.array_equal(desc.data, det.extract_descriptors(ref).data)


def test_sphere_has_candidates_but_no_survivors():
    """The hard-edged sphere gives DoG extrema that the orientation stage
    rejects (both implementations return no keypoints)."""
    from sift3d_tpu_torch.detect import detect_extrema_octave
    from sift3d_tpu_torch.pyramid import (build_gpyr_and_dog, make_plan,
                                          scale_to_unit)
    vol = torch.from_numpy(make_sphere_phantom(64))
    plan = make_plan(vol.shape, (1.0, 1.0, 1.0), _params())
    _, dogs, dmax = build_gpyr_and_dog(scale_to_unit(vol), plan)
    n = sum(int(detect_extrema_octave(d, m, _params()).counts.sum())
            for d, m in zip(dogs, dmax))
    assert n > 0


def test_cli_writes_kpsift3d_layout(jax_ref, tmp_path):
    from sift3d_tpu_torch.cli import main
    keys, desc = tmp_path / "k.csv", tmp_path / "d.csv.gz"
    assert main(["--device", "cpu", "--keys", str(keys), "--desc",
                 str(desc), str(jax_ref / "phantom.nii")]) == 0
    got_k = np.loadtxt(keys, delimiter=",", ndmin=2)
    ref_k = np.loadtxt(jax_ref / "jax_keys.csv", delimiter=",", ndmin=2)
    assert got_k.shape == ref_k.shape and got_k.shape[1] == 15
    assert np.array_equal(got_k[:, 1:6], ref_k[:, 1:6])  # x y z o sd
    np.testing.assert_allclose(got_k[:, 0], ref_k[:, 0], rtol=1e-5)
    np.testing.assert_allclose(got_k[:, 6:], ref_k[:, 6:], atol=2e-6)
    got_d = np.loadtxt(desc, delimiter=",", ndmin=2)
    ref_d = np.loadtxt(jax_ref / "jax_desc.csv", delimiter=",", ndmin=2)
    assert got_d.shape == ref_d.shape and got_d.shape[1] == 771
    assert np.array_equal(got_d[:, :3], ref_d[:, :3])
    err = (np.linalg.norm(got_d[:, 3:] - ref_d[:, 3:], axis=1)
           / np.linalg.norm(ref_d[:, 3:], axis=1))
    assert np.all(err <= 0.01)


def test_cli_fails_without_outputs_or_gpu(tmp_path, capsys):
    from sift3d_tpu_torch.cli import main
    assert main([str(tmp_path / "x.nii")]) == 1
    if not torch.cuda.is_available():
        write_volume(tmp_path / "x.nii", np.zeros((16, 16, 16), np.float32))
        assert main(["--keys", str(tmp_path / "k.csv"),
                     str(tmp_path / "x.nii")]) == 1
        assert "no CUDA GPU" in capsys.readouterr().err


def test_params_reject_unported_extensions_and_bad_ranges():
    """The two extensions are accepted and carried across from the JAX
    package's params (the TPU execution knobs are dropped); the reference
    setters' ranges and edge_thresh >= 1 are enforced."""
    from sift3d_tpu.params import DetectorParams as JaxParams
    p = st.DetectorParams(refine_subvoxel=True, edge_thresh=10.0)
    assert p.refine_subvoxel and p.edge_thresh == 10.0 and p.extensions
    assert not st.DetectorParams().extensions
    p = st.from_jax_params(dataclasses.asdict(
        JaxParams(refine_subvoxel=True, edge_thresh=4.0)))
    assert p.refine_subvoxel and p.edge_thresh == 4.0
    with pytest.raises(ValueError):
        st.DetectorParams(edge_thresh=0.5)
    with pytest.raises(ValueError):
        st.DetectorParams(peak_thresh=0.0)
    with pytest.raises(ValueError):
        st.DetectorParams(sigma_n=5.0)
    p = st.from_jax_params(dataclasses.asdict(
        JaxParams(peak_thresh=0.2, cuboid_extrema=True,
                  conv_precision="highest")))
    assert p.peak_thresh == 0.2 and p.cuboid_extrema
    assert not p.extensions


def test_flat_volume_gives_no_keypoints():
    det = st.SIFT3D(_params(), "cpu")
    kp = det.detect_keypoints(np.zeros((32, 32, 32), np.float32))
    assert len(kp) == 0 and kp.R.shape == (0, 3, 3)


@pytest.mark.parametrize("cell", ["sparse", "dense"])
def test_chip_smoke_phantoms_are_bench_phantoms(cell):
    """phantoms.bench_volume builds bench.py's phantoms with torch (on the
    card in chip_smoke.py, where numpy takes minutes at 256^3) bit for
    bit."""
    import bench
    from sift3d_tpu_torch.phantoms import bench_volume
    make = {"sparse": bench.make_bench_volume,
            "dense": bench.make_dense_volume}[cell]
    got = bench_volume(cell, 24, "cpu").numpy()
    assert np.array_equal(got, make(24))
