"""The port's DetectorParams against the JAX package's: every field with
JAX's default, every value JAX refuses refused with JAX's ValueError,
from_jax_params keeping every field, and the execution knobs of the TPU
pipeline computing, at every value JAX can run on the CPU, rows and
descriptors within the reference bars of JAX's under that value.

The port computes its one exact f32 path at every knob value
(sift3d_tpu_torch/params.py). The JAX side runs in one child process
whose XLA:CPU is capped at SSE4.2 (see test_torch_pipeline.py)."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import make_phantom  # noqa: E402

from sift3d_tpu.params import DetectorParams as JaxParams  # noqa: E402
import sift3d_tpu_torch as st  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
JAX_FIELDS = [f for f in dataclasses.fields(JaxParams)]

# Every value of gpyr_impl and of desc_precision that JAX runs on the
# CPU, one JAX detection each. "incremental" is the reference's sequential
# f32 order, the port's; "auto" (JAX's default) is the composed builder
# off a TPU, and so is "chain" at 48^3, which has no octave the chained
# builder takes (sift3d_tpu/pyramid.py:453-480).
KNOB_CASES = {
    "gpyr_impl=incremental": {"gpyr_impl": "incremental"},
    "gpyr_impl=auto": {},
    "gpyr_impl=composed": {"gpyr_impl": "composed"},
    "gpyr_impl=chain": {"gpyr_impl": "chain"},
    "desc_precision=highest": {"gpyr_impl": "incremental",
                               "desc_precision": "highest"},
}

# Values the JAX package's __post_init__ refuses (sift3d_tpu/params.py:
# 203-246), one a check.
INVALID = [
    ("peak_thresh", 0.0), ("peak_thresh", 1.5), ("corner_thresh", -0.1),
    ("corner_thresh", 1.1), ("num_kp_levels", 0), ("sigma_n", -1.0),
    ("sigma0", -1.0), ("sigma_n", 5.0), ("edge_thresh", 0.5),
    ("conv_precision", "bogus"), ("desc_precision", "bf16"),
    ("conv_tail_precision", "high_xy"), ("conv_exact_from_octave", -1),
    ("dense_octave_acc", 0), ("dense_octave_cand", 0),
    ("split_desc_chunks", -1), ("min_chunk_cost", -1), ("hint_history", 0),
    ("desc_vbins", "flat"), ("extrema_impl", "cuda"),
    ("gpyr_impl", "bogus"),
]

# A valid value other than the default for every field.
NON_DEFAULT = dict(
    peak_thresh=0.2, corner_thresh=0.3, num_kp_levels=4, sigma_n=1.0,
    sigma0=1.7, cuboid_extrema=True, gauss_width_fctr=4.0,
    max_eig_ratio=0.8, ori_grad_thresh=1e-9, bary_eps=1e-5,
    ori_sig_fctr=1.4, ori_rad_fctr=2.5, desc_sig_fctr=7.0,
    desc_rad_fctr=2.5, trunc_thresh=0.05, refine_subvoxel=True,
    edge_thresh=12.0, kp_per_level=64, conv_precision="default",
    desc_precision="highest", conv_tail_precision="highest",
    conv_exact_from_octave=0, gpyr_impl="composed", dense_octave_acc=8,
    dense_octave_cand=16, sparse_desc_groups=False, split_desc_chunks=0,
    min_chunk_cost=0, hint_history=1, desc_vbins="packed",
    extrema_impl="xla")

_CHILD = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tests")
from conftest import make_phantom
from sift3d_tpu import DetectorParams, SIFT3D
cfg = json.loads(sys.argv[1])
vol = make_phantom(48)
for name, knobs in cfg["cases"].items():
    det = SIFT3D(DetectorParams(**knobs))
    kp = det.detect_keypoints(vol)
    d = det.extract_descriptors(kp)
    np.savez(f"{cfg['out']}/{name}.npz", coords=kp.coords, octave=kp.octave,
             level=kp.level, sd=kp.sd, strength=kp.strength, R=kp.R,
             desc=d.data, xyz=d.xyz)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """JAX's keypoints and descriptors under every KNOB_CASES value, from
    one child process."""
    out = tmp_path_factory.mktemp("jax_knobs")
    cfg = dict(out=str(out), cases=KNOB_CASES)
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=SSE4_2").strip())
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(cfg)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    return out


@pytest.mark.parametrize("field", JAX_FIELDS, ids=lambda f: f.name)
def test_port_has_every_jax_field_with_its_default(field):
    ours = {f.name: f for f in dataclasses.fields(st.DetectorParams)}
    assert field.name in ours
    assert ours[field.name].default == field.default
    assert getattr(st.DetectorParams(), field.name) == \
        getattr(JaxParams(), field.name)


def test_port_has_no_field_jax_lacks():
    assert [f.name for f in dataclasses.fields(st.DetectorParams)] == \
        [f.name for f in JAX_FIELDS]


@pytest.mark.parametrize("field, value", INVALID,
                         ids=[f"{f}={v}" for f, v in INVALID])
def test_value_jax_refuses_is_refused_with_its_error(field, value):
    with pytest.raises(ValueError) as jax_err:
        JaxParams(**{field: value})
    with pytest.raises(ValueError) as port_err:
        st.DetectorParams(**{field: value})
    assert str(port_err.value) == str(jax_err.value)


def test_from_jax_params_keeps_every_field():
    assert set(NON_DEFAULT) == {f.name for f in JAX_FIELDS}
    jp = JaxParams(**NON_DEFAULT)
    tp = st.from_jax_params(dataclasses.asdict(jp))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    for f in JAX_FIELDS:
        assert getattr(tp, f.name) != f.default, f.name
    # A field the port does not know raises instead of being dropped.
    with pytest.raises(ValueError, match="bogus_knob"):
        st.from_jax_params(dict(dataclasses.asdict(jp), bogus_knob=1))


@pytest.mark.parametrize("name", list(KNOB_CASES))
def test_knob_value_meets_bars_against_jax(jax_ref, name):
    """The port under the knob value (computing its exact f32 path) against
    JAX under the same value: identical rows (coordinates, octave, level,
    order, scale), R within 1e-5, every descriptor within 1% rel-L2, and
    the stale strength within 1.2e-7 relative of JAX's sequential order.
    JAX's composed builder rounds the levels otherwise and moves the
    strengths (DoG values) further from its own sequential order than
    that; against it the port's strengths may differ by as much as JAX's
    two orders differ, plus the bar."""
    ref = np.load(jax_ref / f"{name}.npz")
    seq = np.load(jax_ref / "gpyr_impl=incremental.npz")
    params = st.from_jax_params(dataclasses.asdict(
        JaxParams(**KNOB_CASES[name])))
    det = st.SIFT3D(params, "cpu")
    kp = det.detect_keypoints(make_phantom(48))
    assert len(kp) == len(ref["coords"]) > 0
    for f in ("coords", "octave", "level", "sd"):
        assert np.array_equal(getattr(kp, f), ref[f]), f
    bar = 1.2e-7 * np.abs(seq["strength"])
    assert np.all(np.abs(kp.strength - seq["strength"]) <= bar)
    gap = np.abs(seq["strength"] - ref["strength"])
    assert np.all(np.abs(kp.strength - ref["strength"]) <= gap + bar)
    assert np.abs(kp.R - ref["R"]).max() <= 1e-5
    d = det.extract_descriptors(kp)
    err = (np.linalg.norm(d.data - ref["desc"], axis=1)
           / np.linalg.norm(ref["desc"], axis=1))
    assert np.all(err <= 0.01), err.max()
    assert np.array_equal(d.xyz, ref["xyz"])


def test_knobs_do_not_change_the_port():
    """Every knob at a non-default value gives the default's bits: the
    port computes one path (on the card: chip_smoke.py)."""
    knobs = {k: NON_DEFAULT[k] for k in
             ("kp_per_level", "conv_precision", "desc_precision",
              "conv_tail_precision", "conv_exact_from_octave", "gpyr_impl",
              "dense_octave_acc", "dense_octave_cand", "sparse_desc_groups",
              "split_desc_chunks", "min_chunk_cost", "hint_history",
              "desc_vbins", "extrema_impl")}
    vol = make_phantom(48)
    out = []
    for params in (st.DetectorParams(), st.DetectorParams(**knobs)):
        det = st.SIFT3D(params, "cpu")
        kp = det.detect_keypoints(vol)
        out.append((kp, det.extract_descriptors(kp), det._funnel))
    (a, da, fa), (b, db, fb) = out
    for f in ("coords", "octave", "level", "sd", "strength", "R"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(da.data, db.data) and fa == fb
