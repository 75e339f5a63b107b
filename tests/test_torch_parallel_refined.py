"""The port's ShardedSIFT3D with subvoxel refinement and Hessian edge
rejection (BASELINE config 2's DetectorParams) on four CPU shards.

Refinement, the edge test and the orientation of fractional centres run
shard-local (parallel/spatial.py). The results equal the port's
single-device refined SIFT3D bit for bit, meet the refine bars against
JAX's single-device SIFT3D (coordinates 1e-5, sd 1e-6 relative, strength
exact, R 1e-5, descriptors within 1% relative L2), and JAX's GSPMD
extension tolerances against JAX's ShardedSIFT3D, which runs the
single-device program on the z-sharded input (tests/test_sharding.py:
224-235). JAX runs in a child process of its own, as in
tests/test_torch_parallel.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import make_phantom  # noqa: E402

import sift3d_tpu_torch as st  # noqa: E402
from sift3d_tpu_torch.parallel import MeshBatchSIFT3D, \
    ShardedSIFT3D  # noqa: E402
from test_torch_parallel import (check_against_jax, cpu_mesh,  # noqa: E402
                                 run_jax_child, same_desc, same_rows)

N = 64
REFINED = {"refine_subvoxel": True, "edge_thresh": 10.0}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax_child(tmp_path_factory.mktemp("jax_refined"), REFINED, N)


@pytest.fixture(scope="module")
def port_runs():
    vol = make_phantom(N)
    p = st.DetectorParams(**REFINED)
    one = st.SIFT3D(p, "cpu")
    kp1 = one.detect_keypoints(vol)
    det = ShardedSIFT3D(p, mesh=cpu_mesh())
    kp2 = det.detect_keypoints(vol)
    return (kp1, one.extract_descriptors(kp1)), \
        (kp2, det.extract_descriptors(kp2), det)


def test_refined_sharded_equals_port_single_device(port_runs):
    """Fractional coordinates, refined scales, true strengths, R and
    descriptors of the four shards equal the single-device port's."""
    (kp1, ds1), (kp2, ds2, det) = port_runs
    assert all(det._shard_flags)
    assert len(kp1) > 3 and np.any(kp1.coords != np.rint(kp1.coords))
    assert same_rows(kp1, kp2) and same_desc(ds1, ds2)


@pytest.mark.parametrize("name", ["single", "sharded"])
def test_refined_sharded_matches_jax(jax_ref, port_runs, name):
    _, (kp, ds, _) = port_runs
    check_against_jax(kp, ds, jax_ref, name, refined=True)


def test_refined_batch_over_mesh_equals_unsharded():
    """The refined batch over a two-device axis equals the unsharded
    refined batch bit for bit."""
    vols = np.stack([make_phantom(40, nblobs=40, seed=s) for s in (31, 32)])
    p = st.DetectorParams(**REFINED)
    ref = st.SIFT3D(p, "cpu")
    kps = ref.detect_keypoints_batch(vols)
    dss = ref.extract_descriptors_batch(kps)
    det = MeshBatchSIFT3D(p, cpu_mesh(2, "b"), "b")
    got = det.detect_keypoints_batch(vols)
    gds = det.extract_descriptors_batch(got)
    assert sum(len(k) for k in kps) > 3
    assert all(same_rows(a, b) for a, b in zip(kps, got))
    assert all(same_desc(a, b) for a, b in zip(dss, gds))
