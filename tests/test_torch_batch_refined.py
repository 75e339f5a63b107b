"""The port's refined batch path (subvoxel refinement and Hessian edge
rejection, BASELINE config 2's extensions) vs the JAX package's, on the
CPU: detect_keypoints_batch + extract_descriptors_batch on two distinct
48^3 phantoms, with JAX in a child process capped at SSE4.2 (see
tests/test_torch_batch.py), to the refined bars: the same rows in the same
order, coordinates within 1e-5, sd within 1e-6 relative, the true
strengths exact, R within 1e-5, descriptors within 1% relative L2. A file
of its own so that each file's JAX child compiles one batch program."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import REFINED, check_batch_against_jax, \
    run_jax_child  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_refined_batch_matches_jax(tmp_path):
    check_batch_against_jax(*run_jax_child(tmp_path, REFINED, False),
                            REFINED)
