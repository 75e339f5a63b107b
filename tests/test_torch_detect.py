"""Port extrema mask and candidates vs the JAX reference."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sift3d_tpu.detect import detect_extrema_octave as jax_detect  # noqa
from sift3d_tpu.params import DetectorParams as JaxParams  # noqa: E402
from sift3d_tpu_torch.detect import detect_extrema_octave  # noqa: E402
from sift3d_tpu_torch.ops.extrema_kernel import extrema_mask  # noqa: E402
from sift3d_tpu_torch.params import from_jax_params  # noqa: E402


def _dog(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(5,) + shape).astype(np.float32)


@pytest.mark.parametrize("cuboid", [False, True])
def test_mask_matches_pallas_kernel_interpret(cuboid):
    """At a shape the TPU kernel takes (nx % 8 == 0, nz % 128 == 0)."""
    from sift3d_tpu.ops.extrema_kernel import extrema_mask_pallas
    dog = _dog((24, 64, 128), 4)
    thr = (np.float32(0.1) * np.abs(dog[1:4]).max(axis=(1, 2, 3))) \
        .astype(np.float32)
    ref = np.asarray(extrema_mask_pallas(jnp.asarray(dog), jnp.asarray(thr),
                                         cuboid=cuboid, interpret=True))
    got = extrema_mask(torch.from_numpy(dog), torch.from_numpy(thr), cuboid)
    assert got.dtype == torch.int8
    assert ref.sum() > 0
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("cuboid", [False, True])
@pytest.mark.parametrize("shape", [(20, 18, 22), (16, 24, 13)])
def test_candidates_match_jax_xla_path(shape, cuboid):
    jp = JaxParams(extrema_impl="xla", cuboid_extrema=cuboid)
    tp = from_jax_params(dataclasses.asdict(jp))
    dog = _dog(shape, 9)
    dogmax = np.abs(dog).max(axis=(1, 2, 3)).astype(np.float32)

    got = detect_extrema_octave(torch.from_numpy(dog),
                                torch.from_numpy(dogmax), tp)
    n = int(got.counts.sum())
    assert n > 0
    ref = jax_detect(jnp.asarray(dog), jp, capacity=n + 8,
                     dogmax=jnp.asarray(dogmax))
    valid = np.asarray(ref.valid)
    assert int(valid.sum()) == n
    assert np.array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert np.array_equal(got.coords.numpy(), np.asarray(ref.coords)[valid])
    assert np.array_equal(got.level.numpy(), np.asarray(ref.level)[valid])
    assert np.array_equal(got.strength.numpy(),
                          np.asarray(ref.strength)[valid])


def test_no_candidates_on_flat_dog():
    tp = from_jax_params(dataclasses.asdict(JaxParams()))
    dog = torch.zeros((5, 12, 12, 12))
    got = detect_extrema_octave(dog, torch.zeros(5), tp)
    assert got.coords.shape == (0, 3) and int(got.counts.sum()) == 0
