"""The traffic generator: the same pool from a seed, another from
another seed, and pairs whose moving volume is the fixed one under the
affine they carry."""

import numpy as np
import pytest
import torch

from benchmark import harness

SPARSE = dict(n=24, batch=2, pool=2, blobs=150, centre=[0.08, 0.92],
              width=[0.01, 0.06], amp=[0.2, 1.0])
PAIRS = dict(SPARSE, batch=1, pool=1, pairs=True, rot_deg=[6.0, 10.0],
             shift_vox=4.0)
BIG_SEED = 2 ** 31 + 12345


def _gen():
    return harness.load("generators", "blob_phantoms")


@pytest.mark.parametrize("params", [SPARSE, PAIRS], ids=["vols", "pairs"])
def test_same_seed_same_pool_other_seed_other_pool(params):
    a = _gen().make(params, BIG_SEED, "cpu")
    b = _gen().make(params, BIG_SEED, "cpu")
    c = _gen().make(params, BIG_SEED + 1, "cpu")
    for x, y, z in zip(a, b, c):
        for key in x:
            assert np.array_equal(np.asarray(x[key]), np.asarray(y[key]))
            assert not np.array_equal(np.asarray(x[key]), np.asarray(z[key]))


def test_pool_shapes_and_batches_differ():
    pool = _gen().make(SPARSE, 7, "cpu")
    assert len(pool) == 2
    for batch in pool:
        assert batch["vols"].shape == (2, 24, 24, 24)
        assert batch["vols"].dtype == torch.float32
    assert not torch.equal(pool[0]["vols"], pool[1]["vols"])


def test_moving_volume_is_the_fixed_one_under_the_affine():
    gen = _gen()
    p = dict(PAIRS, n=32)
    batch = gen.make(p, 11, "cpu")[0]
    fixed, moving = batch["fixed"][0], batch["moving"][0]
    A = batch["affine"][0]
    th = np.degrees(np.arctan2(A[1, 0], A[0, 0]))
    assert 6.0 <= th <= 10.0
    assert np.allclose(A[:, :3] @ A[:, :3].T, np.eye(3))
    # moving(x) = fixed(A x): at voxels whose image lies on the grid's
    # interior, a trilinear sample of the fixed volume.
    x = np.array([16.0, 15.0, 14.0])
    y = A[:, :3] @ x + A[:, 3]
    want = gen.warp(fixed, A)[16, 15, 14]
    assert torch.equal(moving[16, 15, 14], want)
    i = np.floor(y).astype(int)
    corner = fixed[i[0]:i[0] + 2, i[1]:i[1] + 2, i[2]:i[2] + 2]
    assert corner.min() - 1e-6 <= float(want) <= corner.max() + 1e-6


def test_warp_by_the_identity_is_the_volume():
    vol = _gen().make(SPARSE, 3, "cpu")[0]["vols"][0]
    eye = np.hstack([np.eye(3), np.zeros((3, 1))])
    assert torch.allclose(_gen().warp(vol, eye), vol, atol=1e-6)
