"""CUDA kernels vs their plain versions, at small and awkward shapes.

Needs a CUDA GPU and nvcc (the kernels are built at first use): every test
here is marked ``cuda`` and skips without a card. The file imports no jax,
so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _rand(shape, seed, dev):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)) \
        .to(dev)


@pytest.mark.parametrize("shape, units", [((33, 20, 45), (1, 1, 1)),
                                          ((16, 24, 13), (1, 1, 1.5))])
def test_blur_chain_bit_exact(dev, shape, units):
    from sift3d_tpu_torch.ops import blur_kernel as bk
    from sift3d_tpu_torch.params import DetectorParams
    from sift3d_tpu_torch.pyramid import make_plan
    plan = make_plan(shape, units, DetectorParams())
    x = _rand(shape, 1, dev)
    n0 = bk.axis_pass_launches
    gp, dog, dmax = bk.chain_octave(x, plan, 0)
    assert bk.axis_pass_launches - n0 == 3 * plan.num_gpyr_levels
    gc, dc, mc = bk.chain_octave(x.cpu(), plan, 0)
    assert torch.equal(gp.cpu(), gc) and torch.equal(dog.cpu(), dc)
    assert torch.equal(dmax.cpu(), mc)


@pytest.mark.parametrize("cuboid", [False, True])
@pytest.mark.parametrize("shape", [(3, 3, 3), (9, 30, 17)])
def test_extrema_mask_identical(dev, shape, cuboid):
    from sift3d_tpu_torch.ops import extrema_kernel as ek
    dog = _rand((5,) + shape, 2, dev)
    thr = torch.tensor([0.1, 0.2, 0.0], device=dev)
    got = ek.extrema_mask(dog, thr, cuboid)
    assert torch.equal(got, ek.extrema_mask_plain(dog, thr, cuboid))


def _octave_keypoints(dev, K, shape, nl, seed):
    """Random keypoints of one octave: levels i64[K], integer centers
    i64[K, 3] anywhere (borders included), scales f32[K]."""
    g = np.random.default_rng(seed)
    coords = np.stack([g.integers(0, n, K) for n in shape], axis=1)
    lvl = g.integers(0, nl, K)
    sd = g.uniform(1.0, 3.2, K).astype(np.float32)
    return (torch.from_numpy(lvl).to(dev), torch.from_numpy(coords).to(dev),
            torch.from_numpy(sd).to(dev))


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.0, 1.5)])
def test_orient_close(dev, units):
    """The fused orientation kernel vs orient_plain: identical predicates,
    A and vd within rel 1e-5, R within 1e-5 where accepted."""
    from sift3d_tpu_torch.ops import ori_kernel as ok
    from sift3d_tpu_torch.params import DetectorParams
    params = DetectorParams()
    levels = _rand((3, 30, 28, 33), 3, dev)
    K = 13   # no multiple-of-8 requirement
    lvl, coords, sd = _octave_keypoints(dev, K, (30, 28, 33), 3, 4)
    n0 = ok.launches
    got = ok.orient(levels, lvl, coords, sd, units, params)
    assert ok.launches - n0 == 1
    ref = ok.orient_plain(levels, lvl, coords, sd, units, params)
    for a, b in ((got.A, ref.A), (got.vd, ref.vd)):
        err = (a - b).abs().reshape(K, -1).amax(1)
        scale = b.abs().reshape(K, -1).amax(1)
        assert bool((err <= 1e-5 * scale).all())
    for name in ("accepted", "reject_grad", "reject_ratio", "reject_corner"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    acc = ref.accepted
    if bool(acc.any()):
        assert float((got.R[acc] - ref.R[acc]).abs().max()) <= 1e-5


def _bits_equal(a, b):
    """Bitwise equality, any NaN equal to any NaN."""
    same = a.view(torch.int32) == b.view(torch.int32)
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


def test_eigh3x3_bit_exact(dev):
    """s3d_eigh3x3 equals the plain eigh3x3 bit for bit on the card, on
    random, degenerate, zero and NaN matrices."""
    from sift3d_tpu_torch.ops import ori_kernel as ok
    g = np.random.default_rng(8)
    M = g.normal(size=(500, 3, 3)).astype(np.float32)
    A = np.concatenate([
        np.einsum("kij,klj->kil", M, M),
        np.eye(3, dtype=np.float32)[None],
        np.diag([1.0, 1.0, 2.0]).astype(np.float32)[None],
        np.zeros((1, 3, 3), np.float32),
        np.full((1, 3, 3), np.nan, np.float32),
    ])
    A = torch.from_numpy(A).to(dev)
    w, V = ok.eigh3x3(A)
    wr, Vr = ok.eigh3x3_plain(A)
    assert _bits_equal(w, wr) and _bits_equal(V, Vr)


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.0, 1.5)])
def test_desc_fused_close(dev, units):
    """The fused descriptor kernel vs prep_windows + desc_hist_plain, with
    keypoints on the borders too: rel-L2 <= 1e-5 per keypoint."""
    from sift3d_tpu_torch.ops import desc_kernel as dk
    from sift3d_tpu_torch.params import DetectorParams
    params = DetectorParams()
    shape = (40, 36, 44)
    levels = _rand((3,) + shape, 6, dev)
    K = 5
    lvl, coords, _ = _octave_keypoints(dev, K, shape, 3, 7)
    sd = torch.tensor([1.6, 2.0, 2.5, 1.8, 1.6], device=dev)
    Q, _ = torch.linalg.qr(_rand((K, 3, 3), 9, dev))
    args = (levels, lvl, coords.float(), Q.contiguous(), sd, units, params,
            2.5)
    got = dk.desc_fused(*args)
    ref = dk.desc_fused_plain(*args)
    rel = (got - ref).reshape(K, -1).norm(dim=1) / ref.reshape(K, -1) \
        .norm(dim=1)
    assert bool((rel <= 1e-5).all()), rel


def test_wrappers_reject_bad_tensors(dev):
    from sift3d_tpu_torch.ops import desc_kernel as dk
    from sift3d_tpu_torch.ops import extrema_kernel as ek
    dog = _rand((5, 8, 8, 8), 7, dev)
    with pytest.raises(ValueError):
        ek.extrema_mask(dog.double(), torch.zeros(3, device=dev))
    with pytest.raises(ValueError):
        ek.extrema_mask(dog.transpose(1, 3), torch.zeros(3, device=dev))
    from sift3d_tpu_torch.params import DetectorParams
    with pytest.raises(ValueError):     # int32 levels index
        dk.desc_fused(dog[:3], torch.zeros(2, dtype=torch.int32, device=dev),
                      torch.zeros((2, 3), device=dev),
                      torch.zeros((2, 3, 3), device=dev),
                      torch.ones(2, device=dev), (1, 1, 1), DetectorParams(),
                      1.0)
