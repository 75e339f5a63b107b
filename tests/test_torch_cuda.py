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


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.0, 1.5)])
def test_ori_moments_close(dev, units):
    from sift3d_tpu_torch.ops import ori_kernel as ok
    levels = _rand((3, 30, 28, 33), 3, dev)
    g = np.random.default_rng(4)
    K = 13   # no multiple-of-8 requirement
    coords = torch.from_numpy(np.stack(
        [g.integers(0, n, K) for n in (30, 28, 33)], axis=1)).to(dev)
    lvl = torch.from_numpy(g.integers(0, 3, K)).to(dev)
    sd = torch.from_numpy(g.uniform(1.0, 3.2, K).astype(np.float32)).to(dev)
    fp = torch.cat([coords.float(), sd[:, None]], dim=1).contiguous()
    A, vd = ok.ori_moments(levels, lvl, fp, units, 1.5, 3.0)
    Ar, vr = ok.ori_moments_plain(levels, lvl, fp, units, 1.5, 3.0)
    for got, ref in ((A, Ar), (vd, vr)):
        err = (got - ref).abs().reshape(K, -1).amax(1)
        scale = ref.abs().reshape(K, -1).amax(1)
        assert bool((err <= 1e-5 * scale).all())


def test_desc_hist_close(dev):
    from sift3d_tpu_torch.ops import desc_kernel as dk
    K, N = 5, 20_011
    g = np.random.default_rng(6)
    grot = g.standard_normal((K, 3, N)).astype(np.float32)
    grot[:, :, ::7] = 0.0                     # masked voxels
    vbins = g.uniform(0.0, 3.999, (K, 3, N)).astype(np.float32)
    grot, vbins = (torch.from_numpy(a).to(dev) for a in (grot, vbins))
    got = dk.desc_hist(grot, vbins, 1.1920929e-06)
    ref = dk.desc_hist_plain(grot, vbins, 1.1920929e-06)
    rel = (got - ref).reshape(K, -1).norm(dim=1) / ref.reshape(K, -1) \
        .norm(dim=1)
    assert bool((rel <= 1e-5).all())


def test_wrappers_reject_bad_tensors(dev):
    from sift3d_tpu_torch.ops import desc_kernel as dk
    from sift3d_tpu_torch.ops import extrema_kernel as ek
    dog = _rand((5, 8, 8, 8), 7, dev)
    with pytest.raises(ValueError):
        ek.extrema_mask(dog.double(), torch.zeros(3, device=dev))
    with pytest.raises(ValueError):
        ek.extrema_mask(dog.transpose(1, 3), torch.zeros(3, device=dev))
    with pytest.raises(ValueError):
        dk.desc_hist(torch.zeros((2, 3, 8), device=dev),
                     torch.zeros((2, 3, 9), device=dev), 1e-6)
