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


def _launches(*kernels):
    """Launches of each kernel symbol so far (the recorder's counters)."""
    from sift3d_tpu_torch import profiling
    n = tuple(profiling.counter("launch." + k) for k in kernels)
    return n if len(n) > 1 else n[0]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _rand(shape, seed, dev):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)) \
        .to(dev)


@pytest.mark.parametrize("shape, units", [
    ((33, 20, 45), (1, 1, 1)),
    ((16, 24, 13), (1, 1, 1.5)),
    ((40, 36, 44), (0.5, 0.5, 1.0)),    # 34-tap bands in x and y
    ((48, 40, 36), (1, 1, 2.5)),
    ((8, 8, 8), (1, 1, 1)),             # one octave, bands clipped by the dims
])
def test_blur_chain_bit_exact(dev, shape, units):
    """Every octave of the pyramid from s3d_blur_x + s3d_blur_yz_dog
    equals the plain chain bit for bit (levels, DoG, max |DoG|)."""
    from sift3d_tpu_torch.params import DetectorParams
    from sift3d_tpu_torch.pyramid import build_gpyr_and_dog, make_plan
    plan = make_plan(shape, units, DetectorParams())
    x = _rand(shape, 1, dev)
    n0 = _launches("s3d_blur_x", "s3d_blur_yz_dog")
    got = build_gpyr_and_dog(x, plan)
    L = plan.num_gpyr_levels
    levels = L + (plan.num_octaves - 1) * (L - 1)
    assert _launches("s3d_blur_x") - n0[0] == levels
    assert _launches("s3d_blur_yz_dog") - n0[1] == levels
    ref = build_gpyr_and_dog(x.cpu(), plan)
    for o in range(plan.num_octaves):
        for a, b in zip(got, ref):
            assert torch.equal(a[o].cpu(), b[o]), o


def _candidates(ek, dog, thr, cuboid, **kw):
    keys, counts = ek.extrema_candidates(dog, thr, cuboid, **kw)
    return torch.sort(keys).values.cpu(), counts.cpu()


@pytest.mark.parametrize("cuboid", [False, True])
@pytest.mark.parametrize("shape", [(3, 3, 3), (9, 30, 17), (21, 40, 70)])
def test_extrema_candidates_identical(dev, shape, cuboid):
    """Keys and per-level counts of s3d_extrema_candidates equal the plain
    route (mask, nonzero, keys), also when the capacity is too small and
    the kernel runs again with the exact one."""
    from sift3d_tpu_torch.ops import extrema_kernel as ek
    dog = _rand((5,) + shape, 2, dev)
    thr = torch.tensor([0.1, 0.2, 0.0], device=dev)
    rk, rc = ek.extrema_candidates_plain(dog.cpu(), thr.cpu(), cuboid)
    rk = torch.sort(rk).values
    n0 = _launches("s3d_extrema_candidates")
    keys, counts = _candidates(ek, dog, thr, cuboid)
    fits = rk.numel() <= ek.default_capacity(dog.shape)
    assert _launches("s3d_extrema_candidates") - n0 == (1 if fits else 2)
    assert torch.equal(keys, rk) and torch.equal(counts, rc)
    if rk.numel() > 1:
        n0 = _launches("s3d_extrema_candidates")
        keys, counts = _candidates(ek, dog, thr, cuboid, capacity=1)
        assert _launches("s3d_extrema_candidates") - n0 == 2
        assert torch.equal(keys, rk) and torch.equal(counts, rc)


def test_extrema_candidates_flat_dog(dev):
    from sift3d_tpu_torch.ops import extrema_kernel as ek
    dog = torch.zeros((5, 12, 12, 12), device=dev)
    keys, counts = _candidates(ek, dog, torch.zeros(3, device=dev), False)
    assert keys.shape == (0,) and torch.equal(counts, torch.zeros(3).long())


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
    n0 = _launches("s3d_orient")
    got = ok.orient(levels, lvl, coords, sd, units, params)
    assert _launches("s3d_orient") - n0 == 1
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
        ek.extrema_candidates(dog.double(), torch.zeros(3, device=dev))
    with pytest.raises(ValueError):
        ek.extrema_candidates(dog.transpose(1, 3),
                              torch.zeros(3, device=dev))
    from sift3d_tpu_torch.params import DetectorParams
    with pytest.raises(ValueError):     # int32 levels index
        dk.desc_fused(dog[:3], torch.zeros(2, dtype=torch.int32, device=dev),
                      torch.zeros((2, 3), device=dev),
                      torch.zeros((2, 3, 3), device=dev),
                      torch.ones(2, device=dev), (1, 1, 1), DetectorParams(),
                      1.0)


def _fractional(dev, K, shape, nl, seed):
    """Random keypoints of one octave at fractional centers: integer
    anchors i64[K, 3] in the interior, centers f32[K, 3] within a voxel of
    them, scales f32[K] up to 2^(1/nl) above the largest level's."""
    g = np.random.default_rng(seed)
    anchors = np.stack([g.integers(1, n - 1, K) for n in shape], axis=1)
    centers = (anchors + g.uniform(-1, 1, (K, 3))).astype(np.float32)
    lvl = g.integers(0, nl, K)
    sd = g.uniform(1.0, 4.0, K).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (lvl, anchors, centers, sd))


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.0, 1.5)])
def test_orient_fractional_close(dev, units):
    """s3d_orient at fractional centers (subvoxel refinement) vs
    orient_plain with the fractional margin: identical predicates, A and
    vd within rel 1e-5, R within 1e-5 where accepted."""
    from sift3d_tpu_torch.ops import ori_kernel as ok
    from sift3d_tpu_torch.params import DetectorParams
    params = DetectorParams()
    shape = (30, 28, 33)
    levels = _rand((3,) + shape, 13, dev)
    K = 21
    lvl, anchors, centers, sd = _fractional(dev, K, shape, 3, 14)
    kw = dict(centers=centers, sd_max=4.0, fractional=True)
    n0 = _launches("s3d_orient")
    got = ok.orient(levels, lvl, anchors, sd, units, params, **kw)
    assert _launches("s3d_orient") - n0 == 1
    ref = ok.orient_plain(levels, lvl, anchors, sd, units, params, **kw)
    for a, b in ((got.A, ref.A), (got.vd, ref.vd)):
        err = (a - b).abs().reshape(K, -1).amax(1)
        scale = b.abs().reshape(K, -1).amax(1)
        assert bool((err <= 1e-5 * scale).all())
    for name in ("accepted", "reject_grad", "reject_ratio", "reject_corner"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    acc = ref.accepted
    if bool(acc.any()):
        assert float((got.R[acc] - ref.R[acc]).abs().max()) <= 1e-5


@pytest.mark.parametrize("units", [(1.0, 1.0, 1.0), (1.0, 1.0, 1.5)])
def test_desc_fused_fractional_close(dev, units):
    """s3d_desc_fused at fractional centers vs the plain version with the
    fractional margin: rel-L2 <= 1e-5 per keypoint."""
    from sift3d_tpu_torch.ops import desc_kernel as dk
    from sift3d_tpu_torch.params import DetectorParams
    shape = (40, 36, 44)
    levels = _rand((3,) + shape, 15, dev)
    K = 6
    lvl, _, centers, _ = _fractional(dev, K, shape, 3, 16)
    sd = torch.tensor([1.6, 2.0, 2.5, 1.8, 2.9, 3.1], device=dev)
    Q, _ = torch.linalg.qr(_rand((K, 3, 3), 17, dev))
    args = (levels, lvl, centers, Q.contiguous(), sd, units,
            DetectorParams(), 3.2, True)
    got = dk.desc_fused(*args)
    ref = dk.desc_fused_plain(*args)
    rel = (got - ref).reshape(K, -1).norm(dim=1) / ref.reshape(K, -1) \
        .norm(dim=1)
    assert bool((rel <= 1e-5).all()), rel


def test_register_on_card(dev):
    """register on the card: the rotated and shifted 128^3 bench pair
    (tools/bench_registration.py make_pair) within 2 voxels of the truth;
    matching and RANSAC on the card's descriptors give the CPU's pairs and
    inliers (the hypotheses come from one seeded CPU generator)."""
    from sift3d_tpu_torch import SIFT3D, DetectorParams, Volume
    from sift3d_tpu_torch import registration as reg
    from sift3d_tpu_torch.phantoms import bench_volume
    n = 128
    rng = np.random.default_rng(3)
    th = np.deg2rad(rng.uniform(6, 10))
    Rz = np.array([[np.cos(th), -np.sin(th), 0],
                   [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    c = np.array([(n - 1) / 2.0] * 3)
    A = np.zeros((3, 4), np.float32)
    A[:, :3] = Rz
    A[:, 3] = c - Rz @ c + rng.uniform(-4, 4, 3)
    M = np.eye(4)
    M[:3] = A
    fixed = Volume.from_array(bench_volume("sparse", n, dev), device=dev)
    moving = reg.warp_volume(fixed, np.linalg.inv(M)[:3].astype(np.float32),
                             (n, n, n), device=dev)
    det = SIFT3D(DetectorParams(refine_subvoxel=True), dev)
    res = reg.register(fixed, moving, detectors=det, device=dev)
    corners = np.array([[x, y, z, 1.0] for x in (0, n - 1)
                        for y in (0, n - 1) for z in (0, n - 1)])
    err = np.linalg.norm(corners @ (res.affine - A).T, axis=1).mean()
    assert res.num_inliers >= 8 and err < 2.0, (res.num_inliers, err)

    kf = det.detect_keypoints(fixed)
    df = det.extract_descriptors(kf)
    km = det.detect_keypoints(moving)
    dm = det.extract_descriptors(km)
    got = reg.match_descriptors(dm, df, device=dev)
    ref = reg.match_descriptors(dm, df, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    src, dst = dm.xyz[got[0]], df.xyz[got[1]]
    w = 1.0 / (4.0 ** km.octave[got[0]] + 4.0 ** kf.octave[got[1]])
    Ag, mg = reg.ransac_affine(src, dst, weights=w, device=dev)
    Ac, mc = reg.ransac_affine(src, dst, weights=w, device="cpu")
    assert np.array_equal(mg, mc)
    assert np.abs(Ag - Ac).max() <= 1e-3


@pytest.mark.parametrize("shape, units", [
    ((33, 20, 45), (1, 1, 1)),
    ((40, 36, 44), (0.5, 0.5, 1.0)),    # 34-tap bands in x and y
])
def test_blur_chain_batch_bit_exact(dev, shape, units):
    """A batch of three volumes through the chain: each volume's octaves
    equal its own plain chain bit for bit (levels, DoG, max |DoG| per
    volume), with as many launches as one volume takes."""
    from sift3d_tpu_torch.params import DetectorParams
    from sift3d_tpu_torch.pyramid import build_gpyr_and_dog, make_plan
    plan = make_plan(shape, units, DetectorParams())
    x = torch.stack([_rand(shape, s, dev) for s in (1, 2, 3)])
    n0 = _launches("s3d_blur_x", "s3d_blur_yz_dog")
    got = build_gpyr_and_dog(x, plan)
    L = plan.num_gpyr_levels
    levels = L + (plan.num_octaves - 1) * (L - 1)
    assert _launches("s3d_blur_x") - n0[0] == levels
    assert _launches("s3d_blur_yz_dog") - n0[1] == levels
    for b in range(3):
        ref = build_gpyr_and_dog(x[b].cpu(), plan)
        for o in range(plan.num_octaves):
            for a, r in zip(got, ref):
                assert torch.equal(a[o][b].cpu(), r[o]), (b, o)


@pytest.mark.parametrize("cuboid", [False, True])
def test_extrema_candidates_batch_identical(dev, cuboid):
    """One launch for a batch of stacks: each volume's keys offset by b
    times its key range and counts [B, nl] equal the per-volume plain
    route, also through the capacity relaunch."""
    from sift3d_tpu_torch.ops import extrema_kernel as ek
    dog = _rand((3, 5, 21, 40, 70), 2, dev)
    thr = torch.tensor([[0.1, 0.2, 0.0], [0.3, 0.0, 0.1], [0.0, 0.0, 0.0]],
                       device=dev)
    per = 3 * 21 * 40 * 70
    ref = [ek.extrema_candidates_plain(dog[b].cpu(), thr[b].cpu(), cuboid)
           for b in range(3)]
    rk = torch.cat([torch.sort(k).values + b * per
                    for b, (k, _) in enumerate(ref)])
    fits = rk.numel() <= ek.default_capacity(dog.shape)
    for cap in (None, 1):
        n0 = _launches("s3d_extrema_candidates")
        keys, counts = _candidates(ek, dog, thr, cuboid, capacity=cap)
        assert _launches("s3d_extrema_candidates") - n0 == \
            (1 if cap is None and fits else 2)
        assert torch.equal(keys, rk)
        assert torch.equal(counts, torch.stack([c for _, c in ref]))


def test_orient_and_desc_on_a_batch_stack(dev):
    """s3d_orient and s3d_desc_fused on a batch's flattened level stack
    [B * L, ...] (keypoint level l of volume b at b * L + 1 + l) give each
    volume's own launch bit for bit (orientation) and the plain version's
    histograms within rel-L2 1e-5."""
    from sift3d_tpu_torch.ops import desc_kernel as dk
    from sift3d_tpu_torch.ops import ori_kernel as ok
    from sift3d_tpu_torch.params import DetectorParams
    params = DetectorParams()
    B, L, shape = 3, 6, (30, 28, 33)
    gpyr = _rand((B, L) + shape, 21, dev)
    K = 12
    lvl, coords, sd = _octave_keypoints(dev, K, shape, 3, 22)
    b = torch.arange(K, device=dev) % B
    stack = gpyr.reshape((B * L,) + shape)
    got = ok.orient(stack, b * L + 1 + lvl, coords, sd, (1, 1, 1), params)
    for v in range(B):
        sel = b == v
        one = ok.orient(gpyr[v, 1:4], lvl[sel], coords[sel],
                        sd[sel].contiguous(), (1, 1, 1), params)
        assert torch.equal(one.A, got.A[sel]) and torch.equal(one.R,
                                                              got.R[sel])
    Q, _ = torch.linalg.qr(_rand((K, 3, 3), 23, dev))
    args = (stack, b * L + 1 + lvl, coords.float(), Q.contiguous(), sd,
            (1, 1, 1), params, 3.2)
    h = dk.desc_fused(*args)
    ref = dk.desc_fused_plain(*args)
    rel = (h - ref).reshape(K, -1).norm(dim=1) / ref.reshape(K, -1).norm(
        dim=1).clamp(min=1e-30)
    assert bool((rel <= 1e-5).all()), rel


def test_batch_pipeline_on_card(dev):
    """detect_keypoints_batch on the card: each volume's rows equal its own
    detect_keypoints on the card, descriptors within rel-L2 1e-5 (the
    descriptor kernel's atomics add in a changing order), with the launches
    of one volume for the blur and the extrema."""
    import sift3d_tpu_torch as st
    from sift3d_tpu_torch.phantoms import bench_volume
    vols = torch.stack([bench_volume("sparse", 64, dev),
                        bench_volume("sparse", 64, dev, seed=5),
                        bench_volume("dense", 64, dev)])
    det = st.SIFT3D(st.DetectorParams(), dev)
    one = st.SIFT3D(st.DetectorParams(), dev)
    n0 = _launches("s3d_blur_x", "s3d_extrema_candidates")
    one.detect_keypoints(vols[0])
    n1 = _launches("s3d_blur_x", "s3d_extrema_candidates")
    kps = det.detect_keypoints_batch(vols)
    n2 = _launches("s3d_blur_x", "s3d_extrema_candidates")
    assert tuple(b - a for a, b in zip(n1, n2)) == \
        tuple(b - a for a, b in zip(n0, n1))
    dss = det.extract_descriptors_batch(kps)
    for v in range(3):
        kp = one.detect_keypoints(vols[v])
        for f in ("coords", "octave", "level", "sd", "strength", "R"):
            assert np.array_equal(getattr(kp, f), getattr(kps[v], f)), f
        if len(kp):
            d = one.extract_descriptors(kp)
            norm = np.linalg.norm(d.data, axis=1)
            rel = (np.linalg.norm(d.data - dss[v].data, axis=1)
                   / np.where(norm > 0, norm, 1.0))
            assert rel.max() <= 1e-5


def test_loader_uploads_on_card(dev, tmp_path):
    """BatchVolumeLoader(device="cuda"): pinned reads uploaded on the
    loader's stream, the consumer's stream waiting on the copy; the batches
    equal the CPU loader's."""
    from sift3d_tpu_torch.io import BatchVolumeLoader, write_volume
    paths = []
    for i in range(5):
        paths.append(tmp_path / f"v{i}.nii{'.gz' if i == 4 else ''}")
        write_volume(paths[-1], np.random.default_rng(i).normal(
            size=(20, 18, 16)).astype(np.float32))
    gpu = list(BatchVolumeLoader(paths, batch_size=2, device=dev))
    cpu = list(BatchVolumeLoader(paths, batch_size=2, device="cpu"))
    assert [v.shape[0] for v, _ in gpu] == [2, 2, 1]
    for (g, gu), (c, cu) in zip(gpu, cpu):
        assert g.is_cuda and gu == cu and torch.equal(g.cpu(), c)


def test_desc_fused_repeats_its_bits(dev):
    """s3d_desc_fused sums in exact integers: two calls give the same
    bits, and each keypoint's histogram is the same in any launch (alone,
    in a subset, in another order), whatever the split; still within
    rel-L2 1e-5 of the plain version."""
    from sift3d_tpu_torch.ops import desc_kernel as dk
    from sift3d_tpu_torch.params import DetectorParams
    shape = (40, 36, 44)
    levels = _rand((3,) + shape, 21, dev)
    K = 12
    lvl, _, centers, _ = _fractional(dev, K, shape, 3, 22)
    sd = torch.linspace(1.6, 3.1, K, device=dev)
    Q, _ = torch.linalg.qr(_rand((K, 3, 3), 23, dev))
    R = Q.contiguous()
    args = (DetectorParams(), 3.2, True)

    def run(sel):
        return dk.desc_fused(levels, lvl[sel], centers[sel], R[sel], sd[sel],
                             (1.0, 1.0, 1.0), *args)
    every = torch.arange(K, device=dev)
    a, b = run(every), run(every)
    assert torch.equal(a, b)
    for sel in (every[:1], every[3:8], every.flip(0)):
        assert torch.equal(run(sel), a[sel])
    ref = dk.desc_fused_plain(levels, lvl, centers, R, sd, (1.0, 1.0, 1.0),
                              *args)
    rel = (a - ref).reshape(K, -1).norm(dim=1) / ref.reshape(K, -1) \
        .norm(dim=1)
    assert bool((rel <= 1e-5).all()), rel


def _phantom_octave0(dev, n=64):
    """Octave 0 of the sparse bench phantom at n^3 on the card: plan,
    params, levels, DoG, max |DoG|, candidates."""
    from sift3d_tpu_torch.detect import detect_extrema_octave
    from sift3d_tpu_torch.params import DetectorParams
    from sift3d_tpu_torch.phantoms import bench_volume
    from sift3d_tpu_torch.pyramid import (build_gpyr_and_dog, make_plan,
                                          scale_to_unit)
    params = DetectorParams()
    x = scale_to_unit(bench_volume("dense", n, dev))
    plan = make_plan(x.shape, (1.0, 1.0, 1.0), params)
    g, d, m = build_gpyr_and_dog(x, plan)
    cand = detect_extrema_octave(d[0], m[0], params)
    return plan, params, x, g[0], d[0], m[0], cand


def test_slab_launches_equal_whole_volume(dev):
    """Each kernel launched on four haloed z-slabs of octave 0 equals one
    whole-volume launch bit for bit: the pyramid (x pass per slab, y/z +
    DoG on the haloed x output), the extrema keys, the orientation (A,
    vd, R, flags) at integer and fractional centers, the descriptors."""
    from sift3d_tpu_torch.ops import desc_kernel as dk
    from sift3d_tpu_torch.ops import extrema_kernel as ek
    from sift3d_tpu_torch.ops import ori_kernel as ok
    from sift3d_tpu_torch.parallel import z_extend
    from sift3d_tpu_torch.parallel.spatial import (build_gpyr_sharded,
                                                   desc_halo, ori_halo)
    from sift3d_tpu_torch.pyramid import build_gpyr_and_dog
    plan, params, x, gpyr, dog, dmax, cand = _phantom_octave0(dev)
    n, nz = 16, 64
    slabs = [c.contiguous() for c in x.chunk(4, dim=-1)]
    octs, flags = build_gpyr_sharded(slabs, plan, [dev] * 4)
    whole = build_gpyr_and_dog(x, plan)
    for o, sl in enumerate(octs):
        assert torch.equal(torch.cat([s.gpyr for s in sl], -1), whole[0][o])
        assert torch.equal(torch.cat([s.dog for s in sl], -1), whole[1][o])
    nl = params.num_kp_levels
    thr = (params.peak_thresh * dmax[1:1 + nl]).contiguous()
    keys, _ = ek.extrema_candidates(dog, thr)
    parts = [ek.extrema_candidates(e, thr, z_origin=n * s - 1, global_nz=nz,
                                   z_rows=(1, n + 1))[0]
             for s, e in enumerate(z_extend([c.contiguous() for c in
                                             dog.chunk(4, dim=-1)], 1))]
    assert torch.equal(torch.sort(torch.cat(parts)).values,
                       torch.sort(keys).values)
    levels = gpyr[1:1 + nl]
    lslabs = [c.contiguous() for c in levels.chunk(4, dim=-1)]
    K = cand.level.numel()
    sd = torch.tensor(plan.scales[0][1:1 + nl], device=dev)[cand.level]
    g = np.random.default_rng(5)
    for frac in (False, True):
        centers = cand.coords.float()
        sd_max = plan.scales[0][nl]
        if frac:
            centers = centers + torch.from_numpy(
                g.uniform(-1, 1, (K, 3)).astype(np.float32)).to(dev)
            sd_max *= 2.0 ** (1.0 / nl)
        kw = dict(centers=centers.contiguous(), sd_max=sd_max,
                  fractional=frac)
        ref = ok.orient(levels, cand.level, cand.coords, sd, plan.units,
                        params, **kw)
        R = ref.R.contiguous()
        dref = dk.desc_fused(levels, cand.level, kw["centers"], R, sd,
                             plan.units, params, sd_max, frac)
        h = ori_halo(plan, 0, type(params)(refine_subvoxel=frac))
        hd = desc_halo(plan, 0, params, frac)
        owner = torch.clamp(torch.round(centers[:, 2]).long() // n, 0, 3)
        for s in range(4):
            sel = (cand.coords[:, 2] >= n * s) & (cand.coords[:, 2] < n * s + n)
            got = ok.orient(z_extend(lslabs, h)[s], cand.level[sel],
                            cand.coords[sel], sd[sel], plan.units, params,
                            centers=kw["centers"][sel], sd_max=sd_max,
                            fractional=frac, z_origin=n * s - h,
                            global_nz=nz)
            for f in got._fields:
                assert torch.equal(getattr(got, f), getattr(ref, f)[sel]), f
            mine = owner == s
            dg = dk.desc_fused(z_extend(lslabs, hd)[s], cand.level[mine],
                               kw["centers"][mine], R[mine], sd[mine],
                               plan.units, params, sd_max, frac,
                               z_origin=n * s - hd, global_nz=nz)
            assert torch.equal(dg, dref[mine]), s


def _box_rows(c, sd, sig_fctr, rad_fctr, u, nz):
    """Global rows [a, b) that the kernels read for a keypoint at z c of
    scale sd: its loop-bound box along z (f32, as the kernels) with the
    gradient border."""
    f = np.float32
    rad = f(f(f(sd) * f(sig_fctr)) * f(rad_fctr))
    ra = f(rad / f(u))
    lo = max(int(np.floor(f(f(c) - ra))), 1)
    hi = min(int(np.ceil(f(f(c) + ra))), nz - 2)
    return lo - 1, hi + 2


def test_slab_short_of_a_box_reads_nan(dev, monkeypatch):
    """A z-slab that holds exactly a keypoint's box and its gradient
    border gives the whole-volume launch's bits; one row short at either
    end, the kernels read nothing outside it: the orientation's A, vd and
    R read NaN with no flag set, the descriptor row NaN. ShardedSIFT3D
    with a halo too thin raises."""
    from sift3d_tpu_torch.ops import desc_kernel as dk
    from sift3d_tpu_torch.ops import ori_kernel as ok
    from sift3d_tpu_torch.parallel import ShardedSIFT3D, make_mesh, spatial
    from sift3d_tpu_torch.phantoms import bench_volume
    plan, params, _, gpyr, _, _, cand = _phantom_octave0(dev)
    nl, nz = params.num_kp_levels, plan.octave_dims[0][2]
    levels = gpyr[1:1 + nl]
    k = int(np.argmin(np.abs(cand.coords[:, 2].cpu().numpy() - nz // 2)))
    lvl, co = cand.level[k:k + 1], cand.coords[k:k + 1]
    sd = torch.tensor(plan.scales[0][1:1 + nl], device=dev)[lvl]
    sd_max = plan.scales[0][nl]
    ref = ok.orient(levels, lvl, co, sd, plan.units, params, sd_max=sd_max)
    R = ref.R.contiguous()
    centers = co.float().contiguous()
    dref = dk.desc_fused(levels, lvl, centers, R, sd, plan.units, params,
                         sd_max)
    assert not torch.isnan(dref).any()

    def ori(a, b):
        return ok.orient(levels[..., a:b].contiguous(), lvl, co, sd,
                         plan.units, params, sd_max=sd_max, z_origin=a,
                         global_nz=nz)

    def desc(a, b):
        return dk.desc_fused(levels[..., a:b].contiguous(), lvl, centers, R,
                             sd, plan.units, params, sd_max, z_origin=a,
                             global_nz=nz)
    c, s = float(co[0, 2]), float(sd[0])
    a, b = _box_rows(c, s, params.ori_sig_fctr, params.ori_rad_fctr,
                     plan.units[2], nz)
    assert 0 < a and b < nz
    got = ori(a, b)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    for a2, b2 in ((a + 1, b), (a, b - 1)):
        got = ori(a2, b2)
        for f in ("A", "vd", "R"):
            assert torch.isnan(getattr(got, f)).all(), f
        for f in ("accepted", "reject_grad", "reject_ratio",
                  "reject_corner"):
            assert not getattr(got, f).any(), f
    a, b = _box_rows(c, s, params.desc_sig_fctr, params.desc_rad_fctr,
                     plan.units[2], nz)
    assert 0 < a and b < nz
    assert torch.equal(desc(a, b), dref)
    for a2, b2 in ((a + 1, b), (a, b - 1)):
        assert torch.isnan(desc(a2, b2)).all()
    # The sharded detector's own halos, made too thin.
    vol = bench_volume("dense", 64, dev)
    mesh = make_mesh({"z": 4}, [dev] * 4)
    with monkeypatch.context() as m:
        m.setattr(spatial, "ori_halo", lambda *a: 0)
        with pytest.raises(ValueError, match="orientation window"):
            ShardedSIFT3D(params, mesh=mesh).detect_keypoints(vol)
    det = ShardedSIFT3D(params, mesh=mesh)
    kp = det.detect_keypoints(vol)
    assert len(kp) > 0
    monkeypatch.setattr(spatial, "desc_halo", lambda *a: 1)
    with pytest.raises(ValueError, match="descriptor window"):
        det.extract_descriptors(kp)


@pytest.mark.parametrize("ext", [{}, {"refine_subvoxel": True,
                                      "edge_thresh": 10.0}],
                         ids=["default", "refined"])
def test_sharded_sift3d_on_card(dev, ext):
    """ShardedSIFT3D on four shards of one card equals SIFT3D on the card
    bit for bit, rows and descriptors, and every shard launches the
    kernels; the batch over a mesh axis equals the unsharded batch."""
    import sift3d_tpu_torch as st
    from sift3d_tpu_torch.parallel import MeshBatchSIFT3D, ShardedSIFT3D, \
        make_mesh
    from sift3d_tpu_torch.phantoms import bench_volume
    vol = bench_volume("dense", 64, dev)
    p = st.DetectorParams(**ext)
    one = st.SIFT3D(p, dev)
    kp1 = one.detect_keypoints(vol)
    ds1 = one.extract_descriptors(kp1)
    det = ShardedSIFT3D(p, mesh=make_mesh({"z": 4}, [dev] * 4))
    n0 = _launches("s3d_blur_yz_dog")
    kp2 = det.detect_keypoints(vol)
    assert _launches("s3d_blur_yz_dog") - n0 > 4 * 6
    ds2 = det.extract_descriptors(kp2)
    assert len(kp1) > 5
    for f in ("coords", "octave", "level", "sd", "strength", "R"):
        assert np.array_equal(getattr(kp1, f), getattr(kp2, f)), f
    assert np.array_equal(ds1.data, ds2.data)
    assert np.array_equal(ds1.xyz, ds2.xyz)
    vols = torch.stack([vol, bench_volume("sparse", 64, dev), vol.flip(0)])
    kps = one.detect_keypoints_batch(vols)
    dss = one.extract_descriptors_batch(kps)
    mb = MeshBatchSIFT3D(p, make_mesh({"b": 2}, [dev] * 2))
    got = mb.detect_keypoints_batch(vols)
    gds = mb.extract_descriptors_batch(got)
    for a, b, c, d in zip(kps, got, dss, gds):
        assert np.array_equal(a.coords, b.coords) and \
            np.array_equal(a.R, b.R) and np.array_equal(c.data, d.data)


@pytest.mark.parametrize("ext", [{}, {"refine_subvoxel": True,
                                      "edge_thresh": 10.0}],
                         ids=["default", "refined"])
def test_funnel_on_card_equals_cpu(dev, ext):
    """The detection funnel on the card equals the plain versions' on the
    CPU, count for count, for a 64^3 phantom."""
    import sift3d_tpu_torch as st
    from sift3d_tpu_torch.phantoms import bench_volume
    vol = bench_volume("dense", 64, dev)
    p = st.DetectorParams(**ext)
    card, cpu = st.SIFT3D(p, dev), st.SIFT3D(p, "cpu")
    kp = card.detect_keypoints(vol)
    ref = cpu.detect_keypoints(vol.cpu())
    assert len(kp) == len(ref) > 5
    assert card._funnel and card._funnel == cpu._funnel
    assert list(card._funnel) == list(cpu._funnel)
    assert sum(f["survivors"] for f in card._funnel.values()) == len(kp)


def test_stage_sync_waits_for_the_card(dev):
    """A stage whose sync holds a CUDA result measures at least the
    device time of the kernels that made it."""
    from sift3d_tpu_torch import profiling
    a = torch.randn(4096, 4096, device=dev) / 64.0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = profiling.StageTimes()
    out = []
    with times.stage("matmuls", sync=out):
        start.record()
        x = a
        for _ in range(5):
            x = x @ a
        out.append(x)
        end.record()
    end.synchronize()
    device_ms = start.elapsed_time(end)
    assert device_ms > 1.0
    assert times.times["matmuls"] * 1e3 >= device_ms


def test_host_syncs_equal_sync_debug_warnings(dev, tmp_path):
    """One detect_keypoints_batch + extract_descriptors_batch call: under
    torch.cuda.set_sync_debug_mode("warn") it warns exactly as often as the
    recorder counts host_syncs: one count read an octave, one copy of the
    rows and one of the descriptors. In the profiler's trace each host
    sync is one DtoH copy and each stream-ordered upload (h2d_async) one
    HtoD copy, the h2d_bytes + d2h_bytes counted are those copies' bytes,
    and no pinned block is allocated anew after the warm-up call."""
    import json
    import warnings
    import sift3d_tpu_torch as st
    from sift3d_tpu_torch import profiling
    from sift3d_tpu_torch.phantoms import bench_volume
    vols = torch.stack([bench_volume("sparse", 64, dev),
                        bench_volume("sparse", 64, dev, seed=5)])
    det = st.SIFT3D(st.DetectorParams(), dev)
    det.extract_descriptors_batch(det.detect_keypoints_batch(vols))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                kps = det.detect_keypoints_batch(vols)
                det.extract_descriptors_batch(kps)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    calls = profiling.read()["calls"][-2:]
    assert [c["root"] for c in calls] == ["sift3d.detect_batch",
                                          "sift3d.describe_batch"]

    def total(*names):
        return sum(c["counters"].get(k, 0) for c in calls for k in names)
    syncs, uploads = total("host_syncs"), total("h2d_async")
    assert det.sub_batch == 2 and sum(map(len, kps)) > 0
    assert syncs == det._plan.num_octaves + 2
    warned = [w for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]
    assert syncs == len(warned), (syncs, [str(w.message) for w in warned])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert not [e for e in events if e.get("name") == "cudaHostAlloc"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    up = [e for e in copies if "HtoD" in e["name"]]
    down = [e for e in copies if "DtoH" in e["name"]]
    assert len(up) == uploads > 0
    assert len(down) == syncs
    assert total("h2d_bytes", "d2h_bytes") == sum(
        int(e["args"]["bytes"]) for e in up + down)


def test_to_device_keeps_the_values_of_its_call(dev):
    """An upload queued behind a long run of kernels returns before the
    card reaches it, and lands with the values the array held at the
    call, though the caller overwrites the array at once."""
    from sift3d_tpu_torch import profiling
    a = torch.randn(4096, 4096, device=dev) / 64.0
    torch.cuda.synchronize()
    before = (profiling.counter("h2d_async"), profiling.counter("host_syncs"))
    x = a
    for _ in range(20):
        x = x @ a
    host = np.arange(1 << 20, dtype=np.float32)
    want = host.copy()
    t = profiling.to_device(host, None, dev)
    busy = not torch.cuda.current_stream(dev).query()
    host[:] = -1.0
    torch.cuda.synchronize()
    assert busy
    assert np.array_equal(t.cpu().numpy(), want)
    assert (profiling.counter("h2d_async"),
            profiling.counter("host_syncs")) == (before[0] + 1, before[1])
    del x


def test_back_to_back_uploads_under_load_stay_intact(dev):
    """Hundreds of same-size uploads of distinct values, all queued behind
    a long run of kernels: each lands intact, so no pinned block is handed
    out again before its copy has run."""
    from sift3d_tpu_torch import profiling
    a = torch.randn(4096, 4096, device=dev) / 64.0
    torch.cuda.synchronize()
    x = a
    for _ in range(20):
        x = x @ a
    outs = []
    for i in range(400):
        outs.append(profiling.to_device(np.full(4096, i, np.float32), None,
                                        dev) + x[0, 0] * 0)
    torch.cuda.synchronize()
    got = torch.stack(outs).cpu().numpy()
    want = np.repeat(np.arange(400, dtype=np.float32)[:, None], 4096, 1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64, torch.bool])
def test_to_host_equals_cpu_bit_for_bit(dev, dtype):
    """to_host (pinned, one wait) equals .cpu() bit for bit, also for a
    strided view and for a tensor the kernels before it are still
    writing."""
    from sift3d_tpu_torch import profiling
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(1000, 771, device=dev, generator=g)
    x[3, 5], x[7, 0] = float("nan"), float("inf")
    a = torch.randn(4096, 4096, device=dev) / 64.0
    y = a
    for _ in range(10):
        y = y @ a
    x = x + y[:1000, :771] * 0
    x = x > 0 if dtype == torch.bool else x.to(dtype)
    for t in (x, x[::3, 1::2]):
        got = profiling.to_host(t)
        assert got.is_pinned() and got.dtype == t.dtype
        want = t.cpu()
        assert got.shape == want.shape
        assert np.array_equal(got.numpy().view(np.uint8),
                              want.contiguous().numpy().view(np.uint8))


def test_scalar_threshold_equals_f32_tensor_product_on_card(dev):
    """detect_extrema_octave's threshold, max |DoG| times peak_thresh as
    a Python scalar, is bit for bit the product with an f32 tensor on the
    card too."""
    g = np.random.default_rng(3)
    mag = g.random(200_000).astype(np.float32) + np.float32(0.5)
    exp = g.integers(-140, 127, mag.size).astype(np.int32)
    v = torch.from_numpy(np.ldexp(mag, exp)).to(dev)
    for p in (0.1, 0.02, 1 / 3):
        want = torch.tensor(p, dtype=torch.float32, device=dev) * v
        got = v * p
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
