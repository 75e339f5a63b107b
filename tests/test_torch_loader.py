"""The port's batch loader and native IO runtime vs the JAX package's
(sift3d_tpu.io.loader, sift3d_tpu.native), byte for byte on the same
files: headers, grouping by shape, loader batches of .nii, .nii.gz, a
.hdr/.img pair and a big-endian file (the last two read by the numpy
reader, by file), a shape mismatch, the typed cast and the CSV writer.
The loader runs with device="cpu" here (no upload); on the card it reads
into pinned memory and uploads on its own stream (tests/test_torch_cuda.py
and chip_smoke.py)."""

import gzip
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import make_phantom  # noqa: E402

from sift3d_tpu import native as jnative  # noqa: E402
from sift3d_tpu.io import loader as jloader  # noqa: E402
from sift3d_tpu.io import nifti as jnifti  # noqa: E402
from sift3d_tpu.keypoints import _write_csv as jax_write_csv  # noqa: E402
import sift3d_tpu_torch as st  # noqa: E402
from sift3d_tpu_torch import native  # noqa: E402
from sift3d_tpu_torch.io import loader, nifti, write_volume  # noqa: E402
from sift3d_tpu_torch.keypoints import write_csv  # noqa: E402

SHAPE = (12, 10, 8)


def _write_set(tmp_path, n, shape=SHAPE, units=(1.0, 1.5, 2.0),
               suffix=".nii", seed=7):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = tmp_path / f"vol_{i}{suffix}"
        nifti.write_nifti(p, rng.normal(size=shape).astype(np.float32),
                          units)
        paths.append(p)
    return paths


def _big_endian(path, data):
    """A big-endian single-file NIfTI-1 float32 volume."""
    hdr = bytearray(352)
    struct.pack_into(">i", hdr, 0, 348)
    struct.pack_into(">8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into(">h", hdr, 70, 16)
    struct.pack_into(">h", hdr, 72, 32)
    struct.pack_into(">8f", hdr, 76, 0.0, 1.0, 1.5, 2.0, 1, 1, 1, 1)
    struct.pack_into(">f", hdr, 108, 352.0)
    hdr[344:348] = b"n+1\x00"
    path.write_bytes(bytes(hdr) + data.transpose(2, 1, 0).astype(">f4")
                     .tobytes())
    return path


def _port_batches(paths, **kw):
    return [(v.numpy(), u) for v, u in
            loader.iter_volume_batches(paths, device="cpu", **kw)]


def _same_batches(got, ref):
    assert len(got) == len(ref)
    for (gv, gu), (rv, ru) in zip(got, ref):
        assert gv.dtype == rv.dtype == np.float32
        assert gv.tobytes() == np.asarray(rv).tobytes() and gu == ru


def test_peek_header_and_group_by_shape_match_jax(tmp_path):
    paths = _write_set(tmp_path, 2, shape=(6, 5, 4), units=(2.0, 1.0, 3.0))
    (tmp_path / "big").mkdir()
    paths += _write_set(tmp_path / "big", 1, shape=(8, 8, 8),
                        suffix=".nii.gz")
    nifti.write_nifti(tmp_path / "pair.hdr", np.zeros((6, 5, 4), np.float32))
    paths.append(tmp_path / "pair.img")
    paths.append(_big_endian(tmp_path / "be.nii",
                             np.zeros((6, 5, 4), np.float32)))
    for p in paths:
        assert loader.peek_header(p) == jloader.peek_header(p)
    assert loader.peek_header(paths[0]) == ((6, 5, 4), 1, (2.0, 1.0, 3.0))
    got, ref = loader.group_by_shape(paths), jloader.group_by_shape(paths)
    assert got == ref and len(got) == 2


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_loader_batches_match_jax(tmp_path, suffix):
    paths = _write_set(tmp_path, 5, suffix=suffix)
    got = _port_batches(paths, batch_size=2)
    assert [v.shape[0] for v, _ in got] == [2, 2, 1]
    assert all(u == (1.0, 1.5, 2.0) for _, u in got)
    _same_batches(got, list(jloader.iter_volume_batches(paths,
                                                        batch_size=2)))


def test_loader_pair_and_big_endian_match_jax(tmp_path):
    """A .hdr/.img pair and a big-endian file: the native reader returns a
    non-zero code for each, and the numpy reader reads them, as JAX's
    loader does."""
    paths = _write_set(tmp_path, 2)
    nifti.write_nifti(tmp_path / "pair.hdr",
                      np.full(SHAPE, 0.5, np.float32), (1.0, 1.5, 2.0))
    be = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    paths += [tmp_path / "pair.hdr", _big_endian(tmp_path / "be.nii", be)]
    _, _, _, rc = native.nifti_read_batch(paths, int(np.prod(SHAPE)))
    assert rc.tolist()[:2] == [0, 0] and rc[2] != 0 and rc[3] != 0
    got = _port_batches(paths, batch_size=4)
    assert got[0][0][3].tobytes() == be.tobytes()
    _same_batches(got, list(jloader.iter_volume_batches(paths,
                                                        batch_size=4)))


def test_loader_shape_mismatch_raises(tmp_path):
    paths = _write_set(tmp_path, 2)
    nifti.write_nifti(tmp_path / "odd.nii", np.zeros((4, 4, 4), np.float32))
    paths.append(tmp_path / "odd.nii")
    with pytest.raises(ValueError, match="shape"):
        _port_batches(paths, batch_size=3)
    with pytest.raises(ValueError, match="shape"):
        list(jloader.iter_volume_batches(paths, batch_size=3))


def test_native_read_batch_matches_jax(tmp_path):
    paths = _write_set(tmp_path, 3, suffix=".nii.gz")
    count = int(np.prod(SHAPE))
    got = native.nifti_read_batch(paths, count, 2)
    ref = jnative.nifti_read_batch(paths, count, 2)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    out = np.zeros((3, count), np.float32)
    assert native.nifti_read_batch(paths, count, out=out)[0] is out
    assert out.tobytes() == ref[0].tobytes()


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.float64,
                                   np.int8, np.uint16, np.uint32, np.int64,
                                   np.uint64])
def test_native_cast_matches_jax(tmp_path, dtype):
    """The typed cast, with and without scl_slope/scl_inter, and a file of
    that datatype read by both packages' read_nifti."""
    code = {v: k for k, v in nifti._DTYPES.items()}[dtype]
    raw = (np.random.default_rng(3).integers(0, 120, np.prod(SHAPE))
           .astype(dtype))
    for slope, inter, apply in ((1.0, 0.0, False), (0.25, -3.0, True)):
        got = native.cast_to_f32(raw.tobytes(), code, raw.size, slope,
                                 inter, apply)
        ref = jnative.cast_to_f32(raw.tobytes(), code, raw.size, slope,
                                  inter, apply)
        assert got.tobytes() == ref.tobytes()
    nifti.write_nifti(tmp_path / "f.nii", np.zeros(SHAPE, np.float32))
    hdr = bytearray((tmp_path / "f.nii").read_bytes()[:352])
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, 8 * np.dtype(dtype).itemsize)
    struct.pack_into("<f", hdr, 112, 0.25)
    struct.pack_into("<f", hdr, 116, -3.0)
    path = tmp_path / "typed.nii"
    path.write_bytes(bytes(hdr) + raw.tobytes())
    (gd, gu), (rd, ru) = nifti.read_nifti(path), jnifti.read_nifti(path)
    assert gd.tobytes() == rd.tobytes() and gu == ru
    with pytest.raises(ValueError, match="datatype"):
        native.cast_to_f32(raw.tobytes(), 3, raw.size, 1.0, 0.0, False)


@pytest.mark.parametrize("name", ["k.csv", "k.csv.gz"])
def test_native_csv_matches_jax(tmp_path, name):
    """A plain matrix and a keypoint store, written by the port's native
    writer and by the JAX package's: the same bytes (after gunzip for
    .gz)."""
    rng = np.random.default_rng(5)
    mat = np.concatenate([rng.normal(0, 1e3, (20, 15)),
                          [[0.0, -0.0, 1e-7, -1e-7, 0.5e-6, 1.5e-6,
                            123456789.123456789, 2.5, 3.5, -2.5, 1 / 3,
                            np.float32(0.1), 7.0000005, 1e12, -1e-12]]])
    read = gzip.open if name.endswith(".gz") else open

    def data(p):
        with read(p, "rb") as f:
            return f.read()
    write_csv(tmp_path / f"p_{name}", mat)
    jax_write_csv(tmp_path / f"j_{name}", mat)
    assert data(tmp_path / f"p_{name}") == data(tmp_path / f"j_{name}")
    kp = st.Keypoints(coords=rng.integers(0, 9, (6, 3)).astype(np.float64),
                      octave=np.arange(6, dtype=np.int32) % 3,
                      level=np.zeros(6, np.int32), sd=rng.uniform(1, 3, 6),
                      strength=rng.uniform(0, 1, 6),
                      R=rng.normal(size=(6, 3, 3)).astype(np.float32))
    kp.save(tmp_path / f"kp_{name}")
    from sift3d_tpu.keypoints import Keypoints as JaxKeypoints
    JaxKeypoints(kp.coords, kp.octave, kp.level, kp.sd, kp.strength,
                 kp.R).save(str(tmp_path / f"jkp_{name}"))
    assert data(tmp_path / f"kp_{name}") == data(tmp_path / f"jkp_{name}")
    text = data(tmp_path / f"kp_{name}").decode().splitlines()
    assert len(text) == 6 and len(text[0].split(",")) == 15


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message; nothing
    falls back."""
    bad = tmp_path / "fastio.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.lib()
    assert not (tmp_path / "build" / native.LIB_NAME).exists()


def test_loader_feeds_batch_detection(tmp_path):
    """Loader batches (.nii.gz) drive detect_keypoints_batch, and each
    volume's keypoints equal its own detect_keypoints."""
    vols = [make_phantom(24, nblobs=10, seed=s) for s in (1, 2, 3)]
    paths = []
    for i, v in enumerate(vols):
        paths.append(tmp_path / f"mri_{i}.nii.gz")
        write_volume(paths[-1], v)
    det = st.SIFT3D(st.DetectorParams(), "cpu")
    batches = list(loader.BatchVolumeLoader(paths, batch_size=3,
                                            device="cpu"))
    assert len(batches) == 1 and isinstance(batches[0][0], torch.Tensor)
    kps = det.detect_keypoints_batch(*batches[0])
    one = st.SIFT3D(st.DetectorParams(), "cpu")
    for kp, v in zip(kps, vols):
        ref = one.detect_keypoints(v)
        assert np.array_equal(kp.coords, ref.coords)
        assert np.array_equal(kp.strength, ref.strength)
    assert sum(len(k) for k in kps) > 0


def test_loader_defaults_to_the_card(tmp_path):
    """The loader's default device is the card: without one, iterating
    raises instead of yielding CPU tensors."""
    paths = _write_set(tmp_path, 1)
    ld = loader.BatchVolumeLoader(paths)
    assert ld.device == torch.device("cuda") and len(ld) == 1
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            list(ld)
