"""Prefetching batch volume loader.

Counterpart of sift3d_tpu/io/loader.py. Many volumes stream through
``SIFT3D.detect_keypoints_batch``, and the card should not wait on host
IO, so the loader overlaps the two:

 - a background thread assembles batches ahead of the consumer (a bounded
   queue, ``prefetch`` deep);
 - each batch is read by the native threaded reader
   (``native.nifti_read_batch``: header parse + gunzip + typed cast +
   x-fastest -> C-order transpose, fanned out over std::threads, one
   GIL-free call per batch);
 - a volume the native reader does not take (.hdr/.img pairs, big-endian
   files) is read by the numpy reader, file by file, so any mix of inputs
   works;
 - on a CUDA device the producer thread reads each batch into pinned host
   memory and uploads it on a CUDA stream of its own (``non_blocking``),
   records an event, and keeps the pinned buffer until the copy is done;
   the consumer's stream waits on that event before the batch is used.

A batch holds volumes of one shape (the batched pipeline's contract);
``group_by_shape`` groups a mixed dataset from the headers alone (348
bytes per file, no payload read).
"""

from __future__ import annotations

import queue
import struct
import threading

import numpy as np
import torch

from .. import native
from .nifti import _HDR_SIZE, _open_maybe_gz, _resolve_pair, read_nifti


def peek_header(path):
    """(shape tuple, nc, units) of a NIfTI file from its 348-byte header
    (no payload read)."""
    hdr_path, _ = _resolve_pair(path)
    with _open_maybe_gz(hdr_path) as f:
        hdr = f.read(_HDR_SIZE)
    if len(hdr) < _HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")
    endian = "<"
    if struct.unpack_from("<i", hdr, 0)[0] != _HDR_SIZE:
        if struct.unpack_from(">i", hdr, 0)[0] != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        endian = ">"
    dim = struct.unpack_from(endian + "8h", hdr, 40)
    pixdim = struct.unpack_from(endian + "8f", hdr, 76)
    nc = dim[4] if dim[0] == 4 else 1
    units = tuple(float(u) for u in pixdim[1:4])
    if not all(u > 0 for u in units):
        units = (1.0, 1.0, 1.0)
    return (dim[1], dim[2], dim[3]), int(nc), units


def group_by_shape(paths):
    """Group paths by (shape, nc) from headers alone. Returns
    {(shape, nc): [paths]} preserving order within groups."""
    groups: dict = {}
    for p in paths:
        shape, nc, _ = peek_header(p)
        groups.setdefault((shape, nc), []).append(p)
    return groups


def _read_batch(paths, shape, nthreads, out: np.ndarray | None = None):
    """One batch as (vols f32[B, nx, ny, nz], units f32[B, 3]): the native
    threaded reader, then the numpy reader for each volume the native one
    returned a non-zero code for. out, where given, is the f32[B, nx, ny,
    nz] buffer to read into."""
    n = len(paths)
    count = int(np.prod(shape))
    if out is not None and not out.flags.c_contiguous:
        raise ValueError("_read_batch: out must be contiguous")
    flat, dims, units, rc = native.nifti_read_batch(
        paths, count, nthreads, None if out is None else out.reshape(n, -1))
    vols = flat.reshape((n,) + tuple(shape))
    for i in range(n):
        if rc[i] == 0 and tuple(dims[i, :3]) != tuple(shape):
            raise ValueError(f"{paths[i]}: shape {tuple(dims[i, :3])} != "
                             f"batch shape {tuple(shape)}")
    for i in np.nonzero(rc)[0]:
        data, u = read_nifti(paths[i])
        if data.ndim == 4:
            if data.shape[-1] != 1:
                raise ValueError(
                    f"{paths[i]}: only single-channel volumes are "
                    "supported by the detector")
            data = data[..., 0]
        if data.shape != tuple(shape):
            raise ValueError(f"{paths[i]}: shape {data.shape} != batch "
                             f"shape {tuple(shape)}")
        vols[i] = data
        units[i] = u
    return vols, units


class BatchVolumeLoader:
    """Iterates (vols f32[B, nx, ny, nz] on `device`, units (ux, uy, uz))
    batches with background prefetch.

    paths: NIfTI files of ONE shape (see group_by_shape); batch_size: B of
    the full batches (the final batch may be smaller); prefetch: how many
    batches the background thread keeps ready; nthreads: native reader
    threads per batch (0 = one per volume, capped at the CPU count);
    device: where the batches go (default the card; "cpu" uploads
    nothing).

    All volumes of a batch must agree on voxel units; a mismatch raises at
    iteration time.
    """

    def __init__(self, paths, batch_size: int = 8, prefetch: int = 2,
                 nthreads: int = 0, device: torch.device | str = "cuda"):
        self.paths = [str(p) for p in paths]
        if not self.paths:
            raise ValueError("no input paths")
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.prefetch = max(1, int(prefetch))
        self.nthreads = int(nthreads)
        self.device = torch.device(device)
        self.shape, nc, _ = peek_header(self.paths[0])
        if nc != 1:
            raise ValueError("only single-channel volumes are supported")

    def __len__(self):
        return -(-len(self.paths) // self.batch_size)

    def _produce_one(self, chunk, stream):
        """One batch as (vols, units, sync): on the card, read into pinned
        memory and uploaded on `stream`, sync = (the event recorded after
        the copy, the pinned buffer to hold until it completes); else
        sync is None."""
        if self.device.type != "cuda":
            vols, units = _read_batch(chunk, self.shape, self.nthreads)
            return torch.from_numpy(vols).to(self.device), units, None
        pinned = torch.empty((len(chunk),) + tuple(self.shape),
                             dtype=torch.float32, pin_memory=True)
        _, units = _read_batch(chunk, self.shape, self.nthreads,
                               pinned.numpy())
        with torch.cuda.stream(stream):
            vols = pinned.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return vols, units, (event, pinned)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)

        def produce():
            try:
                for i in range(0, len(self.paths), self.batch_size):
                    if stop.is_set():
                        return
                    vols, units, sync = self._produce_one(
                        self.paths[i:i + self.batch_size], stream)
                    q.put(("ok", (vols, units,
                                  None if sync is None else sync[0])))
                    if sync is not None:   # the copy is done before the
                        sync[0].synchronize()   # pinned buffer is freed
                    del sync
                q.put(("done", None))
            except Exception as e:  # raised again on the consumer side
                q.put(("err", e))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise payload
                vols, units, event = payload
                if event is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    # The batch was allocated on the loader's stream: its
                    # memory is not reused before this stream's work on it.
                    vols.record_stream(consumer)
                if not np.allclose(units, units[0:1], rtol=1e-5):
                    raise ValueError(
                        "mixed voxel units within a batch: "
                        f"{np.unique(units, axis=0)}")
                yield vols, tuple(float(x) for x in units[0])
        finally:
            stop.set()
            # drain so the producer is never blocked on put() forever
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)


def iter_volume_batches(paths, batch_size: int = 8, prefetch: int = 2,
                        nthreads: int = 0,
                        device: torch.device | str = "cuda"):
    """Convenience generator over BatchVolumeLoader."""
    return iter(BatchVolumeLoader(paths, batch_size, prefetch, nthreads,
                                  device))
