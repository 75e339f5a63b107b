"""pipeline.copy_mb_per_call.kp: bytes a call through the program's
crossings, both ways (its counters h2d_bytes + d2h_bytes), in MB (10^6
bytes): the keypoint rows and descriptors home, the uploads of the
describe gather and the small per-octave uploads and count reads."""

from benchmark.metrics import _recorder


def read(run):
    value = _recorder.per_call(
        lambda c: _recorder.counted(c, ("h2d_bytes", "d2h_bytes")))
    return None if value is None else value * 1e-6
