"""pipeline.describe_host_ms.kp: host time a call in description's
host-only stages (sift3d.describe.check, .gather, .scatter: the key
check, the per-octave gather of the keypoints' fields, the descriptors
scattered into each volume's lists), outside the crossing spans within
them (the gather's uploads), in ms. Nothing is queued on the card
meanwhile."""

from benchmark.metrics import _recorder


def read(run):
    return _recorder.per_call(
        lambda c: _recorder.span_ms(c, _recorder.DESCRIBE_HOST, own=True))
