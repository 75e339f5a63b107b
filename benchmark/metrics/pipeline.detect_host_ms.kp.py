"""pipeline.detect_host_ms.kp: host time a call in detection's host-only
stages (sift3d.detect.assembly: the keypoints assembled from the octaves'
host rows), outside any crossing span within them, in ms. Nothing is
queued on the card meanwhile."""

from benchmark.metrics import _recorder


def read(run):
    return _recorder.per_call(
        lambda c: _recorder.span_ms(c, _recorder.DETECT_HOST, own=True))
