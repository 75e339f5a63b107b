"""pipeline.sync_wait_ms.kp: host time a call inside the program's
crossing spans (sift3d.to_device, to_host, read_int), in ms: the host
waiting for the card to finish the work queued before each copy, and the
copy itself."""

from benchmark.metrics import _recorder


def read(run):
    return _recorder.per_call(
        lambda c: _recorder.span_ms(c, _recorder.CROSSINGS))
