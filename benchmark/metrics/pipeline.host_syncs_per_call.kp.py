"""pipeline.host_syncs_per_call.kp: blocking host-device crossings a call
(detect_keypoints_batch + extract_descriptors_batch), from the program's
counter host_syncs: every copy between host memory and the card on the
path, each of which waits for the work queued before it."""

from benchmark.metrics import _recorder


def read(run):
    return _recorder.per_call(
        lambda c: _recorder.counted(c, ("host_syncs",)))
