"""pipeline.detect_ms.kp: host time of SIFT3D.detect_keypoints_batch, mean
a call over the measured window of a traced run, in ms. The harness's
span around the call into the pipeline ends in a device sync."""

SPANS = ("detect",)


def read(run):
    parts = [run.spans.get(s) for s in SPANS]
    if not all(parts):
        return None
    return sum(sum(p) for p in parts) / len(parts[0]) * 1e3
