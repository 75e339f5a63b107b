"""pipeline.detect_describe_ms.reg: host time of the two calls that
register_batch makes into SIFT3D (detect_keypoints_batch and
extract_descriptors_batch of the 2P volumes), mean a call over the
measured window of a traced run, in ms. The harness's spans around the
calls into the pipeline end in a device sync."""

SPANS = ("detect", "describe")


def read(run):
    parts = [run.spans.get(s) for s in SPANS]
    if not all(parts):
        return None
    return sum(sum(p) for p in parts) / len(parts[0]) * 1e3
