"""kp_call_p95_ms: the 95th percentile (linear between ranks) of the
latency of every call of the measured window, each the detection and
description of one batch with its results on the host, in ms (host
clock)."""

import numpy as np


def read(run):
    if not run.calls:
        return None
    return float(np.percentile([t for t, _ in run.calls], 95)) * 1e3
