"""The program's own record of its calls (sift3d_tpu_torch.profiling), for
the pipeline's per-layer metrics.

A call of the detect + describe cells is one root span of detection (its
name starts with ``sift3d.detect``) plus one of description
(``sift3d.describe``). A metric is the median of its value over the
recorded calls of each of the two kinds, the two medians added. Every
reader returns None where the program keeps no record (an older tree) or
the record holds no call of a kind.
"""

from __future__ import annotations

import statistics

KINDS = ("sift3d.detect", "sift3d.describe")
# The spans of the host-device crossings, each one blocking copy.
CROSSINGS = ("sift3d.to_device", "sift3d.to_host", "sift3d.read_int")
# The stages in which nothing is queued on the card.
DETECT_HOST = ("sift3d.detect.assembly",)
DESCRIBE_HOST = ("sift3d.describe.check", "sift3d.describe.gather",
                 "sift3d.describe.scatter")


def calls():
    """The recorded calls, or None without a recorder."""
    try:
        from sift3d_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "read", None)
    return None if read is None else read()["calls"]


def per_call(value):
    """The median of value(call) over each kind's recorded calls, the two
    medians added; None without a call of each kind."""
    recorded = calls() or []
    total = 0.0
    for kind in KINDS:
        vals = [value(c) for c in recorded if c["root"].startswith(kind)]
        if not vals:
            return None
        total += statistics.median(vals)
    return total


def counted(call, names) -> int:
    """The call's total of the counters `names`."""
    return sum(call["counters"].get(n, 0) for n in names)


def span_ms(call, names, own: bool = False) -> float:
    """The call's host time in the spans `names`, in ms; with own, only
    the time outside their child spans."""
    return sum(call["spans"][n][2 if own else 1] for n in names
               if n in call["spans"]) * 1e-6
