"""registration.match_ransac_ms.reg: host time of register_batch outside
its two calls into SIFT3D (the volumes stacked, the descriptors' trip
through host numpy, matching, RANSAC and the results' copy home), mean a
call over the measured window of a traced run, in ms: each call's wall
time less its detect and describe spans."""


def read(run):
    det, desc = run.spans.get("detect"), run.spans.get("describe")
    if not run.calls or not det or not desc or len(det) != len(run.calls):
        return None
    rest = [t - a - b for (t, _), a, b in zip(run.calls, det, desc)]
    return sum(rest) / len(rest) * 1e3
