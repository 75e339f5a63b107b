"""device.launches_per_call.kp: kernel launches in the traced window over
the calls traced, from the profiler's trace."""


def read(run):
    t = run.trace
    if not t or not t["calls"]:
        return None
    return t["launches"] / t["calls"]
