"""device.idle_pct.kp: share of the traced window in which nothing (kernel,
copy or set) ran on the card, in percent, from the profiler's trace."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
