"""pairs_per_s: Volume pairs registered completed in the measured window,
over the window's seconds (host clock; the window closes when its last
call returns)."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(u.get("pairs", 0) for _, u in run.calls) / run.window_s
