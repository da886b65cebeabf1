"""device_idle_pct.serve (%): share of the profiled sub-window of a serve
window in which no device operation ran (busy is the union of the device
intervals, so overlapping operations count once)."""


def read(run):
    prof = run.get("profile")
    if not prof or prof["ops"] == 0:
        return None
    return 100.0 * max(0.0, 1.0 - prof["busy_s"] / prof["window_s"])
