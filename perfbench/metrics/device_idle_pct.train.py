"""device_idle_pct.train (%): share of the profiled whole train steps in
which no device operation ran (busy is the union of device intervals)."""


def read(run):
    prof = run.get("profile")
    if run.get("kind") != "train" or not prof or prof["ops"] == 0:
        return None
    return 100.0 * max(0.0, 1.0 - prof["busy_s"] / prof["window_s"])
