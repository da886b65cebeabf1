"""loop_host_ms.p50 (ms): median, over the window's busy ticks of the
fleet server (``fleet.tick`` with the engine holding work), of the tick
less its ``engine.step``: the loop's host time (fetch, the heartbeat and
completions, renewals, the telemetry report)."""

import numpy as np

from perfbench import spans


def read(run):
    tr = spans.load(run)
    host = spans.loop_host_ms(tr) if tr is not None else ()
    return float(np.median(host)) if len(host) else None
