"""admit_wait_ms.p95 (ms): 95th percentile, over the window's requests,
of the time from the lease (the end of ``pool.wait``) to the start of
the request's ``engine.admit``: the engine's queue and the admissions
ahead of it in the same tick (the second part of the time to first
token)."""

import numpy as np

from perfbench import spans


def read(run):
    tr = spans.load(run)
    rows = spans.requests(tr) if tr is not None else ()
    return float(np.percentile(rows[:, 1], 95)) if len(rows) else None
