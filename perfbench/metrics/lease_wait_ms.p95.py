"""lease_wait_ms.p95 (ms): 95th percentile, over the window's requests,
of the program's ``pool.wait`` span: the pool's submit to the lease of
the attempt its server completed (the first part of the time to first
token; ``spans.py`` says which spans are the window's)."""

import numpy as np

from perfbench import spans


def read(run):
    tr = spans.load(run)
    rows = spans.requests(tr) if tr is not None else ()
    return float(np.percentile(rows[:, 0], 95)) if len(rows) else None
