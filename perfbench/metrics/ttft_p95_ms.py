"""ttft_p95_ms (ms): 95th percentile, over every request submitted in the
window, of the seconds from the pool's submit to its first token.  A
request that never completed counts as the longest wait the run allowed
(the window, the drain and the warm-up together)."""

import numpy as np


def read(run):
    cap = run["seconds"] + run["mix"]["drain_s"] + run["mix"]["warmup_s"]
    v = [(r["first"] if r["first"] is not None else cap)
         for r in run["requests"] if r["in_window"]]
    return float(np.percentile(v, 95)) * 1e3 if v else None
