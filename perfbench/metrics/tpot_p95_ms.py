"""tpot_p95_ms (ms): 95th percentile, over every request submitted in the
window that made two tokens or more, of (completed - first token) /
(tokens - 1); a request that never completed counts as the longest wait
the run allowed."""

import numpy as np


def read(run):
    cap = run["seconds"] + run["mix"]["drain_s"] + run["mix"]["warmup_s"]
    v = []
    for r in run["requests"]:
        if not r["in_window"]:
            continue
        if r["tokens"] is None:
            v.append(cap)
        elif r["tokens"] > 1:
            v.append((r["completed"] - r["first"]) / (r["tokens"] - 1))
    return float(np.percentile(v, 95)) * 1e3 if v else None
