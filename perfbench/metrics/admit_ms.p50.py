"""admit_ms.p50 (ms): median ``engine.admit`` span of the window in the
mix's main bucket (the bucket most of the window's admissions took; the
larger on a tie): one one-shot admission, from its start to its
first-token read, which waits for the admission graph on the device (the
last part of the time to first token)."""

import numpy as np

from perfbench import spans


def read(run):
    tr = spans.load(run)
    if tr is None:
        return None
    admits = tr.inside("engine.admit")
    if len(admits) == 0:
        return None
    buckets, counts = np.unique(tr.attr[admits], return_counts=True)
    main = buckets[counts == counts.max()].max()
    return float(np.median(tr.ms(admits[tr.attr[admits] == main])))
