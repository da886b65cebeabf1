"""decode_ms.p50 (ms): median ``engine.decode`` span of the window: the
decode half of an engine tick (the graph's replay, the one device-to-host
copy, which waits for it, the unpack and the evictions)."""

import numpy as np

from perfbench import spans


def read(run):
    tr = spans.load(run)
    decodes = tr.inside("engine.decode") if tr is not None else ()
    return float(np.median(tr.ms(decodes))) if len(decodes) else None
