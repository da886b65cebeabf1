"""report_ms.p50 (ms): median, over the window's busy ticks of the fleet
server, of its ``fleet.report`` phase: the cache pressure and free slots
sent to the pool, which the autoscaler reads."""

from perfbench import spans


def read(run):
    return spans.median_phase_ms(run, "fleet.report")
