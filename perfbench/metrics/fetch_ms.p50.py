"""fetch_ms.p50 (ms): median, over the window's busy ticks of the fleet
server, of its ``fleet.fetch`` phase: the pool's fetch of new leases and
their submit to the engine."""

from perfbench import spans


def read(run):
    return spans.median_phase_ms(run, "fleet.fetch")
