"""complete_ms.p50 (ms): median, over the window's busy ticks of the fleet
server, of its ``fleet.complete`` phase: the heartbeat and the finished
requests handed to the pool (whose callbacks run the clients' next
submit)."""

from perfbench import spans


def read(run):
    return spans.median_phase_ms(run, "fleet.complete")
