"""renew_ms.p50 (ms): median, over the window's busy ticks of the fleet
server, of its ``fleet.renew`` phase: the renewal of every lease it holds,
with each request's progress."""

from perfbench import spans


def read(run):
    return spans.median_phase_ms(run, "fleet.renew")
