"""paged_decode_roofline_pct (%): the least time the card could take for
the profiled sub-window's paged-decode work over the device time of the
paged-decode kernel there.  The work: each decode step of each request,
its K/V rows read once per layer (``work.paged_decode_work``), the rows
from its bucket and its pool progress at the sub-window's ends."""

from perfbench import work

KERNEL = "paged_decode"


def read(run):
    prof = run.get("profile")
    if not prof:
        return None
    t = sum(s for n, s in prof["by_name"].items() if KERNEL in n)
    if t <= 0:
        return None
    c = run["config"]
    p0, p1 = prof["progress0"], prof["progress1"]
    nbytes = flops = 0
    for row in run["requests"]:
        for n in work.steps_in(row, p0.get(row["rid"], 0),
                               p1.get(row["rid"], 0)):
            b, f = work.paged_decode_work(c, n)
            nbytes, flops = nbytes + b, flops + f
    if not nbytes:
        return None
    return 100.0 * work.bound_s(nbytes, flops) / t
