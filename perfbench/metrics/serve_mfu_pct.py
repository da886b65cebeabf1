"""serve_mfu_pct (%): model operations of the tokens delivered in the
window over the window's seconds times the bf16 peak.  A token made by an
admission costs its bucket's prefill; one made by a decode step costs the
step at its context (``work.py``).  Per request, the tokens between its
counts at the window's start and end."""

from perfbench import work


def read(run):
    c = run["config"]
    p0, p1 = run["progress0"], run["progress1"]
    flops = 0
    for row in run["requests"]:
        a, b = p0.get(row["rid"], 0), p1.get(row["rid"], 0)
        if a < 1 <= b:
            flops += work.prefill_flops(c, row["plen"])
        flops += sum(work.decode_flops(c, n) for n in work.steps_in(row, a, b))
    if not flops:
        return None
    return 100.0 * flops / ((run["t1"] - run["t0"]) * work.PEAK_BF16_FLOPS)
