"""serve_tokens_per_s (tokens/s): tokens the pool saw delivered during the
window (completed tokens plus the renewed progress of leased requests, at
the window's end less at its start) over the window's seconds."""


def read(run):
    return run["delivered"] / (run["t1"] - run["t0"])
