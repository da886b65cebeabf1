"""ready_s (s): host clock from the pilot's start (its claim of the slice)
to the payload being ready: for serve, the server's announce to the pool
(engine built, admission graphs captured, install path warmed); for
train, the end of the first step (step 0 and the capture of the graph)."""


def read(run):
    if run["t_ready"] is None:
        return None
    return run["t_ready"] - run["pilot_started"]
