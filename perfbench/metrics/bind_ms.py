"""bind_ms (ms): the pilot's late bind of the payload image (its
``bind_seconds``: image patch, pull and load)."""


def read(run):
    binds = [h["bind_seconds"] for h in run["pilot_history"]
             if h.get("bind_seconds") is not None]
    return binds[0] * 1e3 if binds else None
