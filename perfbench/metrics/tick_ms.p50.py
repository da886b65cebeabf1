"""tick_ms.p50 (ms): median engine tick of the serve payload (its
``itl_p50_s``: the ticks since its install warm-up, the drain included)."""


def read(run):
    v = (run["telemetry"].get("engine") or {}).get("itl_p50_s")
    return None if v is None else v * 1e3
