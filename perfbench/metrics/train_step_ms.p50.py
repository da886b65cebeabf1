"""train_step_ms.p50 (ms): median time of the window's train steps, each
from its start to the next one's on the host clock: the payload loop's
batch, the graphed step, its ``float(loss)`` and the heartbeat."""

import numpy as np


def read(run):
    if run.get("kind") != "train" or not run["step_s"]:
        return None
    return float(np.median(run["step_s"])) * 1e3
