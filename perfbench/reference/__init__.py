"""Plain PyTorch references of the benchmark's configurations.

Each forward takes the weights tree the benchmark made (``weights.py``)
and one token sequence, and returns f32 logits at every position.  They
import nothing of the program and share none of its code: they follow the
configurations' equations as the program states them (``configs/*.json``
lists where those leave the published model), in f32 with TF32 off, one
layer at a time, so they fit beside nothing else on the card.
"""

from perfbench.reference import granite_moe, mamba2

FORWARD = {"moe": granite_moe.forward, "ssm": mamba2.forward}
