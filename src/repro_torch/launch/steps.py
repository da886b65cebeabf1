"""Step functions the pilot system binds: prefill / serve (train later).

Port of ``repro.launch.steps``.  These are the "container images" of the
late-binding analogy: a (cfg x shape x device x step-kind) tuple keys the
`~repro_torch.core.images.ExecutableRegistry` cache, and
`PayloadExecutor.bind()` installs the built artifact on an already-held
slice.  The reference jits them; here they are plain functions of the
port's model bundle, whose kernels are built and loaded when the image is
pulled.
"""

from __future__ import annotations

from repro_torch.models.api import build_model

_TRAIN_LATER = ("the train step comes with the training payload, "
                "ROADMAP.md Queue 1 item 4")


def make_train_step(cfg, oc=None, grad_transform=None):
    """(state, batch) -> (state, metrics): not in this slice of the port."""
    raise NotImplementedError(_TRAIN_LATER)


def make_prefill_step(cfg):
    bundle = build_model(cfg)

    def prefill_step(params, batch):
        return bundle.prefill(params, batch)

    return prefill_step


def make_serve_step(cfg):
    """One decode step: (params, state) -> (logits, state)."""
    bundle = build_model(cfg)

    def serve_step(params, state):
        return bundle.decode(params, state)

    return serve_step


def init_train_state(cfg, seed):
    """{"params", "opt"}: not in this slice of the port."""
    raise NotImplementedError(_TRAIN_LATER)
