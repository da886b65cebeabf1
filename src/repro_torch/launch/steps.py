"""Step functions the pilot system binds: train_step / prefill / serve.

Port of ``repro.launch.steps``.  These are the "container images" of the
late-binding analogy: a (cfg x shape x device x step-kind) tuple keys the
`~repro_torch.core.images.ExecutableRegistry` cache, and
`PayloadExecutor.bind()` installs the built artifact on an already-held
slice.  The reference jits them; here they are plain functions of the
port's model bundle, whose kernels are built and loaded when the image is
pulled.

The train step is ``jax.value_and_grad`` of the bundle's loss turned into
autograd: the loss's ``backward()`` fills each parameter's ``.grad``, and
`repro_torch.optim.adamw.adamw_update` updates the parameters and the
moments in place.  It runs the plain paths, as the reference's does: a
config whose flags select a hand-written kernel raises at its first
forward (`repro_torch.kernels._build.refuse_grad`), where the reference's
``jax.grad`` fails, since neither package defines a VJP for a kernel.
"""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.models.api import build_model, resolve_device
from repro_torch.optim.adamw import OptimConfig, adamw_update, init_opt_state


def make_train_step(cfg, oc: OptimConfig | None = None,
                    grad_transform=None):
    """(state, batch) -> (state, metrics); state = {"params", "opt"},
    updated in place; metrics: ``loss``, ``ce``, ``aux``, ``grad_norm``,
    ``lr`` (0-d tensors on the state's device).  ``grad_transform`` maps
    the gradient tree before the update (the reference's hook)."""
    oc = oc or OptimConfig()
    bundle = build_model(cfg)

    def train_step(state, batch):
        params = state["params"]
        params.zero_grad(set_to_none=True)
        loss, metrics = bundle.loss(params, batch)
        loss.backward()
        live = params.live()
        grads = tree.unflatten(live, [
            torch.zeros_like(p) if p.grad is None else p.grad
            for p in tree.leaves(live)])
        om = adamw_update(live, grads, state["opt"], oc,
                          grad_transform=grad_transform)
        return state, {"loss": loss.detach(), "ce": metrics["ce"].detach(),
                       "aux": metrics["aux"].detach(), **om}

    return train_step


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


def init_train_state(cfg, seed: int = 0, device="cuda"):
    """{"params", "opt"} on ``device``: f32 master weights from ``seed``
    (requiring grad) and zero AdamW moments."""
    dev = resolve_device(device)
    params = build_model(cfg).init(seed, device=dev, dtype=torch.float32)
    params.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params.live())}


def state_tree(state) -> dict:
    """The train state as a tree of tensors in the reference's layout
    (``{"params", "opt": {"m", "v", "step"}}``): what a checkpoint holds."""
    return {"params": state["params"].live(), "opt": state["opt"]}


@torch.no_grad()
def load_train_state(state, restored) -> dict:
    """Copy ``restored`` (`state_tree`'s layout, e.g. a checkpoint's
    `repro_torch.ckpt.checkpoint.restore`) into ``state`` in place."""
    for dst, src in zip(tree.leaves(state_tree(state)),
                        tree.leaves(restored), strict=True):
        dst.copy_(src)
    return state
