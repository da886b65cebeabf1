"""Step functions the pilot system binds: train_step / prefill / serve.

Port of ``repro.launch.steps``.  These are the "container images" of the
late-binding analogy: a (cfg x shape x device x step-kind) tuple keys the
`~repro_torch.core.images.ExecutableRegistry` cache, and
`PayloadExecutor.bind()` installs the built artifact on an already-held
slice.  The reference jits them; here they are plain functions of the
port's model bundle, whose kernels are built and loaded when the image is
pulled, and the train and decode steps replay a CUDA graph on the card
(`make_train_step`, `make_serve_step`).

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
import torch.utils._pytree as pytree

from repro_torch import tree
from repro_torch.models.api import build_model, resolve_device
from repro_torch.optim.adamw import OptimConfig, adamw_update, init_opt_state

# where a state keeps the CUDA graph of its step (train and decode)
GRAPH_KEY = "step_graph"


def make_train_step(cfg, oc: OptimConfig | None = None,
                    grad_transform=None, step_graph: bool = True):
    """(state, batch) -> (state, metrics); state = {"params", "opt"},
    updated in place; metrics: ``loss``, ``ce``, ``aux``, ``grad_norm``,
    ``lr`` (0-d tensors on the state's device).  After a call each
    parameter's ``.grad`` holds that step's gradient.  ``grad_transform``
    maps the gradient tree before the update (the reference's hook).

    The reference jits the step with the state donated.  Here, with
    ``step_graph`` on a state on a CUDA device, the first call runs the
    step eagerly (the real step 0, as `repro_torch.serving.graph.StepGraph`'s
    warm-up) and then captures forward, ``backward()`` and the AdamW update
    as one CUDA graph over static copies of the batch's tensors; each later
    call with a batch of the same shapes copies the batch in and replays.
    The graph replays the state's own tensors, so it is kept in the state
    under ``GRAPH_KEY`` (never in the function, which a cached image shares
    among payloads) and goes with it.  A batch of other shapes captures
    again and replaces it, as a jit compiles again.  The metrics are then
    the graph's static outputs, which the next replay overwrites: read them
    (``float(metrics["loss"])``) before the next call.  Each ``.grad`` is a
    tensor of the graph's pool that every replay refills: nothing outside
    the step may set it to None or rebind it, and a restore
    (`load_train_state`) writes in place.  ``grad_transform`` is replayed
    as captured, as a jit traces it once: a transform that keeps state
    across steps must write it in place (``copy_``), since one that rebinds
    it (e.g. to `repro_torch.runtime.compression.compress`'s new
    residuals) would replay the residuals of the capture, with no error.
    A capture that fails raises; nothing falls back to the eager step.
    ``step_graph=False``, or a state on the CPU or on ``meta``, runs the
    step eagerly."""
    oc = oc or OptimConfig()
    bundle = build_model(cfg)

    def step(state, batch):
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
        return {"loss": loss.detach(), "ce": metrics["ce"].detach(),
                "aux": metrics["aux"].detach(), **om}

    def train_step(state, batch):
        if not step_graph or state["opt"]["step"].device.type != "cuda":
            return state, step(state, batch)
        leaves, spec = pytree.tree_flatten(batch)
        shapes = (spec, [(t.shape, t.dtype) for t in leaves])
        held = state.get(GRAPH_KEY)
        if (held is not None and held[0] is state["params"]
                and held[1] is state["opt"] and held[2] == shapes):
            return state, held[3](*leaves)
        state.pop(GRAPH_KEY, None)       # its pool goes before the next one
        graph, metrics = _capture_train(step, state, leaves, spec)
        state[GRAPH_KEY] = (state["params"], state["opt"], shapes, graph)
        return state, metrics

    return train_step


def _capture_train(step, state, leaves, spec):
    """``step`` run once eagerly on ``state`` and the batch ``leaves`` and
    captured (`repro_torch.serving.graph.CallGraph`); returns the graph and
    the eager run's metrics.  The capture gives each parameter a ``.grad``
    in the graph's pool, which it has not filled yet: the eager run's
    gradients are copied into it, so ``.grad`` holds step 0's."""
    # (imported here: the serving package imports this module)
    from repro_torch.serving.graph import DEVICE_LOCK, CallGraph
    tensors = {"params": state["params"], "opt": state["opt"]}
    params = tree.leaves(tensors["params"].live())
    eager = []

    def run(*batch):
        if torch.cuda.is_current_stream_capturing():
            eager[:] = [p.grad for p in params]     # before the step drops them
        return step(tensors, pytree.tree_unflatten(list(batch), spec))

    with DEVICE_LOCK:
        graph, metrics = CallGraph.first_call(run, leaves, leaves[0].device,
                                              kind="train")
        with torch.no_grad():
            for p, g in zip(params, eager, strict=True):
                if g is not None:
                    p.grad.copy_(g)
    eager.clear()                  # the graph's closure holds the list
    return graph, metrics


def held_graph(state):
    """The `repro_torch.serving.graph.StepGraph` that ``state``'s step
    replays (a train or a decode state's, under ``GRAPH_KEY``), or None."""
    held = state.get(GRAPH_KEY)
    if held is None:
        return None
    return getattr(held[-1], "step", held[-1])   # a CallGraph's StepGraph


def make_prefill_step(cfg):
    """One prefill: (params, batch) -> (last logits, cache).  It stays
    eager where the reference jits it: a prefill image's payload makes one
    call, so capturing a CUDA graph would cost more than the call it
    replaces."""
    bundle = build_model(cfg)

    def prefill_step(params, batch):
        return bundle.prefill(params, batch)

    return prefill_step



def make_serve_step(cfg, step_graph: bool = True):
    """One decode step: (params, state) -> (logits, state).

    The reference jits it with the state donated; here the step writes
    ``token`` and ``pos`` into the state in place (the caches are written
    in place by the decode itself) and returns the state it was given.
    With ``step_graph`` on a state on a CUDA device, the first call for a
    given state runs the step eagerly, as the warm-up of a CUDA graph it
    then captures (`repro_torch.serving.graph.StepGraph`), and every later
    call with that state and those params replays it; its logits are the
    graph's static output, overwritten by the next replay.  The graph
    replays the state's own tensors, so it belongs to the state: it is
    kept in the state under ``GRAPH_KEY`` (never in the function, which a
    cached image shares among payloads) and goes with it.
    ``step_graph=False``, or a state on the CPU, runs the step eagerly."""
    bundle = build_model(cfg)

    def step(params, state):
        logits, new = bundle.decode(params, state)
        state["token"].copy_(new["token"])
        state["pos"].copy_(new["pos"])
        return logits

    def serve_step(params, state):
        if not step_graph or state["token"].device.type != "cuda":
            return step(params, state), state
        held = state.get(GRAPH_KEY)
        if held is not None and held[0] is params:
            return held[1].replay(), state
        # the graph holds the state's tensors, not the dict that holds it
        tensors = {k: v for k, v in state.items() if k != GRAPH_KEY}
        # (imported here: the serving package imports this module)
        from repro_torch.serving.graph import StepGraph
        graph = StepGraph(lambda: step(params, tensors),
                          state["token"].device, kind="serve_step")
        logits, graph.first = graph.first, None
        state[GRAPH_KEY] = (params, graph)
        return logits, state

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
