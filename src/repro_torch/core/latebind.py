"""PayloadExecutor — the payload container + the late-binding image patch.

The executor is the pod's second container (paper §3.3):

* At pod creation it holds the PLACEHOLDER image and its run thread blocks in
  the arena's wait-for-startup-spec loop — Kubernetes is satisfied (every
  container has an image) while no payload exists yet.
* ``patch_image()`` is the unprivileged ``kubectl set image`` / pod-patch:
  it requires a capability token scoped to *this pod only* (the "pod patch
  role inside its own namespace"), swaps the executable in place, and never
  touches the resource grant — the slice stays claimed throughout.
* ``reset()`` is the §3.6 cleanup-by-container-restart: the payload's
  process entries are killed and its device state dropped; the pilot's state
  survives untouched.

The image pull (model bundle, kernel libraries) happens at patch time via
the ExecutableRegistry; a warm cache makes rebinding nearly free — the
measurable win of late-binding over re-provisioning.  Port of
``repro.core.latebind``: the executor takes the slice's ``device`` where
the reference takes its ``mesh``, and pulls every image for it, or for
the slice's ``mesh`` when it holds one (a tensor-parallel serve image then
builds its engines over the mesh's devices).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

from repro_torch.analysis.locks import audit_callback, make_condition, make_lock
from repro_torch.core.arena import SharedArena
from repro_torch.core.images import Executable, ExecutableRegistry, PLACEHOLDER, PayloadImage
from repro_torch.core.proctable import PAYLOAD_UID, ProcessTable
from repro_torch.core.wrapper import run_wrapper

UNBOUND = "unbound"
BOUND = "bound"
RUNNING = "running"
EXITED = "exited"


class PermissionError_(Exception):
    """Capability check failed (wrong pod / not the pilot)."""


@dataclasses.dataclass(frozen=True)
class PodPatchCapability:
    """The pilot's credential (§3.3): may patch images of its own pod only."""
    pod_id: str


class PayloadExecutor:
    def __init__(self, pod_id: str, arena: SharedArena,
                 proctable: ProcessTable, registry: ExecutableRegistry,
                 device=None, mesh=None):
        self.pod_id = pod_id
        self.arena = arena
        self.proctable = proctable
        self.registry = registry
        self.device = device
        self.mesh = mesh
        # where every image is pulled for: the slice's mesh, else device
        self.where = mesh if mesh is not None else device
        self.image: PayloadImage = PLACEHOLDER
        self.exe: Executable | None = registry.pull(PLACEHOLDER, self.where)
        self.state = UNBOUND
        self.generation = 0               # bumped by every restart/patch
        self.exit_event: threading.Event | None = None
        self._lock = make_lock("latebind.executor")
        # the persistent container-runtime thread: entrypoint generations
        # boot from a queue instead of spawning a thread per payload
        self._boot_cond = make_condition(name="latebind.boot")
        self._boot: tuple | None = None
        self._runtime: threading.Thread | None = None
        self._closed = False
        self.last_bind_seconds: float | None = None
        self.last_bind_cached: bool | None = None

    # ------------------------------------------------------------------
    # the unprivileged pod patch
    # ------------------------------------------------------------------

    def patch_image(self, cap: PodPatchCapability, image: PayloadImage):
        if cap.pod_id != self.pod_id:
            raise PermissionError_(
                f"capability for pod {cap.pod_id!r} cannot patch {self.pod_id!r}")
        t0 = time.monotonic()
        exe = self.registry.pull(image, self.where)       # the image pull
        with self._lock:
            self.image = image
            self.exe = exe
            self.state = BOUND
            self.generation += 1
        self.last_bind_seconds = time.monotonic() - t0
        self.last_bind_cached = exe.cached
        return exe

    # ------------------------------------------------------------------
    # container start: wait-for-spec loop, then run the wrapper
    # ------------------------------------------------------------------

    def start(self, *, spec_timeout: float = 30.0, on_exit=None):
        """Start the payload container's entrypoint (async).

        ``on_exit`` (optional) is called exactly once when the container's
        entrypoint finishes, on the container thread — the pilot's
        event-driven collection hook.  ``exit_event`` is set at the same
        point, so observers can block without polling ``running``.
        """
        if self.running:
            raise RuntimeError("payload container already running")
        done = threading.Event()
        self.exit_event = done
        with self._boot_cond:
            self._boot = (self.generation, spec_timeout, on_exit, done)
            if self._runtime is None or not self._runtime.is_alive():
                self._runtime = threading.Thread(
                    target=self._runtime_loop, daemon=True,
                    name=f"payload-container-{self.pod_id}")
                self._runtime.start()
            self._boot_cond.notify()

    def _runtime_loop(self):
        """One thread per pod for the container runtime: it parks between
        payloads and boots each entrypoint generation from the queue."""
        while True:
            with self._boot_cond:
                while self._boot is None and not self._closed:
                    self._boot_cond.wait()
                if self._boot is None:    # closed with nothing queued
                    return
                gen, spec_timeout, on_exit, done = self._boot
                self._boot = None
            try:
                spec = self.arena.wait_for_startup_spec(timeout=spec_timeout)
                with self._lock:
                    stale = self.generation != gen    # restarted while waiting
                    exe = self.exe
                if stale:
                    continue
                if spec is None:
                    self.arena.report_exit(124, {"error": "startup spec timeout"})
                    self.state = EXITED
                else:
                    self.state = RUNNING
                    run_wrapper(self.arena, self.proctable, exe, spec)
                    self.state = EXITED
            except Exception:             # noqa: BLE001 — runtime survives
                self.state = EXITED
            finally:
                done.set()
                if on_exit is not None:
                    try:
                        audit_callback("latebind:on_exit")
                        on_exit()
                    except Exception:     # noqa: BLE001
                        pass

    def close(self):
        """Tear down the pod: stop the container-runtime thread once the
        current entrypoint (if any) finishes.  Terminated pilots must call
        this or every pilot ever created leaks a parked thread."""
        with self._boot_cond:
            self._closed = True
            self._boot_cond.notify()

    def join(self, timeout: float | None = None) -> bool:
        """Wait for the current entrypoint generation to finish."""
        ev = self.exit_event
        if ev is None:
            return True
        return ev.wait(timeout)

    def wait_exit(self, timeout: float | None = None) -> bool:
        """Block on the completion event (microsecond wake-up, no polling)."""
        return self.join(timeout)

    @property
    def running(self) -> bool:
        ev = self.exit_event
        return ev is not None and not ev.is_set()

    # ------------------------------------------------------------------
    # cleanup by restart (§3.6)
    # ------------------------------------------------------------------

    def reset(self, *, back_to_placeholder: bool = False):
        """Kubernetes-runtime cleanup: kill the payload process tree, drop
        payload device state, bump the generation."""
        self.proctable.kill_uid(PAYLOAD_UID)
        self.join(timeout=5.0)
        with self._lock:
            self.generation += 1
            self.exit_event = None
            if back_to_placeholder:
                self.image = PLACEHOLDER
                self.exe = self.registry.pull(PLACEHOLDER, self.where)
                self.state = UNBOUND
            else:
                self.state = BOUND if self.exe is not None else UNBOUND
        self.proctable.reap()
