"""SharedArena — the multi-container pod's volumes (paper §3.2, §3.5, §3.6).

Two storage areas per pilot:

* ``shared/``  — mounted into both the pilot and the payload "containers".
  The pilot stages input files here; the payload wrapper finds its *startup
  spec* here (the paper's wait-for-script loop), and writes ``exitcode.json``
  + telemetry back (the paper's exit-code relay, §3.5).
* ``private/`` — pilot-only: lease tokens, heartbeat files, credentials.
  The payload capability object simply never receives this path — the
  analogue of the volume not being mounted in the payload container.

``wipe_shared()`` is the §3.6 cleanup: between payloads the pilot clears the
shared volume; payload process cleanup itself is delegated to the executor
reset (the "container restart").
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time

STARTUP_SPEC = "startup_spec.json"     # the paper's startup script path
EXITCODE_FILE = "exitcode.json"
ENV_FILE = "payload_env.json"


class SharedArena:
    def __init__(self, root: str | None = None):
        self.root = root or tempfile.mkdtemp(prefix="pilot_arena_")
        self.shared = os.path.join(self.root, "shared")
        self.private = os.path.join(self.root, "private")
        os.makedirs(self.shared, exist_ok=True)
        os.makedirs(self.private, exist_ok=True)
        # in-process fast path for the payload's wait-for-spec loop: publish
        # sets the event so a co-resident waiter wakes instantly instead of
        # polling the file (the file stays authoritative — an out-of-process
        # waiter still sees the atomic rename).
        self._spec_event = threading.Event()
        self._last_env_blob: bytes | None = None
        # in-memory mirrors of the spec/exit files for co-resident readers
        # (the page-cache analogue): the files are always written and stay
        # authoritative for out-of-process readers
        self._last_spec: dict | None = None
        self._last_exit: dict | None = None

    # ---- pilot-side staging (step (b)/(c) of the lifecycle) ---------------

    def stage_file(self, name: str, data: bytes) -> str:
        path = os.path.join(self.shared, name)
        if "/" in name:                   # top-level files need no makedirs
            os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return path

    def write_env(self, env: dict) -> str:
        blob = json.dumps(env).encode()
        path = os.path.join(self.shared, ENV_FILE)
        if blob == self._last_env_blob:   # unchanged since last write — the
            return path                   # common case for multi-payload pilots
        path = self.stage_file(ENV_FILE, blob)
        self._last_env_blob = blob
        return path

    def publish_startup_spec(self, spec: dict) -> str:
        """Publishing the spec is what releases the payload container's
        wait-loop — write must be atomic (tmp+rename)."""
        path = self.stage_file(STARTUP_SPEC, json.dumps(spec).encode())
        self._last_spec = dict(spec)
        self._spec_event.set()
        return path

    # ---- payload-side (wrapper) -------------------------------------------

    def wait_for_startup_spec(self, timeout: float = 30.0,
                              poll: float = 0.01) -> dict | None:
        """The payload container's wait-for-script loop (paper §3.3).

        A co-resident publisher sets the spec event, so the in-process wake
        is immediate; each event wait is still bounded by ``poll`` so a
        publisher holding a *different* SharedArena over the same root (the
        two-process deployment) is noticed at the seed's poll cadence."""
        path = os.path.join(self.shared, STARTUP_SPEC)
        deadline = time.monotonic() + timeout
        while True:
            if self._last_spec is not None:
                return self._last_spec
            if os.path.exists(path):      # published by another process
                with open(path) as f:
                    return json.load(f)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            self._spec_event.wait(timeout=min(poll, remaining))

    def read_env(self) -> dict:
        path = os.path.join(self.shared, ENV_FILE)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return {}

    def report_exit(self, exitcode: int, telemetry: dict | None = None):
        info = {"exitcode": exitcode, "telemetry": telemetry or {},
                "time": time.time()}
        self.stage_file(EXITCODE_FILE, json.dumps(info).encode())
        self._last_exit = info

    # ---- pilot-side collection (step (e)) ----------------------------------

    def read_exit(self) -> dict | None:
        if self._last_exit is not None:
            return self._last_exit
        path = os.path.join(self.shared, EXITCODE_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def shared_files(self) -> list[str]:
        out = []
        for base, _, files in os.walk(self.shared):
            for f in files:
                out.append(os.path.relpath(os.path.join(base, f), self.shared))
        return sorted(out)

    def output_files(self, prefix: str = "out") -> dict[str, bytes]:
        """Collect payload outputs without walking the whole shared tree —
        the common no-outputs case is a single stat."""
        base = os.path.join(self.shared, prefix)
        out: dict[str, bytes] = {}
        if not os.path.isdir(base):
            return out
        for root, _, files in os.walk(base):
            for f in files:
                p = os.path.join(root, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, self.shared)] = fh.read()
        return out

    # ---- cleanup (step (f)/(h)) --------------------------------------------

    def wipe_shared(self):
        self._spec_event.clear()          # next waiter blocks until republish
        self._last_env_blob = None
        self._last_spec = None
        self._last_exit = None
        with os.scandir(self.shared) as it:
            entries = list(it)
        for e in entries:                 # unlink in place: cheaper than
            if e.is_dir(follow_symlinks=False):       # rmtree + mkdir
                shutil.rmtree(e.path, ignore_errors=True)
            else:
                try:
                    os.unlink(e.path)
                except OSError:
                    pass

    def destroy(self):
        shutil.rmtree(self.root, ignore_errors=True)
