"""Concurrency-correctness analysis of the port's pilot control plane.

Three cooperating parts, copies of the reference's (``repro.`` read as
``repro_torch.``):

- :mod:`repro_torch.analysis.locks` — instrumented Lock/RLock/Condition
  factory plus a :class:`LockAuditor` that records per-thread held-sets and
  acquisition-order edges, detects lock-order cycles with witness stacks,
  and flags blocking calls / user callbacks executed under a lock.
- :mod:`repro_torch.analysis.lint` — repo-specific AST lint (bare threading
  locks, wall-clock in jitted step builders, the one-transfer rule,
  blocking under a held lock) with inline suppressions that require a
  written justification.
- :mod:`repro_torch.analysis.fuzz` — deterministic schedule fuzzer: seeded
  preemption injection at lock acquire/release boundaries driving the
  six-server stress race under many seeds.

Beside them, the port's own :mod:`repro_torch.analysis.torch_rules` runs
the copy's rules and three more (torch's device->host copies in the step
path, clock reads in step builders, rebinding a tensor a CUDA graph
captured) over the same findings and suppressions.

This package must stay import-light: ``locks`` is imported by every
locked module in ``core/``, ``serving/`` and ``kernels/``, so it depends
only on the stdlib.  ``fuzz`` imports the serving stack and is therefore
*not* re-exported here (import it explicitly).
"""
