"""Concurrency analysis of the port's pilot control plane.

- :mod:`repro_torch.analysis.locks` — a copy of the reference's instrumented
  Lock/RLock/Condition factory and its :class:`LockAuditor`.

It depends only on the stdlib: every locked module of ``core/`` imports it.
"""
