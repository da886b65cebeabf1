"""Collective byte conventions and the summaries of a counted run.

Port of ``repro.launch.hlo_stats``.  The reference parses the partitioned
HLO text of a compiled step for its collectives and reads XLA's
``cost_analysis()`` and ``memory_analysis()``.  The port has no compiled
artifact and no HLO: its transfers between ranks are the rank loop's
(`repro_torch.runtime.sharding`: ``gather``, ``split`` and the per-rank
moves of ``on_ranks``), which report themselves here as they happen
(`transfer`), and the summaries read the record of a counted run
(`repro_torch.launch.op_cost.ModuleCost`).

Byte-counting conventions (per device, recorded per op kind), the
reference's:

* all-gather          -> result bytes (ring: each chip passes ~the full
                          gathered tensor through its link)
* all-reduce          -> 2 x result bytes (reduce-scatter + all-gather phases)
* reduce-scatter      -> operand bytes (full pre-reduction tensor streams by)
* all-to-all          -> result bytes
* collective-permute  -> result bytes

A rank loop's ``gather`` (the parts concatenated on the lead device) is an
all-gather; a tensor sent from the lead device to another rank (a
``split`` part, an ``on_ranks`` argument) is a collective-permute.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op -> (use operand bytes?, multiplier)
_WEIGHT = {
    "all-gather": (False, 1.0),
    "all-reduce": (False, 2.0),
    "reduce-scatter": (True, 1.0),
    "all-to-all": (False, 1.0),
    "collective-permute": (False, 1.0),
}


def weighted_bytes(op: str, result_bytes: int,
                   operand_bytes: int | None = None) -> float:
    """The bytes a collective ``op`` counts under the conventions above."""
    use_operand, mult = _WEIGHT[op]
    nbytes = operand_bytes if use_operand and operand_bytes else result_bytes
    return mult * float(nbytes)


def tensor_type(t) -> str:
    """A tensor's type as a short string (``bfloat16[8,1024]``), the
    counterpart of an HLO type in a record's collective details."""
    return f"{str(t.dtype).removeprefix('torch.')}[{','.join(map(str, t.shape))}]"


# The walks counting on this thread (op_cost's), innermost last.
_ACTIVE = threading.local()


@contextmanager
def recording(sink):
    """Report the transfers made on this thread inside the block to
    ``sink.collective(op, result_bytes, operand_bytes, type_str)``."""
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    stack.append(sink)
    try:
        yield sink
    finally:
        stack.pop()


def transfer(op: str, result, operand_bytes: int | None = None):
    """Report one collective ``op`` whose result is the tensor ``result``
    to every walk counting on this thread; free when none is."""
    stack = getattr(_ACTIVE, "stack", None)
    if not stack:
        return
    rb = result.numel() * result.element_size()
    for sink in stack:
        sink.collective(op, rb, operand_bytes, tensor_type(result))


def collective_stats(cost) -> dict:
    """{"counts": {op: n}, "bytes": {op: weighted bytes}, "raw_bytes":
    {op: result bytes}, "total_bytes"} of a counted run, as the
    reference's ``collective_stats`` of a compiled step."""
    return {"counts": dict(cost.collective_counts),
            "bytes": dict(cost.collective_bytes),
            "raw_bytes": dict(cost.collective_raw_bytes),
            "total_bytes": cost.total_collective_bytes}


def cost_summary(cost) -> dict:
    """flops / bytes accessed / transcendentals of a counted run, under
    the names of the reference's ``cost_summary`` (whose XLA count reads
    a loop body once; an eager run counts every iteration)."""
    return {"flops": cost.flops, "bytes_accessed": cost.bytes,
            "transcendentals": cost.transcendentals}


def memory_summary(cost) -> dict:
    """The memory of a counted run under the reference's
    ``memory_analysis`` names: argument, output, temp (the peak of the
    bytes the run allocated and had not freed) and alias (output bytes
    that are argument storage, written in place) bytes.

    ``total_nonalias_bytes`` counts the aliased bytes once, as memory
    holds them: the reference's formula subtracts them twice."""
    out = {"argument_size_in_bytes": cost.argument_bytes,
           "output_size_in_bytes": cost.output_bytes,
           "temp_size_in_bytes": cost.peak_temp_bytes,
           "alias_size_in_bytes": cost.alias_bytes}
    out["total_nonalias_bytes"] = (out["argument_size_in_bytes"]
                                   + out["output_size_in_bytes"]
                                   + out["temp_size_in_bytes"]
                                   - out["alias_size_in_bytes"])
    return out
