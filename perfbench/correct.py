"""What decides ``correct``: the served tokens against the plain reference.

For a sample of the requests the window finished (drawn from the seed,
the longest always in it), the reference runs once over each request's
padded prompt and served tokens.  A served token's gap is how far the
reference's logit of that token lies below the reference's best logit at
its position; ``logit_gap`` is the widest gap over every sampled token.
``wrong_length`` counts finished requests of the window whose token count
is not the one their prompt bucket and budget give.  The control
(``control=True``) reads, at the same positions, the gap of the token that
the reference computed in float8 puts first; its numbers (``control``)
are judged in the program's place (`in_place_of_program`).
"""

from __future__ import annotations

import torch

from perfbench.reference import FORWARD
from perfbench.reference.common import Precision, full_f32


def _sequence(entry: dict, tokens: list, plen: int, device) -> torch.Tensor:
    prompt = entry["prompt"]
    seq = torch.zeros(plen + len(tokens) - 1, dtype=torch.long)
    seq[plen - len(prompt):plen] = torch.as_tensor(prompt)
    seq[plen:] = torch.as_tensor(tokens[:-1])
    return seq.to(device)


def serve_checks(out: dict, c: dict, rids: list[int], device,
                 control: bool = False) -> dict:
    fwd = FORWARD[c["family"]]
    tree = out["tree"]
    gap = ctl = 0.0
    n_tokens = 0
    diag = {"gap_sum": 0.0, "ctl_sum": 0.0, 
            "missed": 0, "ctl_missed": 0}
    with full_f32():
        for rid in rids:
            row = next(r for r in out["requests"] if r["rid"] == rid)
            toks = out["results"][rid]
            plen = row["plen"]
            seq = _sequence(out["entries"][rid], toks, plen, device)
            ref = fwd(tree, c, seq, plen, Precision("f32"))[plen - 1:]
            best = ref.max(dim=-1).values
            served = torch.as_tensor(toks, device=device)[:, None]
            g = best - ref.gather(1, served)[:, 0]
            gap = max(gap, float(g.max()))
            diag["gap_sum"] += float(g.sum())
            diag["missed"] += int((g > 0).sum())
            n_tokens += len(toks)
            if control:
                low = fwd(tree, c, seq, plen, Precision("fp8"))[plen - 1:]
                pick = low.argmax(dim=-1, keepdim=True)
                g = best - ref.gather(1, pick)[:, 0]
                ctl = max(ctl, float(g.max()))
                diag["ctl_sum"] += float(g.sum())
                diag["ctl_missed"] += int((g > 0).sum())
            del ref
    wrong = sum(1 for r in out["requests"]
                if r["in_window"] and r["tokens"] is not None
                and r["tokens"] != r["expected"])
    checks = {"logit_gap": gap, "wrong_length": wrong}
    return {"checks": checks, "control": {"logit_gap": ctl} if control else None,
            "compared_requests": len(rids), "compared_tokens": n_tokens,
            "diag": diag}


def in_place_of_program(checks: dict, control: dict) -> dict:
    """The numbers judged in a control run: the control's where it has
    one, the run's own otherwise (``failed``, ``wrong_length``); the
    program's readings follow as ``program_<number>``, which have no
    limit."""
    out = {**checks, **control}
    out.update({f"program_{k}": checks[k] for k in control})
    return out


def judge(checks: dict, limits: dict | None) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) for the numbers that have a
    limit; no limits file makes the run not correct."""
    table = {k: {"value": v, "limit": (limits or {}).get(k)}
             for k, v in checks.items()}
    if limits is None:
        return False, table
    ok = all(table[k]["value"] <= lim for k, lim in limits.items()
             if k in table)
    return ok and all(k in table for k in limits), table


def _worst(prog: dict, ref: dict, keep) -> float:
    """The widest gap of a leaf's norm between the program and the
    reference, over the larger of the reference leaf's norm and the median
    leaf's, among the leaves ``keep`` holds."""
    med = float(torch.tensor(sorted(ref[k] for k in keep)).median())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep)


def train_checks(out: dict, c: dict, device, control: bool = False) -> dict:
    """The program's first steps against the reference's: ``loss_gap``
    (each compared step's loss, the widest relative gap), ``grad_gap``
    (the gradients of step 0, eager, and step 1, the first replay of the
    captured step: each leaf's norm, the worst of both steps) and
    ``change_gap`` (each leaf's change after the compared steps).  Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move by round-off alone and are left out of both."""
    from perfbench.reference import train as ref_train

    def kept(g):
        med = float(torch.tensor(sorted(g.values())).median())
        return [k for k, v in g.items() if v >= 1e-3 * med]

    def gaps(prog, ref):
        steps = list(zip(prog["grad_norms"], ref["grad_norms"]))
        keep = kept(ref["grad_norms"][0])
        return {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(prog["losses"], ref["losses"])),
            "grad_gap": max(_worst(p, r, kept(r)) for p, r in steps),
            "change_gap": _worst(prog["change_norms"], ref["change_norms"],
                                 keep)}, len(ref["grad_norms"][0]) - len(keep)

    ref = ref_train.run(out["init"], c, out["batches"], device,
                        Precision("f32"))
    checks, dropped = gaps(out, ref)
    diag = {"losses": out["losses"], "ref_losses": ref["losses"],
            "leaves_left_out": dropped}
    ctl = None
    if control:
        low = ref_train.run(out["init"], c, out["batches"], device,
                            Precision("fp8"))
        ctl, _ = gaps(low, ref)
    return {"checks": checks, "control": ctl, "compared_requests": 0,
            "compared_tokens": sum(b["tokens"].size for b in out["batches"]),
            "diag": diag}
