"""train_mfu_pct (%): model operations of the window's steps (forward
and backward, three times the forward's: every position's weight
products, the SSD scan on the model's chunk, the head at every position)
over the same time as ``train_tokens_per_s`` times the bf16 peak."""

from perfbench import work


def read(run):
    if run.get("kind") != "train" or not run["steps"]:
        return None
    c = run["config"]
    B, S = c["train"]["batch"], c["train"]["seq"]
    fwd = B * (work.prefill_flops(c, S) + (S - 1) * work.head_flops(c))
    return 100.0 * 3 * fwd * run["steps"] / (
        (run["t1"] - run["t0"]) * work.PEAK_BF16_FLOPS)
