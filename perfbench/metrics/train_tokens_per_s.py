"""train_tokens_per_s (tokens/s): batch x sequence x the steps completed
in the window, over the time from the window's start to the end of the
last step completed in it (a step ends where the next one starts)."""


def read(run):
    if run.get("kind") != "train" or not run["steps"]:
        return None
    return run["tokens_per_step"] * run["steps"] / (run["t1"] - run["t0"])
