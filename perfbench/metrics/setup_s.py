"""setup_s (s): process start to the window's start, on the host clock."""


def read(run):
    return run["setup_s"]
