"""graph_captures (count): ``graph.capture`` spans in the window: CUDA
graphs the program captured while serving (a re-capture stalls the live
tick)."""

from perfbench import spans


def read(run):
    tr = spans.load(run)
    return None if tr is None else int(len(tr.inside("graph.capture")))
