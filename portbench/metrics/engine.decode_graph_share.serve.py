"""The share of the engine's decode steps that replayed a captured CUDA
graph, in %: the program's ``serve.decode_graph_replays`` over its
``serve.decode_iters``, each over the process as the run leaves it (the
warm-up's eager step and the capture count as steps, not as replays).  A
program without the replay counter gives nothing."""
from portbench.harness import program


def read(run):
    replays = program.counter("serve.decode_graph_replays")
    steps = program.counter("serve.decode_iters")
    if not replays or not steps:
        return None
    return 100.0 * replays / steps
