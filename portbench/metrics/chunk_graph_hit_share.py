"""Share of the traced calls' 8-step ICP chunks that were replays of the
captured CUDA graph, %: 100 x ``icp.chunk_graph.replays`` / (the replays +
``icp.chunk_eager``, the chunks enqueued from Python), the program's
counters over the traced calls. A step path kept eager, or a graph
captured anew inside the window, shows here."""


def read(window):
    c = window.traced_counters
    replays = c.get("icp.chunk_graph.replays", 0)
    chunks = replays + c.get("icp.chunk_eager", 0)
    return 100.0 * replays / chunks if chunks else None
