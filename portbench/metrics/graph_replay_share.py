"""graph_replay_share: the window's steps that ran as one replay of the
step's CUDA graph (``StepGraph.replays``), over its steps
(``RenderStats.steps_rendered``), in percent. Layer: the step graph
(``core/stepgraph.py``). Reads 0 where no step replayed: that is a
reading, not a missing one."""


def read(rec):
    steps = rec.counters.get("stats.steps_rendered")
    return 100.0 * rec.counters.get("step_graph.replays", 0) / steps if steps else None
