"""build_ms: the host wall of building the scene (the Kit and the graph's
nodes) plus the warm-up calls' graph compile (the launches' breakdown
``parts.compile``), in set-up, in milliseconds. Layer: the graph compile
(``core/graph.py``, ``kit/``)."""


def read(rec):
    return 1e3 * rec.build_s
