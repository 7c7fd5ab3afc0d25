"""Utilities: render statistics, graph inspection, checkpoint/resume (the
JAX package's five names, graphaudio_tpu/utils/__init__.py), and the port's
own kernel build (``cudabuild``, ``nativebuild``) and JAX state hand-off
(``from_jax``, for the tests)."""

from graphaudio_tpu_torch.utils.profiling import RenderStats
from graphaudio_tpu_torch.utils.inspect import describe_graph, graph_to_dot
from graphaudio_tpu_torch.utils.checkpoint import save_context_state, load_context_state

__all__ = [
    "RenderStats",
    "describe_graph",
    "graph_to_dot",
    "save_context_state",
    "load_context_state",
]
