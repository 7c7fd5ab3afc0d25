"""launches_step: the port's kernel launches (the wrappers'
``cudabuild.launches`` counts, ``launches.<name>`` in the record's
counters; a ``name/mode`` sub-count repeats a launch already counted) over
the traced run's window, over the steps it ran (pipe rows included).
Layer: the step loop (``core/graph.py``)."""


def read(rec):
    rows = rec.spans.get("rows")
    if not rows:
        return None
    return sum(v for k, v in rec.counters.items()
               if k.startswith("launches.") and "/" not in k) / rows
