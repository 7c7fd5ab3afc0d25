"""host_us_step: the render launches' host time, the breakdown's ``prep_s`` +
``enqueue_s`` summed over the traced run's window launches, over the steps
they ran (``rows``: pipe rows included), in microseconds. Layer: the
context (``core/context.py`` ``_render_steps_launch``)."""


def read(rec):
    rows = rec.spans.get("rows")
    return 1e6 * (rec.spans["prep_s"] + rec.spans["enqueue_s"]) / rows if rows else None
