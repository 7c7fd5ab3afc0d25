"""param_encode_us_step: the launches' param encodes, the breakdown's
``parts.param_encode`` summed over the traced run's window launches, over
the steps they ran, in microseconds. An encode runs only after a param was
edited (``core/context.py`` ``_ensure_params_encoded``; ``core/graph.py``
``encode_params`` re-encodes every param of the graph). Layer: param encode."""


def read(rec):
    rows = rec.spans.get("rows")
    return 1e6 * rec.spans["parts.param_encode"] / rows if rows else None
