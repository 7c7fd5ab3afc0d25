"""rt_step_p99_ms: the 99th percentile of the host wall of every
``render_step_blocking`` of the traced run's window (before the profiled
sub-window), in milliseconds; nothing where the window held fewer than
1000 steps. Layer: the realtime context (``realtime/context.py``)."""

import numpy as np


def read(rec):
    if len(rec.call_walls) < 1000:
        return None
    return 1e3 * float(np.percentile(rec.call_walls, 99))
