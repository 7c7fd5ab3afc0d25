"""``realtime_step``: a ``RealtimeAudioContext`` on the null output with no
render thread, and calls of ``render_step_blocking``, one superblock each.

A mix's keys: ``device_period_frames``, the context's period. Edits, if
any, are made before each step that they fall due at.
"""

CONTEXT = "realtime"
EDITS = True


def call_frames(drv) -> int:
    return drv.step_frames


def open_context(drv):
    from graphaudio_tpu_torch.realtime import RealtimeAudioContext

    return RealtimeAudioContext(
        sample_rate=drv.sr, channels=2, buffer_size=drv.mix["device_period_frames"],
        output_device="null", superblock=drv.superblock, auto_start_thread=False,
        device=drv.device)


def call(drv):
    """f32[C, T]: the step's audio."""
    drv.edit_before(drv.steps)
    out = drv.ctx.render_step_blocking()
    drv.steps += 1
    return out
