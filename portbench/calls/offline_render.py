"""``offline_render``: an ``OfflineAudioContext`` and calls of
``render(call_seconds of frames)``, f32 delivered to the host.

A mix's keys: ``call_seconds``. The kind takes no edits.
"""

CONTEXT = "offline"
EDITS = False


def call_frames(drv) -> int:
    return int(round(drv.mix["call_seconds"] * drv.sr))


def open_context(drv):
    import graphaudio_tpu_torch as ga

    return ga.OfflineAudioContext(sample_rate=drv.sr, superblock=drv.superblock,
                                  device=drv.device)


def call(drv):
    """f32[C, n]: the call's audio as the reference compares it."""
    out = drv.ctx.render(drv.call_frames)
    drv.steps = -(-(drv.frame + out.shape[1]) // drv.step_frames)
    return out
