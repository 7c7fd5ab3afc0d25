"""rt_xrt: audio seconds of the realtime steps completed in the window over
its wall seconds (host clock; realtime cells). One stream costs its inverse
of the device period."""


def read(rec):
    return rec.audio_s / rec.wall_s if rec.wall_s > 0 else None
