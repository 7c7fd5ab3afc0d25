"""xrt: audio seconds the window's whole render calls delivered to the host
over their wall seconds (host clock; offline cells)."""


def read(rec):
    return rec.audio_s / rec.wall_s if rec.wall_s > 0 else None
