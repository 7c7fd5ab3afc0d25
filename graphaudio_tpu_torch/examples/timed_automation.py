"""Timed commands: schedule graph edits on the block clock.

The twin of examples/timed_automation.py on the port. ``post_at(time, fn)``
lands a command at the first not-yet-rendered superblock boundary >= time
and ``render`` splits its steps there, so a param edit, a source's stop and
a topology edit (which rebuilds the graph, the running oscillator keeping
its phase) take effect inside one render call. Run:

    python -m graphaudio_tpu_torch.examples.timed_automation

(writes timed_automation.wav to the working directory).
"""

import numpy as np

import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.io import write_wav


def main(device="cuda"):
    ctx = gat.OfflineAudioContext(superblock=8, device=device)
    osc = gat.OscillatorNode(ctx)
    osc.frequency.value = 220.0
    lp = gat.BiQuadFilterNode(ctx, type=gat.FilterType.LOWPASS)
    lp.frequency.value = 800.0
    osc.connect(lp).connect(ctx.destination)
    osc.start(0)

    # t=1.0: open the filter (param edit)
    ctx.post_at(1.0, lambda c: setattr(lp.frequency, "value", 6000.0))

    # t=2.0: layer a fifth on top (topology edit: the graph is rebuilt at
    # the boundary, and the running oscillator's phase survives it)
    def add_fifth(c):
        o2 = gat.OscillatorNode(c)
        o2.frequency.value = 330.0
        g = gat.GainNode(c)
        g.gain.value = 0.5
        o2.connect(g).connect(lp)
        o2.start(c.current_time)

    ctx.post_at(2.0, add_fifth)

    # t=3.0: stop the root note (the fifth keeps ringing at half gain)
    ctx.post_at(3.0, lambda c: osc.stop(c.current_time))

    audio = ctx.render_seconds(3.5)  # ONE call; edits land mid-render
    write_wav("timed_automation.wav", audio, ctx.sample_rate)
    for t in (0.5, 1.5, 2.5, 3.4):
        seg = audio[0, int((t - 0.1) * ctx.sample_rate):int(t * ctx.sample_rate)]
        print(f"t={t:.1f}s rms={np.sqrt((seg ** 2).mean()):.4f}")
    print("graph builds:", ctx.stats.graph_builds)


if __name__ == "__main__":
    main()
