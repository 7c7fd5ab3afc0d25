"""p1_roofline: P1, the spatial panners' HRTF FIR (``hrtf_fir_kernel``,
``csrc/hrtf_fir.cu``), as a share of its roofline in the traced sub-window
(``portbench/roofline.py``), in percent.

Its work a launch at config 5's shapes (V panners, each input two
channels: a sound's gain node up-mixes its mono source to its channel
count 2, GraphAudio.Core's "max" mode; S quanta; the analytic grid of
E x A directions x 2 ears x L taps; a carried tail of W = 64), each byte
once: the input, the gain, azimuth, elevation
and blend a quantum, the grid, the tail in; the stereo output and the
tail out; 2 ears x L multiply-adds an input sample (the count of
``chip_smoke.py``'s P1 check, frozen).
"""

from portbench import roofline

KERNEL = "hrtf_fir_kernel"
E, A, L, W = 7, 24, 64, 64


def work(cfg, superblock):
    V, C, S = cfg["voices"], 2, superblock
    T = S * 128
    moved = (V * C * T * 4 + 4 * V * S * 4 + E * A * 2 * L * 4 + V * 2 * W * 4
             + V * 2 * T * 4 + V * 2 * W * 4)
    return moved, V * T * 2 * L * 2


def read(rec):
    return roofline.share(rec, KERNEL, work)
