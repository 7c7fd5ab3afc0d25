"""k1_roofline: K1, the polyphase voice group's whole step
(``poly_step_kernel``, ``csrc/poly_resample.cu``), as a share of its
roofline in the traced sub-window (``portbench/roofline.py``), in percent.

Its work a launch at config 4's shapes (V voices, one channel, S quanta,
the rate p / q in lowest terms), each byte once: the output, the arena
samples the outputs read (ceil(T p / q) + 3 a voice), the eight state
fields read (six f64, two i32) and the three written, the group table
(V + 1 rows of 10 f64), the block clocks and end clocks, the phase table
(q x 4 weights, q bases); 4 multiplies and 3 adds an output sample
(the count of ``chip_smoke.py``'s K1 check, frozen).
"""

import math

from portbench import roofline

KERNEL = "poly_step_kernel"


def work(cfg, superblock):
    V, C, T = cfg["voices"], 1, superblock * 128
    g = math.gcd(cfg["voice_rate"], cfg["sample_rate"])
    p, q = cfg["voice_rate"] // g, cfg["sample_rate"] // g
    out = V * C * T * 4
    read = V * C * (math.ceil(T * p / q) + 3) * 4
    states = V * (6 * 8 + 2 * 4) + V * (8 + 8 + 4)
    tables = (V + 1) * 10 * 8 + 2 * superblock * 8 + q * 4 * 4 + q * 4
    return out + read + states + tables, 7 * V * C * T


def read(rec):
    return roofline.share(rec, KERNEL, work)
