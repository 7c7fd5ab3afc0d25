"""k2a_roofline: K2a, the partitioned convolver's spectral MAC
(``conv_mac_kernel``, ``csrc/conv.cu``), as a share of its roofline in the
traced sub-window (``portbench/roofline.py``), in percent.

Its work a launch at the cell's convolver (K instances, L sub-blocks a
step, P partitions, NB bins; ``roofline.conv_geometry``), each byte once:
this step's spectra in (complex64), the IR's partition spectra (re, im),
the ring's P - 1 past slots read, the sums out and this step's L slots
written into the ring; a complex multiply-add (8 flops) a (sub-block,
partition, bin) (the count of ``chip_smoke.py``'s K2a check, frozen).
Config 4's convolver has the IR's two channels; config 5's reverb one.
"""

from portbench import roofline

KERNEL = "conv_mac_kernel"


def work(cfg, superblock):
    K = cfg.get("ir_channels", 1)
    M = int(round(cfg["ir_seconds"] * cfg["sample_rate"]))
    L, P, NB = roofline.conv_geometry(superblock, M)
    moved = K * NB * (8 * L + 2 * 4 * P + 2 * 4 * (P - 1) + 8 * L + 2 * 4 * L)
    return moved, 8 * K * L * P * NB


def read(rec):
    return roofline.share(rec, KERNEL, work)
