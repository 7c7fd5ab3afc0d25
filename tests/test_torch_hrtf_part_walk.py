"""A numpy walk of K10p-a's schedule, and the partitioned filter's folded
input pass and inverse scale, on the CPU.

* ``walk_mac`` models csrc/hrtf_part.cu ``hrtf_part_mac_kernel`` block by
  block in f32 numpy operations: the block's window of the ring and X,
  the two change masks of its rows (direction bits, corners), and each
  partition's walk over the block's quanta, which interpolates a spectrum
  only at the walk's first step and where the direction changes, and
  fetches the four corners only at the first step and where they change.
  It holds the walk bit for bit against ``partitioned_mac_plain`` at every
  block length of ``MAC_BLOCK_QUANTA``: directions moving every quantum,
  still (ring and superblock), and in runs of 1-5 quanta across the ring
  boundary, at S = 1 and 4 with P = 8 too; and counts what it fetches;
* ``mac_block_quanta``: the block length the launcher picks;
* the input pass's plain version (gain, mean, zero half) through rfft,
  the plain MAC, the unscaled inverse and the plain K10p-b with its 2^-8:
  bit for bit the filter as it was composed before the fold (rfft with
  its own pad, irfft with its own scale).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from graphaudio_tpu_torch.ops import hrtf as th
from graphaudio_tpu_torch.testing import hrtf_part

SRC = Path(th.__file__).resolve().parents[1] / "csrc" / "hrtf_part.cu"
K_MAX_P = int(re.search(r"constexpr int kMaxP = (\d+);", SRC.read_text()).group(1))


def _u32(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def walk_mac(X, hx, haz, hel, az, el, spec_r, spec_i, Q):
    """K10p-a's blocks of Q output quanta, one after another. Returns the
    kernel's outputs (acc complex64 [V, S, 2, 129], the next ring, its
    directions) as numpy arrays and the counts of spectra interpolated and
    corner sets fetched, per block."""
    X = X.numpy()
    hx, haz, hel, az, el = (t.numpy() for t in (hx, haz, hel, az, el))
    sr, si = spec_r.numpy(), spec_i.numpy()
    V, S, B = X.shape
    E, A, _, P, _ = sr.shape
    R = P - 1
    assert Q + K_MAX_P - 1 <= 32  # warp 0 plans the window a lane a row
    # The grid spectra as [E*A, ear, P, B] (re and im): a corner set is 4 rows.
    gre, gim = sr.reshape(E * A, 2, P, B), si.reshape(E * A, 2, P, B)
    acc = np.full((V, S, 2, B), np.nan, np.complex64)
    ring = np.full((V, R, 2 * B), np.nan, np.float32)
    raz = np.full((V, R), np.nan, np.float32)
    rel = np.full((V, R), np.nan, np.float32)
    counts = []
    for v in range(V):
        cat_az = np.concatenate([haz[v], az[v]])
        cat_el = np.concatenate([hel[v], el[v]])
        rows_t, w_t = th.interp_corners(torch.from_numpy(cat_az), torch.from_numpy(cat_el), E, A)
        rows, w = rows_t.numpy().T, w_t.numpy().T  # [R + S, 4]
        for s0 in range(0, S, Q):
            nq = min(Q, S - s0)
            nw = nq + R
            cs = range(s0, s0 + nw)  # the window: concatenation rows s0 .. s0 + nw - 1
            wre = np.stack([hx[v, c, :B] if c < R else X[v, c - R].real for c in cs])
            wim = np.stack([hx[v, c, B:] if c < R else X[v, c - R].imag for c in cs])
            d_az, d_el = _u32(cat_az[s0:s0 + nw]), _u32(cat_el[s0:s0 + nw])
            r0 = rows[s0:s0 + nw, 0]
            dmask = sum(1 << j for j in range(1, nw) if d_az[j] != d_az[j - 1]
                        or d_el[j] != d_el[j - 1])
            rmask = sum(1 << j for j in range(1, nw) if r0[j] != r0[j - 1])
            walk = (1 << nq) - 1
            yr = np.zeros((nq, 2, B), np.float32)
            yi = np.zeros((nq, 2, B), np.float32)
            n = {"interp": 0, "fetch": 0}

            def fetch(j, p):
                n["fetch"] += 1
                rw = rows[s0 + j]
                return gre[rw, :, p], gim[rw, :, p]  # [4, ear, B] each

            def interp(j, g):
                n["interp"] += 1
                wt = w[s0 + j]
                out = []
                for gg in g:
                    h = wt[0] * gg[0]
                    for c in range(1, 4):
                        h = h + wt[c] * gg[c]
                    out.append(h)
                return out

            for p in range(P):
                j0 = R - p
                dm = (dmask >> j0) & walk & ~1
                rm = (rmask >> j0) & walk & ~1
                g = fetch(j0, p)
                hr, hi = interp(j0, g)
                for s in range(nq):
                    j = j0 + s
                    if (dm >> s) & 1:
                        if (rm >> s) & 1:
                            g = fetch(j, p)
                        hr, hi = interp(j, g)
                    xr, xi = wre[j][None], wim[j][None]
                    yr[s] = (yr[s] + xr * hr) - xi * hi
                    yi[s] = (yi[s] + xr * hi) + xi * hr
            acc[v, s0:s0 + nq] = yr + 1j * yi
            if s0 + nq == S:  # the last block writes the next ring
                ring[v] = np.concatenate([wre[nq:], wim[nq:]], axis=1)
                raz[v], rel[v] = cat_az[s0 + nq:s0 + nw], cat_el[s0 + nq:s0 + nw]
            counts.append(dict(n, nq=nq))
    return (acc, ring, raz, rel), counts


CASES = ["S=1 P=8", "S=4 P=8", "stereo P=2", "P=3 ragged", "static P=8", "static P=2",
         "runs P=8", "runs P=2"]


def _mac_args(label, V=6):
    case = hrtf_part.PART_CASES[label]
    return hrtf_part.kernel_inputs(hrtf_part.seeded_case("cpu", V, *case[1:]))[1]


@pytest.mark.parametrize("Q", th.MAC_BLOCK_QUANTA)
@pytest.mark.parametrize("label", CASES)
def test_walk_matches_plain_bit_for_bit(label, Q):
    mac = _mac_args(label)
    got, counts = walk_mac(*mac, Q)
    want = [t.numpy() for t in th.partitioned_mac_plain(*mac)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint32) if g.dtype == np.float32 else
                                      g.view(np.uint64), w.view(np.uint32) if w.dtype ==
                                      np.float32 else w.view(np.uint64))
    P = mac[6].shape[3]
    motion = hrtf_part.PART_CASES[label][5]
    for n in counts:
        # a walk interpolates at its first step at least; one direction a
        # walk interpolates once and fetches once
        assert P <= n["fetch"] <= n["interp"] <= P * n["nq"]
        if motion == "static":
            assert n["fetch"] == n["interp"] == P


def test_static_and_runs_reuse():
    """Still directions cost P corner sets a block whatever its length;
    runs of 1-5 quanta (some crossing the ring boundary) fewer spectra
    than one a (quantum, partition)."""
    mac = _mac_args("runs P=8")
    haz, az = mac[2], mac[4]
    assert bool((haz[:, -1] == az[:, 0]).any())  # a run crosses the ring boundary
    _, counts = walk_mac(*mac, 16)
    P = 8
    total = sum(n["interp"] for n in counts)
    assert total < 0.5 * P * sum(n["nq"] for n in counts)
    _, counts = walk_mac(*_mac_args("static P=8"), 16)
    assert {n["fetch"] for n in counts} == {P}


def test_mac_block_quanta():
    rule = th.mac_block_quanta
    assert rule(128, 32, 132) == 16  # config5_measured: 256 blocks
    assert rule(64, 32, 132) == 8
    assert rule(32, 32, 132) == 4
    assert rule(1, 32, 132) == 4
    assert rule(128, 4, 132) == 4
    assert rule(128, 1, 132) == 4
    assert th.MAC_BLOCK_QUANTA[0] + K_MAX_P - 1 <= 32


def test_slice_partitions_are_the_kernels_instances():
    """K14b's wrapper takes 1 to ``MAX_SLICE_PARTITIONS`` partitions a
    slice: the counts ``ga_hrtf_part_mac_slice`` instantiates its kernel
    for, up to the longest HRIR's P; a slice of any ``part`` of a P <= 8
    filter fits."""
    src = SRC.read_text()
    cases = sorted(int(n) for n in re.findall(r"GA_SLICE_CASE\((\d+)\)", src))
    assert cases == list(range(1, th.MAX_SLICE_PARTITIONS + 1))
    assert th.MAX_SLICE_PARTITIONS == K_MAX_P == th.MAX_HRIR_LENGTH // 128
    for P in range(2, K_MAX_P + 1):
        for part in (2, 4, 8):
            assert 1 <= -(-P // part) <= th.MAX_SLICE_PARTITIONS


def _before_the_fold(x, gain, az, el, blend, sr, si, hx, haz, hel, ola):
    """The partitioned filter as composed before the input pass and the
    scale were folded into kernels: torch's gain multiply and mean,
    rfft's own zero pad, the plain MAC, irfft's own 1/256 and the
    overlap-add and blend of the scaled blocks."""
    V, C, T = x.shape
    S = T // 128
    q = x.reshape(V, C, S, 128)
    direct = q if gain is None else q * gain.reshape(V, 1, S, 1)
    mono = direct[:, 0] if C == 1 else direct.mean(dim=1)
    X = torch.fft.rfft(mono, n=256, dim=-1)
    acc, hx, haz, hel = th.partitioned_mac_plain(X, hx, haz, hel, az, el, sr, si)
    y = torch.fft.irfft(acc, n=256, dim=-1)
    first, second = y[..., :128], y[..., 128:]
    prev = torch.cat([ola[:, None], second[:, :-1]], dim=1)
    wet = (first + prev).permute(0, 2, 1, 3).reshape(V, 2, T)
    d = x if gain is None else x * torch.repeat_interleave(gain, 128, dim=-1)[:, None, :]
    dry = d.expand(V, 2, T) if C == 1 else d
    b = torch.repeat_interleave(blend, 128, dim=-1)[:, None, :]
    return wet * b + dry * (1.0 - b), hx, haz, hel, second[:, -1].contiguous()


@pytest.mark.parametrize("label", sorted(hrtf_part.PART_CASES))
def test_folded_input_and_scale_as_before(label):
    V, *rest = hrtf_part.PART_CASES[label]
    args = hrtf_part.seeded_case("cpu", min(V, 8), *rest)
    x, gain = args[:2]
    buf = th.partitioned_input_plain(x, gain)
    assert buf.shape == (x.shape[0], x.shape[2] // 128, 256) and not buf[..., 128:].any()
    want = _before_the_fold(*args)
    for got in (th.hrtf_fir_partitioned_plain(*args), th.hrtf_fir_partitioned(*args)):
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g.view(torch.int32), w.view(torch.int32))
