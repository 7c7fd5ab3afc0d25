"""K10b as one prologue launch a step: the batched table against the path
it replaces, on the CPU.

* ``spatial_gains_batch_plain`` over a ``pack_gains_table`` table equals,
  bit for bit, ``spatial_gains_plain`` on the stacked [17, V, S] params the
  step used to build from each param's values (``ParamSignal.per_block``
  of its K6 arena rows or its base value): a-rate, k-rate and constant
  sources, two stages under two distance models, one occluded with
  transmission (``testing/tables.panner_stages``);
* the kernel's reads, walked in numpy thread by thread over the plan's
  words, give the same params, and its writes cover the output arena
  once, each stage's rows where P1 reads them; past 32 stages the table
  splits into plans of at most 32;
* in a graph of two panner groups under two distance models and an
  occluded group, the step makes one K10b call, the panners' ``process``
  gets none of the 17 params, and the render matches the JAX package's
  within 1e-5.
"""

import numpy as np
import pytest
import torch

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.core.graph import to_device
from graphaudio_tpu_torch.nodes import spatial as tsp
from graphaudio_tpu_torch.ops import param_eval as tpe
from graphaudio_tpu_torch.testing import tables as ttab

SR = 48000
S = 8
LISTENER = {"listener_pos": torch.tensor([0.5, 0.1, -0.3]),
            "listener_right": torch.tensor([0.8, 0.0, 0.6]),
            "listener_up": torch.tensor([0.0, 1.0, 0.0]),
            "listener_ahead": torch.tensor([-0.6, 0.0, 0.8])}
MODELS = {1: tsp.DistanceModelType.INVERSE, 2: tsp.DistanceModelType.EXPONENTIAL,
          0: tsp.DistanceModelType.LINEAR}


def _tables(step, models=(1, 2)):
    """The K6 table and arena at ``step`` and the K10b table, as tensors;
    the stages' slots."""
    k6, stages = ttab.panner_stages(4, S, 6 * S * ttab.BLOCK, models)
    k6 = to_device(k6, "cpu")
    bt = torch.from_numpy(ttab.block_clock(6 * S)[step * S:(step + 1) * S])
    arena = tpe.eval_intrinsic_batch_plain(k6, bt, ttab.DT)
    return arena, to_device(tsp.pack_gains_table(stages, S), "cpu"), stages


def _stacked_p(slots, arena):
    """The [17, V, S] stack the panner's ``process`` built before K10b moved
    into the prologue: each param's arena rows through ``per_block`` (a-rate
    rows keep every 128th sample), or its base value broadcast."""
    rows = []
    for name in tsp.GAIN_PARAMS:
        slot = slots[name]
        if slot.off < 0:
            vals = torch.from_numpy(slot.base).unsqueeze(-1).expand(slot.lanes, S)
        else:
            vals = arena.narrow(0, slot.off, slot.lanes * slot.per_lane).view(
                slot.lanes, slot.per_lane)
            vals = vals[..., ::128] if slot.npb == 128 else vals
        rows.append(vals)
    return torch.stack(rows)


@pytest.mark.parametrize("models", [(1, 2), (0, 1)])
@pytest.mark.parametrize("step", [0, 3, 5])
def test_batch_plain_is_the_per_stage_path(step, models):
    arena, table, stages = _tables(step, models)
    got = tsp.spatial_gains_batch(table, arena, LISTENER)  # CPU: the plain version
    assert len(got) == 2
    for out, (code, slots) in zip(got, stages):
        want = tsp.spatial_gains_plain(_stacked_p(slots, arena), LISTENER, MODELS[code])
        assert out.shape == want.shape and out.is_contiguous()
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    if step == 0:  # the occluded stage's band gains differ in this step
        assert not torch.equal(got[1][2], got[1][4])


def test_batch_plain_without_an_arena():
    """A step with no param events (arena None): every word a constant."""
    stages = []
    for code, V in ((1, 2), (2, 1)):
        slots = {n: tpe.constant_slot({"base": np.full(V, 0.5 + j, np.float32)}, 1, S)
                 for j, n in enumerate(tsp.GAIN_PARAMS)}
        stages.append((code, slots))
    table = to_device(tsp.pack_gains_table(stages, S), "cpu")
    for out, (code, slots) in zip(tsp.spatial_gains_batch(table, None, LISTENER), stages):
        want = tsp.spatial_gains_plain(_stacked_p(slots, None), LISTENER, MODELS[code])
        assert torch.equal(out, want)


def _decode_plan(words):
    """csrc/spatial_gains.cu's GainsPlan from its int32 words."""
    w = np.frombuffer(words, np.int32)
    M, P = tsp.GAINS_MAX_STAGES, len(tsp.GAIN_PARAMS)
    n, w = int(w[0]), w[1:]
    lane0, w = w[:M + 1], w[M + 1:]
    model, out, src = w[:M], w[M:2 * M], w[2 * M:].reshape(M, P)
    return n, lane0, model, out, src


def test_table_walk():
    """csrc/spatial_gains.cu's reads and writes, thread by thread from the
    plan's words: thread i is (lane i // S, quantum i % S) of the plan; its
    stage is the last whose first lane it reaches; each param's word of the
    stage's lane 0 (``off << 2 | mode``) gives lane v's value at a fixed
    stride, the model and output offset come from the plan."""
    arena, table, stages = _tables(2)
    consts, src = table["consts"].numpy(), arena.numpy()
    want_p = [_stacked_p(slots, arena).numpy() for _, slots in stages]
    assert len(table["plans"]) == 1
    n, lane0, model, out, src_words = _decode_plan(table["plans"][0])
    assert (n, lane0[n]) == (2, 6)
    lanes = lane0[n]
    hits = np.zeros(table["size"], np.int64)
    for i in range(-(-lanes * S // 32) * 32):  # blocks of 32 threads
        lane, s = divmod(i, S)
        if lane >= lane0[n]:
            continue
        k = 0
        while lane >= lane0[k + 1]:
            k += 1
        v, V = lane - lane0[k], lane0[k + 1] - lane0[k]
        q = np.empty(17, np.float32)
        for j in range(17):
            mode, off = src_words[k, j] & 3, src_words[k, j] >> 2
            if mode == tpe.SRC_CONST:
                q[j] = consts[off + v]
            else:
                q[j] = src[off + (v * S + s) * (128 if mode == tpe.SRC_ARATE else 1)]
        assert np.array_equal(q, want_p[k][:, v, s])
        assert model[k] == stages[k][0]
        at = out[k] + v * S + s + V * S * np.arange(6)
        assert np.array_equal(at, table["stages"][k][0] + (np.arange(6) * V + v) * S + s)
        hits[at] += 1
    assert (hits == 1).all()


def test_more_stages_than_a_launch_takes():
    """Past GAINS_MAX_STAGES stages the table splits into plans of at most
    that many, the later ones' lanes counted from their first."""
    M = tsp.GAINS_MAX_STAGES
    stages = [(k % 3, {n: tpe.constant_slot({"base": np.full(1 + k % 2, 0.5, np.float32)}, 1, S)
                       for n in tsp.GAIN_PARAMS}) for k in range(M + 3)]
    table = tsp.pack_gains_table(stages, S)
    assert len(table["plans"]) == 2
    n, lane0, _, out, _ = _decode_plan(table["plans"][0])
    assert n == M and lane0[M] == sum(1 + k % 2 for k in range(M))
    n, lane0, _, out, _ = _decode_plan(table["plans"][1])
    assert n == 3 and list(lane0[:4]) == [0, 1, 3, 4]
    assert out[0] == table["stages"][M][0]


def _scene(mod, superblock=4, seed=24, **ctx_kw):
    """Six looped mono voices -> one SpatialPannerNode each -> destination:
    voices 0, 2 and 4 under the inverse model, 1 and 3 under the linear
    one, voice 5 occluded with transmission (three panner groups);
    positions ramp per quantum."""
    rng = np.random.default_rng(seed)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=superblock, **ctx_kw)
    ctx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
    for v in range(6):
        src = mod.AudioBufferSourceNode(ctx)
        src.buffer = mod.PlayableAudioBuffer.from_mono_array(
            (rng.standard_normal(SR // 8) * 0.3).astype(np.float32), SR)
        src.loop = True
        pan = mod.SpatialPannerNode(ctx)
        x0, z0 = rng.uniform(-4, 4, 2)
        pan.position_x.set_value_at_time(float(x0), 0.0)
        pan.position_x.linear_ramp_to_value_at_time(float(-x0), 0.04)
        pan.position_z.value = float(z0)
        if v in (1, 3):
            pan.distance_model = type(pan.distance_model).LINEAR
            pan.max_distance.value = 6.0
        if v == 5:
            pan.occlusion.value = 0.6
            pan.transmission_low.value = 0.7
            pan.transmission_high.value = 0.2
        src.connect(pan).connect(ctx.destination)
        src.start(0.001 * v)
    return ctx


def test_three_panner_groups_one_k10b_call_a_step_and_jax():
    from unittest import mock

    T = 4 * 128
    want = _scene(ga).render(3 * T + 100)
    tctx = _scene(gat, device="cpu")
    seen = []
    real = tsp.SpatialPannerNode.process

    def process(self, state, inputs, params, rc):
        seen.append(sorted(params))
        return real(self, state, inputs, params, rc)

    with mock.patch.object(tsp, "spatial_gains_batch", wraps=tsp.spatial_gains_batch) as sg, \
            mock.patch.object(tsp.SpatialPannerNode, "process", process):
        got = tctx.render(3 * T + 100)
    assert sg.call_count == 4  # one a step, three panner groups in each
    assert all(len(c.args[0]["stages"]) == 3 for c in sg.call_args_list)
    assert len(seen) == 12 and all(not set(p) & set(tsp.GAIN_PARAMS) for p in seen)
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < 1e-5
