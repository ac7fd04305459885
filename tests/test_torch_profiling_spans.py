"""The program's own spans (``utils/profiling.py``) on the CPU at
tiny widths: a serving request's ``rollout`` span and its parts, a training
call's steps split into their seven phases, the profiler annotation entered
only under a profiler, ``ACGAN_TELEMETRY=0`` and the bounded ring."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.data.synthetic import SyntheticClips
from action_conditioned_gans_tpu_torch.infer import Predictor
from action_conditioned_gans_tpu_torch.models import Generator
from action_conditioned_gans_tpu_torch.models.common import ConvBlock
from action_conditioned_gans_tpu_torch.train import init_state
from action_conditioned_gans_tpu_torch.train.step import make_multi_train_step
from action_conditioned_gans_tpu_torch.utils import profiling
from action_conditioned_gans_tpu_torch.utils import trace_report as tr

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ["inputs", "g_rollout", "d_update", "d_adam", "g_grad", "g_adam", "metrics"]


def tiny(steps_per_call=2):
    base = tcfg.get_preset("config1")
    return dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, image_size=16, g_levels=2, g_base_channels=8,
                                  d_levels=2, d_base_channels=8, group_norm_groups=4),
        train=dataclasses.replace(base.train, batch_size=2, rollout_length=3,
                                  steps_per_call=steps_per_call))


@pytest.fixture
def predictor():
    cfg = tiny()
    gen = Generator(cfg.model)
    blocks = sum(isinstance(m, ConvBlock) for m in gen.modules())
    return Predictor(cfg, {k: v.detach() for k, v in gen.state_dict().items()},
                     device="cpu"), blocks


def request(p, b=3, t=4):
    m = p.cfg.model
    rng = np.random.default_rng(0)
    return (rng.uniform(-1, 1, (b, m.image_size, m.image_size, m.image_channels)).astype(np.float32),
            rng.uniform(-1, 1, (b, t, m.action_dim)).astype(np.float32))


def test_a_rollout_records_one_span_a_request_with_its_three_parts(predictor):
    p, blocks = predictor
    assert blocks > 0
    profiling.reset()
    for _ in range(2):
        p.rollout(*request(p))
    recs = profiling.records()
    rollouts = [r for r in recs if r.name == "rollout"]
    assert len(rollouts) == 2
    for r in rollouts:
        assert r.parent is None and r.unit == r.id
        assert r.attrs == {"B": 3, "T": 4, "dispatches": blocks * 4}
        parts = [c for c in recs if c.unit == r.unit and c is not r]
        assert [c.name for c in parts] == ["rollout.inputs", "rollout.steps", "rollout.stack"]
        for c in parts:
            assert c.parent == r.id
            assert r.start_ns <= c.start_ns <= c.end_ns <= r.end_ns
        assert sum(c.host_ms for c in parts) <= r.host_ms


def test_a_training_call_records_each_steps_seven_phases_in_order():
    cfg = tiny(steps_per_call=2)
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_multi_train_step(cfg, "cpu")
    batch = SyntheticClips(2, 4, 16, seed=3, stack=2, device="cpu").batch_at(0)
    profiling.reset()
    step(state, batch)
    recs = profiling.records()
    (call,) = [r for r in recs if r.name == "train_call[k=2]"]
    assert call.attrs == {"k": 2}  # no allocator counts off CUDA
    steps = [r for r in recs if r.name == "step"]
    assert len(steps) == 2
    for s in steps:
        assert s.parent == call.id and s.unit == s.id != call.unit
        phases = [r for r in recs if r.parent == s.id]
        assert [r.name for r in phases] == [f"step.{p}" for p in PHASES]
        assert all(r.unit == s.unit for r in phases)
        # Contiguous, inside the step, and covering nearly all of it.
        for a, b in zip(phases, phases[1:]):
            assert a.end_ns <= b.start_ns
        assert s.start_ns <= phases[0].start_ns and phases[-1].end_ns <= s.end_ns
        assert sum(r.host_ms for r in phases) >= 0.9 * s.host_ms
        # On the CPU the host time stands in for the device's.
        assert all(r.device_ms == r.host_ms for r in phases + [s])


def test_no_record_function_without_a_profiler_and_the_spans_in_a_trace(predictor, tmp_path,
                                                                         monkeypatch):
    p, _ = predictor
    entered = []
    real = torch.profiler.record_function

    def spy(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    p.rollout(*request(p))
    assert entered == []
    with profiling.trace(str(tmp_path), device="cpu"):
        p.rollout(*request(p))
    assert [n for n in entered if n.startswith("acgan:")] == [
        "acgan:rollout", "acgan:rollout.inputs", "acgan:rollout.steps", "acgan:rollout.stack"]
    trace = tr.load_trace(str(tmp_path))
    names = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"acgan:rollout", "acgan:rollout.inputs", "acgan:rollout.steps",
            "acgan:rollout.stack"} <= names


def test_phase_outside_a_device_span_and_counters(predictor):
    """Phases split only a span given a device; the conv block counter a
    request's ``dispatches`` reads (``ops.common.conv_blocks``) counts each
    block call once."""
    from action_conditioned_gans_tpu_torch.ops.common import conv_blocks

    profiling.reset()
    profiling.phase("nothing")  # no span open: nothing happens
    with profiling.span("outer") as s:
        profiling.phase("ignored")  # outer has no device: nothing happens
        s.set(n=1)
    with profiling.span("timed", device="cpu"):
        with profiling.span("inner"):
            pass
        profiling.phase("a")
        profiling.phase("b")
    assert [(r.name, r.attrs) for r in profiling.records()] == [
        ("outer", {"n": 1}), ("timed", {}), ("inner", {}), ("timed.a", {}), ("timed.b", {})]
    p, blocks = predictor
    before = conv_blocks()
    p.rollout(*request(p, t=2))
    assert conv_blocks() - before == 2 * blocks


def test_telemetry_off_records_nothing_and_the_ring_is_bounded():
    code = ("from action_conditioned_gans_tpu_torch.utils import profiling as p\n"
            "with p.span('a', device='cpu') as s:\n"
            "    s.set(x=1); p.phase('b')\n"
            "print(len(p.records()), p.ENABLED)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, ACGAN_TELEMETRY="0"), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "False"]
    profiling.reset()
    for i in range(profiling.RING + 10):
        with profiling.span("s", i=i):
            pass
    recs = profiling.records()
    assert len(recs) == profiling.RING
    assert recs[0].attrs == {"i": 10} and json.dumps(recs[-1].attrs) == '{"i": %d}' % (
        profiling.RING + 9)
    profiling.reset()
    assert profiling.records() == []


class FakeEvent:
    """A CUDA timing event that records nothing and reads 1 ms apart."""

    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.0


def test_a_cuda_device_span_takes_its_events_at_most_once_an_interval(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(profiling._local, "timed_ns", 0, raising=False)
    profiling.reset()
    FakeEvent.made = 0

    def step():
        with profiling.span("step", unit=True, device="cuda"):
            for p in PHASES:
                profiling.phase(p)

    step()  # more than DEVICE_EVERY_NS since the last timed span: timed
    step()  # right after it: not timed
    assert FakeEvent.made == len(PHASES) + 1  # one event a boundary, on the first step only
    profiling._local.timed_ns -= profiling.DEVICE_EVERY_NS
    step()
    recs = profiling.records()
    steps = [r for r in recs if r.name == "step"]
    assert [s.device_ms for s in steps] == [1.0, None, 1.0]
    for s in steps:
        phases = [r for r in recs if r.parent == s.id]
        assert [r.name for r in phases] == [f"step.{p}" for p in PHASES]
        assert all(r.device_ms == s.device_ms for r in phases)


def test_a_cuda_training_call_records_the_allocators_counts(monkeypatch):
    from action_conditioned_gans_tpu_torch.train import step as S

    reads = iter([{"num_device_alloc": 5, "num_device_free": 2, "num_alloc_retries": 0},
                  {"num_device_alloc": 7, "num_device_free": 3, "num_alloc_retries": 1}])
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", lambda device=None: next(reads))
    profiling.reset()
    with S._call_span(torch.device("cuda"), 4):
        pass
    with S._call_span(torch.device("cpu"), 4):  # off CUDA: no counts
        pass
    assert [(r.name, r.attrs) for r in profiling.records()] == [
        ("train_call[k=4]", {"k": 4, "device_alloc": 2, "device_free": 1, "alloc_retries": 1}),
        ("train_call[k=4]", {"k": 4})]
