"""The port's ``Prefetcher``, ``StackSteps`` and ``place_batch``
(``data/pipeline.py``): the JAX package's eight ``Prefetcher`` /
``StackSteps`` cases (tests/test_prefetch.py), and host placement on the
CPU."""

import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu.data.pipeline import cast_frames as ref_cast_frames
from action_conditioned_gans_tpu_torch.data import pipeline
from action_conditioned_gans_tpu_torch.data.pipeline import Prefetcher, StackSteps, place_batch

torch.set_num_threads(1)


class FakeDataset:
    def __init__(self, fail_at=None):
        self.fail_at = fail_at
        self.closed = False

    def batch_at(self, i):
        if self.fail_at is not None and i >= self.fail_at:
            raise ValueError("boom")
        return {"i": np.array(i)}

    def close(self):
        self.closed = True


def stream_order():
    pf = Prefetcher(FakeDataset(), depth=2)
    assert [int(pf.batch_at(k)["i"]) for k in range(5)] == [0, 1, 2, 3, 4]
    pf.close()


def error_propagates():
    pf = Prefetcher(FakeDataset(fail_at=2), depth=2)
    assert int(pf.batch_at(0)["i"]) == 0
    assert int(pf.batch_at(1)["i"]) == 1
    with pytest.raises(ValueError, match="boom"):
        pf.batch_at(2)
    pf.close()


def iter_protocol():
    pf = Prefetcher(FakeDataset(), depth=1)
    it = iter(pf)
    assert int(next(it)["i"]) == 0
    assert int(next(it)["i"]) == 1
    pf.close()


def close_terminates_blocked_fill_thread():
    """The fill thread exits though it is blocked on a full queue."""
    inner = FakeDataset()
    pf = Prefetcher(inner, depth=1)
    deadline = time.time() + 5
    while not pf._q.full() and time.time() < deadline:
        time.sleep(0.01)
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    assert inner.closed  # close() reaches the source


def batch_at_after_close_raises():
    pf = Prefetcher(FakeDataset(), depth=1)
    pf.close()
    pf.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        pf.batch_at(0)


def stacksteps_close_propagates():
    inner = FakeDataset()
    StackSteps(inner, k=2).close()
    assert inner.closed


def error_sentinel_survives_full_queue():
    """An error while the queue is full still reaches the consumer."""

    class OneGoodThenBoom:
        calls = 0

        def batch_at(self, i):
            self.calls += 1
            if self.calls > 1:
                raise RuntimeError("boom at batch 2")
            return {"x": i}

    pf = Prefetcher(OneGoodThenBoom(), depth=1)
    time.sleep(1.6)  # batch 1 fills the queue, batch 2 fails, past a 1 s put timeout
    assert pf.batch_at(0) == {"x": 0}
    with pytest.raises(RuntimeError, match="boom"):
        pf.batch_at(1)
    pf.close()


def close_unblocks_waiting_consumer():
    """close() from another thread ends a consumer's wait."""

    class Slow:
        def batch_at(self, i):
            time.sleep(60)
            return {"x": i}

    pf = Prefetcher(Slow(), depth=1)
    result = {}

    def consume():
        try:
            pf.batch_at(0)
            result["out"] = "item"
        except RuntimeError as e:
            result["out"] = str(e)

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.3)
    pf.close()
    t.join(timeout=10)
    assert not t.is_alive(), "consumer stayed blocked after close()"
    assert "closed" in result["out"]


CASES = [stream_order, error_propagates, iter_protocol, close_terminates_blocked_fill_thread,
         batch_at_after_close_raises, stacksteps_close_propagates,
         error_sentinel_survives_full_queue, close_unblocks_waiting_consumer]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_reference_case(case):
    case()


def test_stats_count_what_was_filled_and_waited():
    pf = Prefetcher(FakeDataset(), depth=2)
    for k in range(3):
        pf.batch_at(k)
    pf.close()
    s = pf.stats
    assert s["batches"] == 3 and s["filled"] >= 3
    assert s["fill_s"] >= 0 and s["wait_s"] >= 0
    assert pf._thread.name == pipeline.FILL_THREAD and not pf._thread.is_alive()


class SlowDataset:
    """A source whose ``batch_at`` takes ``seconds`` (a loaded host parsing a
    batch); ``close`` records whether the fill thread was still alive."""

    def __init__(self, seconds):
        self.seconds, self.started = seconds, threading.Event()
        self.closed_with_fill_alive = None

    def batch_at(self, i):
        self.started.set()
        time.sleep(self.seconds)
        return {"i": np.array(i)}

    def close(self):
        self.closed_with_fill_alive = any(t.name == pipeline.FILL_THREAD and t.is_alive()
                                          for t in threading.enumerate())


def test_close_waits_for_a_batch_at_in_progress():
    """A ``batch_at`` that outlasts the 5 s join close used to give up after:
    close returns only once the fill thread has ended, and closes the source
    after it."""
    ds = SlowDataset(5.5)
    pf = Prefetcher(ds, depth=1)
    assert ds.started.wait(10)
    pf.close()
    assert not pf._thread.is_alive()
    assert ds.closed_with_fill_alive is False
    assert not [t for t in threading.enumerate() if t.name == pipeline.FILL_THREAD]


def test_close_raises_naming_a_fill_thread_past_its_deadline():
    """A fill thread alive after ``close_timeout_s`` raises, naming it, and
    the source is not closed under it; a later close ends cleanly."""
    ds = SlowDataset(1.5)
    pf = Prefetcher(ds, depth=1)
    pf.close_timeout_s = 0.2
    assert ds.started.wait(10)
    with pytest.raises(RuntimeError, match=pipeline.FILL_THREAD):
        pf.close()
    assert ds.closed_with_fill_alive is None
    pf.close_timeout_s = 30.0
    pf.close()
    assert not pf._thread.is_alive() and ds.closed_with_fill_alive is False


class ArrayDataset:
    def batch_at(self, i):
        rng = np.random.RandomState(i)
        return {"frames": rng.uniform(-1, 1, (3, 2, 4, 4, 3)).astype(np.float32),
                "actions": rng.randn(3, 1, 4).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacksteps_places_once_as_the_reference_casts(dtype):
    """(k, B, ...) stacked on the host, frames cast as the JAX package casts
    them (ml_dtypes for bf16), actions float32; host arrays without a device."""
    raw = [ArrayDataset().batch_at(i) for i in range(4)]
    host = StackSteps(ArrayDataset(), 2).batch_at(0)
    assert isinstance(host["frames"], np.ndarray) and host["frames"].shape == (2, 3, 2, 4, 4, 3)
    assert np.array_equal(host["frames"], np.stack([raw[0]["frames"], raw[1]["frames"]]))
    placed = StackSteps(ArrayDataset(), 2, "cpu", dtype).batch_at(1)
    want = ref_cast_frames({"frames": np.stack([raw[2]["frames"], raw[3]["frames"]])}, dtype)
    got = placed["frames"]
    assert got.device.type == "cpu" and not got.is_pinned()
    if dtype == "bfloat16":
        assert want["frames"].dtype == ml_dtypes.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(), want["frames"].view(np.int16))
    else:
        assert np.array_equal(got.numpy(), want["frames"])
    assert placed["actions"].dtype == torch.float32
    assert np.array_equal(placed["actions"].numpy(), np.stack([raw[2]["actions"], raw[3]["actions"]]))


def test_pinning_follows_the_target_device(monkeypatch):
    """A CPU target is never pinned, even where CUDA is present; nothing of
    CUDA is touched on the way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_cuda(*a, **k):
        raise AssertionError("place_batch touched CUDA for a CPU target")

    monkeypatch.setattr(torch.cuda, "Stream", no_cuda)
    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    out = place_batch({"frames": np.ones((2, 3), np.float32), "states": np.zeros((2, 1), np.float32)},
                      "cpu", "bfloat16")
    assert out["frames"].dtype == torch.bfloat16 and not out["frames"].is_pinned()
    assert out["states"].dtype == torch.float32 and not out["states"].is_pinned()
    batch = {"frames": torch.zeros(1)}
    assert pipeline.adopt(batch) is batch  # host batches pass through
