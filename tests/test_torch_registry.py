"""The model registry and the batcher's per-batch flip, held against the
reference's: every scenario runs on the reference's ``ModelRegistry`` and
``MicroBatcher`` and on the port's, over the same scripted engines, and must
give the reference's outcomes on both.

The scenarios are the reference's (``tests/test_serve_control.py``): a flip
through a batcher, an empty registry failing loudly, a flip that fails a
queued request alone (``serve.rejected_stale``), the ladder-coverage rule
on ``register`` and ``activate``, retiring the active entry, a JSON
``record()``; plus a stress case, threads submitting while another flips,
where no batch may span two engines.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest

import dgraph_tpu.obs.metrics as ref_metrics
import dgraph_tpu.serve.batcher as ref_batcher
import dgraph_tpu.serve.bucketing as ref_bucketing
import dgraph_tpu.serve.registry as ref_registry
import dgraph_tpu_torch.obs.metrics as port_metrics
import dgraph_tpu_torch.serve.batcher as port_batcher
import dgraph_tpu_torch.serve.bucketing as port_bucketing
import dgraph_tpu_torch.serve.registry as port_registry

IMPLS = {
    "reference": (ref_registry, ref_batcher, ref_bucketing, ref_metrics),
    "port": (port_registry, port_batcher, port_bucketing, port_metrics),
}
C = 3


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    registry, batcher, bucketing, metrics = IMPLS[request.param]
    return registry.ModelRegistry, batcher.MicroBatcher, bucketing.BucketLadder, metrics.Metrics


class ScriptedEngine:
    """An engine whose rows are ``ids * scale`` (each engine its own
    scale), with a graph size and an optional gate that holds ``infer``."""

    def __init__(self, ladder, num_nodes, metrics, scale=1.0, block=None, started=None):
        self.ladder = ladder
        self.num_nodes = num_nodes
        self.registry = metrics
        self.scale = np.float32(scale)
        self.calls = []
        self._block, self._started = block, started

    def infer(self, ids):
        if self._started is not None:
            self._started.set()
        if self._block is not None:
            assert self._block.wait(timeout=30)
        ids = np.asarray(ids)
        if ids.size and ids.max() >= self.num_nodes:
            raise ValueError("engine saw an id it was never validated for")
        self.calls.append(ids)
        return self.rows(ids)

    def rows(self, ids):
        return np.repeat(np.asarray(ids, np.float32)[:, None] * self.scale, C, axis=1)


def test_registry_flip_serves_through_batcher(impl):
    Registry, Batcher, Ladder, Metrics = impl
    blue = ScriptedEngine(Ladder((8, 16, 32)), 100, Metrics(), scale=1.0)
    green = ScriptedEngine(Ladder((8, 16, 32)), 100, Metrics(), scale=2.0)
    reg = Registry()
    reg.register("blue", blue, activate=True)
    assert reg.active_name == "blue"
    bat = Batcher(reg, max_batch_size=4, max_delay_ms=0.5)
    ids = np.arange(3, 12)
    try:
        np.testing.assert_array_equal(bat.infer(ids), blue.rows(ids))
        reg.register("green", green)
        assert reg.active_name == "blue"  # registered, not yet active
        reg.activate("green")
        assert reg.active_name == "green" and reg.active_engine is green
        np.testing.assert_array_equal(bat.infer(ids), green.rows(ids))
        rec = reg.record()
        assert rec["active"] == "green" and set(rec["models"]) == {"blue", "green"}
        json.dumps(rec)
    finally:
        bat.stop()
    assert len(blue.calls) == 1 and len(green.calls) == 1


def test_registry_empty_fails_loudly(impl):
    Registry, *_ = impl
    reg = Registry()
    with pytest.raises(KeyError):
        _ = reg.active_engine
    assert reg.active_name is None and reg.names() == [] and reg.lineage("x") == []
    with pytest.raises(KeyError):
        reg.activate("x")
    with pytest.raises(KeyError):
        reg.get("x")


def test_registry_flip_revalidates_queued_requests(impl):
    """A request validated against the old engine but flushed on a new one
    (a flip to a smaller graph between submit and flush) fails alone with
    the structured stale rejection; the rest of its batch is served."""
    Registry, Batcher, Ladder, Metrics = impl
    block, started = threading.Event(), threading.Event()
    eng_a = ScriptedEngine(Ladder((8,)), 100, Metrics(), block=block, started=started)
    eng_b = ScriptedEngine(Ladder((8,)), 50, Metrics())
    reg = Registry()
    reg.register("m", eng_a, activate=True)
    bat = Batcher(reg, max_batch_size=1, max_delay_ms=0.0, max_queue_depth=8)
    try:
        f0 = bat.submit(np.array([1, 2]))  # holds the worker inside infer
        assert started.wait(timeout=10)
        f_stale = bat.submit(np.array([80]))  # valid on A, stale on B
        f_ok = bat.submit(np.array([10]))  # valid on both
        reg.activate("m", eng_b)  # a rollback to a smaller graph
        block.set()
        f0.result(timeout=10)
        with pytest.raises(ValueError, match="engine now active"):
            f_stale.result(timeout=10)
        np.testing.assert_array_equal(f_ok.result(timeout=10), eng_b.rows([10]))
        assert all(c.max() < 50 for c in eng_b.calls if c.size)
        assert bat.registry.snapshot()["counters"]["serve.rejected_stale"] == 1
    finally:
        block.set()
        bat.stop()


def test_registry_flip_to_a_shorter_ladder_fails_too_large_alone(impl):
    """A queued request larger than the new engine's ladder (a
    replacement under a fresh name, which the coverage rule lets through)
    fails alone with ``too_large``."""
    Registry, Batcher, Ladder, Metrics = impl
    block, started = threading.Event(), threading.Event()
    eng_a = ScriptedEngine(Ladder((8, 16)), 100, Metrics(), block=block, started=started)
    eng_b = ScriptedEngine(Ladder((8,)), 100, Metrics())
    reg = Registry()
    reg.register("a", eng_a, activate=True)
    reg.register("b", eng_b)
    bat = Batcher(reg, max_batch_size=1, max_delay_ms=0.0, max_queue_depth=8)
    try:
        f0 = bat.submit(np.arange(2))
        assert started.wait(timeout=10)
        f_big = bat.submit(np.arange(12))  # fits A's 16, not B's 8
        f_ok = bat.submit(np.arange(5))
        reg.activate("b")
        block.set()
        f0.result(timeout=10)
        with pytest.raises(Exception) as info:
            f_big.result(timeout=10)
        assert getattr(info.value, "code", None) == "too_large"
        np.testing.assert_array_equal(f_ok.result(timeout=10), eng_b.rows(np.arange(5)))
        assert bat.registry.snapshot()["counters"]["serve.rejected_stale"] == 1
    finally:
        block.set()
        bat.stop()


def test_registry_ladder_coverage_on_register_and_activate(impl):
    Registry, _, Ladder, Metrics = impl
    big = ScriptedEngine(Ladder((8, 16, 32)), 100, Metrics())
    small = ScriptedEngine(Ladder((8,)), 100, Metrics())
    reg = Registry()
    reg.register("m", big, activate=True)
    with pytest.raises(ValueError):  # replacing the active entry by a shorter ladder
        reg.register("m", small, activate=True)
    with pytest.raises(ValueError):
        reg.activate("m", small)
    assert reg.active_engine is big
    reg.register("n", small)  # a fresh name may be shorter
    reg.activate("n")
    assert reg.active_engine is small
    reg.register("m", small)  # an inactive entry may shrink
    assert reg.get("m") is small
    wider = ScriptedEngine(Ladder((8, 16)), 100, Metrics())
    reg.activate("n", wider, note={"kind": "adopt", "generation": 2})
    assert reg.active_engine is wider
    assert reg.lineage("n") == [{"kind": "adopt", "generation": 2}]


def test_registry_retire_refuses_the_active_entry(impl):
    Registry, _, Ladder, Metrics = impl
    a = ScriptedEngine(Ladder((8,)), 10, Metrics())
    b = ScriptedEngine(Ladder((8,)), 10, Metrics())
    reg = Registry()
    reg.register("a", a, activate=True)
    reg.register("b", b)
    with pytest.raises(ValueError):
        reg.retire("a")
    reg.retire("b")
    reg.retire("missing")  # a no-op, as the reference's
    assert reg.names() == ["a"]
    with pytest.raises(KeyError):
        reg.get("b")


def test_registry_record_is_json_with_lineage(impl):
    Registry, _, Ladder, Metrics = impl
    reg = Registry()
    a = ScriptedEngine(Ladder((8,)), 10, Metrics())
    reg.register("a", a, activate=True, lineage=[{"kind": "serve_rollover", "step": 0}])
    reg.note("a", {"kind": "serve_rollover", "event": "swap", "adopted": True, "step": 1})
    reg.note("missing", {"ignored": True})
    reg.register("a", a)  # a replacement keeps the lineage
    rec = json.loads(json.dumps(reg.record()))
    assert rec["active"] == "a" and list(rec["models"]) == ["a"]
    assert [r["step"] for r in rec["models"]["a"]["lineage"]] == [0, 1]
    assert isinstance(rec["models"]["a"]["registered_at"], float)


FLIP_THREADS, FLIP_REQUESTS = 12, 20


def test_flips_under_threaded_traffic_never_split_a_batch(impl):
    """More client threads than cores submit while another thread flips the
    active entry back and forth, the interpreter switching threads every
    microsecond: every request is answered, and each reply is wholly one
    engine's rows (a batch split across engines, or resolved twice, would
    mix them)."""
    Registry, Batcher, Ladder, Metrics = impl
    engines = [ScriptedEngine(Ladder((8, 16, 32)), 1000, Metrics(), scale=s) for s in (1, 3)]
    reg = Registry()
    reg.register("e0", engines[0], activate=True)
    reg.register("e1", engines[1])
    bat = Batcher(reg, max_batch_size=4, max_delay_ms=0.2, max_queue_depth=4096)
    replies, errors, stop = [], [], threading.Event()

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(FLIP_REQUESTS):
                ids = rng.choice(np.arange(1, 1000), size=int(rng.integers(1, 9)), replace=False)
                replies.append((ids, bat.infer(ids, timeout_s=60)))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    def flipper():
        i = 0
        while not stop.is_set():
            reg.activate(f"e{i % 2}")
            i += 1
            time.sleep(1e-4)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        flip = threading.Thread(target=flipper)
        flip.start()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(FLIP_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        alive = sum(t.is_alive() for t in threads)
        stop.set()
        flip.join(10)
    finally:
        sys.setswitchinterval(switch)
        bat.stop()
    assert alive == 0 and not flip.is_alive() and errors == []
    assert len(replies) == FLIP_THREADS * FLIP_REQUESTS
    for ids, out in replies:
        assert any(np.array_equal(out, e.rows(ids)) for e in engines), (ids, out)
    assert all(len(e.calls) for e in engines)  # both engines served
