"""The port's elastic state (``horovod_tpu_torch/elastic``), its digest guard
(``guard/digest.py``) and ``ElasticSampler`` against the JAX package's.

- The digest: the same state gives the same hex digest in both packages
  (f32/f16/bf16/i32/i64/bool leaves and counters); the reference's digest
  tests run against the port's module.
- The state classes: ``ObjectState``/``TorchState`` commit and restore over
  the same ``nn.Module`` and ``AdamW`` in both packages to bitwise equal
  ``state_dict``s; ``TensorState`` is the port's ``JaxState``.
- The sampler: the same order for the same seed, epoch, rank and size, and
  the union of processed indices after a sync.
- Copies of the reference's own tests that import inside their bodies
  (named in each docstring): the state primitives, the respawn payload,
  object identity, the mocked-world digest heal and rollback, the digest
  before the save, the quarantined and the readable snapshot.
- The worker's view of the rendezvous: park and reattach against a KV
  server whose driver document changes epoch; a SIGTERM reaching
  ``PreemptionInterrupt``; the failure filter; ``apply_serve_scale``'s verbs
  and event lines against the JAX package's; ``adopted_step_kwargs``
  against the JAX package's translation.
"""

import copy
import json
import os
import pickle
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu.elastic as jelastic
from horovod_tpu.guard import digest as jdigest
from horovod_tpu.torch.elastic import ElasticSampler as JSampler

import horovod_tpu_torch.elastic as elastic
from horovod_tpu_torch import eager
from horovod_tpu_torch import guard
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.fault import preemption
from horovod_tpu_torch.guard import digest
from horovod_tpu_torch.parallel import reshard as R
from horovod_tpu_torch.torch.elastic import ElasticSampler

import test_guard as ref_guard
from torch_port_harness import run_reference_test


# --- the digest --------------------------------------------------------------

LEAVES = {
    "f32": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
    "f16": np.linspace(-2, 2, 5).astype(np.float16),
    "i32": np.arange(4, dtype=np.int32) - 2,
    "i64": np.array([1 << 40, -3], np.int64),
    "bool": np.array([True, False, True]),
}


def test_digest_is_the_same_hex_in_both_packages():
    import jax.numpy as jnp

    tree = {k: v for k, v in LEAVES.items()}
    want = jdigest.tree_digest(tree)
    assert digest.tree_digest(tree) == want
    assert digest.tree_digest({k: torch.from_numpy(v.copy()) for k, v in LEAVES.items()}) == want
    bf = np.linspace(-1, 1, 7).astype(np.float32)
    assert digest.tree_digest({"b": torch.from_numpy(bf).to(torch.bfloat16)}) == \
        jdigest.tree_digest({"b": jnp.asarray(bf).astype(jnp.bfloat16)})
    # A state: arrays by bytes, counters and lists by pickle.
    js = jelastic.ObjectState(w=LEAVES["f32"].copy(), step=3, hist=[1, 2], flags=LEAVES["bool"])
    ps = elastic.ObjectState(w=torch.from_numpy(LEAVES["f32"].copy()), step=3, hist=[1, 2],
                             flags=torch.from_numpy(LEAVES["bool"].copy()))
    assert digest.state_digest(ps) == jdigest.state_digest(js)
    ps.step = 4
    assert digest.state_digest(ps) != jdigest.state_digest(js)


@pytest.mark.parametrize("name", ["test_tree_digest_sensitivity", "test_find_quorum_cases"])
def test_reference_digest_test_holds_for_the_port(name, request):
    run_reference_test(ref_guard, name, {"gdigest": digest}, request)


def test_state_digest_covers_arrays_and_counters():
    """``test_state_digest_covers_arrays_and_counters`` of
    ``tests/test_guard.py`` on the port's ``ObjectState``."""
    s1 = elastic.ObjectState(w=torch.ones(4), step=3)
    s2 = elastic.ObjectState(w=torch.ones(4), step=3)
    assert digest.state_digest(s1) == digest.state_digest(s2)
    s2.step = 4
    assert digest.state_digest(s1) != digest.state_digest(s2)
    s2.step = 3
    s2.w[0] = 7.0
    assert digest.state_digest(s1) != digest.state_digest(s2)


def test_digest_strips_rank_local_rows_keeps_their_layout():
    from horovod_tpu_torch.ops.quantized import EFState
    from horovod_tpu_torch.parallel import zero as Z

    params = {"a": torch.randn(12, 12, generator=torch.Generator().manual_seed(0)),
              "b": torch.randn(30, generator=torch.Generator().manual_seed(1))}
    z4 = Z.init_zero1_stream_states(torch.optim.SGD([torch.zeros(1)], lr=0.1, momentum=0.9),
                                    params, 4, threshold_bytes=1, first_bucket_bytes=1)
    a = elastic.ObjectState(opt=z4[0], ef=EFState(inner=torch.ones(3), residual=torch.ones(3)))
    b = elastic.ObjectState(opt=z4[1], ef=EFState(inner=torch.ones(3), residual=torch.zeros(3)))
    assert digest.state_digest(a) == digest.state_digest(b)     # rows and residuals differ
    b.ef = EFState(inner=torch.zeros(3), residual=torch.zeros(3))
    assert digest.state_digest(a) != digest.state_digest(b)     # the inner state syncs
    z2 = Z.init_zero1_stream_states(torch.optim.SGD([torch.zeros(1)], lr=0.1, momentum=0.9),
                                    params, 2, threshold_bytes=1, first_bucket_bytes=1)
    c = elastic.ObjectState(opt=z2[0], ef=a.ef)
    assert digest.state_digest(a) != digest.state_digest(c)     # another layout
    ok, ref, out = digest.find_quorum([digest.state_digest(x) for x in (a, a, c)])
    assert not ok and ref == 0 and out == [2]


def test_guard_digest_knobs(monkeypatch):
    from horovod_tpu import guard as jguard

    for v in ("", "3", "x", "-2"):
        monkeypatch.setenv(guard.GUARD_DIGEST_STEPS_ENV, v)
        assert guard.digest_steps() == jguard.digest_steps()
    for v in ("", "root", "ROLLBACK", "bogus"):
        monkeypatch.setenv(guard.GUARD_NO_QUORUM_ENV, v)
        assert guard.no_quorum_action() == jguard.no_quorum_action()
    assert guard.NO_QUORUM_ACTIONS == jguard.NO_QUORUM_ACTIONS
    monkeypatch.setenv(guard.GUARD_DIGEST_STEPS_ENV, "2")
    monkeypatch.delenv(guard.GUARD_NONFINITE_ENV, raising=False)
    try:
        assert guard.activate_from_env() is True and guard.TAP.policy == "off"
    finally:
        guard.reset()
    assert guard.ACTIVE is False


# --- the mocked-world digest agreement (tests/test_guard.py:179-242) ------------


def _mock_world(monkeypatch, size, gathered):
    monkeypatch.setattr(basics, "is_initialized", lambda: True)
    monkeypatch.setattr(basics, "size", lambda: size)
    monkeypatch.setattr(eager, "allgather_object", lambda obj, name=None, **kw: gathered(obj))


def test_digest_check_heals_from_quorum(monkeypatch):
    """``test_digest_check_heals_from_quorum`` of ``tests/test_guard.py``."""
    monkeypatch.setenv(guard.GUARD_DIGEST_STEPS_ENV, "2")
    guard.activate_from_env()
    try:
        state = elastic.ObjectState(w=torch.ones(4), step=0)
        _mock_world(monkeypatch, 4, lambda d: [d, d, d, "corrupted"])
        synced = []
        monkeypatch.setattr(state, "sync", lambda: synced.append(elastic._sync_root()))
        state._guard_check_digest()
        assert synced == []
        state._guard_check_digest()
        assert synced == [0]
        assert elastic._sync_root_override is None
    finally:
        guard.reset()


def test_digest_check_rolls_back_without_quorum(monkeypatch):
    """``test_digest_check_rolls_back_without_quorum`` of ``tests/test_guard.py``."""
    monkeypatch.setenv(guard.GUARD_DIGEST_STEPS_ENV, "1")
    guard.activate_from_env()
    try:
        state = elastic.ObjectState(w=torch.ones(4), step=0)
        _mock_world(monkeypatch, 2, lambda d: [d, "diverged"])
        with pytest.raises(basics.HorovodInternalError) as e:
            state._guard_check_digest()
        assert "digest mismatch" in str(e.value) and "no agreeing quorum" in str(e.value)
    finally:
        guard.reset()


def test_commit_checks_digest_before_save(monkeypatch):
    """``test_commit_checks_digest_before_save`` of ``tests/test_guard.py``."""
    monkeypatch.setenv(guard.GUARD_DIGEST_STEPS_ENV, "1")
    guard.activate_from_env()
    try:
        state = elastic.ObjectState(w=torch.ones(4), step=0)
        _mock_world(monkeypatch, 2, lambda d: [d, "diverged"])
        state.w[0] = 123.0
        with pytest.raises(basics.HorovodInternalError):
            state.commit()
        state.restore()
        assert state.w[0] == 1.0
    finally:
        guard.reset()


# --- the state classes ---------------------------------------------------------


def test_elastic_state_primitives():
    """``test_elastic_state_primitives`` of ``tests/test_elastic.py``, with
    ``TensorState`` for ``JaxState``."""
    s = elastic.ObjectState(batch=0, epoch=0, history=[])
    s.batch = 7
    s.history.append("a")
    s.commit()
    s.batch = 9
    s.history.append("b")
    s.restore()
    assert s.batch == 7 and s.history == ["a"]

    js = elastic.TensorState(w=torch.ones(3), step=0)
    w = js.w
    js.commit()
    js.w.zero_()
    js.step = 5
    js.restore()
    assert js.step == 0 and js.w is w
    np.testing.assert_allclose(js.w.numpy(), 1.0)

    fired = []
    js.register_reset_callbacks([lambda: fired.append(1)])
    js.on_reset()
    assert fired == [1]

    @elastic.run
    def train(state, inc):
        state.step += inc
        return state.step

    assert train(js, 4) == 4


def test_respawn_persist_payload_covers_all_snapshots():
    """``test_respawn_persist_payload_covers_all_snapshots`` of
    ``tests/test_elastic.py``."""
    class FancyState(elastic.ObjectState):
        def save(self):
            super().save()
            self._saved_vars = ["w" + str(self.step)]

    s = FancyState(step=3)
    s.save()
    payload = elastic._persist_payload(s)
    assert payload["_saved"] == {"step": 3}
    assert payload["_saved_vars"] == ["w3"]
    fresh = FancyState(step=0)
    elastic._apply_payload(fresh, payload)
    fresh.restore()
    assert fresh.step == 3 and fresh._saved_vars == ["w3"]
    older = FancyState(step=0)
    elastic._apply_payload(older, {"tracked": {"step": 7}})
    older.restore()
    assert older.step == 7


def test_elastic_state_preserves_object_identity():
    """``test_elastic_state_preserves_object_identity`` of
    ``tests/test_elastic.py`` with the port's sampler."""
    sampler = ElasticSampler(10, shuffle=False)
    history = ["a"]
    s = elastic.ObjectState(sampler=sampler, history=history, step=0)
    assert s.sampler is sampler and s.history is history
    list(iter(sampler))
    sampler.record_batch(0, 3)
    s.step = 4
    s.commit()
    sampler.record_batch(1, 3)
    s.step = 9
    s.restore()
    assert s.sampler is sampler and s.history is history
    assert sampler.processed == {0, 1, 2} and s.step == 4
    wire = pickle.loads(pickle.dumps(s.sampler))
    wire.epoch = 3
    wire.processed = {7}
    s._assign("sampler", wire)
    assert s.sampler is sampler
    assert sampler.epoch == 3 and sampler.processed == {7}
    s._assign("step", 11)
    assert s.step == 11


def _model_and_opt(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(), torch.nn.Linear(5, 3))
    return model, torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-2)


def _train(model, opt, steps, seed):
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        opt.zero_grad()
        model(torch.randn(4, 6, generator=g)).pow(2).mean().backward()
        opt.step()


def test_torch_and_object_state_restore_bitwise_like_the_reference():
    """The same module and AdamW through both packages' ``TorchState``
    (the JAX package's takes torch modules): commit, train on, restore;
    the restored ``state_dict``s are bitwise equal, counters too."""
    pm, po = _model_and_opt()
    jm, jo = copy.deepcopy(pm), None
    jo = torch.optim.AdamW(jm.parameters(), lr=1e-2, weight_decay=1e-2)
    ps = elastic.TorchState(pm, po, step=0, log=[])
    js = jelastic.TorchState(jm, jo, step=0, log=[])
    for st, (m, o) in ((ps, (pm, po)), (js, (jm, jo))):
        _train(m, o, 3, seed=1)
        st.step = 3
        st.log.append("c")
        st.commit()
        _train(m, o, 2, seed=2)
        st.step = 5
        st.log.append("x")
        st.restore()
    assert ps.step == js.step == 3 and ps.log == js.log == ["c"]
    for (k, a), (_, b) in zip(pm.state_dict().items(), jm.state_dict().items()):
        assert torch.equal(a, b), k
    pa, ja = po.state_dict(), jo.state_dict()
    assert pa["param_groups"] == ja["param_groups"]
    for i in pa["state"]:
        for k in pa["state"][i]:
            assert torch.equal(pa["state"][i][k], ja["state"][i][k]), (i, k)


def test_torch_state_keeps_dp_optimizer_rank_local_rows():
    """The DP step's ``DistributedOptimizer`` under ZeRO-1: the commit
    snapshots its rows and restore writes them back in place (the same
    optimizer and shard objects)."""
    from horovod_tpu_torch import train
    from horovod_tpu_torch.parallel import zero as Z

    model, inner = _model_and_opt()
    opt = train.DistributedOptimizer(inner, named_parameters=model.named_parameters(),
                                     zero1=True)
    z = opt._zero1_state = Z.init_zero1_stream_states(inner, opt._tree, 1)[0]
    st = elastic.TorchState(model, opt, step=0)
    assert "optimizer" in st._zero1_nodes()
    shard = next(iter(next(iter(z.shards.values())).values()))
    before = shard.detach().clone()
    shard.grad = torch.ones_like(shard)
    z.opt.step()
    assert not torch.equal(shard, before)
    st.restore()
    assert torch.equal(shard, before) and opt.zero1_state is z


def test_elastic_sampler_matches_the_reference(monkeypatch):
    for seed, epoch, n in ((0, 0, 1), (3, 2, 3), (7, 1, 4)):
        for r in range(n):
            monkeypatch.setattr(basics, "is_initialized", lambda: True)
            monkeypatch.setattr(basics, "rank", lambda r=r: r)
            monkeypatch.setattr(basics, "size", lambda n=n: n)
            monkeypatch.setattr(jhvd, "is_initialized", lambda: True)
            monkeypatch.setattr(jhvd, "rank", lambda r=r: r)
            monkeypatch.setattr(jhvd, "size", lambda n=n: n)
            a, b = ElasticSampler(23, shuffle=True, seed=seed), JSampler(23, seed=seed)
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(iter(a)) == list(iter(b)) and len(a) == len(b)
            a.record_batch(1, 2)
            b.record_batch(1, 2)
            assert list(iter(a)) == list(iter(b)) and a.processed == b.processed


def test_sampler_processed_sets_union_on_sync(monkeypatch):
    """``ObjectState.sync`` unions every rank's processed indices, as the
    reference does (the allgather and the broadcast mocked as a world of
    three ranks whose sync root is rank 0)."""
    samplers = [ElasticSampler(12, shuffle=False) for _ in range(3)]
    for r, s in enumerate(samplers):
        s.processed = {r, 10 + r % 2}
    mine = elastic.ObjectState(sampler=samplers[1], epoch=1)
    monkeypatch.setattr(basics, "size", lambda: 3)
    monkeypatch.setattr(eager, "allgather_object", lambda obj, name=None: [
        {"sampler": sorted(s.processed)} for s in samplers])
    monkeypatch.setattr(eager, "broadcast_object", lambda obj, root_rank=0, name=None:
                        pickle.loads(pickle.dumps({"sampler": samplers[0], "epoch": 2})))
    mine.sync()
    assert mine.sampler is samplers[1]
    assert mine.sampler.processed == {0, 1, 2, 10, 11} and mine.epoch == 2


# --- snapshots (tests/test_guard.py:593-628) and their layout --------------------


def test_unreadable_snapshot_is_quarantined(tmp_path, monkeypatch):
    """``test_unreadable_snapshot_is_quarantined`` of ``tests/test_guard.py``."""
    monkeypatch.setenv("HOROVOD_ELASTIC_STATE_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_ELASTIC_WORKER_ID", "hostA:0")
    path = elastic._persist_path()
    with open(path, "wb") as f:
        f.write(b"not a pickle \x00\x01")
    state = elastic.ObjectState(w=torch.ones(2), step=0)
    assert elastic._maybe_restore_persisted(state) is False
    assert not os.path.exists(path) and os.path.exists(path + ".corrupt")
    assert elastic._maybe_restore_persisted(state) is False


def test_readable_snapshot_still_restores(tmp_path, monkeypatch):
    """``test_readable_snapshot_still_restores`` of ``tests/test_guard.py``;
    the snapshot's tensors are on the CPU."""
    monkeypatch.setenv("HOROVOD_ELASTIC_STATE_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_ELASTIC_WORKER_ID", "hostA:0")
    donor = elastic.TensorState(w=torch.full((2,), 7.0), step=9)
    donor.save()
    with open(elastic._persist_path(), "wb") as f:
        pickle.dump(elastic._to_host(elastic._persist_payload(donor)), f)
    state = elastic.TensorState(w=torch.zeros(2), step=0)
    w = state.w
    assert elastic._maybe_restore_persisted(state) is True
    assert state.step == 9 and state.w is w
    assert torch.equal(state.w, donor.w)


def _zero1_state(n, rank):
    from horovod_tpu_torch.parallel import zero as Z

    params = {"a": torch.randn(12, 12, generator=torch.Generator().manual_seed(0)),
              "b": torch.randn(30, generator=torch.Generator().manual_seed(1))}
    states = Z.init_zero1_stream_states(torch.optim.SGD([torch.zeros(1)], lr=0.1, momentum=0.9),
                                        params, n, threshold_bytes=1, first_bucket_bytes=1)
    lay = R.zero1_layout_from_params(params, n, threshold_bytes=1, first_bucket_bytes=1)
    return states, lay


def test_snapshot_layout_stamp_and_preflight(monkeypatch):
    """The reference's ``test_persist_payload_stamps_layout`` and the
    preflight: a snapshot of this rank's rows at another world refuses,
    naming both worlds and the sharded checkpoint; one of the gathered rows
    reshards; a replicated one passes."""
    states, lay4 = _zero1_state(4, 0)
    monkeypatch.setenv("HOROVOD_SIZE", "4")
    st = elastic.TensorState(opt=states[0])
    elastic.note_zero1_layout(st, "opt", lay4)
    payload = elastic._persist_payload(st)
    assert payload["__layout__"]["world"] == 4
    assert payload["__layout__"]["zero1_layout"]["opt"]["n_shards"] == 4
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    with pytest.raises(RuntimeError, match="sharded checkpoint") as ei:
        elastic._preflight_snapshot_layout(st, payload, "snap.pkl")
    assert "world=2" in str(ei.value) and "4" in str(ei.value)
    st.zero1_layout = None
    with pytest.raises(RuntimeError, match="note_zero1_layout"):
        elastic._preflight_snapshot_layout(st, dict(payload, __layout__={"world": 4}), "s")
    rows = R.stack_zero1_states(states)
    out = elastic._preflight_snapshot_layout(
        st, {"_saved": {"opt": rows}, "__layout__": payload["__layout__"]}, "snap.pkl")
    assert out["_saved"]["opt"].n_shards == 2 and out["__layout__"]["world"] == 2
    plain = {"_saved": {"w": torch.ones(3)}, "__layout__": {"world": 4, "zero1_layout": {}}}
    assert elastic._preflight_snapshot_layout(st, plain, "snap.pkl") is plain


def test_resize_after_a_crash_refuses_and_a_gathered_one_reshards(monkeypatch):
    states, lay4 = _zero1_state(4, 0)
    st = elastic.TensorState(opt=states[1])
    elastic.note_zero1_layout(st, "opt", lay4)
    monkeypatch.setattr(basics, "is_initialized", lambda: True)
    monkeypatch.setattr(basics, "rank", lambda: 1)
    with pytest.raises(RuntimeError, match="sharded checkpoint"):
        elastic._reshard_state_for_world(st, 4, 2, {}, crashed=True, old_rank=1)
    elastic._reshard_state_for_world(st, 4, 4, {}, crashed=True, old_rank=1)  # same world
    rows = R.stack_zero1_states(states)
    elastic._reshard_state_for_world(st, 4, 2, {"opt": rows}, old_rank=1)
    want, _ = R.reshard_zero1_state(rows, 2, layout=lay4)
    assert all(torch.equal(a[1], b) for a, b in zip(
        digest.tree_leaves(want.shards), digest.tree_leaves(st.opt.shards)))
    assert st.zero1_layout["opt"].n_shards == 2


# --- the worker's view of the rendezvous -----------------------------------------


@pytest.fixture()
def kv(monkeypatch):
    from horovod_tpu_torch.run.http_server import KVStoreServer

    server = KVStoreServer(port=0)
    port = server.start()
    monkeypatch.setenv("HOROVOD_ELASTIC_WORKER_ID", "localhost:0")
    monkeypatch.setenv("HOROVOD_ELASTIC_KV_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_ELASTIC_KV_PORT", str(port))
    monkeypatch.setenv("HOROVOD_ELASTIC_GEN", "1")
    monkeypatch.setenv("HOROVOD_DRIVER_EPOCH", "1")
    monkeypatch.setenv("HOROVOD_ELASTIC_TIMEOUT", "20")
    monkeypatch.setenv("HOROVOD_RPC_RETRIES", "0")
    yield server
    server.stop()


def _put(server, key, doc):
    server.put("elastic", key, json.dumps(doc).encode())


def test_park_and_reattach_on_a_driver_epoch_change(kv, monkeypatch):
    ctx = elastic._ElasticContext()
    _put(kv, "world", {"gen": 1})
    _put(kv, "driver", {"epoch": 1, "gen": 1})
    assert ctx.commit_probe() == (False, False, None)
    _put(kv, "driver", {"epoch": 2, "gen": 1})       # a resumed driver, same generation
    assert ctx.commit_probe() == (False, False, 2)
    _put(kv, "driver", {"epoch": 0})                  # a stale one
    assert ctx.commit_probe() == (False, True, None)
    watch = elastic.DriverWatch(1, 1)
    assert watch.classify(None, None) == "wait"
    assert watch.classify({"epoch": 0}, {"gen": 1}) == "fenced" and watch.fenced == 1
    assert watch.classify({"epoch": 3}, {"gen": 1}) == "reattach" and watch.epoch_seen == 3
    assert watch.classify({"epoch": 3}, {"gen": 2}) == "rejoin"
    # Parked with no driver answering; a current epoch republishing the
    # same generation reattaches in place.
    kv.delete("elastic", "driver")
    monkeypatch.setenv("HOROVOD_RPC_BACKOFF_BASE_S", "0.01")
    monkeypatch.setattr(basics, "is_initialized", lambda: False)

    def resume():
        time.sleep(0.3)
        _put(kv, "driver", {"epoch": 4, "gen": 1})

    threading.Thread(target=resume).start()
    elastic._park_and_reattach(ctx)
    assert ctx.epoch == 4 and kv.snapshot("elastic")["attach.localhost:0"].startswith(b"1:4:")
    _put(kv, "world", {"gen": 2})
    with pytest.raises(elastic.HostsUpdatedInterrupt):
        elastic._park_and_reattach(ctx)


def test_sigterm_reaches_preemption_interrupt(kv, monkeypatch):
    """``run`` installs the SIGTERM handler (its consumer); the notice turns
    the next commit into ``PreemptionInterrupt`` at one rank."""
    _put(kv, "world", {"gen": 1})
    _put(kv, "driver", {"epoch": 1, "gen": 1})
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    monkeypatch.setattr(elastic, "_context", None)
    monkeypatch.setattr(basics, "is_initialized", lambda: True)
    monkeypatch.setattr(basics, "size", lambda: 1)
    monkeypatch.setattr(basics, "rank", lambda: 0)
    monkeypatch.setattr(basics, "device", lambda: torch.device("cpu"))
    monkeypatch.setattr(basics, "local_rank", lambda: 0)
    prev = signal.getsignal(signal.SIGTERM)
    seen = []

    @elastic.run
    def train(state):
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not preemption.preemption_requested() and time.monotonic() < deadline:
            time.sleep(0.01)
        try:
            state.commit()
        except elastic.PreemptionInterrupt as exc:
            seen.append(str(exc))
            return "drained"

    try:
        assert train(elastic.ObjectState(step=0)) == "drained"
    finally:
        signal.signal(signal.SIGTERM, prev)
        monkeypatch.setattr(preemption, "_installed", False)
        preemption.clear()
    assert seen == ["SIGTERM"]


def test_collective_failure_filter():
    import torch.distributed as dist

    assert elastic._is_collective_failure(basics.HorovodInternalError("x"))
    assert elastic._is_collective_failure(dist.DistBackendError("nccl"))
    assert elastic._is_collective_failure(RuntimeError(
        "[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Connection closed by peer"))
    assert elastic._is_collective_failure(RuntimeError("NCCL communicator was aborted"))
    try:
        try:
            raise basics.HorovodInternalError("lost a peer")
        except basics.HorovodInternalError as inner:
            raise RuntimeError("step failed") from inner
    except RuntimeError as outer:
        assert elastic._is_collective_failure(outer)
    assert not elastic._is_collective_failure(ValueError("shape mismatch"))
    assert not elastic._is_collective_failure(RuntimeError("mat1 and mat2 shapes cannot be"))


def test_rejoin_mode_and_refusals(monkeypatch):
    assert elastic._inprocess_rejoin_supported()
    for forced, want in (("auto", "inprocess"), ("respawn", "respawn"),
                         ("inprocess", "inprocess")):
        monkeypatch.setenv("HOROVOD_ELASTIC_REJOIN_MODE", forced)
        monkeypatch.setattr(elastic, "_rejoin_mode", None)
        assert elastic.rejoin_mode() == want
    monkeypatch.setattr(elastic, "_inprocess_rejoin_supported", lambda: False)
    monkeypatch.setenv("HOROVOD_ELASTIC_REJOIN_MODE", "inprocess")
    monkeypatch.setattr(elastic, "_rejoin_mode", None)
    assert elastic.rejoin_mode() == "respawn"
    monkeypatch.setattr(elastic, "_rejoin_mode", None)
    # apply_serve_scale: scale-out adds a replica, scale-in retires one,
    # each with the JAX package's event line; a refused retire is None.
    import horovod_tpu.elastic as jelastic
    from horovod_tpu.fault import injector as jinjector
    from horovod_tpu.fault.plan import FaultPlan as JFaultPlan
    from horovod_tpu_torch.fault import injector as pinjector
    from horovod_tpu_torch.fault.plan import FaultPlan

    class Engine:
        def __init__(self):
            self.live, self.calls = 1, []

        def add_replica(self):
            self.calls.append("add")
            self.live += 1
            return self.live - 1

        def retire_replica(self):
            self.calls.append("retire")
            if self.live <= 1:
                return None
            self.live -= 1
            return self.live

    out = types.SimpleNamespace(action="scale-out", reason="queue-depth", depth=20.0,
                                slo_burn=0.0)
    back = types.SimpleNamespace(action="scale-in", reason="idle", depth=0.0, slo_burn=0.0)
    lines = []
    for mod, inj, plan in ((elastic, pinjector, FaultPlan), (jelastic, jinjector, JFaultPlan)):
        inj.install_plan(plan.from_json('{"seed": 1, "faults": []}'))
        try:
            eng = Engine()
            got = [mod.apply_serve_scale(eng, d) for d in (out, back, back, None)]
            assert got == [1, 1, None, None] and eng.calls == ["add", "retire", "retire"]
            lines.append([(e["site"], e["hit"], e["action"], e["detail"]) for e in inj.events()])
        finally:
            inj.install_plan(None)
    assert lines[0] == lines[1] == [
        ("replica", 1, "serve-promote", "reason=queue-depth depth=20.0 burn=0.000"),
        ("replica", 1, "serve-retire", "reason=idle depth=0.0 burn=0.000")]
    assert elastic.adopted_step_kwargs() is None
    notice = {"id": 1, "config": {"fusion_threshold_bytes": 1 << 22, "first_bucket_bytes": 1 << 20,
                                  "topo_algorithm": "flat", "wire_dtype": "int8"}}
    monkeypatch.setattr(elastic, "_adopted_replan", notice)
    monkeypatch.setattr(jelastic, "_adopted_replan", notice)
    assert elastic.adopted_step_kwargs() == jelastic.adopted_step_kwargs()
    assert elastic.adopted_replan() == notice


def test_world_document_env_and_the_spare_gate(kv, monkeypatch):
    """``apply`` exports a generation's TCPStore as the launcher does; a
    spare waits at the gate until ``promote.<wid>`` names a published
    generation that assigns it, then takes its environment."""
    world = {"gen": 2, "size": 2, "sync_root": 0, "epoch": 1, "master_addr": "127.0.0.1",
             "master_port": 4321, "controller_addr": "", "controller_port": 0,
             "assignments": {"localhost:0": {"rank": 1, "local_rank": 0, "local_size": 2,
                                             "cross_rank": 0, "cross_size": 1}}}
    for k in ("MASTER_ADDR", "MASTER_PORT", "HOROVOD_RANK", "TORCHELASTIC_USE_AGENT_STORE"):
        monkeypatch.delenv(k, raising=False)
    # apply() and the gate write os.environ directly: the test puts it back.
    saved = dict(os.environ)
    try:
        _apply_and_promote(kv, world, monkeypatch)
    finally:
        os.environ.clear()
        os.environ.update(saved)


def _apply_and_promote(kv, world, monkeypatch):
    ctx = elastic._ElasticContext()
    assert ctx.apply(world)
    assert (os.environ["MASTER_PORT"], os.environ["HOROVOD_RANK"],
            os.environ["TORCHELASTIC_USE_AGENT_STORE"]) == ("4321", "1", "True")
    assert ctx.gen == 1
    assert not ctx.apply(dict(world, assignments={}))
    # Written directly, as apply() writes: the caller restores os.environ
    # whole (a monkeypatch.setenv here would note apply's value and put it
    # back after that restore, leaking HOROVOD_RANK into later tests).
    os.environ["HOROVOD_ELASTIC_SPARE"] = "1"
    monkeypatch.setattr(elastic, "SPARE_POLL_S", 0.02)
    _put(kv, "driver", {"epoch": 1, "gen": 2})
    _put(kv, "world", world)
    os.environ["HOROVOD_RANK"] = "9"

    def promote():
        time.sleep(0.2)
        kv.put("elastic", "promote.localhost:0", b"2")

    threading.Thread(target=promote).start()
    assert elastic.maybe_wait_as_spare() is True
    assert os.environ["HOROVOD_RANK"] == "1" and "HOROVOD_ELASTIC_SPARE" not in os.environ
    assert int(kv.snapshot("elastic")["spare.localhost:0"]) >= 1


def test_example_copies_run_as_plain_calls(capsys):
    """The two example copies outside an elastic launch: ``run`` passes
    through and each trains to its end on the CPU."""
    from horovod_tpu_torch.examples import elastic_train, pytorch_mnist_elastic

    elastic_train.main(["--no-cuda"])
    pytorch_mnist_elastic.main(["--no-cuda"])
    out = capsys.readouterr().out
    assert "done: 200 steps on 1 ranks, |w - w*| = 0.0000" in out
    assert "done: 2 epochs on 1 ranks" in out


def test_mesh_is_built_once_a_world():
    """``hvd.mesh()`` (``horovod_tpu/__init__.py:466-476``): one ``data``
    axis over the job, built at first use and dropped with the world."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        m = hvd.mesh()
        assert m.mesh_dim_names == ("data",) and m.size(0) == 1 and hvd.mesh() is m
    finally:
        hvd.shutdown()
    with pytest.raises(ValueError, match="not been initialized"):
        hvd.mesh()
