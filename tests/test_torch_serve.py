"""The port's serving stack against the JAX package's (horovod_tpu/serve/).

The reference tests' geometry (tests/test_serve.py: vocab 32, d 16, 2
heads, context 32; 2 layers here), the same flax weights through
``params_from_flax`` and the same caches through ``decode_state_from_numpy``,
f32, on the CPU:

- the batcher and page-pool cases of tests/test_serve.py, each run on the
  JAX class and the port's class, with the same decisions from both;
- ``tp_decode_apply`` against JAX's over 6 steps on a random cache and a
  shuffled page table with one padded slot: logits at rtol 1e-5 / atol
  1e-6, the cache at atol 1e-6, and the padded slot leaving every live
  page as the unpadded batch leaves it;
- ``make_decode_step`` against JAX's (the same int32 next tokens), and its
  mesh/rules refusals with the reference's messages;
- the engine at 1 and 2 replicas token for token against JAX's engine and
  against the reference's one-request-at-a-time full recompute
  (``_reference_greedy`` of tests/test_serve.py), page back-pressure, a
  replica killed mid-batch (every request answered once), the request
  refusals; the autoscale beat on live traffic (1 -> 2 -> 1 replicas, the
  reference's tokens) and the same beats into the JAX engine and the
  port's (the same verdicts and event lines);
- the HTTP frontend on port 0 (200 with the engine's tokens, /healthz, 400,
  404, and /metrics 200 with a Prometheus exposition) and the ``python -m
  horovod_tpu_torch.serve`` demo.
"""

import importlib
import json
import os
import subprocess
import sys
import types
import urllib.error
import urllib.request
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.common import env as ref_env
from horovod_tpu.jax import make_decode_step as ref_make_decode_step
from horovod_tpu.models import transformer as ref_tf
from horovod_tpu.parallel import rules as ref_rules
from horovod_tpu.parallel.mesh import build_mesh as ref_build_mesh
import horovod_tpu_torch as hvd
from horovod_tpu_torch.fault import ReplicaKilled
from horovod_tpu_torch.models.transformer import tp_decode_apply
from horovod_tpu_torch.parallel import rules as port_rules
from horovod_tpu_torch.utils.convert import (
    decode_state_from_numpy, decode_state_to_numpy, params_from_flax)

# The modules (``horovod_tpu.serve`` the attribute is the serve function).
ref_serve = importlib.import_module("horovod_tpu.serve")
port_serve = importlib.import_module("horovod_tpu_torch.serve")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, D, HEADS, LAYERS, T = 32, 16, 2, 2, 32
SERVES = {"jax": ref_serve, "port": port_serve}


@pytest.fixture(params=sorted(SERVES))
def mod(request):
    return SERVES[request.param]


# --------------------------------------------------------------- batcher
class TestContinuousBatcher:
    def test_full_precedes_deadline(self, mod):
        b = mod.ContinuousBatcher(max_batch_size=4, max_wait_us=1000)
        for i in range(4):
            assert b.offer(f"r{i}", now_us=0)
        d = b.poll(0)
        assert d.ready and d.reason == "full"
        assert d.request_ids == ("r0", "r1", "r2", "r3")
        assert b.depth() == 0

    def test_deadline_fires_on_head_wait(self, mod):
        b = mod.ContinuousBatcher(max_batch_size=4, max_wait_us=1000)
        b.offer("a", now_us=0)
        b.offer("b", now_us=900)
        assert not b.poll(500).ready
        assert b.poll(500).reason == "waiting"
        d = b.poll(1000)
        assert d.ready and d.reason == "deadline"
        assert d.request_ids == ("a", "b")

    def test_starvation_freedom_bound(self, mod):
        b = mod.ContinuousBatcher(max_batch_size=8, max_wait_us=2000)
        b.offer("head", now_us=100)
        for i in range(3):
            b.offer(f"late{i}", now_us=100 + 300 * (i + 1))
        assert b.next_deadline_us() == 2100
        assert not b.poll(2099).ready
        d = b.poll(2100)
        assert d.request_ids == ("head", "late0", "late1", "late2")

    def test_deterministic_assembly_for_fixed_trace(self, mod):
        trace = [("a", 0), ("b", 10), ("c", 20), ("d", 30), ("e", 40)]

        def replay(m):
            b = m.ContinuousBatcher(max_batch_size=2, max_wait_us=1000)
            out = []
            for rid, t in trace:
                b.offer(rid, now_us=t)
                d = b.poll(t)
                if d.ready:
                    out.append((d.reason, d.request_ids))
            d = b.poll(5000)
            if d.ready:
                out.append((d.reason, d.request_ids))
            return out

        assert replay(mod) == replay(mod) == replay(ref_serve)
        assert replay(mod) == [("full", ("a", "b")), ("full", ("c", "d")),
                               ("deadline", ("e",))]

    def test_queue_bound_refuses(self, mod):
        b = mod.ContinuousBatcher(max_batch_size=8, max_wait_us=10, queue_bound=2)
        assert b.offer("a", 0) and b.offer("b", 0)
        assert not b.offer("c", 0)
        assert b.depth() == 2

    def test_requeue_goes_to_front_and_bypasses_bound(self, mod):
        b = mod.ContinuousBatcher(max_batch_size=8, max_wait_us=0, queue_bound=2)
        b.offer("a", 0)
        b.offer("b", 0)
        b.requeue("survivor", enqueued_us=0)
        assert b.poll(0).request_ids == ("survivor", "a", "b")

    def test_duplicate_offer_raises(self, mod):
        b = mod.ContinuousBatcher()
        b.offer("a", 0)
        with pytest.raises(ValueError, match="already queued"):
            b.offer("a", 1)

    def test_max_size_caps_batch(self, mod):
        b = mod.ContinuousBatcher(max_batch_size=8, max_wait_us=0)
        for i in range(6):
            b.offer(i, 0)
        d = b.poll(100, max_size=2)
        assert d.ready and d.request_ids == (0, 1)
        assert b.depth() == 4

    def test_from_env(self, mod):
        b = mod.ContinuousBatcher.from_env({
            ref_env.HOROVOD_SERVE_MAX_BATCH: "3",
            ref_env.HOROVOD_SERVE_MAX_WAIT_US: "77",
            ref_env.HOROVOD_SERVE_QUEUE_BOUND: "5",
        })
        assert (b.max_batch_size, b.max_wait_us, b.queue_bound) == (3, 77, 5)


def test_batchers_agree_on_a_random_trace():
    """The two batchers fed one random trace of offers, cancels and polls
    (some capped, as KV-page pressure caps them) decide alike at every
    step."""
    rng = np.random.RandomState(0)
    batchers = {k: m.ContinuousBatcher(max_batch_size=4, max_wait_us=300, queue_bound=6)
                for k, m in SERVES.items()}
    now, nxt, log = 0, 0, {k: [] for k in SERVES}
    for _ in range(400):
        now += int(rng.randint(0, 200))
        op = rng.randint(4)
        cap = int(rng.randint(1, 6))
        for k, b in batchers.items():
            if op == 0:
                log[k].append(b.offer(f"r{nxt}", now))
            elif op == 1 and b.depth():
                log[k].append(b.cancel(f"r{nxt - 1}"))
            else:
                d = b.poll(now, max_size=cap if op == 2 else None)
                log[k].append((d.ready, d.reason, d.request_ids, b.next_deadline_us()))
        nxt += op == 0
    assert log["port"] == log["jax"]


# -------------------------------------------------------------- KV pages
class TestPagePool:
    def test_alloc_is_deterministic_and_skips_scratch(self, mod):
        pool = mod.PagePool(num_pages=8, page_size=4)
        assert pool.pages_free == 7
        assert pool.alloc(tokens=9) == [1, 2, 3]
        assert pool.pages_in_use == 3

    def test_alloc_all_or_nothing(self, mod):
        pool = mod.PagePool(num_pages=4, page_size=4)
        with pytest.raises(mod.PagePoolExhausted):
            pool.alloc(tokens=16)
        assert pool.pages_free == 3
        assert pool.can_admit(12) and not pool.can_admit(13)

    def test_free_and_double_free(self, mod):
        pool = mod.PagePool(num_pages=4, page_size=4)
        pages = pool.alloc(tokens=8)
        pool.free(pages)
        assert pool.pages_free == 3
        with pytest.raises(ValueError):
            pool.free(pages)
        with pytest.raises(ValueError):
            pool.free([0])

    def test_freed_pages_are_reused_deterministically(self, mod):
        def replay(m):
            pool = m.PagePool(num_pages=8, page_size=4)
            a = pool.alloc(tokens=8)
            pool.free(a)
            return a, pool.alloc(tokens=8), pool.alloc(tokens=5)

        assert replay(mod) == replay(mod) == replay(ref_serve)

    def test_needs_two_pages_minimum(self, mod):
        with pytest.raises(ValueError):
            mod.PagePool(num_pages=1, page_size=4)


def test_decode_state_geometry_and_converters():
    ref = ref_serve.make_decode_state(2, num_pages=4, page_size=8, n_heads=2, head_dim=4)
    port = port_serve.make_decode_state(2, num_pages=4, page_size=8, n_heads=2, head_dim=4,
                                        device="cpu")
    assert sorted(port) == sorted(ref) == ["block_0", "block_1"]
    k = port["block_0"]["attention"]["cache_k"]
    assert k.shape == ref["block_0"]["attention"]["cache_k"].shape == (4, 8, 2, 4)
    assert k.dtype == torch.bfloat16 and k.device.type == "cpu"   # the serving default
    a = np.random.RandomState(0).randn(4, 8, 2, 4).astype(np.float32)
    tree = {f"block_{i}": {"attention": {"cache_k": a + i, "cache_v": a - i}} for i in range(2)}
    back = decode_state_to_numpy(decode_state_from_numpy(tree, device="cpu"))
    assert sorted(back) == [f"block_{i}/attention/cache_{x}" for i in range(2) for x in "kv"]
    assert all(np.array_equal(back[f"block_{i}/attention/cache_k"], a + i) for i in range(2))


def test_cache_rules_match_the_reference():
    assert port_rules.GPT_CACHE_RULES == ref_rules.GPT_CACHE_RULES
    assert sorted(port_rules.NAMED_CACHE_RULES) == sorted(ref_rules.NAMED_CACHE_RULES)
    ref_cache = ref_serve.make_decode_state(2, num_pages=4, page_size=8, n_heads=4, head_dim=4)
    port_cache = port_serve.make_decode_state(2, num_pages=4, page_size=8, n_heads=4,
                                              head_dim=4, device="cpu")
    ref_specs = dict(ref_rules.named_tree_paths(
        ref_serve.decode_state_specs(ref_rules.GPT_CACHE_RULES, ref_cache)))
    port_specs = dict(port_rules.named_tree_paths(
        port_serve.decode_state_specs(port_rules.GPT_CACHE_RULES, port_cache)))
    assert {k: tuple(v) for k, v in ref_specs.items()} == port_specs
    # The preflight over this rank's shard (2 of 4 heads at model 2): an
    # axis the mesh lacks fails it with the JAX package's error and
    # findings (the Pass 5 validator), and a leaf no rule matches fails it.
    from horovod_tpu.analysis import CollectiveSafetyError as RefError
    from horovod_tpu_torch.analysis import CollectiveSafetyError

    local = port_serve.make_decode_state(2, num_pages=4, page_size=8, n_heads=2, head_dim=4,
                                         device="cpu")
    port_serve.preflight_decode_state(port_rules.GPT_CACHE_RULES, {"model": 2}, local)
    with pytest.raises(CollectiveSafetyError, match="cache_.*not a mesh axis") as e:
        port_serve.preflight_decode_state(port_rules.GPT_CACHE_RULES, {"data": 2}, local)
    with pytest.raises(RefError) as r:
        ref_serve.preflight_decode_state(ref_rules.GPT_CACHE_RULES, {"data": 2}, ref_cache)
    assert [f.to_dict() for f in e.value.findings] == [f.to_dict() for f in r.value.findings]
    with pytest.raises(ValueError, match="no sharding rule matches"):
        port_serve.preflight_decode_state(port_rules.GPT_CACHE_RULES[:0], {"model": 2}, local)


# ------------------------------------------------------- decode parity
def _params():
    model = ref_tf.TransformerLM(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
                                 max_len=T)
    return jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32))["params"]


@pytest.fixture(scope="module")
def weights():
    params = _params()
    flat = {k: np.asarray(v) for k, v in ref_rules.named_tree_paths(params)}
    return params, params_from_flax(flat, device="cpu")


def test_tp_decode_apply_matches_jax(weights):
    """6 steps on a random cache (unwritten positions hold garbage the mask
    must hide) and a shuffled page table; slot 2 is padding (token 0,
    position 0, an all-zeros row: the scratch page)."""
    params, tparams = weights
    rng = np.random.RandomState(0)
    num_pages, page_size, width = 12, 4, 3
    cache0 = {f"block_{i}": {"attention": {
        n: rng.randn(num_pages, page_size, HEADS, D // HEADS).astype(np.float32)
        for n in ("cache_k", "cache_v")}} for i in range(LAYERS)}
    pages = rng.permutation(np.arange(1, num_pages))[:2 * width]
    table = np.zeros((3, width), np.int32)
    table[:2] = pages.reshape(2, width)
    tokens = rng.randint(0, VOCAB, (6, 3)).astype(np.int32)
    tokens[:, 2] = 0
    start = np.array([0, 3, 0])
    ref_step = jax.jit(partial(ref_tf.tp_decode_apply, n_heads=HEADS, dtype=jnp.float32))
    ref_cache = jax.tree.map(jnp.asarray, cache0)
    port_cache = decode_state_from_numpy(cache0, device="cpu")
    live_cache = decode_state_from_numpy(cache0, device="cpu")   # the unpadded batch
    for s in range(6):
        pos = (start + s) * np.array([1, 1, 0])
        ref_logits, ref_cache = ref_step(params, jnp.asarray(tokens[s]), jnp.asarray(pos),
                                         ref_cache, jnp.asarray(table))
        logits, port_cache = tp_decode_apply(
            tparams, torch.from_numpy(tokens[s]).long(), torch.from_numpy(pos), port_cache,
            torch.from_numpy(table).long(), n_heads=HEADS, dtype=torch.float32)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-5, atol=1e-6)
        live, live_cache = tp_decode_apply(
            tparams, torch.from_numpy(tokens[s, :2]).long(), torch.from_numpy(pos[:2]),
            live_cache, torch.from_numpy(table[:2]).long(), n_heads=HEADS, dtype=torch.float32)
        assert torch.equal(live, logits[:2])
    got = decode_state_to_numpy(port_cache)
    want = {k: np.asarray(v) for k, v in ref_rules.named_tree_paths(ref_cache)}
    unpadded = decode_state_to_numpy(live_cache)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6)
        # Padding wrote the scratch page only: every other page is the
        # unpadded batch's, and the pages no slot holds are untouched.
        assert np.array_equal(got[name][1:], unpadded[name][1:])
        written = got[name][pages]
        assert not np.array_equal(written, cache0[name.split("/")[0]]["attention"][
            name.split("/")[-1]][pages])
        idle = sorted(set(range(1, num_pages)) - set(pages.tolist()))
        assert np.array_equal(got[name][idle],
                              cache0[name.split("/")[0]]["attention"][name.split("/")[-1]][idle])


def test_make_decode_step_matches_jax(weights):
    params, tparams = weights
    ref = ref_make_decode_step(n_heads=HEADS, dtype=jnp.float32)
    port = hvd.make_decode_step(n_heads=HEADS, dtype=torch.float32)
    ref_cache = ref_serve.make_decode_state(LAYERS, num_pages=8, page_size=4, n_heads=HEADS,
                                            head_dim=D // HEADS, dtype=jnp.float32)
    port_cache = port_serve.make_decode_state(LAYERS, num_pages=8, page_size=4, n_heads=HEADS,
                                              head_dim=D // HEADS, dtype=torch.float32,
                                              device="cpu")
    table = np.array([[3, 5], [1, 2]], np.int32)
    rng = np.random.RandomState(1)
    for s in range(5):
        tokens = rng.randint(0, VOCAB, 2).astype(np.int32)
        pos = np.array([s, s + 2], np.int32)
        a, ref_cache = ref(params, ref_cache, tokens, pos, table)
        b, port_cache = port(tparams, port_cache, tokens, pos, table)
        assert b.dtype == torch.int32 and b.tolist() == np.asarray(a).tolist()


def test_make_decode_step_refusals_match_the_reference(devices):
    ref_mesh = ref_build_mesh({"model": 2}, devices=devices[:2])
    port_mesh = types.SimpleNamespace(mesh_dim_names=("model",))
    cases = [dict(mesh=True), dict(rules="gpt"), dict(mesh=True, rules="gpt", model_axis="tensor")]
    for kw in cases:
        errors = []
        for make, mesh in ((ref_make_decode_step, ref_mesh), (hvd.make_decode_step, port_mesh)):
            with pytest.raises(ValueError) as exc:
                make(n_heads=HEADS, **dict(kw, **({"mesh": mesh} if "mesh" in kw else {})))
            errors.append(str(exc.value))
        assert errors[0] == errors[1], kw
    assert "needs axis 'tensor'" in errors[1]


# ------------------------------------------------------------- engines
def _prompts(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, VOCAB, size=rng.randint(1, 6))] for _ in range(n)]


_full_forward = jax.jit(partial(ref_tf.tp_apply, n_heads=HEADS, model_axis=None,
                                dtype=jnp.float32))


def _reference_greedy(params, prompt, max_tokens):
    """tests/test_serve.py's one-request-at-a-time full-recompute greedy
    decode through the JAX dense ``tp_apply``: no cache, no batching. The
    sequence is zero-padded to the context T so that one compiled forward
    serves every length; attention is causal, so the pad changes no logit
    at the positions read."""
    seq = list(prompt)
    for _ in range(max_tokens):
        logits = _full_forward(params, jnp.asarray([seq + [0] * (T - len(seq))], jnp.int32))
        seq.append(int(jnp.argmax(logits[0, len(seq) - 1])))
    return seq[len(prompt):]


ENGINE_KW = dict(n_layers=LAYERS, n_heads=HEADS, head_dim=D // HEADS, num_pages=64, page_size=4,
                 max_batch_size=4, max_wait_us=500, max_context=T)


def _port_engine(tparams, step=None, **kw):
    step = step or hvd.make_decode_step(n_heads=HEADS, dtype=torch.float32)
    return port_serve.ServeEngine(tparams, step, **dict(ENGINE_KW, **kw),
                                  cache_dtype=torch.float32, device="cpu")


def _complete(engine, prompts, max_tokens=4):
    with engine:
        rids = [engine.submit(p, max_tokens=max_tokens) for p in prompts]
        engine.drain(timeout=120.0)
    return [engine.result(r) for r in rids]


@pytest.fixture(scope="module")
def reference(weights):
    params, _ = weights
    prompts = _prompts()
    return prompts, [_reference_greedy(params, p, 4) for p in prompts]


@pytest.mark.parametrize("replicas", [1, 2])
def test_engine_matches_jax_engine_and_reference(weights, reference, replicas):
    params, tparams = weights
    prompts, want = reference
    ref_engine = ref_serve.ServeEngine(
        params, ref_make_decode_step(n_heads=HEADS, dtype=jnp.float32), **ENGINE_KW,
        replicas=replicas, cache_dtype=jnp.float32)
    ref_got = [list(c.tokens) for c in _complete(ref_engine, prompts)]
    got = _complete(_port_engine(tparams, replicas=replicas), prompts)
    assert [c.outcome for c in got] == ["ok"] * len(prompts)
    assert [list(c.tokens) for c in got] == ref_got == want


def test_engine_page_back_pressure(weights, reference):
    """3 usable pages of 4 and requests of 2 pages each: one request a
    batch fits, the others wait at the queue front; all are answered."""
    _, tparams = weights
    prompts, want = reference
    prompts = [p[:3] + [1] * (3 - len(p[:3])) for p in prompts]
    engine = _port_engine(tparams, num_pages=4)
    got = _complete(engine, prompts)
    params, _ = weights
    assert [list(c.tokens) for c in got] == [_reference_greedy(params, p, 4) for p in prompts]
    assert engine.batches == len(prompts) and engine.batched_requests == len(prompts)


def test_replica_killed_mid_batch_answers_every_request_once(weights, reference):
    _, tparams = weights
    prompts, want = reference
    inner = hvd.make_decode_step(n_heads=HEADS, dtype=torch.float32)
    calls = {"n": 0, "killed": 0}

    def step(*args):
        calls["n"] += 1
        if calls["n"] == 2:        # the second step of the first batch
            calls["killed"] += 1
            raise ReplicaKilled("kill_replica")
        return inner(*args)

    engine = _port_engine(tparams, step=step, replicas=2)
    answers = []
    finish = engine._finish

    def counting_finish(rep, req, tokens, outcome):
        answers.append(req.id)
        finish(rep, req, tokens, outcome)

    engine._finish = counting_finish
    got = _complete(engine, prompts)
    assert calls["killed"] == 1 and engine.requeues >= 1
    assert [list(c.tokens) for c in got] == want
    assert sorted(answers) == sorted(c.id for c in got)          # answered once each
    log = engine.request_log()
    assert len(log) == len(prompts) and {v["outcome"] for v in log.values()} == {"ok"}
    assert engine.live_replicas() == 0 and sum(r.alive for r in engine._replicas) == 0


def test_fault_plan_drives_the_request_and_replica_sites(weights, reference):
    """A plan installed after import arms the engine's taps: the first
    request is dropped at the ``request`` site (answered ``dropped``), the
    second batch dispatch kills its replica at the ``replica`` site (its
    batch re-queued and answered once by the survivor)."""
    from horovod_tpu_torch.fault import injector
    from horovod_tpu_torch.fault.plan import FaultPlan

    _, tparams = weights
    prompts, want = reference
    injector.install_plan(FaultPlan.from_json(json.dumps({"faults": [
        {"kind": "drop", "site": "request", "at_step": 1},
        {"kind": "kill_replica", "at_step": 2}]})))
    try:
        engine = _port_engine(tparams, replicas=2)
        got = _complete(engine, prompts)
        events = [(e["site"], e["action"]) for e in injector.events()]
    finally:
        injector.reset()
    assert [c.outcome for c in got] == ["dropped"] + ["ok"] * (len(prompts) - 1)
    assert [list(c.tokens) for c in got[1:]] == want[1:]
    assert events == [("request", "drop"), ("replica", "kill_replica")]
    assert engine.requeues >= 1 and engine.live_replicas() == 0


def test_engine_refusals_match_the_reference(weights):
    params, tparams = weights
    engines = [ref_serve.ServeEngine(params, ref_make_decode_step(n_heads=HEADS), **ENGINE_KW,
                                     cache_dtype=jnp.float32),
               _port_engine(tparams)]
    messages = []
    for engine in engines:
        with engine:
            row = []
            for prompt, n, rid in (([], 4, None), ([1, 2], T, None), ([1, 2], 0, None)):
                with pytest.raises(ValueError) as exc:
                    engine.submit(prompt, max_tokens=n, request_id=rid)
                row.append(str(exc.value))
            engine.submit([1, 2], max_tokens=1, request_id="dup")
            with pytest.raises(ValueError) as exc:
                engine.submit([3], max_tokens=1, request_id="dup")
            row.append(str(exc.value))
            engine.drain(timeout=60.0)
        messages.append(row)
    assert messages[0] == messages[1]
    assert messages[1][0] == "empty prompt" and "duplicate request id" in messages[1][3]


def test_autoscaler_and_card_default_refuse(weights, reference, monkeypatch):
    """The autoscale beat on live traffic (the autoscaler refused before it
    was ported; the test keeps its name): a burst held behind the first
    batch scales 1 -> 2 replicas, the tokens stay the reference's, and
    quiet beats scale back to 1, each verb on the event ledger. The
    entry points still refuse a machine without a card."""
    import threading

    from horovod_tpu_torch.fault import injector as pinjector
    from horovod_tpu_torch.fault.plan import FaultPlan
    from horovod_tpu_torch.run.selfdrive import ServeScalePolicy

    _, tparams = weights
    prompts, want = reference
    inner = hvd.make_decode_step(n_heads=HEADS, dtype=torch.float32)
    gate = threading.Event()

    def held(*a):
        gate.wait(60)
        return inner(*a)

    policy = ServeScalePolicy(scale_out_depth=2.0, scale_in_depth=0.5, window=1, cooldown=0,
                              max_replicas=2)
    engine = _port_engine(tparams, step=held, scale_policy=policy, slo_ms=60_000.0)
    pinjector.install_plan(FaultPlan.from_json('{"seed": 1, "faults": []}'))
    try:
        with engine:
            rids = [engine.submit(p, max_tokens=4) for p in prompts]
            decision = engine.autoscale_beat()  # the first batch holds the rest
            assert decision.action == "scale-out" and decision.reason == "queue-depth"
            assert engine.live_replicas() == 2
            gate.set()
            engine.drain(timeout=120.0)
            got = [engine.result(r) for r in rids]
            decision = engine.autoscale_beat()
            assert decision.action == "scale-in" and decision.reason == "idle"
            assert engine.live_replicas() == 1
            assert engine.autoscale_beat() is None  # at min_replicas
        events = [(e["site"], e["action"]) for e in pinjector.events()]
    finally:
        pinjector.install_plan(None)
    assert [list(c.tokens) for c in got] == want
    assert events == [("replica", "serve-promote"), ("replica", "serve-retire")]
    assert engine._completions_since == 0  # drained by the beat
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.serve(tparams, n_heads=HEADS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.ServeEngine(tparams, None, **ENGINE_KW)


def test_autoscale_beats_match_the_jax_engine(weights):
    """The same beats (queue depth, SLO violations, completions) into the
    JAX engine and the port's, each with its own ServeScalePolicy: the same
    verdicts, the same replica counts after each, and the same event
    lines."""
    from horovod_tpu.fault import injector as jinjector
    from horovod_tpu.fault.plan import FaultPlan as JFaultPlan
    from horovod_tpu.run.selfdrive import ServeScalePolicy as JPolicy
    from horovod_tpu_torch.fault import injector as pinjector
    from horovod_tpu_torch.fault.plan import FaultPlan
    from horovod_tpu_torch.run.selfdrive import ServeScalePolicy

    params, tparams = weights
    beats = [(0, 0, 0), (9, 0, 2), (12, 1, 4), (9, 0, 3), (3, 6, 10), (1, 0, 8), (0, 0, 5),
             (0, 0, 6), (0, 0, 0), (0, 0, 1), (0, 0, 0), (0, 0, 0)]
    kw = dict(scale_out_depth=8.0, scale_in_depth=1.0, slo_burn=0.25, window=2, cooldown=1,
              max_replicas=3)
    runs = []
    for engine, inj, plan in (
            (ref_serve.ServeEngine(params, ref_make_decode_step(n_heads=HEADS, dtype=jnp.float32),
                                   **ENGINE_KW, cache_dtype=jnp.float32,
                                   scale_policy=JPolicy(**kw)), jinjector, JFaultPlan),
            (_port_engine(tparams, scale_policy=ServeScalePolicy(**kw)), pinjector, FaultPlan)):
        inj.install_plan(plan.from_json('{"seed": 1, "faults": []}'))
        trail = []
        try:
            with engine:
                for depth, viol, done in beats:
                    engine._batcher.depth = lambda d=depth: d
                    with engine._cond:
                        engine._slo_violations_since = viol
                        engine._completions_since = done
                    d = engine.autoscale_beat()
                    trail.append(None if d is None else (d.action, d.reason, round(d.depth, 6),
                                                         round(d.slo_burn, 6)))
                    trail.append(engine.live_replicas())
            runs.append((trail, [(e["site"], e["hit"], e["action"], e["detail"])
                                 for e in inj.events()]))
        finally:
            inj.install_plan(None)
    assert runs[0] == runs[1]
    actions = [t[0] for t in runs[1][0] if isinstance(t, tuple)]
    assert actions == ["scale-out", "scale-out", "scale-in", "scale-in"], runs[1]


def test_serve_reads_geometry_and_env(weights, reference, monkeypatch):
    """``serve`` takes its knobs from HOROVOD_SERVE_* and its geometry
    from the tree: max_context = min(pos rows, (pages - 1) x page_size)."""
    params, tparams = weights
    prompts, want = reference
    monkeypatch.setenv("HOROVOD_SERVE_KV_PAGES", "5")
    monkeypatch.setenv("HOROVOD_SERVE_PAGE_SIZE", "4")
    monkeypatch.setenv("HOROVOD_SERVE_MAX_BATCH", "2")
    monkeypatch.setenv("HOROVOD_SERVE_REPLICAS", "2")
    with port_serve.serve(tparams, n_heads=HEADS, device="cpu") as handle:
        engine = handle.engine
        assert (engine.max_context, engine.max_batch_size, engine.live_replicas()) == (16, 2, 2)
        rids = [handle.submit(p, max_tokens=4) for p in prompts]
        handle.drain(timeout=120.0)
        assert [list(handle.result(r).tokens) for r in rids] == want
    monkeypatch.setenv("HOROVOD_SERVE_KV_PAGES", "256")
    with port_serve.serve(tparams, n_heads=HEADS, device="cpu") as handle:
        assert handle.engine.max_context == T


# ------------------------------------------------------------ frontend
def _http(port, method, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def test_frontend(weights, reference):
    _, tparams = weights
    prompts, want = reference
    with port_serve.serve(tparams, n_heads=HEADS, device="cpu", http=True,
                          config=_config(serve_port=0)) as handle:
        port = handle.port
        status, body = _http(port, "POST", "/v1/completions",
                             {"prompt": prompts[0], "max_tokens": 4})
        assert status == 200 and json.loads(body)["completion"] == want[0]
        assert json.loads(body)["outcome"] == "ok"
        status, body = _http(port, "GET", "/healthz")
        assert status == 200 and json.loads(body) == {"replicas": 1, "queue_depth": 0}
        status, body = _http(port, "GET", "/metrics")
        # Served since the registry was ported; the tap is off here, so the
        # exposition parses and carries nothing (tests/test_torch_metrics.py
        # checks the hvd_serve_* series with the tap on).
        from horovod_tpu_torch.metrics import export as port_export

        assert status == 200 and port_export.parse_prometheus(body) == {}
        assert _http(port, "POST", "/v1/completions", {"max_tokens": 4})[0] == 400
        assert _http(port, "GET", "/nope")[0] == 404
        assert _http(port, "POST", "/v1/nope", {})[0] == 404


def test_frontend_metrics_match_the_jax_engine(weights, reference):
    """With both metrics taps on, the port's ``GET /metrics`` after the
    same requests carries the ``hvd_request_*``/``hvd_serve_*`` families the
    JAX engine records, with the same request count, tokens and latency
    count (the gauges' values follow each engine's batching)."""
    from horovod_tpu import metrics as jax_metrics
    from horovod_tpu_torch import metrics as port_metrics
    from horovod_tpu_torch.metrics import export as port_export

    params, tparams = weights
    prompts, want = reference
    jax_metrics.install(True)
    try:
        ref_engine = ref_serve.ServeEngine(
            params, ref_make_decode_step(n_heads=HEADS, dtype=jnp.float32), **ENGINE_KW,
            cache_dtype=jnp.float32)
        _complete(ref_engine, prompts)
        jsnap = jax_metrics.snapshot()
    finally:
        jax_metrics.reset()
    port_metrics.install(True)
    try:
        with port_serve.serve(tparams, n_heads=HEADS, device="cpu", http=True,
                              config=_config(serve_port=0)) as handle:
            for prompt, tokens in zip(prompts, want):
                status, body = _http(handle.port, "POST", "/v1/completions",
                                     {"prompt": prompt, "max_tokens": 4})
                assert status == 200 and json.loads(body)["completion"] == tokens
            status, text = _http(handle.port, "GET", "/metrics")
    finally:
        port_metrics.reset()
    assert status == 200
    parsed = port_export.parse_prometheus(text)
    serving = {n for n in jsnap if n.startswith(("hvd_serve_", "hvd_request_"))}
    assert serving and serving <= set(parsed), (serving, sorted(parsed))

    def value(family, sample=None, **labels):
        (v,) = [v for name, lab, v in parsed[family]["samples"] if name == (sample or family)
                and {k: x for k, x in lab.items() if k != "role"} == labels]
        return v

    def jvalue(name, **labels):
        (v,) = [x["value"] for x in jsnap[name]["series"] if x["labels"] == labels]
        return v

    n = len(prompts)
    assert value("hvd_request_total", outcome="ok") == jvalue("hvd_request_total",
                                                              outcome="ok") == n
    assert value("hvd_serve_tokens_total") == jvalue("hvd_serve_tokens_total") == 4 * n
    assert value("hvd_request_latency_seconds", "hvd_request_latency_seconds_count") == \
        jsnap["hvd_request_latency_seconds"]["series"][0]["count"] == n


def _config(**kw):
    from horovod_tpu_torch.common.env import Config

    cfg = Config()
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def test_demo_serves_over_http():
    """``python -m horovod_tpu_torch.serve --device cpu``: the demo model
    behind the frontend on a free port, answering one completion."""
    env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_SERVE_PORT="0", OMP_NUM_THREADS="2")
    proc = subprocess.Popen([sys.executable, "-m", "horovod_tpu_torch.serve", "--device", "cpu"],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert "listening on :" in line, line + proc.stdout.read()
        port = int(line.split("listening on :")[1].split()[0])
        status, body = _http(port, "POST", "/v1/completions", {"prompt": [1, 2, 3],
                                                               "max_tokens": 4})
        assert status == 200 and len(json.loads(body)["completion"]) == 4
    finally:
        proc.kill()
        proc.wait(timeout=30)
