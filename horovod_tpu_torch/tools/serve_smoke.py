"""The serving engine's five gates, with the autoscaler acting.

    python -m horovod_tpu_torch.tools.serve_smoke                # on the card
    python -m horovod_tpu_torch.tools.serve_smoke --device cpu

The port's copy of ``tools/serve_smoke.py``: a 2-replica engine over a
small f32 ``TransformerLM`` (vocab 32, d 16, 2 heads, 1 layer, context
32), two runs of one seeded chaos plan:

1. exactly-once under chaos: a ``kill_replica`` at the second batch
   dispatch and a ``drop`` of the third request; every request is answered
   once (the killed replica's batch re-queued, ``requeues >= 1``), the
   dropped one with outcome ``dropped``;
2. determinism: the two runs' normalised request logs are the same bytes;
3. SLO observability: ``hvd_request_latency_seconds`` counted every
   answer, ``hvd_serve_queue_depth`` and ``hvd_serve_requeues_total`` exist;
4. trace spans: the ``hvd_request`` spans are in the trace window, whose
   ``rank.0.json`` renders through ``tools/trace_merge`` with them;
5. the scale hook, acted on: after the kill one replica is live, and one
   autoscale beat of a ``ServeScalePolicy`` over the backlog left for it
   scales the engine back to 2 (``serve-promote`` on the event ledger).

Prints one JSON line; exits nonzero on a failed gate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

VOCAB, D_MODEL, HEADS, LAYERS, MAX_LEN = 32, 16, 2, 1, 32
N_REQUESTS = 12
MAX_TOKENS = 4
SEED = 7


def _prompts(seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, VOCAB, size=rng.randint(1, 6))]
            for _ in range(N_REQUESTS)]


def run_once(params, device, seed):
    """One seeded 2-replica run under the chaos plan, then the scale hook:
    the survivor held, a backlog queued, one autoscale beat. Returns the
    normalised log and the run's figures."""
    import torch

    from horovod_tpu_torch import make_decode_step
    from horovod_tpu_torch.fault import injector as inj
    from horovod_tpu_torch.fault.plan import FaultPlan
    from horovod_tpu_torch.run.selfdrive import ServeScalePolicy
    from horovod_tpu_torch.serve import ServeEngine

    inner = make_decode_step(n_heads=HEADS, dtype=torch.float32)
    gate = threading.Event()
    gate.set()

    def step(*a):
        gate.wait(60)
        return inner(*a)

    plan = FaultPlan.from_json(json.dumps({"seed": seed, "faults": [
        {"kind": "kill_replica", "at_step": 2},
        {"kind": "drop", "site": "request", "at_step": 3}]}))
    engine = ServeEngine(params, step, n_layers=LAYERS, n_heads=HEADS,
                         head_dim=D_MODEL // HEADS, num_pages=64, page_size=4, max_batch_size=4,
                         max_wait_us=500, max_context=MAX_LEN, replicas=2, slo_ms=250.0,
                         scale_policy=ServeScalePolicy(scale_out_depth=2.0, window=1,
                                                       cooldown=0, max_replicas=2),
                         cache_dtype=torch.float32, device=device)
    inj.install_plan(plan)
    try:
        with engine:
            for prompt in _prompts(seed):
                engine.submit(prompt, max_tokens=MAX_TOKENS)
                time.sleep(0.002)  # several batch dispatches
            engine.drain(timeout=120.0)
            live_after_kill = engine.live_replicas()
            log = engine.request_log()
            # The scale hook: the survivor held behind its batch, a backlog
            # queued for it, one beat.
            gate.clear()
            extra = [engine.submit([1 + i % (VOCAB - 1)], max_tokens=1) for i in range(6)]
            time.sleep(0.05)
            decision = engine.autoscale_beat()
            live_after_beat = engine.live_replicas()
            gate.set()
            engine.drain(timeout=120.0)
            extra_ok = all(engine.result(r).outcome == "ok" for r in extra)
        events = [(e["site"], e["action"]) for e in inj.events()]
    finally:
        gate.set()
        inj.install_plan(None)
    stats = {"requeues": engine.requeues, "live_after_kill": live_after_kill,
             "answered": len(log), "decision": None if decision is None else decision.action,
             "live_after_beat": live_after_beat, "extra_ok": extra_ok,
             "promoted": ("replica", "serve-promote") in events}
    return json.dumps(log, sort_keys=True), stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu for the CPU; default: the card")
    args = ap.parse_args(argv)

    import torch

    from horovod_tpu_torch import metrics
    from horovod_tpu_torch import trace as hvd_trace
    from horovod_tpu_torch.common.basics import resolve_device
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.tools import trace_merge
    from horovod_tpu_torch.utils.convert import param_tree

    device = resolve_device(args.device)
    metrics.install(True)
    hvd_trace.install(True)
    model = TransformerLM(VOCAB, d_model=D_MODEL, n_heads=HEADS, n_layers=LAYERS,
                          max_len=MAX_LEN, dtype=torch.float32, device=device, seed=0)
    params = param_tree(model)
    t0 = time.time()
    failures = []
    log_a, stats_a = run_once(params, device, SEED)
    log_b, stats_b = run_once(params, device, SEED)
    # Gate 1: exactly-once under chaos (and gate 5's accounting).
    for label, stats, log in (("a", stats_a, log_a), ("b", stats_b, log_b)):
        outcomes = [v["outcome"] for v in json.loads(log).values()]
        if stats["answered"] != N_REQUESTS or outcomes.count("dropped") != 1 \
                or outcomes.count("ok") != N_REQUESTS - 1:
            failures.append(f"chaos gate, run {label}: {stats['answered']} answered, "
                            f"outcomes {outcomes}")
        if stats["requeues"] < 1:
            failures.append(f"chaos gate, run {label}: the kill re-queued nothing")
        # Gate 5: the kill shrank the fleet, the beat scaled it back out.
        if stats["live_after_kill"] != 1 or stats["decision"] != "scale-out" \
                or stats["live_after_beat"] != 2 or not stats["promoted"] \
                or not stats["extra_ok"]:
            failures.append(f"scale gate, run {label}: {stats}")
    # Gate 2: determinism.
    if log_a != log_b:
        failures.append(f"determinism gate: the seeded logs differ:\n{log_a}\n{log_b}")
    # Gate 3: SLO observability.
    flat = metrics.flat()
    latency = sum(v for k, v in flat.items()
                  if k.startswith("hvd_request_latency_seconds") and k.endswith("_count"))
    if latency < 2 * N_REQUESTS or not any(k.startswith("hvd_serve_queue_depth") for k in flat) \
            or not any(k.startswith("hvd_serve_requeues_total") for k in flat):
        failures.append(f"metrics gate: latency count {latency}, keys {sorted(flat)}")
    # Gate 4: trace spans render through trace_merge.
    window = hvd_trace.TAP.window()
    spans = 0
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "rank.0.json"), "w") as f:
            json.dump(window, f)
        rc = trace_merge.main([tmp])
        if rc == 0:
            with open(os.path.join(tmp, "merged_trace.json")) as f:
                spans = sum(e.get("name") == "hvd_request" for e in json.load(f)["traceEvents"])
    if rc != 0 or not spans:
        failures.append(f"trace gate: trace_merge exited {rc}, {spans} hvd_request spans")
    out = {"device": str(device), "seconds": time.time() - t0, "runs": [stats_a, stats_b],
           "log_bytes": len(log_a), "latency_count": latency, "request_spans": spans,
           "ok": not failures, "failures": failures}
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
