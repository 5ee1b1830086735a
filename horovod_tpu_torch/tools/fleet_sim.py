"""Calibrated fleet simulator: the port of ``tools/fleet_sim.py``.

Claims at 256-4096 ranks, observable on the CPU. Four modes:

**Predict** (default): deterministic discrete-event simulation of a full
training step at each ``--ranks`` count, composing the structural
compute staircase (the exact ``plan_layer_groups`` partition the
streamed path registers), per-stage communication from the compositor's
alpha-beta plan pricing (two-level / split / int8 wire / ZeRO-1 RS+AG
all price exactly as the planner prices them), and stragglers from a
seeded ``fault/plan.py`` schedule::

    python -m horovod_tpu_torch.tools.fleet_sim --program transformer \\
        --ranks 256 1024 4096 --local 8 --generation h100 -o fleet_sim.json
    python -m horovod_tpu_torch.tools.fleet_sim --algorithm two-level --wire int8 --zero1
    python -m horovod_tpu_torch.tools.fleet_sim --trace-out simtrace   # Perfetto lanes

Output is byte-identical across runs for a fixed seed, and the JAX
package's tool's bytes for the same arguments. ``--trace-out`` renders
the simulated fleet through the same ``trace/merge.py`` machinery real
traces use — one
lane per simulated rank, plan/fault instants preserved — so predicted
and observed timelines are inspected with the same tooling.

**Replay** (``--replay <trace-dir-or-stats.json>``): re-simulate an
observed run (its trace windows, or a ``trace_merge --stats`` summary)
and report per-hop model-vs-measured divergence as
``hvd_sim_divergence_ratio{hop}`` — a drifting cost model is loud, not
silently wrong.

**Calibrate** (``--calibrate <trace-dir-or-stats.json>``): fit per-hop
alpha-beta constants from measured collective samples into a
signature-keyed ``calibration.json`` (a calibration for another hop
ladder falls back loudly). Consumed here via ``--calibration`` and by
``HOROVOD_CALIBRATION_FILE``.

**Serve** (``--serve --qps ...``): an open-loop Poisson arrival stream
through the serving batcher, one report a rate.

No device is touched. ``--resize --zero1`` prices the reshard's bytes and
its time over the model's outermost hop through
``run/selfdrive.price_resize(model=...)``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPORT_SCHEMA = 1


def _analytic_layers(args):
    """Per-layer gradient bytes (forward order) for the named program —
    analytic shapes, no backend: mlp3 mirrors the structural profiler's
    3-layer MLP; transformer mirrors a TransformerLM's top-level
    children (embed + per-block attn/mlp/norms + final norm)."""
    if args.program == "mlp3":
        d = args.dim
        return [4 * (d * d + d)] * 3
    if args.program == "transformer":
        d, v, s = args.d_model, args.vocab, args.seq_len
        tp = max(int(getattr(args, "tp", 1)), 1)
        # Composed DP x TP: the 12d^2 block kernels shard 1/tp per rank
        # (the DP staircase reduces each rank's SHARD gradients); the
        # 9d norm/bias tail and the embeddings replicate.
        block = 4 * (12 * d * d // tp + 9 * d)
        return (
            [4 * (v * d + s * d)]
            + [block] * args.layers
            + [4 * 2 * d]
        )
    # --program layers: explicit byte list.
    return [int(b) for b in args.layer_bytes]


def _model_for(ranks: int, args, calib):
    from horovod_tpu_torch.sim import apply_calibration
    from horovod_tpu_torch.topo.model import synthetic_model

    local = max(int(args.local), 1)
    note = None
    if ranks <= local or ranks % local:
        if ranks > local and ranks % local:
            note = (
                f"{ranks} ranks not divisible by --local {local}; "
                "modeling a flat single-hop fabric"
            )
        model = synthetic_model(ranks, generation=args.generation)
    else:
        model = synthetic_model(
            local, cross=ranks // local, generation=args.generation
        )
    return apply_calibration(model, calib, where="fleet_sim"), note


def _load_stats(path: str):
    """A trace directory (rank windows → stats in-process) or an
    already-emitted ``trace_merge --stats`` JSON file."""
    from horovod_tpu_torch.trace import merge as tmerge

    if os.path.isdir(path):
        ranks, driver = tmerge.read_dir(path)
        if not ranks:
            raise SystemExit(
                f"fleet_sim: no rank windows under {path} (need "
                "rank.<r>.json files, or pass a --stats JSON)"
            )
        return tmerge.stats_summary(ranks, driver)
    with open(path) as f:
        return json.load(f)


def _calibration_block(calib, path):
    if calib is None:
        return {
            "applied": False,
            "source": "generation-defaults",
            "note": (
                "no calibration.json — constants are coarse "
                "per-generation defaults (docs/simulation.md "
                "'Calibration workflow' to fit real ones)"
            ),
        }
    return {
        "applied": True,
        "source": path or "env",
        "signature": calib.signature_hash,
        "hops": {
            k: {
                "calibrated": bool(v.get("calibrated")),
                "latency_us": v.get("latency_us"),
                "bandwidth_gbps": v.get("bandwidth_gbps"),
                "samples": v.get("samples", 0),
            }
            for k, v in sorted(calib.hops.items())
        },
    }


def _resize_block(args, calib):
    """Price a ``--resize FROM,TO`` world-shape change: how many bytes
    of sharded ZeRO-1 state cross ranks and how long the outermost hop
    takes to carry them. Honest zero when ``--zero1`` is off — without
    sharded fast-path state there is nothing to redistribute."""
    try:
        n_old, n_new = (int(x) for x in args.resize.split(","))
    except ValueError:
        raise SystemExit(
            f"fleet_sim: --resize wants FROM,TO ranks, got {args.resize!r}"
        )
    if n_old < 1 or n_new < 1:
        raise SystemExit("fleet_sim: --resize ranks must be >= 1")
    if not args.zero1:
        return {
            "from": n_old,
            "to": n_new,
            "redistribution_bytes": 0,
            "note": (
                "no sharded fast-path state configured (--zero1); "
                "nothing to reshard — replicated state survives any "
                "world shape (docs/fault_tolerance.md 'Elastic "
                "resharding')"
            ),
        }
    from horovod_tpu_torch.run.selfdrive import price_resize

    model, _ = _model_for(max(n_old, n_new), args, calib)
    return price_resize(
        sum(_analytic_layers(args)),
        n_old,
        n_new,
        model=model,
        opt_slots=args.opt_slots,
        quantized=(args.wire == "int8"),
    )


def run_serve(args) -> int:
    """``--serve``: open-loop Poisson serving simulation (docs/serving.md
    "Capacity planning") — one deterministic report per ``--qps`` value,
    so "what does p99 do at 2x qps?" is answered by one sweep."""
    from horovod_tpu_torch.fault.plan import FaultPlan
    from horovod_tpu_torch.sim import ServeSimConfig, simulate_serve

    fault_plan = None
    if args.fault_plan:
        raw = args.fault_plan
        if not raw.lstrip().startswith("{"):
            with open(raw) as f:
                raw = f.read()
        fault_plan = FaultPlan.from_json(raw)
    try:
        qps_values = [float(q) for q in str(args.qps).split(",") if q]
    except ValueError:
        raise SystemExit(
            f"fleet_sim: --qps wants a comma-separated list of rates, "
            f"got {args.qps!r}"
        )
    if not qps_values:
        raise SystemExit("fleet_sim: --serve needs --qps")
    sweep = []
    for qps in qps_values:
        cfg = ServeSimConfig(
            qps=qps,
            duration_s=args.serve_duration,
            replicas=args.serve_replicas,
            max_batch_size=args.serve_max_batch,
            max_wait_us=args.serve_max_wait_us,
            queue_bound=args.serve_queue_bound,
            slo_ms=args.serve_slo_ms,
            service_base_us=args.serve_base_us,
            service_per_request_us=args.serve_per_request_us,
            seed=args.seed,
        )
        sweep.append(simulate_serve(cfg, fault_plan=fault_plan))
    report = {
        "schema_version": REPORT_SCHEMA,
        "kind": "fleet_sim_serve_report",
        "seed": int(args.seed),
        "fault_plan": (
            json.loads(fault_plan.canonical_schedule())
            if fault_plan else None
        ),
        "sweep": sweep,
    }
    payload = json.dumps(report, sort_keys=True, indent=1) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
    print(payload if not args.out else json.dumps({
        "out": args.out,
        "qps": qps_values,
        "p99_ms": {
            str(r["config"]["qps"]): r["latency_ms"]["p99"] for r in sweep
        },
    }, sort_keys=True), flush=True)
    # Human-readable sweep line on stderr: the p99-vs-qps answer.
    for r in sweep:
        print(
            "fleet_sim serve: qps={qps:g} served={served} "
            "rejected={rejected} p50={p50}ms p99={p99}ms "
            "occupancy={occ} slo_burn={burn}".format(
                qps=r["config"]["qps"], served=r["served"],
                rejected=r["rejected"], p50=r["latency_ms"]["p50"],
                p99=r["latency_ms"]["p99"],
                occ=r["mean_batch_occupancy"],
                burn=r["slo_violation_frac"],
            ),
            file=sys.stderr,
        )
    return 0


def run_predict(args) -> int:
    from horovod_tpu_torch.fault.plan import FaultPlan
    from horovod_tpu_torch.sim import (
        SimConfig,
        program_from_layers,
        resolve_calibration,
        simulate,
        straggler_sensitivity,
    )

    calib = resolve_calibration(args.calibration)
    tp = max(int(getattr(args, "tp", 1)), 1)
    tp_block = None
    fixed_comm_us = 0.0
    if tp > 1:
        from horovod_tpu_torch.sim import tp_fixed_comm_us

        if args.program != "transformer":
            raise SystemExit(
                "fleet_sim: --tp prices the composed transformer shape "
                "only (use --program transformer)"
            )
        psum_bytes = int(args.tp_psum_bytes) or (
            int(args.tp_batch) * int(args.seq_len)
            * int(args.d_model) * 2  # bf16 activations
        )
        # 2 forward psums per layer (attention-out + mlp-down) plus
        # their backward conjugates (parallel/tp.py tp_block_input).
        psums = 4 * int(args.layers)
        model0, _ = _model_for(args.ranks[0], args, calib)
        fixed_comm_us = tp_fixed_comm_us(model0, psum_bytes, tp, psums)
        tp_block = {
            "degree": tp,
            "psum_bytes": int(psum_bytes),
            "psums_per_step": int(psums),
            "fixed_comm_us": fixed_comm_us,
            "hop": model0.hops[-1].name,
        }
    program = program_from_layers(
        args.program,
        _analytic_layers(args),
        fusion_threshold_bytes=args.fusion_threshold,
        first_bucket_bytes=args.first_bucket,
        compute_us_per_mib=args.compute_us_per_mib,
        source=f"analytic:{args.program}"
               + (f":tp{tp}" if tp > 1 else ""),
        fixed_comm_us=fixed_comm_us,
    )
    config = SimConfig(
        algorithm=args.algorithm,
        wire_dtype=args.wire,
        zero1=bool(args.zero1),
        overlap=not args.no_overlap,
    )
    fault_plan = None
    if args.fault_plan:
        raw = args.fault_plan
        if not raw.strip().startswith("{"):
            with open(raw) as f:
                raw = f.read()
        fault_plan = FaultPlan.from_json(raw)

    results = []
    traces = {}
    for ranks in args.ranks:
        model, note = _model_for(ranks, args, calib)
        res = simulate(
            model, program, config, steps=args.steps,
            fault_plan=fault_plan, seed=args.seed,
        )
        block = res.to_report()
        block["straggler_sensitivity"] = straggler_sensitivity(
            model, program, config,
            probe_delay_us=args.probe_delay_us, steps=2,
        )
        if note:
            block["note"] = note
        results.append(block)
        traces[ranks] = res

    report = {
        "schema_version": REPORT_SCHEMA,
        "kind": "fleet_sim_report",
        "seed": int(args.seed),
        "steps": int(args.steps),
        "program": program.to_dict(),
        "config": config.to_dict(),
        "fault_plan": (
            json.loads(fault_plan.canonical_schedule())
            if fault_plan else None
        ),
        "calibration": _calibration_block(calib, args.calibration),
        "interconnect": {
            "generation": args.generation,
            "local": int(args.local),
        },
        **({"tp": tp_block} if tp_block else {}),
        **({"resize": _resize_block(args, calib)} if args.resize else {}),
        "results": results,
    }
    payload = json.dumps(report, sort_keys=True, indent=1) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
    print(payload if not args.out else json.dumps({
        "out": args.out,
        "ranks": [r["ranks"] for r in results],
        "step_time_us": {
            str(r["ranks"]): r["step_time_us"] for r in results
        },
        "scaling_efficiency": {
            str(r["ranks"]): r["scaling_efficiency"] for r in results
        },
    }, sort_keys=True), flush=True)

    if args.trace_out:
        from horovod_tpu_torch.trace import merge as tmerge

        os.makedirs(args.trace_out, exist_ok=True)
        res = traces[args.ranks[0]]
        windows = res.windows(max_ranks=args.trace_ranks)
        for r, doc in windows.items():
            with open(
                os.path.join(args.trace_out, f"rank.{r}.json"), "w"
            ) as f:
                json.dump(doc, f, sort_keys=True)
        with open(
            os.path.join(args.trace_out, "driver.json"), "w"
        ) as f:
            json.dump(res.driver_window(), f, sort_keys=True)
        merged = tmerge.merge_windows(windows, res.driver_window())
        out = os.path.join(args.trace_out, "sim_trace.json")
        tmerge.write_trace(out, merged)
        print(
            f"fleet_sim: rendered {len(windows)} simulated lane(s) at "
            f"{args.ranks[0]} ranks -> {out}", file=sys.stderr,
        )
    return 0


def run_replay(args) -> int:
    from horovod_tpu_torch.sim import (
        SimConfig,
        SimGroup,
        SimProgram,
        divergence_report,
        measured_from_stats,
        resolve_calibration,
        simulate,
    )

    stats = _load_stats(args.replay)
    n = int(stats.get("world_size", 0)) or 1
    calib = resolve_calibration(args.calibration)
    args_local = args.local if n > args.local and n % args.local == 0 \
        else n
    model, note = _model_for(n, argparse.Namespace(
        local=args_local, generation=args.generation,
        calibration=None,
    ), calib)
    measured = measured_from_stats(stats, model)

    # Program reconstruction: driver-recorded plan payloads when the
    # trace carries them (simulated traces do), else one group sized by
    # the measured per-step payload bytes. Compute comes from the
    # measured step spans either way — a replay re-runs the OBSERVED
    # staircase under the model, it never invents one.
    plans = (stats.get("driver") or {}).get("plans") or []
    compute_us = float(measured["compute_us"])
    if plans:
        total = sum(int(p.get("nbytes", 0)) for p in plans) or 1
        groups = tuple(
            SimGroup(
                name=f"g{int(p.get('group', i))}",
                nbytes=int(p.get("nbytes", 0)),
                compute_us=compute_us * int(p.get("nbytes", 0)) / total,
            )
            for i, p in enumerate(plans)
        )
        algorithm = str(plans[0].get("algorithm", "auto"))
        wire = str(plans[0].get("wire_dtype", "f32"))
    else:
        nb = int(measured["bytes_per_step"])
        groups = (SimGroup(name="g0", nbytes=nb, compute_us=compute_us),)
        plan_args = {}
        for r in sorted(stats.get("ranks", {})):
            plan_args = stats["ranks"][r].get("plan") or {}
            break
        algorithm = str(plan_args.get("topo_algorithm", "auto") or "auto")
        wire = str(plan_args.get("wire_dtype", "f32") or "f32")
    program = SimProgram(
        name="replay", groups=groups, forward_us=0.0,
        optimizer_us=0.0, source="replay",
    )
    config = SimConfig(algorithm=algorithm, wire_dtype=wire)
    res = simulate(
        model, program, config,
        steps=max(int(measured["steps"]), 1), seed=args.seed,
    )
    div = divergence_report(
        res.per_hop_busy_us(),
        measured["per_hop_us"],
        modeled_step_us=res.mean_step_us,
        measured_step_us=float(measured["step_us"]),
        attribution=measured["attribution"],
    )
    report = {
        "schema_version": REPORT_SCHEMA,
        "kind": "fleet_sim_replay",
        "source": args.replay,
        "world_size": n,
        "calibration": _calibration_block(calib, args.calibration),
        "measured": {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in measured.items()
        },
        "modeled": {
            "step_time_us": round(res.mean_step_us, 4),
            "per_hop_busy_us": {
                k: round(v, 4)
                for k, v in res.per_hop_busy_us().items()
            },
            "per_group": [
                {
                    "group": gi,
                    "algorithm": p.algorithm,
                    "nbytes": int(p.nbytes),
                    "cost_us": round(p.cost_us, 4),
                }
                for gi, (p, _ag) in enumerate(res.plans)
            ],
        },
        "divergence": div,
    }
    if note:
        report["note"] = note
    payload = json.dumps(report, sort_keys=True, indent=1) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
        print(json.dumps({
            "out": args.out,
            "divergence": {
                h: v["ratio"] for h, v in div["per_hop"].items()
            },
            "step_ratio": div["step"]["ratio"],
        }, sort_keys=True), flush=True)
    else:
        print(payload, flush=True)
    return 0


def run_calibrate(args) -> int:
    from horovod_tpu_torch.sim import fit_calibration, save_calibration
    from horovod_tpu_torch.topo.model import synthetic_model

    stats = _load_stats(args.calibrate)
    n = int(stats.get("world_size", 0)) or 1
    local = args.local if n > args.local and n % args.local == 0 else n
    model = (
        synthetic_model(local, cross=n // local,
                        generation=args.generation)
        if local != n
        else synthetic_model(n, generation=args.generation)
    )
    calib = fit_calibration(stats, model, source=args.calibrate)
    out = args.out or "calibration.json"
    save_calibration(calib, out)
    print(json.dumps({
        "out": out,
        "signature": calib.signature_hash,
        "hops": {
            k: {
                "calibrated": bool(v.get("calibrated")),
                "latency_us": v.get("latency_us"),
                "bandwidth_gbps": v.get("bandwidth_gbps"),
                "samples": v.get("samples", 0),
            }
            for k, v in sorted(calib.hops.items())
        },
    }, sort_keys=True), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Calibrated fleet simulator (docs/simulation.md)"
    )
    ap.add_argument("--ranks", type=int, nargs="+",
                    default=[256, 1024, 4096],
                    help="fleet sizes to simulate")
    ap.add_argument("--local", type=int, default=8,
                    help="ranks on the inner (ICI) hop; rank counts "
                         "divisible by this get a two-level DCN x ICI "
                         "fabric, others a flat one")
    ap.add_argument("--generation", default="generic",
                    help="generation for the default alpha-beta "
                         "table (h100/v3/v4/v5e/v5p/v6e/generic)")
    ap.add_argument("--program", default="transformer",
                    choices=["mlp3", "transformer", "layers"],
                    help="workload shape (analytic, no backend)")
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--layer-bytes", type=int, nargs="+", default=[],
                    help="--program layers: explicit per-layer gradient "
                         "bytes, forward order")
    ap.add_argument("--tp", type=int, default=1,
                    help="composed DP x TP shape: each simulated rank "
                         "holds 1/N of the sharded kernels (the DP "
                         "staircase shrinks) and pays the in-block TP "
                         "psums as a fixed per-step ICI term "
                         "(docs/parallelism.md 'Composed DP x TP fast "
                         "path'); transformer program only")
    ap.add_argument("--tp-batch", type=int, default=8,
                    help="per-rank batch for the TP activation-psum "
                         "payload (--tp > 1)")
    ap.add_argument("--tp-psum-bytes", type=int, default=0,
                    help="override the per-psum activation payload "
                         "bytes (default: derived as batch x seq x "
                         "d_model x 2 bf16 bytes)")
    ap.add_argument("--algorithm", default="auto",
                    choices=["auto", "flat", "ring", "two-level",
                             "split", "recursive-halving"],
                    help="pin the topo algorithm (auto = per-payload "
                         "cost selection, the compositor default)")
    ap.add_argument("--wire", default="f32", choices=["f32", "int8"])
    ap.add_argument("--zero1", action="store_true",
                    help="simulate the streamed-ZeRO-1 shape: "
                         "per-group reduce-scatter + parameter "
                         "all-gather")
    ap.add_argument("--no-overlap", action="store_true",
                    help="post-hoc reduction: nothing reduces until "
                         "the whole backward ends")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-plan", default=None,
                    help="seeded fault plan (inline JSON or path); "
                         "delay actions at site 'step' become "
                         "simulated stragglers")
    ap.add_argument("--probe-delay-us", type=float, default=1000.0,
                    help="straggler-sensitivity probe delay")
    ap.add_argument("--resize", default=None, metavar="FROM,TO",
                    help="price a world-resize event (quarantine "
                         "shrink / spare-promotion grow): the "
                         "redistribution bytes and modeled reshard "
                         "time of re-partitioning the sharded ZeRO-1 "
                         "state FROM->TO ranks (--zero1; honest zero "
                         "otherwise — docs/fault_tolerance.md "
                         "'Elastic resharding')")
    ap.add_argument("--opt-slots", type=int, default=2,
                    help="sharded f32 state vectors per parameter for "
                         "--resize pricing (Adam 2, momentum 1); the "
                         "int8 wire adds its EF residual on top")
    ap.add_argument("--fusion-threshold", type=int, default=64 << 20)
    ap.add_argument("--first-bucket", type=int, default=1 << 20)
    ap.add_argument("--compute-us-per-mib", type=float, default=120.0,
                    help="backward compute per MiB of gradient bytes "
                         "(the compute-intensity assumption; "
                         "docs/simulation.md)")
    ap.add_argument("--calibration", default=None,
                    help="calibration.json to price hops with "
                         "(default: HOROVOD_CALIBRATION_FILE; stale "
                         "signatures fall back loudly)")
    ap.add_argument("--replay", default=None, metavar="TRACE",
                    help="re-simulate an observed run (trace dir or "
                         "trace_merge --stats JSON) and report per-hop "
                         "divergence")
    ap.add_argument("--calibrate", default=None, metavar="TRACE",
                    help="fit calibration.json from an observed run "
                         "(trace dir or --stats JSON)")
    ap.add_argument("--serve", action="store_true",
                    help="serving mode (docs/serving.md): open-loop "
                         "Poisson arrivals through the shipping "
                         "continuous-batching policy; sweep --qps")
    ap.add_argument("--qps", default=None,
                    help="serving arrival rate(s), comma-separated "
                         "(e.g. '50,100,200' answers p99-vs-qps in one "
                         "sweep)")
    ap.add_argument("--serve-duration", type=float, default=10.0,
                    help="simulated seconds of arrivals per qps point")
    ap.add_argument("--serve-replicas", type=int, default=2)
    ap.add_argument("--serve-max-batch", type=int, default=8)
    ap.add_argument("--serve-max-wait-us", type=int, default=2000)
    ap.add_argument("--serve-queue-bound", type=int, default=1024)
    ap.add_argument("--serve-slo-ms", type=float, default=100.0)
    ap.add_argument("--serve-base-us", type=float, default=2000.0,
                    help="fixed service cost of one batch dispatch")
    ap.add_argument("--serve-per-request-us", type=float, default=500.0,
                    help="marginal service cost per occupied batch slot")
    ap.add_argument("--trace-out", default=None,
                    help="render the first --ranks count's simulated "
                         "fleet as trace windows + a merged Perfetto "
                         "trace under this directory")
    ap.add_argument("--trace-ranks", type=int, default=64,
                    help="max simulated lanes to render")
    ap.add_argument("-o", "--out", default=None,
                    help="report path (predict/replay) or "
                         "calibration.json path (--calibrate)")
    args = ap.parse_args(argv)

    if args.serve:
        if not args.qps:
            ap.error("--serve needs --qps (comma-separated rates)")
        return run_serve(args)
    if args.qps:
        ap.error("--qps only applies to --serve mode")
    if args.program == "layers" and not args.layer_bytes:
        ap.error("--program layers needs --layer-bytes")
    if args.calibrate:
        return run_calibrate(args)
    if args.replay:
        return run_replay(args)
    return run_predict(args)


if __name__ == "__main__":
    sys.exit(main())
