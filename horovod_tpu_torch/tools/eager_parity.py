"""Eager-API parity: every eager op over n ranks against a whole-batch numpy
reference.

    python -m horovod_tpu_torch.tools.eager_parity --ranks 4                # a GPU per rank, NCCL
    python -m horovod_tpu_torch.tools.eager_parity --ranks 4 --device cpu   # gloo on the CPU
    python -m horovod_tpu_torch.tools.eager_parity --ranks 4 --bench

Every rank makes every rank's inputs from one seed, runs the eager
operations of ``horovod_tpu_torch`` (the native core negotiating, the NCCL
executor running the plans) on its own, and holds its results to what the
whole batch gives in numpy: allreduce with every op in f32, bf16, f16,
i32, i64 and u8 (data movement and integer reductions exact; f32 sums at
rtol 1e-5; half-precision sums at one rounding a rank), Adasum, allgather
with even and uneven dim 0, broadcast from every root, alltoall even and
with skewed splits, reducescatter even and uneven, the grouped operations
(an allreduce group in one plan), the object operations, a shape mismatch that
fails on every rank, disjoint process sets of neighbouring pairs and a
registration that differs between ranks and fails on every rank, and
``join`` with rank r running r + 1 steps (zeros and the participants
divisor). With an even number of ranks, 4 or more, the job then starts
again as a (cross 2, local n/2) grid, each rank still on its own card,
with the hierarchical knobs on: the two-level allreduce and allgather and
the hierarchical Adasum against their references. Rank 0 prints one JSON
line; any disagreement exits non-zero.

``--bench`` times the eager ``grouped_allreduce`` of GPT-2-small's
gradients (f32 and bf16) against ``ops/fusion.fused_allreduce`` over the
same tensors, in turns, and prints each rank's median ms beside the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .launch import launch_ranks, store_url

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
          "i32": torch.int32, "i64": torch.int64, "u8": torch.uint8}
OPS = ("SUM", "AVERAGE", "MIN", "MAX", "PRODUCT")
GPT2_SMALL = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12, max_len=1024)
BENCH_REPS = 6


def gpt2_small_grads(dtype: torch.dtype, device, seed: int = 0):
    """Gradient-shaped tensors of every GPT-2-small parameter, in the
    model's parameter order, N(0, 1e-2) from ``seed``."""
    from ..models.transformer import TransformerLM

    meta = TransformerLM(**GPT2_SMALL, dtype=torch.float32, device="meta")
    gen = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn(p.shape, generator=gen, device=device) * 1e-2).to(dtype)
            for _, p in meta.named_parameters()]


def _inputs(n: int, seed: int = 0) -> dict:
    """Every rank's inputs (row r is rank r's)."""
    rng = np.random.RandomState(seed)
    out = {}
    for dt in DTYPES:
        if dt in ("i32", "i64", "u8"):
            out[dt] = rng.randint(1, 4, size=(n, 33, 5)).astype(
                {"i32": np.int32, "i64": np.int64, "u8": np.uint8}[dt])
        else:
            out[dt] = (rng.rand(n, 33, 5) + 0.5).astype(np.float32)
    out["ada"] = rng.randn(n, 1000).astype(np.float32)
    out["even"] = rng.randn(n, 2 * n, 7).astype(np.float32)
    out["grp"] = rng.randn(n, 5, 64).astype(np.float32)
    return out


class _Checks:
    def __init__(self, rank: int):
        self.rank, self.failures, self.count = rank, [], 0

    def _as_np(self, x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return np.asarray(x)

    def exact(self, what, got, want):
        self.count += 1
        got, want = self._as_np(got), np.asarray(want)
        if got.shape != want.shape or not np.array_equal(got, want.astype(got.dtype)):
            self.failures.append(f"rank {self.rank} {what}: not equal (shapes {got.shape} "
                                 f"{want.shape})")

    def close(self, what, got, want, rtol, atol=0.0):
        self.count += 1
        got, want = self._as_np(got).astype(np.float64), np.asarray(want, np.float64)
        if got.shape != want.shape or not np.allclose(got, want, rtol=rtol, atol=atol):
            err = float(np.abs(got - want).max()) if got.shape == want.shape else None
            self.failures.append(f"rank {self.rank} {what}: max abs err {err}")

    def true(self, what, cond):
        self.count += 1
        if not cond:
            self.failures.append(f"rank {self.rank} {what}")


def _allreduce_ref(x: np.ndarray, dt: str, op: str):
    """The whole batch's reduction and its tolerance (None: exact)."""
    n = x.shape[0]
    if op in ("MIN", "MAX"):
        return (x.min(0) if op == "MIN" else x.max(0)), None
    if dt in ("i32", "i64", "u8"):
        s = x.astype(np.int64).sum(0) if op != "PRODUCT" else x.astype(np.int64).prod(0)
        if op == "AVERAGE":
            s = np.trunc(s / n).astype(np.int64)
        return s, None
    src = x.astype(np.float64)
    want = src.sum(0) if op != "PRODUCT" else src.prod(0)
    if op == "AVERAGE":
        want = want / n
    # f32: summation order; a half type: one rounding of each partial.
    return want, {"f32": 1e-5, "bf16": n * 2.0 ** -8, "f16": n * 2.0 ** -11}[dt]


def _half_input(x: np.ndarray, dt: str):
    """The rank inputs as the dtype holds them (halves round once)."""
    if dt in ("bf16", "f16"):
        return torch.from_numpy(x).to(DTYPES[dt]).float().numpy()
    return x


def _flat_cases(hvd, c: _Checks, X: dict, dev, n: int, r: int) -> None:
    from ..common import basics
    from ..ops.adasum import adasum_allreduce_reference

    def T(a, dt="f32"):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, DTYPES[dt])

    for dt in DTYPES:
        src = _half_input(X[dt], dt)
        for op in OPS:
            out = hvd.allreduce(T(X[dt][r], dt), op=getattr(hvd.ReduceOp, op),
                                name=f"ar.{dt}.{op}")
            c.true(f"allreduce {dt} {op} on the input's device", out.device == dev)
            c.true(f"allreduce {dt} {op} dtype", out.dtype == DTYPES[dt])
            want, rtol = _allreduce_ref(src, dt, op)
            if rtol is None:
                c.exact(f"allreduce {dt} {op}", out, want)
            else:
                c.close(f"allreduce {dt} {op}", out, want, rtol=rtol, atol=1e-6)
    scaled = hvd.allreduce(T(X["f32"][r]), op=hvd.Sum, prescale_factor=0.5, postscale_factor=3.0)
    c.close("allreduce scaled", scaled, X["f32"].astype(np.float64).sum(0) * 1.5, rtol=1e-5)
    if n & (n - 1) == 0:
        c.close("adasum", hvd.allreduce(T(X["ada"][r]), op=hvd.Adasum),
                adasum_allreduce_reference(list(X["ada"])), rtol=1e-5, atol=1e-6)
    e = X["even"]
    c.exact("allgather", hvd.allgather(T(e[r])), e.reshape(-1, 7))
    c.exact("allgather uneven", hvd.allgather(T(e[r][:r + 1])),
            np.concatenate([e[s][:s + 1] for s in range(n)]))
    for root in range(n):
        c.exact(f"broadcast root {root}", hvd.broadcast(T(e[r]), root_rank=root), e[root])
    c.exact("alltoall", hvd.alltoall(T(e[r])),
            np.concatenate([e[s][2 * r:2 * r + 2] for s in range(n)]))
    c.close("reducescatter", hvd.reducescatter(T(e[r])), e.sum(0)[2 * r:2 * r + 2], rtol=1e-5,
            atol=1e-6)
    c.close("reducescatter average", hvd.reducescatter(T(e[r]), op=hvd.Average),
            e.sum(0)[2 * r:2 * r + 2] / n, rtol=1e-5, atol=1e-6)
    d0 = 2 * n - 1          # uneven: the first rank keeps the remainder row
    base, rem = divmod(d0, n)
    start = r * base + min(r, rem)
    c.close("reducescatter uneven", hvd.reducescatter(T(e[r][:d0]), name="rs.uneven"),
            e[:, :d0].sum(0)[start:start + base + (r < rem)], rtol=1e-5, atol=1e-6)
    # Skewed splits: every rank sends (s + 1) * 3 rows to rank 0, one to the others.
    splits = [[(s + 1) * 3] + [1] * (n - 1) for s in range(n)]
    rows = [np.arange(sum(sp) * 2, dtype=np.float32).reshape(-1, 2) + 100 * s
            for s, sp in enumerate(splits)]
    offs = [np.concatenate([[0], np.cumsum(sp)]) for sp in splits]
    got, rs = hvd.alltoall(T(rows[r]), splits=splits[r], name="a2av")
    c.exact("alltoall skewed splits", got,
            np.concatenate([rows[s][offs[s][r]:offs[s][r + 1]] for s in range(n)]))
    c.exact("alltoall received splits", rs, [splits[s][r] for s in range(n)])
    empty, ers = hvd.alltoall(T(np.zeros((0, 2), np.float32)), splits=[0] * n, name="a2a.0")
    c.true("alltoall empty", tuple(empty.shape) == (0, 2) and ers.tolist() == [0] * n)
    # Grouped: each group one plan.
    ex = basics._runtime.eager.executor
    plans, orig = [], ex.execute

    def spy(plan, entries, topo):
        plans.append(list(plan["names"]))
        return orig(plan, entries, topo)

    ex.execute = spy
    try:
        g = X["grp"]
        outs = hvd.grouped_allreduce([T(t) for t in g[r]], op=hvd.Sum, name="grp")
        for i, o in enumerate(outs):
            c.close(f"grouped allreduce {i}", o, g[:, i].sum(0), rtol=1e-5, atol=1e-6)
        gag = hvd.grouped_allgather([T(e[r][:r + 1]), T(g[r][0])], name="gag")
        c.exact("grouped allgather 0", gag[0], np.concatenate([e[s][:s + 1] for s in range(n)]))
        c.exact("grouped allgather 1", gag[1], g[:, 0].reshape(-1))
        grs = hvd.grouped_reducescatter([T(e[r]), T(g[r][:, :8 * n].reshape(-1, 8))],
                                        name="grs")
        c.close("grouped reducescatter", grs[0], e.sum(0)[2 * r:2 * r + 2], rtol=1e-5, atol=1e-6)
        gsum = g[:, :, :8 * n].reshape(n, -1, 8).sum(0)
        k = gsum.shape[0] // n
        c.close("grouped reducescatter 1", grs[1], gsum[r * k:(r + 1) * k], rtol=1e-5, atol=1e-6)
    finally:
        ex.execute = orig
    # An allreduce group fuses into one plan; the other groups complete
    # together, one plan a member.
    for tag, want in (("grp", 1), ("gag", 2), ("grs", 2)):
        mine = [p for p in plans if any(nm.startswith(tag + ".") for nm in p)]
        c.true(f"{tag}: {want} plan(s), got {len(mine)}", len(mine) == want)
    c.true("allgather_object", hvd.allgather_object({"rank": r, "pad": "x" * r})
           == [{"rank": s, "pad": "x" * s} for s in range(n)])
    c.true("broadcast_object", hvd.broadcast_object({"from": r}, root_rank=n - 1)
           == {"from": n - 1})
    hvd.barrier()
    try:
        hvd.allreduce(T(np.ones((4,) if r == 0 else (5,), np.float32)), name="mismatch")
        c.true("shape mismatch raised", False)
    except RuntimeError as exc:
        c.true(f"shape mismatch names the tensor ({exc})", "mismatch" in str(exc))


def _set_cases(hvd, c: _Checks, X: dict, dev, n: int, r: int) -> None:
    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    pairs = [hvd.add_process_set([2 * p, 2 * p + 1]) for p in range(n // 2)]
    mine = pairs[r // 2]
    members = mine.ranks
    e, x = X["even"], X["f32"]
    c.close("process set sum", hvd.allreduce(T(x[r]), op=hvd.Sum, process_set=mine),
            x[members].astype(np.float64).sum(0), rtol=1e-5)
    c.exact("process set allgather", hvd.allgather(T(e[r][:r % 2 + 1]), process_set=mine),
            np.concatenate([e[s][:s % 2 + 1] for s in members]))
    c.exact("process set broadcast", hvd.broadcast(T(e[r]), root_rank=members[1],
                                                   process_set=mine), e[members[1]])
    k = e.shape[1] // 2
    c.close("process set reducescatter", hvd.reducescatter(T(e[r]), process_set=mine),
            e[members].sum(0)[(r % 2) * k:(r % 2 + 1) * k], rtol=1e-5, atol=1e-6)
    c.true("process set object", hvd.allgather_object(r, process_set=mine) == members)
    c.true("process set ids", [p.process_set_id for p in pairs] == list(range(1, n // 2 + 1)))
    hvd.barrier(process_set=mine)
    for p in pairs:
        hvd.remove_process_set(p)
    try:
        hvd.add_process_set([0, 1] if r != n - 1 else [n - 1])
        c.true("a divergent registration raised", False)
    except ValueError as exc:
        c.true(f"divergent registration ({exc})", "identically on every rank" in str(exc))


def _join_cases(hvd, c: _Checks, dev, n: int, r: int) -> None:
    for i in range(r + 1):
        live = [s for s in range(n) if s >= i]
        t = torch.full((3,), float(r + 1), device=dev)
        c.exact(f"join step {i} sum", hvd.allreduce(t, name=f"j.sum{i}", op=hvd.Sum),
                np.full(3, float(sum(s + 1 for s in live)), np.float32))
        c.close(f"join step {i} average", hvd.allreduce(t, name=f"j.avg{i}"),
                np.full(3, sum(s + 1 for s in live) / len(live)), rtol=1e-6)
    hvd.join()


def _grid_cases(hvd, c: _Checks, X: dict, dev, n: int, r: int) -> None:
    from ..common import basics
    from ..ops.adasum import hierarchical_adasum_reference

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    local = n // 2
    c.true("the executor built the (cross, local) grid", basics._runtime.eager.executor.has_grid)
    c.true("topology", [hvd.cross_rank(), hvd.cross_size(), hvd.local_rank(), hvd.local_size()]
           == [r // local, 2, r % local, local])
    x, e, a = X["f32"], X["even"], X["ada"]
    c.close("hierarchical allreduce sum", hvd.allreduce(T(x[r]), op=hvd.Sum),
            x.astype(np.float64).sum(0), rtol=1e-5)
    c.close("hierarchical allreduce average", hvd.allreduce(T(x[r])),
            x.astype(np.float64).sum(0) / n, rtol=1e-5)
    c.exact("hierarchical allgather", hvd.allgather(T(e[r])), e.reshape(-1, 7))
    c.exact("hierarchical allgather uneven", hvd.allgather(T(e[r][:r + 1])),
            np.concatenate([e[s][:s + 1] for s in range(n)]))
    # Adasum on a grid is hierarchical, between node averages (cross 2: a power of 2).
    c.close("hierarchical adasum", hvd.allreduce(T(a[r]), op=hvd.Adasum),
            hierarchical_adasum_reference(list(a / local), local_size=local),
            rtol=1e-5, atol=1e-6)


def _card(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", str(dev.index or 0)],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def _worker(device: str) -> int:
    import horovod_tpu_torch as hvd

    n, r = int(os.environ["HOROVOD_SIZE"]), int(os.environ["HOROVOD_RANK"])
    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", r)
    X = _inputs(n)
    c = _Checks(r)
    t0 = time.perf_counter()
    hvd.init(str(dev), init_method=store_url())
    try:
        _flat_cases(hvd, c, X, dev, n, r)
        if n >= 2 and n % 2 == 0:
            _set_cases(hvd, c, X, dev, n, r)
        _join_cases(hvd, c, dev, n, r)
    finally:
        hvd.shutdown()
    grid = n >= 4 and n % 2 == 0
    if grid:
        os.environ.update({"HOROVOD_LOCAL_SIZE": str(n // 2),
                           "HOROVOD_LOCAL_RANK": str(r % (n // 2)),
                           "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                           "HOROVOD_HIERARCHICAL_ALLGATHER": "1"})
        hvd.init(str(dev), init_method=store_url() + "_grid")
        try:
            _grid_cases(hvd, c, X, dev, n, r)
        finally:
            hvd.shutdown()
    for f in c.failures:
        print(f"[eager_parity] FAIL {f}", file=sys.stderr, flush=True)
    if r == 0:
        print(json.dumps({"eager_parity": "ok" if not c.failures else "failed", "ranks": n,
                          "device": dev.type, "card": _card(dev), "checks_rank0": c.count,
                          "failures_rank0": len(c.failures), "grid": grid,
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 1 if c.failures else 0


def _bench_worker(device: str) -> int:
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from ..ops import fusion

    n, r = int(os.environ["HOROVOD_SIZE"]), int(os.environ["HOROVOD_RANK"])
    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", r)
    hvd.init(str(dev), init_method=store_url())
    try:
        result = {}

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()

        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            grads = gpt2_small_grads(dtype, dev, seed=r)
            tol = (dict(rtol=0.0, atol=n * 2.0 ** -8 * 0.1) if tag == "bf16"
                   else dict(rtol=1e-5, atol=1e-6))
            want = None
            times = {"eager": [], "fused": []}
            for i in range(BENCH_REPS + 1):
                for kind in ("eager", "fused") if i % 2 == 0 else ("fused", "eager"):
                    sync()
                    t0 = time.perf_counter()
                    if kind == "eager":
                        outs = hvd.grouped_allreduce(grads, op=hvd.Sum, name=f"g.{tag}")
                    else:
                        outs = fusion.fused_allreduce(grads, op=hvd.Sum)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    if i:                       # the first turn warms up
                        times[kind].append((time.perf_counter() - t0) * 1e3)
                    # The two forms sum in different chunks, so bf16 partials
                    # round differently: n roundings of partials below 0.1.
                    if want is None:
                        want = [o.float() for o in outs]
                    elif not all(torch.allclose(o.float(), w, **tol) for o, w in zip(outs, want)):
                        raise SystemExit(f"rank {r}: {kind} {tag} disagrees with the first turn")
                    del outs
            result[tag] = {k: statistics.median(v) for k, v in times.items()}
            result[tag]["elements"] = sum(g.numel() for g in grads)
            result[tag]["tensors"] = len(grads)
            del grads, want
        rows = hvd.allgather_object(result)
        if r == 0:
            print(json.dumps({"eager_bench": "grouped_allreduce vs fused_allreduce, GPT-2-small "
                              "gradients, in turns", "ranks": n, "card": _card(dev),
                              "reps": BENCH_REPS, "by_rank": rows}), flush=True)
    finally:
        hvd.shutdown()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    ap.add_argument("--bench", action="store_true",
                    help="time the eager grouped allreduce against fused_allreduce")
    args = ap.parse_args()
    if "HOROVOD_RANK" not in os.environ:
        return launch_ranks("horovod_tpu_torch.tools.eager_parity",
                            ["--ranks", str(args.ranks), "--device", args.device or "cuda"]
                            + (["--bench"] if args.bench else []), args.ranks)
    return (_bench_worker if args.bench else _worker)(args.device or "cuda")


if __name__ == "__main__":
    sys.exit(main())
