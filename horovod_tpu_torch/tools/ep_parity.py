"""Expert-parallel parity: a DATA×EXPERT mesh of n ranks against one process.

    python -m horovod_tpu_torch.tools.ep_parity --ranks 4 --expert 4               # a GPU per rank
    python -m horovod_tpu_torch.tools.ep_parity --ranks 4 --expert 2               # data 2 x expert 2
    python -m horovod_tpu_torch.tools.ep_parity --ranks 4 --expert 4 --device cpu  # gloo on the CPU
    python -m horovod_tpu_torch.tools.ep_parity --ranks 4 --expert 4 --bench       # the MoE bench step

The ranks form a ``{"data": ranks / expert, "expert": expert}`` mesh and
train a small f32 Switch-MoE LM (an embedding, 2 ``moe_ffn`` layers of 8
experts with the default capacity factor 1.25, a head, ``lm_loss`` plus 0.01
x aux) for 3 steps of ``parallel.ep.make_ep_train_step`` under SGD 0.5 (SGD
shows a wrong gradient scale that Adam hides), on one global batch of 512
tokens that the step shards over (data, expert). Every rank then trains a
copy of the same initial weights in one process with every expert and no
all-to-all: the loss is the mean over the n shards of each shard's loss,
each shard routed on its own as its rank routes it (the capacity is per
source rank), so tokens drop exactly where they drop across ranks. Each
rank holds its parameters (its expert rows) to that run: losses rtol 1e-5,
parameters rtol 1e-4 / atol 1e-5. TF32 is off. Prints one JSON line from
rank 0; exits non-zero on any disagreement.

``--bench`` times ``bench.py``'s MoE step (``bench.build_moe``: d_model 512,
d_hidden 2048, 4 layers of 16 experts, vocab 32768, 32 x 1024 tokens a rank)
at this mesh and prints each rank's step ms, tokens/s and one profiled step
(``utils.profile``): device busy ms, and device ms of the forward's dispatch,
expert products and combine (``moe_ffn``'s ``record_function`` spans), of
the all-to-alls (NCCL point-to-point kernels, a kernel's wait for its peers
included), of the other NCCL kernels, cuBLAS and the rest (the backward's
kernels fall in these).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

from .launch import launch_ranks, store_url

DIMS = dict(d_model=32, d_hidden=64, n_layers=2, experts=8, vocab=128)
TOKENS, STEPS, LR = 512, 3, 0.5
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
BENCH_TOKENS, BENCH_WARMUP, BENCH_STEPS = 32 * 1024, 2, 10


def _model(dims, experts_axis_size, index, dev, seed=0):
    """The tool's MoE LM: its parameters (this shard's expert rows) and its
    loss ``(task, aux)`` over a token stream."""
    import torch

    from horovod_tpu_torch.models.transformer import lm_loss
    from horovod_tpu_torch.parallel.ep import init_moe_params, moe_ffn
    from horovod_tpu_torch.utils.convert import moe_params_from_numpy

    g = torch.Generator().manual_seed(seed)
    d, v = dims["d_model"], dims["vocab"]
    params = {
        "embed": (torch.randn(v, d, generator=g) * 0.5).to(dev).requires_grad_(),
        "layers": [moe_params_from_numpy(
            init_moe_params(g, d_model=d, d_hidden=dims["d_hidden"],
                            num_experts=dims["experts"],
                            num_expert_shards=experts_axis_size, device="cpu"),
            n_shards=experts_axis_size, index=index, device=dev)
            for _ in range(dims["n_layers"])],
        "head": (torch.randn(d, v, generator=g) * d ** -0.5).to(dev).requires_grad_(),
    }

    def loss_fn(p, batch, expert_axis="expert"):
        tok, lab = batch
        h = p["embed"][tok]
        aux_total = 0.0
        for layer in p["layers"]:
            out, aux = moe_ffn(layer, h, expert_axis=expert_axis)
            h = h + out
            aux_total = aux_total + aux
        return lm_loss(h @ p["head"], lab), aux_total

    return params, loss_fn


def _flat(params, expert_rows=None):
    """Every leaf, flattened, in one order; ``expert_rows`` keeps those rows
    of the expert-sharded leaves."""
    import torch

    from horovod_tpu_torch.ops.fusion import tree_leaves
    from horovod_tpu_torch.parallel.ep import expert_sharding_specs

    specs = list(expert_sharding_specs(params).values())
    out = []
    for leaf, spec in zip(tree_leaves(params), specs):
        leaf = leaf.detach()
        if spec and expert_rows is not None:
            leaf = leaf[expert_rows]
        out.append(leaf.reshape(-1))
    return torch.cat(out)


def _parity(dev, expert: int) -> dict:
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import tree_leaves
    from horovod_tpu_torch.parallel.ep import make_ep_train_step
    from horovod_tpu_torch.parallel.mesh import build_mesh

    r, n = hvd.rank(), hvd.size()
    mesh = build_mesh({"data": n // expert, "expert": expert})
    e = mesh.get_local_rank("expert")
    params, loss_fn = _model(DIMS, expert, e, dev)
    init = _flat(params)
    rng = np.random.RandomState(0)
    batch = tuple(torch.from_numpy(rng.randint(0, DIMS["vocab"], (TOKENS,))).to(dev)
                  for _ in range(2))
    step = make_ep_train_step(loss_fn, torch.optim.SGD(tree_leaves(params), lr=LR), mesh)
    losses = [float(step(params, batch)) for _ in range(STEPS)]

    ref, ref_loss_fn = _model(DIMS, 1, 0, dev)
    opt = torch.optim.SGD(tree_leaves(ref), lr=LR)
    per = TOKENS // n
    ref_losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        shards = [ref_loss_fn(ref, tuple(t[i * per:(i + 1) * per] for t in batch),
                              expert_axis=None) for i in range(n)]
        task = torch.stack([t for t, _ in shards]).mean()
        (task + 0.01 * torch.stack([a for _, a in shards]).mean()).backward()
        opt.step()
        ref_losses.append(task.item())
    e_local = DIMS["experts"] // expert
    got, want = _flat(params), _flat(ref, slice(e * e_local, (e + 1) * e_local))
    diff = (got - want).abs()
    beyond = int((diff > PARAM_ATOL + PARAM_RTOL * want.abs()).sum())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    moved = bool((got != init).any())
    return {"rank": r, "expert": e, "losses": losses, "one_process_losses": ref_losses,
            "max_loss_rel_err": loss_rel, "max_param_abs_err": float(diff.max()),
            "params_beyond_tolerance": beyond, "params_checked": got.numel(),
            "ok": loss_rel <= LOSS_RTOL and beyond == 0 and moved}


SPANS = ("moe_dispatch", "moe_experts", "moe_combine")


def _family(name: str) -> str:
    """The MoE step's kernel families outside ``moe_ffn``'s forward spans:
    the all-to-alls (NCCL point-to-point kernels), other NCCL (the gradient
    averages), cuBLAS, the rest."""
    if "nccl" in name:
        return "all_to_all" if ("sendrecv" in name or "send" in name or "recv" in name) \
            else "nccl"
    return "gemm" if any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet")) else "other"


def _bench(dev, expert: int) -> dict:
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.bench import MOE_DIMS, build_moe
    from horovod_tpu_torch.utils.profile import profile_step

    r, n = hvd.rank(), hvd.size()
    step, params, batch, mesh = build_moe(MOE_DIMS, BENCH_TOKENS)
    axes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if axes["expert"] != expert:
        raise SystemExit(f"the MoE bench's mesh is {axes}, not expert {expert}")
    losses, times = [], []
    for i in range(BENCH_WARMUP + BENCH_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(float(step(params, batch)))
        if i >= BENCH_WARMUP:
            times.append(time.perf_counter() - t0)
    torch.cuda.synchronize(dev)
    profiled = profile_step(lambda: float(step(params, batch)), _family, SPANS)
    med = statistics.median(times) * 1e3
    return {"rank": r, "mesh": axes, "card": torch.cuda.get_device_name(dev),
            "step_ms": med, "tokens_per_s_per_card": BENCH_TOKENS / (med / 1e3),
            "profiled_step": profiled,
            "losses_first_last": (losses[0], losses[-1]),
            "all_ms": [round(t * 1e3, 2) for t in times],
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "finite": bool(np.isfinite(losses).all())}


def _worker(device, expert: int, bench: bool) -> int:
    import torch

    import horovod_tpu_torch as hvd

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device, init_method=store_url())
    try:
        dev = hvd.device()
        result = _bench(dev, expert) if bench else _parity(dev, expert)
        results = hvd.allgather_object(result)
        ok = all(x["finite"] if bench else x["ok"] for x in results)
        if hvd.rank() == 0:
            print(json.dumps({
                "ranks": hvd.size(), "mesh": {"data": hvd.size() // expert, "expert": expert},
                "device": str(dev),
                "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "ok": ok, "by_rank": results}), flush=True)
        return 0 if ok else 1
    finally:
        hvd.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--expert", type=int, default=4,
                    help="size of the expert axis; data = ranks / expert")
    ap.add_argument("--device", default=None, help="cpu for gloo; default: one GPU per rank")
    ap.add_argument("--bench", action="store_true",
                    help="time the MoE bench step (the card only; its mesh is bench.py's)")
    args = ap.parse_args()
    if args.ranks % args.expert:
        ap.error(f"--expert {args.expert} does not divide --ranks {args.ranks}")
    if args.bench and args.device == "cpu":
        ap.error("--bench times the card; it has no CPU form")
    if "HOROVOD_RANK" not in os.environ:
        argv = ["--ranks", str(args.ranks), "--expert", str(args.expert),
                "--device", args.device or "cuda"] + (["--bench"] if args.bench else [])
        return launch_ranks("horovod_tpu_torch.tools.ep_parity", argv, args.ranks)
    return _worker(args.device, args.expert, args.bench)


if __name__ == "__main__":
    sys.exit(main())
