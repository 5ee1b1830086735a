"""Run a script of the PyTorch port as n gloo ranks on the CPU.

The ranks are separate processes (one default process group each) that
rendezvous through a ``FileStore`` in the test's own directory, so tests
running side by side under xdist never share a port. The worker script
imports only ``horovod_tpu_torch``; it finds its directory in
``HVD_TEST_DIR`` and its store at ``file://$HVD_TEST_DIR/store``.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(script: str, n: int, workdir, timeout: float = 180.0) -> list:
    """Run ``script`` as ranks 0..n-1; return their outputs. Fails with the
    output of every rank when one exits non-zero or the run times out."""
    path = os.path.join(str(workdir), "worker.py")
    with open(path, "w") as f:
        f.write(script)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["HVD_TEST_DIR"] = str(workdir)
    env["OMP_NUM_THREADS"] = "2"
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, path],
                env={**env, "HOROVOD_RANK": str(r), "HOROVOD_SIZE": str(n),
                     "HOROVOD_LOCAL_RANK": str(r), "HOROVOD_LOCAL_SIZE": str(n)},
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(
            f"ranks {failed} failed:\n" + "\n".join(
                f"--- rank {r} ---\n{o}" for r, o in enumerate(outs))
        )
    return outs


# --- the DP step's data-axis variants against the JAX step ----------------------
#
# A 2-layer GPT at d 64, f32, three AdamW steps from one set of flax weights,
# with buckets forced small so that the tree travels in several groups and
# buckets. The loss is ``lm_loss * (1 + poison.sum())``: a zero poison
# changes nothing, and a NaN in one rank's rows makes that rank's gradients
# non-finite (the guard's tests).

GPT_DIMS = dict(vocab_size=256, d_model=64, n_heads=2, n_layers=2, max_len=32)
GPT_BATCH, GPT_T, GPT_STEPS, GPT_LR = 4, 32, 3, 1e-3
GPT_THRESHOLD, GPT_FIRST_BUCKET = 1 << 14, 1 << 12

VARIANT_WORKER = r'''
import json, os
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
from horovod_tpu_torch.ops.fusion import tree_order
from horovod_tpu_torch.parallel.mesh import build_hierarchical_mesh
from horovod_tpu_torch.utils.convert import load_flax_params, params_to_numpy

d = os.environ["HVD_TEST_DIR"]
cfg = json.load(open(f"{d}/cfg.json"))
hvd.init(device="cpu", init_method=f"file://{d}/store")
r, n = hvd.rank(), hvd.size()
data = np.load(f"{d}/inputs.npz")
init = {k[2:]: data[k] for k in data.files if k.startswith("p:")}
per = data["tokens"].shape[0] // n
rows = slice(r * per, (r + 1) * per)
tok, lab = (torch.from_numpy(data[k][rows]) for k in ("tokens", "labels"))


def loss_fn(m, b):
    return lm_loss(m(b[0]), b[1]) * (1 + b[2].sum())


def snapshot(opt, model):
    state = opt.zero1_state.opt.state if opt._zero1 else opt.state
    return ([p.detach().clone() for p in model.parameters()],
            [(k, v.clone()) for s in state.values() for k, v in sorted(s.items())])


def same(a, b):
    return len(a[1]) == len(b[1]) and all(torch.equal(x, y) for x, y in zip(a[0], b[0])) \
        and all(torch.equal(x[1], y[1]) for x, y in zip(a[1], b[1]))


# A variant with "local_size" runs make_train_step(mesh=<(cross, local) mesh>,
# **kwargs) with a plain optimizer; the others wrap a DistributedOptimizer.
meshes = {ls: build_hierarchical_mesh(ls)
          for ls in sorted({v["local_size"] for v in cfg["variants"].values()
                            if "local_size" in v})}
for name, v in cfg["variants"].items():
    model = TransformerLM(**cfg["dims"], dtype=torch.float32, device="cpu", seed=0)
    load_flax_params(model, init)
    kw = dict(v["kwargs"])
    if "op" in kw:
        kw["op"] = getattr(hvd, kw["op"])
    adamw = torch.optim.AdamW(model.parameters(), lr=cfg["lr"], weight_decay=1e-4, eps=1e-8)
    if "local_size" in v:
        step = hvd.make_train_step(loss_fn, adamw, mesh=meshes[v["local_size"]], **kw)
        opt = step.optimizer
        opt.bind_module(model)
    else:
        opt = hvd.DistributedOptimizer(adamw, named_parameters=model.named_parameters(), **kw)
        step = hvd.make_train_step(loss_fn, opt)
    out = {"losses": [], "groups": [], "raised": [], "unchanged": []}
    for s in range(cfg["steps"]):
        poison = torch.zeros(per)
        if v.get("poison") == [s, r] or v.get("poison") == [s, -1]:
            poison[0] = float("nan")
        before = snapshot(opt, model)
        try:
            out["losses"].append(float(step(model, (tok, lab, poison))))
        except hvd.HorovodInternalError:
            out["raised"].append(s)
            out["losses"].append(float("nan"))
        out["unchanged"].append(same(before, snapshot(opt, model)))
        out["groups"].append(list(opt.streamed_groups))
        if s == 0 and opt._use_ef and not opt._zero1:
            first_residual = [e.clone() for e in opt.residual]
        if s == 0 and opt._zero1 and opt.zero1_state.ef is not None:
            first_zero1_ef = {f"z1:{g}/{b}": e.clone().numpy()
                              for g, bs in opt.zero1_state.ef.items() for b, e in bs.items()}
    arrays = {f"p:{k}": a for k, a in params_to_numpy(model).items()}
    if opt._use_ef and not opt._zero1:
        names = sorted(n for n, _ in model.named_parameters())
        names = [names[i].replace(".", "/") for i in tree_order(names)]
        arrays.update({f"e:{k}": e.numpy() for k, e in zip(names, opt.residual)})
        arrays.update({f"e1:{k}": e.numpy() for k, e in zip(names, first_residual)})
    if opt._zero1 and opt.zero1_state.ef is not None:
        arrays.update(first_zero1_ef)
    np.savez(f"{d}/{name}.rank{r}.npz", **arrays)
    json.dump(out, open(f"{d}/{name}.rank{r}.json", "w"))
hvd.shutdown()
'''


def gpt_setup(seed: int = 0):
    """The JAX side's model, flax weights and global batch (numpy)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from horovod_tpu.models import transformer as ref

    rng = np.random.RandomState(seed)
    shape = (GPT_BATCH, GPT_T)
    tokens = rng.randint(0, GPT_DIMS["vocab_size"], shape).astype(np.int32)
    labels = rng.randint(0, GPT_DIMS["vocab_size"], shape).astype(np.int32)
    model = ref.TransformerLM(**GPT_DIMS, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))["params"]
    return model, params, tokens, labels


def run_port_variants(workdir, variants: dict, n: int, setup) -> dict:
    """Run every variant ``{name: {"kwargs": DistributedOptimizer options,
    "poison": [step, rank] (rank -1: every rank)}}`` as n gloo ranks in one
    spawn; returns ``{name: [per-rank dict of arrays, losses, ...]}``. A
    variant with ``"local_size"`` passes its kwargs to ``make_train_step``
    with a plain optimizer on a ``build_hierarchical_mesh(local_size)``
    mesh."""
    import json

    import numpy as np

    from horovod_tpu.parallel.rules import named_tree_paths

    _, params, tokens, labels = setup
    init = {k: np.asarray(v) for k, v in named_tree_paths(params)}
    np.savez(f"{workdir}/inputs.npz", tokens=tokens.astype(np.int64),
             labels=labels.astype(np.int64), **{f"p:{k}": v for k, v in init.items()})
    with open(f"{workdir}/cfg.json", "w") as f:
        json.dump({"dims": GPT_DIMS, "steps": GPT_STEPS, "lr": GPT_LR,
                   "variants": variants}, f)
    run_ranks(VARIANT_WORKER, n, workdir, timeout=240)
    out = {}
    for name in variants:
        out[name] = []
        for r in range(n):
            with open(f"{workdir}/{name}.rank{r}.json") as f:
                rec = json.load(f)
            rec["arrays"] = dict(np.load(f"{workdir}/{name}.rank{r}.npz"))
            out[name].append(rec)
    return out


def run_jax_variant(setup, n: int, poison=None, local_size=None, **kw):
    """JAX's ``make_train_step`` with the same option on an n-device data
    mesh (a ``(cross, local)`` mesh with ``local_size``), the same loss,
    weights and batch: (losses, final named params, the opt_state after
    each step)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    import horovod_tpu.jax as hvdj
    from horovod_tpu.models import transformer as ref
    from horovod_tpu.parallel.mesh import build_hierarchical_mesh, build_mesh
    from horovod_tpu.parallel.rules import named_tree_paths
    from horovod_tpu.parallel.zero import init_zero1_stream_state

    model, params, tokens, labels = setup

    def loss_fn(p, b):
        return ref.lm_loss(model.apply({"params": p}, b[0]), b[1]) * (1 + b[2].sum())

    mesh = (build_mesh({"data": n}, devices=jax.devices()[:n]) if local_size is None
            else build_hierarchical_mesh(local_size, jax.devices()[:n]))
    tx = optax.adamw(GPT_LR)
    kw.setdefault("fusion_threshold_bytes", GPT_THRESHOLD)
    if kw.get("zero1"):
        state = init_zero1_stream_state(
            tx, params, n, threshold_bytes=kw["fusion_threshold_bytes"],
            first_bucket_bytes=kw.get("first_bucket_bytes"), quantized=bool(kw.get("quantized")))
    else:
        state = tx.init(params)
    step = hvdj.make_train_step(loss_fn, tx, mesh, donate=False, **kw)
    per = GPT_BATCH // n
    losses, states = [], []
    for s in range(GPT_STEPS):
        poison_rows = np.zeros(GPT_BATCH, np.float32)
        if poison is not None and poison[0] == s:
            poison_rows[poison[1] * per] = np.nan
        batch = (jnp.asarray(tokens), jnp.asarray(labels), jnp.asarray(poison_rows))
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
        states.append(state)
    return losses, {k: np.asarray(v) for k, v in named_tree_paths(params)}, states


def assert_params_close(got: dict, want: dict, lr: float = GPT_LR, steps: int = GPT_STEPS,
                        share: float = 1e-4):
    """The plain step's parameter tolerance (tests/test_torch_train.py): no
    element further apart than Adam can move it in ``steps`` steps, and all
    but a ``share`` of the elements (one in 10^4) within a hundredth of a
    step."""
    import numpy as np

    diffs = []
    for name, w in want.items():
        g = got[f"p:{name}"]
        assert g.shape == w.shape, name
        diffs.append(np.abs(g - w).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * lr * steps, diffs.max()
    assert np.mean(diffs > lr / 100) <= share, np.mean(diffs > lr / 100)
