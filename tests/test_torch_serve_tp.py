"""The port's tensor-parallel serving at ``model 2`` against the JAX package's dense decode.

One spawned run of 2 gloo ranks on the CPU (``WORKER``), the reference
tests' geometry (tests/test_serve.py's ``test_tp_sharded_decode_matches_dense``:
vocab 32, d 16, 2 heads, model 2; 2 layers here), f32, the same flax
weights cut to each rank's shards by the ``"gpt"`` rules:

- ``tp_decode_apply(model_axis=<the model group>)`` teacher-forced over 8
  positions (two live slots on shuffled pages, one padded slot) against
  JAX's dense ``tp_decode_apply``: logits at rtol 1e-5 / atol 1e-6 on both
  ranks, the same argmax, and each rank's cache the dense cache's slice of
  its head at the same tolerance (the second layer's k/v follow the first
  layer's all-reduce, which sums in another order);
- ``serve(mesh=..., rules="gpt")`` at 1 and 2 replicas: rank 0's engine
  answers the seeded prompts token for token as JAX's dense engine and the
  reference's one-request-at-a-time full recompute, and the follower
  replays exactly the steps the leader issued; the leader refuses a cache
  that is no replica's and a page table of another width than the
  followers' header.

Then ``tools/serve_parity`` itself on 2 gloo ranks, its parity check and
its ``--bench --smoke``.
"""

import json
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from horovod_tpu.jax import make_decode_step as ref_make_decode_step
from horovod_tpu.models import transformer as ref_tf
from horovod_tpu.parallel import rules as ref_rules
from horovod_tpu.serve import ServeEngine as RefEngine
from horovod_tpu.serve import make_decode_state as ref_make_decode_state

from torch_port_harness import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, D, HEADS, LAYERS, T = 32, 16, 2, 2, 32
RANKS, STEPS, PAGE, PAGES, NEW = 2, 8, 4, 16, 4

WORKER = r'''
import json, os
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.env import Config
from horovod_tpu_torch.models.transformer import tp_decode_apply
from horovod_tpu_torch.parallel.mesh import build_mesh
from horovod_tpu_torch.serve import make_decode_state, serve
from horovod_tpu_torch.utils.convert import decode_state_to_numpy, local_params_from_flax

d = os.environ["HVD_TEST_DIR"]
cfg = json.load(open(f"{d}/cfg.json"))
hvd.init(device="cpu", init_method=f"file://{d}/store")
r, n = hvd.rank(), hvd.size()
data = np.load(f"{d}/inputs.npz")
flat = {k[2:]: data[k] for k in data.files if k.startswith("p:")}
mesh = build_mesh({"model": n})
local = local_params_from_flax(flat, "gpt", mesh, device="cpu")
heads = cfg["heads"]
cache = make_decode_state(cfg["layers"], num_pages=cfg["pages"], page_size=cfg["page"],
                          n_heads=heads // n, head_dim=cfg["d"] // heads, dtype=torch.float32,
                          device="cpu")
tokens, positions = torch.from_numpy(data["tokens"]), torch.from_numpy(data["positions"])
table = torch.from_numpy(data["table"])
logits = []
for t in range(tokens.shape[0]):
    out, cache = tp_decode_apply(local, tokens[t], positions[t], cache, table, n_heads=heads,
                                 model_axis=mesh.get_group("model"), dtype=torch.float32)
    logits.append(out.numpy())
np.savez(f"{d}/decode{r}.npz", logits=np.stack(logits), **decode_state_to_numpy(cache))
served = {}
for replicas in (1, 2):
    c = Config()
    c.serve_kv_pages, c.serve_page_size, c.serve_max_batch = cfg["pages"], cfg["page"], 4
    c.serve_max_wait_us, c.serve_replicas = 500, replicas
    handle = serve(local, n_heads=heads, mesh=mesh, rules="gpt", config=c, dtype=torch.float32,
                   device="cpu")
    if handle.engine is None:
        served[replicas] = {"steps": handle.follower_steps}
        continue
    rids = [handle.submit(p, max_tokens=cfg["new"]) for p in cfg["prompts"]]
    handle.drain(timeout=120.0)
    served[replicas] = {"tokens": [list(handle.result(x).tokens) for x in rids]}
    # The leader refuses, before broadcasting, a cache that is no replica's
    # and a page table narrower than the followers' header.
    refused = []
    engine, own = handle.engine, handle.engine.replica_caches()[0]
    B, W = engine.max_batch_size, engine.table_width
    for cache, width in ((make_decode_state(cfg["layers"], num_pages=cfg["pages"],
                                            page_size=cfg["page"], n_heads=heads // n,
                                            head_dim=cfg["d"] // heads, dtype=torch.float32,
                                            device="cpu"), W), (own, W - 1)):
        try:
            handle.leader(engine.params, cache, np.zeros(B, np.int32), np.zeros(B, np.int32),
                          np.zeros((B, width), np.int32))
        except ValueError as e:
            refused.append(str(e))
    served[replicas]["refused"] = refused
    handle.stop()
    served[replicas]["steps"] = handle.leader.steps
json.dump(served, open(f"{d}/served{r}.json", "w"))
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    model = ref_tf.TransformerLM(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
                                 max_len=T)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32))["params"]
    rng = np.random.RandomState(3)
    prompts = [[int(t) for t in rng.randint(0, VOCAB, size=rng.randint(1, 6))] for _ in range(4)]
    tokens = rng.randint(0, VOCAB, (STEPS, 3)).astype(np.int64)
    tokens[:, 2] = 0                                   # slot 2 is padding
    positions = np.stack([np.arange(STEPS), np.arange(STEPS) + 3, np.zeros(STEPS, int)], 1)
    table = np.zeros((3, 3), np.int64)
    table[:2] = rng.permutation(np.arange(1, PAGES))[:6].reshape(2, 3)
    flat = {k: np.asarray(v) for k, v in ref_rules.named_tree_paths(params)}
    workdir = tmp_path_factory.mktemp("serve_tp")
    np.savez(workdir / "inputs.npz", tokens=tokens, positions=positions, table=table,
             **{f"p:{k}": v for k, v in flat.items()})
    (workdir / "cfg.json").write_text(json.dumps(dict(
        heads=HEADS, layers=LAYERS, d=D, pages=PAGES, page=PAGE, new=NEW, prompts=prompts)))
    run_ranks(WORKER, RANKS, workdir)
    decoded = [dict(np.load(workdir / f"decode{r}.npz")) for r in range(RANKS)]
    served = [json.loads((workdir / f"served{r}.json").read_text()) for r in range(RANKS)]
    return params, prompts, (tokens, positions, table), decoded, served


def test_tp_decode_matches_jax_dense(run):
    params, _, (tokens, positions, table), decoded, _ = run
    step = jax.jit(partial(ref_tf.tp_decode_apply, n_heads=HEADS, dtype=jnp.float32))
    cache = ref_make_decode_state(LAYERS, num_pages=PAGES, page_size=PAGE, n_heads=HEADS,
                                  head_dim=D // HEADS, dtype=jnp.float32)
    want = []
    for t in range(STEPS):
        logits, cache = step(params, jnp.asarray(tokens[t], jnp.int32),
                             jnp.asarray(positions[t], jnp.int32), cache,
                             jnp.asarray(table, jnp.int32))
        want.append(np.asarray(logits))
    want = np.stack(want)
    dense = {k: np.asarray(v) for k, v in ref_rules.named_tree_paths(cache)}
    for r, got in enumerate(decoded):
        np.testing.assert_allclose(got["logits"], want, rtol=1e-5, atol=1e-6)
        assert np.array_equal(got["logits"].argmax(-1), want.argmax(-1))
        heads = HEADS // RANKS
        for name, leaf in dense.items():      # this rank's heads of the dense cache
            np.testing.assert_allclose(got[name][1:], leaf[1:, :, r * heads:(r + 1) * heads],
                                       rtol=1e-5, atol=1e-6)


def test_leader_follower_server_matches_jax_dense_engine(run):
    params, prompts, _, _, served = run
    forward = jax.jit(partial(ref_tf.tp_apply, n_heads=HEADS, model_axis=None,
                              dtype=jnp.float32))

    def greedy(prompt):                    # tests/test_serve.py's _reference_greedy, padded
        seq = list(prompt)
        for _ in range(NEW):
            logits = forward(params, jnp.asarray([seq + [0] * (T - len(seq))], jnp.int32))
            seq.append(int(jnp.argmax(logits[0, len(seq) - 1])))
        return seq[len(prompt):]

    engine = RefEngine(params, ref_make_decode_step(n_heads=HEADS, dtype=jnp.float32),
                       n_layers=LAYERS, n_heads=HEADS, head_dim=D // HEADS, num_pages=PAGES,
                       page_size=PAGE, max_batch_size=4, max_wait_us=500,
                       max_context=min(T, (PAGES - 1) * PAGE), cache_dtype=jnp.float32)
    with engine:
        rids = [engine.submit(p, max_tokens=NEW) for p in prompts]
        engine.drain(timeout=120.0)
    jax_tokens = [list(engine.result(r).tokens) for r in rids]
    assert jax_tokens == [greedy(p) for p in prompts]
    for replicas in ("1", "2"):
        assert served[0][replicas]["tokens"] == jax_tokens
        assert served[0][replicas]["steps"] == served[1][replicas]["steps"] > 0
        foreign, narrow = served[0][replicas]["refused"]
        assert "caches of the engine's replicas" in foreign
        assert "pages wide" in narrow


@pytest.mark.parametrize("mode", ["parity", "bench"])
def test_serve_parity_tool_two_gloo_ranks(mode):
    """``tools/serve_parity`` (the multi-card check of tensor-parallel
    serving) on 2 gloo ranks. ``--bench --smoke`` runs at max_len 1024,
    where bench --serve's 64 pages of 8 bound the context (504), so the
    page table (63 pages) is narrower than max_len / 8: the leader's timed
    step must broadcast the header the followers read."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.serve_parity", "--ranks", "2",
         "--device", "cpu"] + ["--bench", "--smoke"] * (mode == "bench"),
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    if mode == "parity":
        (result,) = lines
        assert result["teacher_forced"]["max_logits_rel_l2"] <= 1e-5
        assert result["teacher_forced"]["argmax_identical"]
        assert result["tokens_identical"] == {"1": True, "2": True}
        assert result["steps_by_rank_and_replicas"][0] == result["steps_by_rank_and_replicas"][1]
        return
    assert [x["mesh"]["model"] for x in lines] == [1, 2, 2, 1]
    for x in lines:
        assert x["model"]["max_len"] == 1024
        assert (x["max_context"], x["table_width"]) == (504, 63)
        assert x["requests"] == 16 and x["steps"] > 0 and x["tokens_per_s"] > 0
        assert x["step_alone"]["step_ms"] > 0
