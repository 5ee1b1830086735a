"""The port's convergence evidence (``horovod_tpu_torch.utils.convergence``)
against the JAX package's (``horovod_tpu.utils.convergence``).

``convergence.run(steps=40)`` on 4 gloo ranks at the JAX test's model and
global batch (16 sequences of 64 tokens, 4 a rank), starting from the JAX
run's initial weights carried across as numpy. The assertions of
``tests/test_zero.py::test_quantized_convergence_tracks_fp32``: the fp32 curve
falls below 0.8x its first loss, and both lossy paths end within 5% of fp32.
The first record point (the loss of the initial weights on the first batch,
before any update) matches the JAX curve's: the same weights and tokens
through the bf16 forward of each package, within 5e-3 relative (bf16 keeps
8 bits of mantissa, 3.9e-3 of a value; the mean over 1024 tokens averages
the roundings down), beyond the 4-decimal rounding both curves carry.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from horovod_tpu.models.transformer import TransformerLM, lm_loss
from horovod_tpu.parallel.rules import named_tree_paths

from torch_port_harness import run_ranks

N, GLOBAL_BATCH, SEQ, VOCAB, STEPS = 4, 16, 64, 512, 40

WORKER = r'''
import json, os
import numpy as np
import horovod_tpu_torch as hvd
from horovod_tpu_torch.utils import convergence

d = os.environ["HVD_TEST_DIR"]
hvd.init(device="cpu", init_method=f"file://{d}/store")
data = np.load(f"{d}/init.npz")
result = convergence.run(steps=STEPS, record_every=10,
                         init={k: data[k] for k in data.files})
if hvd.rank() == 0:
    json.dump(result, open(f"{d}/result.json", "w"))
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # The JAX module's data and init (global batch 16: 2 a device on 8 devices).
    rng = np.random.RandomState(0)
    tok0, lab0 = (rng.randint(0, VOCAB, (GLOBAL_BATCH, SEQ)) for _ in range(2))
    model = TransformerLM(vocab_size=VOCAB, d_model=128, n_heads=4, n_layers=2, max_len=SEQ)
    params0 = model.init(jax.random.PRNGKey(0), jnp.asarray(tok0[:1], jnp.int32))["params"]
    first = float(lm_loss(model.apply({"params": params0}, jnp.asarray(tok0, jnp.int32)),
                          jnp.asarray(lab0, jnp.int32)))
    d = tmp_path_factory.mktemp("torch_convergence")
    np.savez(d / "init.npz", **{k: np.asarray(v, np.float32)
                                for k, v in named_tree_paths(params0)})
    run_ranks(WORKER.replace("STEPS", str(STEPS)), N, d, timeout=300)
    return json.loads((d / "result.json").read_text()), first


def test_convergence_tracks_fp32(runs):
    result, _ = runs
    final = result["final_loss"]
    assert result["n_devices"] == N and result["model"]["global_batch"] == GLOBAL_BATCH
    assert len(result["curves"]["fp32"]) == STEPS // 10 + 1
    # The curves must actually be training...
    assert final["fp32"] < result["curves"]["fp32"][0] * 0.8, result["curves"]
    # ...and the lossy paths must land within 5% of fp32.
    assert result["rel_gap_vs_fp32"]["quantized"] < 0.05, final
    assert result["rel_gap_vs_fp32"]["quantized+zero1"] < 0.05, final


def test_convergence_first_point_matches_jax(runs):
    result, first = runs
    for name, curve in result["curves"].items():
        np.testing.assert_allclose(curve[0], round(first, 4), rtol=5e-3, err_msg=name)
