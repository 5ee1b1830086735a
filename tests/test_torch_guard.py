"""The port's non-finite guard against the JAX package's ``guard/``.

The policy resolution and the sentinels (``local_flag``, ``sanitize``,
``agree_flag``, ``select_on_flag``) against JAX's; then the DP step at 2
gloo ranks with a NaN injected into rank 1's rows at the second of three
steps (``lm_loss * (1 + poison.sum())``, so that rank's every gradient is
NaN):

- ``skip``: the parameters AND the AdamW state unchanged by that step on
  every rank (the inner ``step()`` is not called), post hoc, streamed and
  under ZeRO-1; the losses and parameters against JAX's
  ``make_train_step(nonfinite="skip")`` at the plain step's tolerances;
- ``zero``: the poisoned rank's gradients zeroed before the wire, against
  JAX's ``nonfinite="zero"`` at the same tolerances;
- ``abort``: ``HorovodInternalError`` on every rank, nothing applied;
- ``warn``: the update proceeds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu import guard as jguard
from horovod_tpu.guard import nonfinite as jnf

import horovod_tpu_torch as hvd
from horovod_tpu_torch import guard
from horovod_tpu_torch.guard import nonfinite as nf

from torch_port_harness import (GPT_FIRST_BUCKET, GPT_THRESHOLD, assert_params_close, gpt_setup,
                                run_jax_variant, run_port_variants)

N = 2
POISON = [1, 1]            # step 1, rank 1


@pytest.mark.parametrize("explicit,env", [(None, None), ("skip", None), (None, "ZERO"),
                                          ("warn", "abort"), (None, "bogus")])
def test_resolve_policy_matches_jax(monkeypatch, explicit, env):
    if env is None:
        monkeypatch.delenv("HOROVOD_GUARD_NONFINITE", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_GUARD_NONFINITE", env)
    if env == "bogus":
        for fn in (jguard.resolve_policy, guard.resolve_policy):
            with pytest.raises(ValueError, match="unknown HOROVOD_GUARD_NONFINITE"):
                fn(explicit)
        return
    assert guard.resolve_policy(explicit) == jguard.resolve_policy(explicit)


def test_sentinels_match_jax():
    tree = {"b": np.array([1.0, np.inf, 2.0], np.float32), "a": [np.array([np.nan, 3.0], np.float32)],
            "i": np.array([1, 2], np.int32)}
    jtree = {"b": jnp.asarray(tree["b"]), "a": [jnp.asarray(tree["a"][0])], "i": jnp.asarray(tree["i"])}
    ttree = {"b": torch.from_numpy(tree["b"]), "a": [torch.from_numpy(tree["a"][0])],
             "i": torch.from_numpy(tree["i"])}
    assert float(nf.local_flag(ttree)) == float(jnf.local_flag(jtree)) == 1.0
    assert float(nf.local_flag({"i": ttree["i"]})) == float(jnf.local_flag({"i": jtree["i"]})) == 0.0
    got, want = nf.sanitize(ttree), jnf.sanitize(jtree)
    for k in ("b", "i"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["a"][0].numpy(), np.asarray(want["a"][0]))
    clear = {"b": torch.zeros(3), "a": [torch.ones(2)], "i": torch.zeros(2, dtype=torch.int32)}
    picked = nf.select_on_flag(torch.tensor(1.0), ttree, clear)
    assert list(picked) == list(clear) and torch.equal(picked["b"], ttree["b"])
    assert torch.equal(nf.select_on_flag(torch.tensor(0.0), ttree, clear)["a"][0], torch.ones(2))


@pytest.fixture(scope="module")
def setup():
    return gpt_setup()


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    base = {"fusion_threshold_bytes": GPT_THRESHOLD}
    variants = {
        "skip": {"kwargs": dict(base, nonfinite="skip"), "poison": POISON},
        "skip_overlap": {"kwargs": dict(base, nonfinite="skip", overlap=True,
                                        first_bucket_bytes=GPT_FIRST_BUCKET), "poison": POISON},
        "skip_zero1": {"kwargs": dict(base, nonfinite="skip", zero1=True), "poison": POISON},
        "zero": {"kwargs": dict(base, nonfinite="zero"), "poison": POISON},
        "abort": {"kwargs": dict(base, nonfinite="abort"), "poison": POISON},
        "warn": {"kwargs": dict(base, nonfinite="warn"), "poison": POISON},
    }
    return run_port_variants(tmp_path_factory.mktemp("guard"), variants, N, setup)


def _params(arrays):
    return {k: v for k, v in arrays.items() if k.startswith("p:")}


@pytest.mark.parametrize("variant", ["skip", "skip_overlap", "skip_zero1"])
def test_skip_leaves_params_and_optimizer_state_on_every_rank(runs, variant):
    for r in range(N):
        rec = runs[variant][r]
        assert rec["unchanged"] == [False, True, False], rec["unchanged"]
        assert rec["raised"] == [] and np.isnan(rec["losses"][1])
        assert np.isfinite([rec["losses"][0], rec["losses"][2]]).all()
    for key, a in _params(runs[variant][0]["arrays"]).items():
        np.testing.assert_array_equal(runs[variant][1]["arrays"][key], a, err_msg=key)
    if variant != "skip":
        for key, a in _params(runs["skip"][0]["arrays"]).items():
            np.testing.assert_allclose(runs[variant][0]["arrays"][key], a, rtol=0, atol=1e-6)


def test_skip_matches_jax(runs, setup):
    losses, final, _ = run_jax_variant(setup, N, poison=POISON, nonfinite="skip")
    assert np.isnan(losses[1])
    for r in range(N):
        np.testing.assert_allclose(runs["skip"][r]["losses"], losses, rtol=1e-5)
    assert_params_close(runs["skip"][0]["arrays"], final)


def test_zero_matches_jax(runs, setup):
    losses, final, _ = run_jax_variant(setup, N, poison=POISON, nonfinite="zero")
    for r in range(N):
        rec = runs["zero"][r]
        assert rec["unchanged"] == [False, False, False] and rec["raised"] == []
        np.testing.assert_allclose(rec["losses"], losses, rtol=1e-5)
    assert_params_close(runs["zero"][0]["arrays"], final)
    assert all(np.isfinite(a).all() for a in _params(runs["zero"][1]["arrays"]).values())


def test_abort_raises_on_every_rank_and_applies_nothing(runs):
    for r in range(N):
        rec = runs["abort"][r]
        assert rec["raised"] == [1] and rec["unchanged"] == [False, True, False]


def test_warn_lets_the_update_through(runs):
    for r in range(N):
        rec = runs["warn"][r]
        assert rec["raised"] == [] and rec["unchanged"] == [False, False, False]
    assert not all(np.isfinite(a).all() for a in _params(runs["warn"][0]["arrays"]).values())


def test_agree_flag_is_a_max_over_ranks(tmp_path):
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        assert float(nf.agree_flag(torch.tensor(1.0))) == 1.0
        assert float(nf.agree_flag(torch.tensor(0.0))) == 0.0
    finally:
        hvd.shutdown()
