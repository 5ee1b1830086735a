"""The port's checkpoints (``horovod_tpu_torch/utils/checkpoint.py``) against
the JAX package's npz route.

- A sharded f32 checkpoint (parameters, one sliced over the data axis, and a
  ZeRO-1 state) written by the JAX package at data 4 restores in the port at
  world 2, and one written by the port at world 4 restores in the JAX
  package at data 2: the parameters and the gathered optimizer rows bitwise.
- The replicated npz crosses both ways; a bf16 leaf, which both write as its
  raw two bytes, restores as bf16 in the port.
- A torn manifest and a missing payload refuse; ``broadcast=True`` onto
  rank-local state refuses (the reference's
  ``test_restore_broadcast_refuses_rank_local``).
- The atomic writes and the pointer order (copies of the assertions of
  ``tests/test_guard.py``'s ``test_checkpoint_atomic_write_survives_midwrite_kill``
  and ``test_checkpoint_latest_pointer_written_after_payload``).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu.jax as hvdj
from horovod_tpu.parallel import reshard as JR
from horovod_tpu.utils import checkpoint as jckpt

import horovod_tpu_torch.parallel.reshard as R
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.parallel import zero as Z
from horovod_tpu_torch.utils import checkpoint as ckpt

import test_reshard as ref_tests
from test_torch_reshard import OPTS, _torch_params, port_gather, port_rows


def _port_targets(opt_name, params, n, quantized):
    return Z.init_zero1_stream_states(OPTS[opt_name][1]([torch.zeros(1)]), _torch_params(params),
                                      n, threshold_bytes=1, first_bucket_bytes=1,
                                      quantized=quantized)


def _zeros_like(params):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros(np.asarray(v).shape)
            for k, v in params.items()}


@pytest.mark.parametrize("opt_name,quantized", [("sgdm", True), ("adam", False)])
def test_jax_sharded_checkpoint_restores_in_the_port_at_another_world(tmp_path, opt_name,
                                                                      quantized):
    tx = OPTS[opt_name][0]()
    tree, params, lay4 = ref_tests._ckpt_tree(tx, 4, quantized=quantized)
    man = JR.build_manifest(tree, [("data", 4)],
                            specs={"params/a/w": jax.sharding.PartitionSpec("data")},
                            zero1_layouts={"opt": lay4})
    ref_tests._save_all_ranks(str(tmp_path), tree, man)
    targets = _port_targets(opt_name, params, 2, quantized)
    got = []
    for r in range(2):
        out = ckpt.restore_checkpoint(str(tmp_path), {"params": _zeros_like(params),
                                                      "opt": targets[r]}, rank=r, world=2)
        for a, b in zip(jax.tree.leaves(params), ckpt.tree_leaves(out["params"])):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        got.append(out["opt"])
    rows = R.stack_zero1_states(got)
    want, _ = JR.reshard_zero1_state(tree["opt"], 2, layout=lay4)
    for a, b in zip(ref_tests._gather(want, lay4.relayout(2)),
                    port_gather(rows, lay4.relayout(2))):
        np.testing.assert_array_equal(a.astype(np.float64), b.astype(np.float64))


@pytest.mark.parametrize("opt_name,quantized", [("sgdm", True), ("adam", False)])
def test_port_sharded_checkpoint_restores_in_jax_at_another_world(tmp_path, opt_name,
                                                                  quantized):
    tx = OPTS[opt_name][0]()
    params = ref_tests._params(seed=9)
    jstate, lay4 = ref_tests._filled_state(tx, params, 4, quantized=quantized, seed=9)
    states = R.unstack_zero1_states(port_rows(jstate, lay4, opt_name, params))
    tparams = _torch_params(params)
    man = R.build_manifest({"params": tparams, "opt": states[0]}, [("data", 4)],
                           specs={"params/a/w": ("data",)}, zero1_layouts={"opt": lay4})
    for r in (1, 2, 3, 0):      # rank 0 last: it writes the manifest and the pointer
        ckpt.save_checkpoint(str(tmp_path), {"params": tparams, "opt": states[r]}, step=1,
                             manifest=man, rank=r)
    assert ckpt.latest_step(str(tmp_path)) == jckpt.latest_step(str(tmp_path)) == 1
    target = {"params": jax.tree.map(jnp.zeros_like, params),
              "opt": hvdj.init_zero1_stream_state(tx, params, 2, threshold_bytes=1,
                                                  first_bucket_bytes=1, quantized=quantized)}
    out = jckpt.restore_checkpoint(str(tmp_path), target)
    for a, b in zip(jax.tree.leaves(out["params"]), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    want, _ = JR.reshard_zero1_state(jstate, 2, layout=lay4)
    for a, b in zip(ref_tests._gather(out["opt"], lay4.relayout(2)),
                    ref_tests._gather(want, lay4.relayout(2))):
        np.testing.assert_array_equal(a, b)


def test_replicated_npz_crosses_both_ways_and_bf16(tmp_path):
    tree = {"w": jnp.arange(12.0).reshape(3, 4), "step": jnp.asarray(7)}
    jckpt.save_checkpoint(str(tmp_path / "j"), tree, step=2, use_orbax=False)
    target = {"w": torch.zeros(3, 4), "step": torch.zeros((), dtype=torch.int32)}
    out = ckpt.restore_checkpoint(str(tmp_path / "j"), target, broadcast=False)
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(tree["w"]))
    assert int(out["step"]) == 7 and out["step"].dtype == torch.int32
    ckpt.save_checkpoint(str(tmp_path / "p"), {"w": torch.arange(12.0).reshape(3, 4),
                                               "step": torch.tensor(7, dtype=torch.int32)},
                         step=2)
    assert not any(f.startswith("manifest") for f in os.listdir(tmp_path / "p"))
    back = jckpt.restore_checkpoint(str(tmp_path / "p"), jax.tree.map(jnp.zeros_like, tree),
                                    broadcast=False)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # bf16: both packages write the raw two bytes (``|V2``); the port reads
    # them back as bf16 into a bf16 target and refuses any other target.
    vals = np.linspace(-3, 3, 8).astype(np.float32)
    bf = {"w": jnp.asarray(vals).astype(jnp.bfloat16)}
    jckpt.save_checkpoint(str(tmp_path / "b"), bf, step=0, use_orbax=False)
    ckpt.save_checkpoint(str(tmp_path / "c"), {"w": torch.from_numpy(vals).to(torch.bfloat16)})
    a = np.load(str(tmp_path / "b" / "step_0.npz"))["leaf_0"]
    b = np.load(str(tmp_path / "c" / "step_0.npz"))["leaf_0"]
    assert a.dtype == b.dtype == np.dtype("V2") and a.tobytes() == b.tobytes()
    out = ckpt.restore_checkpoint(str(tmp_path / "b"), {"w": torch.zeros(8, dtype=torch.bfloat16)},
                                  broadcast=False)
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].float().numpy(), np.asarray(bf["w"], np.float32))
    with pytest.raises(ValueError, match="bf16"):
        ckpt.restore_checkpoint(str(tmp_path / "b"), {"w": torch.zeros(8)}, broadcast=False)
    with pytest.raises(ValueError, match="npz only"):
        ckpt.save_checkpoint(str(tmp_path / "o"), {"w": torch.zeros(2)}, use_orbax=True)


def test_torn_manifest_and_missing_payload_refuse(tmp_path):
    tx = OPTS["sgdm"][0]()
    tree, params, lay = ref_tests._ckpt_tree(tx, 2)
    man = JR.build_manifest(tree, [("data", 2)], zero1_layouts={"opt": lay})
    ref_tests._save_all_ranks(str(tmp_path), tree, man)
    target = {"params": _zeros_like(params), "opt": _port_targets("sgdm", params, 2, False)[0]}
    man_file = tmp_path / "manifest_step_1.json"
    blob = man_file.read_text()
    man_file.write_text(blob[: len(blob) // 2])
    with pytest.raises(RuntimeError, match="torn or invalid"):
        ckpt.restore_checkpoint(str(tmp_path), target, rank=0, world=2)
    man_file.unlink()
    with pytest.raises(RuntimeError, match="torn"):
        ckpt.restore_checkpoint(str(tmp_path), target, rank=0, world=2)
    man_file.write_text(blob)
    (tmp_path / "step_1.rank1.npz").unlink()
    with pytest.raises(RuntimeError, match="rank-1 payload"):
        ckpt.restore_checkpoint(str(tmp_path), target, rank=0, world=2)


def test_restore_broadcast_refuses_rank_local(tmp_path, monkeypatch):
    """``test_restore_broadcast_refuses_rank_local`` of ``tests/test_reshard.py``
    for the port: a replicated checkpoint of a tree holding a Zero1State
    refuses ``broadcast=True`` at several ranks, naming the path; a
    replicated tree still broadcasts."""
    from horovod_tpu_torch import train

    params = ref_tests._params()
    tparams = _torch_params(params)
    tree = {"params": tparams, "opt": _port_targets("sgdm", params, 2, True)[0]}
    ckpt.save_checkpoint(str(tmp_path), {"params": tparams}, step=0)
    monkeypatch.setattr(basics, "is_initialized", lambda: True)
    monkeypatch.setattr(basics, "size", lambda: 2)
    called = []
    monkeypatch.setattr(train, "broadcast_parameters",
                        lambda items, root_rank=0: called.append(len(list(items))))
    with pytest.raises(ValueError, match="RANK-LOCAL") as ei:
        ckpt.restore_checkpoint(str(tmp_path), tree, broadcast=True, step=0)
    assert "opt" in str(ei.value)
    assert not called, "broadcast ran despite rank-local state"
    ckpt.restore_checkpoint(str(tmp_path), {"params": tparams}, broadcast=True)
    assert called


def test_atomic_write_and_pointer_order(tmp_path):
    """The assertions of ``test_checkpoint_atomic_write_survives_midwrite_kill``
    and ``test_checkpoint_latest_pointer_written_after_payload``
    (``tests/test_guard.py``) on the port's module."""
    path = str(tmp_path / "ckpt")
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    ckpt.save_checkpoint(path, tree, step=1)
    assert ckpt.latest_step(path) == 1
    orig = np.savez

    def dying_savez(f, **kw):
        f.write(b"PK\x03\x04 torn")
        raise KeyboardInterrupt("killed mid-save")

    np.savez = dying_savez
    try:
        with pytest.raises(KeyboardInterrupt):
            ckpt.save_checkpoint(path, {"w": torch.zeros(6)}, step=2)
    finally:
        np.savez = orig
    assert ckpt.latest_step(path) == 1
    assert not os.path.exists(os.path.join(path, "step_2.npz"))
    assert not [f for f in os.listdir(path) if ".tmp." in f]
    restored = ckpt.restore_checkpoint(path, {"w": torch.zeros(6)}, broadcast=False)
    np.testing.assert_array_equal(restored["w"].numpy(), tree["w"].numpy())
    ckpt.save_checkpoint(path, {"w": torch.ones(2)}, step=5)
    assert json.load(open(os.path.join(path, "latest.json")))["step"] == 5
    assert os.path.exists(os.path.join(path, "step_5.npz"))
