"""Checkpoint and resume: the npz route of ``horovod_tpu/utils/checkpoint.py``.

The reference leaves checkpointing to the frameworks and supplies the
consistency primitives (rank 0 saves; every rank resumes from one state by
a broadcast). This module packages them for trees of torch tensors (dicts,
lists, tuples; numpy arrays and Python numbers too) in the JAX package's
file format, so a checkpoint written by one package restores in the other:

- the replicated form: ``step_N.npz`` (``leaf_<i>`` in ``jax.tree.leaves``
  order) and ``latest.json``;
- the sharded form (``save_checkpoint(..., manifest=...)``): every rank
  writes its own ``step_N.rankR.npz`` (a tensor-parallel leaf sliced per
  its spec, a ``Zero1State``'s rows as ``z<node>_<j>``), and rank 0 writes
  ``manifest_step_N.json`` and ``latest.json`` LAST, so a reader sees a
  whole checkpoint or no manifest at all.

Every write is atomic: a temporary file in the same directory, fsynced,
then ``os.replace``. A torn manifest, or one missing a rank's payload,
refuses loudly; it never falls back to the replicated route.

A ``Zero1State``'s rows are written in the JAX package's leaf order: per
bucket (groups and buckets by sorted key) the inner optimizer's state as
the optax leaves it stands for (``step`` as optax's int32 ``count``, then
``exp_avg``/``exp_avg_sq`` as ``mu``/``nu``; SGD's ``momentum_buffer`` as
``trace``), then the sharded residuals. A restore at another world size
reshards the gathered rows (``parallel/reshard``) and keeps the target
rank's. The flat parameter shards are not written: the shard-local update
copies them from the parameters before every step.

Deliberate differences from the reference: there is no orbax route
(``use_orbax=True`` raises); the restore of a sharded checkpoint takes the
target's ``rank`` (default: this process's) because a port ``Zero1State``
holds one rank's rows; and a bf16 leaf, which the reference's npz route
writes as its raw two bytes (numpy has no bf16: a ``|V2`` array its own
restore cannot read back), is written the same way here and read back as
bf16 into a bf16 target leaf (a ``|V2`` array into any other target
refuses).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..guard.digest import host_array, tree_leaves

logger = logging.getLogger("horovod_tpu_torch.checkpoint")

# The optimizer state keys each optimizer class starts with, as optax
# initializes its leaves (a fresh torch optimizer has none until its first
# step; the file holds them from the start, as the JAX package's does).
_INIT_KEYS = {"Adam": ("step", "exp_avg", "exp_avg_sq"),
              "AdamW": ("step", "exp_avg", "exp_avg_sq")}


def _atomic_write(final_path: str, write_fn) -> None:
    """Write through a same-directory temporary file and ``os.replace``:
    a crash mid-write never leaves a torn file under the final name."""
    tmp = f"{final_path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final_path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _reshard_mod():
    from ..parallel import reshard

    return reshard


def _is_zero1(node: Any) -> bool:
    from ..parallel.zero import Zero1State

    return isinstance(node, Zero1State)


def _is_rank_local(node: Any) -> bool:
    from ..ops.quantized import EFState

    return _is_zero1(node) or isinstance(node, EFState)


def _file_array(leaf: Any) -> np.ndarray:
    """A leaf as the npz file holds it: a bf16 tensor as its raw two bytes
    (``|V2``), as numpy stores an ``ml_dtypes.bfloat16`` array."""
    arr = host_array(leaf)
    if arr.dtype.name == "bfloat16" or (arr.dtype == np.uint16 and _is_bf16(leaf)):
        return arr.view(np.dtype("V2"))
    return arr


def _is_bf16(leaf: Any) -> bool:
    import torch

    return torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16


def _to_target(arr: np.ndarray, like: Any) -> Any:
    """A file array in the target leaf's kind: a tensor of its dtype on its
    device for a tensor target, the array itself otherwise."""
    import torch

    if torch.is_tensor(like):
        if arr.dtype.kind == "V":
            if like.dtype != torch.bfloat16 or arr.dtype.itemsize != 2:
                raise ValueError(
                    f"checkpoint leaf holds raw {arr.dtype} bytes (a bf16 leaf) but the "
                    f"target leaf is {like.dtype}: restore it into a bf16 tensor")
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
            return t.view(torch.bfloat16).reshape(arr.shape).to(like.device)
        return torch.from_numpy(np.array(arr)).to(device=like.device, dtype=like.dtype)
    return arr


def _unflatten_like(target: Any, values: List[Any], is_leaf=None) -> Any:
    from ..guard.digest import tree_map

    it = iter(values)
    return tree_map(lambda _: next(it), target, is_leaf=is_leaf)


def _rank_local_paths(tree: Any) -> List[str]:
    """Tree paths of rank-local nodes (``Zero1State``s, ``EFState``s): a
    broadcast must never overwrite them with the root's."""
    R = _reshard_mod()
    return ["/".join(p) for p, leaf in R._flatten_with_path(tree, _is_rank_local)
            if _is_rank_local(leaf)]


def _opt_keys(opt) -> List[str]:
    """The state keys of one bucket of ``opt``'s, in optax leaf order."""
    R = _reshard_mod()
    keys = set(_INIT_KEYS.get(type(opt).__name__, ()))
    if type(opt).__name__ == "SGD" and opt.defaults.get("momentum", 0):
        keys.add("momentum_buffer")
    if opt.defaults.get("amsgrad"):
        keys.add("max_exp_avg_sq")
    for st in opt.state.values():
        keys.update(k for k, v in st.items() if v is not None)
    return R.state_keys(keys)


def _zero1_leaves(node: Any) -> List[np.ndarray]:
    """One rank's ``Zero1State`` rows in the file's order (the module
    docstring): optax's leaves per bucket, then the residuals."""
    out = []
    keys = _opt_keys(node.opt)
    for g in sorted(node.shards):
        for b in sorted(node.shards[g]):
            shard = node.shards[g][b]
            st = node.opt.state.get(shard, {})
            for key in keys:
                v = st.get(key)
                if v is None:       # not stepped yet: optax's initial value
                    v = 0 if key == "step" else np.zeros(tuple(shard.shape), _np_dtype(shard))
                arr = host_array(v) if not isinstance(v, (int, float)) else np.asarray(v)
                out.append(arr.astype(np.int32) if key == "step" else arr)
    if node.ef is not None:
        for g in sorted(node.ef):
            for b in sorted(node.ef[g]):
                out.append(host_array(node.ef[g][b]))
    return out


def _np_dtype(t) -> np.dtype:
    return host_array(t.reshape(-1)[:0]).dtype


def save_checkpoint(path: str, tree: Any, step: int = 0, use_orbax: Optional[bool] = None, *,
                    manifest: Any = None, rank: int = 0) -> str:
    """Save a tree. Without ``manifest``: the replicated form; call from
    rank 0 only. With ``manifest`` (``parallel.reshard.build_manifest``):
    the sharded form; EVERY rank calls with its own ``rank`` and writes its
    payload, and rank 0 then writes the manifest and the ``latest.json``
    pointer, so it must save after the other ranks' payloads are durable
    (after a barrier). ``use_orbax=True`` raises: the port has the npz
    route only."""
    if use_orbax:
        raise ValueError("horovod_tpu_torch checkpoints are npz only (use_orbax=False): the "
                         "orbax route of the JAX package has no counterpart in the port")
    if manifest is not None:
        return _save_sharded(path, tree, step, manifest, rank)
    os.makedirs(path, exist_ok=True)
    payload = {f"leaf_{i}": _file_array(l) for i, l in enumerate(tree_leaves(tree))}
    _atomic_write(os.path.join(path, f"step_{step}.npz"), lambda f: np.savez(f, **payload))
    meta = json.dumps({"step": step, "orbax": False}).encode()
    _atomic_write(os.path.join(path, "latest.json"), lambda f: f.write(meta))
    return path


def _zero1_row_index(manifest, entry: dict, rank: int) -> int:
    R = _reshard_mod()
    axis = entry.get("axis", "data")
    coords = R.rank_coords(manifest.mesh_axes, rank)
    if axis not in coords:
        raise ValueError(f"zero1 layout is scoped to axis {axis!r} but the manifest mesh "
                         f"{manifest.mesh_axes} has no such axis")
    return coords[axis]


def _save_sharded(path: str, tree: Any, step: int, manifest: Any, rank: int) -> str:
    R = _reshard_mod()
    os.makedirs(path, exist_ok=True)
    mesh_sizes = dict(manifest.mesh_axes)
    coords = R.rank_coords(manifest.mesh_axes, rank)
    payload: Dict[str, np.ndarray] = {}
    li = zi = 0
    for name, leaf in R.named_leaves(tree):
        if _is_zero1(leaf):
            if name not in manifest.zero1:
                raise ValueError(
                    f"tree holds a Zero1State at {name!r} but the manifest records none "
                    f"there (known: {sorted(manifest.zero1)}): rebuild the manifest")
            for j, arr in enumerate(_zero1_leaves(leaf)):
                payload[f"z{zi}_{j}"] = arr
            zi += 1
            continue
        entry = manifest.leaves[li]
        arr = _file_array(leaf)
        if list(arr.shape) != list(entry["shape"]):
            raise ValueError(
                f"leaf {entry['path']} has shape {arr.shape} but the manifest records "
                f"{entry['shape']}: save_checkpoint expects the GLOBAL leaf; rebuild the "
                f"manifest for this tree")
        payload[f"leaf_{li}"] = arr[R.leaf_slices(entry["spec"], arr.shape, mesh_sizes, coords)]
        li += 1
    if li != len(manifest.leaves) or zi != len(manifest.zero1):
        raise ValueError(
            f"tree/manifest mismatch: tree has {li} leaves + {zi} zero1 nodes, manifest "
            f"records {len(manifest.leaves)} + {len(manifest.zero1)}: rebuild the manifest "
            f"for this tree")
    _atomic_write(os.path.join(path, f"step_{step}.rank{rank}.npz"),
                  lambda f: np.savez(f, **payload))
    if rank == 0:
        man = R.LayoutManifest(mesh_axes=manifest.mesh_axes, leaves=manifest.leaves,
                               zero1=manifest.zero1, rules_id=manifest.rules_id,
                               step=int(step))
        blob = man.to_json().encode()
        _atomic_write(os.path.join(path, f"manifest_step_{step}.json"), lambda f: f.write(blob))
        meta = json.dumps({"step": int(step), "orbax": False, "sharded": True,
                           "world": man.world}).encode()
        _atomic_write(os.path.join(path, "latest.json"), lambda f: f.write(meta))
    return path


def latest_step(path: str) -> Optional[int]:
    meta = os.path.join(path, "latest.json")
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return int(json.load(f)["step"])


def _this_rank() -> tuple:
    from ..common import basics

    if basics.is_initialized():
        return basics.rank(), basics.size()
    return int(os.environ.get("HOROVOD_RANK", "0")), int(os.environ.get("HOROVOD_SIZE", "1"))


def restore_checkpoint(path: str, target: Any, step: Optional[int] = None,
                       broadcast: bool = True, root_rank: int = 0, ef_policy: str = "fold",
                       *, rank: Optional[int] = None, world: Optional[int] = None) -> Any:
    """Restore a tree saved by ``save_checkpoint`` (by either package) into
    the shape of ``target``: tensors on the target leaves' devices and
    dtypes.

    A sharded checkpoint is assembled to GLOBAL leaves from every rank's
    payload; a ``Zero1State`` in ``target`` gets the rows of ``rank`` (this
    process's by default) in a world of ``world`` ranks (this job's), via
    the reshard planner when the manifest's shard count differs. A torn
    manifest, or a missing payload, refuses. ``ef_policy`` governs the
    error-feedback residuals across a shard-count change.

    A replicated checkpoint restores as saved; with ``broadcast=True`` it is
    then broadcast from ``root_rank`` (the port's ``broadcast_parameters``
    over the process group) when the job has several ranks, unless the tree
    holds RANK-LOCAL nodes (``Zero1State``, ``EFState``), which a broadcast
    would overwrite with the root's rows: that refuses, naming them."""
    from ..common import basics

    meta_path = os.path.join(path, "latest.json")
    tree = target
    restored_sharded = False
    several = basics.is_initialized() and basics.size() > 1
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        step = meta["step"] if step is None else step
        man_path = os.path.join(path, f"manifest_step_{step}.json")
        if meta.get("sharded") or os.path.exists(man_path):
            me, n = _this_rank()
            tree = _restore_sharded(path, target, step, ef_policy,
                                    me if rank is None else int(rank),
                                    n if world is None else int(world))
            restored_sharded = True
        elif meta.get("orbax"):
            raise ValueError(f"checkpoint at {path} step {step} was written by orbax; the "
                             f"port reads the npz route only")
        else:
            if broadcast and several:
                _refuse_rank_local(target, root_rank)
            data = np.load(os.path.join(path, f"step_{step}.npz"))
            like = tree_leaves(target)
            tree = _unflatten_like(target, [_to_target(data[f"leaf_{i}"], l)
                                            for i, l in enumerate(like)])
    if broadcast and several and not restored_sharded:
        _refuse_rank_local(tree, root_rank)
        from .. import train

        train.broadcast_parameters([(str(i), l) for i, l in enumerate(tree_leaves(tree))
                                    if hasattr(l, "detach")], root_rank=root_rank)
    return tree


def _refuse_rank_local(tree: Any, root_rank: int) -> None:
    offending = _rank_local_paths(tree)
    if offending:
        raise ValueError(
            "restore_checkpoint(broadcast=True) would overwrite RANK-LOCAL state with rank "
            f"{root_rank}'s rows at: {offending}: Zero1State shards and EF residuals are "
            "distinct per rank by construction. Save a sharded checkpoint "
            "(save_checkpoint(..., manifest=build_manifest(...))) or pass broadcast=False and "
            "restore each rank's own payload.")


def _restore_sharded(path: str, target: Any, step: int, ef_policy: str, rank: int,
                     world: int) -> Any:
    R = _reshard_mod()
    man_path = os.path.join(path, f"manifest_step_{step}.json")
    try:
        with open(man_path) as f:
            manifest = R.LayoutManifest.from_json(f.read())
    except FileNotFoundError:
        raise RuntimeError(
            f"checkpoint at {path} step {step} is marked sharded but "
            f"{os.path.basename(man_path)} is missing: the save was torn before the manifest "
            f"landed; refusing to guess a layout (restore an older step)")
    except (json.JSONDecodeError, ValueError, KeyError) as e:
        raise RuntimeError(
            f"checkpoint layout manifest {man_path} is torn or invalid ({e}); refusing to "
            f"restore from a checkpoint whose layout cannot be trusted (restore an older step)")
    payloads = []
    for r in range(manifest.world):
        p = os.path.join(path, f"step_{step}.rank{r}.npz")
        if not os.path.exists(p):
            raise RuntimeError(
                f"sharded checkpoint at {path} step {step} is missing the rank-{r} payload "
                f"{os.path.basename(p)} (manifest says world={manifest.world}): the save was "
                f"torn; refusing partial restore")
        payloads.append(np.load(p))
    mesh_sizes = dict(manifest.mesh_axes)
    named = R.named_leaves(target)
    n_z = sum(1 for _, l in named if _is_zero1(l))
    if len(named) - n_z != len(manifest.leaves) or n_z != len(manifest.zero1):
        raise ValueError(
            f"restore target has {len(named) - n_z} leaves + {n_z} Zero1State nodes but the "
            f"checkpoint records {len(manifest.leaves)} + {len(manifest.zero1)}: the target "
            f"tree does not match what was saved")
    zero1_paths = sorted(manifest.zero1)
    out = []
    li = zi = 0
    for _, leaf in named:
        if _is_zero1(leaf):
            entry = manifest.zero1[zero1_paths[zi]]
            out.append(_restore_zero1(R, manifest, entry, payloads, zi, leaf, ef_policy,
                                      rank, world))
            zi += 1
            continue
        entry = manifest.leaves[li]
        out.append(_to_target(_assemble_leaf(R, entry, payloads, li, mesh_sizes,
                                             manifest.mesh_axes), leaf))
        li += 1
    return _unflatten_like(target, out, is_leaf=_is_zero1)


def _assemble_leaf(R, entry: dict, payloads, li: int, mesh_sizes, mesh_axes) -> np.ndarray:
    shape = tuple(int(d) for d in entry["shape"])
    first = payloads[0][f"leaf_{li}"]
    if entry.get("spec") is None:
        return first
    out = np.zeros(shape, dtype=first.dtype)
    for r, data in enumerate(payloads):
        sl = R.leaf_slices(entry["spec"], shape, mesh_sizes, R.rank_coords(mesh_axes, r))
        out[sl] = data[f"leaf_{li}"]
    return out


def _restore_zero1(R, manifest, entry: dict, payloads, zi: int, target_node: Any,
                   ef_policy: str, rank: int, world: int) -> Any:
    import torch

    layout = R.Zero1Layout.from_dict(entry)
    axis = entry.get("axis", "data")
    for a, size in manifest.mesh_axes:
        if a != axis and int(size) != 1:
            raise ValueError(
                f"sharded checkpoint holds Zero1State scoped to axis {axis!r} on mesh "
                f"{manifest.mesh_axes}: restoring zero1 state saved with a non-trivial {a!r} "
                f"axis needs a re-init from the gathered params (the rows differ per {a!r} "
                f"coordinate)")
    rows_by_idx: Dict[int, int] = {}
    for r in range(manifest.world):
        rows_by_idx.setdefault(_zero1_row_index(manifest, entry, r), r)
    if sorted(rows_by_idx) != list(range(layout.n_shards)):
        raise ValueError(f"manifest mesh {manifest.mesh_axes} yields zero1 rows "
                         f"{sorted(rows_by_idx)} but the layout has {layout.n_shards} shards: "
                         f"the manifest is inconsistent")
    keys = _opt_keys(target_node.opt)
    items = [(g, b) for g, b, _ in layout.bucket_items()]
    have = {(g, b) for g in target_node.shards for b in target_node.shards[g]}
    if set(items) != have:
        raise ValueError(f"the checkpoint's zero1 buckets {items} are not the target's "
                         f"{sorted(have)}: the target was built for different params")
    n_ef = len(items) if target_node.ef is not None else 0
    n_leaves = len(items) * len(keys) + n_ef
    found = sum(1 for k in payloads[0].files if k.startswith(f"z{zi}_"))
    if found != n_leaves:
        raise ValueError(
            f"the checkpoint's zero1 node {zi} holds {found} leaves a rank; the target's "
            f"{type(target_node.opt).__name__} with state {keys} over {len(items)} buckets"
            f"{' and residuals' if n_ef else ''} needs {n_leaves}")

    def stacked(j):
        return torch.from_numpy(np.stack([np.asarray(payloads[rows_by_idx[i]][f"z{zi}_{j}"])
                                          for i in range(layout.n_shards)]))

    some = next(iter(next(iter(target_node.shards.values())).values()))
    device = some.device
    state, shards, j = {}, {}, 0
    for g, b in items:
        bl = layout.buckets[g][b]
        shard = target_node.shards[g][b]
        old = dict(target_node.opt.state.get(shard, {}))
        state.setdefault(g, {})[b] = {}
        shards.setdefault(g, {})[b] = torch.zeros((layout.n_shards, bl.k), dtype=shard.dtype)
        for key in keys:
            t = stacked(j)
            j += 1
            if key == "step":
                like = old.get("step")
                t = t.to(torch.float32 if like is None else like.dtype)
                state[g][b][key] = t if like is None else t.to(like.device)
            else:
                state[g][b][key] = t.to(device=device, dtype=shard.dtype)
    ef = None
    if n_ef:
        ef = {}
        for g, b in items:
            ef.setdefault(g, {})[b] = stacked(j).to(device=device, dtype=torch.float32)
            j += 1
    from ..parallel.zero import _hyperparameters

    rows = R.Zero1Rows(shards=shards, state=state, ef=ef, opt_type=type(target_node.opt),
                       hyper=_hyperparameters(target_node.opt))
    if world != layout.n_shards:
        rows, report = R.reshard_zero1_state(rows, world, layout=layout, ef_policy=ef_policy,
                                             trigger="checkpoint", axis=axis)
        logger.info("checkpoint restore resharded zero1 state %d->%d shards (%d bytes moved)",
                    layout.n_shards, world, report["moved_bytes"])
    # The flat parameter shards are the target's: the update copies them
    # from the parameters before every step.
    rows = rows._replace(shards={g: {b: target_node.shards[g][b].detach().unsqueeze(0).expand(
        rows.n_shards, -1) for b in sub} for g, sub in target_node.shards.items()})
    return R.unstack_zero1_states(rows, ranks=[rank])[0]
