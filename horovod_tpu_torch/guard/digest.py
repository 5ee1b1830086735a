"""Parameter-digest agreement: detect silently diverged replicas.

The port of ``horovod_tpu/guard/digest.py``. Replicated data-parallel
state must be bit-identical across ranks between collectives; a flipped
bit in device or host memory, a nondeterministic kernel or a bad rejoin
breaks that silently, and the divergence compounds every step. The
elastic ``State.commit`` hashes each rank's tracked state every
``HOROVOD_GUARD_DIGEST_STEPS`` commits, allgathers the digests (a few
bytes; the payload never moves), and on a mismatch:

- an agreeing STRICT MAJORITY exists: the outlier ranks are healed by a
  re-broadcast from the quorum's reference rank (its lowest member);
- no quorum (a 1-v-1 tie at 2 ranks): ``HOROVOD_GUARD_NO_QUORUM``
  decides, ``rollback`` (default) raises so the elastic layer restores
  the last commit, ``root`` trusts the current sync root's replica.

The digest is SHA-256 over every array leaf's dtype/shape header and raw
bytes, in the order ``jax.tree.leaves`` visits a tree of dicts (sorted
keys), lists, tuples and named tuples, plus a protocol-4 pickle of an
attribute that is not all arrays. The header is numpy's (``str(dtype)``,
``str(shape)``; ``bfloat16`` for a bf16 tensor, as ``ml_dtypes`` names
it), so the same values give the same hex digest here, for torch tensors
on any device or numpy arrays, and in the JAX package.

The rank-local leaves differ from the JAX package's: ``EFState.residual``
(``ops/quantized.py``) and a ``Zero1State``'s shard rows, its sharded
residuals and its inner optimizer's state (``parallel/zero.py``), of which
each rank holds only its own rows. Their bytes are left out and their
layout (dtype and shape headers) is kept, so a rank whose partition
drifted still mismatches.
"""

from __future__ import annotations

import hashlib
import pickle
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def tree_leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order: dicts by sorted
    key, lists and tuples (named tuples too) in order, None has none."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [l for x in tree for l in tree_leaves(x, is_leaf)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable[[Any], Any], tree: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree``, keeping its containers; the leaves
    are visited in :func:`tree_leaves`'s order (dicts by sorted key)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        done = {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return None if tree is None else fn(tree)


def host_array(leaf: Any) -> np.ndarray:
    """A leaf as a contiguous numpy array on the host. A bf16 tensor comes
    back as ``ml_dtypes.bfloat16`` where that package is installed, else
    as the same bits in a uint16 array (:func:`dtype_name` names both
    ``bfloat16``)."""
    import torch

    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            try:
                import ml_dtypes

                return bits.view(ml_dtypes.bfloat16)
            except ImportError:
                return bits
        return t.numpy()
    return np.ascontiguousarray(np.asarray(leaf))


def dtype_name(leaf: Any) -> str:
    """numpy's name of a leaf's dtype (``bfloat16`` for a bf16 tensor)."""
    import torch

    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype) if not hasattr(leaf, "dtype") else str(
        np.dtype(leaf.dtype))


def _shape(leaf: Any) -> Tuple[int, ...]:
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


def _is_rank_local(node: Any) -> bool:
    from ..ops.quantized import EFState
    from ..parallel.zero import Zero1State

    return isinstance(node, (EFState, Zero1State))


def _layout_tokens(node: Any) -> List[str]:
    """The dtype/shape headers of a ``Zero1State``'s tensors: its shard
    rows, its sharded residuals and its inner optimizer's state."""
    import torch

    leaves = tree_leaves(node.shards) + tree_leaves(node.ef)
    for shard in tree_leaves(node.shards):
        for v in sorted(node.opt.state.get(shard, {}).items()):
            if torch.is_tensor(v[1]):
                leaves.append(v[1])
    return [f"{dtype_name(l)}{_shape(l)}" for l in leaves]


def _tp_sharded(spec: Any, shard_axes: Sequence[str]) -> bool:
    from ..parallel.rules import normalize_spec

    norm = normalize_spec(spec) or ()
    want = set(shard_axes)
    return any(bool(want.intersection(e)) for e in norm)


def strip_rank_local(tree: Any, specs: Any = None,
                     shard_axes: Sequence[str] = ("model",)) -> Any:
    """Drop the tracked but RANK-LOCAL parts of ``tree`` before digesting:
    an ``EFState``'s residual (each rank compensates its own quantizer; its
    ``inner`` stays digested) and a ``Zero1State``'s rows, whose bytes
    differ by design and of which only the layout is kept
    (``{"zero1_shard_layout": [...]}``).

    ``specs``, a tree of per-leaf partition specs mirroring ``tree`` (the
    tuple form ``parallel.rules`` uses), marks the leaves sharded over one
    of ``shard_axes`` (tensor parallelism): each model rank holds a
    different shard, so such a leaf is replaced by a layout token. A specs
    tree whose leaf count differs from ``tree``'s raises."""
    if specs is not None:
        leaves = tree_leaves(tree)
        spec_leaves = tree_leaves(specs, is_leaf=lambda x: isinstance(x, tuple)
                                  and not hasattr(x, "_fields"))
        if len(spec_leaves) != len(leaves):
            raise ValueError(
                f"sharding_specs tree has {len(spec_leaves)} leaves but the tracked state "
                f"has {len(leaves)}: stale spec; rebuild it from the live step")
        it = iter(zip(leaves, spec_leaves))

        def tokenize(leaf):
            leaf_, spec = next(it)
            if hasattr(leaf_, "shape") and _tp_sharded(spec, shard_axes):
                return f"tp-shard-layout:{dtype_name(leaf_)}{_shape(leaf_)}:{spec}"
            return leaf_

        tree = tree_map(tokenize, tree)

    def strip(node):
        from ..ops.quantized import EFState

        if isinstance(node, EFState):
            return {"inner": strip_rank_local(node.inner)}
        if _is_rank_local(node):
            return {"zero1_shard_layout": _layout_tokens(node)}
        return node

    return tree_map(strip, tree, is_leaf=_is_rank_local)


def _is_array(leaf: Any) -> bool:
    return hasattr(leaf, "shape") and hasattr(leaf, "dtype")


def tree_digest(tree: Any, _h=None) -> str:
    """SHA-256 hex digest of an array-leaf tree (dtype + shape + raw bytes
    per leaf, in tree order)."""
    h = _h or hashlib.sha256()
    for leaf in tree_leaves(tree):
        arr = host_array(leaf)
        h.update(dtype_name(leaf).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest() if _h is None else ""


def state_digest(state: Any, tracked: Optional[Sequence[str]] = None) -> str:
    """Digest an elastic ``State``'s tracked attributes: array-leaf trees
    hash by raw bytes, everything else by pickle (deterministic for the
    plain counters and containers a state tracks). ``state.sharding_specs``,
    a mapping of tracked attribute to its spec tree, digests the
    tensor-parallel shards by layout only."""
    keys = list(tracked if tracked is not None else getattr(state, "_tracked", []))
    spec_map = getattr(state, "sharding_specs", None) or {}
    h = hashlib.sha256()
    for k in sorted(keys):
        v = strip_rank_local(getattr(state, k, None), specs=spec_map.get(k))
        h.update(k.encode())
        leaves = tree_leaves(v)
        if leaves and all(_is_array(l) for l in leaves):
            tree_digest(v, _h=h)
        else:
            try:
                h.update(pickle.dumps(v, protocol=4))
            except Exception:  # noqa: BLE001 - an unpicklable attribute: hash its repr
                h.update(repr(v).encode())
    return h.hexdigest()


def find_quorum(digests: Sequence[str], *, no_quorum: str = "rollback",
                sync_root: int = 0) -> Tuple[bool, Optional[int], List[int]]:
    """Decide what a set of per-rank digests means: ``(ok, reference_rank,
    outlier_ranks)``.

    - all equal: ``(True, None, [])``;
    - a strict-majority group: ``(False, ref, outliers)``, ``ref`` its
      lowest rank;
    - no strict majority: with ``no_quorum='root'``, ``(False, sync_root,
      ranks disagreeing with it)``; with ``'rollback'``, ``(False, None,
      every rank)``: nothing is trustworthy to heal from."""
    groups: Dict[str, List[int]] = {}
    for r, d in enumerate(digests):
        groups.setdefault(d, []).append(r)
    if len(groups) == 1:
        return True, None, []
    n = len(digests)
    majority = max(groups.values(), key=len)
    if len(majority) * 2 > n:
        return False, min(majority), sorted(set(range(n)) - set(majority))
    if no_quorum == "root" and 0 <= sync_root < n:
        ref_digest = digests[sync_root]
        return False, sync_root, sorted(r for r in range(n) if digests[r] != ref_digest)
    return False, None, list(range(n))
