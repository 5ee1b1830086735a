"""Pass 1: the collective lint over a recorded step.

The port's counterpart of ``horovod_tpu/analysis/jaxpr_lint.py``. A jaxpr
shows every collective a JAX step will issue before it runs; a torch step
has no such graph: its collectives are ``torch.distributed`` calls behind
Python control flow and autograd hooks. So the front end here records the
step as it runs. Every collective the port issues goes through
``ops/collectives.py``, which calls the recorder that :func:`record` puts
in ``collectives.RECORD`` just before it issues the call: the streamed
groups' reductions on autograd's thread, the int8 ring's hops, sequence
parallelism's K/V shifts, the pipeline's sends and receives, the experts'
all-to-alls, the guard's agreement. Each becomes a :class:`CollectiveSite`
with the JAX vocabulary (``psum``, ``all_gather``, ``ppermute``, ...): its
kind, its group mapped back to the mesh axis names it spans (the groups of
every mesh ``parallel.mesh.build_mesh`` made, their flattened tuples, the
world as the caller's mesh's axes, or ``data`` without one), its dtype and
bytes, and for ``ppermute`` the permutation (``send``/``recv`` the pairs of
a point-to-point exchange).

On the recorded sites it checks, as the JAX pass does:

 - every collective's axes exist in the mesh (:data:`RULE_UNKNOWN_AXIS`;
   a group that is no mesh's axis names itself by its ranks and never does);
 - every ``ppermute`` permutation is a complete bijection over its axis,
   and across ranks every send has its receive (:data:`RULE_PPERMUTE`);
 - a fused allreduce bucket (several leaves packed into one buffer,
   ``ops/fusion.py``) stays within the fusion budget
   (:data:`RULE_FUSION_BUDGET`).

:func:`lint_step` runs a step once on every rank of the job (each rank
calls it, as each calls the step), lints this rank's sites, and folds in
the rank-divergence pass (:mod:`.divergence`) over every rank's record and
the guard's skip-agreement rule.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from .findings import (
    Finding,
    RULE_FUSION_BUDGET,
    RULE_PPERMUTE,
    RULE_UNKNOWN_AXIS,
    SEVERITY_ERROR,
    SEVERITY_WARNING,
    apply_suppressions,
)

# The recorded primitives by the JAX package's kinds.
COLLECTIVE_PRIMITIVES = {
    "psum": "allreduce",
    "pmax": "allreduce",
    "pmin": "allreduce",
    "pprod": "allreduce",
    "ppermute": "ppermute",
    "pbroadcast": "broadcast",
    "all_gather": "allgather",
    "all_to_all": "alltoall",
    "reduce_scatter": "reducescatter",
    "send": "p2p",
    "recv": "p2p",
}
# Point-to-point halves: recorded, never agreed over the group (only the
# pair takes part), matched pair by pair across ranks.
P2P = ("send", "recv")
DATA_AXIS = "data"


@dataclass
class CollectiveSite:
    """One collective a recorded step issued on this rank."""

    primitive: str
    kind: str
    axes: Tuple[str, ...]
    params: Dict[str, Any]
    nbytes: int
    dtype: str
    path: str
    axis_sizes: Dict[str, int] = field(default_factory=dict)
    # The group's global ranks, this rank, and the call's index among this
    # rank's calls on the group.
    members: Tuple[int, ...] = ()
    rank: int = 0
    seq: int = 0
    # False when the group's members disagreed about the call, which was
    # then not issued (a rank-divergent program runs to its end).
    issued: bool = True

    @property
    def location(self) -> str:
        return f"graph:{self.path}/{self.primitive}"

    def signature(self) -> str:
        """What the group's members must agree on: the call, its axis, its
        dtype and bytes."""
        return f"{self.primitive}|{','.join(self.axes)}|{self.dtype}|{self.nbytes}"

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CollectiveSite":
        d = dict(d)
        d["axes"], d["members"] = tuple(d["axes"]), tuple(d["members"])
        return cls(**d)


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def mesh_axis_sizes(mesh: Any) -> Dict[str, int]:
    """Name -> size of a ``DeviceMesh`` or a ``{name: size}`` mapping (None:
    no axes)."""
    from ..parallel.rules import mesh_axes

    return {} if mesh is None else mesh_axes(mesh)


class Recorder:
    """The recorder :func:`record` installs: maps each call's group to its
    axes, keeps the sites, and, given ``agree``, lets the call be issued
    only when every member of its group records the same call at the same
    place in its sequence (:class:`StoreAgreement`)."""

    def __init__(self, mesh: Any = None, agree=None, path: str = "step"):
        import torch.distributed as dist

        self._mesh = mesh
        self._agree = agree
        self.path = path
        self.sites: List[CollectiveSite] = []
        self.stream_calls = 0
        self.seam_calls = 0
        self._note: Dict[str, Any] = {}
        self._seq: Dict[Tuple[int, ...], int] = {}
        self._rank = dist.get_rank()
        self._world = tuple(range(dist.get_world_size()))
        self._names: Dict[int, Tuple[str, ...]] = {}
        self.axis_sizes: Dict[str, int] = {}

    def _meshes(self) -> list:
        """The meshes in view: the caller's, or every mesh built in the
        process."""
        from ..parallel.mesh import built_meshes

        if self._mesh is not None and not isinstance(self._mesh, dict):
            return [self._mesh]
        return built_meshes() if self._mesh is None else []

    def _refresh(self) -> None:
        """Name every axis group (and flattened axis tuple) of the meshes
        in view. The world group is the caller's mesh's (a dim or tuple
        whose group it is, else every axis); without one it is ``data``, the
        flat DP step's axis, whatever other meshes the process built (at one
        rank every axis of every mesh is the world)."""
        import torch.distributed as dist

        world = id(dist.group.WORLD)
        explicit = self._mesh is not None
        names: Dict[int, Tuple[str, ...]] = {}
        sizes: Dict[str, int] = {}
        world_axes: Tuple[str, ...] = (DATA_AXIS,)
        if isinstance(self._mesh, dict):
            world_axes = tuple(self._mesh)
        for mesh in self._meshes():
            dims = tuple(mesh.mesh_dim_names)
            sizes.update(mesh_axis_sizes(mesh))
            groups = [(id(mesh.get_group(d)), (d,)) for d in dims]
            groups += [(id(g), tuple(axes))
                       for axes, g in mesh.__dict__.get("_hvt_flat_groups", {}).items()]
            for gid, axes in groups:
                if gid != world or explicit:
                    names.setdefault(gid, axes)
            if explicit:
                world_axes = dims
        if isinstance(self._mesh, dict):
            sizes.update(mesh_axis_sizes(self._mesh))
        if world_axes == (DATA_AXIS,):
            sizes.setdefault(DATA_AXIS, len(self._world))
        names.setdefault(world, world_axes)
        self._names, self.axis_sizes = names, sizes

    def axes_of(self, group) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
        """(the axes ``group`` spans, its global ranks)."""
        import torch.distributed as dist

        group = group if group is not None else dist.group.WORLD
        if id(group) not in self._names:
            self._refresh()
        members = tuple(dist.get_process_group_ranks(group))
        axes = self._names.get(id(group))
        if axes is None:
            axes = ("ranks:" + ",".join(map(str, members)),)
        return axes, members

    def note(self, **params: Any) -> None:
        """Parameters the next recorded site carries (``ops/fusion.py``
        notes a packed bucket's leaf count and its fusion path)."""
        self._note.update(params)

    def __call__(self, primitive: str, x, group, **params: Any) -> bool:
        axes, members = self.axes_of(group)
        note, self._note = self._note, {}
        path = note.pop("path", self.path)
        params.update(note)
        if "perm" in params:
            params["perm"] = [list(p) for p in params["perm"]]
        if "pairs" in params:
            params["pairs"] = [list(p) for p in params["pairs"]]
        seq = self._seq.get(members, 0)
        self._seq[members] = seq + 1
        site = CollectiveSite(
            primitive=primitive, kind=COLLECTIVE_PRIMITIVES[primitive], axes=axes,
            params=params, nbytes=int(x.numel() * x.element_size()), dtype=_dtype_name(x),
            path=path, axis_sizes={a: self.axis_sizes.get(a, 0) for a in axes},
            members=members, rank=self._rank, seq=seq)
        if self._agree is not None and primitive not in P2P:
            site.issued = self._agree(site)
        self.sites.append(site)
        return site.issued

    def groups(self) -> Dict[Tuple[int, ...], int]:
        """The groups this rank issued on, with its count of calls."""
        return dict(self._seq)


class StoreAgreement:
    """Agree each collective over its group's members through a key-value
    store before it is issued. Each member publishes its call's
    :meth:`CollectiveSite.signature` under (group, index); the call is
    issued only when every member published the same one. A member that
    publishes another, or ends its run without that call, makes every
    member skip it, so a rank-divergent program runs to its end on every
    rank instead of hanging, while a program whose ranks agree really
    reduces (the guard's agreed flag converges, as it must)."""

    def __init__(self, store, rank: int, timeout_s: float = 30.0):
        self.store = store
        self.rank = rank
        self.timeout_s = timeout_s

    @staticmethod
    def _gkey(members: Sequence[int]) -> str:
        return ",".join(map(str, members))

    def __call__(self, site: CollectiveSite) -> bool:
        base = f"{self._gkey(site.members)}/{site.seq}"
        sig = site.signature()
        self.store.set(f"{base}/{self.rank}", sig)
        agreed = True
        deadline = time.monotonic() + self.timeout_s
        for peer in site.members:
            if peer == self.rank:
                continue
            key, end = f"{base}/{peer}", f"{self._gkey(site.members)}/end/{peer}"
            while True:
                if self.store.check([key]):
                    agreed &= self.store.get(key).decode() == sig
                    break
                if self.store.check([end]) or time.monotonic() > deadline:
                    agreed = False
                    break
                time.sleep(0.0005)
        return agreed

    def finish(self, groups: Sequence[Sequence[int]]) -> None:
        """Mark this rank's run over on every group it is a member of."""
        for members in groups:
            if self.rank in members:
                self.store.set(f"{self._gkey(members)}/end/{self.rank}", "1")


def _known_groups(rec: Recorder) -> List[Tuple[int, ...]]:
    """Every group in the recorder's view (the meshes' axis groups, the
    world) and every group it recorded a call on."""
    import torch.distributed as dist

    rec._refresh()
    out = {tuple(rec._world)} | set(rec.groups())
    for mesh in rec._meshes():
        for d in mesh.mesh_dim_names:
            out.add(tuple(dist.get_process_group_ranks(mesh.get_group(d))))
        for g in mesh.__dict__.get("_hvt_flat_groups", {}).values():
            out.add(tuple(dist.get_process_group_ranks(g)))
    return sorted(out)


_runs = [0]


@contextlib.contextmanager
def record(mesh: Any = None, *, agree: bool = False, path: str = "step",
           timeout_s: float = 30.0) -> Iterator[Recorder]:
    """Record every collective the port issues inside the block on this
    rank. ``mesh`` names the axes (default: every mesh built in the
    process). With ``agree`` every rank of the job must run the block: each
    collective is first agreed over its group through the job's store
    (:class:`StoreAgreement`), and one the members disagree about is
    recorded but not issued."""
    from ..ops import collectives

    agreement = None
    if agree:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _get_default_store

        _runs[0] += 1
        store = dist.PrefixStore(f"hvd-graph-lint/{_runs[0]}/", _get_default_store())
        agreement = StoreAgreement(store, dist.get_rank(), timeout_s)
    rec = Recorder(mesh, agreement, path)
    prev, collectives.RECORD = collectives.RECORD, rec
    try:
        yield rec
    finally:
        collectives.RECORD = prev
        if agreement is not None:
            agreement.finish(_known_groups(rec))


def collect_collectives(fn, *args: Any, mesh: Any = None, **kwargs: Any) -> List[CollectiveSite]:
    """Run ``fn(*args, **kwargs)`` once under the recorder on this rank;
    every collective it issued, in order."""
    with record(mesh) as rec:
        fn(*args, **kwargs)
    return rec.sites


def inventory(sites: Sequence[CollectiveSite]) -> List[Tuple[str, Tuple[str, ...], str, int]]:
    """The sites as sorted ``(kind, axes, dtype, nbytes)``: what a step
    moves, whatever the order its hooks launched it in."""
    return sorted((s.kind, tuple(s.axes), s.dtype, int(s.nbytes)) for s in sites)


def _check_axes(site: CollectiveSite, known: Dict[str, int]) -> List[Finding]:
    return [Finding(
        rule=RULE_UNKNOWN_AXIS,
        severity=SEVERITY_ERROR,
        message=(f"{site.kind} over axis {axis!r} which is not an axis of the active mesh "
                 f"(known axes: {sorted(known) or 'none'})"),
        location=site.location,
        details={"axis": axis, "known_axes": sorted(known)},
    ) for axis in site.axes if axis not in known]


def _perm_problems(pairs: Sequence[Sequence[int]], n: int) -> List[str]:
    srcs = [int(s) for s, _ in pairs]
    dsts = [int(d) for _, d in pairs]
    problems: List[str] = []
    if len(set(srcs)) != len(srcs):
        problems.append(f"duplicate source ranks {sorted({s for s in srcs if srcs.count(s) > 1})}")
    if len(set(dsts)) != len(dsts):
        problems.append(
            f"duplicate destination ranks {sorted({d for d in dsts if dsts.count(d) > 1})}")
    if n:
        bad = sorted({r for r in srcs + dsts if r < 0 or r >= n})
        if bad:
            problems.append(f"ranks {bad} outside [0, {n})")
    return problems


def _check_ppermute(site: CollectiveSite) -> List[Finding]:
    """A ring's permutation, known whole on every rank: a complete
    bijection over its group."""
    pairs = site.params.get("perm") or []
    n = len(site.members)
    problems = _perm_problems(pairs, n)
    holes = sorted(set(range(n)) - {int(d) for _, d in pairs})
    if holes and not problems:
        problems.append(f"ranks {holes} never receive (hole: the exchange hangs)")
    if not problems:
        return []
    axis = site.axes[0] if site.axes else ""
    return [Finding(
        rule=RULE_PPERMUTE,
        severity=SEVERITY_ERROR,
        message=(f"ppermute over axis {axis!r} (size {n or 'unknown'}) is not a complete "
                 "bijection: " + "; ".join(problems)),
        location=site.location,
        details={"axis": axis, "axis_size": n, "perm": [list(p) for p in pairs]},
    )]


def _check_fusion_budget(site: CollectiveSite, threshold_bytes: Optional[int]) -> List[Finding]:
    leaves = int(site.params.get("fused_leaves", 0))
    if not threshold_bytes or site.kind != "allreduce" or leaves < 2:
        return []
    if site.nbytes <= threshold_bytes:
        return []
    return [Finding(
        rule=RULE_FUSION_BUDGET,
        severity=SEVERITY_WARNING,
        message=(f"fused allreduce bucket is {site.nbytes} bytes, over the {threshold_bytes}-byte "
                 f"fusion-buffer budget ({leaves} leaves concatenated)"),
        location=site.location,
        details={"bucket_bytes": site.nbytes, "threshold_bytes": threshold_bytes,
                 "leaves": leaves},
    )]


def lint_sites(sites: Sequence[CollectiveSite], *, mesh: Any = None,
               fusion_threshold_bytes: Optional[int] = None,
               suppress: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint one rank's recorded sites. With ``mesh`` the sites' axes must
    be its axes; without, the axes of every mesh in view are known."""
    findings: List[Finding] = []
    for site in sites:
        known = mesh_axis_sizes(mesh) if mesh is not None else dict(site.axis_sizes)
        if mesh is None:
            known = {a: n for a, n in known.items() if n}
        findings.extend(_check_axes(site, known))
        if site.primitive == "ppermute":
            findings.extend(_check_ppermute(site))
        findings.extend(_check_fusion_budget(site, fusion_threshold_bytes))
    return apply_suppressions(findings, suppress)


def check_p2p_pairs(traces: Dict[int, Sequence[CollectiveSite]]) -> List[Finding]:
    """Across ranks: every ``send`` of rank s to rank d (of one group) has
    a ``recv`` at d from s of the same bytes, in the same order; an unpaired
    half hangs its exchange (:data:`RULE_PPERMUTE`)."""
    sends: Dict[tuple, List[int]] = {}
    recvs: Dict[tuple, List[int]] = {}
    where: Dict[tuple, CollectiveSite] = {}
    for sites in traces.values():
        for s in sites:
            if s.primitive not in P2P:
                continue
            for src, dst in s.params.get("pairs", []):
                key = (s.members, s.axes, int(src), int(dst))
                (sends if s.primitive == "send" else recvs).setdefault(key, []).append(s.nbytes)
                where.setdefault(key, s)
    findings = []
    for key in sorted(set(sends) | set(recvs)):
        if sends.get(key, []) == recvs.get(key, []):
            continue
        members, axes, src, dst = key
        site = where[key]
        findings.append(Finding(
            rule=RULE_PPERMUTE,
            severity=SEVERITY_ERROR,
            message=(f"point-to-point exchange over axis {axes[0]!r}: rank {src} sends "
                     f"{sends.get(key, [])} bytes to rank {dst}, which receives "
                     f"{recvs.get(key, [])} from it: an unpaired half hangs the exchange"),
            location=site.location,
            details={"axis": axes[0], "src": src, "dst": dst,
                     "sends": sends.get(key, []), "recvs": recvs.get(key, [])},
        ))
    return findings


def gather_traces(sites: Sequence[CollectiveSite]) -> Dict[int, List[CollectiveSite]]:
    """Every rank's recorded sites (a collective over the job: every rank
    calls it)."""
    import torch.distributed as dist

    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, json.dumps([s.to_dict() for s in sites]))
    return {r: [CollectiveSite.from_dict(d) for d in json.loads(doc)]
            for r, doc in enumerate(out)}


def lint_step(fn, *args: Any, mesh: Any = None, fusion_threshold_bytes: Optional[int] = None,
              divergence: bool = True, suppress: Optional[Sequence[str]] = None,
              nonfinite: Optional[str] = None, **kwargs: Any) -> List[Finding]:
    """Run ``fn(*args, **kwargs)`` once under the recorder and lint it.
    Every rank of the job calls it, as every rank calls the step. Folds in
    the rank-divergence pass over every rank's record (``divergence=False``
    opts out; with it, each collective is agreed over its group first, so a
    divergent step does not hang), the pairing of point-to-point halves,
    and the guard's skip-agreement rule: a step that streamed its reduction
    under the ``skip`` policy (``nonfinite``, None reads
    HOROVOD_GUARD_NONFINITE) without the agreement collective
    (``guard/nonfinite.agree_flag``). ``suppress`` filters the findings
    at this call site."""
    from .preflight import check_guard_skip_agreement

    with record(mesh, agree=divergence) as rec:
        fn(*args, **kwargs)
    findings = lint_sites(rec.sites, mesh=mesh, fusion_threshold_bytes=fusion_threshold_bytes)
    if divergence:
        from .divergence import analyze_divergence

        traces = gather_traces(rec.sites)
        findings.extend(analyze_divergence(traces))
        findings.extend(check_p2p_pairs(traces))
    findings.extend(check_guard_skip_agreement(rec.stream_calls, rec.seam_calls, nonfinite))
    return apply_suppressions(findings, suppress)
