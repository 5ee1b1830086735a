"""Machine-readable interconnect model.

The port of ``horovod_tpu/topo/model.py``. The hierarchy is data: an
ordered list of :class:`Hop` entries, outermost (slowest) first and
innermost (fastest) last, each carrying the mesh axis it rides, the rank
count along it and an alpha-beta cost entry (latency a round, bandwidth a
rank). The compositor (``topo/compositor.py``) prices its candidate
lowerings against this table.

**The hop names are the JAX package's**: ``ici``, ``dcn`` and ``dcn-pod``
stay the data keys, because they are the ``HOROVOD_TOPOLOGY_MODEL`` schema,
the ``hop`` label of the metrics and the calibration signature. On the
card, ``ici`` is the NVLink/NVSwitch level inside a node (the ``local``
axis) and ``dcn`` the network across nodes (the ``cross`` axis);
``dcn-pod`` is a third level across groups of nodes (``pod``).

Construction sources, in priority order:

1. ``HOROVOD_TOPOLOGY_MODEL``: a JSON file path or an inline JSON object.
   A ``{"hops": [...]}`` document replaces the model; a
   ``{"<hop-name>": {"bandwidth_gbps": ...}}`` object patches the cost
   entries of the named hops.
2. The detected process topology (``common/topology.py``): LOCAL maps to
   one ``ici`` hop, CROSS to one ``dcn`` hop. A layout that is not a
   homogeneous grid gives a flat, ineligible model, so no lowering ever
   puts a "local" stage on the network.
3. Per-generation defaults (``GENERATION_DEFAULTS``). They rank hops
   against each other, which is all plan selection needs; they are not a
   benchmark. The TPU entries are the JAX package's, so the port's plans
   equal its plans on the CPU; ``h100`` is the card's entry, each constant
   with its source.

Building a model and selecting plans touches no device: ``tools/topo_plan``
runs anywhere.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..common import env as _env
from ..common.topology import Topology

# Canonical hop names (free-form in overrides, but the defaults and the
# mesh wiring use these).
ICI = "ici"
DCN = "dcn"
POD_DCN = "dcn-pod"

# Mesh axis each canonical hop rides (parallel/mesh.py axis names).
_HOP_AXES = {ICI: "local", DCN: "cross", POD_DCN: "pod"}

# {generation: {hop: (bandwidth_gbps, latency_us)}}, gigaBYTES/s a rank and
# microseconds a round.
GENERATION_DEFAULTS: Dict[str, Dict[str, Tuple[float, float]]] = {
    # The JAX package's TPU rows, unchanged: coarse per-chip aggregates from
    # public specs (ICI), a per-chip share of a 200 Gbps host NIC (DCN).
    "v3": {ICI: (70.0, 1.0), DCN: (12.5, 50.0), POD_DCN: (6.25, 200.0)},
    "v4": {ICI: (300.0, 1.0), DCN: (12.5, 50.0), POD_DCN: (6.25, 200.0)},
    "v5e": {ICI: (200.0, 1.0), DCN: (12.5, 50.0), POD_DCN: (6.25, 200.0)},
    "v5p": {ICI: (600.0, 1.0), DCN: (25.0, 50.0), POD_DCN: (6.25, 200.0)},
    "v6e": {ICI: (448.0, 1.0), DCN: (25.0, 50.0), POD_DCN: (6.25, 200.0)},
    # NVIDIA H100 SXM in a DGX/HGX H100 node.
    "h100": {
        # Fitted by `python -m horovod_tpu_torch.tools.topo_parity --ranks 4`
        # on four H100 80GB HBM3 of one node at 700 W: NCCL's all_reduce over
        # NVLink, 1 KiB-64 MiB, through sim.calibrate.fit_calibration: 386.7
        # GB/s of ring wire bytes a rank, 10.9 us a round (PERF.md records it).
        # The datasheet's NVLink 4 figure is 900 GB/s bidirectional, 450 a
        # direction (https://www.nvidia.com/en-us/data-center/h100/).
        ICI: (386.7, 10.9),
        # bandwidth: one 400 Gb/s NDR ConnectX-7 port a GPU, 50 GB/s (DGX
        # H100 User Guide, https://docs.nvidia.com/dgx/dgxh100-user-guide/
        # introduction-to-dgxh100.html). latency: an ordering assumption,
        # above the NVLink hop's; no run on one node can measure it.
        DCN: (50.0, 20.0),
        # bandwidth: the same NDR port (no faster path leaves the node).
        # latency: an ordering assumption, above the dcn hop's.
        POD_DCN: (50.0, 80.0),
    },
    # CPU test clusters and unknown hardware: keep the ici >> dcn ordering
    # so plan shapes match what a real cluster would select.
    "generic": {ICI: (50.0, 2.0), DCN: (5.0, 100.0), POD_DCN: (2.5, 400.0)},
}


@dataclass(frozen=True)
class Hop:
    """One interconnect level: ``size`` ranks reachable over this hop,
    riding mesh axis ``axis``, at ``bandwidth_gbps`` gigaBYTES/s a rank
    with ``latency_us`` a communication round."""

    name: str
    axis: str
    size: int
    bandwidth_gbps: float
    latency_us: float

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"hop {self.name!r}: size must be >= 1")
        if self.bandwidth_gbps <= 0 or self.latency_us < 0:
            raise ValueError(f"hop {self.name!r}: bandwidth must be > 0 and latency >= 0")

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "axis": self.axis,
            "size": self.size,
            "bandwidth_gbps": self.bandwidth_gbps,
            "latency_us": self.latency_us,
        }

    @staticmethod
    def from_dict(d: dict) -> "Hop":
        return Hop(
            name=str(d["name"]),
            axis=str(d.get("axis", d["name"])),
            size=int(d["size"]),
            bandwidth_gbps=float(d["bandwidth_gbps"]),
            latency_us=float(d["latency_us"]),
        )


@dataclass(frozen=True)
class InterconnectModel:
    """Ordered hop list, outermost (slowest) first. One hop is a flat
    topology: the compositor then considers single-level algorithms only.
    ``eligible`` is the hierarchical-safety gate (a homogeneous grid larger
    than 1 x 1)."""

    hops: Tuple[Hop, ...]
    generation: str = "generic"
    eligible: bool = False
    source: str = "synthetic"

    def __post_init__(self):
        if not self.hops:
            raise ValueError("an interconnect model needs at least one hop")

    @property
    def size(self) -> int:
        n = 1
        for h in self.hops:
            n *= h.size
        return n

    @property
    def levels(self) -> int:
        return len(self.hops)

    @property
    def inner(self) -> Hop:
        return self.hops[-1]

    @property
    def axes(self) -> Tuple[str, ...]:
        """Mesh axis names, outermost first."""
        return tuple(h.axis for h in self.hops)

    def hop(self, name: str) -> Hop:
        for h in self.hops:
            if h.name == name:
                return h
        raise KeyError(f"no hop named {name!r} in {self.axes}")

    def to_dict(self) -> dict:
        return {
            "generation": self.generation,
            "eligible": self.eligible,
            "source": self.source,
            "size": self.size,
            "hops": [h.to_dict() for h in self.hops],
        }

    def to_json(self) -> str:
        """Stable serialization (sorted keys, no timestamps)."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=1)

    @staticmethod
    def from_dict(d: dict) -> "InterconnectModel":
        return InterconnectModel(
            hops=tuple(Hop.from_dict(h) for h in d["hops"]),
            generation=str(d.get("generation", "generic")),
            eligible=bool(d.get("eligible", len(d["hops"]) > 1)),
            source=str(d.get("source", "json")),
        )


def detect_generation() -> str:
    """The accelerator generation: a TPU type from ``TPU_ACCELERATOR_TYPE``
    or ``TPU_TYPE`` (e.g. "v5litepod-16", "v4-32"), as the JAX package reads
    it; else ``h100`` where CUDA is available and the first card's name
    contains "H100"; else "generic" (the CPU)."""
    raw = (os.environ.get("TPU_ACCELERATOR_TYPE", "")
           or os.environ.get("TPU_TYPE", "")).strip().lower()
    for gen in ("v6e", "v5p", "v5e", "v5lite", "v4", "v3"):
        if raw.startswith(gen):
            return "v5e" if gen == "v5lite" else gen
    import torch

    if torch.cuda.is_available() and "H100" in torch.cuda.get_device_name(0).upper():
        return "h100"
    return "generic"


def _costs(generation: str) -> Dict[str, Tuple[float, float]]:
    return GENERATION_DEFAULTS.get(generation, GENERATION_DEFAULTS["generic"])


def _mk_hop(name: str, size: int, generation: str, axis: Optional[str] = None) -> Hop:
    bw, lat = _costs(generation).get(name, _costs(generation).get(DCN, (5.0, 100.0)))
    return Hop(name=name, axis=axis or _HOP_AXES.get(name, name), size=size,
               bandwidth_gbps=bw, latency_us=lat)


def synthetic_model(local: int, cross: int = 1, pod: int = 1, generation: str = "generic",
                    eligible: Optional[bool] = None) -> InterconnectModel:
    """A hand-built model for tools and tests: (pod, cross, local) sizes
    with the generation's default costs. Levels of size 1 outside the
    innermost are dropped, so ``synthetic_model(8)`` is one flat hop."""
    hops: List[Hop] = []
    if pod > 1:
        hops.append(_mk_hop(POD_DCN, pod, generation))
    if cross > 1:
        hops.append(_mk_hop(DCN, cross, generation))
    hops.append(_mk_hop(ICI, max(int(local), 1), generation))
    if eligible is None:
        eligible = len(hops) > 1
    return InterconnectModel(hops=tuple(hops), generation=generation, eligible=eligible,
                             source="synthetic")


def model_from_topology(topology: Topology,
                        generation: Optional[str] = None) -> InterconnectModel:
    """The detected deployment's model: LOCAL -> one ``ici`` hop, CROSS ->
    one ``dcn`` hop. A layout that is not a homogeneous local > 1 x cross >
    1 grid collapses to one flat, ineligible hop: the executor's (cross,
    local) groups assume ``rank = cross_rank * local_size + local_rank``,
    and a hierarchical lowering over another layout would put local stages
    on the network."""
    generation = generation or detect_generation()
    grid = (topology.is_homogeneous and topology.local_size > 1 and topology.cross_size > 1
            and topology.local_size * topology.cross_size == topology.size)
    if grid:
        return InterconnectModel(
            hops=(_mk_hop(DCN, topology.cross_size, generation),
                  _mk_hop(ICI, topology.local_size, generation)),
            generation=generation, eligible=True, source="topology")
    return InterconnectModel(hops=(_mk_hop(ICI, max(topology.size, 1), generation),),
                             generation=generation, eligible=False, source="topology")


def model_from_mesh_shape(axis_sizes: Dict[str, int],
                          generation: Optional[str] = None) -> InterconnectModel:
    """The model of a hierarchical mesh the caller built on purpose
    ({axis: size}): its (pod, cross, local) axes make it eligible, since the
    homogeneity gate applies to detected process topologies, not to a
    deliberate mesh."""
    generation = generation or detect_generation()
    hops: List[Hop] = []
    pod = int(axis_sizes.get("pod", 1))
    cross = int(axis_sizes.get("cross", 1))
    local = int(axis_sizes.get("local", 1))
    if pod > 1:
        hops.append(_mk_hop(POD_DCN, pod, generation))
    if cross > 1:
        hops.append(_mk_hop(DCN, cross, generation))
    hops.append(_mk_hop(ICI, local, generation))
    return InterconnectModel(hops=tuple(hops), generation=generation,
                             eligible=len(hops) > 1 and local > 1, source="mesh")


def _load_override() -> Optional[dict]:
    raw = os.environ.get(_env.HOROVOD_TOPOLOGY_MODEL, "").strip()
    if not raw:
        return None
    if raw.startswith("{"):
        return json.loads(raw)
    with open(raw) as f:
        return json.load(f)


def apply_override(model: InterconnectModel) -> InterconnectModel:
    """Apply ``HOROVOD_TOPOLOGY_MODEL``: a document with a "hops" list
    replaces the model; otherwise each top-level key names a hop whose cost
    fields its dict patches (an unknown hop name raises: a mistyped
    override that did nothing would be worse)."""
    doc = _load_override()
    if doc is None:
        return model
    if "hops" in doc:
        return InterconnectModel.from_dict(doc)
    names = {h.name for h in model.hops}
    unknown = [k for k in doc if k not in names]
    if unknown:
        raise ValueError(f"{_env.HOROVOD_TOPOLOGY_MODEL} overrides unknown hop(s) {unknown}; "
                         f"this model has {sorted(names)}")
    patched = []
    for h in model.hops:
        patch = doc.get(h.name, {})
        patched.append(Hop(
            name=h.name,
            axis=str(patch.get("axis", h.axis)),
            size=int(patch.get("size", h.size)),
            bandwidth_gbps=float(patch.get("bandwidth_gbps", h.bandwidth_gbps)),
            latency_us=float(patch.get("latency_us", h.latency_us)),
        ))
    return InterconnectModel(hops=tuple(patched), generation=model.generation,
                             eligible=model.eligible, source=model.source + "+override")


def resolve_model(topology: Optional[Topology] = None) -> InterconnectModel:
    """The model the runtime uses: the detected topology (or the given one)
    with the override applied."""
    if topology is None:
        from ..common import topology as _topo_mod

        topology = _topo_mod.detect()
    return apply_override(model_from_topology(topology))
