"""Device mesh: named axes over the ranks of the job.

The counterpart of ``horovod_tpu/parallel/mesh.py``. There a named mesh axis
is a communicator that XLA lowers collectives over; here it is a
``torch.distributed`` process group, one per axis, from
``torch.distributed.device_mesh.init_device_mesh``. :func:`build_mesh`
returns that ``DeviceMesh``: ``mesh.get_group(name)`` is the axis's group
(what the port's collectives take as ``group=``, in place of
``axis_name``), ``mesh.get_local_rank(name)`` this rank's coordinate on it
(``lax.axis_index``) and :func:`axis_size` its size.

Ranks are laid out row-major with the last axis fastest, as
``np.array(devices).reshape(shape)`` lays out devices in the JAX
``build_mesh``: rank r sits at ``np.unravel_index(r, shape)``. So the
hierarchical meshes (:func:`build_hierarchical_mesh`,
:func:`build_three_level_mesh`) put ``rank = cross * local_size + local``,
outer-major, the order every two-level schedule assumes. A tuple of axes
is reduced over by :func:`axis_groups`: the axes' groups, outermost first,
with :func:`flatten_group`'s one group over all of them.

Conventions:
 - ``data`` — the data-parallel axis (Horovod's world communicator).
 - ``local`` / ``cross`` / ``pod`` — the levels of hierarchical ops.
 - ``model`` / ``seq`` / ``expert`` — extension axes for TP/SP/EP.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..common import basics
from ..ops.collectives import AxisGroups, Group

DATA_AXIS = "data"
LOCAL_AXIS = "local"
CROSS_AXIS = "cross"
POD_AXIS = "pod"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"


def parse_axes(spec: str) -> Dict[str, int]:
    """Parse a ``"data:4,model:2"`` style axis spec. ``-1`` means "fill"."""
    axes: Dict[str, int] = {}
    if not spec:
        return axes
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, n = part.split(":", 1)
            axes[name.strip()] = int(n)
        else:
            axes[part] = -1
    return axes


def build_mesh(axes: Optional[Dict[str, int]] = None) -> DeviceMesh:
    """A mesh over every rank of the initialized job with the given named
    axis sizes, in the order given.

    With no spec, a single ``data`` axis spans every rank. At most one axis
    may be ``-1`` (filled with the remaining rank count); the sizes must
    multiply to the world size."""
    ndev = dist.get_world_size()
    axes = dict(axes) if axes else {DATA_AXIS: ndev}
    fill_axes = [k for k, v in axes.items() if v == -1]
    if len(fill_axes) > 1:
        raise ValueError(f"At most one mesh axis may be -1 (fill): {axes}")
    known = math.prod(v for v in axes.values() if v != -1)
    if fill_axes:
        if ndev % known != 0:
            raise ValueError(
                f"Cannot fill axis {fill_axes[0]}: {ndev} devices not divisible "
                f"by {known}"
            )
        axes[fill_axes[0]] = ndev // known
    total = math.prod(axes.values())
    if total != ndev:
        raise ValueError(
            f"Mesh axes {axes} require {total} devices but {ndev} are available"
        )
    return init_device_mesh(basics.device().type, tuple(axes.values()),
                            mesh_dim_names=tuple(axes.keys()))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def data_axis_size(mesh: DeviceMesh) -> int:
    return axis_size(mesh, DATA_AXIS) if DATA_AXIS in mesh.mesh_dim_names else 1


def build_hierarchical_mesh(local_size: int) -> DeviceMesh:
    """Two-level ``(cross, local)`` mesh for the hierarchical collectives:
    ``local`` spans the cards of one node (NVLink) and ``cross`` the nodes,
    the structure of the reference's ``NCCLHierarchicalAllreduce``."""
    n = dist.get_world_size()
    if n % local_size != 0:
        raise ValueError(f"{n} devices not divisible by local_size={local_size}")
    return build_mesh({CROSS_AXIS: n // local_size, LOCAL_AXIS: local_size})


def build_three_level_mesh(pod_size: int, cross_size: int, local_size: int) -> DeviceMesh:
    """Three-level ``(pod, cross, local)`` mesh, ``rank = pod * (cross *
    local) + cross * local + local``."""
    n = dist.get_world_size()
    if n != pod_size * cross_size * local_size:
        raise ValueError(
            f"{n} devices != pod {pod_size} x cross {cross_size} x local {local_size}")
    return build_mesh({POD_AXIS: pod_size, CROSS_AXIS: cross_size, LOCAL_AXIS: local_size})


def hierarchy_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The mesh's hierarchy axis tuple, outermost first; () when the mesh
    has no (cross, local) grid to compose over."""
    names = mesh.mesh_dim_names
    if LOCAL_AXIS not in names or CROSS_AXIS not in names:
        return ()
    return ((POD_AXIS,) if POD_AXIS in names else ()) + (CROSS_AXIS, LOCAL_AXIS)


def flatten_group(mesh: DeviceMesh, axes: Sequence[str]) -> Group:
    """The process group over several mesh axes at once (the group a psum
    over the axis tuple reduces in), whose group rank is the outer-major
    index over ``axes``. Every rank creates every such group of the mesh,
    in one order, the first time any rank asks (group creation is
    collective); the groups are kept on the mesh. A group over every rank
    of the job is the world group."""
    names = list(mesh.mesh_dim_names)
    axes = tuple(axes)
    if any(a not in names for a in axes) or len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes} are not distinct axes of the mesh {tuple(names)}")
    if [a for a in names if a in axes] != list(axes):
        raise ValueError(f"axes {axes} must come in the mesh's order {tuple(names)}")
    cache = mesh.__dict__.setdefault("_hvt_flat_groups", {})
    if axes not in cache:
        if len(axes) == 1:
            cache[axes] = mesh.get_group(axes[0])
        elif math.prod(axis_size(mesh, a) for a in axes) == dist.get_world_size():
            cache[axes] = dist.group.WORLD
        else:
            # Put the flattened axes last: each row is one group, its ranks
            # in outer-major order (ascending, as new_group orders them).
            rest = [i for i, a in enumerate(names) if a not in axes]
            order = rest + [names.index(a) for a in axes]
            rows = mesh.mesh.permute(order).reshape(-1, math.prod(
                axis_size(mesh, a) for a in axes))
            cache[axes], _ = dist.new_subgroups_by_enumeration(rows.tolist())
    return cache[axes]


def axis_groups(mesh: DeviceMesh, axes: Sequence[str]) -> AxisGroups:
    """The groups of ``axes`` (outermost first) with their flattened group:
    the port's form of the JAX axis-name tuple, taken by every ``group=``."""
    axes = tuple(axes)
    return AxisGroups([mesh.get_group(a) for a in axes], flat=flatten_group(mesh, axes))
