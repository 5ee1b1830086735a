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
``build_mesh``: rank r sits at ``np.unravel_index(r, shape)``. The
hierarchical ``cross``/``local``/``pod`` builders are not ported yet.

Conventions:
 - ``data`` — the data-parallel axis (Horovod's world communicator).
 - ``local`` / ``cross`` / ``pod`` — the levels of hierarchical ops.
 - ``model`` / ``seq`` / ``expert`` — extension axes for TP/SP/EP.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..common import basics

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
