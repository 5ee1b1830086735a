"""Process topology: rank, size, local rank and size, cross rank and size.

The counterpart of ``horovod_tpu/common/topology.py``, read in priority
order from:

1. ``HOROVOD_RANK``/``HOROVOD_SIZE``/``HOROVOD_LOCAL_RANK``/
   ``HOROVOD_LOCAL_SIZE``, which hvdrun sets;
2. torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``LOCAL_WORLD_SIZE``;
3. neither: a single-process job, rank 0 of 1.

The cross rank and size come from ``HOROVOD_CROSS_RANK``/
``HOROVOD_CROSS_SIZE`` where they are set, else from ``rank // local_size``
and the number of local groups, as ``horovod_tpu/common/topology.py:63-86``
derives them; the job is homogeneous when ``size == local_size *
cross_size``. The native core's ``hvd_core_init`` takes all three.

The JAX package's TPU slice and megascale discovery has no counterpart
here: on a GPU host the launcher's variables are the whole story.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from . import env as env_mod


@dataclass(frozen=True)
class Topology:
    rank: int
    size: int
    local_rank: int
    local_size: int
    source: str = "single"
    cross_rank: Optional[int] = None
    cross_size: Optional[int] = None
    is_homogeneous: Optional[bool] = None

    def __post_init__(self):
        # Unset cross fields derive from the local ones (rank-major blocks
        # of local_size ranks, one per node).
        if self.cross_rank is None:
            object.__setattr__(self, "cross_rank", self.rank // max(self.local_size, 1))
        if self.cross_size is None:
            object.__setattr__(self, "cross_size",
                               (self.size + self.local_size - 1) // max(self.local_size, 1))
        if self.is_homogeneous is None:
            object.__setattr__(self, "is_homogeneous",
                               self.size == self.local_size * self.cross_size)
        if not (0 <= self.rank < self.size):
            raise ValueError(f"rank {self.rank} out of range for size {self.size}")
        if not (0 <= self.local_rank < self.local_size):
            raise ValueError(
                f"local_rank {self.local_rank} out of range for local_size "
                f"{self.local_size}"
            )


def _from_vars(rank_var: str, size_var: str, local_rank_var: str,
               local_size_var: str, source: str) -> Optional[Topology]:
    rank = os.environ.get(rank_var)
    size = os.environ.get(size_var)
    if rank is None or size is None:
        return None
    cross_rank = os.environ.get(env_mod.HOROVOD_CROSS_RANK)
    cross_size = os.environ.get(env_mod.HOROVOD_CROSS_SIZE)
    return Topology(
        rank=int(rank),
        size=int(size),
        local_rank=int(os.environ.get(local_rank_var, 0)),
        local_size=int(os.environ.get(local_size_var, 1)),
        source=source,
        cross_rank=None if cross_rank is None else int(cross_rank),
        cross_size=None if cross_size is None else int(cross_size),
    )


def detect() -> Topology:
    topo = _from_vars(
        env_mod.HOROVOD_RANK, env_mod.HOROVOD_SIZE,
        env_mod.HOROVOD_LOCAL_RANK, env_mod.HOROVOD_LOCAL_SIZE, "env",
    )
    if topo is None:
        topo = _from_vars(
            "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "torchrun"
        )
    return topo or Topology(rank=0, size=1, local_rank=0, local_size=1)
