"""The torch binding's elastic API (upstream ``horovod.torch.elastic``).

The port of ``horovod_tpu/torch/elastic.py``: ``run`` and the state classes
re-exported from :mod:`horovod_tpu_torch.elastic`, and
:class:`ElasticSampler`, a rank-sharding sampler that survives a world
resize without repeating or dropping data within an epoch. It draws its
order with numpy's ``RandomState``, as the reference does, so the same
seed, epoch, rank and size give the same indices in both packages.
"""

from __future__ import annotations

from ..elastic import (  # noqa: F401
    HostsUpdatedInterrupt,
    ObjectState,
    PreemptionInterrupt,
    State,
    TensorState,
    TorchState,
    run,
)

__all__ = [
    "run",
    "State",
    "ObjectState",
    "TensorState",
    "TorchState",
    "ElasticSampler",
    "HostsUpdatedInterrupt",
    "PreemptionInterrupt",
]


def _world() -> tuple:
    from ..common import basics

    if basics.is_initialized():
        return basics.rank(), basics.size()
    return 0, 1


class ElasticSampler:
    """Shards dataset indices over the CURRENT world (``rank()``/``size()``
    are read again at every ``__iter__``, so a re-formed world
    re-partitions) and records processed batches, so a rollback or a
    membership change resumes the epoch where it left off.

    ```python
    sampler = ElasticSampler(len(dataset), shuffle=True)
    loader = DataLoader(dataset, sampler=sampler, batch_size=B)
    state = hvd.elastic.TorchState(model, opt, sampler=sampler, epoch=0)
    # in the loop: sampler.record_batch(batch_idx, B); state.commit()
    # at the epoch's end: sampler.set_epoch(epoch + 1)
    ```

    The instance is picklable, so tracked as a state attribute it gets the
    commit, rollback and sync semantics (a sync unions every rank's
    processed set)."""

    def __init__(self, dataset_size: int, shuffle: bool = True, seed: int = 0):
        self.dataset_size = int(dataset_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.epoch = 0
        self.processed: set = set()
        self._local_order: list = []

    def set_epoch(self, epoch: int) -> None:
        """Start a new epoch: reshuffle and forget the processed indices."""
        self.epoch = int(epoch)
        self.processed.clear()
        self._local_order = []

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        """Mark the ``batch_idx``-th batch of the current order processed
        (after training on it, before ``commit()``)."""
        start = batch_idx * batch_size
        self.processed.update(self._local_order[start:start + batch_size])

    def _remaining(self) -> list:
        import numpy as np

        order = list(range(self.dataset_size))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return [i for i in order if i not in self.processed]

    def __iter__(self):
        r, n = _world()
        remaining = self._remaining()
        # Pad by wrapping so every rank yields the same count (unequal
        # counts would desync the collectives).
        if remaining and len(remaining) % n:
            total = len(remaining) + (n - len(remaining) % n)
            remaining = [remaining[i % len(remaining)] for i in range(total)]
        self._local_order = remaining[r::n]
        return iter(self._local_order)

    def __len__(self) -> int:
        _, n = _world()
        return -(-(self.dataset_size - len(self.processed)) // n)
