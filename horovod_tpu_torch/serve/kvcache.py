"""Paged decode state (the KV cache) of the serving engine.

The counterpart of ``horovod_tpu/serve/kvcache.py``, in two halves:

- :class:`PagePool`, the allocator (pure Python, the reference's copy).
  Fixed-size pages are granted to a request's slot all or nothing, so a
  refused request leaks no page; exhaustion raises
  :class:`PagePoolExhausted`. Page 0 is the scratch page that padded batch
  slots write into, never granted, so padding never touches a live
  request's cache.
- :func:`make_decode_state`, the cache tree: per layer
  ``block_i/attention/cache_k`` and ``cache_v`` tensors of shape
  ``[num_pages, page_size, n_heads, head_dim]`` on one device. The names
  follow the parameter tree's ``block_i/attention/`` so that the rule
  tables place the cache as they place the parameters
  (``parallel/rules.GPT_CACHE_RULES`` shards the head dim over "model"),
  and :func:`preflight_decode_state` checks a cache table against the mesh
  and the tree's whole shapes before a decode step is built.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..common.basics import resolve_device


class PagePoolExhausted(RuntimeError):
    """KV-cache page allocation refused: the pool cannot cover the
    request. The engine keeps the request queued (back-pressure, not
    loss)."""


class PagePool:
    """Fixed-size KV-cache page allocator (pure Python)."""

    #: index of the scratch page padded batch slots write into; never
    #: granted to a request.
    SCRATCH_PAGE = 0

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved scratch "
                f"page), got {num_pages}"
            )
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list, deterministic: page ids descend so the first
        # alloc after construction is [1, 2, ...].
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._owner: Dict[int, Any] = {}

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` cache positions."""
        return max(1, -(-int(tokens) // self.page_size))

    def can_admit(self, tokens: int) -> bool:
        return self.pages_for(tokens) <= self.pages_free

    def alloc(self, tokens: int, owner: Any = None) -> List[int]:
        """Grant the pages for a ``tokens``-position slot, all or
        nothing. Raises :class:`PagePoolExhausted` (pool unchanged) when
        the request cannot be covered."""
        n = self.pages_for(tokens)
        if n > len(self._free):
            raise PagePoolExhausted(
                f"KV-cache pool exhausted: request needs {n} pages "
                f"({tokens} tokens x page_size {self.page_size}) but only "
                f"{len(self._free)}/{self.num_pages - 1} are free"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = owner
        return pages

    def free(self, pages: Sequence[int]) -> None:
        """Return a slot's pages. A double free or a foreign page raises:
        a silent accounting error here would become cross-request cache
        corruption."""
        for p in pages:
            if p not in self._owner:
                raise ValueError(
                    f"page {p} is not allocated (double free or foreign "
                    f"page)"
                )
        for p in pages:
            del self._owner[p]
            self._free.append(p)


def make_decode_state(
    n_layers: int,
    *,
    num_pages: int,
    page_size: int,
    n_heads: int,
    head_dim: int,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> Dict[str, Any]:
    """The paged decode state: per layer, zeroed ``cache_k``/``cache_v`` of
    shape [num_pages, page_size, n_heads, head_dim] in ``dtype`` (bf16 by
    default, the reference's) on ``device`` (None: the card). Under tensor
    parallelism ``n_heads`` is this rank's local head count."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if dtype is None else dtype
    shape = (int(num_pages), int(page_size), int(n_heads), int(head_dim))
    return {
        f"block_{i}": {
            "attention": {
                "cache_k": torch.zeros(shape, dtype=dtype, device=device),
                "cache_v": torch.zeros(shape, dtype=dtype, device=device),
            }
        }
        for i in range(int(n_layers))
    }


def decode_state_specs(cache_rules: Any, cache: Any) -> Any:
    """The spec tree of a decode state from a cache-rule table
    (first match wins, as for the parameters)."""
    from ..parallel.rules import match_partition_rules

    return match_partition_rules(cache_rules, cache)


def preflight_decode_state(cache_rules: Any, mesh: Any, cache: Any) -> None:
    """Check a cache-rule table against the mesh and this rank's cache tree
    before a sharded decode step is built: every leaf matches a rule and
    every axis it names is a mesh axis that divides its dim (the Pass 5
    pre-flight, ``analysis/preflight.check_sharding_rules``, over the whole
    shapes the shards imply; ``CollectiveSafetyError`` otherwise)."""
    from ..analysis.preflight import check_sharding_rules
    from ..parallel import rules as _rules

    shapes = _rules.global_shapes(cache, decode_state_specs(cache_rules, cache), mesh)
    check_sharding_rules(cache_rules, mesh, shapes)
