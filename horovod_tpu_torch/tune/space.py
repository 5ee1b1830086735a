"""The joint compiled-path knob space the offline tuner searches.

The port's copy of ``horovod_tpu/tune/space.py``, kept whole.

Six dimensions, extending the eager engine's 2-continuous +
3-categorical shape (``cpp/src/autotune.cc`` — the golden-trace test
depends on the kernel treating the shared dims this way):

- ``x0`` — log2(HOROVOD_FUSION_THRESHOLD) in [16, 28], normalized to
  [0, 1] (the same range the eager tuner sweeps);
- ``x1`` — log2(HOROVOD_FUSION_FIRST_BUCKET_BYTES) in [12, 24],
  normalized (the streamed path's DDP-style small first bucket;
  together with x0 this determines the whole ``stream_param_groups``
  partition);
- ``x2``/``x3`` — the per-collective topology-plan choice for the
  gradient allreduce, two {0,1} embeddings encoding
  ``(auto, flat, two-level, split)``;
- ``x4`` — ``wire_dtype`` at thirds: f32 / bf16 / int8 (docs/overlap.md
  "Quantized wire compression"; the bf16 rung is a pure cast, always
  admissible — int8 stays behind ``allow_int8``);
- ``x5`` — the tensor-parallel chunk count for the fused
  collective-matmul path (docs/parallelism.md "Fused TP overlap"):
  ``0`` = the classic exposed psum, then {1, 2, 4, 8} ring chunks.
  Only live when the program declares a TP term (``tp=True``) —
  otherwise frozen at 0 and absent from decoded configs, so DP-only
  tunings keep their exact historical knob dicts.

Categorical dims that the target topology cannot realize (two-level on a
single-hop model, int8 when the caller pins f32, TP chunks without a TP
term) are FROZEN at their default instead of dropped, exactly like the
C++ engine freezes the hierarchical dims when no (cross, local) grid
exists — the space stays 6-D, the candidate grid just never varies them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..common.quant import WIRE_BF16, WIRE_DTYPES, WIRE_F32, WIRE_INT8

# log2 bounds, continuous dims (x0 matches autotune.cc kF0/kF1).
FUSION_LOG2_LO, FUSION_LOG2_HI = 16.0, 28.0
FIRST_LOG2_LO, FIRST_LOG2_HI = 12.0, 24.0

# Topology-plan choice encoded in (x2, x3). "auto" = per-bucket
# select_plan (the planner decides by payload); the rest pin one
# algorithm for every bucket.
TOPO_CHOICES: Tuple[str, ...] = ("auto", "flat", "two-level", "split")

# TP chunk-count choice encoded in x5. 0 = the classic exposed psum
# (no fusion); the rest are the fused collective-matmul ring's chunk
# counts (ops/collective_matmul.py caps at 8 — latency rounds scale
# linearly with chunks, so deeper pipelining stops paying).
TP_CHUNK_CHOICES: Tuple[int, ...] = (0, 1, 2, 4, 8)

# Grid resolution for the continuous dims (the C++ engine's 9x9 EI grid).
GRID_POINTS = 9

DEFAULT_FUSION_BYTES = 64 * 1024 * 1024
DEFAULT_FIRST_BUCKET_BYTES = 1024 * 1024


def _norm(log2v: float, lo: float, hi: float) -> float:
    return (min(max(log2v, lo), hi) - lo) / (hi - lo)


def _denorm_bytes(x: float, lo: float, hi: float) -> int:
    return int(round(2.0 ** (lo + min(max(x, 0.0), 1.0) * (hi - lo))))


@dataclass(frozen=True)
class SearchSpace:
    """The admissible slice of the 6-D space for one target topology.

    ``topo_choices`` lists the realizable plan choices (a single-hop
    model lowers natively whatever the label says, so only "auto" is
    offered there); ``allow_int8`` gates the top wire rung (SUM/AVERAGE
    float gradients only — and the tune-smoke pins it off so the tuned
    step stays bitwise-identical to the untuned one; the bf16 cast rung
    is always admissible); ``tp`` activates the TP chunk-count dim —
    only programs that declare a tensor-parallel term
    (``tune(tp=TPTerm(...))``) have anything for it to price."""

    topo_choices: Tuple[str, ...] = TOPO_CHOICES
    allow_int8: bool = True
    tp: bool = False
    dims: int = field(default=6, init=False)

    def encode(self, config: Dict) -> Tuple[float, ...]:
        import math

        topo = config.get("topo_algorithm") or "auto"
        idx = TOPO_CHOICES.index(topo) if topo in TOPO_CHOICES else 0
        wire = config.get("wire_dtype", WIRE_F32)
        chunks = int(config.get("tp_chunks", 0))
        ci = (TP_CHUNK_CHOICES.index(chunks)
              if chunks in TP_CHUNK_CHOICES else 0)
        return (
            _norm(math.log2(max(int(config["fusion_threshold_bytes"]), 1)),
                  FUSION_LOG2_LO, FUSION_LOG2_HI),
            _norm(math.log2(max(int(config["first_bucket_bytes"]), 1)),
                  FIRST_LOG2_LO, FIRST_LOG2_HI),
            float(idx & 1),
            float((idx >> 1) & 1),
            1.0 if wire == WIRE_INT8 else 0.5 if wire == WIRE_BF16
            else 0.0,
            ci / (len(TP_CHUNK_CHOICES) - 1.0),
        )

    def decode(self, x: Sequence[float]) -> Dict:
        idx = (1 if x[2] > 0.5 else 0) | ((1 if x[3] > 0.5 else 0) << 1)
        topo = TOPO_CHOICES[idx]
        if topo not in self.topo_choices:
            topo = "auto"
        if x[4] > 2.0 / 3.0:
            # Top rung falls back to the cast rung when int8 is pinned
            # off — bf16 is the strongest compression still admissible.
            wire = WIRE_INT8 if self.allow_int8 else WIRE_BF16
        elif x[4] > 1.0 / 3.0:
            wire = WIRE_BF16
        else:
            wire = WIRE_F32
        config = {
            "fusion_threshold_bytes": _denorm_bytes(
                x[0], FUSION_LOG2_LO, FUSION_LOG2_HI),
            "first_bucket_bytes": _denorm_bytes(
                x[1], FIRST_LOG2_LO, FIRST_LOG2_HI),
            "topo_algorithm": topo,
            "wire_dtype": wire,
        }
        if self.tp:
            x5 = float(x[5]) if len(x) > 5 else 0.0
            ci = int(round(
                min(max(x5, 0.0), 1.0) * (len(TP_CHUNK_CHOICES) - 1)
            ))
            config["tp_chunks"] = TP_CHUNK_CHOICES[ci]
        return config

    def default_config(self) -> Dict:
        config = {
            "fusion_threshold_bytes": DEFAULT_FUSION_BYTES,
            "first_bucket_bytes": DEFAULT_FIRST_BUCKET_BYTES,
            "topo_algorithm": "auto",
            "wire_dtype": WIRE_F32,
        }
        if self.tp:
            config["tp_chunks"] = 0
        return config

    def _cat_combos(self) -> List[Tuple[float, float, float, float]]:
        wires = (0.0, 0.5, 1.0) if self.allow_int8 else (0.0, 0.5)
        chunk_xs = (
            tuple(i / (len(TP_CHUNK_CHOICES) - 1.0)
                  for i in range(len(TP_CHUNK_CHOICES)))
            if self.tp else (0.0,)
        )
        combos: List[Tuple[float, float, float, float]] = []
        for idx, name in enumerate(TOPO_CHOICES):
            if name not in self.topo_choices:
                continue
            for wire in wires:
                for cx in chunk_xs:
                    combos.append(
                        (float(idx & 1), float((idx >> 1) & 1), wire, cx)
                    )
        return combos

    def candidate_grid(self) -> List[Tuple[float, ...]]:
        """The deterministic EI candidate grid: GRID_POINTS^2 continuous
        cells x the admissible categorical combinations, in a fixed
        iteration order (grid scan, then categories) so EI ties break
        identically on every run."""
        grid: List[Tuple[float, ...]] = []
        for gi in range(GRID_POINTS):
            for gj in range(GRID_POINTS):
                for cat in self._cat_combos():
                    grid.append((
                        gi / (GRID_POINTS - 1.0),
                        gj / (GRID_POINTS - 1.0),
                    ) + cat)
        return grid

    def validate(self, config: Dict) -> Dict:
        if config.get("wire_dtype", WIRE_F32) not in WIRE_DTYPES:
            raise ValueError(
                f"unknown wire_dtype {config.get('wire_dtype')!r}; one of "
                f"{WIRE_DTYPES}"
            )
        topo = config.get("topo_algorithm") or "auto"
        if topo not in TOPO_CHOICES:
            raise ValueError(
                f"unknown topo_algorithm {topo!r}; one of {TOPO_CHOICES}"
            )
        chunks = int(config.get("tp_chunks", 0))
        if chunks not in TP_CHUNK_CHOICES:
            raise ValueError(
                f"unknown tp_chunks {chunks!r}; one of {TP_CHUNK_CHOICES}"
            )
        return config


def space_for_model(model, allow_int8: bool = True,
                    zero1: bool = False, tp: bool = False) -> SearchSpace:
    """The admissible space for an interconnect model: single-hop models
    freeze the topology dims (every label lowers natively flat there);
    two-level models drop "split" unless the FlexLink conditions
    (exactly two hops) hold. ``zero1=True`` (the streamed-ZeRO-1
    reduction shape) additionally drops "split" everywhere — the
    FlexLink concurrent-bucket mode has no reduce-scatter + all-gather
    decomposition — so the tuner never pins an unrealizable plan for a
    zero1 program. ``tp=True`` (a program with a declared
    tensor-parallel term) unfreezes the TP chunk-count dim."""
    if model.levels <= 1:
        choices: Tuple[str, ...] = ("auto",)
    elif model.levels == 2:
        choices = TOPO_CHOICES
    else:
        choices = ("auto", "flat", "two-level")
    if zero1:
        choices = tuple(c for c in choices if c != "split")
    return SearchSpace(topo_choices=choices, allow_int8=bool(allow_int8),
                       tp=bool(tp))
