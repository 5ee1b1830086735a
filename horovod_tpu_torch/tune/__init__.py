"""The offline autotuner for the compiled path (ROADMAP A13b).

The port of ``horovod_tpu/tune/``. Where the native core's GP/EI engine
(``cpp/src/autotune.cc``) tunes the eager runtime online, this package tunes
the training step's build-time knobs offline:
``python -m horovod_tpu_torch.tools.autotune_compiled`` sweeps the fusion
threshold, the streamed first-bucket size (together: the
``stream_param_groups`` partition), the topology-plan choice and the wire
dtype, scored by free cost models (the structural overlap staircase and the
compositor's alpha-beta pricing) or by measured step time, and freezes the
winner as a ``tuned.json`` keyed by an abstract step signature
(``tune/signature.py``).

Consumption: ``make_train_step(tuned=...)``,
``DistributedOptimizer(tuned=...)`` (or the ``HOROVOD_TUNED_FILE`` knob)
apply the pinned knobs when the live step's signature matches; a mismatch
warns loudly and runs untuned: stale knobs are never applied silently.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Tuple

from .gp import GP, expected_improvement, fit, posterior  # noqa: F401
from .objective import (  # noqa: F401
    ProgramSpec,
    TPTerm,
    free_objectives,
    group_plans,
    plan_for_bucket,
    tp_group_plans,
    tp_term_us,
)
from .signature import (  # noqa: F401
    mesh_axes_hash,
    params_match,
    signature_hash,
    signatures_match,
    step_signature,
)
from .space import SearchSpace, space_for_model  # noqa: F401
from .tuner import (  # noqa: F401
    TunedConfig,
    TuneVerificationError,
    load_tuned,
    save_tuned,
    tune,
)

_logger = logging.getLogger("horovod_tpu_torch")

# Record of the last tuned-config application in this process, the
# compiled-path counterpart of the eager verdict's ``tuned_flags``:
# {"source": "arg"|"file"|"env"|"none", "signature": hash, "matched": bool,
# "where": call site}. Exported as the ``hvd_tuned_info`` gauge and stamped
# into eager plan verdicts by ``core/nccl_executor.py``.
_applied_info: Optional[Dict] = None


def resolve_tuned(tuned: Any) -> Tuple[Optional[TunedConfig], str]:
    """Resolve a ``tuned`` argument to ``(config, source)``:

    - a :class:`TunedConfig` (or its dict) passes through (source ``"arg"``);
    - a path loads the file (source ``"file"``);
    - ``None`` consults ``HOROVOD_TUNED_FILE`` (source ``"env"``);
    - ``False`` (or an unset knob) disables tuning (source ``"none"``).

    Any other type (``True`` among them) raises ``TypeError``. An unreadable
    file raises for an explicit path but only warns for the env knob: a
    stale env var must not brick a job that never asked for tuning in code.
    """
    if tuned is False:
        return None, "none"
    if isinstance(tuned, TunedConfig):
        return tuned, "arg"
    if isinstance(tuned, dict):
        return TunedConfig.from_dict(tuned), "arg"
    if isinstance(tuned, (str, os.PathLike)):
        return load_tuned(os.fspath(tuned)), "file"
    if tuned is not None:
        raise TypeError(
            f"tuned= takes a TunedConfig, a tuned.json path, None, or "
            f"False; got {type(tuned).__name__}"
        )
    from ..common import env as _env

    path = os.environ.get(_env.HOROVOD_TUNED_FILE, "").strip()
    if not path:
        return None, "none"
    try:
        return load_tuned(path), "env"
    except Exception as e:  # noqa: BLE001 - env knob must not brick startup
        _logger.warning(
            "HOROVOD_TUNED_FILE=%s could not be loaded (%r); running "
            "untuned", path, e,
        )
        return None, "none"


def tuned_step_kwargs(cfg: TunedConfig) -> Dict:
    """The ``make_train_step`` knob values a pinned configuration maps to,
    by construction expressible by hand, so a tuned build is bitwise the
    same knobs passed explicitly:

    - ``fusion_threshold_bytes`` / ``first_bucket_bytes`` verbatim;
    - ``wire_dtype`` ``int8`` -> ``quantized=True``;
    - topology: ``flat`` pins the flat lowering, ``two-level``/``split``
      ride ``hierarchical="auto"`` with the algorithm pinned
      (``topo_algorithm=``), ``auto`` leaves per-bucket selection to the
      compositor. On a flat mesh ``"auto"`` is flat, so a pin tuned for a
      hierarchical mesh cannot force an unrealizable lowering (and the
      signature's mesh half keeps it from applying there at all);
    - ``tp_chunks`` (TP-term tunings only) -> ``tp_overlap``: chunks >= 1
      is the fused collective-matmul path, 0 the classic exposed psum; the
      chunk count itself rides ``HOROVOD_TP_OVERLAP_CHUNKS``.
    """
    knobs = cfg.knobs
    topo = knobs.get("topo_algorithm") or "auto"
    if topo == "flat":
        hierarchical: Any = False
        algorithm = None
    elif topo in ("two-level", "split"):
        hierarchical = "auto"
        algorithm = topo
    else:
        hierarchical = "auto"
        algorithm = None
    out = {
        "fusion_threshold_bytes": int(knobs["fusion_threshold_bytes"]),
        "first_bucket_bytes": int(knobs["first_bucket_bytes"]),
        "quantized": knobs.get("wire_dtype") == "int8",
        "hierarchical": hierarchical,
        "topo_algorithm": algorithm,
    }
    if "tp_chunks" in knobs:
        out["tp_overlap"] = int(knobs["tp_chunks"]) > 0
    return out


def note_applied(source: str, signature: str, matched: bool,
                 where: str) -> Dict:
    """Record (and gauge) a tuned-config application."""
    global _applied_info
    _applied_info = {
        "source": str(source),
        "signature": str(signature or "-"),
        "matched": bool(matched),
        "where": str(where),
    }
    try:
        from .. import metrics as _metrics

        if _metrics.ACTIVE:
            _metrics.TAP.set(
                "hvd_tuned_info", 1.0,
                source=_applied_info["source"],
                signature=_applied_info["signature"],
                matched="1" if matched else "0",
                where=_applied_info["where"],
            )
    except Exception:  # noqa: BLE001 - metrics must never block a step build
        pass
    return _applied_info


def applied_tuned_info() -> Optional[Dict]:
    """The last tuned-application record in this process (None before any
    ``tuned=`` / ``HOROVOD_TUNED_FILE`` resolution)."""
    return _applied_info


def current_tuned_source() -> Dict:
    """What the compiled path is tuned from now, for verdict stamping: the
    last application record if one exists, else the env knob's static
    promise, else ``none``."""
    if _applied_info is not None:
        return dict(_applied_info)
    from ..common import env as _env

    path = os.environ.get(_env.HOROVOD_TUNED_FILE, "").strip()
    if not path:
        return {"source": "none", "signature": "-", "matched": False,
                "where": "-"}
    try:
        sig = load_tuned(path).signature_hash
    except Exception:  # noqa: BLE001 - unreadable file still reports "env"
        sig = "-"
    return {"source": "env", "signature": sig, "matched": False,
            "where": "-"}


def warn_signature_mismatch(cfg: TunedConfig, live_hash: str,
                            where: str) -> None:
    _logger.warning(
        "tuned configuration (program %r, signature %s) does NOT match "
        "this step's signature %s at %s — the pinned knobs are stale "
        "for this program/mesh; FALLING BACK to untuned defaults. "
        "Re-run python -m horovod_tpu_torch.tools.autotune_compiled against "
        "the current program to refresh tuned.json.",
        cfg.program or "?", cfg.signature_hash, live_hash, where,
    )


def spec_from_params(name: str, params: Any, mesh: Any = None,
                     model: Any = None) -> ProgramSpec:
    """A :class:`ProgramSpec` (layer granularity + signature) from a module
    or a parameter tree (tensors of any device, ``meta`` included): the
    same top-level children ``stream_param_groups`` streams (sorted keys),
    so the tuner scores exactly the groups the step would stream."""
    from ..ops.fusion import _top_level_children, _tree_bytes, named_tree

    tree = params
    if hasattr(params, "named_parameters"):
        tree = named_tree(list(params.named_parameters()))
    children = _top_level_children(tree)
    if children is None:
        layers = [("params", _tree_bytes(tree))]
    else:
        names = ([str(k) for k in sorted(tree)] if isinstance(tree, dict)
                 else [str(i) for i in range(len(children))])
        layers = [(n, _tree_bytes(c)) for n, c in zip(names, children)]
    return ProgramSpec(
        name=name,
        layers=tuple((n, int(b)) for n, b in layers),
        signature=step_signature(params, mesh=mesh, model=model),
    )
