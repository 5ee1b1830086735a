"""Calibration: fit per-hop alpha-beta constants from measured traces.

The port of ``horovod_tpu/sim/calibrate.py``.

The FlexLink lesson (PAPERS.md, arXiv:2510.15882): *measure links, don't
assume them*. The interconnect model ships coarse per-generation
defaults that only need to RANK hops for plan selection — but the fleet
simulator and the tuner's pricing are only evidence when the constants
come from observation. This module closes that loop:

- :func:`fit_calibration` consumes the machine-readable per-rank stats
  summary ``python -m horovod_tpu_torch.tools.trace_merge --stats``
  emits from merged trace windows and least-squares fits, per hop, ``duration_us =
  latency_us * rounds + bytes / (bandwidth_gbps * 1e3)`` over the
  per-collective (bytes, rounds, duration) samples the trace carries
  (``hvd_collective_stage`` spans name their hop exactly; eager
  ``hvd_response`` / native ``hvd_plan`` spans carry bytes and are
  attributed to the model's bottleneck hop, recorded as such).
- The result persists as a signature-keyed ``calibration.json`` —
  the signature is the interconnect model's (hop name, size) ladder,
  and :func:`apply_calibration` follows the tuned-config staleness
  discipline: a calibration fitted for a different ladder warns loudly
  ("FALLING BACK") and leaves the generation defaults in place, never
  silently applies stale constants.
- :func:`divergence_report` compares a simulated run against measured
  per-hop time and publishes ``hvd_sim_divergence_ratio{hop}`` so a
  drifting model is an alert, not a quiet lie.
"""

from __future__ import annotations

import hashlib
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..topo.model import Hop, InterconnectModel

logger = logging.getLogger("horovod_tpu_torch.sim")

CALIBRATION_VERSION = 1

# Least-squares guards: a fitted bandwidth must stay positive and a
# fitted latency non-negative; degenerate sample sets fall back to the
# ratio estimator (total bytes / total seconds).
_MIN_BANDWIDTH_GBPS = 1e-6


def model_signature(model: InterconnectModel) -> Dict:
    """The staleness key a calibration is valid for: the ordered hop
    NAME ladder plus generation — the identity of the links, NOT their
    sizes (alpha-beta constants are per-link properties, so an ICI
    measurement at 8 ranks prices the ICI hop at 4096) and NOT the cost
    constants (those are what calibration replaces)."""
    sig = {
        "version": CALIBRATION_VERSION,
        "hops": [h.name for h in model.hops],
        "generation": model.generation,
    }
    sig["hash"] = signature_hash(sig)
    return sig


def signature_hash(sig: Dict) -> str:
    body = {k: v for k, v in sig.items() if k != "hash"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclass
class Calibration:
    """Fitted per-hop constants plus the evidence they came from."""

    signature: Dict
    hops: Dict[str, Dict]  # name -> {latency_us, bandwidth_gbps, ...}
    source: str = "fit"
    meta: Dict = field(default_factory=dict)
    version: int = CALIBRATION_VERSION

    def to_dict(self) -> Dict:
        return {
            "version": self.version,
            "signature": dict(self.signature),
            "hops": {k: dict(v) for k, v in sorted(self.hops.items())},
            "source": self.source,
            "meta": dict(self.meta),
        }

    def to_json(self) -> str:
        """Stable serialization (sorted keys, no timestamps) — two fits
        from the same stats diff byte-for-byte."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=1) + "\n"

    @staticmethod
    def from_dict(d: Dict) -> "Calibration":
        return Calibration(
            signature=dict(d.get("signature", {})),
            hops={str(k): dict(v) for k, v in d.get("hops", {}).items()},
            source=str(d.get("source", "fit")),
            meta=dict(d.get("meta", {})),
            version=int(d.get("version", CALIBRATION_VERSION)),
        )

    @property
    def signature_hash(self) -> str:
        h = self.signature.get("hash")
        return str(h) if h else signature_hash(self.signature)


def save_calibration(calib: Calibration, path: str) -> str:
    with open(path, "w") as f:
        f.write(calib.to_json())
    return path


def load_calibration(path: str) -> Calibration:
    with open(path) as f:
        return Calibration.from_dict(json.load(f))


# ----------------------------------------------------------------- fit


def _collect_samples(
    stats: Dict, model: InterconnectModel
) -> Tuple[Dict[str, List[Tuple[float, float, float]]], Dict[str, int]]:
    """Per-hop (bytes, rounds, duration_us) samples from a stats doc.

    ``hvd_collective_stage`` spans (simulated or future native traces)
    name their hop and rounds exactly. ``hvd_response`` / ``hvd_plan``
    spans carry only total bytes; they are attributed to the model's
    bottleneck hop with flat-ring rounds — the attribution counts are
    returned so the calibration records how much of its evidence was
    attributed rather than measured per-hop."""
    hop_names = {h.name for h in model.hops}
    bottleneck = min(model.hops, key=lambda h: h.bandwidth_gbps)
    n = model.size
    ring_rounds = max(2 * (n - 1), 1)
    samples: Dict[str, List[Tuple[float, float, float]]] = {}
    attributed: Dict[str, int] = {}
    for r in sorted(stats.get("ranks", {})):
        for c in stats["ranks"][r].get("collectives", []):
            dur_us = float(c.get("dur_s", 0.0)) * 1e6
            if dur_us <= 0.0:
                continue
            nbytes = float(c.get("nbytes", 0) or 0)
            hop = c.get("hop")
            if hop in hop_names:
                rounds = float(c.get("rounds", 1) or 1)
                samples.setdefault(hop, []).append(
                    (nbytes, rounds, dur_us)
                )
            elif nbytes > 0:
                samples.setdefault(bottleneck.name, []).append(
                    (nbytes * 2 * (n - 1) / max(n, 1), ring_rounds,
                     dur_us)
                )
                attributed[bottleneck.name] = (
                    attributed.get(bottleneck.name, 0) + 1
                )
    return samples, attributed


def _fit_hop(
    samples: List[Tuple[float, float, float]]
) -> Optional[Tuple[float, float]]:
    """Least-squares ``dur = alpha * rounds + beta * bytes`` →
    (latency_us, bandwidth_gbps). Pure python 2x2 normal equations;
    degenerate systems fall back to the ratio estimator (alpha = 0)."""
    if not samples:
        return None
    srr = srb = sbb = srd = sbd = 0.0
    for b, r, d in samples:
        srr += r * r
        srb += r * b
        sbb += b * b
        srd += r * d
        sbd += b * d
    det = srr * sbb - srb * srb
    alpha = beta = None
    if det > 1e-12 * max(srr * sbb, 1.0):
        alpha = (srd * sbb - sbd * srb) / det
        beta = (srr * sbd - srb * srd) / det
    if (
        alpha is None or beta is None
        or beta <= 0.0 or alpha < 0.0
    ):
        # Ratio fallback: all time charged to bandwidth.
        total_b = sum(b for b, _, _ in samples)
        total_d = sum(d for _, _, d in samples)
        if total_b <= 0.0 or total_d <= 0.0:
            return None
        alpha, beta = 0.0, total_d / total_b
    bw = 1.0 / (beta * 1e3)  # us/byte -> GB/s
    return max(alpha, 0.0), max(bw, _MIN_BANDWIDTH_GBPS)


def fit_calibration(
    stats: Dict, model: InterconnectModel, source: str = "fit"
) -> Calibration:
    """Fit per-hop constants for ``model``'s ladder from a
    ``trace_merge --stats`` document. Hops the trace never exercised
    keep their generation defaults and are marked ``calibrated:
    false`` — a calibration never pretends to know a link it never
    saw."""
    samples, attributed = _collect_samples(stats, model)
    hops: Dict[str, Dict] = {}
    for h in model.hops:
        fit = _fit_hop(samples.get(h.name, []))
        if fit is None:
            hops[h.name] = {
                "calibrated": False,
                "latency_us": round(h.latency_us, 6),
                "bandwidth_gbps": round(h.bandwidth_gbps, 6),
                "samples": 0,
                "note": "no samples on this hop; generation default",
            }
            continue
        alpha, bw = fit
        residual = 0.0
        pts = samples[h.name]
        for b, r, d in pts:
            pred = alpha * r + b / (bw * 1e3)
            residual += abs(pred - d)
        hops[h.name] = {
            "calibrated": True,
            "latency_us": round(alpha, 6),
            "bandwidth_gbps": round(bw, 6),
            "samples": len(pts),
            "attributed_samples": int(attributed.get(h.name, 0)),
            "mean_abs_residual_us": round(residual / len(pts), 4),
        }
    return Calibration(
        signature=model_signature(model),
        hops=hops,
        source=source,
        meta={
            "schema_version": int(stats.get("schema_version", 0)),
            "world_size": int(stats.get("world_size", 0)),
            # Provenance only — NOT part of the staleness key (per-link
            # constants transfer across rank counts of the same fabric).
            "fitted_hop_sizes": [
                [h.name, int(h.size)] for h in model.hops
            ],
        },
    )


# --------------------------------------------------------------- apply


def apply_calibration(
    model: InterconnectModel,
    calib: Optional[Calibration],
    where: str = "sim",
    strict: bool = False,
) -> InterconnectModel:
    """Patch ``model``'s cost entries with calibrated constants when the
    signature matches; on a mismatch warn loudly and return the model
    UNCHANGED (``strict=True`` raises instead) — the tuned-config
    staleness discipline: stale constants are never applied silently."""
    if calib is None:
        return model
    live = model_signature(model)
    if calib.signature_hash != live["hash"]:
        msg = (
            f"calibration (signature {calib.signature_hash}, hops "
            f"{calib.signature.get('hops')}) does NOT match this "
            f"model's ladder {live['hops']} (signature {live['hash']}) "
            f"at {where} — FALLING BACK to generation-default "
            "constants. Re-fit with python -m "
            "horovod_tpu_torch.tools.fleet_sim --calibrate "
            "against a trace from this topology."
        )
        if strict:
            raise ValueError(msg)
        logger.warning(msg)
        return model
    patched = []
    for h in model.hops:
        entry = calib.hops.get(h.name)
        if not entry or not entry.get("calibrated"):
            patched.append(h)
            continue
        patched.append(Hop(
            name=h.name, axis=h.axis, size=h.size,
            bandwidth_gbps=float(entry["bandwidth_gbps"]),
            latency_us=float(entry["latency_us"]),
        ))
    return InterconnectModel(
        hops=tuple(patched), generation=model.generation,
        eligible=model.eligible, source=model.source + "+calibrated",
    )


def resolve_calibration(calibration: Any) -> Optional[Calibration]:
    """Resolve a ``calibration`` argument: a :class:`Calibration` or
    dict passes through, a path string loads the file, ``None``
    consults ``HOROVOD_CALIBRATION_FILE`` (unreadable env files warn
    instead of raising — the ``resolve_tuned`` contract)."""
    import os

    if isinstance(calibration, Calibration):
        return calibration
    if isinstance(calibration, dict):
        return Calibration.from_dict(calibration)
    if isinstance(calibration, (str, os.PathLike)):
        return load_calibration(os.fspath(calibration))
    if calibration is not None and calibration is not False:
        raise TypeError(
            "calibration= takes a Calibration, a calibration.json "
            f"path, a dict, or None; got {type(calibration).__name__}"
        )
    if calibration is False:
        return None
    from ..common import env as _env

    path = os.environ.get(_env.HOROVOD_CALIBRATION_FILE, "").strip()
    if not path:
        return None
    try:
        return load_calibration(path)
    except Exception as e:  # noqa: BLE001 - env knob must not brick startup
        logger.warning(
            "HOROVOD_CALIBRATION_FILE=%s could not be loaded (%r); "
            "running on generation defaults", path, e,
        )
        return None


# ---------------------------------------------------------- divergence


def divergence_report(
    modeled_per_hop_us: Dict[str, float],
    measured_per_hop_us: Dict[str, float],
    *,
    modeled_step_us: float = 0.0,
    measured_step_us: float = 0.0,
    attribution: str = "per-hop",
) -> Dict:
    """Per-hop model-vs-measured divergence: ratio > 1 means the model
    is pessimistic (predicts more time than observed), < 1 optimistic.
    Published as ``hvd_sim_divergence_ratio{hop}`` (plus the ``step``
    scope) when metrics are armed; hops with no measured time report an
    honest ``null`` instead of a fake 1.0."""
    from .. import metrics as _metrics

    per_hop: Dict[str, Any] = {}
    for hop in sorted(set(modeled_per_hop_us) | set(measured_per_hop_us)):
        modeled = float(modeled_per_hop_us.get(hop, 0.0))
        measured = float(measured_per_hop_us.get(hop, 0.0))
        ratio = (modeled / measured) if measured > 0.0 else None
        per_hop[hop] = {
            "modeled_us": round(modeled, 4),
            "measured_us": round(measured, 4),
            "ratio": None if ratio is None else round(ratio, 6),
        }
        if _metrics.ACTIVE and ratio is not None:
            _metrics.TAP.set(
                "hvd_sim_divergence_ratio", float(ratio), hop=hop
            )
    step_ratio = (
        modeled_step_us / measured_step_us
        if measured_step_us > 0.0 else None
    )
    if _metrics.ACTIVE and step_ratio is not None:
        _metrics.TAP.set(
            "hvd_sim_divergence_ratio", float(step_ratio), hop="step"
        )
    return {
        "attribution": attribution,
        "per_hop": per_hop,
        "step": {
            "modeled_us": round(float(modeled_step_us), 4),
            "measured_us": round(float(measured_step_us), 4),
            "ratio": (
                None if step_ratio is None else round(step_ratio, 6)
            ),
        },
    }


def measured_from_stats(
    stats: Dict, model: InterconnectModel
) -> Dict:
    """Extract the measured quantities a replay compares against:
    per-rank step spans (compute), inter-step gaps (exposed time), and
    per-hop communication time. Per-hop attribution is exact where the
    trace carries hop-labeled stage spans; bytes-only collective spans
    attribute to the model's bottleneck hop (recorded in
    ``attribution``)."""
    ranks = stats.get("ranks", {})
    hop_names = {h.name for h in model.hops}
    bottleneck = min(model.hops, key=lambda h: h.bandwidth_gbps)

    def _median(xs: List[float]) -> float:
        if not xs:
            return 0.0
        xs = sorted(xs)
        return xs[len(xs) // 2]

    compute_us: List[float] = []
    gap_us: List[float] = []
    cycle_us: List[float] = []
    per_hop_exact: Dict[str, float] = {}
    per_hop_attr: Dict[str, float] = {}
    total_bytes = 0.0
    n_steps = 0
    for r in sorted(ranks):
        doc = ranks[r]
        steps = doc.get("steps") or []
        n_steps = max(n_steps, len(steps))
        durs = [(t1 - t0) * 1e6 for _, t0, t1 in steps]
        gaps = [
            (steps[i + 1][1] - steps[i][2]) * 1e6
            for i in range(len(steps) - 1)
        ]
        cycles = [
            (steps[i + 1][2] - steps[i][2]) * 1e6
            for i in range(len(steps) - 1)
        ]
        if durs:
            compute_us.append(_median(durs))
        if gaps:
            gap_us.append(_median(gaps))
        if cycles:
            cycle_us.append(_median(cycles))
        for c in doc.get("collectives", []):
            dur = float(c.get("dur_s", 0.0)) * 1e6
            if dur <= 0.0:
                continue
            hop = c.get("hop")
            if hop in hop_names:
                per_hop_exact[hop] = per_hop_exact.get(hop, 0.0) + dur
            else:
                per_hop_attr[bottleneck.name] = (
                    per_hop_attr.get(bottleneck.name, 0.0) + dur
                )
                # Bytes-only spans carry PAYLOAD bytes (per rank);
                # hop-labeled stage spans carry wire bytes, which are
                # not a payload measure and stay out of this sum.
                total_bytes += float(c.get("nbytes", 0) or 0)
    steps_div = max(n_steps, 1)
    # Hop-labeled stage spans appear once (the schedule is global, rank
    # 0 carries it); bytes-only spans appear once per participating
    # rank — normalize those by the rank count.
    n_ranks = max(len(ranks), 1)
    per_hop_step: Dict[str, float] = {}
    for hop, v in per_hop_exact.items():
        per_hop_step[hop] = per_hop_step.get(hop, 0.0) + v / steps_div
    for hop, v in per_hop_attr.items():
        per_hop_step[hop] = (
            per_hop_step.get(hop, 0.0) + v / steps_div / n_ranks
        )
    return {
        "world_size": len(ranks),
        "steps": n_steps,
        "compute_us": _median(compute_us),
        "gap_us": _median(gap_us),
        "step_us": (
            _median(cycle_us) if cycle_us
            else _median(compute_us) + _median(gap_us)
        ),
        "per_hop_us": {
            k: round(v, 4) for k, v in sorted(per_hop_step.items())
        },
        "bytes_per_step": total_bytes / steps_div / n_ranks,
        "attribution": (
            "per-hop" if not per_hop_attr else
            f"bottleneck-attributed ({bottleneck.name})"
        ),
    }
