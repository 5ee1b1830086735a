"""CLI/YAML config → HOROVOD_* env mapping.

The port's copy of ``horovod_tpu/run/config_parser.py``: the same knob
table, so both launchers export the same environment for the same flags.
``--mesh-axes`` stays ``HOROVOD_TPU_MESH_AXES``, the name the port's
``common/env.py`` reads. Role parity with the reference's ``run/common/util/config_parser.py``: all
three config surfaces (env vars, CLI flags, YAML file) converge on the same
``HOROVOD_*`` env names read at init, with CLI taking precedence over YAML.
"""

from __future__ import annotations

from typing import Dict

# arg attribute name -> env var
ARG_TO_ENV = {
    "fusion_threshold_mb": "HOROVOD_FUSION_THRESHOLD",
    "cycle_time_ms": "HOROVOD_CYCLE_TIME",
    "cache_capacity": "HOROVOD_CACHE_CAPACITY",
    "hierarchical_allreduce": "HOROVOD_HIERARCHICAL_ALLREDUCE",
    "hierarchical_allgather": "HOROVOD_HIERARCHICAL_ALLGATHER",
    "autotune": "HOROVOD_AUTOTUNE",
    "autotune_log_file": "HOROVOD_AUTOTUNE_LOG",
    "autotune_warmup_samples": "HOROVOD_AUTOTUNE_WARMUP_SAMPLES",
    "autotune_steps_per_sample": "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE",
    "autotune_bayes_opt_max_samples": "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES",
    "autotune_gaussian_process_noise": "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE",
    "timeline_filename": "HOROVOD_TIMELINE",
    "timeline_mark_cycles": "HOROVOD_TIMELINE_MARK_CYCLES",
    "stall_check_disable": "HOROVOD_STALL_CHECK_DISABLE",
    "stall_check_time_seconds": "HOROVOD_STALL_CHECK_TIME_SECONDS",
    "stall_shutdown_time_seconds": "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
    "log_level": "HOROVOD_LOG_LEVEL",
    "start_timeout": "HOROVOD_START_TIMEOUT",
    "mesh_axes": "HOROVOD_TPU_MESH_AXES",
}

# YAML section/key -> arg attribute (reference config file layout).
_YAML_MAP = {
    ("fusion", "threshold-mb"): "fusion_threshold_mb",
    ("fusion", "cycle-time-ms"): "cycle_time_ms",
    ("cache", "capacity"): "cache_capacity",
    ("hierarchy", "allreduce"): "hierarchical_allreduce",
    ("hierarchy", "allgather"): "hierarchical_allgather",
    ("autotune", "enabled"): "autotune",
    ("autotune", "log-file"): "autotune_log_file",
    ("autotune", "warmup-samples"): "autotune_warmup_samples",
    ("autotune", "steps-per-sample"): "autotune_steps_per_sample",
    ("autotune", "bayes-opt-max-samples"): "autotune_bayes_opt_max_samples",
    ("autotune", "gaussian-process-noise"): "autotune_gaussian_process_noise",
    ("timeline", "filename"): "timeline_filename",
    ("timeline", "mark-cycles"): "timeline_mark_cycles",
    ("stall-check", "disable"): "stall_check_disable",
    ("stall-check", "warning-time-seconds"): "stall_check_time_seconds",
    ("stall-check", "shutdown-time-seconds"): "stall_shutdown_time_seconds",
    ("logging", "level"): "log_level",
    ("tpu", "mesh-axes"): "mesh_axes",
}


def parse_config_file(path: str, args, overridden: set) -> None:
    """Apply YAML values to args for every attribute the CLI didn't
    explicitly set (CLI > YAML > defaults, as in the reference)."""
    try:
        import yaml
    except ImportError as exc:  # the card's machine may lack PyYAML
        raise RuntimeError(f"--config-file {path} needs PyYAML, which is not installed") from exc

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    for (section, key), attr in _YAML_MAP.items():
        if attr in overridden:
            continue
        sec = doc.get(section)
        if isinstance(sec, dict) and key in sec:
            setattr(args, attr, sec[key])


def set_env_from_args(env: Dict[str, str], args) -> Dict[str, str]:
    for attr, env_name in ARG_TO_ENV.items():
        value = getattr(args, attr, None)
        # Precise unset test: numeric 0 is a VALID setting (e.g.
        # --cache-capacity 0 disables the cache); `in (None, False, "")`
        # would silently drop it (0 == False).
        if value is None or value is False or value == "":
            continue
        if attr == "fusion_threshold_mb":
            value = int(value) * 1024 * 1024
        if value is True:
            value = "1"
        env[env_name] = str(value)
    return env
