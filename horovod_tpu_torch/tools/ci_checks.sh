#!/usr/bin/env bash
# The port's CI gate: the collective lint, the CI smokes, then the port's
# tests. The counterpart of tools/ci_checks.sh, with the same stages in the
# same order, each with its HVD_CI_SKIP_* knob:
#
#   bash horovod_tpu_torch/tools/ci_checks.sh              # every stage
#   HVD_CI_SKIP_TESTS=1 bash horovod_tpu_torch/tools/ci_checks.sh
#
# Every stage runs on the CPU (--device cpu, gloo ranks), as the reference's
# CI runs with JAX_PLATFORMS=cpu. A stage's own exit code ends the script:
# 1 for findings, 2 for a crash (the overlap stage's failed assertions exit
# 5, as the reference's do). Arguments go to the collective lint.
#
# Stage 1 (HVD_CI_SKIP_LINT): the collective lint,
#   horovod_tpu_torch/tools/collective_lint.py all over 4 gloo ranks (the
#   reference's stage 1 has no knob; the port's has one so that a single
#   stage can run alone). Budget: under 60 s.
# Stage 2 (HVD_CI_SKIP_CHAOS): chaos_smoke, the seeded worker kill + slow
#   rank + dropped control-plane burst on 3 elastic ranks. Under 120 s.
# Stage 3 (HVD_CI_SKIP_METRICS): metrics_smoke, the driver's /metrics
#   scraped mid-run and validated. Under 60 s.
# Stage 4 (HVD_CI_SKIP_OVERLAP): profile_overlap --structural
#   --assert-overlap, the reference's two programs in four modes on a world
#   of 8 played by one process. Under 60 s.
# Stage 5 (HVD_CI_SKIP_GUARD): guard_smoke, nan + bit flip detected and
#   healed, the event log byte-identical across two runs. Under 15 s (the
#   port's two 2-rank launches take ~20 s).
# Stage 6 (HVD_CI_SKIP_DRIVER): driver_smoke, the driver killed, resumed
#   from its journal, the workers reattached, twice. Under 90 s.
# Stage 7 (HVD_CI_SKIP_TOPO): topo_smoke, the plan dumps byte-stable and
#   the plan shapes sane. Under 10 s of cost model.
# Stage 8 (HVD_CI_SKIP_QUANT): quant_smoke, the streamed int8 step bitwise
#   the post-hoc one, int8 hops only. Under 15 s.
# Stage 9 (HVD_CI_SKIP_TRACE): trace_smoke, the straggler attributed, the
#   merged trace and the postmortem, twice. Under 60 s.
# Stage 10 (HVD_CI_SKIP_TUNE): tune_smoke, tuned.json byte-stable, the tuned
#   step bitwise the untuned one, a modeled win, a loud stale fallback.
# Stage 11 (HVD_CI_SKIP_ZERO): zero_smoke, streamed ZeRO-1 with the int8
#   wire bitwise the post-hoc one, the state sharded. Under 15 s.
# Stage 12 (HVD_CI_SKIP_SIM): sim_smoke, the fleet simulator deterministic,
#   scale-gated, calibrated and replaying a real trace. Under 60 s.
# Stage 13 (HVD_CI_SKIP_SELFDRIVE): selfdrive_smoke, quarantine -> re-plan
#   -> promote -> recover, twice. Under 60 s (the port's ~70 s).
# Stage 14 (HVD_CI_SKIP_LLM): llm_smoke, the composed DP x TP step with
#   streamed ZeRO-1 + int8 on the data axis, the per-axis wire bytes.
# Stage 15 (HVD_CI_SKIP_RESHARD): reshard_smoke, ZeRO-1 state through a
#   4 -> 2 -> 4 shrink and grow. Under 25 s.
# Stage 16 (HVD_CI_SKIP_SERVE): serve_smoke, the five serving gates.
# Stage 17 (HVD_CI_SKIP_TPFUSE): tpfuse_smoke, the fused TP step against the
#   classic one, the psum-free fused forward, the tuner's TP term. Under 90 s.
# Stage 18 (HVD_CI_SKIP_TESTS): the port's tests, tests/test_torch_*.py.
set -euo pipefail
cd "$(dirname "$0")/../.."

export OMP_NUM_THREADS="${OMP_NUM_THREADS:-2}"

stage() {
    # stage <knob> <message> <module> [args...]
    local knob="$1" msg="$2" module="$3"
    shift 3
    if [ "${!knob:-0}" = "1" ]; then
        echo "ci_checks: $module skipped ($knob=1)"
        return 0
    fi
    local start
    start=$(date +%s)
    python -m "horovod_tpu_torch.tools.$module" "$@"
    echo "ci_checks: $msg in $(( $(date +%s) - start ))s"
}

stage HVD_CI_SKIP_LINT "collective lint clean" collective_lint all "$@"

stage HVD_CI_SKIP_CHAOS "chaos smoke recovered" chaos_smoke --device cpu
stage HVD_CI_SKIP_METRICS "metrics smoke scraped" metrics_smoke --device cpu
stage HVD_CI_SKIP_OVERLAP "overlap structure verified" profile_overlap --structural \
    --assert-overlap --device cpu
stage HVD_CI_SKIP_GUARD "guard smoke detected+healed" guard_smoke --device cpu
stage HVD_CI_SKIP_DRIVER "driver smoke killed+resumed+reattached" driver_smoke --device cpu
stage HVD_CI_SKIP_TOPO "topo smoke plans stable" topo_smoke --device cpu
stage HVD_CI_SKIP_QUANT "quant smoke bitwise+s8+EF verified" quant_smoke --device cpu
stage HVD_CI_SKIP_TRACE "trace smoke merged+attributed+postmortem" trace_smoke --device cpu
stage HVD_CI_SKIP_TUNE "tune smoke deterministic+bitwise+modeled-win" tune_smoke --device cpu
stage HVD_CI_SKIP_ZERO "zero smoke streamed==posthoc+sharded+byte-stable" zero_smoke --device cpu
stage HVD_CI_SKIP_SIM "sim smoke deterministic+scale-gated+calibrated+replayed" sim_smoke \
    --device cpu
stage HVD_CI_SKIP_SELFDRIVE "selfdrive smoke quarantined+replanned+promoted+byte-stable" \
    selfdrive_smoke --device cpu
stage HVD_CI_SKIP_LLM "llm smoke composed+preflighted+attributed+byte-stable" llm_smoke \
    --device cpu
stage HVD_CI_SKIP_RESHARD "reshard smoke shrunk+grown+parity+byte-stable" reshard_smoke \
    --device cpu
stage HVD_CI_SKIP_SERVE "serve smoke exactly-once+metered+traced+byte-stable" serve_smoke \
    --device cpu
stage HVD_CI_SKIP_TPFUSE "tpfuse smoke fused==classic+psum-free+tuner-win+byte-stable" \
    tpfuse_smoke --device cpu

if [ "${HVD_CI_SKIP_TESTS:-0}" != "1" ]; then
    start=$(date +%s)
    python -m pytest tests/test_torch_*.py -q -p no:cacheprovider
    echo "ci_checks: port tests passed in $(( $(date +%s) - start ))s"
else
    echo "ci_checks: port tests skipped (HVD_CI_SKIP_TESTS=1)"
fi
