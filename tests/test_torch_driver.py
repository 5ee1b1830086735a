"""The port's elastic driver, journal and self-driving policies against the
JAX package's (``horovod_tpu/run/{elastic_driver,journal,selfdrive}.py``).

- The JAX package's own tests of them, run against the port's modules
  (``run_reference_test``; the names a test imports inside its body,
  ``horovod_tpu.run.elastic_driver`` and the like, resolve to the port's
  modules for the call): the journal, blacklist and supervisor tests of
  ``tests/test_driver_ha.py``, the policy, skew, journal v1/v2 and drift
  tests of ``tests/test_selfdrive.py``, the blacklist tests of
  ``tests/test_chaos.py``, ``tests/test_serve.py::TestServeScalePolicy``
  and the driver tests of ``tests/test_elastic.py``.
- A journal written by either package's ``DriverJournal`` replays in the
  other's, byte for byte.
- The live re-plan (A13b): its knobs arm the driver's ``_maybe_replan``,
  and each call of selfdrive's planning half gives the JAX package's value
  (``tests/test_torch_replan.py`` holds the rest).
- The world document the port's driver publishes (the generation's
  TCPStore, served by the job's store host, and the slots keeping their
  local ranks) and its card-keeping spare swap.
"""

import importlib
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import horovod_tpu as jhvd  # noqa: E402
import horovod_tpu.run as jrun  # noqa: E402
from horovod_tpu.fault import injector as jinjector  # noqa: E402
from horovod_tpu.run import journal as jjournal  # noqa: E402
from horovod_tpu.run import selfdrive as jselfdrive  # noqa: E402

from horovod_tpu_torch import elastic as port_elastic  # noqa: E402
from horovod_tpu_torch import trace as port_trace  # noqa: E402
from horovod_tpu_torch.common import env as port_env  # noqa: E402
from horovod_tpu_torch.fault import injector as port_injector  # noqa: E402
from horovod_tpu_torch.fault import plan as port_plan  # noqa: E402
from horovod_tpu_torch.run import elastic_driver as ed  # noqa: E402
from horovod_tpu_torch.run import journal as pjournal  # noqa: E402
from horovod_tpu_torch.run import launcher as plauncher  # noqa: E402
from horovod_tpu_torch.run import network as pnetwork  # noqa: E402
from horovod_tpu_torch.run import selfdrive as psd  # noqa: E402
from horovod_tpu_torch.trace import pusher as ppusher  # noqa: E402

# The module (``horovod_tpu_torch.run.run`` the attribute is the function).
prun = importlib.import_module("horovod_tpu_torch.run.run")

import test_chaos as ref_chaos  # noqa: E402
import test_driver_ha as ref_ha  # noqa: E402
import test_elastic as ref_elastic  # noqa: E402
import test_selfdrive as ref_selfdrive  # noqa: E402
import test_serve as ref_serve  # noqa: E402
from torch_port_harness import run_reference_test  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_fault_state():
    for mod in (port_injector, jinjector):
        mod.reset()
    yield
    for mod in (port_injector, jinjector):
        mod.reset()


@pytest.fixture
def as_port(monkeypatch):
    """The JAX package's module names, bound to the port's modules."""
    for name, mod in (("elastic_driver", ed), ("journal", pjournal), ("selfdrive", psd),
                      ("launcher", plauncher), ("run", prun), ("network", pnetwork)):
        monkeypatch.setitem(sys.modules, f"horovod_tpu.run.{name}", mod)
        monkeypatch.setattr(jrun, name, mod, raising=False)
    for name, mod in (("elastic", port_elastic), ("trace", port_trace)):
        monkeypatch.setitem(sys.modules, f"horovod_tpu.{name}", mod)
        monkeypatch.setattr(jhvd, name, mod, raising=False)
    monkeypatch.setitem(sys.modules, "horovod_tpu.trace.pusher", ppusher)


HA_SWAPS = {"DriverJournal": pjournal.DriverJournal, "journal_mod": pjournal,
            "blacklist_from_journal": pjournal.blacklist_from_journal,
            "blacklist_to_journal": pjournal.blacklist_to_journal,
            "_injector": port_injector, "FaultPlan": port_plan.FaultPlan,
            "DRIVER_KILL_EXIT_CODE": port_plan.DRIVER_KILL_EXIT_CODE}
HA_TESTS = [
    "test_journal_roundtrip_and_idempotent_replay", "test_journal_epoch_monotonic_across_opens",
    "test_journal_refuses_future_version", "test_journal_unreadable_degrades_to_fresh",
    "test_blacklist_serialization_roundtrip_same_clock",
    "test_blacklist_resume_with_backwards_clock_skew_does_not_extend",
    "test_blacklist_resume_with_forward_skew_or_downtime_expires",
    "test_blacklist_malformed_entry_is_dropped_not_fatal", "test_driver_watch_classification",
    "test_driver_fault_actions_parse_and_schedule",
    "test_driver_fault_kinds_skipped_at_worker_taps",
    "test_maybe_fire_driver_faults_kill_and_epoch_fence",
    "test_elastic_driver_resume_requires_journal",
    "test_elastic_driver_resume_finished_journal_exits_zero",
    "test_fresh_driver_reusing_dir_clears_finished_flag",
    "test_supervise_driver_resumes_on_abnormal_exit",
    "test_supervise_driver_resumes_on_unhandled_exception_rc",
    "test_supervise_driver_deliberate_exit_and_budget",
]


@pytest.mark.parametrize("name", HA_TESTS)
def test_reference_driver_ha_test_holds_for_the_port(name, request, as_port):
    run_reference_test(ref_ha, name, HA_SWAPS, request)


SELFDRIVE_TESTS = [
    "test_policy_disabled_by_default", "test_policy_strike_accumulation_2_ranks",
    "test_policy_decay_healthy_steps_push_charges_out",
    "test_policy_never_quarantines_below_min_world", "test_policy_one_host_per_beat_4_ranks",
    "test_policy_relapse_ledgers_are_independent", "test_policy_reset_on_generation_change",
    "test_driver_quarantine_respects_available_capacity",
    "test_skew_tracker_generation_gate_and_reset", "test_trace_tap_reset_steps_restarts_ledger",
    "test_trace_window_carries_generation", "test_journal_v2_roundtrip_with_selfdrive_records",
    "test_journal_v1_replays_cleanly", "test_resume_mid_quarantine_replays_the_same_fleet_state",
    "test_journal_v1_with_v2_records_refuses_loudly", "test_divergence_ratios_and_threshold",
    "test_skew_trend_needs_sustained_evidence", "test_replay_divergence_skips_null_hops",
]


@pytest.mark.parametrize("name", SELFDRIVE_TESTS)
def test_reference_selfdrive_test_holds_for_the_port(name, request, as_port):
    run_reference_test(ref_selfdrive, name, {"sd": psd, "DriverJournal": pjournal.DriverJournal},
                       request)


@pytest.mark.parametrize("name", ["test_blacklist_threshold_quarantine_and_readmission",
                                  "test_blacklist_cooldown_zero_is_permanent",
                                  "test_failure_count_decays_after_quiet_period"])
def test_reference_blacklist_test_holds_for_the_port(name, request, as_port):
    run_reference_test(ref_chaos, name, {"_injector": port_injector}, request)


@pytest.mark.parametrize("name", ["test_driver_nic_probe_on_host_set_change",
                                  "test_driver_service_retirement_supersession_clock",
                                  "test_driver_forced_inprocess_degrades_without_surfaces"])
def test_reference_elastic_driver_test_holds_for_the_port(name, request, as_port):
    run_reference_test(ref_elastic, name, {}, request)


@pytest.mark.parametrize("name", sorted(
    n for n in vars(ref_serve.TestServeScalePolicy) if n.startswith("test_")))
def test_reference_serve_scale_policy_test_holds_for_the_port(name, monkeypatch):
    monkeypatch.setattr(ref_serve, "ServeScalePolicy", psd.ServeScalePolicy)
    monkeypatch.setattr(ref_serve, "hvd_env", port_env)
    getattr(ref_serve.TestServeScalePolicy(), name)()


# --- the journal crosses packages ------------------------------------------------


def _record(journal_cls, path):
    j = journal_cls.open(path)
    j.record(gen=4, kv_port=4321, rejoin_mode="inprocess",
             world={"gen": 4, "size": 1, "assignments": {"localhost:0": {"rank": 0}}},
             kv={"joined.localhost:0": "4"}, strikes={"h": 1}, slow_strikes={"s": 2},
             blacklist_reasons={"s": "slow"}, spare_ids=["localhost:1"], failures={"h": 1},
             blacklist={"s": {"permanent": True}})
    return j


@pytest.mark.parametrize("writer,reader", [(jjournal, pjournal), (pjournal, jjournal)])
def test_journal_written_by_one_package_replays_in_the_other(tmp_path, writer, reader,
                                                             monkeypatch):
    monkeypatch.setattr(writer.time, "time", lambda: 1234.5)
    path = str(tmp_path / "driver_journal.json")
    _record(writer.DriverJournal, path)
    with open(path, "rb") as f:
        written = f.read()
    other = str(tmp_path / "other.json")
    monkeypatch.setattr(reader.time, "time", lambda: 1234.5)
    _record(reader.DriverJournal, other)
    with open(other, "rb") as f:
        assert f.read() == written  # the same bytes from either package
    state = reader.DriverJournal(path).replay()
    assert state["gen"] == 4 and state["epoch"] == 1 and state["spare_ids"] == ["localhost:1"]
    reopened = reader.DriverJournal.open(path)
    assert reopened.epoch == 2 and reopened.state["world"]["gen"] == 4
    assert reader.blacklist_from_journal(state["blacklist"]) == {"s": None}


# --- the live re-plan (A13b) --------------------------------------------------------


@pytest.mark.parametrize("knob", [psd.REPLAN_DIVERGENCE_ENV, psd.REPLAN_SKEW_ENV])
def test_replan_knobs_refuse_naming_a13(knob, tmp_path):
    """The re-plan knobs (refused until A13b) arm the driver's
    ``_maybe_replan``, as in the JAX package: its thresholds and check
    interval read from the job's env, and a beat with no published world
    yet publishes nothing."""
    drv = ed.ElasticDriver(["true"], min_np=1, max_np=1, hosts=[("localhost", 1)],
                           env={knob: "0.5", psd.REPLAN_CHECK_ENV: "0.1"},
                           output_dir=str(tmp_path))
    try:
        assert (drv._replan_divergence, drv._replan_skew_s) == (
            (0.5, 0.0) if knob == psd.REPLAN_DIVERGENCE_ENV else (0.0, 0.5))
        assert drv._replan_check_s == 0.5        # the floor
        drv._maybe_replan()
        assert drv._replan_doc is None and drv._last_replan_check > 0
    finally:
        drv._kv.close()


def _planning_inputs(sd, tm, obj, cal):
    """One package's model, program and drifted calibration."""
    model = tm.synthetic_model(4, cross=2)
    spec = obj.ProgramSpec(name="p", layers=(("a", 3 << 20), ("b", 1 << 20), ("c", 64 << 10)))
    hop = model.hops[-1]
    calib = cal.Calibration(signature=cal.model_signature(model), hops={hop.name: {
        "calibrated": True, "latency_us": hop.latency_us, "bandwidth_gbps": 0.05}})
    return model, spec, calib


PLANNING_CALLS = [
    lambda sd, m, s, c: sd.candidate_configs(m, sd._normalize_config(None)),
    lambda sd, m, s, c: sd.propose_replan(s, m, {}, c, drift=2.0).to_notice(1, 2, 3),
    lambda sd, m, s, c: [f.render() for f in sd.verify_replan(
        s, sd.propose_replan(s, m, {}, c).config, m, c)],
    lambda sd, m, s, c: sd.spec_from_windows({0: {"events": [
        {"name": "hvd_plan", "args": {"tensor": "g", "nbytes": 4096}}]}}).layers,
    lambda sd, m, s, c: sd.model_for_world({"assignments": {
        f"h{i}:0": {"rank": i, "local_size": 1, "cross_size": 2} for i in range(2)}}).to_dict(),
    lambda sd, m, s, c: sd.price_resize(1 << 20, 4, 2, model=m)]


@pytest.mark.parametrize("call", PLANNING_CALLS)
def test_selfdrive_planning_half_refuses_naming_a13(call, monkeypatch):
    """Each call of the planning half (refused until A13b) gives the JAX
    package's value on the same inputs."""
    from horovod_tpu.sim import calibrate as jcal
    from horovod_tpu.topo import model as jtm
    from horovod_tpu.tune import objective as jobj
    from horovod_tpu_torch.sim import calibrate as tcal
    from horovod_tpu_torch.topo import model as ttm
    from horovod_tpu_torch.tune import objective as tobj

    monkeypatch.delenv(psd.REPLAN_SPEC_ENV, raising=False)
    got = call(psd, *_planning_inputs(psd, ttm, tobj, tcal))
    want = call(jselfdrive, *_planning_inputs(jselfdrive, jtm, jobj, jcal))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("n_old,n_new,quantized", [(4, 2, False), (3, 4, True), (2, 2, False)])
def test_price_resize_bytes_match_the_reference(n_old, n_new, quantized):
    assert psd.price_resize(3 << 20, n_old, n_new, quantized=quantized) == \
        jselfdrive.price_resize(3 << 20, n_old, n_new, quantized=quantized)


# --- the world document and the slots' cards ------------------------------------------


def test_published_world_names_the_generations_store(tmp_path):
    drv = ed.ElasticDriver(["true"], min_np=2, max_np=2, hosts=[("localhost", 2)],
                           env={"PATH": os.environ.get("PATH", "")})
    drv._kv.start()
    try:
        slots = drv._desired_slots()
        endpoints = drv._publish(slots)
        world = json.loads(drv._kv.snapshot("elastic")["world"].decode())
        assert world["gen"] == 1 and world["size"] == 2 and world["epoch"] == 1
        assert world["master_addr"] == "127.0.0.1" and world["master_port"] > 0
        assert (world["controller_addr"], world["controller_port"]) == ("", 0)
        assert "jax_coordinator" not in world
        assert world["assignments"]["localhost:1"] == {
            "rank": 1, "local_rank": 1, "local_size": 2, "cross_rank": 0, "cross_size": 1}
        assert endpoints["master_port"] == str(world["master_port"])
        # The store answers, and a second generation keeps the first up
        # (the drain grace) on a port of its own.
        import datetime

        import torch.distributed as dist

        client = dist.TCPStore("127.0.0.1", world["master_port"], None, False,
                               datetime.timedelta(seconds=10))
        client.set("k", "v")
        assert client.get("k") == b"v"
        drv._publish(slots)
        ports = [svc.port for _, svc, _, _ in drv._services]
        assert len(ports) == 2 and ports[0] != ports[1]
        env = port_elastic._world_env(world, world["assignments"]["localhost:0"])
        assert env["MASTER_PORT"] == str(world["master_port"])
        # The job's stores live in the store host, a process of its own.
        host = int(drv._kv.snapshot("elastic")["stores.host"])
        assert host != os.getpid() and drv._pid_alive(host)
    finally:
        drv._retire_services(keep=0)
        drv._stop_store_host()
        drv._kv.stop()
    assert not drv._pid_alive(host)


def test_dead_slot_goes_to_a_parked_spare_keeping_its_card():
    class _Live:
        def poll(self):
            return None

    drv = ed.ElasticDriver.__new__(ed.ElasticDriver)
    drv._rejoin_mode = "inprocess"
    drv._workers = {"localhost:0": object(), "localhost:1": object()}
    drv._spares = {"localhost:3": ed._Worker("localhost:3", "localhost", _Live(), ())}
    drv._dead_slots = {"localhost:2"}
    slots = plauncher.allocate([("localhost", 4)], 3)
    got = drv._keep_cards(slots)
    assert [drv._worker_id(s) for s in got] == ["localhost:0", "localhost:1", "localhost:3"]
    assert [(s.rank, s.local_rank, s.local_size, s.size) for s in got] == [
        (0, 0, 4, 3), (1, 1, 4, 3), (2, 3, 4, 3)]
    # No dead slot, or a respawn-mode world still draining: the allocation.
    drv._dead_slots = set()
    assert drv._keep_cards(slots) is slots
    drv._dead_slots, drv._rejoin_mode = {"localhost:2"}, "respawn"
    assert drv._keep_cards(slots) is slots


def test_drain_grace_follows_the_group_timeout():
    assert ed._respawn_drain_grace({}) == 65.0  # the 60 s default window + 5
    assert ed._respawn_drain_grace({"HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "4"}) == 15.0
    assert ed._respawn_drain_grace({"HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "30"}) == 35.0
    assert ed._respawn_drain_grace({"HOROVOD_STALL_CHECK_TIME_SECONDS": "100"}) == 105.0


def test_serve_smoke_gates_pass_on_the_cpu():
    """``tools/serve_smoke``'s five gates (the port's copy of the JAX
    package's): chaos exactly-once, determinism, SLO metrics, trace spans
    and the scale hook, acted on."""
    from torch_port_harness import run_tool

    out = run_tool("horovod_tpu_torch.tools.serve_smoke", ["--device", "cpu"], timeout=180)
    assert out["ok"], out["failures"]
    assert [r["decision"] for r in out["runs"]] == ["scale-out", "scale-out"]
    assert out["request_spans"] > 0 and out["latency_count"] >= 24


def test_scheduled_preemption_notice_reaches_the_worker_once(tmp_path):
    """A plan's ``preempt`` with ``after_s`` is the driver's: it SIGTERMs
    the selected worker that long after its spawn, once per incarnation,
    and logs ``preempt-notice``."""
    import time

    from horovod_tpu_torch.run import safe_shell_exec

    port_injector.install_plan(port_plan.FaultPlan.from_json(
        '{"seed": 2, "faults": [{"kind": "preempt", "after_s": 0.0, "worker": "h:0"}]}'))
    proc = safe_shell_exec.ManagedProcess([sys.executable, "-c", "import time; time.sleep(30)"])
    try:
        drv = ed.ElasticDriver.__new__(ed.ElasticDriver)
        drv._gen, drv._output_dir, drv._preempts_fired = 1, None, set()
        drv._trace_event = lambda *a, **k: None
        drv._workers = {"h:0": ed._Worker("h:0", "h", proc, (), spawned_at=time.monotonic()),
                        "h:1": ed._Worker("h:1", "h", proc, (), spawned_at=time.monotonic())}
        drv._maybe_fire_preemptions()
        drv._maybe_fire_preemptions()
        assert proc.wait(timeout=10) == -15
    finally:
        if proc.poll() is None:
            proc.terminate()
    assert [(e["action"], e["detail"]) for e in port_injector.events()] == [
        ("preempt-notice", "h:0")]


def test_restart_driver_fault_replays_the_journal_in_process(tmp_path):
    """``restart_driver``: a KV blackout, the journal replayed as a resumed
    driver would, the epoch raised, the same port reclaimed and the world
    republished under the new epoch."""
    drv = ed.ElasticDriver(["true"], min_np=1, max_np=1, hosts=[("localhost", 1)],
                           env={"PATH": os.environ.get("PATH", ""),
                                "HOROVOD_FAULT_DRIVER_BLACKOUT_S": "0.1"},
                           output_dir=str(tmp_path))
    drv._kv.start()
    try:
        port = drv._kv.port
        drv._publish(drv._desired_slots())
        drv._simulated_restart()
        assert drv._epoch == 2 and drv._kv.port == port and drv._gen == 1
        world = json.loads(drv._kv.snapshot("elastic")["world"].decode())
        assert world["epoch"] == 2 and world["gen"] == 1
        assert json.loads(drv._kv.snapshot("elastic")["driver"].decode())["epoch"] == 2
        assert pjournal.DriverJournal(drv._journal.path).replay()["epoch"] == 2
    finally:
        drv._retire_services(keep=0)
        drv._stop_store_host()
        drv._kv.stop()
