"""The port's launcher (horovod_tpu_torch/run) against the JAX package's
(horovod_tpu/run):

- host strings, hostfiles and slot allocation (too few slots included),
  ``parse_args`` + ``set_env_from_args`` over every knob flag, the YAML
  file with a CLI override, and ``build_rank_env``: the same outputs from
  the same inputs (the rank env with ``MASTER_ADDR``/``MASTER_PORT`` and the
  launcher's store in place of the JAX coordinator and the controller
  endpoint);
- ``safe_shell_exec``'s behaviours (tests/test_safe_shell_exec.py run
  against the port's module), the SSH pre-flight and its cache;
- the port's ``KVStoreClient`` against the JAX ``KVStoreServer`` and the
  reverse;
- end to end, each subprocess with its own timeout, rendezvous through the
  launcher's store on a port the OS picks: ``python -m
  horovod_tpu_torch.run -np 2`` of the small GPT DP step (both ranks' losses
  within 1e-6 relative of the one-process whole-batch loss; the step's
  ``hvd_fusion_buckets`` and ``hvd_axis_wire_bytes_total`` equal to JAX's
  ``make_train_step``'s on a 2-device mesh, recorded once for the run); a
  failing rank ends the job with its code and stops its peer;
  ``run_parity --smoke`` (``run()`` returning both ranks' records); a
  ``localhost`` + fake ``hosta`` hostfile through an ssh PATH shim;
- each elastic flag reaches the ``ElasticDriver`` with the arguments the
  JAX CLI routes it with (``--auto-resume`` through the supervisor);
  ``--tpu-pod`` refuses, a job over two remote hosts runs the ring NIC
  probe, and ``init`` refuses more local ranks than visible cards.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from horovod_tpu import metrics as jax_metrics
from horovod_tpu.run import config_parser as jax_config
from horovod_tpu.run import http_server as jax_http
from horovod_tpu.run import launcher as jax_launcher

from horovod_tpu_torch.run import config_parser as port_config
from horovod_tpu_torch.run import http_server as port_http
from horovod_tpu_torch.run import launcher as port_launcher
from horovod_tpu_torch.run import safe_shell_exec as port_sse

import test_safe_shell_exec as ref_sse_tests
from torch_port_harness import (GPT_DIMS, GPT_LR, GPT_STEPS, GPT_THRESHOLD,
                                gpt_setup, run_jax_variant, run_reference_test)

# The modules (each package's ``run`` attribute is the run() function).
jax_run = importlib.import_module("horovod_tpu.run.run")
port_run = importlib.import_module("horovod_tpu_torch.run.run")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "2"
    for k in ("HOROVOD_METRICS", "HOROVOD_TRACE", "HOROVOD_TIMELINE", "HOROVOD_RANK",
              "HOROVOD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    env.update(extra)
    return env


def _launch(args, timeout, **env):
    return subprocess.run([sys.executable, "-m", "horovod_tpu_torch.run", *args],
                          env=_env(**env), cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


# --- hosts, allocation, flags, rank env: the JAX launcher's outputs ------------

HOST_STRINGS = ["a:2,b:4", "localhost", "h1,h2:3, h3:1,", "node-1.x:8", "x:1,x:2"]


@pytest.mark.parametrize("hosts", HOST_STRINGS)
def test_parse_hosts_matches_jax(hosts):
    assert port_launcher.parse_hosts(hosts) == jax_launcher.parse_hosts(hosts)


def test_parse_hostfile_matches_jax(tmp_path):
    p = tmp_path / "hosts"
    p.write_text("# comment\nnodeA slots=2\n\nnodeB slots=4  # trailing\nnodeC\n"
                 "nodeD extra=1 slots=3\n")
    got = port_launcher.parse_hostfile(str(p))
    assert got == jax_launcher.parse_hostfile(str(p))
    assert got == [("nodeA", 2), ("nodeB", 4), ("nodeC", 1), ("nodeD", 3)]


@pytest.mark.parametrize("hosts,np_", [
    ([("a", 2), ("b", 2)], 4), ([("a", 4)], 3), ([("a", 1), ("b", 3), ("c", 2)], 6),
    ([("a", 3), ("b", 3)], 5), ([("a", 2), ("a", 2)], 4), ([("a", 1)], 3),
    ([("a", 2), ("b", 1)], 4),
])
def test_allocate_matches_jax(hosts, np_):
    try:
        want = [dataclasses.asdict(s) for s in jax_launcher.allocate(hosts, np_)]
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)):
            port_launcher.allocate(hosts, np_)
        return
    assert [dataclasses.asdict(s) for s in port_launcher.allocate(hosts, np_)] == want


# Every knob flag of both launchers, with a value.
KNOB_ARGV = [
    "--fusion-threshold-mb", "32", "--cycle-time-ms", "3.5", "--cache-capacity", "0",
    "--start-timeout", "45", "--hierarchical-allreduce", "--hierarchical-allgather",
    "--autotune", "--autotune-log-file", "/tmp/at.csv", "--autotune-warmup-samples", "4",
    "--autotune-steps-per-sample", "7", "--autotune-bayes-opt-max-samples", "9",
    "--autotune-gaussian-process-noise", "0.5", "--timeline-filename", "/tmp/tl.json",
    "--timeline-mark-cycles", "--stall-check-disable", "--stall-check-time-seconds", "12",
    "--stall-shutdown-time-seconds", "99", "--log-level", "debug", "--mesh-axes", "data:2,model:2",
]


@pytest.mark.parametrize("argv", [KNOB_ARGV, ["--cycle-time-ms", "2", "--log-level", "warning"],
                                  ["--disable-cache", "--start-timeout", "45"], []])
def test_parse_args_and_env_match_jax(argv):
    full = ["-np", "4", "-H", "localhost:4", *argv, "python", "train.py"]
    pa, ja = port_run.parse_args(full), jax_run.parse_args(full)
    assert pa.command == ja.command == ["python", "train.py"]
    for attr in port_config.ARG_TO_ENV:
        assert getattr(pa, attr) == getattr(ja, attr), attr
    assert port_config.ARG_TO_ENV == jax_config.ARG_TO_ENV
    assert port_config.set_env_from_args({}, pa) == jax_config.set_env_from_args({}, ja)


def test_config_file_with_cli_override_matches_jax(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(textwrap.dedent("""
        fusion:
          threshold-mb: 16
          cycle-time-ms: 7.5
        autotune:
          enabled: true
        timeline:
          filename: /tmp/from_yaml.json
        tpu:
          mesh-axes: data:4
        """))
    argv = ["-np", "2", "--config-file", str(cfg), "--cycle-time-ms", "2.0", "x"]
    pa, ja = port_run.parse_args(argv), jax_run.parse_args(argv)
    assert pa.cycle_time_ms == 2.0 and pa.fusion_threshold_mb == 16 and pa.autotune is True
    env = port_config.set_env_from_args({}, pa)
    assert env == jax_config.set_env_from_args({}, ja)
    assert env["HOROVOD_TPU_MESH_AXES"] == "data:4"


@pytest.mark.parametrize("slot", [("localhost", 1, 4, 1, 2, 0, 2), ("b", 5, 8, 1, 4, 1, 2),
                                  ("a", 0, 1, 0, 1, 0, 1)])
def test_build_rank_env_matches_jax(slot):
    port_env = port_launcher.build_rank_env(port_launcher.SlotInfo(*slot),
                                            {"PATH": "/bin", "HOROVOD_X": "1"},
                                            "127.0.0.1", 9999)
    jax_env = jax_launcher.build_rank_env(jax_launcher.SlotInfo(*slot),
                                          {"PATH": "/bin", "HOROVOD_X": "1"},
                                          "127.0.0.1", 9998, "127.0.0.1:8888")
    endpoint = ("HOROVOD_CONTROLLER_ADDR", "HOROVOD_CONTROLLER_PORT", "HOROVOD_JAX_COORDINATOR")
    assert ({k: v for k, v in port_env.items() if k.startswith("HOROVOD_")}
            == {k: v for k, v in jax_env.items() if k.startswith("HOROVOD_") and k not in endpoint})
    assert port_env["MASTER_ADDR"] == "127.0.0.1" and port_env["MASTER_PORT"] == "9999"
    assert port_env["TORCHELASTIC_USE_AGENT_STORE"] == "True"
    assert (port_env["RANK"], port_env["WORLD_SIZE"], port_env["LOCAL_RANK"],
            port_env["LOCAL_WORLD_SIZE"]) == tuple(str(v) for v in (slot[1], slot[2], slot[3],
                                                                    slot[4]))
    assert port_env["PATH"] == "/bin"


def test_remote_command_forwards_the_ports_env():
    env = {"HOROVOD_RANK": "1", "MASTER_PORT": "5", "NCCL_DEBUG": "INFO", "CUDA_HOME": "/c",
           "TORCH_X": "1", "RANK": "1", "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "-x",
           "TORCHELASTIC_USE_AGENT_STORE": "True", "PATH": "/bin", "HOME": "/h"}
    cmd = port_launcher.build_remote_command("hosta", env, ["python", "t.py"], ssh_port=22)
    line = cmd[-1]
    for k in ("HOROVOD_RANK", "MASTER_PORT", "NCCL_DEBUG", "CUDA_HOME", "TORCH_X", "RANK=",
              "TORCHELASTIC_USE_AGENT_STORE", "PATH"):
        assert k in line, k
    assert "JAX_PLATFORMS" not in line and "XLA_FLAGS" not in line and " HOME=" not in line
    assert cmd[:-1] == jax_launcher.ssh_base_cmd("hosta", 22)


# --- safe_shell_exec, the SSH pre-flight ----------------------------------------

SSE_PORTABLE = ["test_exit_code_propagation", "test_execute_returns_exit_code",
                "test_terminate_kills_whole_process_group",
                "test_terminate_sigkills_sigterm_ignorer", "test_terminate_after_exit_is_noop"]


@pytest.mark.parametrize("name", SSE_PORTABLE)
def test_reference_safe_shell_exec_test_holds_for_the_port(name, request):
    run_reference_test(ref_sse_tests, name, {"safe_shell_exec": port_sse}, request)


def test_execute_forwards_sigterm(tmp_path):
    """execute() in a subprocess: SIGTERM to the supervisor terminates the
    tree at once and execute() returns the child's (signal) status."""
    import signal

    script = tmp_path / "sup.py"
    script.write_text(
        "import importlib.util, sys\n"
        # By path: the module alone, without the package's torch import.
        "spec = importlib.util.spec_from_file_location('sse', sys.argv[1] + "
        "'/horovod_tpu_torch/run/safe_shell_exec.py')\n"
        "safe_shell_exec = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(safe_shell_exec)\n"
        "rc = safe_shell_exec.execute([sys.executable, '-c', 'import sys, time; "
        "open(sys.argv[1], \"w\").close(); time.sleep(300)', sys.argv[2]])\n"
        "sys.exit(0 if rc != 0 else 1)\n")
    ready = tmp_path / "ready"
    proc = subprocess.Popen([sys.executable, str(script), REPO, str(ready)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.monotonic() + 60
    while not ready.exists() and time.monotonic() < deadline:
        time.sleep(0.05)
    time.sleep(0.5)     # the child runs: execute() installs its handlers next
    t0 = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) == 0, proc.stderr.read().decode()
    # The tree ends as soon as the child dies, not after the SIGKILL grace
    # (the JAX copy's handler waits it out: ROADMAP C).
    assert time.monotonic() - t0 < port_sse.GRACEFUL_TERMINATION_TIME_S


def _fake_ssh(monkeypatch, up):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return type("R", (), {"returncode": 0 if up(cmd[-2]) else 255})()

    monkeypatch.setattr(subprocess, "run", fake_run)
    return calls


@pytest.mark.parametrize("mods", [(port_launcher, "horovod_tpu_torch.run.disk_cache"),
                                  (jax_launcher, "horovod_tpu.run.disk_cache")],
                         ids=["port", "jax"])
def test_ssh_preflight_and_cache(mods, monkeypatch, tmp_path):
    """tests/test_run.py:156-241 on both launchers: a dead host fails fast
    by name, localhost is never probed, successes are cached for the TTL,
    failures never."""
    launcher, cache_mod = mods[0], importlib.import_module(mods[1])
    state = {"flaky": False}
    calls = _fake_ssh(monkeypatch, lambda h: h != "bad-host" and (h != "flaky" or state["flaky"]))
    cache = cache_mod.DiskCache(str(tmp_path / "c.json"), ttl_seconds=300)
    with pytest.raises(RuntimeError) as e:
        launcher.check_hosts_reachable(["good-host", "bad-host", "localhost"], cache=cache)
    assert "bad-host" in str(e.value) and "good-host" not in str(e.value)
    assert e.value.failed_hosts == ["bad-host"]
    assert all("localhost" not in c for c in calls)
    n = len(calls)
    launcher.check_hosts_reachable(["good-host"], cache=cache)      # cached
    assert len(calls) == n
    launcher.check_hosts_reachable(["good-host"],
                                   cache=cache_mod.DiskCache(str(tmp_path / "c.json"), 0))
    assert len(calls) == n + 1                                       # TTL expired
    with pytest.raises(RuntimeError):
        launcher.check_hosts_reachable(["flaky"], cache=cache)
    state["flaky"] = True
    launcher.check_hosts_reachable(["flaky"], cache=cache)           # re-probed
    assert len(calls) == n + 3


# --- the KV plane: wire compatibility -----------------------------------------


@pytest.mark.parametrize("server_mod,client_mod", [(jax_http, port_http), (port_http, jax_http)],
                         ids=["port-client-jax-server", "jax-client-port-server"])
def test_kv_wire_compatible(server_mod, client_mod):
    server = server_mod.KVStoreServer()
    port = server.start()
    try:
        client = client_mod.KVStoreClient("127.0.0.1", port)
        client.put("global", "k1", b"hello")
        assert client.get("global", "k1") == b"hello"
        assert server.snapshot("global") == {"k1": b"hello"}
        assert client.get("global", "missing") is None
        assert client.get("global", "missing", strict=True) is None
        assert client.wait("global", "k1") == b"hello"
        server.put("metrics", "rank.0", b"{}")
        assert client.get("metrics", "rank.0") == b"{}"
    finally:
        server.stop()
    with pytest.raises(client_mod.KVUnavailableError):
        client.get("global", "k1", strict=True)


# --- end to end ------------------------------------------------------------------

GPT_WORKER = r'''
import json, os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import metrics
from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
from horovod_tpu_torch.utils.convert import load_flax_params

d = sys.argv[1]
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
data = np.load(f"{d}/inputs.npz")
cfg = json.load(open(f"{d}/cfg.json"))
model = TransformerLM(**cfg["dims"], dtype=torch.float32, device="cpu", seed=0)
load_flax_params(model, {k[2:]: data[k] for k in data.files if k.startswith("p:")})
per = data["tokens"].shape[0] // n
rows = slice(r * per, (r + 1) * per)
tok, lab = (torch.from_numpy(data[k][rows]) for k in ("tokens", "labels"))
opt = hvd.DistributedOptimizer(
    torch.optim.AdamW(model.parameters(), lr=cfg["lr"], weight_decay=1e-4, eps=1e-8),
    named_parameters=model.named_parameters(), fusion_threshold_bytes=cfg["threshold"])
step = hvd.make_train_step(lambda m, b: lm_loss(m(b[0]), b[1]), opt)
losses = [float(step(model, (tok, lab))) for _ in range(cfg["steps"])]
env = {k: os.environ.get(k) for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                                      "MASTER_ADDR", "MASTER_PORT", "HOROVOD_CONTROLLER_PORT",
                                      "HOROVOD_JAX_COORDINATOR")}
json.dump({"losses": losses, "metrics": metrics.snapshot(), "env": env},
          open(f"{d}/out.rank{r}.json", "w"))
print("GPT_WORKER_DONE", r, flush=True)
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def launched_gpt(tmp_path_factory):
    """The small GPT DP step at 2 ranks through ``python -m
    horovod_tpu_torch.run -np 2`` with the metrics tap on, and the same
    weights and batch (tests/torch_port_harness.py)."""
    from horovod_tpu.parallel.rules import named_tree_paths

    d = tmp_path_factory.mktemp("launched_gpt")
    setup = gpt_setup()
    _, params, tokens, labels = setup
    np.savez(d / "inputs.npz", tokens=tokens.astype(np.int64), labels=labels.astype(np.int64),
             **{f"p:{k}": np.asarray(v) for k, v in named_tree_paths(params)})
    (d / "cfg.json").write_text(json.dumps({"dims": GPT_DIMS, "lr": GPT_LR, "steps": GPT_STEPS,
                                            "threshold": GPT_THRESHOLD}))
    (d / "worker.py").write_text(GPT_WORKER)
    proc = _launch(["-np", "2", "--output-dir", str(d / "out"), sys.executable,
                    str(d / "worker.py"), str(d)], timeout=240, HOROVOD_METRICS="1")
    assert proc.returncode == 0, (proc.stdout, proc.stderr, [
        (f, (d / "out" / f).read_text()) for f in sorted(os.listdir(d / "out"))])
    outs = [json.loads((d / f"out.rank{r}.json").read_text()) for r in range(2)]
    return setup, outs, d


def test_cli_np2_gpt_losses_match_whole_batch(launched_gpt):
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.utils.convert import load_flax_params

    (_, _, tokens, labels), outs, d = launched_gpt
    data = np.load(d / "inputs.npz")
    model = TransformerLM(**GPT_DIMS, dtype=torch.float32, device="cpu", seed=0)
    load_flax_params(model, {k[2:]: data[k] for k in data.files if k.startswith("p:")})
    opt = torch.optim.AdamW(model.parameters(), lr=GPT_LR, weight_decay=1e-4, eps=1e-8)
    want = []
    for _ in range(GPT_STEPS):
        opt.zero_grad()
        loss = lm_loss(model(torch.from_numpy(tokens.astype(np.int64))),
                       torch.from_numpy(labels.astype(np.int64)))
        loss.backward()
        opt.step()
        want.append(loss.item())
    for out in outs:
        np.testing.assert_allclose(out["losses"], want, rtol=1e-6)
    # The rank env: the launcher's store, no controller port, no JAX coordinator.
    envs = [o["env"] for o in outs]
    assert [e["HOROVOD_RANK"] for e in envs] == ["0", "1"]
    assert {e["MASTER_ADDR"] for e in envs} == {"127.0.0.1"}
    assert len({e["MASTER_PORT"] for e in envs}) == 1
    assert all(e["HOROVOD_CONTROLLER_PORT"] is None and e["HOROVOD_JAX_COORDINATOR"] is None
               for e in envs)
    assert sorted(os.listdir(d / "out")) == ["rank.0.err", "rank.0.out", "rank.1.err",
                                             "rank.1.out"]
    assert "GPT_WORKER_DONE 1" in (d / "out" / "rank.1.out").read_text()


def _series(snap, name):
    return sorted((tuple(sorted(s["labels"].items())), s.get("value", s.get("count")))
                  for s in snap.get(name, {}).get("series", []))


def test_cli_np2_dp_step_plan_metrics_match_jax(launched_gpt):
    """The step's fusion plan taps equal JAX's make_train_step on a
    2-device mesh (same tree, same threshold), recorded once for
    GPT_STEPS steps as JAX records them once per compile."""
    setup, outs, _ = launched_gpt
    jax_metrics.install(True)
    try:
        run_jax_variant(setup, 2)
        jsnap = jax_metrics.snapshot()
    finally:
        jax_metrics.reset()
    # JAX records at trace time, once per compile; its step compiles more
    # than once over the steps (the traces: the bucket-size histogram's
    # count over the bucket count). The port records each plan once.
    buckets = _series(jsnap, "hvd_fusion_buckets")
    (_, n_buckets), = buckets
    traces = jsnap["hvd_fusion_bucket_bytes"]["series"][0]["count"] / n_buckets
    assert traces == int(traces) >= 1
    (labels, jax_wire), = _series(jsnap, "hvd_axis_wire_bytes_total")
    for out in outs:
        snap = out["metrics"]
        assert _series(snap, "hvd_fusion_buckets") == buckets
        assert _series(snap, "hvd_axis_wire_bytes_total") == [(labels, jax_wire / traces)]
        assert snap["hvd_fusion_bucket_bytes"]["series"][0]["count"] == n_buckets
        assert snap["hvd_fusion_bucket_bytes"]["series"][0]["sum"] == \
            jsnap["hvd_fusion_bucket_bytes"]["series"][0]["sum"] / traces
    # The ring formula of horovod_tpu/ops/fusion.py:158 over the f32 gradients.
    from horovod_tpu.parallel.rules import named_tree_paths

    payload = sum(np.asarray(v).nbytes for _, v in named_tree_paths(setup[1]))
    assert _series(outs[0]["metrics"], "hvd_axis_wire_bytes_total") == [
        ((("axis", "data"), ("collective", "allreduce")), float(2 * (2 - 1) * payload // 2))]


def test_failing_rank_ends_the_job_and_stops_its_peer(tmp_path):
    code = ("import os, sys, time\n"
            "if os.environ['HOROVOD_RANK'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(120)\n")
    t0 = time.monotonic()
    proc = _launch(["-np", "2", sys.executable, "-c", code], timeout=60)
    assert proc.returncode == 3, proc.stderr
    assert time.monotonic() - t0 < 30
    assert "rank 1 failed with exit code 3" in proc.stderr


def test_run_parity_smoke():
    """``tools/run_parity --smoke``: run() returns both ranks' records; the
    losses, the launches, the plan taps, the step spans, the timeline and a
    killed rank are checked there."""
    proc = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.tools.run_parity",
                           "--smoke"], env=_env(), cwd=REPO, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["step_spans_by_rank"] == [3, 3] and out["timeline_events"] > 0
    assert out["killed_rank"]["ok"]
    assert out["axis_wire_bytes"][0][1] == out["ring_formula_bytes"]


def test_hostfile_with_a_remote_host_through_an_ssh_shim(tmp_path):
    """``localhost`` + fake ``hosta``: the pre-flight and hosta's rank go
    through the ssh binary (a PATH shim that runs the command here), with
    no NIC probe (one remote host)."""
    shim_dir = tmp_path / "bin"
    shim_dir.mkdir()
    shim = shim_dir / "ssh"
    shim.write_text(textwrap.dedent("""\
        #!/bin/sh
        while [ $# -gt 0 ]; do
          case "$1" in
            -o|-p) shift 2 ;;
            -*) shift ;;
            *) break ;;
          esac
        done
        host="$1"; shift
        echo "$host" >> "$SSH_SHIM_LOG"
        exec /bin/sh -c "$*"
        """))
    shim.chmod(0o755)
    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent("""\
        import numpy as np
        import horovod_tpu_torch as hvd
        hvd.init(device="cpu")
        s = hvd.allreduce(np.full(2, float(hvd.rank() + 1), np.float32), op=hvd.Sum, name="e2e")
        print("SSHE2E", hvd.rank(), hvd.size(), float(s[0]), flush=True)
        hvd.shutdown()
        """))
    hostfile = tmp_path / "hosts"
    hostfile.write_text("localhost slots=1\nhosta slots=1\n")
    out_dir = tmp_path / "out"
    proc = _launch(["-np", "2", "--hostfile", str(hostfile), "--disable-cache",
                    "--output-dir", str(out_dir), sys.executable, str(worker)], timeout=120,
                   PATH=f"{shim_dir}{os.pathsep}{os.environ.get('PATH', '')}",
                   SSH_SHIM_LOG=str(tmp_path / "ssh.log"))
    outs = {f: (out_dir / f).read_text() for f in os.listdir(out_dir)}
    assert proc.returncode == 0, (proc.stdout, proc.stderr, outs)
    lines = sorted(l for o in outs.values() for l in o.splitlines() if l.startswith("SSHE2E"))
    assert lines == ["SSHE2E 0 2 3.0", "SSHE2E 1 2 3.0"], outs
    assert set((tmp_path / "ssh.log").read_text().split()) == {"hosta"}


# --- refusals ----------------------------------------------------------------------


def _capture_elastic_routing(monkeypatch, run_mod, driver_mod):
    """Replace ``driver_mod.ElasticDriver`` with a recorder of its keyword
    arguments; the first recorded driver's ``run()`` exits 67 (a driver
    crash, which the supervisor resumes), every later one 0."""
    seen = []

    class Recorder:
        def __init__(self, command, **kw):
            seen.append(dict(kw, command=list(command)))

        def run(self):
            return 67 if len(seen) == 1 else 0

    monkeypatch.setattr(driver_mod, "ElasticDriver", Recorder)
    real = run_mod._supervise_driver
    monkeypatch.setattr(run_mod, "_supervise_driver",
                        lambda argv: real(argv, call=run_mod.run_commandline))
    return seen


# Each elastic flag, with --min-np where the flag alone does not route the
# job to the driver (the JAX routing: a discovery script, --min-np,
# --max-np or --resume).
@pytest.mark.parametrize("flags", [["--min-np", "2"], ["--max-np", "4"],
                                   ["--host-discovery-script", "d.sh"],
                                   ["--min-np", "1", "--spares", "1"],
                                   ["--resume"], ["--min-np", "2", "--auto-resume"],
                                   ["--min-np", "2", "--blacklist-cooldown", "5"]])
def test_elastic_flags_refuse_naming_a12b(flags, monkeypatch):
    """Each elastic flag reaches ``ElasticDriver`` with the arguments the
    JAX CLI routes it with (the elastic driver was refused before it was
    ported; the test keeps its name). ``--auto-resume`` runs the driver
    under the supervisor, which resumes the crashed driver with
    ``--resume`` placed before the training command (the JAX supervisor
    appends it after, where the command swallows it)."""
    import horovod_tpu.run.elastic_driver as jax_ed

    import horovod_tpu_torch.run.elastic_driver as port_ed

    argv = ["-np", "2", "--elastic-timeout", "30", *flags, "python", "x.py"]
    port_seen = _capture_elastic_routing(monkeypatch, port_run, port_ed)
    jax_seen = _capture_elastic_routing(monkeypatch, jax_run, jax_ed)
    # The recorded driver crashes (67); under --auto-resume the supervisor
    # resumes it and the job ends 0.
    rc = 0 if "--auto-resume" in flags else 67
    assert port_run.run_commandline(list(argv)) == rc
    assert jax_run.run_commandline(list(argv)) == rc
    for kw in port_seen + jax_seen:
        kw.pop("env")
    assert port_seen[0] == jax_seen[0]
    assert port_seen[0]["command"] == ["python", "x.py"]
    assert port_seen[0]["elastic_timeout"] == 30.0
    given = {"--min-np": ("min_np", int), "--max-np": ("max_np", int),
             "--host-discovery-script": ("discovery_script", str), "--spares": ("spares", int),
             "--blacklist-cooldown": ("blacklist_cooldown", float)}
    for flag, value in zip(flags, flags[1:]):
        if flag in given:
            key, cast = given[flag]
            assert port_seen[0][key] == cast(value), (flag, port_seen[0])
    assert port_seen[0]["resume"] is ("--resume" in flags)
    if "--auto-resume" in flags:
        # The supervisor's second driver resumes the first's journal.
        assert [kw["resume"] for kw in port_seen] == [False, True]
        assert port_seen[1]["command"] == ["python", "x.py"]
        assert jax_seen[1]["command"] == ["python", "x.py", "--resume"]


def test_tpu_pod_and_nic_probe_refuse(monkeypatch, capsys):
    """``--tpu-pod`` refuses; two remote hosts with no pinned interface run
    the ring NIC probe (``run/network.py``, monkeypatched here) and launch
    with its interfaces and rank 0's probed address; a failed probe prints
    and the launch goes on, as in the JAX launcher."""
    from horovod_tpu_torch.run import network

    assert port_run.run_commandline(["--tpu-pod", "python", "x.py"]) == 2
    assert "TPU slice metadata" in capsys.readouterr().err
    monkeypatch.setattr(port_launcher, "check_hosts_reachable", lambda *a, **k: None)
    probed, launched = [], []

    def probe(hosts, **kw):
        probed.append((list(hosts), kw))
        return ["eth9", "lo"], {h: {"lo": [("127.0.0.1", 7)], "eth9": [(f"10.0.0.{i}", 7)]}
                                for i, h in enumerate(hosts)}

    monkeypatch.setattr(network, "discover_common_interfaces", probe)
    monkeypatch.setattr(port_launcher, "launch_job",
                        lambda cmd, slots, env=None, **kw: launched.append(env) or 0)
    assert port_run.run_commandline(["-np", "2", "-H", "hosta:1,hostb:1", "python", "x"]) == 0
    assert probed == [(["hosta", "hostb"], {"ssh_port": None, "return_addresses": True})]
    assert launched[0]["HOROVOD_IFACE"] == "eth9,lo"
    assert launched[0]["HOROVOD_PROBED_CONTROLLER_ADDR"] == "10.0.0.0"
    # A pinned interface skips the probe; a failed probe prints and goes on.
    assert port_run.run_commandline(["-np", "2", "-H", "hosta:1,hostb:1",
                                     "--network-interfaces", "lo", "python", "x"]) == 0
    assert len(probed) == 1 and launched[1]["HOROVOD_IFACE"] == "lo"

    def broken(hosts, **kw):
        raise TimeoutError("rendezvous phase 'initial-registration' timed out")

    monkeypatch.setattr(network, "discover_common_interfaces", broken)
    capsys.readouterr()
    assert port_run.run_commandline(["-np", "2", "-H", "hosta:1,hostb:1", "python", "x"]) == 0
    assert "NIC probe failed" in capsys.readouterr().err
    assert "HOROVOD_IFACE" not in launched[2]
    assert port_run.run_commandline(["-np", "3", "-H", "localhost:1", "python", "x"]) == 2
    assert port_run.run_commandline(["python", "x"]) == 2


def test_more_local_ranks_than_cards_refuses(monkeypatch):
    from horovod_tpu_torch.common import basics

    for k, v in (("HOROVOD_RANK", "1"), ("HOROVOD_SIZE", "2"), ("HOROVOD_LOCAL_RANK", "1"),
                 ("HOROVOD_LOCAL_SIZE", "2")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 local ranks on this host but 1 visible CUDA"):
        basics.init()
    assert not basics.is_initialized()


def test_check_build_and_version():
    proc = _launch(["--check-build"], timeout=60)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    for line in ("[X] PyTorch", "[X] Gloo", "native core", "nvcc", "CUDA device"):
        assert line in out, (line, out)
    import horovod_tpu_torch

    assert port_run.run_commandline(["--version"]) == 0
    assert horovod_tpu_torch.__version__ == "0.1.0"
