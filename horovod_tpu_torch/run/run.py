"""``python -m horovod_tpu_torch.run`` — the port's launcher CLI.

The port of ``horovod_tpu/run/run.py``'s fixed path (role parity with the
reference ``horovodrun``): ``-np``, ``-H``/``--hostfile``, every runtime
knob as a flag, YAML ``--config-file`` with CLI-override precedence,
``--check-build``, ``--version``, ``--output-dir``, ``--serve``, and a
``run()`` Python API that ships a pickled function to every rank and
gathers the results. Any elastic flag (``--min-np``, ``--max-np``,
``--host-discovery-script``, ``--resume``) routes the job to the elastic
driver (:mod:`.elastic_driver`); ``--auto-resume`` supervises that driver
in a child process and resumes it from its journal when it dies.

It is a module, not a console script, so nothing shadows the JAX
package's ``hvdrun``. A job over more than one host with no
``--network-interfaces`` runs the ring NIC probe (:mod:`.network`) and
exports the routable interfaces as ``HOROVOD_IFACE``. ``--tpu-pod`` reads
TPU slice metadata, which a GPU host does not have: it exits 2 saying so.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Callable, List, Optional

from . import config_parser, launcher

TPU_POD_REFUSED = (
    "hvdrun: --tpu-pod derives the allocation from TPU slice metadata "
    "(TPU_WORKER_HOSTNAMES), which a GPU host does not have; use -np with -H or --hostfile")


def _preflight_and_nic_probe(hostnames, controller_host, env, args, fatal=True):
    """SSH pre-flight and ring NIC probe (``horovod_tpu/run/run.py:23-86``,
    reference ``run/run.py:62-115,198-268``); returns the hosts that
    answered. With ``fatal`` (the fixed path) an unreachable host exits 4
    before any rank starts; without (the elastic path, where an
    unreachable host is a state the driver handles by blacklisting) the
    per-host error is printed and only the reachable hosts are returned.
    With more than one host and no pinned
    interface the NICs are probed ring-wise over the HMAC-authenticated
    services and the routable intersection is exported as
    ``HOROVOD_IFACE``; the launcher's store is served on this host's
    address on the first of them (``launcher._store_addr``). A remote rank
    0's probed address goes to ``HOROVOD_PROBED_CONTROLLER_ADDR`` (its
    hostname may not resolve on the other hosts). The probe is
    best-effort: a failed one prints and the launch goes on."""
    from .disk_cache import default_cache

    hostnames = sorted(dict.fromkeys(hostnames))
    reachable = list(hostnames)
    try:
        launcher.check_hosts_reachable(
            hostnames, ssh_port=args.ssh_port,
            cache=None if args.disable_cache else default_cache())
    except RuntimeError as e:
        if fatal:
            print(str(e), file=sys.stderr)
            raise SystemExit(4)
        print(f"[hvdrun] elastic pre-flight: {e}\n[hvdrun] continuing with the reachable "
              f"subset; the driver will retry/blacklist the rest", file=sys.stderr)
        bad = set(getattr(e, "failed_hosts", ()))
        reachable = [h for h in hostnames if h not in bad]
    if args.network_interfaces or len(reachable) < 2:
        return reachable
    from . import network

    try:
        common, host_addrs = network.discover_common_interfaces(
            reachable, ssh_port=args.ssh_port, return_addresses=True)
    except Exception as e:  # noqa: BLE001 - the probe is best-effort
        print(f"[hvdrun] NIC probe failed ({e}); continuing without", file=sys.stderr)
        return reachable
    if not common:
        return reachable
    env["HOROVOD_IFACE"] = ",".join(common)
    if not launcher._is_local(controller_host):
        addrs0 = host_addrs.get(controller_host, {})
        for intf in common:
            if addrs0.get(intf):
                env["HOROVOD_PROBED_CONTROLLER_ADDR"] = addrs0[intf][0][0]
                break
    if args.verbose:
        print(f"[hvdrun] routable interfaces: {common}")
    return reachable


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        "hvdrun", description="Launch a horovod_tpu_torch training job "
                              "(python -m horovod_tpu_torch.run).")
    parser.add_argument("-v", "--version", action="store_true")
    parser.add_argument("-np", "--num-proc", type=int, default=None,
                        help="Total number of training processes.")
    parser.add_argument("-H", "--hosts", default=None,
                        help='Host list, e.g. "host1:4,host2:4".')
    parser.add_argument("--hostfile", default=None,
                        help='Hostfile with lines "hostname slots=N".')
    parser.add_argument("--tpu-pod", action="store_true",
                        help="Refused: TPU slice metadata does not exist on a GPU host.")
    parser.add_argument("-p", "--ssh-port", type=int, default=None)
    parser.add_argument("--output-dir", default=None,
                        help="Write per-rank stdout/stderr files here.")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--check-build", action="store_true",
                        help="Print build capabilities and exit.")
    parser.add_argument("--config-file", default=None)
    # runtime knobs (reference flag set)
    parser.add_argument("--fusion-threshold-mb", type=int, default=None)
    parser.add_argument("--cycle-time-ms", type=float, default=None)
    parser.add_argument("--cache-capacity", type=int, default=None)
    parser.add_argument("--disable-cache", action="store_true", default=None,
                        help="turn the response cache off entirely (same as "
                             "--cache-capacity 0)")
    parser.add_argument("--start-timeout", type=int, default=None,
                        help="seconds to wait for all ranks to register with the "
                             "rendezvous before aborting (HOROVOD_START_TIMEOUT)")
    parser.add_argument("--hierarchical-allreduce", action="store_true", default=None)
    parser.add_argument("--hierarchical-allgather", action="store_true", default=None)
    parser.add_argument("--autotune", action="store_true", default=None)
    parser.add_argument("--autotune-log-file", default=None)
    parser.add_argument("--autotune-warmup-samples", type=int, default=None)
    parser.add_argument("--autotune-steps-per-sample", type=int, default=None)
    parser.add_argument("--autotune-bayes-opt-max-samples", type=int, default=None)
    parser.add_argument("--autotune-gaussian-process-noise", type=float, default=None)
    parser.add_argument("--timeline-filename", default=None)
    parser.add_argument("--timeline-mark-cycles", action="store_true", default=None)
    parser.add_argument("--stall-check-disable", action="store_true", default=None)
    parser.add_argument("--stall-check-time-seconds", type=float, default=None)
    parser.add_argument("--stall-shutdown-time-seconds", type=float, default=None)
    parser.add_argument("--log-level", default=None,
                        choices=["trace", "debug", "info", "warning", "error"])
    # elastic mode (the JAX launcher's flags, horovod_tpu/run/run.py:144-190)
    parser.add_argument("--min-np", type=int, default=None,
                        help="Elastic: minimum processes to keep running (job fails below "
                             "this).")
    parser.add_argument("--max-np", type=int, default=None,
                        help="Elastic: cap on processes even when discovery offers more "
                             "slots.")
    parser.add_argument("--host-discovery-script", default=None,
                        help='Elastic: executable printing one "host:slots" line per '
                             "available host; polled for membership changes.")
    parser.add_argument("--elastic-discovery-interval", type=float, default=1.0,
                        help="Elastic: seconds between discovery polls.")
    parser.add_argument("--blacklist-threshold", type=int, default=3,
                        help="Elastic: worker failures before a host is blacklisted.")
    parser.add_argument("--blacklist-cooldown", type=float, default=None,
                        help="Elastic: seconds a blacklisted host stays quarantined before "
                             "being re-admitted (doubles per relapse; 0 = forever; default "
                             "HOROVOD_BLACKLIST_COOLDOWN_S or 300).")
    parser.add_argument("--elastic-timeout", type=float, default=600.0,
                        help="Elastic: seconds a worker waits for a usable world generation "
                             "before giving up.")
    parser.add_argument("--spares", type=int, default=None,
                        help="Elastic: hot-spare workers kept spawned beyond the world, "
                             "parked before init; a quarantine or death promotes one in the "
                             "same generation bump instead of a respawn (default "
                             "HOROVOD_SPARES or 0).")
    parser.add_argument("--resume", action="store_true",
                        help="Elastic: resume a crashed driver from its journal (needs the "
                             "original --output-dir or HOROVOD_DRIVER_JOURNAL) and adopt the "
                             "surviving workers instead of respawning them.")
    parser.add_argument("--auto-resume", action="store_true",
                        help="Elastic: supervise the driver in a child process and re-launch "
                             "it with --resume when it dies abnormally, up to "
                             "HOROVOD_DRIVER_MAX_RESTARTS (default 3) times. Needs "
                             "--output-dir for the journal.")
    parser.add_argument("--network-interfaces", default=None,
                        help="Comma-separated NICs to use for the control plane.")
    parser.add_argument("--mesh-axes", default=None,
                        help='Mesh spec, e.g. "data:4,model:2" (HOROVOD_TPU_MESH_AXES).')
    parser.add_argument("--serve", action="store_true",
                        help="Inference-serving mode: sets HOROVOD_SERVE=1 for every rank; "
                             "with no command, runs python -m horovod_tpu_torch.serve.")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="Training command to run on every rank.")
    args = parser.parse_args(argv)

    if args.config_file:
        # CLI flags explicitly provided take precedence over YAML
        # (reference override-tracking): anything non-None was set by CLI.
        overridden = {
            k for k, v in vars(args).items()
            if v is not None and k in config_parser.ARG_TO_ENV
        }
        config_parser.parse_config_file(args.config_file, args, overridden)
    return args


def check_build() -> str:
    """The port's build: torch's collective backends, the native core
    (whether g++ is there to build it, whether it is built), and the CUDA
    kernels (whether nvcc is found, whether a card is visible)."""
    import torch
    import torch.distributed as dist

    from .. import __version__
    from ..common import native

    def mark(ok: bool) -> str:
        return "X" if ok else " "

    def nvcc_found() -> bool:
        from ..ops import _build

        try:
            _build._nvcc()
            return True
        except RuntimeError:
            return False

    core_built = os.path.exists(native.library_path()) if native._compiler() else False
    cuda = torch.cuda.is_available()
    lines = [
        f"horovod_tpu_torch v{__version__} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda or 'none'}):",
        "",
        "Available Frameworks:",
        "    [X] PyTorch",
        "    [ ] JAX (the horovod_tpu package)",
        "",
        "Available Controllers:",
        f"    [{mark(native._compiler() is not None)}] native core (cpp/src, built at init"
        f"{'; built' if core_built else ''})",
        "    [ ] MPI",
        "",
        "Available Tensor Operations:",
        f"    [{mark(dist.is_nccl_available())}] NCCL",
        f"    [{mark(dist.is_gloo_available())}] Gloo",
        "    [ ] MPI",
        "",
        "CUDA kernels (horovod_tpu_torch/csrc, built at first use):",
        f"    [{mark(nvcc_found())}] nvcc",
        f"    [{mark(cuda)}] CUDA device"
        + (f" ({torch.cuda.device_count()} x {torch.cuda.get_device_name(0)})" if cuda else ""),
    ]
    return "\n".join(lines)


# The exit code of an UNHANDLED exception in the elastic driver (sysexits
# EX_SOFTWARE): a traceback must not exit 1, the driver's deliberate "job
# failed", or --auto-resume would refuse to resume the very crash the
# journal exists to recover from.
DRIVER_CRASH_RC = 70


def _supervise_driver(argv: List[str], call=None) -> int:
    """``--auto-resume``: run the elastic driver as a child process and
    re-launch it with ``--resume`` whenever it dies abnormally. "Abnormal"
    is any exit the driver does not use for deliberate outcomes (0
    success, 1 job failure, 2 usage, 3 config, 4 unreachable hosts):
    signals, unhandled driver exceptions (``DRIVER_CRASH_RC``) and
    injected driver-kill codes resume. ``HOROVOD_DRIVER_MAX_RESTARTS``
    (default 3) bounds a crash loop."""
    import subprocess

    call = call or (lambda a: subprocess.call(
        [sys.executable, "-m", "horovod_tpu_torch.run", *a]))
    child_args = [a for a in argv if a != "--auto-resume"]
    try:
        max_restarts = int(os.environ.get("HOROVOD_DRIVER_MAX_RESTARTS", "") or 3)
    except ValueError:
        max_restarts = 3
    deliberate = (0, 1, 2, 3, 4)
    restarts = 0
    while True:
        rc = call(child_args)
        if rc in deliberate:
            return rc
        if restarts >= max_restarts:
            print(f"[hvdrun supervisor] driver died abnormally (exit {rc}) and the restart "
                  f"budget ({max_restarts}) is spent", file=sys.stderr)
            return rc
        restarts += 1
        print(f"[hvdrun supervisor] driver died abnormally (exit {rc}); resuming from the "
              f"journal (restart {restarts}/{max_restarts})", file=sys.stderr)
        if "--resume" not in child_args:
            # Before the training command: argparse hands everything after
            # the command's first word to the command (REMAINDER).
            child_args = ["--resume"] + child_args


def _run_elastic(args, command: List[str], env: dict, argv: Optional[List[str]]) -> int:
    """The elastic path (``horovod_tpu/run/run.py:342-420``): the initial
    host set is pre-flighted without being fatal (unreachable hosts are
    dropped; the driver may bring them back), then :class:`ElasticDriver`
    supervises the job."""
    if args.auto_resume:
        return _supervise_driver(argv if argv is not None else sys.argv[1:])
    if args.hostfile:
        hosts = launcher.parse_hostfile(args.hostfile)
    elif args.hosts:
        hosts = launcher.parse_hosts(args.hosts)
    elif args.host_discovery_script:
        hosts = None  # the discovery script is the sole source
    elif args.num_proc:
        hosts = [("localhost", args.num_proc)]
    else:
        print("hvdrun: elastic mode needs -np, -H/--hostfile, or --host-discovery-script",
              file=sys.stderr)
        return 2
    probed_hostset = None
    if hosts:
        reachable = _preflight_and_nic_probe([h for h, _ in hosts], hosts[0][0], env, args,
                                             fatal=False)
        hosts = [(h, c) for h, c in hosts if h in reachable]
        probed_hostset = reachable
        if not hosts:
            print("hvdrun: no initial host is reachable", file=sys.stderr)
            return 4
        # The probed address maps the INITIAL hosts[0]; the driver
        # re-elects rank 0 every generation, so a pin would go stale. The
        # interfaces stay: they are host-set-wide, and the driver re-probes
        # when discovery changes the set.
        env.pop("HOROVOD_PROBED_CONTROLLER_ADDR", None)

    from .elastic_driver import ElasticDriver

    try:
        driver = ElasticDriver(
            command,
            min_np=args.min_np or args.num_proc or 1,
            max_np=args.max_np or args.num_proc or (1 << 30),
            hosts=hosts,
            discovery_script=args.host_discovery_script,
            discovery_interval=args.elastic_discovery_interval,
            env=env,
            output_dir=args.output_dir,
            verbose=args.verbose,
            host_failure_threshold=args.blacklist_threshold,
            ssh_port=args.ssh_port,
            elastic_timeout=args.elastic_timeout,
            nic_pinned=bool(args.network_interfaces),
            probed_hostset=probed_hostset,
            blacklist_cooldown=args.blacklist_cooldown,
            resume=args.resume,
            spares=args.spares,
        )
    except (NotImplementedError, ValueError) as e:
        print(f"hvdrun: {e}", file=sys.stderr)
        return 2
    try:
        return driver.run()
    except SystemExit:
        raise
    except Exception:  # noqa: BLE001 - a crash the supervisor resumes
        import traceback

        traceback.print_exc()
        return DRIVER_CRASH_RC


def run_commandline(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.version:
        from .. import __version__

        print(__version__)
        return 0
    if args.check_build:
        print(check_build())
        return 0
    if args.tpu_pod:
        print(TPU_POD_REFUSED, file=sys.stderr)
        return 2
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command and args.serve:
        # Serving mode's default workload: the built-in HTTP entry point.
        command = [sys.executable, "-m", "horovod_tpu_torch.serve"]
    if not command:
        print("hvdrun: no training command given", file=sys.stderr)
        return 2

    # The runtime knobs' environment, shared by the elastic and fixed paths.
    if args.disable_cache:
        args.cache_capacity = 0
    env = dict(os.environ)
    config_parser.set_env_from_args(env, args)
    if args.network_interfaces:
        env["HOROVOD_IFACE"] = args.network_interfaces
    if args.serve:
        from ..common import env as _env_names

        env[_env_names.HOROVOD_SERVE] = "1"

    # Any elastic flag routes supervision to the ElasticDriver
    # (generation-based re-rendezvous) instead of the fixed fan-out.
    if args.host_discovery_script or args.min_np or args.max_np or args.resume:
        return _run_elastic(args, command, env, argv)
    if args.num_proc is None:
        print("hvdrun: -np is required", file=sys.stderr)
        return 2

    if args.hostfile:
        hosts = launcher.parse_hostfile(args.hostfile)
    elif args.hosts:
        hosts = launcher.parse_hosts(args.hosts)
    else:
        hosts = [("localhost", args.num_proc)]
    try:
        slots = launcher.allocate(hosts, args.num_proc)
    except ValueError as e:
        print(f"hvdrun: {e}", file=sys.stderr)
        return 2
    try:
        _preflight_and_nic_probe([s.hostname for s in slots], slots[0].hostname, env, args)
    except SystemExit as e:
        return e.code
    return launcher.launch_job(command, slots, env=env, ssh_port=args.ssh_port,
                               output_dir=args.output_dir, verbose=args.verbose)


# ---------------------------------------------------------------- run() API
def run(
    fn: Callable,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    np: int = 1,
    hosts: Optional[str] = None,
    env: Optional[dict] = None,
    verbose: bool = False,
) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``np`` ranks and return the list of
    per-rank results (parity with ``horovod.run.run()``). The function is
    shipped with cloudpickle where it is installed, else with plain pickle,
    which ships a function by reference: then ``fn`` must be importable by
    name from a module (not ``__main__``). The package's own directory is
    put on the ranks' ``PYTHONPATH``."""
    import pickle
    import shutil
    import tempfile

    try:
        import cloudpickle as _pickler
    except ImportError:
        _pickler = pickle

    kwargs = kwargs or {}
    workdir = tempfile.mkdtemp(prefix="hvdrun_")
    try:
        fn_path = os.path.join(workdir, "fn.pkl")
        with open(fn_path, "wb") as f:
            _pickler.dump((fn, args, kwargs), f)

        host_list = launcher.parse_hosts(hosts) if hosts else [("localhost", np)]
        slots = launcher.allocate(host_list, np)
        run_env = dict(os.environ)
        if env:
            run_env.update(env)
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        run_env["PYTHONPATH"] = os.pathsep.join(
            [root, run_env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
        run_env["HOROVOD_RUN_FN_FILE"] = fn_path
        run_env["HOROVOD_RUN_RESULT_DIR"] = workdir
        command = [sys.executable, "-m", "horovod_tpu_torch.run.task_runner"]
        rc = launcher.launch_job(command, slots, env=run_env, verbose=verbose)
        if rc != 0:
            raise RuntimeError(f"hvdrun job failed with exit code {rc}")
        results = []
        for slot in slots:
            with open(os.path.join(workdir, f"result.{slot.rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
