"""HMAC-authenticated TCP request/response services for launcher-time
coordination: task registration, ring-wise NIC reachability probing, and
remote command execution.

The port of ``horovod_tpu/run/network.py`` (the same services, messages,
frame format and service names). Parity surface (behavior, not code) with
the reference launcher's probe plane:

- secret key + HMAC-SHA256 digest framing — ``run/common/util/secret.py:26-36``
- ``Wire`` message format (digest | length | pickled body) —
  ``run/common/util/network.py`` ``Wire`` class
- driver service collecting per-task addresses and host hashes, task
  services pinged ring-wise with *interface matching* to weed out NAT'ed /
  unroutable interfaces — ``run/driver/driver_service.py``,
  ``run/task/task_service.py``, ``run/task_fn.py:1-67``

The launcher runs the probe for a job over more than one host without
``--network-interfaces`` and exports the routable intersection as
``HOROVOD_IFACE``; the job's store is then served on the launcher host's
address on the first of those interfaces (``launcher._store_addr``). Every
client request passes the fault plan's ``rpc`` tap and is retried under
:mod:`..fault.backoff`.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import hmac
import logging
import os
import pickle
import socket
import socketserver
import struct
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import metrics as _metrics
from ..fault import injector as _fault
from ..fault.backoff import Backoff, retry_call

logger = logging.getLogger("horovod_tpu_torch.run")

SECRET_LENGTH = 32
DIGEST_LENGTH = 32
SECRET_ENV = "HOROVOD_SECRET_KEY"
MAX_MESSAGE_BYTES = 64 * 1024 * 1024
# Server-side wait window for rendezvous phases that block on a peer
# (replaces the old hardcoded 60 s); see common/env.py.
COORD_WAIT_TIMEOUT_ENV = "HOROVOD_COORD_WAIT_TIMEOUT_S"


def coord_wait_timeout(default: float = 60.0) -> float:
    try:
        return float(os.environ.get(COORD_WAIT_TIMEOUT_ENV, "") or default)
    except ValueError:
        return default


def make_secret_key() -> bytes:
    return os.urandom(SECRET_LENGTH)


def compute_digest(key: bytes, message: bytes) -> bytes:
    return hmac.new(key, message, hashlib.sha256).digest()


def check_digest(key: bytes, message: bytes, digest: bytes) -> bool:
    return hmac.compare_digest(compute_digest(key, message), digest)


def encode_key(key: bytes) -> str:
    return key.hex()


def decode_key(text: str) -> bytes:
    return bytes.fromhex(text)


class WireError(Exception):
    """Digest mismatch or malformed frame."""


class Wire:
    """digest(32) | body_len(4, network order) | pickled body.

    Every frame is authenticated with HMAC-SHA256 before unpickling — an
    unauthenticated peer cannot reach the pickle layer.
    """

    def __init__(self, key: bytes):
        self._key = key

    def write(self, obj: Any, wfile) -> None:
        body = pickle.dumps(obj)
        wfile.write(compute_digest(self._key, body))
        wfile.write(struct.pack("!I", len(body)))
        wfile.write(body)
        wfile.flush()

    def read(self, rfile) -> Any:
        digest = _read_exact(rfile, DIGEST_LENGTH)
        (length,) = struct.unpack("!I", _read_exact(rfile, 4))
        if length > MAX_MESSAGE_BYTES:
            raise WireError(f"frame too large: {length} bytes")
        body = _read_exact(rfile, length)
        if not check_digest(self._key, body, digest):
            raise WireError("security error: digest did not match the message")
        return pickle.loads(body)


def _read_exact(rfile, n: int) -> bytes:
    chunks = []
    remaining = n
    while remaining:
        chunk = rfile.read(remaining)
        if not chunk:
            raise EOFError("connection closed mid-frame")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


# --- messages -------------------------------------------------------------


class PingRequest:
    pass


@dataclass
class PingResponse:
    service_name: str
    source_address: str


@dataclass
class AckResponse:
    pass


@dataclass
class RegisterTaskRequest:
    index: int
    addresses: Dict[str, List[Tuple[str, int]]]
    host_hash: str


@dataclass
class AllTaskAddressesRequest:
    index: int


@dataclass
class AllTaskAddressesResponse:
    addresses: Dict[str, List[Tuple[str, int]]]


@dataclass
class RegisterTaskToTaskAddressesRequest:
    index: int
    addresses: Dict[str, List[Tuple[str, int]]]


@dataclass
class AddressCheckFinishedSignal:
    index: int


@dataclass
class RunCommandRequest:
    command: str
    env: Dict[str, str]


@dataclass
class CommandExitCodeRequest:
    pass


@dataclass
class CommandExitCodeResponse:
    terminated: bool
    exit_code: Optional[int]


@dataclass
class ErrorResponse:
    """Structured server-side failure: the handler's error travels back to
    the client instead of dying as a silent EOF (the client would
    otherwise fail over to other addresses and eventually report the
    wrong thing)."""

    message: str
    kind: str = "error"  # "error" | "timeout"


class NoValidAddressesFound(Exception):
    pass


class RPCUnavailableError(ConnectionError):
    """A control-plane RPC endpoint could not be reached within the retry
    budget. Subclasses ConnectionError so existing transport-failure
    handling still matches, while the message names the endpoints, how
    long they have been failing across consecutive sends, and the retry
    budget spent. Raised ``from`` the final transport error instead of
    rebuilding it — reconstructing an OSError subclass from a bare
    string loses ``errno`` (and would TypeError on exception types
    without a one-string constructor)."""


class RemoteTimeoutError(RuntimeError):
    """A rendezvous phase timed out ON THE SERVER (e.g. a peer task never
    registered). Deliberately not an OSError/TimeoutError: the server
    already waited out the configured window, so the client-side retry
    budget must NOT spin on it."""


# --- interface enumeration ------------------------------------------------


def local_addresses(nic: Optional[str] = None) -> Dict[str, List[Tuple[str, int]]]:
    """Map interface name → [(ipv4_addr, port)] for a given bound port.

    Port is filled in by the service; this returns addr stubs with port 0.
    Mirrors the psutil enumeration the reference services use to advertise
    every candidate interface; falls back to an ioctl(SIOCGIFADDR)
    enumeration when psutil is absent (it is not a hard dependency).
    """
    result: Dict[str, List[Tuple[str, int]]] = {}
    try:
        import psutil

        for intf, addrs in psutil.net_if_addrs().items():
            if nic and intf != nic:
                continue
            for a in addrs:
                if a.family == socket.AF_INET:
                    result.setdefault(intf, []).append((a.address, 0))
        return result
    except ImportError:
        pass
    import fcntl

    for _, intf in socket.if_nameindex():
        if nic and intf != nic:
            continue
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            try:
                packed = fcntl.ioctl(
                    s.fileno(),
                    0x8915,  # SIOCGIFADDR
                    struct.pack("256s", intf.encode()[:15]),
                )
                addr = socket.inet_ntoa(packed[20:24])
                result.setdefault(intf, []).append((addr, 0))
            except OSError:
                continue  # interface without an IPv4 address
    return result


# --- services -------------------------------------------------------------


class BasicService:
    """Threaded TCP server answering one authenticated request per
    connection. Subclasses extend ``_handle``."""

    def __init__(self, service_name: str, key: bytes, nic: Optional[str] = None):
        self._service_name = service_name
        self._wire = Wire(key)
        self._nic = nic
        service = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    req = service._wire.read(self.rfile)
                    try:
                        resp = service._handle(req, self.client_address)
                        if resp is None:
                            raise RuntimeError("handler returned no response")
                    except TimeoutError as exc:
                        # A phase timeout is an ANSWER, not a dropped
                        # connection: ship it back so the client can name
                        # the phase and the missing peers.
                        resp = ErrorResponse(str(exc), kind="timeout")
                    service._wire.write(resp, self.wfile)
                except (EOFError, WireError):
                    pass  # unauthenticated / truncated client; drop quietly

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._cond = threading.Condition()
        self._server = _Server(("0.0.0.0", 0), _Handler)
        self._port = self._server.socket.getsockname()[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        # NOT started here: a request racing in before a subclass finished
        # initializing its own state would crash the handler. Subclass
        # __init__ (or the creator, for a bare BasicService) calls start().

    def start(self) -> None:
        if not self._thread.is_alive():
            self._thread.start()

    @property
    def port(self) -> int:
        return self._port

    def addresses(self) -> Dict[str, List[Tuple[str, int]]]:
        out = {}
        for intf, addrs in local_addresses(self._nic).items():
            out[intf] = [(a, self._port) for a, _ in addrs]
        return out

    def _handle(self, req: Any, client_address) -> Any:
        if isinstance(req, PingRequest):
            return PingResponse(self._service_name, client_address[0])
        raise RuntimeError(
            f"{self._service_name}: unknown request {type(req).__name__}"
        )

    def shutdown(self) -> None:
        if self._thread.is_alive():
            # socketserver.shutdown() blocks on an event that only
            # serve_forever() sets — calling it on a never-started server
            # would deadlock; just close the socket in that case.
            self._server.shutdown()
        self._server.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5)


class BasicClient:
    """Connects to the first reachable advertised address; with
    ``match_intf=True`` keeps only interfaces whose service-visible source
    address proves a working route (the reference's NAT-weeding check)."""

    def __init__(
        self,
        service_name: str,
        addresses: Dict[str, List[Tuple[str, int]]],
        key: bytes,
        match_intf: bool = False,
        retries: int = 3,
        timeout: float = 5.0,
    ):
        self._service_name = service_name
        self._wire = Wire(key)
        self._timeout = timeout
        # Control-plane RPC retry budget (HOROVOD_RPC_* knobs): a dropped
        # or delayed message costs one backoff, not the job.
        self._backoff = Backoff.from_env()
        # First instant of the current consecutive-failure streak: a
        # dead peer reads as "endpoint down for Ns", not a bare error.
        self._down_since: Optional[float] = None
        self._addresses = self._probe(addresses, match_intf, retries)
        if not self._addresses:
            raise NoValidAddressesFound(
                f"no usable address for {service_name!r} among {addresses}"
            )

    def _endpoints(self) -> str:
        """Compact 'host:port' list of the verified addresses, for error
        messages (which endpoint was actually dialed and found dead)."""
        flat = sorted({
            f"{a}:{p}" for addrs in self._addresses.values()
            for a, p in addrs
        })
        return ",".join(flat) or "<no-verified-address>"

    def addresses(self) -> Dict[str, List[Tuple[str, int]]]:
        return self._addresses

    def _probe(self, addresses, match_intf: bool, retries: int):
        """Probe every advertised address concurrently so one dead NIC
        (the exact case match_intf exists to weed out) costs max-over-
        addresses wall-clock, not sum — sequential retries x 5s against
        two unroutable interfaces would blow the callers' 60s barriers."""
        local = local_addresses() if match_intf else {}
        # Unreachable addresses time out on connect; a short connect
        # budget per attempt keeps the worst case well under the ring
        # barriers while reachable peers answer in milliseconds.
        probe_timeout = min(self._timeout, 2.0)

        def probe_one(intf, addr):
            for _ in range(retries):
                try:
                    resp = self._request(
                        PingRequest(), addr, connect_timeout=probe_timeout
                    )
                except (OSError, EOFError, WireError):
                    continue
                if not isinstance(resp, PingResponse):
                    continue
                if resp.service_name != self._service_name:
                    return False  # a different service answered; wrong port
                if match_intf:
                    # NAT weeding (reference network.py match_intf): the
                    # source address the *server* saw must belong to our
                    # own same-named interface — i.e. reaching the peer's
                    # intf X must route out of our intf X.
                    own = {a for a, _ in local.get(intf, [])}
                    if resp.source_address not in own:
                        return False
                return True
            return False

        flat = [(intf, addr) for intf, addrs in addresses.items()
                for addr in addrs]
        if not flat:
            return {}
        with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(16, len(flat))
        ) as pool:
            results = list(pool.map(lambda ia: probe_one(*ia), flat))

        usable: Dict[str, List[Tuple[str, int]]] = {}
        for (intf, addr), ok in zip(flat, results):
            if ok:
                usable.setdefault(intf, []).append(addr)
        # Keep the verified subset even when some advertised addresses on
        # an interface failed (e.g. a stale alias): every address in
        # `usable` proved a working route, which is what callers need.
        return usable

    def _request(self, req: Any, addr: Tuple[str, int],
                 timeout: Optional[float] = None,
                 connect_timeout: Optional[float] = None) -> Any:
        if _fault.ACTIVE:
            # Chaos tap: a 'drop' here raises before the socket opens (a
            # lost request); retries re-enter the tap with a fresh hit
            # count, so bounded drop bursts are survivable by design.
            directive = _fault.fault_point("rpc", type(req).__name__)
        else:
            directive = None
        repeats = 2 if directive == "duplicate" else 1
        for _ in range(repeats):
            with socket.create_connection(
                addr,
                timeout=connect_timeout if connect_timeout is not None
                else self._timeout,
            ) as sock:
                # A request the server intentionally blocks on (e.g. the
                # driver's wait-for-peer-registration) needs a read window
                # longer than the connect default.
                sock.settimeout(timeout if timeout is not None else self._timeout)
                rfile = sock.makefile("rb")
                wfile = sock.makefile("wb")
                self._wire.write(req, wfile)
                resp = self._wire.read(rfile)
        if isinstance(resp, ErrorResponse):
            if resp.kind == "timeout":
                raise RemoteTimeoutError(resp.message)
            raise RuntimeError(resp.message)
        return resp

    def send(self, req: Any, timeout: Optional[float] = None) -> Any:
        """One authenticated request/response, sweeping every verified
        address, with bounded exponential-backoff retries around the whole
        sweep (``HOROVOD_RPC_RETRIES`` / ``HOROVOD_RPC_BACKOFF_*``)."""
        req_name = type(req).__name__
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_rpc_requests_total", request=req_name)

        def sweep() -> Any:
            last_err: Optional[Exception] = None
            for addrs in self._addresses.values():
                for addr in addrs:
                    try:
                        return self._request(req, addr, timeout=timeout)
                    except (OSError, EOFError, WireError) as e:
                        # EOF = server handler raised and closed without a
                        # response; try the remaining advertised addresses.
                        last_err = e
            raise last_err or NoValidAddressesFound(self._service_name)

        def on_retry(attempt, exc, delay):
            if _metrics.ACTIVE:
                _metrics.TAP.inc("hvd_rpc_retries_total", request=req_name)
            logger.warning(
                "%s: %s failed (%s); retry %d in %.2fs",
                self._service_name, req_name, exc, attempt + 1, delay,
            )

        import time as _time

        try:
            result = retry_call(
                sweep,
                retryable=(OSError, EOFError, WireError),
                backoff=self._backoff,
                describe=(
                    f"{self._service_name} at {self._endpoints()}: "
                    f"{req_name}"
                ),
                on_retry=on_retry,
            )
        except RemoteTimeoutError:
            self._down_since = None  # the server answered; it is up
            if _metrics.ACTIVE:
                _metrics.TAP.inc("hvd_rpc_timeouts_total", request=req_name)
            raise
        except (OSError, EOFError, WireError) as exc:
            now = _time.monotonic()
            if self._down_since is None:
                self._down_since = now
            if _metrics.ACTIVE:
                _metrics.TAP.inc("hvd_rpc_failures_total", request=req_name)
            raise RPCUnavailableError(
                f"{exc} [endpoint {self._endpoints()} failing for "
                f"{now - self._down_since:.1f}s; retry budget "
                f"{self._backoff.retries + 1} attempts spent]"
            ) from exc
        except Exception:
            if _metrics.ACTIVE:
                _metrics.TAP.inc("hvd_rpc_failures_total", request=req_name)
            raise
        self._down_since = None
        return result


class DriverService(BasicService):
    """Collects per-task registrations (addresses + host hash) and
    task→next-task verified addresses (``run/driver/driver_service.py``
    semantics)."""

    NAME = "horovod_tpu driver service"

    def __init__(self, num_tasks: int, key: bytes, nic: Optional[str] = None,
                 wait_timeout: Optional[float] = None):
        super().__init__(self.NAME, key, nic)
        self._num_tasks = num_tasks
        # Honors HOROVOD_COORD_WAIT_TIMEOUT_S (or the launcher-plumbed
        # value) instead of the old hardcoded 60 s.
        self._wait_timeout = (
            coord_wait_timeout() if wait_timeout is None else wait_timeout
        )
        self._task_addrs: Dict[int, Dict[str, List[Tuple[str, int]]]] = {}
        self._task_to_task_addrs: Dict[int, Dict[str, List[Tuple[str, int]]]] = {}
        self._host_hashes: Dict[int, str] = {}
        self.start()

    def _handle(self, req: Any, client_address) -> Any:
        if isinstance(req, RegisterTaskRequest):
            with self._cond:
                self._task_addrs[req.index] = req.addresses
                self._host_hashes[req.index] = req.host_hash
                self._cond.notify_all()
            return AckResponse()
        if isinstance(req, AllTaskAddressesRequest):
            with self._cond:
                ok = self._cond.wait_for(
                    lambda: req.index in self._task_addrs,
                    timeout=self._wait_timeout,
                )
                addrs = self._task_addrs.get(req.index)
                registered = sorted(self._task_addrs)
            if not ok or addrs is None:
                # Travels back to the asking task as an ErrorResponse —
                # it raises RemoteTimeoutError naming the phase and the
                # missing peer instead of silently proceeding.
                raise TimeoutError(
                    "rendezvous phase 'all-task-addresses' timed out "
                    f"after {self._wait_timeout:g}s: task {req.index} "
                    f"never registered (registered tasks: {registered})"
                )
            return AllTaskAddressesResponse(addrs)
        if isinstance(req, RegisterTaskToTaskAddressesRequest):
            with self._cond:
                self._task_to_task_addrs[req.index] = req.addresses
                self._cond.notify_all()
            return AckResponse()
        return super()._handle(req, client_address)

    def wait_for_initial_registration(self, timeout: Optional[float] = None) -> None:
        timeout = self._wait_timeout if timeout is None else timeout
        with self._cond:
            ok = self._cond.wait_for(
                lambda: len(self._task_addrs) >= self._num_tasks, timeout=timeout
            )
            missing = sorted(
                set(range(self._num_tasks)) - set(self._task_addrs)
            )
        if not ok:
            raise TimeoutError(
                "rendezvous phase 'initial-registration' timed out after "
                f"{timeout:g}s; tasks never registered: {missing}"
            )

    def wait_for_task_to_task_addresses(self, timeout: Optional[float] = None) -> None:
        timeout = self._wait_timeout if timeout is None else timeout
        with self._cond:
            ok = self._cond.wait_for(
                lambda: len(self._task_to_task_addrs) >= self._num_tasks,
                timeout=timeout,
            )
            missing = sorted(
                set(range(self._num_tasks)) - set(self._task_to_task_addrs)
            )
        if not ok:
            raise TimeoutError(
                "rendezvous phase 'ring-address-check' timed out after "
                f"{timeout:g}s; tasks that never reported verified "
                f"addresses: {missing}"
            )

    def task_addresses_for(self, index: int):
        with self._cond:
            return dict(self._task_addrs.get(index, {}))

    def host_hashes(self) -> Dict[int, str]:
        with self._cond:
            return dict(self._host_hashes)

    def common_interfaces(self) -> List[str]:
        """Interfaces proven routable on every ring hop — the intersection
        the reference computes in ``run/run.py:198-268``."""
        with self._cond:
            sets = [set(v.keys()) for v in self._task_to_task_addrs.values()]
        if not sets:
            return []
        common = set.intersection(*sets)
        return sorted(common)


class TaskService(BasicService):
    """Per-task probe service: answers pings (interface matching), relays
    the ring 'address check finished' signal, and can run a shell command
    on behalf of the driver (``run/common/service/task_service.py``
    semantics — used by the Spark integration's rsh agent)."""

    NAME_FORMAT = "horovod_tpu task service #%d"

    def __init__(self, index: int, key: bytes, nic: Optional[str] = None):
        super().__init__(self.NAME_FORMAT % index, key, nic)
        self.index = index
        self._check_finished = False
        self._command_exit: Optional[int] = None
        self._command_started = False
        self.start()

    def _handle(self, req: Any, client_address) -> Any:
        if isinstance(req, AddressCheckFinishedSignal):
            with self._cond:
                self._check_finished = True
                self._cond.notify_all()
            return AckResponse()
        if isinstance(req, RunCommandRequest):
            self._start_command(req.command, req.env)
            return AckResponse()
        if isinstance(req, CommandExitCodeRequest):
            with self._cond:
                return CommandExitCodeResponse(
                    terminated=self._command_started
                    and self._command_exit is not None,
                    exit_code=self._command_exit,
                )
        return super()._handle(req, client_address)

    def _start_command(self, command: str, env: Dict[str, str]) -> None:
        from . import safe_shell_exec

        def _run():
            # ManagedProcess directly: safe_shell_exec.execute() installs
            # signal handlers, which is main-thread-only.
            mp = safe_shell_exec.ManagedProcess(
                command, env={**os.environ, **env}, shell=True
            )
            code = mp.wait()
            with self._cond:
                self._command_exit = code
                self._cond.notify_all()

        with self._cond:
            self._command_started = True
        threading.Thread(target=_run, daemon=True).start()

    def wait_for_address_check_finished(self, timeout: float = 60.0) -> None:
        with self._cond:
            ok = self._cond.wait_for(lambda: self._check_finished, timeout=timeout)
        if not ok:
            raise TimeoutError(f"task {self.index}: ring check signal missing")

    def wait_for_command_exit(self, timeout: Optional[float] = None) -> int:
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._command_exit is not None, timeout=timeout
            )
        if not ok:
            raise TimeoutError("command did not terminate")
        return int(self._command_exit)  # type: ignore[arg-type]


class DriverClient(BasicClient):
    def __init__(self, addresses, key, match_intf: bool = False, retries: int = 3):
        super().__init__(DriverService.NAME, addresses, key, match_intf, retries)

    def register_task(self, index, addresses, host_hash) -> None:
        self.send(RegisterTaskRequest(index, addresses, host_hash))

    def all_task_addresses(self, index):
        # The driver blocks up to its configured wait window for the peer
        # to register (slow ssh spawn); the read window must outlast it.
        return self.send(
            AllTaskAddressesRequest(index),
            timeout=coord_wait_timeout() + 5.0,
        ).addresses

    def register_task_to_task_addresses(self, index, addresses) -> None:
        self.send(RegisterTaskToTaskAddressesRequest(index, addresses))


class TaskClient(BasicClient):
    def __init__(self, index, addresses, key, match_intf=False, retries=3):
        super().__init__(
            TaskService.NAME_FORMAT % index, addresses, key, match_intf, retries
        )
        self.index = index

    def signal_address_check_finished(self) -> None:
        self.send(AddressCheckFinishedSignal(self.index))

    def run_command(self, command: str, env: Dict[str, str]) -> None:
        self.send(RunCommandRequest(command, env))

    def command_exit_code(self) -> CommandExitCodeResponse:
        return self.send(CommandExitCodeRequest())


def host_hash() -> str:
    """Stable identifier grouping tasks that share a host (the reference
    hashes hostname; same-hash tasks share local_rank space)."""
    return hashlib.md5(socket.gethostname().encode()).hexdigest()


def run_task_probe(
    index: int,
    num_tasks: int,
    driver_addresses: Dict[str, List[Tuple[str, int]]],
    key: bytes,
    nic: Optional[str] = None,
    timeout: float = 60.0,
) -> None:
    """One task's side of the ring NIC probe (``run/task_fn.py:23-53``):
    register with the driver, ping the next task with interface matching,
    report the verified addresses, pass the baton."""
    task = TaskService(index, key, nic)
    try:
        driver = DriverClient(driver_addresses, key)
        driver.register_task(index, task.addresses(), host_hash())
        next_index = (index + 1) % num_tasks
        next_addresses = driver.all_task_addresses(next_index)
        next_task = TaskClient(
            next_index, next_addresses, key, match_intf=True, retries=10
        )
        driver.register_task_to_task_addresses(
            next_index, next_task.addresses()
        )
        next_task.signal_address_check_finished()
        task.wait_for_address_check_finished(timeout)
    finally:
        task.shutdown()


def interface_address(name: str) -> Optional[str]:
    """First IPv4 address bound to interface ``name`` (None if absent)."""
    addrs = local_addresses(name).get(name)
    return addrs[0][0] if addrs else None


def discover_common_interfaces(
    hosts: Sequence[str],
    *,
    key: Optional[bytes] = None,
    ssh_launch=None,
    ssh_port: Optional[int] = None,
    timeout: float = 60.0,
    return_addresses: bool = False,
) -> Any:
    """Driver-side orchestration: start a DriverService, launch one probe
    task per host (via ``ssh_launch(host, command_argv, env)`` or locally),
    and return the interface names routable around the whole ring.

    With ``return_addresses=True`` also returns each host's registered
    per-interface addresses, ``{host: {intf: [(addr, port), ...]}}`` —
    the launcher uses these to dial rank 0's controller by its probed
    routable address rather than its (possibly unresolvable) hostname."""
    import subprocess
    import sys

    key = key or make_secret_key()
    driver = DriverService(len(hosts), key, wait_timeout=timeout)
    procs = []
    try:
        addrs = driver.addresses()
        for i, host in enumerate(hosts):
            argv = [
                sys.executable,
                "-m",
                "horovod_tpu_torch.run.probe",
                str(i),
                str(len(hosts)),
            ]
            env = {
                **os.environ,
                SECRET_ENV: encode_key(key),
                "HOROVOD_PROBE_DRIVER_ADDRS": repr_addresses(addrs),
            }
            from .launcher import _is_local

            if _is_local(host):
                procs.append(subprocess.Popen(argv, env=env))
            elif ssh_launch is not None:
                procs.append(ssh_launch(host, argv, env))
            else:
                import shlex

                # The secret is shipped over ssh's stdin, never on the
                # command line — argv is visible to every user via ps.
                env_str = " ".join(
                    f"{k}={shlex.quote(v)}"
                    for k, v in env.items()
                    if k != SECRET_ENV
                    and k.startswith(("HOROVOD_", "PATH", "PYTHONPATH"))
                )
                remote = (
                    f"IFS= read -r _HVDKEY; {env_str} {SECRET_ENV}=\"$_HVDKEY\" "
                    f"{' '.join(shlex.quote(a) for a in argv)}"
                )
                from .launcher import ssh_base_cmd

                p = subprocess.Popen(
                    ssh_base_cmd(host, ssh_port) + [remote],
                    stdin=subprocess.PIPE,
                )
                p.stdin.write((encode_key(key) + "\n").encode())
                p.stdin.close()
                procs.append(p)
        driver.wait_for_initial_registration(timeout)
        driver.wait_for_task_to_task_addresses(timeout)
        common = driver.common_interfaces()
        if return_addresses:
            host_addrs = {
                host: driver.task_addresses_for(i)
                for i, host in enumerate(hosts)
            }
            return common, host_addrs
        return common
    finally:
        deadline = 3.0  # grace for clean exits, shared across all procs
        import time as _time

        t0 = _time.monotonic()
        for p in procs:
            remaining = max(0.0, deadline - (_time.monotonic() - t0))
            try:
                p.wait(timeout=remaining)
            except Exception:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=5)  # reap; no zombies for the driver lifetime
            except Exception:
                pass
        driver.shutdown()


def repr_addresses(addrs: Dict[str, List[Tuple[str, int]]]) -> str:
    return ";".join(
        f"{intf}={','.join(f'{a}:{p}' for a, p in lst)}"
        for intf, lst in addrs.items()
    )


def parse_addresses(text: str) -> Dict[str, List[Tuple[str, int]]]:
    out: Dict[str, List[Tuple[str, int]]] = {}
    for part in filter(None, text.split(";")):
        intf, _, rest = part.partition("=")
        for item in filter(None, rest.split(",")):
            host, _, port = item.rpartition(":")
            out.setdefault(intf, []).append((host, int(port)))
    return out
