"""Client side of the tuning service: blocking and handle-based callers.

``ServiceClient`` owns one socket and speaks the JSON-lines protocol
strictly request→response; it is thread-safe (a lock serializes the
socket) and reconnects lazily, so a client object can outlive daemon
restarts.  Failed responses raise ``ServiceError`` carrying the wire
``code``; transport failures (daemon not running, connection refused,
timeout) raise ``ServiceUnavailable`` — callers like the serve path
catch *that* to fall back to in-process tuning.

Self-healing: ``call`` distinguishes *request never sent* (connect or
send failed — the daemon cannot have acted on it, always safe to retry)
from *response never read* (sent, then the socket died — the daemon may
have already executed it).  The former is retried up to ``retries``
times with exponential backoff + jitter; the latter is retried only for
idempotent operations — reads (``status``/``result``/``stats``/
``health``/``ping``), operations safe to repeat (``cancel``,
``shutdown``), and submits that carry an ``idempotency_key`` (the daemon
dedupes those onto the original request, even across its own restarts).
A bare submit whose response was lost raises ``ServiceUnavailable``
rather than risk a duplicate paid tuning run.

``AsyncServiceClient`` layers fire-and-forget submits on top: every
submit returns a ``PendingTuning`` handle whose ``result()`` blocks only
when the answer is actually needed — the natural shape for a serving
engine that wants tuning off its tick path.  Async submits generate an
idempotency key automatically, so handles survive daemon crashes: the
daemon recovers the request from its journal and ``result()`` rides out
the restart inside its reconnect window.

This is the JAX package's client unchanged, ``submit_serve`` included: it
talks to a daemon of either package.  The port's ``OnlineAutotuner``
routes its drift retunes through it.
"""
from __future__ import annotations

import random
import socket
import threading
import time
import uuid
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from repro_torch.service import protocol as P


class ServiceError(RuntimeError):
    """The daemon refused a request; ``code`` is the wire error code."""

    def __init__(self, message: str, code: str = P.E_INTERNAL,
                 response: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.code = code
        self.response = response or {}


class ServiceUnavailable(ServiceError):
    """No daemon answered (refused / reset / timed out)."""

    def __init__(self, message: str):
        super().__init__(message, code="unavailable")


def parse_address(address: Union[str, Tuple[str, int]]
                  ) -> Tuple[str, int]:
    """``"host:port"`` / ``":port"`` / ``(host, port)`` → ``(host, port)``."""
    if isinstance(address, tuple):
        return address[0], int(address[1])
    host, _, port = address.rpartition(":")
    if not port.isdigit():
        raise ValueError(f"bad service address {address!r} "
                         f"(expected host:port)")
    return host or "127.0.0.1", int(port)


class ServiceClient:
    """Blocking JSON-lines client for one tuning daemon.

    ``retries`` bounds reconnect attempts per call; waits grow
    ``backoff * 2**attempt`` (capped at ``backoff_max``) with up to 50%
    jitter so a daemon restart is not greeted by a synchronized thundering
    herd of clients.  ``deadline`` per call (or the ``timeout`` socket
    default) bounds total wall time including the backoff sleeps.
    """

    def __init__(self, address: Union[str, Tuple[str, int]],
                 timeout: float = 30.0, retries: int = 3,
                 backoff: float = 0.05, backoff_max: float = 2.0,
                 jitter_seed: Optional[int] = None):
        self.host, self.port = parse_address(address)
        self.timeout = float(timeout)
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.backoff_max = float(backoff_max)
        self._rng = random.Random(jitter_seed)
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._rfile = None

    # -- transport -------------------------------------------------------------
    def _connect(self) -> None:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout)
        self._sock = sock
        self._rfile = sock.makefile("rb")

    def _reset(self) -> None:
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._rfile = None

    def close(self) -> None:
        with self._lock:
            self._reset()

    def __enter__(self) -> "ServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _sleep_backoff(self, attempt: int,
                       deadline: Optional[float]) -> None:
        wait = min(self.backoff_max, self.backoff * (2 ** attempt))
        wait *= 1.0 + 0.5 * self._rng.random()
        if deadline is not None:
            wait = min(wait, max(0.0, deadline - time.monotonic()))
        if wait > 0:
            time.sleep(wait)

    def _round_trip(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        """One attempt.  Raises ``(sent, exc)`` info via exception args."""
        sent = False
        try:
            if self._sock is None:
                self._connect()
            self._sock.sendall(P.encode(obj))
            sent = True
            line = P.read_line(self._rfile)
        except (OSError, P.ProtocolError) as exc:
            self._reset()
            raise _TransportFailure(sent, str(exc)) from None
        if line is None:
            self._reset()
            raise _TransportFailure(True, "daemon closed the connection")
        return P.decode(line)

    def call(self, obj: Dict[str, Any], idempotent: bool = False,
             deadline_s: Optional[float] = None) -> Dict[str, Any]:
        """One request→response round trip (no ok-checking), self-healing.

        ``idempotent=True`` allows retrying even after the request may
        have reached the daemon (response lost); otherwise only
        never-sent failures retry.  ``deadline_s`` caps total time spent
        across attempts and backoff waits.
        """
        deadline = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        last = "unavailable"
        with self._lock:
            for attempt in range(self.retries + 1):
                if deadline is not None and time.monotonic() >= deadline:
                    break
                try:
                    return self._round_trip(obj)
                except _TransportFailure as tf:
                    last = tf.detail
                    retryable = idempotent or not tf.sent
                    if not retryable or attempt >= self.retries:
                        if tf.sent and not idempotent:
                            last += (" (request may have been received; "
                                     "not retrying a non-idempotent op)")
                        break
                    self._sleep_backoff(attempt, deadline)
        raise ServiceUnavailable(
            f"tuning service at {self.host}:{self.port} "
            f"unavailable: {last}")

    def _checked(self, obj: Dict[str, Any], idempotent: bool = False,
                 deadline_s: Optional[float] = None) -> Dict[str, Any]:
        resp = self.call(obj, idempotent=idempotent,
                         deadline_s=deadline_s)
        if not resp.get("ok"):
            raise ServiceError(resp.get("error", "request failed"),
                               code=resp.get("code", P.E_INTERNAL),
                               response=resp)
        return resp

    # -- ops -------------------------------------------------------------------
    def ping(self) -> Dict[str, Any]:
        return self._checked({"op": "ping"}, idempotent=True)

    def health(self) -> Dict[str, Any]:
        """Daemon liveness/readiness report (see ``service.health``)."""
        return self._checked({"op": "health"}, idempotent=True)

    # the ops vocabulary calls this the heartbeat; same probe
    heartbeat = health

    def wait_ready(self, timeout: float = 30.0,
                   poll: float = 0.1) -> Dict[str, Any]:
        """Block until the daemon reports ``ready`` (or raise on timeout)."""
        deadline = time.monotonic() + float(timeout)
        last: Dict[str, Any] = {}
        while time.monotonic() < deadline:
            try:
                last = self.health()
                if last.get("ready"):
                    return last
            except ServiceUnavailable:
                pass
            time.sleep(poll)
        raise ServiceUnavailable(
            f"tuning service at {self.host}:{self.port} not ready "
            f"after {timeout}s: {last.get('detail', 'unreachable')}")

    def submit_kernel(self, tenant: str, kernel: str, hardware: str,
                      input: Optional[str] = None,
                      budget: Optional[int] = None, seed: int = 0,
                      searcher: Optional[str] = None,
                      tenant_budget_s: Optional[float] = None,
                      idempotency_key: Optional[str] = None
                      ) -> Dict[str, Any]:
        return self._checked({
            "op": "submit", "kind": "kernel", "tenant": tenant,
            "kernel": kernel, "input": input, "hardware": hardware,
            "budget": budget, "seed": seed, "searcher": searcher,
            "tenant_budget_s": tenant_budget_s,
            "idempotency_key": idempotency_key},
            idempotent=idempotency_key is not None)

    def submit_problem(self, tenant: str, problem: str, hardware: str,
                       params: Optional[Dict[str, Any]] = None,
                       budget: Optional[int] = None, seed: int = 0,
                       searcher: Optional[str] = None,
                       tenant_budget_s: Optional[float] = None,
                       idempotency_key: Optional[str] = None
                       ) -> Dict[str, Any]:
        """Submit any registered ``TuningProblem`` by its ``"kind:name"``
        spec (e.g. ``"sharding:qwen2.5-3b/train_4k"``, ``"serve:p9n9"``,
        ``"kernel:matmul/128"``); ``params`` are forwarded to the
        problem's constructor."""
        return self._checked({
            "op": "submit", "kind": "problem", "tenant": tenant,
            "problem": problem, "params": dict(params or {}),
            "hardware": hardware, "budget": budget, "seed": seed,
            "searcher": searcher, "tenant_budget_s": tenant_budget_s,
            "idempotency_key": idempotency_key},
            idempotent=idempotency_key is not None)

    def submit_serve(self, tenant: str, hardware: str, bucket: str,
                     bucket_shape: Sequence[int],
                     batch_sizes: Sequence[int],
                     max_seqs: Sequence[int],
                     space: str = "serve_online", calib_n: int = 16,
                     stats: Optional[Dict[str, Any]] = None,
                     budget: Optional[int] = None, seed: int = 0,
                     tenant_budget_s: Optional[float] = None,
                     hardware_spec: Optional[Dict[str, Any]] = None,
                     idempotency_key: Optional[str] = None
                     ) -> Dict[str, Any]:
        return self._checked({
            "op": "submit", "kind": "serve", "tenant": tenant,
            "hardware": hardware, "bucket": bucket,
            "bucket_shape": list(bucket_shape),
            "batch_sizes": list(batch_sizes),
            "max_seqs": list(max_seqs), "space": space,
            "calib_n": calib_n, "stats": dict(stats or {}),
            "budget": budget, "seed": seed,
            "tenant_budget_s": tenant_budget_s,
            "hardware_spec": hardware_spec,
            "idempotency_key": idempotency_key},
            idempotent=idempotency_key is not None)

    def status(self, request_id: str) -> Dict[str, Any]:
        return self._checked({"op": "status", "request_id": request_id},
                             idempotent=True)

    def result(self, request_id: str, timeout: Optional[float] = None,
               poll: float = 0.05,
               reconnect_window: float = 60.0) -> Dict[str, Any]:
        """Block until the request resolves; return its result payload.

        Raises ``ServiceError(code="not_done")`` if the request was
        cancelled, ``TimeoutError`` past ``timeout`` seconds.  A daemon
        outage shorter than ``reconnect_window`` is ridden out: the poll
        keeps retrying, so a handle survives a crash + ``--recover``
        restart (the recovered daemon still knows the request id).
        """
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        down_since: Optional[float] = None
        while True:
            try:
                st = self.status(request_id)
                down_since = None
            except ServiceUnavailable:
                now = time.monotonic()
                if down_since is None:
                    down_since = now
                if now - down_since >= reconnect_window or \
                        (deadline is not None and now >= deadline):
                    raise
                time.sleep(min(1.0, poll * 4))
                continue
            if st["state"] == "done":
                return self._checked({"op": "result",
                                      "request_id": request_id},
                                     idempotent=True)
            if st["state"] == "cancelled":
                raise ServiceError(
                    st.get("error") or f"request {request_id} cancelled",
                    code=P.E_NOT_DONE, response=st)
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"request {request_id} still {st['state']} after "
                    f"{timeout}s")
            time.sleep(poll)

    def cancel(self, request_id: str) -> Dict[str, Any]:
        return self._checked({"op": "cancel", "request_id": request_id},
                             idempotent=True)

    def stats(self) -> Dict[str, Any]:
        return self._checked({"op": "stats"}, idempotent=True)

    def shutdown(self, drain: bool = True) -> Dict[str, Any]:
        return self._checked({"op": "shutdown", "drain": drain},
                             idempotent=True)


class _TransportFailure(Exception):
    """Internal: one failed round trip; ``sent`` says whether the request
    bytes left this process before the failure."""

    def __init__(self, sent: bool, detail: str):
        super().__init__(detail)
        self.sent = sent
        self.detail = detail


class PendingTuning:
    """Handle for one submitted request (async client)."""

    def __init__(self, client: ServiceClient, request_id: str,
                 submit_response: Dict[str, Any]):
        self.client = client
        self.request_id = request_id
        self.submit_response = submit_response

    def status(self) -> Dict[str, Any]:
        return self.client.status(self.request_id)

    def done(self) -> bool:
        return self.status()["state"] in ("done", "cancelled")

    def result(self, timeout: Optional[float] = None,
               poll: float = 0.05,
               reconnect_window: float = 60.0) -> Dict[str, Any]:
        return self.client.result(self.request_id, timeout=timeout,
                                  poll=poll,
                                  reconnect_window=reconnect_window)

    def cancel(self) -> Dict[str, Any]:
        return self.client.cancel(self.request_id)


class AsyncServiceClient:
    """Handle-based wrapper: submits return ``PendingTuning``.

    Every submit carries an idempotency key (caller's, or a generated
    uuid), so a retried/resubmitted request can never fork into two paid
    tuning runs and handles stay valid across daemon crash-recovery.
    """

    def __init__(self, address: Union[str, Tuple[str, int]],
                 timeout: float = 30.0, **client_kwargs):
        self.client = ServiceClient(address, timeout=timeout,
                                    **client_kwargs)

    def submit_kernel(self, *args, **kwargs) -> PendingTuning:
        kwargs.setdefault("idempotency_key", uuid.uuid4().hex)
        resp = self.client.submit_kernel(*args, **kwargs)
        return PendingTuning(self.client, resp["request_id"], resp)

    def submit_serve(self, *args, **kwargs) -> PendingTuning:
        kwargs.setdefault("idempotency_key", uuid.uuid4().hex)
        resp = self.client.submit_serve(*args, **kwargs)
        return PendingTuning(self.client, resp["request_id"], resp)

    def submit_problem(self, *args, **kwargs) -> PendingTuning:
        kwargs.setdefault("idempotency_key", uuid.uuid4().hex)
        resp = self.client.submit_problem(*args, **kwargs)
        return PendingTuning(self.client, resp["request_id"], resp)

    def stats(self) -> Dict[str, Any]:
        return self.client.stats()

    def health(self) -> Dict[str, Any]:
        return self.client.health()

    def close(self) -> None:
        self.client.close()

    def __enter__(self) -> "AsyncServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
