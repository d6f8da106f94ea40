"""JSON-lines wire protocol for the tuning service.

One request per line, one response per line, strictly in order per
connection.  Every request is a JSON object with an ``"op"`` field; every
response carries ``"ok": true/false`` plus op-specific payload, and failed
ones add ``"error"`` (human-readable) and ``"code"`` (machine-checkable).

Ops
---
``ping``      liveness probe; echoes the protocol version.
``submit``    enqueue a tuning request for a tenant.  Three kinds:
              ``kind="kernel"`` names a registry benchmark
              (kernel / input / hardware), ``kind="serve"`` describes an
              online-serving space (batch_sizes × max_seqs + bucket shape)
              so drift retunes from ``OnlineAutotuner`` route through the
              shared fleet, and ``kind="problem"`` names any registered
              ``TuningProblem`` as a ``"kind:name"`` spec (e.g.
              ``"sharding:qwen2.5-3b/train_4k"``) plus optional ``params``,
              resolved through ``repro.tuning.problem``.  Responds with a
              request id immediately; a store hit resolves it inline with
              ``trials == 0``.
``status``    poll a request id: state + progress meters.
``result``    fetch the final entry for a *done* request.
``cancel``    abandon a queued or running request.
``stats``     daemon-wide snapshot: fleet progress, tenants, store size.
``health``    liveness + readiness: fleet loop alive, store writable,
              journal fsync lag, draining flag (heartbeat probe).
``shutdown``  stop accepting work; ``drain=true`` (default) finishes
              in-flight trials first.

Crash safety (protocol v2): a ``submit`` may carry a client-supplied
``idempotency_key`` (unique per logical request, per tenant).  A retried
submit after a timeout, socket drop, or daemon restart then DEDUPES onto
the original request instead of spawning a duplicate tuning run — the
response echoes the original request id with ``deduped: true``.  Without
a key, a retried submit is a new request (at-least-once semantics).

The protocol is deliberately version-tagged and flat (no nesting beyond
one level) so non-Python tenants can speak it with any JSON library.

This is the JAX package's protocol byte for byte, its wire name
(``PROTOCOL``) included, so a client of either package talks to a daemon
of either.  The port's daemon prices ``kind="serve"`` submits and
``sharding:`` / ``serve:`` problem submits as the JAX daemon does.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

PROTOCOL = "repro.tuning-service"
PROTOCOL_VERSION = 2     # v2: idempotency_key on submit + health op

# Guard against a hostile/broken peer streaming an unbounded line.
MAX_LINE_BYTES = 1 << 20

OPS = ("ping", "submit", "status", "result", "cancel", "stats", "health",
       "shutdown")
SUBMIT_KINDS = ("kernel", "serve", "problem")

# Machine-checkable error codes (the ``code`` field of failed responses).
E_BAD_REQUEST = "bad_request"        # malformed JSON / failed validation
E_UNKNOWN_OP = "unknown_op"
E_UNKNOWN_REQUEST = "unknown_request"   # no such request id
E_UNKNOWN_KERNEL = "unknown_kernel"     # registry has no such kernel/input
E_UNKNOWN_PROBLEM = "unknown_problem"   # problem registry has no such spec
E_ADMISSION = "admission_denied"        # tenant/queue limits hit
E_BUDGET = "budget_exhausted"           # tenant worker-seconds budget spent
E_DRAINING = "draining"                 # daemon is shutting down
E_NOT_DONE = "not_done"                 # result requested before completion
E_INTERNAL = "internal"


class ProtocolError(ValueError):
    """A request that cannot be parsed or fails validation."""

    def __init__(self, message: str, code: str = E_BAD_REQUEST):
        super().__init__(message)
        self.code = code


def encode(obj: Dict[str, Any]) -> bytes:
    """Serialize one protocol message to a newline-terminated line."""
    return (json.dumps(obj, separators=(",", ":"), sort_keys=True)
            + "\n").encode("utf-8")


def decode(line: bytes) -> Dict[str, Any]:
    """Parse one wire line into a message dict (``ProtocolError`` if not)."""
    if len(line) > MAX_LINE_BYTES:
        raise ProtocolError(f"line exceeds {MAX_LINE_BYTES} bytes")
    try:
        obj = json.loads(line.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ProtocolError(f"bad JSON: {exc}") from None
    if not isinstance(obj, dict):
        raise ProtocolError("message must be a JSON object")
    return obj


def ok(**payload: Any) -> Dict[str, Any]:
    resp: Dict[str, Any] = {"ok": True}
    resp.update(payload)
    return resp


def err(message: str, code: str = E_BAD_REQUEST, **payload: Any
        ) -> Dict[str, Any]:
    resp: Dict[str, Any] = {"ok": False, "error": message, "code": code}
    resp.update(payload)
    return resp


def _want(obj: Dict[str, Any], field: str, types: Tuple[type, ...],
          required: bool = True, default: Any = None) -> Any:
    if field not in obj or obj[field] is None:
        if required:
            raise ProtocolError(f"missing field {field!r}")
        return default
    val = obj[field]
    # bool is an int subclass; never accept it where a number is wanted.
    if isinstance(val, bool) and bool not in types:
        raise ProtocolError(f"field {field!r}: expected "
                            f"{'/'.join(t.__name__ for t in types)}, "
                            f"got bool")
    if not isinstance(val, types):
        raise ProtocolError(f"field {field!r}: expected "
                            f"{'/'.join(t.__name__ for t in types)}, "
                            f"got {type(val).__name__}")
    return val


def _want_num_list(obj: Dict[str, Any], field: str, required: bool = True,
                   default: Any = None) -> Optional[List[int]]:
    val = _want(obj, field, (list,), required=required, default=default)
    if val is default and not required:
        return default
    out = []
    for x in val:
        if isinstance(x, bool) or not isinstance(x, int) or x <= 0:
            raise ProtocolError(f"field {field!r}: expected a list of "
                                f"positive ints")
        out.append(x)
    if not out:
        raise ProtocolError(f"field {field!r}: must be non-empty")
    return out


def _validate_submit(obj: Dict[str, Any]) -> Dict[str, Any]:
    kind = _want(obj, "kind", (str,), required=False, default="kernel")
    if kind not in SUBMIT_KINDS:
        raise ProtocolError(f"unknown submit kind {kind!r}; "
                            f"expected one of {SUBMIT_KINDS}")
    req: Dict[str, Any] = {
        "op": "submit",
        "kind": kind,
        "tenant": _want(obj, "tenant", (str,)),
        "hardware": _want(obj, "hardware", (str,)),
        "budget": _want(obj, "budget", (int,), required=False),
        "seed": _want(obj, "seed", (int,), required=False, default=0),
        # Declares/updates the tenant's worker-seconds budget at first
        # sight; None leaves whatever the daemon already knows.
        "tenant_budget_s": _want(obj, "tenant_budget_s", (int, float),
                                 required=False),
        # Client-supplied dedupe token: a retried submit carrying the
        # same (tenant, key) resolves to the ORIGINAL request.
        "idempotency_key": _want(obj, "idempotency_key", (str,),
                                 required=False),
    }
    if not req["tenant"]:
        raise ProtocolError("field 'tenant': must be non-empty")
    if req["idempotency_key"] is not None and not req["idempotency_key"]:
        raise ProtocolError("field 'idempotency_key': must be non-empty")
    if req["budget"] is not None and req["budget"] <= 0:
        raise ProtocolError("field 'budget': must be positive")
    if kind == "kernel":
        req["kernel"] = _want(obj, "kernel", (str,))
        req["input"] = _want(obj, "input", (str,), required=False)
        req["searcher"] = _want(obj, "searcher", (str,), required=False)
    elif kind == "problem":
        # registry-resolved: "kind:name" spec + optional constructor params
        req["problem"] = _want(obj, "problem", (str,))
        req["params"] = _want(obj, "params", (dict,), required=False,
                              default={})
        req["searcher"] = _want(obj, "searcher", (str,), required=False)
        if not req["problem"]:
            raise ProtocolError("field 'problem': must be non-empty")
    else:  # serve
        req["bucket"] = _want(obj, "bucket", (str,))
        shape = _want_num_list(obj, "bucket_shape")
        if len(shape) != 2:
            raise ProtocolError("field 'bucket_shape': expected "
                                "[prompt_len, new_tokens]")
        req["bucket_shape"] = shape
        req["batch_sizes"] = _want_num_list(obj, "batch_sizes")
        req["max_seqs"] = _want_num_list(obj, "max_seqs")
        req["space"] = _want(obj, "space", (str,), required=False,
                             default="serve_online")
        req["calib_n"] = _want(obj, "calib_n", (int,), required=False,
                               default=16)
        req["stats"] = _want(obj, "stats", (dict,), required=False,
                             default={})
        # hardware outside the daemon's registry ships its spec numbers,
        # the same payload the fleet sends to subprocess lanes
        req["hardware_spec"] = _want(obj, "hardware_spec", (dict,),
                                     required=False)
        if req["calib_n"] <= 0:
            raise ProtocolError("field 'calib_n': must be positive")
    return req


def validate_request(obj: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize a decoded request; raise ``ProtocolError`` if invalid.

    Returns a fresh dict holding only known fields with defaults applied,
    so daemon code never touches unvalidated client input.
    """
    op = obj.get("op")
    if not isinstance(op, str) or op not in OPS:
        raise ProtocolError(f"unknown op {op!r}; expected one of {OPS}",
                            code=E_UNKNOWN_OP)
    if op == "submit":
        return _validate_submit(obj)
    if op in ("status", "result", "cancel"):
        rid = _want(obj, "request_id", (str,))
        if not rid:
            raise ProtocolError("field 'request_id': must be non-empty")
        return {"op": op, "request_id": rid}
    if op == "shutdown":
        return {"op": op,
                "drain": _want(obj, "drain", (bool,), required=False,
                               default=True)}
    return {"op": op}  # ping / stats / health carry no payload


def read_line(sock_file, max_bytes: int = MAX_LINE_BYTES
              ) -> Optional[bytes]:
    """Read one protocol line from a file-like socket wrapper, bounded.

    Returns ``None`` on clean EOF.  Raises ``ProtocolError`` when the
    peer exceeds ``max_bytes`` before terminating the line — the bound
    caps how much a misbehaving client can make the reader buffer (the
    daemon answers ``E_BAD_REQUEST`` and closes the connection, leaving
    the rest of the oversize line undelivered on the dead socket).
    """
    line = sock_file.readline(max_bytes + 1)
    if not line:
        return None
    if len(line) > max_bytes:
        raise ProtocolError(f"line exceeds {max_bytes} bytes")
    return line
