"""Fleet worker subprocess: a JSON-lines evaluation server.

One of these runs per ``SubprocessWorkerPool`` lane.  Requests name a
registered kernel workload (``{"kernel", "input", "hw", "index", "uid",
"profile"}``, ``"measure": true`` for a measured job).

* Without ``--device`` the lane PRICES: it rebuilds the workload model from
  the registry, executes it on the cost model on the named hardware, and
  replies with ``{"uid", "runtime", "cost"}`` (plus ``ops``/``stress`` when
  profiled), as the JAX package's worker does.  A measured request gets a
  per-request error: it is never priced in place of a measurement.
* With ``--device cuda:N`` (or ``cpu``, the plain versions, for tests) the
  lane MEASURES: a ``DeviceKernelEvaluator`` per (kernel, input), built at
  its first request, launches the kernel there and times it.  The reply
  carries the runtime, ``cost`` (the test's host wall-clock), ``ops`` and
  ``stress`` when profiled, the card's name (``device_name``) and every
  kernel wrapper's launch count (``launches``).  A request for hardware
  other than the lane's card, or a priced one, gets a per-request error.

Protocol extras: ``{"op": "ping"}`` → ``{"op": "pong", "device": ...,
"device_name": ...}`` (startup handshake), ``{"op": "shutdown"}`` or EOF →
exit.  Errors are reported per-request (``{"uid", "error", ...}``), never
by crashing the worker.  ``attempt`` is echoed back verbatim so the pool
can correlate retries.

Fault-injection hooks (tests for the fleet's failure policies): a payload
with ``"sim_fail": true`` replies with an injected error instead of
evaluating; ``"sim_crash": true`` makes the worker process exit immediately
WITHOUT replying — the deterministic stand-in for a lane dying with a test
in flight (the pool's reader sees EOF and fails the item as kind
``"lane"``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


class _Lane:
    """What one lane evaluates on: the cost model, or one device."""

    def __init__(self, device):
        from repro_torch.core import hwspec

        self.device = device
        self.hw = None            # the lane card's spec (None: CPU, priced)
        self.device_name = None
        self._evaluators = {}     # (kernel, input) -> DeviceKernelEvaluator
        self._spaces = {}         # kernel -> TuningSpace, priced lanes
        if device is not None:
            import torch

            from repro_torch.device import resolve_device

            dev = resolve_device(device)
            self.device = str(dev)
            if dev.type == "cuda":
                self.device_name = torch.cuda.get_device_name(dev)
                self.hw = hwspec.spec_for_device_name(self.device_name)
            else:
                self.device_name = "cpu"

    def _hw(self, req):
        from repro_torch.core import hwspec

        if "hw_spec" in req:        # unregistered hardware: by numbers
            return hwspec.HardwareSpec(**req["hw_spec"])
        return hwspec.get(req["hw"])

    def price(self, req, out) -> None:
        from repro_torch.core import costmodel
        from repro_torch.kernels.registry import BENCHMARKS

        if req.get("measure"):
            raise RuntimeError("this lane has no device: a measured test "
                               "is never priced in its place")
        bm = BENCHMARKS[req["kernel"]]
        if req["kernel"] not in self._spaces:
            self._spaces[req["kernel"]] = bm.make_space()
        cfg = self._spaces[req["kernel"]][int(req["index"])]
        inp = bm.inputs[req["input"]]
        hw = self._hw(req)
        t0 = time.perf_counter()
        cs = costmodel.execute(bm.workload_fn(cfg, inp), hw)
        out["runtime"] = float(cs.runtime)
        out["cost"] = time.perf_counter() - t0
        if req.get("profile"):
            out["ops"] = {k: float(v) for k, v in cs.ops.items()}
            out["stress"] = {k: float(v) for k, v in cs.stress.items()}

    def measure(self, req, out) -> None:
        from repro_torch.core import hwspec
        from repro_torch.core.evaluate import DeviceKernelEvaluator
        from repro_torch.kernels.registry import BENCHMARKS

        if not req.get("measure"):
            raise RuntimeError(f"this lane measures on {self.device}: a "
                               "priced test goes to a lane without a device")
        hw = self._hw(req)
        if self.hw is not None and \
                hwspec.hardware_key(hw) != hwspec.hardware_key(self.hw):
            raise RuntimeError(
                f"this lane's card is {self.device_name} "
                f"({self.hw.name}), not {hwspec.hardware_key(hw)!r}")
        key = (req["kernel"], req["input"])
        ev = self._evaluators.get(key)
        if ev is None:
            bm = BENCHMARKS[req["kernel"]]
            ev = DeviceKernelEvaluator(
                bm.space(), bm, bm.inputs[req["input"]],
                hw=self.hw if self.hw is not None else hw,
                device=self.device)
            self._evaluators[key] = ev
        rt, cs, cost = ev._evaluate(int(req["index"]),
                                    bool(req.get("profile")))
        out["runtime"] = float(rt)
        out["cost"] = float(cost)
        if cs is not None:
            out["ops"] = {k: float(v) for k, v in cs.ops.items()}
            out["stress"] = {k: float(v) for k, v in cs.stress.items()}
        out["device_name"] = self.device_name
        out["launches"] = _launches()

    def evaluate(self, req, out) -> None:
        if self.device is None:
            self.price(req, out)
        else:
            self.measure(req, out)


def _launches():
    """Every kernel wrapper's launch count in this process."""
    import importlib

    from repro_torch.kernels.registry import BENCHMARKS

    counts = {}
    for name in BENCHMARKS:
        mod = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
        wrapper = getattr(mod, name, None) or getattr(mod, f"flash_{name}")
        counts[name] = int(wrapper.launches)
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="measure on this device (cuda:N, or cpu for the "
                    "plain versions); default: price on the cost model")
    args = ap.parse_args(argv)

    lane = None
    start_error = None
    try:
        lane = _Lane(args.device)
    except Exception as e:          # reported on the handshake
        start_error = f"{type(e).__name__}: {e}"

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        req = json.loads(line)
        op = req.get("op")
        if op == "shutdown":
            break
        if op == "ping":
            pong = {"op": "pong", "device": args.device,
                    "device_name": lane.device_name if lane else None}
            if start_error is not None:
                pong["error"] = start_error
            print(json.dumps(pong), flush=True)
            continue
        out = {"uid": req.get("uid"), "attempt": int(req.get("attempt", 0))}
        if req.get("sim_crash"):
            # simulate a lane dying mid-test: no reply, immediate exit
            sys.exit(1)
        if req.get("sim_fail"):
            out["error"] = "InjectedFailure: sim_fail requested"
            print(json.dumps(out), flush=True)
            continue
        try:
            if lane is None:
                raise RuntimeError(f"the lane did not start: {start_error}")
            lane.evaluate(req, out)
        except Exception as e:      # report per-request, keep serving
            out["error"] = f"{type(e).__name__}: {e}"
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
