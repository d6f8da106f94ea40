"""Batched serving engine: prefill + greedy decode in waves.

The JAX package's ``repro.serve.engine`` carried over.  The engine owns a
fixed batch of slots; requests are served ``batch_size`` at a time: each
wave's prompts are left-padded with token 0 to the longest (the pads are
attended, as in the JAX package), prefilled into one cache, and decoded
greedily until each request's EOS or budget.  A partial wave (the queue's
tail) runs at its true size.

The engine runs on ``device`` (the card unless the caller names the CPU).
Where the JAX engine jit-compiles prefill and decode on their first call,
the port's first wave loads the kernel library and makes the cuBLAS
handles; ``warmup`` and ``warmup_for`` run those waves untimed.  A decode
step reads its next tokens on the host once (one synchronization a step).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (L,) int32
    max_new_tokens: int = 16
    eos_id: int = -1            # -1: never stops early
    generated: Optional[List[int]] = None


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    def __init__(self, model, batch_size: int, max_seq: int,
                 params=None, generator: Optional[torch.Generator] = None,
                 device=None):
        self.model = model
        self.batch = batch_size
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.params = params if params is not None else model.init(
            generator, device=self.device)
        self._decode = model.decode

    def generate(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Run all requests to completion, batch_size at a time."""
        out: Dict[int, List[int]] = {}
        queue = list(requests)
        while queue:
            wave = queue[:self.batch]
            queue = queue[self.batch:]
            out.update(self._run_wave(wave))
        return out

    def _run_wave(self, wave: List[Request]) -> Dict[int, List[int]]:
        # a partial wave (the queue tail) runs at its true size: padding it
        # to self.batch would prefill and decode ghost slots
        n = len(wave)
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((n, plen), np.int32)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        logits, cache = self.model.prefill(self.params, batch,
                                           max_seq=self.max_seq)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        steps = max(r.max_new_tokens for r in wave)
        done = np.zeros(n, bool)
        gen: List[List[int]] = [[] for _ in range(n)]
        # an exhausted budget means no generated tokens at all
        for i, r in enumerate(wave):
            if r.max_new_tokens <= 0:
                done[i] = True
        for _ in range(steps):
            host = next_tok.tolist()
            for i, r in enumerate(wave):
                if not done[i]:
                    gen[i].append(int(host[i]))
                    if (int(host[i]) == r.eos_id
                            or len(gen[i]) >= r.max_new_tokens):
                        done[i] = True
            if done.all():
                break
            logits, cache = self._decode(self.params, cache,
                                         {"tokens": next_tok[:, None]})
            next_tok = torch.argmax(logits[:, -1], dim=-1)
        return {r.uid: gen[i] for i, r in enumerate(wave)}

    def warmup(self, prompt_len: int = 4, wave_size: Optional[int] = None
               ) -> None:
        """Run one untimed dummy wave (a prefill and at least one decode
        step) before any timed serving or tuning measurement."""
        n = min(wave_size if wave_size is not None else self.batch,
                self.batch)
        plen = max(1, min(prompt_len, self.max_seq - 2))
        reqs = [Request(uid=-1 - i, prompt=np.ones(plen, np.int32),
                        max_new_tokens=2) for i in range(n)]
        self.generate(reqs)

    def warmup_for(self, n_requests: int, prompt_len: int = 4) -> None:
        """Warm every wave size ``generate(n_requests requests)`` runs:
        the full-batch wave and the partial tail."""
        n = max(1, int(n_requests))
        sizes = {min(self.batch, n)}
        if n % self.batch:
            sizes.add(n % self.batch)
        for size in sorted(sizes):
            self.warmup(prompt_len=prompt_len, wave_size=size)


def timed_generate(engine, requests: List[Request]) -> float:
    """Seconds ``engine.generate(requests)`` takes, the card's queue
    drained before the clock starts and before it is read, under the
    card's timing lock (one timed window a card: a kernel evaluator in
    the same process never overlaps it).  An engine without a
    ``device`` (a test's fake) is timed on the host clock alone."""
    from repro_torch.core.evaluate import device_lock

    device = getattr(engine, "device", None)
    if device is None:
        t0 = time.perf_counter()
        engine.generate(requests)
        return time.perf_counter() - t0
    with device_lock(device):
        synchronize(device)
        t0 = time.perf_counter()
        engine.generate(requests)
        synchronize(device)
        return time.perf_counter() - t0


def tune_engine_batch(
    engine_factory,
    requests: List[Request],
    batch_sizes: Tuple[int, ...] = (1, 2, 4, 8),
    budget: Optional[int] = None,
    seed: int = 0,
    warmup: bool = True,
):
    """Pick the engine batch size by timed end-to-end trials, through the
    ask-tell tuning API (``FunctionEvaluator`` + the random searcher; a
    serving loop has no counters, so the search is runtime-only).

    Engines are built once a batch size and reused across trials, and
    each serves untimed warm-up waves of every shape the timed run hits
    before its first timed trial.  ``engine_factory(batch_size) ->
    ServeEngine``.  Returns (best batch size, best seconds, history),
    history being the (config index, seconds) trace."""
    from repro_torch.core.evaluate import FunctionEvaluator
    from repro_torch.core.searcher import make_searcher, run_search
    from repro_torch.core.tuning_space import TuningParameter, TuningSpace

    space = TuningSpace([TuningParameter("BATCH", tuple(batch_sizes))],
                        name="serve_batch")
    engines: Dict[int, ServeEngine] = {}

    def _engine(b: int) -> ServeEngine:
        if b not in engines:
            eng = engines[b] = engine_factory(b)
            if warmup and hasattr(eng, "warmup_for"):
                eng.warmup_for(len(requests))
            elif warmup and hasattr(eng, "warmup"):
                eng.warmup()
        return engines[b]

    def timed_run(cfg) -> float:
        engine = _engine(int(cfg["BATCH"]))
        return timed_generate(engine, [dataclasses.replace(r, generated=None)
                                       for r in requests])

    ev = FunctionEvaluator(space, timed_run)
    run_search(make_searcher("random", space, seed=seed), ev,
               budget if budget is not None else len(space))
    best = space[ev.best_index]
    return int(best["BATCH"]), ev.best_runtime, ev.history()
