"""The port's serving engine (``repro_torch.serve.engine``): every case of
``tests/test_serve.py`` run with the port's engine and its own
``EchoModel`` (waves, partial-wave masking, token budgets, EOS, the empty
list, warm-up, ``tune_engine_batch``), and the JAX engine and the port's
at one SMOKE config with carried weights generating the same tokens.  All
on the CPU (``device="cpu"``); the engine's card path is in
``test_torch_gpu.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import SMOKES as JSMOKES
from repro.models.registry import build_model as jbuild
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import SMOKES
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.serve import engine as E
from repro_torch.serve.engine import Request, ServeEngine, tune_engine_batch


class EchoModel:
    """Deterministic fake model: next token = (last token + 1) % VOCAB,
    with the registry ``Model``'s calling convention, so the engine's
    behavior (wave masking, budgets, EOS) is testable exactly."""

    VOCAB = 32

    def init(self, generator=None, device=None):
        return {"w": torch.zeros(1, device=device)}

    def _logits(self, tok):
        nxt = (tok + 1) % self.VOCAB
        return F.one_hot(nxt, self.VOCAB).float()[:, None, :]

    def prefill(self, params, batch, max_seq):
        last = batch["tokens"][:, -1].long()
        return self._logits(last), (last + 1) % self.VOCAB

    def decode(self, params, cache, batch):
        tok = batch["tokens"][:, 0].long()
        return self._logits(tok), (tok + 1) % self.VOCAB


def echo_engine(batch_size, max_seq=32):
    return ServeEngine(EchoModel(), batch_size=batch_size, max_seq=max_seq,
                       device="cpu")


def _count_decodes(engine):
    """Wrap ``engine._decode`` to record decode-call token shapes."""
    calls = []
    orig = engine._decode

    def counting(params, cache, batch):
        calls.append(tuple(batch["tokens"].shape))
        return orig(params, cache, batch)

    engine._decode = counting
    return calls


@pytest.fixture(scope="module")
def engine():
    model = build_model(SMOKES["qwen1.5-0.5b"])
    return ServeEngine(model, batch_size=2, max_seq=32,
                       generator=torch.Generator().manual_seed(7),
                       device="cpu")


def _reqs(n, rng, cls=Request):
    return [
        cls(uid=i, prompt=rng.integers(1, 500, size=rng.integers(3, 8)),
            max_new_tokens=5)
        for i in range(n)
    ]


def test_generate_batch(engine):
    rng = np.random.default_rng(0)
    out = engine.generate(_reqs(2, rng))
    assert set(out) == {0, 1}
    for toks in out.values():
        assert len(toks) == 5
        assert all(0 <= t < 512 for t in toks)


def test_generate_more_requests_than_slots(engine):
    rng = np.random.default_rng(1)
    out = engine.generate(_reqs(5, rng))
    assert set(out) == set(range(5))


def test_generate_deterministic(engine):
    rng1 = np.random.default_rng(2)
    rng2 = np.random.default_rng(2)
    a = engine.generate(_reqs(2, rng1))
    b = engine.generate(_reqs(2, rng2))
    assert a == b


def test_the_engine_runs_on_the_card_unless_the_cpu_is_asked_for(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(EchoModel(), batch_size=2, max_seq=8)
    assert echo_engine(2).device == torch.device("cpu")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llama4-scout-17b-a16e"])
def test_jax_and_port_engines_generate_the_same_tokens(arch):
    """Both engines at one SMOKE config with the JAX weights carried over:
    left-padded waves, a partial tail, the same greedy tokens."""
    jm = jbuild(JSMOKES[arch])
    jp = jm.init(jax.random.PRNGKey(3))
    pm = build_model(SMOKES[arch])
    pp = params_from_jax(SMOKES[arch], jax.tree.map(np.asarray, jp))
    jout = JEngine(jm, batch_size=2, max_seq=32, params=jp).generate(
        _reqs(5, np.random.default_rng(8), JRequest))
    pout = ServeEngine(pm, batch_size=2, max_seq=32, params=pp,
                       device="cpu").generate(
        _reqs(5, np.random.default_rng(8)))
    assert pout == jout
    assert all(len(v) == 5 for v in pout.values())


# =============================================================================
# Edge cases + bugfix regressions (deterministic fake model)
# =============================================================================
def test_echo_model_sequence():
    out = echo_engine(2).generate(
        [Request(uid=0, prompt=np.array([5], np.int32), max_new_tokens=4)])
    assert out[0] == [6, 7, 8, 9]


def test_partial_wave_masks_ghost_slots():
    """A partial wave prefills and decodes only its true size."""
    eng = echo_engine(4)
    calls = _count_decodes(eng)
    reqs = [Request(uid=i, prompt=np.array([3 + i], np.int32),
                    max_new_tokens=3) for i in range(2)]
    out = eng.generate(reqs)
    assert out == {0: [4, 5, 6], 1: [5, 6, 7]}
    assert calls, "expected at least one decode step"
    assert all(shape == (2, 1) for shape in calls), calls


def test_partial_wave_matches_full_wave_output_and_steps():
    reqs = [Request(uid=i, prompt=np.array([10 + i], np.int32),
                    max_new_tokens=4) for i in range(2)]
    full = echo_engine(2)
    partial = echo_engine(4)
    full_calls = _count_decodes(full)
    partial_calls = _count_decodes(partial)
    out_full = full.generate([dataclasses.replace(r) for r in reqs])
    out_partial = partial.generate([dataclasses.replace(r) for r in reqs])
    assert out_full == out_partial
    assert len(full_calls) == len(partial_calls)


def test_max_new_tokens_zero_gets_no_tokens():
    reqs = [Request(uid=0, prompt=np.array([5], np.int32), max_new_tokens=0),
            Request(uid=1, prompt=np.array([7], np.int32), max_new_tokens=3)]
    out = echo_engine(2).generate(reqs)
    assert out[0] == []
    assert out[1] == [8, 9, 10]


def test_all_zero_budget_wave_never_decodes():
    eng = echo_engine(2)
    calls = _count_decodes(eng)
    out = eng.generate([Request(uid=i, prompt=np.array([4], np.int32),
                                max_new_tokens=0) for i in range(2)])
    assert out == {0: [], 1: []}
    assert calls == []


def test_eos_mid_wave():
    reqs = [Request(uid=0, prompt=np.array([5], np.int32), max_new_tokens=6,
                    eos_id=7),
            Request(uid=1, prompt=np.array([20], np.int32), max_new_tokens=6)]
    out = echo_engine(2).generate(reqs)
    assert out[0] == [6, 7]                        # stops at EOS (included)
    assert out[1] == [21, 22, 23, 24, 25, 26]      # full budget


def test_empty_request_list():
    assert echo_engine(2).generate([]) == {}


def test_engine_warmup_compiles_decode():
    eng = echo_engine(2, max_seq=16)
    calls = _count_decodes(eng)
    eng.warmup()
    assert len(calls) >= 1


def test_warmup_for_runs_the_full_wave_and_the_tail():
    eng = echo_engine(4)
    calls = _count_decodes(eng)
    eng.warmup_for(6)
    assert sorted(set(calls)) == [(2, 1), (4, 1)]


# =============================================================================
# tune_engine_batch: warmup + engine reuse
# =============================================================================
class _FakeEngine:
    def __init__(self, batch, log, builds):
        self.batch = batch
        self.log = log
        builds[batch] = builds.get(batch, 0) + 1

    def warmup(self):
        self.log.append(("warmup", self.batch))

    def generate(self, requests):
        self.log.append(("generate", self.batch))
        return {r.uid: [] for r in requests}


def test_tune_engine_batch_warms_up_and_reuses_engines():
    log, builds = [], {}
    reqs = [Request(uid=i, prompt=np.array([1], np.int32), max_new_tokens=2)
            for i in range(4)]
    best, best_s, hist = tune_engine_batch(
        lambda b: _FakeEngine(b, log, builds), reqs, batch_sizes=(1, 2, 4))
    assert set(builds) == {1, 2, 4} and all(v == 1 for v in builds.values())
    assert len(hist) == 3
    for b in (1, 2, 4):
        events = [kind for kind, eb in log if eb == b]
        assert events[0] == "warmup", (b, events)
        assert events.count("generate") >= 1


def test_tune_engine_batch_times_a_real_engine_under_the_device_lock(
        monkeypatch):
    """A timed run takes the device's timing lock and drains the device's
    queue before the clock starts and before it is read (a no-op on the
    CPU, recorded here)."""
    from repro_torch.core.evaluate import device_lock

    seen = []
    monkeypatch.setattr(E, "synchronize",
                        lambda dev: seen.append(
                            (str(dev), device_lock(dev).locked())))
    reqs = [Request(uid=i, prompt=np.array([i + 1], np.int32),
                    max_new_tokens=2) for i in range(3)]
    best, best_s, hist = tune_engine_batch(
        lambda b: echo_engine(b), reqs, batch_sizes=(1, 2))
    assert best in (1, 2) and best_s > 0 and len(hist) == 2
    assert seen == [("cpu", True)] * 4
