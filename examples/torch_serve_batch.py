"""Serve a model with batched requests through the continuous-batching
engine (prefill + greedy decode, slot waves).

On the card (the default) the model is qwen2.5-3b at full width and depth
in bf16, its weights random from seed 0 (an explicit ``torch.Generator``),
and prefill attention runs on the hand-written kernel.  ``--smoke
--device cpu`` serves the reduced config on the CPU instead.

    PYTHONPATH=src python examples/torch_serve_batch.py [--smoke --device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, SMOKES
from repro_torch.device import resolve_device
from repro_torch.kernels.attention.kernel import flash_attention
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Request, ServeEngine, synchronize

ARCH = "qwen2.5-3b"


def make_requests(n=10, seed=0):
    """``n`` requests of 4-11 seeded prompt tokens, 8 new tokens each."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(1, 500, size=int(rng.integers(4, 12))),
                    max_new_tokens=8)
            for i in range(n)]


def run(smoke=False, device=None, params=None, batch_size=4, max_seq=64,
        seed=0, say=print):
    """Serve ``make_requests()`` with ``batch_size`` slots; ``params``
    (a ``ParamTree``) replaces the seeded random weights.  Returns what it
    prints: each request's tokens and the tokens/s."""
    device = resolve_device(device)
    cfg = (SMOKES if smoke else ARCHS)[ARCH]
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(seed),
                            device=device)
    engine = ServeEngine(model, batch_size=batch_size, max_seq=max_seq,
                         params=params, device=device)
    requests = make_requests()
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    t0 = time.perf_counter()
    engine.warmup_for(len(requests))
    warm_s = time.perf_counter() - t0
    before = flash_attention.launches
    synchronize(device)
    t0 = time.perf_counter()
    out = engine.generate(requests)
    synchronize(device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in out.values())
    for uid in sorted(out):
        say(f"request {uid}: {out[uid]}")
    launches = flash_attention.launches - before
    say(f"{cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.dtype}): warm-up {warm_s:.1f}s; attention kernel launches "
        f"{launches}")
    say(f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s, {where})")
    return {"tokens": out, "n_tokens": n_tok, "seconds": dt,
            "tok_per_s": n_tok / dt, "device_name": where,
            "attention_launches": launches}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (CPU-sized)")
    ap.add_argument("--device", default=None,
                    help="the first CUDA card by default; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    run(smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
