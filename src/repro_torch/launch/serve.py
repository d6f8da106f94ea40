"""Serving CLI: initialize a model and run batched generation on the
card (the JAX package's ``repro.launch.serve``, carried over).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --requests 8 --max-new 16

runs on the first CUDA card; ``--device cpu`` runs on the CPU, with the
attention kernel's plain version (``--smoke`` picks the arch's small test
config).  Weights are random, drawn from seed 0 on the device.  Every
decoder-only arch serves (``--arch zamba2-2.7b``, ``--arch xlstm-125m``
too; their prompts here are at most 16 tokens, within one chunk of their
scans); the encoder-decoder ``seamless-m4t-large-v2`` is refused with a
message, as the engine feeds tokens only.

``--autotune`` serves through the online shape-bucketed tuner instead of a
fixed configuration: requests are bucketed by (prompt length, max-new)
deciles, the dominant bucket's configuration comes from the ``ConfigStore``
(``--store``; zero live trials on a hit) or from a handful of live
warm-started trials on a miss, and freshly tuned configs persist for the
next run.  On the card the tuner prices on the spec detected for it and
keys the store by its name; on the CPU it prices on the H100 SXM's spec
and keys the store ``cpu``.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--tune-batch", action="store_true",
                    help="pick batch size by timed trials through the "
                         "ask-tell tuning API before serving")
    ap.add_argument("--autotune", action="store_true",
                    help="serve through the online shape-bucketed tuner "
                         "(drift-triggered live trials, store-backed reuse)")
    ap.add_argument("--store", default=None,
                    help="ConfigStore JSON path for --autotune (tuned "
                         "configs/models persist across runs; default: "
                         "in-memory)")
    ap.add_argument("--live-trials", type=int, default=8,
                    help="max live trials per drift event for --autotune")
    ap.add_argument("--service", default=None,
                    help="tuning-daemon address (host:port) for --autotune: "
                         "drift retunes route through the shared tuning "
                         "service and fall back in-process when it is "
                         "unreachable (start one with "
                         "python -m repro_torch.launch.daemon)")
    ap.add_argument("--device", default=None,
                    help="where to serve: the first CUDA card by default; "
                         "'cpu' runs the plain versions on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, SMOKES
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import (Request, ServeEngine,
                                          tune_engine_batch)

    arch = (SMOKES if args.smoke else ARCHS)[args.arch]
    if arch.enc_layers:
        raise SystemExit(
            f"--arch {args.arch}: the engine serves token-only models, as "
            f"the JAX engine does; this encoder-decoder also needs its "
            f"encoder's frames: serve it through Model.prefill and "
            f"Model.decode")
    device = resolve_device(args.device)
    model = build_model(arch)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(1, arch.vocab_size,
                                        size=int(rng.integers(4, 16))),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    where = (f"{device} ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else str(device))
    gen = torch.Generator(device=device).manual_seed(0)

    if args.autotune:
        from repro_torch.core import hwspec
        from repro_torch.serve.autotune import (EngineBackend,
                                                OnlineAutotuner,
                                                ShapeBucketer, serve_space,
                                                stats_from_model)
        from repro_torch.tuning.store import ConfigStore

        if device.type == "cuda":
            hw, hardware_name = hwspec.detect(device.index), None
        else:
            hw, hardware_name = hwspec.H100_SXM, "cpu"
        backend = EngineBackend(model, generator=gen, device=device)
        tuner = OnlineAutotuner(
            backend,
            store=ConfigStore(args.store),
            bucketer=ShapeBucketer(max_prompt=args.max_seq,
                                   max_new=max(1, args.max_new)),
            space=serve_space(max_seqs=tuple(sorted(
                {args.max_seq, args.max_seq // 2, 2 * args.max_seq}))),
            stats=stats_from_model(model),
            hw=hw,
            max_live_trials=args.live_trials,
            hardware_name=hardware_name,
            service=args.service,
        )
        t0 = time.time()
        out, rep = tuner.serve(reqs)
        dt = time.time() - t0
        n = sum(len(v) for v in out.values())
        if rep is not None:
            how = ("reused stored config" if rep.reused
                   else "tuned via service" if rep.via_service
                   else "tuned live")
            print(f"[serve] bucket={rep.bucket} {how} "
                  f"(trials={rep.live_trials}) -> {rep.config}")
        print(f"[serve] {arch.name} on {where}: {len(reqs)} requests, {n} "
              f"tokens in {dt:.1f}s ({n/max(dt, 1e-9):.1f} tok/s)")
        return 0

    params = model.init(gen, device=device)  # one copy for all engines
    batch = args.batch
    if args.tune_batch:
        factory = lambda b: ServeEngine(model, batch_size=b,  # noqa: E731
                                        max_seq=args.max_seq, params=params,
                                        device=device)
        batch, best_s, hist = tune_engine_batch(factory, reqs)
        print(f"[serve] tuned batch_size={batch} "
              f"({best_s:.2f}s best of {len(hist)} trials)")
    engine = ServeEngine(model, batch_size=batch, max_seq=args.max_seq,
                         params=params, device=device)
    t0 = time.time()
    out = engine.generate(reqs)
    dt = time.time() - t0
    n = sum(len(v) for v in out.values())
    print(f"[serve] {arch.name} on {where}: {len(reqs)} requests, {n} "
          f"tokens in {dt:.1f}s ({n/max(dt, 1e-9):.1f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
