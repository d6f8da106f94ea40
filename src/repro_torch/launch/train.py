"""Training CLI with checkpoint/restart fault tolerance (the JAX package's
``repro.launch.train``, carried over, on one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 10 --batch 8 --seq 1024 --ckpt-dir /tmp/ckpt

trains on the first CUDA card; ``--device cpu`` trains on the CPU, with
the attention kernel's plain version (``--smoke`` picks the arch's small
test config).  Weights are random, drawn from seed 0 on the device; the
data is the synthetic step-indexed pipeline, so a restart replays the
exact batches.  The job resumes from the latest complete checkpoint in
``--ckpt-dir``; a per-step watchdog exits with code 42 when a step wedges,
so that a supervisor (``repro_torch.launch.supervisor``) re-executes it.
A mesh other than ``--data-model 1 1`` is refused: the sharded step waits
for ROADMAP.md, queue 1, item 9.
"""
from __future__ import annotations

import argparse
import os
import threading
import time


class StepWatchdog:
    """Aborts the process if a step wedges: a wedged step becomes a fast
    exit (code 42), and the supervisor restarts from the last
    checkpoint."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._timer = None

    def arm(self):
        self.disarm()
        self._timer = threading.Timer(self.timeout_s, self._abort)
        self._timer.daemon = True
        self._timer.start()

    def disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    @staticmethod
    def _abort():
        print("[watchdog] step exceeded timeout — aborting for restart",
              flush=True)
        os._exit(42)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="nothing_saveable")
    ap.add_argument("--step-timeout", type=float, default=600.0)
    ap.add_argument("--data-model", type=int, nargs=2, default=(1, 1),
                    help="mesh shape (data, model); only 1 1 here")
    ap.add_argument("--device", default=None,
                    help="where to train: the first CUDA card by default; "
                         "'cpu' runs the plain versions on the CPU")
    args = ap.parse_args(argv)
    if tuple(args.data_model) != (1, 1):
        ap.error(f"--data-model {args.data_model[0]} {args.data_model[1]}: "
                 "the port trains on one device; the sharded step waits "
                 "for ROADMAP.md, queue 1, item 9 (sharding)")

    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import ARCHS, SMOKES
    from repro_torch.data.pipeline import DataConfig, make_batch, to_device
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.train_step import (StepConfig, init_train_state,
                                              make_train_step)

    device = resolve_device(args.device)
    arch = (SMOKES if args.smoke else ARCHS)[args.arch]
    model = build_model(arch)
    optimizer = AdamW(lr=warmup_cosine(args.lr, max(args.steps // 10, 1),
                                       args.steps))
    scfg = StepConfig(remat=args.remat, microbatches=args.microbatches,
                      loss_chunks=1)
    step_fn = make_train_step(model, optimizer, scfg)
    dcfg = DataConfig(
        vocab_size=arch.vocab_size, seq_len=args.seq,
        global_batch=args.batch,
        frontend=arch.frontend, frontend_len=arch.frontend_len,
        frontend_dim=arch.frontend_dim,
    )
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    watchdog = StepWatchdog(args.step_timeout)

    state = init_train_state(
        model, optimizer, torch.Generator(device=device).manual_seed(0),
        device)
    start = 0
    if ckpt is not None:
        got = ckpt.restore_latest(state)
        if got[0] is not None:
            start, state = got
            print(f"[train] restored checkpoint at step {start}", flush=True)

    loss = float("nan")
    t0 = time.time()
    for step in range(start, args.steps):
        batch = to_device(make_batch(dcfg, step), device)
        watchdog.arm()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        watchdog.disarm()
        if step % 5 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt:.1f}s)", flush=True)
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
    if ckpt is not None:
        ckpt.wait()
        # the loop published the last step already when it is a multiple
        # of --ckpt-every (a second write of one step cannot be renamed)
        if ckpt.latest_step() != args.steps:
            ckpt.save(args.steps, state)
            ckpt.wait()
    print(f"[train] done: final loss {loss:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
