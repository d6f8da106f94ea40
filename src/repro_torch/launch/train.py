"""Training CLI with checkpoint/restart fault tolerance (the JAX package's
``repro.launch.train``, carried over).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 10 --batch 8 --seq 1024 --ckpt-dir /tmp/ckpt

    # the sharded step on a 2x2 (data, model) mesh of CPU ranks
    PYTHONPATH=src python -m repro_torch.launch.train --smoke \\
        --device cpu --data-model 2 2 --steps 4

trains on the first CUDA card; ``--device cpu`` trains on the CPU, with
the attention kernel's plain version (``--smoke`` picks the arch's small
test config).  Weights are random, drawn from seed 0 on the device; the
data is the synthetic step-indexed pipeline, so a restart replays the
exact batches.  The job resumes from the latest complete checkpoint in
``--ckpt-dir``; a per-step watchdog exits with code 42 when a step wedges,
so that a supervisor (``repro_torch.launch.supervisor``) re-executes it.

``--data-model D M`` with D*M > 1 trains the sharded step
(``train_step.make_train_step(mesh=...)``) on a (data, model) mesh of D*M
ranks, which this command starts itself, one process a rank (gloo on the
CPU; NCCL on cards, one card a rank): one command trains on a mesh, as
the JAX CLI does in one process.  Rank 0 prints.  A rank that exits with
an error brings the others down at once (each rank's watchdog covers a
rank that hangs in a collective), and the command exits with its code,
so that the supervisor restarts the run from the last checkpoint, which
rank 0 wrote whole.  Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set)
each process is a rank already.  ``--data-model 1 1`` trains unsharded.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import signal
import subprocess
import sys
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


def _die_with_parent() -> None:
    # a rank outlives no parent: the kernel kills it when the parent dies
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def spawn_ranks(argv, world: int, poll_s: float = 0.2) -> int:
    """Run this CLI as ``world`` ranks on localhost and wait: 0 when every
    rank exits 0; the first failing rank's code as soon as it fails, the
    other ranks killed then."""
    from repro_torch.launch.mesh import free_port

    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train"] + list(argv),
            env=env, stdout=None if rank == 0 else subprocess.DEVNULL,
            preexec_fn=_die_with_parent))
    print(f"[train] {world} ranks: pids "
          f"{' '.join(str(p.pid) for p in procs)}", flush=True)
    try:
        while True:
            rcs = [p.poll() for p in procs]
            bad = [(r, rc) for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                rank, rc = bad[0]
                print(f"[train] rank {rank} exited rc={rc}: stopping the "
                      "others", flush=True)
                return rc
            if all(rc == 0 for rc in rcs):
                return 0
            time.sleep(poll_s)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


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
                    help="mesh shape (data, model): D*M > 1 starts D*M "
                         "ranks and trains the sharded step; 1 1 trains "
                         "unsharded")
    ap.add_argument("--device", default=None,
                    help="where to train: the first CUDA card by default; "
                         "'cpu' runs the plain versions on the CPU")
    args = ap.parse_args(argv)
    data, model_ax = args.data_model
    world = data * model_ax
    if world < 1:
        ap.error("--data-model takes two positive extents")
    if world > 1 and "RANK" not in os.environ:
        return spawn_ranks(sys.argv[1:] if argv is None else argv, world)

    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import ARCHS, SMOKES
    from repro_torch.data.pipeline import DataConfig, make_batch, to_device
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.train_step import (StepConfig, init_train_state,
                                              make_train_step,
                                              shard_train_state)

    device = resolve_device(args.device)
    mesh = rules = None
    rank = 0
    if world > 1:
        from repro_torch.distributed.sharding import default_rules
        from repro_torch.launch.mesh import make_host_mesh

        rank = int(os.environ["RANK"])
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             rank)))
        mesh = make_host_mesh(data, model_ax, device.type)
        rules = default_rules(multi_pod=False)

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    arch = (SMOKES if args.smoke else ARCHS)[args.arch]
    model = build_model(arch)
    optimizer = AdamW(lr=warmup_cosine(args.lr, max(args.steps // 10, 1),
                                       args.steps))
    scfg = StepConfig(remat=args.remat, microbatches=args.microbatches,
                      loss_chunks=1)
    step_fn = make_train_step(model, optimizer, scfg, mesh=mesh, rules=rules)
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
    if mesh is not None:
        from repro_torch.data.pipeline import shard_batch
        from repro_torch.distributed.sharding import batch_shardings

        state = shard_train_state(state, model, mesh, rules)
        say(f"[train] sharded step on a {data}x{model_ax} (data, model) "
            f"mesh over {torch.distributed.get_backend()}")
    start = saved = 0
    if ckpt is not None:
        got = ckpt.restore_latest(state)
        if got[0] is not None:
            start, state = got
            saved = start
            say(f"[train] restored checkpoint at step {start}")

    loss = float("nan")
    t0 = time.time()
    for step in range(start, args.steps):
        host = make_batch(dcfg, step)
        batch = to_device(host, device) if mesh is None else shard_batch(
            host, batch_shardings(mesh, rules, host))
        watchdog.arm()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        watchdog.disarm()
        if step % 5 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            say(f"[train] step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} ({dt:.1f}s)")
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
            saved = step + 1
    if ckpt is not None:
        ckpt.wait()
        # the loop published the last step already when it is a multiple
        # of --ckpt-every (a second write of one step cannot be renamed);
        # every rank decides alike, the gather being collective
        if saved != args.steps:
            ckpt.save(args.steps, state)
            ckpt.wait()
    say(f"[train] done: final loss {loss:.4f}")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
