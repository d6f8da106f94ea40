"""Fault-tolerant training supervisor: re-executes the trainer
(``python -m repro_torch.launch.train``) on failure, and the trainer
resumes from its last checkpoint (the JAX package's
``repro.launch.supervisor``, carried over).  The trainer's watchdog turns
a wedged step into an exit; this loop restarts a bounded number of times.

    PYTHONPATH=src python -m repro_torch.launch.supervisor -- \\
        --arch qwen1.5-0.5b --smoke --device cpu --steps 100 \\
        --ckpt-dir /tmp/ck
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--backoff", type=float, default=5.0)
    ap.add_argument("train_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    train_args = [a for a in args.train_args if a != "--"]

    for attempt in range(args.max_restarts + 1):
        cmd = [sys.executable, "-m", "repro_torch.launch.train"] + train_args
        print(f"[supervisor] attempt {attempt}: {' '.join(cmd)}", flush=True)
        rc = subprocess.call(cmd)
        if rc == 0:
            print("[supervisor] training completed", flush=True)
            return 0
        print(f"[supervisor] exited rc={rc}; restarting from checkpoint "
              f"in {args.backoff}s", flush=True)
        time.sleep(args.backoff)
    print("[supervisor] restart budget exhausted", flush=True)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
