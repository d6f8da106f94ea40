"""End to end: train qwen1.5 through the port's train CLI
(``python -m repro_torch.launch.train``) with checkpointing.

On the card (the default) it trains the config at full width; ``--smoke``
trains the reduced config on the CPU (``--smoke --device cpu``).  Without
a card and without ``--device cpu`` it raises before the CLI starts.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--smoke]
"""
import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]


def command(steps=200, arch="qwen1.5-0.5b", smoke=False, device=None,
            ckpt_dir=None, ckpt_every=50):
    """The train CLI's command line for these arguments: on the card
    unless ``device`` is ``"cpu"``, which ``smoke`` implies where no
    device is named."""
    device = resolve_device("cpu" if smoke and device is None else device)
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(),
                                "repro_torch_train_ckpt")
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", arch, "--steps", str(steps), "--batch", "8",
           "--seq", "256", "--ckpt-dir", str(ckpt_dir),
           "--ckpt-every", str(ckpt_every)]
    if smoke:
        cmd.append("--smoke")
    if device.type == "cpu":
        cmd += ["--device", "cpu"]
    return cmd


def run(say=print, **kwargs):
    """Run the train CLI (``command(**kwargs)``) from the checkout's root,
    the caller's environment passed through with ``src`` on
    ``PYTHONPATH``; its exit code."""
    env = dict(os.environ)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    cmd = command(**kwargs)
    say(" ".join(cmd[1:]))
    return subprocess.call(cmd, env=env, cwd=ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config, on the CPU")
    ap.add_argument("--device", default=None,
                    help="the first CUDA card by default; 'cpu' for the CPU")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)
    raise SystemExit(run(steps=args.steps, arch=args.arch, smoke=args.smoke,
                         device=args.device, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every))


if __name__ == "__main__":
    main()
