"""Quickstart on the H100: autotune the hand-written GEMM's block sizes
through the public ``repro_torch.tuning`` API.  The TP→PC model is trained
on one hardware spec (priced by the cost model), shipped as a JSON
artifact, loaded on the machine of interest and used to tune there (the
paper's hardware-portability headline); then the best configuration is
checked numerically against the fp32 oracle at 256³.

On the card (the default) the model is trained on the H100 PCIe's spec,
the tune measures each configuration of the GEMM at its registry input on
the detected card (``DeviceKernelEvaluator``), and the check launches the
CUDA kernel, TF32 off.  With ``--device cpu`` the tune is priced on the
H100 SXM's spec and the check runs the kernel's plain version.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import hwspec
from repro_torch.core.evaluate import CostModelEvaluator, DeviceKernelEvaluator
from repro_torch.device import resolve_device
from repro_torch.kernels.matmul.kernel import matmul
from repro_torch.kernels.matmul.space import GemmInput
from repro_torch.kernels.registry import BENCHMARKS
from repro_torch.tuning import TuningSession

CHECK_TOL = 2e-4        # the GEMM's tolerance against its fp32 oracle
CHECK_SIZE = 256


def run(train_hw="h100_pcie", hw=None, device=None, budget=25,
        artifact=None, say=print):
    """Train on ``train_hw`` (priced), save, load and tune ``budget`` tests
    on ``hw``, then check the best configuration at 256³.

    ``device=None`` is the card: ``hw`` defaults to its detected spec and
    each test is measured there.  ``device="cpu"`` prices the tune on
    ``hw`` (default ``h100_sxm``).  Returns what it prints, with the
    check's output as a numpy array under ``check_out``."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if hw is None:
        hw = hwspec.detect(device.index) if on_card else hwspec.get(
            "h100_sxm")
    elif isinstance(hw, str):
        hw = hwspec.get(hw)
    bm = BENCHMARKS["matmul"]
    space = bm.make_space()
    inp = bm.default_input
    workload = lambda cfg: bm.workload_fn(cfg, inp)  # noqa: E731

    # Phase 1: train the portable TP→PC_ops model on other hardware and
    # ship it as a JSON artifact.
    trainer = TuningSession(space, workload, hw=hwspec.get(train_hw), seed=0)
    trainer.train(kind="tree")
    if artifact is None:
        artifact = os.path.join(tempfile.gettempdir(),
                                f"gemm_tppc_{train_hw}.json")
    trainer.save_model(artifact)
    out = {"artifact": artifact, "artifact_bytes": os.path.getsize(artifact),
           "train_hw": train_hw, "hw": hw.name, "device": str(device)}
    say(f"model trained on {train_hw} -> {artifact} "
        f"({out['artifact_bytes']} bytes)")

    # Phase 2: load the artifact on the machine of interest and tune.
    session = TuningSession(space, workload, hw=hw, seed=0)
    session.load_model(artifact)
    launches = matmul.launches
    if on_card:
        ev = DeviceKernelEvaluator(space, bm, inp, hw=hw, device=device)
        where = f"measured on {torch.cuda.get_device_name(device)}"
    else:
        ev = CostModelEvaluator(space, workload, hw)
        where = f"priced on {hw.name}"
    result = session.tune(budget=budget, evaluator=ev)
    out.update(space=len(space), steps=result.steps,
               best_runtime=result.best_runtime,
               best_config=dict(result.best_config))
    say(f"space: {len(space)} configurations")
    say(f"best after {result.steps} empirical tests ({where}, "
        f"{inp.tag}): {result.best_runtime * 1e6:.1f} us")
    say(f"best config: {result.best_config}")

    # validate the chosen configuration numerically: the kernel on the
    # card, its plain version on the CPU, against the fp32 oracle
    a, b = bm.make_args(GemmInput(CHECK_SIZE, CHECK_SIZE, CHECK_SIZE),
                        np.random.default_rng(0), device)
    cfg = dict(result.best_config)
    for k in ("BLOCK_M", "BLOCK_N", "BLOCK_K"):
        cfg[k] = min(cfg[k], CHECK_SIZE)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = bm.run(cfg, a, b)
        ref = bm.ref(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    err = float(torch.max(torch.abs(got - ref)))
    rel = err / float(torch.max(torch.abs(ref)))
    out.update(max_err=err, rel_err=rel, check_out=got.cpu().numpy(),
               launches=matmul.launches - launches)
    say(f"numerical check vs oracle ({CHECK_SIZE}^3, "
        f"{'kernel' if on_card else 'plain version'}): max err {err:.2e} "
        f"(relative {rel:.2e}, tolerance {CHECK_TOL:.0e})")
    say(f"GEMM kernel launches: {out['launches']}")
    if not rel <= CHECK_TOL:
        raise AssertionError(f"the best configuration {cfg} misses the "
                             f"oracle: relative error {rel:.3e}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="the first CUDA card by default; 'cpu' prices the "
                         "tune and checks the plain version")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
