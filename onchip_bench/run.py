"""Run one cell of the port's benchmark once, on the card of this machine:

    python3 onchip_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It prints, as the last line of its standard output, one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the trace's breakdown; and whether what the window
produced is correct, each number compared beside its limit (also the last
lines of its standard error).  It exits with another code than 0, printing
no result, when there is no CUDA card, too few, or when JAX or the JAX
package was loaded.  Run it from the root of a checkout: it imports the
port from ``src/`` and builds the kernels under ``build/``.  With
``--withheld 1`` it also finds the cells of ``withheld.json``, kept out of
``BENCHMARK.json``, to record what keeps them out.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One process, few threads: the host work of a tune is small and serial.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
sys.path.insert(1, str(Path(__file__).resolve().parents[1] / "src"))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--withheld", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    import harness

    if not torch.cuda.is_available():
        harness.log("no CUDA card is visible: nothing to measure")
        return 2
    cell = harness.resolve(args.workload, withheld=bool(args.withheld))
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} are visible")
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T0)
    leaked = harness.forbidden_modules()
    if leaked:
        harness.log(f"the run loaded JAX or the JAX package: {leaked}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
