"""Online shape-bucketed serving autotuner: drift -> retune -> reuse.

Replays a shifting request mix against the deterministic synthetic backend
(a virtual clock priced on an H100 spec, no model weights and no card),
showing the three behaviors of the online tuner:

1. a new dominant shape bucket triggers a handful of live warm-started
   trials (the portable TP→PC model, trained on the H100 PCIe's spec,
   ranks the space; only the top few configurations are measured);
2. a stable mix costs zero trials;
3. a bucket seen before — in this process or in the persisted store — is
   reused with zero live trials.

    PYTHONPATH=src python examples/torch_serve_autotune.py

For the real engine on the card, see
``python -m repro_torch.launch.serve --autotune``.
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import hwspec
from repro_torch.serve.autotune import (OnlineAutotuner, ServeWorkloadStats,
                                        ShapeBucketer, SyntheticServeBackend)
from repro_torch.serve.engine import Request
from repro_torch.tuning.store import ConfigStore

# phases: short prompts/gens -> long/long -> back to short
PHASES = (("short", (12, 6)), ("long", (80, 28)), ("short again", (12, 6)))
TICKS = 3


def tick(rng, plen_c, new_c, n=24, uid0=0):
    return [Request(uid=uid0 + i,
                    prompt=np.ones(int(np.clip(rng.normal(plen_c, 2), 1, 96)),
                                   np.int32),
                    max_new_tokens=int(np.clip(rng.normal(new_c, 1), 1, 32)))
            for i in range(n)]


def serve_mix(store_path, hw="h100_sxm", train_hw="h100_pcie", say=print):
    """One run of the three phases against ``store_path``; the tuner."""
    hw, train_hw = hwspec.get(hw), hwspec.get(train_hw)
    stats = ServeWorkloadStats()
    backend = SyntheticServeBackend(hw, stats, seed=0)
    tuner = OnlineAutotuner(backend, store=ConfigStore(store_path),
                            bucketer=ShapeBucketer(max_prompt=96, max_new=32),
                            hw=hw, train_hw=train_hw, stats=stats, seed=0)
    rng = np.random.default_rng(0)
    uid = 0
    for name, (p, nw) in PHASES:
        for t in range(TICKS):
            requests = tick(rng, p, nw, uid0=uid)
            uid += len(requests)
            _, rep = tuner.serve(requests)
            what = ("reused from store" if rep.reused else
                    f"tuned live ({rep.live_trials} trials)"
                    if rep.drift else "steady state")
            say(f"  [{name:12s} tick {t}] bucket={rep.bucket:5s} "
                f"{what:24s} config={rep.config}")
    return tuner


def run(store_dir=None, hw="h100_sxm", train_hw="h100_pcie", say=print):
    """Run 1 on a cold store, run 2 on the same store.  Returns each run's
    tick reports and run 2's live trials."""
    with tempfile.TemporaryDirectory() as td:
        store_path = os.path.join(store_dir or td, "serve_store.json")
        say("run 1 (cold store):")
        first = serve_mix(store_path, hw, train_hw, say)
        say("run 2 (same store — every drift event is pure reuse):")
        second = serve_mix(store_path, hw, train_hw, say)
    trials = sum(r.live_trials for r in second.reports)
    say(f"run 2 spent {trials} live trials total")
    return {"runs": [first.reports, second.reports],
            "run2_live_trials": trials}


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    run()


if __name__ == "__main__":
    main()
