"""The checkpoint-forking sweep with the fork-affinity hold on and off, on one GPU.

    python3 fork_hold_probe.py [--pairs 2]

Runs chip_smoke.py's slice_fork sweep (BERT-base ASHA(3, 1, 9) with median
stopping, forked promotions, two thread runners) with
``maggy_tpu_torch.constants.FORK_AFFINITY_HOLD_S`` at 0.5 s (its value) and
at 0, in the order 0.5, 0, 0, 0.5 for each pair, so drift in the card's
state falls on both sides. Each sweep prints one JSON line: its wall, steps,
forks, the forks held for their parent's runner, the goodput buckets and
shares (``idle`` among them) and the checkpoint lock waits; the last lines
are the medians of each side and the card's name and power limit. Exits
non-zero if a sweep fails chip_smoke.py's checks of the slice sweep.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def one_sweep(exp_dir, hold_s):
    import chip_smoke as cs
    from maggy_tpu_torch import constants

    constants.FORK_AFFINITY_HOLD_S = hold_s
    cs.fresh_dir(exp_dir)
    try:
        result, wall, records, launches = cs.bert_asha_sweep(exp_dir, "thread",
                                                             train=cs.train_bert_fork)
        _, _, steps, _ = cs.check_bert_sweep("fork_hold_probe", result, exp_dir, records,
                                             launches)
        telemetry = cs.journal_check("fork_hold_probe", os.path.join(exp_dir, "exp"), result)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    trial = [e for e in telemetry["_events"] if e["ev"] == "trial"]
    return {"hold_s": hold_s, "sweep_wall_s": wall, "steps": steps,
            "forks": sum(e["phase"] == "forked_from" for e in trial),
            "held_forks": sum(e["phase"] == "assigned" and bool(e.get("fork_affinity"))
                              for e in trial),
            "early_stopped": result["early_stopped"], **cs.fork_reading(telemetry)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("fork_hold_probe.py needs a CUDA device")
    import chip_smoke as cs
    from maggy_tpu_torch import constants

    cs.phase_build()
    default = constants.FORK_AFFINITY_HOLD_S
    exp_dir = os.path.join(ROOT, "build", "fork_hold_probe")
    runs = []
    for _ in range(args.pairs):
        for hold_s in (default, 0.0, 0.0, default):
            runs.append(one_sweep(exp_dir, hold_s))
            print(json.dumps({"phase": "fork_hold_probe", **runs[-1]}), flush=True)
    keys = ("sweep_wall_s", "steps", "held_forks")
    shares = ("idle", "ckpt_save", "ckpt_restore", "train")
    for hold_s in (default, 0.0):
        side = [r for r in runs if r["hold_s"] == hold_s]
        print(json.dumps({"phase": "fork_hold_probe_median", "hold_s": hold_s, "n": len(side),
                          **{k: float(np.median([r[k] for r in side])) for k in keys},
                          "shares": {b: float(np.median([r["goodput_shares"].get(b, 0.0)
                                                         for r in side])) for b in shares}}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
