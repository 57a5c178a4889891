"""The comparison's control and planted faults of the multi-view fit cells
(traffic loop "fit_views"), read at a cell's own size:

    python3 benchmark/control_views.py --workload NAME --seeds S1,S2 [--variants V,...]

prints, for each seed, the numbers that decide `correct` when the
reference itself takes the program's place (control.py's, for the loop
that control.py does not take):
  * "control": the reference computed in bfloat16, the precision below
    the configuration's float32;
  * "half": the reference's fit with half of each view's pixels left out
    of every step and the mean taken over the rest;
  * "leftout": the reference's fit with the last view left out of every
    step, the mean taken over the other views.
A sound limit lies above the program's readings and below these.  The
benchmark's own runs never run this; it runs on the card when a limit is
set, and its small sizes in benchmark/tests.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import compare, inputs  # noqa: E402
from benchmark.harness import find_cell  # noqa: E402
from benchmark.reference import views  # noqa: E402

VARIANTS = ("control", "half", "leftout")


def _fit(leaves, found, targets, poses, **kw):
    traffic, config = found["traffic"], found["config"]
    losses, grad, params = views.fit(
        leaves, config["render"], targets, poses, traffic["check_steps"],
        traffic["learning_rate"], config["reference"]["block_pixels"], **kw)
    return {"losses": losses,
            "grad": {k: v.float() for k, v in grad.items()},
            "params": {k: v.float() for k, v in params.items()}}


def training(found: dict, seed: int, device, variants=VARIANTS) -> dict:
    """{variant: the training numbers} for one seed."""
    config, traffic = found["config"], found["traffic"]
    render = config["render"]
    leaves = inputs.jittered(inputs.scene_leaves(config, seed, device),
                             traffic, seed)
    poses = views.traffic_views(traffic["views"], device)
    targets = views.targets(render, traffic, seed, len(poses), device)
    ref = _fit(leaves, found, targets, poses)
    out = {}
    if "control" in variants:
        low = {k: v.to(torch.bfloat16) for k, v in leaves.items()}
        out["control"] = compare.training(_fit(low, found, targets, poses), ref,
                                          leaves)
    if "half" in variants:
        p = render["width"] * render["height"]
        half = p // 2
        prog = _fit(leaves, found, targets, poses, pixels=(0, half),
                    reduce=lambda ts: [t * (p / half) for t in ts])
        out["half"] = compare.training(prog, ref, leaves)
    if "leftout" in variants:
        prog = _fit(leaves, found, targets[:-1], poses[:-1])
        out["leftout"] = compare.training(prog, ref, leaves)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default=",".join(VARIANTS),
                   help="comma-separated variants to read (default: all)")
    args = p.parse_args(argv)
    found = find_cell(ROOT, args.workload)
    if found["traffic"]["loop"] != "fit_views":
        print(f"{args.workload} is not a multi-view fit cell: use control.py",
              file=sys.stderr)
        return 2
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        got = training(found, seed, device, tuple(args.variants.split(",")))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "limits": found["limits"], **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
