"""The comparison's control and planted faults, read at a cell's own size:

    python3 benchmark/control.py --workload NAME --seeds S1,S2,S3 [--variants V,...]

prints, for each seed, the numbers that decide `correct` when the
reference itself takes the program's place:
  * "control": the reference computed in bfloat16, the precision below
    the configuration's float32;
  * "half" (training cells): the reference's fit with half of the frame's
    pixels left out of every step and the mean taken over the rest;
  * "exchange" (cells on several chips): the reference's fit as the first
    rank would run it with the exchange between chips left out, its own
    pixels' share of the loss and gradient alone;
  * "altered" (frame cells): the reference's frame with its middle row
    altered where it is produced (raised by off_threshold x 10 of the
    frame's largest value).
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
from benchmark.reference import tracer  # noqa: E402


def _fit(leaves, found, target, **kw):
    traffic, config = found["traffic"], found["config"]
    losses, grad, params = tracer.fit(
        leaves, config["render"], target, traffic["check_steps"],
        traffic["learning_rate"], config["reference"]["block_pixels"], **kw)
    return {"losses": losses,
            "grad": {k: v.float() for k, v in grad.items()},
            "params": {k: v.float() for k, v in params.items()}}


def training(found: dict, seed: int, device,
             variants=("control", "half", "exchange")) -> dict:
    """{variant: the training numbers} for one seed."""
    config, traffic = found["config"], found["traffic"]
    render = config["render"]
    leaves = inputs.jittered(inputs.scene_leaves(config, seed, device),
                             traffic, seed)
    target = inputs.target(render, traffic, seed, device)
    ref = _fit(leaves, found, target)
    out = {}
    if "control" in variants:
        low = {k: v.to(torch.bfloat16) for k, v in leaves.items()}
        out["control"] = compare.training(_fit(low, found, target), ref, leaves)
    if "half" in variants:
        p = render["width"] * render["height"]
        half = p // 2
        prog = _fit(leaves, found, target, pixels=(0, half),
                    reduce=lambda ts: [t * (p / half) for t in ts])
        out["half"] = compare.training(prog, ref, leaves)
    chips = found["cell"]["chips"]
    if "exchange" in variants and chips > 1:
        p = render["width"] * render["height"]
        prog = _fit(leaves, found, target, pixels=(0, -(-p // chips)))
        out["exchange"] = compare.training(prog, ref, leaves)
    return out


def frame(found: dict, seed: int, device, variants=("control", "altered")) -> dict:
    """{variant: the frame numbers} for one seed."""
    config, traffic = found["config"], found["traffic"]
    render = config["render"]
    block = config["reference"]["block_pixels"]
    leaves = inputs.jittered(inputs.scene_leaves(config, seed, device),
                             traffic, seed % traffic["variants"])
    ref = tracer.render(leaves, render, block)
    threshold = traffic["off_threshold"]
    out = {}
    if "control" in variants:
        low = {k: v.to(torch.bfloat16) for k, v in leaves.items()}
        out["control"] = compare.frame(tracer.render(low, render, block), ref,
                                       threshold)
    if "altered" in variants:
        w, h = render["width"], render["height"]
        bad = ref.clone().reshape(h, w, 3)
        bad[h // 2] += 10 * threshold * float(ref.abs().max())
        out["altered"] = compare.frame(bad.reshape(-1, 3), ref, threshold)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default=None,
                   help="comma-separated variants to read (default: all)")
    args = p.parse_args(argv)
    found = find_cell(ROOT, args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    read = training if found["traffic"]["loop"] == "fit" else frame
    for seed in (int(s) for s in args.seeds.split(",")):
        got = (read(found, seed, device) if args.variants is None else
               read(found, seed, device, tuple(args.variants.split(","))))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "limits": found["limits"], **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
