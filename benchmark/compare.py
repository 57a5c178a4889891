"""The comparison that decides `correct`: the numbers a run compares
between what its timed path produced and the reference, and their limits
(limits/<workload>.json: {number: limit}; a number passes at or under its
limit)."""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import torch

from benchmark.reference.tracer import LEAF_NAMES, norm

HERE = Path(__file__).resolve().parent
# Leaves whose reference gradient is under this share of the median
# leaf's norm move under Adam by round-off alone: they take no part in
# the change's comparison.
STILL_LEAF = 1e-3


def load_limits(workload: str) -> dict:
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())


def _gap(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor, 1e-300)


def _worst(values) -> float:
    """The largest value; NaN where any value is NaN."""
    values = list(values)
    return float("nan") if any(v != v for v in values) else max(values)


def training(prog: dict, ref: dict, start: dict) -> dict:
    """The training cells' numbers.  `prog` and `ref` are {"losses":
    [step losses], "grad": {leaf: the first step's gradient}, "params":
    {leaf: the leaves after the checked steps}}; `start` the leaves before
    the first step.  A leaf's gap is | |a| - |ref| | over the larger of
    |ref| and the median leaf's |ref|.
      loss_gap:       the worst step's |loss - reference| / reference;
      loss1_gap:      the first step's (before any update);
      grad_gap:       the worst leaf's gap of the first gradient;
      change_gap:     the worst leaf's gap of the change over the checked
                      steps, leaves whose reference gradient is under
                      STILL_LEAF of the median leaf's left out;
      change_med_gap: the median leaf's gap of that change."""
    losses = list(zip(prog["losses"], ref["losses"]))
    loss_gap = _worst(_gap(a, b, 0.0) for a, b in losses)
    g_ref = {k: norm(ref["grad"][k]) for k in LEAF_NAMES}
    g_prog = {k: norm(prog["grad"][k]) for k in LEAF_NAMES}
    g_med = statistics.median(g_ref.values())
    grad_gap = _worst(_gap(g_prog[k], g_ref[k], g_med) for k in LEAF_NAMES)
    moved = [k for k in LEAF_NAMES if g_ref[k] >= STILL_LEAF * g_med]
    d_ref = {k: norm(ref["params"][k].double() - start[k].double()) for k in moved}
    d_prog = {k: norm(prog["params"][k].double() - start[k].double()) for k in moved}
    d_med = statistics.median(d_ref.values())
    changes = [_gap(d_prog[k], d_ref[k], d_med) for k in moved]
    return {"loss_gap": loss_gap, "loss1_gap": _gap(*losses[0], 0.0),
            "grad_gap": grad_gap, "change_gap": _worst(changes),
            "change_med_gap": (float("nan") if any(c != c for c in changes)
                               else statistics.median(changes))}


def frame(prog: torch.Tensor, ref: torch.Tensor, threshold: float) -> dict:
    """The frame cells' numbers over (P, 3) linear frames:
      off_share:    the share of pixels with a channel off the reference by
                    more than threshold x the reference frame's largest
                    value;
      mean_abs_rel: the mean |difference| over the mean |reference|."""
    prog, ref = prog.double().reshape(-1, 3), ref.double().reshape(-1, 3)
    if not bool(torch.isfinite(prog).all()):
        return {"off_share": float("inf"), "mean_abs_rel": float("inf")}
    diff = (prog - ref).abs()
    off = (diff > threshold * float(ref.abs().max())).any(dim=-1)
    return {"off_share": float(off.double().mean()),
            "mean_abs_rel": float(diff.mean() / max(float(ref.abs().mean()), 1e-300))}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(numbers[k] <= limits[k] for k in limits)
