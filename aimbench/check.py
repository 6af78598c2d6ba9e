"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference's answer to the same inputs.

Train (the first steps of the very train step the window then drives):
``loss_gap``, the largest gap of a step's loss, as a share of the
reference's; ``grad_gap``, the first gradient as the optimizer got it, by
the worst leaf: the gap between the two norms of a leaf, as a share of the
reference's norm of that leaf or of the median leaf, whichever is larger;
``change_gap``, the same of the parameters' change over the checked steps,
over the leaves whose reference gradient is at least a thousandth of the
median leaf's (a leaf below that moves by AdamW's round-off alone).

Eval: ``prob_l1``, over every answer the run gave, the largest L1 distance
between a video's view-averaged class probabilities and the reference's;
an answer that is missing, or of another shape, reads infinite.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, List, Optional, Tuple

import numpy as np

CHANGE_FLOOR = 1e-3  # of the median leaf's reference gradient


def _finite(x: float) -> float:
    return x if math.isfinite(x) else float("inf")


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> float:
    if set(prog) != set(ref):
        return float("inf")  # a leaf trained on one side only
    mid = median(ref[n] for n in names)
    return max(_finite(abs(prog[n] - ref[n]) / max(ref[n], mid, 1e-30)) for n in names)


def moved_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose change is compared: reference gradient norm at
    least ``CHANGE_FLOOR`` of the median leaf's."""
    mid = median(ref_grad.values())
    return sorted(n for n, g in ref_grad.items() if g >= CHANGE_FLOOR * mid)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {"losses": [...], "grad": {leaf: norm}, "change": {leaf: norm}}."""
    if len(prog["losses"]) != len(ref["losses"]):
        loss = float("inf")
    else:
        loss = max(_finite(abs(p - r) / abs(r)) for p, r in zip(prog["losses"], ref["losses"]))
    return {"loss_gap": loss, "grad_gap": leaf_gap(prog["grad"], ref["grad"], sorted(ref["grad"])),
            "change_gap": leaf_gap(prog["change"], ref["change"], moved_leaves(ref["grad"]))}


def eval_numbers(answers: List[Tuple[int, np.ndarray]], ref: Dict[int, np.ndarray],
                 videos: int) -> Dict[str, float]:
    """answers: (pool index, (videos, classes) scores) of every call;
    ref: the reference's scores of each pool batch."""
    worst = 0.0
    for idx, scores in answers:
        want = ref[idx]
        if scores.shape != want.shape or scores.shape[0] != videos:
            return {"prob_l1": float("inf")}
        gap = np.abs(scores.astype(np.float64) - want.astype(np.float64)).sum(-1).max()
        worst = max(worst, _finite(float(gap)))
    return {"prob_l1": worst}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit fails."""
    shown = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(limits.get(k) is not None and v <= limits[k] for k, v in numbers.items())
    return ok, shown


def limit_from(lower: float, upper: Optional[float]) -> Optional[float]:
    """A limit two thirds of the way (in log) from the program's highest
    sound reading to the least reading of the control and the faults; None
    where they do not separate by three times."""
    if upper is None or lower <= 0 or upper < 3 * lower:
        return None
    return math.exp(math.log(lower) / 3 + 2 * math.log(upper) / 3)
