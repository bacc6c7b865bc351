"""The comparison that decides ``correct``: the program's readings against
the reference's, each number beside a limit of its own.

Training (the first three steps of the timed step object, from the
benchmark's weights, on three distinct pool batches):

* ``loss``: the widest relative gap of a step's loss;
* ``grad``: the widest gap of a leaf's first-gradient norm (the program's
  read from its optimizer's momentum buffer after one step), over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``change``: the same of each leaf's change over the three steps.

Both leave out the leaves whose reference gradient is under a thousandth
of the median leaf's: a conv bias in front of a BatchNorm has a gradient
of zero but for rounding (the normalisation takes the mean out), and its
norm and its change are rounding alone, on either side;
* ``stats``: the same of each BatchNorm running statistic's change.

Evaluation (a sample of the window's batches, drawn from the seed):
``prediction`` the widest absolute gap of a probability against the
reference's forward; ``loss`` and ``hd95`` (relative; HD95's over at
least one pixel), ``dice``, ``jaccard``, ``mcc`` and ``auroc``
(absolute) against the reference's loss and metrics of the program's own
predictions.  Against the reference's forward these swing with the seed
whatever the precision: Dice, Jaccard, MCC and HD95 with pixels near the
threshold, AUROC with the ties that bf16's rounding of the probabilities
makes, the loss, a ratio of sums over every pixel, as its errors cancel;
bf16 runs read as much as the float8 control on some seeds.  So they
judge the loss and the metric layer (sums, counts, the distance
transform, the percentile, the sort) on the program's answer, and
``prediction`` judges the forward.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

__all__ = ["train_numbers", "eval_numbers", "judge", "NEGLIGIBLE"]

#: a leaf whose reference gradient is under this share of the median
#: leaf's has a gradient of rounding alone: left out of ``grad`` and
#: ``change``
NEGLIGIBLE = 1e-3


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
                keep=None) -> float:
    names = [n for n in ref if keep is None or keep(n)]
    if not names:
        return 0.0
    floor = statistics.median(ref[n] for n in names)
    worst = 0.0
    for n in names:
        if n not in prog:
            return float("inf")
        denom = max(ref[n], floor)
        gap = abs(prog[n] - ref[n])
        worst = max(worst, gap / denom if denom > 0 else
                    (0.0 if gap == 0 else float("inf")))
    return worst


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float],
                 top: int = 3) -> List[tuple]:
    """The *top* leaves by gap over max(reference, median): (gap, leaf,
    program's norm, reference's norm), for the run's diagnostics."""
    floor = statistics.median(ref.values())
    rows = [(abs(prog.get(n, float("inf")) - r) / max(r, floor), n,
             prog.get(n), r) for n, r in ref.items()]
    return sorted(rows, reverse=True)[:top]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """*prog*, *ref*: ``{"loss": [...], "grad": {leaf: norm}, "change":
    {leaf: norm}, "stats": {buffer: norm}}``."""
    losses = [abs(p - r) / abs(r) if r else abs(p)
              for p, r in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]):
        losses.append(float("inf"))
    median = statistics.median(ref["grad"].values())

    def moved(name):
        return ref["grad"][name] >= NEGLIGIBLE * median
    out = {"loss": max(losses),
           "grad": _worst_leaf(prog["grad"], ref["grad"], keep=moved),
           "change": _worst_leaf(prog["change"], ref["change"], keep=moved)}
    if ref.get("stats"):
        out["stats"] = _worst_leaf(prog["stats"], ref["stats"])
    return out


def eval_numbers(prog: list, ref: list, own: list) -> Dict[str, float]:
    """*prog*, *ref*: per sampled batch ``{"prediction": tensor, "values":
    {loss, dice, jaccard, mcc, hd95, auroc}}``; *own*: the reference's
    metric values of the program's predictions.  The widest gap over the
    batches."""
    out: Dict[str, float] = {}

    def widen(key, value):
        out[key] = max(out.get(key, 0.0), value)
    for p, r, o in zip(prog, ref, own):
        widen("prediction", float((p["prediction"].float()
                                   - r["prediction"].float()).abs().max()))
        pv, rv = p["values"], r["values"]
        widen("loss", abs(pv["loss"] - o["loss"]) / abs(o["loss"]))
        for key in ("dice", "jaccard", "mcc", "auroc"):
            widen(key, abs(pv[key] - o[key]))
        widen("hd95", abs(pv["hd95"] - o["hd95"]) / max(o["hd95"], 1.0))
    return out


def judge(numbers: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, List[list]]:
    """(every number within its limit, [[name, number, limit], ...]); a
    number without a limit fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits.get(name)
        rows.append([name, value, limit])
        if limit is None or not value <= limit:
            ok = False
    return ok, rows
