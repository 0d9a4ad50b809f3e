"""The comparison that decides ``correct``.

The first rounds of a run go through the program's own ``run_round`` on the
timed federation, before the window; the plain f32 reference
(``reference/round.py``) then runs the same rounds from the same
federation and the same round seed. These numbers are compared,
each against the limit of its own in ``limits/<workload>.json``:

- ``loss_gap_<r>``: the relative gap between the program's and the
  reference's ``client_loss_mean`` of round ``r``;
- ``update_norm_gap_<r>``: the same for round ``r``'s mean over clients of
  the norm of a row's change (after the attack), which reads local training
  and the attack layer;
- ``rows_gap``: round 1's trained client rows ``[C, D]`` (the attack's
  input), by the worst leaf of the norm of their difference: the draws are
  the same on both sides, so what is left is arithmetic, and round 1 comes
  before any selection;
- ``first_step_gap``: the global change of round 1 (the aggregate the
  server applies), by the worst leaf;
- ``change_gap``: the global change over all the rounds, by the worst leaf.

Round 1's losses and row norms come before any aggregation, so a selection
that flips between near-tied clients moves only the later rounds' numbers.

"By the worst leaf", for the global changes: for each leaf the gap between the two changes' norms
(not the norm of their difference: two sound runs may pick another of two
near-tied clients), over the larger of the reference's norm of that leaf
and of the median leaf. Leaves whose reference change is under a
thousandth of the median leaf's move by round-off alone and are left out.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

from torch_bench.reference.round import Readings

#: a leaf moved by round-off alone, relative to the median leaf's change
STILL_LEAF = 1e-3


def relative_gap(got: float, want: float) -> float:
    if want == 0:
        return 0.0 if got == want else math.inf
    return abs(got - want) / abs(want) if math.isfinite(got) else math.inf


def leaf_norms(delta: torch.Tensor, leaves, squared: bool = False
               ) -> List[float]:
    """Each leaf's norm of a ``[D]`` vector; with ``squared``, ``delta``
    holds squares already (summed over rows) and the root of each leaf's
    sum is taken."""
    out, lo = [], 0
    for _, shape in leaves:
        n = math.prod(shape)
        seg = delta[lo:lo + n].double()
        out.append(float(seg.sum().sqrt() if squared
                         else torch.linalg.vector_norm(seg)))
        lo += n
    return out


def worst_leaf_gap(got: torch.Tensor, want: torch.Tensor, leaves) -> float:
    """Worst leaf's ``| |got_l| - |want_l| | / max(|want_l|, median)``."""
    g, w = leaf_norms(got, leaves), leaf_norms(want, leaves)
    med = statistics.median(w)
    if not med > 0:
        return math.inf
    gaps = [abs(a - b) / max(b, med)
            for a, b in zip(g, w) if b >= STILL_LEAF * med]
    return max(gaps) if all(map(math.isfinite, g)) else math.inf


def worst_leaf_difference(got: torch.Tensor, want: torch.Tensor, leaves
                          ) -> float:
    """Worst leaf's ``|got_l - want_l| / max(|want_l|, median)`` over the
    rows of ``[C, D]`` changes (Frobenius norms), the same leaf rule."""
    diff = leaf_norms((got - want).double().square().sum(dim=0), leaves,
                      squared=True)
    w = leaf_norms(want.double().square().sum(dim=0), leaves, squared=True)
    med = statistics.median(w)
    if not med > 0:
        return math.inf
    gaps = [a / max(b, med) for a, b in zip(diff, w) if b >= STILL_LEAF * med]
    return max(gaps) if all(map(math.isfinite, diff)) else math.inf


def numbers(prog: Readings, ref: Readings, leaves) -> Dict[str, float]:
    p0, r0 = prog.thetas[0].to(ref.thetas[0].device), ref.thetas[0]
    p1 = prog.thetas[1].to(r0.device)
    pn = prog.thetas[-1].to(r0.device)
    out = {}
    for r, (got, want) in enumerate(zip(prog.losses, ref.losses), 1):
        out[f"loss_gap_{r}"] = relative_gap(got, want)
    for r, (got, want) in enumerate(zip(prog.update_norms, ref.update_norms),
                                    1):
        out[f"update_norm_gap_{r}"] = relative_gap(got, want)
    out["rows_gap"] = worst_leaf_difference(
        prog.trained[0].to(r0.device) - p0, ref.trained[0] - r0, leaves)
    return {
        **out,
        "first_step_gap": worst_leaf_gap(p1 - p0, ref.thetas[1] - r0, leaves),
        "change_gap": worst_leaf_gap(pn - p0, ref.thetas[-1] - r0, leaves),
    }


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``(correct, checks)``: every number that has a limit at or under it.
    A limit whose number is missing or not finite fails. A number without a
    limit is not compared (``limits/<workload>.json`` holds the cell's)."""
    checks = {name: {"value": values.get(name, math.nan), "limit": limit}
              for name, limit in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
