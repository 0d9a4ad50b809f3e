"""Bulyan (El Mhamdi, Guerraoui and Rouault, ICML 2018).

Selection: ``theta = n - 2f`` times, score every still-active row by the
sum of its distances to its ``m - f - 2`` nearest other active rows (``m``
the active count) and move the lowest (the first on a tie) into the
selected set. Aggregation: the coordinate-wise trimmed mean of the selected
rows, ``f`` values dropped at each end. Requires ``n >= 4f + 3``.

Departures from the paper, as the reference testbed and the system under
test define Bulyan: distances are Euclidean, not squared, and the
aggregate means the middle ``theta - 2f`` sorted values rather than the
``theta - 2f`` values closest to the median. Distances in f64.

Near-ties: each selection takes ``prefer`` (the program's selected set) as
``krum.tied_pick`` does, within ``krum.margin`` of that selection's scores.
"""

import torch

from torch_bench.reference.defenses.krum import (
    distances,
    f32_distances,
    margin,
    nearest_sum,
    tied_pick,
)


def select(rows, config, prefer=None):
    """The selected rows' indices, in the order chosen."""
    f = int(config.get("num_malicious", 1))
    n = rows.shape[0]
    if n < 4 * f + 3:
        raise ValueError(f"Bulyan needs n >= 4f + 3, got n={n}, f={f}")
    exact = distances(rows)
    rounded = f32_distances(rows) if prefer is not None else None
    active = list(range(n))
    chosen = []
    for _ in range(n - 2 * f):
        sub = exact[active][:, active]
        tie = 0.0
        if rounded is not None:
            tie = margin(sub, rounded[active][:, active], f)
        best = active[tied_pick(
            nearest_sum(sub, f), None if prefer is None else prefer[active],
            tie)]
        chosen.append(best)
        active.remove(best)
    return chosen


def aggregate(rows, counts, config, selected=None, prefer=None):
    """``selected`` (a ``[C]`` mask) stands in for the rows' own selection,
    when the round follows another's choice (``round.py``); ``prefer`` is
    passed to :func:`select`."""
    f = int(config.get("num_malicious", 1))
    chosen = (select(rows, config, prefer) if selected is None
              else torch.nonzero(selected).flatten().tolist())
    srt = torch.sort(rows[chosen], dim=0).values
    return srt[f:len(chosen) - f].double().mean(dim=0).float()
