"""Krum and Multi-Krum (Blanchard et al., NeurIPS 2017).

Each row's score is the sum of its distances to its ``n - f - 2`` nearest
other rows; Krum returns the lowest-scoring row (the first on a tie),
Multi-Krum the plain mean of the ``multi_k`` lowest. Requires
``n >= 2f + 3``.

Departure from the paper: the score sums Euclidean distances, not squared
ones, as the reference testbed's ``krum.py`` and the system under test do.
Distances are computed directly in f64.

Near-ties: the system under test scores from an f32 Gram, so two rows
whose scores lie within that rounding may swap. :func:`select` takes a
``prefer`` mask (the program's choice) and, where a preferred row scores
within :func:`margin` of the lowest, picks it instead.
"""

import torch

#: how many times the f32 Gram's measured rounding of the scores two
#: scores may lie apart and still count as tied
TIE_ROUNDINGS = 8.0


def distances(rows):
    u = rows.double()
    return torch.cdist(u, u, compute_mode="donot_use_mm_for_euclid_dist")


def f32_distances(rows):
    """The distances as an f32 Gram of the centred rows gives them (the
    system's route), the diagonal zero."""
    u = rows.float() - rows.float().mean(dim=0)
    sq = (u * u).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (u @ u.T)
    return d2.clamp_min(0.0).fill_diagonal_(0.0).sqrt()


def nearest_sum(dists, f):
    """Each row's sum of its distances to its ``n - f - 2`` nearest others."""
    n = dists.shape[0]
    srt = torch.sort(dists, dim=1).values  # column 0: the self-distance
    return srt[:, 1:n - f - 1].sum(dim=1)


def scores(dists, f):
    n = dists.shape[0]
    if n < 2 * f + 3:
        raise ValueError(f"Krum needs n >= 2f + 3, got n={n}, f={f}")
    return nearest_sum(dists, f)


def margin(exact, rounded, f):
    """``TIE_ROUNDINGS`` x the largest gap between the scores from the f64
    distances ``exact`` and from the f32 Gram's ``rounded``."""
    return TIE_ROUNDINGS * float(
        (nearest_sum(rounded.double(), f) - nearest_sum(exact, f))
        .abs().max())


def tied_pick(sc, prefer, tie):
    """The lowest of the scores ``sc`` (the first on a tie); where
    ``prefer`` marks rows within ``tie`` of it, the lowest of those."""
    best = int(torch.argmin(sc))
    if prefer is None or prefer[best]:
        return best
    near = torch.nonzero((sc <= sc[best] + tie) & prefer).flatten()
    return int(near[torch.argmin(sc[near])]) if len(near) else best


def select(rows, config, prefer=None):
    """The ``multi_k`` lowest-scoring rows' indices; ``prefer`` (a ``[C]``
    bool mask) takes near-ties as :func:`tied_pick` does."""
    f = int(config.get("num_malicious", 1))
    k = int(config.get("multi_k", 1))
    exact = distances(rows)
    sc = scores(exact, f).clone()
    tie = 0.0 if prefer is None else margin(exact, f32_distances(rows), f)
    chosen = []
    for _ in range(k):
        chosen.append(tied_pick(sc, prefer, tie))
        sc[chosen[-1]] = float("inf")
    return torch.tensor(chosen, device=rows.device)


def aggregate(rows, counts, config, selected=None, prefer=None):
    """``selected`` (a ``[C]`` mask) stands in for the rows' own selection,
    when the round follows another's choice (``round.py``); ``prefer`` is
    passed to :func:`select`."""
    chosen = (select(rows, config, prefer) if selected is None
              else torch.nonzero(selected).flatten())
    return rows.double()[chosen].mean(dim=0).float()
