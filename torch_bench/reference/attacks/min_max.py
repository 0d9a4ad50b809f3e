"""Min-Max (Shejwalkar and Houmansadr, NDSS 2021, "Manipulating the
Byzantine"), AGR-agnostic.

Every malicious client sends ``mean + gamma * p`` with ``mean`` the benign
rows' mean and ``p`` the perturbation (``"std"``: minus the benign rows'
coordinate-wise population standard deviation; ``"sign"``: minus the
mean's sign; ``"unit"``: minus the mean's unit vector). ``gamma`` is the
largest for which the crafted row's farthest distance to a benign row is
no larger than the largest distance between two benign rows.

Departure from the paper's search: ``gamma`` is found by ``bisection_steps``
halvings of ``[0, gamma_max]`` (the system's stated search), not by the
paper's step-halving from an initial ``gamma``. Distances are computed
directly in f64.
"""

import torch


def _perturbation(benign, mean, kind):
    if kind == "sign":
        return -torch.sign(mean)
    if kind == "unit":
        return -mean / torch.linalg.vector_norm(mean).clamp_min(1e-12)
    return -((benign - mean) ** 2).mean(dim=0).sqrt()


def poison(rows, malicious, config):
    benign = rows[~malicious].double()
    mean = benign.mean(dim=0)
    p = _perturbation(benign, mean, config.get("perturbation", "std"))
    threshold = torch.cdist(benign, benign,
                            compute_mode="donot_use_mm_for_euclid_dist").max()

    def fits(gamma):
        crafted = mean + gamma * p
        return torch.linalg.vector_norm(benign - crafted, dim=1).max() \
            <= threshold

    lo, hi = 0.0, float(config.get("gamma_max", 50.0))
    for _ in range(int(config.get("bisection_steps", 20))):
        mid = 0.5 * (lo + hi)
        if fits(mid):
            lo = mid
        else:
            hi = mid
    out = rows.clone()
    out[malicious] = (mean + lo * p).float()
    return out
