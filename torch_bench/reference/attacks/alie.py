"""ALIE, "A Little Is Enough" (Baruch, Baruch and Goldberg, NeurIPS 2019).

Every malicious client sends ``mean - z * std`` of the benign rows,
coordinate by coordinate (population standard deviation). With ``n``
clients and ``m`` colluders the attack needs ``s = floor(n / 2 + 1) - m``
benign supporters, and the paper's ``z`` is the largest with
``Phi(z) < (n - m - s) / (n - m)`` (section 3), ``Phi`` the standard normal
CDF; ``config["z"]`` overrides it. The colluders' count is
``config["num_malicious"]``, as the system under test takes it.
Computed in f64.
"""

from scipy.stats import norm


def z_max(n: int, m: int) -> float:
    s = n // 2 + 1 - m
    share = (n - m - s) / max(n - m, 1)
    return float(norm.ppf(min(max(share, 0.5), 1.0 - 1e-6)))


def poison(rows, malicious, config):
    benign = rows[~malicious].double()
    mean = benign.mean(dim=0)
    std = ((benign - mean) ** 2).mean(dim=0).sqrt()
    z = config.get("z")
    if z is None:
        z = z_max(rows.shape[0], int(config.get("num_malicious", 1)))
    out = rows.clone()
    out[malicious] = (mean - float(z) * std).float()
    return out
