"""Coordinate-wise trimmed mean (Yin et al., ICML 2018).

Sorts each coordinate over the clients, drops ``t = max(1, int(n * ratio))``
values at each end and means the rest; where ``2t >= n`` it is the
coordinate median (the lower middle for even ``n``), as the system under
test falls back. Summed in f64.
"""

import torch


def aggregate(rows, counts, config, selected=None):
    n = rows.shape[0]
    t = max(1, int(n * float(config.get("trim_ratio", 0.1))))
    srt = torch.sort(rows, dim=0).values
    if 2 * t >= n:
        return srt[(n - 1) // 2]
    return srt[t:n - t].double().mean(dim=0).float()
