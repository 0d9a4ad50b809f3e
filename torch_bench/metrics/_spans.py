"""Per-round layer times from the window's spans (host clock, the device
synchronised at each boundary)."""


def mean_ms(pairs):
    if not pairs:
        return None
    return 1e3 * sum(e - s for s, e in pairs) / len(pairs)
