"""device_idle_pct.embed: the share of the traced span of whole batches in
which no kernel, copy or memset ran on the card, in %."""

KIND = "embed"


def read(r):
    if r is None or r.kind != KIND or r.window_s <= 0.0 or r.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
