"""mfu.train: the model's operations in the traced span (counted from the
configuration's shapes and the batches' masks, `core/counts.py`; training
3 times the forward, recomputation not counted) over the span's time and
the chips' bf16 peak, in %."""

KIND = "train"


def read(r):
    if r is None or r.kind != KIND:
        return None
    return r.mfu_pct()
