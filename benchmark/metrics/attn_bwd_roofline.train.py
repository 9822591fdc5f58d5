"""attn_bwd_roofline.train: the least time of the traced steps' attention
backward calls (14·B·N·D bytes, 10·N·D·keys operations each,
`core/counts.py`) over the device time of the attention backward kernels, in
%; nothing where no such kernel ran."""

KIND = "train"


def read(r):
    if r is None or r.kind != KIND:
        return None
    return r.roofline_pct("attn_bwd", "attention backward")
