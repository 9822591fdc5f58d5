"""attn_fwd_roofline.embed: the least time of the traced span's attention
forward calls (8·B·N·D bytes, 4·N·D·keys operations each, `core/counts.py`)
over the device time of the attention forward kernels, in %; nothing where
no such kernel ran (renamed or fused away)."""

KIND = "embed"


def read(r):
    if r is None or r.kind != KIND:
        return None
    return r.roofline_pct("attn_fwd", "attention forward")
