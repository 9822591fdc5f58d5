"""gemm_roofline.train: the least time of the traced steps' GEMMs (every
projection's forward, recompute and two backward products, the loss's
similarity products; 2 operations a multiply-add, `core/counts.py`) over the
device time of the GEMM kernels, in %; nothing where none ran."""

KIND = "train"


def read(r):
    if r is None or r.kind != KIND:
        return None
    return r.roofline_pct("gemm", "gemm")
