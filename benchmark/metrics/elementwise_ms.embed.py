"""elementwise_ms.embed: device ms of the elementwise, reduction, cast and
copy kernels (every kernel that is no GEMM, attention kernel or optimizer
kernel) a batch, over the traced span."""

from benchmark.core.trace import ELEMENTWISE

KIND = "embed"


def read(r):
    if r is None or r.kind != KIND or r.units == 0:
        return None
    took = r.group(*ELEMENTWISE)
    return 1e3 * took / r.units if took > 0.0 else None
