"""The table of peaks a share of a roofline or of a peak is taken against.

Published dense rates of the card (NVIDIA's H100 SXM data sheet, no
sparsity), at its full power limit of 700 W; the run records the card's
power limit beside every number.  A card not in the table has no peaks,
and every metric that needs one reads nothing.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "flops": {"bf16": 989e12, "fp32": 67e12},
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks_for(kind: str) -> Optional[dict]:
    return PEAKS.get(kind)
