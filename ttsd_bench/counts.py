"""The chip's published peaks, a call's share of its roofline, and the
rules by which each architecture (``arch/<name>.py``) counts the work a
call needs from its shapes and valid extents.

Counts are of the mathematics, whatever implements it: each input byte
read once and each output byte written once, attention over the keys a
row really has (not the padded capacity, nor keys outside a layer's
window), the model's FLOPs as two per weight a token passes through (the
experts it is routed to, not every expert) plus attention. A later kernel
or fused step that does less work does not make these numbers stale.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def roofline_percent(flops: float, nbytes: float, seconds: float) -> float:
    """The least time the chip could take (the larger of FLOPs over the
    bf16 peak and bytes over HBM bandwidth), as a percentage of
    ``seconds``."""
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
    return 100.0 * bound / seconds
