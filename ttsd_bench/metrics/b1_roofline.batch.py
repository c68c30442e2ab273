"""flash_prefill's share of its roofline in the traced batch's prefill:
the FLOPs and bytes one call needs (the architecture's ``b1_work`` over
the rows' valid prompt tokens) over the kernel's device time a call."""
from ttsd_bench.readers import roofline


def read(layer, cfg):
    return roofline(layer, lambda n: "prefill_" in n and "_kernel" in n,
                    [layer["b1"]] if "b1" in layer else [])
