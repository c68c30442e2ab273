"""flash_decode_int8_hs's share of its roofline in the traced pool
steps: the bytes one call needs (the architecture's
``decode_attention_work`` over each slot's extent: a live row's valid
int8 keys and values with their scales, one slot for a row that does not
advance) over the kernel's device time a call."""
from ttsd_bench.readers import is_decode_int8, roofline


def read(layer, cfg):
    return roofline(layer, is_decode_int8, layer.get("b3", []))
