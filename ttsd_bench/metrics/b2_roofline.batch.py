"""flash_decode_hs's share of its roofline in the traced decode steps:
the bytes one call needs (the architecture's ``decode_attention_work``:
the query, the output and each row's valid bf16 keys and values) over
the kernel's device time a call."""
from ttsd_bench.readers import is_decode_int8, roofline


def read(layer, cfg):
    return roofline(layer, lambda n: "split_kernel" in n
                    and not is_decode_int8(n), layer.get("b2", []))
