"""Mean wall time of one ``ContinuousBatcher.submit_many`` burst (the
batched admission prefill and the splices), synced, host clock."""
from ttsd_bench.readers import mean_ms


def read(layer, cfg):
    return mean_ms(layer.get("admits"))
