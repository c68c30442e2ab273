"""Mean time from the server's ``ContinuousWorker.submit`` of a request to
its ``_join`` into a pool slot (queueing and admission), host clock."""
from ttsd_bench.readers import mean_ms


def read(layer, cfg):
    return mean_ms(layer.get("join_waits"))
