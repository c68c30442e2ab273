"""The program's own set-up in the run: the ``setup.codec`` (the codec
built and its weights loaded), ``setup.lm`` (the LM engine: cast,
quantization) and ``setup.kernels`` (the kernels built or loaded) span
seconds."""
from ttsd_bench.spans import setup_seconds


def read(layer, cfg):
    return setup_seconds()
