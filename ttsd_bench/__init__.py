"""The benchmark of ``moss_ttsd_torch`` (the PyTorch and CUDA port) on one
NVIDIA H100: ``python -m ttsd_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See README.md."""
