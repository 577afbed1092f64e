"""The benchmark of the PyTorch/CUDA port ``lattice_net_tpu_torch`` on one
NVIDIA H100: ``python3 -m port_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run.py``)."""
