"""The benchmark of the PyTorch and CUDA port (``mbd_tpu_torch``): one
run of one cell is ``python3 benchmark/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` (README.md)."""
