"""The benchmark of the PyTorch and CUDA port (``python3 -m portbench.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``)."""
