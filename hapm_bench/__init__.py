"""The benchmark of the PyTorch/CUDA port (``repro_torch``): run a cell
with ``python hapm_bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the repository's root."""
