"""The benchmark of the PyTorch and CUDA port (``blt_vqg_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Nothing here imports JAX or the JAX package.
"""
