"""The benchmark of ``tpu_nbody_torch`` on NVIDIA GPUs: one cell, once.

    python3 -m nbody_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``README.md``.
"""
