"""The benchmark of salamander_tpu_torch on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``: a closed loop of
whole jobs through the port's public entry points, then a comparison of
sampled outputs with the plain reference in ``portbench/reference``.
Configurations, traffic mixes and metric readers are files found by the
names in ``BENCHMARK.json`` (README.md beside this file).
"""
