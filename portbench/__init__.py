"""The benchmark of jepa_tpu_torch on an NVIDIA H100 (see BENCHMARK.json).

One command runs one cell once:

    python3 -m portbench.run --workload vitl16.train --seed 7 --seconds 45 --trace 0

Everything that measures (traffic, FLOP and bound arithmetic, trace
reduction, the fp32 reference and the comparison that decides `correct`)
lives in this folder; from the port it takes only the system under test.
"""
