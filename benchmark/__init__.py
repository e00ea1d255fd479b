"""The benchmark of ``pqcache_tpu_torch`` on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything here is the yardstick: traffic, weights and inputs made from the
seed, the plain reference that decides ``correct``, the reduction from the
profiler's trace to per-layer metrics, and the roofline arithmetic. It
imports the port and nothing of the JAX package. See README.md.
"""
