"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of the SQMD
federation, on one NVIDIA H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` at the root of the checkout names the cells. Each cell
is one configuration (``portbench/configs/<config>.json``) under one
traffic mix (``portbench/traffic/<traffic>.json``); each per-layer metric
is a reader of its own (``portbench/metrics/<metric>.py``); each model
kind has a plain reference (``portbench/reference/<kind>.py``) and an
adapter onto the port (``portbench/families/<kind>.py``). The harness
finds all of them by the names in ``BENCHMARK.json``. Nothing here
imports JAX or the JAX package.
"""
