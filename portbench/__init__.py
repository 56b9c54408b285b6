"""The benchmark of ``audioanalysisdetector_tpu_torch`` on NVIDIA cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Cells,
configurations, traffic mixes, drivers and per-layer metrics are files found
by name (``harness/cells.py``); the plain references under ``reference/``
import nothing of the port.
"""
