"""The benchmark of the PyTorch and CUDA port (``analyzer_tpu_torch``).

One run of one cell: ``python3 -m portbench.run --workload <name> --seed
<n> --seconds <s> --trace <0|1>`` (see ``portbench/run.py``). The cells,
their configurations and their metrics are listed in ``BENCHMARK.json``
at the checkout's root; every configuration (``configs/``), traffic mix
(``traffic/``), traffic driver (``drivers/``) and per-layer metric
(``metrics/``) is a file of its own, found by its name. The plain
reference (``plain.py``), the data generator
(``gen.py``), the database fixture (``dbfixture.py``), the trace
reduction (``trace.py``) and the roofline's bytes (``roofline.py``)
import nothing of the program. ``python3 -m portbench.control`` reads a
cell's check and its control (the reference in a lower precision) at the
cell's own size. The CPU tests are under ``tests/``:
``python3 -m pytest portbench/tests``.
"""
