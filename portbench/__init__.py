"""The benchmark of ``bfir_tpu_torch`` on one CUDA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
loop kind, metric or cell is a file of its own, found by name:

- ``configs/<config>.json``: the deployment (channels, taps, block
  length, rate, precision, engine) and the impulse's law;
- ``traffic/<traffic>.json``: a mix's parameters; its ``loop`` names the
  driver ``drivers/<loop>.py`` that runs it;
- ``metrics/<metric>.py``: the reader of one metric;
- ``limits/<cell>.json``: the limits of the cell's correctness check.

The yardstick lives here too: the seeded inputs (``inputs``), the plain
NumPy reference (``reference``), the comparison (``check``), the trace
reduction (``devtrace``) and the bytes and peaks of the roofline
(``roofline``). Nothing here imports ``jax`` or ``bfir_tpu``.
"""
