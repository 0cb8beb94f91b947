"""The benchmark of ``repro_torch``, the PyTorch/CUDA port, on one H100.

``python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, one traffic mix
or one metric sits in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``limits/<cell>.json``
and ``metrics/<metric>.py``.

The yardstick lives here and nowhere in the program: the traffic generator
(``traffic.py``), the analytic FLOP and byte count (``count.py``), the
plain float32 reference and its fp8 control (``reference.py``) and the
comparison that decides ``correct`` (``harness.py``).  ``traffic.py``,
``count.py`` and ``reference.py`` import nothing of ``repro_torch``.
"""
