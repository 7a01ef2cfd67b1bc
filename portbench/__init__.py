"""The benchmark of ``cmcfs_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA cards: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.

Everything that belongs to one configuration, one traffic mix, one cell
or one metric is a file of its own, found by the name ``BENCHMARK.json``
gives it: ``configs/<name>.json``, ``traffic/<name>.json``,
``workloads/<name>.json`` (the comparison's limits),
``kinds/<kind>.py`` (the builder of a configuration's case, named by
its ``kind``) and ``metrics/<name>.py`` (a reader of the run's
record).  Files whose names start with ``_`` are shared helpers.  ``reference/``
is the plain NumPy and PyTorch ADI step that decides ``correct``; it
imports nothing of the port.
"""
