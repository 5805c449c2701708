"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line. Everything that belongs to one configuration, traffic mix or
metric sits in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json`` and
``metrics/<metric>.py``. ``reference/`` holds the plain references that
decide ``correct``, ``bounds.py`` the kernels' byte counts and the card's
peaks. Nothing here imports the JAX package or JAX.
"""
