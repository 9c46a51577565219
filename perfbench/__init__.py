"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of GriNNder.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA card
and prints one JSON result line. Everything is found by name: a
configuration in ``configs/<name>.json``, a traffic mix in
``workloads/<traffic>.json`` (its ``entry`` names the driver in
``entries/<entry>.py``), the plain reference of a model family in
``reference/<model>.py``, the limits of a cell's comparison in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``. Nothing here imports JAX or the JAX package.
"""
