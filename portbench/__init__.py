"""The benchmark of ``densephrases_tpu_torch``, the PyTorch and CUDA port.

Run one cell from the root of a checkout:

    python3 -m portbench.run --workload flat-sq8.nq-b64 --seed 7 \\
        --seconds 30 --trace 0

Everything that belongs to one configuration, one traffic mix, one cell or
one metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it (``registry.py``). The plain reference that
decides ``correct`` is under ``reference/`` and imports nothing of the
port.
"""
