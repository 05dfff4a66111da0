"""The benchmark of ``dask_array_tpu_torch``, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  Everything a cell is made of is found by its name:
``configs/<config>.json`` (the field), ``mixes/<traffic>.json`` (the
requests, read by ``traffic.py``), ``metrics/<metric>.py`` (one reader a
per-layer metric), ``reference/<config>.py`` (the plain PyTorch reference)
and ``limits/<cell>.json`` (the limit of each number compared).
"""
