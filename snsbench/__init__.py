"""The benchmark of the PyTorch port of Sketch and Scale (``repro_torch``).

``python3 snsbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see README.md.
"""
