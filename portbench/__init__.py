"""The benchmark of the PyTorch and CUDA port (``cnmf_torch_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything a cell needs is found by name: its
configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json``, the code of the mix's kind in
``kinds/<kind>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``. The yardstick (the counts model, the work counts,
the peaks, the profiler arithmetic and the plain reference) lives here and
imports nothing of the JAX package.
"""
