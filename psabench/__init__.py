"""The benchmark of the PyTorch and CUDA port (`psa_torch`).

Every run is one cell run once:

    python -m psabench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (`cells/<cell>.json`) names a configuration (`configs/<config>.json`:
the entry it drives and the scoring it runs) and a traffic mix
(`traffic/<traffic>.json`, read by the driver `traffic/<kind>.py`).  Each
metric is a module of its own (`metrics/<metric>.py`).  The harness finds
all of them by name, so a later cell, mix or metric is added as new files.

What this folder holds besides: the frozen input generator
(`generator.py`), the published peaks (`peaks.py`) and the work counts of a
query (`roofline.py`), the plain reference that decides `correct`
(`reference.py`, which imports nothing of the port), the harness's spans
(`spans.py`), the profiler's reading (`trace.py`) and the control
(`control.py`).  Nothing here imports JAX or the JAX package.
"""
