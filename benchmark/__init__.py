"""The benchmark of the PyTorch and CUDA lane tracker (``lane_tracker_tpu_torch``).

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; BENCHMARK.json names the
cells.  A cell ``<config>.<traffic>`` is found by name: the deployment in
``configs/<config>.json`` (its entry in ``entries/<entry>.py``), the mix
in ``traffic/<traffic>.json`` (its generator in ``traffic/<generator>.py``)
and each per-layer metric in ``metrics/<metric>.py``.  ``reference/`` is
the plain reference that decides ``correct``.
"""
