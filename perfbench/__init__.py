"""The benchmark of ``lightkurve_tpu_torch`` on one NVIDIA H100.

Run one cell of ``BENCHMARK.json`` from the root of a checkout::

    python3 -m perfbench.run --workload tess_sector.sweep --seed 7 \\
        --seconds 20 --trace 0

Everything a cell needs is found by name: its configuration in
``perfbench/configs/<config>.json``, its traffic in
``perfbench/workloads/<cell>.json``, the driver of the traffic's kind in
``perfbench/kinds/<kind>.py`` and each metric's reader in
``perfbench/metrics/<metric>.py``.  The data generator, the roofline count
and the plain reference that decides ``correct`` are frozen copies in this
folder; none imports the JAX package.
"""
