"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on NVIDIA
H100 cards: federated DML rounds timed end to end, a traced run read into
per-layer metrics, and a plain-PyTorch reference that decides ``correct``.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under ``configs/``, ``traffic/``,
``workloads/`` and ``metrics/``, found by its name.  ``yard/`` holds the
yardstick (token streams, peaks, work formulas, trace reduction) and
``reference.py`` the plain model; neither imports the port.
"""
