"""Per-layer metrics, one reader a file: ``<name>.py`` holds the metric's
``LAYER``, ``UNIT``, ``MOVES``, the kernel names it sums (``KERNELS``, as
data) and ``read(ctx)``, which returns the value from the traced run's
``harness.Context`` or None where it finds nothing to read."""
