"""Post-dry-run analysis: roofline terms, bottleneck attribution (the port
of ``repro/analysis``): ``from repro_torch.analysis import roofline``."""
