"""The benchmark of ``repro_torch`` on one H100: cells, traffic, metrics and
the plain reference that decides ``correct`` (see README.md)."""
