"""Per-layer readers, one file a metric (portbench/run.py loads each by its name)."""
