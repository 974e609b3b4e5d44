"""One reader a per-layer metric, ``<metric name>.py``, loaded by name:
``read(run)`` takes the traced run and returns the metric, or None where
it finds nothing to read (the harness then leaves the metric out)."""
