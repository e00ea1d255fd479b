"""One reader per per-layer metric, found by the metric's name: the file
``<name>.py`` (dots as "_") with ``read(record) -> float | None``. A reader
that finds nothing to read returns None, and the metric is left out."""
