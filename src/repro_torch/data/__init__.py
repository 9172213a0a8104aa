"""The synthetic token pipeline (port of ``repro/data``)."""
