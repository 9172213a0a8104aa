"""The optimizer (port of ``repro/optim``)."""
