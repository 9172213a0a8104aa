"""Step functions and the training loop (port of ``repro/train``)."""
