"""Step functions of the port (the serve side of ``repro/train/step.py``)."""
