"""Formats, quantization and layers of the VDBB datapath (PyTorch port)."""
