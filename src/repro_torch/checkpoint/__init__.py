"""Verified, atomic checkpoints (port of ``repro/checkpoint``)."""
