"""Measurement tools that run on a CUDA card (not imported by the port)."""
