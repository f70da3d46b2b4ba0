"""Detector modules (PyTorch, NCHW inside)."""
