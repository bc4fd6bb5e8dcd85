"""Measurement scripts for the port (need a CUDA device)."""
