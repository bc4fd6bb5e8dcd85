"""Transformer building blocks."""
