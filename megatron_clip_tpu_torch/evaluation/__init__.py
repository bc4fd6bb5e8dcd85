"""Evaluation."""
