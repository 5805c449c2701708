"""Synthetic input data (``pipeline``)."""
