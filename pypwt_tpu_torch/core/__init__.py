"""Functional core of the PyTorch port: shapes, conv index algebra, level
loops, haar path and threshold operators."""
