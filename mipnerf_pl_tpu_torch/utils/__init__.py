"""Numpy helpers."""
