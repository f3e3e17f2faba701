"""Datasets, synthetic scenes and the host -> device batch pipeline."""
