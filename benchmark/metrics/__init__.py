"""Metric readers, one file per metric name (see manifest.py)."""
