"""Closed-loop drivers, one per traffic kind (`"kind"` in a mix file)."""
