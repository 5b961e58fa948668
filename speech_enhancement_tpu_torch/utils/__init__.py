"""Checkpoint conversion and device selection."""
