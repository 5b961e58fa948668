"""Metrics of the port: the native PESQ engine (``pesq.py``)."""
