"""Diagnostic entry points of the port, and the timing they share with
``chip_smoke.py``."""
