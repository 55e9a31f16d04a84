"""Launchers: the serving driver (``serve.py``)."""
