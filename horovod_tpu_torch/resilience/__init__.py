"""Resilience: the stall escalation ladder (``escalation.py``)."""
