"""Roofline terms of planned programs (``analysis.py``) and the FLOP and
byte counter they come from (``jaxpr_cost.py``)."""
