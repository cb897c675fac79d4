"""Roofline terms of planned programs (``analysis.py``), the FLOP and
byte counter they come from (``jaxpr_cost.py``), and the LM records'
recount under the analytic HBM model (``recost.py``)."""
