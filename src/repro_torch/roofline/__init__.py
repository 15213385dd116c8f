"""Roofline terms of the LM steps on the H100: the card's data-sheet
constants (``hw``), the analytic work model (``analytic``) and the
three-term roofline with its ring model of collectives (``analysis``)."""
