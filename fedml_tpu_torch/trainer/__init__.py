"""Local training and evaluation over state dicts."""
