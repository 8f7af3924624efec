"""Roofline terms and the step cost counter (counterpart of
``repro.roofline``)."""
