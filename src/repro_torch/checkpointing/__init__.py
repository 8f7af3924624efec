"""Moving parameters between ``repro`` and the port."""
