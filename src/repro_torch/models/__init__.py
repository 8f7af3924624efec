"""Denoisers of the port (the DiT family in this slice)."""
