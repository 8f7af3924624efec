"""Sharding rules (counterpart of ``repro.sharding``)."""
