"""Rectified-flow schedule and the cache-policy sampler."""
