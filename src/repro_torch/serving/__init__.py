"""Continuous-batching serving of the FreqCa sampler."""
