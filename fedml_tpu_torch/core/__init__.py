"""Sampling, partitioning and state-dict algebra."""
