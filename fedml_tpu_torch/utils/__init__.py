"""Tracing, metrics, device selection, weight conversion, round
checkpoints and the federation error context."""
