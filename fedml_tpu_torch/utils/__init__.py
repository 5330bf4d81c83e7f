"""Tracing, metrics, device selection and weight conversion."""
