"""Federated algorithms."""
