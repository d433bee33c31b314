"""Federated datasets and partitioners (numpy)."""
