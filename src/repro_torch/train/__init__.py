"""Serving steps (the training half of the reference arrives later)."""
