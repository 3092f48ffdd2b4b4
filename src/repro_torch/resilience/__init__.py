"""Resilience: deterministic fault injection and the degradation ledger."""
