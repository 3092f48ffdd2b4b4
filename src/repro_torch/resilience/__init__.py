"""Resilience: deterministic fault injection, the degradation ledger, and the
numeric guard policies of the GEMM planner."""
