"""PKPD cohort simulator (factual path)."""
