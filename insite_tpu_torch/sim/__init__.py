"""PKPD cohort simulator (factual and counterfactual test sets)."""
