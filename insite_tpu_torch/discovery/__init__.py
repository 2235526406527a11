"""Candidate library, derivative estimates and STLSQ."""
