"""Constants and dtype policy."""
