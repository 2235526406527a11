"""The north-star pipeline."""
