"""The north-star pipeline, the sweep harness and its results tools."""
