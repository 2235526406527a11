"""Dataset container, PKPD processing and the dataset collections."""
