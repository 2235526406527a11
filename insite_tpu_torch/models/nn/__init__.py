"""The neural building blocks and the training loop of the baselines."""
