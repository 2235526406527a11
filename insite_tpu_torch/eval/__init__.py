"""The normalised masked RMSE protocol."""
