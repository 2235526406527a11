"""The estimator base and the SINDy / INSITE estimator."""
