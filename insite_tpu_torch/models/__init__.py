"""EQ_4 design matrix and the INSITE fine-tune."""
