"""Models of this package: the GenRe full model (training and inference)."""
