"""Models of this package: the GenRe full model's inference path."""
