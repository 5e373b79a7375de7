"""Models of this package: MarrNet-1, GenRe's stage 2
(depth_pred_with_sph_inpaint) and the GenRe full model (training and
inference)."""
