"""Models of this package: MarrNet-1, GenRe's stage 2
(depth_pred_with_sph_inpaint), the GenRe full model, MarrNet-2, MarrNet,
the 3D-WGAN-GP shape prior and ShapeHD (training and inference)."""

from ..core.registry import get_model
from .base import ModelBase, default_opt

__all__ = ["get_model", "ModelBase", "default_opt"]
