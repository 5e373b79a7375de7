"""PyTorch network zoo of the GenRe inference path (counterpart of
``genre_shapehd_tpu/nn``)."""

from .resnet import ResNet18Features
from .revresnet import Deconv, RevBasicBlock, RevLayer
from .uresnet import MinmaxHead, URDecoder, UResNet
from .voxel_nets import Conv3D, Deconv3D
from .unet3d import UNet3D
from .init import init_weights

__all__ = [
    "ResNet18Features", "Deconv", "RevBasicBlock", "RevLayer", "MinmaxHead",
    "URDecoder", "UResNet", "Conv3D", "Deconv3D", "UNet3D", "init_weights",
]
