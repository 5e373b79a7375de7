"""PyTorch network zoo of the GenRe, MarrNet and ShapeHD models
(counterpart of ``genre_shapehd_tpu/nn``)."""

from .resnet import ResNet18Encoder, ResNet18Features
from .revresnet import Deconv, RevBasicBlock, RevLayer
from .uresnet import MinmaxHead, URDecoder, UResNet
from .voxel_nets import (Conv3D, Deconv3D, VoxelDecoder,
                         VoxelDiscriminator, VoxelGenerator)
from .unet3d import UNet3D
from .init import init_weights

__all__ = [
    "ResNet18Encoder", "ResNet18Features", "Deconv", "RevBasicBlock",
    "RevLayer", "MinmaxHead", "URDecoder", "UResNet", "Conv3D", "Deconv3D",
    "VoxelDecoder", "VoxelDiscriminator", "VoxelGenerator", "UNet3D",
    "init_weights",
]
