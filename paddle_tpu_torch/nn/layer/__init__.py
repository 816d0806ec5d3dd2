"""Layers of the port (counterpart of ``paddle_tpu/nn/layer``)."""
from .activation import ReLU
from .common import Linear
from .container import Sequential
from .conv import Conv2D
from .loss import CrossEntropyLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, RMSNorm)
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["AdaptiveAvgPool2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "Conv2D", "CrossEntropyLoss", "LayerNorm", "Linear",
           "MaxPool2D", "RMSNorm", "ReLU", "Sequential"]
