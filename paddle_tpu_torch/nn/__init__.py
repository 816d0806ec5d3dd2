"""Layers and functionals of the port (counterpart of ``paddle_tpu/nn``):
RMS and layer normalisation and attention (the Llama and GPT paths), and the
ResNet path's BatchNorm, Conv2D, pooling, Linear, Sequential, ReLU and
cross entropy."""
from . import functional
from .layer import (AdaptiveAvgPool2D, BatchNorm, BatchNorm1D, BatchNorm2D,
                    BatchNorm3D, Conv2D, CrossEntropyLoss, LayerNorm, Linear,
                    MaxPool2D, ReLU, RMSNorm, Sequential)

__all__ = ["AdaptiveAvgPool2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "Conv2D", "CrossEntropyLoss", "LayerNorm", "Linear",
           "MaxPool2D", "RMSNorm", "ReLU", "Sequential", "functional"]
