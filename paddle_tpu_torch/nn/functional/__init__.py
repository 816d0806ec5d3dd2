"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``)."""
from .attention import scaled_dot_product_attention
from .common import linear, relu
from .conv import conv2d
from .loss import cross_entropy
from .norm import batch_norm, layer_norm, rms_norm
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["adaptive_avg_pool2d", "batch_norm", "conv2d", "cross_entropy",
           "layer_norm", "linear", "max_pool2d", "relu", "rms_norm",
           "scaled_dot_product_attention"]
