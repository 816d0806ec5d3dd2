"""The ResNet family.

Counterpart of ``paddle_tpu/vision/models/resnet.py``: ``BasicBlock``,
``BottleneckBlock``, ``ResNet`` and the constructors (``resnet18`` ...
``resnext152_64x4d``, the same class with other arguments), with the
reference's module tree and names, so ``models/convert.py`` maps its
``state_dict()`` one to one. Each block's ``relu(bn(conv(x)))`` passes
``relu=True`` to its BatchNorm, which applies the relu in the BN
kernel's pass (the same values; the reference runs the relu as its next
op); the ``relu(out + identity)`` after the residual add is its own op.
Weights are drawn in construction order from one ``torch.Generator``
(seed 0 when none is given) on ``device`` (the card by default).
``pretrained=True`` raises: there is no download.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..._device import resolve_device
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, MaxPool2D,
                   ReLU, Sequential)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
           "wide_resnet101_2", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
           "resnext152_64x4d"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None, *,
                 device=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = dict(device=device, generator=generator)
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, device=device)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **kw)
        self.bn2 = norm_layer(planes, device=device)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.bn1(self.conv1(x), relu=True)
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None, *,
                 device=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = dict(device=device, generator=generator)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width, device=device)
        self.conv2 = Conv2D(width, width, 3, padding=dilation,
                            stride=stride, groups=groups, dilation=dilation,
                            bias_attr=False, **kw)
        self.bn2 = norm_layer(width, device=device)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion, device=device)
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.bn1(self.conv1(x), relu=True)
        out = self.bn2(self.conv2(out), relu=True)
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, block, depth: int = 50, width: int = 64,
                 num_classes: int = 1000, with_pool: bool = True,
                 groups: int = 1, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self._kw = dict(device=dev, generator=generator)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, **self._kw)
        self.bn1 = BatchNorm2D(self.inplanes, device=dev)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **self._kw)
        del self._kw

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **self._kw),
                BatchNorm2D(planes * block.expansion,
                            device=self._kw["device"]))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        **self._kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **self._kw))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.bn1(self.conv1(x), relu=True))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained=True: the port downloads nothing; load the "
            "reference's weights with models.convert.resnet_from_jax_state")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=128, **kwargs)


def _resnext(depth, groups, pretrained, kwargs):
    return _resnet(BottleneckBlock, depth, pretrained, groups=groups,
                   width=4, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnext(50, 32, pretrained, kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnext(50, 64, pretrained, kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnext(101, 32, pretrained, kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnext(101, 64, pretrained, kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnext(152, 32, pretrained, kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnext(152, 64, pretrained, kwargs)
