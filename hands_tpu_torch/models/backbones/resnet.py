"""ResNet-18/50 backbones emitting spatial feature maps (port of
``hands_tpu/models/backbones/resnet.py``): torchvision's ResNet with the fc
removed, stopping before global pooling at the 7x7 stage-5 map.

The public layout is the JAX module's, NHWC in and out; inside, the
convolutions see the same memory as NCHW views in ``channels_last`` format,
so neither permute copies. Parameters are f32; the compute dtype (bf16 or
f32) is applied per call, as Flax does. BatchNorm computes in f32 and rounds
to the compute dtype: in eval mode on its running statistics, in train mode
(``module.train()``) on the batch's, moving the running statistics as Flax
does. ``quant_int8`` swaps the convolutions of every residual block for the
W8A8 serving convolution of ``ops/quant.py`` (inference only); the 7x7 stem
stays in the compute dtype.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hands_tpu_torch.ops.quant import serving_conv_cls


class Conv(nn.Module):
    """Flax ``nn.Conv(dtype=...)`` on an NCHW tensor: input and OIHW kernel
    cast to ``dtype``, bias (if any) added in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32, use_bias: bool = False,
                 device=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel, kernel, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device))
                     if use_bias else None)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        stride=self.stride, padding=self.padding)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(dtype=...)``: f32 statistics and affine
    parameters, result rounded to ``dtype``. Eval mode normalises with the
    running statistics. Train mode normalises with the batch's mean and
    biased variance and moves the running statistics by Flax's rule,
    ``new = 0.99 old + 0.01 batch``, with the biased variance
    (``nn.BatchNorm2d`` would store the unbiased one). A new module is in
    eval mode, the Flax module's ``train=False`` default."""

    momentum = 0.99  # Flax's default: the share of the old statistics kept

    def __init__(self, ch: int, dtype=torch.float32, device=None,
                 eps: float = 1e-5):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))
        self.register_buffer("running_mean", torch.zeros(ch, device=device))
        self.register_buffer("running_var", torch.ones(ch, device=device))
        self.eval()

    def forward(self, x):
        x = x.to(self.dtype)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # one pass over x: the op hands back the mean and 1/sqrt(var + eps)
        # it normalised with, and the running update is made from those
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = torch.clamp(1.0 / (invstd * invstd) - self.eps, min=0.0)
            keep = self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
            self.running_var.mul_(keep).add_(var, alpha=1.0 - keep)
        return y


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype=torch.float32, conv_cls: Callable = Conv, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = conv_cls(in_ch, filters, 3, strides, 1, **kw)
        self.bn1 = BatchNorm(filters, **kw)
        self.conv2 = conv_cls(filters, filters, 3, 1, 1, **kw)
        self.bn2 = BatchNorm(filters, **kw)  # Flax zero-inits its scale
        self.down_conv = self.down_bn = None
        if strides != 1 or in_ch != filters:
            self.down_conv = conv_cls(in_ch, filters, 1, strides, 0, **kw)
            self.down_bn = BatchNorm(filters, **kw)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.down_conv is not None:
            x = self.down_bn(self.down_conv(x))
        return F.relu(y + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype=torch.float32, conv_cls: Callable = Conv, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = conv_cls(in_ch, filters, 1, 1, 0, **kw)
        self.bn1 = BatchNorm(filters, **kw)
        self.conv2 = conv_cls(filters, filters, 3, strides, 1, **kw)
        self.bn2 = BatchNorm(filters, **kw)
        self.conv3 = conv_cls(filters, filters * 4, 1, 1, 0, **kw)
        self.bn3 = BatchNorm(filters * 4, **kw)  # Flax zero-inits its scale
        self.down_conv = self.down_bn = None
        if strides != 1 or in_ch != filters * 4:
            self.down_conv = conv_cls(in_ch, filters * 4, 1, strides, 0, **kw)
            self.down_bn = BatchNorm(filters * 4, **kw)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.down_conv is not None:
            x = self.down_bn(self.down_conv(x))
        return F.relu(y + x)


class ResNet(nn.Module):
    """Spatial-feature ResNet: (B, H, W, C_in) -> (B, H/32, W/32, C_out),
    NHWC, in the compute dtype."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, in_ch: int = 3,
                 dtype=torch.float32, quant_int8: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv_stem = Conv(in_ch, 64, 7, 2, 3, dtype=dtype, device=device)
        self.bn_stem = BatchNorm(64, dtype=dtype, device=device)
        conv_cls = serving_conv_cls(quant_int8)
        self.stages = nn.ModuleList()
        ch = 64
        for i, block_count in enumerate(stage_sizes):
            blocks = nn.ModuleList()
            for j in range(block_count):
                blocks.append(block_cls(
                    ch, 64 * 2**i, strides=2 if i > 0 and j == 0 else 1,
                    dtype=dtype, conv_cls=conv_cls, device=device))
                ch = 64 * 2**i * block_cls.expansion
            self.stages.append(blocks)
        self.out_channels = ch

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last
        x = F.relu(self.bn_stem(self.conv_stem(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for blocks in self.stages:
            for block in blocks:
                x = block(x)
        return x.permute(0, 2, 3, 1)


def resnet18(in_ch: int = 3, dtype=torch.float32, quant_int8: bool = False,
             device=None) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, in_ch, dtype, quant_int8, device)


def resnet50(in_ch: int = 3, dtype=torch.float32, quant_int8: bool = False,
             device=None) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, in_ch, dtype, quant_int8, device)


BACKBONE_INFO = {
    "resnet18": {"n_output_channels": 512, "spatial_dim": 7},
    "resnet50": {"n_output_channels": 2048, "spatial_dim": 7},
    "vit_b_16": {"n_output_channels": 2048, "spatial_dim": 14},
    "vit_h": {"n_output_channels": 1280, "spatial_dim": None},
}
