"""ResNet for CIFAR-10 and ImageNet (``bigdl_tpu/models/resnet.py``).

Blocks are built with ``ConcatTable`` + ``CAddTable`` exactly as in the
JAX package, so a parameter's dotted name is its path in the JAX
``params`` tree (``layer1_0.0.0.0.weight`` is the first conv of the first
bottleneck). Every builder takes ``device`` (default ``cuda``) and a
``torch.Generator`` that all weights are drawn from in construction order.
NCHW only: the JAX package's ``NHWC``/``MIXED`` layouts and its
space-to-depth stem (``Conv1SpaceToDepth``) are queued in ROADMAP A.3.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.init import MsraFiller, Zeros, default_generator


class _Init:
    """Device and generator shared by the layers of one model."""

    def __init__(self, device: DeviceLike, generator):
        self.device = resolve_device(device)
        self.generator = default_generator(generator)

    def conv(self, cin, cout, k, stride=1, pad=0, kernel_format="OIHW"):
        return nn.SpatialConvolution(
            cin, cout, k, k, stride, stride, pad, pad, with_bias=False,
            weight_init=MsraFiller(), kernel_format=kernel_format,
            device=self.device, generator=self.generator)

    def bn(self, n, zero_init=False):
        return nn.SpatialBatchNormalization(
            n, weight_init=Zeros() if zero_init else None,
            device=self.device, generator=self.generator)


def _check_layout(data_format: str):
    if data_format != "NCHW":
        raise NotImplementedError(
            f"data_format {data_format!r}: the port builds NCHW ResNets "
            "only; NHWC and MIXED are queued in ROADMAP A.3")


def shortcut(cin: int, cout: int, stride: int, shortcut_type: str = "B",
             data_format: str = "NCHW", kernel_format: str = "OIHW", *,
             device: DeviceLike = None,
             generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """A = identity / stride then zero-pad channels, B = 1x1 conv when the
    shape changes, C = always a 1x1 conv."""
    _check_layout(data_format)
    return _shortcut(_Init(device, generator), cin, cout, stride,
                     shortcut_type, kernel_format)


def _shortcut(init, cin, cout, stride, shortcut_type, kf):
    use_conv = shortcut_type == "C" or (
        shortcut_type == "B" and (cin != cout or stride != 1))
    if use_conv:
        return nn.Sequential(init.conv(cin, cout, 1, stride,
                                       kernel_format=kf), init.bn(cout))
    if cin != cout:
        return nn.Sequential(nn.SpatialAveragePooling(1, 1, stride, stride),
                             nn.Padding(1, cout - cin))
    return nn.Identity()


def _residual(block, short):
    return nn.Sequential(nn.ConcatTable(block, short), nn.CAddTable(),
                         nn.ReLU())


def basic_block(cin: int, cout: int, stride: int, shortcut_type: str = "B",
                zero_init_residual: bool = False, data_format: str = "NCHW",
                kernel_format: str = "OIHW", *, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None):
    _check_layout(data_format)
    return _basic_block(_Init(device, generator), cin, cout, stride,
                        shortcut_type, zero_init_residual, kernel_format)


def _basic_block(init, cin, cout, stride, shortcut_type, zero_init, kf):
    block = nn.Sequential(
        init.conv(cin, cout, 3, stride, 1, kf), init.bn(cout), nn.ReLU(),
        init.conv(cout, cout, 3, 1, 1, kf), init.bn(cout, zero_init))
    return _residual(block, _shortcut(init, cin, cout, stride, shortcut_type,
                                      kf))


def bottleneck(cin: int, planes: int, stride: int, shortcut_type: str = "B",
               zero_init_residual: bool = False, data_format: str = "NCHW",
               kernel_format: str = "OIHW", *, device: DeviceLike = None,
               generator: Optional[torch.Generator] = None):
    _check_layout(data_format)
    return _bottleneck(_Init(device, generator), cin, planes, stride,
                       shortcut_type, zero_init_residual, kernel_format)


def _bottleneck(init, cin, planes, stride, shortcut_type, zero_init, kf):
    cout = planes * 4
    block = nn.Sequential(
        init.conv(cin, planes, 1, kernel_format=kf), init.bn(planes),
        nn.ReLU(),
        init.conv(planes, planes, 3, stride, 1, kf), init.bn(planes),
        nn.ReLU(),
        init.conv(planes, cout, 1, kernel_format=kf),
        init.bn(cout, zero_init))
    return _residual(block, _shortcut(init, cin, cout, stride, shortcut_type,
                                      kf))


IMAGENET_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def build_imagenet(depth: int = 50, class_num: int = 1000,
                   shortcut_type: str = "B", zero_init_residual: bool = True,
                   data_format: str = "NCHW", kernel_format: str = "OIHW",
                   stem_s2d: bool = False, *, device: DeviceLike = None,
                   generator: Optional[torch.Generator] = None):
    """ImageNet ResNet: 7x7/2 stem conv, 3x3/2 max pool, four stages
    (stride on the 3x3 of a bottleneck), global average pool, ``fc``."""
    if depth not in IMAGENET_CFG:
        raise ValueError(f"unsupported imagenet resnet depth {depth}")
    _check_layout(data_format)
    if stem_s2d:
        raise NotImplementedError(
            "the space-to-depth stem (Conv1SpaceToDepth) is queued in "
            "ROADMAP A.3")
    kind, counts = IMAGENET_CFG[depth]
    make = _basic_block if kind == "basic" else _bottleneck
    expansion = 1 if kind == "basic" else 4
    init = _Init(device, generator)
    model = nn.Sequential(
        nn.named(init.conv(3, 64, 7, 2, 3, kernel_format), "conv1"),
        init.bn(64), nn.ReLU(), nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1))
    cin = 64
    for stage, (planes, n_blocks) in enumerate(zip([64, 128, 256, 512],
                                                   counts)):
        for i in range(n_blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            model.add(make(init, cin, planes, stride, shortcut_type,
                           zero_init_residual, kernel_format),
                      name=f"layer{stage + 1}_{i}")
            cin = planes * expansion
    model.add(nn.GlobalAveragePooling2D())
    model.add(nn.named(_fc(init, cin, class_num), "fc"))
    return model


def _fc(init, cin, class_num):
    return nn.Linear(cin, class_num, weight_init=MsraFiller(),
                     device=init.device, generator=init.generator)


def build_cifar(depth: int = 20, class_num: int = 10,
                shortcut_type: str = "A", *, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None):
    """CIFAR-10 ResNet: depth = 6n + 2, basic blocks of 16/32/64 planes."""
    if (depth - 2) % 6 != 0:
        raise ValueError("cifar resnet depth must be 6n+2")
    n = (depth - 2) // 6
    init = _Init(device, generator)
    model = nn.Sequential(init.conv(3, 16, 3, 1, 1), init.bn(16), nn.ReLU())
    cin = 16
    for stage, planes in enumerate([16, 32, 64]):
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            model.add(_basic_block(init, cin, planes, stride, shortcut_type,
                                   False, "OIHW"),
                      name=f"stage{stage + 1}_{i}")
            cin = planes
    model.add(nn.GlobalAveragePooling2D())
    model.add(nn.named(_fc(init, cin, class_num), "fc"))
    return model
