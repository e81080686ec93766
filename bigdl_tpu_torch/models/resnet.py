"""ResNet for CIFAR-10 and ImageNet (``bigdl_tpu/models/resnet.py``).

Blocks are built with ``ConcatTable`` + ``CAddTable`` exactly as in the
JAX package, so a parameter's dotted name is its path in the JAX
``params`` tree (``layer1_0.0.0.0.weight`` is the first conv of the first
bottleneck). Every builder takes ``device`` (default ``cuda``) and a
``torch.Generator`` that all weights are drawn from in construction order.

Layouts, as in the JAX package: ``data_format="NCHW"`` (the default),
``"NHWC"`` (input and every activation ``(B, H, W, C)``; see
``nn/layers/conv.py`` for how the layers keep it without a copy), and
``"MIXED"`` (NCHW input, stem and layer1; one ``Transpose`` to NHWC
before layer2). ``kernel_format="HWIO"`` stores every convolution weight
``(kh, kw, in, out)``. ``stem_s2d=True`` replaces the 7x7/2 stem by
:class:`Conv1SpaceToDepth`, NCHW only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.init import MsraFiller, Zeros, default_generator


class Conv1SpaceToDepth(torch.nn.Module):
    """The ImageNet stem (7x7/2, 3 -> 64, pad 3) computed as the MLPerf
    space-to-depth convolution: 2x2 pixel blocks folded into 12 channels,
    then a 4x4/1 convolution with padding (2, 1) of the weight padded to
    8x8 and folded the same way. The weight is stored as the 7x7 stem's,
    ``(64, 3, 7, 7)``, so it bridges and checkpoints as that conv's; the
    result equals the 7x7/2 convolution up to summation order. Even H and
    W only."""

    def __init__(self, cout: int = 64, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        w = MsraFiller()(gen, (cout, 3, 7, 7), 3 * 49, cout * 49)
        self.weight = torch.nn.Parameter(w.to(resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        o = w.shape[0]
        b, c, h, wd = x.shape
        xf = (x.reshape(b, c, h // 2, 2, wd // 2, 2)
              .permute(0, 1, 3, 5, 2, 4)
              .reshape(b, c * 4, h // 2, wd // 2))   # channels (c, p, q)
        wp = F.pad(w, (1, 0, 1, 0))                   # tap -1 -> zero
        wf = (wp.reshape(o, c, 4, 2, 4, 2)
              .permute(0, 1, 3, 5, 2, 4)
              .reshape(o, c * 4, 4, 4))
        return F.conv2d(F.pad(xf, (2, 1, 2, 1)), wf)


class _Init:
    """Device, generator and layout shared by the layers of one model."""

    def __init__(self, device: DeviceLike, generator,
                 data_format: str = "NCHW"):
        self.device = resolve_device(device)
        self.generator = default_generator(generator)
        self.data_format = data_format

    def conv(self, cin, cout, k, stride=1, pad=0, kernel_format="OIHW"):
        return nn.SpatialConvolution(
            cin, cout, k, k, stride, stride, pad, pad, with_bias=False,
            data_format=self.data_format, weight_init=MsraFiller(),
            kernel_format=kernel_format, device=self.device,
            generator=self.generator)

    def bn(self, n, zero_init=False):
        return nn.SpatialBatchNormalization(
            n, weight_init=Zeros() if zero_init else None,
            data_format=self.data_format, device=self.device,
            generator=self.generator)


def shortcut(cin: int, cout: int, stride: int, shortcut_type: str = "B",
             data_format: str = "NCHW", kernel_format: str = "OIHW", *,
             device: DeviceLike = None,
             generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """A = identity / stride then zero-pad channels, B = 1x1 conv when the
    shape changes, C = always a 1x1 conv."""
    return _shortcut(_Init(device, generator, data_format), cin, cout, stride,
                     shortcut_type, kernel_format)


def _shortcut(init, cin, cout, stride, shortcut_type, kf):
    use_conv = shortcut_type == "C" or (
        shortcut_type == "B" and (cin != cout or stride != 1))
    if use_conv:
        return nn.Sequential(init.conv(cin, cout, 1, stride,
                                       kernel_format=kf), init.bn(cout))
    if cin != cout:
        nhwc = init.data_format == "NHWC"
        return nn.Sequential(
            nn.SpatialAveragePooling(1, 1, stride, stride,
                                     data_format=init.data_format),
            nn.Padding(3 if nhwc else 1, cout - cin))
    return nn.Identity()


def _residual(block, short):
    return nn.Sequential(nn.ConcatTable(block, short), nn.CAddTable(),
                         nn.ReLU())


def basic_block(cin: int, cout: int, stride: int, shortcut_type: str = "B",
                zero_init_residual: bool = False, data_format: str = "NCHW",
                kernel_format: str = "OIHW", *, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None):
    return _basic_block(_Init(device, generator, data_format), cin, cout,
                        stride,
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
    return _bottleneck(_Init(device, generator, data_format), cin, planes,
                       stride,
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
    """ImageNet ResNet: 7x7/2 stem conv (or :class:`Conv1SpaceToDepth`),
    3x3/2 max pool, four stages (stride on the 3x3 of a bottleneck),
    global average pool, ``fc``; in the layout ``data_format``."""
    if depth not in IMAGENET_CFG:
        raise ValueError(f"unsupported imagenet resnet depth {depth}")
    if data_format not in ("NCHW", "NHWC", "MIXED"):
        raise ValueError(f"unknown data_format {data_format}")
    kind, counts = IMAGENET_CFG[depth]
    make = _basic_block if kind == "basic" else _bottleneck
    expansion = 1 if kind == "basic" else 4
    mixed = data_format == "MIXED"
    init = _Init(device, generator, "NCHW" if mixed else data_format)
    if stem_s2d and init.data_format != "NCHW":
        raise ValueError("stem_s2d supports the NCHW layout only")
    stem = (Conv1SpaceToDepth(64, device=init.device,
                              generator=init.generator) if stem_s2d
            else init.conv(3, 64, 7, 2, 3, kernel_format))
    model = nn.Sequential(
        nn.named(stem, "conv1"), init.bn(64), nn.ReLU(),
        nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1,
                             data_format=init.data_format))
    cin = 64
    for stage, (planes, n_blocks) in enumerate(zip([64, 128, 256, 512],
                                                   counts)):
        if mixed and stage == 1:
            # NCHW -> NHWC between layer1 and layer2
            model.add(nn.Transpose((1, 2), (2, 3)), name="to_nhwc")
            init.data_format = "NHWC"
        for i in range(n_blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            model.add(make(init, cin, planes, stride, shortcut_type,
                           zero_init_residual, kernel_format),
                      name=f"layer{stage + 1}_{i}")
            cin = planes * expansion
    model.add(nn.GlobalAveragePooling2D(data_format=init.data_format))
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
