"""Int8 post-training quantization (``bigdl_tpu/nn/quantized.py``), in
module form: the serving ``Transformer``'s transform and the
module-tree rewrite.

**The serving transform.** The JAX ``quantize_for_serving`` rewrites a
params tree; here it rewrites a copy of the module, and the copy's
parameter names are that tree's paths, so ``load_jax_params`` fills a
quantized port model from ``jax.device_get(quantize_for_serving(params))``:

- every 2-D GEMM ``Linear`` (q/k/v/output projections, FFN up/down)
  drops ``weight`` and holds ``weight_q`` (int8, (out, in)) and ``scale``
  (fp32, (out,)), plus its ``bias`` in fp32 if it has one;
- the ``Transformer`` root keeps its float ``embedding`` for the lookups
  and, when the embedding is also the lm head, gains ``embedding_q`` +
  ``lm_scale``, the int8 head (an untied model's head is its ``project``
  Linear, quantized as the others).

``Linear.forward`` and ``Transformer._logits`` see the quantized
parameters and run :func:`~bigdl_tpu_torch.nn.int8.int8_linear`. The
quantized tensors are parameters with ``requires_grad=False`` (an int8
tensor has no gradient), so the weight bridge and ``named_parameters``
see them as leaves of the tree. :func:`quantize_tree_for_serving`
quantizes a float tree into such a model's layout (a reload's way in).

**The module rewrite** (the reference's ``Quantizer``,
``AbstractModule.quantize()``): :func:`quantize` returns a new module
tree in which every ``Linear`` and ``SpatialConvolution`` (exact types:
a subclass is left alone) is a :class:`QuantizedLinear` /
:class:`QuantizedSpatialConvolution` holding int8 weights with
per-output-channel scales; the caller's module is untouched.
Activations quantize per sample (one scale per batch row), so an answer
never depends on its batch-mates; a calibrated ``act_scale > 0``
(:func:`calibrate`) replaces the absmax pass. The Linear product is an
exact ``s8 x s8 -> s32`` GEMM (:func:`~bigdl_tpu_torch.nn.int8.int8_accum`,
cuBLASLt's int8 GEMM on the card). A convolution computes the quantized
integer values as an fp32 convolution by default, or, under
``BIGDL_INT8_CONV=dot`` (read at call time), as im2col plus one int8
GEMM: patches in ``(kh, kw)``-major tap order, weights flattened ``(O,
kh, kw, I)``, the contracting dim zero-padded to a multiple of 8 (exact;
ResNet-50's stem has K = 3 * 7 * 7 = 147). That path takes NCHW, one
group and explicit padding only.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Iterable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn import int8 as _int8
from bigdl_tpu_torch.nn.layers.conv import SpatialConvolution, _same_pads
from bigdl_tpu_torch.nn.layers.linear import Linear
from bigdl_tpu_torch.nn.module import flatten_tree

_QUANTIZED_LEAVES = ("weight_q", "embedding_q")


def _frozen(t) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def quantize_for_serving(model: nn.Module) -> nn.Module:
    """A quantized copy of ``model`` (the caller's model is untouched):
    every ``Linear`` with a 2-D weight becomes an int8 GEMM, and a root
    with a float ``embedding`` (the shared-embedding lm head) gains its
    int8 twin."""
    model = copy.deepcopy(model)
    for module in model.modules():
        if isinstance(module, Linear) and "weight" in module._parameters \
                and module.weight.dim() == 2:
            wq, scale = _int8.quantize_weight(module.weight.detach())
            del module.weight
            module.weight_q = _frozen(wq)
            module.scale = _frozen(scale)
            if module.bias is not None:
                module.bias = nn.Parameter(module.bias.detach().float())
    emb = model._parameters.get("embedding")
    # the shared-embedding head only: an untied model's head is its
    # ``project`` Linear, quantized above
    if emb is not None and emb.dim() == 2 and "project" not in model._modules:
        eq, es = _int8.quantize_weight(emb.detach())
        model.embedding_q = _frozen(eq)
        model.lm_scale = _frozen(es)
    return model


def count_quantized_gemms(model: nn.Module) -> int:
    """Number of int8 GEMMs in a :func:`quantize_for_serving` model: the
    ``ServingMetrics.quantized_gemms`` gauge (6 per layer plus the head)."""
    return sum(name.rsplit(".", 1)[-1] in _QUANTIZED_LEAVES
               for name, _ in model.named_parameters())


def quantize_tree_for_serving(model: nn.Module,
                              tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The parameters of the :func:`quantize_for_serving` model ``model``
    for the float parameter tree ``tree`` of the model it was made from
    (nested by module path, numpy or torch leaves): ``{dotted name:
    tensor}``, each ``weight_q`` / ``scale`` pair quantized from its
    layer's float ``weight``, ``embedding_q`` / ``lm_scale`` from the
    ``embedding``, every other leaf as given. Leaves the model does not
    read are kept and missing ones left out, so the caller's signature
    check names the mismatch (a reload's way in)."""
    flat = dict(flatten_tree(tree))
    out: Dict[str, Any] = {}
    sources = set()
    for name, _ in model.named_parameters():
        prefix, _, leaf = name.rpartition(".")
        src = {"weight_q": "weight", "scale": "weight",
               "embedding_q": "embedding", "lm_scale": "embedding"}.get(leaf)
        if src is not None:
            src = f"{prefix}.{src}" if prefix else src
        if src in flat:
            wq, sc = _int8.quantize_weight(_float(flat[src]))
            out[name] = wq if leaf in ("weight_q", "embedding_q") else sc
            sources.add(src)
        elif name in flat:
            out[name] = flat[name]
    out.update({k: v for k, v in flat.items()
                if k not in out and k not in sources})
    return out


def _float(leaf) -> torch.Tensor:
    t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
    return t.detach().float()


# --------------------------------------------------- the module rewrite ----


def _quantize_weight(w: torch.Tensor, channel_axis: int = 0):
    """Symmetric per-output-channel int8: ``scale = max(max|w|, 1e-8) /
    127`` over every axis but ``channel_axis`` (kept as a size-1 dim).
    -> ``(int8 weight, fp32 scale)``."""
    w = w.float()
    axes = tuple(i for i in range(w.dim()) if i != channel_axis)
    scale = _int8._scale(w.abs().amax(dim=axes, keepdim=True))
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale


def _quantize_activation(x: torch.Tensor, static_scale: Optional[float],
                         act_scale: Optional[torch.Tensor] = None):
    """Symmetric int8 activations, one scale PER SAMPLE (batch row,
    absmax over the rest): a batch-wide scale would make one request's
    answer depend on what the batcher grouped it with. With a calibrated
    static scale > 0 (``static_scale``, read on the host; ``act_scale``
    its tensor) the absmax pass does not run and that one scale serves
    every sample. Divides by a scale tensor. -> ``(int8 x, fp32 scale
    (B, 1, ...))``."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    if static_scale is not None and static_scale > 0:
        scale = act_scale.float().expand(shape)
    else:
        scale = _int8._scale(x.abs().amax(dim=tuple(range(1, x.dim())),
                                          keepdim=True))
    xq = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return xq, scale


def _padded_accum(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``int8_accum`` with K and N zero-padded to multiples of 8, which the
    card's int8 GEMM needs; zero columns and rows add nothing to the
    integer sums, so the product is the unpadded one exactly."""
    k, n = xq.shape[1], wq.shape[0]
    pk, pn = -k % 8, -n % 8
    if pk:
        xq = F.pad(xq, (0, pk))
        wq = F.pad(wq, (0, pk))
    if pn:
        wq = F.pad(wq, (0, 0, 0, pn))
    acc = _int8.int8_accum(xq, wq)
    return acc[:, :n] if pn else acc


class _Int8Layer(nn.Module):
    """What both quantized layers share: the int8 weight, its scales, the
    optional fp32 bias, the static activation scale (a parameter, 0 =
    dynamic) and the calibration state (``act_absmax``, a buffer)."""

    def _init_quantized(self, wq, scale, bias) -> None:
        self.weight_q = _frozen(wq)
        self.scale = _frozen(scale)
        self.act_scale = _frozen(torch.zeros((), dtype=torch.float32,
                                             device=wq.device))
        if bias is not None:
            self.bias = nn.Parameter(bias.detach().float())
        self.register_buffer("act_absmax",
                             torch.zeros((), dtype=torch.float32,
                                         device=wq.device))
        # (act_scale tensor, its version, its value on the host)
        self._static = (None, -1, 0.0)

    def _static_scale(self) -> float:
        """``act_scale`` on the host, read again only when the tensor or
        its contents changed (calibration, a weight load, a reload): a
        read per call would make the host wait for the device in every
        quantized layer."""
        t = self.act_scale
        # an inference tensor keeps no version counter (and takes no
        # in-place write outside inference mode)
        version = 0 if t.is_inference() else t._version
        if self._static[0] is not t or self._static[1] != version:
            self._static = (t, version, float(t))
        return self._static[2]

    def _record_absmax(self, x: torch.Tensor) -> None:
        # training mode is the calibration pass: the running input absmax
        if self.training:
            with torch.no_grad():
                self.act_absmax.copy_(torch.maximum(self.act_absmax,
                                                    x.abs().max()))


class QuantizedLinear(_Int8Layer):
    """Int8 ``Linear`` (reference ``quantized/Linear.scala``): per-sample
    activation scales, an exact ``s8 x s8 -> s32`` GEMM, per-output-
    channel rescale. Parameters ``weight_q`` (out, in) int8, ``scale``
    (1, out), ``act_scale`` (), ``bias`` (out,)."""

    def __init__(self, src: Linear):
        super().__init__()
        self.input_size = src.input_size
        self.output_size = src.output_size
        self.with_bias = src.bias is not None
        wq, scale = _quantize_weight(src.weight.detach(), channel_axis=0)
        self._init_quantized(wq, scale.reshape(1, -1),
                             src.bias if self.with_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).float()
        self._record_absmax(x2)
        xq, scale_x = _quantize_activation(x2, self._static_scale(),
                                           self.act_scale)
        acc = _padded_accum(xq, self.weight_q)
        y = acc.float() * (scale_x * self.scale)
        if self.with_bias:
            y = y + self.bias
        return y.reshape(shape[:-1] + (self.output_size,)).to(x.dtype)


class QuantizedSpatialConvolution(_Int8Layer):
    """Int8 convolution (reference ``quantized/SpatialConvolution.scala``),
    NCHW: per-sample activation scales; the integer values convolved in
    fp32, or under ``BIGDL_INT8_CONV=dot`` as an exact int8 GEMM over
    im2col patches (module docstring). Parameters ``weight_q`` OIHW int8,
    ``scale`` (O,), ``act_scale`` (), ``bias`` (O,)."""

    def __init__(self, src: SpatialConvolution):
        super().__init__()
        if getattr(src, "kernel_format", "OIHW") != "OIHW":
            raise ValueError(
                "quantization expects OIHW-stored conv weights; transpose "
                "the params (SpatialConvolution.weight_as_oihw) first")
        self.stride = src.stride
        self.pad = src.pad
        self.kernel = src.kernel
        self.n_group = src.n_group
        self.with_bias = src.bias is not None
        self.data_format = "NCHW"
        self.dilation = (1, 1)
        self.n_output_plane = src.n_output_plane
        wq, scale = _quantize_weight(src.weight.detach(), channel_axis=0)
        self._init_quantized(wq, scale.reshape(-1),
                             src.bias if self.with_bias else None)

    def _int8_dot_path(self, xq: torch.Tensor) -> torch.Tensor:
        """im2col + one ``s8 x s8 -> s32`` GEMM: the (kh, kw)-major taps
        of I channels each, against the weights flattened (O, kh, kw, I).
        -> int32 (B, O, Ho, Wo)."""
        wq = self.weight_q
        b, i, h, w = xq.shape
        o, _, kh_n, kw_n = wq.shape
        sh, sw = self.stride
        dh, dw = self.dilation
        ph, pw = self.pad
        if ph or pw:
            xq = F.pad(xq, (pw, pw, ph, ph))
        hp, wp = h + 2 * ph, w + 2 * pw
        ho = (hp - ((kh_n - 1) * dh + 1)) // sh + 1
        wo = (wp - ((kw_n - 1) * dw + 1)) // sw + 1
        taps = [xq[:, :, kh * dh:kh * dh + (ho - 1) * sh + 1:sh,
                   kw * dw:kw * dw + (wo - 1) * sw + 1:sw]
                for kh in range(kh_n) for kw in range(kw_n)]
        cols = torch.cat(taps, dim=1)                  # (B, K, Ho, Wo)
        rows = cols.permute(0, 2, 3, 1).reshape(b * ho * wo, -1)
        w2 = wq.permute(0, 2, 3, 1).reshape(o, -1)
        acc = _padded_accum(rows, w2)                  # (B*Ho*Wo, O)
        return acc.reshape(b, ho, wo, o).permute(0, 3, 1, 2)

    def _use_dot(self) -> bool:
        return (self.n_group == 1 and self.pad[0] >= 0 and self.pad[1] >= 0
                and os.environ.get("BIGDL_INT8_CONV", "float") == "dot")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        self._record_absmax(xf)
        xq, scale_x = _quantize_activation(xf, self._static_scale(),
                                           self.act_scale)
        if self._use_dot():
            y = self._int8_dot_path(xq).float()
        else:
            xi = xq.float()
            if self.pad[0] == -1 or self.pad[1] == -1:
                (hlo, hhi), (wlo, whi) = (
                    _same_pads(xi.shape[2 + d], self.kernel[d],
                               self.stride[d]) for d in range(2))
                xi = F.pad(xi, (wlo, whi, hlo, hhi))
                padding = 0
            else:
                padding = self.pad
            # exact under TF32 too: its 11 significant bits hold every
            # int8 value, and the products accumulate in fp32
            y = F.conv2d(xi, self.weight_q.float(), None, self.stride,
                         padding, self.dilation, self.n_group)
        # scale_x is per sample, (B, 1, 1, 1); the weight scale per channel
        y = y * scale_x * self.scale[None, :, None, None]
        if self.with_bias:
            y = y + self.bias[None, :, None, None]
        return y.to(x.dtype)


_QUANTIZED_TYPES = (QuantizedLinear, QuantizedSpatialConvolution)


def _quantize_node(module: nn.Module) -> Optional[nn.Module]:
    # exact types, not isinstance: a subclass (a parallel Linear, say)
    # carries behaviour a plain quantized layer would silently drop
    if type(module) is Linear:
        return QuantizedLinear(module)
    if type(module) is SpatialConvolution:
        return QuantizedSpatialConvolution(module)
    return None


def quantize(module: nn.Module) -> nn.Module:
    """Rewrite the module tree, quantizing every ``Linear`` and
    ``SpatialConvolution`` (reference ``Quantizer.quantize``). Returns a
    new module whose child names, and so parameter paths, are the
    original's; the original is untouched. A child registered twice stays
    one (quantized) child. Quantizing a DAG ``Graph`` needs the port's
    ``nn/graph.py`` (ROADMAP A.9) and raises."""
    return _quantize(module, {})


def _quantize(module: nn.Module, memo: Dict[int, nn.Module]) -> nn.Module:
    if id(module) in memo:
        return memo[id(module)]
    if type(module).__name__ == "Graph":
        raise NotImplementedError(
            "quantizing an nn.Graph needs the port's nn/graph.py, queued "
            "in ROADMAP A.9")
    q = _quantize_node(module)
    if q is None:
        # a container or another layer: a shallow copy whose children are
        # the rewritten ones (its own parameters and buffers are shared,
        # in dicts of its own)
        q = copy.copy(module)
        q._parameters = dict(module._parameters)
        q._buffers = dict(module._buffers)
        q._modules = {}
        for name, child in module._modules.items():
            new_child = None if child is None else _quantize(child, memo)
            q._modules[name] = new_child
            # attribute aliases of the child follow it
            for attr, val in vars(module).items():
                if val is child:
                    object.__setattr__(q, attr, new_child)
    memo[id(module)] = q
    return q


def count_executed_gemms(module: nn.Module) -> int:
    """GEMMs of a :func:`quantize` module tree that execute as ``s8 x s8
    -> s32`` products: the ``ServingMetrics.quantized_gemms`` gauge of
    ``InferenceService(quantize="int8")``. A ``QuantizedLinear`` always
    counts; a ``QuantizedSpatialConvolution`` only under
    ``BIGDL_INT8_CONV=dot`` (read now), since by default its integer
    values convolve in fp32. A child registered twice under one parent
    counts once."""
    n = 0
    if isinstance(module, QuantizedLinear):
        n += 1
    elif isinstance(module, QuantizedSpatialConvolution):
        n += int(os.environ.get("BIGDL_INT8_CONV", "float") == "dot")
    seen = set()
    for child in module._modules.values():
        if child is None or id(child) in seen:
            continue
        seen.add(id(child))
        n += count_executed_gemms(child)
    return n


def calibrate(qmodule: nn.Module, batches: Iterable) -> nn.Module:
    """Static activation-scale calibration (reference
    ``GenerateInt8Scales.scala``): run ``batches`` through the quantized
    model in training mode from its current state (the JAX ``calibrate``
    given the module's state), as the JAX package does (so batch norm
    uses batch statistics and its running statistics move), each quantized
    layer recording its running input absmax in ``act_absmax``; then set
    ``act_scale = max(absmax, 1e-8) / 127``, so inference skips the
    absmax pass. Returns ``qmodule``, calibrated in place, in the mode it
    was in."""
    was_training = qmodule.training
    qmodule.train()
    try:
        with torch.no_grad():
            for x in batches:
                qmodule(x)
    finally:
        qmodule.train(was_training)
    with torch.no_grad():
        for m in qmodule.modules():
            if isinstance(m, _QUANTIZED_TYPES):
                m.act_scale.copy_(_int8._scale(m.act_absmax))
    return qmodule


def quantized_params(qmodule: nn.Module,
                     tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The parameters of the :func:`quantize` rewrite ``qmodule`` for the
    float parameter tree ``tree`` of the module it was made from
    (``{dotted name: tensor}``): each quantized layer's ``weight_q``,
    ``scale`` and ``bias`` from its float ``weight`` and ``bias``, its
    ``act_scale`` 0 (dynamic), as :func:`quantize` makes them; every
    other leaf as given. Leaves the rewrite does not read are kept and
    missing ones left out, so the caller's signature check names the
    mismatch (a reload's way in)."""
    flat = dict(flatten_tree(tree))
    out: Dict[str, Any] = {}
    for path, m in qmodule.named_modules():
        base = path + "." if path else ""
        if not isinstance(m, _QUANTIZED_TYPES) or base + "weight" not in flat:
            continue
        wq, scale = _quantize_weight(_float(flat.pop(base + "weight")))
        out[base + "weight_q"] = wq
        out[base + "scale"] = (scale.reshape(1, -1)
                               if isinstance(m, QuantizedLinear)
                               else scale.reshape(-1))
        out[base + "act_scale"] = torch.zeros((), dtype=torch.float32)
        if base + "bias" in flat:
            out[base + "bias"] = _float(flat.pop(base + "bias"))
    out.update(flat)
    return out
