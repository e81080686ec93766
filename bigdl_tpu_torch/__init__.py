"""bigdl_tpu_torch — the PyTorch / CUDA port of bigdl_tpu for NVIDIA Hopper.

A second package beside the JAX package ``bigdl_tpu``, which stays the
reference each part of the port is checked against. The port imports
``torch`` and numpy, never JAX and nothing of ``bigdl_tpu``. Its entry
points run on the card (``device=None`` means ``"cuda"``) unless the
caller asks for the CPU; the TPU kernels of the JAX package become CUDA
kernels written for Hopper under ``csrc/``, each with a plain PyTorch
version beside it.

Ported so far: the paged generation engine serving a decoder-only
``Transformer`` (``serving.GenerationEngine``, ``serving.static_generate``)
with kernels B2 (flash-attention forward) and B3 (paged decode attention),
greedy or sampled (``ops.sampling``, threefry-keyed per request), plain or
speculative (``speculate=(draft_model, k)``), float or int8, with a
prefix cache, a host KV tier, prefill/decode roles, grammar masks and
async scheduling, observed through ``obs`` (step timeline, request
traces, a metrics registry served as Prometheus text) and exercised
through ``faults`` (fault sites, a stall watchdog), over paged or dense
K/V lanes, its weights hot-reloadable; request serving
(``serving.InferenceService`` over a ``DynamicBatcher``, with B1 on a
served ResNet, ``serving.ModelRouter``, ``optim.Predictor``) of float or
``nn.quantized.quantize``-rewritten int8 models;
single-device training (``optim.optimizer``, ``optim.SGD``,
``dataset.DataSet.tensors``) of the ResNets in ``models.resnet``, with
kernel B1 (the residual add) under ``BIGDL_RESIDUAL_ADD=pallas``, and of
``nn.Transformer`` (language model, translation, untied head) with
dropout keyed by ``core.threefry`` keys bit for bit as the JAX package
keys it, and B2 with a gradient.
"""

__version__ = "0.1.0"
