"""Transformer training on the port against the JAX package: one keyed
training step in four configurations, and the training loop.

Each configuration is the JAX ``Transformer(50, 32, 4, 64, 2)`` (the size
of ``tests/test_attention.py``'s) with embedding, residual and FFN
dropout 0.1 — as a language model, in translation mode (a padded source,
so the padding bias reaches the encoder and every cross-attention, whose
Sq != Sk), with an untied ``project`` head, and with attention dropout
0.1 (the plain attention path). Same weights (numpy-seeded JAX trees,
copied by module path), same ids, same key; the step is ``apply(...,
training=True, rng=key)`` then ``TimeDistributedCriterion(
CrossEntropyCriterion(), size_average=True)`` and the gradient of every
parameter.

- The draws: the port makes the JAX forward's draws in its order, each
  under the same module path and draw count (so under the same key, and
  ``test_torch_threefry.py`` holds the masks of equal keys bitwise).
- Logits within 2e-5 absolute, the loss within ``rtol=1e-6``, every
  grad leaf within ``rtol=1e-5`` plus ``1e-5`` of the leaf's largest entry
  (as ``test_torch_layers_train.py``): fp32 throughout, JAX at
  ``highest`` matmul precision; what differs is the summation order
  inside the GEMMs, softmax and layer norm (a few ulps per op, observed
  below 4e-6 on the logits and 7e-7 on the grads), and XLA, under jit,
  may multiply by the reciprocal of the dropout's keep rate where the
  port divides by it (one ulp on a kept unit).

The JAX references are jitted once per configuration, lowered in turn
(tracing is Python) and compiled together on threads with
``_jax_trees.FAST_COMPILE``.
"""

import logging
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_trees import FAST_COMPILE, assert_trees_close, seeded_trees

from bigdl_tpu.core.rng import RandomGenerator as JaxRandomGenerator
from bigdl_tpu.dataset.dataset import DataSet as JaxDataSet
from bigdl_tpu.nn import criterion as jcrit
from bigdl_tpu.nn.layers.attention import Transformer as JaxTransformer
from bigdl_tpu.nn.module import Context
from bigdl_tpu.optim import optim_method as jopt
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core import RandomGenerator
from bigdl_tpu_torch.core import threefry as tf
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.interop import export_params, load_jax_params
from bigdl_tpu_torch.nn.module import RngContext, unflatten_tree
from bigdl_tpu_torch.ops import attention as tattn
from bigdl_tpu_torch.optim import SGD, Trigger, optimizer

VOCAB, HIDDEN, HEADS, FILTER, LAYERS = 50, 32, 4, 64, 2
DROPS = dict(embedding_dropout=0.1, ffn_dropout=0.1)
CONFIGS = {
    "lm": {},
    "translation": dict(transformer_type="translation"),
    "untied": dict(with_share_weights_linear=False),
    "attention_dropout": dict(attention_dropout=0.1),
}
SEED = 5
LOGIT_TOL = 2e-5


def _criterion(module):
    return module.TimeDistributedCriterion(module.CrossEntropyCriterion(),
                                           size_average=True)


def _inputs(name):
    """(x, y): ids (2, 12) and next-token targets; in translation mode
    ``x`` is (source (2, 7) with padding 0 at its end, target (2, 9))."""
    rs = np.random.RandomState(0)
    if name == "translation":
        src = rs.randint(1, VOCAB, (2, 7))
        src[0, 5:] = src[1, 6:] = 0
        return (src, rs.randint(1, VOCAB, (2, 9))), \
            rs.randint(0, VOCAB, (2, 9))
    return rs.randint(0, VOCAB, (2, 12)), rs.randint(0, VOCAB, (2, 12))


def _lower(name, draws):
    """The jitted JAX step of one configuration, lowered; ``Context.rng``
    records each draw's (path, count) while it traces."""
    jm = JaxTransformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, **DROPS,
                        **CONFIGS[name])
    params, _ = seeded_trees(jm, seed=1)
    x, y = _inputs(name)
    crit = _criterion(jcrit)

    def loss_fn(p, x, y, key):
        out, _ = jm.apply(p, x, training=True, rng=key)
        return crit.forward(out, y), out

    args = (params, jax.tree_util.tree_map(jnp.asarray, x), jnp.asarray(y),
            jax.random.key(SEED))
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    start = len(draws)
    lowered = step.lower(*args)
    return params, lowered, args, draws[start:]


@pytest.fixture(scope="module")
def jax_refs():
    draws = []
    traced = Context.rng

    def rng(self):
        key = traced(self)
        draws.append(("/".join(self.path), self._rng_count[0]))
        return key

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Context, "rng", rng)
        lowered = {name: _lower(name, draws) for name in CONFIGS}

    def run(name):
        _, low, args, _ = lowered[name]
        step = low.compile(FAST_COMPILE)
        return jax.device_get(step(*args))

    with ThreadPoolExecutor(len(CONFIGS)) as pool:
        results = dict(zip(CONFIGS, pool.map(run, CONFIGS)))
    refs = {}
    for name, ((loss, logits), grads) in results.items():
        params, _, _, recorded = lowered[name]
        refs[name] = dict(params=params, loss=loss, logits=logits,
                          grads=grads, draws=recorded)
    return refs


def _port_model(name):
    return nn.Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cpu",
                          **DROPS, **CONFIGS[name])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_training_step_matches_jax(jax_refs, name, monkeypatch):
    ref = jax_refs[name]
    tm = _port_model(name)
    load_jax_params(tm, ref["params"])
    draws = []
    keyed = RngContext.next_key

    def next_key(self, module):
        key = keyed(self, module)
        draws.append((self._paths[id(module)], self.draws))
        return key

    monkeypatch.setattr(RngContext, "next_key", next_key)
    x, y = _inputs(name)
    x = tuple(map(torch.from_numpy, x)) if isinstance(x, tuple) \
        else torch.from_numpy(x)
    tm.train()
    logits = tm(x, rng=tf.key(SEED))
    loss = _criterion(nn)(logits, torch.from_numpy(y))
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))

    assert draws == ref["draws"]
    per_layer = {"lm": 3, "untied": 3, "attention_dropout": 4,
                 "translation": 7}[name]
    assert len(draws) == (2 if name == "translation" else 1) \
        + per_layer * LAYERS
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"],
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-6)
    got = unflatten_tree({k: g.numpy() for k, g in zip(params, grads)})
    assert_trees_close(got, ref["grads"], rtol=1e-5, atol=1e-5, what="grad")


@pytest.mark.parametrize("attention_dropout, training, b2_calls", [
    (0.1, True, 0), (0.1, False, LAYERS), (0.0, True, LAYERS)])
def test_attention_dropout_takes_the_plain_path(
        monkeypatch, attention_dropout, training, b2_calls):
    """As the JAX package's dispatch: attention dropout > 0 (training
    only) runs the plain attention, which draws the mask; otherwise every
    layer calls B2."""
    calls = []
    b2 = tattn._fa.flash_attention

    def counted(*args, **kw):
        calls.append(1)
        return b2(*args, **kw)

    monkeypatch.setattr(tattn._fa, "flash_attention", counted)
    tm = nn.Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cpu",
                        attention_dropout=attention_dropout)
    tm.train(training)
    tm(torch.zeros((1, 5), dtype=torch.long), rng=tf.key(0))
    assert len(calls) == b2_calls


def test_dropout_needs_a_key_in_training_only():
    tm = _port_model("translation")
    x = (torch.ones((1, 4), dtype=torch.long),
         torch.ones((1, 3), dtype=torch.long))
    with pytest.raises(ValueError, match="rng"):
        tm.train()(x)
    assert tm.eval()(x).shape == (1, 3, VOCAB)
    with pytest.raises(ValueError, match="language_model"):
        tm.init_paged_cache(4, 4)
    with pytest.raises(TypeError, match="Key"):
        tm.train()(x, rng=7)


def test_local_optimizer_trains_the_lm_like_jax(caplog):
    """Three steps of ``optimizer(...).optimize()`` with dropout against
    the JAX loop's. The JAX loop initialises its own params from the
    second key of ``split(key(seed))`` and splits a step key from the
    first before each step; the port loop, given those params, takes the
    same splits. Losses (from the loops' log records) and the trained
    weights within ``rtol=1e-5`` plus ``1e-5`` of each leaf's largest
    entry. The model has the shapes of the serving tests' shared JAX LM,
    whose init the JAX loop repeats here."""
    caplog.set_level(logging.INFO)
    shape = (64, 32, 4, 64, 2)
    rs = np.random.RandomState(1)
    ids = rs.randint(1, shape[0], (8, 13))
    x, y = ids[:, :-1], ids[:, 1:]

    jm = JaxTransformer(*shape, **DROPS)
    jloop = JaxLocalOptimizer(jm, JaxDataSet.tensors(x, y,
                                                     JaxRandomGenerator(3)),
                              _criterion(jcrit), 4)
    jloop.set_optim_method(jopt.SGD(0.1, momentum=0.9))
    jloop.set_end_when(JaxTrigger.max_iteration(3))
    init, _ = jm.init(jax.random.split(jax.random.key(jloop.config.seed))[1])
    jparams, _ = jloop.optimize()

    tm = nn.Transformer(*shape, device="cpu", **DROPS)
    load_jax_params(tm, jax.device_get(init))
    loop = optimizer(tm, DataSet.tensors(x, y, RandomGenerator(3)),
                     _criterion(nn), 4)
    assert loop.config.seed == jloop.config.seed
    loop.set_optim_method(SGD(0.1, momentum=0.9))
    loop.set_end_when(Trigger.max_iteration(3))
    loop.optimize()

    def losses(logger):
        return [r.args[2] for r in caplog.records if r.name == logger]

    want, got = losses("bigdl_tpu.optim"), losses("bigdl_tpu_torch.optim")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_trees_close(export_params(tm), jax.device_get(jparams),
                       rtol=1e-5, atol=1e-5, what="param")
