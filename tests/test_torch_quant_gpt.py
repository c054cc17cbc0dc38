"""Port parity: ``quant.quantize_module`` over the ``torch.nn`` GPT.

A GPT of 2 layers at width 128 (vocab 256, 128 positions, 4 heads; the
serving tour's model at 2 of its 4 layers) is built by the JAX package and
carried across with ``load_numpy_params``.  ``quantize_module(min_features=
64)`` runs on both: the same Linear layers are converted (more than none),
their int8 buffers are bitwise equal and their scales within 1e-7, the
logits of ``generate(use_cache=False)``'s padded window agree at the
quantized BERT's cross-package tolerance (tests/test_torch_quant.py), the
greedy tokens equal JAX's (``tests/torch_port.py::jax_greedy``: the
uncached arithmetic, eagerly), and KV-cache decoding raises the port's
``ValueError`` -- where the JAX package fails with a ``KeyError``."""

import numpy as np
import pytest
import torch

from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models import GPT as JaxGPT
from lightgrad_tpu.models import GPTConfig as JaxGPTConfig
from lightgrad_tpu.quant import QuantLinear as JQuantLinear
from lightgrad_tpu.quant import quantize_module as jquantize_module
from lightgrad_tpu_torch import GPT, GPTConfig, load_numpy_params
from lightgrad_tpu_torch.quant import TorchQuantLinear, quantize_module
from tests.torch_port import jax_greedy, jax_kernel_mode, one_thread  # noqa: F401

CFG = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2, n_head=4)
# the quantized BERT's cross-package tolerance (tests/test_torch_quant.py):
# equal int32 sums; a per-row activation scale one ulp apart can move a
# rounding tie
TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT = [int(t) for t in np.random.default_rng(0).integers(0, 256, 8)]
NEW = 12


def _jax_quantized(m, prefix=""):
    for name, sub in m._modules.items():
        if isinstance(sub, JQuantLinear):
            yield prefix + name, sub
        else:
            yield from _jax_quantized(sub, f"{prefix}{name}.")


@pytest.fixture(scope="module")
def pair():
    np.random.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG))
    tm = GPT(GPTConfig(**CFG), device="cpu")
    load_numpy_params(tm, {n: np.asarray(t.data)
                           for n, t in jm.named_parameters()})
    # a decode before the conversion leaves float decode functions behind
    tm.generate(PROMPT, max_new_tokens=2, use_cache=True)
    jquantize_module(jm, min_features=64)
    assert quantize_module(tm, min_features=64) is tm
    return jm, tm


def test_the_same_layers_convert_with_equal_buffers(pair):
    jm, tm = pair
    want = dict(_jax_quantized(jm))
    got = {n: m for n, m in tm.named_modules()
           if isinstance(m, TorchQuantLinear)}
    assert sorted(got) == sorted(want) and len(got) == 4 * CFG["n_layer"]
    for name, jq in want.items():
        tq = got[name]
        assert tq.weight_q.dtype == torch.int8
        np.testing.assert_array_equal(tq.weight_q.numpy(),
                                      np.asarray(jq.weight_q.data))
        np.testing.assert_allclose(tq.weight_scale.numpy(),
                                   np.asarray(jq.weight_scale.data),
                                   rtol=0, atol=1e-7)
        np.testing.assert_array_equal(tq.bias.detach().numpy(),
                                      np.asarray(jq.bias.data))
    # the int8 weights are buffers, not parameters
    assert not any(n.endswith(("c_attn.weight", "c_fc.weight"))
                   for n, _ in tm.named_parameters())


def test_uncached_generate_runs_the_int8_layers_as_jax_does(pair):
    jm, tm = pair
    window = CFG["n_positions"]
    ids = np.zeros((1, window), np.int32)
    ids[0, :len(PROMPT)] = PROMPT
    with jax_kernel_mode("xla"):
        want = np.asarray(jm(JTensor.from_numpy(
            ids, requires_grad=False)).data)
        jtoks = jax_greedy(jm, PROMPT, NEW, window)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    toks = tm.generate(PROMPT, max_new_tokens=NEW, use_cache=False)
    assert [int(t) for t in toks] == [int(t) for t in jtoks]
    assert len(toks) == len(PROMPT) + NEW


@pytest.mark.parametrize("path", ["generate", "beam", "generate_batch",
                                  "generate_device"])
def test_cached_decoding_of_a_quantized_gpt_raises(pair, path):
    _, tm = pair
    run = {"generate": lambda: tm.generate(PROMPT, 4, use_cache=True),
           "beam": lambda: tm.generate(PROMPT, 4, num_beams=2),
           "generate_batch": lambda: tm.generate_batch([PROMPT, PROMPT[:3]],
                                                       4),
           "generate_device": lambda: tm.generate_device(PROMPT, 4)}[path]
    with pytest.raises(ValueError, match="use_cache=False"):
        run()


def test_the_straight_through_backward_reaches_the_biases(pair):
    _, tm = pair
    ids = torch.from_numpy(np.asarray([PROMPT], np.int64))
    tm.zero_grad()
    tm(ids).float().square().mean().backward()
    lin = tm.h[0].attn.c_attn
    assert lin.bias.grad is not None and torch.isfinite(lin.bias.grad).all()
    assert tm.wte.weight.grad is not None
    tm.zero_grad()
