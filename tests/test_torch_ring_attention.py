"""Port parity: ring attention over the port's ``flash_block``
(lightgrad_tpu_torch/parallel/ring_attention.py) against the JAX package's
``ring_attention_sharded`` on a 4-device mesh, and the sequence-parallel
branches of the ported models against the JAX models.

One spawned group of 4 gloo ranks (tests/torch_dist_workers.py, under a
time limit) runs every multi-rank case; the JAX side runs here on the
conftest's virtual CPU devices.  Cases: sp = 4, causal and not (out, dq,
dk, dv); dp x sp = 2 x 2 with the batch sharded over dp; the 4-D
(b, heads, s, d) shape; BERT, LLaMA (grouped-query) and the ``torch.nn``
GPT under ``enable_sequence_parallel``, loss and every gradient.  Without
ranks: a chunked merge of ``flash_block`` calls -- the ring's rounds on
one process -- against ``flash_block_reference`` of the whole sequence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import lightgrad_tpu as light
from lightgrad_tpu import parallel as jpar
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models.bert import BertConfig as JBertConfig
from lightgrad_tpu.models.bert import BertForMaskedLM as JBertForMaskedLM
from lightgrad_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from lightgrad_tpu.models.llama import Llama as JLlama
from lightgrad_tpu.models.llama import LlamaConfig as JLlamaConfig
from lightgrad_tpu_torch.autograd.ops import flash_block
from lightgrad_tpu_torch.ops.attention import flash_block_reference
from lightgrad_tpu_torch.parallel.distributed import spawn
from tests import torch_dist_workers as workers
from tests.torch_port import jax_kernel_mode

# f32 ring against JAX's ring: the same rounds, merged in the same order
RING_TOL = dict(rtol=1e-5, atol=5e-5)
# each model's own unsharded parity tolerance (tests/test_torch_bert.py,
# test_torch_llama.py, test_torch_gpt_train.py)
MODEL_TOL = {"bert": dict(rtol=1e-4, atol=1e-5),
             "llama": dict(rtol=1e-4, atol=1e-4),
             "gpt": dict(rtol=1e-5, atol=1e-5)}
SCALE = 0.25

CFGS = {
    "bert": dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=64,
                 max_position_embeddings=32),
    "llama": dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=32),
    "gpt": dict(vocab_size=96, n_positions=32, n_embd=32, n_layer=2,
                n_head=2),
}
JAX_MODELS = {"bert": (JBertForMaskedLM, JBertConfig),
              "llama": (JLlama, JLlamaConfig), "gpt": (JGPT, JGPTConfig)}


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(4)]


def _jax_ring(q, k, v, g, spec, causal, mesh_kw, batch_axis=None):
    mesh = jpar.make_mesh(**mesh_kw)
    sh = NamedSharding(mesh, spec)
    qs, ks, vs = (jax.device_put(jnp.asarray(x), sh) for x in (q, k, v))
    # its rounds' block in the xla mode: exact attention, no interpreter
    with jax_kernel_mode("xla"):
        out, vjp = jax.vjp(lambda a, b, c: jpar.ring_attention_sharded(
            a, b, c, SCALE, mesh, axis="sp", causal=causal,
            batch_axis=batch_axis), qs, ks, vs)
        dq, dk, dv = vjp(jnp.asarray(g))
    return {"out": out, "dq": dq, "dk": dk, "dv": dv}


def _jax_model(family, seed):
    np.random.seed(seed)
    cls, cfg = JAX_MODELS[family]
    m = cls(cfg(**CFGS[family]))
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 96, (2, 16)).astype(np.int32)
    labels = rng.integers(0, 96, 32).astype(np.int32)
    with jax_kernel_mode("xla"):
        logits = m(JTensor.from_numpy(ids, requires_grad=False))
        loss = light.loss.cross_entropy(
            logits.reshape(32, 96), JTensor.from_numpy(labels,
                                                       requires_grad=False))
        loss.backward()
    weights = {n: np.asarray(p.data) for n, p in m.named_parameters()}
    want = {"loss": loss.numpy(),
            "grads": {n: p.grad.numpy() for n, p in m.named_parameters()}}
    return {"cfg": CFGS[family], "weights": weights, "ids": ids,
            "labels": labels}, want


@pytest.fixture(scope="module")
def ring():
    """(the ranks' results, the JAX side's) for every case."""
    cases, want = {}, {}
    cases["ring"] = _arrays((2, 64, 16), 1)
    for causal in (False, True):
        want["ring", causal] = _jax_ring(*cases["ring"], JP(None, "sp", None),
                                         causal, dict(dp=1, tp=1, sp=4))
    cases["dp_sp"] = _arrays((4, 32, 16), 2)
    want["dp_sp"] = _jax_ring(*cases["dp_sp"], JP("dp", "sp", None), False,
                              dict(dp=2, tp=1, sp=2), batch_axis="dp")
    cases["heads"] = _arrays((2, 3, 64, 16), 3)
    want["heads"] = _jax_ring(*cases["heads"], JP(None, None, "sp", None),
                              True, dict(dp=1, tp=1, sp=4))
    for i, family in enumerate(("bert", "llama", "gpt")):
        cases[family], want[family] = _jax_model(family, 7 + i)
    got = spawn(workers.ring_group, 4, cases, device="cpu", timeout=240,
                group_timeout=120)
    return got[0], want


@pytest.mark.parametrize("case", [("ring", False), ("ring", True), "dp_sp",
                                  "heads"],
                         ids=["sp4", "sp4_causal", "dp2_sp2", "heads_4d"])
@pytest.mark.parametrize("what", ["out", "dq", "dk", "dv"])
def test_ring_matches_jax_ring(ring, case, what):
    got, want = ring
    np.testing.assert_allclose(got[case][what], np.asarray(want[case][what]),
                               **RING_TOL)


@pytest.mark.parametrize("family", ["bert", "llama", "gpt"])
def test_sequence_parallel_model_matches_jax(ring, family):
    got, want = ring
    g, w = got[family], want[family]
    assert g["n"] == CFGS[family].get("num_hidden_layers",
                                      CFGS[family].get("n_layer"))
    tol = MODEL_TOL[family]
    np.testing.assert_allclose(g["loss"], w["loss"], **tol)
    assert set(g["grads"]) == set(w["grads"])
    for name, gw in w["grads"].items():
        np.testing.assert_allclose(g["grads"][name], gw, err_msg=name, **tol)


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_merge_equals_whole_sequence(causal):
    """The ring's call pattern on one process: 4 chunks, the causal
    diagonal, full earlier chunks and skipped later ones, merged by lse
    in f32 -- against one plain call over the whole sequence, forward
    and gradients."""
    rng = np.random.default_rng(4)
    q, k, v, g = (torch.tensor(rng.normal(0, 0.5, (3, 64, 16)),
                               dtype=torch.float32) for _ in range(4))
    n, s = 4, 16
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    outs = []
    for i in range(n):
        qi = qs[:, i * s:(i + 1) * s]
        acc = lse = None
        for j in range(n):
            if causal and j > i:
                continue                    # a later chunk: skipped
            o, l_ = flash_block(qi, ks[:, j * s:(j + 1) * s],
                                vs[:, j * s:(j + 1) * s], SCALE,
                                causal and i == j)
            if acc is None:
                acc, lse = o.float(), l_
            else:
                new = torch.logaddexp(lse, l_)
                acc = acc * torch.exp(lse - new) + o * torch.exp(l_ - new)
                lse = new
        outs.append(acc)
    out = torch.cat(outs, 1)
    out.backward(g)
    q2, k2, v2 = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = flash_block_reference(q2, k2, v2, SCALE, causal)[0]
    ref.backward(g)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    for a, b in ((qs, q2), (ks, k2), (vs, v2)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_local_equals_whole_sequence(causal):
    """``ring_local``: every rank's rounds of a 4-rank ring on one device
    (the pattern the card runs), through the ring's own per-round code,
    against one plain call over the whole sequence."""
    from lightgrad_tpu_torch.parallel.ring_attention import ring_local

    rng = np.random.default_rng(6)
    q, k, v, g = (torch.tensor(rng.normal(0, 0.5, (2, 64, 16)),
                               dtype=torch.float32) for _ in range(4))
    out, dq, dk, dv = ring_local(q, k, v, g, SCALE, 4, causal)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_block_reference(*ts, SCALE, causal)[0]
    ref.backward(g)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    for got, t in zip((dq, dk, dv), ts):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)
