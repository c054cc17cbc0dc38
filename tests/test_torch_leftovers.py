"""Port parity: the ported modules' leftovers.  The exports the JAX package
has (``CpuTensor``, ``Profiler``, ``serving`` at the top level; the
decoding loops, ViT and diffusion in ``models``); ``utils.profiler.
device_trace`` writing a TensorBoard trace on the CPU; ``scan.remat_mode``
taking the ``jax.checkpoint_policies`` names with a counterpart, each
mapped and each mode's gradients bitwise the unscanned model's, "dots"
recomputing the batched products that "dots_saveable" keeps; and
``NeoX.from_pretrained`` from a seeded ``LIGHTGRAD_CACHE`` against the JAX
model's."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import lightgrad_tpu as light
import lightgrad_tpu.models as jmodels
import lightgrad_tpu_torch as lt
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models.neox import NeoX as JNeoX
from lightgrad_tpu.models.neox import NeoXConfig as JNeoXConfig
from lightgrad_tpu_torch import load_numpy_params, scan
from lightgrad_tpu_torch.autograd import Tensor
from lightgrad_tpu_torch.autograd.cuda import ops as cuda_ops
from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
from lightgrad_tpu_torch.models.neox import NeoX
from lightgrad_tpu_torch.utils import profiler
from tests.torch_port import cpu_device, jax_kernel_mode  # noqa: F401

BERT_CFG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=48,
                max_position_embeddings=16)
NEOX_CFG = dict(vocab_size=61, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=16, rotary_pct=0.5)


@pytest.mark.parametrize("name", ["CpuTensor", "Profiler", "serving"])
def test_top_level_exports_as_jax(name):
    assert hasattr(light, name)
    assert getattr(lt, name) is not None and name in lt.__all__


@pytest.mark.parametrize("name", [
    "beam_search", "generate_speculative", "generate_speculative_device",
    "ViTConfig", "ViTModel", "ViTForImageClassification", "UNet",
    "Diffusion"])
def test_models_export_as_jax(name):
    assert hasattr(jmodels, name)
    assert getattr(lt.models, name).__name__ == name


def test_device_trace_writes_a_trace(tmp_path):
    assert "device_trace" in profiler.__all__
    x = Tensor.from_numpy(np.ones((8, 8), np.float32))
    with profiler.device_trace(str(tmp_path)):
        (x @ x).sum().backward()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    events = json.loads((tmp_path / files[0]).read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)


@pytest.mark.parametrize("name,mode", sorted(scan.POLICIES.items()))
def test_remat_mode_maps_the_jax_policy_names(name, mode):
    assert scan.remat_mode(name) == mode


@pytest.mark.parametrize("value,mode", [(False, False), (None, False),
                                        (True, "full"), ("full", "full"),
                                        ("dots", "dots")])
def test_remat_mode_keeps_the_port_values(value, mode):
    assert scan.remat_mode(value) == mode


def _bert_step(remat):
    """Products launched and gradients of one masked step of the small
    BERT (the materialised branch: two batched products a layer)."""
    kw = {} if remat == "loop" else dict(scan_layers=True, remat=remat)
    rng = np.random.default_rng(0)
    m = BertForMaskedLM(BertConfig(**BERT_CFG, **kw))
    # per-layer names, which the scanned stack also takes
    m.load_parameters({
        n: (rng.standard_normal(p.shape) * 0.1).astype(np.float32)
        for n, p in BertForMaskedLM(BertConfig(
            **BERT_CFG)).named_parameters()})
    ids = rng.integers(0, 64, (2, 8)).astype(np.int32)
    mask = np.array([[1] * 8, [1] * 5 + [0] * 3], np.float32)
    out = m(Tensor.from_numpy(ids, requires_grad=False),
            attention_mask=Tensor.from_numpy(mask, requires_grad=False))
    calls = {"n": 0}
    real = cuda_ops.kmatmul

    def counted(a, b):
        calls["n"] += 1
        return real(a, b)

    cuda_ops.kmatmul = counted
    try:
        out.sum().backward()
    finally:
        cuda_ops.kmatmul = real
    return calls["n"], {n: p.grad.numpy() for n, p in m.named_parameters()}


def test_remat_policies_keep_what_they_name():
    """Backward products: "dots_saveable" keeps every forward product (as
    many as the unscanned model's backward), "dots" recomputes the two
    batched ones a layer, "nothing_saveable" recomputes all; the gradients
    stay bitwise the unscanned model's."""
    n_loop, g_loop = _bert_step("loop")
    n = {}
    for remat in ("everything_saveable", "dots_saveable", "dots",
                  "nothing_saveable"):
        n[remat], grads = _bert_step(remat)
        for name, g in grads.items():
            if "__" not in name:
                assert np.array_equal(g, g_loop[name]), (remat, name)
        for l in range(BERT_CFG["num_hidden_layers"]):
            key = "attention.self.query.weight"
            stack = grads["bert.layer." + key.replace(".", "__")]
            assert np.array_equal(stack[l], g_loop[f"bert.layer.{l}.{key}"])
    layers = BERT_CFG["num_hidden_layers"]
    assert n["everything_saveable"] == n["dots_saveable"] == n_loop
    assert n["dots"] == n_loop + 2 * layers < n["nothing_saveable"], n


def test_neox_from_pretrained_reads_a_seeded_cache(tmp_path, monkeypatch):
    """Both packages' ``from_pretrained`` build the same NeoX from an HF
    ``config.json`` and ``pytorch_model.bin`` (with the rotary and mask
    buffers HF keeps, which the remap drops); equal parameters, and logits
    within the NeoX tests' tolerance."""
    np.random.seed(0)
    src = JNeoX(JNeoXConfig(**NEOX_CFG))
    hf = {n: np.asarray(a) for n, a in src.export_hf_state().items()}
    hf["gpt_neox.layers.0.attention.rotary_emb.inv_freq"] = np.ones(
        4, np.float32)
    hf["gpt_neox.layers.0.attention.bias"] = np.ones((1, 1, 4, 4), bool)
    url = "https://huggingface.co/tiny/neox/resolve/main/"

    def seed(name, data):
        key = hashlib.md5((url + name).encode()).hexdigest()
        (tmp_path / key).write_bytes(data)

    seed("config.json", json.dumps(dict(NEOX_CFG, model_type="gpt_neox"))
         .encode())
    torch.save({n: torch.from_numpy(np.array(a)) for n, a in hf.items()},
               tmp_path / "bin")
    seed("pytorch_model.bin", (tmp_path / "bin").read_bytes())
    monkeypatch.setenv("LIGHTGRAD_CACHE", str(tmp_path))
    model, cfg = NeoX.from_pretrained("tiny/neox")
    assert cfg.rotary_pct == NEOX_CFG["rotary_pct"]
    jmodel, _ = JNeoX.from_pretrained("tiny/neox")
    jparams = {n: np.asarray(p.numpy()) for n, p in jmodel.named_parameters()}
    assert sorted(jparams) == sorted(n for n, _ in model.named_parameters())
    for n, p in model.named_parameters():
        assert np.array_equal(p.numpy(), jparams[n]), n
    ids = np.random.default_rng(1).integers(0, 61, (2, 9)).astype(np.int32)
    with jax_kernel_mode("xla"):
        want = jmodel(JTensor.from_numpy(ids, requires_grad=False)).numpy()
    got = model(Tensor.from_numpy(ids, requires_grad=False)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    # the same weights through load_numpy_params agree bit for bit
    fresh = NeoX(model.cfg)
    load_numpy_params(fresh, jparams)
    assert np.array_equal(
        fresh(Tensor.from_numpy(ids, requires_grad=False)).numpy(), got)
