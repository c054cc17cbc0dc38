"""Port parity: the Vision Transformer on the lightgrad tape.  A small ViT
(image 32, patch 8, width 64, 3 layers, 4 heads, FFN 128, 10 labels: 17
tokens, 16 patches + CLS, not a multiple of any tile) built by the JAX
package and carried across with ``load_numpy_params``, on a 2 x 3 x 32 x 32
batch.  Checked against the JAX model (pallas interpret and xla modes):
the logits, the cross-entropy loss and step 1's gradient of every
parameter (the CLS token's summed over the batch); an eval forward after
an AdamW step.  A scanned ViT (``scan_layers=True``, each remat mode)
loads the JAX scanned model's parameters and equals the unscanned port
bit for bit.  ``remap_hf_state`` against the JAX package's on one
synthetic HF state, and ``from_pretrained`` of both packages from a
seeded ``LIGHTGRAD_CACHE``."""

import hashlib
import json

import numpy as np
import pytest
import torch

import lightgrad_tpu as light
import lightgrad_tpu_torch as lt
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models import vit as jvit
from lightgrad_tpu_torch.autograd import Tensor as TTensor
from lightgrad_tpu_torch.models import vit as tvit
from tests.torch_port import cpu_device, jax_kernel_mode, rand  # noqa: F401

CFG = dict(image_size=32, patch_size=8, num_channels=3, hidden_size=64,
           num_hidden_layers=3, num_attention_heads=4, intermediate_size=128,
           num_labels=10)
B = 2
# f32 through 3 layers: products and row sums in another order
TOL = dict(rtol=1e-4, atol=1e-5)


def _params(model):
    return {n: np.asarray(p.numpy()) for n, p in model.named_parameters()}


def _models(**kw):
    np.random.seed(0)
    jm = jvit.ViTForImageClassification(jvit.ViTConfig(**CFG, **kw))
    tm = tvit.ViTForImageClassification(tvit.ViTConfig(**CFG, **kw))
    lt.load_numpy_params(tm, _params(jm))
    return jm, tm


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rand(rng, B, 3, 32, 32),
            rng.integers(0, CFG["num_labels"], B).astype(np.int32))


def _step(T, pkg, model, x, y):
    logits = model(T.from_numpy(x, requires_grad=False))
    loss = pkg.loss.cross_entropy(logits, T.from_numpy(y,
                                                       requires_grad=False))
    model.zero_grad()
    loss.backward()
    return logits.numpy(), loss.numpy(), {
        n: p.grad.numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_logits_loss_and_gradients_match_jax(mode):
    jm, tm = _models()
    x, y = _batch()
    with jax_kernel_mode(mode):
        jl, jloss, jg = _step(JTensor, light, jm, x, y)
    tl, tloss, tg = _step(TTensor, lt, tm, x, y)
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(tloss, jloss, **TOL)
    assert sorted(tg) == sorted(jg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], **TOL, err_msg=n)
    # the CLS token's gradient is the batch's sum: not zero, (1, 1, h)
    assert tg["vit.embeddings.cls_token"].shape == (1, 1, CFG["hidden_size"])
    assert np.abs(tg["vit.embeddings.cls_token"]).max() > 0


def test_adamw_step_then_eval_matches_jax():
    jm, tm = _models()
    x, y = _batch(1)
    with jax_kernel_mode("xla"):
        jopt = light.optim.AdamW(list(jm.parameters()), lr=1e-3, eps=1e-6)
        _step(JTensor, light, jm, x, y)
        jopt.step()
        jm.eval()
        jl = jm(JTensor.from_numpy(x, requires_grad=False)).numpy()
    topt = lt.optim.AdamW(list(tm.parameters()), lr=1e-3, eps=1e-6)
    _step(TTensor, lt, tm, x, y)
    topt.step()
    tm.eval()
    with lt.no_grad():
        tl = tm(TTensor.from_numpy(x, requires_grad=False)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("remat", [False, "full", "dots"])
def test_scanned_vit_loads_jax_and_equals_the_unscanned_one(remat):
    np.random.seed(0)
    jsc = jvit.ViTForImageClassification(jvit.ViTConfig(
        **CFG, scan_layers=True))
    sc = tvit.ViTForImageClassification(tvit.ViTConfig(
        **CFG, scan_layers=True, remat=remat))
    lt.load_numpy_params(sc, _params(jsc))
    loop = tvit.ViTForImageClassification(tvit.ViTConfig(**CFG))
    loop.load_parameters(sc.state_dict())
    x, y = _batch(2)
    with jax_kernel_mode("xla"):
        jl = jsc(JTensor.from_numpy(x, requires_grad=False)).numpy()
    sl, sloss, sg = _step(TTensor, lt, sc, x, y)
    ll, lloss, lg = _step(TTensor, lt, loop, x, y)
    np.testing.assert_allclose(sl, jl, **TOL)
    assert np.array_equal(sl, ll) and np.array_equal(sloss, lloss)
    for n, stack in sc.vit.layer._stacked.items():
        for l in range(CFG["num_hidden_layers"]):
            assert np.array_equal(stack.grad.numpy()[l],
                                  lg[f"vit.layer.{l}.{n}"]), (remat, n, l)
    for n in lg:
        if not n.startswith("vit.layer."):
            assert np.array_equal(sg[n], lg[n]), (remat, n)


def _hf_state(seed=0):
    """An HF ViTForImageClassification-named state of CFG (numpy f32), the
    pooler included."""
    rng = np.random.default_rng(seed)
    h, f, c, p = (CFG["hidden_size"], CFG["intermediate_size"],
                  CFG["num_channels"], CFG["patch_size"])
    n = (CFG["image_size"] // p) ** 2
    st = {"vit.embeddings.cls_token": (1, 1, h),
          "vit.embeddings.position_embeddings": (1, n + 1, h),
          "vit.embeddings.patch_embeddings.projection.weight": (h, c, p, p),
          "vit.embeddings.patch_embeddings.projection.bias": (h,),
          "vit.layernorm.weight": (h,), "vit.layernorm.bias": (h,),
          "vit.pooler.dense.weight": (h, h), "vit.pooler.dense.bias": (h,),
          "classifier.weight": (CFG["num_labels"], h),
          "classifier.bias": (CFG["num_labels"],)}
    for i in range(CFG["num_hidden_layers"]):
        pre = f"vit.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            st[pre + f"attention.attention.{name}.weight"] = (h, h)
            st[pre + f"attention.attention.{name}.bias"] = (h,)
        st.update({pre + "attention.output.dense.weight": (h, h),
                   pre + "attention.output.dense.bias": (h,),
                   pre + "intermediate.dense.weight": (f, h),
                   pre + "intermediate.dense.bias": (f,),
                   pre + "output.dense.weight": (h, f),
                   pre + "output.dense.bias": (h,)})
        for ln in ("layernorm_before", "layernorm_after"):
            st[pre + f"{ln}.weight"] = (h,)
            st[pre + f"{ln}.bias"] = (h,)
    return {k: rand(rng, *s, scale=0.05) for k, s in st.items()}


def test_remap_hf_state_matches_jax():
    hf = _hf_state()
    want = jvit.ViTForImageClassification.remap_hf_state(hf)
    got = tvit.ViTForImageClassification.remap_hf_state(
        {k: torch.from_numpy(v) for k, v in hf.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    _, tm = _models()
    assert sorted(got) == sorted(n for n, _ in tm.named_parameters())
    tm.load_parameters(got)


def test_from_pretrained_reads_a_seeded_cache(tmp_path, monkeypatch):
    """Both packages' ``from_pretrained`` build the same ViT from an HF
    ``config.json`` and ``pytorch_model.bin`` under md5(url) in
    ``LIGHTGRAD_CACHE``; their logits agree."""
    hf = _hf_state(seed=1)
    url = "https://huggingface.co/tiny/vit/resolve/main/"

    def seed(name, data):
        key = hashlib.md5((url + name).encode()).hexdigest()
        (tmp_path / key).write_bytes(data)

    config = {k: v for k, v in CFG.items() if k != "num_labels"}
    config["id2label"] = {str(i): f"c{i}" for i in range(CFG["num_labels"])}
    seed("config.json", json.dumps(config).encode())
    torch.save({n: torch.from_numpy(a) for n, a in hf.items()},
               tmp_path / "bin")
    seed("pytorch_model.bin", (tmp_path / "bin").read_bytes())
    monkeypatch.setenv("LIGHTGRAD_CACHE", str(tmp_path))
    model, cfg = tvit.ViTForImageClassification.from_pretrained("tiny/vit")
    assert cfg.num_labels == CFG["num_labels"]
    jmodel, _ = jvit.ViTForImageClassification.from_pretrained("tiny/vit")
    jparams = _params(jmodel)
    for n, p in model.named_parameters():
        assert np.array_equal(p.numpy(), jparams[n]), n
    x, _ = _batch(3)
    with jax_kernel_mode("xla"):
        jl = jmodel(JTensor.from_numpy(x, requires_grad=False)).numpy()
    tl = model(TTensor.from_numpy(x, requires_grad=False)).numpy()
    np.testing.assert_allclose(tl, jl, **TOL)
