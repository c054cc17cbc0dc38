"""Port parity: the ported examples (``lightgrad_tpu_torch/examples/``)
against the JAX package, on the CPU.

Each example runs through its own build and step functions at a small
size (batches of a few rows, 2-3 steps); the JAX package runs the same
model (the JAX script's own classes where it defines them) and the same
step through its public API, eagerly, in xla mode, on the same numpy
inputs, with the weights carried across by ``load_numpy_params``.
Tolerances: f32 losses per step within 1e-4 relative, bf16 ``--amp``
losses within 5e-2, greedy tokens equal.  The diffusion step takes its
timesteps and noise from the test (the two packages' random streams
differ).  ``--pretrained`` paths read a ``LIGHTGRAD_CACHE`` seeded with a
synthetic checkpoint; the network is refused throughout.  The distributed
tour's tests are in tests/test_torch_examples_dist.py."""

import hashlib
import importlib.util
import io
import os
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgrad_tpu as light
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models import GPT as JGPT
from lightgrad_tpu.models import GPTConfig as JGPTConfig
from lightgrad_tpu.models import Llama as JLlama
from lightgrad_tpu.models import LlamaConfig as JLlamaConfig
from lightgrad_tpu.models import T5Config as JT5Config
from lightgrad_tpu.models import T5ForConditionalGeneration as JT5
from lightgrad_tpu.models.bert import BertForMaskedLM as JBert
from lightgrad_tpu.models.diffusion import Diffusion as JDiffusion
from lightgrad_tpu.models.diffusion import UNet as JUNet
from lightgrad_tpu.quant import quantize_module as jquantize_module
import lightgrad_tpu_torch as lt
from lightgrad_tpu_torch.examples import (bert, char_corpus, char_windows,
                                          diffusion, gpt, gradient_descent,
                                          llama, mnist, resnet, serving, t5)
from lightgrad_tpu_torch.data import _synthetic_digits
from tests.torch_port import (cpu_device, jax_batchnorm_true_gradient,  # noqa: F401
                               jax_greedy, jax_kernel_mode, one_thread)

F32 = 1e-4          # f32 losses per step, relative
BF16 = 5e-2         # bf16 --amp losses per step, relative
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise OSError("the network is refused in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def _jax_example(name):
    """The JAX package's ``examples/<name>.py`` as a module (its classes;
    nothing runs at import)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carry(tm, jm):
    """The JAX model's parameters (and buffers) into the port's model."""
    lt.load_numpy_params(tm, {n: np.asarray(t) for n, t in
                              jm.state_dict().items()})


def _j(a):
    return JTensor.from_numpy(np.asarray(a), requires_grad=False)


def _t(a):
    return lt.Tensor.from_numpy(np.asarray(a), requires_grad=False)


def _jax_step(model, opt, loss_of):
    loss = loss_of()
    opt.zero_grad()
    loss.backward()
    opt.step()
    return float(loss.numpy())


def _close(got, want, rel, what="losses"):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert err.max() <= rel, f"{what}: {got} vs {want} (rel {err.max():.2e})"


def _digits(n, seed=0):
    x, y = _synthetic_digits(n, seed=seed)
    return x.reshape(n, 784).astype(np.float32), y.astype(np.int32)


# ---------------------------------------------------------------------------
def test_gradient_descent():
    rng = np.random.default_rng(0)
    init = [rng.uniform(-1, 1, (64, 64)).astype(np.float32)
            for _ in range(3)]
    tp = tuple(lt.Tensor.from_numpy(a) for a in init)
    jp = [JTensor.from_numpy(a) for a in init]
    got = [float(gradient_descent.step(tp, 1e-3).numpy()) for _ in range(3)]
    want = []
    with jax_kernel_mode("xla"):
        for _ in range(3):
            a, b, c = jp
            y = (a.tanh() + b.sigmoid()) @ (c.relu() - a.sigmoid())
            loss = (y * y).sum()
            for p in jp:
                p.zero_grad()
            loss.backward()
            with light.no_grad():
                for p in jp:
                    p += p.grad * (-1e-3)
            want.append(float(loss.numpy()))
    _close(got, want, F32)
    assert got[-1] < got[0]
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_mnist(kind):
    jex = _jax_example("mnist")
    np.random.seed(0)
    jm = jex.MLP() if kind == "mlp" else jex.CNN()
    tm, topt = mnist.build(kind)
    _carry(tm, jm)
    jopt = light.optim.AdaBelief(jm.parameters(),
                                 lr=1e-3 if kind == "mlp" else 3e-3)
    xs, ys = _digits(48)
    got, want = [], []
    for i in range(3):
        x, y = xs[16 * i:16 * (i + 1)], ys[16 * i:16 * (i + 1)]
        got.append(float(mnist.train_step(tm, topt, kind, _t(x),
                                          _t(y)).numpy()))
        with jax_kernel_mode("xla"):
            want.append(_jax_step(jm, jopt, lambda: light.loss.cross_entropy(
                jm(_j(x) if kind == "mlp" else _j(x).reshape(16, 1, 28, 28)),
                _j(y))))
    _close(got, want, F32)
    test = lt.data.MNIST(train=False, n=32, shuffle=False, batchsize=16)
    acc = mnist.evaluate(tm, test, kind)
    with jax_kernel_mode("xla"):
        jacc = np.mean([
            (jm(_j(x.numpy()).reshape(16, -1) if kind == "mlp" else
                _j(x.numpy()).reshape(16, 1, 28, 28)).numpy().argmax(-1)
             == y.numpy()).mean() for x, y in test])
    assert acc == pytest.approx(jacc)


SMALL_RESNET = dict(stage_blocks=[1, 1], stage_channels=[8, 16],
                    num_classes=10, in_channels=1)


@pytest.mark.parametrize("amp", [False, True])
def test_resnet(amp, jax_batchnorm_true_gradient):
    """The example's step on a 2-stage ResNet of its layers (ResNet-20's
    blocks at 1 + 1 and 8 / 16 channels)."""
    from lightgrad_tpu.models.resnet import ResNet as JResNet
    from lightgrad_tpu_torch.models.resnet import ResNet

    np.random.seed(0)
    jm = JResNet(**SMALL_RESNET)
    tm = ResNet(**SMALL_RESNET)
    _carry(tm, jm)
    if amp:
        topt = lt.amp.MixedPrecision(
            tm, lambda ps: lt.optim.AdamW(ps, lr=3e-3, weight_decay=0.01))
        jopt = light.amp.MixedPrecision(
            jm, lambda ps: light.optim.AdamW(ps, lr=3e-3, weight_decay=0.01),
            compute_dtype=jnp.bfloat16)
    else:
        topt = lt.optim.AdamW(tm.parameters(), lr=3e-3, weight_decay=0.01)
        jopt = light.optim.AdamW(jm.parameters(), lr=3e-3, weight_decay=0.01)
    # 16 digits a step: at 4, the last BatchNorm normalises over few values
    # and step 2's loss moves 1e-3 with rounding alone
    xs, ys = _digits(32)
    got, want = [], []
    for i in range(2):
        x, y = xs[16 * i:16 * (i + 1)], ys[16 * i:16 * (i + 1)]
        got.append(float(resnet.train_step(tm, topt, _t(x), _t(y)).numpy()))
        with jax_kernel_mode("xla"):
            want.append(_jax_step(jm, jopt, lambda: light.loss.cross_entropy(
                jm(_j(x).reshape(16, 1, 28, 28)), _j(y))))
    _close(got, want, BF16 if amp else F32)
    test = lt.data.MNIST(train=False, n=32, shuffle=False, batchsize=16)
    acc = resnet.evaluate(tm, test)
    jm.eval()
    with jax_kernel_mode("xla"), light.no_grad():
        jacc = np.mean([(jm(_j(x.numpy()).reshape(16, 1, 28, 28)).numpy()
                         .argmax(-1) == y.numpy()).mean() for x, y in test])
    assert acc == pytest.approx(jacc)


def _seed_cache(tmp_path, monkeypatch, files):
    monkeypatch.setenv("LIGHTGRAD_CACHE", str(tmp_path))
    for url, data in files.items():
        (tmp_path / hashlib.md5(url.encode()).hexdigest()).write_bytes(data)


def _torch_bytes(state):
    buf = io.BytesIO()
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()},
               buf)
    return buf.getvalue()


def test_resnet_pretrained_from_a_seeded_cache(tmp_path, monkeypatch,
                                               capsys):
    assert resnet.pretrained_inference("cpu") is None      # offline
    assert "could not fetch" in capsys.readouterr().out
    tv = {}
    for n, t in lt.models.resnet18().state_dict().items():
        tv[n] = np.random.default_rng(len(tv)).normal(
            0, 0.05, t.shape).astype(np.float32)
    from lightgrad_tpu_torch.models.resnet import resnet18

    # the torchvision names of a model whose state is ``tv``
    model = resnet18()
    lt.load_numpy_params(model, tv)
    names = {"stem.w": "conv1.weight", "fc.weight": "fc.weight",
             "fc.bias": "fc.bias"}
    state = {}
    for n, a in tv.items():
        if n.startswith("bstem."):
            state["bn1." + n.split(".", 1)[1]] = a
        elif n in names:
            state[names[n]] = a
        else:
            _, i, part, leaf = n.split(".")
            layer, block = divmod(int(i), 2)
            part = {"c1": "conv1", "b1": "bn1", "c2": "conv2", "b2": "bn2",
                    "proj": "downsample.0", "bproj": "downsample.1"}[part]
            leaf = "weight" if leaf == "w" else leaf
            state[f"layer{layer + 1}.{block}.{part}.{leaf}"] = a
    _seed_cache(tmp_path, monkeypatch, {
        "https://download.pytorch.org/models/resnet18-f37072fd.pth":
            _torch_bytes(state)})
    got = resnet.pretrained_inference("cpu")["logits"]
    model.eval()
    x = np.random.default_rng(0).standard_normal(
        (2, 3, 224, 224)).astype(np.float32)
    with lt.no_grad():
        want = model(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bert_offline_fallback():
    tm, tok, cfg = bert.load_model_and_tokenizer(offline_layers=2,
                                                 offline_hidden=128)
    assert cfg.vocab_size == 1000 and cfg.num_hidden_layers == 2
    np.random.seed(0)
    jm = JBert(light.models.bert.BertConfig(**vars(cfg)))
    _carry(tm, jm)
    ids = np.array([tok.encode("the capital of france is [MASK] .")],
                   np.int32)
    got = bert.infer(tm, _t(ids)).numpy()
    with jax_kernel_mode("xla"), light.no_grad():
        want = jm(_j(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    pos = list(ids[0]).index(tok.ids["[MASK]"])
    assert list(np.argsort(-got[0, pos])[:5]) == \
        list(np.argsort(-want[0, pos])[:5])


def _char_batches(seq, n=3, batch=2):
    chars, stoi, data = char_corpus()
    xs, ys = char_windows(data, n * batch, seq)
    return chars, stoi, [(xs[i * batch:(i + 1) * batch],
                          ys[i * batch:(i + 1) * batch]) for i in range(n)]


def test_gpt():
    """The example's step and sampler on a 2-layer, 32-wide char GPT."""
    chars, stoi, batches = _char_batches(16, n=2)
    cfg = dict(vocab_size=len(chars), n_positions=16, n_embd=32, n_layer=2,
               n_head=2)
    tm = lt.GPT(lt.GPTConfig(**cfg), device="cpu")
    np.random.seed(0)
    jm = JGPT(JGPTConfig(**cfg))
    _carry(tm, jm)
    topt = lt.optim.Adam(list(tm.parameters()), lr=3e-4)
    jopt = light.optim.Adam(jm.parameters(), lr=3e-4)
    got, want = [], []
    for x, y in batches:
        got.append(float(gpt.train_step(tm, topt, torch.from_numpy(x).long(),
                                        torch.from_numpy(y).long()).detach()))
        with jax_kernel_mode("xla"):
            want.append(_jax_step(jm, jopt, lambda: light.loss.cross_entropy(
                jm(_j(x)).reshape(-1, len(chars)), _j(y).reshape(-1))))
    _close(got, want, F32)
    text = gpt.sample(tm, chars, stoi, temperature=0.0)
    ids = [stoi.get(c, 0) for c in "lightgrad"]
    with jax_kernel_mode("xla"):
        jout = jax_greedy(jm, ids, 16 - len(ids), 16)
    assert text == "".join(chars[i] for i in jout)


@pytest.mark.parametrize("amp", [False, True])
def test_llama(amp):
    """The example's step on a 2-layer, 32-wide char LLaMA (4 heads, 2 KV
    heads, head dim 8), f32 and ``--amp``; greedy decode."""
    chars, stoi, batches = _char_batches(16, n=2)
    cfg = dict(vocab_size=len(chars), hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=32)
    tm = lt.Llama(lt.LlamaConfig(**cfg))
    np.random.seed(0)
    jm = JLlama(JLlamaConfig(**cfg))
    _carry(tm, jm)
    if amp:
        topt = lt.amp.MixedPrecision(tm, lambda ps: lt.optim.Adam(ps, lr=3e-4),
                                     compute_dtype=torch.bfloat16)
        jopt = light.amp.MixedPrecision(
            jm, lambda ps: light.optim.Adam(ps, lr=3e-4),
            compute_dtype=jnp.bfloat16)
    else:
        topt = lt.optim.Adam(tm.parameters(), lr=3e-4)
        jopt = light.optim.Adam(jm.parameters(), lr=3e-4)
    got, want = [], []
    for x, y in batches:
        got.append(float(llama.train_step(tm, topt, _t(x), _t(y)).numpy()))
        with jax_kernel_mode("xla"):
            want.append(_jax_step(jm, jopt, lambda: light.loss.cross_entropy(
                jm(_j(x)).reshape(-1, len(chars)), _j(y).reshape(-1))))
    _close(got, want, BF16 if amp else F32)
    if not amp:
        ids = [stoi.get(c, 0) for c in "lightgrad"]
        with jax_kernel_mode("xla"):
            jout = jax_greedy(jm, ids, 12, 32)
        assert tm.generate(ids, max_new_tokens=12) == jout


def test_t5():
    """The example's step and greedy reversals on a 1 + 1-layer, 32-wide
    T5 of its vocabulary and buckets."""
    cfg = dict(vocab_size=t5.VOCAB, d_model=32, d_kv=8, d_ff=64,
               num_layers=1, num_decoder_layers=1, num_heads=4,
               relative_attention_num_buckets=16,
               relative_attention_max_distance=10, dropout_rate=0.0)
    tm = lt.models.T5ForConditionalGeneration(lt.models.T5Config(**cfg))
    np.random.seed(0)
    jm = JT5(JT5Config(**cfg))
    _carry(tm, jm)
    topt = lt.optim.Adam(tm.parameters(), lr=3e-3)
    jopt = light.optim.Adam(jm.parameters(), lr=3e-3)
    src, lab = t5.make_batch(np.random.default_rng(0), 8, 8)
    dec = tm.shift_right(lab)
    np.testing.assert_array_equal(dec, jm.shift_right(lab))
    got, want = [], []
    for i in range(2):
        x, d, y = (a[4 * i:4 * (i + 1)] for a in (src, dec, lab))
        got.append(float(t5.train_step(tm, topt, _t(x), _t(d),
                                       _t(y)).numpy()))
        with jax_kernel_mode("xla"):
            want.append(_jax_step(jm, jopt, lambda: light.loss.cross_entropy(
                jm(_j(x), _j(d)).reshape(-1, t5.VOCAB), _j(y).reshape(-1))))
    _close(got, want, F32)
    tm.eval()
    jm.eval()
    s, _, out = t5.decode(tm, 8)
    with jax_kernel_mode("xla"):
        jout = jm.generate(_j(s), max_new_tokens=8)
    np.testing.assert_array_equal(out, np.asarray(jout))


def test_diffusion():
    """The example's step at base 8 with the test's timesteps and noise;
    the EMA's shadow after both, and a reverse step under its average."""
    B, T = 2, 20
    np.random.seed(0)
    jdif = JDiffusion(JUNet(in_channels=1, base=8), timesteps=T)
    dif = lt.models.Diffusion(lt.models.UNet(in_channels=1, base=8),
                              timesteps=T)
    _carry(dif.model, jdif.model)
    topt = lt.optim.Adam(dif.model.parameters(), lr=2e-4)
    tema = lt.optim.EMA(dif.model.parameters(), decay=0.995)
    jopt = light.optim.Adam(jdif.model.parameters(), lr=2e-4)
    jema = light.optim.EMA(jdif.model.parameters(), decay=0.995)
    rng = np.random.default_rng(3)
    x, _ = _digits(2 * B)
    x = x.reshape(-1, 1, 28, 28) * 2.0 - 1.0
    got, want = [], []
    for i in range(2):
        x0 = x[B * i:B * (i + 1)]
        t = rng.integers(0, T, B).astype(np.int32)
        z = rng.standard_normal((B, 1, 28, 28)).astype(np.float32)
        got.append(float(diffusion.train_step(dif, topt, tema, _t(x0), _t(t),
                                              _t(z)).numpy()))
        with jax_kernel_mode("xla"):
            want.append(_jax_step(jdif.model, jopt,
                                  lambda: jdif.loss(_j(x0), _j(t), _j(z))))
            jema.update()
    _close(got, want, F32)
    # an element whose gradient is rounding noise moves by up to lr in
    # either direction under Adam, so the shadow may differ by (1 - decay)
    # x lr a step there
    for ts, js in zip(tema.shadow, jema.shadow):
        np.testing.assert_allclose(ts.numpy(), js.numpy(), rtol=1e-5,
                                   atol=2 * 2e-4 * (1 - 0.995))
    xt = rng.standard_normal((B, 1, 28, 28)).astype(np.float32)
    noise = rng.standard_normal((B, 1, 28, 28)).astype(np.float32)
    tt = np.full(B, T // 2, np.int32)
    with tema.average_parameters(), lt.no_grad():
        out = dif.p_sample(_t(xt), _t(tt), _t(noise)).numpy()
    with lt.no_grad():          # the average swapped back out
        assert not np.allclose(out, dif.p_sample(_t(xt), _t(tt),
                                                 _t(noise)).numpy())
    assert np.isfinite(out).all()


@pytest.mark.parametrize("name", ["mnist", "resnet", "gpt", "llama", "t5",
                                  "diffusion"])
def test_build_functions_make_the_published_configurations(name):
    """Each ``build`` function's model and optimizer at the JAX script's
    widths and learning rates (the runs above hand the steps smaller
    models)."""
    if name == "mnist":
        for kind, lr, cls in (("mlp", 1e-3, mnist.MLP), ("cnn", 3e-3,
                                                          mnist.CNN)):
            model, opt = mnist.build(kind)
            assert isinstance(model, cls)
            assert isinstance(opt, lt.optim.AdaBelief) and opt.lr == lr
    elif name == "resnet":
        model, opt = resnet.build()
        ref = lt.models.resnet20(num_classes=10, in_channels=1)
        assert [(n, p.shape) for n, p in model.named_parameters()] == \
            [(n, p.shape) for n, p in ref.named_parameters()]
        assert isinstance(opt, lt.optim.AdamW) and opt.lr == 3e-3
        model, opt = resnet.build(amp=True)
        assert isinstance(opt, lt.amp.MixedPrecision)
    elif name == "gpt":
        model, opt = gpt.build(108, 64, "cpu")
        c = model.cfg
        assert (c.vocab_size, c.n_positions, c.n_embd, c.n_layer,
                c.n_head) == (108, 64, 128, 4, 4)
        assert isinstance(opt, lt.optim.Adam) and opt.lr == 3e-4
    elif name == "llama":
        model, opt = llama.build(108, 64)
        c = model.cfg
        assert (c.hidden_size, c.intermediate_size, c.num_hidden_layers,
                c.num_attention_heads, c.num_key_value_heads,
                c.max_position_embeddings) == (128, 256, 4, 4, 2, 192)
        assert isinstance(opt, lt.optim.Adam) and opt.lr == 3e-4
        model, opt = llama.build(108, 64, use_amp=True)
        assert isinstance(opt, lt.amp.MixedPrecision)
        assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    elif name == "t5":
        model, opt = t5.build(seq=8)
        c = model.cfg
        assert (c.vocab_size, c.d_model, c.num_layers, c.num_decoder_layers,
                c.num_heads, c.relative_attention_num_buckets) == \
            (t5.VOCAB, 64, 2, 2, 4, 16)
        assert isinstance(opt, lt.optim.Adam) and opt.lr == 3e-3
    else:
        dif, opt, ema = diffusion.build()
        assert dif.T == 200 and dif.model.stem.w.shape[0] == 32
        assert isinstance(opt, lt.optim.Adam) and opt.lr == 2e-4
        assert isinstance(ema, lt.optim.EMA) and ema.decay == 0.995
        assert diffusion.build(ema_decay=0)[2] is None


@pytest.fixture(scope="module")
def serving_pair():
    np.random.seed(0)
    jm = JGPT(JGPTConfig(**serving.CFG))
    tm = serving.build(device="cpu")
    lt.load_numpy_params(tm, {n: np.asarray(t.data)
                              for n, t in jm.named_parameters()})
    np.random.seed(1)
    jd = JGPT(JGPTConfig(**serving.DRAFT))
    td = serving.build(serving.DRAFT, seed=1, device="cpu")
    lt.load_numpy_params(td, {n: np.asarray(t.data)
                              for n, t in jd.named_parameters()})
    return jm, tm, td


def test_serving_tour(serving_pair):
    jm, tm, td = serving_pair
    prompt, batch = serving.prompts()
    kv, _ = serving.kv_decode(tm, prompt)
    window = serving.CFG["n_positions"]
    with jax_kernel_mode("xla"):
        assert kv == jax_greedy(jm, prompt, 32, window)
    outs, _ = serving.batched(tm, batch)
    assert outs == [tm.generate(p, max_new_tokens=32) for p in batch]
    spec, plain = serving.speculative(tm, td, prompt)
    assert spec == plain == kv
    qout, n_q = serving.int8(tm, prompt)
    jquantize_module(jm, min_features=64)
    with jax_kernel_mode("xla"):
        jq = jax_greedy(jm, prompt, 16, window)
    assert n_q == 4 * serving.CFG["n_layer"] and qout == jq


def test_serving_main_on_one_process(capsys):
    out = serving.main("cpu")
    said = capsys.readouterr().out
    assert "[tp=2] skipped" in said and "serving tour green" in said
    assert out["n_quantized"] == 16 and out["speculative"] == out["kv"]


def _seed_repo(tmp_path, monkeypatch, name, files):
    """``files`` ({file name: bytes}) as HF repository ``name``'s, in a
    LIGHTGRAD_CACHE at ``tmp_path``."""
    url = f"https://huggingface.co/{name}/resolve/main/"
    _seed_cache(tmp_path, monkeypatch,
                {url + f: data for f, data in files.items()})


def _saved(model, tmp_path):
    model.save_pretrained(str(tmp_path / "saved"))
    return {name: (tmp_path / "saved" / name).read_bytes()
            for name in ("config.json", "pytorch_model.bin")}


@pytest.mark.parametrize("family", ["gpt", "bert", "llama", "t5"])
def test_pretrained_paths_read_a_seeded_cache(family, tmp_path, monkeypatch,
                                              capsys):
    """Each example's ``--pretrained`` path on a small synthetic checkpoint
    under the real repository's name: what it loads and decodes equals the
    saved model's own."""
    import json

    prompt = "The tensor processing unit"
    if family == "gpt":
        model = lt.GPT(lt.GPTConfig(vocab_size=256, n_positions=64, n_embd=32,
                                    n_layer=2, n_head=2), device="cpu")
        b2u = lt.models.GPT2Tokenizer._bytes_to_unicode()
        vocab = {b2u[b]: b for b in range(256)}
        _seed_repo(tmp_path, monkeypatch, "gpt2", {
            **_saved(model, tmp_path), "vocab.json": json.dumps(vocab).encode(),
            "merges.txt": b"#version: 0.2\n"})
        got = gpt.run_pretrained(prompt, device="cpu")["ids"]
        assert got == model.generate(list(prompt.encode()), max_new_tokens=30,
                                     temperature=0.7)
        assert capsys.readouterr().out.startswith(prompt)
    elif family == "bert":
        cfg = lt.models.BertConfig(vocab_size=len(
            lt.models.BertTokenizer.synthetic().vocab), hidden_size=32,
            num_hidden_layers=1, num_attention_heads=2, intermediate_size=64)
        model = lt.models.BertForMaskedLM(cfg)
        vocab = "\n".join(lt.models.BertTokenizer.synthetic().vocab).encode()
        _seed_repo(tmp_path, monkeypatch, "bert-base-uncased",
                   {**_saved(model, tmp_path), "vocab.txt": vocab})
        got, tok, got_cfg = bert.load_model_and_tokenizer()
        assert "loaded bert-base-uncased" in capsys.readouterr().out
        assert got_cfg.hidden_size == 32 and tok.vocab == \
            lt.models.BertTokenizer.synthetic().vocab
        for (n, a), (_, b) in zip(got.named_parameters(),
                                  model.named_parameters()):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=n)
    elif family == "llama":
        model = lt.Llama(lt.LlamaConfig(
            vocab_size=260, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64))
        _seed_repo(tmp_path, monkeypatch, "tiny/llama",
                   _saved(model, tmp_path))
        got = llama.run_pretrained("tiny/llama", prompt, device="cpu")["ids"]
        assert got == model.generate([1] + list(prompt.encode()),
                                     max_new_tokens=30, temperature=0.7)
    else:
        model = lt.models.T5ForConditionalGeneration(lt.models.T5Config(
            vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=1,
            num_heads=4, relative_attention_num_buckets=8,
            relative_attention_max_distance=10))
        cfg = {k: v for k, v in vars(model.cfg).items()
               if isinstance(v, (int, float, str, bool))}
        _seed_repo(tmp_path, monkeypatch, "t5-small", {
            "config.json": json.dumps(cfg).encode(),
            "pytorch_model.bin": _torch_bytes(model.export_hf_state())})
        n = t5.pretrained_demo("cpu")["params"]
        assert n == sum(int(np.prod(p.shape)) for p in model.parameters())
        assert f"loaded t5-small; {n} params" in capsys.readouterr().out


MAINS = {
    "gradient_descent": lambda: gradient_descent.main(epochs=4,
                                                      device="cpu"),
    "mnist": lambda: mnist.main("cnn", steps=4, batch=16, profile=True,
                                device="cpu"),
    "bert": lambda: bert.main(device="cpu"),
    "gpt": lambda: gpt.train_char_gpt(steps=4, batch=2, seq=16,
                                      device="cpu"),
    "llama": lambda: llama.train_char_llama(steps=4, batch=2, seq=16,
                                            use_amp=True, device="cpu"),
    "t5": lambda: t5.train(steps=4, batch=4, device="cpu"),
    "diffusion": lambda: diffusion.main(steps=2, batch=4, timesteps=4,
                                        base=16, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_runs_on_the_cpu(name, monkeypatch, capsys):
    """Each script's own entry, at a few steps on the CPU (synthetic
    digits): it runs through and prints the JAX script's lines.
    ResNet-20's entry is left to the card (chip_smoke.py phase 15): its
    evaluation over 2,000 digits costs ~20 s on one CPU thread."""
    monkeypatch.setenv("LIGHTGRAD_FAKE_DATA", "1")
    out = MAINS[name]()
    said = capsys.readouterr().out
    want = {"gradient_descent": "final loss", "mnist": "test accuracy",
            "bert": "top-k for [MASK]",
            "gpt": "sample:", "llama": "KV-cache decode: 120 tokens",
            "t5": "exact reversals", "diffusion": "sampled in"}[name]
    assert want in said, said
    if "losses" in out:
        assert np.isfinite(out["losses"]).all()
    if name == "mnist":
        assert "Function" in said          # the profiler's table
