"""Port parity: npz checkpoints (``lightgrad_tpu_torch.checkpoint``).

A resumed run repeats the uninterrupted one bit for bit: the torch.nn GPT
under Adam, a tape model under AdaBelief, SGD with momentum and a scanned
LLaMA under AdamW.  bfloat16 parameters round-trip exactly (widened to f32
in the file).  Each package reads the other's file: parameters, Adam's
``t`` / ``m.{i}`` / ``v.{i}`` (positional, so the two packages' parameter
orders are held equal by name) and ``__meta__`` entries, exactly.  The
write is atomic (no ``.tmp`` left behind).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import lightgrad_tpu as light
import lightgrad_tpu.checkpoint as jckpt
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models import GPT as JGPT, GPTConfig as JGPTConfig
from lightgrad_tpu_torch import (GPT, GPTConfig, amp, checkpoint as ckpt,
                                 load_numpy_params, loss, nn, optim)
from lightgrad_tpu_torch.autograd import Tensor
from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
from tests.torch_port import cpu_device  # noqa: F401

GPT_CFG = dict(vocab_size=64, n_positions=16, n_embd=32, n_layer=2,
               n_head=2)
LLAMA_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
                 num_hidden_layers=2, num_attention_heads=2,
                 num_key_value_heads=1, max_position_embeddings=16)


class TwoLayer(nn.Module):
    def __init__(self, din=6, dhid=16, dout=3):
        super().__init__()
        self.l1 = nn.Linear(din, dhid)
        self.l2 = nn.Linear(dhid, dout)

    def forward(self, x):
        return self.l2(self.l1(x).relu())


def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, 64, (2, 9)) \
        .astype(np.int32)


def _resume_matches(build, step, tmp_path, n=3):
    """n steps straight against n - 1, save, fresh objects, load, 1."""
    m1, o1 = build()
    straight = [step(m1, o1) for _ in range(n)]
    m2, o2 = build()
    for _ in range(n - 1):
        step(m2, o2)
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, m2, o2, step=n - 1, note=42)
    assert not (tmp_path / "ck.npz.tmp").exists()
    m3, o3 = build()
    meta = ckpt.load_checkpoint(path, m3, o3)
    assert int(meta["step"]) == n - 1 and int(meta["note"]) == 42
    assert step(m3, o3) == straight[-1]
    return m1, m3


def test_gpt_adam_resume_is_bitwise(tmp_path):
    ids = _ids()
    x = torch.from_numpy(ids[:, :-1]).long()
    y = torch.from_numpy(ids[:, 1:].reshape(-1)).long()

    def build():
        m = GPT(GPTConfig(**GPT_CFG), device="cpu",
                generator=torch.Generator().manual_seed(1))
        return m, optim.Adam(m.parameters(), lr=1e-2)

    def step(m, o):
        lo = F.cross_entropy(m(x).reshape(-1, 64), y)
        o.zero_grad()
        lo.backward()
        o.step()
        return lo.item()

    m1, m3 = _resume_matches(build, step, tmp_path)
    for (n, a), (_, b) in zip(m1.named_parameters(), m3.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("opt", ["AdaBelief", "SGD"])
def test_tape_resume_is_bitwise(opt, tmp_path):
    rng = np.random.default_rng(0)
    x_np = rng.uniform(-1, 1, (16, 6)).astype(np.float32)
    y_np = rng.uniform(-1, 1, (16, 3)).astype(np.float32)

    def build():
        from lightgrad_tpu_torch import random as lg_random

        lg_random.seed(11)
        m = TwoLayer()
        kw = dict(momentum=0.9) if opt == "SGD" else {}
        return m, getattr(optim, opt)(m.parameters(), lr=0.01, **kw)

    def step(m, o):
        lo = loss.mse(m(Tensor.from_numpy(x_np, requires_grad=False)),
                      Tensor.from_numpy(y_np, requires_grad=False))
        o.zero_grad()
        lo.backward()
        o.step()
        return lo.item()

    m1, m3 = _resume_matches(build, step, tmp_path, n=4)
    for (n, a), (_, b) in zip(m1.named_parameters(), m3.named_parameters()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=n)


def test_scanned_llama_resume_is_bitwise_and_per_layer(tmp_path):
    ids = _ids(1)

    def build():
        from lightgrad_tpu_torch import random as lg_random

        lg_random.seed(2)
        m = Llama(LlamaConfig(scan_layers=True, remat="dots", **LLAMA_CFG))
        return m, optim.AdamW(list(m.parameters()), lr=1e-2)

    def step(m, o):
        lo = loss.cross_entropy(
            m(Tensor.from_numpy(ids[:, :-1], requires_grad=False))
            .reshape(-1, 64),
            Tensor.from_numpy(ids[:, 1:].reshape(-1), requires_grad=False))
        o.zero_grad()
        lo.backward()
        o.step()
        return lo.item()

    m1, m3 = _resume_matches(build, step, tmp_path)
    for (n, a), (_, b) in zip(m1.named_parameters(), m3.named_parameters()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=n)
    with np.load(tmp_path / "ck.npz") as z:
        assert "layers.1.self_attn.q_proj.weight" in z.files
        # the unscanned model reads the scanned model's file
        plain = Llama(LlamaConfig(**LLAMA_CFG))
        plain.load_parameters({k: z[k] for k in z.files
                               if not k.startswith("__")})


@pytest.mark.parametrize("world", ["tape", "torch"])
def test_bf16_round_trip_is_exact(world, tmp_path):
    path = str(tmp_path / "bf16.npz")
    if world == "tape":
        m1, m2, m3 = TwoLayer(), TwoLayer(), TwoLayer()
    else:
        m1, m2, m3 = (GPT(GPTConfig(**GPT_CFG), device="cpu",
                          generator=torch.Generator().manual_seed(i))
                      for i in range(3))
    amp.cast_module(m1, torch.bfloat16)
    amp.cast_module(m2, torch.bfloat16)
    ckpt.save_checkpoint(path, m1)
    ckpt.load_checkpoint(path, m2)
    with np.load(path) as z:
        assert all(z[k].dtype == np.float32 for k in z.files)
    for (n, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        assert b.dtype == torch.bfloat16, n
        a, b = (t.numpy() if world == "tape" else t.detach().float().numpy()
                for t in (a, b))
        np.testing.assert_array_equal(a, b, err_msg=n)
    ckpt.load_checkpoint(path, m3)       # f32 model, same file
    assert all(p.dtype == torch.float32 for p in m3.parameters())


def _jax_gpt_adam(steps):
    """A JAX GPT after ``steps`` Adam steps (xla mode) and its optimizer."""
    from lightgrad_tpu.ops import runtime

    prev = runtime.set_kernel_mode("xla")
    try:
        np.random.seed(5)
        jm = JGPT(JGPTConfig(**GPT_CFG))
        jo = light.optim.Adam(list(jm.parameters()), lr=1e-2)
        ids = _ids(2)
        for _ in range(steps):
            lo = light.loss.cross_entropy(
                jm(JTensor.from_numpy(ids[:, :-1], requires_grad=False))
                .reshape(-1, 64),
                JTensor.from_numpy(ids[:, 1:].reshape(-1),
                                   requires_grad=False))
            jo.zero_grad()
            lo.backward()
            jo.step()
    finally:
        runtime.set_kernel_mode(prev)
    return jm, jo


def test_each_package_reads_the_others_file(tmp_path):
    jm, jo = _jax_gpt_adam(2)
    tm = GPT(GPTConfig(**GPT_CFG), device="cpu")
    to = optim.Adam(tm.parameters(), lr=1e-2)
    # m.{i} is positional: the orders must agree
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, jm, jo, step=2)
    meta = ckpt.load_checkpoint(jpath, tm, to)
    assert int(meta["step"]) == 2
    for (n, p), (_, q) in zip(tm.named_parameters(), jm.named_parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), q.numpy(),
                                      err_msg=n)
    assert float(to.t) == float(jo.t.numpy()) == 2.0
    for i in range(len(to.m)):
        np.testing.assert_array_equal(to.m[i].numpy(), jo.m[i].numpy())
        np.testing.assert_array_equal(to.v[i].numpy(), jo.v[i].numpy())

    tpath = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(tpath, tm, to, step=7)
    np.random.seed(9)
    jm2 = JGPT(JGPTConfig(**GPT_CFG))
    jo2 = light.optim.Adam(list(jm2.parameters()), lr=1e-2)
    meta = jckpt.load_checkpoint(tpath, jm2, jo2)
    assert int(meta["step"]) == 7
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            if k != "__meta__/step":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for (n, p), (_, q) in zip(jm2.named_parameters(), jm.named_parameters()):
        np.testing.assert_array_equal(p.numpy(), q.numpy(), err_msg=n)


def test_jax_resumes_from_the_ports_tape_file(tmp_path):
    """A scanned port LLaMA's file loads into the unscanned JAX LLaMA (the
    per-layer names) and its AdamW state into JAX's AdamW."""
    from lightgrad_tpu.models.llama import Llama as JLlama
    from lightgrad_tpu.models.llama import LlamaConfig as JLlamaConfig

    np.random.seed(0)
    jm = JLlama(JLlamaConfig(**LLAMA_CFG))
    tm = Llama(LlamaConfig(**LLAMA_CFG))
    load_numpy_params(tm, {n: np.asarray(t.data)
                           for n, t in jm.named_parameters()})
    to = optim.AdamW(list(tm.parameters()), lr=1e-2)
    ids = _ids(3)
    lo = loss.cross_entropy(
        tm(Tensor.from_numpy(ids[:, :-1], requires_grad=False))
        .reshape(-1, 64),
        Tensor.from_numpy(ids[:, 1:].reshape(-1), requires_grad=False))
    lo.backward()
    to.step()
    path = str(tmp_path / "llama.npz")
    ckpt.save_checkpoint(path, tm, to)
    jo = light.optim.AdamW(list(jm.parameters()), lr=1e-2)
    jckpt.load_checkpoint(path, jm, jo)
    for (n, p), (_, q) in zip(tm.named_parameters(), jm.named_parameters()):
        np.testing.assert_array_equal(p.numpy(), q.numpy(), err_msg=n)
    for i in range(len(to.m)):
        np.testing.assert_array_equal(to.m[i].numpy(), jo.m[i].numpy())


def test_parallel_npz_is_a_compressed_npz(tmp_path, monkeypatch):
    """The writer's file (members deflated in pieces joined after sync
    flushes, zip64 records) is a valid zip of deflated members that
    ``np.load`` reads back exactly, pieces of 1000 bytes included."""
    import zipfile

    monkeypatch.setattr(ckpt, "_PIECE", 1000)
    rng = np.random.default_rng(0)
    arrays = {"a.weight": rng.standard_normal((64, 33)).astype(np.float32),
              "b": np.arange(7), "__meta__/step": np.asarray(3),
              "empty": np.zeros((0, 4), np.float32),
              "zeros": np.zeros((300, 10), np.float32)}
    path = tmp_path / "x.npz"
    with open(path, "wb") as f:
        ckpt._write_npz(f, arrays)
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
        assert all(i.compress_type == zipfile.ZIP_DEFLATED
                   for i in z.infolist())
        zs = {i.filename: i for i in z.infolist()}
        assert zs["zeros.npy"].compress_size < zs["zeros.npy"].file_size // 4
    with np.load(path) as z:
        assert sorted(z.files) == sorted(arrays)
        for k, v in arrays.items():
            assert z[k].dtype == v.dtype
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_parallel_npz_zip64_fields(tmp_path, monkeypatch):
    """With the zip64 threshold lowered, every size and offset takes the
    zip64 records, as a checkpoint over 2 GB does: zipfile and np.load
    read the file, and the threads of the reader each open it."""
    import zipfile

    monkeypatch.setattr(ckpt, "_ZIP64_LIMIT", 64)
    monkeypatch.setattr(ckpt, "_PIECE", 700)
    rng = np.random.default_rng(1)
    arrays = {f"w.{i}": rng.standard_normal((40, 9)).astype(np.float32)
              for i in range(12)}
    path = tmp_path / "z64.npz"
    with open(path, "wb") as f:
        ckpt._write_npz(f, arrays)
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
    got = ckpt._read_npz(str(path))
    assert list(got) == list(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
