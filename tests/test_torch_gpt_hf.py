"""Port parity: GPT-2's and BERT's HF state interop -- ``remap_hf_state``,
``export_hf_state``, ``save_pretrained`` and ``from_pretrained``.

A synthetic HF GPT-2 state (Conv1D weights stored (in, out), the
attention's ``bias`` / ``masked_bias`` buffers, the tied ``lm_head``)
goes through both packages' ``remap_hf_state``: equal dicts, numpy in and
torch tensors in.  The export remaps back to the same state, a scanned
GPT's export equals the unscanned one's.  Each package's
``save_pretrained`` file is read by the other (the JAX package's
``load_torch_state_dict``; the port's ``torch.load(weights_only=True)``),
with equal arrays and equal ``config.json``.  ``from_pretrained`` of both
packages runs from a pre-seeded ``LIGHTGRAD_CACHE`` with no network; the
two models' parameters are equal.  BERT has the same checks for its save /
load pair.  Exact equality throughout.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from lightgrad_tpu.models import GPT as JGPT, GPTConfig as JGPTConfig
from lightgrad_tpu.models.bert import BertConfig as JBertConfig
from lightgrad_tpu.models.bert import BertForMaskedLM as JBert
from lightgrad_tpu.utils import load_torch_state_dict
from lightgrad_tpu_torch import GPT, GPTConfig, load_numpy_params
from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
from tests.torch_port import cpu_device  # noqa: F401

GPT_CFG = dict(vocab_size=64, n_positions=16, n_embd=16, n_layer=2,
               n_head=2)
BERT_CFG = dict(vocab_size=64, hidden_size=16, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=32,
                max_position_embeddings=8)


def _hf_gpt_state(seed=0):
    rng = np.random.default_rng(seed)
    d, V, P = GPT_CFG["n_embd"], GPT_CFG["vocab_size"], GPT_CFG["n_positions"]
    s = {"transformer.wte.weight": (V, d), "transformer.wpe.weight": (P, d),
         "transformer.ln_f.weight": (d,), "transformer.ln_f.bias": (d,),
         "lm_head.weight": (V, d)}
    for l in range(GPT_CFG["n_layer"]):
        pre = f"transformer.h.{l}."
        s.update({pre + "ln_1.weight": (d,), pre + "ln_1.bias": (d,),
                  pre + "ln_2.weight": (d,), pre + "ln_2.bias": (d,),
                  pre + "attn.c_attn.weight": (d, 3 * d),
                  pre + "attn.c_attn.bias": (3 * d,),
                  pre + "attn.c_proj.weight": (d, d),
                  pre + "attn.c_proj.bias": (d,),
                  pre + "attn.bias": (1, 1, P, P),
                  pre + "attn.masked_bias": (),
                  pre + "mlp.c_fc.weight": (d, 4 * d),
                  pre + "mlp.c_fc.bias": (4 * d,),
                  pre + "mlp.c_proj.weight": (4 * d, d),
                  pre + "mlp.c_proj.bias": (d,)})
    return {n: rng.standard_normal(sh).astype(np.float32)
            for n, sh in s.items()}


def _equal(a, b, name):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_array_equal(a, b, err_msg=name)


def test_gpt_remap_matches_jax_and_round_trips():
    hf = _hf_gpt_state()
    want = JGPT.remap_hf_state(dict(hf))
    got = GPT.remap_hf_state(dict(hf))
    got_t = GPT.remap_hf_state({n: torch.from_numpy(a)
                                for n, a in hf.items()})
    assert sorted(got) == sorted(want) == sorted(got_t)
    assert not any(n.endswith((".attn.bias", ".attn.masked_bias"))
                   or "lm_head" in n for n in got)
    for n in want:
        _equal(got[n], want[n], n)
        _equal(got_t[n], want[n], n)
    assert got["h.0.c_fc.weight"].shape == (64, 16)
    m = GPT(GPTConfig(**GPT_CFG), device="cpu")
    m.load_state_dict(got_t)
    exported = m.export_hf_state()
    back = GPT.remap_hf_state(exported)
    assert sorted(back) == sorted(want)
    for n in want:
        _equal(back[n], want[n], n)
    # a scanned GPT exports the unscanned layout
    sc = GPT(GPTConfig(scan_layers=True, **GPT_CFG), device="cpu")
    sc.load_state_dict(got_t)
    sce = sc.export_hf_state()
    assert sorted(sce) == sorted(exported)
    for n in exported:
        _equal(sce[n], exported[n], n)


def test_gpt_save_pretrained_is_read_across_packages(tmp_path):
    state = JGPT.remap_hf_state(_hf_gpt_state(1))
    tm = GPT(GPTConfig(**GPT_CFG), device="cpu")
    load_numpy_params(tm, state)
    np.random.seed(0)
    jm = JGPT(JGPTConfig(**GPT_CFG))
    jm.load_parameters(state)
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    tpath, jpath = tm.save_pretrained(str(tdir)), jm.save_pretrained(
        str(jdir))
    assert json.loads((tdir / "config.json").read_text()) == \
        json.loads((jdir / "config.json").read_text())
    with open(tpath, "rb") as f:
        read_by_jax = load_torch_state_dict(f.read())
    read_by_port = torch.load(jpath, weights_only=True)
    names = sorted(jm.export_hf_state())
    assert sorted(read_by_jax) == sorted(read_by_port) == names
    for n in names:
        _equal(read_by_jax[n], read_by_port[n], n)


def _seed_cache(tmp_path, url, files):
    for name, data in files.items():
        key = hashlib.md5((url + name).encode()).hexdigest()
        (tmp_path / key).write_bytes(data)


def test_gpt_from_pretrained_reads_a_seeded_cache(tmp_path, monkeypatch):
    hf = _hf_gpt_state(2)
    torch.save({n: torch.from_numpy(a) for n, a in hf.items()},
               tmp_path / "bin")
    url = "https://huggingface.co/tiny/gpt2/resolve/main/"
    _seed_cache(tmp_path, url, {
        "config.json": json.dumps(dict(GPT_CFG, model_type="gpt2")).encode(),
        "pytorch_model.bin": (tmp_path / "bin").read_bytes()})
    monkeypatch.setenv("LIGHTGRAD_CACHE", str(tmp_path))
    model, cfg = GPT.from_pretrained("tiny/gpt2", device="cpu")
    assert cfg.n_layer == GPT_CFG["n_layer"]
    jmodel, _ = JGPT.from_pretrained("tiny/gpt2")
    jp = dict(jmodel.named_parameters())
    assert [n for n, _ in model.named_parameters()] == list(jp)
    for n, p in model.named_parameters():
        _equal(p.detach(), jp[n].numpy(), n)


def test_bert_save_pretrained_is_read_across_packages(tmp_path):
    np.random.seed(13)
    jm = JBert(JBertConfig(**BERT_CFG))
    tm = BertForMaskedLM(BertConfig(**BERT_CFG))
    load_numpy_params(tm, {n: np.asarray(t.data)
                           for n, t in jm.named_parameters()})
    back = BertForMaskedLM.remap_hf_state(tm.export_hf_state())
    ours = tm.state_dict()
    assert set(back) == set(ours)
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    tpath, jpath = tm.save_pretrained(str(tdir)), jm.save_pretrained(
        str(jdir))
    assert json.loads((tdir / "config.json").read_text()) == \
        json.loads((jdir / "config.json").read_text())
    with open(tpath, "rb") as f:
        read_by_jax = load_torch_state_dict(f.read())
    read_by_port = torch.load(jpath, weights_only=True)
    assert sorted(read_by_jax) == sorted(read_by_port) == \
        sorted(jm.export_hf_state())
    for n in read_by_port:
        _equal(read_by_jax[n], read_by_port[n], n)
    m2 = BertForMaskedLM(BertConfig(**BERT_CFG))
    m2.load_parameters(BertForMaskedLM.remap_hf_state(read_by_port))
    for (n, a), (_, b) in zip(tm.named_parameters(), m2.named_parameters()):
        _equal(a.numpy(), b.numpy(), n)


@pytest.mark.parametrize("scan", [False, True], ids=["loop", "scanned"])
def test_bert_from_pretrained_reads_a_seeded_cache(scan, tmp_path,
                                                   monkeypatch):
    np.random.seed(3)
    src = JBert(JBertConfig(**BERT_CFG))
    src.save_pretrained(str(tmp_path / "src"))
    url = "https://huggingface.co/tiny/bert/resolve/main/"
    config = dict(BERT_CFG, model_type="bert", scan_layers=scan)
    _seed_cache(tmp_path, url, {
        "config.json": json.dumps(config).encode(),
        "pytorch_model.bin": (tmp_path / "src" /
                              "pytorch_model.bin").read_bytes()})
    monkeypatch.setenv("LIGHTGRAD_CACHE", str(tmp_path))
    model, cfg = BertForMaskedLM.from_pretrained("tiny/bert")
    assert cfg.scan_layers == scan
    jmodel, _ = JBert.from_pretrained("tiny/bert")
    want = jmodel.state_dict()
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for n in want:
        _equal(got[n], want[n], n)
