"""Port parity: the LLaMA family's HF state interop -- ``remap_hf_state``,
``export_hf_state``, ``save_pretrained`` and ``from_pretrained``.

A synthetic HF Mixtral state (per-expert ``w1`` / ``w2`` / ``w3`` Linears
as HF stores them, ``gate`` for the router, rotary ``inv_freq`` buffers) of
the tiny Mixtral of tests/test_torch_mixtral.py goes through both
packages' ``remap_hf_state``: equal dicts (numpy in, and torch tensors in
on the port's side).  The port's export remaps back to its state.  The
port's ``save_pretrained`` (``torch.save``) is read by the JAX package's
``load_torch_state_dict`` and the JAX package's file by the port's
``torch.load(weights_only=True)``: equal arrays, equal ``config.json``
(Mistral's window too).  ``from_pretrained`` of both packages runs from a
pre-seeded ``LIGHTGRAD_CACHE`` with no network.  Exact equality throughout.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from lightgrad_tpu.models.llama import Llama as JLlama
from lightgrad_tpu.models.llama import LlamaConfig as JLlamaConfig
from lightgrad_tpu.utils import load_torch_state_dict
from lightgrad_tpu_torch import load_numpy_params
from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
from tests.test_torch_mixtral import CFG as MIXTRAL
from tests.torch_port import cpu_device  # noqa: F401

MISTRAL = dict(MIXTRAL, num_local_experts=0, sliding_window=8)


def _hf_state(cfg, seed=0):
    """An HF-named state of ``cfg`` (numpy f32): per-expert (out, in)
    Linears, the router as ``gate``, the rotary buffers HF keeps."""
    rng = np.random.default_rng(seed)
    d, ff, E = (cfg["hidden_size"], cfg["intermediate_size"],
                cfg["num_local_experts"])
    hd = d // cfg["num_attention_heads"]
    kvh = cfg["num_key_value_heads"] * hd
    state = {"model.embed_tokens.weight": (cfg["vocab_size"], d),
             "model.norm.weight": (d,), "lm_head.weight": (cfg["vocab_size"],
                                                           d)}
    for l in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{l}."
        state.update({pre + "input_layernorm.weight": (d,),
                      pre + "post_attention_layernorm.weight": (d,),
                      pre + "self_attn.q_proj.weight": (d, d),
                      pre + "self_attn.k_proj.weight": (kvh, d),
                      pre + "self_attn.v_proj.weight": (kvh, d),
                      pre + "self_attn.o_proj.weight": (d, d),
                      pre + "self_attn.rotary_emb.inv_freq": (hd // 2,)})
        if E:
            state[pre + "block_sparse_moe.gate.weight"] = (E, d)
            for e in range(E):
                ex = pre + f"block_sparse_moe.experts.{e}."
                state.update({ex + "w1.weight": (ff, d),
                              ex + "w2.weight": (d, ff),
                              ex + "w3.weight": (ff, d)})
        else:
            state.update({pre + "mlp.gate_proj.weight": (ff, d),
                          pre + "mlp.up_proj.weight": (ff, d),
                          pre + "mlp.down_proj.weight": (d, ff)})
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in state.items()}


def test_remap_hf_state_matches_jax_and_round_trips():
    hf = _hf_state(MIXTRAL)
    want = JLlama.remap_hf_state(dict(hf))
    got = Llama.remap_hf_state(dict(hf))
    got_t = Llama.remap_hf_state({n: torch.from_numpy(a)
                                  for n, a in hf.items()})
    assert sorted(got) == sorted(want) == sorted(got_t)
    assert "layers.0.block_sparse_moe.router.weight" in got
    assert not any("inv_freq" in n or "experts" in n for n in got)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        np.testing.assert_array_equal(got_t[n].numpy(), want[n], err_msg=n)
    assert got["layers.1.block_sparse_moe.w2"].shape == (
        MIXTRAL["num_local_experts"], MIXTRAL["intermediate_size"],
        MIXTRAL["hidden_size"])
    # the remapped state loads into the port's Mixtral, and its export
    # remaps back to the same state
    model = Llama(LlamaConfig(**MIXTRAL))
    model.load_parameters(got_t)
    again = Llama.remap_hf_state(model.export_hf_state())
    assert sorted(again) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(again[n], want[n], err_msg=n)


@pytest.mark.parametrize("cfg", [MIXTRAL, MISTRAL],
                         ids=["mixtral", "mistral"])
def test_save_pretrained_is_read_across_packages(cfg, tmp_path):
    state = JLlama.remap_hf_state(_hf_state(cfg, seed=1))
    tm = Llama(LlamaConfig(**cfg))
    load_numpy_params(tm, state)
    np.random.seed(0)
    jm = JLlama(JLlamaConfig(**cfg))
    jm.load_parameters(state)
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    tpath, jpath = tm.save_pretrained(str(tdir)), jm.save_pretrained(
        str(jdir))
    tcfg = json.loads((tdir / "config.json").read_text())
    assert tcfg == json.loads((jdir / "config.json").read_text())
    assert (tcfg["model_type"] == "mistral") == bool(cfg.get(
        "sliding_window"))
    with open(tpath, "rb") as f:
        read_by_jax = load_torch_state_dict(f.read())
    read_by_port = torch.load(jpath, weights_only=True)
    hf_names = sorted(jm.export_hf_state())
    assert sorted(read_by_jax) == sorted(read_by_port) == hf_names
    for n in hf_names:
        a = np.asarray(read_by_jax[n])
        np.testing.assert_array_equal(a, read_by_port[n].numpy(), err_msg=n)
        np.testing.assert_array_equal(
            a, state[n.removeprefix("model.")], err_msg=n)


def test_from_pretrained_reads_a_seeded_cache(tmp_path, monkeypatch):
    """Both packages' ``from_pretrained`` build the same Mixtral from an
    HF ``config.json`` and ``pytorch_model.bin`` under md5(url) in
    ``LIGHTGRAD_CACHE``."""
    hf = _hf_state(MIXTRAL, seed=2)
    url = "https://huggingface.co/tiny/mixtral/resolve/main/"

    def seed(name, data):
        key = hashlib.md5((url + name).encode()).hexdigest()
        (tmp_path / key).write_bytes(data)

    config = dict(MIXTRAL, model_type="mixtral", router_jitter_noise=0.0)
    seed("config.json", json.dumps(config).encode())
    torch.save({n: torch.from_numpy(a) for n, a in hf.items()},
               tmp_path / "bin")
    seed("pytorch_model.bin", (tmp_path / "bin").read_bytes())
    monkeypatch.setenv("LIGHTGRAD_CACHE", str(tmp_path))
    model, cfg = Llama.from_pretrained("tiny/mixtral")
    assert cfg.num_local_experts == MIXTRAL["num_local_experts"]
    jmodel, _ = JLlama.from_pretrained("tiny/mixtral")
    jparams = dict(jmodel.named_parameters())
    assert sorted(jparams) == sorted(n for n, _ in model.named_parameters())
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.numpy(), jparams[n].numpy(),
                                      err_msg=n)
