"""Port parity: sharded training, tensor-parallel decode and the sharded
checkpoint pair of the port's parallel layer, against the JAX package.

One spawned group of 4 gloo ranks (tests/torch_dist_workers.py, under a
time limit) runs every multi-rank case; the JAX side runs here, unsharded
(sharding changes no value).  Cases:

* two Adam steps -- losses and every parameter after -- at tp = 2 (the
  batch replicated over dp = 2) for BERT, LLaMA and T5 on the tape and the
  ``torch.nn`` GPT; BERT at dp x tp = 2 x 2; GPT at fsdp = 4 and at
  fsdp x tp = 2 x 2; GPT-MoE at dp x ep = 2 x 2.  Each at the tolerance of
  that model's own unsharded parity test;
* the tp = 2 MLP's up-projection keeps its output sharded (local width
  4d / 2), and no tape model's step gathers a TP-sharded parameter whole
  (the kernels' redistribution record);
* tp = 2 cached GPT decode gives the unsharded tokens;
* the sharded checkpoint pair: an fsdp = 4 save loaded back (parameters,
  Adam moments, meta), loaded again under tp = 2 (resharded), and read by
  the JAX package's ``load_checkpoint_sharded``.

Without ranks: ``distributed`` as the single-process no-op, and a bare
two-process ``initialize()`` that reads torchrun's environment."""

import multiprocessing as mp
import queue

import numpy as np
import pytest

import lightgrad_tpu as light
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.checkpoint import load_checkpoint_sharded as jax_load
from lightgrad_tpu.models import GPT as JGPT, GPTConfig as JGPTConfig
from lightgrad_tpu.models.bert import BertConfig as JBertConfig
from lightgrad_tpu.models.bert import BertForMaskedLM as JBert
from lightgrad_tpu.models.llama import Llama as JLlama
from lightgrad_tpu.models.llama import LlamaConfig as JLlamaConfig
from lightgrad_tpu.models import t5 as jt5
from lightgrad_tpu_torch.parallel import distributed
from lightgrad_tpu_torch.parallel.distributed import _free_port, spawn
from tests import torch_dist_workers as workers
from tests.torch_port import jax_kernel_mode

# each model's own unsharded parity tolerance (tests/test_torch_bert.py,
# test_torch_llama.py, test_torch_t5.py, test_torch_gpt_train.py,
# test_torch_gpt_moe.py)
TOL = {"bert": dict(rtol=1e-4, atol=1e-5), "llama": dict(rtol=1e-4, atol=1e-4),
       "t5": dict(rtol=1e-4, atol=1e-5), "gpt": dict(rtol=1e-5, atol=1e-5),
       "moe": dict(rtol=1e-5, atol=1e-6)}
LR, EPS, STEPS = 1e-3, 1e-6, 2

CFG = {
    "bert": dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=64,
                 max_position_embeddings=16),
    "llama": dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=16),
    "t5": dict(vocab_size=32, d_model=16, d_kv=4, d_ff=32, num_layers=1,
               num_decoder_layers=1, num_heads=4,
               relative_attention_num_buckets=8,
               relative_attention_max_distance=10, dropout_rate=0.0),
    "gpt": dict(vocab_size=64, n_positions=16, n_embd=32, n_layer=2,
                n_head=2),
    "moe": dict(vocab_size=64, n_positions=16, n_embd=16, n_layer=2,
                n_head=2, n_experts=2, moe_k=2, moe_hidden=32),
    "decode": dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=2,
                   n_head=4),
}
JAX_CLS = {"bert": (JBert, JBertConfig), "llama": (JLlama, JLlamaConfig),
           "t5": (jt5.T5ForConditionalGeneration, jt5.T5Config),
           "gpt": (JGPT, JGPTConfig), "moe": (JGPT, JGPTConfig),
           "decode": (JGPT, JGPTConfig)}


def _jax_model(family, seed):
    np.random.seed(seed)
    cls, cfg = JAX_CLS[family]
    return cls(cfg(**CFG[family]))


def _weights(m):
    return {n: np.asarray(p.data) for n, p in m.named_parameters()}


def _batch(family, seed, model):
    rng = np.random.default_rng(seed)
    vocab = CFG[family]["vocab_size"]
    if family == "t5":
        src = rng.integers(2, vocab, (4, 6)).astype(np.int32)
        return {"ids": src, "dec": model.shift_right(src),
                "labels": src.reshape(-1)}
    ids = rng.integers(0, vocab, (4, 8)).astype(np.int32)
    return {"ids": ids, "labels": np.roll(ids, -1, 1).reshape(-1)}


def _jax_steps(family, m, batch):
    """``STEPS`` Adam steps of the JAX model: (losses, params after)."""
    opt = light.optim.Adam(list(m.parameters()), lr=LR, eps=EPS)
    T = JTensor.from_numpy
    losses = []
    with jax_kernel_mode("xla"):
        for _ in range(STEPS):
            if family == "t5":
                logits = m(T(batch["ids"], requires_grad=False),
                           T(batch["dec"], requires_grad=False))
            else:
                logits = m(T(batch["ids"], requires_grad=False))
            loss = light.loss.cross_entropy(
                logits.reshape(-1, logits.shape[-1]),
                T(batch["labels"], requires_grad=False))
            if family == "moe":
                loss = loss + m.aux_loss * 0.01
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss.numpy()))
    return losses, {n: p.numpy() for n, p in m.named_parameters()}


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    cases, want = {}, {}
    for i, family in enumerate(("bert", "llama", "t5", "gpt", "moe")):
        m = _jax_model(family, 20 + i)
        cases[family] = {"cfg": CFG[family], "weights": _weights(m),
                         "batch": _batch(family, i, m)}
        want[family] = _jax_steps(family, m, cases[family]["batch"])
    cases["other_weights"] = _weights(_jax_model("bert", 99))
    m = _jax_model("decode", 0)
    ids = [int(t) for t in np.random.default_rng(0).integers(0, 64, 6)]
    cases["decode"] = {"cfg": CFG["decode"], "weights": _weights(m),
                       "ids": ids}
    with jax_kernel_mode("xla"):
        want["decode"] = [int(t) for t in m.generate(ids, max_new_tokens=8,
                                                     use_cache=True)]
    ckpt = str(tmp_path_factory.mktemp("sharded_ckpt"))
    got = spawn(workers.shard_group, 4, cases, ckpt, device="cpu",
                timeout=300, group_timeout=120)
    return got[0], want, ckpt


RUNS = [("bert", "tp"), ("bert", "dp_tp"), ("llama", "tp"), ("t5", "tp"),
        ("gpt", "tp"), ("gpt", "fsdp"), ("gpt", "fsdp_tp"), ("moe", None)]


@pytest.mark.parametrize("family,layout", RUNS,
                         ids=[f"{f}-{l}" if l else f for f, l in RUNS])
def test_sharded_steps_match_jax(shard, family, layout):
    got, want, _ = shard
    g = got[family, layout] if layout else got[family]
    losses, params = want[family]
    tol = TOL[family]
    np.testing.assert_allclose(g["losses"], losses, **tol)
    assert set(g["params"]) == set(params)
    for name, p in params.items():
        np.testing.assert_allclose(g["params"][name], p, err_msg=name, **tol)


def test_fsdp_keeps_one_nth_of_a_weight(shard):
    got, _, _ = shard
    d = CFG["gpt"]["n_embd"]
    assert got["gpt", "fsdp"]["local"] == (4 * d // 4, d)
    assert got["gpt", "fsdp_tp"]["local"] == (4 * d // 2, d // 2)


def test_tp_up_projection_stays_sharded(shard):
    got, _, _ = shard
    local, whole = got["up_width"]
    d = CFG["bert"]["intermediate_size"]
    assert whole[-1] == d and local[-1] == d // 2


@pytest.mark.parametrize("family,layout", RUNS[:4],
                         ids=[f"{f}-{l}" for f, l in RUNS[:4]])
def test_no_tp_parameter_gathered_whole(shard, family, layout):
    got, _, _ = shard
    assert got[family, layout]["gathered"] == []


def test_tp_decode_gives_unsharded_tokens(shard):
    got, want, _ = shard
    assert got["decode"] == want["decode"]


def test_sharded_checkpoint_round_trip(shard):
    got, _, _ = shard
    r = got["ckpt_roundtrip"]
    assert r["meta"] == {"step": 1, "tag": "port"}
    for name, p in r["saved"].items():
        np.testing.assert_array_equal(r["loaded"][name], p, err_msg=name)
    for a, b in zip(r["loaded_m"], r["m"]):
        np.testing.assert_array_equal(a, b)
    assert float(r["t"]) == 1.0


def test_sharded_checkpoint_reshards_on_load(shard):
    got, _, _ = shard
    r = got["ckpt_reshard"]
    saved = got["ckpt_roundtrip"]["saved"]
    for name, p in saved.items():
        np.testing.assert_array_equal(r["loaded"][name], p, err_msg=name)
    # the live TP layout is kept
    assert "Shard(dim=0)" in r["placements"][
        "bert.layer.0.intermediate.weight"]


def test_jax_reads_the_ports_sharded_checkpoint(shard):
    got, _, ckpt = shard
    r = got["ckpt_roundtrip"]
    m = _jax_model("bert", 99)
    opt = light.optim.Adam(list(m.parameters()), lr=LR)
    meta = jax_load(ckpt, m, opt)
    assert meta == {"step": 1, "tag": "port"}
    for name, p in m.named_parameters():
        np.testing.assert_array_equal(p.numpy(), r["saved"][name],
                                      err_msg=name)
    for a, b in zip(opt.m, r["m"]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_distributed_single_process_noop(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert not distributed.is_initialized()
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0


def test_two_process_initialize_from_environment():
    """Two bare ranks join through torchrun's variables alone."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=workers.env_init_main, daemon=True,
                         args=(r, 2, port, results)) for r in range(2)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(2):
            rank, ok, value = results.get(timeout=60)
            assert ok, value
            out[rank] = value
    except queue.Empty:
        pytest.fail("a rank did not report within 60 s")
    finally:
        for p in procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
    assert out == {0: (True, 2, 0, 3.0), 1: (True, 2, 1, 3.0)}


def test_port_reads_the_jax_packages_sharded_checkpoint(tmp_path):
    """The other direction, on one process: the JAX package's
    ``save_checkpoint_sharded`` directory (a trained BERT and its Adam
    state) loads into the port's BERT and Adam, value for value."""
    from lightgrad_tpu.checkpoint import save_checkpoint_sharded as jax_save
    from lightgrad_tpu_torch import optim
    from lightgrad_tpu_torch.checkpoint import load_checkpoint_sharded
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM

    jm = _jax_model("bert", 5)
    jopt = light.optim.Adam(list(jm.parameters()), lr=LR)
    batch = _batch("bert", 0, jm)
    with jax_kernel_mode("xla"):    # one step: moments that are not zero
        logits = jm(JTensor.from_numpy(batch["ids"], requires_grad=False))
        loss = light.loss.cross_entropy(
            logits.reshape(-1, logits.shape[-1]),
            JTensor.from_numpy(batch["labels"], requires_grad=False))
        jopt.zero_grad()
        loss.backward()
        jopt.step()
    jax_save(str(tmp_path), jm, jopt, step=7)
    from lightgrad_tpu_torch.autograd.cuda import device

    prev = device.set_default_device("cpu")
    try:
        tm = BertForMaskedLM(BertConfig(**CFG["bert"]))
        topt = optim.Adam(list(tm.parameters()), lr=LR)
        meta = load_checkpoint_sharded(str(tmp_path), tm, topt)
    finally:
        device.set_default_device(prev)
    assert meta == {"step": 7}
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 jm.named_parameters()):
        np.testing.assert_array_equal(p.numpy(), q.numpy(), err_msg=name)
    for a, b in zip(topt.m, jopt.m):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(topt.t) == float(jopt.t.numpy())
