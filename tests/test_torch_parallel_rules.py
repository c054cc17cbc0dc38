"""Port parity of the parallel layer's host-side logic, without ranks:
the partition rule tables (lightgrad_tpu_torch/parallel/shard.py), the
FSDP axis choice, the pipeline schedules' tables and tick counts, and the
sequence-parallel switch, each against the JAX package's.

* Each of the eight rule tables resolves every parameter name of every
  tiny model family -- BERT, GPT, LLaMA, Mixtral, T5, NeoX, GPT-MoE and a
  bare ``nn.MoE`` -- scanned-stack (``__``-mangled) names included, to the
  spec JAX's ``partition_rules`` gives (the port's ``P`` holds the same
  entries as ``PartitionSpec``).
* ``fsdp_spec`` over a grid of shapes, base specs, axis sizes, sizes
  floors and ``skip_leading``.
* 1F1B and interleaved-1F1B: the schedule and arrival tables, tick counts
  and ``peak_in_flight`` over a grid of (M, P, V); GPipe's and the
  interleaved forward's tick counts.
* ``enable_sequence_parallel`` switches the same attention modules."""

import itertools

import numpy as np
import pytest

import lightgrad_tpu.nn as jnn
from lightgrad_tpu import models as jm
from lightgrad_tpu.parallel import pipeline as jpipe
from lightgrad_tpu.parallel import pipeline_1f1b as j1f1b
from lightgrad_tpu.parallel import pipeline_1f1b_interleaved as jv
from lightgrad_tpu.parallel import shard as jshard
from lightgrad_tpu_torch import nn as tnn
from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
from lightgrad_tpu_torch.models.gpt import GPT, GPTConfig
from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
from lightgrad_tpu_torch.models.neox import NeoX, NeoXConfig
from lightgrad_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration
from lightgrad_tpu_torch.parallel import pipeline as tpipe
from lightgrad_tpu_torch.parallel import pipeline_1f1b as t1f1b
from lightgrad_tpu_torch.parallel import pipeline_1f1b_interleaved as tv
from lightgrad_tpu_torch.parallel import shard as tshard
from tests.torch_port import cpu_device  # noqa: F401

TABLES = ["BERT_TP_RULES", "GPT_TP_RULES", "LLAMA_TP_RULES", "T5_TP_RULES",
          "MOE_EP_RULES", "NEOX_TP_RULES", "GPT_MOE_RULES", "LLAMA_MOE_RULES"]

_GPT = dict(vocab_size=64, n_positions=16, n_embd=16, n_layer=2, n_head=2)
_LLAMA = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=16)
_BERT = dict(vocab_size=64, hidden_size=16, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=32,
             max_position_embeddings=16)
FAMILIES = {
    "bert": lambda: BertForMaskedLM(BertConfig(**_BERT)),
    "bert_scanned": lambda: BertForMaskedLM(BertConfig(**_BERT,
                                                       scan_layers=True)),
    "gpt": lambda: GPT(GPTConfig(**_GPT), device="cpu"),
    "gpt_scanned": lambda: GPT(GPTConfig(**_GPT, scan_layers=True),
                               device="cpu"),
    "gpt_moe": lambda: GPT(GPTConfig(**_GPT, n_experts=4, moe_hidden=32),
                           device="cpu"),
    "llama": lambda: Llama(LlamaConfig(**_LLAMA, attention_bias=True)),
    "llama_scanned": lambda: Llama(LlamaConfig(**_LLAMA, scan_layers=True)),
    "mixtral": lambda: Llama(LlamaConfig(**_LLAMA, num_local_experts=4)),
    "t5": lambda: T5ForConditionalGeneration(T5Config(
        vocab_size=32, d_model=16, d_kv=4, d_ff=32, num_layers=1,
        num_decoder_layers=1, num_heads=4, relative_attention_num_buckets=8,
        feed_forward_proj="gated-gelu")),
    "neox": lambda: NeoX(NeoXConfig(vocab_size=64, hidden_size=16,
                                    intermediate_size=32, num_hidden_layers=2,
                                    num_attention_heads=2)),
    "moe": lambda: tnn.MoE(16, 32, 4, dispatch="topk", n_shared=1,
                           ffn="swiglu"),
}


@pytest.fixture(scope="module")
def names():
    from lightgrad_tpu_torch.autograd.cuda import device

    prev = device.set_default_device("cpu")
    try:
        return {f: [n for n, _ in make().named_parameters()]
                for f, make in FAMILIES.items()}
    finally:
        device.set_default_device(prev)


def test_tables_are_the_jax_tables():
    for t in TABLES:
        port, jax = getattr(tshard, t), getattr(jshard, t)
        assert [(p, tuple(s)) for p, s in port] == \
            [(p, tuple(s)) for p, s in jax], t


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("table", TABLES)
def test_partition_rules_match_jax(names, table, family):
    port, jax = getattr(tshard, table), getattr(jshard, table)
    assert names[family]
    for n in names[family]:
        got = tshard.partition_rules(port, n)
        want = jshard.partition_rules(jax, n)
        assert tuple(got) == tuple(want), (n, got, want)


def test_scanned_names_are_stacked(names):
    """The ``__``-mangled stacks resolve with the leading layer axis."""
    stacked = [n for n in names["gpt_scanned"] if "__" in n]
    assert stacked
    for n in stacked:
        spec = tshard.partition_rules(tshard.GPT_TP_RULES, n)
        assert tuple(spec)[:1] in ((), (None,)), (n, spec)


_SHAPES = [(256, 128), (64,), (8, 48, 128), (250, 130), (1024, 64),
           (64, 1024), (4, 16, 16), (32, 32), (7, 9), (16384,)]
_BASES = [(), ("tp",), ("tp", None), (None, "tp"), ("ep", None, None)]


@pytest.mark.parametrize("n_shard,min_size,skip", list(itertools.product(
    (1, 2, 4, 8), (1, 2 ** 14), (False, True))))
def test_fsdp_spec_matches_jax(n_shard, min_size, skip):
    from jax.sharding import PartitionSpec

    for shape, base in itertools.product(_SHAPES, _BASES):
        if len(base) > len(shape):
            continue
        got = tshard.fsdp_spec(shape, tshard.P(*base), n_shard,
                               min_size=min_size, skip_leading=skip)
        want = jshard.fsdp_spec(shape, PartitionSpec(*base), n_shard,
                                min_size=min_size, skip_leading=skip)
        assert tuple(got) == tuple(want), (shape, base)


@pytest.mark.parametrize("P", [1, 2, 3, 4, 8])
def test_1f1b_tables_match_jax(P):
    for M in range(1, 17):
        for a, b in zip(t1f1b._schedule(M, P), j1f1b._schedule(M, P)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t1f1b._arrival_tables(M, P),
                        j1f1b._arrival_tables(M, P)):
            np.testing.assert_array_equal(a, b)
        assert t1f1b.onef_oneb_ticks(M, P) == j1f1b.onef_oneb_ticks(M, P)
        assert t1f1b.peak_in_flight(M, P) == j1f1b.peak_in_flight(M, P)


@pytest.mark.parametrize("P,V", [(2, 2), (4, 2), (4, 3), (2, 4), (3, 2)])
def test_interleaved_tables_match_jax(P, V):
    for M in range(1, 13):
        for a, b in zip(tv._schedule_v(M, P, V), jv._schedule_v(M, P, V)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tv._arrival_tables_v(M, P, V),
                        jv._arrival_tables_v(M, P, V)):
            np.testing.assert_array_equal(a, b)
        assert tv.interleaved_ticks(M, P, V) == jv.interleaved_ticks(M, P, V)
        assert tv.interleaved_peak_in_flight(M, P, V) == \
            jv.interleaved_peak_in_flight(M, P, V)
        assert tpipe.gpipe_ticks(M, P, V) == jpipe.gpipe_ticks(M, P, V)
        assert tpipe.interleaved_ticks(M, P, V) == \
            jpipe.interleaved_ticks(M, P, V)


_SP = [
    ("bert", lambda: BertForMaskedLM(BertConfig(**_BERT)),
     lambda: jm.BertForMaskedLM(jm.BertConfig(**_BERT))),
    ("gpt", lambda: GPT(GPTConfig(**_GPT), device="cpu"),
     lambda: jm.GPT(jm.GPTConfig(**_GPT))),
    ("llama", lambda: Llama(LlamaConfig(**_LLAMA)),
     lambda: jm.Llama(jm.LlamaConfig(**_LLAMA))),
]


@pytest.mark.parametrize("family,port,jax", _SP, ids=[s[0] for s in _SP])
def test_enable_sequence_parallel_counts_as_jax(family, port, jax):
    mesh = object()                 # only stored on the modules
    pm, jmod = port(), jax()
    n = tshard.enable_sequence_parallel(pm, mesh, axis="sp",
                                        batch_axis="dp")
    assert n == jshard.enable_sequence_parallel(jmod, mesh, axis="sp",
                                                batch_axis="dp")
    assert n == 2
    marked = [m for m in _walk(pm) if hasattr(m, "_sequence_parallel")]
    assert len(marked) == n
    assert all(m._sequence_parallel == (mesh, "sp", "dp") for m in marked)


def _walk(m):
    yield m
    for c in m._modules.values():
        if c is not None:
            yield from _walk(c)


def test_moe_module_is_the_jax_one():
    """The MoE rules are written for nn.MoE's parameter names."""
    assert [n for n, _ in tnn.MoE(8, 16, 2, n_shared=1, ffn="swiglu")
            .named_parameters()] == \
        [n for n, _ in jnn.MoE(8, 16, 2, n_shared=1, ffn="swiglu")
         .named_parameters()]
