"""Serving tour: KV decode, batching, speculation, int8, TP.

Counterpart of ``examples/serving.py`` on the port's ``torch.nn`` GPT (vocab
256, 128 positions, width 128, 4 layers, 4 heads; random weights -- the
point is the execution paths, which the tests hold against their oracles):

  1. single-stream KV-cache decode (prefill attention, the whole-stack
     decode kernel)
  2. batched serving: ragged prompts, one batched step a round (the batched
     stack kernel)
  3. speculative decoding: a 32-wide draft proposes 4, the target verifies
     them in one pass; the output equals plain greedy decoding
  4. int8 post-training quantization of the same model
     (``quant.quantize_module``), decoded uncached
  5. tensor-parallel decode over ``make_mesh(dp=1, tp=2)``, when the process
     is one of >= 2 initialised ranks (``torchrun --nproc_per_node 2``);
     skipped, and said so, on one

    python -m lightgrad_tpu_torch.examples.serving [--device cpu]
"""

import time

import numpy as np
import torch

from lightgrad_tpu_torch import quant
from lightgrad_tpu_torch.examples import device_parser
from lightgrad_tpu_torch.models import GPT, GPTConfig
from lightgrad_tpu_torch.models.decoding import generate_speculative
from lightgrad_tpu_torch.parallel import distributed

CFG = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=4, n_head=4)
DRAFT = dict(vocab_size=256, n_positions=128, n_embd=32, n_layer=1,
             n_head=2)


def build(cfg=CFG, seed=0, device="cuda"):
    """A GPT at ``cfg``, its weights drawn from ``seed``."""
    device = torch.device(device)
    return GPT(GPTConfig(**cfg), device=device,
               generator=torch.Generator(device=device).manual_seed(seed))


def prompts():
    """The tour's single prompt (8 tokens) and four ragged ones."""
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(0, 256, 8)]
    batch = [[int(t) for t in rng.integers(0, 256, n)] for n in (5, 9, 7, 3)]
    return prompt, batch


def tensor_parallel(prompt, device="cuda", weights=None):
    """Step 5's tokens: a fresh float model with the tour's weights (or
    ``weights``, by name), sharded under ``GPT_TP_RULES`` over
    ``make_mesh(dp=1, tp=2)``, decoded 16 tokens with the cache.  None on a
    rank outside the mesh."""
    from lightgrad_tpu_torch import load_numpy_params
    from lightgrad_tpu_torch.parallel import (GPT_TP_RULES, make_mesh,
                                              shard_module)

    mesh = make_mesh(dp=1, tp=2, devices=torch.device(device).type)
    if mesh.get_coordinate() is None:
        return None
    tp_model = build(device=device)
    if weights is not None:
        load_numpy_params(tp_model, weights)
    shard_module(tp_model, mesh, GPT_TP_RULES)
    return tp_model.generate(prompt, max_new_tokens=16, use_cache=True)


def _say(*args):
    if distributed.process_index() == 0:
        print(*args)


def kv_decode(model, prompt):
    """Step 1: 32 tokens of single-stream cached decode, cold then warm:
    (tokens, warm tok/s)."""
    t0 = time.perf_counter()
    model.generate(prompt, max_new_tokens=32, use_cache=True)
    t1 = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=32, use_cache=True)
    t2 = time.perf_counter()
    _say(f"[kv decode] 32 tokens: cold {t1-t0:.2f}s (compile), "
         f"warm {t2-t1:.3f}s ({32/(t2-t1):.0f} tok/s)")
    return out, 32 / (t2 - t1)


def batched(model, batch):
    """Step 2: the ragged prompts decoded together, 32 tokens each, cold
    then warm: (token lists, warm aggregate tok/s)."""
    model.generate_batch(batch, max_new_tokens=32)
    t1 = time.perf_counter()
    outs = model.generate_batch(batch, max_new_tokens=32)
    t2 = time.perf_counter()
    n_tok = sum(len(o) - len(p) for o, p in zip(outs, batch))
    _say(f"[batched x{len(batch)}] {n_tok} tokens: warm {t2-t1:.3f}s "
         f"({n_tok/(t2-t1):.0f} tok/s aggregate)")
    return outs, n_tok / (t2 - t1)


def speculative(model, draft, prompt):
    """Step 3: speculative decoding with a 4x narrower draft, which must
    equal plain greedy decoding: (tokens, the greedy tokens)."""
    spec = generate_speculative(model, draft, prompt, max_new_tokens=32, k=4)
    plain = model.generate(prompt, max_new_tokens=32, use_cache=True)
    assert [int(t) for t in spec] == [int(t) for t in plain]
    _say(f"[speculative k=4] output bit-exact vs plain greedy "
         f"({len(spec)-len(prompt)} tokens)")
    return spec, plain


def int8(model, prompt):
    """Step 4: ``quant.quantize_module`` of the model (in place), then 16
    tokens of uncached decode: (tokens, layers converted)."""
    quant.quantize_module(model, min_features=64)
    n_q = sum(isinstance(m, quant.TorchQuantLinear) for m in model.modules())
    qout = model.generate(prompt, max_new_tokens=16, use_cache=False)
    assert len(qout) == len(prompt) + 16
    _say(f"[int8] quantized {n_q} Linear layers; decode still runs")
    return qout, n_q


def main(device="cuda"):
    model = build(device=device)
    prompt, batch = prompts()
    out = {}
    out["kv"], out["kv_tok_per_s"] = kv_decode(model, prompt)
    out["batch"], out["batch_tok_per_s"] = batched(model, batch)
    out["speculative"], plain = speculative(
        model, build(DRAFT, seed=1, device=device), prompt)
    out["int8"], out["n_quantized"] = int8(model, prompt)
    if distributed.process_count() >= 2:
        tp_out = out["tp"] = tensor_parallel(prompt, device)
        if tp_out is not None:
            assert [int(t) for t in tp_out] == [int(t) for t in
                                                 plain[:len(tp_out)]]
            _say("[tp=2] sharded decode matches single-device tokens")
    else:
        _say("[tp=2] skipped: one process (run under torchrun "
             "--nproc_per_node 2 for tensor-parallel decode)")
    _say("serving tour green")
    return out


if __name__ == "__main__":
    args = device_parser(__doc__.splitlines()[0]).parse_args()
    distributed.initialize(device=args.device)   # under torchrun
    main(args.device)
