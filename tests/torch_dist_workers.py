"""Rank functions of the port's multi-rank CPU tests.

Each test module of the parallel layer (tests/test_torch_ring_attention.py,
test_torch_pipeline.py, test_torch_shard.py, and the distributed examples'
test_torch_examples_dist.py) starts ONE spawned gloo group
in a fixture (``lightgrad_tpu_torch.parallel.distributed.spawn``, every
rank under a time limit) and runs one of the group functions below, which
run all of that module's cases and hand back their results as numpy
arrays; the tests then assert on them against the JAX package, which runs
in the parent process.  The spawned ranks import ``torch`` and the port
only -- never JAX, nor this directory's ``conftest.py`` -- so this module
imports nothing else.
"""

import numpy as np
import torch


def _np(t):
    """A whole host copy of a tensor, tape tensor or DTensor."""
    if hasattr(t, "data") and not isinstance(t, torch.Tensor):
        t = t.data
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


def _dt(x, mesh, spec):
    """numpy ``x`` as a DTensor of ``mesh`` placed as ``spec``."""
    from torch.distributed.tensor import distribute_tensor

    from lightgrad_tpu_torch.parallel.distributed import placements

    return distribute_tensor(torch.as_tensor(x), mesh, placements(mesh, spec),
                             src_data_rank=None)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------
def _ring_case(mesh, q, k, v, g, spec, causal, batch_axis=None):
    from lightgrad_tpu_torch.parallel import ring_attention_sharded

    qs, ks, vs = (_dt(x, mesh, spec).requires_grad_(True) for x in (q, k, v))
    out = ring_attention_sharded(qs, ks, vs, 0.25, mesh, axis="sp",
                                 causal=causal, batch_axis=batch_axis)
    out.backward(_dt(g, mesh, spec))
    return {"out": _np(out), "dq": _np(qs.grad), "dk": _np(ks.grad),
            "dv": _np(vs.grad)}


def _tape_sp_case(model_cls, cfg_cls, cfg, weights, ids, labels, mesh):
    """Loss and gradients of a tape model under enable_sequence_parallel,
    its ids sharded on S over sp."""
    from lightgrad_tpu_torch import load_numpy_params, loss as L
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.parallel import enable_sequence_parallel
    from lightgrad_tpu_torch.parallel.distributed import P

    m = model_cls(cfg_cls(**cfg))
    load_numpy_params(m, weights)
    n = enable_sequence_parallel(m, mesh, axis="sp")
    logits = m(Tensor(_dt(ids, mesh, P(None, "sp")), requires_grad=False))
    loss = L.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           Tensor.from_numpy(labels, requires_grad=False))
    loss.backward()
    return {"n": n, "loss": _np(loss),
            "grads": {k: _np(p.grad) for k, p in m.named_parameters()}}


def _gpt_sp_case(cfg, weights, ids, labels, mesh):
    from lightgrad_tpu_torch import GPT, GPTConfig, load_numpy_params
    from lightgrad_tpu_torch.loss import cross_entropy
    from lightgrad_tpu_torch.parallel import enable_sequence_parallel
    from lightgrad_tpu_torch.parallel.distributed import P

    m = GPT(GPTConfig(**cfg), device="cpu")
    load_numpy_params(m, weights)
    n = enable_sequence_parallel(m, mesh, axis="sp")
    logits = m(_dt(torch.from_numpy(ids).long(), mesh, P(None, "sp")))
    loss = cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         torch.from_numpy(labels).long())
    loss.backward()
    return {"n": n, "loss": _np(loss),
            "grads": {k: _np(p.grad) for k, p in m.named_parameters()}}


def ring_group(rank, n, cases):
    """Every case of tests/test_torch_ring_attention.py on 4 ranks."""
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
    from lightgrad_tpu_torch.parallel import make_mesh
    from lightgrad_tpu_torch.parallel.distributed import P

    sp4 = make_mesh(dp=1, tp=1, sp=4, devices="cpu")
    dpsp = make_mesh(dp=2, tp=1, sp=2, devices="cpu")
    out = {}
    for causal in (False, True):
        q, k, v, g = cases["ring"]
        out["ring", causal] = _ring_case(sp4, q, k, v, g, P(None, "sp"),
                                         causal)
    q, k, v, g = cases["dp_sp"]
    out["dp_sp"] = _ring_case(dpsp, q, k, v, g, P("dp", "sp"), False,
                              batch_axis="dp")
    q, k, v, g = cases["heads"]
    out["heads"] = _ring_case(sp4, q, k, v, g, P(None, None, "sp"), True)
    c = cases["bert"]
    out["bert"] = _tape_sp_case(BertForMaskedLM, BertConfig, c["cfg"],
                                c["weights"], c["ids"], c["labels"], sp4)
    c = cases["llama"]
    out["llama"] = _tape_sp_case(Llama, LlamaConfig, c["cfg"], c["weights"],
                                 c["ids"], c["labels"], sp4)
    c = cases["gpt"]
    out["gpt"] = _gpt_sp_case(c["cfg"], c["weights"], c["ids"], c["labels"],
                              sp4)
    return out


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------
def _tanh_stage(w, h):
    return torch.tanh(h @ w)


def _mse(y, t):
    return ((y - t) ** 2).mean()


def _affine_stage(p, h):
    return torch.tanh(h @ p[0] + p[1])


class _Block:
    """The tape block of the bridge cases: tanh(Linear(x))."""

    @staticmethod
    def make(dim):
        from lightgrad_tpu_torch import nn

        class Block(nn.Module):
            def __init__(self):
                super().__init__()
                self.lin = nn.Linear(dim, dim)

            def forward(self, x):
                return self.lin(x).tanh()

        return Block()


def _blocks(weights, dim):
    from lightgrad_tpu_torch import load_numpy_params

    out = []
    for w in weights:
        b = _Block.make(dim)
        load_numpy_params(b, w)
        out.append(b.eval())
    return out


def pipeline_group(rank, n, cases):
    """Every case of tests/test_torch_pipeline.py on 4 ranks (pp = 4)."""
    from lightgrad_tpu_torch.parallel import (make_mesh, pipeline_apply,
                                              pipeline_apply_interleaved,
                                              pipeline_train_1f1b,
                                              pipeline_train_1f1b_interleaved)
    from lightgrad_tpu_torch.parallel.distributed import P
    from lightgrad_tpu_torch.parallel.pipeline_1f1b import (
        load_module_grads, module_stages)
    from lightgrad_tpu_torch.parallel.pipeline_1f1b_interleaved import (
        load_module_grads_interleaved, module_stages_interleaved)

    mesh = make_mesh(dp=1, tp=1, pp=4, devices="cpu")
    t = torch.as_tensor
    out = {}
    w, b, x = cases["gpipe"]
    ws = _dt(w, mesh, P("pp")).requires_grad_(True)
    bs = t(b).requires_grad_(True)                 # whole on every rank
    y = pipeline_apply(_affine_stage, (ws, bs), t(x), mesh)
    (y * y).sum().backward()
    out["gpipe"] = {"y": _np(y), "gw": _np(ws.grad), "gb": _np(bs.grad)}
    w, x = cases["interleaved"]
    wt = t(w).requires_grad_(True)
    y = pipeline_apply_interleaved(_tanh_stage, wt, t(x), mesh, n_virtual=2)
    (y * y).mean().backward()
    out["interleaved"] = {"y": _np(y), "g": _np(wt.grad)}
    for m, (w, xs, ys) in cases["1f1b"].items():
        loss, g = pipeline_train_1f1b(_tanh_stage, _mse, _dt(w, mesh, P("pp")),
                                      t(xs), t(ys), mesh)
        out["1f1b", m] = {"loss": _np(loss), "g": _np(g)}
    for m, (w, xs, ys) in cases["1f1b_v"].items():
        loss, g = pipeline_train_1f1b_interleaved(
            _tanh_stage, _mse, _dt(w, mesh, P("pp")), t(xs), t(ys), mesh,
            n_chunks=2)
        out["1f1b_v", m] = {"loss": _np(loss), "g": _np(g)}
    weights, xs, ys, dim = cases["bridge"]
    blocks = _blocks(weights, dim)
    stage_fn, stacked = module_stages(blocks)
    loss, grads = pipeline_train_1f1b(stage_fn, _mse, stacked, t(xs), t(ys),
                                      mesh)
    load_module_grads(blocks, grads)
    out["bridge"] = {"loss": _np(loss), "grads": [
        {k: _np(p.grad) for k, p in b.named_parameters()} for b in blocks]}
    weights, xs, ys, dim = cases["bridge_v"]
    blocks = _blocks(weights, dim)
    stage_fn, stacked = module_stages_interleaved(blocks, 4, 2)
    loss, grads = pipeline_train_1f1b_interleaved(stage_fn, _mse, stacked,
                                                  t(xs), t(ys), mesh,
                                                  n_chunks=2)
    load_module_grads_interleaved(blocks, grads, 4, 2)
    out["bridge_v"] = {"loss": _np(loss), "grads": [
        {k: _np(p.grad) for k, p in b.named_parameters()} for b in blocks]}
    return out


# ---------------------------------------------------------------------------
# sharded training, decode and checkpoints
# ---------------------------------------------------------------------------
def _tape_model(family, cfg, weights):
    from lightgrad_tpu_torch import load_numpy_params
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig
    from lightgrad_tpu_torch.models.t5 import (T5Config,
                                               T5ForConditionalGeneration)

    cls, cfg_cls = {"bert": (BertForMaskedLM, BertConfig),
                    "llama": (Llama, LlamaConfig),
                    "t5": (T5ForConditionalGeneration, T5Config)}[family]
    m = cls(cfg_cls(**cfg))
    load_numpy_params(m, weights)
    return m


def _tape_steps(family, m, batch, mesh, batch_spec, steps=2):
    """``steps`` Adam steps of a tape model: (losses, whole params)."""
    from lightgrad_tpu_torch import loss as L, optim
    from lightgrad_tpu_torch.autograd import Tensor

    opt = optim.Adam(list(m.parameters()), lr=1e-3, eps=1e-6)
    ids = Tensor(_dt(batch["ids"], mesh, batch_spec), requires_grad=False)
    labels = Tensor.from_numpy(batch["labels"], requires_grad=False)
    losses = []
    for _ in range(steps):
        if family == "t5":
            dec = Tensor(_dt(batch["dec"], mesh, batch_spec),
                         requires_grad=False)
            logits = m(ids, dec)
        else:
            logits = m(ids)
        loss = L.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.numpy()))
    return losses, {k: _np(p) for k, p in m.named_parameters()}


def _gpt(cfg, weights, device="cpu"):
    from lightgrad_tpu_torch import GPT, GPTConfig, load_numpy_params

    m = GPT(GPTConfig(**cfg), device=device)
    load_numpy_params(m, weights)
    return m


def _gpt_steps(m, batch, mesh, batch_spec, steps=2):
    from lightgrad_tpu_torch import optim
    from lightgrad_tpu_torch.loss import cross_entropy

    opt = optim.Adam(list(m.parameters()), lr=1e-3, eps=1e-6)
    ids = _dt(torch.from_numpy(batch["ids"]).long(), mesh, batch_spec)
    tgt = torch.from_numpy(batch["labels"]).long()
    losses = []
    for _ in range(steps):
        logits = m(ids)
        loss = cross_entropy(logits.reshape(-1, logits.shape[-1]), tgt)
        if m.aux_loss is not None:
            loss = loss + _whole(m.aux_loss) * 0.01
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses, {k: _np(p) for k, p in m.named_parameters()}


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _gathered_params(redistributions, model):
    """The redistributions that gathered a TP-sharded parameter whole:
    a move from Shard to Replicate on the tp mesh dim of a tensor of a
    sharded parameter's shape."""
    sharded = {tuple(p.shape) for _, p in model.named_parameters()
               if any(q.is_shard() for q in _raw(p).placements)}
    return [r for r in redistributions
            if r[1] in sharded and r[2][1].is_shard()
            and not r[3][1].is_shard()]


def _raw(p):
    return p if isinstance(p, torch.Tensor) else p.data


def shard_group(rank, n, cases, ckpt_dir):
    """Every multi-rank case of tests/test_torch_shard.py on 4 ranks."""
    from lightgrad_tpu_torch import optim
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.checkpoint import (load_checkpoint_sharded,
                                                save_checkpoint_sharded)
    from lightgrad_tpu_torch.ops import runtime
    from lightgrad_tpu_torch.parallel import (BERT_TP_RULES, GPT_MOE_RULES,
                                              GPT_TP_RULES, LLAMA_TP_RULES,
                                              T5_TP_RULES, fsdp_module,
                                              make_mesh, shard_module)
    from lightgrad_tpu_torch.parallel.distributed import P

    rules = {"bert": BERT_TP_RULES, "llama": LLAMA_TP_RULES,
             "t5": T5_TP_RULES}
    dptp = make_mesh(dp=2, tp=2, devices="cpu")
    out = {}
    # tp = 2 (the batch replicated over dp) and dp x tp (sharded over dp)
    for family in ("bert", "llama", "t5"):
        c = cases[family]
        for name, spec in (("tp", P()), ("dp_tp", P("dp"))):
            if name == "dp_tp" and family != "bert":
                continue
            m = _tape_model(family, c["cfg"], c["weights"])
            shard_module(m, dptp, rules[family])
            runtime.reset_launch_counts()
            losses, params = _tape_steps(family, m, c["batch"], dptp, spec)
            out[family, name] = {
                "losses": losses, "params": params,
                "gathered": _gathered_params(runtime.redistributions(), m)}
    c = cases["gpt"]
    m = _gpt(c["cfg"], c["weights"])
    shard_module(m, dptp, GPT_TP_RULES)
    out["gpt", "tp"] = dict(zip(("losses", "params"),
                                _gpt_steps(m, c["batch"], dptp, P())))
    # the tp = 2 MLP's up-projection output: its local width
    bert = _tape_model("bert", cases["bert"]["cfg"],
                       cases["bert"]["weights"])
    shard_module(bert, dptp, BERT_TP_RULES)
    h = cases["bert"]["cfg"]["hidden_size"]
    x = Tensor(_dt(np.ones((2, 4, h), np.float32), dptp, P()),
               requires_grad=False)
    up = bert.bert.layer[0].intermediate(x)
    out["up_width"] = (tuple(up.data.to_local().shape), tuple(up.shape))
    # fsdp = 4 and fsdp x tp = 2 x 2 (the batch over fsdp)
    fs = make_mesh(dp=1, tp=1, fsdp=4, devices="cpu")
    fstp = make_mesh(dp=1, tp=2, fsdp=2, devices="cpu")
    c = cases["gpt"]
    for name, mesh, r in (("fsdp", fs, None), ("fsdp_tp", fstp, GPT_TP_RULES)):
        m = _gpt(c["cfg"], c["weights"])
        fsdp_module(m, mesh, rules=r, min_size=64)
        w = dict(m.named_parameters())["h.0.c_fc.weight"]
        losses, params = _gpt_steps(m, c["batch"], mesh, P("fsdp"))
        out["gpt", name] = {"losses": losses, "params": params,
                            "local": tuple(w.to_local().shape)}
    # GPT-MoE, dp x ep
    c = cases["moe"]
    dpep = make_mesh(dp=2, ep=2, devices="cpu")
    m = _gpt(c["cfg"], c["weights"])
    shard_module(m, dpep, GPT_MOE_RULES)
    out["moe"] = dict(zip(("losses", "params"),
                          _gpt_steps(m, c["batch"], dpep, P("dp"))))
    # tensor-parallel cached decode
    c = cases["decode"]
    m = _gpt(c["cfg"], c["weights"])
    shard_module(m, dptp, GPT_TP_RULES)
    out["decode"] = [int(t) for t in m.generate(
        list(c["ids"]), max_new_tokens=8, use_cache=True)]
    # sharded checkpoints: fsdp = 4 save; load back, load resharded to tp
    c = cases["bert"]
    m = _tape_model("bert", c["cfg"], c["weights"])
    fsdp_module(m, fs, min_size=64)
    opt = optim.Adam(list(m.parameters()), lr=1e-3, eps=1e-6)
    _one_step(m, opt, c["batch"], fs)
    save_checkpoint_sharded(ckpt_dir, m, opt, step=1, tag="port")
    saved = {k: _np(p) for k, p in m.named_parameters()}
    saved_m = [_np(t) for t in opt.m]
    fresh = _tape_model("bert", c["cfg"], cases["other_weights"])
    fsdp_module(fresh, fs, min_size=64)
    fopt = optim.Adam(list(fresh.parameters()), lr=1e-3)
    meta = load_checkpoint_sharded(ckpt_dir, fresh, fopt)
    out["ckpt_roundtrip"] = {
        "meta": meta, "saved": saved,
        "loaded": {k: _np(p) for k, p in fresh.named_parameters()},
        "m": saved_m, "loaded_m": [_np(t) for t in fopt.m],
        "t": _np(fopt.t)}
    tpm = _tape_model("bert", c["cfg"], cases["other_weights"])
    shard_module(tpm, dptp, BERT_TP_RULES)
    load_checkpoint_sharded(ckpt_dir, tpm)
    out["ckpt_reshard"] = {
        "loaded": {k: _np(p) for k, p in tpm.named_parameters()},
        "placements": {k: str(p.data.placements)
                       for k, p in tpm.named_parameters()}}
    return out


def _one_step(m, opt, batch, mesh):
    from lightgrad_tpu_torch import loss as L
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.parallel.distributed import P

    ids = Tensor(_dt(batch["ids"], mesh, P("fsdp")), requires_grad=False)
    logits = m(ids)
    loss = L.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           Tensor.from_numpy(batch["labels"],
                                             requires_grad=False))
    opt.zero_grad()
    loss.backward()
    opt.step()


def env_init_main(rank, world, port, results):
    """A rank started bare, as torchrun starts one: ``initialize()`` reads
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK from the environment."""
    import os
    import traceback

    import torch.distributed as dist

    try:
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                          WORLD_SIZE=str(world), RANK=str(rank))
        from lightgrad_tpu_torch.parallel import distributed

        joined = distributed.initialize(device="cpu")
        x = torch.ones(1) * (rank + 1)
        dist.all_reduce(x)
        results.put((rank, True, (joined, distributed.process_count(),
                                  distributed.process_index(), float(x))))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


# ---------------------------------------------------------------------------
# the distributed examples
# ---------------------------------------------------------------------------
def examples_group(rank, n, cases_path):
    """tests/test_torch_examples_dist.py on 8 ranks: the distributed
    tour's four demos, and the serving tour's tensor-parallel decode (tp 2
    on ranks 0 and 1).  The cases (weights of several MB) come from a
    pickle the test wrote: as a process argument, the parent's write of
    them into each rank's start pipe waits for that rank to import torch,
    one rank after the other."""
    import pickle

    from lightgrad_tpu_torch.examples import distributed, serving

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    out = distributed.demos(rank, n, cases["demos"], device="cpu")
    prompt, weights = cases["serving_tp"]
    out["serving_tp"] = serving.tensor_parallel(prompt, "cpu", weights)
    return out
