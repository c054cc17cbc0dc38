"""One sharded training step per parallel form, on N local ranks.

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip`` for the port:
:func:`dryrun_multichip` spawns ``n_devices`` ranks on the device it is
told (``"cuda"``: one card a rank, NCCL; ``"cpu"``: gloo) -- never moving
to the CPU on its own -- and each rank runs the JAX dry run's legs at tiny
shapes:

* BERT (tape) over dp x tp x sp, ring attention on the sp axis;
* GPT-2 blocks through the 1F1B and the interleaved-1F1B pipelines;
* GPT-MoE (``torch.nn``) with its experts over ep;
* T5 (tape) over dp x tp;
* GPT-2 (``torch.nn``) under fsdp, and under fsdp x tp.

Every loss must be finite; the FSDP legs also check the local shard shape
of a sharded weight.  Run it as ``python -m
lightgrad_tpu_torch.parallel.dryrun N [cpu|cuda]`` (it spawns the ranks),
or under ``torchrun --nproc-per-node N -m lightgrad_tpu_torch.parallel.dryrun
N`` (one rank a process).
"""

import os
import sys

import numpy as np
import torch

from . import distributed
from .mesh import axis_rank, axis_size

__all__ = ["dryrun_multichip"]


def _finite(name, losses):
    assert all(np.isfinite(v) for v in losses), (name, losses)
    return losses


def _bert_leg(n, dev):
    from .. import loss as L, optim
    from ..autograd import Tensor
    from ..models.bert import BertConfig, BertForMaskedLM
    from . import (BERT_TP_RULES, enable_sequence_parallel, make_mesh,
                   shard_module)
    from .distributed import P, distribute_batch

    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % 4 == 0 else 1
    dp = n // (tp * sp)
    mesh = make_mesh(dp=dp, tp=tp, sp=sp, devices=dev)
    np.random.seed(0)
    cfg = BertConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=128,
                     max_position_embeddings=32)
    model = BertForMaskedLM(cfg)
    shard_module(model, mesh, BERT_TP_RULES)
    if sp > 1:
        enable_sequence_parallel(model, mesh, axis="sp",
                                 batch_axis="dp" if dp > 1 else None)
    opt = optim.Adam(list(model.parameters()), lr=1e-3)
    batch, seq = 2 * dp, 16
    ids_np = np.random.randint(0, cfg.vocab_size, (batch, seq)).astype(
        np.int32)
    # each rank's own block of the (dp, sp)-sharded batch
    bi, si = axis_rank(mesh, "dp"), axis_rank(mesh, "sp")
    local = ids_np.reshape(dp, batch // dp, sp, seq // sp)[bi, :, si]
    ids = Tensor(distribute_batch(mesh, local, P("dp", "sp")),
                 requires_grad=False)
    labels = Tensor.from_numpy(ids_np.reshape(-1), requires_grad=False)
    losses = []
    for _ in range(3):
        logits = model(ids).reshape(batch * seq, cfg.vocab_size)
        loss = L.cross_entropy(logits, labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.numpy()))
    return {"bert": _finite("bert", losses), "mesh": (dp, tp, sp)}


def _pipeline_leg(n, dev):
    from ..models.gpt import GPTBlock, GPTConfig
    from . import make_mesh
    from .pipeline_1f1b import module_stages, pipeline_train_1f1b
    from .pipeline_1f1b_interleaved import (module_stages_interleaved,
                                            pipeline_train_1f1b_interleaved)

    pp, vchunks, n_micro, mb, seq = n, 2, 4, 2, 8
    cfg = GPTConfig(vocab_size=32, n_positions=seq, n_embd=16,
                    n_layer=pp * vchunks, n_head=2)
    mesh = make_mesh(dp=1, tp=1, pp=pp, devices=dev)
    device = _device(dev)
    torch.manual_seed(7)
    blocks = [GPTBlock(cfg, device=device) for _ in range(pp * vchunks)]
    rng = np.random.default_rng(1)
    xm = torch.tensor(rng.normal(size=(n_micro, mb, seq, cfg.n_embd))
                      .astype(np.float32) * 0.5, device=device)
    ym = torch.tensor(rng.normal(size=(n_micro, mb, seq, cfg.n_embd))
                      .astype(np.float32) * 0.5, device=device)

    def loss_fn(out, tgt):
        return ((out - tgt) ** 2).mean()

    stage_fn, stacked = module_stages(blocks[:pp])
    l1, g1 = pipeline_train_1f1b(stage_fn, loss_fn, stacked, xm, ym, mesh)
    stage_fn, stacked = module_stages_interleaved(blocks, pp, vchunks)
    l2, g2 = pipeline_train_1f1b_interleaved(stage_fn, loss_fn, stacked, xm,
                                             ym, mesh, n_chunks=vchunks)
    for g in list(g1.values()) + list(g2.values()):
        assert torch.isfinite(g.to_local()).all()
    return {"1f1b": _finite("1f1b", [float(l1)]),
            "interleaved": _finite("interleaved", [float(l2)])}


def _device(dev):
    return torch.device("cuda", torch.cuda.current_device()) \
        if dev == "cuda" else torch.device("cpu")


def _gpt_steps(model, mesh, ids_np, opt, axis, steps=3):
    """Next-token steps of a ``torch.nn`` GPT on a batch sharded over mesh
    axis ``axis``."""
    from .. import loss as L
    from .distributed import P, distribute_batch

    rows = ids_np.shape[0] // axis_size(mesh, axis)
    r = axis_rank(mesh, axis)
    ids = distribute_batch(mesh, ids_np[r * rows:(r + 1) * rows], P(axis))
    tgt = torch.as_tensor(np.roll(ids_np, -1, 1).reshape(-1),
                          device=ids.device)
    losses = []
    for _ in range(steps):
        logits = model(ids)
        loss = L.cross_entropy(logits.reshape(-1, logits.shape[-1]), tgt)
        if getattr(model, "aux_loss", None) is not None:
            aux = model.aux_loss
            loss = loss + (aux.full_tensor() if hasattr(aux, "full_tensor")
                           else aux) * 0.01
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def _moe_leg(n, dev):
    from .. import optim
    from ..models.gpt import GPT, GPTConfig
    from . import GPT_MOE_RULES, make_mesh, shard_module

    ep = 4 if n % 4 == 0 else 2
    mesh = make_mesh(dp=n // ep, ep=ep, devices=dev)
    cfg = GPTConfig(vocab_size=64, n_positions=16, n_embd=16, n_layer=2,
                    n_head=2, n_experts=ep, moe_k=2, moe_hidden=32)
    model = GPT(cfg, device=_device(dev),
                generator=torch.Generator().manual_seed(0))
    shard_module(model, mesh, GPT_MOE_RULES)
    opt = optim.Adam(list(model.parameters()), lr=1e-2)
    ids = np.random.default_rng(2).integers(0, 64, (2 * (n // ep), 8))
    return {"moe": _finite("moe", _gpt_steps(model, mesh, ids, opt, "dp"))}


def _t5_leg(n, dev):
    from .. import loss as L, optim
    from ..autograd import Tensor
    from ..models.t5 import T5Config, T5ForConditionalGeneration
    from . import T5_TP_RULES, make_mesh, shard_module

    mesh = make_mesh(dp=2, tp=n // 2, devices=dev)
    cfg = T5Config(vocab_size=32, d_model=16, d_kv=4, d_ff=32, num_layers=1,
                   num_decoder_layers=1, num_heads=4,
                   relative_attention_num_buckets=8,
                   relative_attention_max_distance=10, dropout_rate=0.0)
    np.random.seed(5)
    t5 = T5ForConditionalGeneration(cfg)
    shard_module(t5, mesh, T5_TP_RULES)
    opt = optim.Adam(list(t5.parameters()), lr=5e-3)
    src = np.random.default_rng(5).integers(2, 32, (4, 6)).astype(np.int32)
    x = Tensor.from_numpy(src, requires_grad=False)
    d = Tensor.from_numpy(t5.shift_right(src), requires_grad=False)
    y = Tensor.from_numpy(src.reshape(-1), requires_grad=False)
    losses = []
    for _ in range(3):
        loss = L.cross_entropy(t5(x, d).reshape(-1, 32), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.numpy()))
    return {"t5": _finite("t5", losses)}


def _fsdp_leg(n, dev, tp):
    from .. import optim
    from ..models.gpt import GPT, GPTConfig
    from . import GPT_TP_RULES, fsdp_module, make_mesh

    f = n // tp
    mesh = (make_mesh(dp=1, tp=1, fsdp=n, devices=dev) if tp == 1 else
            make_mesh(dp=1, tp=tp, fsdp=f, devices=dev))
    cfg = GPTConfig(vocab_size=64, n_positions=16, n_embd=8 * n, n_layer=2,
                    n_head=2)
    model = GPT(cfg, device=_device(dev),
                generator=torch.Generator().manual_seed(0))
    fsdp_module(model, mesh, rules=GPT_TP_RULES if tp > 1 else None,
                min_size=64)
    w = dict(model.named_parameters())["h.0.c_fc.weight"]
    want = ((4 * cfg.n_embd // n, cfg.n_embd) if tp == 1 else
            (4 * cfg.n_embd // tp, cfg.n_embd // f))
    assert tuple(w.to_local().shape) == want, (tuple(w.to_local().shape),
                                               want)
    opt = optim.Adam(list(model.parameters()), lr=1e-3)
    ids = np.random.default_rng(7).integers(0, 64, (n, 8))
    # fsdp is data parallelism with the state scattered: the batch over fsdp
    return _finite(f"fsdp x tp{tp}", _gpt_steps(model, mesh, ids, opt,
                                                "fsdp"))


def _rank(rank, n, dev, legs):
    out = {}
    if "bert" in legs:
        out.update(_bert_leg(n, dev))
    if "pipeline" in legs and n >= 2:
        out.update(_pipeline_leg(n, dev))
    if "moe" in legs and n >= 4:
        out.update(_moe_leg(n, dev))
    if "t5" in legs and n >= 4:
        out.update(_t5_leg(n, dev))
    if "fsdp" in legs and n >= 2:
        out["fsdp"] = _fsdp_leg(n, dev, 1)
    if "fsdp_tp" in legs and n >= 4:
        out["fsdp_tp"] = _fsdp_leg(n, dev, 2)
    return out


LEGS = ("bert", "pipeline", "moe", "t5", "fsdp", "fsdp_tp")


def dryrun_multichip(n_devices: int, device: str = "cuda", legs=LEGS,
                     timeout: float = 900.0) -> dict:
    """One sharded training step per parallel form (``legs``) on
    ``n_devices`` ranks of ``device``; returns rank 0's losses by leg and
    prints them.  Raises if a rank fails or a loss is not finite."""
    res = distributed.spawn(_rank, n_devices, device, tuple(legs),
                            device=device, timeout=timeout)
    for name, v in res[0].items():
        print(f"dryrun {name}: {v}")
    return res[0]


def main(argv):
    """``python -m lightgrad_tpu_torch.parallel.dryrun [N] [cuda|cpu]``
    spawns N ranks; under ``torchrun`` (``RANK`` set) each process is
    one rank of the launcher's group."""
    device = argv[2] if len(argv) > 2 else "cuda"
    if "RANK" in os.environ:
        if device == "cpu":
            from ..autograd.cuda import device as tape_device

            tape_device.set_default_device("cpu")
        distributed.initialize(device=device)
        out = _rank(distributed.process_index(), distributed.process_count(),
                    device, LEGS)
        if distributed.process_index() == 0:
            for name, v in out.items():
                print(f"dryrun {name}: {v}")
        return out
    return dryrun_multichip(int(argv[1]) if len(argv) > 1 else 4, device)


if __name__ == "__main__":
    main(sys.argv)
