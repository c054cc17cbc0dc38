"""Distributed training tour: dp x tp sharding, ring attention, pipelines.

Counterpart of ``examples/distributed.py`` on the port's parallel layer
(``torch.distributed``, one process a device).  On ``cuda``, the default,
it runs under ``torchrun --nproc_per_node 8``, one GPU a rank over NCCL,
and raises when it was not started so or the host has fewer GPUs than
ranks.  ``--device cpu`` starts 8 gloo ranks as CPU processes on this host
(``parallel.distributed.spawn``), as the JAX script provisions 8 virtual
CPU devices, so it runs anywhere:

  1. data+tensor parallel training step (dp 2 x tp 4: ``shard_module``,
     DTensor's collectives)
  2. sequence-parallel exact attention: K/V shards hop the ring (sp 4)
  3. pipeline-parallel training under the 1F1B schedule (pp 4, 8
     microbatches), against ``torch.autograd`` of the unpipelined loop
  4. expert-parallel GPT-MoE (dp 2 x ep 4: one expert an ep slice)

    torchrun --nproc_per_node 8 -m lightgrad_tpu_torch.examples.distributed
    python -m lightgrad_tpu_torch.examples.distributed --device cpu
"""

import os

import numpy as np
import torch

import lightgrad_tpu_torch as light
from lightgrad_tpu_torch.examples import device_parser
from lightgrad_tpu_torch.parallel import distributed
from lightgrad_tpu_torch.parallel.distributed import P

WORLD = 8


def _say(*args):
    if distributed.process_index() == 0:
        print(*args, flush=True)


def _sharded(x, mesh, spec):
    """numpy ``x`` as a DTensor of ``mesh`` placed as ``spec``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.as_tensor(x).to(mesh.device_type), mesh,
                             distributed.placements(mesh, spec),
                             src_data_rank=None)


def _whole(t):
    t = t.data if isinstance(t, light.AbstractTensor) else t
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().cpu().numpy()


class Block(light.nn.Module):
    """A BERT-ish MLP block: up-projection, GELU, down-projection."""

    def __init__(self, d=64, ffn=256):
        super().__init__()
        self.up = light.nn.Linear(d, ffn)
        self.down = light.nn.Linear(ffn, d)

    def forward(self, x):
        return self.down(self.up(x).gelu())


def dp_tp_training_step(device="cuda", steps=5, weights=None, data=None):
    """The block trained dp=2 x tp=4: parameters column / row split over
    tp, the batch split over dp; DTensor inserts the all-reduces from the
    placements.  ``weights`` / ``data`` (x, y) replace the seeded ones."""
    from lightgrad_tpu_torch.parallel import make_mesh, shard_module

    mesh = make_mesh(dp=2, tp=4, devices=torch.device(device).type)
    light.random.seed(0)
    model = Block()
    if weights is not None:
        light.load_numpy_params(model, weights)
    # Megatron MLP recipe: column-split the up projection, row-split the
    # down projection -- one all-reduce at the row-split output
    shard_module(model, mesh, rules=[
        (r"up\.weight$", P("tp", None)),
        (r"up\.bias$", P("tp")),
        (r"down\.weight$", P(None, "tp")),
    ])
    optim = light.optim.Adam(model.parameters(), lr=1e-3)
    if data is None:
        rng = np.random.default_rng(0)
        data = tuple(rng.normal(size=(16, 64)).astype(np.float32)
                     for _ in range(2))
    xb, yb = (light.Tensor(_sharded(a, mesh, P("dp", None)),
                           requires_grad=False) for a in data)
    losses = []
    for _ in range(steps):
        loss = light.loss.mse(model(xb), yb)
        optim.zero_grad()
        loss.backward()
        optim.step()
        losses.append(float(_whole(loss)))
    assert losses[-1] < losses[0], losses
    _say(f"[dp2 x tp4] loss {losses[0]:.4f} -> {losses[-1]:.4f}  "
         f"(params sharded: up={tuple(model.up.weight.data.placements)} "
         f"down={tuple(model.down.weight.data.placements)})")
    return {"losses": losses,
            "params": {n: _whole(p) for n, p in model.named_parameters()}}


def ring_attention_demo(device="cuda", s=1024, qkv=None):
    """Exact causal attention with the sequence sharded 4 ways: K/V hop
    the ring; no rank ever holds the whole sequence.  None on a rank
    outside the sp mesh."""
    from lightgrad_tpu_torch.parallel import make_mesh, ring_attention_sharded

    mesh = make_mesh(dp=1, tp=1, sp=4, devices=torch.device(device).type)
    if mesh.get_coordinate() is None:
        return None
    b, d = 2, 32
    if qkv is None:
        rng = np.random.default_rng(1)
        qkv = [rng.normal(0, 0.5, (b, s, d)).astype(np.float32)
               for _ in range(3)]
    q, k, v = qkv
    out = _whole(ring_attention_sharded(
        *(_sharded(x, mesh, P(None, "sp", None)) for x in qkv),
        1 / np.sqrt(d), mesh, axis="sp", causal=True))
    # oracle: dense softmax attention
    scores = np.einsum("bqd,bkd->bqk", q, k) / np.sqrt(d)
    scores = np.where(np.tril(np.ones((s, s), bool)), scores, -1e30)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bqk,bkd->bqd", p, v)
    np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-4)
    _say(f"[ring sp4] causal attention s={s} matches dense oracle; "
         f"per-device residency s_local={s // 4}")
    return {"out": out}


def _stage(wi, h):
    return torch.tanh(h @ wi)


def _mse(y, t):
    return torch.mean((y - t) ** 2)


def pipeline_1f1b_demo(device="cuda", case=None):
    """8 microbatches through a 4-stage pipeline under 1F1B: the schedule's
    tick count, the activation stash bounded at P, gradients equal to
    ``torch.autograd`` of the unpipelined loop.  None on a rank outside
    the pp mesh."""
    from lightgrad_tpu_torch.parallel import make_mesh, pipeline_train_1f1b
    from lightgrad_tpu_torch.parallel.pipeline_1f1b import (onef_oneb_ticks,
                                                            peak_in_flight)

    pp, mb, dim, M = 4, 4, 16, 8
    mesh = make_mesh(dp=1, tp=1, pp=pp, devices=torch.device(device).type)
    if mesh.get_coordinate() is None:
        return None
    if case is None:
        rng = np.random.default_rng(2)
        case = (rng.normal(0, 0.3, (pp, dim, dim)).astype(np.float32),
                rng.normal(size=(M, mb, dim)).astype(np.float32),
                rng.normal(size=(M, mb, dim)).astype(np.float32))
    w, xs, ys = (torch.as_tensor(a).to(mesh.device_type) for a in case)
    loss, grads = pipeline_train_1f1b(_stage, _mse, _sharded(
        case[0], mesh, P("pp")), xs, ys, mesh)
    loss, grads = _whole(loss), _whole(grads)

    wr = w.clone().requires_grad_(True)
    want = 0.0
    for m in range(M):
        h = xs[m]
        for s in range(pp):
            h = _stage(wr[s], h)
        want = want + _mse(h, ys[m])
    want = want / M
    want.backward()
    np.testing.assert_allclose(grads, _whole(wr.grad), rtol=1e-5, atol=1e-6)
    _say(f"[1F1B pp4] {M} microbatches in {onef_oneb_ticks(M, pp)} ticks "
         f"(GPipe-with-autodiff stores {M} activations/device; 1F1B peak: "
         f"{peak_in_flight(M, pp)}); loss {float(loss):.4f} == "
         f"{float(want.detach()):.4f}, grads exact")
    return {"loss": float(loss), "grads": grads}


MOE_CFG = dict(vocab_size=64, n_positions=16, n_embd=32, n_layer=2,
               n_head=2, n_experts=4, moe_k=2, moe_hidden=64)


def moe_expert_parallel_demo(device="cuda", steps=10, weights=None):
    """GPT-MoE trained dp=2 x ep=4: the stacked expert weights shard one
    expert an ep slice; the router's load-balancing aux loss joins the LM
    loss.  ``weights`` replace the seeded ones."""
    from lightgrad_tpu_torch.models import GPT, GPTConfig
    from lightgrad_tpu_torch.parallel import (GPT_MOE_RULES, make_mesh,
                                              shard_module)

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    model = GPT(GPTConfig(**MOE_CFG), device=dev,
                generator=torch.Generator(device=dev).manual_seed(4))
    if weights is not None:
        light.load_numpy_params(model, weights)
    mesh = make_mesh(dp=2, ep=4, devices=dev.type)
    shard_module(model, mesh, GPT_MOE_RULES)

    rng = np.random.default_rng(4)
    ids = rng.integers(0, 64, (4, 12))
    x = torch.as_tensor(ids, device=dev)
    y = torch.as_tensor(np.roll(ids, -1, 1).reshape(-1), device=dev)
    opt = light.optim.Adam(list(model.parameters()), lr=5e-3)

    def step():
        loss = light.loss.cross_entropy(model(x).reshape(-1, 64), y)
        aux = model.aux_loss
        loss = loss + (aux.full_tensor() if hasattr(aux, "full_tensor")
                       else aux) * 0.01
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss

    fn = light.jit(step)
    losses = [float(fn()) for _ in range(steps)]
    w1 = dict(model.named_parameters())["h.0.moe.w1"]
    _say(f"[moe dp2 x ep4] expert stack {tuple(w1.shape)} -> "
         f"{tuple(w1.to_local().shape)} per device; loss {losses[0]:.3f} -> "
         f"{losses[-1]:.3f}")
    return {"losses": losses,
            "params": {n: _whole(p) for n, p in model.named_parameters()}}


def demos(rank, n, cases=None, device="cpu"):
    """The four demos on one rank of an ``n``-rank group; ``cases`` holds
    each demo's keyword arguments (inputs, weights, step counts), by
    name.  Returns each demo's results."""
    if n < WORLD:
        raise RuntimeError(f"the tour needs {WORLD} ranks, has {n}")
    cases = cases or {}
    out = {}
    for name, fn in (("dp_tp", dp_tp_training_step),
                     ("ring", ring_attention_demo),
                     ("1f1b", pipeline_1f1b_demo),
                     ("moe", moe_expert_parallel_demo)):
        out[name] = fn(device, **cases.get(name, {}))
    _say("all distributed demos green")
    return out


def main(argv=None):
    args = device_parser(__doc__.splitlines()[0]).parse_args(argv)
    device = torch.device(args.device).type
    if device == "cpu":
        print(f"spawning {WORLD} gloo ranks as CPU processes (--device cpu; "
              f"torchrun --nproc_per_node {WORLD} runs one GPU a rank)",
              flush=True)
        # by its import path, which the spawned ranks import (not __main__)
        from lightgrad_tpu_torch.examples import distributed as tour

        return distributed.spawn(tour.demos, WORLD, None, device="cpu")[0]
    if "RANK" not in os.environ:
        raise RuntimeError(
            f"distributed.py on {device} runs one GPU a rank: start it with "
            f"torchrun --nproc_per_node {WORLD} (or pass --device cpu for "
            f"{WORLD} gloo ranks on CPU processes)")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", WORLD))
    gpus = torch.cuda.device_count() if device == "cuda" else 0
    if gpus < local:
        raise RuntimeError(f"distributed.py: {local} ranks on this host, "
                           f"{gpus} GPUs; it needs one GPU a rank")
    distributed.initialize(device=device)
    return demos(distributed.process_index(), distributed.process_count(),
                 device=device)


if __name__ == "__main__":
    main()
