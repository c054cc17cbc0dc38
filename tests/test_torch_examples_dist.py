"""Port parity: the distributed tour (``lightgrad_tpu_torch/examples/
distributed.py``) and the serving tour's tensor-parallel step against the
JAX package.

ONE spawned group of 8 gloo ranks (tests/torch_dist_workers.py, under a
time limit) runs the tour's four demos through their own functions, with
the test's inputs, weights and step counts, and the serving tour's tp = 2
decode; the JAX side runs here, on the conftest's virtual CPU devices where
it shards and unsharded where sharding changes no value.  Cases:

* dp 2 x tp 4: the MLP block's 3 Adam steps (MSE) -- losses within 1e-4
  relative, the parameters after at the Adam step's noise bound;
* ring attention at sp 4, causal, s 256: against the JAX package's
  ``ring_attention_sharded`` on a 4-device mesh (the ring's tolerance of
  tests/test_torch_ring_attention.py) and the demo's dense oracle;
* 1F1B at pp 4, 8 microbatches: loss and gradients against
  ``jax.value_and_grad`` of the unpipelined loop (the demo's tolerance);
* GPT-MoE at dp 2 x ep 4: 3 Adam steps of CE + 0.01 aux_loss, losses
  within 1e-4 relative of the JAX tape GPT's;
* serving's tp 2 cached decode: the JAX GPT's greedy tokens."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

import lightgrad_tpu as light
from lightgrad_tpu import parallel as jpar
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu.models import GPT as JGPT
from lightgrad_tpu.models import GPTConfig as JGPTConfig
from lightgrad_tpu_torch.examples import distributed, serving
from lightgrad_tpu_torch.parallel.distributed import spawn
from tests import torch_dist_workers as workers
from tests.torch_port import jax_greedy, jax_kernel_mode, one_thread  # noqa: F401

F32 = 1e-4                              # f32 losses per step, relative
RING_TOL = dict(rtol=1e-5, atol=5e-5)   # tests/test_torch_ring_attention.py
STEPS, S = 3, 256


def _j(a):
    return JTensor.from_numpy(np.asarray(a), requires_grad=False)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert err.max() <= rel, f"{got} vs {want} (rel {err.max():.2e})"


class _JaxBlock(light.nn.Module):
    """The tour's MLP block on the JAX tape (the JAX script defines its
    own inside its demo)."""

    def __init__(self, d=64, ffn=256):
        super().__init__()
        self.up = light.nn.Linear(d, ffn)
        self.down = light.nn.Linear(ffn, d)

    def forward(self, x):
        return self.down(self.up(x).gelu())


def _dp_tp():
    np.random.seed(0)
    jm = _JaxBlock()
    weights = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    rng = np.random.default_rng(0)
    x, y = (rng.normal(size=(16, 64)).astype(np.float32) for _ in range(2))
    opt = light.optim.Adam(jm.parameters(), lr=1e-3)
    losses = []
    with jax_kernel_mode("xla"):
        for _ in range(STEPS):
            loss = light.loss.mse(jm(_j(x)), _j(y))
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss.numpy()))
    return (dict(steps=STEPS, weights=weights, data=(x, y)),
            {"losses": losses,
             "params": {n: p.numpy() for n, p in jm.named_parameters()}})


def _ring():
    rng = np.random.default_rng(1)
    qkv = [rng.normal(0, 0.5, (2, S, 32)).astype(np.float32)
           for _ in range(3)]
    mesh = jpar.make_mesh(dp=1, tp=1, sp=4)
    sh = NamedSharding(mesh, JP(None, "sp", None))
    with jax_kernel_mode("xla"):
        out = jpar.ring_attention_sharded(
            *(jax.device_put(jnp.asarray(a), sh) for a in qkv),
            1 / np.sqrt(32), mesh, axis="sp", causal=True)
    return dict(s=S, qkv=qkv), {"out": np.asarray(out)}


def _1f1b():
    pp, mb, dim, M = 4, 4, 16, 8
    rng = np.random.default_rng(2)
    case = (rng.normal(0, 0.3, (pp, dim, dim)).astype(np.float32),
            rng.normal(size=(M, mb, dim)).astype(np.float32),
            rng.normal(size=(M, mb, dim)).astype(np.float32))
    w, xs, ys = (jnp.asarray(a) for a in case)

    def ref(w):
        tot = 0.0
        for m in range(M):
            h = xs[m]
            for s in range(pp):
                h = jnp.tanh(h @ w[s])
            tot = tot + jnp.mean((h - ys[m]) ** 2)
        return tot / M

    loss, grads = jax.value_and_grad(ref)(w)
    return dict(case=case), {"loss": float(loss), "grads": np.asarray(grads)}


def _moe():
    np.random.seed(4)
    jm = JGPT(JGPTConfig(**distributed.MOE_CFG))
    weights = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 64, (4, 12))
    x, y = _j(ids.astype(np.int32)), _j(np.roll(ids, -1, 1).reshape(-1)
                                        .astype(np.int32))
    opt = light.optim.Adam(jm.parameters(), lr=5e-3)
    losses = []
    with jax_kernel_mode("xla"):
        for _ in range(STEPS):
            loss = light.loss.cross_entropy(jm(x).reshape(-1, 64), y) \
                + jm.aux_loss * 0.01
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss.numpy()))
    return dict(steps=STEPS, weights=weights), {"losses": losses}


def _serving_tp():
    np.random.seed(0)
    jm = JGPT(JGPTConfig(**serving.CFG))
    prompt, _ = serving.prompts()
    with jax_kernel_mode("xla"):
        want = jax_greedy(jm, prompt, 16, serving.CFG["n_positions"])
    return (prompt, {n: np.asarray(p.data) for n, p in
                     jm.named_parameters()}), want


@pytest.fixture(scope="module")
def tour(tmp_path_factory):
    """(every rank's results, the JAX side's) for every case."""
    demos, want = {}, {}
    for name, make in (("dp_tp", _dp_tp), ("ring", _ring), ("1f1b", _1f1b),
                       ("moe", _moe)):
        demos[name], want[name] = make()
    tp_case, want["serving_tp"] = _serving_tp()
    path = tmp_path_factory.mktemp("examples_dist") / "cases.pkl"
    path.write_bytes(pickle.dumps({"demos": demos, "serving_tp": tp_case}))
    got = spawn(workers.examples_group, distributed.WORLD, str(path),
                device="cpu", timeout=300, group_timeout=150)
    return got, want


def test_dp_tp_training_step(tour):
    got, want = tour
    g, w = got[0]["dp_tp"], want["dp_tp"]
    _close(g["losses"], w["losses"], F32)
    # Adam's first steps move each element by about lr: held at a tenth
    for name, p in w["params"].items():
        np.testing.assert_allclose(g["params"][name], p, rtol=0,
                                   atol=0.1 * 1e-3, err_msg=name)


def test_ring_attention(tour):
    got, want = tour
    for rank in range(distributed.WORLD):
        out = got[rank]["ring"]
        if rank < 4:      # the sp mesh's ranks each give the whole output
            np.testing.assert_allclose(out["out"], want["ring"]["out"],
                                       **RING_TOL)
        else:
            assert out is None


def test_pipeline_1f1b(tour):
    got, want = tour
    g, w = got[0]["1f1b"], want["1f1b"]
    np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g["grads"], w["grads"], rtol=1e-5, atol=1e-6)
    assert all(got[r]["1f1b"] is None for r in range(4, distributed.WORLD))


def test_moe_expert_parallel(tour):
    got, want = tour
    _close(got[0]["moe"]["losses"], want["moe"]["losses"], F32)
    # every rank trained the same model
    for rank in range(1, distributed.WORLD):
        assert got[rank]["moe"]["losses"] == got[0]["moe"]["losses"]


def test_serving_tensor_parallel_decode(tour):
    got, want = tour
    assert got[0]["serving_tp"] == got[1]["serving_tp"] == want["serving_tp"]
    assert all(got[r]["serving_tp"] is None
               for r in range(2, distributed.WORLD))


@pytest.mark.parametrize("env, says", [
    ({}, "torchrun --nproc_per_node 8"),
    ({"RANK": "0", "WORLD_SIZE": "8", "LOCAL_WORLD_SIZE": "8"},
     "8 ranks on this host, 0 GPUs")])
def test_main_on_cuda_takes_no_cpu_fallback(env, says, monkeypatch):
    """The tour's default device is cuda: without torchrun's group, or with
    fewer GPUs than ranks (none here), it raises rather than spawning CPU
    ranks (those take --device cpu)."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(RuntimeError, match=says):
        distributed.main([])
