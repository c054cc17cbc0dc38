"""Port parity: the three pipeline schedules of the port's parallel layer
(lightgrad_tpu_torch/parallel/pipeline*.py) at pp = 4 against the JAX
package's on a 4-device mesh.

One spawned group of 4 gloo ranks (tests/torch_dist_workers.py, under a
time limit) runs every case; the JAX side runs here.  Cases: GPipe
``pipeline_apply`` (outputs, and the gradients of a loss of them through
the schedule, one stacked leaf sharded over pp and one whole), the
interleaved ``pipeline_apply_interleaved`` (V = 2), ``pipeline_train_1f1b``
and ``pipeline_train_1f1b_interleaved`` (loss and stacked gradients at two
microbatch counts each), and the ``module_stages`` bridges over lightgrad
tape blocks (loss and each block's gradients against the JAX tape running
the same blocks in order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

import lightgrad_tpu as light
import lightgrad_tpu.nn as jnn
from lightgrad_tpu import parallel as jpar
from lightgrad_tpu.autograd import Tensor as JTensor
from lightgrad_tpu_torch.parallel.distributed import spawn
from tests import torch_dist_workers as workers
from tests.torch_port import jax_kernel_mode

PP, DIM = 4, 8
# f32 stage products in another order (the JAX tests' own bars)
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
M_1F1B = (3, 8)
M_1F1B_V = (4, 6)


def _stage(w, h):
    return jnp.tanh(h @ w)


def _mse(y, t):
    return jnp.mean((y - t) ** 2)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(0, scale, shape)).astype(np.float32)


def _sharded(mesh, a):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, JP("pp")))


def _gpipe(mesh):
    rng = np.random.default_rng(0)
    w, b = _normal(rng, PP, 16, 16, scale=0.5), _normal(rng, PP, 16, scale=0.1)
    x = _normal(rng, 6, 8, 16)

    def stage(p, h):
        return jnp.tanh(h @ p[0] + p[1])

    def loss(params):
        y = jpar.pipeline_apply(stage, params, x, mesh, axis="pp")
        return jnp.sum(y * y), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        (_sharded(mesh, w), _sharded(mesh, b)))
    return (w, b, x), {"y": y, "gw": g[0], "gb": g[1]}


def _interleaved(mesh):
    rng = np.random.default_rng(1)
    w, x = _normal(rng, PP * 2, DIM, DIM, scale=0.4), _normal(rng, 4, 2, DIM)

    def loss(w):
        y = jpar.pipeline_apply_interleaved(_stage, w, x, mesh, axis="pp",
                                            n_virtual=2)
        return jnp.mean(y * y), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(w))
    return (w, x), {"y": y, "g": g}


def _train(mesh, m, v):
    rng = np.random.default_rng(10 + m)
    shape = (PP, DIM, DIM) if v == 1 else (PP, v, DIM, DIM)
    w = _normal(rng, *shape, scale=0.4)
    xs, ys = _normal(rng, m, 2, DIM), _normal(rng, m, 2, DIM)
    if v == 1:
        step = jax.jit(lambda w, xs, ys: jpar.pipeline_train_1f1b(
            _stage, _mse, w, xs, ys, mesh))
    else:
        step = jax.jit(lambda w, xs, ys: jpar.pipeline_train_1f1b_interleaved(
            _stage, _mse, w, xs, ys, mesh, n_chunks=v))
    loss, g = step(_sharded(mesh, w), xs, ys)
    return (w, xs, ys), {"loss": loss, "g": g}


class _Block(jnn.Module):
    def __init__(self):
        super().__init__()
        self.lin = jnn.Linear(DIM, DIM)

    def forward(self, x):
        return self.lin(x).tanh()


def _bridge(n_blocks, seed, m):
    """The JAX tape running ``n_blocks`` blocks in order over ``m``
    microbatches: (the blocks' weights, xs, ys), (mean loss, grads)."""
    np.random.seed(seed)
    blocks = [_Block() for _ in range(n_blocks)]
    rng = np.random.default_rng(seed)
    xs, ys = _normal(rng, m, 2, DIM), _normal(rng, m, 2, DIM)
    total = 0.0
    with jax_kernel_mode("xla"):
        for mi in range(m):
            h = JTensor.from_numpy(xs[mi], requires_grad=False)
            for b in blocks:
                h = b(h)
            # the tape's mse halves the square; the stage loss does not
            lm = light.loss.mse(h, JTensor.from_numpy(
                ys[mi], requires_grad=False)) * (2.0 / m)
            lm.backward()
            total += float(lm.numpy())
    weights = [{n: np.asarray(p.data) for n, p in b.named_parameters()}
               for b in blocks]
    grads = [{n: p.grad.numpy() for n, p in b.named_parameters()}
             for b in blocks]
    return (weights, xs, ys, DIM), {"loss": total, "grads": grads}


@pytest.fixture(scope="module")
def pipe():
    mesh = jpar.make_mesh(dp=1, tp=1, pp=PP)
    cases, want = {}, {}
    with jax_kernel_mode("xla"):
        cases["gpipe"], want["gpipe"] = _gpipe(mesh)
        cases["interleaved"], want["interleaved"] = _interleaved(mesh)
        cases["1f1b"], cases["1f1b_v"] = {}, {}
        for m in M_1F1B:
            cases["1f1b"][m], want["1f1b", m] = _train(mesh, m, 1)
        for m in M_1F1B_V:
            cases["1f1b_v"][m], want["1f1b_v", m] = _train(mesh, m, 2)
    cases["bridge"], want["bridge"] = _bridge(PP, 9, 6)
    cases["bridge_v"], want["bridge_v"] = _bridge(PP * 2, 3, 4)
    got = spawn(workers.pipeline_group, 4, cases, device="cpu", timeout=240,
                group_timeout=120)
    return got[0], want


@pytest.mark.parametrize("what", ["y", "gw", "gb"])
def test_gpipe_matches_jax(pipe, what):
    got, want = pipe
    tol = TOL if what == "y" else GRAD_TOL
    np.testing.assert_allclose(got["gpipe"][what],
                               np.asarray(want["gpipe"][what]), **tol)


@pytest.mark.parametrize("what", ["y", "g"])
def test_interleaved_apply_matches_jax(pipe, what):
    got, want = pipe
    tol = TOL if what == "y" else GRAD_TOL
    np.testing.assert_allclose(got["interleaved"][what],
                               np.asarray(want["interleaved"][what]), **tol)


@pytest.mark.parametrize("sched,m", [("1f1b", m) for m in M_1F1B]
                         + [("1f1b_v", m) for m in M_1F1B_V])
def test_1f1b_matches_jax(pipe, sched, m):
    got, want = pipe
    g, w = got[sched, m], want[sched, m]
    np.testing.assert_allclose(g["loss"], float(w["loss"]), rtol=1e-6)
    np.testing.assert_allclose(g["g"], np.asarray(w["g"]), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["bridge", "bridge_v"])
def test_module_bridge_matches_jax_tape(pipe, case):
    got, want = pipe
    g, w = got[case], want[case]
    np.testing.assert_allclose(g["loss"], w["loss"], rtol=2e-5)
    assert len(g["grads"]) == len(w["grads"])
    for i, (gb, wb) in enumerate(zip(g["grads"], w["grads"])):
        for name in wb:
            np.testing.assert_allclose(gb[name], wb[name], rtol=3e-4,
                                       atol=3e-5, err_msg=f"block {i} {name}")
