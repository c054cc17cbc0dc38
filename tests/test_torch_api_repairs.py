"""The port's public API against the JAX package's where the two differed:
tape ops over numpy operands (arrays, 0-d arrays, a float16 tensor with a
Python scalar), ``setitem`` over numpy values, index arrays and negative
steps, ``getitem`` with a negative step beside an index array,
out-of-range indices (gathers clamp, scatters drop), ``set_device_init``,
``utils.load_torch_state_dict`` / ``save_torch_state_dict`` and the order of
``GPT.generate``'s parameters.  Each case runs the same numpy inputs
through both packages on the CPU."""

import inspect

import numpy as np
import pytest

import lightgrad_tpu as light
import lightgrad_tpu_torch as lt
from lightgrad_tpu.autograd import TpuTensor
from lightgrad_tpu.models import GPT as JaxGPT
from lightgrad_tpu_torch import GPT
from lightgrad_tpu_torch.autograd.cuda import tensor as cuda_tensor
from tests.torch_port import cpu_device, one_thread  # noqa: F401

A = np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32)


def _set(idx, val):
    def f(t, np_):
        t = t.copy(requires_grad=False)
        t[idx(np_)] = val(np_)
        return t
    return f


def _iadd(t, np_):
    t = t.copy(requires_grad=False)
    t += np_.ones((4, 6), np_.float32)
    return t


CASES = {
    # numpy operands of tape ops
    "add array": lambda t, np_: t + np_.ones(6, np_.float32),
    "gt array": lambda t, np_: t.gt(np_.zeros(6, np_.float32)),
    "iadd array": _iadd,
    "0-d array": lambda t, np_: t * np_.array(2.0),
    "int tensor, float array": lambda t, np_: t.astype("int32")
    + np_.full(6, 0.5, np_.float32),
    "float16 scalar": lambda t, np_: t.astype("float16") * 2.0,
    # setitem
    "set numpy scalar": _set(lambda np_: (slice(None), 2),
                             lambda np_: np_.float32(-1)),
    "set index array": _set(lambda np_: np_.array([0, 2]),
                            lambda np_: np_.ones((2, 6), np_.float32)),
    "set negative step": _set(lambda np_: (np_.array([1, 3]),
                                           slice(None, None, -2)),
                              lambda np_: 7.0),
    "set out of range": _set(lambda np_: np_.array([0, 7, -1, -9]),
                             lambda np_: 5.0),
    "set out of range int": _set(lambda np_: 9, lambda np_: 5.0),
    "set out of range numpy int": _set(lambda np_: (1, np_.int64(6)),
                                       lambda np_: 5.0),
    "set out of range rows": _set(lambda np_: np_.array([5, 1]),
                                  lambda np_: np_.arange(
                                      12, dtype=np_.float32).reshape(2, 6)),
    # getitem
    "get negative step": lambda t, np_: t[np_.array([0, 2]), ::-1],
    "get negative step cols": lambda t, np_: t[::-2, np_.array([5, 0, 1])],
    "get clamped int": lambda t, np_: t[9],
    "get clamped numpy int": lambda t, np_: t[np_.int64(-7), 1],
    "get clamped negative": lambda t, np_: t[-9],
    "get clamped array": lambda t, np_: t[np_.array([0, 7, -6])],
    "get clamped column": lambda t, np_: t[:, np_.array([2, 40])],
}


@pytest.mark.parametrize("case", list(CASES))
def test_op_matches_jax(case):
    f = CASES[case]
    want = f(TpuTensor.from_numpy(A, requires_grad=False), np)
    got = f(lt.Tensor.from_numpy(A, requires_grad=False), np)
    w, g = np.asarray(want.numpy()), got.numpy()
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def test_array_operand_gradient_matches_jax():
    """A tensor broadcast against a numpy array: the tensor's gradient."""
    def run(T):
        x = T.from_numpy(A[0])
        (x * np.arange(24, dtype=np.float32).reshape(4, 6)).sum().backward()
        return np.asarray(x.grad.numpy())
    np.testing.assert_allclose(run(lt.Tensor), run(TpuTensor), rtol=1e-6)


@pytest.fixture
def host_init():
    yield
    cuda_tensor._init_seed = cuda_tensor._TAPE_STREAM
    cuda_tensor._init_generators.clear()


def test_set_device_init_none_draws_host_numpy(host_init):
    """``set_device_init(None)``: the initializers draw from host numpy, so
    ``np.random.seed`` gives the JAX package's own initial weights."""
    light.set_device_init(None)
    lt.set_device_init(None)
    np.random.seed(5)
    want = np.asarray(TpuTensor.xavier((6, 4)).numpy())
    np.random.seed(5)
    np.testing.assert_array_equal(lt.Tensor.xavier((6, 4)).numpy(), want)
    np.random.seed(5)
    a = lt.Tensor.uniform(-1, 1, (3, 5)).numpy()
    np.random.seed(5)
    np.testing.assert_array_equal(
        a, np.random.uniform(-1, 1, size=(3, 5)).astype(np.float32))


def test_set_device_init_seed_repeats_on_the_device(host_init):
    """A seed puts the initializers on a stream of their own: the seed
    repeats its weights, another seed differs, and numpy's state is left
    alone."""
    lt.set_device_init(3)
    a = lt.Tensor.uniform(-1, 1, (8,)).numpy()
    state = np.random.get_state()[1].copy()
    lt.set_device_init(3)
    assert np.array_equal(lt.Tensor.uniform(-1, 1, (8,)).numpy(), a)
    assert np.array_equal(np.random.get_state()[1], state)
    lt.set_device_init(4)
    assert not np.array_equal(lt.Tensor.uniform(-1, 1, (8,)).numpy(), a)
    assert np.all((a >= -1) & (a < 1))


STATE = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
         "b": np.array([1, -2, 3], np.int64),
         "h": np.ones((2, 2), np.float16)}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_torch_state_dict_round_trip(tmp_path, writer):
    """A checkpoint written by either package reads back in both, with the
    JAX signatures (bytes in; a state dict, a path and an archive name)."""
    from lightgrad_tpu.utils import load_torch_state_dict as jload
    from lightgrad_tpu.utils import save_torch_state_dict as jsave
    from lightgrad_tpu_torch.utils import load_torch_state_dict as tload
    from lightgrad_tpu_torch.utils import save_torch_state_dict as tsave

    path = str(tmp_path / "model.bin")
    (tsave if writer == "port" else jsave)(STATE, path, archive_name="ckpt")
    data = open(path, "rb").read()
    assert list(inspect.signature(tsave).parameters) == \
        list(inspect.signature(jsave).parameters)
    for load in (tload, jload):
        got = load(data)
        assert set(got) == set(STATE)
        for k, v in STATE.items():
            assert np.asarray(got[k]).dtype == v.dtype
            np.testing.assert_array_equal(np.asarray(got[k]), v)


def test_generate_parameters_in_the_jax_order():
    """``GPT.generate`` takes its parameters in the JAX package's order, so
    a positional caller means the same thing in both."""
    assert list(inspect.signature(GPT.generate).parameters) == \
        list(inspect.signature(JaxGPT.generate).parameters)
