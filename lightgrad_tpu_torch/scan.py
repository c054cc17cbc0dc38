"""Scan over layers on the lightgrad tape: L identical blocks as stacked
``(L, ...)`` parameters, applied by one tape op, with rematerialisation.

Counterpart of ``lightgrad_tpu/scan.py``.  ``ScannedStack`` holds L
structurally identical ``nn.Module`` blocks as stacked parameter tensors
registered under the JAX package's names (a block parameter ``a.b.weight``
becomes ``a__b__weight``), so ``load_numpy_params`` takes a scanned JAX
model's ``named_parameters()`` as they are and an optimizer updates all
layers with one tensor a name.  ``state_dict`` / ``load_parameters`` use
per-layer names (``h.0.ln_1.weight``), so checkpoints and the HF interop
see the unscanned layout.  ``blocks[0]`` stays as the template whose tape
ops define the block; each layer runs it on views of the stacks.

The JAX package traces the block once and scans it with ``lax.scan``; the
port runs eagerly, so the stack is one tape op (``_scan_blocks``) that
loops over the layers and runs its own backward, with ``remat``:

* ``False``: each layer runs with the tape recording and keeps its graph;
  the backward walks the layers' graphs in reverse;
* ``True`` / ``"full"``: the layers run without a graph and only each
  layer's input is kept; the backward replays a layer with the tape
  recording, then walks that graph (``jax.checkpoint``);
* ``"dots"``: as ``"full"``, but the products without batch dimensions
  (``dot`` with a 2-D right operand, ``einsum`` with no index common to
  every operand and the output: the Linears) keep their outputs from the
  first pass, and the replay takes them back in order instead of launching
  them again (the JAX package's ``dots_with_no_batch_dims_saveable``);
  ``"dots_all"`` keeps every product's output (``dots_saveable``).

``remat`` also takes the ``jax.checkpoint_policies`` names that have one of
these counterparts (:data:`POLICIES`).

Every mode runs the same kernels on the same inputs, so the values do not
depend on ``remat``: on the CPU the gradients of the three modes and of the
unscanned model are bitwise equal (tests/test_torch_scan.py).

A block must not draw random numbers: a live ``Dropout`` inside it is
refused, with the JAX package's message.
"""

import contextlib

import numpy as np
import torch

from . import nn
from .autograd import AbstractTensor, Function, Gradients, Tensor
from .autograd.cuda import ops as _cuda_ops

__all__ = ["ScannedStack", "layer_tensors"]


# the jax.checkpoint_policies names that have a counterpart here
POLICIES = {"everything_saveable": False,
            "nothing_saveable": "full",
            "dots_with_no_batch_dims_saveable": "dots",
            "checkpoint_dots_with_no_batch_dims": "dots",
            "dots_saveable": "dots_all",
            "checkpoint_dots": "dots_all"}


def remat_mode(remat):
    """``remat`` as one of False, "full", "dots", "dots_all": False / None,
    True / "full", "dots", or a name of :data:`POLICIES`.  "dots" keeps
    the outputs of products without batch dimensions, "dots_all" those of
    every product.  Any other value raises, naming the accepted ones."""
    if remat is False or remat is None:
        return False
    if remat is True or remat == "full":
        return "full"
    if remat == "dots":
        return "dots"
    if isinstance(remat, str) and remat in POLICIES:
        return POLICIES[remat]
    raise ValueError(f"unknown remat policy {remat!r}: the port takes False, "
                     f"True / 'full', 'dots' and the jax.checkpoint_policies "
                     f"names {sorted(POLICIES)}")


@contextlib.contextmanager
def _recording(on: bool):
    """The tape records (``on``) or not, whatever the enclosing state; the
    previous state comes back on exit."""
    depth = Gradients._disable_depth
    Gradients._disable_depth = 0 if on else max(depth, 1)
    try:
        yield
    finally:
        Gradients._disable_depth = depth


class _Products:
    """remat="dots" / "dots_all": the products of one layer's first pass
    (unless ``keep_batched``, only those without batch dimensions), kept in
    order and handed back in the same order when the layer is replayed."""

    def __init__(self, keep_batched):
        self.keep_batched = keep_batched
        self.outs = []
        self.at = None

    def __call__(self, compute, batched):
        if batched and not self.keep_batched:
            return compute()
        if self.at is None:
            out = compute()
            self.outs.append(out)
            return out
        out = self.outs[self.at]
        self.at += 1
        return out

    def replay(self):
        self.at = 0
        return self


@contextlib.contextmanager
def _products(store):
    prev, _cuda_ops.product_store = _cuda_ops.product_store, store
    try:
        yield
    finally:
        _cuda_ops.product_store = prev


def _slots(module):
    """[(owner, attribute)] of ``module``'s parameters in
    ``named_parameters`` order."""
    out = [(module, name) for name in module._params]
    for m in module._modules.values():
        out.extend(_slots(m))
    return out


class _scan_blocks(Function):
    """Tape op: y = block(...block(block(x, p[0]), p[1])..., p[L-1]).

    ``ts`` are the stacked parameters (the first ``n_stacked``), then the
    tensor extras passed to every layer; both get gradients."""

    def forward(ctx, x, *ts, n_stacked=None, stack=None, layout=None):
        stacked, extras = ts[:n_stacked], ts[n_stacked:]
        mode = remat_mode(stack.remat)
        ctx.stack, ctx.n_stacked, ctx.layout = stack, n_stacked, layout
        h, layers = x.data, []
        for l in range(stack.n_layers):
            if mode is False:
                with _recording(True):
                    run = stack._layer(l, h, stacked, extras, layout, True)
                layers.append(run)
            else:
                store = _Products(mode == "dots_all") \
                    if mode in ("dots", "dots_all") else None
                with _recording(False), _products(store):
                    run = stack._layer(l, h, stacked, extras, layout, False)
                layers.append((h, store))
            h = run[-1].data
        ctx.save_for_backward(layers, mode)
        return Tensor(h, requires_grad=False)

    def backward(ctx, g):
        layers, mode = ctx.get_saved_tensors()
        stack, n_stacked = ctx.stack, ctx.n_stacked
        stacked = ctx.parents[1:1 + n_stacked]
        extras = ctx.parents[1 + n_stacked:]
        d_stacked = [None] * n_stacked
        d_extras = [None] * len(extras)
        for l in reversed(range(stack.n_layers)):
            if mode is False:
                run = layers[l]
            else:
                h, store = layers[l]
                with _recording(True), _products(
                        store.replay() if store is not None else None):
                    run = stack._layer(l, h, stacked, extras, ctx.layout,
                                       True)
            layers[l] = None
            hin, leaves, ex_leaves, out = run
            if out.ctx is None:
                # nothing below this layer's output requires a gradient
                g = None
                break
            Gradients.backward(out.ctx, g)
            for i, leaf in enumerate(leaves):
                if leaf.grad is None:
                    continue
                if d_stacked[i] is None:
                    d_stacked[i] = torch.zeros(stacked[i].shape,
                                               dtype=leaf.grad.dtype,
                                               device=leaf.grad.device)
                d_stacked[i][l] = leaf.grad.data
            for i, leaf in enumerate(ex_leaves):
                if leaf.grad is not None:
                    d_extras[i] = (leaf.grad.data if d_extras[i] is None
                                   else d_extras[i] + leaf.grad.data)
            g = hin.grad
            if g is None:
                break
        return (g, *(None if d is None else Tensor(d, requires_grad=False)
                     for d in d_stacked + d_extras))


def _has_live_dropout(m):
    if isinstance(m, nn.Dropout) and m.p > 0 and m.training:
        return True
    return any(_has_live_dropout(c) for c in m._modules.values())


class ScannedStack(nn.Module):
    """L structurally identical blocks applied by one tape op.

    Parameters are the stacked ``(L, ...)`` tensors; ``blocks[0]`` survives
    as the template (kept out of ``_modules``, so its tensors are never
    parameters) whose parameters are rebound to layer ``l``'s views while
    layer ``l`` runs."""

    def __init__(self, blocks, remat=False):
        super().__init__()
        blocks = list(blocks)
        assert blocks, "ScannedStack needs at least one block"
        remat_mode(remat)
        proto = blocks[0]
        names = [n for n, _ in proto.named_parameters()]
        object.__setattr__(self, "_proto", proto)
        object.__setattr__(self, "_names", names)
        object.__setattr__(self, "n_layers", len(blocks))
        object.__setattr__(self, "remat", remat)
        name_map = {}
        for n in names:
            per = []
            for b in blocks:
                d = dict(b.named_parameters())
                assert n in d, f"block missing parameter {n}"
                per.append(d[n].data)
            key = n.replace(".", "__")
            setattr(self, key, Tensor(torch.stack(per), requires_grad=True))
            name_map[n] = key
        object.__setattr__(self, "_name_map", name_map)
        # the template holds layer 0's views, not a copy of its own
        self._bind([t.data[0] for t in self._stacked.values()],
                   requires_grad=False)

    @property
    def _stacked(self):
        """{original name: stacked tensor}, resolved through _params so
        rebinds (map_parameters, amp.cast_module) stay visible."""
        return {n: self._params[k] for n, k in self._name_map.items()}

    def train(self, mode: bool = True):
        self._proto.train(mode)
        return super().train(mode)

    def layer_params(self, l: int) -> dict:
        """{original name: layer ``l``'s view of the stack} (no copy)."""
        return {n: t.data[l] for n, t in self._stacked.items()}

    def _bind(self, datas, requires_grad):
        """Rebind the template's parameters to new tensors over ``datas``;
        returns them."""
        leaves = []
        for (owner, attr), d in zip(_slots(self._proto), datas):
            t = Tensor(d, requires_grad=requires_grad)
            owner._params[attr] = t
            object.__setattr__(owner, attr, t)
            leaves.append(t)
        return leaves

    def _layer(self, l, h, stacked, extras, layout, record):
        """Run layer ``l`` on the raw input ``h``: (input leaf, parameter
        leaves, extra leaves, output).  With ``record`` every leaf follows
        its source's ``requires_grad`` (the input always requires one) and
        the tape records the layer."""
        leaves = self._bind([t.data[l] for t in stacked], False)
        if record:
            for leaf, t in zip(leaves, stacked):
                leaf._set_requires_grad(t.requires_grad)
        hin = Tensor(h, requires_grad=record)
        ex = [Tensor(e.data, requires_grad=record and e.requires_grad)
              for e in extras]
        it = iter(ex)
        args = [next(it) if slot else e for slot, e in layout]
        out = self._proto(hin, *args)
        return hin, leaves, ex, out

    def forward(self, x, *extra):
        """Apply all layers.  ``extra`` tensors (e.g. an attention mask) are
        passed unchanged to every layer; ``None`` extras pass through as
        Python Nones."""
        if _has_live_dropout(self._proto):
            raise AssertionError(
                "ScannedStack: active Dropout inside a scanned block would "
                "reuse one mask for every layer (the body traces once) -- "
                "call .eval() or set p=0")
        assert isinstance(x, AbstractTensor), \
            "ScannedStack requires a lightgrad tensor input"
        stacked = [self._stacked[n] for n in self._names]
        layout = [(isinstance(e, AbstractTensor), e) for e in extra]
        extra_ts = [e for e in extra if isinstance(e, AbstractTensor)]
        if not (Gradients._is_enabled() and any(
                t.requires_grad for t in [x, *stacked, *extra_ts])):
            h = x.data
            with _recording(False):
                for l in range(self.n_layers):
                    h = self._layer(l, h, stacked, extra_ts, layout,
                                    False)[-1].data
            return Tensor(h, requires_grad=False)
        return _scan_blocks(x, *stacked, *extra_ts, n_stacked=len(stacked),
                            stack=self, layout=layout)

    # -- checkpoint interop: per-layer names, exactly like a ModuleList -----
    def state_dict(self, prefix: str = "", separator: str = ".") -> dict:
        pfx = (prefix + separator) if prefix else ""
        out = {}
        for n in self._names:
            arr = self._stacked[n].numpy()
            for l in range(self.n_layers):
                out[f"{pfx}{l}{separator}{n}"] = arr[l]
        return out

    def load_parameters(self, param_dict: dict, prefix: str = "",
                        separator: str = ".") -> None:
        """Per-layer names (``0.attn.c_attn.weight``), or the stacked names
        of ``named_parameters`` (``attn__c_attn__weight``, as a scanned JAX
        model names them); each stack keeps its device and dtype."""
        pfx = (prefix + separator) if prefix else ""
        for n in self._names:
            t = self._stacked[n]
            key = pfx + self._name_map[n]
            if key in param_dict:
                nn._load_into(t, param_dict[key], key)
                continue
            per = []
            for l in range(self.n_layers):
                full = f"{pfx}{l}{separator}{n}"
                if full not in param_dict:
                    raise KeyError(f"{full} not found in param dict")
                per.append(_as_torch(param_dict[full]))
            nn._load_into(t, torch.stack([p.cpu() for p in per]),
                          f"{pfx}*{separator}{n}")


def _as_torch(v):
    if isinstance(v, AbstractTensor):
        return v.data
    if isinstance(v, torch.Tensor):
        return v
    v = np.asarray(v)
    if v.dtype.name == "bfloat16":
        v = v.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(v))



def layer_tensors(module) -> dict:
    """{``state_dict`` name: the parameter's tensor in its dtype and on its
    device}; a ScannedStack contributes its layers' views under per-layer
    names (what ``save_pretrained`` writes)."""
    out = {}

    def walk(m, pfx):
        if isinstance(m, ScannedStack):
            for l in range(m.n_layers):
                for n, v in m.layer_params(l).items():
                    out[f"{pfx}{l}.{n}"] = v
            return
        for n, t in m._params.items():
            out[pfx + n] = t.data
        for n, c in m._modules.items():
            walk(c, f"{pfx}{n}.")

    walk(module, "")
    return out
