"""Denoising diffusion (DDPM) on the lightgrad tape: a time-conditioned
UNet and its schedule.

Counterpart of ``lightgrad_tpu/models/diffusion.py``, with its module and
parameter names.  Everything runs through the port's tape modules --
``Conv2d``, ``ConvTranspose2d`` (a stride-1 conv over the zero-dilated
input and the flipped kernel), ``GroupNorm`` (a composite over the
elementwise and reduce kernels), ``Linear`` -- so on the card the conv
kernels take both routes: the 1-channel stem and the 1-channel output conv
on the CUDA cores, the 32- and 64-channel convs on the tensor cores.

DDPM per Ho et al. 2020 (https://arxiv.org/abs/2006.11239): the forward
process q(x_t|x_0) = N(sqrt(a_bar_t) x_0, (1-a_bar_t) I); the UNet learns
to predict the injected noise; ancestral sampling inverts it step by step,
DDIM (Song et al. 2021) in fewer, deterministic hops.

A sampler compiles its step with ``jit=lightgrad_tpu_torch.jit`` (one
CUDA graph serves every step), as the JAX package's takes its ``jit``;
``jit=None`` runs each step eagerly.  Noise drawn in the samplers comes from
the tape's ``randn_like`` under the seeded ``random`` module, so sampled
images differ from the JAX package's (another random stream); the
starting noise is numpy's, as there.
"""

import numpy as np

from .. import nn

__all__ = ["UNet", "Diffusion"]


def _silu(x):
    return x * x.sigmoid()


def sinusoidal_embedding(t, dim: int):
    """Transformer-style sin/cos features of (float) timesteps ``t`` (b,)."""
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half, dtype=np.float32)
                   / half)
    f = type(t).from_numpy(freqs, requires_grad=False)
    ang = t.reshape(-1, 1) * f.reshape(1, half)
    return ang.sin().concat(ang.cos(), axis=-1)  # (b, dim)


class ResBlock(nn.Module):
    """GroupNorm -> SiLU -> conv, with a per-channel timestep shift between
    the two convs and a 1x1 skip when the channel count changes."""

    def __init__(self, cin: int, cout: int, time_dim: int, groups: int = 8):
        super().__init__()
        self.norm1 = nn.GroupNorm(min(groups, cin), cin)
        self.conv1 = nn.Conv2d(cin, cout, kernelsize=3, pad="same")
        self.temb = nn.Linear(time_dim, cout)
        self.norm2 = nn.GroupNorm(min(groups, cout), cout)
        self.conv2 = nn.Conv2d(cout, cout, kernelsize=3, pad="same")
        self.skip = nn.Conv2d(cin, cout, kernelsize=1, pad=0, bias=False) \
            if cin != cout else None

    def forward(self, x, emb):
        h = self.conv1(_silu(self.norm1(x)))
        b, c = emb.shape[0], h.shape[1]
        h = h + self.temb(_silu(emb)).reshape(b, c, 1, 1)
        h = self.conv2(_silu(self.norm2(h)))
        return h + (self.skip(x) if self.skip is not None else x)


class UNet(nn.Module):
    """Small time-conditioned UNet (2 resolutions + bottleneck, skip
    concatenation).  Spatial dims must be divisible by 4 after the stem --
    28x28 digits work (28 -> 14 -> 7 -> 14 -> 28)."""

    def __init__(self, in_channels: int = 1, base: int = 32,
                 time_dim: int = 128):
        super().__init__()
        c = base
        self.time_dim = time_dim
        self.time_mlp = nn.Sequential(nn.Linear(time_dim, time_dim),
                                      nn.GELU(),
                                      nn.Linear(time_dim, time_dim))
        self.stem = nn.Conv2d(in_channels, c, kernelsize=3, pad="same")
        self.rb_d1 = ResBlock(c, c, time_dim)
        self.down1 = nn.Conv2d(c, c, kernelsize=3, stride=2, pad=1)
        self.rb_d2 = ResBlock(c, 2 * c, time_dim)
        self.down2 = nn.Conv2d(2 * c, 2 * c, kernelsize=3, stride=2, pad=1)
        self.rb_mid = ResBlock(2 * c, 2 * c, time_dim)
        self.up2 = nn.ConvTranspose2d(2 * c, 2 * c, kernelsize=4, stride=2,
                                      pad=1)
        self.rb_u2 = ResBlock(4 * c, c, time_dim)       # cat with rb_d2 out
        self.up1 = nn.ConvTranspose2d(c, c, kernelsize=4, stride=2, pad=1)
        self.rb_u1 = ResBlock(2 * c, c, time_dim)       # cat with rb_d1 out
        self.out_norm = nn.GroupNorm(8, c)
        self.out = nn.Conv2d(c, in_channels, kernelsize=3, pad="same")

    def forward(self, x, t):
        """Predict the noise in ``x`` (b, c, h, w) at float timesteps ``t``
        (b,)."""
        emb = self.time_mlp(sinusoidal_embedding(t, self.time_dim))
        h1 = self.rb_d1(self.stem(x), emb)              # (b, c,  h,   w)
        h2 = self.rb_d2(self.down1(h1), emb)            # (b, 2c, h/2, w/2)
        m = self.rb_mid(self.down2(h2), emb)            # (b, 2c, h/4, w/4)
        u2 = self.rb_u2(self.up2(m).concat(h2, axis=1), emb)
        u1 = self.rb_u1(self.up1(u2).concat(h1, axis=1), emb)
        return self.out(_silu(self.out_norm(u1)))


class Diffusion:
    """DDPM schedule + training loss + ancestral and DDIM samplers around a
    UNet.

    The schedule constants are (T,) tensors on the model's device; the
    per-example coefficients are gathered by the int timestep tensor, so a
    step never reads ``t`` back to the host."""

    def __init__(self, model: UNet, timesteps: int = 200,
                 beta_start: float = 1e-4, beta_end: float = 0.02):
        self.model = model
        self.T = timesteps
        betas = np.linspace(beta_start, beta_end, timesteps, dtype=np.float32)
        alphas = 1.0 - betas
        a_bar = np.cumprod(alphas)
        a_bar_prev = np.concatenate([[1.0], a_bar[:-1]]).astype(np.float32)
        t0 = type(model.out.w)  # tensor class of the model's backend
        mk = lambda arr: t0.from_numpy(np.asarray(arr, np.float32),
                                       requires_grad=False)
        self.betas = mk(betas)
        self.sqrt_a_bar = mk(np.sqrt(a_bar))
        self.sqrt_1m_a_bar = mk(np.sqrt(1.0 - a_bar))
        self.rsqrt_alphas = mk(1.0 / np.sqrt(alphas))
        self.eps_coef = mk(betas / np.sqrt(1.0 - a_bar))
        # posterior variance beta_tilde = beta * (1 - a_bar_{t-1})/(1 - a_bar)
        self.post_std = mk(np.sqrt(betas * (1.0 - a_bar_prev)
                                   / (1.0 - a_bar)))
        # a_bar padded with a_bar_{-1} = 1 at index 0, so DDIM can index
        # a_bar[t_prev] with t_prev = -1 (the final hop to clean data) as
        # a_bar_pad[t_prev + 1] -- no data-dependent control flow
        self.a_bar_pad = mk(np.concatenate([[1.0], a_bar]))

    def q_sample(self, x0, t, noise):
        """Diffuse clean images to step ``t``: the closed-form forward."""
        b = x0.shape[0]
        c1 = self.sqrt_a_bar[t].reshape(b, 1, 1, 1)
        c2 = self.sqrt_1m_a_bar[t].reshape(b, 1, 1, 1)
        return x0 * c1 + noise * c2

    def loss(self, x0, t, noise):
        """Noise-prediction MSE at integer timesteps ``t`` (b,)."""
        from ..loss import mse

        xt = self.q_sample(x0, t, noise)
        return mse(self.model(xt, t.astype(np.float32)), noise)

    def p_sample(self, xt, t, noise):
        """One reverse step: x_{t-1} from x_t (``noise`` ~ N(0,1), zero it
        for the final step).  ``t`` is a (b,) int tensor."""
        b = xt.shape[0]
        eps = self.model(xt, t.astype(np.float32))
        mean = (xt - eps * self.eps_coef[t].reshape(b, 1, 1, 1)) \
            * self.rsqrt_alphas[t].reshape(b, 1, 1, 1)
        return mean + noise * self.post_std[t].reshape(b, 1, 1, 1)

    def p_sample_ddim(self, xt, t, t_prev, eta: float, noise):
        """One DDIM hop t -> t_prev (Song et al. 2021, arXiv:2010.02502
        §4.1).  ``eta=0`` is the deterministic DDIM ODE; ``eta=1``
        recovers DDPM's ancestral variance.  ``t`` / ``t_prev`` are (b,)
        int tensors; ``t_prev`` may be -1 for the final hop."""
        b = xt.shape[0]
        eps = self.model(xt, t.astype(np.float32))
        a_t = self.a_bar_pad[t + 1].reshape(b, 1, 1, 1)
        a_p = self.a_bar_pad[t_prev + 1].reshape(b, 1, 1, 1)
        x0 = (xt - eps * (1.0 - a_t) ** 0.5) * a_t ** -0.5
        sigma = ((1.0 - a_p) / (1.0 - a_t)) ** 0.5 \
            * (1.0 - a_t / a_p) ** 0.5 * eta
        dir_xt = (1.0 - a_p - sigma * sigma) ** 0.5 * eps
        return x0 * a_p ** 0.5 + dir_xt + noise * sigma

    def sample_ddim(self, n: int, steps: int = 50, eta: float = 0.0,
                    shape=(1, 28, 28), seed: int = 0, jit=None):
        """DDIM sampling on a ``steps``-long sub-schedule of the T trained
        timesteps: 10-50 hops instead of T, deterministic at ``eta=0``
        (the noise is gated to zero by a 0-d tensor)."""
        from ..autograd import no_grad
        from .. import random as _lgrandom

        _lgrandom.seed(seed)
        t0 = type(self.sqrt_a_bar)
        rng = np.random.default_rng(seed)
        x = t0.from_numpy(rng.normal(size=(n, *shape)).astype(np.float32),
                          requires_grad=False)
        ts = np.unique(np.linspace(0, self.T - 1, steps).round()
                       .astype(np.int64))[::-1]  # descending
        pairs = list(zip(ts, np.append(ts[1:], -1)))

        def one(xt, t, tp, gate):
            return self.p_sample_ddim(xt, t, tp, eta, xt.randn_like() * gate)

        step = jit(one) if jit is not None else one
        with no_grad():
            for i, (t_i, tp_i) in enumerate(pairs):
                t = t0.from_numpy(np.full((n,), t_i, np.int32),
                                  requires_grad=False)
                tp = t0.from_numpy(np.full((n,), tp_i, np.int32),
                                   requires_grad=False)
                gate = t0.from_numpy(
                    np.float32(1.0 if (eta and i < len(pairs) - 1) else 0.0),
                    requires_grad=False)
                x = step(x, t, tp, gate)
        return x

    def sample(self, n: int, shape=(1, 28, 28), seed: int = 0, jit=None):
        """Ancestral sampling: T reverse steps from pure noise.  The
        per-step noise is drawn on the device (``randn_like``), gated by a
        0-d tensor so the final step is noiseless."""
        from ..autograd import no_grad
        from .. import random as _lgrandom

        _lgrandom.seed(seed)
        t0 = type(self.sqrt_a_bar)
        rng = np.random.default_rng(seed)
        x = t0.from_numpy(rng.normal(size=(n, *shape)).astype(np.float32),
                          requires_grad=False)

        def one(xt, t, gate):
            return self.p_sample(xt, t, xt.randn_like() * gate)

        step = jit(one) if jit is not None else one
        with no_grad():
            for i in reversed(range(self.T)):
                t = t0.from_numpy(np.full((n,), i, np.int32),
                                  requires_grad=False)
                gate = t0.from_numpy(np.float32(1.0 if i > 0 else 0.0),
                                     requires_grad=False)
                x = step(x, t, gate)
        return x
