"""Diffusion inference: schedulers + timed denoising loop.

Rebuild of /root/reference/baseline/inference.py:1594-1678
(DiffusionInferenceRunner: wraps a diffusers pipeline and monkeypatches
``scheduler.step`` to time each denoise step). This design owns the
sampling loop instead: DDIM/Euler schedulers are pure functions, the
whole denoise loop can run inside one jit (lax.scan), and per-step latencies
come from an eager timed mode — no monkeypatching.

The denoiser is any callable ``eps = f(params, x_t, t_embed)``; diffusers
checkpoints can be adapted by wrapping their UNet apply function.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 8.5e-4
    beta_end: float = 0.012
    schedule: str = "linear"  # "linear" | "cosine"


def make_alphas(cfg: SchedulerConfig) -> jax.Array:
    """Cumulative alpha-bar table."""
    if cfg.schedule == "linear":
        betas = jnp.linspace(cfg.beta_start, cfg.beta_end,
                             cfg.num_train_timesteps)
    else:  # cosine (Nichol & Dhariwal)
        t = jnp.arange(cfg.num_train_timesteps + 1) / cfg.num_train_timesteps
        f = jnp.cos((t + 0.008) / 1.008 * jnp.pi / 2) ** 2
        alphas_bar = f / f[0]
        betas = jnp.clip(1 - alphas_bar[1:] / alphas_bar[:-1], 0, 0.999)
    return jnp.cumprod(1.0 - betas)


def ddim_step(x_t, eps, alpha_bar_t, alpha_bar_prev, eta: float = 0.0):
    """One deterministic DDIM update."""
    x0 = (x_t - jnp.sqrt(1 - alpha_bar_t) * eps) / jnp.sqrt(alpha_bar_t)
    dir_xt = jnp.sqrt(1 - alpha_bar_prev) * eps
    return jnp.sqrt(alpha_bar_prev) * x0 + dir_xt


def euler_step(x_t, eps, sigma_t, sigma_prev):
    """One Euler update in sigma-space (k-diffusion style)."""
    d = eps  # eps-prediction == derivative for VE-style parameterization
    return x_t + d * (sigma_prev - sigma_t)


class DiffusionInferenceRunner:
    """(parity: DiffusionInferenceRunner inference.py:1594-1678)."""

    def __init__(
        self,
        denoise_fn: Callable,  # (params, x_t, t_scalar) -> eps
        params,
        *,
        scheduler: SchedulerConfig = SchedulerConfig(),
        method: str = "ddim",  # "ddim" | "euler"
        num_inference_steps: int = 20,
    ):
        self.denoise_fn = denoise_fn
        self.params = params
        self.scheduler = scheduler
        self.method = method
        self.num_inference_steps = num_inference_steps
        self.alphas_bar = make_alphas(scheduler)
        self.step_latencies_ms: List[float] = []

    def _timesteps(self) -> np.ndarray:
        T = self.scheduler.num_train_timesteps
        return np.linspace(T - 1, 0, self.num_inference_steps).round().astype(np.int32)

    # -- fused sampling: whole loop inside one jit ---------------------------

    def sample(self, shape: Tuple[int, ...],
               rng: Optional[jax.Array] = None) -> jax.Array:
        """Jitted end-to-end sampling (one dispatch; the fast path)."""
        rng = rng if rng is not None else jax.random.PRNGKey(0)
        ts = jnp.asarray(self._timesteps())
        ab = self.alphas_bar

        @jax.jit
        def run(params, rng):
            x = jax.random.normal(rng, shape)
            def body(x, i):
                t = ts[i]
                t_prev = jnp.where(i + 1 < ts.shape[0], ts[jnp.minimum(
                    i + 1, ts.shape[0] - 1)], 0)
                eps = self.denoise_fn(params, x, t)
                if self.method == "ddim":
                    x = ddim_step(x, eps, ab[t], jnp.where(
                        t_prev > 0, ab[t_prev], 1.0))
                else:
                    sigma_t = jnp.sqrt(1 - ab[t])
                    sigma_p = jnp.where(t_prev > 0,
                                        jnp.sqrt(1 - ab[t_prev]), 0.0)
                    x = euler_step(x, eps, sigma_t, sigma_p)
                return x, None
            x, _ = jax.lax.scan(body, x, jnp.arange(ts.shape[0]))
            return x

        return run(self.params, rng)

    # -- timed eager sampling: per-step latency metrics ----------------------

    def run_inference(self, shape: Tuple[int, ...],
                      rng: Optional[jax.Array] = None) -> Dict[str, Any]:
        """Per-denoise-step timing (parity: the scheduler.step timing wrap
        inference.py:1626-1665)."""
        rng = rng if rng is not None else jax.random.PRNGKey(0)
        ts = self._timesteps()
        ab = np.asarray(self.alphas_bar)
        step_fn = jax.jit(lambda params, x, t: self.denoise_fn(params, x, t))

        x = jax.random.normal(rng, shape)
        _ = np.asarray(step_fn(self.params, x, jnp.int32(int(ts[0]))))  # warm

        self.step_latencies_ms = []
        for i, t in enumerate(ts):
            t0 = time.perf_counter()
            eps = step_fn(self.params, x, jnp.int32(int(t)))
            t_prev = int(ts[i + 1]) if i + 1 < len(ts) else 0
            if self.method == "ddim":
                x = ddim_step(x, eps, float(ab[t]),
                              float(ab[t_prev]) if t_prev > 0 else 1.0)
            else:
                x = euler_step(x, eps, float(np.sqrt(1 - ab[t])),
                               float(np.sqrt(1 - ab[t_prev])) if t_prev > 0 else 0.0)
            _ = np.asarray(x[..., 0:1])  # sync
            self.step_latencies_ms.append((time.perf_counter() - t0) * 1e3)

        lat = np.asarray(self.step_latencies_ms)
        return {
            "output": x,
            "num_steps": len(ts),
            "step_latencies_ms": self.step_latencies_ms,
            "mean_step_ms": float(lat.mean()),
            "p99_step_ms": float(np.percentile(lat, 99)),
            "total_ms": float(lat.sum()),
        }


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """diffusers UNet2DModel-shaped config (the checkpoint class the
    reference's DiffusionInferenceRunner wraps, inference.py:1594-1678)."""

    sample_size: int = 32
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (32, 64)
    layers_per_block: int = 1
    time_embed_dim: int = 128
    norm_num_groups: int = 8
    mid_attention: bool = True


def _timestep_embedding(t, dim: int):
    """Sinusoidal timestep embedding (DDPM/Transformer convention)."""
    half = dim // 2
    freqs = jnp.exp(-jnp.log(10000.0) * jnp.arange(half) / half)
    ang = jnp.asarray(t, jnp.float32)[None] * freqs
    return jnp.concatenate([jnp.sin(ang), jnp.cos(ang)])[None]  # [1, dim]


def _group_norm(x, scale, bias, groups: int, eps: float = 1e-5):
    """GroupNorm over NHWC (channels last)."""
    N, H, W, C = x.shape
    g = x.reshape(N, H, W, groups, C // groups)
    mu = jnp.mean(g, axis=(1, 2, 4), keepdims=True)
    var = jnp.var(g, axis=(1, 2, 4), keepdims=True)
    g = (g - mu) * jax.lax.rsqrt(var + eps)
    return g.reshape(N, H, W, C) * scale + bias


def make_unet_denoiser(cfg: UNetConfig = UNetConfig(),
                       key: Optional[jax.Array] = None):
    """A real UNet-shaped denoiser: conv ResNet blocks with GroupNorm/SiLU
    and timestep conditioning, strided-conv downsampling, a mid
    self-attention block, skip connections, nearest-neighbour upsampling —
    the diffusers UNet2DModel architecture re-expressed in NHWC (channels
    last, the layout XLA's GPU convolutions prefer).

    Returns (denoise_fn, params) with ``eps = denoise_fn(params, x, t)``
    over NHWC ``x`` — plug-compatible with DiffusionInferenceRunner.
    """
    key = key if key is not None else jax.random.PRNGKey(0)
    ks = iter(jax.random.split(key, 200))

    def conv_p(cin, cout, k=3):
        w = jax.random.normal(next(ks), (k, k, cin, cout)) \
            * (k * k * cin) ** -0.5
        return {"w": w, "b": jnp.zeros((cout,))}

    def lin_p(cin, cout):
        return {"w": jax.random.normal(next(ks), (cin, cout)) * cin ** -0.5,
                "b": jnp.zeros((cout,))}

    def res_p(cin, cout):
        return {"n1": {"s": jnp.ones((cin,)), "b": jnp.zeros((cin,))},
                "c1": conv_p(cin, cout),
                "t": lin_p(cfg.time_embed_dim, cout),
                "n2": {"s": jnp.ones((cout,)), "b": jnp.zeros((cout,))},
                "c2": conv_p(cout, cout),
                "skip": (conv_p(cin, cout, k=1) if cin != cout else None)}

    chans = cfg.block_out_channels
    params: Dict[str, Any] = {
        "time": [lin_p(cfg.time_embed_dim, cfg.time_embed_dim),
                 lin_p(cfg.time_embed_dim, cfg.time_embed_dim)],
        "conv_in": conv_p(cfg.in_channels, chans[0]),
        "down": [], "downsample": [],
        "mid1": res_p(chans[-1], chans[-1]),
        "mid2": res_p(chans[-1], chans[-1]),
        "up": [], "upsample": [],
        "norm_out": {"s": jnp.ones((chans[0],)),
                     "b": jnp.zeros((chans[0],))},
        "conv_out": conv_p(chans[0], cfg.out_channels),
    }
    if cfg.mid_attention:
        c = chans[-1]
        params["attn"] = {"n": {"s": jnp.ones((c,)), "b": jnp.zeros((c,))},
                          "qkv": lin_p(c, 3 * c), "o": lin_p(c, c)}
    cin = chans[0]
    for c in chans:
        blocks = []
        for _ in range(cfg.layers_per_block):
            blocks.append(res_p(cin, c))
            cin = c
        params["down"].append(blocks)
        params["downsample"].append(conv_p(c, c))  # stride-2 in apply
    rev = list(reversed(chans))
    for i, c in enumerate(rev):
        params["upsample"].append(conv_p(cin, cin))  # pre-concat, keeps cin
        blocks = []
        bc_in = cin + rev[i]  # skip concat feeds only the first block
        for _ in range(cfg.layers_per_block):
            blocks.append(res_p(bc_in, c))
            bc_in = c
        params["up"].append(blocks)
        cin = c

    def conv(p, x, stride=1):
        return jax.lax.conv_general_dilated(
            x, p["w"], (stride, stride), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + p["b"]

    def res_block(p, x, temb):
        h = jax.nn.silu(_group_norm(x, p["n1"]["s"], p["n1"]["b"],
                                    cfg.norm_num_groups))
        h = conv(p["c1"], h)
        h = h + (temb @ p["t"]["w"] + p["t"]["b"])[:, None, None, :]
        h = jax.nn.silu(_group_norm(h, p["n2"]["s"], p["n2"]["b"],
                                    cfg.norm_num_groups))
        h = conv(p["c2"], h)
        if p["skip"] is not None:
            x = conv(p["skip"], x)
        return x + h

    def attn_block(p, x):
        N, H, W, C = x.shape
        h = _group_norm(x, p["n"]["s"], p["n"]["b"], cfg.norm_num_groups)
        qkv = h.reshape(N, H * W, C) @ p["qkv"]["w"] + p["qkv"]["b"]
        q, k, v = jnp.split(qkv, 3, axis=-1)
        s = jax.nn.softmax(q @ k.swapaxes(-1, -2) * C ** -0.5, axis=-1)
        o = (s @ v) @ p["o"]["w"] + p["o"]["b"]
        return x + o.reshape(N, H, W, C)

    def denoise(params, x, t):
        temb = _timestep_embedding(t, cfg.time_embed_dim)
        for lp in params["time"]:
            temb = jax.nn.silu(temb @ lp["w"] + lp["b"])
        temb = jnp.broadcast_to(temb, (x.shape[0], temb.shape[-1]))

        h = conv(params["conv_in"], x)
        skips = []
        for blocks, ds in zip(params["down"], params["downsample"]):
            for bp in blocks:
                h = res_block(bp, h, temb)
            skips.append(h)
            h = conv(ds, h, stride=2)
        h = res_block(params["mid1"], h, temb)
        if cfg.mid_attention:
            h = attn_block(params["attn"], h)
        h = res_block(params["mid2"], h, temb)
        for blocks, us, skip in zip(params["up"], params["upsample"],
                                    reversed(skips)):
            h = jnp.repeat(jnp.repeat(h, 2, axis=1), 2, axis=2)  # nearest
            h = conv(us, h)
            h = jnp.concatenate([h, skip], axis=-1)
            for bp in blocks:
                h = res_block(bp, h, temb)
        h = jax.nn.silu(_group_norm(h, params["norm_out"]["s"],
                                    params["norm_out"]["b"],
                                    cfg.norm_num_groups))
        return conv(params["conv_out"], h)

    return denoise, params


def make_mlp_denoiser(dim: int, hidden: int = 128,
                      key: Optional[jax.Array] = None):
    """Tiny reference denoiser for tests/benchmarks (a stand-in for a UNet:
    the runner only needs `eps = f(params, x, t)`)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    params = {
        "w1": jax.random.normal(k1, (dim + 1, hidden)) * (dim ** -0.5),
        "w2": jax.random.normal(k2, (hidden, dim)) * (hidden ** -0.5),
    }

    def denoise(params, x, t):
        t_feat = jnp.broadcast_to(
            jnp.asarray(t, jnp.float32) / 1000.0, x.shape[:-1] + (1,))
        h = jnp.concatenate([x, t_feat], axis=-1)
        return jnp.tanh(h @ params["w1"]) @ params["w2"]

    return denoise, params
