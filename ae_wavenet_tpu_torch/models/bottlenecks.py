"""Bottlenecks: plain AE, zero (conditioning ablation), VAE and VQ-EMA.

Counterpart of ``ae_wavenet_tpu.models.bottlenecks``.  ``forward(z)`` is
the evaluation path (VAE posterior mean, nearest code); ``train_apply``
is ``apply(params, state, cfg, z, rng, step, train)``: the loss terms and
diagnostics, and for VQ the EMA codebook update (Laplace smoothing,
dead-code restarts), the straight-through value and temporal jitter.

VQ state (``codebook``, ``ema_counts``, ``ema_sums``) is kept as buffers
under the reference's ``bn_state`` names; ``train_apply(train=True)``
updates them in place.  The random draws are optional inputs (``draws``:
``jitter_u`` [B, 1, Tz] uniforms, ``restart_idx`` [G, K] batch-vector
indices, ``eps`` [B, D, Tz] normals), so a test can feed both packages
the same numbers; absent ones come from ``generator``.

With ``cfg.vq_use_pallas`` (G = 1) the nearest codes, the looked-up rows and
the EMA counts and sums come from the fused kernel ``ops/vq_cuda.py`` on the
detached latents; everything after them is the same code.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ae_wavenet_tpu_torch.ops.vq_cuda import vq_lookup_fused
from ae_wavenet_tpu_torch.utils.config import BottleneckConfig


def _draw(draws: dict | None, key: str, make):
    if draws is not None and key in draws:
        return draws[key]
    return make()


def _ramp(step, n: int, device) -> torch.Tensor:
    """min(step / n, 1) in f32, or 1 when n == 0."""
    if n <= 0:
        return torch.ones((), device=device)
    return torch.clamp(torch.as_tensor(step, dtype=torch.float32, device=device) / n,
                       max=1.0)


class AEBottleneck(nn.Module):
    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return z

    def train_apply(self, z, step, train, generator=None, draws=None):
        return z, {"bn_loss": z.new_zeros(())}


class ZeroBottleneck(nn.Module):
    """The decoder sees all-zero local conditioning."""

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(z)

    def train_apply(self, z, step, train, generator=None, draws=None):
        return torch.zeros_like(z), {"bn_loss": z.new_zeros(())}


class VAEBottleneck(nn.Module):
    def __init__(self, cfg: BottleneckConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        d, s = cfg.n_dim, 1.0 / math.sqrt(cfg.n_dim)
        self.w_mu = nn.Parameter(torch.randn(d, d, generator=generator) * s)
        self.b_mu = nn.Parameter(torch.zeros(d))
        self.w_sig = nn.Parameter(torch.randn(d, d, generator=generator) * s)
        self.b_sig = nn.Parameter(torch.zeros(d))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """Posterior mean (no reparameterization draw in eval)."""
        return (torch.einsum("bdt,ed->bet", z, self.w_mu)
                + self.b_mu[None, :, None])

    def train_apply(self, z, step, train, generator=None, draws=None):
        """Reparameterised draw (train), free-bits KL with its anneal
        weight, and the posterior-health diagnostics ``active_units`` and
        ``mu_var`` (reference ``_apply_vae``)."""
        cfg = self.cfg
        mu = self.forward(z)
        log_sig = torch.clamp(torch.einsum("bdt,ed->bet", z, self.w_sig)
                              + self.b_sig[None, :, None], -7.0, 7.0)
        if train:
            eps = _draw(draws, "eps", lambda: torch.randn(
                mu.shape, generator=generator, device=mu.device))
            zq = mu + torch.exp(log_sig) * eps
        else:
            zq = mu
        kl_dims = 0.5 * (mu.square() + torch.exp(2.0 * log_sig) - 2.0 * log_sig - 1.0)
        kl = torch.clamp(kl_dims, min=cfg.free_nats).sum(1).mean()
        w = _ramp(step, cfg.kl_anneal_steps, z.device)
        kl_dim_mean = kl_dims.mean((0, 2))
        aux = {"bn_loss": w * kl, "kl": kl, "kl_weight": w,
               "active_units": (kl_dim_mean > 0.02).float().sum(),
               "mu_var": mu.var((0, 2), unbiased=False).mean()}
        return zq, aux


def jitter(zq: torch.Tensor, u: torch.Tensor, p: float) -> torch.Tensor:
    """Temporal jitter (Chorowski): each timestep is replaced by its left
    or right neighbour where u < p/2 or u > 1 - p/2 (u [B, 1, T])."""
    left = torch.cat([zq[..., :1], zq[..., :-1]], -1)
    right = torch.cat([zq[..., 1:], zq[..., -1:]], -1)
    out = torch.where(u < p / 2, left, zq)
    return torch.where(u > 1.0 - p / 2, right, out)


class VQBottleneck(nn.Module):
    def __init__(self, cfg: BottleneckConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        g = cfg.vq_groups
        if g == 1:  # the reference keeps ungrouped state shapes for G = 1
            shape, counts_shape = (cfg.vq_k, cfg.n_dim), (cfg.vq_k,)
        else:
            shape, counts_shape = (g, cfg.vq_k, cfg.n_dim // g), (g, cfg.vq_k)
        codebook = torch.randn(*shape, generator=generator) / math.sqrt(shape[-1])
        self.groups = g
        self.register_buffer("codebook", codebook)
        self.register_buffer("ema_counts", torch.ones(counts_shape))
        self.register_buffer("ema_sums", codebook.clone())

    def _grouped(self, z: torch.Tensor):
        """z [B, D, T] -> (flat z [N, D], per-group z [G, N, D/G],
        per-group codebook [G, K, D/G])."""
        b, d, t = z.shape
        zf = z.permute(0, 2, 1).reshape(b * t, d)
        zg = zf.reshape(b * t, self.groups, d // self.groups).permute(1, 0, 2)
        e = self.codebook
        return zf, zg, (e if e.dim() == 3 else e[None])

    @staticmethod
    def _nearest(zg: torch.Tensor, eg: torch.Tensor) -> torch.Tensor:
        d2 = (zg.square().sum(2, keepdim=True)
              - 2.0 * torch.einsum("gnd,gkd->gnk", zg, eg)
              + eg.square().sum(2)[:, None, :])
        return d2.argmin(2)

    def _fused(self, zf: torch.Tensor, stats: bool):
        """(codes [N] int32, q [N, D], counts [K], sums [K, D]) from the
        fused kernel on the detached f32 latents; without ``stats`` the
        EMA counts and sums are neither computed nor returned."""
        return vq_lookup_fused(zf.detach().float().contiguous(), self.codebook,
                               stats)

    def codes(self, z: torch.Tensor) -> torch.Tensor:
        """Nearest code per group: [G, B*T] (rows ordered (b, t))."""
        zf, zg, eg = self._grouped(z)
        if self.cfg.vq_use_pallas:
            return self._fused(zf, False)[0].long()[None]
        return self._nearest(zg, eg)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        b, d, t = z.shape
        zf, zg, eg = self._grouped(z)
        if self.cfg.vq_use_pallas:
            q = self._fused(zf, False)[1]
        else:
            idx = self._nearest(zg, eg)
            qg = torch.gather(eg, 1, idx[..., None].expand(-1, -1, eg.shape[-1]))
            q = qg.permute(1, 0, 2).reshape(b * t, d)
        # the reference's straight-through value zf + (q - zf), kept as is
        # so the conditioning matches it to the last bit
        zq = zf + (q - zf)
        return zq.reshape(b, t, d).permute(0, 2, 1)

    def train_apply(self, z, step, train, generator=None, draws=None):
        """Reference ``_apply_vq``: nearest codes, EMA counts and sums,
        Laplace-smoothed codebook, dead-code restarts, commitment,
        straight-through value, jitter (train) and usage perplexity.  With
        ``train`` the buffers take the new state in place."""
        cfg = self.cfg
        b, d, t = z.shape
        zf, zg, eg = self._grouped(z)
        n_vec = b * t
        with torch.no_grad():
            zg_sg = zg.detach()
            if cfg.vq_use_pallas:
                _, q, counts, sums = self._fused(zf, True)
                counts, sums = counts[None], sums[None]
            else:
                idx = self._nearest(zg_sg, eg)
                onehot = F.one_hot(idx, cfg.vq_k).float()        # [G, N, K]
                qg = torch.einsum("gnk,gkd->gnd", onehot, eg)
                q = qg.permute(1, 0, 2).reshape(n_vec, d)
                counts = onehot.sum(1)                            # [G, K]
                sums = torch.einsum("gnk,gnd->gkd", onehot, zg_sg)
            grp = self.codebook.dim() == 3
            cnt = self.ema_counts if grp else self.ema_counts[None]
            sm = self.ema_sums if grp else self.ema_sums[None]
            decay = cfg.ema_decay
            new_counts = decay * cnt + (1.0 - decay) * counts
            new_sums = decay * sm + (1.0 - decay) * sums
            n = new_counts.sum(1, keepdim=True)
            smoothed = (new_counts + cfg.ema_eps) / (n + cfg.vq_k * cfg.ema_eps) * n
            new_codebook = new_sums / smoothed[..., None]
            if cfg.vq_restart_thresh > 0.0:
                ridx = _draw(draws, "restart_idx", lambda: torch.randint(
                    0, n_vec, (self.groups, cfg.vq_k), generator=generator,
                    device=z.device))
                cand = torch.gather(zg_sg, 1, ridx.long()[..., None].expand(
                    -1, -1, zg.shape[-1]))
                dead = new_counts < cfg.vq_restart_thresh
                new_codebook = torch.where(dead[..., None], cand, new_codebook)
                new_sums = torch.where(dead[..., None], cand, new_sums)
                new_counts = torch.where(dead, torch.ones_like(new_counts), new_counts)
                n_restarts = dead.float().sum()
            else:
                n_restarts = z.new_zeros(())
            if train:
                shape = self.codebook.shape
                self.codebook.copy_(new_codebook.reshape(shape))
                self.ema_sums.copy_(new_sums.reshape(shape))
                self.ema_counts.copy_(new_counts.reshape(self.ema_counts.shape))
            avg = counts / torch.clamp(counts.sum(-1, keepdim=True), min=1.0)
            perplexity = torch.exp(
                -(avg * torch.log(torch.clamp(avg, min=1e-10))).sum(-1)).mean()
        commitment = (zf - q).square().sum(1).mean()
        zq = zf + (q - zf).detach()
        zq = zq.reshape(b, t, d).permute(0, 2, 1)
        zq_pre_jitter = zq
        if train and cfg.jitter_p > 0.0:
            u = _draw(draws, "jitter_u", lambda: torch.rand(
                (b, 1, t), generator=generator, device=z.device))
            zq = jitter(zq, u, cfg.jitter_p)
        w = _ramp(step, cfg.vq_warmup_steps, z.device)
        aux = {"bn_loss": w * cfg.vq_beta * commitment, "commitment": commitment,
               "perplexity": perplexity,
               "restarts": n_restarts if train else z.new_zeros(()),
               "zq_pre_jitter": zq_pre_jitter}
        return zq, aux


def make(cfg: BottleneckConfig, generator: torch.Generator | None = None) -> nn.Module:
    if cfg.kind == "ae":
        return AEBottleneck()
    if cfg.kind == "zero":
        return ZeroBottleneck()
    if cfg.kind == "vae":
        return VAEBottleneck(cfg, generator)
    if cfg.kind == "vq":
        return VQBottleneck(cfg, generator)
    raise ValueError(f"unknown bottleneck kind {cfg.kind!r}")
