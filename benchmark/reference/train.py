"""The reference's first training steps: loss, gradients and plain Adam.

The batch is taken a row at a time (every loss term is a mean over rows of
equal size, so the batch's gradient is the mean of the rows' gradients),
which bounds the float32 activations to one row's.  The VQ codebook's EMA
update takes the batch's summed statistics after every row has been seen,
as the program's update does after its batched lookup.
"""

from __future__ import annotations

import torch

from benchmark.reference import models
from benchmark.reference.precision import exact


def _ramp(step: int, n: int) -> float:
    return 1.0 if n <= 0 else min(step / n, 1.0)


class Adam:
    """optax's ``chain(clip_by_global_norm, adam | adamw)`` at a constant
    learning rate, one tensor at a time."""

    def __init__(self, params: dict, t_cfg):
        self.cfg, self.params = t_cfg, params
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, grads: dict) -> dict:
        """Apply one update; returns the gradients as the update took them
        (after the clip)."""
        t = self.cfg
        if t.lr_boundaries:
            raise NotImplementedError("a piecewise learning rate")
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        if t.grad_clip > 0 and norm >= t.grad_clip:
            grads = {k: g / norm * t.grad_clip for k, g in grads.items()}
        self.count += 1
        bc1 = 1.0 - t.adam_b1 ** self.count
        bc2 = 1.0 - t.adam_b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = t.adam_b1 * self.mu[k] + (1.0 - t.adam_b1) * g
            self.nu[k] = t.adam_b2 * self.nu[k] + (1.0 - t.adam_b2) * g * g
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + t.adam_eps)
            if t.weight_decay > 0:
                u = u + t.weight_decay * p
            p.sub_(t.learning_rate * u)
        return grads


def state(model) -> dict:
    """Every parameter and buffer of ``model`` (the VQ codebook and its EMA
    counts and sums among them), copied to the host."""
    named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    return {k: t.detach().cpu().clone() for k, t in named.items()}


def follow(cfg, weights: dict, batches, draws, device, q=exact, keep=()) -> list[dict]:
    """Train a fresh copy of ``weights`` through ``len(batches)`` steps.
    ``batches``: [(wav [B, U] int16, spk [B])]; ``draws``: each step's
    {"jitter_u", "restart_idx"} as the program's step took them.  Returns a
    record per step: ``loss`` (and its terms); the first step's also
    ``grads`` (as Adam took them); and the steps in ``keep`` also
    ``state`` (:func:`state` after the step)."""
    model = models.build(cfg, weights, device)
    spec = models.window_spec(cfg)
    params = dict(model.named_parameters())
    opt = Adam(params, cfg.train)
    bn = cfg.bottleneck
    records = []
    for step, ((wav, spk), dr) in enumerate(zip(batches, draws)):
        for p in params.values():
            p.grad = None
        b = wav.shape[0]
        terms: dict = {}
        counts = sums = None
        zfs = []
        for r in range(b):
            u = dr["jitter_u"][r : r + 1] if "jitter_u" in dr else None
            out = models.window_row(model, cfg, spec, wav[r : r + 1].to(device),
                                    spk[r : r + 1].to(device), u, q)
            loss = out["recon_ce"]
            if "commitment" in out:
                loss = loss + _ramp(step, bn.vq_warmup_steps) * bn.vq_beta * out["commitment"]
            if "aux_frame_mse" in out:
                loss = loss + cfg.train.aux_frame_weight * out["aux_frame_mse"]
            (loss / b).backward()
            for k in ("recon_ce", "commitment", "aux_frame_mse"):
                if k in out:
                    terms[k] = terms.get(k, 0.0) + float(out[k].detach()) / b
            terms["loss"] = terms.get("loss", 0.0) + float(loss.detach()) / b
            if "counts" in out:
                counts = out["counts"] if counts is None else counts + out["counts"]
                sums = out["sums"] if sums is None else sums + out["sums"]
                zfs.append(out["zf"])
        if counts is not None:
            with torch.no_grad():
                terms["perplexity"] = float(models.perplexity(counts))
                models.ema_update(model.bottleneck, bn, counts, sums, torch.cat(zfs),
                                  dr.get("restart_idx"))
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        taken = opt.update(grads)
        if step == 0:
            terms["grads"] = {k: g.detach().cpu() for k, g in taken.items()}
        if step in keep:
            terms["state"] = state(model)
        records.append(terms)
    return records
