"""Weights by the reference's dotted names, and the export checkpoint file.

The reference names every tensor by its pytree path
(``ae_wavenet_tpu.training.torch_compat.flatten_named``):
``params.wavenet.layers.3.w_cond.w``, ``bn_state.codebook``, ...  The
port's ``state_dict`` keys are the same names with ``params.`` dropped and
``bn_state.`` replaced by ``bottleneck.``.  Checkpoints use the reference's
``export_torch`` payload ``{"step", "run_config_json", "state"}``, so a
JAX checkpoint exported with ``export_torch`` serves (and, with its
``opt_state.*`` tensors, resumes training) here, and a file saved here
imports into the JAX package.  The optimizer state keeps optax's names
(``training/chassis.Adam``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ae_wavenet_tpu_torch.models.autoencoder import AutoEncoder
from ae_wavenet_tpu_torch.utils import config as config_mod


def _port_name(name: str) -> str | None:
    """Reference name -> state_dict key (None for optimizer state)."""
    head, _, rest = name.partition(".")
    if head == "params":
        return rest
    if head == "bn_state":
        return "bottleneck." + rest
    if head == "opt_state":
        return None
    raise KeyError(f"unexpected tensor name {name!r}")


def load_into(model: AutoEncoder, named: dict) -> AutoEncoder:
    """Copy {reference dotted name: array} into ``model`` (every tensor
    must be present with its shape; ``opt_state.*`` is ignored)."""
    own = model.state_dict()
    state = {}
    for name, v in named.items():
        key = _port_name(name)
        if key is None:
            continue
        if key not in own:
            raise KeyError(f"{name}: no such tensor in the model")
        t = torch.as_tensor(np.asarray(v, dtype=np.float32))
        if tuple(t.shape) != tuple(own[key].shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(own[key].shape)}")
        state[key] = t
    missing = sorted(set(own) - set(state))
    if missing:
        raise KeyError(f"missing {len(missing)} tensors, e.g. {missing[:5]}")
    model.load_state_dict(state)
    return model


def from_named(named: dict, cfg: config_mod.RunConfig) -> AutoEncoder:
    """{reference dotted name: array} -> AutoEncoder holding those values."""
    return load_into(AutoEncoder(cfg), named)


def load_named(path: str):
    """-> (step, {dotted name: tensor}, RunConfig) from an export file."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return (int(payload["step"]), dict(payload["state"]),
            config_mod.from_json(payload["run_config_json"]))


def load_export(path: str):
    """-> (step, AutoEncoder on the CPU, RunConfig) from an export file."""
    step, named, cfg = load_named(path)
    if cfg.model_kind != "autoencoder":
        raise NotImplementedError(
            f"model_kind={cfg.model_kind!r}: the port serves the autoencoder "
            "only (the MFCC inverter is a later slice, ROADMAP.md)")
    return step, from_named({k: v.numpy() for k, v in named.items()}, cfg), cfg


def save_export(path: str, model: AutoEncoder, cfg: config_mod.RunConfig,
                step: int, extra: dict | None = None) -> None:
    """Write the export payload; ``extra`` adds named tensors (the
    optimizer state).  The file appears atomically."""
    buffers = {k for k, _ in model.named_buffers()}
    state = {}
    for k, v in model.state_dict().items():
        if k in buffers:
            name = "bn_state." + k.removeprefix("bottleneck.")
        else:
            name = "params." + k
        state[name] = v.detach().float().cpu().contiguous()
    for name, v in (extra or {}).items():
        state[name] = v.detach().cpu().contiguous()
    tmp = path + ".tmp"
    torch.save({"step": int(step), "run_config_json": config_mod.to_json(cfg),
                "state": state}, tmp)
    os.replace(tmp, path)
