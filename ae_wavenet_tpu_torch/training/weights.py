"""Weights by the reference's dotted names, and the export checkpoint file.

The reference names every tensor by its pytree path
(``ae_wavenet_tpu.training.torch_compat.flatten_named``):
``params.wavenet.layers.3.w_cond.w``, ``bn_state.codebook``, ...  The
port's ``state_dict`` keys are the same names with ``params.`` dropped and
``bn_state.`` replaced by ``bottleneck.`` (the MFCC inverter has
``params.wavenet.*`` only).  Checkpoints use the reference's
``export_torch`` payload ``{"step", "run_config_json", "state"}``, so a
JAX checkpoint exported with ``export_torch`` serves (and, with its
``opt_state.*`` tensors, resumes training) here, and a file saved here
imports into the JAX package.  The optimizer state keeps optax's names
(``training/chassis.Adam``).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from ae_wavenet_tpu_torch.models import registry
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


def check_merge(ref: dict, new: dict, what: str) -> None:
    """The reference's guarded merge (``training/checkpoint.merge_into``) as
    a check of names and shapes: ``new`` ({name: array}) must hold exactly
    ``ref``'s names ({name: shape}) with their shapes, or the runtime config
    builds another model than the checkpoint's."""
    if set(ref) != set(new):
        odd = sorted(set(ref) ^ set(new))[:5]
        raise ValueError(
            f"checkpoint {what} tree has {len(new)} leaves but "
            f"the current config builds {len(ref)} (e.g. {odd}) — the "
            f"model architecture changed since the save; resume "
            f"with the checkpoint's embedded config (CLI `resume` "
            f"does this) or match the flags (aux_frame_weight, "
            f"bottleneck kind, model dims) to the original run")
    for name, shape in ref.items():
        got = tuple(np.shape(new[name]))
        if tuple(shape) != got and not (math.prod(shape) == math.prod(got) == 1):
            # (a 0-d count may come back from an export as one element)
            raise ValueError(
                f"checkpoint {what} leaf shape {got} != "
                f"model's {tuple(shape)} ({name}) — architecture drift "
                f"since the save")


def load_into(model: nn.Module, named: dict) -> nn.Module:
    """Copy {reference dotted name: array} into ``model``: exactly the
    model's tensors, each with its shape (:func:`check_merge`;
    ``opt_state.*`` is ignored)."""
    own = model.state_dict()
    new = {key: v for name, v in named.items()
           if (key := _port_name(name)) is not None}
    check_merge({k: v.shape for k, v in own.items()}, new, "params")
    model.load_state_dict({k: torch.as_tensor(np.asarray(v, dtype=np.float32))
                           for k, v in new.items()})
    return model


def from_named(named: dict, cfg: config_mod.RunConfig) -> nn.Module:
    """{reference dotted name: array} -> the model of ``cfg.model_kind``
    (on the CPU) holding those values."""
    return load_into(registry.get(cfg.model_kind).init(cfg, device="cpu"), named)


def load_named(path: str):
    """-> (step, {dotted name: tensor}, RunConfig) from an export file."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return (int(payload["step"]), dict(payload["state"]),
            config_mod.from_json(payload["run_config_json"]))


def load_export(path: str):
    """-> (step, model on the CPU, RunConfig) from an export file; the
    model is the family the file's config names."""
    step, named, cfg = load_named(path)
    return step, from_named({k: v.numpy() for k, v in named.items()}, cfg), cfg


def export_state(model: nn.Module, extra: dict | None = None) -> dict:
    """{reference dotted name: CPU tensor}: a host snapshot (copies, so a
    later step does not write into it) of the model and of ``extra``'s
    named tensors (the optimizer state)."""
    buffers = {k for k, _ in model.named_buffers()}
    state = {}
    for k, v in model.state_dict().items():
        if k in buffers:
            name = "bn_state." + k.removeprefix("bottleneck.")
        else:
            name = "params." + k
        state[name] = v.detach().to("cpu", torch.float32, copy=True).contiguous()
    for name, v in (extra or {}).items():
        state[name] = v.detach().to("cpu", copy=True).contiguous()
    return state


def write_export(path: str, state: dict, cfg: config_mod.RunConfig,
                 step: int) -> None:
    """Write the export payload; the file appears atomically."""
    tmp = path + ".tmp"
    torch.save({"step": int(step), "run_config_json": config_mod.to_json(cfg),
                "state": state}, tmp)
    os.replace(tmp, path)


def save_export(path: str, model: nn.Module, cfg: config_mod.RunConfig,
                step: int, extra: dict | None = None) -> None:
    """Write the export payload; ``extra`` adds named tensors (the
    optimizer state)."""
    write_export(path, export_state(model, extra), cfg, step)
