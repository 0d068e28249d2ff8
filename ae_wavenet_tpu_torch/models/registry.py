"""Model families by ``RunConfig.model_kind``.

Counterpart of ``ae_wavenet_tpu.models.registry``.  Each family module has
the same ``init``, ``loss_fn``, ``make_window_spec``, ``encode`` and
``reconstruct``, so the chassis and the CLIs take either.
"""

from __future__ import annotations

from ae_wavenet_tpu_torch.models import autoencoder, mfcc_inverter

_REGISTRY = {
    "autoencoder": autoencoder,
    "mfcc_inverter": mfcc_inverter,
}


def get(model_kind: str):
    try:
        return _REGISTRY[model_kind]
    except KeyError:
        raise ValueError(f"unknown model_kind {model_kind!r}; available: "
                         f"{sorted(_REGISTRY)}") from None
