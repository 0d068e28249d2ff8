"""Model families by ``RunConfig.model_kind``.

Counterpart of ``ae_wavenet_tpu.models.registry``.  Each family module has
the same ``init``, ``loss_fn``, ``draws``, ``make_window_spec``,
``encode`` and ``reconstruct``, so the chassis and the CLIs take either
(WaveGlow's ``loss_fn`` and ``make_window_spec`` raise: it has no training
step yet).
"""

from __future__ import annotations

from ae_wavenet_tpu_torch.models import autoencoder, mfcc_inverter, waveglow

_REGISTRY = {
    "autoencoder": autoencoder,
    "mfcc_inverter": mfcc_inverter,
    "waveglow": waveglow,
}


def get(model_kind: str):
    try:
        return _REGISTRY[model_kind]
    except KeyError:
        raise ValueError(f"unknown model_kind {model_kind!r}; available: "
                         f"{sorted(_REGISTRY)}") from None
