"""Training curves of the port against the JAX package, on the CPU in f32.

The tiny preset with a VQ bottleneck, made draw-free (jitter 0, restart
threshold 0, so no step takes a random draw): both packages start from the
same weights (the JAX init, exported with ``export_torch`` and resumed by
the port at step 0) and see the same windows (the counter-based sampler),
then train with their own step, optimizer and loop.

Tolerance.  ``tests/test_torch_train.py`` holds two resumed steps to atol
1e-3 of recon CE, and 200 steps keep it: the two f32 implementations drift
apart (other reduction orders, fed back through Adam and the EMA codebook)
by 1.4e-6 over the first 20 steps and 1.5e-4 over 200, measured here on
the CPU, on a curve that falls from 5.545 to 5.229.  About 25 s.
"""

import dataclasses
import io

import numpy as np

from ae_wavenet_tpu.data.preprocess import make_synthetic_dataset
from ae_wavenet_tpu.training import chassis as jch
from ae_wavenet_tpu.training import torch_compat
from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu_torch.training import chassis as tch
from ae_wavenet_tpu_torch.training import checkpoint as tckpt
from ae_wavenet_tpu_torch.utils import config as tcfg

CURVE_ATOL = 1e-3
N_STEPS = 200


def _curves(tmp_path, n_steps):
    prefix = str(tmp_path / "synth")
    make_synthetic_dataset(prefix, n_clips=8, n_speakers=4, clip_len=(9000, 14000),
                           seed=0)
    base = jcfg.tiny_config()
    cfg = dataclasses.replace(
        base,
        bottleneck=jcfg.BottleneckConfig(kind="vq", n_dim=16, vq_k=64, jitter_p=0.0,
                                         vq_restart_thresh=0.0),
        train=dataclasses.replace(base.train, n_steps=n_steps, log_every=1,
                                  aux_frame_weight=1.0))
    ja = jch.Chassis(cfg, prefix, log_stream=io.StringIO())
    tree = {"params": ja.params, "opt_state": ja.opt_state, "bn_state": ja.bn_state}
    ckpt = str(tmp_path / "ck")
    (tmp_path / "ck").mkdir()
    torch_compat.export_torch(tckpt.checkpoint_path(ckpt, 0), 0, tree, cfg)
    want = [h["recon_ce"] for h in ja.train(n_steps)]
    ja.close()
    port = tch.Chassis(tcfg.from_json(jcfg.to_json(cfg)), prefix, ckpt_dir=ckpt,
                       device="cpu", log_stream=io.StringIO())
    assert port.resume() == 0
    got = [h["recon_ce"] for h in port.train(n_steps)]
    return np.asarray(got), np.asarray(want)


def test_recon_ce_curve_matches_jax_over_200_steps(tmp_path):
    got, want = _curves(tmp_path, N_STEPS)
    assert len(got) == len(want) == N_STEPS and np.isfinite(got).all()
    assert want[-1] < want[0] - 0.2  # the curve moves: the comparison says something
    np.testing.assert_allclose(got, want, atol=CURVE_ATOL, rtol=0)
