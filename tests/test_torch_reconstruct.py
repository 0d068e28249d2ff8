"""The reconstruction slice as a whole: the port against what the JAX
package runs on the TPU (encode, prime, then the fused sampler, here in
Pallas interpret mode), plus the port's CLI and checkpoint files."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ae_wavenet_tpu.data.preprocess import make_synthetic_dataset
from ae_wavenet_tpu.models import autoencoder as jae
from ae_wavenet_tpu.models import common as jcommon
from ae_wavenet_tpu.ops import fastgen as jfg
from ae_wavenet_tpu.ops import fastgen_pallas as jfp
from ae_wavenet_tpu.training import torch_compat
from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu.utils.wavio import read_wav
from ae_wavenet_tpu_torch.cli import generate as tcli
from ae_wavenet_tpu_torch.models import autoencoder as tae
from ae_wavenet_tpu_torch.models import common as tcommon
from ae_wavenet_tpu_torch.ops import fastgen as tfg
from ae_wavenet_tpu_torch.ops import fastgen_cuda as tfc
from ae_wavenet_tpu_torch.training import weights
from ae_wavenet_tpu_torch.utils import config as tcfg

# the bf16 sampler tolerance of tests_tpu/test_pallas_tpu.py:236-237
LOGIT_REL_TOL = 0.05


def _cfg():
    base = jcfg.tiny_config()
    return dataclasses.replace(
        base, bottleneck=jcfg.BottleneckConfig(kind="vq", n_dim=16, vq_k=64),
        train=dataclasses.replace(base.train, aux_frame_weight=1.0))


def _jax_model(cfg, seed=0):
    params, bn = jae.init(jax.random.PRNGKey(seed), cfg)
    return params, bn


def test_reconstruct_matches_jax_greedy():
    """Port reconstruct(temperature=0) vs JAX encode + prime_for_generation
    + generate_fused (what _fused_pipeline runs): the same start, ids equal
    over each row's inclusive greedy prefix, logits over that prefix within
    0.05 of max |logits|."""
    cfg = _cfg()
    params, bn = _jax_model(cfg)
    port_cfg = tcfg.from_json(jcfg.to_json(cfg))
    model = weights.from_named(
        torch_compat.flatten_named({"params": params, "bn_state": bn}), port_cfg)
    rng = np.random.default_rng(0)
    t = np.arange(8000) / 16000.0
    wav = (6000 * np.sin(2 * np.pi * 180 * t)[None] * (1 + 0.3 * rng.normal(size=(2, 1)))
           + 800 * rng.normal(size=(2, 8000))).astype(np.int16)
    spk = np.array([1, 3], np.int32)
    n = 24

    prep = jcommon.prime_for_generation(
        jae.encode, params, bn, cfg, jnp.asarray(wav), jnp.asarray(spk),
        jax.random.PRNGKey(0), n)
    cond_gc = jfg._with_gc(params["wavenet"], cfg.wavenet, prep.gen_cond,
                           jnp.asarray(spk))
    want_ids, _, _, want_lg = jfp.generate_fused(
        jfp.pack_for_pallas(params["wavenet"], cfg.wavenet), cfg.wavenet,
        jfp.state_to_flat(prep.state, cfg.wavenet), prep.state.prev_id,
        prep.state.t, cond_gc, jnp.int32(0), temperature=0.0,
        debug_logits=True, interpret=True)
    want_ids, want_lg = np.asarray(want_ids), np.asarray(want_lg)

    wav_t, spk_t = torch.from_numpy(wav), torch.from_numpy(spk).long()
    ids, start = tae.reconstruct(model, port_cfg, wav_t, spk_t, temperature=0.0,
                                 n_samples=n)
    assert start == prep.start
    assert tuple(ids.shape) == want_ids.shape == (2, n)
    # the port's logits, through the same pieces reconstruct runs
    tprep = tcommon.prime_for_generation(tae.encode, model, port_cfg, wav_t, spk_t, n)
    _, _, _, lg = tfc.generate_fused(
        tfc.pack_for_kernel(model.wavenet, port_cfg.wavenet), port_cfg.wavenet,
        tfc.state_to_flat(tprep.state, port_cfg.wavenet), tprep.state.prev_id,
        tprep.state.t, tfg.with_gc(model.wavenet, port_cfg.wavenet,
                                   tprep.gen_cond, spk_t),
        0, temperature=0.0, debug_logits=True)
    scale = np.abs(want_lg).max()
    agree = 0
    for r in range(2):
        diff = np.nonzero(ids[r].numpy() != want_ids[r])[0]
        t_div = int(diff[0]) if len(diff) else n
        agree += t_div
        hi = min(t_div + 1, n)
        rel = np.abs(lg[:hi, r].numpy() - want_lg[:hi, r]).max() / scale
        assert rel < LOGIT_REL_TOL, (r, t_div, rel)
    assert agree >= n  # the comparison covers real steps, not just step 0


def test_cli_serves_a_jax_export(tmp_path):
    """A checkpoint written by JAX's torch_compat.export_torch (with its
    optimizer state, which the port ignores) serves through the port's CLI
    on the CPU and writes a wav."""
    cfg = _cfg()
    params, bn = _jax_model(cfg, seed=1)
    opt = {"mu": jax.tree.map(jnp.zeros_like, params)}
    ckpt = str(tmp_path / "model.pt")
    torch_compat.export_torch(ckpt, 7, {"params": params, "bn_state": bn,
                                        "opt_state": opt}, cfg)
    data = str(tmp_path / "synth")
    make_synthetic_dataset(data, n_clips=2, n_speakers=2, clip_len=(7000, 7500))
    out = str(tmp_path / "out.wav")
    rc = tcli.main(["--ckpt", ckpt, "--data", data, "--clip", "1",
                    "--n-samples", "60", "--device", "cpu", "--out", out])
    assert rc == 0
    x, sr = read_wav(out)
    assert sr == 16000 and len(x) == 60
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main(["--ckpt", ckpt, "--data", data, "--device", "cpu",
                   "--int8", "--out", out])


def test_port_export_imports_into_jax(tmp_path):
    """save_export -> JAX import_torch gives back the port's values under
    the reference's tree, and load_export returns them to the port."""
    cfg = _cfg()
    port_cfg = tcfg.from_json(jcfg.to_json(cfg))
    model = tae.init(port_cfg, torch.Generator().manual_seed(3))
    path = str(tmp_path / "port.pt")
    weights.save_export(path, model, port_cfg, 11)
    ref_params, ref_bn = _jax_model(cfg)
    step, tree, cfg2 = torch_compat.import_torch(
        path, {"params": ref_params, "bn_state": ref_bn})
    assert step == 11 and cfg2 == cfg
    named = torch_compat.flatten_named(tree)
    state = model.state_dict()
    assert len(named) == len(state)
    np.testing.assert_array_equal(named["params.wavenet.layers.2.w_cond.w"],
                                  state["wavenet.layers.2.w_cond.w"].numpy())
    np.testing.assert_array_equal(named["bn_state.codebook"],
                                  state["bottleneck.codebook"].numpy())
    step, back, _ = weights.load_export(path)
    assert step == 11
    for k, v in back.state_dict().items():
        assert torch.equal(v, state[k]), k
