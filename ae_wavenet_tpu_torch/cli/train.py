"""CLI: training, with the reference's two-phase contract.

``new`` takes the architecture and training flags (and the reference's
presets); ``resume`` reloads the config stored in the latest checkpoint and
only takes runtime overrides, so the architecture cannot drift.

    python -m ae_wavenet_tpu_torch.cli.train new --preset chorowski \\
        --pallas-stack --data PREFIX --ckpt-dir DIR [--device cuda] ...
    python -m ae_wavenet_tpu_torch.cli.train resume --ckpt-dir DIR --data PREFIX

Checkpoints are export files ``DIR/step_XXXXXXXX.pt`` with ``LATEST`` and
``BEST`` pointers beside them; ``--ckpt-keep N`` keeps the newest N, the
best-holdout one and the one ``LATEST`` names.  ``--profile-steps N
--profile-dir DIR`` traces the first N steps.  ``--tb-logdir DIR`` also
writes every metric as a TensorBoard scalar (it needs the ``tensorboard``
package and says so when it is missing).  ``--model mfcc_inverter`` trains
the vocoder baseline (upsample strides (5, 4, 4, 2)); ``--frame-norm
dataset`` computes the dataset's frame statistics once and keeps them in
the config, so every checkpoint carries them.  Flags of the reference left
out until their modules are ported (ROADMAP.md): ``--mesh`` and
``--distributed`` (and its ``--coordinator``/``--num-processes``/
``--process-id``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from ae_wavenet_tpu_torch.utils import config as config_mod


def _int_tuple(s: str) -> tuple:
    return tuple(int(x) for x in s.split(",") if x)


def _float_tuple(s: str) -> tuple:
    return tuple(float(x) for x in s.split(",") if x)


def _add_runtime_flags(p):
    p.add_argument("--data", required=True, help="packed dataset prefix")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--n-steps", type=int, default=None)
    p.add_argument("--log-every", type=int, default=None)
    p.add_argument("--ckpt-every", type=int, default=None)
    p.add_argument("--ckpt-keep", type=int, default=None,
                   help="keep-last-N retention: prune all but the newest N "
                        "checkpoints after each save (the best-holdout one "
                        "and LATEST's are always kept; 0 keeps every one)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="run Chassis.evaluate() every N steps (0 = off)")
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="K > 1: each loader item carries K steps (n-steps "
                        "must be a multiple of K); metrics are the last step's")
    p.add_argument("--nan-checks", action="store_true",
                   help="verify metrics and params are finite at every log "
                        "point and raise at the first non-finite step")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="trace the first N steps with torch.profiler "
                        "(requires --profile-dir)")
    p.add_argument("--profile-dir", default=None,
                   help="where the Chrome trace goes (trace.json)")
    p.add_argument("--tb-logdir", default=None,
                   help="also write the metrics as TensorBoard scalars here")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when there is no card")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ae-wavenet-tpu-torch-train",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="mode", required=True)
    new = sub.add_parser("new", help="start a fresh run")
    _add_runtime_flags(new)
    new.add_argument("--preset", default="full", choices=sorted(config_mod.PRESETS))
    new.add_argument("--model", choices=["autoencoder", "mfcc_inverter"],
                     default="autoencoder")
    new.add_argument("--bottleneck", choices=["ae", "vae", "vq", "zero"], default=None)
    for flag in ("n-quant", "n-res", "n-dil", "n-skp", "n-post", "n-blocks",
                 "n-block-layers", "bn-dim", "vq-k", "vq-groups", "n-speakers",
                 "kl-anneal-steps", "vq-warmup-steps", "n-lc-out",
                 "n-global-embed", "batch-sz", "n-win", "holdout-every", "seed",
                 "gated-tile", "gated-bwd-tile", "gated-bwd-group",
                 "fastgen-vmem-dil-max"):
        new.add_argument(f"--{flag}", type=int, default=None)
    for flag in ("jitter-p", "free-nats", "ema-decay", "vq-beta",
                 "vq-restart-thresh", "learning-rate", "weight-decay",
                 "aux-frame-weight", "grad-clip"):
        new.add_argument(f"--{flag}", type=float, default=None)
    new.add_argument("--vq-use-pallas", action="store_true", default=None,
                     help="the fused VQ lookup (a CUDA kernel on the card; "
                          "vq_groups = 1)")
    new.add_argument("--lc-upsample-strides", type=_int_tuple, default=None)
    new.add_argument("--lc-upsample-filters", type=_int_tuple, default=None)
    new.add_argument("--lr-boundaries", type=_int_tuple, default=None)
    new.add_argument("--lr-values", type=_float_tuple, default=None)
    new.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default=None)
    new.add_argument("--frame-norm", choices=["window", "dataset"], default=None)
    new.add_argument("--pallas-stack", action="store_true", default=None,
                     help="the fused gated stack (CUDA kernels on the card; "
                          "bf16)")
    new.add_argument("--no-gated-save-y", dest="gated_save_y",
                     action="store_false", default=None,
                     help="recompute the gate pre-activations in the backward")
    new.add_argument("--no-gated-fuse-pairs", dest="gated_fuse_pairs",
                     action="store_false", default=None,
                     help="one layer per kernel instead of pairs")
    new.add_argument("--gated-full-fusion", action="store_true", default=None,
                     help="every gated layer's forward in one kernel launch")
    res = sub.add_parser("resume", help="resume from the latest checkpoint")
    _add_runtime_flags(res)
    res.add_argument("--step", type=int, default=None, help="checkpoint step")
    res.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                     default=None)
    return p


def _over(dc, **kv):
    kv = {k: v for k, v in kv.items() if v is not None}
    return dataclasses.replace(dc, **kv) if kv else dc


def config_from_args(a) -> config_mod.RunConfig:
    """The reference's ``config_from_args`` (``cli/train.py:183``)."""
    cfg = config_mod.PRESETS[a.preset]()
    wn, bn, tr, enc = cfg.wavenet, cfg.bottleneck, cfg.train, cfg.encoder
    if a.frame_norm is not None:
        cfg = dataclasses.replace(cfg, spec=dataclasses.replace(cfg.spec,
                                                                norm=a.frame_norm))
    if a.pallas_stack:
        wn = dataclasses.replace(wn, use_pallas_stack=True)
    wn = _over(wn, n_quant=a.n_quant, n_res=a.n_res, n_dil=a.n_dil, n_skp=a.n_skp,
               n_post=a.n_post, n_blocks=a.n_blocks,
               n_block_layers=a.n_block_layers, n_speakers=a.n_speakers,
               n_lc_out=a.n_lc_out, n_global_embed=a.n_global_embed,
               lc_upsample_strides=a.lc_upsample_strides,
               lc_upsample_filters=a.lc_upsample_filters,
               gated_tile=a.gated_tile, gated_bwd_tile=a.gated_bwd_tile,
               gated_save_y=a.gated_save_y, gated_fuse_pairs=a.gated_fuse_pairs,
               gated_full_fusion=a.gated_full_fusion,
               gated_bwd_group=a.gated_bwd_group,
               fastgen_vmem_dil_max=a.fastgen_vmem_dil_max)
    if a.lc_upsample_strides is not None and a.lc_upsample_filters is None:
        wn = dataclasses.replace(
            wn, lc_upsample_filters=tuple(2 * s for s in a.lc_upsample_strides))
    bn = _over(bn, kind=a.bottleneck, n_dim=a.bn_dim, vq_k=a.vq_k,
               vq_groups=a.vq_groups, jitter_p=a.jitter_p, free_nats=a.free_nats,
               kl_anneal_steps=a.kl_anneal_steps, ema_decay=a.ema_decay,
               vq_beta=a.vq_beta, vq_restart_thresh=a.vq_restart_thresh,
               vq_use_pallas=a.vq_use_pallas, vq_warmup_steps=a.vq_warmup_steps)
    if a.bn_dim is not None:
        enc = dataclasses.replace(enc, n_out=a.bn_dim)
        wn = dataclasses.replace(wn, n_lc_in=a.bn_dim)
    if a.lr_boundaries is not None or a.lr_values is not None:
        lb = a.lr_boundaries if a.lr_boundaries is not None else tr.lr_boundaries
        lv = a.lr_values if a.lr_values is not None else tr.lr_values
        if len(lv) != len(lb) + 1:
            raise SystemExit(f"--lr-values needs len(--lr-boundaries)+1 entries "
                             f"(got {len(lv)} values for {len(lb)} boundaries)")
        tr = dataclasses.replace(tr, lr_boundaries=lb, lr_values=lv)
    tr = _over(tr, batch_sz=a.batch_sz, n_win=a.n_win, learning_rate=a.learning_rate,
               grad_clip=a.grad_clip, weight_decay=a.weight_decay,
               holdout_every=a.holdout_every, seed=a.seed,
               compute_dtype=a.compute_dtype, aux_frame_weight=a.aux_frame_weight)
    if a.model == "mfcc_inverter":
        wn = dataclasses.replace(wn, lc_upsample_strides=(5, 4, 4, 2),
                                 lc_upsample_filters=(10, 8, 8, 4))
    return dataclasses.replace(cfg, wavenet=wn, bottleneck=bn, train=tr,
                               encoder=enc, model_kind=a.model)


def check_schedule(cfg: config_mod.RunConfig) -> None:
    """Refuse, before anything is built, a fused-stack schedule that does
    not apply (``ops/gated.check_schedule``)."""
    from ae_wavenet_tpu_torch.ops import gated

    if cfg.wavenet.use_pallas_stack:
        gated.check_schedule(cfg.wavenet)


def setup(argv=None):
    """Parse, set the numerics and build the config: -> (args, cfg)."""
    from ae_wavenet_tpu_torch.utils.precision import set_reference_precision

    set_reference_precision()
    a = build_parser().parse_args(argv)
    from ae_wavenet_tpu_torch.training import checkpoint as ckpt_mod

    if a.profile_steps > 0 and not a.profile_dir:
        raise SystemExit("--profile-steps requires --profile-dir")
    if a.mode == "new":
        cfg = config_from_args(a)
    else:
        if not a.ckpt_dir:
            raise SystemExit("resume requires --ckpt-dir")
        try:
            cfg = ckpt_mod.load_config(a.ckpt_dir, a.step)[1]
        except FileNotFoundError as e:
            raise SystemExit(str(e))
    cfg = dataclasses.replace(cfg, train=_over(
        cfg.train, n_steps=a.n_steps, log_every=a.log_every,
        ckpt_every=a.ckpt_every, ckpt_keep=a.ckpt_keep,
        steps_per_call=a.steps_per_call,
        compute_dtype=getattr(a, "compute_dtype", None)))
    check_schedule(cfg)
    return a, cfg


def main(argv=None) -> int:
    a, cfg = setup(argv)
    import torch

    from ae_wavenet_tpu_torch.training.chassis import Chassis

    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    ch = Chassis(cfg, a.data, ckpt_dir=a.ckpt_dir, device=device,
                 nan_checks=a.nan_checks, profile_dir=a.profile_dir,
                 profile_steps=a.profile_steps, tb_logdir=a.tb_logdir)
    if a.mode == "resume":
        ch.resume(a.step)
        print(f"resumed at step {ch.step}")
    print(config_mod.to_json(ch.cfg))  # with the dataset statistics, if computed
    ch.train(cfg.train.n_steps, eval_every=a.eval_every)
    if ch.profile_summary:
        print(json.dumps({"profile": ch.profile_summary}))
    if a.ckpt_dir:
        print(f"saved {ch.save()}")
    ch.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
