"""Training cells of the vocoder with a mixture-of-logistics output:
``Chassis.train``, K steps a call, closed loop.

The program's side is ``loops/train.py``'s (the packed dataset drawn from
the seed, the ``Chassis`` with the benchmark's seeded weights, step 1 as a
call of one step, the K-step program's first call snapshotted before and
after, the window, and with ``--trace`` a profiled call of 2 K steps).
After the window the reference (``reference/mol.py``, plain float32)
follows the same 1 + K steps on the same rows: each step's loss is
``mol.window_loss`` (the mixture's mean NLL over the window's samples,
under the log-mel frames normalised by the dataset's statistics), taken a
row at a time, and the update ``reference/train.Adam``'s.  The numbers
compared are ``loops/train.readings``' (``grad_gap``, ``grad_diff``,
``change_gap``; the model has no codebook).
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import counts, counts_mol, peaks, traffic
from benchmark.counts import _mm
from benchmark.harness import Check, Run
from benchmark.loops import train
from benchmark.reference import data as ref_data
from benchmark.reference import mol
from benchmark.reference import train as ref_train
from benchmark.reference.precision import exact

COMPARED = ("grad_gap", "grad_diff", "change_gap")


def train_step_flops(voc, win, batch: int) -> int:
    """Forward and backward operations of one training step of ``batch``
    windows: the log-mel frontend, the upsampler, the input map, every
    gated layer over its valid rows and the post-net over the loss
    samples, a backward twice the forward."""
    sp, wn = voc.cfg.spec, voc.cfg.wavenet
    n_bins = sp.n_fft // 2 + 1
    fwd = 2 * _mm(win.n_frames, n_bins, sp.win_sz) + _mm(win.n_frames, sp.n_mels, n_bins)
    t_up, cin = win.n_frames, sp.n_mels
    for i, f in enumerate(wn.lc_upsample_filters):
        fwd += _mm(t_up, wn.n_lc_out, cin, f)
        cin, t_up = wn.n_lc_out, win.up_steps[i].keep
    fwd += _mm(win.t_in, wn.n_res, 1)
    t_l = win.t_in
    for dil in mol.dilations(wn):
        t_l -= dil * (wn.filter_sz - 1)
        fwd += 2 * _mm(t_l, 2 * wn.n_dil, wn.n_res) + _mm(t_l, 2 * wn.n_dil, wn.n_lc_out)
        fwd += _mm(t_l, wn.n_res, wn.n_dil) + _mm(win.n_win, wn.n_skp, wn.n_dil)
    fwd += 2 * win.n_win * (counts_mol.step_macs(wn, voc.n_mix) - wn.n_res
                            - len(mol.dilations(wn)) * counts.layer_macs(wn))
    return 3 * fwd * batch


def reference_steps(run: Run, prog_weights: dict, prefix: str, device, q=exact) -> list:
    """The reference's first 1 + K steps on the loader's rows: a record per
    step (``loss``; the first's ``grads``, as Adam took them; the first's
    and the last's ``state``)."""
    voc = mol.with_stats(mol.from_json(run.config_json()), prefix)
    win = mol.window(voc)
    t_cfg = voc.cfg.train
    model = mol.build(voc, prog_weights, device)
    params = dict(model.named_parameters())
    opt = ref_train.Adam(params, t_cfg)
    pk = ref_data.Packed(prefix)
    n = 1 + t_cfg.steps_per_call
    records = []
    for s in range(n):
        for p in params.values():
            p.grad = None
        wav, _ = pk.batch_at(win.u_len, t_cfg.batch_sz, t_cfg.seed, s)
        wav = torch.from_numpy(wav).to(device)
        b = wav.shape[0]
        loss = 0.0
        for r in range(b):
            row = mol.window_loss(model, voc, win, wav[r : r + 1], q)
            (row / b).backward()
            loss += float(row.detach()) / b
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        taken = opt.update(grads)
        rec = {"loss": loss}
        if s == 0:
            rec["grads"] = {k: g.detach().cpu() for k, g in taken.items()}
        if s in (0, n - 1):
            rec["state"] = ref_train.state(model)
        records.append(rec)
    return records


def finish(run: Run, got: dict, w: dict, prefix: str, device) -> None:
    """Counts for the readers; then the reference's steps and the checks."""
    voc = mol.with_stats(mol.from_json(run.config_json()), prefix)
    win = mol.window(voc)
    b = voc.cfg.train.batch_sz
    ops, n_bytes = counts.stack_step(voc.cfg, win, b)
    run.counts = {"step_flops": train_step_flops(voc, win, b), "stack_ops": ops,
                  "stack_bytes": n_bytes}
    t = time.perf_counter()
    gaps = train.readings(got, reference_steps(run, w, prefix, device), None)
    run.window["reference_s"] = time.perf_counter() - t
    traffic.remove_packed(prefix)
    run.checks = [Check(k, gaps[k], run.limits[k]) for k in COMPARED]
    run.window["not_compared"] = {k: v for k, v in gaps.items() if k not in COMPARED}


def run(run: Run) -> None:
    on_card = torch.device(run.device).type == "cuda"
    if on_card:
        run.device_kind = torch.cuda.get_device_name(0)
        run.device_count = 1
        run.peak = peaks.of(run.device_kind)
    prefix = train.write_data(run)
    run.mark("data")
    prog = train.setup(run, prefix)
    run.mark("built")
    got = train.first_steps(prog)
    run.mark("first_steps")
    win = train.timed(run, prog, on_card)
    train.adopt(run, win)
    run.memory_peak_bytes = win["memory_peak_bytes"]
    w = prog.weights
    prog.chassis.close()
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    finish(run, got, w, prefix, w[next(iter(w))].device)
