"""The gated kernels against their plain versions: the whole stack's run,
its tolerances and comparisons, and planted faults (not a test module).

Used by tests/test_torch_cuda.py on the card and tests/test_torch_gated.py
on the CPU.  The seeded stacks, each kernel's inputs (``random_stack``,
``segment_inputs``, ``segment_calls``) and the per-kernel tolerances
(``segment_tolerance``) live in ``chip_smoke.py``, which times the kernels
on the same inputs and holds its readings to the same tolerances.

Whole stack: logits within LOGIT_ABS_TOL and every gradient within
GRAD_REL_TOL of the largest, as ``tests/test_gated_pallas.py:48,131`` hold
the Pallas stack.  The whole-stack forward is many layers deep in one
kernel, so it is held twice: every layer of it against the plain layer on
the kernel's own input stream at ``chip_smoke.SEGMENT_REL_TOL``
(:func:`stack_layerwise`), and every output against the plain version run
from x0 at ``chip_smoke.DRIFT_REL_TOL``.
"""

from __future__ import annotations

import copy
from unittest import mock

import torch

from ae_wavenet_tpu_torch.ops import gated
from ae_wavenet_tpu_torch.ops.gated_cuda import TM
from chip_smoke import skip0

LOGIT_ABS_TOL = 0.02
GRAD_REL_TOL = 0.05


def stack_layerwise(got, dils, cond_tm, packed, x0, skip_seed: int = 1):
    """What the plain layer gives on the input stream that the whole-stack
    kernel itself produced: from ``got`` = (skip, L - 1 mids, L ys) of the
    ``gated_stack_fused`` case, the same tuple with layer l computed from
    got's mid l - 1, and the skip as the sum of those layers' terms."""
    n = len(dils)
    mids = got[1:n]
    skip = skip0(x0, packed, skip_seed)
    outs_x, outs_y = [], []
    for l in range(n):
        x_new, _, y = gated.gated_layer_fused_reference(
            x0 if l == 0 else mids[l - 1], cond_tm, skip, *packed[l], dd=dils[l],
            r0=gated.valid_lo(dils, 0), save_y=True)
        outs_x.append(x_new)
        outs_y.append(y)
    return (skip, *outs_x[:-1], *outs_y)


# ------------------------------------------------------------ the stack

def stack_run(wn, cfg, ids, cond, spk, probe, ops, save_y, fuse_pairs,
              full_fusion=False, bwd_group=0):
    """Logits [B, T, Q] (f32) and every gradient (wavenet parameters and
    cond) of mean(logits * probe) through the fused stack."""
    wn.zero_grad(set_to_none=True)
    c = cond.detach().clone().requires_grad_(True)
    logits = gated.stack_apply(wn, cfg, ids, c, spk, btq=True, ops=ops,
                               save_y=save_y, fuse_pairs=fuse_pairs,
                               full_fusion=full_fusion, bwd_group=bwd_group)
    (logits.float() * probe).mean().backward()
    grads = {n: p.grad.detach().clone() for n, p in wn.named_parameters()
             if p.grad is not None}
    grads["cond"] = c.grad.detach().clone()
    return logits.detach().float(), grads


def stack_errors(lg_k, g_k, lg_p, g_p) -> tuple[float, float]:
    """(max |logit diff|, max |grad diff| / max |plain grad|) over all
    gradient tensors together."""
    if set(g_k) != set(g_p):
        raise AssertionError(f"gradient sets differ: {sorted(set(g_k) ^ set(g_p))}")
    lg = float((lg_k - lg_p).abs().max())
    num = max(float((g_k[n].float() - g_p[n].float()).abs().max()) for n in g_p)
    den = max(float(g_p[n].float().abs().max()) for n in g_p)
    return lg, num / den


def stack_passes(lg: float, rel: float) -> bool:
    return lg < LOGIT_ABS_TOL and rel < GRAD_REL_TOL


def planted_faults(wn, cfg):
    """{name: (wavenet, ops, schedule keywords of ``stack_run``)}: plain
    versions with a fault planted, which the stack check must reject.  Layer
    10's skip dropped; in the pair of stack layers 2 and 3, the pair's layer
    2 reading its prev tap (mid, the rows the kernel carries across tiles)
    one row off; inside the whole-stack forward, layer 7's prev tap one row
    off."""
    l_skip = min(10, len(wn.layers) - 1)
    wn_bad = copy.deepcopy(wn)
    with torch.no_grad():
        wn_bad.layers[l_skip].w_skip["w"].zero_()
        wn_bad.layers[l_skip].w_skip["b"].zero_()
    dils = gated.stack_dils(cfg)
    r0_bad = gated.valid_lo(dils, 2)

    def pair_off(x, cond, skip, pk1, pk2, *, dd1, dd2, r0, save_y=False):
        if r0 == r0_bad:
            dd2 = dd2 + 1
        return gated.gated_pair_fused_reference(x, cond, skip, pk1, pk2, dd1=dd1,
                                                dd2=dd2, r0=r0, save_y=save_y)

    l_tap = min(7, len(dils) - 1)

    def stack_off(x, cond, skip, packed, *, dils, r0, save_y=False, save_mids=True):
        bad = tuple(d + (i == l_tap) for i, d in enumerate(dils))
        return gated.gated_stack_fused_reference(
            x, cond, skip, packed, dils=bad, r0=r0, save_y=save_y,
            save_mids=save_mids)

    pairs, fused = {"full_fusion": False}, {"full_fusion": True}
    return {f"layer {l_skip} skip dropped": (wn_bad, gated.PLAIN, pairs),
            "pair (2, 3): layer 2's prev tap one row off":
                (wn, gated.PLAIN._replace(pair_fwd=pair_off), pairs),
            f"whole stack: layer {l_tap}'s prev tap one row off":
                (wn, gated.PLAIN._replace(stack_fwd=stack_off), fused)}


def planted_segment_faults() -> dict:
    """{name: (segment of ``segment_calls``, faulty plain version)}, which
    that segment's check must reject.  The pair forward and the pair
    backward with layer 2's dilation one row off (the prev tap that the
    kernels mask and carry across tiles and chunks themselves).  The grouped
    backward with every boundary between two layers of the group losing the
    prev-tap cotangent of the rows whose source lies in another tile: what
    the kernel hands over between blocks through global memory.  (It moves
    the whole stack's gradients by under GRAD_REL_TOL of the largest, so it
    is held against the kernel's own outputs.)  The single-layer backward's
    recompute mode with b_in dropped from the y it recomputes (the bias
    that its gate pass adds to the accumulator).  The pair backward (the
    pair below one tile's reach) with layer 1 reading none of the prev-tap
    cotangents that layer 2 wrote from the tile just above: what a layer 1
    tile that ran before the other tile in flight had stored them would
    give.  The pair forward (the pair below one tile's reach) with layer 2
    reading zeros for the rows of mid that layer 1 stored from its own tile:
    what it reads before those bulk stores have completed.  The pair forward
    with the incoming skip rows lost (its skip terms added to zeros): what
    it adds to before the tile's skip rows have landed."""
    inner_upstream = gated._inner_upstream
    shift_down = gated._shift_down

    def dropped(keep):
        def upstream(gxn, g_xin, n_res, dd_up):
            # row r's prev-tap cotangent feeds row r - dd_up of the layer below
            r = torch.arange(g_xin.shape[1], device=g_xin.device)
            src, dst = r // TM, (r - dd_up) // TM
            prev = torch.where(keep(src, dst)[None, :, None], g_xin[..., :n_res], 0.0)
            return inner_upstream(gxn, torch.cat([prev, g_xin[..., n_res:]], -1),
                                  n_res, dd_up)
        return upstream

    def patched(reference, keep):
        def run(*args, **kw):
            with mock.patch.object(gated, "_inner_upstream", dropped(keep)):
                return reference(*args, **kw)
        return run

    group_no_carry = patched(gated.gated_group_bwd_reference,
                             lambda src, dst: src == dst)
    pair_no_carry = patched(gated.gated_pair_bwd_reference,
                            lambda src, dst: src != dst + 1)

    def pair_fwd_off(*args, dd2, **kw):
        return gated.gated_pair_fused_reference(*args, dd2=dd2 + 1, **kw)

    def pair_bwd_off(*args, dd2, **kw):
        return gated.gated_pair_bwd_reference(*args, dd2=dd2 + 1, **kw)

    def pair_fwd_stale_mid(*args, **kw):
        taps = []

        def shift(x, d, lo, hi):
            # the second shift is layer 2's prev tap, from mid; tiles from lo
            out = shift_down(x, d, lo, hi)
            taps.append(d)
            if len(taps) == 2:
                g = torch.arange(lo, hi, device=x.device)
                same = (g - d >= lo) & ((g - d - lo) // TM == (g - lo) // TM)
                out = torch.where(same[None, :, None], torch.zeros_like(out), out)
            return out

        with mock.patch.object(gated, "_shift_down", shift):
            return gated.gated_pair_fused_reference(*args, **kw)

    def pair_fwd_skip_unloaded(x, cond, skip, pk1, pk2, **kw):
        return gated.gated_pair_fused_reference(x, cond, torch.zeros_like(skip), pk1,
                                                pk2, **kw)

    def layer_bwd_no_bias(x, cond, gxcur, gxprev, gskip, gcond, w_in, w_out, b_in,
                          **kw):
        return gated.gated_layer_bwd_reference(x, cond, gxcur, gxprev, gskip, gcond,
                                               w_in, w_out, torch.zeros_like(b_in),
                                               **kw)

    return {"pair forward: layer 2's prev tap one row off":
            ("gated_pair_fused", pair_fwd_off),
            "pair backward: layer 2's prev tap one row off":
            ("gated_pair_bwd", pair_bwd_off),
            "grouped backward: prev-tap cotangents from another tile dropped":
            ("gated_group_bwd", group_no_carry),
            "pair backward: layer 1 before the tile above's prev-tap stores":
            ("gated_pair_bwd_near", pair_no_carry),
            "single-layer backward, recompute mode: b_in dropped from y":
            ("gated_layer_bwd_recompute", layer_bwd_no_bias),
            "pair forward: layer 2 reads mid before layer 1's bulk stores complete":
            ("gated_pair_fused_near", pair_fwd_stale_mid),
            "pair forward: skip terms added before the skip rows landed":
            ("gated_pair_fused", pair_fwd_skip_unloaded)}
