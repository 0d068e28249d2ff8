"""The fused gated stack for training: schedule, autograd and plain versions.

Counterpart of ``ae_wavenet_tpu/ops/gated_pallas.py``: ``pack_stack_weights``
(``:78``), ``stack_apply`` (``:558``) and the custom VJP ``_stack_core``
(``:1335``), plus plain PyTorch versions of the six kernels the stack runs
(``gated_layer_fused`` ``:105``, ``gated_pair_fused`` ``:217``,
``gated_stack_fused`` ``:355``, ``gated_layer_bwd`` ``:643``,
``gated_pair_bwd`` ``:859``, ``gated_group_bwd`` ``:1095``).  The kernels
themselves are ``csrc/gated.cu``, wrapped by ``ops/gated_cuda.py``.

Layout.  Time-major [B, P, C] buffers with P = t_in rows; layer i's valid
output rows are [vl_i, P) with vl_i = dils[0] + ... + dils[i] (its output
lattice right-aligned, as in the reference's frame).  Row g of every
buffer (x, cond, skip, y, cotangents) is input position g, so the taps of
layer i at output row g read x[g - dd_i] and x[g].  The Pallas frame's
top padding, 128-lane channel padding and 16-row halo rounding are Mosaic
constraints and are dropped: cond keeps its n_lc_out + n_global_embed
channels.

The contract, down to the rounding points, which the plain versions and
the kernels both follow.  Forward, per layer, on rows [r0, P):

    xin = [x[g-dd] | x[g] | cond[g]]                  bf16
    y   = xin @ bf16(w_in) + b_in                     f32 accumulation
    h   = bf16(tanh(y_f) * sigmoid(y_g))             from the f32 y
    out = h @ bf16(w_out) + b_out                     f32
    x'  = bf16(x[g] + bf16(out_res));  skip += out_skip (f32)

y is saved in bf16; rows below r0 of every output hold zeros.  The
single-layer forward has a second, non-causal mode with three taps
(WaveGlow's layers: ``cond`` None, w_in [3 n_res, 2 n_dil]), on every row:

    xin = [x[g-dd] | x[g] | x[g+dd]]                  zero outside [0, P)
    y   = xin @ bf16(w_in) + b_in + f32(addend[g])    addend [B, P, 2 n_dil] bf16

and the rest as above, with no y saved.  A pair runs
layer 2 on the same rows, its prev tap reading mid[g - dd2] (zero below
r0), and adds both layers' skip terms in order.  Backward, per layer:

    h     = bf16(tanh(y_f) * sigmoid(y_g))           from the bf16 saved y
    g_out = bf16([gxn | gskip]),  masked to the layer's valid rows
    g_h   = g_out @ w_out^T;  g_y = bf16([g_h s (1-t^2) | g_h t s (1-s)])
    g_xin = g_y @ w_in^T (f32);  dW_in = xin^T g_y, dW_out = h^T g_out (f32)
    gxcur' = bf16(gxn + g_xin_cur), gxprev' = bf16(g_xin_prev) at row g

where gxn = gxcur[g] (rows >= the producer's cur_valid_lo) + gxprev[g +
prev_dd] (rows with g + prev_dd < P), and gcond accumulates g_xin_cond in
f32.  Inside a pair, layer 2's cotangent to layer 1 stays f32.

The whole-stack forward (``gated_full_fusion``) runs every layer on rows
[vl_0, P), the pair's rule extended to all layers, so rows [vl_0, vl_i) of
mid_i and y_i hold values where the pair path leaves zeros; every backward
masks them by the layer's own vl_i.  The grouped backward
(``gated_bwd_group`` >= 3, saved y only) is the pair backward from 2 to G
layers: each layer masked to its own lattice, every cotangent between two
layers of the group in f32.  The TPU kernels carry rows between time tiles
in on-chip scratch, walking a batch row's tiles in order; the CUDA kernels
walk the layers in order instead, all tiles of a layer before the next
layer, and hand rows to neighbouring tiles through global memory behind a
barrier across the grid (``csrc/gated.cu``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ae_wavenet_tpu_torch.models.wavenet import embed_input
from ae_wavenet_tpu_torch.ops.fastgen import with_gc
from ae_wavenet_tpu_torch.utils.config import WaveNetConfig

BF16 = torch.bfloat16


def pack_stack_weights(wavenet, cfg: WaveNetConfig) -> list:
    """Per layer (w_in [2*n_res + n_cond, 2*n_dil], b_in [2*n_dil],
    w_out [n_dil, n_res + n_skp], b_out [n_res + n_skp]), all f32 and
    differentiable in the layer's parameters; cond rows unpadded."""
    packed = []
    for layer in wavenet.layers:
        w_in = torch.cat([layer.w_prev["w"], layer.w_cur["w"],
                          layer.w_cond["w"]], 1).t()
        b_in = layer.w_prev["b"] + layer.w_cur["b"] + layer.w_cond["b"]
        w_out = torch.cat([layer.w_res["w"], layer.w_skip["w"]], 0).t()
        b_out = torch.cat([layer.w_res["b"], layer.w_skip["b"]])
        packed.append((w_in, b_in, w_out, b_out))
    return packed


def stack_dils(cfg: WaveNetConfig) -> tuple:
    return tuple(d * (cfg.filter_sz - 1) for d in cfg.dilations)


def valid_lo(dils: tuple, i: int) -> int:
    """First valid output row of layer i (its input is layer i-1's
    output; the stack's input x0 is valid from row 0)."""
    return sum(dils[: i + 1])


# ---------------------------------------------------------- plain versions

def _shift_down(x: torch.Tensor, d: int, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo - d, hi - d) of x [B, P, C], zero where the index is < 0."""
    if lo - d >= 0:
        return x[:, lo - d : hi - d]
    return F.pad(x, (0, 0, d, 0))[:, lo:hi]


def _shift_up(x: torch.Tensor, d: int, lo: int) -> torch.Tensor:
    """Rows [lo + d, P + d) of x [B, P, C], zero where the index is >= P."""
    return F.pad(x, (0, 0, 0, d))[:, lo + d :]


def _gate(y: torch.Tensor):
    yf, yg = y.chunk(2, -1)
    tf, sg = torch.tanh(yf), torch.sigmoid(yg)
    return tf, sg, (tf * sg).to(BF16)


def _fwd_rows(x_prev, x_cur, cond, skip_rows, w_in, b_in, w_out, b_out, addend=None):
    """One layer on a block of rows: returns (x' bf16, y f32) and adds the
    skip term into ``skip_rows`` in place.  ``cond``: the third part of xin
    (the next tap in the three-tap mode, which adds ``addend`` to y)."""
    n_res = x_cur.shape[-1]
    xin = torch.cat([x_prev, x_cur, cond], -1).float()
    y = xin @ w_in.to(BF16).float() + b_in
    if addend is not None:
        y = y + addend.float()
    _, _, h = _gate(y)
    out = h.float() @ w_out.to(BF16).float() + b_out
    skip_rows += out[..., n_res:]
    return (x_cur.float() + out[..., :n_res].to(BF16).float()).to(BF16), y


def gated_layer_fused_reference(x, cond, skip, w_in, b_in, w_out, b_out, *,
                                dd: int, r0: int, save_y: bool = False, addend=None):
    """Plain version of the single-layer forward (``gated_layer_fused``).

    x [B, P, n_res] bf16, cond [B, P, n_cond] bf16, skip [B, P, n_skp] f32
    (updated in place).  Computes rows [r0, P).  Returns (x', skip) and,
    with ``save_y``, y [B, P, 2*n_dil] bf16.  ``cond`` None: the three-tap
    mode (r0 = 0, w_in [3 n_res, 2 n_dil], ``addend`` [B, P, 2 n_dil] bf16
    or None)."""
    gated_layer_fused_reference.launches += 1
    p_len = x.shape[1]
    if cond is None:
        if r0 or save_y:
            raise ValueError("the three-tap mode runs every row and saves no y")
        cond = _shift_up(x, dd, 0)
    elif addend is not None:
        raise ValueError("the addend is the three-tap mode's")
    x_new = torch.zeros_like(x)
    x_new[:, r0:], y = _fwd_rows(_shift_down(x, dd, r0, p_len), x[:, r0:],
                                 cond[:, r0:], skip[:, r0:], w_in, b_in,
                                 w_out, b_out, addend)
    if not save_y:
        return x_new, skip
    y_out = x.new_zeros(*x.shape[:2], y.shape[-1])
    y_out[:, r0:] = y.to(BF16)
    return x_new, skip, y_out


def gated_pair_fused_reference(x, cond, skip, pk1, pk2, *, dd1: int, dd2: int,
                               r0: int, save_y: bool = False):
    """Plain version of the two-layer forward (``gated_pair_fused``): both
    layers on rows [r0, P); layer 2's prev tap reads mid[g - dd2], zero
    below r0.  Returns (mid, x', skip) and, with ``save_y``, (y1, y2)."""
    gated_pair_fused_reference.launches += 1
    p_len = x.shape[1]
    mid = torch.zeros_like(x)
    mid[:, r0:], y1 = _fwd_rows(_shift_down(x, dd1, r0, p_len), x[:, r0:],
                                cond[:, r0:], skip[:, r0:], *pk1)
    x_new = torch.zeros_like(x)
    x_new[:, r0:], y2 = _fwd_rows(_shift_down(mid, dd2, r0, p_len), mid[:, r0:],
                                  cond[:, r0:], skip[:, r0:], *pk2)
    if not save_y:
        return mid, x_new, skip
    ys = []
    for y in (y1, y2):
        y_out = x.new_zeros(*x.shape[:2], y.shape[-1])
        y_out[:, r0:] = y.to(BF16)
        ys.append(y_out)
    return (mid, x_new, skip, *ys)


def gated_stack_fused_reference(x, cond, skip, packed, *, dils, r0: int,
                                save_y: bool = False, save_mids: bool = True):
    """Plain version of the whole-stack forward (``gated_stack_fused``):
    every layer on rows [r0, P), r0 = valid_lo(dils, 0); each layer's prev
    tap reads the layer below's output at g - dd, zero below r0; the skip
    terms add into the incoming ``skip`` (in place) in layer order.  Returns
    (skip, mids, ys): the L - 1 streams between layers (none with
    ``save_mids=False``) and, with ``save_y`` and ``save_mids``, the L
    saved y; rows below r0 of each hold zeros."""
    gated_stack_fused_reference.launches += 1
    p_len = x.shape[1]
    cur, mids, ys = x, [], []
    for l, (pk, dd) in enumerate(zip(packed, dils)):
        nxt = torch.zeros_like(x)
        nxt[:, r0:], y = _fwd_rows(_shift_down(cur, dd, r0, p_len), cur[:, r0:],
                                   cond[:, r0:], skip[:, r0:], *pk)
        if save_y and save_mids:
            y_out = x.new_zeros(*x.shape[:2], y.shape[-1])
            y_out[:, r0:] = y.to(BF16)
            ys.append(y_out)
        if save_mids and l + 1 < len(dils):
            mids.append(nxt)
        cur = nxt
    return skip, tuple(mids), tuple(ys)


def _bwd_rows(xin, y, gxn, gsk, w_in, w_out):
    """Backward of one layer on a block of rows given its masked operands:
    xin bf16, y f32, gxn f32, gsk f32.  Returns (g_xin f32, dW_in, db_in,
    dW_out, db_out)."""
    tf, sg, h = _gate(y)
    g_out = torch.cat([gxn, gsk], -1).to(BF16)
    g_h = g_out.float() @ w_out.to(BF16).float().t()
    n_dil = tf.shape[-1]
    g_y = torch.cat([g_h[..., :n_dil] * sg * (1.0 - tf * tf),
                     g_h[..., :n_dil] * tf * sg * (1.0 - sg)], -1).to(BF16)
    g_xin = g_y.float() @ w_in.to(BF16).float().t()
    xin2, gy2 = xin.reshape(-1, xin.shape[-1]).float(), g_y.reshape(-1, g_y.shape[-1]).float()
    h2, go2 = h.reshape(-1, h.shape[-1]).float(), g_out.reshape(-1, g_out.shape[-1]).float()
    return g_xin, xin2.t() @ gy2, gy2.sum(0), h2.t() @ go2, go2.sum(0)


def _upstream(gxcur, gxprev, rows, lo, prev_dd, cur_valid_lo):
    """gxn on rows [lo, P): gxcur masked below the producer's lattice plus
    the next layer's prev-tap cotangent read at g + prev_dd (< P)."""
    gxn = torch.where(rows >= cur_valid_lo, gxcur[:, lo:].float(), 0.0)
    if prev_dd:
        gxn = gxn + _shift_up(gxprev, prev_dd, lo).float()
    return gxn


def gated_layer_bwd_reference(x, cond, gxcur, gxprev, gskip, gcond, w_in,
                              w_out, b_in, *, dd: int, prev_dd: int,
                              valid_lo: int, cur_valid_lo: int, y_saved=None):
    """Plain version of the single-layer backward (``gated_layer_bwd``),
    saved-y or recompute mode, on rows [valid_lo, P).  gcond [B, P, n_cond]
    f32 accumulates in place.  Returns (gxcur', gxprev', gcond, dW_in,
    db_in, dW_out, db_out) with f32 weight gradients."""
    gated_layer_bwd_reference.launches += 1
    p_len, n_res = x.shape[1], x.shape[2]
    lo = valid_lo
    rows = torch.arange(lo, p_len, device=x.device)[None, :, None]
    xin = torch.cat([_shift_down(x, dd, lo, p_len), x[:, lo:], cond[:, lo:]], -1)
    if y_saved is not None:
        y = y_saved[:, lo:].float()
    else:
        y = xin.float() @ w_in.to(BF16).float() + b_in
    gxn = _upstream(gxcur, gxprev, rows, lo, prev_dd, cur_valid_lo)
    g_xin, dwi, dbi, dwo, dbo = _bwd_rows(xin, y, gxn, gskip[:, lo:].float(),
                                          w_in, w_out)
    gxc, gxp = torch.zeros_like(x), torch.zeros_like(x)
    gxc[:, lo:] = (gxn + g_xin[..., n_res : 2 * n_res]).to(BF16)
    gxp[:, lo:] = g_xin[..., :n_res].to(BF16)
    gcond[:, lo:] += g_xin[..., 2 * n_res :]
    return gxc, gxp, gcond, dwi, dbi, dwo, dbo


def gated_pair_bwd_reference(x1, x2, cond, gxcur, gxprev, gskip, gcond, pk1,
                             pk2, y1, y2, *, dd1: int, dd2: int, prev_dd: int,
                             valid_lo1: int, valid_lo2: int, cur_valid_lo: int):
    """Plain version of the pair backward (``gated_pair_bwd``, saved-y):
    layer 2 then layer 1 on rows [valid_lo1, P), the cotangent between them
    in f32.  gcond accumulates layer 2's term, then layer 1's.  Returns
    (gxcur', gxprev', gcond, 2 x (dW_in, db_in, dW_out, db_out))."""
    gated_pair_bwd_reference.launches += 1
    p_len, n_res = x1.shape[1], x1.shape[2]
    lo = valid_lo1
    rows = torch.arange(lo, p_len, device=x1.device)[None, :, None]
    valid2 = rows >= valid_lo2
    xin2 = torch.cat([_shift_down(x2, dd2, lo, p_len), x2[:, lo:], cond[:, lo:]], -1)
    xin2 = torch.where(valid2, xin2, torch.zeros((), dtype=BF16, device=x1.device))
    y2f = torch.where(valid2, y2[:, lo:].float(), 0.0)
    gxn2 = torch.where(valid2, _upstream(gxcur, gxprev, rows, lo, prev_dd,
                                         cur_valid_lo), 0.0)
    gsk = gskip[:, lo:].float()
    g_xin2, *dw2 = _bwd_rows(xin2, y2f, gxn2, torch.where(valid2, gsk, 0.0),
                             pk2[0], pk2[2])
    gcond[:, lo:] += g_xin2[..., 2 * n_res :]
    # layer 1's upstream: identity + cur at row q, prev tap produced at q + dd2
    gxn1 = _inner_upstream(gxn2, g_xin2, n_res, dd2)
    xin1 = torch.cat([_shift_down(x1, dd1, lo, p_len), x1[:, lo:], cond[:, lo:]], -1)
    g_xin1, *dw1 = _bwd_rows(xin1, y1[:, lo:].float(), gxn1, gsk, pk1[0], pk1[2])
    gcond[:, lo:] += g_xin1[..., 2 * n_res :]
    gxc, gxp = torch.zeros_like(x1), torch.zeros_like(x1)
    gxc[:, lo:] = (gxn1 + g_xin1[..., n_res : 2 * n_res]).to(BF16)
    gxp[:, lo:] = g_xin1[..., :n_res].to(BF16)
    return (gxc, gxp, gcond, *dw1, *dw2)


def _inner_upstream(gxn, g_xin, n_res: int, dd_up: int):
    """A layer's upstream inside a group, f32: the layer above's identity
    and cur-tap terms at row q plus its prev-tap term produced at q + dd_up
    (zero past the last row)."""
    return (gxn + g_xin[..., n_res : 2 * n_res]) + F.pad(
        g_xin[:, :, :n_res], (0, 0, 0, dd_up))[:, dd_up:]


def gated_group_bwd_reference(xs_g, cond, gxcur, gxprev, gskip, gcond, pks,
                              ys_g, *, dds, prev_dd: int, valid_los,
                              cur_valid_lo: int):
    """Plain version of the grouped backward (``gated_group_bwd``, saved-y):
    G consecutive layers (tuples, lower layer first) from the top of the
    group down on rows [valid_los[0], P), each layer's operands masked to
    its own valid_los[j], the cotangent between two layers in f32.  gcond
    accumulates the top layer's term first.  Returns (gxcur', gxprev',
    gcond, G x (dW_in, db_in, dW_out, db_out)), lower layer first."""
    gated_group_bwd_reference.launches += 1
    p_len, n_res = xs_g[0].shape[1], xs_g[0].shape[2]
    lo = valid_los[0]
    rows = torch.arange(lo, p_len, device=cond.device)[None, :, None]
    zero = torch.zeros((), dtype=BF16, device=cond.device)
    gsk_all = gskip[:, lo:].float()
    top = len(dds) - 1
    grads = [None] * len(dds)
    gxn = g_xin = None
    for j in range(top, -1, -1):
        xin = torch.cat([_shift_down(xs_g[j], dds[j], lo, p_len), xs_g[j][:, lo:],
                         cond[:, lo:]], -1)
        y = ys_g[j][:, lo:].float()
        if j == top:
            gxn = _upstream(gxcur, gxprev, rows, lo, prev_dd, cur_valid_lo)
        else:
            gxn = _inner_upstream(gxn, g_xin, n_res, dds[j + 1])
        gsk = gsk_all
        if valid_los[j] > lo:
            valid = rows >= valid_los[j]
            xin = torch.where(valid, xin, zero)
            y, gxn, gsk = (torch.where(valid, v, 0.0) for v in (y, gxn, gsk))
        g_xin, *grads[j] = _bwd_rows(xin, y, gxn, gsk, pks[j][0], pks[j][2])
        gcond[:, lo:] += g_xin[..., 2 * n_res :]
    gxc, gxp = torch.zeros_like(xs_g[0]), torch.zeros_like(xs_g[0])
    gxc[:, lo:] = (gxn + g_xin[..., n_res : 2 * n_res]).to(BF16)
    gxp[:, lo:] = g_xin[..., :n_res].to(BF16)
    return (gxc, gxp, gcond, *(g for layer in grads for g in layer))


for _f in (gated_layer_fused_reference, gated_pair_fused_reference,
           gated_stack_fused_reference, gated_layer_bwd_reference,
           gated_pair_bwd_reference, gated_group_bwd_reference):
    _f.launches = 0


class StackOps(NamedTuple):
    """The six kernels a stack schedule calls (same signatures as the
    plain versions)."""

    layer_fwd: Callable
    pair_fwd: Callable
    layer_bwd: Callable
    pair_bwd: Callable
    stack_fwd: Callable
    group_bwd: Callable


PLAIN = StackOps(gated_layer_fused_reference, gated_pair_fused_reference,
                 gated_layer_bwd_reference, gated_pair_bwd_reference,
                 gated_stack_fused_reference, gated_group_bwd_reference)


def kernel_ops() -> StackOps:
    """The dispatching wrappers of ``ops/gated_cuda.py``: the CUDA kernels
    on CUDA tensors, the plain versions on CPU tensors."""
    from ae_wavenet_tpu_torch.ops import gated_cuda as gc

    return StackOps(gc.gated_layer_fused, gc.gated_pair_fused,
                    gc.gated_layer_bwd, gc.gated_pair_bwd,
                    gc.gated_stack_fused, gc.gated_group_bwd)


# ----------------------------------------------------------- the schedule

class Schedule(NamedTuple):
    dils: tuple
    save_y: bool
    fuse_pairs: bool
    ops: StackOps
    full_fusion: bool = False
    bwd_group: int = 0

    def _runs(self, size: int) -> list:
        """Consecutive layers in runs of ``size``, the remainder last."""
        n = len(self.dils)
        return [tuple(range(i, min(i + size, n))) for i in range(0, n, size)]

    def fwd_segments(self) -> list:
        """One segment of every layer with ``full_fusion`` (two layers or
        more), else pairs or single layers."""
        if self.full_fusion and len(self.dils) >= 2:
            return [tuple(range(len(self.dils)))]
        return self._runs(2 if self.fuse_pairs else 1)

    def bwd_segments(self) -> list:
        """``_stack_core`` ``:1450-1469``, whatever the forward ran (the
        saved streams and y cover every layer).  Fused segments need saved
        y (no recompute mode): runs of up to ``bwd_group`` layers when it is
        3 or more (a run of 3 or more goes to the grouped kernel, a
        remainder of 2 to the pair kernel, of 1 to the single-layer kernel),
        else pairs with ``fuse_pairs``; otherwise one layer per segment."""
        if self.save_y and self.bwd_group >= 3:
            return self._runs(self.bwd_group)
        return self._runs(2 if self.save_y and self.fuse_pairs else 1)


def run_forward(sched: Schedule, x, cond, packed, save: bool):
    """The forward schedule of ``_stack_core`` (``:1390-1426``).  Returns
    (skip, xs, ys): each layer's input stream and, with save_y, its y."""
    dils, ops = sched.dils, sched.ops
    skip = torch.zeros(*x.shape[:2], packed[0][3].shape[0] - x.shape[2],
                       device=x.device)
    save_y = save and sched.save_y
    xs, ys = [], []
    for seg in sched.fwd_segments():
        i = seg[0]
        if save:
            xs.append(x)
        if sched.full_fusion and len(seg) >= 2:
            skip, mids, ys_all = ops.stack_fwd(
                x, cond, skip, packed, dils=dils, r0=valid_lo(dils, 0),
                save_y=save_y, save_mids=save)
            xs.extend(mids)
            ys.extend(ys_all)
        elif len(seg) == 2:
            outs = ops.pair_fwd(x, cond, skip, packed[i], packed[i + 1],
                                dd1=dils[i], dd2=dils[i + 1],
                                r0=valid_lo(dils, i), save_y=save_y)
            mid, x, skip = outs[:3]
            ys.extend(outs[3:])
            if save:
                xs.append(mid)
        else:
            outs = ops.layer_fwd(x, cond, skip, *packed[i], dd=dils[i],
                                 r0=valid_lo(dils, i), save_y=save_y)
            x, skip = outs[:2]
            ys.extend(outs[2:])
    return skip, xs, ys


def run_backward(sched: Schedule, g_skip, xs, ys, cond, packed):
    """The backward of ``_stack_core`` (``:1437-1535``): segments in
    reverse, the layer-0 fold, and the bf16 cond cotangent.  Returns
    (g_x0 bf16, g_cond bf16, per-layer f32 (dW_in, db_in, dW_out, db_out))."""
    dils, ops = sched.dils, sched.ops
    x0 = xs[0]
    p_len = x0.shape[1]
    gskip = g_skip.to(BF16)
    gxcur, gxprev = torch.zeros_like(x0), torch.zeros_like(x0)
    gcond = torch.zeros(cond.shape, device=cond.device)
    grads = [None] * len(dils)
    n = len(dils)
    for seg in reversed(sched.bwd_segments()):
        i, j = seg[0], seg[-1]
        prev_dd = dils[j + 1] if j + 1 < n else 0
        cur_lo = valid_lo(dils, j + 1) if j + 1 < n else p_len
        if len(seg) >= 3:
            outs = ops.group_bwd(
                tuple(xs[i : j + 1]), cond, gxcur, gxprev, gskip, gcond,
                tuple(packed[i : j + 1]), tuple(ys[i : j + 1]),
                dds=tuple(dils[i : j + 1]), prev_dd=prev_dd,
                valid_los=tuple(valid_lo(dils, k) for k in range(i, j + 1)),
                cur_valid_lo=cur_lo)
            gxcur, gxprev, gcond = outs[:3]
            for k in range(len(seg)):
                grads[i + k] = outs[3 + 4 * k : 7 + 4 * k]
        elif len(seg) == 2:
            outs = ops.pair_bwd(
                xs[i], xs[i + 1], cond, gxcur, gxprev, gskip, gcond,
                packed[i], packed[i + 1], ys[i], ys[i + 1], dd1=dils[i],
                dd2=dils[i + 1], prev_dd=prev_dd, valid_lo1=valid_lo(dils, i),
                valid_lo2=valid_lo(dils, i + 1), cur_valid_lo=cur_lo)
            gxcur, gxprev, gcond = outs[:3]
            grads[i], grads[i + 1] = outs[3:7], outs[7:11]
        else:
            w_in, b_in, w_out, _ = packed[i]
            outs = ops.layer_bwd(
                xs[i], cond, gxcur, gxprev, gskip, gcond, w_in, w_out, b_in,
                dd=dils[i], prev_dd=prev_dd, valid_lo=valid_lo(dils, i),
                cur_valid_lo=cur_lo, y_saved=ys[i] if sched.save_y else None)
            gxcur, gxprev, gcond = outs[:3]
            grads[i] = outs[3:7]
    # fold layer 0's prev-tap cotangent into x0's (rows outside each
    # buffer's defined region are masked to zero)
    d0 = dils[0]
    row = torch.arange(p_len, device=x0.device)[None, :, None]
    zero = torch.zeros((), dtype=BF16, device=x0.device)
    g_x0 = (torch.where(row >= d0, gxcur, zero)
            + _shift_up(gxprev, d0, 0))
    return g_x0, gcond.to(BF16), grads


class GatedStack(torch.autograd.Function):
    """(x0 [B, P, n_res] bf16, cond [B, P, n_cond] bf16, packed f32
    weights) -> skip [B, P, n_skp] f32, with the fused backward.  The
    weight gradients return in f32 to the packed f32 weights."""

    @staticmethod
    def forward(ctx, sched: Schedule, x0, cond, *flat):
        packed = [flat[k : k + 4] for k in range(0, len(flat), 4)]
        save = any(ctx.needs_input_grad[1:])
        skip, xs, ys = run_forward(sched, x0, cond, packed, save)
        ctx.sched = sched
        if save:
            ctx.save_for_backward(cond, *flat, *xs, *ys)
            ctx.n_flat, ctx.n_xs = len(flat), len(xs)
        return skip

    @staticmethod
    def backward(ctx, g_skip):
        saved = ctx.saved_tensors
        cond = saved[0]
        flat = saved[1 : 1 + ctx.n_flat]
        xs = saved[1 + ctx.n_flat : 1 + ctx.n_flat + ctx.n_xs]
        ys = saved[1 + ctx.n_flat + ctx.n_xs :]
        packed = [flat[k : k + 4] for k in range(0, len(flat), 4)]
        g_x0, g_cond, grads = run_backward(ctx.sched, g_skip.contiguous(), xs,
                                           ys, cond, packed)
        return (None, g_x0, g_cond, *(g for layer in grads for g in layer))


def check_schedule(cfg: WaveNetConfig, *, save_y: bool | None = None,
                   full_fusion: bool | None = None,
                   bwd_group: int | None = None) -> None:
    """Refuse what the fused stack cannot run as asked (the keywords
    override the config's ``gated_*`` fields, as in :func:`stack_apply`).
    The reference warns and runs the pair or per-layer schedule instead;
    here a schedule that does not apply raises."""
    save_y = cfg.gated_save_y if save_y is None else save_y
    full_fusion = cfg.gated_full_fusion if full_fusion is None else full_fusion
    bwd_group = cfg.gated_bwd_group if bwd_group is None else bwd_group
    if cfg.filter_sz != 2:
        raise ValueError("the fused stack takes filter_sz == 2")
    if full_fusion and len(cfg.dilations) < 2:
        raise ValueError(
            f"gated_full_fusion takes two or more layers, the stack has "
            f"{len(cfg.dilations)}: drop gated_full_fusion (the single-layer "
            "kernel runs one layer)")
    if bwd_group >= 3 and not save_y:
        raise ValueError(
            f"gated_bwd_group={bwd_group} needs gated_save_y=True (the grouped "
            "backward has no recompute mode): set gated_save_y, or "
            "gated_bwd_group=0 for the per-layer backward")


def stack_apply(wavenet, cfg: WaveNetConfig, x_ids: torch.Tensor,
                cond: torch.Tensor, gc_ids: torch.Tensor | None = None, *,
                btq: bool = False, ops: StackOps | None = None,
                save_y: bool | None = None,
                fuse_pairs: bool | None = None,
                full_fusion: bool | None = None,
                bwd_group: int | None = None) -> torch.Tensor:
    """The fused counterpart of ``models/wavenet.apply`` (bf16):
    x_ids [B, T_in] (ids, or samples with ``cfg.n_mix``), cond
    [B, n_lc_out, T_in] -> logits [B, n_out, T_out] ([B, T_out, n_out] with
    ``btq``).

    ``ops`` defaults to :func:`kernel_ops`; ``save_y``, ``fuse_pairs``,
    ``full_fusion`` and ``bwd_group`` default to the config's ``gated_*``
    fields, which choose the kernels (:class:`Schedule`).  ``cfg.gated_tile`` and ``cfg.gated_bwd_tile`` are
    TPU schedule knobs and are not read: the CUDA kernels pick their own
    tiles."""
    check_schedule(cfg, save_y=save_y, full_fusion=full_fusion,
                   bwd_group=bwd_group)
    dils = stack_dils(cfg)
    t_in = x_ids.shape[-1]
    t_out = t_in - sum(dils)
    x0 = embed_input(wavenet, x_ids).to(BF16)
    cond_tm = with_gc(wavenet, cfg, cond, gc_ids).permute(0, 2, 1).to(BF16)
    sched = Schedule(dils, cfg.gated_save_y if save_y is None else save_y,
                     cfg.gated_fuse_pairs if fuse_pairs is None else fuse_pairs,
                     kernel_ops() if ops is None else ops,
                     cfg.gated_full_fusion if full_fusion is None else full_fusion,
                     cfg.gated_bwd_group if bwd_group is None else bwd_group)
    flat = [t for pk in pack_stack_weights(wavenet, cfg) for t in pk]
    skip = GatedStack.apply(sched, x0.contiguous(), cond_tm.contiguous(), *flat)
    h = F.relu(skip[:, t_in - t_out :])

    def mm(p, v):
        return (torch.einsum("oc,btc->bto", p["w"].to(BF16), v.to(BF16))
                + p["b"].to(BF16))

    logits = mm(wavenet.post2, F.relu(mm(wavenet.post1, h)))
    return logits if btq else logits.permute(0, 2, 1)
