"""The gated kernels against their plain versions, on the same inputs.

Shared by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``: seeded
random stacks with every bias perturbed (so a dropped bias shows), inputs
for each kernel taken from a plain forward of that stack, and the
comparisons with their tolerances.

Tolerances.  Kernel and plain version round at the same points (the
contract in ``ops/gated.py``); only the order of f32 summation differs, so
an intermediate bf16 value (h, g_out, g_y, x') may land one ulp (2^-8
relative) apart and carry that into later sums.  Per-kernel outputs:
max |d| <= SEGMENT_REL_TOL * max |plain|.  Whole stack: logits within
LOGIT_ABS_TOL and every gradient within GRAD_REL_TOL of the largest, as
``tests/test_gated_pallas.py:48,131`` hold the Pallas stack.

The whole-stack forward is many layers deep in one kernel: a one-ulp flip
of x' stays on the residual stream and the flips of later layers add to it,
so against the plain version run from x0 its deepest outputs drift by a few
ulps of their largest value (about 0.02 of it at 20 layers of the flagship
width on an H100, against 0.004-0.006 for one layer).  It is therefore held
twice: every layer of it against the plain layer on the kernel's own input
stream at SEGMENT_REL_TOL (:func:`stack_layerwise`), and every output
against the plain version run from x0 at DRIFT_REL_TOL.
"""

from __future__ import annotations

import copy
from unittest import mock

import torch

from ae_wavenet_tpu_torch.models import wavenet as twn
from ae_wavenet_tpu_torch.ops import gated
from ae_wavenet_tpu_torch.ops.fastgen import with_gc
from ae_wavenet_tpu_torch.utils.config import WaveNetConfig

SEGMENT_REL_TOL = 1e-2
DRIFT_REL_TOL = 5e-2   # many layers deep, from x0 (see above)
LOGIT_ABS_TOL = 0.02
GRAD_REL_TOL = 0.05
BF16 = torch.bfloat16


def random_stack(cfg: WaveNetConfig, batch: int, t_out: int, seed: int, dev):
    """(wavenet with every bias ~ N(0, 0.3^2), x_ids, cond, speaker ids)."""
    gen = torch.Generator().manual_seed(seed)
    wn = twn.WaveNet(cfg, gen)
    with torch.no_grad():
        for name, p in wn.named_parameters():
            if name.endswith(".b"):
                p.normal_(0.0, 0.3, generator=gen)
    t_in = t_out + twn.receptive_field(cfg)
    ids = torch.randint(0, cfg.n_quant, (batch, t_in), generator=gen)
    cond = torch.randn(batch, cfg.n_lc_out, t_in, generator=gen) * 0.5
    spk = torch.randint(0, cfg.n_speakers, (batch,), generator=gen)
    return wn.to(dev), ids.to(dev), cond.to(dev), spk.to(dev)


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    d = float((got.float() - want.float()).abs().max())
    return d, d / max(float(want.float().abs().max()), 1e-30)


# ---------------------------------------------------------- per kernel

def segment_inputs(wn, cfg: WaveNetConfig, ids, cond, spk, seed: int = 0):
    """The stack's operands from a plain saved forward: (dils, x0, cond_tm,
    packed, xs, ys) plus random upstream cotangents (gxcur, gxprev, gskip,
    gcond) of the stack's shape."""
    dils = gated.stack_dils(cfg)
    with torch.no_grad():
        x0 = wn.embed[ids].to(BF16).contiguous()
        cond_tm = with_gc(wn, cfg, cond, spk).permute(0, 2, 1).to(BF16).contiguous()
        packed = [tuple(t.detach().contiguous() for t in pk)
                  for pk in gated.pack_stack_weights(wn, cfg)]
        sched = gated.Schedule(dils, True, False, gated.PLAIN)
        _, xs, ys = gated.run_forward(sched, x0, cond_tm, packed, save=True)
    gen = torch.Generator(device=x0.device).manual_seed(seed)

    def rnd(shape, dtype, scale):
        return (torch.randn(shape, generator=gen, device=x0.device) * scale).to(dtype)

    b, p, r = x0.shape
    cot = dict(gxcur=rnd((b, p, r), BF16, 0.1), gxprev=rnd((b, p, r), BF16, 0.1),
               gskip=rnd((b, p, cfg.n_skp), BF16, 0.1),
               gcond=rnd((b, p, cond_tm.shape[-1]), torch.float32, 0.1))
    return dils, x0, cond_tm, packed, xs, ys, cot


def _skip0(x0, packed, seed: int):
    """A random incoming skip [B, P, n_skp] f32."""
    gen = torch.Generator(device=x0.device).manual_seed(seed)
    return torch.randn(*x0.shape[:2], packed[0][3].shape[0] - x0.shape[2],
                       generator=gen, device=x0.device)


def segment_tolerance(name: str) -> float:
    """The tolerance of ``segment_calls``'s case ``name`` against its plain
    version on the same inputs."""
    return DRIFT_REL_TOL if name.startswith("gated_stack_fused") else SEGMENT_REL_TOL


def stack_layerwise(got, dils, cond_tm, packed, x0, skip_seed: int = 1):
    """What the plain layer gives on the input stream that the whole-stack
    kernel itself produced: from ``got`` = (skip, L - 1 mids, L ys) of the
    ``gated_stack_fused`` case, the same tuple with layer l computed from
    got's mid l - 1, and the skip as the sum of those layers' terms."""
    n = len(dils)
    mids = got[1:n]
    skip = _skip0(x0, packed, skip_seed)
    outs_x, outs_y = [], []
    for l in range(n):
        x_new, _, y = gated.gated_layer_fused_reference(
            x0 if l == 0 else mids[l - 1], cond_tm, skip, *packed[l], dd=dils[l],
            r0=gated.valid_lo(dils, 0), save_y=True)
        outs_x.append(x_new)
        outs_y.append(y)
    return (skip, *outs_x[:-1], *outs_y)


def segment_calls(dils, cond_tm, packed, xs, ys, cot, skip_seed: int = 1):
    """{kernel name: (wrapper name, call(fn))} for one segment each, chosen
    where the schedule is hardest: the pair and the single layer with the
    largest dilation (the forward's halo spans the most rows) and a pair
    and a single layer below the top, so the upstream prev-tap cotangent
    (prev_dd) is read; the whole stack from x0 into a random incoming skip,
    saving everything and saving nothing; and groups of up to 5 and of 3
    layers below the top that end on the largest dilation.  Every call
    returns a flat tuple of tensors."""
    n = len(dils)
    vl = lambda i: gated.valid_lo(dils, i)  # noqa: E731
    top = n - 2 if n % 2 == 0 else n - 3   # the last pair of the schedule
    mid = max(top - 2, 0)
    skip0 = _skip0(xs[0], packed, skip_seed)

    def fresh(d):
        return {k: v.clone() for k, v in d.items()}

    def pair_fwd(fn):
        return fn(xs[top], cond_tm, skip0.clone(), packed[top], packed[top + 1],
                  dd1=dils[top], dd2=dils[top + 1], r0=vl(top), save_y=True)

    def layer_fwd(fn):
        i = n - 1
        return fn(xs[i], cond_tm, skip0.clone(), *packed[i], dd=dils[i],
                  r0=vl(i), save_y=True)

    def pair_bwd(fn):
        c = fresh(cot)
        return fn(xs[mid], xs[mid + 1], cond_tm, c["gxcur"], c["gxprev"],
                  c["gskip"], c["gcond"], packed[mid], packed[mid + 1],
                  ys[mid], ys[mid + 1], dd1=dils[mid], dd2=dils[mid + 1],
                  prev_dd=dils[mid + 2], valid_lo1=vl(mid),
                  valid_lo2=vl(mid + 1), cur_valid_lo=vl(mid + 2))

    def layer_bwd(fn, saved=True):
        c, i = fresh(cot), n - 2
        w_in, b_in, w_out, _ = packed[i]
        return fn(xs[i], cond_tm, c["gxcur"], c["gxprev"], c["gskip"],
                  c["gcond"], w_in, w_out, b_in, dd=dils[i], prev_dd=dils[i + 1],
                  valid_lo=vl(i), cur_valid_lo=vl(i + 1),
                  y_saved=ys[i] if saved else None)

    def stack_fwd(fn, save=True):
        skip, mids, ys_all = fn(xs[0], cond_tm, skip0.clone(), packed, dils=dils,
                                r0=vl(0), save_y=save, save_mids=save)
        return (skip, *mids, *ys_all)

    # the first layer below the top with the largest dilation ends the groups
    hi = max(range(n - 1), key=lambda i: (dils[i], -i)) if n > 1 else 0

    def group_bwd(fn, size):
        c, i, k = fresh(cot), max(hi + 1 - size, 0), hi + 1
        return fn(tuple(xs[i:k]), cond_tm, c["gxcur"], c["gxprev"], c["gskip"],
                  c["gcond"], tuple(packed[i:k]), tuple(ys[i:k]),
                  dds=tuple(dils[i:k]), prev_dd=dils[k],
                  valid_los=tuple(vl(m) for m in range(i, k)), cur_valid_lo=vl(k))

    return {
        "gated_stack_fused": ("gated_stack_fused", stack_fwd),
        "gated_stack_fused_no_save": (
            "gated_stack_fused", lambda fn: stack_fwd(fn, save=False)),
        "gated_group_bwd": ("gated_group_bwd", lambda fn: group_bwd(fn, 5)),
        "gated_group_bwd_3": ("gated_group_bwd", lambda fn: group_bwd(fn, 3)),
        "gated_pair_fused": ("gated_pair_fused", pair_fwd),
        "gated_layer_fused": ("gated_layer_fused", layer_fwd),
        "gated_pair_bwd": ("gated_pair_bwd", pair_bwd),
        "gated_layer_bwd": ("gated_layer_bwd", layer_bwd),
        "gated_layer_bwd_recompute": (
            "gated_layer_bwd", lambda fn: layer_bwd(fn, saved=False)),
    }


def compare_outputs(got, want) -> tuple[float, float]:
    """Largest (abs, rel) error over every output tensor."""
    worst = (0.0, 0.0)
    for g, w in zip(got, want):
        e = rel_err(g, w)
        worst = (max(worst[0], e[0]), max(worst[1], e[1]))
    return worst


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


FAULT_TILE = 64  # csrc/gated.cu: rows per tile


def planted_faults(wn, cfg: WaveNetConfig):
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
    that its gate pass adds to the accumulator)."""
    inner_upstream = gated._inner_upstream

    def no_carry(gxn, g_xin, n_res, dd_up):
        # row r's prev-tap cotangent feeds row r - dd_up of the layer below
        r = torch.arange(g_xin.shape[1], device=g_xin.device)
        same_tile = (r // FAULT_TILE == (r - dd_up) // FAULT_TILE)[None, :, None]
        prev = torch.where(same_tile, g_xin[..., :n_res], 0.0)
        return inner_upstream(gxn, torch.cat([prev, g_xin[..., n_res:]], -1),
                              n_res, dd_up)

    def group_no_carry(*args, **kw):
        with mock.patch.object(gated, "_inner_upstream", no_carry):
            return gated.gated_group_bwd_reference(*args, **kw)

    def pair_fwd_off(*args, dd2, **kw):
        return gated.gated_pair_fused_reference(*args, dd2=dd2 + 1, **kw)

    def pair_bwd_off(*args, dd2, **kw):
        return gated.gated_pair_bwd_reference(*args, dd2=dd2 + 1, **kw)

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
            "single-layer backward, recompute mode: b_in dropped from y":
            ("gated_layer_bwd_recompute", layer_bwd_no_bias)}
