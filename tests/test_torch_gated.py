"""The port's fused gated stack (``ops/gated.py``, through the CPU dispatch
of ``ops/gated_cuda.py``) against the JAX package, on the CPU.

Weights come from the JAX init (biases perturbed, so a dropped bias shows)
and cross by their dotted names; inputs are made with numpy from a seed.
Tolerances, from ``tests/test_gated_pallas.py``: forward max |d| < 0.02
against the Pallas stack in interpret mode (bf16 reduction order);
gradients within 0.05 of the largest and an RMS distance to the f32
gradients under 3x the XLA bf16 stack's own (``:100,131``).  Each plain
backward against the Pallas kernel on one segment: within 1e-2 of the
largest value (the same rounding points, f32 sums in another order).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ae_wavenet_tpu.models import wavenet as jwn
from ae_wavenet_tpu.ops import gated_pallas as gp
from ae_wavenet_tpu.training.torch_compat import flatten_named
from ae_wavenet_tpu.utils.config import WaveNetConfig as JW
from ae_wavenet_tpu_torch.models import wavenet as twn
from ae_wavenet_tpu_torch.ops import gated
from ae_wavenet_tpu_torch.ops import gated_check
from ae_wavenet_tpu_torch.utils.config import WaveNetConfig as TW

KW = dict(n_blocks=1, n_block_layers=5, n_res=128, n_dil=128, n_skp=128,
          n_post=128, n_lc_in=16, n_lc_out=64, n_speakers=8, n_global_embed=16)
JCFG, TCFG = JW(**KW), TW(**KW)
RF = jwn.receptive_field(JCFG)
T_OUT, TILE, BATCH = 100, 64, 2
FWD_TOL, GRAD_REL_TOL, SEG_TOL = 0.02, 0.05, 1e-2
SCHEDULES = [(True, True), (True, False), (False, True), (False, False)]


@functools.lru_cache(maxsize=None)
def _setup():
    params = jwn.init(jax.random.PRNGKey(0), JCFG)
    rng = np.random.default_rng(0)
    for layer in params["layers"]:
        for tap in layer.values():
            tap["b"] = jnp.asarray(rng.normal(size=tap["b"].shape) * 0.3, jnp.float32)
    port = twn.WaveNet(TCFG)
    port.load_state_dict({k: torch.tensor(np.asarray(v))
                          for k, v in flatten_named(params).items()})
    t_in = T_OUT + RF
    ids = rng.integers(0, 256, (BATCH, t_in)).astype(np.int32)
    cond = (rng.normal(size=(BATCH, KW["n_lc_out"], t_in)) * 0.5).astype(np.float32)
    spk = rng.integers(0, KW["n_speakers"], (BATCH,)).astype(np.int32)
    probe = rng.normal(size=(BATCH, 256, T_OUT)).astype(np.float32)
    return params, port, ids, cond, spk, probe


def _t(x, long=False):
    t = torch.from_numpy(np.asarray(x))
    return t.long() if long else t


@functools.lru_cache(maxsize=None)
def _jax_grads():
    """jax.grad of mean(logits * probe) through the XLA stack, bf16 and f32."""
    params, _, ids, cond, spk, probe = _setup()

    def loss(p, c, dt):
        out = jwn.apply(p, JCFG, ids, c, spk, dtype=dt)
        return jnp.mean(out.astype(jnp.float32) * probe)

    out = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        g = jax.jit(jax.grad(loss, argnums=(0, 1)), static_argnums=2)(
            params, jnp.asarray(cond), dt)
        out[name] = flatten_named({"p": g[0], "c": g[1]})
    return out


@pytest.mark.parametrize("save_y,fuse_pairs", SCHEDULES)
def test_stack_forward_matches_pallas(save_y, fuse_pairs):
    """Pair and single schedules, save_y on and off, an odd layer count."""
    params, port, ids, cond, spk, _ = _setup()
    want = gp.stack_apply(params, JCFG, ids, cond, spk, tile=TILE, interpret=True,
                          fuse_pairs=fuse_pairs, save_y=save_y)
    with torch.no_grad():
        got = gated.stack_apply(port, TCFG, _t(ids, True), _t(cond), _t(spk, True),
                                save_y=save_y, fuse_pairs=fuse_pairs)
    assert got.shape == want.shape
    d = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert d < FWD_TOL, d


@pytest.mark.parametrize("save_y,fuse_pairs", SCHEDULES)
def test_stack_grads_match_xla(save_y, fuse_pairs):
    _, port, ids, cond, spk, probe = _setup()
    ref = _jax_grads()
    port.zero_grad(set_to_none=True)
    c = _t(cond).clone().requires_grad_(True)
    out = gated.stack_apply(port, TCFG, _t(ids, True), c, _t(spk, True),
                            save_y=save_y, fuse_pairs=fuse_pairs)
    (out.float() * _t(probe)).mean().backward()
    mine = {"p." + k: p.grad.numpy() for k, p in port.named_parameters()
            if p.grad is not None}
    mine["c"] = c.grad.numpy()
    keys = sorted(ref["bf16"])
    assert set(mine) <= set(keys)  # unused parameters (the upsampler) get none
    flat = lambda g: np.concatenate(  # noqa: E731
        [np.ravel(g[k]) if k in g else np.zeros(ref["bf16"][k].size) for k in keys])
    fp, fx, f32 = flat(mine), flat(ref["bf16"]), flat(ref["f32"])
    assert np.isfinite(fp).all()
    assert np.abs(fp - fx).max() / np.abs(fx).max() < GRAD_REL_TOL
    rms = lambda a: float(np.sqrt(((a - f32) ** 2).mean()))  # noqa: E731
    assert rms(fp) < 3.0 * rms(fx) + 1e-8, (rms(fp), rms(fx))


# ---------------------------------------- plain backward vs the Pallas kernels

def _frame(t_in):
    p_len = -(-t_in // TILE) * TILE
    lpad = -(-512 // TILE) * TILE
    return p_len, lpad, p_len - t_in


def _jx(a: torch.Tensor, top: int, bottom: int = 0, ch: int | None = None):
    """Port [B, P, C] -> the Pallas frame: ``top`` rows above, ``bottom``
    below, channels zero-padded to ``ch``."""
    a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    c = a.shape[-1] if ch is None else ch
    a = np.pad(a, ((0, 0), (top, bottom), (0, c - a.shape[-1])))
    return jnp.asarray(a)


def _segment():
    params, port, ids, cond, spk, _ = _setup()
    dils, _, cond_tm, packed, xs, ys, cot = gated_check.segment_inputs(
        port, TCFG, _t(ids, True), _t(cond), _t(spk, True))
    t_in = xs[0].shape[1]
    p_len, lpad, off = _frame(t_in)
    ncp = -(-cond_tm.shape[-1] // 128) * 128
    j = dict(cond=_jx(cond_tm, off, ch=ncp).astype(jnp.bfloat16),
             gxcur=_jx(cot["gxcur"], lpad + off).astype(jnp.bfloat16),
             gxprev=_jx(cot["gxprev"], lpad + off, 512).astype(jnp.bfloat16),
             gskip=_jx(cot["gskip"], off).astype(jnp.bfloat16),
             gcond=_jx(cot["gcond"], off, ch=ncp))
    jpk = gp.pack_stack_weights(params, JCFG)
    return dils, cond_tm, packed, xs, ys, cot, j, jpk, (p_len, lpad, off, ncp)


def _cmp_rows(got: torch.Tensor, want, lo: int, top: int):
    """Rows [lo, P) of a port buffer against the same rows of the Pallas one."""
    w = np.asarray(want, np.float32)[:, top + lo : top + got.shape[1]]
    g = got.float().numpy()[:, lo:]
    return np.abs(g[..., : w.shape[-1]] - w[..., : g.shape[-1]]).max() / np.abs(w).max()


def _cmp_dw(got, want, n_in, ncp):
    """Weight gradients: the Pallas w_in rows carry zero-padded cond rows."""
    dwi = np.asarray(want[0])
    n_cond = got[0].shape[0] - n_in
    dwi = np.concatenate([dwi[:n_in], dwi[n_in : n_in + n_cond]])
    pairs = [(got[0], dwi)] + [(g, np.asarray(w).reshape(g.shape))
                                for g, w in zip(got[1:], want[1:])]
    return max(np.abs(g.numpy() - w).max() / np.abs(w).max() for g, w in pairs)


@pytest.mark.parametrize("saved", [True, False])
@pytest.mark.parametrize("layer", ["below_top", "bottom", "top"])
def test_plain_layer_bwd_matches_pallas(saved, layer):
    """Saved-y and recompute modes, for one layer below the top (its
    upstream prev-tap cotangent is read), the bottom layer (dilation 1, x
    defined from row 0) and the top layer (no layer above: no prev_dd, and
    no rows of gxcur on its lattice)."""
    dils, cond_tm, packed, xs, ys, cot, j, jpk, (p_len, lpad, off, ncp) = _segment()
    n = len(dils)
    i = {"below_top": n - 2, "bottom": 0, "top": n - 1}[layer]
    vl = gated.valid_lo(dils, i)
    prev_dd = dils[i + 1] if i + 1 < n else 0
    cur_vl = gated.valid_lo(dils, i + 1) if i + 1 < n else xs[0].shape[1]
    c = {k: v.clone() for k, v in cot.items()}
    w_in, b_in, w_out, _ = packed[i]
    got = gated.gated_layer_bwd_reference(
        xs[i], cond_tm, c["gxcur"], c["gxprev"], c["gskip"], c["gcond"], w_in,
        w_out, b_in, dd=dils[i], prev_dd=prev_dd, valid_lo=vl,
        cur_valid_lo=cur_vl, y_saved=ys[i] if saved else None)
    jw_in, jb_in, jw_out, _ = jpk[i]
    want = gp.gated_layer_bwd(
        _jx(xs[i], lpad + off).astype(jnp.bfloat16), j["cond"], j["gxcur"],
        j["gxprev"], j["gskip"], j["gcond"], jw_in, jw_out, jb_in, dd=dils[i],
        prev_dd=prev_dd, t_min=(off + vl) // TILE, valid_lo=off + vl,
        cur_valid_lo=off + cur_vl, tile=TILE, interpret=True,
        y_saved=_jx(ys[i], off).astype(jnp.bfloat16) if saved else None)
    n_in = 2 * KW["n_res"]
    errs = [_cmp_rows(got[0], want[0], vl, lpad + off),
            _cmp_rows(got[1], want[1], vl, lpad + off),
            _cmp_rows(got[2], want[2], 0, off),
            _cmp_dw(got[3:], want[3:], n_in, ncp)]
    assert max(errs) < SEG_TOL, errs


def test_plain_pair_bwd_matches_pallas():
    """The pair below the top layer: layer 2's f32 cotangent to layer 1,
    its cross-tile head, and the upstream prev-tap cotangent."""
    dils, cond_tm, packed, xs, ys, cot, j, jpk, (p_len, lpad, off, ncp) = _segment()
    i = len(dils) - 3
    vl1, vl2 = gated.valid_lo(dils, i), gated.valid_lo(dils, i + 1)
    cur_vl = gated.valid_lo(dils, i + 2)
    c = {k: v.clone() for k, v in cot.items()}
    got = gated.gated_pair_bwd_reference(
        xs[i], xs[i + 1], cond_tm, c["gxcur"], c["gxprev"], c["gskip"], c["gcond"],
        packed[i], packed[i + 1], ys[i], ys[i + 1], dd1=dils[i], dd2=dils[i + 1],
        prev_dd=dils[i + 2], valid_lo1=vl1, valid_lo2=vl2, cur_valid_lo=cur_vl)
    xj = [_jx(xs[k], lpad + off).astype(jnp.bfloat16) for k in (i, i + 1)]
    yj = [_jx(ys[k], off).astype(jnp.bfloat16) for k in (i, i + 1)]
    want = gp.gated_pair_bwd(
        xj[0], xj[1], j["cond"], j["gxcur"], j["gxprev"], j["gskip"], j["gcond"],
        jpk[i], jpk[i + 1], yj[0], yj[1], dd1=dils[i], dd2=dils[i + 1],
        prev_dd=dils[i + 2], t_min=(off + vl1) // TILE, valid_lo1=off + vl1,
        valid_lo2=off + vl2, cur_valid_lo=off + cur_vl, tile=TILE, interpret=True)
    n_in = 2 * KW["n_res"]
    errs = [_cmp_rows(got[0], want[0], vl1, lpad + off),
            _cmp_rows(got[1], want[1], vl1, lpad + off),
            _cmp_rows(got[2], want[2], 0, off),
            _cmp_dw(got[3:7], want[3:7], n_in, ncp),
            _cmp_dw(got[7:11], want[7:11], n_in, ncp)]
    assert max(errs) < SEG_TOL, errs


def test_plain_forward_kernels_match_pallas():
    """The pair and single-layer forward on the top segment: x' (and mid),
    skip and the saved y on the valid rows."""
    dils, cond_tm, packed, xs, ys, cot, j, jpk, (p_len, lpad, off, ncp) = _segment()
    n = len(dils)
    i = n - 3
    gen = torch.Generator().manual_seed(5)
    skip = torch.randn(*xs[0].shape[:2], KW["n_skp"], generator=gen)
    got = gated.gated_pair_fused_reference(
        xs[i], cond_tm, skip.clone(), packed[i], packed[i + 1], dd1=dils[i],
        dd2=dils[i + 1], r0=gated.valid_lo(dils, i), save_y=True)
    want = gp.gated_pair_fused(
        _jx(xs[i], lpad + off).astype(jnp.bfloat16), j["cond"], _jx(skip, off),
        jpk[i], jpk[i + 1], dd1=dils[i], dd2=dils[i + 1],
        t_min=(off + gated.valid_lo(dils, i)) // TILE, tile=TILE, interpret=True,
        save_y=True)
    vl2 = gated.valid_lo(dils, i + 1)
    errs = [_cmp_rows(got[0], want[0], gated.valid_lo(dils, i), lpad + off),
            _cmp_rows(got[1], want[1], vl2, lpad + off),
            _cmp_rows(got[2], want[2], gated.valid_lo(dils, n - 1), off),
            _cmp_rows(got[3], want[3], gated.valid_lo(dils, i), off),
            _cmp_rows(got[4], want[4], vl2, off)]
    k = n - 1
    got1 = gated.gated_layer_fused_reference(
        xs[k], cond_tm, skip.clone(), *packed[k], dd=dils[k],
        r0=gated.valid_lo(dils, k), save_y=True)
    w_in, b_in, w_out, b_out = jpk[k]
    want1 = gp.gated_layer_fused(
        _jx(xs[k], lpad + off).astype(jnp.bfloat16), j["cond"], _jx(skip, off),
        w_in, b_in, w_out, b_out, dd=dils[k],
        t_min=(off + gated.valid_lo(dils, k)) // TILE, tile=TILE, interpret=True,
        save_y=True)
    errs += [_cmp_rows(g, w, gated.valid_lo(dils, k), top)
             for g, w, top in zip(got1, want1, (lpad + off, off, off))]
    assert max(errs) < SEG_TOL, errs


# ----------------------- the whole-stack forward and the grouped backward

FUSED = [(True, 0, True), (True, 0, False), (True, 3, True), (True, 4, True),
         (False, 3, True), (True, 8, True)]  # (full_fusion, bwd_group, save_y)


@pytest.mark.parametrize("save_y,save_mids", [(True, True), (False, True),
                                              (False, False)])
def test_plain_stack_fused_matches_pallas(save_y, save_mids):
    """All five layers from x0 into a random incoming skip: skip, each mid
    and each y on the layer's valid rows; no mids and no ys when nothing is
    saved."""
    dils, cond_tm, packed, xs, _, _, j, jpk, (p_len, lpad, off, ncp) = _segment()
    n = len(dils)
    vl = [gated.valid_lo(dils, i) for i in range(n)]
    gen = torch.Generator().manual_seed(6)
    skip = torch.randn(*xs[0].shape[:2], KW["n_skp"], generator=gen)
    got = gated.gated_stack_fused_reference(
        xs[0], cond_tm, skip.clone(), packed, dils=dils, r0=vl[0], save_y=save_y,
        save_mids=save_mids)
    want = gp.gated_stack_fused(
        _jx(xs[0], lpad + off).astype(jnp.bfloat16), j["cond"], _jx(skip, off),
        tuple(jpk), dils=dils, t_min=(off + vl[0]) // TILE, tile=TILE,
        interpret=True, save_y=save_y, save_mids=save_mids)
    assert len(got[1]) == len(want[1]) == (n - 1 if save_mids else 0)
    assert len(got[2]) == len(want[2]) == (n if save_y and save_mids else 0)
    errs = [_cmp_rows(got[0], want[0], vl[-1], off)]
    errs += [_cmp_rows(g, w, vl[i], lpad + off)
             for i, (g, w) in enumerate(zip(got[1], want[1]))]
    errs += [_cmp_rows(g, w, vl[i], off) for i, (g, w) in enumerate(zip(got[2], want[2]))]
    assert max(errs) < SEG_TOL, errs
    for t in (*got[1], *got[2]):
        assert not t[:, : vl[0]].any()  # rows below r0 hold zeros


def _group_args(dils, xs, ys, packed, cot, i, k):
    """Layers [i, k) of the stack as one group: the plain version's keywords."""
    n, p = len(dils), xs[0].shape[1]
    return dict(dds=tuple(dils[i:k]), prev_dd=dils[k] if k < n else 0,
                valid_los=tuple(gated.valid_lo(dils, m) for m in range(i, k)),
                cur_valid_lo=gated.valid_lo(dils, k) if k < n else p)


@pytest.mark.parametrize("i,k", [(2, 5), (1, 4), (0, 5), (0, 4)])
def test_plain_group_bwd_matches_pallas(i, k):
    """Groups of 3, 4 and 5 layers, at the top of the stack (prev_dd = 0,
    no upstream) and below it: the three streams on the valid rows and all
    4G weight gradients."""
    dils, cond_tm, packed, xs, ys, cot, j, jpk, (p_len, lpad, off, ncp) = _segment()
    kw = _group_args(dils, xs, ys, packed, cot, i, k)
    c = {n: v.clone() for n, v in cot.items()}
    got = gated.gated_group_bwd_reference(
        tuple(xs[i:k]), cond_tm, c["gxcur"], c["gxprev"], c["gskip"], c["gcond"],
        tuple(packed[i:k]), tuple(ys[i:k]), **kw)
    top = k == len(dils)
    want = gp.gated_group_bwd(
        tuple(_jx(xs[m], lpad + off).astype(jnp.bfloat16) for m in range(i, k)),
        j["cond"], j["gxcur"], j["gxprev"], j["gskip"], j["gcond"],
        tuple(jpk[i:k]), tuple(_jx(ys[m], off).astype(jnp.bfloat16)
                               for m in range(i, k)),
        dds=kw["dds"], prev_dd=kw["prev_dd"], t_min=(off + kw["valid_los"][0]) // TILE,
        valid_los=tuple(off + v for v in kw["valid_los"]),
        cur_valid_lo=p_len if top else off + kw["cur_valid_lo"], tile=TILE,
        interpret=True)
    assert len(got) == len(want) == 3 + 4 * (k - i)
    lo, n_in = kw["valid_los"][0], 2 * KW["n_res"]
    errs = [_cmp_rows(got[0], want[0], lo, lpad + off),
            _cmp_rows(got[1], want[1], lo, lpad + off),
            _cmp_rows(got[2], want[2], 0, off)]
    errs += [_cmp_dw(got[3 + 4 * m : 7 + 4 * m], want[3 + 4 * m : 7 + 4 * m], n_in, ncp)
             for m in range(k - i)]
    assert max(errs) < SEG_TOL, errs


@pytest.mark.parametrize("i", [3, 1])
def test_plain_group_bwd_of_two_equals_the_pair_bwd(i):
    """G = 2 is the pair backward, bit for bit (at the top and below it)."""
    dils, cond_tm, packed, xs, ys, cot, *_ = _segment()
    kw = _group_args(dils, xs, ys, packed, cot, i, i + 2)
    a, b = ({n: v.clone() for n, v in cot.items()} for _ in range(2))
    got = gated.gated_group_bwd_reference(
        tuple(xs[i : i + 2]), cond_tm, a["gxcur"], a["gxprev"], a["gskip"],
        a["gcond"], tuple(packed[i : i + 2]), tuple(ys[i : i + 2]), **kw)
    want = gated.gated_pair_bwd_reference(
        xs[i], xs[i + 1], cond_tm, b["gxcur"], b["gxprev"], b["gskip"], b["gcond"],
        packed[i], packed[i + 1], ys[i], ys[i + 1], dd1=dils[i], dd2=dils[i + 1],
        prev_dd=kw["prev_dd"], valid_lo1=kw["valid_los"][0],
        valid_lo2=kw["valid_los"][1], cur_valid_lo=kw["cur_valid_lo"])
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("full_fusion,bwd_group,save_y", FUSED)
def test_fused_schedules_forward_matches_pallas(full_fusion, bwd_group, save_y):
    params, port, ids, cond, spk, _ = _setup()
    want = gp.stack_apply(params, JCFG, ids, cond, spk, tile=TILE, interpret=True,
                          save_y=save_y, full_fusion=full_fusion, bwd_group=bwd_group)
    before = gated.gated_stack_fused_reference.launches
    with torch.no_grad():
        got = gated.stack_apply(port, TCFG, _t(ids, True), _t(cond), _t(spk, True),
                                save_y=save_y, full_fusion=full_fusion,
                                bwd_group=bwd_group)
    assert gated.gated_stack_fused_reference.launches == before + int(full_fusion)
    assert got.shape == want.shape
    d = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert d < 0.05, d


@pytest.mark.parametrize("full_fusion,bwd_group,save_y", FUSED)
def test_fused_schedules_grads_match_xla(full_fusion, bwd_group, save_y):
    """Gradients through the whole-stack forward and the grouped backward
    (groups of 3 with a pair left over, of 4 with one layer left over, of 8
    = the whole stack) against XLA's bf16 stack."""
    _, port, ids, cond, spk, probe = _setup()
    ref = _jax_grads()["bf16"]
    port.zero_grad(set_to_none=True)
    c = _t(cond).clone().requires_grad_(True)
    before = gated.gated_group_bwd_reference.launches
    out = gated.stack_apply(port, TCFG, _t(ids, True), c, _t(spk, True),
                            save_y=save_y, full_fusion=full_fusion,
                            bwd_group=bwd_group)
    (out.float() * _t(probe)).mean().backward()
    assert (gated.gated_group_bwd_reference.launches > before) == (bwd_group >= 3)
    mine = {"p." + k: p.grad.numpy() for k, p in port.named_parameters()
            if p.grad is not None}
    mine["c"] = c.grad.numpy()
    keys = sorted(ref)
    assert set(mine) <= set(keys)
    fp = np.concatenate([np.ravel(mine[k]) if k in mine else np.zeros(ref[k].size)
                         for k in keys])
    fx = np.concatenate([np.ravel(ref[k]) for k in keys])
    assert np.isfinite(fp).all()
    assert np.abs(fp - fx).max() / np.abs(fx).max() < GRAD_REL_TOL


@pytest.mark.parametrize("n_layers,group,want", [
    (20, 5, [(0, 1, 2, 3, 4), (5, 6, 7, 8, 9), (10, 11, 12, 13, 14),
             (15, 16, 17, 18, 19)]),
    (8, 3, [(0, 1, 2), (3, 4, 5), (6, 7)]),
    (5, 4, [(0, 1, 2, 3), (4,)]),
    (5, 3, [(0, 1, 2), (3, 4)]),
])
def test_bwd_segments_of_the_grouped_schedule(n_layers, group, want):
    """Greedy runs of up to ``group`` layers; a run of 2 is a pair whatever
    fuse_pairs says, a run of 1 a single layer; the forward is one segment
    with full fusion; without saved y one layer per segment."""
    dils = tuple(2 ** (i % 10) for i in range(n_layers))
    for pairs in (True, False):
        s = gated.Schedule(dils, True, pairs, gated.PLAIN, True, group)
        assert s.bwd_segments() == want
        assert s.fwd_segments() == [tuple(range(n_layers))]
    s = gated.Schedule(dils, False, True, gated.PLAIN, True, group)
    assert s.bwd_segments() == [(i,) for i in range(n_layers)]
    s = gated.Schedule(dils, True, True, gated.PLAIN, True, 2)  # below 3: pairs
    assert s.bwd_segments() == gated.Schedule(dils, True, True, gated.PLAIN).fwd_segments()


def test_stack_forward_then_pair_backward_equals_the_pair_path():
    """The whole-stack forward leaves values on rows [vl_0, vl_i) of mid_i
    and y_i where the pair path leaves zeros; the pair backward masks them,
    so its gradients equal the pair path's within bf16 reduction order."""
    _, port, ids, cond, spk, probe = _setup()
    pr = _t(np.transpose(probe, (0, 2, 1)).copy())
    args = (port, TCFG, _t(ids, True), _t(cond), _t(spk, True), pr, gated.PLAIN)
    lg_a, g_a = gated_check.stack_run(*args, True, True, full_fusion=True)
    lg_b, g_b = gated_check.stack_run(*args, True, True)
    lg, rel = gated_check.stack_errors(lg_a, g_a, lg_b, g_b)
    assert lg < 1e-2 and rel < 1e-2, (lg, rel)


@pytest.mark.parametrize("rows,batch,dd2,sms,per_sm", [
    (49023, 4, 512, 132, 1),   # the top pair at the flagship training shape
    (49535, 4, 2, 132, 1),     # the bottom pair
    (4036, 2, 128, 132, 1),    # the smoke's B = 2 check
    (147, 3, 128, 132, 2),     # short rows: one chunk per batch row
    (50000, 5, 64, 132, 1),    # a batch that does not divide the card
    (1000, 200, 0, 132, 1),    # more batch rows than blocks: one chunk each
])
def test_chunk_plan_is_one_wave_and_covers_every_row(rows, batch, dd2, sms, per_sm):
    """The Hopper kernels' chunks: a multiple of the tile, at least the
    pair's dd2, every row covered by exactly one chunk, and all blocks of the
    launch resident at once (one wave) as far as the batch allows."""
    from ae_wavenet_tpu_torch.ops import gated_cuda

    chunk, n = gated_cuda._chunk(rows, batch, dd2, sms, per_sm)
    assert chunk % gated_cuda.TM == 0 and chunk >= dd2
    assert (n - 1) * chunk < rows <= n * chunk
    assert batch * n <= max(sms * per_sm, batch)


@pytest.mark.parametrize("rows,batch,sms,per_sm", [
    (50046 - 1, 4, 132, 1),    # the whole stack at the flagship training shape
    (50046 - 2046, 4, 132, 1), # a group at the top of the stack
    (4036, 2, 132, 1),         # the smoke's B = 2 check
    (132 * 64 + 1, 1, 132, 1), # one tile past a round: 131 blocks idle in it
    (147, 3, 132, 2),          # fewer tiles than blocks: one tile each
    (50000, 5, 114, 2),        # another card, two blocks an SM
    (1, 1, 132, 1),            # one row
])
def test_coop_plan_gives_every_tile_once_to_one_block(rows, batch, sms, per_sm):
    """The whole-stack forward's and the grouped backward's grid: every tile
    of a layer taken once, by the same block in every layer (each block adds
    to the rows it alone owns), no more blocks than the card holds at once,
    and no block more than one tile ahead of another."""
    from ae_wavenet_tpu_torch.ops import gated_cuda

    grid, n_tiles, most = gated_cuda.coop_plan(rows, batch, sms, per_sm)
    total = batch * n_tiles
    assert (n_tiles - 1) * gated_cuda.TM < rows <= n_tiles * gated_cuda.TM
    assert 1 <= grid <= min(sms * per_sm, total)

    def tiles(block):  # csrc/gated.cu: for (tile = blockIdx.x; ...; tile += gridDim.x)
        return range(block, total, grid)

    owners = []
    for _ in range(2):  # two layers
        owner = {}
        for block in range(grid):
            for tile in tiles(block):
                assert tile not in owner
                owner[tile] = block
        assert sorted(owner) == list(range(total))
        owners.append(owner)
    assert owners[0] == owners[1]
    counts = [len(tiles(block)) for block in range(grid)]
    assert max(counts) == most and max(counts) - min(counts) <= 1
