"""The fused gated stack's kernels: one layer, two layers, the whole stack
(forward) or a group of layers (backward).

Wrappers of ``csrc/gated.cu``, kernels written by hand for Hopper
(``sm_90a``) that replace the TPU kernels of
``ae_wavenet_tpu/ops/gated_pallas.py``: ``gated_pair_fused`` (K1),
``gated_layer_fused`` (K1b), ``gated_pair_bwd`` (K2), ``gated_layer_bwd``
(K2b), ``gated_stack_fused`` (K7) and ``gated_group_bwd`` (K8).  Their
signatures and contract are those of the plain versions in
``ops/gated.py``.

Each wrapper dispatches on the device of the tensors it is given: CUDA
tensors launch the kernel on the current stream (and raise on what it
cannot take or on a CUDA error), CPU tensors run the plain version.  Each
counts its kernel runs in ``.launches``.

The kernels choose their own tiles (64 rows per tile, chunks of rows per
block sized so that every block of a launch is resident at once); the
reference's ``gated_tile`` and ``gated_bwd_tile`` are TPU schedule knobs and
are not read.  Every kernel runs on one tile core (``wgmma`` fed by TMA) on
the weights as they are: K1, K1b, K7, K2, K2b in both modes, K8's
data-gradient tiles and every weight gradient.  K2b's recompute mode runs
the forward's gate pass ahead of each backward tile and keeps its f32 gate
in a per-block scratch (:func:`_rec_scratch`).  Shape limits:
``filter_sz == 2`` (K1b also takes WaveGlow's non-causal three-tap layer:
``cond`` None, ``w_in`` [3 n_res, 2 n_dil], an optional bf16 addend of y;
``gated_layer_fused.taps`` is the last call's taps, 3 or 2); n_res, n_cond,
n_dil and
n_skp multiples of 8 (16-byte rows); the widths' shared-memory footprint
within one block's 227 KB (a width past it raises ``ValueError``); the
grouped backward takes saved y only.  The pair backward keeps two tiles in
flight, one per consumer warpgroup, where two fit beside two ring stages
(:func:`bwd_plan`); ``gated_pair_bwd.tiles_in_flight`` is the last
launch's count.  The pair forward stages its epilogue traffic (y, the new
residual rows, the f32 skip rows) in shared memory and moves it by TMA
where the widths are multiples of 128 and the slots and two ring stages
fit (:func:`fwd_plan`);
``gated_pair_fused.staged_epilogue`` is the last launch's plan (1 staged,
0 not).  The whole-stack forward and the
grouped backward are cooperative launches of as many blocks as the card
holds at once (:func:`coop_plan`), with a barrier across the grid between
layers; a grid the card cannot hold raises.
"""

from __future__ import annotations

import ctypes

import torch

from ae_wavenet_tpu_torch.ops import gated

TM = 64                 # csrc/gated.cu: rows per tile
SMEM_LIMIT = 232448     # bytes of shared memory one block may use (H100)
BF16 = torch.bfloat16
# csrc/gated.cu's shared-memory layout: a 64 x 64 bf16 atom, a ring stage,
# the most stages, the ring's barriers, the alignment slack
ATOM, SLAB, MAX_STAGES, BAR_BYTES, ALIGN = 8192, 32768, 4, 64, 1024
# the pair forward's staged epilogue: the most slots, the f32 skip columns
# of one slot, the skip rows' barrier
MAX_SLOTS, SKIP_BOX, SKIP_BAR = 16, 32, 8


def _dims(x: torch.Tensor, cond: torch.Tensor | None, w_in: torch.Tensor,
          w_out: torch.Tensor) -> list:
    """[B, P, n_res, n_cond, n_dil, n_skp]: the kernels' six dims (n_cond =
    n_res in K1b's three-tap mode, ``cond`` None: the next tap takes the
    cond part's place)."""
    b, p, r = x.shape
    c = r if cond is None else cond.shape[-1]
    return [b, p, r, c, w_in.shape[1] // 2, w_out.shape[1] - r]


def _cast_weights(w_in, b_in, w_out, b_out):
    """Packed f32 weights -> what the Hopper kernels read: w_in [2R + C, 2D]
    and w_out [D, R + S] bf16 as they are (TMA zero-fills past the edges),
    biases f32 (zeros when absent)."""
    def bias(v, n):
        if v is None:
            return torch.zeros(n, device=w_in.device)
        return v.detach().float().contiguous()

    cast = lambda w: w.detach().to(BF16, memory_format=torch.contiguous_format)  # noqa: E731
    return (cast(w_in), bias(b_in, w_in.shape[1]), cast(w_out),
            bias(b_out, w_out.shape[1]))


def _check(dims, tensors: dict, smem: int) -> None:
    b, p, r, c, d, s = dims[:6]
    want = {"x": ((b, p, r), BF16), "cond": ((b, p, c), BF16),
            "skip": ((b, p, s), torch.float32), "gskip": ((b, p, s), BF16),
            "gcond": ((b, p, c), torch.float32), "y": ((b, p, 2 * d), BF16),
            "addend": ((b, p, 2 * d), BF16)}
    dev = None
    for name, v in tensors.items():
        if v is None:
            continue
        dev = v.device if dev is None else dev
        if v.device != dev:
            raise ValueError(f"{name} is on {v.device}, the others on {dev}")
        if v.device.type != "cuda":
            raise ValueError(f"{name}: the gated kernels take CUDA tensors, "
                             f"got {v.device}")
        shape, dtype = want.get(name.rstrip("0123456789"), (None, None))
        if shape is not None and (tuple(v.shape) != shape or v.dtype != dtype):
            raise ValueError(f"{name}: {tuple(v.shape)} {v.dtype}, the kernel "
                             f"takes {shape} {dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, n in (("n_res", r), ("n_cond", c), ("n_dil", d), ("n_skp", s)):
        if n % 8:
            raise ValueError(f"{name}={n}: the gated kernels take widths that "
                             "are multiples of 8 (16-byte row loads)")
    if smem > SMEM_LIMIT:
        raise ValueError(f"these widths need {smem} bytes of shared memory per "
                         f"block; the kernel has at most {SMEM_LIMIT}")


def _ring(tile_bytes: int, bars: int = BAR_BYTES) -> tuple[int, int]:
    """csrc/gated.cu ``ring_layout``: (ring stages, bytes) beside
    ``tile_bytes`` of tiles and ``bars`` bytes of barriers; bytes past
    SMEM_LIMIT when two stages do not fit."""
    stages = min(int((SMEM_LIMIT - ALIGN - bars - tile_bytes) / SLAB), MAX_STAGES)
    if stages < 2:
        return stages, SMEM_LIMIT + 1
    return stages, ALIGN + tile_bytes + stages * SLAB + bars


def fwd_plan(n_res: int, n_dil: int, n_skp: int, n_cond: int) -> tuple[bool, int, int]:
    """The pair forward's plan from the widths alone (csrc/gated.cu
    ``fwd_staged_layout`` and ``fwd_layout``): (epilogue staged, ring
    stages, shared-memory bytes).  A tile is xin [64, 2 n_res + n_cond] in
    64-column atoms, h over its prev part where one gate pass writes it and
    it fits there.  Staged, y (2 n_dil wide) and the f32 skip rows (boxes of
    SKIP_BOX columns) pass through 8 KB slots: xin's prev atoms beyond h,
    its cond part, and the rest after xin; that plan is taken where n_res,
    n_dil and n_skp are multiples of 128 (so the epilogues test nothing per
    element), h goes over prev, the slots are at most MAX_SLOTS and two ring
    stages fit.  Else the epilogue stores from the registers, as the other
    forward kernels do.  Raises ValueError where not even that tile fits."""
    ra, ca, da = -(-n_res // 64), -(-n_cond // 64), -(-n_dil // 64)
    xin = (2 * ra + ca) * ATOM
    alias = -(-n_dil // 128) <= 2 and da <= ra
    need = max(-(-2 * n_dil // 64), -(-n_skp // SKIP_BOX))
    aligned = n_res % 128 == 0 and n_dil % 128 == 0 and n_skp % 128 == 0
    if aligned and alias and need <= MAX_SLOTS:
        extra = max(need - (ra - da + ca), 0)
        stages, nbytes = _ring(xin + extra * ATOM, BAR_BYTES + SKIP_BAR)
        if stages >= 2:
            return True, stages, nbytes
    tile = xin if alias else xin + da * ATOM
    stages, nbytes = _ring(tile)
    if stages >= 2:
        return False, stages, nbytes
    raise ValueError(f"these widths need {ALIGN + tile + 2 * SLAB + BAR_BYTES} bytes "
                     f"of shared memory per block; the kernel has at most {SMEM_LIMIT}")


def bwd_plan(n_res: int, n_dil: int, n_skp: int) -> tuple[int, int, int]:
    """The pair backward's plan from the widths alone (csrc/gated.cu
    ``bwd_layout``, which refuses a plan that does not fit): (tiles in
    flight, ring stages, shared-memory bytes).  A tile is g_out [64, n_res + n_skp] and g_y
    [64, 2 n_dil] in 64-column atoms, g_y over g_out where one g_h pass
    writes it and it fits there.  Two tiles go in flight, one per consumer
    warpgroup, where two tiles and two ring stages fit; else one, as in the
    other backward kernels.  Raises ValueError where even one does not fit."""
    go = -(-(n_res + n_skp) // 64) * ATOM
    gy = -(-2 * n_dil // 64) * ATOM
    tile = go if -(-n_dil // 128) <= 2 and gy <= go else go + gy
    for tiles in (2, 1):
        stages, nbytes = _ring(tiles * tile)
        if stages >= 2:
            return tiles, stages, nbytes
    raise ValueError(f"these widths need {ALIGN + tile + 2 * SLAB + BAR_BYTES} bytes "
                     f"of shared memory per block; the kernel has at most {SMEM_LIMIT}")


def _chunk(rows: int, batch: int, dd2: int, sms: int, per_sm: int) -> tuple[int, int]:
    """Rows per block (a multiple of the tile, at least the pair's dd2, so a
    halo spans one neighbouring chunk) and the number of chunks per batch
    row, so that the batch's blocks fit the card at once (``sms`` SMs
    holding ``per_sm`` blocks each): one wave, as far as the batch allows."""
    per_row = max(1, sms * per_sm // batch)
    chunk = max(-(-rows // per_row), dd2, TM)
    chunk = -(-chunk // TM) * TM
    return chunk, -(-rows // chunk)


def coop_plan(rows: int, batch: int, sms: int, per_sm: int) -> tuple[int, int, int]:
    """The whole-stack forward's and the grouped backward's grid: every layer
    has ``batch`` x ceil(``rows`` / TM) tiles, and tile t goes to block t mod
    grid in every layer (``csrc/gated.cu``: ``tile = blockIdx.x; tile +=
    gridDim.x``); the grid is as many blocks as the card holds at once
    (``sms`` SMs holding ``per_sm`` each), or one per tile.  -> (grid, tiles
    per batch row, the most tiles a block takes in a layer)."""
    n_tiles = -(-rows // TM)
    total = batch * n_tiles
    grid = max(1, min(sms * per_sm, total))
    return grid, n_tiles, -(-total // grid)


_BLOCKS: dict = {}
# awt_gated_wg_blocks: the forward, the backward (saved y), the whole stack,
# the group, the single-layer backward's recompute mode, the pair backward
# with two tiles in flight, the pair forward with its epilogue staged, K1b's
# three-tap mode
_KINDS = {"fwd": 0, "bwd": 1, "stack": 2, "group": 3, "bwd_rec": 4, "bwd2": 5,
          "fwd2": 6, "same": 7}


def _per_sm(kind: str, dims) -> int:
    """Blocks of the kernel ``kind`` one SM holds at these widths
    (memoised)."""
    from ae_wavenet_tpu_torch.ops import _build

    key = (kind, tuple(dims[2:6]))
    if key not in _BLOCKS:
        n = _build.load().awt_gated_wg_blocks(_KINDS[kind], _ints(*dims))
        if n < 1:
            raise RuntimeError(f"occupancy query failed: CUDA error {-n}"
                               if n < 0 else f"no {kind} block fits on an SM at "
                               f"widths {dims[2:6]}")
        _BLOCKS[key] = n
    return _BLOCKS[key]


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _plan(dev, kind: str, dims, rows: int, batch: int, dd2: int) -> tuple[int, int]:
    """``_chunk`` from the card's SM count and the kernel's occupancy at
    these widths (kind "fwd", "fwd2", "same", "bwd", "bwd2" or "bwd_rec")."""
    return _chunk(rows, batch, dd2, _sms(dev), _per_sm(kind, dims))


def _coop_grid(dev, kind: str, dims, rows: int, batch: int) -> int:
    """:func:`coop_plan`'s grid for the Hopper kernel ``kind`` ("stack" or
    "group") on this card."""
    return coop_plan(rows, batch, _sms(dev), _per_sm(kind, dims))[0]


def _head_zeroed(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with rows [0, rows) of its time axis set to zero."""
    t[:, :rows] = 0
    return t


def _ptrs(*ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(
        *(None if t is None else t.data_ptr() for t in ts))


def _ints(*v) -> ctypes.Array:
    return (ctypes.c_int * len(v))(*(int(i) for i in v))


def _call(fn_name: str, nl, ptrs, ints, dev) -> None:
    from ae_wavenet_tpu_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        fn = getattr(lib, fn_name)
        rc = fn(ptrs, ints, stream) if nl is None else fn(nl, ptrs, ints, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc} "
                           f"({lib.awt_cuda_error_string(rc).decode()})")


def _smem(fn_name: str, dims) -> int:
    from ae_wavenet_tpu_torch.ops import _build

    return getattr(_build.load(), fn_name)(_ints(*dims))


# ---------------------------------------------------------------- forward

def _fwd(nl, x, cond, skip, pks, dds, r0, save_y, addend=None):
    dims = _dims(x, cond, pks[0][0], pks[0][2])
    taps = 3 if cond is None else 2
    if taps == 3 and (nl != 1 or r0 or save_y
                      or pks[0][0].shape[0] != 3 * dims[2]):
        raise ValueError("the three-tap mode is one layer on every row (r0 = 0), "
                         "saves no y and takes w_in [3 n_res, 2 n_dil]")
    _check(dims, {"x": x, "cond": cond, "skip": skip, "addend": addend},
           _smem("awt_gated_wg_same_smem" if taps == 3 else "awt_gated_wg_fwd_smem", dims))
    b, p, r, c, d, s = dims
    dev = x.device
    staged = nl == 2 and fwd_plan(r, d, s, c)[0]
    chunk, n_chunks = _plan(dev, "fwd2" if staged else "same" if taps == 3 else "fwd", dims,
                            p - r0, b, dds[-1] if nl == 2 else 0)
    # the kernel writes rows [r0, P) of every output; rows below hold zeros
    outs = [_head_zeroed(torch.empty_like(x), r0) for _ in range(nl)]  # (mid,) x'
    ys = ([_head_zeroed(x.new_empty(b, p, 2 * d), r0) for _ in range(nl)]
          if save_y else [])
    halo = (torch.empty(b * n_chunks, dds[1], r, dtype=BF16, device=dev)
            if nl == 2 else None)
    layers = []
    for l in range(2):
        if l < nl:
            layers += [*_cast_weights(*pks[l]), ys[l] if save_y else None]
        else:
            layers += [None] * 5
    _call("awt_gated_fwd", nl,
          _ptrs(x, cond, skip, outs[0] if nl == 2 else None, outs[-1], halo, *layers,
                addend),
          _ints(*dims, r0, chunk, dds[0], dds[1] if nl == 2 else 0, n_chunks,
                int(staged), taps), dev)
    if nl == 2:
        gated_pair_fused.staged_epilogue = int(staged)
    return (*outs, skip, *ys)


def gated_layer_fused(x, cond, skip, w_in, b_in, w_out, b_out, *, dd: int,
                      r0: int, save_y: bool = False, addend=None):
    """K1b: one gated layer forward; see ``gated.gated_layer_fused_reference``
    (``cond`` None: the non-causal three-tap mode, with ``addend``).
    ``.taps``: the last call's taps."""
    gated_layer_fused.taps = 2 if cond is not None else 3
    if x.device.type == "cpu":
        return gated.gated_layer_fused_reference(
            x, cond, skip, w_in, b_in, w_out, b_out, dd=dd, r0=r0, save_y=save_y,
            addend=addend)
    out = _fwd(1, x, cond, skip, [(w_in, b_in, w_out, b_out)], (dd,), r0, save_y, addend)
    gated_layer_fused.launches += 1
    return out


def gated_pair_fused(x, cond, skip, pk1, pk2, *, dd1: int, dd2: int, r0: int,
                     save_y: bool = False):
    """K1: two gated layers forward; see ``gated.gated_pair_fused_reference``.
    ``.staged_epilogue``: the last launch's plan (:func:`fwd_plan`)."""
    if x.device.type == "cpu":
        return gated.gated_pair_fused_reference(
            x, cond, skip, pk1, pk2, dd1=dd1, dd2=dd2, r0=r0, save_y=save_y)
    out = _fwd(2, x, cond, skip, [pk1, pk2], (dd1, dd2), r0, save_y)
    gated_pair_fused.launches += 1
    return out


def _check_depth(n: int, what: str) -> None:
    """The fused kernels take their per-layer tables (tensor maps and
    pointers) by value in the launch's parameters, which bounds the layers of
    one launch (``awt_gated_max_fused_layers``)."""
    from ae_wavenet_tpu_torch.ops import _build

    most = _build.load().awt_gated_max_fused_layers()
    if n > most:
        raise ValueError(f"{what} takes at most {most} layers in one launch, "
                         f"got {n}")


def gated_stack_fused(x, cond, skip, packed, *, dils, r0: int,
                      save_y: bool = False, save_mids: bool = True):
    """K7: every gated layer forward in one launch; see
    ``gated.gated_stack_fused_reference``."""
    if x.device.type == "cpu":
        return gated.gated_stack_fused_reference(
            x, cond, skip, packed, dils=dils, r0=r0, save_y=save_y,
            save_mids=save_mids)
    n = len(dils)
    if n < 2 or len(packed) != n:
        raise ValueError(f"the whole-stack forward takes two or more layers and "
                         f"one weight set each, got {n} dilations and "
                         f"{len(packed)} weight sets")
    _check_depth(n, "the whole-stack forward")
    dims = _dims(x, cond, packed[0][0], packed[0][2])
    _check(dims, {"x": x, "cond": cond, "skip": skip},
           _smem("awt_gated_wg_fwd_smem", dims))
    b, p, _, _, d = dims[:5]
    if not 0 <= r0 < p:
        raise ValueError(f"r0={r0} leaves no rows of {p}")
    dev = x.device

    def stream(width):
        t = torch.empty(b, p, width, dtype=BF16, device=dev)
        t[:, :r0] = 0
        return t

    save_y = save_y and save_mids
    mids = [stream(x.shape[2]) for _ in range(n - 1 if save_mids else min(2, n - 1))]
    ys = [stream(2 * d) for _ in range(n)] if save_y else []
    layers = []
    for l in range(n):
        src = x if l == 0 else mids[(l - 1) % len(mids)]
        dst = None if l == n - 1 else mids[l % len(mids)]
        layers += [*_cast_weights(*packed[l]), ys[l] if save_y else None, src, dst]
    bar = torch.zeros(1, dtype=torch.int64, device=dev)
    grid = _coop_grid(dev, "stack", dims, p - r0, b)
    _call("awt_gated_stack", None, _ptrs(cond, skip, bar, *layers),
          _ints(*dims, n, r0, grid, *dils), dev)
    gated_stack_fused.launches += 1
    return skip, tuple(mids) if save_mids else (), tuple(ys)


# --------------------------------------------------------------- backward

def _dw(kind, lo, g, n, m, x=None, cond=None, dd=0, a=None):
    """(f32 [m, n] = A^T G, f32 [n] = column sums of G) over rows [lo, P)
    of every batch row, where A is xin (kind 0, gathered from x and cond)
    or ``a`` (kind 1): a weight gradient and its bias gradient, in one
    launch (and two fixed-order reductions of its split-K partials)."""
    b, p = g.shape[:2]
    r = x.shape[2] if x is not None else 0
    c = cond.shape[2] if cond is not None else 0
    ka = a.shape[2] if a is not None else 0
    # output tiles of 128 x 256 over A's columns, each part padded to 64
    atoms = 2 * -(-r // 64) + -(-c // 64) if kind == 0 else -(-ka // 64)
    tiles = -(-atoms // 2) * -(-n // 256)
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    splits = max(1, min(sms // tiles, b * -(-(p - lo) // 64)))
    f32 = dict(device=g.device, dtype=torch.float32)
    part, out = torch.empty(splits, m, n, **f32), torch.empty(m, n, **f32)
    part_b, out_b = torch.empty(splits, n, **f32), torch.empty(n, **f32)
    _call("awt_gated_dw", None, _ptrs(x, cond, a, g, part, out, part_b, out_b),
          _ints(b, p, lo, kind, dd, r, c, ka, n, m, splits), g.device)
    return out, out_b


def _scratch(dims, dev) -> tuple:
    """One layer's g_y, h and g_out (bf16), which the backward kernel writes
    for the weight-gradient products."""
    b, p, r, _, d, s = dims[:6]
    return (torch.empty(b, p, 2 * d, dtype=BF16, device=dev),
            torch.empty(b, p, d, dtype=BF16, device=dev),
            torch.empty(b, p, r + s, dtype=BF16, device=dev))


def _weight_grads(dims, saved: list, xs, cond, dds, vls) -> list:
    """Per layer (dW_in, db_in, dW_out, db_out) from its ``_scratch``;
    empties ``saved``, so each layer's buffers go back to the allocator as
    soon as its products are queued."""
    r, c, d, s = dims[2:6]
    grads = []
    for l in range(len(saved)):
        gy, h, gout = saved[l]
        saved[l] = None
        dwi, dbi = _dw(0, vls[l], gy, 2 * d, 2 * r + c, x=xs[l], cond=cond, dd=dds[l])
        dwo, dbo = _dw(1, vls[l], gout, r + s, d, a=h)
        grads += [dwi, dbi, dwo, dbo]
    return grads


def _rec_scratch(dims, blocks: int, dev) -> torch.Tensor:
    """The recompute mode's gate scratch: per block of the launch, f32
    tanh(y_f) and sigmoid(y_g) for one 64-row tile (``awt_gated_rec_slots``
    float4 each, 128 KB at n_dil 256), reused tile after tile."""
    from ae_wavenet_tpu_torch.ops import _build

    slots = _build.load().awt_gated_rec_slots(_ints(*dims))
    return torch.empty(blocks * slots * 4, device=dev, dtype=torch.float32)


def _bwd(nl, xs, cond, gxcur, gxprev, gskip, gcond, pks, ys, dds, vls,
         prev_dd, cur_valid_lo):
    dims = _dims(xs[0], cond, pks[0][0], pks[0][2])
    recompute = ys[0] is None
    tensors = {"x1": xs[0], "cond": cond, "gxcur": gxcur, "gxprev": gxprev,
               "gskip": gskip, "gcond": gcond, "y1": ys[0]}
    if nl == 2:
        tensors.update(x2=xs[1], y2=ys[1])
    _check(dims, tensors, _smem("awt_gated_wg_bwd_rec_smem" if recompute
                                else "awt_gated_wg_bwd_smem", dims))
    for v, name in ((gxcur, "gxcur"), (gxprev, "gxprev")):
        if tuple(v.shape) != tuple(xs[0].shape) or v.dtype != BF16:
            raise ValueError(f"{name}: {tuple(v.shape)} {v.dtype}, the kernel "
                             f"takes {tuple(xs[0].shape)} {BF16}")
    b, p, r = dims[:3]
    dev = xs[0].device
    r0 = vls[0]
    tiles = bwd_plan(r, dims[4], dims[5])[0] if nl == 2 else 1
    kind = "bwd_rec" if recompute else "bwd2" if tiles == 2 else "bwd"
    chunk, n_chunks = _plan(dev, kind, dims, p - r0, b, dds[-1] if nl == 2 else 0)
    gxc, gxp = (_head_zeroed(torch.empty_like(xs[0]), r0) for _ in range(2))
    saved = [_scratch(dims, dev) for _ in range(nl)]
    f32 = dict(device=dev, dtype=torch.float32)
    gcur2 = torch.empty(b, p, r, **f32) if nl == 2 else None
    gp2 = torch.empty(b, p, r, **f32) if nl == 2 else None
    cast = [_cast_weights(*pk) for pk in pks]
    layers = []
    for l in range(2):
        layers += ([ys[l], cast[l][0], cast[l][2], *saved[l]] if l < nl
                   else [None] * 6)
    # the recompute mode (one layer, no saved y) reads x, b_in and its scratch
    rec = ([xs[0], cast[0][1], _rec_scratch(dims, b * n_chunks, dev)] if recompute
           else [None] * 3)
    ints = [*dims, prev_dd, cur_valid_lo, r0, chunk, dds[0], vls[0],
            dds[1] if nl == 2 else 0, vls[1] if nl == 2 else 0, n_chunks, tiles]
    _call("awt_gated_bwd", nl,
          _ptrs(cond, gxcur, gxprev, gskip, gcond, gxc, gxp, gcur2, gp2, *layers,
                *rec), _ints(*ints), dev)
    if nl == 2:
        gated_pair_bwd.tiles_in_flight = tiles
    del cast, layers, rec
    return (gxc, gxp, gcond, *_weight_grads(dims, saved, xs, cond, dds, vls))


def gated_layer_bwd(x, cond, gxcur, gxprev, gskip, gcond, w_in, w_out, b_in, *,
                    dd: int, prev_dd: int, valid_lo: int, cur_valid_lo: int,
                    y_saved=None):
    """K2b: one gated layer backward, saved-y or recompute mode; see
    ``gated.gated_layer_bwd_reference``.  ``.launches`` counts both modes,
    ``.launches_recompute`` the recompute mode's kernel alone."""
    if x.device.type == "cpu":
        return gated.gated_layer_bwd_reference(
            x, cond, gxcur, gxprev, gskip, gcond, w_in, w_out, b_in, dd=dd,
            prev_dd=prev_dd, valid_lo=valid_lo, cur_valid_lo=cur_valid_lo,
            y_saved=y_saved)
    out = _bwd(1, (x,), cond, gxcur, gxprev, gskip, gcond,
               [(w_in, b_in, w_out, None)], (y_saved,), (dd,), (valid_lo,),
               prev_dd, cur_valid_lo)
    gated_layer_bwd.launches += 1
    gated_layer_bwd.launches_recompute += int(y_saved is None)
    return out


def gated_pair_bwd(x1, x2, cond, gxcur, gxprev, gskip, gcond, pk1, pk2, y1, y2,
                   *, dd1: int, dd2: int, prev_dd: int, valid_lo1: int,
                   valid_lo2: int, cur_valid_lo: int):
    """K2: two gated layers backward (saved-y); see
    ``gated.gated_pair_bwd_reference``.  ``.tiles_in_flight``: the last
    launch's plan (:func:`bwd_plan`)."""
    if x1.device.type == "cpu":
        return gated.gated_pair_bwd_reference(
            x1, x2, cond, gxcur, gxprev, gskip, gcond, pk1, pk2, y1, y2,
            dd1=dd1, dd2=dd2, prev_dd=prev_dd, valid_lo1=valid_lo1,
            valid_lo2=valid_lo2, cur_valid_lo=cur_valid_lo)
    if y1 is None or y2 is None:
        raise ValueError("the pair backward takes saved y (no recompute mode)")
    out = _bwd(2, (x1, x2), cond, gxcur, gxprev, gskip, gcond,
               [(pk1[0], pk1[1], pk1[2], None), (pk2[0], pk2[1], pk2[2], None)],
               (y1, y2), (dd1, dd2), (valid_lo1, valid_lo2), prev_dd,
               cur_valid_lo)
    gated_pair_bwd.launches += 1
    return out


def gated_group_bwd(xs_g, cond, gxcur, gxprev, gskip, gcond, pks, ys_g, *, dds,
                    prev_dd: int, valid_los, cur_valid_lo: int):
    """K8: two or more consecutive gated layers backward in one launch
    (saved y); see ``gated.gated_group_bwd_reference``."""
    if xs_g[0].device.type == "cpu":
        return gated.gated_group_bwd_reference(
            xs_g, cond, gxcur, gxprev, gskip, gcond, pks, ys_g, dds=dds,
            prev_dd=prev_dd, valid_los=valid_los, cur_valid_lo=cur_valid_lo)
    n = len(dds)
    if n < 2 or not (len(xs_g) == len(pks) == len(ys_g) == len(valid_los) == n):
        raise ValueError(f"the grouped backward takes two or more layers with a "
                         f"stream, a weight set, a y and a valid_lo each, got "
                         f"{n} dilations")
    if any(y is None for y in ys_g):
        raise ValueError("the grouped backward takes saved y (no recompute mode)")
    _check_depth(n, "the grouped backward")
    dims = _dims(xs_g[0], cond, pks[0][0], pks[0][2])
    tensors = {"cond": cond, "gxcur": gxcur, "gxprev": gxprev, "gskip": gskip,
               "gcond": gcond}
    for l in range(n):
        tensors[f"x{l + 1}"], tensors[f"y{l + 1}"] = xs_g[l], ys_g[l]
    _check(dims, tensors, _smem("awt_gated_wg_bwd_smem", dims))
    for v, name in ((gxcur, "gxcur"), (gxprev, "gxprev")):
        if tuple(v.shape) != tuple(xs_g[0].shape) or v.dtype != BF16:
            raise ValueError(f"{name}: {tuple(v.shape)} {v.dtype}, the kernel "
                             f"takes {tuple(xs_g[0].shape)} {BF16}")
    b, p, r = dims[:3]
    dev = xs_g[0].device
    gxc, gxp = torch.zeros_like(xs_g[0]), torch.zeros_like(xs_g[0])
    inner = [torch.empty(b, p, r, device=dev) for _ in range(3)]  # gcur, gp0, gp1
    layers, saved = [], []
    for l in range(n):
        win, _, wout, _ = _cast_weights(*pks[l])
        saved.append(_scratch(dims, dev))
        layers += [ys_g[l], win, wout, *saved[-1]]
    bar = torch.zeros(1, dtype=torch.int64, device=dev)
    grid = _coop_grid(dev, "group", dims, p - valid_los[0], b)
    _call("awt_gated_group", None,
          _ptrs(cond, gxcur, gxprev, gskip, gcond, gxc, gxp, *inner, bar, *layers),
          _ints(*dims, n, prev_dd, cur_valid_lo, valid_los[0], grid,
                *(v for l in range(n) for v in (dds[l], valid_los[l]))), dev)
    del inner, layers
    grads = _weight_grads(dims, saved, xs_g, cond, dds, valid_los)
    gated_group_bwd.launches += 1
    return (gxc, gxp, gcond, *grads)


for _f in (gated_layer_fused, gated_pair_fused, gated_layer_bwd, gated_pair_bwd,
           gated_stack_fused, gated_group_bwd):
    _f.launches = 0
gated_layer_bwd.launches_recompute = 0
gated_pair_bwd.tiles_in_flight = 0
gated_pair_fused.staged_epilogue = 0
gated_layer_fused.taps = 0
