"""The sampler grid's share plan (``fastgen_cuda.share_plan``) and the
shares it lays out (``pack_shares``), on the CPU: block counts, bytes,
column ownership and the bytes of every owned column against the packed
weights.  The kernel reads the same layout on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``)."""

import dataclasses

import pytest
import torch

from ae_wavenet_tpu_torch.models import wavenet as twn
from ae_wavenet_tpu_torch.ops import fastgen_cuda as tfc
from ae_wavenet_tpu_torch.utils.config import (WaveNetConfig, chorowski_config,
                                               tiny_config)

H100_SMS, H100_SMEM = 132, 232_448
CHOROWSKI = chorowski_config().wavenet
CFGS = {
    "chorowski": CHOROWSKI,
    "tiny": tiny_config().wavenet,
    # tests/test_torch_cuda.py's two widths
    "scalar": WaveNetConfig(n_blocks=2, n_block_layers=4, n_res=48, n_dil=40,
                            n_skp=24, n_post=32, n_lc_out=12, n_global_embed=4,
                            n_speakers=5),
    "vector": WaveNetConfig(n_blocks=2, n_block_layers=4, n_res=64, n_dil=64,
                            n_skp=64, n_post=64, n_lc_out=12, n_global_embed=4,
                            n_speakers=5),
}
MODES = [None, "int8", "int4"]
# matrix -> its number of output columns
COLUMNS = {"w_in": lambda c: 2 * c.n_dil, "w_out": lambda c: c.n_res + c.n_skp,
           "post1": lambda c: c.n_post, "post2": lambda c: c.n_quant}
OWNERS = {"w_in": ("filter", "gate"), "w_out": ("res", "skip"),
          "post1": ("post1",), "post2": ("post2",)}


def _plan(cfg, mode, n_sms=H100_SMS, smem=H100_SMEM):
    return tfc.plan_for(cfg, mode, n_sms, smem)


@pytest.mark.parametrize("mode,share_bytes", [(None, 201_728), ("int8", 104_448),
                                              ("int4", 55_808)])
def test_chorowski_plan_on_an_h100(mode, share_bytes):
    """128 blocks, each owning 2 filter, 2 gate, 3 residual, 2 skip and 2 + 2
    post-net columns; every layer resident: 201,728 bytes in bf16 (928
    input rows x 4 columns + 256 x 5, x 2 bytes x 20 layers, + 2,048 of
    post-net), about a half and a quarter of that quantized (columns padded
    to whole 64-byte chunks: 960 and 512 bytes of w_in per column)."""
    plan = _plan(CHOROWSKI, mode)
    assert plan.n_blocks == 128
    for r in (0, 77, 127):
        assert [plan.n_cols(n, r) for n in tfc.SHARES] == [2, 2, 3, 2, 2, 2]
    assert plan.resident_layers == 20
    assert plan.resident_bytes == share_bytes == plan.stride
    assert plan.smem_bytes <= H100_SMEM


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("mode", MODES)
def test_every_column_has_one_owner(name, mode):
    cfg = CFGS[name]
    plan = _plan(cfg, mode)
    assert 1 <= plan.n_blocks <= H100_SMS
    for matrix, shares in OWNERS.items():
        owners = torch.zeros(COLUMNS[matrix](cfg), dtype=torch.int64)
        for r in range(plan.n_blocks):
            for share in shares:
                lo, hi = plan.cols(share, r)
                assert 0 <= lo <= hi <= len(owners)
                owners[lo:hi] += 1
        assert bool((owners == 1).all()), (matrix, owners.tolist())
    assert plan.smem_bytes <= H100_SMEM


def test_uneven_widths_leave_blocks_without_columns():
    """No count near the SM count divides 48, 40 and 24: 132 blocks split
    each width as evenly as integers allow, and most own no filter column."""
    plan = _plan(CFGS["scalar"], None)
    assert plan.n_blocks == H100_SMS
    counts = [plan.n_cols("filter", r) for r in range(plan.n_blocks)]
    assert sum(counts) == 40 and set(counts) == {0, 1}


@pytest.mark.parametrize("mode", MODES)
def test_forty_layers_are_resident_in_part(mode):
    """``n_blocks=4`` at the ``chorowski`` widths: about 51 MB of bf16
    weights.  The shares of the first layers fill shared memory; the rest
    stay in global memory (in the stride), read by the same kernel."""
    cfg = dataclasses.replace(CHOROWSKI, n_blocks=4)
    plan = _plan(cfg, mode)
    n_layers = len(cfg.dilations)
    assert n_layers == 40 and plan.n_blocks == 128
    layer, post = plan.layer_bytes(0), plan.post_bytes(0)
    if mode is None:
        assert 0 < plan.resident_layers < n_layers
    else:  # half and a quarter of the bytes: every layer fits
        assert plan.resident_layers == (n_layers if mode == "int4" else
                                        plan.resident_layers)
    assert plan.resident_bytes == post + plan.resident_layers * layer
    assert plan.stride == post + n_layers * layer
    assert plan.smem_bytes <= H100_SMEM
    assert plan.smem_bytes + layer > H100_SMEM or plan.resident_layers == n_layers


def test_bf16_forty_layers_keep_twenty_one_resident():
    plan = _plan(dataclasses.replace(CHOROWSKI, n_blocks=4), None)
    assert plan.resident_layers == 21 and plan.resident_bytes == 2_048 + 21 * 9_984


@pytest.mark.parametrize("width", [8192, 16384])
def test_a_width_no_block_can_take_raises(width):
    """The post-net's share alone passes one block's shared memory."""
    cfg = dataclasses.replace(CHOROWSKI, n_skp=width, n_post=width, n_quant=width)
    with pytest.raises(ValueError, match="no block layout"):
        _plan(cfg, None)


def test_a_layer_share_past_shared_memory_stays_global():
    """n_res 8,192: one layer's share (4 input columns of 16,544 rows and 66
    of 256) passes shared memory; every layer is read from global memory
    and only the post-net is resident."""
    plan = _plan(dataclasses.replace(CHOROWSKI, n_res=8192), None)
    assert plan.resident_layers == 0
    assert plan.resident_bytes == max(plan.post_bytes(r) for r in range(plan.n_blocks))
    assert plan.smem_bytes <= H100_SMEM


def test_plan_refuses_empty_widths():
    with pytest.raises(ValueError):
        tfc.share_plan(0, 8, 8, 8, 8, 4, 2, None, H100_SMS, H100_SMEM)


def _column_bytes(w: torch.Tensor, col: int, n_bytes: int) -> torch.Tensor:
    """Column ``col`` of w [K, N] as the kernel reads it: its K values'
    bytes, zero-padded to n_bytes."""
    raw = w[:, col].contiguous().view(torch.uint8)
    return torch.nn.functional.pad(raw, (0, n_bytes - raw.numel()))


@pytest.mark.parametrize("name", ["scalar", "vector", "tiny"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_sms", [8, 132])
def test_shares_hold_the_owned_columns(name, mode, n_sms):
    """Every owned column of every block, at the offset the kernel computes
    (post1, post2, then per layer filter, gate, res, skip), holds exactly
    the packed weights' column, K-major and zero-padded; the rest of the
    stride is zero."""
    cfg = CFGS[name]
    wn = twn.WaveNet(cfg, torch.Generator().manual_seed(0))
    packed = tfc.PACKERS[mode](wn, cfg)
    plan = _plan(cfg, mode, n_sms=n_sms)
    shares = tfc.pack_shares(packed, plan)
    assert shares.dtype == torch.uint8
    assert tuple(shares.shape) == (plan.n_blocks, plan.stride)
    if mode is None:
        w_in, w_out = packed.w_in, packed.w_out
    elif mode == "int8":
        w_in, w_out = tfc.unpack_int8(packed.w_in_q), tfc.unpack_int8(packed.w_out_q)
    else:
        w_in, w_out = tfc.unpack_int8(packed.w_in_p), tfc.unpack_int8(packed.w_out_p)
    mats = {"filter": w_in, "gate": w_in, "res": w_out, "skip": w_out,
            "post1": packed.post1_w, "post2": packed.post2_w}
    cb = plan.col_bytes
    for r in range(plan.n_blocks):
        row, at = shares[r], 0

        def expect(name, w):
            nonlocal at
            lo, hi = plan.cols(name, r)
            for col in range(lo, hi):
                got = row[at:at + cb[name]]
                assert torch.equal(got, _column_bytes(w, col, cb[name])), (r, name, col)
                at += cb[name]

        expect("post1", mats["post1"])
        expect("post2", mats["post2"])
        assert at == plan.post_bytes(r)
        for l in range(plan.n_layers):
            for name in ("filter", "gate", "res", "skip"):
                expect(name, mats[name][l])
        assert at == plan.post_bytes(r) + plan.n_layers * plan.layer_bytes(r)
        assert not bool(row[at:].any())
