"""The port's conv-stack geometry against the reference's, on random chains:
every answer must be the same integers."""

import dataclasses

import numpy as np
import pytest

from ae_wavenet_tpu.geometry import vconv as jv
from ae_wavenet_tpu_torch.geometry import vconv as tv


def _random_chains(rng):
    """The same random chain built from both modules' layer classes."""
    specs = []
    for _ in range(rng.integers(1, 6)):
        if rng.random() < 0.6:
            s = int(rng.integers(1, 4))
            specs.append(("Conv", dict(filter_sz=int(rng.integers(1, 9)), stride=s,
                                       dilation=int(rng.integers(1, 5)) if s == 1 else 1)))
        else:
            s = int(rng.integers(1, 5))
            specs.append(("TConv", dict(filter_sz=int(rng.integers(s, s + 6)), stride=s)))
    return tuple(mod.Chain([getattr(mod, k)(**kw) for k, kw in specs]) for mod in (jv, tv))


def _steps(plan):
    return [(dataclasses.asdict(s.layer), s.in_want.as_tuple(), s.out_want.as_tuple(),
             s.trim_l, s.keep) for s in plan]


@pytest.mark.parametrize("trial", range(12))
def test_chain_queries_match_reference(trial):
    rng = np.random.default_rng(trial)
    ref, port = _random_chains(rng)
    assert port.total_stride() == ref.total_stride()
    for in_len in rng.integers(1, 300, size=8):
        in_len = int(in_len)
        assert port.out_len(in_len) == ref.out_len(in_len)
        n = ref.out_len(in_len)
        if n < 1:
            continue
        b = int(rng.integers(0, n))
        e = int(rng.integers(b + 1, n + 1))
        for clip in (None, in_len):
            assert (port.in_range(tv.Range(b, e), clip).as_tuple()
                    == ref.in_range(jv.Range(b, e), clip).as_tuple())
        assert _steps(port.plan(tv.Range(b, e))) == _steps(ref.plan(jv.Range(b, e)))


def test_padded_conv_and_errors_match_reference():
    for kw in (dict(filter_sz=5, pad_l=2, pad_r=2), dict(filter_sz=400, stride=160,
                                                          pad_l=200, pad_r=200)):
        ref, port = jv.Conv(**kw), tv.Conv(**kw)
        for in_len in (1, 7, 399, 1000):
            assert port.out_len(in_len) == ref.out_len(in_len)
            assert (port.in_range(tv.Range(0, 3), in_len).as_tuple()
                    == ref.in_range(jv.Range(0, 3), in_len).as_tuple())
    with pytest.raises(ValueError):
        tv.TConv(2, stride=3)
    with pytest.raises(ValueError):
        tv.Range(3, 2)
    with pytest.raises(ValueError, match="outside"):
        tv.Chain([tv.Conv(3)]).plan(tv.Range(0, 4), in_len=5)
