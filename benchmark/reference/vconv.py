"""Geometry of VALID conv stacks, resolved to plain integers.

Counterpart of ``ae_wavenet_tpu.geometry.vconv`` (the part the serving path
uses): half-open ranges on each layer's lattice, the input range a stack
needs for a range of outputs, and the per-layer plan (window to feed, slice
to keep) that reproduces the full computation exactly.

Conventions, as in the reference: ranges are half-open ``[b, e)``; a
layer's output holds only *complete* positions, those whose every tap lands
on a real input sample.  For a transposed conv this drops the ragged edges
(the first ``filter_sz - 1`` positions of the full output, and as many at
its end).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Range:
    """Half-open integer range [b, e)."""

    b: int
    e: int

    def __post_init__(self):
        if self.e < self.b:
            raise ValueError(f"empty-or-negative range [{self.b}, {self.e})")

    def __len__(self) -> int:
        return self.e - self.b

    def contains(self, other: "Range") -> bool:
        return self.b <= other.b and other.e <= self.e

    def as_tuple(self) -> Tuple[int, int]:
        return (self.b, self.e)


@dataclasses.dataclass(frozen=True)
class Conv:
    """Strided, dilated convolution, VALID with optional edge pads.  Output
    ``o`` reads inputs ``o*stride - pad_l + k*dilation`` for k < filter_sz."""

    filter_sz: int
    stride: int = 1
    dilation: int = 1
    pad_l: int = 0
    pad_r: int = 0
    name: str = "conv"

    def __post_init__(self):
        if self.filter_sz < 1 or self.stride < 1 or self.dilation < 1:
            raise ValueError(f"bad conv spec {self}")

    @property
    def span(self) -> int:
        return (self.filter_sz - 1) * self.dilation + 1

    def out_len(self, in_len: int) -> int:
        eff = in_len + self.pad_l + self.pad_r
        if eff < self.span:
            return 0
        return (eff - self.span) // self.stride + 1

    def in_range(self, out: Range, in_len: int | None = None) -> Range:
        """Input range needed for outputs ``out``; clipped to [0, in_len)
        when ``in_len`` is given (pads cover the rest at the edges)."""
        b = out.b * self.stride - self.pad_l
        e = (out.e - 1) * self.stride - self.pad_l + self.span
        if in_len is not None:
            b, e = max(b, 0), min(e, in_len)
        return Range(b, e)


@dataclasses.dataclass(frozen=True)
class TConv:
    """Transposed conv, complete outputs only: zero-stuff the input by
    ``stride``, run a FULL ``filter_sz``-tap convolution, and keep the
    positions whose whole window lies on the real fine lattice, re-indexed
    from 0."""

    filter_sz: int
    stride: int
    name: str = "tconv"

    def __post_init__(self):
        if self.filter_sz < self.stride:
            raise ValueError(
                f"tconv filter_sz {self.filter_sz} < stride {self.stride}: "
                "output would have gaps with zero taps")

    def out_len(self, in_len: int) -> int:
        if in_len < 1:
            return 0
        return max((in_len - 1) * self.stride + 1 - (self.filter_sz - 1), 0)

    def in_range(self, out: Range, in_len: int | None = None) -> Range:
        """The smallest input window whose ``tconv1d`` output covers ``out``
        (slightly wider than the tap dependencies when ``stride`` does not
        divide ``out.b``)."""
        b = out.b // self.stride
        e = _ceil_div(out.e + self.filter_sz - 2, self.stride) + 1
        if in_len is not None:
            b, e = max(b, 0), min(e, in_len)
        return Range(b, e)


Layer = Conv | TConv


def impl_out_range(layer: Layer, inp: Range) -> Range:
    """Global output range that ``ops.conv1d`` produces from exactly the
    window ``inp`` (a strided conv's window must start on its lattice)."""
    if isinstance(layer, Conv):
        if layer.pad_l or layer.pad_r:
            raise ValueError("impl_out_range only supports pad-free convs")
        if inp.b % layer.stride:
            raise ValueError(f"window start {inp.b} not aligned to stride {layer.stride}")
        n = layer.out_len(len(inp))
        return Range(inp.b // layer.stride, inp.b // layer.stride + n)
    oe = (inp.e - 1) * layer.stride + 2 - layer.filter_sz
    return Range(inp.b * layer.stride, max(inp.b * layer.stride, oe))


@dataclasses.dataclass(frozen=True)
class PlanStep:
    """One layer of an exact-computation plan (bottom-up order)."""

    layer: Layer
    in_want: Range   # global input range the layer must be fed
    out_want: Range  # global output range to keep (== next step's in_want)
    trim_l: int      # left slice offset into the implementation's output

    @property
    def keep(self) -> int:
        return len(self.out_want)


@dataclasses.dataclass(frozen=True)
class Chain:
    """A stack of layers; composes range queries through the whole stack."""

    layers: Tuple[Layer, ...]

    def __init__(self, layers: Sequence[Layer]):
        object.__setattr__(self, "layers", tuple(layers))

    def __add__(self, other: "Chain | Sequence[Layer]") -> "Chain":
        other_layers = other.layers if isinstance(other, Chain) else tuple(other)
        return Chain(self.layers + other_layers)

    def out_len(self, in_len: int) -> int:
        n = in_len
        for layer in self.layers:
            n = layer.out_len(n)
        return n

    def in_range(self, out: Range, in_len: int | None = None) -> Range:
        """Input range at the bottom of the chain needed for top outputs
        ``out``; ``in_len`` is the bottom input length, for edge pads."""
        lens: list[int | None] = [None] * len(self.layers)
        if in_len is not None:
            n = in_len
            for i, layer in enumerate(self.layers):
                lens[i] = n
                n = layer.out_len(n)
        r = out
        for layer, n in zip(reversed(self.layers), reversed(lens)):
            r = layer.in_range(r, n)
        return r

    def plan(self, out: Range, in_len: int | None = None) -> Tuple[PlanStep, ...]:
        """Per layer (bottom-up), the window to feed it and the slice of its
        output to keep, so that feeding ``plan[0].in_want`` reproduces the
        full computation on ``out`` exactly."""
        wants: list[Range] = [out]
        for layer in reversed(self.layers):
            wants.append(layer.in_range(wants[-1], None))
        wants.reverse()  # wants[i] = input range of layer i; wants[-1] = out
        if in_len is not None and (wants[0].b < 0 or wants[0].e > in_len):
            raise ValueError(
                f"output range {out} needs input {wants[0]} outside [0, {in_len})")
        steps = []
        for i, layer in enumerate(self.layers):
            io = impl_out_range(layer, wants[i])
            if not io.contains(wants[i + 1]):
                raise AssertionError(
                    f"geometry bug: layer {layer} fed {wants[i]} produces {io}, "
                    f"want {wants[i + 1]}")
            steps.append(PlanStep(layer, wants[i], wants[i + 1], wants[i + 1].b - io.b))
        return tuple(steps)

    def total_stride(self) -> Tuple[int, int]:
        """Net (numerator, denominator) resampling ratio of the chain."""
        num = den = 1
        for layer in self.layers:
            if isinstance(layer, Conv):
                num *= layer.stride
            else:
                den *= layer.stride
        g = math.gcd(num, den)
        return num // g, den // g
