"""Fast autoregressive WaveNet state: O(1)/sample ring-buffer queues.

Counterpart of ``ae_wavenet_tpu.ops.fastgen`` (Fast WaveNet,
arXiv:1611.09482): each dilated layer keeps a queue of its last
``dilation`` input activations, so one new sample costs one matmul pass
through the stack.  This module holds the state, the plain f32 cell,
:func:`prime`, which warms the queues on real context, and the f32
samplers :func:`generate` (the quality eval's rollout and the fused
sampler's oracle) and :func:`generate_naive` (the O(receptive field) per
sample oracle).  The fused sampler runs in ``ops/fastgen_cuda.py``.

State layout per layer l: buf [B, n_res, d_l] f32 holding the layer's input
activation at positions t-1 .. t-d_l (circular, index t mod d_l), as in the
reference.  Unlike the reference's pure functions, :func:`prime` and
:func:`generate` update the buffers in place: a flagship batch of 64 holds
200 MB of them.

The reference runs :func:`prime` and :func:`generate` as jitted
``lax.scan``s of the cell (``ae_wavenet_tpu/ops/fastgen.py:135-210``).
:func:`prime` needs no scan: every input it writes to a queue is a function
of known samples only, so it runs the context as one teacher-forced f32
pass, layer by layer over all its positions at once (GEMMs of T x B rows),
with the cell's arithmetic in another reduction order.  :func:`generate`
feeds each step the sample the last one drew, so one step (:func:`_cell`
and what follows it) reads every input from device tensors, the step
counters included, and on a CUDA device is captured once as a CUDA graph
and replayed once a step: the counterpart of the compiled scan, with the
same kernels and so the same bits as the step called in a Python loop.
That loop runs on the CPU, and on the card only when asked for with
``eager=True`` (the graph's plain version).  A capture or replay that fails
raises; nothing falls back to the loop on the card.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Tuple

import torch

from ae_wavenet_tpu_torch.models.wavenet import WaveNet, embed_input
from ae_wavenet_tpu_torch.utils.config import WaveNetConfig
from ae_wavenet_tpu_torch.utils.profiling import span


class GenState(NamedTuple):
    bufs: Tuple[torch.Tensor, ...]  # per layer [B, n_res, d_l] f32
    prev_id: torch.Tensor           # [B] last emitted/consumed sample id
                                    # (n_mix > 0: the sample, f32)
    t: int                          # global time (buffer phase)


def init_state(cfg: WaveNetConfig, batch: int, fill_id: int = 128,
               device=None) -> GenState:
    """Zero-filled queues; ``fill_id`` (mu-law silence) seeds the AR input,
    0.0 with a mixture output."""
    bufs = tuple(torch.zeros(batch, cfg.n_res, d, device=device)
                 for d in cfg.dilations)
    if cfg.n_mix:
        return GenState(bufs, torch.zeros(batch, device=device), 0)
    return GenState(bufs, torch.full((batch,), fill_id, dtype=torch.long,
                                     device=device), 0)


def _rounder(dtype):
    """v -> v rounded to the compute ``dtype`` and held in f32 (identity
    for f32): products of such values are exact in f32, so an f32 GEMM of
    them accumulates in f32 as the reference's ``preferred_element_type``
    does."""
    if dtype == torch.float32:
        return lambda v: v
    return lambda v: v.to(dtype).float()


def pack_params(wavenet: WaveNet, cfg: WaveNetConfig, dtype=torch.float32) -> dict:
    """Per layer, the five taps as two GEMMs, stored input-major:
        y     = [x_prev | x_cur | cond_t] @ w_in + b_in
        [r|s] = h @ w_out + b_out
    with the GEMMs' weights rounded to the compute ``dtype`` once (the
    embedding, or with a mixture output the input map ``in0_w`` /
    ``in0_b`` [n_res], and the biases stay f32)."""
    rnd = _rounder(dtype)
    w_in, b_in, w_out, b_out = [], [], [], []
    for p in wavenet.layers:
        w_in.append(rnd(torch.cat([p.w_prev["w"], p.w_cur["w"], p.w_cond["w"]], 1).t()))
        b_in.append(p.w_prev["b"] + p.w_cur["b"] + p.w_cond["b"])
        w_out.append(rnd(torch.cat([p.w_res["w"], p.w_skip["w"]], 0).t()))
        b_out.append(torch.cat([p.w_res["b"], p.w_skip["b"]]))
    x0 = ({"in0_w": wavenet.in0["w"][:, 0], "in0_b": wavenet.in0["b"]} if cfg.n_mix
          else {"embed": wavenet.embed})
    return {
        **x0, "w_in": w_in, "b_in": b_in,
        "w_out": w_out, "b_out": b_out,
        "post1_w": rnd(wavenet.post1["w"].t()), "post1_b": wavenet.post1["b"],
        "post2_w": rnd(wavenet.post2["w"].t()), "post2_b": wavenet.post2["b"],
    }


def _ring(bufs) -> torch.Tensor:
    """The queues [B, n_res, d_l] as one buffer [sum d_l, B, n_res]: layer
    l's slot s at row off_l + s, off_l = d_0 + ... + d_(l-1)."""
    return torch.cat([b.permute(2, 0, 1) for b in bufs], 0)


def _unring(ring: torch.Tensor, bufs, cfg: WaveNetConfig) -> None:
    """Write :func:`_ring`'s buffer back into the queues, in place."""
    for b, r in zip(bufs, ring.split(list(cfg.dilations), 0)):
        b.copy_(r.permute(1, 2, 0))


class _Loop:
    """One call's state on its device; every input a step reads is a tensor
    here, so one step can be captured and replayed:

    ring     [sum d_l, B, n_res] f32, every layer's queue (:func:`_ring`);
    offs, dils  [L] int64, each layer's first row in ``ring`` and dilation;
    ctr      [2] int64, the ring phase t and the call's step j, advanced by
             the step itself;
    cond_tm  [T, B, n_cond], the cond column of each step;
    and what :func:`generate` adds (the AR input, the draws, the
    outputs)."""

    WRITTEN = ("ring", "ctr", "prev")  # what a step writes besides its outputs' row j

    def __init__(self, cfg: WaveNetConfig, state: GenState, cond_tm: torch.Tensor):
        dev = cond_tm.device
        d = torch.tensor(cfg.dilations, dtype=torch.long)
        self.dils = d.to(dev)
        self.offs = (torch.cumsum(d, 0) - d).to(dev)
        self.ring = _ring(state.bufs)
        self.ctr = torch.tensor([state.t, 0], dtype=torch.long, device=dev)
        self.cond_tm = cond_tm

    def scratch(self) -> "_Loop":
        """A copy whose step leaves this loop's queues, counters and AR input
        as they are (the warm-up before a capture); it writes row 0 of the
        shared outputs, which step 0 writes again."""
        c = copy.copy(self)
        for k in self.WRITTEN:
            if hasattr(self, k):
                setattr(c, k, getattr(self, k).clone())
        return c


def _cell(packed: dict, cfg: WaveNetConfig, loop: _Loop, x_id: torch.Tensor,
          dtype=torch.float32) -> torch.Tensor:
    """One AR step at ``loop``'s counters: consume sample ids x_id [B] and
    the cond column of step j, write every queue at slot t mod d_l in place
    and return logits [B, n_quant].  Every layer's read comes before any
    write (each layer reads and writes only its own queue, at one slot), so
    the reads are one gather at the start and the writes one scatter at the
    end.  Every GEMM input is rounded to the compute ``dtype``; the residual
    stream, the queues and the sums stay f32.  The counters are left for
    the caller to advance."""
    rnd = _rounder(dtype)
    n_layers = len(cfg.dilations)
    t, j = loop.ctr[:1], loop.ctr[1:]
    slot = loop.offs + torch.remainder(t, loop.dils)
    x_prev = loop.ring.index_select(0, slot)  # [L, B, n_res]
    xs = torch.empty_like(x_prev)             # every layer's input, this step
    x = torch.index_select(packed["embed"], 0, x_id, out=xs[0])
    cond_t = rnd(loop.cond_tm.index_select(0, j)[0])
    skip = None
    for i in range(n_layers):
        xin = torch.cat([rnd(x_prev[i]), rnd(x), cond_t], 1)
        y = torch.addmm(packed["b_in"][i], xin, packed["w_in"][i])
        f, g = y.chunk(2, 1)
        h = rnd(torch.tanh(f) * torch.sigmoid(g))
        rs = torch.addmm(packed["b_out"][i], h, packed["w_out"][i])
        res, s = rs[:, : cfg.n_res], rs[:, cfg.n_res :]
        skip = s if skip is None else skip + s
        if i + 1 < n_layers:
            x = torch.add(x, res, out=xs[i + 1])
    loop.ring.index_copy_(0, slot, xs)
    h = rnd(torch.relu(skip))
    h = rnd(torch.relu(torch.addmm(packed["post1_b"], h, packed["post1_w"])))
    return torch.addmm(packed["post2_b"], h, packed["post2_w"])


def _capture(make_step, loop: _Loop) -> torch.cuda.CUDAGraph:
    """``make_step(loop)`` captured once as a CUDA graph, after one warm-up
    step on a scratch copy of the loop on the capture stream (cuBLAS and
    the allocator initialise there, outside the capture).  Other threads
    (a training run's loader) may use the card meanwhile."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        make_step(loop.scratch())()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # the outer stream context gives the caller back its stream where a
    # failed capture raises from the graph context's exit before its own
    with torch.cuda.stream(side), torch.cuda.graph(
            graph, stream=side, capture_error_mode="thread_local"):
        make_step(loop)()
    return graph


def _run(counted, make_step, loop: _Loop, n_steps: int, eager: bool,
         refill=None, chunk: int = 0) -> None:
    """``n_steps`` steps of ``make_step(loop)``: on a CUDA device, unless
    ``eager``, one captured step replayed ``n_steps`` times; else the step
    called in a Python loop.  ``refill()`` runs before step j wherever
    j % ``chunk`` == 0.  Counts ``counted.graph_replays`` and
    ``counted.eager_steps``."""
    graph = None
    if loop.ring.is_cuda and not eager and n_steps:
        graph = _capture(make_step, loop)
    step = make_step(loop)
    for j in range(n_steps):
        if refill is not None and j % chunk == 0:
            refill()
        if graph is None:
            step()
            counted.eager_steps += 1
        else:
            graph.replay()
            counted.graph_replays += 1


def with_gc(wavenet: WaveNet, cfg: WaveNetConfig, cond: torch.Tensor,
            gc_ids: torch.Tensor | None) -> torch.Tensor:
    """Append the (time-constant) speaker embedding to the cond channels:
    [B, n_lc_out, T] -> [B, n_lc_out + n_global_embed, T] (cond itself
    where n_global_embed is 0)."""
    if not cfg.n_global_embed:
        return cond
    b, _, t = cond.shape
    if gc_ids is None:
        g = cond.new_zeros(b, cfg.n_global_embed)
    else:
        g = wavenet.gc_embed[gc_ids]
    g = g[:, :, None].expand(b, cfg.n_global_embed, t).to(cond.dtype)
    return torch.cat([cond, g], 1)


def _by_step(wavenet, cfg, cond, gc_ids) -> torch.Tensor:
    """cond [B, n_lc_out, T] with the speaker embedding, time-major
    [T, B, n_cond]."""
    return with_gc(wavenet, cfg, cond, gc_ids).permute(2, 0, 1).contiguous()


@torch.no_grad()
def prime(wavenet: WaveNet, cfg: WaveNetConfig, state: GenState,
          ids: torch.Tensor, cond: torch.Tensor,
          gc_ids: torch.Tensor | None = None) -> GenState:
    """Warm the queues with known samples (teacher context), in place.

    ids: [B, T0] real samples at positions [t, t+T0) (mu-law ids, or with a
    mixture output the samples in [-1, 1], mapped by ``in0``).  The first T = T0-1
    are consumed through the stack (no logits are made); the LAST one is
    left as ``prev_id`` so the next generation step consumes it.
    cond: [B, n_lc_out, >= T0-1] columns for the consumed positions.

    One teacher-forced pass, layer-major and time-major ([positions, B,
    channels], GEMM row p*B + b): layer l's input at p - d_l, the cell's
    left context at p, is row p of S = [queue in time order (positions
    t-d_l .. t-1) ; the layer's T inputs], and the last d_l rows of S are
    the queue's new contents, written at slot p mod d_l (T < d_l and any
    phase t included).  Every layer but the last, whose output only the
    skip sums read, runs the cell's f32 GEMMs on all T x B rows at once:
    the work of T steps of :func:`_cell` without their head, in another
    reduction order.  Counts ``prime.passes`` and ``prime.positions`` (B x
    T a call)."""
    b, n = ids.shape[0], ids.shape[-1] - 1
    with span("prime.pack"):
        packed = pack_params(wavenet, cfg)
        cond_rows = _by_step(wavenet, cfg, cond[..., :n], gc_ids).flatten(0, 1)
    with span("prime.pass"):
        x = embed_input(wavenet, ids[:, :n].t())
        last = len(cfg.dilations) - 1
        for i, (d, buf) in enumerate(zip(cfg.dilations, state.bufs)):
            ring = buf.permute(2, 0, 1)  # [d, B, n_res], position p at slot p mod d
            seq = torch.cat([ring.roll(-(state.t % d), 0), x])
            buf.copy_(seq[n:].roll((state.t + n) % d, 0).permute(1, 2, 0))
            if i == last:
                break
            # the cell's one GEMM of [x_prev | x | cond] as three: a large
            # GEMM of T x B rows sums each output over its K in sequence,
            # and three shorter sums round less
            w_prev, w_cur, w_cond = packed["w_in"][i].split(
                [cfg.n_res, cfg.n_res, cond_rows.shape[1]])
            y = torch.addmm(packed["b_in"][i], seq[:n].flatten(0, 1), w_prev)
            y.addmm_(x.flatten(0, 1), w_cur).addmm_(cond_rows, w_cond)
            f, g = y.chunk(2, 1)
            rs = torch.addmm(packed["b_out"][i], torch.tanh(f) * torch.sigmoid(g),
                             packed["w_out"][i])
            x = x + rs[:, : cfg.n_res].unflatten(0, (n, b))
    prime.passes += 1
    prime.positions += b * n
    return GenState(state.bufs, ids[:, -1], state.t + n)


prime.passes = 0
prime.positions = 0

#: the most bytes of uniforms :func:`generate` draws at once: a rollout
#: whose T x B x n_quant f32 would take more draws them in chunks of steps
DRAW_CHUNK_BYTES = 256 << 20


def _pick(logits: torch.Tensor, u: torch.Tensor, temperature: float) -> torch.Tensor:
    """A categorical draw from softmax(logits / temperature) by Gumbel-max
    on the uniforms u (logits' shape)."""
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits / temperature + g, -1)


def _draw(logits: torch.Tensor, temperature: float,
          generator: torch.Generator | None) -> torch.Tensor:
    """Next ids [B] from logits [B, Q]: argmax at temperature 0, else
    :func:`_pick` on uniforms taken from ``generator`` on its own device."""
    if temperature == 0.0:
        return torch.argmax(logits, -1)
    u_dev = logits.device if generator is None else generator.device
    u = torch.rand(logits.shape, generator=generator, device=u_dev)
    return _pick(logits, u.to(logits.device), temperature)


def _draws(generator: torch.Generator | None, n_steps: int, chunk: int,
           shape: tuple, device):
    """The uniforms of ``n_steps`` draws of ``shape``, ``chunk`` steps at a
    time: yields [c, *shape] on ``generator``'s device (``device``'s
    default generator when None).  One chunk from a CPU generator holds the
    numbers of its steps drawn one by one, as :func:`_draw` draws them."""
    u_dev = device if generator is None else generator.device
    for j in range(0, n_steps, chunk):
        c = min(chunk, n_steps - j)
        yield torch.rand((c, *shape), generator=generator, device=u_dev)


@torch.no_grad()
def generate(wavenet: WaveNet, cfg: WaveNetConfig, state: GenState,
             cond: torch.Tensor, generator: torch.Generator | None = None,
             gc_ids: torch.Tensor | None = None, n_steps: int | None = None,
             temperature: float = 1.0, return_logits: bool = False,
             dtype=torch.float32, eager: bool = False):
    """Sample ``n_steps`` (default: the cond length) mu-law ids with the
    cell: f32, or with ``dtype=torch.bfloat16`` the GEMMs' inputs rounded to
    bf16 and their sums kept in f32, as the reference's ``dtype`` does.  On
    a CUDA device the step is a CUDA graph replayed once a sample
    (``eager``: the same step in a Python loop).  Every step's uniforms are
    drawn from ``generator`` before its chunk of steps (:func:`_draws`, at
    most DRAW_CHUNK_BYTES a chunk), the same numbers on either path.

    cond: [B, n_lc_out, T]; column p conditions the step that consumes the
    sample at position p (the training lattice).  The queues of ``state``
    are updated in place.  Returns (ids [B, T] int32, final state) and, with
    ``return_logits``, the per-step logits [B, n_quant, T]: the free-running
    predictive distributions that eval/quality scores ground truth under.
    A mixture output (``cfg.n_mix``) is sampled by the fused sampler alone
    (``ops/fastgen_cuda``): it raises here."""
    if cfg.n_mix:
        raise NotImplementedError("the f32 rollout samples mu-law ids; a mixture "
                                  "output is sampled by ops/fastgen_cuda")
    t_len = cond.shape[-1] if n_steps is None else n_steps
    if t_len > cond.shape[-1]:
        raise ValueError(f"n_steps={t_len} exceeds the {cond.shape[-1]} "
                         "conditioning columns provided")
    packed = pack_params(wavenet, cfg, dtype)
    loop = _Loop(cfg, state, _by_step(wavenet, cfg, cond[..., :t_len], gc_ids))
    dev, b, q = cond.device, state.prev_id.shape[0], cfg.n_quant
    loop.prev = state.prev_id.to(device=dev, dtype=torch.long, copy=True)
    loop.ids = torch.empty(t_len, b, dtype=torch.long, device=dev)
    loop.logits = torch.empty(t_len, b, q, device=dev) if return_logits else None
    refill, chunk = None, 0
    if temperature != 0.0:
        chunk = max(1, min(t_len, DRAW_CHUNK_BYTES // (4 * b * q)))
        loop.u = torch.zeros(chunk, b, q, device=dev)
        draws = _draws(generator, t_len, chunk, (b, q), dev)

        def refill():
            u = next(draws)
            loop.u[: u.shape[0]].copy_(u)

    def make_step(lp):
        def step():
            logits = _cell(packed, cfg, lp, lp.prev, dtype)
            j = lp.ctr[1:]
            if temperature == 0.0:
                nxt = torch.argmax(logits, -1)
            else:
                u = lp.u.index_select(0, torch.remainder(j, chunk))[0]
                nxt = _pick(logits, u, temperature)
            lp.ids.index_copy_(0, j, nxt[None])
            if return_logits:
                lp.logits.index_copy_(0, j, logits[None])
            lp.prev.copy_(nxt)
            lp.ctr.add_(1)
        return step

    _run(generate, make_step, loop, t_len, eager, refill, chunk)
    _unring(loop.ring, state.bufs, cfg)
    out = (loop.ids.t().to(torch.int32),
           GenState(state.bufs, loop.prev, state.t + t_len))
    if return_logits:
        return out + (loop.logits.permute(1, 2, 0).contiguous(),)
    return out


generate.graph_replays = 0
generate.eager_steps = 0


@torch.no_grad()
def generate_naive(wavenet: WaveNet, cfg: WaveNetConfig, ctx_ids: torch.Tensor,
                   cond: torch.Tensor, generator: torch.Generator | None = None,
                   gc_ids: torch.Tensor | None = None, n_steps: int = 16,
                   temperature: float = 1.0) -> torch.Tensor:
    """O(receptive field) per sample: re-runs the teacher-forcing stack for
    every emitted sample.  A test oracle only.

    ctx_ids: [B, rf + 1], the window of AR inputs for which ``apply`` emits
    exactly one logit column; cond: [B, n_lc_out, rf + 1 + n_steps] aligned
    with the consumed inputs.  Returns ids [B, n_steps] int32."""
    from ae_wavenet_tpu_torch.models import wavenet as wn

    rf = wn.receptive_field(cfg)
    if ctx_ids.shape[-1] != rf + 1:
        raise ValueError(f"ctx_ids has {ctx_ids.shape[-1]} samples, need rf + 1 = "
                         f"{rf + 1}")
    ids, out = ctx_ids, []
    for j in range(n_steps):
        logits = wn.apply(wavenet, cfg, ids[..., -(rf + 1):],
                          cond[..., j : j + rf + 1], gc_ids)
        nxt = _draw(logits[..., -1], temperature, generator)
        out.append(nxt.to(torch.int32))
        ids = torch.cat([ids, nxt[:, None].to(ids.dtype)], -1)
    return torch.stack(out, 1)
