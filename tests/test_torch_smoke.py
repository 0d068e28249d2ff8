"""``chip_smoke.py``'s reading of the ptxas report and the rules it holds
its kernel readings to, and the card tests' check of a data-parallel VQ
step (``torch_parallel_worker.vq_step_check``), on the CPU.

The smoke itself needs the card; its build phase holds every Hopper kernel
to zero spills by the names this parser gives them, so a template argument
that the parser dropped or garbled would let a kernel escape the check.
The mangled names are the ones nvcc 12.9 gives the port's kernels.
"""

import pytest
import torch

import chip_smoke
import torch_parallel_worker as worker

REPORT = """ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    16 bytes stack frame, 20 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 16 bytes cumulative stack size
"""

GATED = "_ZN40_GLOBAL__N__a4712fb8_8_gated_cu_ed8bba29"


@pytest.mark.parametrize("mangled,name", [
    (GATED + "13wg_bwd_kernelILi1ELb1EEEvNS_6WgBwdPE", "wg_bwd_kernel<1, true>"),
    (GATED + "13wg_bwd_kernelILi2ELb0EEEvNS_6WgBwdPE", "wg_bwd_kernel<2, false>"),
    (GATED + "13wg_fwd_kernelILi2ELb1EEEvNS_6WgFwdPE", "wg_fwd_kernel<2, true>"),
    (GATED + "12wg_dw_kernelENS_5WgDwPE", "wg_dw_kernel"),
    (GATED + "19gated_reduce_kernelEPKfPfix", "gated_reduce_kernel"),
    ("_ZN43_GLOBAL__N__b731e597_10_fastgen_cu_cd6989dc14fastgen_kernelILi2EEEvNS_6ParamsE",
     "fastgen_kernel<2>"),
    ("_ZN37_GLOBAL__N__357a87a4_5_vq_cu_fd27733f9vq_kernelILi8ELb1EEEvPKfS2_iiiiPiPfS4_S4_Pj",
     "vq_kernel<8, true>"),
])
def test_ptxas_report_names_each_kernel_with_its_template_arguments(mangled, name):
    assert chip_smoke.ptxas_kernels(REPORT.format(name=mangled)) == {
        name: (168, 20, 24, 16)}


def test_ptxas_report_keeps_every_instance_apart():
    """The three backward instances (saved y, pair, recompute mode) stay
    three entries, each with its own numbers."""
    names = [GATED + f"13wg_bwd_kernelILi{nl}ELb{rec}EEEvNS_6WgBwdPE"
             for nl, rec in ((1, 0), (2, 0), (1, 1))]
    got = chip_smoke.ptxas_kernels("".join(REPORT.format(name=n) for n in names))
    assert sorted(got) == ["wg_bwd_kernel<1, false>", "wg_bwd_kernel<1, true>",
                           "wg_bwd_kernel<2, false>"]
    assert set(chip_smoke.HOPPER_KERNELS) >= set(got)


def _ema_buffers(z, codes, e0, bn) -> dict:
    """The VQ bottleneck's buffers after one EMA step from ``e0`` (counts 1)."""
    import torch

    k = e0.shape[0]
    counts = torch.bincount(codes, minlength=k).float()
    c = bn.ema_decay + (1.0 - bn.ema_decay) * counts
    s = bn.ema_decay * e0 + (1.0 - bn.ema_decay) * torch.zeros_like(e0).index_add_(
        0, codes, z)
    n = c.sum()
    cb = s / ((c + bn.ema_eps) / (n + k * bn.ema_eps) * n)[:, None]
    return {"bottleneck.ema_counts": c, "bottleneck.ema_sums": s,
            "bottleneck.codebook": cb}


def _readings(rule: str, far: bool) -> bool:
    """Whether ``rule`` passes a reading one rounding off (``far`` False)
    or one a fault would give."""
    gen = torch.Generator().manual_seed(0)
    if rule == "vq codes":
        z, e = torch.randn(300, 8, generator=gen), torch.randn(16, 8, generator=gen)
        e[1] = e[0]  # rows nearest e[0] tie with e[1]
        d2 = e.square().sum(1)[None] - 2.0 * z @ e.t()
        ref, codes = d2.argmin(1), d2.argmin(1)
        if far:  # two rows (under 1%) on their farthest code: not a tie
            codes[:2] = d2[:2].argmax(1)
        else:  # one row on the other code of its tie
            codes[int(torch.nonzero(ref == 0)[0])] = 1
        return chip_smoke.vq_codes_agree(z, e, codes, ref)
    if rule == "vq sums":
        z = torch.randn(300, 8, generator=gen)
        codes = torch.randint(0, 16, (300,), generator=gen)
        sums = torch.zeros(16, 8).index_add_(0, codes, z)
        sums[0, 0] += 1e-2 if far else 1e-7
        return chip_smoke.vq_sums_err(z, codes, sums)[1] <= chip_smoke.VQ_SUM_TOL
    if rule == "mol mixture":
        mix = torch.randn(4, 3, 30, generator=gen)
        mix[..., 20:] *= 0.01  # a small group is held to its own largest value
        got = mix.clone()
        got[..., 20:] += 1e-3 if far else 1e-6
        return chip_smoke.mol_param_err(got, mix, 10) < chip_smoke.MOL_PARAM_TOL
    tol = chip_smoke.segment_tolerance(rule)
    outs = [torch.randn(64, 32, generator=gen) for _ in range(3)]
    got = [o.clone() for o in outs]
    got[2][0, 0] += (2.0 * tol if far else 1e-4) * float(outs[2].abs().max())
    return chip_smoke.compare_outputs(got, outs)[1] < tol


@pytest.mark.parametrize("rule", ["vq codes", "vq sums", "mol mixture",
                                  "gated_pair_bwd", "gated_stack_fused"])
def test_kernel_reading_rules_pass_rounding_and_reject_faults(rule):
    assert _readings(rule, far=False)
    assert not _readings(rule, far=True)


@pytest.mark.parametrize("fault", [None, "assignment", "counts", "codebook"])
def test_vq_step_check_takes_a_near_tie_and_rejects_faults(fault):
    """The two-rank step's VQ check on made-up latents: one row sits on a tie of
    two codes and falls either side in the two runs; every other latent
    moves in its last bits.  That passes.  A row put on a code that is not
    its nearest, an EMA count or a codebook entry off on a code no
    differing row took: each fails."""
    import torch

    from ae_wavenet_tpu_torch.utils.config import BottleneckConfig

    bn = BottleneckConfig(kind="vq", n_dim=4, vq_k=8)
    gen = torch.Generator().manual_seed(0)
    e0 = torch.randn(8, 4, generator=gen)
    e0[1] = e0[0] + 0.1 * torch.randn(4, generator=gen)
    z_1 = torch.randn(400, 4, generator=gen)
    z_dp = z_1 + 1e-6 * torch.randn(400, 4, generator=gen)
    mid, step = (e0[0] + e0[1]) / 2, 1e-4 * (e0[1] - e0[0])
    z_1[0], z_dp[0] = mid + step, mid - step

    def nearest(z):
        return (e0.square().sum(1)[None] - 2.0 * z @ e0.t()).argmin(1)

    codes_1, codes_dp = nearest(z_1), nearest(z_dp)
    assert (int(codes_1[0]), int(codes_dp[0])) == (1, 0)
    if fault == "assignment":
        r = int(torch.nonzero(codes_dp > 1)[0])
        codes_dp[r] = 7 - codes_dp[r] if codes_dp[r] != 7 else 2
    buf_1, buf_dp = _ema_buffers(z_1, codes_1, e0, bn), _ema_buffers(z_dp, codes_dp, e0, bn)
    kept = int(codes_1[codes_1 > 1][0])
    if fault == "counts":
        buf_dp["bottleneck.ema_counts"][kept] += 1.0 - bn.ema_decay
    if fault == "codebook":
        buf_dp["bottleneck.codebook"][kept] += 1e-3
    fails, vq = worker.vq_step_check(z_dp, codes_dp, z_1, codes_1, e0, buf_dp, buf_1, bn)
    if fault is None:
        assert not fails and vq["flipped"] == 1, (fails, vq)
    else:
        assert fails, vq


@pytest.mark.parametrize("route", ["fused", "plain"])
def test_vq_capture_records_the_training_lookup(route, tmp_path):
    """``vq_capture`` records one (latents, codes) pair for a training step
    on either route (the fused wrapper runs its plain version on the CPU),
    and the codes are the nearest to those latents: the step's own check
    against itself passes with nothing flipped."""
    import dataclasses
    import io

    from ae_wavenet_tpu_torch.data.dataset import make_synthetic_dataset
    from ae_wavenet_tpu_torch.training import chassis
    from ae_wavenet_tpu_torch.utils import config as tcfg

    base = tcfg.tiny_config()
    cfg = dataclasses.replace(
        base, bottleneck=tcfg.BottleneckConfig(kind="vq", n_dim=16, vq_k=32, jitter_p=0.0,
                                               vq_use_pallas=route == "fused"),
        train=dataclasses.replace(base.train, batch_sz=2, log_every=1))
    prefix = str(tmp_path / "synth")
    make_synthetic_dataset(prefix, n_clips=2, n_speakers=2, clip_len=(9000, 12000), seed=0)
    ch = chassis.Chassis(cfg, prefix, device="cpu", log_stream=io.StringIO())
    e0 = ch.model.bottleneck.codebook.clone()
    seen = []
    with worker.vq_capture(seen):
        ch.train(1)
    assert len(seen) == 1
    z, codes = seen[0]
    assert z.shape == (len(codes), 16)
    buf = {k: v for k, v in ch.model.state_dict().items() if k.startswith("bottleneck.")}
    fails, vq = worker.vq_step_check(z, codes, z, codes, e0, buf, buf, cfg.bottleneck)
    assert not fails and vq["flipped"] == 0, (fails, vq)
