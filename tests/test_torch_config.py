"""The port's config schema against the reference's, and its import hygiene."""

import dataclasses
import pathlib
import subprocess
import sys

import pytest

from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu_torch.utils import config as tcfg

REPO = pathlib.Path(__file__).resolve().parent.parent


def _stats_variant(mod):
    """A chorowski config with every tuple-valued field set (dataset-norm
    statistics, LR schedule): the fields that JSON turns into lists."""
    cfg = mod.chorowski_config()
    spec = dataclasses.replace(cfg.spec, norm="dataset", mel_fmax=7600.0,
                               stats_mean=(0.5,) * 39, stats_var=(2.0,) * 39)
    train = dataclasses.replace(cfg.train, lr_boundaries=(10, 20),
                                lr_values=(1e-3, 5e-4, 1e-4))
    return dataclasses.replace(cfg, spec=spec, train=train)


CASES = [(name, lambda mod, n=name: mod.PRESETS[n]()) for name in jcfg.PRESETS]
CASES.append(("chorowski+stats", _stats_variant))


@pytest.mark.parametrize("name,make", CASES, ids=[c[0] for c in CASES])
def test_json_round_trips_both_ways(name, make):
    ref, port = make(jcfg), make(tcfg)
    assert tcfg.to_json(port) == jcfg.to_json(ref)
    assert tcfg.to_json(tcfg.from_json(jcfg.to_json(ref))) == jcfg.to_json(ref)
    assert jcfg.from_json(tcfg.to_json(port)) == ref
    assert tcfg.from_json(jcfg.to_json(ref)) == port


def test_presets_match():
    assert set(tcfg.PRESETS) == set(jcfg.PRESETS)


def test_port_imports_no_jax():
    """Neither jax nor the JAX package: the port and chip_smoke.py stand on
    their own on a machine that has neither."""
    code = ("import sys, ae_wavenet_tpu_torch.cli.generate, "
            "ae_wavenet_tpu_torch.ops.fastgen_cuda, "
            "ae_wavenet_tpu_torch.models.autoencoder, "
            "ae_wavenet_tpu_torch.training.weights, "
            "ae_wavenet_tpu_torch.data.dataset, ae_wavenet_tpu_torch.utils.wavio, "
            "chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'ae_wavenet_tpu')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_no_source_file_imports_jax():
    pkg = REPO / "ae_wavenet_tpu_torch"
    paths = [p for p in sorted(pkg.rglob("*.py"))
             if "_build" not in p.relative_to(pkg).parts]  # build outputs
    for path in paths + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] in ("jax", "ae_wavenet_tpu")), (
                f"{path}: {line}")
