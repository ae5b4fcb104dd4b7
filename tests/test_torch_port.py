"""Properties of the port as a whole: it imports no jax, its entry points
never choose the CPU on their own, its configs are the JAX package's, and
chip_smoke.py refuses to report a result without a card."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_every_port_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 41


def test_no_jax_or_repro_import_in_port_sources():
    pat = re.compile(r"^\s*(import jax|from jax|from repro[ .]|import repro$"
                     r"|import repro\.)", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0)}" for f in files
            for m in pat.finditer(f.read_text())]
    assert not hits, hits


def test_entry_points_do_not_choose_the_cpu():
    from repro_torch import resolve_device
    from repro_torch.convert import tensor
    from repro_torch.core.shift_bn import init_bn
    from repro_torch.models.paper_nets import init_cnn, init_mlp
    g = torch.Generator().manual_seed(0)
    calls = [lambda: init_mlp(g, 8, 8, 1), lambda: init_cnn(g, img=8),
             lambda: init_bn(4), lambda: tensor([1.0]), resolve_device]
    if torch.cuda.is_available():
        for call in calls[2:]:
            out = call()
            dev = out if isinstance(out, torch.device) else \
                (out[0].gamma if isinstance(out, tuple) else out).device
            assert dev.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert init_bn(4, device="cpu")[0].gamma.device.type == "cpu"


def test_paper_configs_are_the_jax_packages():
    from repro.configs import bnn_paper as j
    from repro_torch.configs import bnn_paper as t
    assert set(t.PAPER_CONFIGS) == set(j.PAPER_CONFIGS)
    for name, cfg in t.PAPER_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(j.PAPER_CONFIGS[name])


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs there in full")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
