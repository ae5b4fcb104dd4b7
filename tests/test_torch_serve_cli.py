"""The port's serving CLI (`python -m repro_torch.launch.serve`) against the
JAX package's (`repro.launch.serve`), both run in-process on one JAX
checkpoint of smoke qwen2-72b params (written by the JAX
`CheckpointManager`, read by each package's), on the CPU: the static
batch's `req i:` lines are equal, and in queue mode under a fault plan
the per-rid statuses and token counts are equal. The port runs in XLA's
float mode (`test_torch_whole_prompt._flush_denormals`), so tokens are
compared exactly.
"""
import re
import sys

import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.launch import serve as jax_serve
from repro_torch.launch import serve

from _torch_families import params
from test_torch_whole_prompt import _flush_denormals  # noqa: F401 (autouse)

BASE = ["--arch", "qwen2-72b", "--smoke", "--freeze", "--prompt-len", "12",
        "--max-new", "8"]
STATIC = ["--batch", "3"]
QUEUE = ["--batch", "6", "--queue", "--prefill-chunk", "4", "--page-size",
         "4", "--inject-faults", "nan@admit:1,device_error@burst:1*2"]
STATUS = re.compile(r"s (done|ERROR|SHED)\s+rid=(\d+)(?: tokens=(\d+))?")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("qwen2_ckpt")
    JaxManager(path, async_save=False).save(1, params("qwen2-72b")[2])
    return str(path)


def _both(ckpt, extra, capsys, monkeypatch):
    """Each CLI's stdout lines for the same flags."""
    argv = BASE + ["--ckpt", ckpt] + extra
    assert serve.main(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jax_serve.main()
    return port, capsys.readouterr().out.splitlines()


def test_static_batch_prints_jax_s_tokens(ckpt, capsys, monkeypatch):
    port, jax = _both(ckpt, STATIC, capsys, monkeypatch)
    mine = [ln for ln in port if ln.startswith("req ")]
    assert len(mine) == 3
    assert mine == [ln for ln in jax if ln.startswith("req ")]
    assert any(ln.startswith("serving packed 1-bit weights") for ln in port)


def test_queue_under_faults_resolves_as_jax(ckpt, capsys, monkeypatch):
    port, jax = _both(ckpt, QUEUE, capsys, monkeypatch)

    def statuses(lines):
        return {int(m[2]): (m[1], m[3]) for ln in lines
                if (m := STATUS.search(ln))}
    mine = statuses(port)
    assert sorted(mine) == list(range(6))
    assert [s for s, _ in mine.values()].count("ERROR") == 1
    assert mine == statuses(jax)
    res = [ln for ln in port if ln.startswith("resilience:")]
    assert res == [ln for ln in jax if ln.startswith("resilience:")]
    assert "2 burst retries" in res[0] and "1 errored" in res[0]
    assert any(ln.startswith("page pool:") for ln in port)


@pytest.mark.parametrize("flag", [["--mesh", "2,1", "--slots", "3",
                                   "--device", "cpu"], ["--replicas", "2"]])
def test_mesh_and_replicas_raise(flag, monkeypatch):
    """--mesh and --replicas serve (tests/test_torch_mesh_serving.py,
    tests/test_torch_replica.py); they raise where the devices cannot hold
    them: slots that do not divide over the data axis, and without
    --device more replicas than cards (none here: the default device is
    stubbed to the CPU, so the launcher reaches the count)."""
    from repro_torch import _device
    from repro_torch.launch import mesh
    monkeypatch.setattr(_device, "resolve_device",
                        lambda d=None: torch.device(d or "cpu"))
    monkeypatch.setattr(mesh, "visible_devices", lambda: [])
    with pytest.raises(ValueError, match="divide|cards"):
        serve.main(BASE + flag)


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(BASE + STATIC)
