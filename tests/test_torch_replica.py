"""Replica serving (`repro_torch.serving.replica`) on repeated CPU devices,
the mirror of the JAX package's replica tests (`tests/test_sharded_serving.py`
and `tests/test_faults.py`, which skip on a one-device host), against the
single-device port engine: greedy tokens identical over two replicas;
replica 0 killed mid-batch fails over to the survivor with every token
still identical; every replica dead raises `ReplicaDead` with `.partial`;
a worker's own exception reaches the caller with health unchanged; the
worker threads take the caller's grad / inference / flush-denormal modes;
`devices_needed`; the launch counts the workers share lose no update;
and the serving CLI's `--replicas`.
"""
import contextlib
import io
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.smoke import smoke_config
from repro_torch.kernels import _build
from repro_torch.launch import serve as cli
from repro_torch.models.api import get_model
from repro_torch.serving import replica as R
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faults import (Fault, FaultPlan, ReplicaDead,
                                        RequestError)

ARCH = "qwen2-72b"
TRAFFIC = [(5, 4), (11, 3), (3, 5), (8, 2)]
FAULT_KW = dict(max_len=24, slots=2, prefill_chunk=4)


@pytest.fixture(scope="module")
def setup():
    cfg = smoke_config(ARCH)
    return cfg, get_model(cfg).init(torch.Generator().manual_seed(0),
                                    device="cpu")


def _requests(cfg, seed, lens_budgets):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab, p, dtype=np.int32),
                    max_new_tokens=m) for p, m in lens_budgets]


def _server(cfg, params, plan=None, **kw):
    return R.ReplicaServer(cfg, params, devices=["cpu", "cpu"],
                           fault_plan=plan, backoff_s=0.001, **kw)


def test_replica_server_greedy_identical(setup):
    """Round-robin replicas against one engine on the same queue: greedy
    tokens bit for bit, merged back into submission order."""
    cfg, params = setup
    reqs = _requests(cfg, 2, [(7, 6), (12, 5), (3, 8), (9, 4), (5, 7)])
    kw = dict(max_len=64, freeze=True, slots=4, kv_bits=1)
    want = ServingEngine(cfg, params, **kw).generate(reqs)
    srv = _server(cfg, params, **kw)
    got = srv.generate(reqs)
    for i, (a, b) in enumerate(zip(want, got, strict=True)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    st = srv.stats()
    assert st["replicas"] == 2 and st["tokens_out"] == sum(map(len, want))
    assert [e["scheduler"]["completed"] for e in st["per_replica"]] == [3, 2]
    assert R.devices_needed(10, 3) == 4 and R.devices_needed(1, 100) == 1
    with pytest.raises(ValueError):
        R.devices_needed(1, 0)
    with pytest.raises(ValueError, match="mesh"):
        R.ReplicaServer(cfg, params, devices=["cpu"], mesh=object())


def test_replica_death_fails_over_bit_identical(setup):
    """Kill replica 0 at its second poll: its unfinished requests fail over
    to the survivor and every token matches a fault-free single engine."""
    cfg, params = setup
    reqs = _requests(cfg, 0, TRAFFIC + [(6, 3)])
    ref = ServingEngine(cfg, params, **FAULT_KW).generate(reqs)
    plan = FaultPlan([Fault("death", "replica0", 1)])
    srv = _server(cfg, params, plan, **FAULT_KW)
    out = srv.generate(reqs)
    assert srv.health == [False, True]
    assert srv.failovers == 1
    assert 0 in srv.last_errors
    for a, b in zip(ref, out, strict=True):
        np.testing.assert_array_equal(a, b)
    st = srv.stats()
    assert st["healthy"] == 1 and st["failovers"] == 1
    assert st["per_replica"][0]["healthy"] is False
    assert "died" in st["per_replica"][0]["error"]


def test_all_replicas_dead_raises_with_partial(setup):
    cfg, params = setup
    plan = FaultPlan([Fault("death", "replica0", 0, times=99),
                      Fault("death", "replica1", 1, times=99)])
    srv = _server(cfg, params, plan, **FAULT_KW)
    with pytest.raises(ReplicaDead) as ei:
        srv.generate(_requests(cfg, 0, TRAFFIC))
    assert srv.health == [False, False]
    assert isinstance(ei.value.partial, dict)


def test_replica_worker_exception_propagates(setup):
    """A worker's own exception (a validation error) reaches the caller,
    never a partial result, and kills no replica."""
    cfg, params = setup
    srv = _server(cfg, params, **FAULT_KW)
    bad = [Request(prompt=np.zeros((3,), np.int32)),
           Request(prompt=np.zeros((0,), np.int32))]
    with pytest.raises(RequestError):
        srv.generate(bad)
    assert srv.health == [True, True]    # a bug is not a death


def test_workers_take_the_callers_thread_modes(setup, monkeypatch):
    """Each mode on a server of its own (a scheduler's state made under
    inference mode stays inference tensors)."""
    cfg, params = setup
    seen = []
    drive = R.ReplicaServer._drive

    def spy(self, i, shard):
        seen.append((torch.is_grad_enabled(),
                     torch.is_inference_mode_enabled(),
                     R._flushes_denormals()))
        return drive(self, i, shard)

    monkeypatch.setattr(R.ReplicaServer, "_drive", spy)
    reqs = _requests(cfg, 0, TRAFFIC)
    torch.set_flush_denormal(True)
    try:
        with torch.inference_mode():
            _server(cfg, params, **FAULT_KW).generate(reqs)
        with torch.no_grad():
            _server(cfg, params, **FAULT_KW).generate(reqs)
    finally:
        torch.set_flush_denormal(False)
    _server(cfg, params, **FAULT_KW).generate(reqs)
    assert seen == [(False, True, True)] * 2 + [(False, False, True)] * 2 \
        + [(True, False, False)] * 2


def _cli(*argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--arch", "phi3-medium-14b", "--smoke", "--freeze",
                         "--kv-bits", "1", "--batch", "3", "--prompt-len",
                         "8", "--max-new", "5", "--device", "cpu",
                         *argv]) == 0
    return buf.getvalue().splitlines()


def test_cli_replicas_print_single_device_tokens():
    """`--replicas 2` prints one replica's `req i:` lines (`--replicas 1`,
    a single-device engine on the same requests), after JAX's summary, per
    replica and fit lines."""
    two, one = _cli("--replicas", "2"), _cli("--replicas", "1")
    req = [ln for ln in one if ln.startswith("req ")]
    assert len(req) == 3 and [ln for ln in two if ln.startswith("req ")] == req
    assert two[0].startswith("2 replicas (2 healthy, 0 failover rounds) "
                             "served 3 requests in ")
    assert [ln.split(":")[0] for ln in two[1:3]] == ["  cpu", "  cpu"]
    assert "2 reqs" in two[1] and "1 reqs" in two[2]
    assert two[3].startswith("fit at a ") and "packed replica fits in" \
        in two[3]


def test_launch_counts_lose_no_update_across_threads():
    """The kernels' launch tables are process-wide and every replica's
    worker counts into them: 16 threads (more than this machine's cores)
    counting 2,000 launches each, with the interpreter switching threads
    every microsecond, lose none."""
    table = {"k": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count(table, "k") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert table["k"] == 16 * 2000
