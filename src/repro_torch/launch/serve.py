"""Serving launcher: loads (or draws) a model and serves synthetic requests,
either one batch through the engine or a queue of mixed-length requests
with Poisson arrivals through the continuous-batching scheduler (port of
`repro.launch.serve`, the same flags and the same lines on stdout).

    python -m repro_torch.launch.serve --arch musicgen-large --smoke
    python -m repro_torch.launch.serve --arch phi3-medium-14b --smoke \\
        --freeze --kv-bits 1 --queue --prefill-chunk 4 --page-size 4 \\
        --prefix-cache --queue-cap 3 --inject-faults 'nan@admit:1'

--smoke takes the reduced same-family config; without it the arch serves at
its full size. Without --device the run is on the CUDA card (and raises if
there is none). --ckpt reads a checkpoint directory in the JAX package's
format (`checkpoint.manager`), fp32 masters or packed 1-bit leaves; without
it the weights are drawn from --seed (`Model.init`; at full size with
--freeze, `Model.init_frozen`, one layer's masters at a time). The prompts
are numpy draws from --seed, the JAX launcher's, so on the same checkpoint
both print the same `req i:` lines.

With frozen weights it prints, as the JAX launcher does, one `kernel route`
line per entry of `ServingEngine.kernel_routes()`: the route table's answer
for the engine's shapes (`kernels.tune`; on the card `cuda` and the
launch's fields).

--mesh D,M (or 'data=D,model=M', or 'D') serves over a mesh of D*M shards
(`launch.mesh`): the scheduler splits its slots over the data axis and
prints, after the JAX launcher's `serving mesh` line, each shard's resident
bytes (a data row's 'model' 0 shard holds the row; the other shards 0).
--replicas R fans one queue of mixed-length requests out to R
single-device engines (`serving.replica`) and prints the JAX launcher's
replica lines, its fit line with --freeze, and each request's tokens as
`req i:` lines. With --device D every shard or replica sits on D (the CPU,
or one card holding them all); without it, each gets a card of its own,
and there must be enough cards.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests to serve")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="prompt length (max length in --queue mode: "
                         "lengths are drawn from [prompt_len//4, prompt_len])")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--ckpt", default=None, help="checkpoint dir to load")
    ap.add_argument("--freeze", action="store_true",
                    help="freeze binary weights to packed 1-bit form and "
                         "serve from XNOR+popcount")
    ap.add_argument("--kv-bits", type=int, default=0, choices=(0, 1),
                    help="1 = bit-resident KV cache: K/V stored as packed "
                         "sign bitplanes, decode attention via XOR+popcount")
    ap.add_argument("--queue", action="store_true",
                    help="continuous-batching mode: mixed-length requests "
                         "stream through the slot scheduler")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked admission in chunks of this many tokens, "
                         "interleaved with decode bursts (0 = whole-prompt "
                         "admission)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache: pages of this many tokens in a "
                         "shared refcounted pool (0 = contiguous slot "
                         "cache; attention families, needs --prefill-chunk)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="page-pool size (0 = slots * pages-per-slot)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prefix cache over full KV pages "
                         "(needs --page-size)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="requests/second Poisson arrivals in --queue mode "
                         "(0 = submit everything upfront)")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve over a device mesh: 'data=D,model=M' (or "
                         "'D,M'/'D'). The scheduler shards its slots over "
                         "the data axis; a model axis replicates serving "
                         "state and is reserved for the tensor-parallel "
                         "kernel wrappers. With --device every shard sits "
                         "on that device")
    ap.add_argument("--replicas", type=int, default=0,
                    help="data-parallel replica serving: one request queue "
                         "fans out to this many single-device engines "
                         "(serving.replica; exclusive with --mesh/--queue)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request TTFT deadline in seconds (--queue "
                         "mode): requests still queued past it are shed "
                         "before any prefill (0 = none)")
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="bounded admission queue: submissions beyond this "
                         "many queued requests are rejected (0 = unbounded)")
    ap.add_argument("--inject-faults", default="",
                    help="deterministic fault plan, comma-separated "
                         "kind@site:index[*times][:param] entries, e.g. "
                         "'device_error@burst:2*3,slow@burst:6:0.05' "
                         "(serving.faults)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, cuda, ...; default: the CUDA card")
    args = ap.parse_args(argv)

    import torch

    from repro_torch._device import resolve_device
    from repro_torch.configs.base import get_config
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.faults import parse_plan

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    fault_plan = None
    if args.inject_faults:
        fault_plan = parse_plan(args.inject_faults)
        print(f"fault plan armed: {len(fault_plan.faults)} fault(s) — "
              f"{args.inject_faults}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.ckpt:
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager(args.ckpt)
        like = model.init(torch.Generator().manual_seed(0), device="meta")
        params = mgr.restore(mgr.latest_step(), like, device=dev)
    elif args.freeze and not args.smoke:
        params = model.init_frozen(gen, device=dev)
    else:
        params = model.init(gen, device=dev)

    if args.replicas:
        _serve_replicas(cfg, params, args, fault_plan)
        return 0

    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import (make_serving_mesh, parse_mesh,
                                             visible_devices)
        data, model_ax = parse_mesh(args.mesh)
        devices = ([dev] * (data * model_ax) if args.device is not None
                   else visible_devices())
        mesh = make_serving_mesh(data, model_ax, devices=devices)
        print(f"serving mesh: data={data} x model={model_ax} over "
              f"{data * model_ax} of {len(devices)} devices")

    eng = ServingEngine(cfg, params,
                        max_len=args.prompt_len + args.max_new + 1,
                        freeze=args.freeze, slots=args.slots, seed=args.seed,
                        kv_bits=args.kv_bits, mesh=mesh,
                        prefill_chunk=args.prefill_chunk or None,
                        page_size=args.page_size or None,
                        pool_pages=args.pool_pages or None,
                        prefix_cache=args.prefix_cache,
                        queue_cap=args.queue_cap or None,
                        fault_plan=fault_plan)
    if eng.frozen:
        rb = eng.resident_weight_bytes()
        total = rb["binary"] + rb["other"]
        print(f"serving packed 1-bit weights: {total/1e6:.2f} MB resident "
              f"total = {rb['binary']/1e6:.2f} MB binary layers (packed) "
              f"+ {rb['other']/1e6:.2f} MB non-binary (embeddings, norms, "
              f"recurrence dynamics)")
        cb = eng.resident_cache_bytes()
        print(f"kv cache / state ({eng.slots} slots x {eng.max_len}): "
              f"{cb['total']/1e6:.3f} MB resident = {cb['packed']/1e6:.3f} MB "
              f"packed bitplanes (kv_bits={eng.cfg.kv_bits}) + "
              f"{cb['float']/1e6:.3f} MB float (fp K/V, V scales, recurrent "
              f"state)")
        pp = cb.get("page_pool")
        if pp is None and eng.page_size:
            pp = eng.scheduler().page_stats()
        if pp:
            pinned = pp.get("pinned_by_prefix", 0)
            print(f"page pool: {pp['pages']} pages x {pp['page_size']} "
                  f"tokens = {pp['allocated']} allocated "
                  f"({pinned} pinned by prefix tree) + {pp['free']} free")
        if mesh is not None:
            # each shard's residency: a data row's 'model' 0 shard holds
            # the params on its device, the row's cache / pool replica and
            # serving state; the row's other shards nothing
            for shard, b in eng.resident_bytes_per_device().items():
                print(f"  {shard}: {b['total']/1e6:.3f} MB resident = "
                      f"{b['weights']/1e6:.3f} MB weights + "
                      f"{b['cache']/1e6:.3f} MB cache/pool + "
                      f"{b['state']/1e6:.3f} MB serving state")
        for name, (route, params) in eng.kernel_routes().items():
            extra = f" {params}" if params else ""
            print(f"kernel route {name}: {route}{extra}")
    rng = np.random.default_rng(args.seed)

    if args.queue:
        _serve_queue(eng, cfg, rng, args)
        return 0

    reqs = [Request(prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=args.max_new)
            for _ in range(args.batch)]
    outs = eng.generate(reqs)
    for i, o in enumerate(outs):
        print(f"req {i}: {o.tolist()}")
    print("stats:", eng.scheduler().stats)
    return 0


def _serve_replicas(cfg, params, args, fault_plan) -> None:
    """Replica fan-out: one queue of `--batch` mixed-length requests
    round-robins over `--replicas` single-device engines
    (serving.replica)."""
    from repro_torch.launch.mesh import visible_devices
    from repro_torch.models.api import param_count
    from repro_torch.serving.engine import Request
    from repro_torch.serving.replica import ReplicaServer, devices_needed

    if args.device is not None:
        devs = [params["embed"].device] * args.replicas
    else:
        devs = visible_devices()
        if args.replicas > len(devs):
            raise ValueError(f"--replicas {args.replicas} > {len(devs)} "
                             f"cards (pass --device to put every replica "
                             f"on one)")
        devs = devs[:args.replicas]
    srv = ReplicaServer(cfg, params, devices=devs,
                        fault_plan=fault_plan,
                        max_len=args.prompt_len + args.max_new + 1,
                        freeze=args.freeze, slots=args.slots, seed=args.seed,
                        kv_bits=args.kv_bits,
                        prefill_chunk=args.prefill_chunk or None,
                        page_size=args.page_size or None,
                        pool_pages=args.pool_pages or None,
                        prefix_cache=args.prefix_cache)
    rng = np.random.default_rng(args.seed)
    lo = max(1, args.prompt_len // 4)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab,
                                        int(rng.integers(lo, args.prompt_len + 1)),
                                        dtype=np.int32),
                    max_new_tokens=args.max_new)
            for _ in range(args.batch)]
    t0 = time.time()
    outs = srv.generate(reqs)
    wall = time.time() - t0
    st = srv.stats()
    print(f"{st['replicas']} replicas ({st['healthy']} healthy, "
          f"{st['failovers']} failover rounds) served {len(outs)} requests "
          f"in {wall:.3f}s | {st['tokens_out']/wall:.1f} tok/s aggregate")
    for e in st["per_replica"]:
        line = (f"  {e['device']}: {e['weight_bytes']/1e6:.2f} MB weights + "
                f"{e['cache_bytes']/1e6:.3f} MB cache")
        s = e.get("scheduler")
        if s:
            line += (f" | {s['completed']} reqs, {s['tokens_out']} tokens, "
                     f"decode {s['decode_s']:.3f}s")
        print(line)
    if args.freeze:
        # the fit argument, in device units: a per-device budget sized so
        # the fp32 masters would need 8 devices vs what packed needs
        wb = st["per_replica"][0]["weight_bytes"]
        unpacked = param_count(params) * 4
        budget = -(-unpacked // 8)
        print(f"fit at a {budget/1e6:.2f} MB/device budget (float needs "
              f"{devices_needed(unpacked, budget)}): packed replica fits in "
              f"{devices_needed(wb, budget)} device(s)")
    for i, o in enumerate(outs):
        print(f"req {i}: {o.tolist()}")


def _serve_queue(eng, cfg, rng, args) -> None:
    """Stream `--batch` mixed-length requests through the scheduler with
    exponential inter-arrival gaps (`--arrival-rate` req/s). `--deadline`
    sets each request's TTFT deadline (late ones shed); `--queue-cap`
    bounds the admission queue (overflow rejected with backpressure);
    `--inject-faults` arms the scheduler's fault plan."""
    from repro_torch.serving.engine import Request
    from repro_torch.serving.faults import QueueFull

    sched = eng.scheduler()
    lo = max(1, args.prompt_len // 4)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab,
                                        int(rng.integers(lo, args.prompt_len + 1)),
                                        dtype=np.int32),
                    max_new_tokens=int(rng.integers(1, args.max_new + 1)),
                    deadline_s=args.deadline or None)
            for _ in range(args.batch)]
    if args.arrival_rate > 0:
        gaps = rng.exponential(1.0 / args.arrival_rate, size=len(reqs))
        arrive_at = np.cumsum(gaps)
    else:
        arrive_at = np.zeros(len(reqs))

    t0 = time.time()
    pending = list(zip(arrive_at, reqs))
    lats, ttfts, itls = [], [], []
    while pending or not sched.idle:
        now = time.time() - t0
        while pending and pending[0][0] <= now:
            _, req = pending.pop(0)
            try:
                rid = sched.submit(req)
            except QueueFull:
                print(f"t={now:7.3f}s REJECT (queue at cap "
                      f"{sched.queue_cap}) prompt={req.prompt.size}")
                continue
            print(f"t={now:7.3f}s submit rid={rid} "
                  f"prompt={req.prompt.size} max_new={req.max_new_tokens}")
        if sched.idle and pending:
            time.sleep(min(0.01, pending[0][0] - now))
            continue
        # a non-drain poll yields at every completion, so slots stay
        # admittable for requests arriving mid-flight
        for c in sched.poll(drain=not pending):
            if c.status != "completed":
                print(f"t={time.time()-t0:7.3f}s {c.status.upper():6s} "
                      f"rid={c.rid}" +
                      (f" ({c.error})" if c.error else ""))
                continue
            lats.append(c.latency)
            ttfts.append(c.ttft)
            itls.extend(c.itl.tolist())
            print(f"t={time.time()-t0:7.3f}s done   rid={c.rid} "
                  f"tokens={c.tokens.size} latency={c.latency*1e3:.1f}ms "
                  f"ttft={c.ttft*1e3:.1f}ms")
    wall = time.time() - t0
    lats = np.asarray(sorted(lats))
    ttfts = np.asarray(ttfts)
    # the scheduler syncs the device before every clock read, so these are
    # compute times, not dispatch times
    itl_p99 = f"{np.percentile(itls, 99)*1e3:.1f}ms" if itls else "n/a"
    if lats.size:
        print(f"served {len(lats)} requests in {wall:.3f}s | "
              f"{sched.stats['tokens_out']/wall:.1f} tok/s | "
              f"latency p50 {np.percentile(lats, 50)*1e3:.1f}ms "
              f"p99 {np.percentile(lats, 99)*1e3:.1f}ms | "
              f"ttft p50 {np.percentile(ttfts, 50)*1e3:.1f}ms "
              f"p99 {np.percentile(ttfts, 99)*1e3:.1f}ms | "
              f"inter-token p99 {itl_p99}")
    s = sched.stats
    if any(s[k] for k in ("shed", "errors", "rejected", "burst_retries",
                          "invariant_violations")):
        print(f"resilience: {s['shed']} shed, {s['errors']} errored, "
              f"{s['rejected']} rejected at cap, {s['burst_retries']} "
              f"burst retries, {s['invariant_violations']} invariant "
              f"violations (degraded to cache bypass)")
    print(f"decode steps {sched.decode_steps()} "
          f"bursts {sched.stats['bursts']} | "
          f"prefill {sched.stats['prefill_s']:.3f}s "
          f"decode {sched.stats['decode_s']:.3f}s | "
          f"chunked admission: {sched.prefill_chunk or 'off'} "
          f"({sched.prefill_shape_count} prefill shapes compiled)")
    ps = sched.page_stats()
    if ps is not None:
        line = (f"page pool: {ps['allocated']}/{ps['pages']} pages "
                f"allocated ({ps.get('pinned_by_prefix', 0)} pinned by "
                f"prefix tree)")
        tree = ps.get("prefix_tree")
        if tree is not None:
            line += (f" | prefix cache: {tree['hits']}/{tree['lookups']} "
                     f"hits, {sched.stats['prefill_tokens_saved']} prompt "
                     f"tokens served zero-copy, {tree['evicted']} evicted")
        print(line)


if __name__ == "__main__":
    raise SystemExit(main())
