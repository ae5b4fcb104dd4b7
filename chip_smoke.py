#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out report.json]

Phases, each of which raises on failure (nothing is caught):
  1. device  - the card's name, count, and name + power limit from nvidia-smi
  2. build   - nvcc builds every kernel from the sources in this checkout,
               one nvcc per source, all started together
  3. kernels - each Hopper kernel against its plain PyTorch version on the
               card, at the shapes the main paths give it and at ragged
               ones: int32 dots and packed words must be equal (tolerance
               0); attention outputs within rtol = atol = 2^-7 (bf16, one
               ulp) or 1e-6 (float32, 8 ulps), with equal signs; the paged
               attention kernels (7, 9) bit for bit equal to their plain
               versions and to the contiguous kernels on the gathered
               panels, dots at every position included; kernels 1-3 also
               at the LM's GEMM shapes (phi3-medium-14b, falcon-mamba-7b)
               at 4 and 32 rows and at the edges of their dispatch rule
               (`gemm_plan`; kernel 1 at 1, 8, 9, 16 and 33 rows too, K
               off a word, KW % 4 != 0, and its small-M kernel forced to
               every K split and width), one launch per call; the
               prefill kernels (8, 9) at T 2,048 and 4,096, past ~1,770,
               where a (32, T) score panel no longer fits shared memory (a
               window shorter than the chunk, kv_len 0 rows, shuffled pools
               with sentinel tails, T splits of 1, 2, 4 and 8 over a
               cluster): dots exact, outputs within the
               tolerance, paged equal to contiguous bit for bit; a one-row
               prefill equal to decode bit for bit, paged and contiguous;
               the decode kernels (6, 7) at T 2,048, 4,096 and 16,384, past
               the old panel body's ~14,500 (a window, cache_len 0 rows,
               shuffled pools with sentinel tails, T splits of 1, 2, 4 and
               8): dots exact, outputs within the tolerance, paged equal to
               contiguous bit for bit, with dots and as served; kernel 5's
               cache entry (`pack_rows_into`: K and V rows packed into
               their cache rows in one launch) at a decode step with
               inactive rows, a 32-row chunk with n_valid < 32, a 200-row
               prompt, paged rows with sentinel and sink writes, K off a
               word and K % 8 != 0, float32 and bf16 with -0.0 and NaN:
               both caches equal the plain version's bit for bit, one
               launch per call; at recurrentgemma-2b's shapes: kernel 6 on
               its ring (B 4, T 2,048, one KV head, G 10, hd 256: the
               wide body; cache lengths 0, 1, 17, 2,047, 2,048), kernel
               5's `pack_rows_into` of hd-256 K|V rows into the ring's
               (B*W, 1, 8) view (wrapped slots, -1 drops, a chunk after
               the ring, whole prompts of 200 and of 3,000 wrapped), and
               kernels 1 and 2 at its GEMM shapes at 4, 32 and 200 rows;
               at the shapes of phase 11's families: kernels 1-3 at their
               GEMMs at 4, 32 and 200 rows (qwen2's d_ff 29,568, deepseek's
               22,016, musicgen's bf16 FFN), kernel 3 at nemotron's
               up-projection (K 6,144, N 24,576; bf16 and float32 lhs)
               with the sq_relu fold's constant threshold (all-ones words)
               and with random ones, its dots of both signs, and kernel 1
               on its words (K 24,576); kernels 6-9 at each family's head
               layout (Hkv 8 G 8 hd 128, Hkv 8 G 6, Hkv 32 G 1 hd 64;
               lengths 1, 17, 512, 300; paged equal to contiguous and to
               the plain versions); kernel 5 at their packs and K|V rows;
               at the MoE configs' shapes (dbrx-132b, llama4-scout): kernel
               1's batched entry ((E, C, KW) x (E, N, KW), every expert in
               one launch) at both configs' gate|up and down at C 1, 2,
               10, 15 and 62 and ragged cases (E 3, K off a word, KW % 4
               != 0, C 9 and 33), each call's last capacity row all zero
               (an empty slot's all-ones words); kernel 5 at the (E C, D |
               F) packs; kernels 6-9 at G 6 and G 5, hd 128; a decode row
               of cache_len 0 weighs every position of its row alike (the
               JAX oracle's all-masked softmax), bit for bit with the
               plain version
  4. mlp     - bnn-mnist (784-1024x3-10) frozen, batches of 200 through the
               kernels; hidden words and scores equal the plain path's, the
               fp32-master path's, and the CPU's on a small batch
  5. cnn     - bnn-cifar10 (128,128,256,256,512,512 convs, 1024 FC, 32x32x3)
               frozen with shift-BN, batches of 100; the same checks
  6. lm      - phi3-medium-14b at full width, depth cut to 2, frozen, served
               by ServingEngine(kv_bits=1, prefill_chunk=32, slots=4,
               max_len=512): 8 greedy requests, prompts of 17-200 tokens
               from the seed, 16 new tokens, one stopping at an eos taken
               from its own greedy run; tokens equal the plain path's on the
               card (on a difference, the first differing cache sign bit)
  6b. paged - the same width at depth 2, served from the paged 1-bit KV
               pool with the prefix cache (page 32): 8 greedy requests of a
               shared 128-token prefix plus 17-72 tokens of their own, 16
               new tokens each, through four engines (paged + prefix cache,
               paged, contiguous, all through the kernels; paged + prefix
               cache through the plain versions): all tokens equal, prefix
               hits >= 1, prefilled + cached tokens = prompt tokens
  6c. default - the JAX package's default serving call at the same width
               and depth 2: ServingEngine(cfg, params, freeze=True)
               (whole-prompt admission, float KV cache), the same at
               kv_bits=1, and kv_bits=0 chunked, contiguous and paged, on
               phase 6's traffic: tokens through the kernels equal the
               plain versions' in each, paged equals contiguous, kernel 5
               launched 2 (float cache) or 3 (packed) times per layer and
               forward call; generate_static through the kernels equals
               the plain versions' on 4 prompts of one length;
               whole-prompt against chunked agreement printed, not held
  7. times   - per kernel and shape: its device time (calls queued behind
               a spin kernel, CUDA events) and its wrapper's CUDA-event
               time, the plain version's, one PyTorch
               library call computing the same function where there is one,
               and the card's bound (bytes against the faster of popc and
               int8 tensor cores); kernels 1 and 2 at the LM's GEMM
               shapes at 4 and 32 rows, apart from the kernels line;
               kernels 8 and 9 on a 32-row chunk at the end of a
               4,096-position context beside SDPA and the bound, and
               kernel 8 at each T split of 1, 2, 4 and 8, kernels 6 and 7
               on 4 slots' decode step against a 4,096-position table
               beside SDPA and the bound, and at each T split at T 512 and
               4,096, apart from the kernels line; each forward per batch,
               one profiled
               frozen forward each; then the LM at full depth (40 layers,
               drawn and frozen one at a time): decode tokens/s, TTFT, ITL,
               resident bytes, one profiled decode step (device busy
               share, launches); then the same 40-layer weights serving the
               shared-prefix traffic from the paged pool with the prefix
               cache and from the contiguous cache: decode tokens/s, TTFT of
               hit and miss requests, ITL, prefix stats, the page pool,
               tokens equal; then the default engine (whole prompt, float
               cache) on the same weights and traffic: decode tokens/s,
               TTFT, ITL, cache bytes beside the packed cache's, one
               profiled decode step; the same weights in float32 (float
               leaves cast up), whole-prompt against chunked admission of
               the default engine on phase 6's traffic: requests and
               leading tokens in common, and for the first request that
               parts each layer's K/V rows after prefill (the first layer
               whose K rows differ is where the two paths part; printed,
               not held); the float attention (plain PyTorch)
               beside SDPA at the decode step and a 200-token prefill;
               what a kernel-5 wrapper call's time is made of
  8. train   - kernel 4 (binary_gemm_mxu: w sign-packed along K, then
               kernel 2's tensor-core tiles or small-M kernel with a float32
               store) against its plain version at the five binary-conv
               shapes of a bnn-cifar10 train step (batch 100), ragged ones
               and each regime of its plan (small M, split K), float32 and
               bf16 x, NaN and -0.0 in x and w, tolerance 0, one launch per
               call; bnn-cifar10 at full width, batch
               100, BBP stochastic from a seeded device generator, shift-BN,
               S-AdaMax, 3 steps through each route (auto: kernel 4; vpu:
               sign-pack + XNOR-popcount kernels; ref: plain) from the same
               weights, batches and draws: step-1 binary-conv outputs and
               scores, then losses, params, BN and optimizer state equal
               (tolerance 0), launches 5 per step on auto, 0 on ref; a
               deterministic step of 2 images on the card against the CPU's
               (1e-5 of each tensor's largest magnitude; params off by more
               only where S-AdaMax's per-element normalization carries the
               moments' difference: a noise-floor gradient, an AP2 boundary,
               or through a shared AP2 factor); bnn-mnist (batch 200) 3
               steps; 30 steps of bnn-cifar10 on SyntheticImages lower the
               loss; kernel 4's
               times beside its bound, plain version, torch._int_mm on
               +-1 int8 and signing x and w to int8 + torch._int_mm; the
               train step per batch on auto and ref (ms, images/s), one
               profiled step (busy share, launches), peak memory
  9. ssm     - kernel 10 (selective_scan) against its plain version on the
               card, tolerance 0: the decode step (4, 1, 8192, 16) from a
               state, the prefill chunk (1, 32, 8192, 16) with and without
               one, a long prefill (1, 4096, 8192, 16), ragged shapes (D
               8200, N 2 / 4 / 16, T 1 / 7 / 33, float32 and bf16 xi); two
               chained launches equal one, dt = 0 pads keep h bit for bit;
               falcon-mamba-7b at full width, depth cut to 2, frozen, served
               by ServingEngine(prefill_chunk=32, slots=4, max_len=512) on
               phase 6's traffic through the kernels and the plain
               versions: tokens equal, kernel 10 launched layers x (chunks +
               decode steps) times, kernel 2 three times that, nothing
               else; the same with whole-prompt admission (kernel 10 at T
               = S): tokens equal; kernel 10's times at the decode, chunk and long
               prefill shapes beside its bound, its float64-exp floor and
               its plain version; all 64
               layers (drawn and frozen one at a time) on the same
               traffic: decode tokens/s, TTFT, ITL, resident weight and
               state bytes, peak memory, one profiled decode step
  10. hybrid - recurrentgemma-2b at full width, depth cut to 5 (one group
               of rec, rec, attn and a tail of two rec layers), frozen,
               on phase 6's traffic plus one request of 2,100 prompt and
               24 new tokens (the ring of 2,048 wraps in whole-prompt
               and chunked prefill and in decode), through four engines:
               chunked at kv_bits=1 (the main path), the default engine
               (whole prompt, float ring), whole prompt at kv_bits=1,
               chunked at kv_bits=0: tokens through the kernels equal the plain
               versions' (on a difference, the first differing state
               element and ring sign bit), launches of kernels 1, 2, 5
               and 6 per forward call and decode step as counted from the
               layers; generate_static against the plain versions; whole
               prompt against chunked printed, not held; kernel 6 at the
               ring shape timed beside SDPA and the bound; all 26 layers
               (drawn and frozen one at a time), chunked kv_bits=1 and
               the default engine: decode tokens/s, TTFT, ITL, weight,
               ring and state bytes, peak memory, one profiled decode
               step (214 launches of the four kernels at kv_bits=1) and
               the float32 gate products' device time
  11. dense families - deepseek-67b, qwen2-72b (QKV bias), nemotron-4-15b
               (LayerNorm; its frozen sq_relu FFN runs bit-resident: kernel
               3 emits the hidden words, kernel 1 reads them) and
               musicgen-large (sinusoidal positions, GELU, 32 heads of 64),
               each at full width, depth cut to 2, frozen, norm scales and
               biases and the QKV bias drawn N(0, 0.02^2), through three
               engines: chunked at kv_bits=1 on phase 6's traffic (the main
               path), the default engine (whole prompt, float cache), and
               paged at kv_bits=1 with the prefix cache on phase 6b's
               shared-prefix traffic; tokens through the kernels equal the
               plain versions', launches of kernels 1, 2, 3, 5 and 6-9
               held to the counts of the layers (`family_per_call`) per
               forward call; generate_static against the plain versions;
               kernel 3 at nemotron's up-projection timed beside
               torch._int_mm and its bound, and its small-M kernel against
               its tiles at 1-32 rows on four shapes (words equal; the
               ground of gemm_plan's FUSED_SMALL_M_ROWS); then each family
               at all its layers (drawn and frozen one at a time; cut to
               40 when the script runs late), chunked kv_bits=1
               and the default engine: decode tokens/s, TTFT, ITL, weight
               and cache bytes, peak memory, one profiled decode step with
               its kernel launches asserted
  12. moe   - dbrx-132b (16 experts, top-4) and llama4-scout-17b-a16e (16
               experts, top-1), frozen experts, router and norms drawn
               N(0, 0.02^2), at full width, depth cut to 2, through phase
               11's three engines against the plain versions (tokens
               equal; per layer and call kernel 5 x3 (+1 at kv_bits=1:
               the qkv pack, the dispatch buffer's for gate and up, the
               hidden's), kernel 1 x6 (q, k, v and one batched launch for
               each of gate, up and down), kernel 2 x1, attention x1), the
               share of dropped routes printed per engine (not held: the
               reference's semantics), generate_static against the plain
               versions; the batched kernel 1 timed at the experts' shapes
               and capacity rows beside its bound, plain version and
               torch._int_mm / torch.bmm; each config at all its layers
               (as phase 11's, cut to 40 when the script runs late),
               chunked kv_bits=1 and the default engine, as phase 11
  13. vlm   - llama-3.2-vision-11b (40 layers in 8 groups of a gated
               cross-attention block and four self blocks; 1,600 image
               tokens of 1,280), frozen, norms N(0, 0.02^2) and the cross
               gates N(0, 1), at full width, depth cut to 10 (two groups,
               so a group-index fault shows), each request with its own
               image embeddings N(0, 1) from the seed, through three
               engines against the plain versions: chunked kv_bits=1 and
               the default engine on phase 6's traffic, paged kv_bits=1
               with the prefix cache on phase 6b's (no prefix hit: the
               family shares no page); tokens equal, launches held per
               block and call (`vlm_expected`: the image K/V once per
               admission and group; the cross-attention through kernel 8
               non-causal per chunk and kernel 6 per decode step);
               generate_static refuses the family; kernel 1 at the image
               K/V (M 1,600, K 1,280, N 1,024), kernel 5 on the image and
               kernels 6 and 8 over the image rows timed beside their
               bounds, torch._int_mm and SDPA; all 40 layers, chunked
               kv_bits=1 and the default engine, as phase 11. Phase 3
               holds kernel 8 with causal=False at every T split (held
               and streamed shares) and a one-row non-causal chunk to
               kernel 6 bit for bit, kernel 6 over 1,600 full rows, kernel
               1 at the image K/V, kernel 5 on the image and its K|V rows
               into a slot, kernels 6-9 at G 4
  14. lm train - phi3-medium-14b at full width, depth cut to 2 (1 if the
               disk cannot hold two checkpoints), bf16 activations, fp32
               masters, bbp_det, remat, S-AdaMax, through the Trainer on
               SyntheticLM at batch 8 x 512 for 4 steps, checkpoints every
               2 steps (keep 1) under build/lm_train (deleted after): a
               straight run; a run stopped after 2 steps (the SIGTERM
               path); a fresh Trainer resuming it, whose losses of steps
               2-3 and final params and moments equal the straight run's
               bit for bit; the gradients' largest magnitude per step (the
               reference's binarized backward nears float32's range here);
               step ms, tokens/s, peak memory, one profiled step, the
               checkpoint's bytes and seconds to save and restore; the
               trained masters saved with packed_binary=True, restored as
               PackedWeights and served by phase 6's engine (tokens equal
               the plain path's and freeze(masters)', launches as phase
               6's); one train step each of llama4-scout-17b-a16e (depth
               1), falcon-mamba-7b (2), recurrentgemma-2b (3) and
               llama-3.2-vision-11b (5) at full width, batch 4 x 256: loss
               finite, every gradient leaf finite or its overflow of
               float32 proven from a 2^-100-scaled backward, every clip
               key's gradient non-zero; each family's smoke step on the
               card against the CPU (gradients and moments within 5e-5,
               params held through the moments; the unroped families'
               attention from the CPU, parting signs proven exact ties)
  15. lifecycle - phase 6's weights (phi3-medium-14b full width, depth 2)
               through phase 6b's paged kv_bits=1 engine with the prefix
               cache and the invariant watchdog on phase 6's 8 requests
               plus two: fault-free (tokens equal phase 6's plain path's),
               then under a plan arming every single-device fault site
               (LIFECYCLE_PLAN: two failed burst attempts, a 50 ms stall,
               a NaN and a poisoned admission, two exhausted allocs, a
               corrupted prefix tree) with a blocking queue of 3 and two
               requests whose deadlines pass in the queue: every rid
               resolves once, statuses 6 / 2 / 2 (completed / shed /
               error), every armed fault fired, 2 burst retries, 1
               invariant violation degraded to cache bypass, survivors'
               tokens equal the fault-free run's bit for bit, the pool
               audits clean; phase 6's chunked engine built with the float
               cache and switched live by freeze(kv_bits=1) gives phase 6's
               tokens through kernels 6 and 8; the default engine admits a
               prompt whole behind NaN V rows left past it and gives a
               clean engine's tokens; the serving CLI in a subprocess on
               the smoke config (paged, prefix cache, queue cap 3, CLI_PLAN)
               exits 0 with the plan's status lines; printed: decode tok/s
               faulted against fault-free, audit() host ms per burst on the
               64-page pool, the zero fill per whole-prompt admission
               (device ms at 40 layers, max_len 512) beside its bound
  16. route table - `python -m repro_torch.kernels.tune --check` on the
               card's table (a gap fails the run); every bucket of the
               card's standard shapes launched through dispatch (route
               None: the table's winner, or the fixed rule where the real
               shape clamps it) at the shape the bucket was tuned at (a
               card bucket's recorded main-path shape) and at a ragged
               shape inside it, K off a word, against the plain version
               (GEMMs bit for bit; attention dots bit for bit, outputs
               within the tolerance with equal signs); where the winner is
               not the fixed rule's launch, both timed at the shape the
               bucket was tuned at; per kernel: buckets,
               how many differ, the largest rule/tuned ratio; the buckets
               this run launched that the table lacks; host µs of a plan
               choice (memo hit against the fixed rule computed per call);
               phase 15's CLI `kernel route` lines, each a `cuda` launch
  17. mesh    - the tensor-parallel wrappers (`kernels/sharded.py`) on a
               (1, M) mesh of the card: binary_gemm_tp at phi3's q (packed
               lhs) and w_down (bf16 lhs) at 4 and 32 rows and
               binary_gemm_fused_tp at the MNIST MLP's chain step (200 x
               1,024 -> 1,024), over 2 and 4 shards; the four attention
               wrappers at phi3's heads (B 4, Hkv 10, G 4, hd 128, T 512, a
               decode step and a 32-row chunk, contiguous and paged) over 2
               and 5 shards: one launch per shard per call, GEMM dots and
               words bit for bit, attention dots bit for bit and outputs
               within ATTN_TOL with equal signs against the unsharded
               launch; device ms of the wrapper, of its shards' launches
               alone and of the unsharded launch. Phase 6's engine and
               weights on `make_serving_mesh(2, 2, devices=[cuda:0] * 4)`:
               phase 6's 8 requests plus 2 at temperature 0.8 give the
               single-device engine's tokens (the greedy ones phase 6's);
               per-shard residency, decode tok/s and a profiled decode step
               (busy ms, launches) beside one device's; phase 6b's paged
               engine with the prefix cache on a data=4 mesh gives the
               single-device engine's tokens on phase 6b's traffic, its
               pool replicas equal; two replicas on the card
               (`ReplicaServer`) give phase 6's tokens, and again with
               replica 0 killed at its second poll (one failover round);
               the serving CLI's `--mesh 2,2` and `--replicas 2` at smoke
               size on the card, two processes, exit 0
  18. mesh train - phi3-medium-14b at full width, depth 2, bbp_det,
               S-AdaMax, 8 x 512: step 0 on a data-2 mesh of the card
               (`make_train_step(mesh=)`) against one device's from the
               same init: loss within MESH_LOSS_REL, moments within
               MESH_GRAD_REL, params held through the moments; one
               profiled step of each (busy share, launches).
               musicgen-large at full width, depth cut to 8 of 48, through
               `Trainer(mesh=)` (placed by the JAX specs) at 8 x 256: a
               straight 4-step run on data 2 and on 2 x 2, a run on 2 x 2
               stopped after 2 (its step-2 checkpoint the one alive under
               build/mesh_train), restored on data 4, data 2 and one
               device (every restored leaf byte-equal to the saved state,
               losses within MESH_LOSS_REL) and resumed on 2 x 2 (losses,
               params and moments equal the straight run's bit for bit);
               per-position resident bytes; EF-SignSGD
               (`train/compressed.py`) over data 2 against the dense step,
               6 steps of SGD(0.02), each loss within 0.08, residuals
               non-zero, compressed_bytes; the 2 x 2-trained masters'
               packed_binary checkpoint served at kv_bits=1, chunk 32 on
               one device, on a 2 x 1 mesh and through the plain versions
               (greedy tokens equal; kernels 1, 2, 5, 6 and 8 launched)
  19. placed train - the JAX package's placement over data x model
               (`param_specs`: masters and S-AdaMax state in pieces, each
               weight gathered per use, gradients reduced onto the pieces,
               projections, vocabulary and experts over 'model'):
               phi3-medium-14b at full width, depth 2, 8 x 512, step 0 on
               a 2 x 2 mesh of the card against one device's, with float32
               activations (loss within 1e-5, moments within 5e-5) and at
               the config's bfloat16 (loss within MESH_LOSS_REL, moments
               within PLACED_BF16_REL), params held through the moments;
               the bf16 limit's witness without a mesh (one device's step
               with its +-1 products, then also their dx, as two column
               halves, as a 'model' 2 column split takes them, against its
               plain step; reported); each position's
               bytes against the whole; peak memory above the step's
               inputs beside one device's and phase 18's data-2 step's;
               one profiled later step (busy share, launches)
  20. dry run - the dry run's counter (`roofline.count`, fake devices)
               on this host's CPU at shapes measured above: phase 14's
               step's roofline bound (H100 SXM datasheet peaks) at most
               its profiled busy time, with the useful-FLOP share; phase
               19's one-device step's predicted peak above its inputs
               within DRYRUN_TEMP_REL of the card's; phase 19's 2 x 2
               step: each position's params + S-AdaMax bytes equal to
               phase 19's, its cross-device bytes predicted; the
               kernel-repetition analysis of phase 8's trained CNN
               (`apply_dedup` on the card equal to the CPU's bit for
               bit); the paper's energy table (`core.energy`)
Every GEMM and packed attention of phases 4-16 takes its launch from the
card's route table (`kernels/tune.py`); phase 3 pins every route to the
fixed rule (`gemm_plan`, `attention_plan`: its checks hold one entry point
to another bit for bit at one plan, and force splits by explicit routes).
Phase 6's engines print their `kernel_routes()`; phase 7 also times phi3's
decode step at all layers with the table and pinned to the fixed rule.
`--record-shapes PATH` writes the buckets this run's launches resolved
through the table (the card's standard shapes, `tuned/card_shapes.json`).
Launch counts are set to 0 just before each main path (mlp, cnn, lm, paged
lm, default lm, train, ssm chunked and whole-prompt, hybrid chunked and
default, each family's, each MoE config's and the vlm's three engines,
the trained checkpoint's engine, the lifecycle's fault-free, faulted and
switched engines, the mesh's 2 x 2 engine) runs and read just after. The line
before the last is {"kernels": [...]} (ten kernels); the last line is
{"ok": true, "device": {...}}. Weights, BN statistics and inputs are
random from the seed; image inputs are multiples of 1/128 in
[-1, 1], like 8-bit pixels. Exits non-zero, printing no result, without a
card or without the repo. It finds the port in the `src` beside it, else in
the working directory's `src` (a copy of the script run from a checkout's
root), else on PYTHONPATH.

    python3 chip_smoke.py --attention-times [--port-src DIR]

builds the kernels and times only the attention kernels (phase 7's lm
kernel, long-context prefill and long-context decode times), of this
checkout or of the port under DIR (another tree's src, such as a parent
commit's unpacked into build/parent: run parent, change, change, parent in
one call to compare them on one card).

    python3 chip_smoke.py --gemm-scan-times [--port-src DIR]

does the same for kernels 1 and 10: kernel 1 at phi3's q, K|V and gate|up
at 4 and 32 rows and at the MLP and CNN output layers, kernel 10 at the
decode, chunk and 4,096-step prefill shapes.

    python3 chip_smoke.py --decode-times N [--port-src DIR]

builds the kernels and serves only phase 7's timed run (phi3-medium-14b
at full width and depth, chunked kv_bits=1, one device) N times, printing
each serve's decode tokens/s and ms per step on one `decode times` JSON
line: processes of the parent's tree and of the change, alternated in one
call, compare the host-bound decode loop.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
import unittest.mock
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def find_port() -> str:
    """Put the port on the import path: the `src` beside this script first,
    then the `src` of the working directory (a copy of the script run from a
    checkout's root), then whatever PYTHONPATH already gives. Exits non-zero,
    naming the places it looked, when none holds `repro_torch`."""
    looked = []
    for src in dict.fromkeys((ROOT / "src", Path.cwd() / "src")):
        looked.append(str(src))
        if (src / "repro_torch" / "__init__.py").is_file():
            sys.path.insert(0, str(src))
            return str(src)
    spec = importlib.util.find_spec("repro_torch")
    if spec is not None and spec.origin:
        return str(Path(spec.origin).parents[1])
    raise SystemExit(f"chip_smoke: no repro_torch package in {looked} or on "
                     f"PYTHONPATH ({os.environ.get('PYTHONPATH', '')!r})")


import torch  # noqa: E402

# every route-table kernel pinned to the fixed rule's launch
# (`tune.route_override`; `cuda` with no params is `gemm_plan` /
# `attention_plan`)
# phase 16's ragged GEMMs: K this far below a whole last word
ROUTE_K_SHORT = 7
FIXED_RULE = dict.fromkeys(("binary_gemm", "binary_gemm_fused",
                            "decode_attention", "prefill_attention",
                            "decode_attention_paged",
                            "prefill_attention_paged"), "cuda")
EXP_PER_CLOCK_PER_SM = 16          # SFU exp issue rate, compute 9.0
FP64_PER_CLOCK_PER_SM = 64         # float64 FMA issue rate, compute 9.0
FP64_OPS_PER_EXP = 17              # float64 instructions of CUDA's double
                                   # exp (its sm_90a SASS): kernel 10's floor
GEMMS = ("binary_gemm_packed", "binary_gemm_packed_rhs", "binary_gemm_fused")
MXU = "binary_gemm_mxu"
SCAN = "selective_scan"
SOURCES = {**{kn: "src/repro_torch/kernels/csrc/binary_gemm.cu"
              for kn in (*GEMMS, MXU)},
           "pack_bits": "src/repro_torch/kernels/csrc/pack.cu",
           SCAN: "src/repro_torch/kernels/csrc/selective_scan.cu",
           **{kn: "src/repro_torch/kernels/csrc/attention.cu" for kn in (
               "decode_attention_packed", "prefill_attention_packed",
               "decode_attention_packed_paged",
               "prefill_attention_packed_paged")}}
REPLACES = {"binary_gemm_packed": "src/repro/kernels/binary_gemm.py:107",
            "binary_gemm_packed_rhs": "src/repro/kernels/binary_gemm.py:166",
            "binary_gemm_fused": "src/repro/kernels/binary_gemm.py:242",
            MXU: "src/repro/kernels/binary_gemm.py:318",
            "pack_bits": "src/repro/kernels/pack.py:35",
            "decode_attention_packed": "src/repro/kernels/decode_attention.py:137",
            "prefill_attention_packed": "src/repro/kernels/prefill_attention.py:131",
            "decode_attention_packed_paged":
                "src/repro/kernels/decode_attention.py:214",
            "prefill_attention_packed_paged":
                "src/repro/kernels/prefill_attention.py:225",
            SCAN: "src/repro/kernels/selective_scan.py:64"}
PAGED_KERNELS = ("decode_attention_packed_paged",
                 "prefill_attention_packed_paged")
RAGGED = [(9, 100, 48), (17, 64, 10), (3, 37, 33), (130, 257, 129)]
# the LM serving path: phi3-medium-14b at full width, kv_bits=1, chunked
# admission; depth cut to LM_CHECK_DEPTH where the tokens are held against
# the plain path (its SWAR popcount GEMMs are slow), all 40 layers in the
# timed run (drawn and frozen one layer at a time: all fp32 masters at once
# would be 54.5 GB)
LM_ARCH, LM_SLOTS, LM_MAX_LEN, LM_CHUNK = "phi3-medium-14b", 4, 512, 32
LM_CHECK_DEPTH = 2
LM_REQUESTS, LM_NEW, LM_PROMPT = 8, 16, (17, 200)
# the paged path: pages of 32 positions (16 per slot at max_len 512), the
# prefix cache on; traffic of a shared 128-token prefix (4 pages) plus a
# suffix of its own per request; kernel checks on a 64-page pool
LM_PAGE, LM_POOL, LM_PREFIX, LM_SUFFIX = 32, 64, 128, (17, 72)
# the training path: bnn-cifar10 at full width and batch 100, BBP with
# stochastic binarization, shift-BN, S-AdaMax; TRAIN_STEPS steps per route,
# CONVERGE_STEPS on SyntheticImages, CPU_BATCH images for the CPU step
TRAIN_ROUTES = ("auto", "vpu", "ref")
TRAIN_STEPS, CONVERGE_STEPS, CPU_BATCH, TRAIN_TIMED = 3, 30, 2, 10
TRAIN_REL = 1e-5
# the Mamba serving path: falcon-mamba-7b at full width (d_inner 8192, N 16)
# on the LM's traffic, engine and chunk; depth cut to SSM_CHECK_DEPTH where
# tokens are held to the plain path, all 64 layers in the timed run (drawn
# and frozen one layer at a time: all fp32 masters at once are ~29 GB);
# kernel 10 also checked and timed at a SSM_LONG-step prefill
SSM_ARCH, SSM_CHECK_DEPTH, SSM_LONG = "falcon-mamba-7b", 2, 4096
# the hybrid serving path: recurrentgemma-2b at full width (d 2560, 10 query
# heads over one KV head of 256, lru width 2560, a ring of 2048 K/V rows per
# attention layer at t % 2048); depth cut to HYBRID_CHECK_DEPTH (one group
# of rec, rec, attn and a tail of two rec layers) where tokens are held to
# the plain path, all 26 layers in the timed run (drawn and frozen one layer
# at a time); phase 6's traffic plus one request whose prompt and new
# tokens (HYBRID_WRAP) pass the ring's 2048 positions, so the ring wraps in
# whole-prompt and chunked prefill and in decode
HYBRID_ARCH, HYBRID_CHECK_DEPTH = "recurrentgemma-2b", 5
HYBRID_WRAP, HYBRID_MAX_LEN = (2100, 24), 2176
# the other dense-stack families, each at full width on phase 6's engine
# and traffic: depth cut to FAMILY_CHECK_DEPTH where tokens are held to the
# plain path, every layer in the timed runs (drawn and frozen one layer at
# a time); their GEMMs checked at FAMILY_ROWS rows (a decode step, a chunk,
# a 200-token prompt). A host slower than usual cuts the timed runs of
# phases 11 and 12 to FAMILY_TIMED_DEPTH (phi3's 40) layers, so that the
# script ends inside its time limit: late means phase 11 starts more than
# FAMILY_LATE_S after the build (on an H100 host ~200-215 s usually and
# 266-272 s in the slowest whole runs, which then took ~1,125 s of the
# 1,200 at all depths); the printed depth says which
FAMILY_ARCHS = ("deepseek-67b", "qwen2-72b", "nemotron-4-15b",
                "musicgen-large")
FAMILY_CHECK_DEPTH, FAMILY_ROWS = 2, (LM_SLOTS, LM_CHUNK, 200)
FAMILY_TIMED_DEPTH, FAMILY_LATE_S = 40, 240
# the MoE family, each at full width on phase 6's engine and traffic (the
# dense families' helpers, depth FAMILY_CHECK_DEPTH where tokens are held to
# the plain path); the batched kernel 1 checked at the experts' capacity
# rows MOE_CAPS: a 4-slot decode step (1), llama4's and dbrx's 32-token
# chunk (2, 10), and their 200-token prompts (15, 62); timed at MOE_TIMED
MOE_ARCHS = ("dbrx-132b", "llama4-scout-17b-a16e")
MOE_CAPS = (1, 2, 10, 15, 62)
# the vlm family: llama-3.2-vision-11b at full width (d 4,096, 32 heads over
# 8 KV heads of 128, 1,600 image tokens of d_vision 1,280) on phase 6's
# engine and traffic, each request with its own image embeddings N(0, 1)
# from the seed; depth cut to VLM_CHECK_DEPTH (two groups of a cross block
# and four self blocks, so that a group-index fault shows) where tokens are
# held to the plain path, all 40 layers in the timed run
VLM_ARCH, VLM_CHECK_DEPTH = "llama-3.2-vision-11b", 10
# the LM train path: phi3-medium-14b at full width (bf16 activations, fp32
# masters, bbp_det, remat, S-AdaMax), depth cut to LM_TRAIN_DEPTH, through
# the Trainer on SyntheticLM at LM_TRAIN_BATCH x LM_TRAIN_SEQ for
# LM_TRAIN_STEPS steps; one step of each other family at full width (depth
# cut so that masters, gradients and moments fit) at FAMILY_TRAIN_BATCH x
# FAMILY_TRAIN_SEQ; every family's smoke step on the card against the CPU,
# the unroped families' attention from the CPU (exact ties)
LM_TRAIN_DEPTH, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 2, 8, 512, 4
TRAIN_FAMILIES = (("llama4-scout-17b-a16e", 1), ("falcon-mamba-7b", 2),
                  ("recurrentgemma-2b", 3), ("llama-3.2-vision-11b", 5))
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ = 4, 256
SMOKE_TRAIN_ARCHS = ("phi3-medium-14b", "dbrx-132b", "musicgen-large",
                     "llama-3.2-vision-11b", "falcon-mamba-7b",
                     "recurrentgemma-2b")
UNROPED_ARCHS = ("musicgen-large", "llama-3.2-vision-11b")
GRAD_SCALE_EXP = 100         # the scaled backward's 2^-100 (family steps)
LM_TRAIN_REL = 5e-5          # tests/test_torch_lm_train.py's GRAD_REL
# the serving lifecycle (phase 15): phase 6b's paged kv_bits=1 engine with
# the prefix cache and the invariant watchdog, on phase 6's requests plus
# two more, fault-free and under LIFECYCLE_PLAN, which arms every
# single-device fault site (two failed burst attempts, a stall, a NaN and a
# poisoned admission, two exhausted allocs after the NaN admission's, a
# corrupted prefix tree), with a blocking queue of LIFECYCLE_CAP and the
# requests LIFECYCLE_LATE carrying deadlines that pass while they are
# queued; LIFECYCLE_STATUSES (completed, shed, error) follow; the CLI runs
# the smoke config under CLI_PLAN on a queue capped at 3 of CLI_BATCH
LIFECYCLE_PLAN = ("device_error@burst:1*2,slow@burst:3:0.05,nan@admit:2,"
                  "poison@admit:5,exhaust@alloc:3*2,corrupt@audit:4")
LIFECYCLE_CAP, LIFECYCLE_LATE, LIFECYCLE_WAIT = 3, (1, 6), 0.02
LIFECYCLE_STATUSES = (6, 2, 2)
CLI_PLAN, CLI_BATCH = "nan@admit:1,device_error@burst:0*2", 5


# the buckets the serving and paper-net paths resolved (`tune.seen`), kept
# before phase 16's own launches add theirs
SERVED_SHAPES: dict = {}


def write_shapes(path: Path, card: str) -> None:
    """The buckets this run's launches resolved through the route table
    outside a route override before phase 16, each as the real shape of
    its first launch, by kernel, as `tune.card_shapes()` reads them."""
    from repro_torch.kernels import tune
    seen = SERVED_SHAPES or tune.seen
    out = {"_meta": {"source": "chip_smoke.py --record-shapes: every bucket "
                               "a launch resolved through the route table "
                               "outside a route override in one run, as "
                               "the real shape of its first launch",
                     "card": card}}
    for (kernel, _), shape in sorted(seen.items()):
        out.setdefault(kernel, []).append(shape)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"recorded {len(seen)} buckets to {path}")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def main_path_shapes(mlp_cfg, cnn_cfg):
    """(kernel, lhs, M, K, N, where) of every binary GEMM in one forward of
    each network, in the order the forwards launch them."""
    hid, mb = mlp_cfg.hidden, mlp_cfg.batch
    shapes = [("binary_gemm_fused", "float", mb, hid, hid, "mlp.l1"),
              ("binary_gemm_fused", "packed", mb, hid, hid, "mlp.l2"),
              ("binary_gemm_packed", "packed", mb, hid, mlp_cfg.n_classes,
               "mlp.out")]
    cb, side, cin = cnn_cfg.batch, cnn_cfg.img, cnn_cfg.widths[0]
    for i, cout in enumerate(cnn_cfg.widths[1:], start=1):
        shapes.append(("binary_gemm_packed_rhs", "float", cb * side * side,
                       9 * cin, cout, f"cnn.conv{i + 1}"))
        cin = cout
        if i % 2 == 1:
            side //= 2
    flat = (cnn_cfg.img // 8) ** 2 * cnn_cfg.widths[-1]
    shapes += [("binary_gemm_fused", "float", cb, flat, cnn_cfg.fc, "cnn.fc1"),
               ("binary_gemm_fused", "packed", cb, cnn_cfg.fc, cnn_cfg.fc,
                "cnn.fc2"),
               ("binary_gemm_packed", "packed", cb, cnn_cfg.fc,
                cnn_cfg.n_classes, "cnn.out")]
    return shapes


class Operands:
    """Random operands of one GEMM on the card: float lhs with exact zeros
    (sign(0) := +1), its packed words, packed weights, thresholds."""

    def __init__(self, gen, m, k, n):
        from repro_torch.core.bitpack import pack_bits
        dev = gen.device
        x = torch.randn(m, k, generator=gen, device=dev)
        x[torch.rand(m, k, generator=gen, device=dev) < 0.05] = 0.0
        self.m, self.k, self.n = m, k, n
        self.x = x
        self.x_bf16 = x.to(torch.bfloat16)
        self.a = pack_bits(x)
        self.b = pack_bits(torch.randn(n, k, generator=gen, device=dev))
        d = int(k ** 0.5)
        self.thresh = torch.randint(-d, d + 1, (n,), generator=gen,
                                    device=dev, dtype=torch.int32)
        self.flip = torch.randint(0, 2, (n,), generator=gen, device=dev,
                                  dtype=torch.int32)

    def call(self, kernel, lhs, plain=False):
        from repro_torch.kernels import binary_gemm as bg
        a = {"float": self.x, "packed": self.a}.get(lhs)
        if lhs == "bf16":            # the LM's activations
            a = self.x_bf16
        if kernel == "binary_gemm_fused":
            fn = bg.binary_gemm_fused_plain if plain else bg.binary_gemm_fused
            return fn(a, self.b, self.thresh, self.flip, self.k)
        if kernel == "binary_gemm_packed_rhs":
            fn = bg.binary_gemm_packed_rhs_plain if plain \
                else bg.binary_gemm_packed_rhs
        else:
            fn = bg.binary_gemm_packed_plain if plain else bg.binary_gemm_packed
        return fn(a, self.b, self.k)


def max_abs_diff(got, want, words: bool) -> int:
    if words:   # compare the 32-bit words as unsigned values
        got, want = got.long() & 0xFFFFFFFF, want.long() & 0xFFFFFFFF
    return int((got.long() - want.long()).abs().max().item()) \
        if got.numel() else 0


def cuda_ms(fn, *, warmup=3, budget_s=0.05, max_iters=500) -> float:
    """Mean device time of fn() in ms, by CUDA events over many calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    iters = int(max(3, min(max_iters, budget_s / max(once, 1e-6))))
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, wrapper: str | None = None) -> float:
    """Device time of one fn() call in ms, host dispatch hidden
    (`tune.device_ms`: CUDA events around `iters` calls queued behind a
    spin kernel). With `wrapper` given, its launch count must grow by
    exactly one per call. (The profiler's trace is not used: it misses
    launches now and then, once all 20 of a kernel's.)"""
    from repro_torch.kernels import tune
    try:
        return tune.device_ms(fn, iters, (lambda: all_launches()[wrapper])
                              if wrapper else None)
    except AssertionError as e:
        raise AssertionError(f"{wrapper or 'library call'}: {e}") from e


def trace(fn, top=6):
    """One profiled call of fn: host wall ms (synchronised), device busy ms
    (the sum of its kernels' device times), kernel launches, and the
    kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall, "busy_ms": busy,
            "launches": sum(e.count for e in kernels),
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                    for e in kernels[:top]]}


def library_call(op: Operands):
    """One PyTorch call computing the same +-1 dots (the port never calls
    it): torch._int_mm on +-1 int8 where its shape rules allow, else a
    float32 matmul of +-1 operands. Operands are prepared outside the
    timing."""
    from repro_torch.core.bitpack import unpack_bits
    xs = unpack_bits(op.a, op.k)                     # (M, K) +-1
    ws = unpack_bits(op.b, op.k)                     # (N, K) +-1
    if op.m > 16 and op.k % 8 == 0 and op.n % 8 == 0:
        xi, wi = xs.to(torch.int8), ws.to(torch.int8).t()
        return "torch._int_mm", (lambda: torch._int_mm(xi, wi))
    wt = ws.t().contiguous()
    return "torch.matmul fp32", (lambda: torch.matmul(xs, wt))


# this script's lhs labels as `tune.gemm_bound` names the lhs forms
LHS_FORM = {"float": "float32", "bf16": "bfloat16", "packed": "packed"}


def bound(kernel, lhs, m, k, n, popc_per_s):
    """Least time for the work (`tune.gemm_bound`): the larger of the bytes
    over the HBM rate and the faster of the popc and int8 tensor-core
    ways to compute the +-1 dots."""
    from repro_torch.kernels import tune
    return tune.gemm_bound(kernel, LHS_FORM[lhs], m, k, n, popc_per_s)


def bound_by(row):
    if row["bytes_ms"] >= row["ops_ms"]:
        return "bytes"
    return "popc" if row["popc_ms"] <= row["int8_tc_ms"] else "int8 TC"


def plan_text(kn, m, k, n, sms):
    """The dispatch rule's choice (`gemm_plan`), for the printed rows."""
    from repro_torch.kernels import binary_gemm as bg
    if kn == "binary_gemm_packed" and not hasattr(bg, "PLANNED"):
        return "popc tiles"        # kernel 1 of a port from before its plan
    p = bg.gemm_plan(kn, m, n, k, sms)
    kind = "TC tiles"
    if p.small_m:
        kind = "small-M b1" if kn == "binary_gemm_packed" else "small-M"
    return f"{kind} split {p.split} blocks {p.blocks}"


# the LM's popcount GEMMs (kernel, lhs, K, N, what), timed at decode and
# chunk rows apart from the kernels line: phi3-medium-14b's q, K|V and
# gate|up (packed lhs), wo and w_down (bf16 lhs); falcon-mamba-7b's
# in_proj, x_proj and out_proj (bf16 lhs)
LM_GEMMS = [("binary_gemm_packed", "packed", 5120, 5120, "phi3.q"),
            ("binary_gemm_packed", "packed", 5120, 1280, "phi3.kv"),
            ("binary_gemm_packed", "packed", 5120, 17920, "phi3.gate"),
            ("binary_gemm_packed_rhs", "bf16", 5120, 5120, "phi3.wo"),
            ("binary_gemm_packed_rhs", "bf16", 17920, 5120, "phi3.down"),
            ("binary_gemm_packed_rhs", "bf16", 4096, 16384, "mamba.in"),
            ("binary_gemm_packed_rhs", "bf16", 8192, 288, "mamba.x"),
            ("binary_gemm_packed_rhs", "bf16", 8192, 4096, "mamba.out")]
# kernels 2 and 3 at the edges of the dispatch rule (kernel, lhs, M, K, N):
# small-M rows 1..32 (kernel 3's 1..16) and tensor-core tiles from 33,
# K not a multiple of 32, KW % 4 != 0 (tiles at small M), a full 8-block
# cluster (K 8190, N 200), 256-channel tiles at an odd N
REGIME_EDGES = [(kn, lhs, m, k, n)
                for m in (1, 16, 33, 64, 100)
                for k, n in ((1000, 288), (3961, 130), (300, 77))
                for kn, lhs in (("binary_gemm_packed_rhs", "float"),
                                ("binary_gemm_packed_rhs", "bf16"),
                                ("binary_gemm_fused", "packed"),
                                ("binary_gemm_fused", "bf16"))] + [
    ("binary_gemm_packed_rhs", "bf16", m, 8190, 200) for m in (1, 4, 32)] + [
    ("binary_gemm_packed_rhs", "float", 12831, 300, 301)]
# kernel 1 at the edges of its rule (M, K, N), beside the LM rows' 4 and 32:
# the packed small-M kernel at 1 to 32 rows on phi3's q, K|V and gate|up,
# tiles from 33; K off a word with KW % 4 == 0 (1000, 3961) and KW % 4 != 0
# (300: tiles at every M)
PACKED_EDGES = [(m, 5120, n) for m in (1, 8, 9, 16, 33)
                for n in (5120, 1280, 17920)] + [
    (m, k, n) for m in (1, 9, 32) for k, n in ((1000, 33), (3961, 130),
                                               (300, 77))]


def lm_gemm_times(dev_gen, popc_per_s, sms, kernels=GEMMS, gemms=LM_GEMMS,
                  row_counts=((LM_SLOTS, "decode"), (LM_CHUNK, "chunk"))):
    """The kernels of `kernels` at the LM's shapes (`gemms`, LM_GEMMS: kernels
    1 and 2) at `row_counts` rows (decode and chunk): device, wrapper,
    plain, library and bound times (`shape_times`, `bound`), the library's
    dots held to the kernel's first."""
    rows = []
    for m, rows_of in row_counts:
        for kn, lhs, k, n, what in gemms:
            if kn not in kernels:
                continue
            op = Operands(dev_gen, m, k, n)
            lib_name, lib_fn = library_call(op)
            check_equal(f"{lib_name} vs kernel dots {what}",
                        lib_fn().to(torch.int32),
                        op.call("binary_gemm_packed", "packed"))
            rows.append({"kernel": kn, "lhs": lhs, "M": m, "K": k, "N": n,
                         "where": f"{what}.{rows_of}", "library": lib_name,
                         "plan": plan_text(kn, m, k, n, sms),
                         **shape_times(lambda: op.call(kn, lhs), kn,
                                       lambda: op.call(kn, lhs, plain=True),
                                       lib_fn),
                         **bound(kn, lhs, m, k, n, popc_per_s)})
            del op, lib_fn
    return rows


def print_gemm_rows(title, rows):
    """GEMM time rows (`lm_gemm_times`) under a title."""
    print(title)
    for r in rows:
        print(f"  {r['where']:16s} {r['kernel']:24s} {r['lhs']:6s} "
              f"M={r['M']:3d} K={r['K']:5d} N={r['N']:5d} kernel "
              f"{r['ms']:.4f} (wrapper {r['wrapper_ms']:.4f})  plain "
              f"{r['plain_ms']:.3f}  {r['library']} {r['library_ms']:.4f} "
              f"(wall {r['library_wall_ms']:.4f})  bound {r['bound_ms']:.5f} "
              f"({bound_by(r)})  {r['plan']}")


def packed_split_checks(dev_gen, sms):
    """Kernel 1's packed small-M kernel with its plan forced to each K split
    (1, 2, 4, 8 blocks of a cluster) and each width (32 to 256 channels a
    block), at phi3's K|V shape and at K 8190, N 200, at 4 and 32 rows: every
    result equals the plain version's (tolerance 0), one launch a call.
    Returns the largest error (0)."""
    from dataclasses import replace
    from unittest import mock
    from repro_torch.kernels import binary_gemm as bg
    kn, calls = "binary_gemm_packed", 0
    for m in (LM_SLOTS, LM_CHUNK):
        for k, n in ((5120, 1280), (8190, 200)):
            op = Operands(dev_gen, m, k, n)
            want = op.call(kn, "packed", plain=True)
            plan = bg.gemm_plan(kn, m, n, k, sms)
            for split in (1, 2, 4, 8):
                for block_n in (32, 64, 128, 256):
                    forced = replace(plan, split=split, block_n=block_n,
                                     blocks=-(-n // block_n) * split)
                    with mock.patch.object(bg, "gemm_plan",
                                           lambda *_, forced=forced: forced):
                        before = bg.launches[kn]
                        got = op.call(kn, "packed")
                        torch.cuda.synchronize()
                    if bg.launches[kn] - before != 1:
                        raise AssertionError(f"{kn}: not one launch")
                    d = max_abs_diff(got, want, words=False)
                    if d:
                        raise AssertionError(
                            f"{kn} ({m},{k},{n}) split {split} block_n "
                            f"{block_n} differs from its plain version by {d}")
                    calls += 1
    print(f"check {kn}: the small-M kernel at every K split (1, 2, 4, 8) and "
          f"width (32, 64, 128, 256 channels a block), {calls} forced plans at "
          f"M {LM_SLOTS} and {LM_CHUNK}, K|V (5120, 1280) and (8190, 200): "
          f"max_abs_err=0")
    return 0


def random_bn(gen, n, fan_in, spread, dev):
    """BN params and running stats in the range a trained net has: var near
    fan_in * spread (the variance of a +-1 dot), some negative gammas."""
    from repro_torch.core.shift_bn import BNParams, BNState
    var = fan_in * spread * (0.5 + torch.rand(n, generator=gen))
    return (BNParams(torch.randn(n, generator=gen).to(dev),
                     (0.1 * torch.randn(n, generator=gen)).to(dev)),
            BNState((0.2 * var.sqrt() * torch.randn(n, generator=gen)).to(dev),
                    var.to(dev), torch.zeros((), dtype=torch.int32).to(dev)))


def to_device(tree, dev):
    from repro_torch.core.packed import PackedWeight, map_tree
    return map_tree(lambda _, p: p.to(dev)
                    if isinstance(p, (torch.Tensor, PackedWeight)) else p, tree)


def check_gemm(op: Operands, kn, lhs, where, sms) -> int:
    """Kernel `kn` on `op` with a `lhs` lhs against its plain version:
    equal (tolerance 0; kernel 3's words as words), one launch. Returns
    the error (0)."""
    from repro_torch.kernels import binary_gemm as bg
    m, k, n = op.m, op.k, op.n
    before = bg.launches[kn]
    got = op.call(kn, lhs)
    torch.cuda.synchronize()
    if bg.launches[kn] - before != 1:
        raise AssertionError(f"{kn} ({m},{k},{n}): not one launch")
    want = op.call(kn, lhs, plain=True)
    torch.cuda.synchronize()
    d = max_abs_diff(got, want, words=kn == "binary_gemm_fused")
    print(f"check {kn:24s} {lhs:6s} M={m:6d} K={k:5d} N={n:5d} "
          f"{where:9s} {plan_text(kn, m, k, n, sms):28s} max_abs_err={d}")
    if d:
        raise AssertionError(f"{kn} {lhs} ({m},{k},{n}) differs from its "
                             f"plain version by {d}")
    return d


def check_equal(what, got, want):
    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"{what}: results differ")


# ---------------------------------------------------------------------------
# The LM serving path: kernels 5 (pack), 6 (decode attention), 8 (prefill
# attention) and the engine
# ---------------------------------------------------------------------------
def lm_modules():
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import pack as pk
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import selective_scan as ss
    return bg, pk, da, pa, ss


def reset_all_launches() -> None:
    for mod in lm_modules():
        mod.reset_launches()


def all_launches() -> dict:
    out = {}
    for mod in lm_modules():
        out.update(mod.launches)
    return out


def pack_check_shapes(cfg):
    """(M, K) of every sign-pack on the LM path, per layer: the normed
    residual of a decode step and of a chunk (for Q/K/V, then gate/up) and
    the new K/V rows, (rows * Hkv, hd); the (M, d_ff) lhs too."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    return [(LM_SLOTS, cfg.d_model, "decode x2"),
            (LM_SLOTS * hkv, hd, "decode kv x2"),
            (LM_CHUNK, cfg.d_model, "chunk x2"),
            (LM_CHUNK * hkv, hd, "chunk kv x2"),
            (LM_SLOTS, cfg.d_ff, "check"), (LM_CHUNK, cfg.d_ff, "check")]


def pack_checks(shapes, dev_gen, dev) -> int:
    """Kernel 5's `pack_bits_kernel` against its plain version at each
    (M, K, where), bf16 and float32, with -0.0 and NaN among the values:
    words equal bit for bit, one launch a call. Returns the largest error."""
    _, pk, _, _, _ = lm_modules()
    err = 0
    for m, k, where in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(m, k, generator=dev_gen, device=dev).to(dtype)
            x.view(-1)[::13] = -0.0
            x.view(-1)[5::17] = float("nan")
            before = pk.launches["pack_bits"]
            got = pk.pack_bits_kernel(x)
            torch.cuda.synchronize()
            if pk.launches["pack_bits"] - before != 1:
                raise AssertionError(f"pack_bits ({m},{k}): not one launch")
            d = max_abs_diff(got, pk.pack_bits_plain(x), words=True)
            err = max(err, d)
            print(f"check pack_bits {str(dtype)[6:]:8s} M={m:5d} K={k:5d} "
                  f"{where:12s} max_abs_err={d}")
            if d:
                raise AssertionError(f"pack_bits ({m},{k}) differs from its "
                                     f"plain version by {d}")
    return err


def attention_case(gen, b, s, t, hkv, g, hd, dtype, dev):
    """Integer-valued queries (rope'd popcount dots are such values), packed
    sign K/V and V scales, on the card."""
    from repro_torch.core.bitpack import pack_bits
    q = torch.randint(-6, 7, (b, s, hkv * g, hd), generator=gen,
                      device=dev).to(dtype)
    k, v = (pack_bits(torch.randn(b, t, hkv, hd, generator=gen, device=dev))
            for _ in range(2))
    vs = 0.5 + 0.5 * torch.rand(b, hkv, generator=gen, device=dev)
    return q, k, v, vs


def attention_bound(valid, s, hq, hkv, hd, elt, popc_per_s):
    """Least time of one packed-attention call (`tune.attention_bound`),
    counted from its (B, S, T) `valid` mask: the valid (query head,
    position) pairs, and the K/V rows up to each row's last valid
    position."""
    from repro_torch.kernels import tune
    b, _, t = valid.shape
    last = valid.any(dim=1).int() * torch.arange(1, t + 1, device=valid.device)
    bnd = tune.attention_bound(int(valid.sum()) * hq,
                               int(last.amax(dim=1).sum()), b, s, hq, hkv, hd,
                               elt, popc_per_s)
    return {k: bnd[k] for k in ("bytes_ms", "ops_ms", "bound_ms")}


def sdpa_call(q, k, v, vs, valid):
    """One PyTorch call computing the same function (the port never calls
    it): scaled_dot_product_attention over sign(q) and the unpacked +-1 K/V
    with the same mask, times v_scale. Operands are prepared outside the
    timing."""
    import torch.nn.functional as F
    from repro_torch.core.bitpack import unpack_bits
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qs = torch.where(q >= 0, 1.0, -1.0).to(q.dtype).transpose(1, 2)
    ks, vv = (unpack_bits(x, hd, dtype=q.dtype).transpose(1, 2)
              .repeat_interleave(g, dim=1).contiguous() for x in (k, v))
    mask = valid[:, None]
    scale = vs.repeat_interleave(g, dim=1)[:, :, None, None].to(q.dtype)

    def call():
        out = F.scaled_dot_product_attention(qs, ks, vv, attn_mask=mask,
                                             scale=1.0 / hd ** 0.5)
        return out * scale
    return lambda: call().transpose(1, 2)


def check_close(what, got, want, dtype):
    """Attention outputs: within ATTN_TOL of their type (rtol = atol), and
    the same sign everywhere (all that the next projection reads)."""
    from repro_torch.kernels import tune
    eps = tune.ATTN_TOL[dtype]
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=eps, atol=eps,
                               msg=lambda m: f"{what}: {m}")
    if not torch.equal(got >= 0, want >= 0):
        raise AssertionError(f"{what}: output signs differ")
    return err


def lm_kernel_checks(cfg, dev_gen, dev):
    """Kernels 5, 6, 8 against their plain versions on the card at the LM's
    main-path shapes and at ragged ones. Words and integer dots: tolerance
    0. Attention outputs: ATTN_TOL, signs equal."""
    _, _, da, pa, _ = lm_modules()
    err = {"pack_bits": pack_checks(pack_check_shapes(cfg) + [
               (3, 31, "ragged"), (5, 33, "ragged"), (7, 1000, "ragged")],
               dev_gen, dev),
           "decode_attention_packed": 0.0, "prefill_attention_packed": 0.0}
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    decode_cases = [(LM_SLOTS, LM_MAX_LEN, hkv, g, hd, 0, "main"),
                    (3, 37, 2, 1, 33, 0, "ragged"), (2, 70, 1, 8, 64, 9, "ragged"),
                    (5, 33, 3, 2, 128, 0, "ragged")]
    for b, t, nkv, gg, d_h, window, where in decode_cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, vs = attention_case(dev_gen, b, 1, t, nkv, gg, d_h,
                                         dtype, dev)
            lens = torch.randint(1, t + 1, (b,), generator=dev_gen, device=dev,
                                 dtype=torch.int32)
            lens[0] = 1
            got, dots = da.decode_attention_packed(q, k, v, vs, lens,
                                                   window=window,
                                                   return_dots=True)
            torch.cuda.synchronize()
            want, wdots = da.decode_attention_packed_plain(
                q, k, v, vs, lens, window=window, return_dots=True)
            if not torch.equal(dots, wdots):
                raise AssertionError(f"decode dots ({b},{t},{nkv},{gg},{d_h})")
            e = check_close(f"decode ({b},{t},{nkv},{gg},{d_h},{window})",
                            got, want, dtype)
            err["decode_attention_packed"] = max(err["decode_attention_packed"], e)
            print(f"check decode_attention_packed {str(dtype)[6:]:8s} B={b} "
                  f"T={t} Hkv={nkv} G={gg} hd={d_h} window={window} {where} "
                  f"dots equal, max_abs_err={e:.3g}")
    prefill_cases = [(1, LM_CHUNK, LM_MAX_LEN, hkv, g, hd, 96, 0, True, "main"),
                     (1, LM_CHUNK, LM_MAX_LEN, hkv, g, hd, 0, 0, True, "main"),
                     (2, 7, 45, 2, 1, 33, 11, 5, True, "ragged"),
                     (1, 16, 70, 1, 8, 64, 40, 0, False, "ragged"),
                     (3, 5, 40, 2, 2, 16, 0, 0, True, "ragged")]
    for b, s, t, nkv, gg, d_h, qp, window, causal, where in prefill_cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, vs = attention_case(dev_gen, b, s, t, nkv, gg, d_h,
                                         dtype, dev)
            got, dots = pa.prefill_attention_packed(
                q, k, v, vs, qp + s, qp, window=window, causal=causal,
                return_dots=True)
            torch.cuda.synchronize()
            want, wdots = pa.prefill_attention_packed_plain(
                q, k, v, vs, qp + s, qp, window=window, causal=causal,
                return_dots=True)
            if not torch.equal(dots, wdots):
                raise AssertionError(f"prefill dots ({b},{s},{t})")
            e = check_close(f"prefill ({b},{s},{t},{nkv},{gg},{d_h})", got,
                            want, dtype)
            err["prefill_attention_packed"] = max(
                err["prefill_attention_packed"], e)
            print(f"check prefill_attention_packed {str(dtype)[6:]:8s} B={b} "
                  f"S={s} T={t} Hkv={nkv} G={gg} hd={d_h} q_pos={qp} "
                  f"window={window} causal={causal} {where} dots equal, "
                  f"max_abs_err={e:.3g}")
    # a one-row chunk at q_pos = kv_len - 1 is a decode step
    q, k, v, vs = attention_case(dev_gen, LM_SLOTS, 1, LM_MAX_LEN, hkv, g, hd,
                                 torch.bfloat16, dev)
    lens = torch.tensor([1, 100, 333, 512], dtype=torch.int32, device=dev)
    check_equal("prefill S=1 vs decode",
                pa.prefill_attention_packed(q, k, v, vs, lens, lens - 1),
                da.decode_attention_packed(q, k, v, vs, lens))
    flat = da.decode_attention_packed(q, k, v, vs, 0)
    plain = da.decode_attention_packed_plain(q, k, v, vs, 0)
    if not torch.equal(flat, plain) or not (flat != 0).any():
        raise AssertionError("cache_len 0 must weigh the whole row alike, "
                             "as the plain version")
    print("check prefill S=1 equals decode; cache_len 0 weighs every "
          "position alike, equal to the plain version bit for bit")
    return err


def pack_rows_cases(cfg):
    """(where, n source rows, sub-rows per row, K, pool, destination rows)
    of kernel 5's `pack_rows_into` on the LM's path (K and V rows of a
    decode step, a 32-row chunk with n_valid < 32, a whole 200-token prompt,
    paged rows with sentinel and sink writes) and at ragged K (off a word;
    K % 8 != 0: the ballot body). `pool` is ("contiguous", B, T) or
    ("paged", pages, page size); rows index the pool seen as (rows, per,
    ceil(K/32)), paged with its sink page."""
    hkv, hd, t, ps = cfg.n_kv_heads, cfg.head_dim, LM_MAX_LEN, LM_PAGE
    sink = LM_POOL * ps
    cases = [
        ("decode, rows 1 and 3 inactive", LM_SLOTS, hkv, hd,
         ("contiguous", LM_SLOTS, t), [0 * t + 511, -1, 2 * t + 17, -1]),
        ("chunk of 32, n_valid 20", LM_CHUNK, hkv, hd, ("contiguous", 1, t),
         [96 + i if i < 20 else -1 for i in range(LM_CHUNK)]),
        ("whole prompt of 200 into slot 2", 200, hkv, hd,
         ("contiguous", LM_SLOTS, t), [2 * t + i for i in range(200)]),
        ("paged decode: sentinel, sink", LM_SLOTS, hkv, hd,
         ("paged", LM_POOL, ps), [7 * ps + 3, sink + 3, sink, 40 * ps]),
        ("paged chunk: sentinel tail, pads", LM_CHUNK, hkv, hd,
         ("paged", LM_POOL, ps),
         [(5 * ps + 16 + i) if i < 16 else (sink + i - 16) if i < 24 else -1
          for i in range(LM_CHUNK)]),
        ("K 37 (ballot body)", 5, 3, 37, ("contiguous", 2, 9),
         [0, 17, -1, 8, 3]),
        ("K 72 (off a word)", 6, 2, 72, ("contiguous", 1, 8),
         [7, 0, 5, 1, -1, 2]),
    ]
    return cases


def pack_rows_checks(cases, dev_gen, dev):
    """Kernel 5's `pack_rows_into` against its plain version on the card at
    `cases` (as `pack_rows_cases` gives them), float32 and bf16 sources with
    -0.0 and NaN: both
    whole cache tensors (the pools without their sink page, which several
    rows may write) equal bit for bit, one launch per call. Returns the
    max error (0)."""
    from repro_torch.models import transformer as T
    _, pk, _, _, _ = lm_modules()

    def fresh(pool, per, kw):
        if pool[0] == "paged":                   # the pool has a sink page
            return T.new_pool(1, pool[1], pool[2], per, kw, device=dev)[0]
        return torch.zeros((pool[1], pool[2], per, kw), dtype=torch.int32,
                           device=dev)

    err = 0
    for where, n, per, k, pool, rows in cases:
        kw = (k + 31) // 32
        dst = torch.tensor(rows, dtype=torch.int64, device=dev)

        def view(ps):
            return [T._with_sink(p) for p in ps] if pool[0] == "paged" \
                else ps
        for dtype in (torch.bfloat16, torch.float32):
            srcs = []
            for _ in range(2):
                x = torch.randn(n, per, k, generator=dev_gen, device=dev)
                x.view(-1)[::13] = -0.0
                x.view(-1)[5::17] = float("nan")
                srcs.append(x.to(dtype))
            pools = [fresh(pool, per, kw) for _ in range(2)]
            for p in pools:
                p.random_(-2**31, 2**31 - 1, generator=dev_gen)
            want = [fresh(pool, per, kw).copy_(p) for p in pools]
            pk.pack_rows_into_plain(srcs, view(want), dst)
            before = pk.launches["pack_bits"]
            pk.pack_rows_into(srcs, view(pools), dst)
            torch.cuda.synchronize()
            if pk.launches["pack_bits"] - before != 1:
                raise AssertionError(f"pack_rows_into {where}: not one launch")
            d = max(max_abs_diff(g, w, words=True)
                    for g, w in zip(pools, want))
            if d or not all(torch.equal(g, w) for g, w in zip(pools, want)):
                raise AssertionError(f"pack_rows_into {where} {dtype}: the "
                                     f"cache differs from the plain version's")
            err = max(err, d)
            print(f"check pack_rows_into {str(dtype)[6:]:8s} n={n:4d} "
                  f"per={per:3d} K={k:4d} {where}: both caches equal, "
                  f"one launch, max_abs_err={d}")
    return err


def paged_case(gen, rng, b, s, ps, n_pages, pool, hkv, g, hd, lens, dtype,
               dev):
    """Integer-valued queries, packed sign K/V pools of `pool` pages and V
    scales on the card, and a page table giving row i ceil(lens[i] / ps)
    pages of the pool in shuffled order, the sentinel `pool` in its
    unallocated tail."""
    from repro_torch.core.bitpack import pack_bits
    q = torch.randint(-6, 7, (b, s, hkv * g, hd), generator=gen,
                      device=dev).to(dtype)
    k, v = (pack_bits(torch.randn(pool, ps, hkv, hd, generator=gen,
                                  device=dev)) for _ in range(2))
    vs = 0.5 + 0.5 * torch.rand(b, hkv, generator=gen, device=dev)
    free = list(rng.permutation(pool))
    table = np.full((b, n_pages), pool, np.int32)
    for i, n in enumerate(lens):
        for j in range(-(-int(n) // ps)):
            table[i, j] = free.pop()
    return q, k, v, vs, torch.from_numpy(table).to(dev)


def lm_paged_kernel_checks(cfg, dev_gen, seed, dev):
    """Kernels 7 and 9 on the card at the paged path's shapes (B 4, page 32,
    16 pages per row, a 64-page pool in shuffled order, lengths
    512/300/100/17; chunks of 32 at q_pos 0 and 96 against one row) and a
    ragged one (page 16, hd 33, a row of length 0): outputs and dots at
    every position equal, bit for bit, the plain version's (gather + the
    contiguous plain version) and the contiguous kernel's on the gathered
    panel."""
    from repro_torch.kernels import ref
    _, _, da, pa, _ = lm_modules()
    rng = np.random.default_rng(seed)
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    n_pages = LM_MAX_LEN // LM_PAGE
    cases = [(LM_SLOTS, LM_PAGE, n_pages, LM_POOL, hkv, g, hd,
              (LM_MAX_LEN, 300, 100, 17), 0, "main"),
             (3, 16, 5, 12, 2, 2, 33, (0, 37, 80), 9, "ragged")]

    def same(what, got, plain, contig):
        for name, other in (("plain version", plain),
                            ("contiguous kernel", contig)):
            if not torch.equal(got, other):
                d = float((got.float() - other.float()).abs().max())
                raise AssertionError(f"{what}: differs from the {name} "
                                     f"(max abs {d})")

    for b, ps, npg, pool, nkv, gg, d_h, lens, window, where in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, vs, pt = paged_case(dev_gen, rng, b, 1, ps, npg, pool,
                                         nkv, gg, d_h, lens, dtype, dev)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
            got, dots = da.decode_attention_packed_paged(
                q, k, v, vs, pt, lens_t, window=window, return_dots=True)
            torch.cuda.synchronize()
            plain = da.decode_attention_packed_paged_plain(
                q, k, v, vs, pt, lens_t, window=window, return_dots=True)
            contig = da.decode_attention_packed(q, kg, vg, vs, lens_t,
                                                window=window,
                                                return_dots=True)
            what = f"paged decode ({b},{ps},{npg},{pool},{nkv},{gg},{d_h})"
            same(what + " dots", dots, plain[1], contig[1])
            same(what, got, plain[0], contig[0])
            print(f"check decode_attention_packed_paged {str(dtype)[6:]:8s} "
                  f"B={b} ps={ps} NP={npg} pool={pool} Hkv={nkv} G={gg} "
                  f"hd={d_h} lens={list(lens)} window={window} {where}: "
                  f"outputs and dots equal the plain version's and the "
                  f"contiguous kernel's on the gathered panel")
            s = LM_CHUNK if where == "main" else 5
            q, k, v, vs, pt = paged_case(dev_gen, rng, b, s, ps, npg, pool,
                                         nkv, gg, d_h, lens, dtype, dev)
            calls = [(q[1:2], vs[1:2], pt[1:2], qp, qp + s)
                     for qp in (0, 96)] if where == "main" else []
            qpos = torch.tensor([max(n - s, 0) for n in lens],
                                dtype=torch.int32, device=dev)
            calls.append((q, vs, pt, qpos, qpos + s))
            for qq, vv, tt, qp, kv in calls:
                got, dots = pa.prefill_attention_packed_paged(
                    qq, k, v, vv, tt, kv, qp, window=window, return_dots=True)
                torch.cuda.synchronize()
                plain = pa.prefill_attention_packed_paged_plain(
                    qq, k, v, vv, tt, kv, qp, window=window, return_dots=True)
                contig = pa.prefill_attention_packed(
                    qq, ref.gather_pages(k, tt), ref.gather_pages(v, tt), vv,
                    kv, qp, window=window, return_dots=True)
                shown = qp if isinstance(qp, int) else qp.tolist()
                what = f"paged prefill ({qq.shape[0]},{s},{ps},{npg},{d_h}) " \
                       f"q_pos {shown}"
                same(what + " dots", dots, plain[1], contig[1])
                same(what, got, plain[0], contig[0])
                print(f"check prefill_attention_packed_paged "
                      f"{str(dtype)[6:]:8s} B={qq.shape[0]} S={s} ps={ps} "
                      f"NP={npg} pool={pool} q_pos={shown} window={window} "
                      f"{where}: outputs and dots equal the plain version's "
                      f"and the contiguous kernel's on the gathered panel")
    # every output was held equal to its plain version's
    return {kn: 0.0 for kn in PAGED_KERNELS}


# prefill past T ~1,770, where a (32, T) score panel no longer fits shared
# memory (B, S, T, Hkv, kv_lens, q_pos, window): 32-row chunks at the end
# of 2,048- and 4,096-position contexts, a window shorter than the chunk,
# kv_len 0 rows; on the H100 their grids take T splits of 8, 4, 2 and 1
# (`attention_plan`)
LONG_PAGE = 64
LONG_PREFILL = [(1, 32, 2048, 2, (2048,), (2016,), 0),
                (1, 32, 4096, 10, (4096,), (4064,), 0),
                (2, 32, 4096, 10, (0, 4000), (0, 3968), 8),
                (4, 64, 2048, 10, (2048, 0, 700, 64), (1984, 0, 636, 0), 0)]


def lm_long_prefill_checks(cfg, dev_gen, seed, dev, sms):
    """Kernels 8 and 9 at T 2,048 and 4,096 (LONG_PREFILL; G and hd of the
    LM; a pool of 64-position pages in shuffled order, the sentinel in each
    row's unallocated tail): the contiguous kernel on the gathered panel
    against its plain version (dots at every position equal, outputs within
    ATTN_TOL with equal signs, kv_len 0 rows exactly 0) and the paged
    kernel against the contiguous one (outputs and dots bit for bit); then
    a one-row chunk at q_pos = kv_len - 1 against decode at the LM's decode
    shape, paged and contiguous, bit for bit. Every T split of 1, 2, 4 and
    8 is taken at least once."""
    from repro_torch.kernels import ref
    _, _, da, pa, _ = lm_modules()
    rng = np.random.default_rng(seed + 1)
    g, hd = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    err = {kn: 0.0 for kn in ("prefill_attention_packed",
                              "prefill_attention_packed_paged")}
    splits = set()
    for b, s, t, hkv, lens, qpos, window in LONG_PREFILL:
        plan = pa.attention_plan(b, s, t, hkv, g, hd, sms)
        splits.add(plan.split)
        pool = b * t // LONG_PAGE + 3
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, vs, pt = paged_case(dev_gen, rng, b, s, LONG_PAGE,
                                         t // LONG_PAGE, pool, hkv, g, hd,
                                         lens, dtype, dev)
            kv = torch.tensor(lens, dtype=torch.int32, device=dev)
            qp = torch.tensor(qpos, dtype=torch.int32, device=dev)
            kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
            got, dots = pa.prefill_attention_packed(
                q, kg, vg, vs, kv, qp, window=window, return_dots=True)
            paged, pdots = pa.prefill_attention_packed_paged(
                q, k, v, vs, pt, kv, qp, window=window, return_dots=True)
            torch.cuda.synchronize()
            want, wdots = pa.prefill_attention_packed_plain(
                q, kg, vg, vs, kv, qp, window=window, return_dots=True)
            what = f"long prefill ({b},{s},{t},{hkv}) lens {list(lens)}"
            if not (torch.equal(dots, wdots) and torch.equal(pdots, dots)):
                raise AssertionError(f"{what}: dots differ")
            if not torch.equal(paged, got):
                raise AssertionError(f"{what}: paged differs from contiguous")
            if not (got[kv == 0] == 0).all():
                raise AssertionError(f"{what}: a kv_len 0 row is not 0")
            e = check_close(what, got, want, dtype)
            for kn in err:
                err[kn] = max(err[kn], e)
            print(f"check prefill_attention_packed[_paged] {str(dtype)[6:]:8s} "
                  f"B={b} S={s} T={t} Hkv={hkv} lens={list(lens)} q_pos="
                  f"{list(qpos)} window={window} split {plan.split}: dots "
                  f"equal, max_abs_err={e:.3g}, paged equals contiguous bit "
                  f"for bit (ps {LONG_PAGE}, pool {pool} shuffled, sentinel "
                  f"tails)")
    if splits != {1, 2, 4, 8}:
        raise AssertionError(f"long prefill checks took splits {splits}")
    lens = (1, 100, 333, LM_MAX_LEN)
    q, k, v, vs, pt = paged_case(dev_gen, rng, LM_SLOTS, 1, LM_PAGE,
                                 LM_MAX_LEN // LM_PAGE, LM_POOL,
                                 cfg.n_kv_heads, g, hd, lens, torch.bfloat16,
                                 dev)
    kv = torch.tensor(lens, dtype=torch.int32, device=dev)
    kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
    check_equal("paged prefill S=1 vs paged decode",
                pa.prefill_attention_packed_paged(q, k, v, vs, pt, kv, kv - 1),
                da.decode_attention_packed_paged(q, k, v, vs, pt, kv))
    check_equal("prefill S=1 vs decode (gathered)",
                pa.prefill_attention_packed(q, kg, vg, vs, kv, kv - 1),
                da.decode_attention_packed(q, kg, vg, vs, kv))
    split = pa.attention_plan(LM_SLOTS, 1, LM_MAX_LEN, cfg.n_kv_heads, g, hd,
                              sms).split
    print(f"check prefill S=1 equals decode bit for bit, paged and contiguous "
          f"(lens {list(lens)}, split {split})")
    return err


def lm_long_prefill_times(cfg, dev_gen, dev, popc_per_s):
    """A 32-row chunk at the end of a 4,096-position context (q_pos 4064,
    one row, the LM's heads, bf16): kernel 8 on the contiguous cache and
    kernel 9 on a shuffled pool of 32-position pages, as `shape_times`,
    beside SDPA (paged: on the gathered pages, the gather's time printed
    beside it) and the bound. Not in the kernels line (no main-path call
    reaches this context)."""
    from repro_torch.kernels import ref
    _, _, _, pa, _ = lm_modules()
    rng = np.random.default_rng(4096)
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    t, qp = 4096, 4096 - LM_CHUNK
    q, k, v, vs, pt = paged_case(dev_gen, rng, 1, LM_CHUNK, LM_PAGE,
                                 t // LM_PAGE, t // LM_PAGE + 8, hkv, g, hd,
                                 (t,), torch.bfloat16, dev)
    kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
    valid = ref.chunk_valid_mask(1, LM_CHUNK, t, t, qp, 0, True, device=dev)
    lib = sdpa_call(q, kg, vg, vs, valid)
    bnd = attention_bound(valid, LM_CHUNK, cfg.n_heads, hkv, hd, 2, popc_per_s)
    rows = []
    for kn, call, plain in (
            ("prefill_attention_packed",
             lambda: pa.prefill_attention_packed(q, kg, vg, vs, t, qp),
             lambda: pa.prefill_attention_packed_plain(q, kg, vg, vs, t, qp)),
            ("prefill_attention_packed_paged",
             lambda: pa.prefill_attention_packed_paged(q, k, v, vs, pt, t, qp),
             lambda: pa.prefill_attention_packed_paged_plain(
                 q, k, v, vs, pt, t, qp))):
        check_close_loose(f"SDPA vs {kn} at T {t}", lib(), call())
        row = {"kernel": kn, "where": f"chunk S={LM_CHUNK} q_pos={qp} T={t}",
               "library": "F.scaled_dot_product_attention",
               **shape_times(call, kn, plain, lib),
               **(paged_bound(bnd, pt) if kn.endswith("paged") else bnd)}
        if kn.endswith("paged"):
            row["gather_ms"] = device_ms(lambda: (ref.gather_pages(k, pt),
                                                  ref.gather_pages(v, pt)))
        rows.append(row)
    return rows


def prefill_split_sweep(cfg, dev_gen, dev, sms):
    """Kernel 8's device time at each T split (1, 2, 4, 8) on one slot's
    32-row chunk at q_pos 0 and 96 of a 512-position table and at the end
    of a 4,096-position one, beside the split `attention_plan` picks: the
    measurement its rule rests on. Outputs are held equal across splits
    within ATTN_TOL (the sums' order changes with the split)."""
    _, _, _, pa, _ = lm_modules()
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    rows = []
    for t, qp in ((LM_MAX_LEN, 0), (LM_MAX_LEN, 96), (4096, 4096 - LM_CHUNK)):
        q, k, v, vs = attention_case(dev_gen, 1, LM_CHUNK, t, hkv, g, hd,
                                     torch.bfloat16, dev)
        plan = pa.attention_plan(1, LM_CHUNK, t, hkv, g, hd, sms)
        want = pa.prefill_attention_packed(q, k, v, vs, qp + LM_CHUNK, qp,
                                           route="cuda")
        ms = {}
        for split in (1, 2, 4, 8):
            def call(split=split):
                return pa.prefill_attention_packed(
                    q, k, v, vs, qp + LM_CHUNK, qp, route="cuda", split=split,
                    block_rows=plan.bq)
            check_close(f"split {split}", call(), want, torch.bfloat16)
            ms[split] = device_ms(call, wrapper="prefill_attention_packed")
        rows.append({"T": t, "q_pos": qp, "plan_split": plan.split, "ms": ms})
    return rows


# decode past the old panel body's cap of ~14,500 positions at G 4
# (B, T, Hkv, lengths, window), the LM's G and hd: the table's 4-slot
# step at T 4,096, two slots at 16,384 (a cache_len 0 row), three with a
# window, and grids of 80, 160 and 320 blocks at T 2,048 (lengths from the
# seed, a full and an empty row each), so the decode rule
# (`attention_plan` at S = 1) takes each split of 8, 4, 2 and 1
LONG_DECODE = [(4, 4096, 10, (4096, 3000, 1000, 17), 0),
               (2, 16384, 1, (16384, 0), 0),
               (3, 16384, 2, (16384, 9001, 12000), 700),
               (8, 2048, 10, None, 0), (16, 2048, 10, None, 0),
               (32, 2048, 10, None, 0)]


def lm_long_decode_checks(cfg, dev_gen, seed, dev, sms):
    """Kernels 6 and 7 at T 2,048, 4,096 and 16,384 (LONG_DECODE; G and hd
    of the LM; a pool of 64-position pages in shuffled order, the sentinel
    in each row's unallocated tail): the contiguous kernel on the gathered
    pages against its plain version (dots at every position equal, outputs
    within ATTN_TOL with equal signs, cache_len 0 rows exactly 0) and the
    paged kernel against the contiguous one, with dots (every table
    position streamed) and without (as served: shares held whole where
    they fit), bit for bit. Every T split of 1, 2, 4 and 8 is taken."""
    from repro_torch.kernels import ref
    _, _, da, pa, _ = lm_modules()
    rng = np.random.default_rng(seed + 2)
    g, hd = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    err = {kn: 0.0 for kn in ("decode_attention_packed",
                              "decode_attention_packed_paged")}
    splits = set()
    for b, t, hkv, lens, window in LONG_DECODE:
        if lens is None:
            lens = (t, 0, *rng.integers(1, t + 1, b - 2).tolist())
        plan = pa.attention_plan(b, 1, t, hkv, g, hd, sms)
        splits.add(plan.split)
        pool = b * t // LONG_PAGE + 3
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, vs, pt = paged_case(dev_gen, rng, b, 1, LONG_PAGE,
                                         t // LONG_PAGE, pool, hkv, g, hd,
                                         lens, dtype, dev)
            kv = torch.tensor(lens, dtype=torch.int32, device=dev)
            kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
            got, dots = da.decode_attention_packed(
                q, kg, vg, vs, kv, window=window, return_dots=True)
            paged, pdots = da.decode_attention_packed_paged(
                q, k, v, vs, pt, kv, window=window, return_dots=True)
            served = (da.decode_attention_packed(q, kg, vg, vs, kv,
                                                 window=window),
                      da.decode_attention_packed_paged(q, k, v, vs, pt, kv,
                                                       window=window))
            torch.cuda.synchronize()
            want, wdots = da.decode_attention_packed_plain(
                q, kg, vg, vs, kv, window=window, return_dots=True)
            what = f"long decode ({b},{t},{hkv}) window {window}"
            if not (torch.equal(dots, wdots) and torch.equal(pdots, dots)):
                raise AssertionError(f"{what}: dots differ")
            for name, other in (("paged", paged), ("contiguous, served",
                                                   served[0]),
                                ("paged, served", served[1])):
                if not torch.equal(other, got):
                    raise AssertionError(f"{what}: {name} differs from "
                                         "contiguous with dots")
            flat = kv == 0
            if not (torch.equal(got[flat], want[flat])
                    and (got[flat] != 0).any() | ~flat.any()):
                raise AssertionError(f"{what}: a cache_len 0 row differs from "
                                     "the plain version's whole-row mean")
            e = check_close(what, got, want, dtype)
            for kn in err:
                err[kn] = max(err[kn], e)
            shown = list(lens) if b <= 4 else f"{b} rows from the seed"
            print(f"check decode_attention_packed[_paged] {str(dtype)[6:]:8s} "
                  f"B={b} T={t} Hkv={hkv} lens={shown} window={window} split "
                  f"{plan.split}: dots equal, max_abs_err={e:.3g}, paged "
                  f"equals contiguous bit for bit, with dots and as served "
                  f"(ps {LONG_PAGE}, pool {pool} shuffled, sentinel tails)")
    if splits != {1, 2, 4, 8}:
        raise AssertionError(f"long decode checks took splits {splits}")
    return err


def decode_case(dev_gen, dev, t, lens, ps, hkv, g, hd):
    """The decode step of LM_SLOTS slots at `lens` against a T-position
    table, bf16: q, a shuffled pool of `ps`-position pages (sentinel tails),
    its table, the gathered pages and the V scales."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(t)
    q, k, v, vs, pt = paged_case(dev_gen, rng, LM_SLOTS, 1, ps, t // ps,
                                 LM_SLOTS * t // ps + 8, hkv, g, hd, lens,
                                 torch.bfloat16, dev)
    return q, k, v, vs, pt, ref.gather_pages(k, pt), ref.gather_pages(v, pt)


def lm_long_decode_times(cfg, dev_gen, dev, popc_per_s):
    """The decode step of 4 slots at lengths 4096/3000/1000/17 against a
    4,096-position table (the LM's heads, bf16): kernel 6 on the contiguous
    cache and kernel 7 on a shuffled pool of 32-position pages, as
    `shape_times`, beside SDPA (paged: on the gathered pages, the gather's
    time printed beside it) and the bound. Not in the kernels line (no
    main-path call reaches this context)."""
    from repro_torch.kernels import ref
    _, _, da, _, _ = lm_modules()
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    t, lens = 4096, (4096, 3000, 1000, 17)
    q, k, v, vs, pt, kg, vg = decode_case(dev_gen, dev, t, lens, LM_PAGE,
                                          hkv, g, hd)
    kv = torch.tensor(lens, dtype=torch.int32, device=dev)
    valid = ref.chunk_valid_mask(LM_SLOTS, 1, t, kv, kv - 1, 0, True,
                                 device=dev)
    lib = sdpa_call(q, kg, vg, vs, valid)
    bnd = attention_bound(valid, 1, cfg.n_heads, hkv, hd, 2, popc_per_s)
    rows = []
    for kn, call, plain in (
            ("decode_attention_packed",
             lambda: da.decode_attention_packed(q, kg, vg, vs, kv),
             lambda: da.decode_attention_packed_plain(q, kg, vg, vs, kv)),
            ("decode_attention_packed_paged",
             lambda: da.decode_attention_packed_paged(q, k, v, vs, pt, kv),
             lambda: da.decode_attention_packed_paged_plain(
                 q, k, v, vs, pt, kv))):
        check_close_loose(f"SDPA vs {kn} at T {t}", lib(), call())
        row = {"kernel": kn, "where": f"decode B={LM_SLOTS} T={t} lens "
                                      f"{list(lens)}",
               "library": "F.scaled_dot_product_attention",
               **shape_times(call, kn, plain, lib),
               **(paged_bound(bnd, pt) if kn.endswith("paged") else bnd)}
        if kn.endswith("paged"):
            row["gather_ms"] = device_ms(lambda: (ref.gather_pages(k, pt),
                                                  ref.gather_pages(v, pt)))
        rows.append(row)
    return rows


def decode_split_sweep(cfg, dev_gen, dev, sms):
    """Kernels 6 and 7's device time at each T split (1, 2, 4, 8) on the
    decode step of 4 slots at the table's lengths (512/300/100/17 against
    512 positions) and at 4096/3000/1000/17 against 4,096 (paged: shuffled
    32-position pages), beside the split `attention_plan` picks: the
    measurement the decode rule rests on. Outputs are held equal across
    splits within ATTN_TOL (the sums' order changes with the split)."""
    _, _, da, pa, _ = lm_modules()
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    rows = []
    for t, lens in ((LM_MAX_LEN, (LM_MAX_LEN, 300, 100, 17)),
                    (4096, (4096, 3000, 1000, 17))):
        q, k, v, vs, pt, kg, vg = decode_case(dev_gen, dev, t, lens, LM_PAGE,
                                              hkv, g, hd)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        plan = pa.attention_plan(LM_SLOTS, 1, t, hkv, g, hd, sms)
        for kn, call in (
                ("decode_attention_packed",
                 lambda **r: da.decode_attention_packed(q, kg, vg, vs, kv,
                                                        route="cuda", **r)),
                ("decode_attention_packed_paged",
                 lambda **r: da.decode_attention_packed_paged(
                     q, k, v, vs, pt, kv, route="cuda", **r))):
            want = call()
            ms = {}
            for split in (1, 2, 4, 8):
                check_close(f"{kn} split {split}", call(split=split), want,
                            torch.bfloat16)
                ms[split] = device_ms(lambda: call(split=split), wrapper=kn)
            rows.append({"kernel": kn, "T": t, "lens": list(lens),
                         "plan_split": plan.split, "ms": ms})
    return rows


def print_attention_rows(title, rows, width=30):
    """Attention time rows (`shape_times` plus bound) under a title."""
    print(title)
    for r in rows:
        lib = "—" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} (wall {r['library_wall_ms']:.4f})"
        if "gather_ms" in r:
            lib += f" + gather {r['gather_ms']:.4f}"
        print(f"  {r['kernel']:30s} {r['where']:{width}s} kernel "
              f"{r['ms']:.4f} (wrapper {r['wrapper_ms']:.4f})  plain "
              f"{r['plain_ms']:.3f}  library {lib}  bound "
              f"{r['bound_ms']:.5f} "
              f"({'bytes' if r['bytes_ms'] >= r['ops_ms'] else 'ops'})")


def lm_traffic(seed, vocab):
    """LM_REQUESTS prompts with lengths drawn from the seed in LM_PROMPT."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def lm_engine(cfg, params, **kw):
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(cfg, params, kv_bits=1, prefill_chunk=LM_CHUNK,
                         slots=LM_SLOTS, max_len=LM_MAX_LEN, **kw)


def first_sign_difference(cfg, frozen, prompt, tokens, dev):
    """Replay one request alone through the kernels and the plain versions
    (its chunks, then decode steps fed the kernel path's tokens) and return
    the first (step, layer, position, KV head, bit) whose cache sign bit
    differs, or None."""
    from repro_torch.models import transformer as T
    caches = {p: T.init_cache(cfg, 1, LM_MAX_LEN, device=dev)
              for p in ("auto", "ref")}

    def diff(step):
        for name in ("k", "v"):
            x = caches["auto"][name] ^ caches["ref"][name]
            if x.any():
                layer, _, pos, head, word = (int(i) for i in x.nonzero()[0])
                w = int(x[layer, 0, pos, head, word]) & 0xFFFFFFFF
                bit = 32 * word + (w & -w).bit_length() - 1
                return (step, layer, f"{name} position {pos}", head, bit)
        return None

    for lo in range(0, len(prompt), LM_CHUNK):
        nv = min(LM_CHUNK, len(prompt) - lo)
        ch = torch.zeros((1, LM_CHUNK), dtype=torch.int64, device=dev)
        ch[0, :nv] = torch.from_numpy(prompt[lo:lo + nv].astype(np.int64))
        for path in caches:
            T.transformer_prefill_chunk(frozen, cfg, ch, caches[path], 0, lo,
                                        nv, path=path)
        found = diff(f"chunk at {lo}")
        if found:
            return found
    for i, tok in enumerate(tokens[:-1]):
        token = torch.tensor([int(tok)], device=dev)
        pos = torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev)
        for path in caches:
            T.transformer_decode(frozen, cfg, token, caches[path], pos,
                                 path=path)
        found = diff(f"decode step {i + 1}")
        if found:
            return found
    return None


def lm_engine_check(base_cfg, seed, dev, frozen=None, what="lm engine check"):
    """Full width, depth LM_CHECK_DEPTH (or, given a frozen tree `frozen` to
    serve instead of one drawn from the seed, base_cfg's depth): the
    engine's greedy tokens through the kernels equal its tokens through the
    plain versions, on the card. Returns the launch counts of the kernel
    run (the main path), the prompt chunks, the requests and the tokens."""
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request
    depth = LM_CHECK_DEPTH if frozen is None else base_cfg.n_layers
    cfg = base_cfg.scaled(n_layers=depth, kv_bits=1)
    if frozen is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        masters = get_model(cfg).init(gen, device=dev)
        eng = lm_engine(cfg, masters, freeze=True, seed=seed)
        frozen = eng.params
        del masters
        torch.cuda.empty_cache()
    else:
        eng = lm_engine(cfg, frozen, seed=seed)
    plain = lm_engine(cfg, frozen, kernel_path="ref", seed=seed)
    prompts = lm_traffic(seed, cfg.vocab)
    alone = eng.generate([Request(prompts[5], max_new_tokens=LM_NEW)])[0]
    eos = int(alone[7])          # request 5 stops at its own 8th token
    reqs = [Request(p, max_new_tokens=LM_NEW, eos_id=eos if i == 5 else None)
            for i, p in enumerate(prompts)]
    sched = eng.scheduler()
    steps0 = sched.stats["decode_steps"]
    reset_all_launches()
    got = eng.generate(reqs)
    torch.cuda.synchronize()
    launches = all_launches()
    steps = sched.stats["decode_steps"] - steps0
    want = plain.generate(reqs)
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if not np.array_equal(a, b):
            where = first_sign_difference(cfg, frozen, prompts[i], a, dev)
            raise AssertionError(
                f"LM request {i}: kernel tokens {a.tolist()} != plain "
                f"{b.tolist()}; first differing sign bit (step, layer, "
                f"position, head, bit): {where}")
    if got[5][-1] != eos or len(got[5]) > 8:
        raise AssertionError(f"request 5 did not stop at eos {eos}: {got[5]}")
    if any(len(t) != LM_NEW for i, t in enumerate(got) if i != 5):
        raise AssertionError("a request did not get its budget")
    n_chunks = sum(-(-len(p) // LM_CHUNK) for p in prompts)
    if launches["prefill_attention_packed"] != n_chunks * depth:
        raise AssertionError(f"prefill launches {launches} != "
                             f"{n_chunks} chunks x {depth} layers")
    # kernel 5 per layer and forward call: the two shared packs of the
    # normed residual and one launch packing the K and V rows into the cache
    if launches["pack_bits"] != 3 * depth * (n_chunks + steps):
        raise AssertionError(f"pack_bits launches {launches['pack_bits']} != "
                             f"3 x {depth} layers x ({n_chunks} "
                             f"chunks + {steps} decode steps)")
    for kn in ("pack_bits", "decode_attention_packed", "binary_gemm_packed",
               "binary_gemm_packed_rhs"):
        if not launches[kn]:
            raise AssertionError(f"the LM path launched no {kn}")
    if launches["binary_gemm_fused"]:
        raise AssertionError("the LM path has no fused-epilogue GEMM")
    print(f"{what}: {LM_ARCH} full width, depth {depth} "
          f"(cut from {base_cfg.n_layers}), {LM_REQUESTS} requests, prompts "
          f"{sorted(len(p) for p in prompts)}, {LM_NEW} new tokens, request 5 "
          f"stops at eos {eos} after {len(got[5])}: tokens equal the plain "
          f"path's; pack_bits 3 x {depth} layers x ({n_chunks} "
          f"chunks + {steps} decode steps); launches {launches}")
    print_routes(what, eng)
    del eng, plain, frozen
    torch.cuda.empty_cache()
    return launches, n_chunks, reqs, got


def shared_prefix_traffic(seed, vocab):
    """LM_REQUESTS prompts: one shared LM_PREFIX-token prefix (a system
    prompt of 4 pages) plus a suffix of LM_SUFFIX tokens of each its own,
    all drawn from the seed."""
    rng = np.random.default_rng(seed + 100)
    prefix = rng.integers(0, vocab, LM_PREFIX)
    lens = rng.integers(LM_SUFFIX[0], LM_SUFFIX[1] + 1, LM_REQUESTS)
    return [np.concatenate([prefix, rng.integers(0, vocab, n)]).astype(np.int32)
            for n in lens]


def print_routes(what, eng):
    """An engine's `kernel_routes()`, as the serving CLI prints them: on the
    card each a `cuda` launch and its fields."""
    routes = eng.kernel_routes()
    for name, (route, params) in routes.items():
        if route != "cuda":
            raise AssertionError(f"{what}: kernel route {name} is {route}")
        print(f"  {what}: kernel route {name}: {route} {params}")
    return routes


def lm_paged_engine_check(base_cfg, seed, dev):
    """Full width, depth LM_CHECK_DEPTH, the shared-prefix traffic through
    four engines: paged + prefix cache (the main path, launches counted),
    paged, contiguous (all through the kernels), and paged + prefix cache
    through the plain versions. All greedy tokens equal; prefix hits >= 1;
    prefilled plus cached tokens equal the prompt tokens. Returns the main
    path's launch counts."""
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request
    cfg = base_cfg.scaled(n_layers=LM_CHECK_DEPTH, kv_bits=1)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    frozen = get_model(cfg).init_frozen(gen, device=dev)
    prompts = shared_prefix_traffic(seed, cfg.vocab)
    reqs = [Request(p, max_new_tokens=LM_NEW) for p in prompts]
    main = lm_engine(cfg, frozen, seed=seed, page_size=LM_PAGE,
                     prefix_cache=True)
    reset_all_launches()
    comps = main.serve(reqs)
    torch.cuda.synchronize()
    launches = all_launches()
    st = dict(main.scheduler().stats)
    pool = main.scheduler().page_stats()
    others = {
        "paged": lm_engine(cfg, frozen, seed=seed, page_size=LM_PAGE),
        "contiguous": lm_engine(cfg, frozen, seed=seed),
        "paged + prefix, plain": lm_engine(cfg, frozen, seed=seed,
                                           page_size=LM_PAGE,
                                           prefix_cache=True,
                                           kernel_path="ref")}
    for name, eng in others.items():
        for i, (a, b) in enumerate(zip(comps, eng.generate(reqs),
                                       strict=True)):
            if not np.array_equal(a.tokens, b):
                raise AssertionError(
                    f"paged LM request {i}: paged + prefix tokens "
                    f"{a.tokens.tolist()} != {name} {b.tolist()}")
    if any(len(c.tokens) != LM_NEW for c in comps):
        raise AssertionError("a paged request did not get its budget")
    total = sum(map(len, prompts))
    if st["prefix_hits"] < 1:
        raise AssertionError("the shared prefix was never served from the "
                             "tree")
    if st["prefill_tokens"] + st["prefill_tokens_saved"] != total:
        raise AssertionError(f"prefill accounting {st} != {total} prompt "
                             f"tokens")
    for kn in PAGED_KERNELS + ("pack_bits", "binary_gemm_packed",
                               "binary_gemm_packed_rhs"):
        if not launches[kn]:
            raise AssertionError(f"the paged LM path launched no {kn}")
    for kn in ("decode_attention_packed", "prefill_attention_packed"):
        if launches[kn]:
            raise AssertionError(f"the paged LM path launched {kn}")
    print(f"lm paged engine check: {LM_ARCH} full width, depth "
          f"{LM_CHECK_DEPTH}, page {LM_PAGE}, prefix cache; {LM_REQUESTS} "
          f"requests of a shared {LM_PREFIX}-token prefix + "
          f"{sorted(len(p) - LM_PREFIX for p in prompts)} own tokens, "
          f"{LM_NEW} new: tokens equal the paged, contiguous and plain "
          f"engines'; prefix hits {st['prefix_hits']}, tokens saved "
          f"{st['prefill_tokens_saved']} + prefilled "
          f"{st['prefill_tokens']} = {total}; cached per request "
          f"{[c.cached_tokens for c in comps]}; pool {pool}; launches "
          f"{launches}")
    print_routes("lm paged engine check", main)
    del main, others, frozen
    torch.cuda.empty_cache()
    return launches


def lm_default_engine_check(base_cfg, seed, dev):
    """Phase 6c, the JAX package's default serving call at full width,
    depth LM_CHECK_DEPTH, frozen, on phase 6's traffic: the default engine
    `ServingEngine(cfg, params, freeze=True)` (whole-prompt admission,
    float KV cache; the main path, launches counted), the same at
    kv_bits=1, and kv_bits=0 chunked, contiguous and paged. In each, tokens
    through the kernels equal tokens through the plain versions; at
    kv_bits=0 paged equals contiguous; generate_static through the kernels
    equals it through the plain versions on 4 prompts of one length.
    Kernel 5 launches 2 (kv_bits=0) or 3 (kv_bits=1: the K|V rows into the
    cache) times per layer and forward call. Whole-prompt against chunked
    at kv_bits=0 is printed, not held: flash and masked-chunk softmax round
    differently, and a sign near zero can move a greedy token. Returns the
    main path's launch counts."""
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = base_cfg.scaled(n_layers=LM_CHECK_DEPTH, kv_bits=0)
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    frozen = get_model(cfg).init_frozen(gen, device=dev)
    prompts = lm_traffic(seed, cfg.vocab)
    reqs = [Request(p, max_new_tokens=LM_NEW) for p in prompts]
    base = dict(slots=LM_SLOTS, max_len=LM_MAX_LEN, seed=seed)
    variants = {"default (kv_bits=0, whole prompt)": {},
                "kv_bits=1, whole prompt": dict(kv_bits=1),
                "kv_bits=0, chunked": dict(prefill_chunk=LM_CHUNK),
                "kv_bits=0, chunked, paged": dict(prefill_chunk=LM_CHUNK,
                                                  page_size=LM_PAGE)}
    tokens, launches = {}, None
    for name, kw in variants.items():
        eng = ServingEngine(cfg, frozen, freeze=True, **base, **kw)
        sched = eng.scheduler()
        steps0 = sched.stats["decode_steps"]
        reset_all_launches()
        got = eng.generate(reqs)
        torch.cuda.synchronize()
        counts = all_launches()
        steps = sched.stats["decode_steps"] - steps0
        if launches is None:
            launches = counts                    # the default engine's run
        want = ServingEngine(cfg, frozen, kernel_path="ref", **base,
                             **kw).generate(reqs)
        for i, (a, b) in enumerate(zip(got, want, strict=True)):
            if not np.array_equal(a, b):
                raise AssertionError(f"default-engine phase, {name}, request "
                                     f"{i}: kernel tokens {a.tolist()} != "
                                     f"plain {b.tolist()}")
        if any(len(t) != LM_NEW for t in got):
            raise AssertionError(f"{name}: a request did not get its budget")
        calls = (len(prompts) if "whole" in name else
                 sum(-(-len(p) // LM_CHUNK) for p in prompts)) + steps
        per_call = 3 if kw.get("kv_bits") == 1 else 2
        if counts["pack_bits"] != per_call * LM_CHECK_DEPTH * calls:
            raise AssertionError(f"{name}: pack_bits launched "
                                 f"{counts['pack_bits']} times, not "
                                 f"{per_call} x {LM_CHECK_DEPTH} layers x "
                                 f"{calls} forward calls")
        attn = {kn: n for kn, n in counts.items() if "attention" in kn and n}
        if kw.get("kv_bits") != 1 and attn:
            raise AssertionError(f"{name}: a float-cache engine launched "
                                 f"packed attention {attn}")
        tokens[name] = got
        print(f"default-engine check, {name}: tokens equal the plain "
              f"path's; {steps} decode steps, pack_bits {per_call} x "
              f"{LM_CHECK_DEPTH} layers x {calls} calls; launches {counts}")
        del eng
    paged, contig = (tokens["kv_bits=0, chunked, paged"],
                     tokens["kv_bits=0, chunked"])
    for i, (a, b) in enumerate(zip(paged, contig, strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"kv_bits=0 request {i}: paged tokens "
                                 f"{a.tolist()} != contiguous {b.tolist()}")
    whole = tokens["default (kv_bits=0, whole prompt)"]
    same = [int(np.array_equal(a, b)) for a, b in zip(whole, contig)]
    agree = [int(np.argmin(np.r_[a == b, False])) for a, b in
             zip(whole, contig)]
    print(f"default-engine check: kv_bits=0 paged tokens equal contiguous; "
          f"whole-prompt against chunked (a figure, not held): "
          f"{sum(same)} of {len(same)} requests equal, leading tokens in "
          f"common {agree}")
    rng = np.random.default_rng(seed + 9)
    static = [Request(rng.integers(0, cfg.vocab, 64).astype(np.int32),
                      max_new_tokens=n) for n in (LM_NEW, 8, 12, LM_NEW)]
    eng = ServingEngine(cfg, frozen, freeze=True, **base)
    got = eng.generate_static(static)
    want = ServingEngine(cfg, frozen, kernel_path="ref",
                         **base).generate_static(static)
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"generate_static request {i}: kernel "
                                 f"tokens {a.tolist()} != plain {b.tolist()}")
    print(f"default-engine check: generate_static on 4 prompts of 64 tokens "
          f"(budgets {[r.max_new_tokens for r in static]}): tokens equal "
          f"the plain path's")
    del eng, frozen
    torch.cuda.empty_cache()
    return launches, {"agree_whole_vs_chunked": same,
                      "leading_tokens_in_common": agree}


def percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else float("nan")


def serve_report(eng, prompts, budget, images=None):
    """Warm `eng` up on a short request, then serve `prompts` (`budget` new
    tokens each; with `images`, the vlm family's, each its own) and report
    wall and decode/prefill seconds, steps, bursts, decode and prefill
    tokens/s, TTFT (own admission) p50/p99, TTFT wall p50 and ITL p50/p99.
    Returns (report, completions, scheduler)."""
    from repro_torch.serving.engine import Request
    imgs = images if images is not None else [None] * len(prompts)
    eng.generate([Request(prompts[0][:40], max_new_tokens=4,
                          img_emb=imgs[0])])                       # warm-up
    sched = eng.scheduler()
    before = dict(sched.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps = eng.serve([Request(p, max_new_tokens=budget, img_emb=img)
                       for p, img in zip(prompts, imgs)])
    wall = time.perf_counter() - t0
    st = {k: sched.stats[k] - before[k] for k in ("decode_s", "prefill_s",
                                                 "decode_steps", "bursts")}
    decode_tokens = sum(len(c.tokens) - 1 for c in comps)
    itl = np.concatenate([c.itl for c in comps])
    rep = {
        "wall_s": wall, **st, "decode_tokens": decode_tokens,
        "decode_tok_per_s": decode_tokens / st["decode_s"],
        "prefill_tok_per_s": sum(map(len, prompts)) / st["prefill_s"],
        "ttft_ms_p50": percentile([c.ttft for c in comps], 50) * 1e3,
        "ttft_ms_p99": percentile([c.ttft for c in comps], 99) * 1e3,
        "ttft_wall_ms_p50": percentile([c.ttft_wall for c in comps], 50) * 1e3,
        "itl_ms_p50": percentile(itl, 50) * 1e3,
        "itl_ms_p99": percentile(itl, 99) * 1e3}
    return rep, comps, sched


def print_serve_report(rep, prefill_note=""):
    print(f"  wall {rep['wall_s']:.4f} s; decode {rep['decode_tokens']} tokens"
          f" in {rep['decode_s']:.4f} s over {rep['decode_steps']} steps / "
          f"{rep['bursts']} bursts = {rep['decode_tok_per_s']:.2f} tok/s; "
          f"prefill {rep['prefill_tok_per_s']:.1f} tok/s{prefill_note}")
    print(f"  TTFT (own admission) p50 {rep['ttft_ms_p50']:.3f} ms, p99 "
          f"{rep['ttft_ms_p99']:.3f} ms; TTFT wall p50 "
          f"{rep['ttft_wall_ms_p50']:.3f} ms; ITL p50 {rep['itl_ms_p50']:.3f} "
          f"ms, p99 {rep['itl_ms_p99']:.3f} ms")


def print_trace(head, step, note=""):
    """One `trace` result: wall, device busy and its share of wall,
    launches (`note` after them), the top kernels."""
    share = step["busy_ms"] / step["wall_ms"] if step["wall_ms"] else 0.0
    print(f"{head}: wall {step['wall_ms']:.4f} ms (profiled), device busy "
          f"{step['busy_ms']:.4f} ms ({share:.3f} of wall), "
          f"{step['launches']} kernel launches{note}; top kernels:")
    for kname, cnt, ms in step["top"]:
        print(f"    {ms:9.4f} ms  x{cnt:<3d} {kname}")


def lm_timed_run(base_cfg, seed, dev, card):
    """Full width and depth: the same engine and traffic, timed, the
    weights drawn and frozen one layer at a time (`Model.init_frozen`).
    Returns the report and the frozen engine (for the profiled decode
    step)."""
    from repro_torch.models.api import get_model
    cfg = base_cfg.scaled(kv_bits=1)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    frozen = get_model(cfg).init_frozen(gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    d, hd = cfg.d_model, cfg.head_dim
    master_layer = 4 * (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                        + cfg.n_heads * hd * d + 3 * d * cfg.d_ff)
    eng = lm_engine(cfg, frozen, freeze=True, seed=seed)
    del frozen
    rep, _, _ = serve_report(eng, lm_traffic(seed, cfg.vocab), LM_NEW)
    w = eng.resident_weight_bytes()
    c = eng.resident_cache_bytes()
    bf16_cache = 2 * cfg.n_layers * LM_SLOTS * LM_MAX_LEN * cfg.n_kv_heads * \
        cfg.head_dim * 2
    rep.update({
        "depth": cfg.n_layers, "init_frozen_s": init_s,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "binary_bytes_per_layer": w["binary"] // cfg.n_layers,
        "master_bytes_per_layer": master_layer,
        "cache_packed_bytes": c["packed"], "cache_float_bytes": c["float"],
        "cache_bf16_bytes": bf16_cache})
    print(f"lm timed run on {card}: {LM_ARCH} full width and depth "
          f"({cfg.n_layers} layers, not cut; drawn and frozen layer by layer "
          f"in {init_s:.1f} s), {LM_REQUESTS} requests, {LM_SLOTS} slots, "
          f"chunk {LM_CHUNK}, max_len {LM_MAX_LEN}; peak device memory "
          f"{rep['peak_device_bytes'] / 1e9:.2f} GB")
    print_serve_report(rep)
    print(f"  resident weights per layer: {rep['binary_bytes_per_layer'] / 1e6:.1f}"
          f" MB packed vs {master_layer / 1e9:.3f} GB fp32 "
          f"({master_layer / rep['binary_bytes_per_layer']:.1f}x); cache "
          f"{c['packed'] / 1e6:.2f} MB packed + {c['float']} B V scales vs "
          f"{bf16_cache / 1e6:.2f} MB bf16 ({bf16_cache / c['packed']:.1f}x)")
    return rep, eng


def lm_default_timed_run(cfg, frozen, seed, dev, card, packed_bytes):
    """All 40 layers (the timed run's frozen weights) served by the default
    engine `ServingEngine(cfg, params)` (whole-prompt admission, float KV
    cache in bf16) on the LM's traffic: decode tokens/s, TTFT, ITL,
    resident cache bytes beside the packed cache's `packed_bytes`, peak
    device memory and one profiled decode step at position 300."""
    from repro_torch.serving.engine import ServingEngine
    cfg = cfg.scaled(kv_bits=0)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(cfg, frozen, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                        seed=seed)
    rep, _, sched = serve_report(eng, lm_traffic(seed, cfg.vocab), LM_NEW)
    c = eng.resident_cache_bytes()
    pos = torch.full((LM_SLOTS,), 300, dtype=torch.int32, device=dev)
    step = trace(lambda: sched.model.decode(sched.params, sched._state["cur"],
                                            sched._cache, pos))
    rep.update({
        "depth": cfg.n_layers,
        "cache_float_bytes": c["float"], "cache_packed_bytes": c["packed"],
        "packed_cache_bytes": packed_bytes,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "prefill_shapes": sched.prefill_shape_count,
        "decode_step_trace": step})
    print(f"lm default engine (kv_bits=0, whole prompt) timed run on {card}: "
          f"{LM_ARCH} 40 layers, {LM_REQUESTS} requests, {LM_SLOTS} slots, "
          f"max_len {LM_MAX_LEN}; peak device memory "
          f"{rep['peak_device_bytes'] / 1e9:.2f} GB")
    print_serve_report(rep, f" ({rep['prefill_shapes']} prompt shapes)")
    print(f"  cache {c['float'] / 1e6:.2f} MB float K/V (bf16) vs "
          f"{packed_bytes / 1e6:.2f} MB packed (kv_bits=1; "
          f"{c['float'] / packed_bytes:.1f}x)")
    print_trace(f"trace lm default-engine decode step (depth {cfg.n_layers}, "
                f"{LM_SLOTS} slots at position 300) on {card}", step)
    del eng, sched
    torch.cuda.empty_cache()
    return rep


def float_attention_times(cfg, dev_gen, dev, card):
    """The float attention (plain PyTorch, `models.attention`; the JAX
    package has no Pallas kernel for it) beside SDPA on the same inputs, at
    the default engine's shapes, bf16: one decode step of LM_SLOTS slots
    against a LM_MAX_LEN-position cache (lengths 512/300/100/17) and a
    200-token whole prompt (causal flash over attn_chunk positions). Device
    time (`device_ms`) and CUDA-event time of back-to-back calls; the bytes
    each must move over HBM rate beside them. Outputs agree within bf16
    rounding (atol 5e-2 on outputs of size ~1)."""
    from repro_torch.kernels import tune
    import torch.nn.functional as F
    from repro_torch.models import attention as A
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hkv
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=dev_gen, device=dev).to(bf)

    def gqa(x):                     # (B, T, Hkv, hd) -> (B, Hq, T, hd)
        return x.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()

    def decode_case():
        q = randn(LM_SLOTS, 1, hq, hd)
        k, v = (randn(LM_SLOTS, LM_MAX_LEN, hkv, hd) for _ in range(2))
        lens = torch.tensor([LM_MAX_LEN, 300, 100, 17], dtype=torch.int32,
                            device=dev)
        qs, ks, vs = q.transpose(1, 2).contiguous(), gqa(k), gqa(v)
        mask = (torch.arange(LM_MAX_LEN, device=dev)[None]
                < lens[:, None])[:, None, None]
        nbytes = 2 * int(lens.sum()) * hkv * hd * 2 + 2 * LM_SLOTS * hq * hd * 2
        return ("decode step", lambda: A.decode_attention(q, k, v, lens),
                lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                       attn_mask=mask),
                nbytes)

    def prefill_case(s):
        q = randn(1, s, hq, hd)
        k, v = (randn(1, s, hkv, hd) for _ in range(2))
        qs, ks, vs = q.transpose(1, 2).contiguous(), gqa(k), gqa(v)
        return (f"prefill of {s} tokens",
                lambda: A.flash_attention(q, k, v, True, 0, cfg.attn_chunk, 0),
                lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                       is_causal=True),
                (2 * s * hq * hd + 2 * s * hkv * hd) * 2)

    rows = [decode_case(), prefill_case(200)]
    out = []
    for where, fn, lib, nbytes in rows:
        err = float((fn() - lib().transpose(1, 2)).float().abs().max())
        if not err <= 5e-2:
            raise AssertionError(f"float attention {where} differs from "
                                 f"SDPA by {err}")
        r = {"where": where, "ms": device_ms(fn), "wall_ms": cuda_ms(fn),
             "sdpa_ms": device_ms(lib), "sdpa_wall_ms": cuda_ms(lib),
             "bytes_ms": nbytes / tune.HBM_BYTES_PER_S * 1e3,
             "max_abs_diff": err}
        out.append(r)
    print(f"float attention times on {card} (bf16; plain PyTorch, "
          f"models/attention.py; ms: device time, wall = CUDA events over "
          f"back-to-back calls; SDPA is timed, never called by the port):")
    for r in out:
        print(f"  {r['where']:22s} ours {r['ms']:.4f} (wall "
              f"{r['wall_ms']:.4f})  SDPA {r['sdpa_ms']:.4f} (wall "
              f"{r['sdpa_wall_ms']:.4f})  bytes bound {r['bytes_ms']:.5f}  "
              f"max |ours - SDPA| {r['max_abs_diff']:.3g}")
    return out


def lm_paged_timed_run(cfg, frozen, seed, dev, card):
    """All 40 layers (the timed run's weights), the shared-prefix traffic
    served twice: from the paged pool with the prefix cache (page 32,
    chunk 32, 4 slots, max_len 512) and from the contiguous cache. Tokens
    must be equal. Reports decode tokens/s, TTFT of the requests that hit
    the tree and of those that missed, ITL, prefix stats, the page pool and
    peak device memory of each."""
    from repro_torch.serving.engine import Request
    prompts = shared_prefix_traffic(seed, cfg.vocab)
    warm = np.random.default_rng(seed + 7).integers(0, cfg.vocab, 40)
    out = {}
    tokens = {}
    for name, kw in (("paged + prefix", dict(page_size=LM_PAGE,
                                             prefix_cache=True)),
                     ("contiguous", {})):
        eng = lm_engine(cfg, frozen, seed=seed, **kw)
        eng.generate([Request(warm, max_new_tokens=4)])   # a page of its own
        sched = eng.scheduler()
        before = dict(sched.stats)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        comps = eng.serve([Request(p, max_new_tokens=LM_NEW)
                           for p in prompts])
        wall = time.perf_counter() - t0
        st = {k: sched.stats[k] - before[k] for k in before}
        tokens[name] = [c.tokens for c in comps]
        hit = [c.ttft for c in comps if c.cached_tokens]
        miss = [c.ttft for c in comps if not c.cached_tokens]
        itl = np.concatenate([c.itl for c in comps])
        decode_tokens = sum(len(c.tokens) - 1 for c in comps)
        rep = {"wall_s": wall, "decode_s": st["decode_s"],
               "prefill_s": st["prefill_s"],
               "decode_steps": st["decode_steps"], "bursts": st["bursts"],
               "decode_tokens": decode_tokens,
               "decode_tok_per_s": decode_tokens / st["decode_s"],
               "prefill_tokens": st["prefill_tokens"],
               "prefill_tokens_saved": st["prefill_tokens_saved"],
               "prefix_hits": st["prefix_hits"],
               "cached_tokens": [c.cached_tokens for c in comps],
               "hit_requests": len(hit), "miss_requests": len(miss),
               "ttft_hit_ms_p50": percentile(hit, 50) * 1e3,
               "ttft_miss_ms_p50": percentile(miss, 50) * 1e3,
               "ttft_wall_ms_p50": percentile(
                   [c.ttft_wall for c in comps], 50) * 1e3,
               "itl_ms_p50": percentile(itl, 50) * 1e3,
               "itl_ms_p99": percentile(itl, 99) * 1e3,
               "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
               "page_pool": sched.page_stats(),
               "cache_bytes": {k: v for k, v in
                               eng.resident_cache_bytes().items()
                               if k != "page_pool"}}
        out[name] = rep
        print(f"lm paged timed run on {card}, {name}: {LM_ARCH} full width "
              f"and depth ({cfg.n_layers} layers), {LM_REQUESTS} requests of "
              f"a shared {LM_PREFIX}-token prefix + "
              f"{LM_SUFFIX[0]}-{LM_SUFFIX[1]} own tokens, {LM_NEW} new, "
              f"{LM_SLOTS} slots, chunk {LM_CHUNK}, max_len {LM_MAX_LEN}")
        print(f"  wall {wall:.4f} s; decode {decode_tokens} tokens in "
              f"{st['decode_s']:.4f} s over {st['decode_steps']} steps / "
              f"{st['bursts']} bursts = {rep['decode_tok_per_s']:.2f} tok/s; "
              f"prefilled {st['prefill_tokens']} tokens in "
              f"{st['prefill_s']:.4f} s, {st['prefill_tokens_saved']} served "
              f"from the tree ({st['prefix_hits']} hits)")
        print(f"  TTFT (own admission) p50 hit {rep['ttft_hit_ms_p50']:.3f} "
              f"ms ({len(hit)} requests), miss {rep['ttft_miss_ms_p50']:.3f} "
              f"ms ({len(miss)}); TTFT wall p50 "
              f"{rep['ttft_wall_ms_p50']:.3f} ms; ITL p50 "
              f"{rep['itl_ms_p50']:.3f} ms, p99 {rep['itl_ms_p99']:.3f} ms; "
              f"peak device memory {rep['peak_device_bytes'] / 1e9:.2f} GB; "
              f"cache {rep['cache_bytes']}; pool {rep['page_pool']}")
        del eng, sched
        torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(tokens["paged + prefix"],
                                   tokens["contiguous"], strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"40-layer paged request {i}: tokens "
                                 f"{a.tolist()} != contiguous {b.tolist()}")
    if out["paged + prefix"]["prefix_hits"] < 1:
        raise AssertionError("the 40-layer paged run served no prefix hit")
    print("  tokens of the paged + prefix run equal the contiguous run's")
    return out


def shape_times(call, kn, plain, library=None):
    """The times of kernel `kn` at one shape: `ms` its device time
    (`device_ms`), `wrapper_ms` the CUDA-event time of back-to-back wrapper
    calls (host checks and the ctypes call included), `plain_ms` the
    CUDA-event time of its plain version, `library_ms` the device time of
    the library call and `library_wall_ms` its CUDA-event time."""
    out = {"ms": device_ms(call, wrapper=kn),
           "wrapper_ms": cuda_ms(call),
           "plain_ms": cuda_ms(plain, warmup=1, budget_s=0.2, max_iters=10),
           "library_ms": None, "library_wall_ms": None}
    if library is not None:
        out["library_ms"] = device_ms(library)
        out["library_wall_ms"] = cuda_ms(library)
    return out


def pack_times(cfg, dev_gen, dev):
    """Kernel 5's three launches of an LM layer-step (bf16): the normed
    residual's shared packs for Q/K/V and gate/up (`pack_bits_kernel`,
    x2) and the new K and V rows packed into the cache (`pack_rows_into`,
    x1), in a decode step of LM_SLOTS rows and a chunk of LM_CHUNK rows,
    as `shape_times`. Bound: the bytes each call moves (values read,
    words written, destination rows read) over HBM rate, or one compare a
    value at the fp32 rate."""
    from repro_torch.kernels import tune
    _, pk, _, _, _ = lm_modules()
    hkv, hd, t = cfg.n_kv_heads, cfg.head_dim, LM_MAX_LEN
    rows = []

    def bound(nbytes, values):
        t_bytes = nbytes / tune.HBM_BYTES_PER_S * 1e3
        t_ops = values / tune.FP32_OPS_PER_S * 1e3
        return {"bytes_ms": t_bytes, "ops_ms": t_ops,
                "bound_ms": max(t_bytes, t_ops)}

    for m, where in ((LM_SLOTS, "decode"), (LM_CHUNK, "chunk")):
        x = torch.randn(m, cfg.d_model, generator=dev_gen,
                        device=dev).to(torch.bfloat16)
        rows.append({"kernel": "pack_bits", "where": f"{where} x2 (shared)",
                     "shape": (m, cfg.d_model), "per_layer": 2,
                     "library": None,
                     **shape_times(lambda: pk.pack_bits_kernel(x),
                                   "pack_bits",
                                   lambda: pk.pack_bits_plain(x)),
                     **bound(m * cfg.d_model * 2
                             + m * ((cfg.d_model + 31) // 32) * 4,
                             m * cfg.d_model)})
        kv = [torch.randn(m, hkv, hd, generator=dev_gen,
                          device=dev).to(torch.bfloat16) for _ in range(2)]
        pools = [torch.zeros((LM_SLOTS, t, hkv, (hd + 31) // 32),
                             dtype=torch.int32, device=dev) for _ in range(2)]
        dst = (torch.arange(m, device=dev) * 7 % (LM_SLOTS * t)).long()
        rows.append({"kernel": "pack_bits", "where": f"{where} K|V rows "
                                                     f"into the cache",
                     "shape": (2, m, hkv, hd), "per_layer": 1,
                     "library": None,
                     **shape_times(lambda: pk.pack_rows_into(kv, pools, dst),
                                   "pack_bits",
                                   lambda: pk.pack_rows_into_plain(
                                       kv, pools, dst)),
                     **bound(2 * m * hkv * hd * 2
                             + 2 * m * hkv * ((hd + 31) // 32) * 4 + m * 8,
                             2 * m * hkv * hd)})
    return rows


def pack_wrapper_parts(cfg, dev_gen, dev):
    """What a kernel-5 wrapper call's time is made of, at the decode step's
    shapes (ms per call, CUDA events over back-to-back calls): the whole
    wrapper; the bare C entry called with its arguments ready (the launch,
    through ctypes); torch.empty of the output (pack_bits_kernel only); the
    rest is the wrapper's Python checks and argument reads."""
    _, pk, _, _, _ = lm_modules()
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    x = torch.randn(LM_SLOTS, cfg.d_model, generator=dev_gen,
                    device=dev).to(torch.bfloat16)
    out = torch.empty((LM_SLOTS, (cfg.d_model + 31) // 32),
                      dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = pk._entry("pack_bits")
    args = (x.data_ptr(), 1, out.data_ptr(), LM_SLOTS, cfg.d_model, stream)
    parts = {"pack_bits_kernel": {
        "wrapper_ms": cuda_ms(lambda: pk.pack_bits_kernel(x)),
        "c_entry_ms": cuda_ms(lambda: fn(*args)),
        "alloc_ms": cuda_ms(lambda: torch.empty(
            (LM_SLOTS, (cfg.d_model + 31) // 32), dtype=torch.int32,
            device=dev))}}
    kv = [torch.randn(LM_SLOTS, hkv, hd, generator=dev_gen,
                      device=dev).to(torch.bfloat16) for _ in range(2)]
    pools = [torch.zeros((LM_SLOTS, LM_MAX_LEN, hkv, (hd + 31) // 32),
                         dtype=torch.int32, device=dev) for _ in range(2)]
    dst = torch.arange(LM_SLOTS, device=dev) * LM_MAX_LEN + 300
    fn = pk._entry("pack_rows_into")
    args = (kv[0].data_ptr(), kv[1].data_ptr(), 1, pools[0].data_ptr(),
            pools[1].data_ptr(), dst.data_ptr(), LM_SLOTS, hkv, hd,
            LM_SLOTS * LM_MAX_LEN, stream)
    parts["pack_rows_into"] = {
        "wrapper_ms": cuda_ms(lambda: pk.pack_rows_into(kv, pools, dst)),
        "c_entry_ms": cuda_ms(lambda: fn(*args)), "alloc_ms": 0.0}
    for p in parts.values():
        p["checks_ms"] = p["wrapper_ms"] - p["c_entry_ms"] - p["alloc_ms"]
    return parts


def lm_kernel_times(cfg, dev_gen, dev, popc_per_s):
    """Times of kernels 5, 6, 8 at the LM's main-path shapes (bf16
    activations, see `shape_times`) beside their bounds, plain versions and, for
    B and C, one PyTorch call (SDPA) computing the same function. Returns
    the rows and the per-kernel sums over one layer's launches in one
    decode step and one prefill chunk."""
    from repro_torch.kernels import ref
    _, pk, da, pa, _ = lm_modules()
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    rows = pack_times(cfg, dev_gen, dev)
    lens = torch.tensor([LM_MAX_LEN, 300, 100, 17], dtype=torch.int32,
                        device=dev)
    q, k, v, vs = attention_case(dev_gen, LM_SLOTS, 1, LM_MAX_LEN, hkv, g, hd,
                                 torch.bfloat16, dev)
    valid = ref.chunk_valid_mask(LM_SLOTS, 1, LM_MAX_LEN, lens, lens - 1, 0,
                                 True, device=dev)
    lib = sdpa_call(q, k, v, vs, valid)
    check_close_loose("SDPA vs decode kernel", lib(),
                      da.decode_attention_packed(q, k, v, vs, lens))
    rows.append({"kernel": "decode_attention_packed",
                 "where": f"decode B={LM_SLOTS} T={LM_MAX_LEN} lens "
                          f"{lens.tolist()}", "shape": tuple(q.shape),
                 "per_layer": 1, "library": "F.scaled_dot_product_attention",
                 **shape_times(
                     lambda: da.decode_attention_packed(q, k, v, vs, lens),
                     "decode_attention_packed",
                     lambda: da.decode_attention_packed_plain(
                         q, k, v, vs, lens), lib),
                 **attention_bound(valid, 1, cfg.n_heads, hkv, hd, 2, popc_per_s)})
    for qp in (0, 96):
        q, k, v, vs = attention_case(dev_gen, 1, LM_CHUNK, LM_MAX_LEN, hkv, g,
                                     hd, torch.bfloat16, dev)
        kv = qp + LM_CHUNK
        valid = ref.chunk_valid_mask(1, LM_CHUNK, LM_MAX_LEN, kv, qp, 0, True,
                                     device=dev)
        lib = sdpa_call(q, k, v, vs, valid)
        check_close_loose("SDPA vs prefill kernel", lib(),
                          pa.prefill_attention_packed(q, k, v, vs, kv, qp))
        rows.append({"kernel": "prefill_attention_packed",
                     "where": f"chunk S={LM_CHUNK} q_pos={qp} T={LM_MAX_LEN}",
                     "shape": tuple(q.shape), "per_layer": 0.5,
                     "library": "F.scaled_dot_product_attention",
                     **shape_times(
                         lambda: pa.prefill_attention_packed(
                             q, k, v, vs, kv, qp),
                         "prefill_attention_packed",
                         lambda: pa.prefill_attention_packed_plain(
                             q, k, v, vs, kv, qp), lib),
                     **attention_bound(valid, LM_CHUNK, cfg.n_heads, hkv, hd,
                                       2, popc_per_s)})
    rows += lm_paged_kernel_times(cfg, dev_gen, dev, popc_per_s)
    totals = {}
    for r in rows:
        t = totals.setdefault(r["kernel"], {
            "ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": None,
            "library_wall_ms": None})
        for key in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bytes_ms",
                    "ops_ms"):
            t[key] += r[key] * r["per_layer"]
        for key in ("library_ms", "library_wall_ms"):
            if r[key] is not None:
                t[key] = (t[key] or 0.0) + r[key] * r["per_layer"]
    return rows, totals


def lm_paged_kernel_times(cfg, dev_gen, dev, popc_per_s):
    """Times of kernels 7 and 9 at the paged path's shapes (bf16; a 64-page
    pool in shuffled order, page 32, lengths 512/300/100/17; chunks of 32
    at q_pos 0 and 96 against one row), as `shape_times`. The library call
    is SDPA over the unpacked +-1 K/V gathered from the pages; the gather's
    own device time is printed beside it (`gather_ms`). The bound counts
    the valid K/V rows, q, out, v_scale and the page table."""
    from repro_torch.kernels import ref
    _, _, da, pa, _ = lm_modules()
    rng = np.random.default_rng(0)
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    n_pages = LM_MAX_LEN // LM_PAGE
    lens = torch.tensor([LM_MAX_LEN, 300, 100, 17], dtype=torch.int32,
                        device=dev)
    q, k, v, vs, pt = paged_case(dev_gen, rng, LM_SLOTS, 1, LM_PAGE, n_pages,
                                 LM_POOL, hkv, g, hd, lens.tolist(),
                                 torch.bfloat16, dev)

    def gathered(table):
        return ref.gather_pages(k, table), ref.gather_pages(v, table)

    rows = []
    valid = ref.chunk_valid_mask(LM_SLOTS, 1, LM_MAX_LEN, lens, lens - 1, 0,
                                 True, device=dev)
    lib = sdpa_call(q, *gathered(pt), vs, valid)
    check_close_loose("SDPA vs paged decode kernel", lib(),
                      da.decode_attention_packed_paged(q, k, v, vs, pt, lens))
    bnd = attention_bound(valid, 1, cfg.n_heads, hkv, hd, 2, popc_per_s)
    rows.append({"kernel": "decode_attention_packed_paged",
                 "where": f"paged decode B={LM_SLOTS} ps={LM_PAGE} "
                          f"pool={LM_POOL} lens {lens.tolist()}",
                 "shape": tuple(q.shape), "per_layer": 1,
                 "library": "F.scaled_dot_product_attention",
                 "gather_ms": device_ms(lambda: gathered(pt)),
                 **shape_times(
                     lambda: da.decode_attention_packed_paged(
                         q, k, v, vs, pt, lens),
                     "decode_attention_packed_paged",
                     lambda: da.decode_attention_packed_paged_plain(
                         q, k, v, vs, pt, lens), lib),
                 **paged_bound(bnd, pt)})
    for qp in (0, 96):
        qc = torch.randint(-6, 7, (1, LM_CHUNK, hkv * g, hd), generator=dev_gen,
                           device=dev).to(torch.bfloat16)
        vc = vs[1:2]
        row = pt[1:2]                       # the 300-position row
        kv = qp + LM_CHUNK
        valid = ref.chunk_valid_mask(1, LM_CHUNK, LM_MAX_LEN, kv, qp, 0, True,
                                     device=dev)
        lib = sdpa_call(qc, *gathered(row), vc, valid)
        check_close_loose("SDPA vs paged prefill kernel", lib(),
                          pa.prefill_attention_packed_paged(qc, k, v, vc, row,
                                                            kv, qp))
        bnd = attention_bound(valid, LM_CHUNK, cfg.n_heads, hkv, hd, 2,
                              popc_per_s)
        rows.append({"kernel": "prefill_attention_packed_paged",
                     "where": f"paged chunk S={LM_CHUNK} q_pos={qp} "
                              f"ps={LM_PAGE}",
                     "shape": tuple(qc.shape), "per_layer": 0.5,
                     "library": "F.scaled_dot_product_attention",
                     "gather_ms": device_ms(lambda: gathered(row)),
                     **shape_times(
                         lambda: pa.prefill_attention_packed_paged(
                             qc, k, v, vc, row, kv, qp),
                         "prefill_attention_packed_paged",
                         lambda: pa.prefill_attention_packed_paged_plain(
                             qc, k, v, vc, row, kv, qp), lib),
                     **paged_bound(bnd, row)})
    return rows


def paged_bound(bnd, table):
    """`attention_bound` plus the page table's bytes read once."""
    from repro_torch.kernels import tune
    extra = table.numel() * 4 / tune.HBM_BYTES_PER_S * 1e3
    out = dict(bnd, bytes_ms=bnd["bytes_ms"] + extra)
    out["bound_ms"] = max(out["bytes_ms"], out["ops_ms"])
    return out


def check_close_loose(what, lib, kern):
    """The library call computes the same function: within bf16 rounding of
    the kernel (atol 2e-2 on outputs of size <= 1)."""
    err = float((lib.float() - kern.float()).abs().max())
    if not err <= 2e-2:
        raise AssertionError(f"{what}: differs by {err}")

# ---------------------------------------------------------------------------
# The training path: kernel 4 (binary_gemm_mxu) and the train step
# ---------------------------------------------------------------------------
def train_conv_shapes(cfg):
    """(M, K, N) of the binary convs (2-6) of one bnn-cifar10 train step:
    im2col rows of the batch x K = 9 Cin against Cout."""
    side, cin, out = cfg.img, cfg.widths[0], []
    for i, cout in enumerate(cfg.widths[1:], start=1):
        out.append((cfg.batch * side * side, 9 * cin, cout))
        cin = cout
        if i % 2 == 1:
            side //= 2
    return out


def mxu_operands(gen, m, k, n, edges=False):
    """x (M, K), w (K, N) float32 on the card with 5% exact zeros; with
    `edges` also -0.0 (signs +1) and NaN (signs -1) in both."""
    dev = gen.device
    x = torch.randn(m, k, generator=gen, device=dev)
    x[torch.rand(m, k, generator=gen, device=dev) < 0.05] = 0.0
    w = torch.randn(k, n, generator=gen, device=dev)
    w[torch.rand(k, n, generator=gen, device=dev) < 0.05] = 0.0
    if edges:
        for t in (x, w):
            t.view(-1)[1::17] = -0.0
            t.view(-1)[2::19] = float("nan")
    return x, w


# kernel 4 in each regime of its plan besides the convs' tiles: small-M
# rows, small M split over an 8-block cluster, tiles at small M (KW % 4 !=
# 0), tiles split over a cluster
MXU_REGIMES = [(4, 1024, 300), (32, 8190, 200), (17, 300, 48),
               (300, 1000, 257)]


def mxu_bound(m, k, n, x_bytes=4):
    """Least time of sign(x) @ sign(w): x, w read once and the float32
    output written once over HBM rate, or the 2MNK int8 tensor-core ops."""
    from repro_torch.kernels import tune
    nbytes = m * k * x_bytes + k * n * 4 + m * n * 4
    t_bytes = nbytes / tune.HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * n * k / tune.INT8_TC_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": 2 * m * n * k, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops)}


def mxu_kernel_checks(dev_gen, shapes, sms):
    """Kernel 4 against its plain version, float32 and bf16 x, with NaN,
    -0.0 and 0.0 in x and w: equal (tolerance 0), one launch per call."""
    from repro_torch.kernels import binary_gemm as bg
    err = 0
    for m, k, n in shapes:
        x, w = mxu_operands(dev_gen, m, k, n, edges=True)
        for xs in (x, x.to(torch.bfloat16)):
            before = bg.launches[MXU]
            got = bg.binary_gemm_mxu(xs, w)
            torch.cuda.synchronize()
            if bg.launches[MXU] - before != 1:
                raise AssertionError(f"{MXU} ({m},{k},{n}): not one launch")
            want = bg.binary_gemm_mxu_plain(xs, w)
            if not torch.equal(got, want):
                d = float((got - want).abs().max())
                raise AssertionError(f"{MXU} {xs.dtype} ({m},{k},{n}) differs "
                                     f"from its plain version by {d}")
            print(f"check {MXU:24s} {str(xs.dtype)[6:]:8s} M={m:6d} K={k:5d} "
                  f"N={n:5d} {plan_text(MXU, m, k, n, sms):28s} "
                  f"NaN/-0.0 in x and w, max_abs_err=0.0")
    return err


class Recorder:
    """Records the outputs of module attributes while active (the binary
    convs and the scores of a train forward)."""

    def __init__(self, module, names):
        self.module, self.names, self.seen = module, names, {n: [] for n in names}

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in self.names}
        for n in self.names:
            def spy(*a, _n=n, **kw):
                out = self.orig[_n](*a, **kw)
                self.seen[_n].append((out if _n != "square_hinge_loss"
                                      else a[0]).detach().clone())
                return out
            setattr(self.module, n, spy)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)


def leaves_equal(a, b) -> bool:
    from repro_torch.optim.base import tree_leaves
    return all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a), tree_leaves(b), strict=True))


def slice_pairs(a: torch.Tensor, b: torch.Tensor, n: int = 1 << 24):
    """Matching flat float64 slices of two tensors of one shape on a's
    device, b's moved there (a full-width leaf in float64 at once would not
    fit beside a train step's state on the card)."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    for lo in range(0, fa.numel(), n):
        yield fa[lo:lo + n].double(), fb[lo:lo + n].to(fa.device).double()


def max_rel(got, want) -> float:
    """max |got - want| / max |want| over one tensor (0 for equal zeros),
    a slice at a time on got's device."""
    scale = err = 0.0
    for x, y in slice_pairs(got, want):
        scale = max(scale, float(y.abs().max()))
        err = max(err, float((x - y).abs().max()))
    return err / scale if scale else (0.0 if err == 0 else float("inf"))


def train_routes_check(cfg, seed, dev):
    """bnn-cifar10 at full width: TRAIN_STEPS steps through every route from
    the same weights, batches and draws. Returns the auto route's launches
    (the main path) and each route's."""
    from repro_torch.models import paper_nets as pn
    from repro_torch.train import paper as tp
    data = tp.synthetic_data(cfg, seed)
    batches = [tuple(torch.from_numpy(a).to(dev) for a in data.batch(i, cfg.batch))
               for i in range(TRAIN_STEPS)]
    runs = {}
    for path in TRAIN_ROUTES:
        params, bn = tp.init_params(cfg, torch.Generator().manual_seed(seed), dev)
        opt = tp.make_optimizer(cfg)
        st = opt.init(params)
        step = tp.make_train_step(cfg, opt, kernel_path=path)
        gen = torch.Generator(device=dev).manual_seed(seed + 8)
        losses = []
        torch.cuda.synchronize()
        reset_all_launches()
        for i, (x, y) in enumerate(batches):
            if i == 0:
                with Recorder(pn, ("binary_conv2d", "square_hinge_loss")) as rec:
                    params, bn, st, loss = step(params, bn, st, x, y, gen)
            else:
                params, bn, st, loss = step(params, bn, st, x, y, gen)
            losses.append(loss)
        torch.cuda.synchronize()
        runs[path] = {"launches": {k: v for k, v in all_launches().items() if v},
                      "convs": rec.seen["binary_conv2d"],
                      "scores": rec.seen["square_hinge_loss"][0],
                      "losses": [float(v) for v in losses],
                      "state": (params, bn, st)}
    n_convs = len(cfg.widths) - 1
    base = runs["auto"]
    for path, run in runs.items():
        if len(run["convs"]) != n_convs:
            raise AssertionError(f"{path}: {len(run['convs'])} binary convs")
        for i, (a, b) in enumerate(zip(run["convs"], base["convs"])):
            check_equal(f"step-1 binary conv {i + 2} output, {path} vs auto",
                        a, b)
        check_equal(f"step-1 scores, {path} vs auto", run["scores"],
                    base["scores"])
        if run["losses"] != base["losses"] \
                or not leaves_equal(run["state"], base["state"]):
            raise AssertionError(f"{path}: losses or params/BN/optimizer state "
                                 f"after {TRAIN_STEPS} steps differ from auto")
    want = {"auto": {MXU: n_convs * TRAIN_STEPS}, "ref": {},
            "vpu": {"binary_gemm_packed": n_convs * TRAIN_STEPS,
                    "pack_bits": 2 * n_convs * TRAIN_STEPS}}
    for path, run in runs.items():
        if run["launches"] != want[path]:
            raise AssertionError(f"{path} launches {run['launches']} != "
                                 f"{want[path]}")
    print(f"train routes: {cfg.name} full width, batch {cfg.batch}, BBP "
          f"stochastic, shift-BN, S-AdaMax, {TRAIN_STEPS} steps per route: "
          f"step-1 binary-conv outputs and scores equal across "
          f"{'/'.join(TRAIN_ROUTES)} (tolerance 0); losses "
          f"{base['losses']} and params, BN and optimizer state after "
          f"{TRAIN_STEPS} steps equal bit for bit (tolerance 0: the backward "
          f"is the same code on every route and takes no atomics); launches "
          + ", ".join(f"{p} {r['launches']}" for p, r in runs.items()))
    return base["launches"], {p: r["launches"] for p, r in runs.items()}


def train_cpu_check(cfg, seed, dev):
    """One deterministic step of a CPU_BATCH batch at full width on the
    card and on the CPU, from the same weights: loss, BN state and moments
    within TRAIN_REL of the largest magnitude of each tensor; params there
    too, except where S-AdaMax's per-element normalization carries the
    moments' difference further (tests/test_torch_train.py): a gradient at
    the noise floor of its tensor (|m| <= TRAIN_REL max|m| on both sides:
    its sign is rounding), two AP2 factors AP2(1 / (u + eps)) that differ,
    or |dp| <= s |dm| AP2(1 / (u + eps)) through a shared factor."""
    import dataclasses
    from repro_torch.optim.base import tree_leaves
    from repro_torch.train import paper as tp
    small = dataclasses.replace(cfg, batch=CPU_BATCH)
    x, y = (torch.from_numpy(a)
            for a in tp.synthetic_data(small, seed).batch(0, CPU_BATCH))

    def one_step(d):
        params, bn = tp.init_params(small, torch.Generator().manual_seed(seed), d)
        opt = tp.make_optimizer(small)
        return tp.make_train_step(small, opt)(params, bn, opt.init(params),
                                              x.to(d), y.to(d), None)

    (pg, bgr, sg, lg), (pc, bc, sc, lc) = one_step(dev), one_step("cpu")
    worst = max_rel(lg, lc)
    for a, b in zip(tree_leaves((bgr, sg.m, sg.u)), tree_leaves((bc, sc.m, sc.u)),
                    strict=True):
        worst = max(worst, max_rel(a, b) if a.is_floating_point() else
                    (0.0 if torch.equal(a.cpu(), b) else float("inf")))
    if not worst <= TRAIN_REL:
        raise AssertionError(f"card step vs CPU step: {worst} > {TRAIN_REL}")
    # S-AdaMax's first step: p - s * m * AP2(1 / (u + eps)), s = AP2(lr / 0.1)
    lr = torch.tensor(small.base_lr, dtype=torch.float64)
    s = float(2.0 ** torch.round(torch.log2(lr / (1 - 0.9))))
    counts = moments_parity((pg, sg), (pc, sc), TRAIN_REL, s)
    print(f"train CPU check: one deterministic step of {CPU_BATCH} images at "
          f"full width, card vs CPU: loss {float(lg):.6f} / {float(lc):.6f}, "
          f"loss, BN state and moments within {worst:.3g} of the largest "
          f"magnitude of each tensor (tolerance {TRAIN_REL}); params off by "
          f"more in {sum(counts.values())} elements: {counts['noise_floor']} "
          f"at the noise floor of their gradient, {counts['ap2']} at an AP2 "
          f"boundary, {counts['carried']} by the moments' difference through "
          f"a shared AP2 factor")


def train_times(cfg, seed, dev, card, dev_gen):
    """Kernel 4 at the train step's conv shapes (`shape_times`, with
    torch._int_mm on the same +-1 int8 operands as the library call; beside
    it `library_sign_ms`, the device time of signing x and w to int8 and
    then torch._int_mm, the same function from kernel 4's own float
    inputs), then the train step per batch on each route, and one step's
    busy share, launches and peak memory."""
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.train import paper as tp
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    one, neg = (torch.tensor(v, dtype=torch.int8, device=dev) for v in (1, -1))
    print(f"{MXU} times on {card} (ms; kernel: device_ms, its signing pass "
          f"included; wrapper and plain: CUDA events; library: torch._int_mm "
          f"on +-1 int8, device_ms; sign+lib: signing x and w to int8 and "
          f"torch._int_mm, device_ms; bound = max(bytes / 3.35 TB/s, 2MNK / "
          f"1979 TOP/s))")
    for m, k, n in train_conv_shapes(cfg):
        x, w = mxu_operands(dev_gen, m, k, n)
        xi = torch.where(x >= 0, 1, -1).to(torch.int8)
        # (K, N) column-major, the layout phase 7's torch._int_mm calls use
        wi = torch.where(w.t() >= 0, 1, -1).to(torch.int8).contiguous().t()
        lib = (lambda xi=xi, wi=wi: torch._int_mm(xi, wi))

        def signed_lib(x=x, w=w):
            return torch._int_mm(torch.where(x >= 0, one, neg), torch.where(
                w.t() >= 0, one, neg).contiguous().t())
        got = bg.binary_gemm_mxu(x, w)
        check_equal(f"torch._int_mm vs {MXU} ({m},{k},{n})",
                    lib().to(torch.float32), got)
        check_equal(f"sign + torch._int_mm vs {MXU} ({m},{k},{n})",
                    signed_lib().to(torch.float32), got)
        row = {"kernel": MXU, "M": m, "K": k, "N": n,
               "library": "torch._int_mm", "plan": plan_text(MXU, m, k, n, sms),
               **shape_times(lambda x=x, w=w: bg.binary_gemm_mxu(x, w), MXU,
                             lambda x=x, w=w: bg.binary_gemm_mxu_plain(x, w),
                             lib),
               "library_sign_ms": device_ms(signed_lib),
               **mxu_bound(m, k, n)}
        rows.append(row)
        print(f"  {MXU} M={m:6d} K={k:5d} N={n:4d} kernel {row['ms']:.4f} "
              f"(wrapper {row['wrapper_ms']:.4f})  plain {row['plain_ms']:.3f}"
              f"  torch._int_mm {row['library_ms']:.4f} (wall "
              f"{row['library_wall_ms']:.4f})  sign+lib "
              f"{row['library_sign_ms']:.4f}  bound {row['bound_ms']:.4f} "
              f"({'bytes' if row['bytes_ms'] >= row['ops_ms'] else 'ops'}; "
              f"int8 TC {row['ops_ms']:.4f})  {row['plan']}")
        del x, w, xi, wi, got
    print(f"  {MXU} over the {len(rows)} convs: kernel "
          f"{sum(r['ms'] for r in rows):.4f}  torch._int_mm "
          f"{sum(r['library_ms'] for r in rows):.4f}  sign+lib "
          f"{sum(r['library_sign_ms'] for r in rows):.4f}  bound "
          f"{sum(r['bound_ms'] for r in rows):.4f}")
    data = tp.synthetic_data(cfg, seed)
    x, y = (torch.from_numpy(a).to(dev) for a in data.batch(0, cfg.batch))
    steps = {}
    for path in ("auto", "ref"):
        params, bn = tp.init_params(cfg, torch.Generator().manual_seed(seed), dev)
        opt = tp.make_optimizer(cfg)
        st = opt.init(params)
        step = tp.make_train_step(cfg, opt, kernel_path=path)
        gen = torch.Generator(device=dev).manual_seed(seed)
        call = (lambda step=step, params=params, bn=bn, st=st:
                step(params, bn, st, x, y, gen))
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(TRAIN_TIMED):
            call()
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
        ms = start.elapsed_time(end) / TRAIN_TIMED
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        tr = trace(call)
        steps[path] = {"ms": ms, "host_wall_ms": wall,
                       "images_per_s": cfg.batch / ms * 1e3,
                       "peak_bytes": peak, "trace": tr}
        share = tr["busy_ms"] / tr["wall_ms"] if tr["wall_ms"] else 0.0
        print(f"train step {cfg.name} batch {cfg.batch} on {path} on {card}: "
              f"{ms:.3f} ms per step by CUDA events over {TRAIN_TIMED} steps "
              f"(host wall {wall:.3f}), {cfg.batch / ms * 1e3:.1f} images/s; "
              f"peak memory {peak / 1e9:.3f} GB; one profiled step: wall "
              f"{tr['wall_ms']:.3f} ms, device busy {tr['busy_ms']:.3f} ms "
              f"({share:.3f}), {tr['launches']} kernel launches; top kernels:")
        for kname, cnt, kms in tr["top"]:
            print(f"    {kms:9.4f} ms  x{cnt:<3d} {kname}")
    return rows, steps


def train_phase(seed, dev, card, dev_gen):
    """Phase 8: kernel 4 against its plain version, the routes against each
    other at full width, a CPU step against the card's, bnn-mnist on the
    card, convergence, times. Returns (max error, main-path launches,
    per-shape rows, report); the launches are kernel 4's on the main path,
    the auto route's TRAIN_STEPS steps."""
    from repro_torch.configs.bnn_paper import BNN_CIFAR10, BNN_MNIST
    from repro_torch.train import paper as tp
    t0 = time.perf_counter()
    cfg = BNN_CIFAR10
    shapes = train_conv_shapes(cfg) + list(RAGGED) + [(17, 1, 10), (130, 33, 129)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = mxu_kernel_checks(dev_gen, shapes + MXU_REGIMES, sms)
    launches, route_launches = train_routes_check(cfg, seed, dev)
    train_cpu_check(cfg, seed, dev)
    mnist = tp.train(BNN_MNIST, TRAIN_STEPS, seed=seed, device=dev)
    if not all(np.isfinite(mnist)):
        raise AssertionError(f"bnn-mnist losses {mnist}")
    print(f"train {BNN_MNIST.name}: full width, batch {BNN_MNIST.batch}, "
          f"{TRAIN_STEPS} steps on the card, losses {mnist}")
    trained = {}
    make_step = tp.make_train_step

    def kept_step(*a, **kw):       # the same step; its last params kept
        step = make_step(*a, **kw)

        def run(*args):
            out = step(*args)
            trained["params"] = out[0]
            return out
        return run
    with unittest.mock.patch.object(tp, "make_train_step", kept_step):
        losses = tp.train(cfg, CONVERGE_STEPS, seed=seed, device=dev)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"train convergence: {cfg.name} on SyntheticImages (img {cfg.img}, "
          f"{cfg.in_ch} channels, noise {tp.DATA_NOISE}), {CONVERGE_STEPS} "
          f"steps, losses {[round(v, 3) for v in losses]}; mean of the first "
          f"5 {first:.4f}, of the last 5 {last:.4f}")
    if not last < first:
        raise AssertionError("the training loss did not fall")
    rows, steps = train_times(cfg, seed, dev, card, dev_gen)
    print(f"phase 8 (train): {time.perf_counter() - t0:.1f} s")
    return err, launches.get(MXU, 0), rows, {"route_launches": route_launches,
                                 "mnist_losses": mnist,
                                 "converge_losses": losses, "steps": steps,
                                 "shapes": rows,
                                 "trained_convs": [
                                     c["w"].detach().cpu()
                                     for c in trained["params"]["convs"]]}


# ---------------------------------------------------------------------------
# The Mamba serving path: kernel 10 (selective_scan) and falcon-mamba-7b
# ---------------------------------------------------------------------------
def scan_case(gen, b, t, d, n, dev, h0=True, xi_dtype=torch.bfloat16):
    """Operands of one selective scan on the card, in the ranges the
    falcon-mamba path gives them: dt = softplus(normal - 4) (about 1e-3 to
    0.1, as softplus(dt_b) at init), A = -(1..N) on every channel (S4D-real
    init), xi normal, B and C integer dots of +-1 vectors of length 8192
    (x_proj's), h0 normal."""
    import torch.nn.functional as F
    dt = F.softplus(torch.randn(b, t, d, generator=gen, device=dev) - 4.0)
    xi = torch.randn(b, t, d, generator=gen, device=dev).to(xi_dtype)
    bm, cm = (torch.round(torch.randn(b, t, n, generator=gen, device=dev)
                          * 90.0) for _ in range(2))
    am = -torch.arange(1, n + 1, dtype=torch.float32, device=dev) \
        .expand(d, n).contiguous()
    h = torch.randn(b, d, n, generator=gen, device=dev) if h0 else None
    return dt, xi, bm, cm, am, h


def scan_kernel_checks(dev_gen, dev, di, n_state):
    """Kernel 10 against its plain version on the card (both take CUDA's
    double exp), tolerance 0: the decode step (4, 1, di, N) from a state,
    the prefill chunk (1, 32, di, N) with and without one, a long prefill
    (1, 4096, di, N), ragged shapes (D di + 8, N 2 / 4 / 16, T 1 / 7 / 33)
    with float32 and bf16 xi; two chained launches against one over the
    concatenation, and dt = 0 pads leaving h bit for bit. Returns the
    largest error (0)."""
    from repro_torch.kernels import selective_scan as ss
    cases = [((LM_SLOTS, 1, di, n_state), True, torch.bfloat16, "decode"),
             ((1, LM_CHUNK, di, n_state), True, torch.bfloat16, "chunk"),
             ((1, LM_CHUNK, di, n_state), False, torch.bfloat16,
              "first chunk"),
             ((1, SSM_LONG, di, n_state), False, torch.bfloat16,
              "long prefill")]
    for n in (2, 4, 16):
        for t in (1, 7, 33):
            for xd in (torch.float32, torch.bfloat16):
                cases.append(((2, t, di + 8, n), t != 7, xd, "ragged"))
    err = 0.0
    for (b, t, d, n), with_h0, xd, where in cases:
        ops = scan_case(dev_gen, b, t, d, n, dev, with_h0, xd)
        got = ss.selective_scan(*ops)
        torch.cuda.synchronize()
        want = ss.selective_scan_plain(*ops)
        torch.cuda.synchronize()
        e = max(float((g - w).abs().max()) for g, w in zip(got, want))
        err = max(err, e)
        print(f"check {SCAN} {where:12s} B={b} T={t:4d} D={d} N={n:2d} xi "
              f"{str(xd)[6:]:8s} h0 {with_h0!s:5s} max_abs_err={e}")
        if e:
            raise AssertionError(f"{SCAN} {where} ({b},{t},{d},{n}) differs "
                                 f"from its plain version by {e}")
        del ops, got, want
    dt, xi, bm, cm, am, h0 = scan_case(dev_gen, 2, 100, di + 8, n_state, dev)
    y, h = ss.selective_scan(dt, xi, bm, cm, am, h0)
    cut = 37

    def part(s, h_in):
        return ss.selective_scan(dt[:, s].contiguous(), xi[:, s].contiguous(),
                                 bm[:, s].contiguous(), cm[:, s].contiguous(),
                                 am, h_in)
    y1, h1 = part(slice(0, cut), h0)
    y2, h2 = part(slice(cut, 100), h1)
    check_equal(f"{SCAN}: chained y", torch.cat([y1, y2], dim=1), y)
    check_equal(f"{SCAN}: chained h", h2, h)
    dt_pad = dt.clone()
    dt_pad[:, cut:] = 0.0
    _, hp = ss.selective_scan(dt_pad, xi, bm, cm, am, h0)
    check_equal(f"{SCAN}: dt = 0 pads", hp, h1)
    print(f"check {SCAN}: two chained launches (37 + 63 steps) equal one "
          f"over 100, y and h bit for bit; 63 dt = 0 pads leave h as after "
          f"step 37, bit for bit")
    return err


def ssm_engine(cfg, params, **kw):
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                         **{"prefill_chunk": LM_CHUNK, **kw})


def ssm_engine_check(base_cfg, seed, dev):
    """falcon-mamba-7b at full width, depth SSM_CHECK_DEPTH, frozen, on the
    LM phase's traffic through the kernels and through the plain versions:
    all greedy tokens equal; kernel 10 launched once per layer in every
    prefill chunk and decode step, kernel 2 three times (in_proj, x_proj,
    out_proj with a bf16 lhs), no other kernel. Returns the launch counts
    of the kernel run (the main path) and its chunk and decode-step
    counts."""
    from repro_torch.serving.engine import Request
    from repro_torch.models.api import get_model
    cfg = base_cfg.scaled(n_layers=SSM_CHECK_DEPTH)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    masters = get_model(cfg).init(gen, device=dev)
    eng = ssm_engine(cfg, masters, freeze=True, seed=seed)
    frozen = eng.params
    del masters
    torch.cuda.empty_cache()
    plain = ssm_engine(cfg, frozen, kernel_path="ref", seed=seed)
    prompts = lm_traffic(seed, cfg.vocab)
    alone = eng.generate([Request(prompts[5], max_new_tokens=LM_NEW)])[0]
    eos = int(alone[7])          # request 5 stops at its own 8th token
    reqs = [Request(p, max_new_tokens=LM_NEW, eos_id=eos if i == 5 else None)
            for i, p in enumerate(prompts)]
    sched = eng.scheduler()
    steps0 = sched.stats["decode_steps"]
    reset_all_launches()
    got = eng.generate(reqs)
    torch.cuda.synchronize()
    launches = all_launches()
    steps = sched.stats["decode_steps"] - steps0
    want = plain.generate(reqs)
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"{SSM_ARCH} request {i}: kernel tokens "
                                 f"{a.tolist()} != plain {b.tolist()}")
    if got[5][-1] != eos or len(got[5]) > 8:
        raise AssertionError(f"request 5 did not stop at eos {eos}: {got[5]}")
    if any(len(t) != LM_NEW for i, t in enumerate(got) if i != 5):
        raise AssertionError("a request did not get its budget")
    n_chunks = sum(-(-len(p) // LM_CHUNK) for p in prompts)
    calls = SSM_CHECK_DEPTH * (n_chunks + steps)
    want_launches = {kn: 0 for kn in launches}
    want_launches.update({SCAN: calls, "binary_gemm_packed_rhs": 3 * calls})
    if launches != want_launches:
        raise AssertionError(f"{SSM_ARCH} launches {launches} != "
                             f"{want_launches} ({SSM_CHECK_DEPTH} layers x "
                             f"({n_chunks} chunks + {steps} decode steps))")
    # whole-prompt admission (the JAX default): each prompt is one launch
    # of kernel 10 per layer at T = S
    whole = ssm_engine(cfg, frozen, seed=seed, prefill_chunk=None)
    wsched = whole.scheduler()
    reset_all_launches()
    got_whole = whole.generate(reqs)
    torch.cuda.synchronize()
    whole_launches = all_launches()
    wsteps = wsched.stats["decode_steps"]
    want_whole = ssm_engine(cfg, frozen, kernel_path="ref", seed=seed,
                            prefill_chunk=None).generate(reqs)
    for i, (a, b) in enumerate(zip(got_whole, want_whole, strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"{SSM_ARCH} whole-prompt request {i}: "
                                 f"kernel tokens {a.tolist()} != plain "
                                 f"{b.tolist()}")
    wcalls = SSM_CHECK_DEPTH * (len(prompts) + wsteps)
    if whole_launches[SCAN] != wcalls:
        raise AssertionError(f"{SSM_ARCH} whole-prompt {SCAN} launches "
                             f"{whole_launches[SCAN]} != {SSM_CHECK_DEPTH} "
                             f"layers x ({len(prompts)} prompts + {wsteps} "
                             f"decode steps)")
    same = sum(np.array_equal(a, b) for a, b in zip(got_whole, got))
    print(f"ssm whole-prompt check: tokens through the kernels equal the "
          f"plain path's; {SCAN} launches {whole_launches[SCAN]} = "
          f"{SSM_CHECK_DEPTH} layers x ({len(prompts)} prompts at T = S + "
          f"{wsteps} decode steps); whole-prompt against chunked tokens "
          f"(a figure): {same} of {len(got)} requests equal")
    del whole
    print(f"ssm engine check: {SSM_ARCH} full width (d_model {cfg.d_model}, "
          f"d_inner {cfg.expand * cfg.d_model}, N {cfg.ssm_state}), "
          f"depth {SSM_CHECK_DEPTH} (cut from {base_cfg.n_layers}), "
          f"{LM_REQUESTS} requests, prompts {sorted(len(p) for p in prompts)}, "
          f"{LM_NEW} new tokens, request 5 stops at eos {eos} after "
          f"{len(got[5])}: tokens equal the plain path's; {SCAN} launches "
          f"{launches[SCAN]} = {SSM_CHECK_DEPTH} layers x ({n_chunks} chunks + "
          f"{steps} decode steps); launches {launches}")
    del eng, plain, frozen
    torch.cuda.empty_cache()
    return launches, n_chunks, steps, whole_launches


def ssm_timed_run(base_cfg, seed, dev, card):
    """All 64 layers, drawn and frozen one layer at a time, on the same
    traffic, timed: decode tokens/s, TTFT, ITL, resident weight bytes
    (binary vs other; the binary layers against their fp32 masters), state
    bytes, peak device memory, and one profiled decode step."""
    from repro_torch.models.api import get_model
    cfg = base_cfg
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    frozen = get_model(cfg).init_frozen(gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ssm_engine(cfg, frozen, freeze=True, seed=seed)
    del frozen
    rep, _, sched = serve_report(eng, lm_traffic(seed, cfg.vocab), LM_NEW)
    w = eng.resident_weight_bytes()
    c = eng.resident_cache_bytes()
    d, n, r = cfg.d_model, cfg.ssm_state, cfg.dt_rank
    di = cfg.expand * d
    master_binary = 4 * cfg.n_layers * (d * 2 * di + di * (r + 2 * n)
                                        + di * d)
    rep.update({
        "depth": cfg.n_layers, "init_frozen_s": init_s,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "binary_bytes": w["binary"], "other_bytes": w["other"],
        "binary_master_bytes": master_binary,
        "state_bytes": c["total"]})
    if master_binary != 32 * w["binary"]:
        raise AssertionError(f"binary layers {w['binary']} B are not 1/32 of "
                             f"their fp32 masters {master_binary} B")
    print(f"ssm timed run on {card}: {SSM_ARCH} full width and depth "
          f"({cfg.n_layers} layers, not cut; drawn and frozen layer by layer "
          f"in {init_s:.1f} s), {LM_REQUESTS} requests, {LM_SLOTS} slots, "
          f"chunk {LM_CHUNK}, max_len {LM_MAX_LEN}; peak device memory "
          f"{rep['peak_device_bytes'] / 1e9:.3f} GB")
    print_serve_report(rep)
    print(f"  resident weights: binary {w['binary'] / 1e9:.4f} GB (in_proj, "
          f"x_proj, out_proj; fp32 masters {master_binary / 1e9:.3f} GB, "
          f"32x), other {w['other'] / 1e9:.4f} GB (embed fp32, head bf16, "
          f"dt_w, A_log, D, conv taps, norms); state {c['total'] / 1e6:.3f} "
          f"MB for {LM_SLOTS} slots (conv + h, float)")
    pos = torch.full((LM_SLOTS,), 300, dtype=torch.int32, device=dev)
    step = trace(lambda: sched.model.decode(sched.params, sched._state["cur"],
                                            sched._cache, pos))
    print_trace(f"trace ssm decode step (depth {cfg.n_layers}, {LM_SLOTS} "
                f"slots) on {card}", step)
    rep["decode_step_trace"] = step
    del eng, sched
    torch.cuda.empty_cache()
    return rep


def scan_bound(b, t, d, n, h0, xi_bytes, exp_per_s, fp64_per_s):
    """Least time of one scan: the bytes it must move (dt, xi, B, C, A, h0
    read once; y, h_final written once) over HBM rate, and its B*T*D*N exps
    over the card's exp rate (16 per clock per SM). Beside it the floor of
    the exact design, `fp64_ms`: each exp a float64 exp (FP64_OPS_PER_EXP
    float64 instructions) on the card's float64 lanes."""
    from repro_torch.kernels import tune
    from repro_torch.kernels.selective_scan import scan_cost
    cost = scan_cost(b, t, d, n, h0, xi_bytes)
    t_bytes = cost["bytes"] / tune.HBM_BYTES_PER_S * 1e3
    t_ops = cost["exps"] / exp_per_s * 1e3
    return {"bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "fp64_ms": cost["exps"] * FP64_OPS_PER_EXP / fp64_per_s * 1e3}


def scan_kernel_times(dev_gen, dev, card, exp_per_s, fp64_per_s, di, n):
    """Kernel 10 at the decode step, the prefill chunk and a long prefill
    (bf16 xi, as the path gives it): device ms, wrapper ms, plain ms, bound.
    No single PyTorch call computes a selective scan: library none. Returns
    the rows and the sums over one layer's launches in one decode step and
    one prefill chunk."""
    from repro_torch.kernels import selective_scan as ss
    rows = []
    print(f"{SCAN} times on {card} (ms; kernel: device_ms; wrapper and plain:"
          f" CUDA events; bound = max(bytes / 3.35 TB/s, exps / "
          f"{exp_per_s / 1e12:.3f} T/s); float64-exp floor = exps x "
          f"{FP64_OPS_PER_EXP} / {fp64_per_s / 1e12:.3f} T FP64/s; no library "
          f"call computes it)")
    for (b, t), with_h0, where, per_layer in (
            ((LM_SLOTS, 1), True, "decode", 1), ((1, LM_CHUNK), True,
                                                  "chunk", 1),
            ((1, SSM_LONG), False, "long prefill", 0)):
        ops = scan_case(dev_gen, b, t, di, n, dev, with_h0)
        row = {"kernel": SCAN, "where": where, "shape": (b, t, di, n),
               "per_layer": per_layer, "library": None,
               **shape_times(lambda ops=ops: ss.selective_scan(*ops), SCAN,
                             lambda ops=ops: ss.selective_scan_plain(*ops)),
               **scan_bound(b, t, di, n, with_h0, 2, exp_per_s, fp64_per_s)}
        rows.append(row)
        print(f"  {SCAN} {where:12s} B={b} T={t:4d} D={di} N={n} kernel "
              f"{row['ms']:.4f} (wrapper {row['wrapper_ms']:.4f})  plain "
              f"{row['plain_ms']:.3f}  bound {row['bound_ms']:.5f} "
              f"({'bytes' if row['bytes_ms'] >= row['ops_ms'] else 'exps'})"
              f"  float64-exp floor {row['fp64_ms']:.5f}")
        del ops
    total = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
             "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": None,
             "library_wall_ms": None}
    for r in rows:
        for key in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bytes_ms",
                    "ops_ms"):
            total[key] += r[key] * r["per_layer"]
    return rows, total


def ssm_phase(seed, dev, card, dev_gen, exp_per_s, fp64_per_s):
    """Phase 9: kernel 10 against its plain version, falcon-mamba-7b at full
    width and depth 2 through the kernels and the plain versions (chunked
    and whole-prompt admission), kernel 10's times, the 64-layer timed
    run. Returns (max error, the two main paths' launches summed, kernel-10
    total, report)."""
    from repro_torch.configs.base import get_config
    t0 = time.perf_counter()
    cfg = get_config(SSM_ARCH)
    di, n = cfg.expand * cfg.d_model, cfg.ssm_state
    err = scan_kernel_checks(dev_gen, dev, di, n)
    launches, n_chunks, steps, whole = ssm_engine_check(cfg, seed, dev)
    rows, total = scan_kernel_times(dev_gen, dev, card, exp_per_s,
                                    fp64_per_s, di, n)
    timed = ssm_timed_run(cfg, seed, dev, card)
    print(f"phase 9 (ssm): {time.perf_counter() - t0:.1f} s")
    both = {kn: launches[kn] + whole[kn] for kn in launches}
    return err, both, total, {"launches": launches, "chunks": n_chunks,
                              "decode_steps": steps,
                              "whole_prompt_launches": whole, "shapes": rows,
                              "timed": timed}


# ---------------------------------------------------------------------------
# The hybrid serving path: recurrentgemma-2b (RG-LRU + local attention over a
# ring), through kernels 1, 2, 5 and 6
# ---------------------------------------------------------------------------
def hybrid_gemms(cfg):
    """The hybrid's popcount GEMMs (kernel, lhs, K, N, what): q, k and v
    after the attention layer's shared pack and the MLP's gate and up after
    its shared pack (packed lhs); the RG-LRU's w_x, w_gate and w_out and
    attention's wo (2560 -> 2560) and the MLP's w_down (bf16 lhs)."""
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    w = cfg.lru_width or d
    return [("binary_gemm_packed", "packed", d, cfg.n_heads * hd, "rg.q"),
            ("binary_gemm_packed", "packed", d, cfg.n_kv_heads * hd, "rg.kv"),
            ("binary_gemm_packed", "packed", d, f, "rg.gate"),
            ("binary_gemm_packed_rhs", "bf16", d, w, "rg.w_x"),
            ("binary_gemm_packed_rhs", "bf16", f, d, "rg.down")]


def hybrid_pack_check_shapes(cfg):
    """(M, K) of the hybrid's shared sign-packs (an attention layer's Q/K/V
    input, either layer's gate/up input): the normed residual, K = d_model,
    at a decode step, a chunk, a 200-token prompt and the whole prompt of
    HYBRID_WRAP that passes the ring."""
    d = cfg.d_model
    return [(LM_SLOTS, d, "rg.decode"), (LM_CHUNK, d, "rg.chunk"),
            (200, d, "rg.prompt"), (HYBRID_WRAP[0], d, "rg.wrap")]


def hybrid_pack_rows_cases(cfg):
    """Kernel 5's `pack_rows_into` at the hybrid's ring (as
    `pack_rows_cases`): hd-256 K|V rows into the (B*W, 1, 8) view of a
    4-slot ring at decode (slots wrapped by t % W, inactive rows -1), a
    chunk's 32 rows after the slot's ring (the [ring | chunk] buffer the
    chunk attends over), and whole prompts: 200 rows into slot 2's ring and
    a 3,000-token prompt's last 2,048 positions, wrapped."""
    hkv, hd, wnd = cfg.n_kv_heads, cfg.head_dim, cfg.local_window
    ring = ("contiguous", LM_SLOTS, wnd)
    return [
        ("ring decode, wrapped slots, rows 1 inactive", LM_SLOTS, hkv, hd,
         ring, [wnd - 1, -1, 2 * wnd + 5000 % wnd, 3 * wnd]),
        ("chunk of 32 after the ring", LM_CHUNK, hkv, hd,
         ("contiguous", 1, wnd + LM_CHUNK), [wnd + i for i in range(LM_CHUNK)]),
        ("whole prompt of 200 into slot 2's ring", 200, hkv, hd, ring,
         [2 * wnd + i for i in range(200)]),
        ("whole prompt of 3000: its last 2048 positions", wnd, hkv, hd, ring,
         [wnd + t % wnd for t in range(3000 - wnd, 3000)])]


def hybrid_kernel_checks(cfg, dev_gen, dev, sms):
    """Kernel 6 at the hybrid's ring shape (B 4, T 2048, one KV head, G 10,
    hd 256: a decode step's 10 query rows take the wide body), cache
    lengths 0, 1, 17, 2,047 and 2,048, float32 and bf16 q, against its
    plain version: dots at every position equal, outputs within ATTN_TOL
    with equal signs, cache_len 0 rows exactly 0, the call with dots equal
    to the call without, one launch a call. Returns the largest error."""
    _, _, da, pa, _ = lm_modules()
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    t = cfg.local_window
    plan = pa.attention_plan(LM_SLOTS, 1, t, hkv, g, hd, sms)
    body = "narrow" if plan.bq * g <= pa._NARROW_ROWS else "wide"
    err = 0.0
    for lens in ((t, t - 1, 17, 1), (0, t, 1, 17)):
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, vs = attention_case(dev_gen, LM_SLOTS, 1, t, hkv, g, hd,
                                         dtype, dev)
            before = da.launches["decode_attention_packed"]
            got, dots = da.decode_attention_packed(q, k, v, vs, kv,
                                                   return_dots=True)
            served = da.decode_attention_packed(q, k, v, vs, kv)
            torch.cuda.synchronize()
            if da.launches["decode_attention_packed"] - before != 2:
                raise AssertionError("hybrid ring decode: not one launch a "
                                     "call")
            want, wdots = da.decode_attention_packed_plain(
                q, k, v, vs, kv, return_dots=True)
            what = f"hybrid ring decode lens {list(lens)} {dtype}"
            if not torch.equal(dots, wdots):
                raise AssertionError(f"{what}: dots differ")
            if not torch.equal(served, got):
                raise AssertionError(f"{what}: the call without dots differs")
            flat = kv == 0
            if not (torch.equal(got[flat], want[flat])
                    and (got[flat] != 0).any() | ~flat.any()):
                raise AssertionError(f"{what}: a cache_len 0 row differs from "
                                     "the plain version's whole-row mean")
            e = check_close(what, got, want, dtype)
            err = max(err, e)
            print(f"check decode_attention_packed {str(dtype)[6:]:8s} hybrid "
                  f"ring B={LM_SLOTS} T={t} Hkv={hkv} G={g} hd={hd} lens "
                  f"{list(lens)} ({body} body, bq {plan.bq}, split "
                  f"{plan.split}, {plan.blocks} blocks): dots equal, "
                  f"max_abs_err={e:.3g}")
    return err


def hybrid_ring_decode_times(cfg, dev_gen, dev, popc_per_s):
    """Kernel 6 on 4 slots' decode step over full rings (B 4, T 2048, G 10,
    hd 256, bf16 q), as `shape_times`, beside SDPA over the unpacked +-1
    K/V and the bound. Not in the kernels line."""
    from repro_torch.kernels import ref
    _, _, da, _, _ = lm_modules()
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    t = cfg.local_window
    q, k, v, vs = attention_case(dev_gen, LM_SLOTS, 1, t, hkv, g, hd,
                                 torch.bfloat16, dev)
    kv = torch.full((LM_SLOTS,), t, dtype=torch.int32, device=dev)
    valid = ref.chunk_valid_mask(LM_SLOTS, 1, t, kv, kv - 1, 0, True,
                                 device=dev)
    lib = sdpa_call(q, k, v, vs, valid)
    kn = "decode_attention_packed"
    check_close_loose("SDPA vs kernel 6 on the hybrid ring", lib(),
                      da.decode_attention_packed(q, k, v, vs, kv))
    return [{"kernel": kn, "where": f"ring B={LM_SLOTS} T={t} G={g} hd={hd}",
             "library": "F.scaled_dot_product_attention",
             **shape_times(lambda: da.decode_attention_packed(q, k, v, vs, kv),
                           kn, lambda: da.decode_attention_packed_plain(
                               q, k, v, vs, kv), lib),
             **attention_bound(valid, 1, cfg.n_heads, hkv, hd, 2,
                               popc_per_s)}]


def hybrid_traffic(seed, vocab):
    """Phase 6's prompts and budgets, plus one request (HYBRID_WRAP) whose
    prompt passes the ring's positions."""
    prompts = lm_traffic(seed, vocab)
    rng = np.random.default_rng(seed + 11)
    prompts.append(rng.integers(0, vocab, HYBRID_WRAP[0]).astype(np.int32))
    return prompts, [LM_NEW] * LM_REQUESTS + [HYBRID_WRAP[1]]


def hybrid_engine(cfg, params, **kw):
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(cfg, params, slots=LM_SLOTS,
                         max_len=HYBRID_MAX_LEN, **kw)


def hybrid_per_call(cfg) -> dict:
    """Launches of kernels 1, 2 and 5 per forward call (a prefill chunk, a
    whole prompt or a decode step) of the hybrid: a rec layer launches
    kernel 2 four times (w_x, w_gate, w_out, w_down), kernel 1 twice (gate,
    up) and kernel 5 once (the MLP's shared pack); an attention layer kernel
    1 five times (q, k, v, gate, up), kernel 2 twice (wo, w_down) and kernel
    5 three times at kv_bits=1 (the Q/K/V and MLP shared packs, the K|V
    rows into the ring) or twice at kv_bits=0. Kernel 6 runs once per
    attention layer and decode step at kv_bits=1 (`hybrid_attn_layers`)."""
    n_attn, n_rec = hybrid_layers(cfg)
    return {"binary_gemm_packed_rhs": 4 * n_rec + 2 * n_attn,
            "binary_gemm_packed": 2 * n_rec + 5 * n_attn,
            "pack_bits": n_rec + (3 if cfg.kv_bits == 1 else 2) * n_attn}


def hybrid_layers(cfg) -> tuple[int, int]:
    """(attention layers, rec layers) of the hybrid config."""
    from repro_torch.models import ssm_lm as L
    g, tail = L.rg_layout(cfg)
    return g, cfg.n_layers - g


def hybrid_first_difference(cfg, frozen, prompt, tokens, chunked, dev):
    """Replay one request alone through the kernels and the plain versions
    (its prompt in chunks or whole, then decode steps fed the kernel path's
    tokens) and return the first state element that differs after a call:
    (call, leaf, index, and for ring words the sign bit), or None."""
    from repro_torch.models import ssm_lm as L
    states = {p: L.rg_init_state(cfg, 1, device=dev) for p in ("auto", "ref")}

    def diff(step):
        for name, a in states["auto"].items():
            b = states["ref"][name]
            x = (a ^ b) if a.dtype == torch.int32 else (a != b)
            if x.any():
                idx = tuple(int(i) for i in x.nonzero()[0])
                if a.dtype != torch.int32:
                    return (step, name, idx)
                w = int(x[idx]) & 0xFFFFFFFF
                return (step, name, idx,
                        f"bit {32 * idx[-1] + (w & -w).bit_length() - 1}")
        return None

    ids = torch.from_numpy(prompt.astype(np.int64)).to(dev)[None]
    if chunked:
        for lo in range(0, len(prompt), LM_CHUNK):
            nv = min(LM_CHUNK, len(prompt) - lo)
            ch = torch.zeros((1, LM_CHUNK), dtype=torch.int64, device=dev)
            ch[0, :nv] = ids[0, lo:lo + nv]
            for path in states:
                L.rg_prefill_chunk(frozen, cfg, ch, states[path], 0, lo, nv,
                                   path=path)
            found = diff(f"chunk at {lo}")
            if found:
                return found
    else:
        for path in states:
            L.rg_prefill(frozen, cfg, ids, cache=states[path], path=path)
        found = diff("whole prompt")
        if found:
            return found
    for i, tok in enumerate(tokens[:-1]):
        token = torch.tensor([int(tok)], device=dev)
        pos = torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev)
        for path in states:
            L.rg_decode(frozen, cfg, token, states[path], pos, path=path)
        found = diff(f"decode step {i + 1}")
        if found:
            return found
    return None


def hybrid_engine_check(base_cfg, seed, dev):
    """recurrentgemma-2b at full width, depth HYBRID_CHECK_DEPTH, frozen, on
    `hybrid_traffic` through four engines: chunked at kv_bits=1 (the main
    path), the default engine `ServingEngine(cfg, params, freeze=True)`
    (whole prompt, float ring), whole prompt at kv_bits=1 and chunked at
    kv_bits=0. In each, greedy tokens through the kernels equal the plain
    versions' (on a difference, the first differing state element), every
    request gets its budget, and the launches of kernels 1, 2, 5 and 6 are
    `hybrid_per_call` per forward call and kernel 6 once per attention
    layer and decode step at kv_bits=1; one direct decode step too. Then
    generate_static (default engine and kv_bits=1) through the kernels
    against the plain versions. Whole prompt against chunked is printed,
    not held. Returns the main path's and the default engine's launch
    counts, and a report."""
    from repro_torch.models import ssm_lm as L
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request
    cfg = base_cfg.scaled(n_layers=HYBRID_CHECK_DEPTH)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    frozen = get_model(cfg).init_frozen(gen, device=dev)
    n_attn, n_rec = hybrid_layers(cfg)
    prompts, budgets = hybrid_traffic(seed, cfg.vocab)
    reqs = [Request(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    variants = {"chunked, kv_bits=1": dict(kv_bits=1, prefill_chunk=LM_CHUNK),
                "default (kv_bits=0, whole prompt)": {},
                "kv_bits=1, whole prompt": dict(kv_bits=1),
                "kv_bits=0, chunked": dict(prefill_chunk=LM_CHUNK)}
    tokens, counted, rep = {}, {}, {}
    for name, kw in variants.items():
        eng = hybrid_engine(cfg, frozen, freeze=True, seed=seed, **kw)
        ecfg = eng.cfg
        sched = eng.scheduler()
        reset_all_launches()
        got = eng.generate(reqs)
        torch.cuda.synchronize()
        counts = all_launches()
        steps = sched.stats["decode_steps"]
        want = hybrid_engine(cfg, frozen, kernel_path="ref", seed=seed,
                             **kw).generate(reqs)
        chunked = kw.get("prefill_chunk") is not None
        for i, (a, b) in enumerate(zip(got, want, strict=True)):
            if not np.array_equal(a, b):
                where = hybrid_first_difference(ecfg, frozen, prompts[i], a,
                                                chunked, dev)
                raise AssertionError(
                    f"hybrid, {name}, request {i}: kernel tokens {a.tolist()}"
                    f" != plain {b.tolist()}; first differing state element "
                    f"(call, leaf, index, bit): {where}")
        if [len(t) for t in got] != budgets:
            raise AssertionError(f"hybrid, {name}: a request did not get its "
                                 f"budget")
        calls = (sum(-(-len(p) // LM_CHUNK) for p in prompts) if chunked
                 else len(prompts)) + steps
        expect = {kn: 0 for kn in counts}
        expect.update({kn: n * calls
                       for kn, n in hybrid_per_call(ecfg).items()})
        if ecfg.kv_bits == 1:
            expect["decode_attention_packed"] = n_attn * steps
        if counts != expect:
            raise AssertionError(f"hybrid, {name}: launches {counts} != "
                                 f"{expect} ({calls} forward calls, {steps} "
                                 f"decode steps)")
        # one decode step called directly: the per-step launches
        reset_all_launches()
        pos = torch.full((LM_SLOTS,), 2100, dtype=torch.int32, device=dev)
        sched.model.decode(sched.params, sched._state["cur"], sched._cache,
                           pos)
        torch.cuda.synchronize()
        step = {kn: n for kn, n in all_launches().items() if n}
        tokens[name] = got
        counted[name] = counts
        rep[name] = {"launches": counts, "decode_steps": steps,
                     "forward_calls": calls, "decode_step_launches": step}
        print(f"hybrid engine check, {name}: tokens equal the plain path's; "
              f"{calls} forward calls ({steps} decode steps), launches "
              f"{ {kn: n for kn, n in counts.items() if n} }; one decode step "
              f"({n_rec} rec + {n_attn} attention layers): {step} "
              f"({sum(step.values())} launches)")
        del eng
    agree = {}
    for kv in (0, 1):
        whole = tokens["default (kv_bits=0, whole prompt)" if kv == 0
                       else "kv_bits=1, whole prompt"]
        chunk = tokens[f"{'chunked, kv_bits=1' if kv else 'kv_bits=0, chunked'}"]
        agree[kv] = [int(np.argmin(np.r_[a == b, False]))
                     for a, b in zip(whole, chunk)]
    rng = np.random.default_rng(seed + 12)
    static = [Request(rng.integers(0, cfg.vocab, 64).astype(np.int32),
                      max_new_tokens=n) for n in (LM_NEW, 8, 12, LM_NEW)]
    for kw in ({}, dict(kv_bits=1)):
        got = hybrid_engine(cfg, frozen, seed=seed, **kw) \
            .generate_static(static)
        want = hybrid_engine(cfg, frozen, kernel_path="ref", seed=seed,
                             **kw).generate_static(static)
        for i, (a, b) in enumerate(zip(got, want, strict=True)):
            if not np.array_equal(a, b):
                raise AssertionError(f"hybrid generate_static {kw} request "
                                     f"{i}: kernel tokens {a.tolist()} != "
                                     f"plain {b.tolist()}")
    print(f"hybrid engine check: {HYBRID_ARCH} full width (d {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV head of "
          f"{cfg.head_dim}, window {cfg.local_window}), depth "
          f"{HYBRID_CHECK_DEPTH} (cut from {base_cfg.n_layers}: {n_rec} rec + "
          f"{n_attn} attention layers), {len(reqs)} requests, prompts "
          f"{sorted(len(p) for p in prompts)}, budgets {budgets}; "
          f"generate_static on 4 prompts of 64 (float and packed ring) equals "
          f"the plain path's; whole prompt against chunked (a figure, not "
          f"held), leading tokens in common: kv_bits=0 {agree[0]}, kv_bits=1 "
          f"{agree[1]}")
    rep["leading_tokens_whole_vs_chunked"] = agree
    del frozen
    torch.cuda.empty_cache()
    return (counted["chunked, kv_bits=1"],
            counted["default (kv_bits=0, whole prompt)"], rep)


def hybrid_timed_run(base_cfg, seed, dev, card):
    """All 26 layers, drawn and frozen one layer at a time, on phase 6's
    traffic, through the chunked kv_bits=1 engine and the default engine:
    decode tokens/s, TTFT, ITL p50/p99, resident weight, ring and state
    bytes (packed ring against a bf16 one), peak device memory, and one
    profiled decode step (4 slots, cache_len 2,048: pos set to 2,100 on the
    state that phase 6's traffic left, so kernel 6 reads whole rings of
    which most rows are zero or stale) with its
    launches of the four kernels asserted, beside the device time of the
    float32 gate products of the 18 rec layers (two (4, 2560) x (2560,
    2560) matmuls each)."""
    from repro_torch.models.api import get_model
    from repro_torch.models import ssm_lm as L
    cfg = base_cfg
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    frozen = get_model(cfg).init_frozen(gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_attn, n_rec = hybrid_layers(cfg)
    prompts = lm_traffic(seed, cfg.vocab)
    w_wnd, hkv, hd = cfg.local_window, cfg.n_kv_heads, cfg.head_dim
    out = {"depth": cfg.n_layers, "init_frozen_s": init_s}
    tail = L.rg_layout(cfg)[1]
    gates = [L.pick(frozen["groups"]["rec"], gi, j)["mix"]
             for gi in range(n_attn) for j in range(L._n_rec(cfg))]
    gates += [L.pick(frozen["tail"], j)["mix"] for j in range(tail)]
    xf = torch.randn(LM_SLOTS, 1, cfg.lru_width, generator=gen, device=dev)

    def gate_products():
        for mix in gates:
            torch.matmul(xf, mix["w_input_gate"])
            torch.matmul(xf, mix["w_rec_gate"])
    # few calls: 36 matmuls a call, and CUDA's launch queue must not fill
    # behind the spin
    gates_ms = device_ms(gate_products, iters=3)
    gate_bytes = sum(m["w_input_gate"].numel() + m["w_rec_gate"].numel()
                     for m in gates) * 4
    for name, kw in (("chunked, kv_bits=1", dict(kv_bits=1,
                                                prefill_chunk=LM_CHUNK)),
                     ("default (kv_bits=0, whole prompt)", {})):
        eng = hybrid_engine(cfg, frozen, seed=seed, **kw)
        rep, _, sched = serve_report(eng, prompts, LM_NEW)
        w = eng.resident_weight_bytes()
        c = eng.resident_cache_bytes()
        cache = sched._cache
        ring = sum(cache[k].numel() * cache[k].element_size()
                   for k in ("attn_k", "attn_v"))
        state = sum(t.numel() * t.element_size() for k, t in cache.items()
                    if k not in ("attn_k", "attn_v"))
        bf16_ring = 2 * n_attn * LM_SLOTS * w_wnd * hkv * hd * 2
        pos = torch.full((LM_SLOTS,), 2100, dtype=torch.int32, device=dev)
        reset_all_launches()
        sched.model.decode(sched.params, sched._state["cur"], cache, pos)
        torch.cuda.synchronize()
        per_step = {kn: n for kn, n in all_launches().items() if n}
        expect = hybrid_per_call(eng.cfg)
        if eng.cfg.kv_bits == 1:
            expect["decode_attention_packed"] = n_attn
        if per_step != expect:
            raise AssertionError(f"hybrid 26-layer {name}: decode step "
                                 f"launches {per_step} != {expect}")
        step = trace(lambda: sched.model.decode(sched.params,
                                                sched._state["cur"], cache,
                                                pos))
        rep.update({
               "binary_bytes": w["binary"], "other_bytes": w["other"],
               "ring_bytes": ring, "bf16_ring_bytes": bf16_ring,
               "state_bytes": state, "cache_split": c,
               "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
               "decode_step_launches": per_step, "decode_step_trace": step,
               "float_gates_ms": gates_ms, "float_gates_bytes": gate_bytes})
        out[name] = rep
        print(f"hybrid timed run on {card}, {name}: {HYBRID_ARCH} full width "
              f"and depth ({cfg.n_layers} layers: {n_rec} rec + {n_attn} "
              f"attention, not cut; drawn and frozen layer by layer in "
              f"{init_s:.1f} s), {LM_REQUESTS} requests, {LM_SLOTS} slots; "
              f"peak device memory {rep['peak_device_bytes'] / 1e9:.2f} GB")
        print_serve_report(rep)
        print(f"  resident weights: binary {w['binary'] / 1e9:.4f} GB, other "
              f"{w['other'] / 1e9:.4f} GB (embed bf16 = the tied head, "
              f"float32 gates {gate_bytes / 1e9:.3f} GB, conv taps, norms); "
              f"ring {ring / 1e6:.3f} MB ({str(cache['attn_k'].dtype)[6:]}"
              f"; a bf16 ring {bf16_ring / 1e6:.3f} MB), rec state "
              f"{state / 1e6:.3f} MB for {LM_SLOTS} slots")
        print_trace(f"trace hybrid decode step ({name}, depth "
                    f"{cfg.n_layers}, {LM_SLOTS} slots, cache_len {w_wnd}: "
                    f"pos set to 2100 on the state phase 6's traffic left) "
                    f"on {card}", step,
                    f" ({sum(per_step.values())} of kernels 1, 2, 5, 6: "
                    f"{per_step}); the float32 gate products {gates_ms:.4f} "
                    f"ms device ({gate_bytes / 1e9:.3f} GB read)")
        del eng, sched, cache
        torch.cuda.empty_cache()
    del frozen, gates
    torch.cuda.empty_cache()
    return out


def hybrid_phase(seed, dev, card, dev_gen, popc_per_s):
    """Phase 10: recurrentgemma-2b at full width and depth 5 through the
    kernels and the plain versions (four engines), kernel 6 at the ring
    shape timed, the 26-layer timed run. Returns (the main path's and the
    default engine's launches summed, report)."""
    from repro_torch.configs.base import get_config
    t0 = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    main_launches, default_launches, rep = hybrid_engine_check(cfg, seed, dev)
    rows = hybrid_ring_decode_times(cfg, dev_gen, dev, popc_per_s)
    print_attention_rows(f"hybrid ring decode times on {card} (ms, as phase "
                         f"7; not in the kernels line):", rows, 32)
    timed = hybrid_timed_run(cfg, seed, dev, card)
    print(f"phase 10 (hybrid): {time.perf_counter() - t0:.1f} s")
    both = {kn: main_launches[kn] + default_launches[kn]
            for kn in main_launches}
    return both, {"check": rep, "ring_decode": rows, "timed": timed}


# ---------------------------------------------------------------------------
# The other dense-stack families: deepseek-67b, qwen2-72b (QKV bias),
# nemotron-4-15b (LayerNorm; the sq_relu FFN bit-resident through kernel 3)
# and musicgen-large (sinusoidal positions, GELU, MHA at hd 64)
# ---------------------------------------------------------------------------
def family_gemms(cfg):
    """One layer's popcount GEMMs (kernel, lhs, K, N, what): q, k and v
    after the shared pack (packed lhs), wo (bf16); the FFN: GLU gate and up
    after their shared pack (packed) and w_down (bf16); sq_relu's w_up
    through kernel 3 on the bf16 normed residual and w_down on its words
    (packed); gelu's w_up and w_down (bf16)."""
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    rows = [("binary_gemm_packed", "packed", d, cfg.n_heads * hd, "q"),
            ("binary_gemm_packed", "packed", d, cfg.n_kv_heads * hd, "kv"),
            ("binary_gemm_packed_rhs", "bf16", cfg.n_heads * hd, d, "wo")]
    if cfg.mlp in ("swiglu", "geglu"):
        rows += [("binary_gemm_packed", "packed", d, f, "gate"),
                 ("binary_gemm_packed_rhs", "bf16", f, d, "down")]
    elif cfg.mlp == "sq_relu":
        rows += [("binary_gemm_fused", "bf16", d, f, "up"),
                 ("binary_gemm_packed", "packed", f, d, "down")]
    else:
        rows += [("binary_gemm_packed_rhs", "bf16", d, f, "up"),
                 ("binary_gemm_packed_rhs", "bf16", f, d, "down")]
    short = cfg.name.split("-")[0]
    return [(kn, lhs, k, n, f"{short}.{what}") for kn, lhs, k, n, what in rows]


def family_gemm_checks(cfgs):
    """(kernel, lhs, M, K, N, where) of every family's GEMMs at FAMILY_ROWS
    rows, each distinct shape once, for phase 3's check loop."""
    seen, checks = set(), []
    for cfg in cfgs:
        for kn, lhs, k, n, what in family_gemms(cfg):
            for m in FAMILY_ROWS:
                if (kn, lhs, m, k, n) not in seen:
                    seen.add((kn, lhs, m, k, n))
                    checks.append((kn, lhs, m, k, n, what))
    return checks


def fused_lm_checks(cfg, dev_gen, dev):
    """Kernel 3 at nemotron-4-15b's up-projection (K d_model, N d_ff) at
    FAMILY_ROWS rows, bf16 and float32 lhs: with the act:sq_relu fold
    (ALWAYS_THRESH, no flip: every word all ones) and with thresholds
    within sqrt(K) of 0 and flips, against its plain version, bit for bit;
    the dots of each case take both signs. Then kernel 1 on those words as
    w_down's lhs (K d_ff, N d_model) against its plain version. One launch
    a call. Returns the largest error of kernels 3 and 1 (0)."""
    from repro_torch.core.packed import ALWAYS_THRESH
    bg, _, _, _, _ = lm_modules()
    k, n = cfg.d_model, cfg.d_ff
    always = torch.full((n,), ALWAYS_THRESH, dtype=torch.int32, device=dev)
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    down = Operands(dev_gen, 1, n, k).b                  # (d_model, d_ff/32)
    for m in FAMILY_ROWS:
        op = Operands(dev_gen, m, k, n)
        dots = op.call("binary_gemm_packed", "packed")
        if not ((dots > 0).any() and (dots < 0).any()):
            raise AssertionError(f"kernel 3 at ({m},{k},{n}): the dots do "
                                 f"not take both signs")
        for lhs in ("bf16", "float"):
            a = op.x_bf16 if lhs == "bf16" else op.x
            for fold, th, fl in (("act:sq_relu", always, zero),
                                 ("random", op.thresh, op.flip)):
                before = bg.launches["binary_gemm_fused"]
                words = bg.binary_gemm_fused(a, op.b, th, fl, k)
                torch.cuda.synchronize()
                if bg.launches["binary_gemm_fused"] - before != 1:
                    raise AssertionError("kernel 3: not one launch")
                want = bg.binary_gemm_fused_plain(a, op.b, th, fl, k)
                d = max_abs_diff(words, want, words=True)
                if d or (fold != "random" and not (words == -1).all()):
                    raise AssertionError(f"kernel 3 {lhs} ({m},{k},{n}) "
                                         f"{fold}: words differ")
                before = bg.launches["binary_gemm_packed"]
                out = bg.binary_gemm_packed(words, down, n)
                torch.cuda.synchronize()
                if bg.launches["binary_gemm_packed"] - before != 1:
                    raise AssertionError("kernel 1: not one launch")
                d1 = max_abs_diff(out, bg.binary_gemm_packed_plain(
                    words, down, n), words=False)
                if d1:
                    raise AssertionError(f"kernel 1 on kernel 3's words "
                                         f"({m},{n},{k}) differs by {d1}")
                print(f"check binary_gemm_fused {lhs:6s} M={m:4d} K={k} "
                      f"N={n} {fold:11s} dots in [{int(dots.min())}, "
                      f"{int(dots.max())}]: words equal the plain version's"
                      f"; binary_gemm_packed on them (K {n} -> N {k}) "
                      f"equal, max_abs_err=0")
        del op
    return 0


def family_attention_checks(cfgs, dev_gen, seed, dev, sms):
    """Kernels 6 and 8 and their paged twins 7 and 9 at each family's head
    layout, bf16 and float32 q: a 4-slot decode step over 512 positions
    (lengths 1, 17, 512, 300) and one slot's chunks reaching lengths 1 (one
    row), 17 (17 rows) and 512 (32 rows at q_pos 480). Dots equal the plain
    version's, outputs within ATTN_TOL with equal signs; the paged kernels
    equal, bit for bit, their plain versions and the contiguous kernels on
    the gathered pages. Returns the largest error of each kernel."""
    from repro_torch.kernels import ref
    _, _, da, pa, _ = lm_modules()
    rng = np.random.default_rng(seed + 21)
    err = {kn: 0.0 for kn in ("decode_attention_packed",
                              "prefill_attention_packed", *PAGED_KERNELS)}
    lens = (1, 17, LM_MAX_LEN, 300)
    npg = LM_MAX_LEN // LM_PAGE
    for hkv, g, hd in sorted({(c.n_kv_heads, c.n_heads // c.n_kv_heads,
                               c.head_dim) for c in cfgs}):
        plan = pa.attention_plan(LM_SLOTS, 1, LM_MAX_LEN, hkv, g, hd, sms)
        body = "narrow" if plan.bq * g <= pa._NARROW_ROWS else "wide"
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, vs, pt = paged_case(dev_gen, rng, LM_SLOTS, 1, LM_PAGE,
                                         npg, LM_POOL, hkv, g, hd, lens,
                                         dtype, dev)
            kv = torch.tensor(lens, dtype=torch.int32, device=dev)
            kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
            got, dots = da.decode_attention_packed(q, kg, vg, vs, kv,
                                                   return_dots=True)
            want, wdots = da.decode_attention_packed_plain(
                q, kg, vg, vs, kv, return_dots=True)
            paged, pdots = da.decode_attention_packed_paged(
                q, k, v, vs, pt, kv, return_dots=True)
            plain_paged = da.decode_attention_packed_paged_plain(
                q, k, v, vs, pt, kv, return_dots=True)
            torch.cuda.synchronize()
            what = f"decode Hkv {hkv} G {g} hd {hd} {dtype}"
            if not (torch.equal(dots, wdots) and torch.equal(pdots, dots)
                    and torch.equal(plain_paged[1], dots)):
                raise AssertionError(f"{what}: dots differ")
            if not (torch.equal(paged, got)
                    and torch.equal(plain_paged[0], paged)):
                raise AssertionError(f"{what}: paged differs from the "
                                     f"contiguous kernel or its plain version")
            e = check_close(what, got, want, dtype)
            for kn in ("decode_attention_packed",
                       "decode_attention_packed_paged"):
                err[kn] = max(err[kn], e)
            print(f"check decode_attention_packed(_paged) {str(dtype)[6:]:8s}"
                  f" B={LM_SLOTS} T={LM_MAX_LEN} Hkv={hkv} G={g} hd={hd} lens "
                  f"{list(lens)} ({body} body, bq {plan.bq}, split "
                  f"{plan.split}): dots equal, paged = contiguous = plain, "
                  f"max_abs_err={e:.3g}")
            for s, qp in ((1, 0), (17, 0), (LM_CHUNK, LM_MAX_LEN - LM_CHUNK)):
                q, k, v, vs, pt = paged_case(dev_gen, rng, 1, s, LM_PAGE, npg,
                                             LM_POOL, hkv, g, hd,
                                             (qp + s,), dtype, dev)
                kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
                got, dots = pa.prefill_attention_packed(
                    q, kg, vg, vs, qp + s, qp, return_dots=True)
                want, wdots = pa.prefill_attention_packed_plain(
                    q, kg, vg, vs, qp + s, qp, return_dots=True)
                paged, pdots = pa.prefill_attention_packed_paged(
                    q, k, v, vs, pt, qp + s, qp, return_dots=True)
                plain_paged = pa.prefill_attention_packed_paged_plain(
                    q, k, v, vs, pt, qp + s, qp, return_dots=True)
                torch.cuda.synchronize()
                what = f"prefill S {s} length {qp + s} Hkv {hkv} G {g}"
                if not (torch.equal(dots, wdots) and torch.equal(pdots, dots)
                        and torch.equal(plain_paged[1], dots)):
                    raise AssertionError(f"{what}: dots differ")
                if not (torch.equal(paged, got)
                        and torch.equal(plain_paged[0], paged)):
                    raise AssertionError(f"{what}: paged differs")
                e = check_close(what, got, want, dtype)
                for kn in ("prefill_attention_packed",
                           "prefill_attention_packed_paged"):
                    err[kn] = max(err[kn], e)
                p = pa.attention_plan(1, s, qp + s, hkv, g, hd, sms)
                print(f"check prefill_attention_packed(_paged) "
                      f"{str(dtype)[6:]:8s} S={s:2d} q_pos={qp:3d} length "
                      f"{qp + s:3d} Hkv={hkv} G={g} hd={hd} (bq {p.bq}, "
                      f"{p.bq * g} rows a block, split {p.split}): dots "
                      f"equal, paged = contiguous = plain, max_abs_err={e:.3g}")
    return err


def family_kernel_checks(cfgs, dev_gen, seed, dev, sms):
    """Phase 3 at the families' shapes, beyond the GEMM check loop: kernel
    3 and kernel 1 on its words (`fused_lm_checks`), the attention kernels
    (`family_attention_checks`), kernel 5's shared packs (K d_model at
    FAMILY_ROWS rows) and its `pack_rows_into` at each family's K|V rows
    (the main-path cases of `pack_rows_cases`). Returns the largest error
    of each kernel."""
    nemotron = next(c for c in cfgs if c.mlp == "sq_relu")
    e3 = fused_lm_checks(nemotron, dev_gen, dev)
    err = {"binary_gemm_fused": e3, "binary_gemm_packed": e3}
    err.update(family_attention_checks(cfgs, dev_gen, seed, dev, sms))
    packs = sorted({(m, c.d_model, c.name.split("-")[0]) for c in cfgs
                    for m in FAMILY_ROWS})
    rows_cases = []
    for hkv, hd in sorted({(c.n_kv_heads, c.head_dim) for c in cfgs}):
        c = next(c for c in cfgs if (c.n_kv_heads, c.head_dim) == (hkv, hd))
        rows_cases += [(f"{where} (Hkv {hkv}, hd {hd})", *rest)
                       for where, *rest in pack_rows_cases(c)[:5]]
    err["pack_bits"] = max(pack_checks(packs, dev_gen, dev),
                           pack_rows_checks(rows_cases, dev_gen, dev))
    return err


def family_per_call(cfg) -> dict:
    """Launches of kernels 1, 2, 3 and 5 per layer and forward call (a
    prefill chunk, a whole prompt or a decode step), counted from the
    layer: kernel 1 for q, k, v (shared pack) and the GLU's gate and up
    (shared pack) or sq_relu's w_down (on kernel 3's words); kernel 2 for
    wo and the GLU's w_down or gelu's w_up and w_down; kernel 3 for
    sq_relu's w_up; kernel 5 for the Q/K/V pack, the GLU's pack and, at
    kv_bits=1, the K|V rows into the cache. The MoE FFN: kernel 5 packs
    the dispatch buffer once for gate and up and the hidden once, and each
    of gate, up and down is one batched launch of kernel 1 over the
    experts."""
    kv1 = int(cfg.kv_bits == 1)
    if cfg.n_experts:
        return {"binary_gemm_packed": 6, "binary_gemm_packed_rhs": 1,
                "binary_gemm_fused": 0, "pack_bits": 3 + kv1}
    glu, fused = cfg.mlp in ("swiglu", "geglu"), cfg.mlp == "sq_relu"
    return {"binary_gemm_packed": 3 + (2 if glu else int(fused)),
            "binary_gemm_packed_rhs": 1 + (1 if glu else 0 if fused else 2),
            "binary_gemm_fused": int(fused),
            "pack_bits": 1 + int(glu) + kv1}


def family_expected(cfg, layers, calls, chunks, steps, paged) -> dict:
    """Every launch counter of an engine run: `family_per_call` x layers x
    forward calls, and at kv_bits=1 one attention launch per layer and
    decode step (kernel 6, or 7 paged) and per layer and chunk (8, or 9)."""
    want = {kn: 0 for kn in REPLACES}
    want.update({kn: n * layers * calls
                 for kn, n in family_per_call(cfg).items()})
    if cfg.kv_bits == 1:
        tail = "_paged" if paged else ""
        want[f"decode_attention_packed{tail}"] = layers * steps
        want[f"prefill_attention_packed{tail}"] = layers * chunks
    return want


def randomize_norms_and_biases(params, gen):
    """Every norm scale and bias and the QKV bias of a params tree drawn
    N(0, 0.02^2) from `gen`, in place of the init's zeros (with which a
    path that dropped them would pass unseen)."""
    from repro_torch.core.packed import map_tree

    def leaf(name, p):
        if name in ("scale", "bias", "bq", "bk", "bv"):
            return (0.02 * torch.randn(p.shape, generator=gen,
                                       device=gen.device)).to(p)
        return p
    return map_tree(leaf, params)


@contextlib.contextmanager
def moe_drops(out):
    """Within the block, each MoE FFN call appends (its share of dropped
    routes, its routes) to `out`: a wrapper of `models.transformer`'s
    `moe_ffn` (it reads each call's drop_frac, a host sync: check runs
    only). A dense stack's calls never reach it."""
    from unittest import mock
    from repro_torch.models import transformer as T
    real = T.moe_ffn

    def wrapped(params, x, kind, mode, *, top_k, **kw):
        y, aux = real(params, x, kind, mode, top_k=top_k, **kw)
        out.append((float(aux["drop_frac"]), x.shape[0] * x.shape[1] * top_k))
        return y, aux
    with mock.patch.object(T, "moe_ffn", wrapped):
        yield


def drop_share(drops) -> float:
    """Dropped routes over all routes of the calls `moe_drops` recorded."""
    total = sum(n for _, n in drops)
    return sum(f * n for f, n in drops) / total if total else 0.0


def family_engine_check(base_cfg, seed, dev):
    """One family at full width, depth FAMILY_CHECK_DEPTH, frozen, norms
    and biases drawn non-zero, through three engines, each through the
    kernels (launches counted and held to `family_expected`) and through
    the plain versions (tokens equal): chunked at kv_bits=1 on phase 6's
    traffic (the main path), the default engine (whole prompt, float
    cache) on the same, and paged kv_bits=1 with the prefix cache on the
    shared-prefix traffic (prefix hits >= 1); then generate_static on 4
    prompts of 64. A MoE prints each kernel run's share of dropped routes
    (`moe_drops`; nothing holds it: it is the reference's semantics).
    Returns the three runs' launches summed, and a report."""
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = base_cfg.scaled(n_layers=FAMILY_CHECK_DEPTH)
    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    frozen = randomize_norms_and_biases(
        get_model(cfg).init_frozen(gen, device=dev), gen)
    ffn = frozen["blocks"]["ffn"]
    w_up = ffn["experts"]["w_up"] if cfg.n_experts else ffn["w_up"]
    if (w_up.fold == "act:sq_relu") != (cfg.mlp == "sq_relu"):
        raise AssertionError(f"{cfg.name}: w_up fold {w_up.fold!r}")
    prompts = lm_traffic(seed, cfg.vocab)
    shared = shared_prefix_traffic(seed, cfg.vocab)
    base = dict(slots=LM_SLOTS, max_len=LM_MAX_LEN, seed=seed)
    variants = {
        "chunked, kv_bits=1": (prompts, dict(kv_bits=1,
                                             prefill_chunk=LM_CHUNK)),
        "default (kv_bits=0, whole prompt)": (prompts, {}),
        "paged + prefix, kv_bits=1": (shared, dict(
            kv_bits=1, prefill_chunk=LM_CHUNK, page_size=LM_PAGE,
            prefix_cache=True))}
    total = {kn: 0 for kn in REPLACES}
    rep = {}
    for name, (traffic, kw) in variants.items():
        reqs = [Request(p, max_new_tokens=LM_NEW) for p in traffic]
        eng = ServingEngine(cfg, frozen, **base, **kw)
        sched = eng.scheduler()
        drops = []
        reset_all_launches()
        with moe_drops(drops):
            comps = eng.serve(reqs)
        torch.cuda.synchronize()
        counts = all_launches()
        steps = sched.stats["decode_steps"]
        want = ServingEngine(cfg, frozen, kernel_path="ref", **base,
                             **kw).generate(reqs)
        for i, (c, b) in enumerate(zip(comps, want, strict=True)):
            if not np.array_equal(c.tokens, b):
                raise AssertionError(
                    f"{cfg.name}, {name}, request {i}: kernel tokens "
                    f"{c.tokens.tolist()} != plain {b.tolist()}")
        if any(len(c.tokens) != LM_NEW for c in comps):
            raise AssertionError(f"{cfg.name}, {name}: a request did not get "
                                 f"its budget")
        chunked = kw.get("prefill_chunk") is not None
        chunks = sum(-(-(len(p) - c.cached_tokens) // LM_CHUNK)
                     for p, c in zip(traffic, comps)) if chunked else 0
        calls = (chunks if chunked else len(traffic)) + steps
        expect = family_expected(eng.cfg, FAMILY_CHECK_DEPTH, calls, chunks,
                                 steps, "page_size" in kw)
        if counts != expect:
            raise AssertionError(f"{cfg.name}, {name}: launches {counts} != "
                                 f"{expect} ({calls} forward calls, {steps} "
                                 f"decode steps)")
        if kw.get("prefix_cache") and sched.stats["prefix_hits"] < 1:
            raise AssertionError(f"{cfg.name}: no prefix hit")
        for kn in REPLACES:
            total[kn] += counts[kn]
        rep[name] = {"launches": counts, "forward_calls": calls,
                     "decode_steps": steps,
                     "prefix_hits": sched.stats.get("prefix_hits", 0)}
        drop_note = ""
        if cfg.n_experts:
            rep[name]["drop_frac"] = drop_share(drops)
            drop_note = (f"; routes dropped {rep[name]['drop_frac']:.4f} of "
                         f"{sum(n for _, n in drops)}")
        print(f"{cfg.name} engine check, {name}: tokens equal the plain "
              f"path's; {calls} forward calls ({chunks or len(traffic)} "
              f"{'chunks' if chunked else 'prompts'}, {steps} decode steps)"
              f", per layer and call {family_per_call(eng.cfg)}; launches "
              f"{ {kn: n for kn, n in counts.items() if n} }{drop_note}")
        del eng, sched
    rng = np.random.default_rng(seed + 13)
    static = [Request(rng.integers(0, cfg.vocab, 64).astype(np.int32),
                      max_new_tokens=n) for n in (LM_NEW, 8, 12, LM_NEW)]
    got = ServingEngine(cfg, frozen, **base).generate_static(static)
    want = ServingEngine(cfg, frozen, kernel_path="ref",
                         **base).generate_static(static)
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"{cfg.name} generate_static request {i}: "
                                 f"kernel tokens {a.tolist()} != plain "
                                 f"{b.tolist()}")
    experts = (f", {cfg.n_experts} experts top-{cfg.top_k} at capacity "
               f"factor {cfg.capacity_factor}" if cfg.n_experts else "")
    print(f"{cfg.name} engine check: full width (d {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}{experts}, {cfg.mlp}, {cfg.norm}, "
          f"{cfg.pos}{', QKV bias' if cfg.qkv_bias else ''}), depth "
          f"{FAMILY_CHECK_DEPTH} (cut from {base_cfg.n_layers}); "
          f"generate_static on 4 prompts of 64 equals the plain path's")
    del frozen
    torch.cuda.empty_cache()
    return total, rep


def timed_config(arch, late):
    """`arch` at full width and depth, or at most FAMILY_TIMED_DEPTH layers
    when the script runs `late`."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if not late:
        return cfg
    return cfg.scaled(n_layers=min(cfg.n_layers, FAMILY_TIMED_DEPTH))


def family_timed_run(cfg, seed, dev, card):
    """The family at full width and `cfg`'s layers, drawn and
    frozen one layer at a time, norms and biases non-zero, on phase 6's
    traffic through the chunked kv_bits=1 engine and the default engine:
    decode tokens/s, TTFT, ITL, weight bytes (binary, other), cache bytes
    (packed against bf16), peak device memory, and one profiled decode
    step at position 300 with its launches of kernels 1-3, 5 and 6 held to
    `family_expected`."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import ServingEngine
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    frozen = randomize_norms_and_biases(
        get_model(cfg).init_frozen(gen, device=dev), gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = lm_traffic(seed, cfg.vocab)
    bf16_cache = 2 * cfg.n_layers * LM_SLOTS * LM_MAX_LEN * \
        cfg.n_kv_heads * cfg.head_dim * 2
    out = {"depth": cfg.n_layers, "init_frozen_s": init_s}
    for name, kw in (("chunked, kv_bits=1", dict(kv_bits=1,
                                                prefill_chunk=LM_CHUNK)),
                     ("default (kv_bits=0, whole prompt)", {})):
        eng = ServingEngine(cfg, frozen, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                            seed=seed, **kw)
        rep, _, sched = serve_report(eng, prompts, LM_NEW)
        w = eng.resident_weight_bytes()
        c = eng.resident_cache_bytes()
        pos = torch.full((LM_SLOTS,), 300, dtype=torch.int32, device=dev)

        def step_call():
            sched.model.decode(sched.params, sched._state["cur"],
                               sched._cache, pos)
        reset_all_launches()
        step_call()
        torch.cuda.synchronize()
        per_step = all_launches()
        expect = family_expected(eng.cfg, cfg.n_layers, 1, 0, 1, False)
        if per_step != expect:
            raise AssertionError(f"{cfg.name} timed {name}: decode step "
                                 f"launches {per_step} != {expect}")
        step = trace(step_call)
        rep.update({"binary_bytes": w["binary"], "other_bytes": w["other"],
                    "cache_packed_bytes": c["packed"],
                    "cache_float_bytes": c["float"],
                    "cache_bf16_bytes": bf16_cache,
                    "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                    "decode_step_launches": {kn: n for kn, n in
                                             per_step.items() if n},
                    "decode_step_trace": step})
        out[name] = rep
        full = get_config(cfg.name).n_layers
        depth = (f"full width and depth ({cfg.n_layers} layers"
                 if cfg.n_layers == full else
                 f"full width, depth {cfg.n_layers} (cut from {full}: the "
                 f"script ran late")
        print(f"{cfg.name} timed run on {card}, {name}: {depth}, drawn and "
              f"frozen layer by layer in {init_s:.1f} s), {LM_REQUESTS} "
              f"requests, {LM_SLOTS} slots, max_len {LM_MAX_LEN}; peak device "
              f"memory {rep['peak_device_bytes'] / 1e9:.2f} GB")
        print_serve_report(rep)
        print(f"  resident weights: binary {w['binary'] / 1e9:.4f} GB, other "
              f"{w['other'] / 1e9:.4f} GB (embedding, bf16 head, norms, "
              f"biases{', routers' if cfg.n_experts else ''}); cache "
              f"{c['packed'] / 1e6:.2f} MB packed + "
              f"{c['float'] / 1e6:.2f} MB float (a bf16 cache "
              f"{bf16_cache / 1e6:.2f} MB)")
        print_trace(f"trace {cfg.name} decode step ({name}, depth "
                    f"{cfg.n_layers}, {LM_SLOTS} slots at position 300) on "
                    f"{card}", step,
                    f" ({sum(per_step.values())} of the kernels: "
                    f"{ {kn: n for kn, n in per_step.items() if n} })")
        del eng, sched
        torch.cuda.empty_cache()
    del frozen
    torch.cuda.empty_cache()
    return out


# kernel 3's shapes for the sweep of its small-M rows (K, N): nemotron's
# up-projection, a split-K cluster, two square layers
FUSED_SWEEP = [(6144, 24576), (8192, 288), (1024, 1024), (4096, 4096)]


def fused_plan_sweep(dev_gen, sms):
    """Kernel 3 at FUSED_SWEEP shapes and 1 to 32 rows, bf16 lhs: the words
    of its small-M kernel and of its tensor-core tiles (each plan forced)
    equal the plain version's, and their device times, the ground of
    `gemm_plan`'s FUSED_SMALL_M_ROWS. Not in the kernels line."""
    from unittest import mock
    bg = lm_modules()[0]
    kn, rows = "binary_gemm_fused", []
    for k, n in FUSED_SWEEP:
        for m in (1, 4, 8, 16, 24, 32):
            op = Operands(dev_gen, m, k, n)
            want = op.call(kn, "bf16", plain=True)
            ms = {}
            for name, limit in (("small", 32), ("tiles", 0)):
                with mock.patch.object(bg, "FUSED_SMALL_M_ROWS", limit):
                    plan = bg.gemm_plan(kn, m, n, k, sms)
                with mock.patch.object(bg, "gemm_plan",
                                       lambda *_, p=plan: p):
                    check_equal(f"kernel 3 {name} ({m},{k},{n})",
                                op.call(kn, "bf16"), want)
                    ms[name] = device_ms(lambda: op.call(kn, "bf16"),
                                         wrapper=kn)
            rows.append({"M": m, "K": k, "N": n, **ms})
            del op
    return rows


def family_phase(seed, dev, card, dev_gen, popc_per_s, sms, late):
    """Phase 11: each family at full width and depth FAMILY_CHECK_DEPTH
    through three engines against the plain versions, kernel 3 timed at
    nemotron's up-projection and its small-M rows swept, then each family's
    timed run at all its layers (at most FAMILY_TIMED_DEPTH when `late`).
    Returns (the depth-2 runs' launches summed, report)."""
    from repro_torch.configs.base import get_config
    t0 = time.perf_counter()
    launches = {kn: 0 for kn in REPLACES}
    rep = {"check": {}, "timed": {}}
    for arch in FAMILY_ARCHS:
        counts, rep["check"][arch] = family_engine_check(get_config(arch),
                                                         seed, dev)
        for kn in REPLACES:
            launches[kn] += counts[kn]
    print(f"phase 11 checks: {time.perf_counter() - t0:.1f} s")
    rows = lm_gemm_times(
        dev_gen, popc_per_s, sms,
        gemms=[g for g in family_gemms(get_config("nemotron-4-15b"))
               if g[0] == "binary_gemm_fused"],
        row_counts=[(m, f"M{m}") for m in FAMILY_ROWS])
    print_gemm_rows(f"nemotron up-projection (kernel 3) times on {card} (ms "
                    f"per launch, as phase 7; not in the kernels line):", rows)
    rep["fused_lm"] = rows
    sweep = fused_plan_sweep(dev_gen, sms)
    from repro_torch.kernels.binary_gemm import FUSED_SMALL_M_ROWS
    print(f"kernel 3 plan sweep on {card} (bf16 lhs, words equal the plain "
          f"version's; device ms small-M kernel / tensor-core tiles; the rule "
          f"takes small-M at M <= {FUSED_SMALL_M_ROWS}):")
    for k, n in FUSED_SWEEP:
        print(f"  K={k:5d} N={n:5d}  " + "  ".join(
            f"M={r['M']} {r['small']:.4f}/{r['tiles']:.4f}" for r in sweep
            if (r["K"], r["N"]) == (k, n)))
    rep["fused_plan_sweep"] = sweep
    for arch in FAMILY_ARCHS:
        t1 = time.perf_counter()
        rep["timed"][arch] = family_timed_run(timed_config(arch, late), seed,
                                              dev, card)
        print(f"{arch} timed: {time.perf_counter() - t1:.1f} s")
    print(f"phase 11 (dense families): {time.perf_counter() - t0:.1f} s")
    return launches, rep


# ---------------------------------------------------------------------------
# The MoE family: dbrx-132b (16 experts, top-4) and llama4-scout-17b-a16e
# (16 experts, top-1), frozen experts through the batched kernel 1
# ---------------------------------------------------------------------------
def moe_caps(cfg) -> dict:
    """The experts' capacity rows C = max(1, T k cf // E) of the main
    paths' calls: a 4-slot decode step, a 32-token chunk, a 200-token
    prompt (batch-global: every row of the call counts)."""
    return {where: int(max(1, (t * cfg.top_k * cfg.capacity_factor)
                           // cfg.n_experts))
            for where, t in (("decode", LM_SLOTS), ("chunk", LM_CHUNK),
                             ("prompt", 200))}


def expert_operands(gen, e, c, k, n):
    """Packed (E, C, KW) capacity rows, the last of each expert all zero
    (an empty slot: all-ones words), and packed (E, N, KW) weights."""
    from repro_torch.core.bitpack import pack_bits
    x = torch.randn(e, c, k, generator=gen, device=gen.device)
    x[:, -1] = 0.0
    return pack_bits(x), pack_bits(torch.randn(e, n, k, generator=gen,
                                               device=gen.device))


def expert_shapes(cfgs):
    """(E, K, N, what) of each MoE config's expert projections: gate and
    up (d_model -> d_ff) share a shape, and down (d_ff -> d_model)."""
    out = []
    for cfg in cfgs:
        short = cfg.name.split("-")[0]
        out += [(cfg.n_experts, cfg.d_model, cfg.d_ff, f"{short}.gate|up"),
                (cfg.n_experts, cfg.d_ff, cfg.d_model, f"{short}.down")]
    return out


def moe_kernel_checks(cfgs, dev_gen, seed, dev, sms):
    """Phase 3 at the MoE configs' shapes: the batched kernel 1 against
    its plain version, tolerance 0, one launch a call, at each config's
    expert projections and MOE_CAPS capacity rows, and at ragged cases (E
    3: K off a word at C 9, the small-M kernel; K off a word with KW % 4
    != 0, which takes the tiles, at C 9 and at C 33 past the small-M edge);
    every call's last capacity row all zero. Then kernel 5 at the (E C,
    D | F) packs of the dispatch buffer and the hidden, and the attention
    kernels 6-9 at the configs' head layouts (`family_attention_checks`).
    Returns the largest error of each kernel."""
    bg = lm_modules()[0]
    cases = [(e, c, k, n, what) for e, k, n, what in expert_shapes(cfgs)
             for c in MOE_CAPS]
    cases += [(3, c, k, 77, "ragged") for c, k in ((9, 1000), (9, 1050),
                                                   (33, 1050))]
    for e, c, k, n, what in cases:
        a, b = expert_operands(dev_gen, e, c, k, n)
        before = bg.launches["binary_gemm_packed"]
        got = bg.binary_gemm_packed(a, b, k)
        torch.cuda.synchronize()
        if bg.launches["binary_gemm_packed"] - before != 1:
            raise AssertionError(f"batched kernel 1 ({e},{c},{k},{n}): not "
                                 f"one launch")
        d = max_abs_diff(got, bg.binary_gemm_packed_plain(a, b, k),
                         words=False)
        p = bg.gemm_plan("binary_gemm_packed", c, n, k, sms, batch=e)
        print(f"check binary_gemm_packed batched E={e:2d} C={c:3d} K={k:5d} "
              f"N={n:5d} {what:14s} "
              f"{'small-M b1' if p.small_m else 'TC tiles'} split {p.split} "
              f"blocks {p.blocks}  max_abs_err={d}")
        if d:
            raise AssertionError(f"batched kernel 1 ({e},{c},{k},{n}) "
                                 f"differs from its plain version by {d}")
        del a, b, got
    packs = sorted({(cfg.n_experts * c, dim, f"{cfg.name.split('-')[0]} "
                     f"E*C{c}") for cfg in cfgs
                    for c in moe_caps(cfg).values()
                    for dim in (cfg.d_model, cfg.d_ff)})
    err = {"binary_gemm_packed": 0, "pack_bits": pack_checks(packs, dev_gen,
                                                             dev)}
    err.update(family_attention_checks(cfgs, dev_gen, seed, dev, sms))
    return err


def moe_gemm_times(cfgs, dev_gen, popc_per_s, sms):
    """The batched kernel 1 at each config's expert projections and its
    main paths' capacity rows (`moe_caps`): device ms beside its plain
    version, the bound (E times one GEMM's: `bound`) and a library call:
    torch._int_mm on +-1 int8, one call per expert, where its shape rules
    allow (C > 16), else one float32 torch.bmm of +-1 operands (exact: the
    dots are integers below 2^24, TF32 off). Not in the kernels line."""
    from repro_torch.core.bitpack import unpack_bits
    bg = lm_modules()[0]
    rows = []
    for cfg in cfgs:
        caps = moe_caps(cfg)
        for e, k, n, what in expert_shapes([cfg]):
            for where, c in caps.items():
                a, b = expert_operands(dev_gen, e, c, k, n)
                xs, ws = unpack_bits(a, k), unpack_bits(b, k)   # +-1 float
                if c > 16 and k % 8 == 0 and n % 8 == 0:
                    xi = xs.to(torch.int8)
                    wi = [ws[i].to(torch.int8).t() for i in range(e)]
                    lib_name = f"torch._int_mm x{e}"

                    def lib(xi=xi, wi=wi):
                        return [torch._int_mm(xi[i], wi[i])
                                for i in range(len(wi))]
                else:
                    wt = ws.transpose(1, 2).contiguous()
                    lib_name = "torch.bmm fp32"

                    def lib(xs=xs, wt=wt):
                        return torch.bmm(xs, wt)
                want = bg.binary_gemm_packed(a, b, k)
                got = lib()
                got = torch.stack(got) if isinstance(got, list) else got
                check_equal(f"{lib_name} vs batched kernel 1 {what} "
                            f"{where}", got.to(torch.int32), want)
                one = bound("binary_gemm_packed", "packed", c, k, n,
                            popc_per_s)
                row = {"kernel": "binary_gemm_packed", "E": e, "C": c,
                       "K": k, "N": n, "where": f"{what} {where}",
                       "library": lib_name,
                       **shape_times(lambda: bg.binary_gemm_packed(a, b, k),
                                     "binary_gemm_packed",
                                     lambda: bg.binary_gemm_packed_plain(
                                         a, b, k), lib),
                       **{key: e * one[key] for key in
                          ("bytes", "popc", "bytes_ms", "popc_ms",
                           "int8_tc_ms", "ops_ms", "bound_ms")}}
                p = bg.gemm_plan("binary_gemm_packed", c, n, k, sms, batch=e)
                row["plan"] = (f"{'small-M b1' if p.small_m else 'TC tiles'}"
                               f" split {p.split} blocks {p.blocks}")
                rows.append(row)
                del a, b, xs, ws, got, want
    return rows


def moe_phase(seed, dev, card, dev_gen, popc_per_s, sms, late):
    """Phase 12: each MoE config at full width and depth FAMILY_CHECK_DEPTH
    through three engines against the plain versions, launches held per
    layer and call (`family_engine_check`, `family_per_call`), the share
    of dropped routes printed per engine; the batched kernel 1 timed at the
    experts' shapes; then each config's timed run at all its layers (at
    most FAMILY_TIMED_DEPTH when `late`; `family_timed_run`). Returns (the depth-2 runs' launches summed,
    report)."""
    from repro_torch.configs.base import get_config
    t0 = time.perf_counter()
    launches = {kn: 0 for kn in REPLACES}
    rep = {"check": {}, "timed": {}}
    for arch in MOE_ARCHS:
        counts, rep["check"][arch] = family_engine_check(get_config(arch),
                                                         seed, dev)
        for kn in REPLACES:
            launches[kn] += counts[kn]
    print(f"phase 12 checks: {time.perf_counter() - t0:.1f} s")
    cfgs = [get_config(arch) for arch in MOE_ARCHS]
    rows = moe_gemm_times(cfgs, dev_gen, popc_per_s, sms)
    print(f"moe expert gemm times on {card} (batched kernel 1, every expert "
          f"in one launch; ms, as phase 7; bound = E x one expert's; not in "
          f"the kernels line):")
    for r in rows:
        print(f"  {r['where']:26s} E={r['E']} C={r['C']:3d} K={r['K']:5d} "
              f"N={r['N']:5d} kernel {r['ms']:.4f} (wrapper "
              f"{r['wrapper_ms']:.4f})  plain {r['plain_ms']:.3f}  "
              f"{r['library']} {r['library_ms']:.4f} (wall "
              f"{r['library_wall_ms']:.4f})  bound {r['bound_ms']:.4f} "
              f"({bound_by(r)})  {r['plan']}")
    rep["expert_gemms"] = rows
    for arch in MOE_ARCHS:
        t1 = time.perf_counter()
        rep["timed"][arch] = family_timed_run(timed_config(arch, late), seed,
                                              dev, card)
        print(f"{arch} timed: {time.perf_counter() - t1:.1f} s")
    print(f"phase 12 (moe): {time.perf_counter() - t0:.1f} s")
    return launches, rep


# ---------------------------------------------------------------------------
# The vlm family: llama-3.2-vision-11b (a gated cross-attention block, then
# four self-attention blocks, eight times over; image K/V per slot)
# ---------------------------------------------------------------------------
def vlm_images(seed, cfg, n):
    """n image embeddings (n_img_tokens, d_vision), N(0, 1), float32 on the
    host, as requests bring them."""
    rng = np.random.default_rng(seed + 17)
    return [rng.standard_normal((cfg.n_img_tokens, cfg.d_vision),
                               dtype=np.float32) for _ in range(n)]


def vlm_gemm_checks(cfg):
    """(kernel, lhs, M, K, N, where) of the vlm family's GEMMs for phase 3's
    check loop: a self block's (`family_gemm_checks`) at FAMILY_ROWS rows,
    the cross block's float-lhs q and wo (kernel 2, K and N d_model: the
    self wo's shape) and the image K and V: kernel 1 on the image's words,
    M n_img_tokens, K d_vision (1,280: 40 words, not a multiple of 64),
    N Hkv * hd, and past the small-M edge at 33 rows."""
    img = ("binary_gemm_packed", "packed", cfg.d_vision,
           cfg.n_kv_heads * cfg.head_dim)
    return family_gemm_checks([cfg]) + [
        (img[0], img[1], m, img[2], img[3], "llama.img_kv")
        for m in (33, cfg.n_img_tokens)]


def vlm_cross_attention_checks(cfg, dev_gen, dev, sms):
    """The cross-attention's kernels against their plain versions at full
    width, bf16 and float32 q: kernel 6 on 4 slots' decode step over the
    image rows (T n_img_tokens, every row at full length, G 4, hd 128);
    kernel 8 non-causal (`causal=False`) on a 32-row chunk over the same
    rows, at q_pos 0 and 480 (equal: no causal mask), at each T split of 1,
    2, 4 and 8 (`attention_plan` forced: shares held whole and streamed),
    and a one-row non-causal chunk against kernel 6 bit for bit. Dots
    equal, outputs within ATTN_TOL with equal signs, one launch a call.
    Returns the largest error of kernels 6 and 8."""
    _, _, da, pa, _ = lm_modules()
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    t = cfg.n_img_tokens
    err = {"decode_attention_packed": 0.0, "prefill_attention_packed": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, vs = attention_case(dev_gen, LM_SLOTS, 1, t, hkv, g, hd,
                                     dtype, dev)
        before = da.launches["decode_attention_packed"]
        got, dots = da.decode_attention_packed(q, k, v, vs, t,
                                               return_dots=True)
        torch.cuda.synchronize()
        if da.launches["decode_attention_packed"] - before != 1:
            raise AssertionError("cross decode: not one launch")
        want, wdots = da.decode_attention_packed_plain(q, k, v, vs, t,
                                                       return_dots=True)
        what = f"cross decode B {LM_SLOTS} T {t} {dtype}"
        if not torch.equal(dots, wdots):
            raise AssertionError(f"{what}: dots differ")
        e = check_close(what, got, want, dtype)
        err["decode_attention_packed"] = max(err["decode_attention_packed"], e)
        one = pa.prefill_attention_packed(q, k, v, vs, t, 0, causal=False)
        check_equal(f"{what}: one-row non-causal prefill vs decode", one, got)
        plan = pa.attention_plan(LM_SLOTS, 1, t, hkv, g, hd, sms)
        print(f"check decode_attention_packed {str(dtype)[6:]:8s} cross "
              f"B={LM_SLOTS} T={t} Hkv={hkv} G={g} hd={hd} all rows full "
              f"(split {plan.split}, {plan.blocks} blocks): dots equal, "
              f"max_abs_err={e:.3g}; a one-row non-causal prefill equals it "
              f"bit for bit")
        q, k, v, vs = attention_case(dev_gen, 1, LM_CHUNK, t, hkv, g, hd,
                                     dtype, dev)
        want, wdots = pa.prefill_attention_packed_plain(
            q, k, v, vs, t, 0, causal=False, return_dots=True)
        plan = pa.attention_plan(1, LM_CHUNK, t, hkv, g, hd, sms)
        for split in (plan.split, 1, 2, 4, 8):
            forced = dict(route="cuda", split=split, block_rows=plan.bq)
            for qp in (0, LM_MAX_LEN - LM_CHUNK):
                before = pa.launches["prefill_attention_packed"]
                got, dots = pa.prefill_attention_packed(
                    q, k, v, vs, t, qp, causal=False, return_dots=True,
                    **forced)
                served = pa.prefill_attention_packed(q, k, v, vs, t, qp,
                                                     causal=False,
                                                     **forced)
                torch.cuda.synchronize()
                if pa.launches["prefill_attention_packed"] - before != 2:
                    raise AssertionError("cross prefill: not one launch "
                                         "a call")
                what = (f"cross prefill C {LM_CHUNK} T {t} q_pos {qp} "
                        f"split {split} {dtype}")
                if not torch.equal(dots, wdots):
                    raise AssertionError(f"{what}: dots differ")
                e = check_close(what, served, want, dtype)
                check_equal(f"{what}: with dots vs served", got, served)
                err["prefill_attention_packed"] = max(
                    err["prefill_attention_packed"], e)
            # a share of <= 32 KB of K and V words is held whole (served
            # calls; a call with dots streams), longer ones stream
            share, hold = -(-t // split), 32 * 1024 // (hd // 4) // 64 * 64
            print(f"check prefill_attention_packed {str(dtype)[6:]:8s} cross "
                  f"causal=False C={LM_CHUNK} T={t} Hkv={hkv} G={g} hd={hd} "
                  f"q_pos 0 and {LM_MAX_LEN - LM_CHUNK} split {split}"
                  f"{' (the plan)' if split == plan.split else ''}, "
                  f"{share} positions a block "
                  f"({'held' if share <= hold else 'streamed'}): dots equal, "
                  f"with and without dots equal, max_abs_err={e:.3g}")
    return err


def vlm_kernel_checks(cfg, dev_gen, seed, dev, sms):
    """Phase 3 at llama-3.2-vision-11b's shapes beyond the GEMM loop: the
    cross-attention (`vlm_cross_attention_checks`), kernels 6-9 at its self
    blocks' head layout (`family_attention_checks`: Hkv 8, G 4, hd 128),
    kernel 5's packs (the image, 1,600 rows of 1,280: whole 16-byte loads;
    the normed residual at FAMILY_ROWS) and its `pack_rows_into` of a
    request's 1,600 image K|V rows (Hkv 8, hd 128) into slot 2's image rows
    of a 4-slot cache, beside the self blocks' K|V rows. Returns the
    largest error of each kernel."""
    err = vlm_cross_attention_checks(cfg, dev_gen, dev, sms)
    for kn, e in family_attention_checks([cfg], dev_gen, seed, dev,
                                         sms).items():
        err[kn] = max(err.get(kn, 0.0), e)
    n, hkv, hd = cfg.n_img_tokens, cfg.n_kv_heads, cfg.head_dim
    packs = [(n, cfg.d_vision, "llama image")] + [
        (m, cfg.d_model, "llama") for m in FAMILY_ROWS]
    rows = [(f"image K|V of slot 2 (Hkv {hkv}, hd {hd})", n, hkv, hd,
             ("contiguous", LM_SLOTS, n), [2 * n + i for i in range(n)])]
    rows += [(f"{where} (Hkv {hkv}, hd {hd})", *rest)
             for where, *rest in pack_rows_cases(cfg)[:5]]
    err["pack_bits"] = max(pack_checks(packs, dev_gen, dev),
                           pack_rows_checks(rows, dev_gen, dev))
    return err


def vlm_expected(cfg, layers, calls, chunks, steps, admissions,
                 paged) -> dict:
    """Every launch counter of a vlm engine run at depth `layers` (g groups
    of a cross block and xattn_group - 1 self blocks). A self block per
    forward call: `family_per_call`, and at kv_bits=1 its attention (6 or 7
    a decode step, 8 or 9 a chunk). A cross block per forward call: kernel
    2 x3 (the float-lhs q, wo, and the FFN's w_down), kernel 1 x2 (gate,
    up), kernel 5 x1 (their shared pack), and at kv_bits=1 kernel 6 a decode
    step or kernel 8 (non-causal) a chunk, contiguous in either layout (the
    image rows stay per slot). Per admission (a request's first chunk or
    whole prompt) and group: kernel 5 packs the image once for K and V,
    kernel 1 x2 (wk, wv), and at kv_bits=1 kernel 5 packs the image K|V
    rows into the slot's image rows."""
    from repro_torch.models import transformer as T
    g, p_self = T.vlm_layout(cfg.scaled(n_layers=layers))
    kv1 = int(cfg.kv_bits == 1)
    want = {kn: 0 for kn in REPLACES}
    for kn, n in family_per_call(cfg).items():
        want[kn] = n * g * p_self * calls
    want["binary_gemm_packed_rhs"] += 3 * g * calls
    want["binary_gemm_packed"] += 2 * g * calls + 2 * g * admissions
    want["pack_bits"] += g * calls + (1 + kv1) * g * admissions
    if kv1:
        tail = "_paged" if paged else ""
        want[f"decode_attention_packed{tail}"] += g * p_self * steps
        want[f"prefill_attention_packed{tail}"] += g * p_self * chunks
        want["decode_attention_packed"] += g * steps
        want["prefill_attention_packed"] += g * chunks
    return want


def vlm_params(cfg, seed, dev):
    """Frozen params drawn and frozen one block at a time, the norm scales
    N(0, 0.02^2) and the cross blocks' gates N(0, 1) (both 0 at init: the
    gate would hide the whole cross path)."""
    from repro_torch.core.packed import map_tree
    from repro_torch.models.api import get_model
    gen = torch.Generator(device=dev).manual_seed(seed + 40)
    frozen = randomize_norms_and_biases(
        get_model(cfg).init_frozen(gen, device=dev), gen)

    def gate(name, p):
        return torch.randn(p.shape, generator=gen, device=dev) \
            if name == "gate" else p
    return map_tree(gate, frozen)


def vlm_engine_check(base_cfg, seed, dev):
    """llama-3.2-vision-11b at full width, depth VLM_CHECK_DEPTH (two groups),
    frozen, norms and gates drawn non-zero, through three engines, each
    through the kernels (launches held to `vlm_expected`) and through the
    plain versions (tokens equal), every request with its own image:
    chunked at kv_bits=1 on phase 6's traffic (the main path), the default
    engine (whole prompt, bf16 cache) on the same, and paged kv_bits=1 with
    the prefix cache on phase 6b's shared-prefix traffic, where the vlm
    family takes no prefix hit. generate_static refuses the family. Returns
    the three kernel runs' launches summed, and a report."""
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = base_cfg.scaled(n_layers=VLM_CHECK_DEPTH)
    frozen = vlm_params(cfg, seed, dev)
    prompts = lm_traffic(seed, cfg.vocab)
    shared = shared_prefix_traffic(seed, cfg.vocab)
    images = vlm_images(seed, cfg, max(len(prompts), len(shared)))
    base = dict(slots=LM_SLOTS, max_len=LM_MAX_LEN, seed=seed)
    variants = {
        "chunked, kv_bits=1": (prompts, dict(kv_bits=1,
                                             prefill_chunk=LM_CHUNK)),
        "default (kv_bits=0, whole prompt)": (prompts, {}),
        "paged + prefix, kv_bits=1": (shared, dict(
            kv_bits=1, prefill_chunk=LM_CHUNK, page_size=LM_PAGE,
            prefix_cache=True))}
    total = {kn: 0 for kn in REPLACES}
    rep = {}
    for name, (traffic, kw) in variants.items():
        reqs = [Request(p, max_new_tokens=LM_NEW, img_emb=img)
                for p, img in zip(traffic, images)]
        eng = ServingEngine(cfg, frozen, **base, **kw)
        sched = eng.scheduler()
        reset_all_launches()
        t0 = time.perf_counter()
        comps = eng.serve(reqs)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        counts = all_launches()
        steps = sched.stats["decode_steps"]
        t0 = time.perf_counter()
        want = ServingEngine(cfg, frozen, kernel_path="ref", **base,
                             **kw).generate(reqs)
        plain_s = time.perf_counter() - t0
        for i, (c, b) in enumerate(zip(comps, want, strict=True)):
            if not np.array_equal(c.tokens, b):
                raise AssertionError(
                    f"{cfg.name}, {name}, request {i}: kernel tokens "
                    f"{c.tokens.tolist()} != plain {b.tolist()}")
        if any(len(c.tokens) != LM_NEW for c in comps):
            raise AssertionError(f"{cfg.name}, {name}: a request did not get "
                                 f"its budget")
        hits = sched.stats["prefix_hits"]
        if hits or any(c.cached_tokens for c in comps):
            raise AssertionError(f"{cfg.name}, {name}: {hits} prefix hits; "
                                 f"the vlm family shares no page")
        chunked = kw.get("prefill_chunk") is not None
        chunks = sum(-(-len(p) // LM_CHUNK) for p in traffic) if chunked \
            else 0
        calls = (chunks if chunked else len(traffic)) + steps
        expect = vlm_expected(eng.cfg, VLM_CHECK_DEPTH, calls, chunks, steps,
                              len(traffic), "page_size" in kw)
        if counts != expect:
            raise AssertionError(f"{cfg.name}, {name}: launches {counts} != "
                                 f"{expect} ({calls} forward calls, {steps} "
                                 f"decode steps)")
        for kn in REPLACES:
            total[kn] += counts[kn]
        rep[name] = {"launches": counts, "forward_calls": calls,
                     "decode_steps": steps, "prefix_hits": hits,
                     "kernel_s": kernel_s, "plain_s": plain_s}
        print(f"{cfg.name} engine check, {name}: tokens equal the plain "
              f"path's; {calls} forward calls ({chunks or len(traffic)} "
              f"{'chunks' if chunked else 'prompts'}, {steps} decode steps), "
              f"{len(traffic)} images, prefix hits {hits}; launches "
              f"{ {kn: n for kn, n in counts.items() if n} } (as counted "
              f"from the blocks); {kernel_s:.1f} s through the kernels, "
              f"{plain_s:.1f} s plain")
        del eng, sched
    try:
        ServingEngine(cfg, frozen, **base).generate_static(
            [Request(prompts[0], max_new_tokens=2, img_emb=images[0])])
    except ValueError as e:
        print(f"{cfg.name}: generate_static refuses the family ({e})")
    else:
        raise AssertionError("generate_static served the vlm family")
    print(f"{cfg.name} engine check: full width (d {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, {cfg.n_img_tokens} image tokens "
          f"of {cfg.d_vision}, a cross block every {cfg.xattn_group} "
          f"layers), depth {VLM_CHECK_DEPTH} (cut from {base_cfg.n_layers}: "
          f"two groups)")
    del frozen
    torch.cuda.empty_cache()
    return total, rep


def vlm_times(cfg, dev_gen, dev, popc_per_s, sms):
    """The vlm family's new kernel shapes, timed (`shape_times`) beside
    the bound and a library call, not in the kernels line: kernel 1 on the
    image's words (M 1,600, K 1,280, N 1,024; `torch._int_mm` on +-1 int8),
    kernel 5 packing the image (1,600 x 1,280 bf16; no single call), kernel
    6 on 4 slots' decode step over the image rows and kernel 8 non-causal
    on a 32-row chunk over them (SDPA over sign(q) and the unpacked +-1
    K/V, no mask)."""
    from repro_torch.kernels import tune
    _, pk, da, pa, _ = lm_modules()
    n, hkv, hd = cfg.n_img_tokens, cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // hkv
    gemm = lm_gemm_times(dev_gen, popc_per_s, sms,
                         kernels=("binary_gemm_packed",),
                         gemms=[("binary_gemm_packed", "packed", cfg.d_vision,
                                 hkv * hd, "llama.img_kv")],
                         row_counts=[(n, "image")])
    x = torch.randn(n, cfg.d_vision, generator=dev_gen,
                    device=dev).to(torch.bfloat16)
    nbytes = n * cfg.d_vision * 2 + n * (cfg.d_vision // 32) * 4
    pack = [{"kernel": "pack_bits", "where": f"image {n} x {cfg.d_vision}",
             "library": None,
             **shape_times(lambda: pk.pack_bits_kernel(x), "pack_bits",
                           lambda: pk.pack_bits_plain(x)),
             "bytes_ms": nbytes / tune.HBM_BYTES_PER_S * 1e3, "ops_ms": 0.0,
             "bound_ms": nbytes / tune.HBM_BYTES_PER_S * 1e3}]
    rows = []
    q, k, v, vs = attention_case(dev_gen, LM_SLOTS, 1, n, hkv, g, hd,
                                 torch.bfloat16, dev)
    valid = torch.ones((LM_SLOTS, 1, n), dtype=torch.bool, device=dev)
    lib = sdpa_call(q, k, v, vs, valid)
    check_close_loose("SDPA vs kernel 6 on the image rows", lib(),
                      da.decode_attention_packed(q, k, v, vs, n))
    rows.append({"kernel": "decode_attention_packed",
                 "where": f"cross B={LM_SLOTS} T={n} G={g}",
                 "library": "F.scaled_dot_product_attention",
                 **shape_times(lambda: da.decode_attention_packed(
                     q, k, v, vs, n), "decode_attention_packed",
                     lambda: da.decode_attention_packed_plain(q, k, v, vs, n),
                     lib),
                 **attention_bound(valid, 1, cfg.n_heads, hkv, hd, 2,
                                   popc_per_s)})
    q, k, v, vs = attention_case(dev_gen, 1, LM_CHUNK, n, hkv, g, hd,
                                 torch.bfloat16, dev)
    valid = torch.ones((1, LM_CHUNK, n), dtype=torch.bool, device=dev)
    lib = sdpa_call(q, k, v, vs, valid)
    check_close_loose("SDPA vs kernel 8 non-causal on the image rows", lib(),
                      pa.prefill_attention_packed(q, k, v, vs, n, 0,
                                                  causal=False))
    rows.append({"kernel": "prefill_attention_packed",
                 "where": f"cross causal=False C={LM_CHUNK} T={n}",
                 "library": "F.scaled_dot_product_attention",
                 **shape_times(lambda: pa.prefill_attention_packed(
                     q, k, v, vs, n, 0, causal=False),
                     "prefill_attention_packed",
                     lambda: pa.prefill_attention_packed_plain(
                         q, k, v, vs, n, 0, causal=False), lib),
                 **attention_bound(valid, LM_CHUNK, cfg.n_heads, hkv, hd, 2,
                                   popc_per_s)})
    return gemm, pack + rows


def vlm_timed_run(cfg, seed, dev, card):
    """llama-3.2-vision-11b at full width and all its layers, drawn and
    frozen one block at a time, norms and gates non-zero, on phase 6's
    traffic with an image per request through the chunked kv_bits=1 engine
    and the default engine: decode tokens/s, TTFT, ITL, weight bytes
    (binary, other), cache bytes (the image rows among them, packed
    against bf16), peak device memory, and one profiled decode step at
    position 300 with its launches held to `vlm_expected`."""
    from repro_torch.serving.engine import ServingEngine
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    frozen = vlm_params(cfg, seed + 1, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = lm_traffic(seed, cfg.vocab)
    images = vlm_images(seed, cfg, len(prompts))
    g = cfg.n_layers // cfg.xattn_group
    image_bf16 = 2 * g * cfg.n_img_tokens * cfg.n_kv_heads * cfg.head_dim * 2
    image_packed = 2 * g * cfg.n_img_tokens * cfg.n_kv_heads \
        * (cfg.head_dim // 32) * 4
    out = {"depth": cfg.n_layers, "init_frozen_s": init_s,
           "image_cache_bf16_bytes_per_slot": image_bf16,
           "image_cache_packed_bytes_per_slot": image_packed}
    for name, kw in (("chunked, kv_bits=1", dict(kv_bits=1,
                                                prefill_chunk=LM_CHUNK)),
                     ("default (kv_bits=0, whole prompt)", {})):
        eng = ServingEngine(cfg, frozen, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                            seed=seed, **kw)
        rep, _, sched = serve_report(eng, prompts, LM_NEW, images)
        w = eng.resident_weight_bytes()
        c = eng.resident_cache_bytes()
        pos = torch.full((LM_SLOTS,), 300, dtype=torch.int32, device=dev)

        def step_call():
            sched.model.decode(sched.params, sched._state["cur"],
                               sched._cache, pos)
        reset_all_launches()
        step_call()
        torch.cuda.synchronize()
        per_step = all_launches()
        expect = vlm_expected(eng.cfg, cfg.n_layers, 1, 0, 1, 0, False)
        if per_step != expect:
            raise AssertionError(f"{cfg.name} timed {name}: decode step "
                                 f"launches {per_step} != {expect}")
        step = trace(step_call)
        rep.update({"binary_bytes": w["binary"], "other_bytes": w["other"],
                    "cache_packed_bytes": c["packed"],
                    "cache_float_bytes": c["float"],
                    "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                    "decode_step_launches": {kn: n for kn, n in
                                             per_step.items() if n},
                    "decode_step_trace": step})
        out[name] = rep
        print(f"{cfg.name} timed run on {card}, {name}: full width and "
              f"depth ({cfg.n_layers} layers, drawn and frozen block by "
              f"block in {init_s:.1f} s), {LM_REQUESTS} requests with an "
              f"image each, {LM_SLOTS} slots, max_len {LM_MAX_LEN}; peak "
              f"device memory {rep['peak_device_bytes'] / 1e9:.2f} GB")
        print_serve_report(rep)
        print(f"  resident weights: binary {w['binary'] / 1e9:.4f} GB, other "
              f"{w['other'] / 1e9:.4f} GB (fp32 embedding, bf16 head, norms, "
              f"gates); cache {c['packed'] / 1e6:.2f} MB packed + "
              f"{c['float'] / 1e6:.2f} MB float, of it the image rows "
              f"{image_packed / 1e6:.2f} MB packed or "
              f"{image_bf16 / 1e6:.2f} MB bf16 a slot")
        print_trace(f"trace {cfg.name} decode step ({name}, depth "
                    f"{cfg.n_layers}, {LM_SLOTS} slots at position 300) on "
                    f"{card}", step,
                    f" ({sum(per_step.values())} of the kernels: "
                    f"{ {kn: n for kn, n in per_step.items() if n} })")
        del eng, sched
        torch.cuda.empty_cache()
    del frozen
    torch.cuda.empty_cache()
    return out


def vlm_phase(seed, dev, card, dev_gen, popc_per_s, sms):
    """Phase 13: llama-3.2-vision-11b at full width and depth
    VLM_CHECK_DEPTH through three engines against the plain versions
    (`vlm_engine_check`), its new kernel shapes timed (`vlm_times`), then
    the 40-layer timed run. Returns (the depth-10 runs' launches summed,
    report)."""
    from repro_torch.configs.base import get_config
    t0 = time.perf_counter()
    cfg = get_config(VLM_ARCH)
    launches, check = vlm_engine_check(cfg, seed, dev)
    print(f"phase 13 checks: {time.perf_counter() - t0:.1f} s")
    gemm, rows = vlm_times(cfg, dev_gen, dev, popc_per_s, sms)
    print_gemm_rows(f"vlm image K/V gemm times on {card} (ms per launch, as "
                    f"phase 7; not in the kernels line):", gemm)
    print_attention_rows(f"vlm kernel times on {card} (ms, as phase 7; not "
                         f"in the kernels line):", rows, 40)
    t1 = time.perf_counter()
    timed = vlm_timed_run(cfg, seed, dev, card)
    print(f"{VLM_ARCH} timed: {time.perf_counter() - t1:.1f} s")
    print(f"phase 13 (vlm): {time.perf_counter() - t0:.1f} s")
    return launches, {"check": check, "image_gemm": gemm, "shapes": rows,
                      "timed": timed}


# ---------------------------------------------------------------------------
# Phase 14: the LM trainer and checkpoints
# ---------------------------------------------------------------------------
def timed_calls(obj, name, record):
    """Wrap obj.name so each call's seconds are appended to record."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            record.append(time.perf_counter() - t0)
    setattr(obj, name, wrapped)


def lm_trainer(cfg, ckpt_dir, seed, dev, steps=LM_TRAIN_STEPS):
    """A Trainer of `cfg` on SyntheticLM (batch LM_TRAIN_BATCH x
    LM_TRAIN_SEQ), checkpoints every 2 steps into `ckpt_dir`, keep 1, its
    checkpoint writes, save calls (the device-to-host copy) and restores
    timed into trainer.ckpt_times."""
    from repro_torch.train.step import default_optimizer
    from repro_torch.train.trainer import TrainConfig, Trainer
    tc = TrainConfig(steps=steps, global_batch=LM_TRAIN_BATCH,
                     seq_len=LM_TRAIN_SEQ, ckpt_every=2, keep=1,
                     ckpt_dir=str(ckpt_dir), log_every=1, seed=seed)
    seen = []
    tr = Trainer(cfg, tc, device=dev, optimizer=inspecting(
        default_optimizer(cfg, tc.lr), seen))
    tr.grad_stats = seen
    tr.ckpt_times = {"write": [], "save_call": [], "restore": []}
    timed_calls(tr.ckpt, "_write", tr.ckpt_times["write"])
    timed_calls(tr.ckpt, "save", tr.ckpt_times["save_call"])
    timed_calls(tr.ckpt, "restore", tr.ckpt_times["restore"])
    return tr


def step_bytes(mgr, step: int) -> int:
    """Bytes of checkpoint step `step` on disk."""
    return sum(f.stat().st_size for f in (mgr.dir / f"step_{step}").iterdir())


def ckpt_bytes_estimate(cfg) -> int:
    """Bytes of one (fp32 masters, S-AdaMax m and u) checkpoint of a dense
    cfg (untied head)."""
    from repro_torch.models.transformer import _block_shapes, _norm_shapes

    def count(shapes):
        if isinstance(shapes, dict):
            return sum(count(v) for v in shapes.values())
        return int(np.prod(shapes))
    n = 2 * cfg.vocab * cfg.d_model + count(_norm_shapes(cfg)) \
        + cfg.n_layers * count(_block_shapes(cfg))
    return 3 * 4 * n


def lm_train_depth(base_cfg, root):
    """LM_TRAIN_DEPTH, or 1 where the disk under `root` cannot hold the two
    runs' checkpoints (two steps of one run at a time, plus the packed
    one)."""
    free = shutil.disk_usage(root).free
    need = 2.2 * ckpt_bytes_estimate(base_cfg.scaled(n_layers=LM_TRAIN_DEPTH))
    depth = LM_TRAIN_DEPTH if free >= need else 1
    print(f"lm train: {free / 1e9:.1f} GB free under {root}, "
          f"{need / 1e9:.1f} GB wanted at depth {LM_TRAIN_DEPTH}: depth {depth}")
    return depth


def lm_train_check(base_cfg, seed, dev, card, root):
    """phi3-medium-14b at full width through the Trainer: the straight
    LM_TRAIN_STEPS-step run; a run stopped after 2 steps (the SIGTERM
    path: its final checkpoint is step 2); a fresh Trainer on that
    directory restoring step 2 and running to the end, whose losses of
    steps 2-3 and final params and moments must equal the straight run's
    bit for bit. Returns (the resumed trainer, its config, report)."""
    from repro_torch.checkpoint.manager import leaves_with_names
    from repro_torch.optim.base import tree_leaves
    depth = lm_train_depth(base_cfg, root)
    cfg = base_cfg.scaled(n_layers=depth)
    torch.cuda.reset_peak_memory_stats(dev)
    straight = lm_trainer(cfg, root / "straight", seed, dev)
    out = straight.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    ckpt_bytes = step_bytes(straight.ckpt, straight.ckpt.latest_step())
    shutil.rmtree(root / "straight")
    killed = lm_trainer(cfg, root / "resume", seed, dev)
    orig = killed._batch

    def stop_at_2(step):
        if step == 1:            # as SIGTERM during step 1: 2 steps done
            killed._stop = True
        return orig(step)
    killed._batch = stop_at_2
    out_k = killed.run()
    killed._batch = orig            # no cycle keeps its 20 GB of state
    if not out_k["interrupted"] or out_k["final_step"] != 2 \
            or killed.ckpt.latest_step() != 2:
        raise AssertionError(f"the stopped run: {out_k}")
    del killed
    torch.cuda.empty_cache()
    resumed = lm_trainer(cfg, root / "resume", seed, dev)
    out_r = resumed.run()
    if resumed.start_step != 2 or out_r["final_step"] != LM_TRAIN_STEPS:
        raise AssertionError(f"the resumed run: {out_r}")
    losses = {h["step"]: h["loss"] for h in out["history"]}
    resumed_losses = {h["step"]: h["loss"] for h in out_r["history"]}
    for step, loss in resumed_losses.items():
        if loss != losses[step]:
            raise AssertionError(f"resumed loss of step {step} {loss!r} != "
                                 f"the straight run's {losses[step]!r}")
    pairs = list(zip(tree_leaves((resumed.params, resumed.opt_state)),
                     tree_leaves((straight.params, straight.opt_state)),
                     strict=True))
    if not all(same_bits(a, b) for a, b in pairs):
        raise AssertionError("resumed params or moments differ from the "
                             "straight run's")
    nonfinite = {name: int((~torch.isfinite(x)).sum()) for name, x in
                 leaves_with_names((straight.params, straight.opt_state))
                 if x.is_floating_point() and not torch.isfinite(x).all()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"losses {losses}")
    walls = list(straight.step_times)
    step_s = sorted(walls[1:])[len(walls[1:]) // 2]
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    grads = grad_report(straight.grad_stats)
    profiled = lm_train_profile(straight, card)
    del straight
    torch.cuda.empty_cache()
    rep = {"depth": depth, "losses": losses, "grads": grads,
           "trace": profiled,
           "nonfinite_state": nonfinite,
           "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in walls],
           "tokens_per_s": tokens / step_s, "peak_device_bytes": peak,
           "ckpt_bytes": ckpt_bytes,
           "ckpt_write_s": resumed.ckpt_times["write"],
           "ckpt_save_call_s": resumed.ckpt_times["save_call"],
           "ckpt_restore_s": resumed.ckpt_times["restore"]}
    print(f"lm train on {card}: {LM_ARCH} full width (d {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), depth "
          f"{depth} (cut from {base_cfg.n_layers}), {cfg.quant}, "
          f"{cfg.dtype} activations, fp32 masters, remat {cfg.remat}, "
          f"S-AdaMax, batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}: losses "
          + ", ".join(f"step {k} {v:.6f}" for k, v in sorted(losses.items()))
          + f"; step {rep['step_ms']:.1f} ms (median of steps 1-"
          f"{LM_TRAIN_STEPS - 1}, wall, a checkpoint's device-to-host copy "
          f"outside it), {rep['tokens_per_s']:.0f} tokens/s; peak device "
          f"memory {peak / 1e9:.2f} GB; resumed at step 2 after a stopped "
          f"run: losses of steps 2-3 and final params and moments equal "
          f"the straight run's bit for bit")
    for i, g in enumerate(grads):
        print(f"  step {i}: largest |gradient| {g['max']:.3e} ({g['argmax']}),"
              f" non-finite gradient leaves {g['nonfinite']}")
    print(f"  non-finite elements in the final params and moments: "
          f"{nonfinite or 'none'}")
    print(f"  checkpoint (fp32 masters + S-AdaMax m, u) {ckpt_bytes / 1e9:.3f} "
          f"GB; save call (device-to-host copy) "
          + ", ".join(f"{t:.2f}" for t in rep["ckpt_save_call_s"])
          + " s; write " + ", ".join(f"{t:.2f}" for t in rep["ckpt_write_s"])
          + " s; restore " + ", ".join(f"{t:.2f}" for t in
                                       rep["ckpt_restore_s"]) + " s")
    return resumed, cfg, rep


def lm_train_profile(tr, card):
    """One more step of trainer `tr`, profiled (`trace`: two steps run,
    which move its params on)."""
    batch = tr._batch(LM_TRAIN_STEPS)

    def step():
        tr.params, tr.opt_state, _ = tr.train_step(tr.params, tr.opt_state,
                                                   batch, None)
    t = trace(step, top=8)
    print_trace(f"trace lm train step on {card}", t)
    return t


def lm_trained_serve(tr, cfg, seed, dev, root):
    """The trained masters saved with packed_binary=True, restored as
    PackedWeights (no fp32 master rebuilt) and served by phase 6's engine
    (`lm_engine_check`: tokens through the kernels equal the plain
    versions', launches as phase 6's); the tokens must also equal those of
    the engine on model.freeze(trained masters). Returns (launches,
    report)."""
    from repro_torch.core.packed import PackedWeight
    mgr = tr.ckpt
    mgr.async_save = False
    step = LM_TRAIN_STEPS + 100
    t0 = time.perf_counter()
    mgr.save(step, tr.params, packed_binary=True)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = mgr.restore(step, tr.params, device=dev)
    restore_s = time.perf_counter() - t0
    n_packed = sum(isinstance(x, PackedWeight)
                   for x in [packed["blocks"]["attn"][k] for k in
                             ("wq", "wk", "wv", "wo")]
                   + [packed["blocks"]["ffn"][k] for k in
                      ("w_gate", "w_up", "w_down")])
    if n_packed != 7 or packed["embed"].dtype != torch.float32:
        raise AssertionError("the packed checkpoint did not restore to "
                             "PackedWeights")
    packed_bytes = step_bytes(mgr, step)
    launches, _, reqs, got = lm_engine_check(
        cfg, seed, dev, frozen=packed, what="lm trained-checkpoint serve")
    eng = lm_engine(cfg.scaled(kv_bits=1), tr.params, freeze=True, seed=seed)
    want = eng.generate(reqs)
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"request {i}: restored-checkpoint tokens "
                                 f"{a.tolist()} != freeze(masters)' "
                                 f"{b.tolist()}")
    del eng, packed
    torch.cuda.empty_cache()
    print(f"lm trained-checkpoint serve: packed_binary checkpoint "
          f"{packed_bytes / 1e9:.3f} GB (saved in {save_s:.2f} s, restored "
          f"to PackedWeights in {restore_s:.2f} s): tokens equal the plain "
          f"path's and freeze(trained masters)'")
    return launches, {"packed_ckpt_bytes": packed_bytes,
                      "packed_save_s": save_s, "packed_restore_s": restore_s}


def clip_key_path(name: str) -> bool:
    from repro_torch.train.step import _CLIP_KEYS
    return any(part in _CLIP_KEYS for part in name.split("/"))


def inspecting(opt, seen):
    """`opt` that records, per gradient leaf, whether it is finite and its
    largest magnitude (device tensors, read later), before its update."""
    from repro_torch.checkpoint.manager import leaves_with_names
    from repro_torch.optim.base import Optimizer

    def update(g, s, p, donate=False):
        named = leaves_with_names(g)
        seen.append(([n for n, _ in named],
                     torch.stack([torch.isfinite(x).all() for _, x in named]),
                     torch.stack([x.abs().max().float() for _, x in named])))
        return opt.update(g, s, p, donate=donate)
    return Optimizer(opt.init, update)


def grad_report(seen) -> list[dict]:
    """Per step: the non-finite gradient leaves, the largest |gradient|
    and its leaf."""
    out = []
    for names, fin, top in seen:
        fin, top = fin.tolist(), top.tolist()
        i = max(range(len(top)), key=lambda j: top[j])
        out.append({"nonfinite": [n for n, f in zip(names, fin) if not f],
                    "max": top[i], "argmax": names[i],
                    "zero": [n for n, t in zip(names, top) if t == 0.0]})
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN payloads included)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def scaled_grads(model, params, batch):
    """Per gradient leaf of the loss scaled by 2^-GRAD_SCALE_EXP (the
    backward is linear in its seed and a power of two scales every float
    exactly, short of underflow): (name, finite, largest |gradient| of the
    unscaled loss in float64, this scaled maximum x 2^GRAD_SCALE_EXP)."""
    from repro_torch.checkpoint.manager import leaves_with_names
    from repro_torch.optim.base import tree_leaves, tree_unflatten_like
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = model.loss(tree_unflatten_like(params, leaves), batch)
    grads = torch.autograd.grad(loss * 2.0 ** -GRAD_SCALE_EXP, leaves)
    named = leaves_with_names(tree_unflatten_like(params, list(grads)))
    fin = torch.stack([torch.isfinite(g).all() for _, g in named]).tolist()
    top = torch.stack([g.abs().max().double() for _, g in named]).tolist()
    return [(n, f, t * 2.0 ** GRAD_SCALE_EXP)
            for (n, _), f, t in zip(named, fin, top)]


def family_train_steps(seed, dev, card):
    """One train step of each other family at full width, depth cut so
    that masters, gradients and S-AdaMax's moments fit (the moments
    allocated at the update, after the backward, `lazy_state`); the vlm's
    image embeddings N(0, 1) from the seed. The loss must be finite. Every
    gradient leaf of the step must be finite, or the step's backward must
    be shown to overflow float32: the reference's binarized backward
    multiplies the residual's gradient by ~sqrt(K) at each +-1 matmul,
    unnormalized, so its size grows by orders of magnitude a block. The
    proof is the same loss's backward from the same params scaled by
    2^-GRAD_SCALE_EXP (`scaled_grads`): every leaf finite there, and the
    embedding's largest |gradient| over the batch's B S positions (its
    rows sum the residual's gradient at their positions) above float32's
    largest value, so the residual's gradient overflows in the step. In
    the scaled backward every leaf under train.step._CLIP_KEYS has a
    non-zero gradient."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import LMDataConfig, SyntheticLM
    from repro_torch.models.api import get_model, param_count
    from repro_torch.train.step import default_optimizer, make_train_step
    f32_max = float(torch.finfo(torch.float32).max)
    rows, failed = [], []
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train steps: {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
          f"allocated before the first")
    for arch, depth in TRAIN_FAMILIES:
        base = get_config(arch)
        cfg = base.scaled(n_layers=depth)
        torch.cuda.reset_peak_memory_stats(dev)
        model = get_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = model.init(gen, device=dev)
        if cfg.family == "vlm":    # the gates N(0, 1), as phase 13's: at
            # its init's 0 no gradient reaches the cross-attention weights
            params["groups"]["cross"]["attn"]["gate"].normal_(generator=gen)
        n_params = param_count(params)
        toks = SyntheticLM(LMDataConfig(
            vocab=cfg.vocab, seq_len=FAMILY_TRAIN_SEQ,
            global_batch=FAMILY_TRAIN_BATCH, seed=seed)).batch(0)["tokens"]
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if cfg.family == "vlm":
            batch["img_emb"] = torch.randn(
                (FAMILY_TRAIN_BATCH, cfg.n_img_tokens, cfg.d_vision),
                generator=gen, device=dev).to(cfg.activation_dtype)
        scaled = scaled_grads(model, params, batch)
        torch.cuda.empty_cache()
        seen = []
        step = make_train_step(model, inspecting(
            lazy_state(default_optimizer(cfg)), seen))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, None, batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        g = grad_report(seen)[0]
        true_max = {n: t for n, _, t in scaled}
        zero = [n for n, _, t in scaled if clip_key_path(n) and t == 0.0]
        bad = [n for n, f, _ in scaled if not f]
        overflow = true_max["embed"] / (FAMILY_TRAIN_BATCH
                                         * FAMILY_TRAIN_SEQ) > f32_max
        if not np.isfinite(loss) or zero or bad \
                or (g["nonfinite"] and not overflow):
            failed.append(f"{arch}: loss {loss}, non-finite gradients "
                          f"{g['nonfinite']} (scaled: {bad}), zero scaled "
                          f"gradients under the clip keys {zero}")
        n_clip = sum(clip_key_path(n) for n, _, _ in scaled)
        top = max(scaled, key=lambda r: r[2])
        rows.append({"arch": arch, "depth": depth, "params": n_params,
                     "loss": loss, "step_ms": wall * 1e3, "grads": g,
                     "true_max": true_max, "overflow": g["nonfinite"],
                     "peak_device_bytes": peak})
        print(f"train step {arch} on {card}: full width, depth {depth} (cut "
              f"from {base.n_layers}), {n_params / 1e9:.3f} B params, batch "
              f"{FAMILY_TRAIN_BATCH} x {FAMILY_TRAIN_SEQ}: loss {loss:.6f}; "
              f"{len(scaled)} gradient leaves, non-zero under the "
              f"{n_clip} clip keys; largest |gradient| {top[2]:.3e} "
              f"({top[0]}; from the 2^-{GRAD_SCALE_EXP}-scaled backward, "
              f"every leaf finite there); the step's non-finite leaves "
              + (f"{g['nonfinite']}: float32 overflow (the embedding's "
                 f"largest |gradient| {true_max['embed']:.3e} over "
                 f"{FAMILY_TRAIN_BATCH * FAMILY_TRAIN_SEQ} positions > "
                 f"{f32_max:.3e})" if g["nonfinite"] else "none")
              + f"; step {wall * 1e3:.1f} ms (the model's first), peak "
              f"device memory {peak / 1e9:.2f} GB")
        del params, state, step, seen, batch, model
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return rows


def lazy_state(opt):
    """`opt` whose state is allocated at its first update (init gives
    None), so that the first step's backward never holds it: S-AdaMax's
    zero moments are the same whenever they are made."""
    from repro_torch.optim.base import Optimizer

    def update(g, s, p, donate=False):
        return opt.update(g, opt.init(p) if s is None else s, p,
                          donate=donate)
    return Optimizer(lambda p: None, update)


class CpuAttention(torch.autograd.Function):
    """The float attention of a card run computed on the CPU (forward and
    backward), so that a step of a family whose attention meets exact ties
    compares with the CPU's; each sign the card's own attention output
    disagrees on must lie within float32's rounding bound of 0 (an exact
    tie: a sum of T terms p v, each rounded by 2^-24 at most)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, q_offset, ties):
        from repro_torch.models import attention as A
        cpu = [x.detach().cpu().requires_grad_(True) for x in (q, k, v)]
        with torch.enable_grad():
            out = A.flash_attention(*cpu, causal, window, chunk, q_offset)
        mine = A.flash_attention(q.detach(), k.detach(), v.detach(), causal,
                                 window, chunk, q_offset).cpu()
        part = (mine >= 0) != (out.detach() >= 0)
        if part.any():
            bound = k.shape[1] * 2.0 ** -23 * float(v.detach().abs().max())
            if float(mine[part].abs().max()) > bound or \
                    float(out.detach()[part].abs().max()) > bound:
                raise AssertionError("card and CPU attention part beyond a "
                                     "tie")
            ties.append(int(part.sum()))
        ctx.saved = (cpu, out)
        return out.detach().to(q.device)

    @staticmethod
    def backward(ctx, g):
        cpu, out = ctx.saved
        grads = torch.autograd.grad(out, cpu, g.cpu())
        return (*(x.to(g.device) for x in grads), None, None, None, None,
                None)


def moments_parity(got, want, rel, scale):
    """(params, AdaMaxState) after one S-AdaMax step on two devices: the
    moments within rel of each tensor's largest magnitude, params there too
    except where the per-element normalization carries the moments'
    difference further (tests/_torch_moments.py: a noise-floor gradient, an
    AP2 boundary, or through a shared AP2 factor). A slice at a time on
    got's device. Returns the counts."""
    from repro_torch.core.ap2 import ap2_exponent
    from repro_torch.optim.base import tree_leaves
    (pg, sg), (pc, sc) = got, want
    for a, b in zip(tree_leaves((sg.m, sg.u)), tree_leaves((sc.m, sc.u)),
                    strict=True):
        if max_rel(a, b) > rel:
            raise AssertionError(f"moments differ by {max_rel(a, b)} > {rel}")
    counts = {"noise_floor": 0, "ap2": 0, "carried": 0}
    for p_g, p_c, m_g, m_c, u_g, u_c in zip(
            tree_leaves(pg), tree_leaves(pc), tree_leaves(sg.m),
            tree_leaves(sc.m), tree_leaves(sg.u), tree_leaves(sc.u),
            strict=True):
        top = float(p_c.abs().max())
        floor = rel * float(m_c.abs().max())
        for (pa, pb), (ma, mb), (ua, ub) in zip(
                slice_pairs(p_g, p_c), slice_pairs(m_g, m_c),
                slice_pairs(u_g, u_c)):
            e_g = ap2_exponent(1.0 / (ua.float() + 1e-8))
            e_c = ap2_exponent(1.0 / (ub.float() + 1e-8))
            diff = (pa - pb).abs()
            off = diff > rel * top
            noise = (ma.abs() <= floor) & (mb.abs() <= floor)
            ap2 = ~noise & (e_g != e_c)
            carried = ~noise & (e_g == e_c) & (
                diff <= scale * (ma - mb).abs() * 2.0 ** e_c.double()
                * (1 + 1e-6) + rel * top)
            if bool((off & ~(noise | ap2 | carried)).any()):
                raise AssertionError("params differ beyond what the "
                                     "moments' difference explains")
            counts["noise_floor"] += int((off & noise).sum())
            counts["ap2"] += int((off & ap2).sum())
            counts["carried"] += int((off & carried).sum())
    return counts


def smoke_train_cpu_checks(seed, dev):
    """Each family's smoke config (float32): one make_train_step step on the
    card and on the CPU from the same params and batch: loss within 1e-5,
    gradients and moments within LM_TRAIN_REL of each tensor's largest
    magnitude, params held through the moments (`moments_parity`); the
    unroped families' attention taken from the CPU on the card
    (`CpuAttention`), every parting sign proved an exact tie."""
    import unittest.mock
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_model
    from repro_torch.optim.base import Optimizer, tree_leaves, tree_map
    from repro_torch.train.step import default_optimizer, make_train_step
    lr = 1e-3
    scale = float(2.0 ** np.round(np.log2(np.float32(lr) / np.float32(0.1))))
    rows, failed = {}, []
    for arch in SMOKE_TRAIN_ARCHS:
        cfg = smoke_config(arch)
        params = get_model(cfg).init(torch.Generator().manual_seed(seed),
                                     device="cpu")
        rng = np.random.default_rng(seed)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (2, 24)).astype(np.int32))}
        if cfg.family == "vlm":
            batch["img_emb"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.n_img_tokens, cfg.d_vision)).astype(np.float32))
        ties, runs = [], []
        for d in (dev, torch.device("cpu")):
            opt = default_optimizer(cfg, lr)
            seen = {}

            def update(g, s, p, donate=False, opt=opt, seen=seen):
                seen["g"] = tree_map(torch.clone, g)
                return opt.update(g, s, p)
            p = tree_map(lambda t: t.to(d), params)
            swap = contextlib.nullcontext()
            if d.type == "cuda" and arch in UNROPED_ARCHS:
                swap = unittest.mock.patch.object(
                    T, "flash_attention", lambda q, k, v, causal=True,
                    window=0, chunk=512, q_offset=0: CpuAttention.apply(
                        q, k, v, causal, window, chunk, q_offset, ties))
            with swap:
                p2, st, m = make_train_step(
                    get_model(cfg), Optimizer(opt.init, update))(
                    p, opt.init(p), {k: v.to(d) for k, v in batch.items()})
            runs.append((p2, st, seen["g"], float(m["loss"])))
        (pg, sg, gg, lg), (pc, sc, gc, lc) = runs
        worst = max(max_rel(a, b) for a, b in zip(
            tree_leaves(gg), tree_leaves(gc), strict=True))
        try:
            if abs(lg - lc) > 1e-5 * abs(lc):
                raise AssertionError(f"card loss {lg!r} vs CPU {lc!r}")
            if worst > LM_TRAIN_REL:
                raise AssertionError(f"gradients differ by {worst}")
            counts = moments_parity((pg, sg), (pc, sc), LM_TRAIN_REL, scale)
        except AssertionError as e:
            failed.append(f"{arch}: {e}")
            print(f"train card vs CPU {arch}: FAILED {e} (loss {lg!r} / "
                  f"{lc!r}, gradients within {worst:.3g}, ties {ties})")
            continue
        rows[arch] = {"loss_card": lg, "loss_cpu": lc, "grad_rel": worst,
                      "params_off": counts, "ties": ties}
        print(f"train card vs CPU {arch} (smoke, float32): loss {lg:.7f} / "
              f"{lc:.7f}, gradients within {worst:.3g} (tolerance "
              f"{LM_TRAIN_REL}), params off by more in {counts}"
              + (f"; attention from the CPU, exact ties {ties}" if arch in
                 UNROPED_ARCHS else ""))
    if failed:
        raise AssertionError("; ".join(failed))
    return rows


def lm_train_phase(seed, dev, card):
    """Phase 14: the phi3-medium-14b trainer run with its bit-exact resume,
    one profiled step, the packed checkpoint served through the kernels,
    one step of each other family at full width, and the smoke steps on
    the card against the CPU. Returns (the serving run's launches,
    report)."""
    from repro_torch.configs.base import get_config
    t0 = time.perf_counter()
    root = ROOT / "build" / "lm_train"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    try:
        tr, cfg, rep = lm_train_check(get_config(LM_ARCH), seed, dev, card,
                                      root)
        tr.opt_state = None
        torch.cuda.empty_cache()
        launches, rep["serve"] = lm_trained_serve(tr, cfg, seed, dev, root)
        del tr
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 14 lm train: {time.perf_counter() - t0:.1f} s")
    rep["card_vs_cpu"] = smoke_train_cpu_checks(seed, dev)
    rep["families"] = family_train_steps(seed, dev, card)
    print(f"phase 14 (lm train): {time.perf_counter() - t0:.1f} s")
    return launches, rep


def lifecycle_checks(cfg, frozen, reqs6, tokens6, seed, dev):
    """Phase 15's serving checks on `frozen` (cfg at kv_bits=1): the
    fault-free and the faulted run of the paged engine with the prefix
    cache and the watchdog, freeze(kv_bits=1) on a live float-cache engine,
    and whole-prompt admission behind stale NaN V rows. Raises on any
    difference; returns (the main path's launch counts, report)."""
    import dataclasses
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.faults import parse_plan

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(seed + 15)
    reqs = list(reqs6) + [
        Request(rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                max_new_tokens=LM_NEW)
        for n in rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, 2)]
    kw = dict(seed=seed, page_size=LM_PAGE, prefix_cache=True,
              check_invariants=True)
    launches = {kn: 0 for kn in REPLACES}

    def count():
        sync()
        for kn, n in all_launches().items():
            launches[kn] += n

    def decode_rate(st):
        return (st["tokens_out"] - st["completed"]) / st["decode_s"]

    # fault-free, each audit timed on the host, after a warm-up request on
    # an engine of its own (the first calls at each shape would otherwise
    # land in this run's decode_s alone, not in the faulted run's)
    lm_engine(cfg, frozen, **kw).generate(
        [Request(reqs[0].prompt[:40], max_new_tokens=4)])
    clean = lm_engine(cfg, frozen, **kw)
    sched = clean.scheduler()
    audit_s = []
    audit = sched.audit

    def timed_audit():
        t = time.perf_counter()
        out = audit()
        audit_s.append(time.perf_counter() - t)
        return out
    sched.audit = timed_audit
    reset_all_launches()
    base = clean.serve(reqs)
    count()
    if any(c.status != "completed" for c in base):
        raise AssertionError("a fault-free lifecycle request did not complete")
    for i, (c, want) in enumerate(zip(base, tokens6)):
        if not np.array_equal(c.tokens, want):
            raise AssertionError(f"lifecycle request {i}: fault-free tokens "
                                 f"{c.tokens.tolist()} != phase 6's "
                                 f"{want.tolist()}")
    st0 = dict(sched.stats)

    # the faulted run
    plan = parse_plan(LIFECYCLE_PLAN)
    eng = lm_engine(cfg, frozen, fault_plan=plan, queue_cap=LIFECYCLE_CAP,
                    overflow="block", **kw)
    fs = eng.scheduler()
    reset_all_launches()
    rids = []
    for i, r in enumerate(reqs):
        late = i in LIFECYCLE_LATE
        rids.append(fs.submit(dataclasses.replace(r, deadline_s=1e-3)
                              if late else r))
        if late:
            time.sleep(LIFECYCLE_WAIT)   # its deadline passes in the queue
    comps = fs.run()
    count()
    fired = set(plan.fired)
    missed = [(f.site, i, f.kind) for f in plan.faults
              for i in range(f.index, f.index + f.times)
              if (f.site, i, f.kind) not in fired]
    statuses = [comps[r].status for r in rids]
    tally = tuple(statuses.count(k) for k in ("completed", "shed", "error"))
    if sorted(comps) != sorted(rids):
        raise AssertionError(f"faulted run: rids {sorted(comps)} resolved, "
                             f"{rids} submitted")
    if tally != LIFECYCLE_STATUSES or missed:
        raise AssertionError(f"faulted run: statuses {statuses} (completed, "
                             f"shed, error {tally}, want "
                             f"{LIFECYCLE_STATUSES}); faults not fired "
                             f"{missed}")
    for i, r in enumerate(rids):
        if i in LIFECYCLE_LATE and statuses[i] != "shed":
            raise AssertionError(f"faulted run: late request {i} {statuses[i]}")
        if statuses[i] == "completed" and \
                not np.array_equal(comps[r].tokens, base[i].tokens):
            raise AssertionError(f"faulted run: request {i} tokens "
                                 f"{comps[r].tokens.tolist()} != fault-free "
                                 f"{base[i].tokens.tolist()}")
    st = dict(fs.stats)
    if st["burst_retries"] != 2 or st["invariant_violations"] != 1 \
            or fs._use_tree:
        raise AssertionError(f"faulted run: stats {st}, tree on "
                             f"{fs._use_tree}")
    violations = fs.audit()
    fs._pager.check()
    if violations or fs._pager.allocated != 0:
        raise AssertionError(f"faulted run: pool {fs.page_stats()}, audit "
                             f"{violations}")
    errors = sorted({comps[r].error for r in rids if comps[r].error})

    # freeze(kv_bits=1) on phase 6's engine built with the float cache
    sw = ServingEngine(cfg.scaled(kv_bits=0), frozen, kv_bits=0,
                       prefill_chunk=LM_CHUNK, slots=LM_SLOTS,
                       max_len=LM_MAX_LEN, seed=seed)
    sw.generate(reqs6[:2])
    sw.freeze(kv_bits=1)
    reset_all_launches()
    switched = sw.generate(reqs6)
    sync()
    sw_launches = all_launches()
    count()
    for i, (a, b) in enumerate(zip(switched, tokens6, strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"freeze(kv_bits=1) request {i}: tokens "
                                 f"{a.tolist()} != a fresh kv_bits=1 "
                                 f"engine's {b.tolist()}")
    for kn in ("decode_attention_packed", "prefill_attention_packed"):
        if dev.type == "cuda" and not sw_launches[kn]:
            raise AssertionError(f"freeze(kv_bits=1): no {kn} launch")
    del sw

    # whole-prompt admission behind stale NaN V rows (the default engine)
    cfg0 = cfg.scaled(kv_bits=0)
    by_len = sorted(reqs6, key=lambda r: len(r.prompt))
    nxt = Request(by_len[0].prompt, max_new_tokens=LM_NEW)
    s = len(nxt.prompt)
    stale = ServingEngine(cfg0, frozen, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                          seed=seed)
    stale.generate([Request(r.prompt, max_new_tokens=4)
                    for r in by_len[-LM_SLOTS:]])
    stale.scheduler()._cache["v"][..., s:, :, :] = float("nan")
    got = stale.serve([nxt])[0]
    want = ServingEngine(cfg0, frozen, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                         seed=seed).generate([nxt])[0]
    if got.status != "completed" or not np.array_equal(got.tokens, want):
        raise AssertionError(f"stale NaN V: {got.status} {got.error} "
                             f"tokens {got.tokens.tolist()} != clean "
                             f"{want.tolist()}")
    del stale
    rep = {
        "requests": len(reqs), "statuses": statuses, "errors": errors,
        "fired": [list(f) for f in plan.fired],
        "faulted_stats": {k: st[k] for k in (
            "burst_retries", "invariant_violations", "shed", "errors",
            "rejected", "prefix_hits", "bursts", "decode_s")},
        "fault_free_decode_tok_per_s": decode_rate(st0),
        "faulted_decode_tok_per_s": decode_rate(st),
        "audits": len(audit_s), "bursts": st0["bursts"],
        "audit_host_ms_mean": 1e3 * float(np.mean(audit_s)),
        "audit_host_ms_max": 1e3 * float(np.max(audit_s)),
        "switch_launches": sw_launches, "stale_prompt_len": s}
    return launches, rep


def lm_f32_whole_vs_chunked(cfg, frozen, seed, dev, card):
    """The default engine's whole-prompt admission against chunked
    admission at all layers in float32 (the float leaves of the timed
    run's frozen weights cast up), on phase 6's traffic: the share of equal
    requests and leading tokens in common, and for the first request that
    parts, each layer's K/V cache rows after prefill, whole against
    chunked: entries that differ and the largest difference. A layer whose
    K rows are equal took equal signs in (its input is binarized), so the
    first layer with a differing K row is where the two paths part; the
    first attention output (the float input of wo's binarized matmul)
    whose sign differs is printed with both values and its row's scale.
    Printed, not held: the parting is the reference's semantics (the flash
    formula's float32 sums of scaled products against the chunked
    formula's exact integer dots; JAX parts alike,
    tests/test_torch_attention_order.py; ROADMAP Queue C's recorded
    differences)."""
    from repro_torch.core.packed import map_tree
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = cfg.scaled(kv_bits=0, dtype="float32")
    f32 = map_tree(lambda _, p: p.float() if isinstance(p, torch.Tensor)
                   and p.is_floating_point() else p, frozen)
    prompts = lm_traffic(seed, cfg.vocab)
    reqs = [Request(p, max_new_tokens=LM_NEW) for p in prompts]
    base = dict(slots=LM_SLOTS, max_len=LM_MAX_LEN, seed=seed)
    t0 = time.perf_counter()
    whole = ServingEngine(cfg, f32, **base).generate(reqs)
    chunked = ServingEngine(cfg, f32, prefill_chunk=LM_CHUNK,
                            **base).generate(reqs)
    same = [int(np.array_equal(a, b)) for a, b in zip(whole, chunked)]
    lead = [int(np.argmin(np.r_[a == b, False]))
            for a, b in zip(whole, chunked)]
    layers, flip = [], None
    parted = [i for i, ok in enumerate(same) if not ok]
    if parted:
        p = prompts[parted[0]]
        tok = torch.from_numpy(p[None].astype(np.int64)).to(dev)
        cw = T.init_cache(cfg, 1, LM_MAX_LEN, device=dev)
        cc = T.init_cache(cfg, 1, LM_MAX_LEN, device=dev)
        # each layer's float attention output, the one float input of a
        # binarized matmul (wo) that the two admissions compute apart
        outs = {"whole": [], "chunked": []}

        def capture(fn, key):
            def call(*a, **k):
                out = fn(*a, **k)
                outs[key].append(out.float().reshape(out.shape[1], -1))
                return out
            return call
        with unittest.mock.patch.object(
                T, "flash_attention", capture(T.flash_attention, "whole")), \
                unittest.mock.patch.object(
                    T, "chunk_attention",
                    capture(T.chunk_attention, "chunked")):
            T.transformer_prefill(f32, cfg, tok, cache=cw)
            nvs = []
            for lo in range(0, len(p), LM_CHUNK):
                nv = min(LM_CHUNK, len(p) - lo)
                ch = torch.zeros((1, LM_CHUNK), dtype=torch.int64, device=dev)
                ch[0, :nv] = tok[0, lo:lo + nv]
                T.transformer_prefill_chunk(f32, cfg, ch, cc, 0, lo, nv)
                nvs.append(nv)
        n = cfg.n_layers
        for layer in range(n):
            a = outs["whole"][layer]
            b = torch.cat([outs["chunked"][c * n + layer][:nv]
                           for c, nv in enumerate(nvs)])
            differ = (a >= 0) != (b >= 0)
            if differ.any():
                pos, j = (int(i) for i in differ.nonzero()[0])
                flip = {"layer": layer, "position": pos, "element": j,
                        "signs_differing": int(differ.sum()),
                        "whole": float(a[pos, j]), "chunked": float(b[pos, j]),
                        "row_max_abs": float(a[pos].abs().max()),
                        "layer_max_diff": float((a - b).abs().max()),
                        "layer_max_abs": float(a.abs().max())}
                break
        del outs
        for layer in range(cfg.n_layers):
            row = {"layer": layer}
            for name in ("k", "v"):
                a = cw[name][layer, 0, :len(p)]
                b = cc[name][layer, 0, :len(p)]
                row[f"{name}_differ"] = int((a != b).sum())
                row[f"{name}_max_diff"] = float((a - b).abs().max())
                row[f"{name}_max_abs"] = float(a.abs().max())
                row[f"{name}_positions"] = int((a != b).flatten(1).any(1)
                                               .sum())
            layers.append(row)
        del cw, cc
    first = next((r["layer"] for r in layers if r["k_differ"]), None)
    rep = {"equal_requests": same, "leading_tokens_in_common": lead,
           "first_parting_request": parted[0] if parted else None,
           "first_layer_k_differs": first, "first_sign_flip": flip,
           "layers": layers,
           "seconds": time.perf_counter() - t0}
    print(f"lm float32 whole-prompt against chunked on {card} (a recorded "
          f"difference of the reference, not a port fault: flash sums "
          f"scaled products, chunks sum exact integer dots): {LM_ARCH} "
          f"{cfg.n_layers} layers, float32 activations and cache, phase 6's "
          f"traffic: {sum(same)} of {len(same)} requests equal, leading "
          f"tokens in common {lead} ({rep['seconds']:.1f} s)")
    if parted:
        diffs = [(r["layer"], r["k_positions"], r["k_differ"],
                  r["v_differ"], f"{r['v_max_diff']:.3g}") for r in layers
                 if r["k_differ"] or r["v_differ"]][:6]
        print(f"  request {parted[0]} (prompt {len(prompts[parted[0]])}) "
              f"after prefill, whole against chunked: first layer whose K "
              f"rows differ {first}; (layer, positions whose K differs, K "
              f"entries differing, V entries differing, V max diff) of the "
              f"first differing layers {diffs}")
        print(f"  the first float attention output (wo's binarized input) "
              f"whose sign differs, whole against chunked: {flip}")
    del f32
    torch.cuda.empty_cache()
    return rep


def lifecycle_phase(base_cfg, seed, dev, card, reqs6, tokens6):
    """Phase 15, the serving lifecycle: phase 6's weights (full width,
    depth LM_CHECK_DEPTH, the same draw) through `lifecycle_checks`; the
    zero fill of a whole-prompt admission timed at all 40 layers; the
    serving CLI once on the card under CLI_PLAN. Returns (launches,
    report)."""
    from repro_torch.kernels import tune
    from repro_torch.models.api import get_model
    t0 = time.perf_counter()
    cfg = base_cfg.scaled(n_layers=LM_CHECK_DEPTH, kv_bits=1)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)      # phase 6's
    frozen = model.freeze(model.init(gen, device=dev))
    torch.cuda.empty_cache()
    launches, rep = lifecycle_checks(cfg, frozen, reqs6, tokens6, seed, dev)
    del frozen
    torch.cuda.empty_cache()

    # the zero fill of a whole-prompt admission, at all layers: K and V rows
    # [s, max_len) of one slot, s the shortest prompt of the traffic
    shape = (base_cfg.n_layers, LM_SLOTS, LM_MAX_LEN, base_cfg.n_kv_heads,
             base_cfg.head_dim)
    kv = [torch.ones(shape, dtype=base_cfg.activation_dtype, device=dev)
          for _ in range(2)]
    s = LM_PROMPT[0]

    def fill():
        for c in kv:
            c[..., 0:1, s:, :, :].zero_()
    fill_ms = device_ms(fill)
    fill_bytes = 2 * base_cfg.n_layers * (LM_MAX_LEN - s) * \
        base_cfg.n_kv_heads * base_cfg.head_dim * kv[0].element_size()
    del kv
    torch.cuda.empty_cache()

    # the serving CLI in a process of its own, on the card
    import repro_torch
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    argv = ["--arch", LM_ARCH, "--smoke", "--freeze", "--kv-bits", "1",
            "--queue", "--prefill-chunk", "4", "--page-size", "4",
            "--prefix-cache", "--queue-cap", "3", "--batch", str(CLI_BATCH),
            "--prompt-len", "12", "--max-new", "8", "--inject-faults",
            CLI_PLAN]
    t_cli = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *argv], env=env, capture_output=True, text=True,
                         timeout=300)
    cli_s = time.perf_counter() - t_cli
    lines = run.stdout.splitlines()
    if run.returncode:
        raise AssertionError(f"serve CLI exited {run.returncode}: "
                             f"{run.stderr[-2000:]}")
    want = {"REJECT": CLI_BATCH - 3, "ERROR  rid=1": 1, "done   rid=0": 1,
            "done   rid=2": 1}
    got = {k: sum(k in ln for ln in lines) for k in want}
    res = [ln for ln in lines if ln.startswith("resilience:")]
    want_res = (f"resilience: 0 shed, 1 errored, {CLI_BATCH - 3} rejected at "
                f"cap, 2 burst retries, 0 invariant violations (degraded to "
                f"cache bypass)")
    if got != want or res != [want_res]:
        raise AssertionError(f"serve CLI lines {got} != {want}, {res}: "
                             + "\n".join(lines))
    rep.update({"zero_fill_ms": fill_ms, "zero_fill_bytes": fill_bytes,
                "zero_fill_bound_ms": fill_bytes / tune.HBM_BYTES_PER_S * 1e3,
                "cli_s": cli_s, "cli_lines": lines,
                "seconds": time.perf_counter() - t0})
    print(f"lifecycle (phase 15) on {card}: {LM_ARCH} full width, depth "
          f"{LM_CHECK_DEPTH}, paged kv_bits=1 + prefix cache + watchdog, "
          f"{rep['requests']} requests; faulted under {LIFECYCLE_PLAN!r}, "
          f"queue cap {LIFECYCLE_CAP} (block), requests {LIFECYCLE_LATE} "
          f"late: statuses {rep['statuses']}, errors {rep['errors']}; "
          f"survivors' tokens equal the fault-free run's, whose equal phase "
          f"6's; stats {rep['faulted_stats']}; pool audits clean")
    print(f"  decode tok/s faulted {rep['faulted_decode_tok_per_s']:.2f} "
          f"against fault-free {rep['fault_free_decode_tok_per_s']:.2f} "
          f"(decode_s holds the injected stall and the retries' backoff)")
    print(f"  audit() host ms on the {LM_POOL}-page pool: mean "
          f"{rep['audit_host_ms_mean']:.4f}, max "
          f"{rep['audit_host_ms_max']:.4f} over {rep['audits']} calls in "
          f"{rep['bursts']} bursts (one per burst)")
    print(f"  zero fill per whole-prompt admission ({base_cfg.n_layers} "
          f"layers, max_len {LM_MAX_LEN}, rows [{s}, {LM_MAX_LEN}) of K and "
          f"V): device {fill_ms:.4f} ms, {fill_bytes / 1e6:.1f} MB written, "
          f"bound {rep['zero_fill_bound_ms']:.4f} ms")
    print(f"  freeze(kv_bits=1) on a live float-cache engine: tokens equal a "
          f"fresh kv_bits=1 engine's, launches {rep['switch_launches']}; "
          f"whole-prompt admission behind NaN V rows past {s} tokens: "
          f"tokens equal a clean engine's")
    print(f"  serve CLI ({cli_s:.1f} s, exit 0): "
          + "; ".join(ln.strip() for ln in lines if "rid=" in ln
                      or "REJECT" in ln or ln.startswith("resilience")))
    print(f"phase 15 (lifecycle): {rep['seconds']:.1f} s")
    return launches, rep


def route_table_step(step, cfg, card, steps=10):
    """One decode step of phi3 at all layers with the route table and with
    every route pinned to the fixed rule (`tune.route_override`), in turns
    table, rule, rule, table in this run: device busy ms and launches (one
    profiled step), host wall ms (the mean of `steps` synchronised steps)
    and tok/s = slots / wall; and the kernels whose device ms in a step
    moved most between the two (summed over each mode's two steps). A
    measurement, not a claim."""
    from repro_torch.kernels import tune
    rows, by_kernel = [], {}
    for mode in ("table", "fixed rule", "fixed rule", "table"):
        pin = tune.route_override(**FIXED_RULE) if mode == "fixed rule" \
            else contextlib.nullcontext()
        with pin:
            t = trace(step, top=40)
            for name, _, ms in t["top"]:
                by_kernel.setdefault(name, {"table": 0.0, "fixed rule": 0.0})
                by_kernel[name][mode] += ms / 2
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps * 1e3
        rows.append({"mode": mode, "busy_ms": t["busy_ms"], "wall_ms": wall,
                     "launches": t["launches"],
                     "tok_per_s": LM_SLOTS / wall * 1e3})
    print(f"lm decode step (depth {cfg.n_layers}, {LM_SLOTS} slots at "
          f"position 300) on {card}, route table against the fixed rule, in "
          f"turns:")
    for r in rows:
        print(f"  {r['mode']:10s} busy {r['busy_ms']:.4f} ms, wall "
              f"{r['wall_ms']:.4f} ms, {r['launches']} launches, "
              f"{r['tok_per_s']:.2f} tok/s")
    moved = sorted(by_kernel.items(),
                   key=lambda kv: -abs(kv[1]["table"] - kv[1]["fixed rule"]))
    for name, ms in moved[:6]:
        print(f"  {name[:60]:60s} table {ms['table']:.4f} ms, fixed rule "
              f"{ms['fixed rule']:.4f} ms a step")
    return {"rows": rows, "by_kernel": by_kernel}


def entry_plan(kernel, shape, params, sms):
    """The launch a table entry names at a real `shape`, or None where
    dispatch clamps it to the fixed rule."""
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import tune
    if kernel in ("binary_gemm", "binary_gemm_fused"):
        kn = tune._gemm_kernel(kernel, shape)
        k = 32 * shape["kw"] - (ROUTE_K_SHORT if shape["kw"] > 1 else 0)
        return bg.plan_from_params(kn, shape["m"], shape["n"], k, sms, True,
                                   params)
    t = shape["t"]
    if "ps" in shape:
        t = max(1, -(-t // shape["ps"])) * shape["ps"]
    return pa.plan_from_params(shape["b"], shape.get("s", 1), t, shape["hkv"],
                               shape["g"], shape["hd"], params)


def dispatch_host_us(sms, calls=20000):
    """Host µs a launch spends choosing its plan, at phi3's decode-step
    shapes: the route table's memo hit (`routed_plan`, this tree) against
    the fixed rule computed on every call (`gemm_plan` / `attention_plan`,
    what the parent tree's wrappers ran)."""
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.kernels import prefill_attention as pa
    cases = {
        "binary_gemm_packed (4, 5120 -> 1280)": (
            lambda: bg.routed_plan("binary_gemm_packed", LM_SLOTS, 1280, 5120,
                                   sms, True, torch.int32),
            lambda: bg.gemm_plan("binary_gemm_packed", LM_SLOTS, 1280, 5120,
                                 sms, True)),
        "decode_attention (4, T 512)": (
            lambda: pa.routed_plan("decode_attention", LM_SLOTS, 1,
                                   LM_MAX_LEN, 10, 4, 128, sms, None, {}),
            lambda: pa.attention_plan(LM_SLOTS, 1, LM_MAX_LEN, 10, 4, 128,
                                      sms))}
    out = {}
    for name, fns in cases.items():
        us = []
        for fn in fns:
            fn()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            us.append((time.perf_counter() - t0) / calls * 1e6)
        out[name] = {"table_us": us[0], "rule_us": us[1]}
    return out


def route_table_phase(card, sms, cli_lines):
    """Phase 16, the route table on the card: `tune --check` (a gap fails
    the run); for every bucket of the card's standard shapes the table's
    winner launched through dispatch (route None) at a ragged shape inside
    the bucket (K off a word) and held to the plain version (GEMMs bit for
    bit; attention dots bit for bit, outputs within ATTN_TOL with equal
    signs), and at the shape the bucket was tuned at (a card bucket's
    recorded main-path shape); where the winner is not the fixed rule's
    launch, both timed at that shape (device µs, `tune.device_ms`); the
    buckets this run's launches resolved that the table lacks; the host µs of a plan choice;
    and the serving CLI's `kernel route` lines from phase 15's run."""
    from repro_torch.kernels import tune
    t0 = time.perf_counter()
    if tune.main(["--check"]) != 0:
        raise AssertionError("the card's route table misses standard buckets")
    table = tune.load_cache()
    SERVED_SHAPES.update(tune.seen)
    resolved = len(tune.seen)
    gap = sorted(f"{k} {key}" for k, key in tune.seen
                 if key not in table.get(k, {}))
    per, rows = {}, []
    for kernel, shapes in tune.standard_shapes().items():
        stats = per.setdefault(kernel, {"buckets": 0, "differ": 0,
                                        "clamped": 0, "max_ratio": 1.0})
        for shape in shapes:
            key = tune.bucket_key(shape)
            entry = table[kernel][key]
            rule = tune.rule_params(kernel, shape, sms)
            cut = tune.ragged(shape)
            _, check, _ = tune.problem(kernel, cut, k_short=ROUTE_K_SHORT)
            check(None, {})
            call, check, _ = tune.problem(kernel, shape)
            check(None, {})
            stats["buckets"] += 1
            stats["clamped"] += entry_plan(kernel, cut, entry["params"],
                                           sms) is None
            row = {"kernel": kernel, "key": key, "params": entry["params"],
                   "rule": rule, "ragged": cut}
            if entry["params"] != rule:
                row["tuned_us"] = 1e3 * device_ms(
                    lambda: call("cuda", entry["params"]))
                row["rule_us"] = 1e3 * device_ms(lambda: call("cuda", {}))
                stats["differ"] += 1
                stats["max_ratio"] = max(stats["max_ratio"],
                                         row["rule_us"] / row["tuned_us"])
            del call, check
            rows.append(row)
    torch.cuda.empty_cache()
    print(f"route table (phase 16) on {card}: {tune.cache_path().name}, "
          f"`tune --check` exit 0; each bucket's winner at the shape it "
          f"was tuned at and at a ragged shape inside it through dispatch "
          f"equals the plain version (GEMMs bit "
          f"for bit, attention dots bit for bit and outputs within "
          f"ATTN_TOL); winner against the fixed rule at the shape the bucket "
          f"was tuned at, device µs:")
    for kernel, st in per.items():
        print(f"  {kernel:24s} {st['buckets']:4d} buckets, {st['differ']:4d} "
              f"differ from the fixed rule, largest rule/tuned "
              f"{st['max_ratio']:.3f}, {st['clamped']} ragged launches "
              f"clamped to the rule")
    for r in rows:
        if "tuned_us" in r:
            print(f"    {r['kernel']:24s} {r['key']:40s} tuned {r['params']} "
                  f"{r['tuned_us']:.2f} us, rule {r['rule']} "
                  f"{r['rule_us']:.2f} us")
    print(f"  buckets this run's launches resolved before this phase: "
          f"{resolved}, not in the table (fixed rule): {len(gap)} {gap[:8]}")
    host = dispatch_host_us(sms)
    for name, h in host.items():
        print(f"  plan choice per launch, {name}: route table (memo hit) "
              f"{h['table_us']:.3f} host µs, fixed rule computed "
              f"{h['rule_us']:.3f} host µs")
    routes = [ln for ln in cli_lines if ln.startswith("kernel route ")]
    if not routes or any(": cuda" not in ln for ln in routes):
        raise AssertionError(f"serve CLI kernel route lines: {routes}")
    for ln in routes:
        print(f"  serve CLI: {ln}")
    rep = {"buckets": per, "rows": rows, "gap": gap, "host_us": host,
           "cli_routes": routes, "seconds": time.perf_counter() - t0}
    print(f"phase 16 (route table): {rep['seconds']:.1f} s")
    return rep


# the mesh (phase 17): the tensor-parallel wrappers at phi3's shapes (q and
# w_down at decode and chunk rows over MESH_GEMM_PARTS shards, the MLP's
# chain step for the fused GEMM, attention at B 4 / Hkv 10 / G 4 / hd 128 /
# T 512 over MESH_ATTN_PARTS); phase 6's engine on a 2 x 2 mesh of one card
# on phase 6's traffic plus MESH_SAMPLED requests at temperature 0.8, phase
# 6b's paged engine on a data-4 mesh, two replicas on the card and the
# CLI's --mesh / --replicas
MESH_GEMM_PARTS, MESH_ATTN_PARTS = (2, 4), (2, 5)
MESH_SAMPLED, MESH_TEMP = 2, 0.8
MESH_POS = 300                 # the profiled decode step's position


def card_mesh(dev, data, model=1):
    from repro_torch.launch.mesh import make_serving_mesh
    return make_serving_mesh(data, model, devices=[dev] * (data * model))


def tp_row(what, tp, one, parts, shard_calls, equal):
    """One wrapper against its unsharded launch: `equal(got, want)` checks
    the values, the launches of one call must be `parts`; device ms of the
    wrapper (with its split and join), of its shards' launches alone on
    pieces cut beforehand, and of the unsharded launch."""
    before = sum(all_launches().values())
    got = tp()
    torch.cuda.synchronize()
    launches = sum(all_launches().values()) - before
    if launches != parts:
        raise AssertionError(f"{what}: {launches} launches for {parts} "
                             f"shards")
    err = equal(got, one())
    return {"what": what, "parts": parts, "launches": launches,
            "max_abs_err": err, "tp_ms": device_ms(tp),
            "shards_ms": device_ms(shard_calls), "one_ms": device_ms(one)}


def tp_gemm_checks(dev_gen, dev, cfg):
    """binary_gemm_tp at phi3's q (packed lhs, kernel 1) and w_down (bf16
    lhs, kernel 2) at 4 and 32 rows, binary_gemm_fused_tp at the MNIST
    MLP's chain step (packed lhs, kernel 3), over MESH_GEMM_PARTS shards:
    dots and words bit for bit."""
    from repro_torch.configs.bnn_paper import BNN_MNIST
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.kernels import sharded as S
    rows = []
    gemms = [("phi3.q", "packed", cfg.d_model, cfg.n_heads * cfg.head_dim),
             ("phi3.w_down", "bf16", cfg.d_ff, cfg.d_model)]
    for parts in MESH_GEMM_PARTS:
        mesh = card_mesh(dev, 1, parts)
        for m in (LM_SLOTS, LM_CHUNK):
            for where, lhs, k, n in gemms:
                op = Operands(dev_gen, m, k, n)
                a = op.a if lhs == "packed" else op.x_bf16
                cut = n // parts
                pieces = [op.b[i * cut:(i + 1) * cut] for i in range(parts)]
                rows.append(tp_row(
                    f"binary_gemm_tp {where} M={m}",
                    lambda: S.binary_gemm_tp(a, op.b, k, mesh=mesh),
                    lambda: bg.dispatch_binary_gemm(a, op.b, k), parts,
                    lambda: [bg.dispatch_binary_gemm(a, p, k)
                             for p in pieces],
                    lambda x, y: check_equal(f"{where} tp dots", x, y)
                    or max_abs_diff(x, y, False)))
        cfgm = BNN_MNIST
        op = Operands(dev_gen, cfgm.batch, cfgm.hidden, cfgm.hidden)
        cut = cfgm.hidden // parts
        pieces = [(op.b[i * cut:(i + 1) * cut], op.thresh[i * cut:(i + 1) * cut],
                   op.flip[i * cut:(i + 1) * cut]) for i in range(parts)]
        rows.append(tp_row(
            f"binary_gemm_fused_tp mlp.chain M={cfgm.batch}",
            lambda: S.binary_gemm_fused_tp(op.a, op.b, op.thresh, op.flip,
                                           op.k, mesh=mesh),
            lambda: bg.dispatch_binary_gemm_fused(op.a, op.b, op.thresh,
                                                  op.flip, op.k), parts,
            lambda: [bg.dispatch_binary_gemm_fused(op.a, b, t, f, op.k)
                     for b, t, f in pieces],
            lambda x, y: check_equal("mlp chain tp words", x, y)
            or max_abs_diff(x, y, True)))
    return rows


def tp_attention_checks(dev_gen, dev, cfg, seed):
    """The four attention wrappers at phi3's heads over MESH_ATTN_PARTS
    shards, a decode step and a 32-row chunk, contiguous and paged (pages
    of LM_PAGE, LM_POOL of them): dots bit for bit, outputs within
    ATTN_TOL with equal signs against the unsharded launch."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import sharded as S
    rng = np.random.default_rng(seed)
    b, t, hkv, hd = LM_SLOTS, LM_MAX_LEN, cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // hkv
    dt = cfg.activation_dtype
    lens = torch.tensor([512, 300, 100, 17], dtype=torch.int32, device=dev)
    q1, kc, vc, vs = attention_case(dev_gen, b, 1, t, hkv, g, hd, dt, dev)
    qs = torch.randint(-6, 7, (b, LM_CHUNK, hkv * g, hd), generator=dev_gen,
                       device=dev).to(dt)
    _, kp, vp, _, table = paged_case(dev_gen, rng, b, 1, LM_PAGE,
                                     t // LM_PAGE, LM_POOL, hkv, g, hd,
                                     [256, 300, 100, 17], dt, dev)
    plens = torch.tensor([256, 300, 100, 17], dtype=torch.int32, device=dev)
    pos = (lens - LM_CHUNK).clamp(min=0)
    ppos = (plens - LM_CHUNK).clamp(min=0)
    cases = [("decode_attention_packed_tp", da.decode_attention_packed,
              S.decode_attention_packed_tp, (q1, kc, vc, vs, lens)),
             ("decode_attention_packed_paged_tp",
              da.decode_attention_packed_paged,
              S.decode_attention_packed_paged_tp,
              (q1, kp, vp, vs, table, plens)),
             ("prefill_attention_packed_tp", pa.prefill_attention_packed,
              S.prefill_attention_packed_tp,
              (qs, kc, vc, vs, pos + LM_CHUNK, pos)),
             ("prefill_attention_packed_paged_tp",
              pa.prefill_attention_packed_paged,
              S.prefill_attention_packed_paged_tp,
              (qs, kp, vp, vs, table, ppos + LM_CHUNK, ppos))]
    rows = []
    for parts in MESH_ATTN_PARTS:
        mesh = card_mesh(dev, 1, parts)
        for name, one, tp, args in cases:
            heads = hkv // parts
            q = args[0]
            pieces = [(q[:, :, i * heads * g:(i + 1) * heads * g]
                       .contiguous(),
                       args[1][:, :, i * heads:(i + 1) * heads].contiguous(),
                       args[2][:, :, i * heads:(i + 1) * heads].contiguous(),
                       args[3][:, i * heads:(i + 1) * heads].contiguous())
                      for i in range(parts)]

            def equal(got, want, name=name, args=args, tp=tp, one=one,
                      mesh=mesh):
                _, dots = tp(*args, mesh=mesh, return_dots=True)
                _, want_dots = one(*args, return_dots=True)
                check_equal(f"{name} dots", dots, want_dots)
                return check_close(f"{name} output", got, want, dt)

            rows.append(tp_row(
                f"{name} T={t}", lambda tp=tp, args=args, mesh=mesh:
                tp(*args, mesh=mesh), lambda one=one, args=args: one(*args),
                parts, lambda one=one, args=args, pieces=pieces:
                [one(*p, *args[4:]) for p in pieces], equal))
    return rows


def mesh_decode_trace(sched, dev):
    """One profiled decode step of every shard of `sched` at MESH_POS."""
    def step():
        for sh in sched._shards:
            pos = torch.full((sh.rows,), MESH_POS, dtype=torch.int32,
                             device=dev)
            sched.model.decode(sh.params, sh.state["cur"], sh.cache, pos)
    return trace(step)


def mesh_serving_checks(base_cfg, seed, dev, card, reqs6, tokens6):
    """phi3-medium-14b at full width, depth LM_CHECK_DEPTH (phase 6's
    weights and engine) on a 2 x 2 mesh of the card: phase 6's requests
    plus MESH_SAMPLED sampled ones give the single-device engine's tokens
    (phase 6's for the greedy ones); the paged + prefix engine on a data-4
    mesh gives phase 6b's engine's tokens on phase 6b's traffic; two
    replicas on the card give phase 6's tokens, and again with replica 0
    killed at its second poll. Returns (launches of the mesh run, report)."""
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request
    from repro_torch.serving.faults import Fault, FaultPlan
    from repro_torch.serving.replica import ReplicaServer
    cfg = base_cfg.scaled(n_layers=LM_CHECK_DEPTH, kv_bits=1)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)      # phase 6's
    frozen = model.freeze(model.init(gen, device=dev))
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 17)
    sampled = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32),
                       max_new_tokens=LM_NEW, temperature=MESH_TEMP)
               for n in rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1,
                                     MESH_SAMPLED)]
    reqs = list(reqs6) + sampled
    one = lm_engine(cfg, frozen, seed=seed)
    want = one.generate(reqs)
    for i, (a, b) in enumerate(zip(want[:len(tokens6)], tokens6)):
        check_equal(f"single-device request {i} vs phase 6",
                    torch.from_numpy(a), torch.from_numpy(b))
    mesh = card_mesh(dev, 2, 2)
    eng = lm_engine(cfg, frozen, seed=seed, mesh=mesh)
    sched = eng.scheduler()
    steps0 = sched.stats["decode_steps"]
    reset_all_launches()
    got = eng.generate(reqs)
    torch.cuda.synchronize()
    launches = all_launches()
    steps = sched.stats["decode_steps"] - steps0
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"mesh request {i}: {a.tolist()} != one "
                                 f"device's {b.tolist()}")
    resident = eng.resident_bytes_per_device()
    prompts = [r.prompt for r in reqs6]
    rep_one, _, sched_one = serve_report(one, prompts, LM_NEW)
    rep_mesh, _, _ = serve_report(eng, prompts, LM_NEW)
    step_one = trace(lambda: sched_one.model.decode(
        sched_one.params, sched_one._state["cur"], sched_one._cache,
        torch.full((LM_SLOTS,), MESH_POS, dtype=torch.int32, device=dev)))
    step_mesh = mesh_decode_trace(sched, dev)
    del eng, one, sched, sched_one
    torch.cuda.empty_cache()

    # paged + prefix on a data-4 mesh, phase 6b's weights and traffic
    gen = torch.Generator(device=dev).manual_seed(seed + 2)  # phase 6b's
    frozen_p = model.init_frozen(gen, device=dev)
    preqs = [Request(p, max_new_tokens=LM_NEW)
             for p in shared_prefix_traffic(seed, cfg.vocab)]
    kw = dict(seed=seed, page_size=LM_PAGE, prefix_cache=True)
    pwant = lm_engine(cfg, frozen_p, **kw).generate(preqs)
    peng = lm_engine(cfg, frozen_p, mesh=card_mesh(dev, 4), **kw)
    reset_all_launches()
    pgot = peng.serve(preqs)
    torch.cuda.synchronize()
    paged_launches = all_launches()
    for i, (a, b) in enumerate(zip(pgot, pwant, strict=True)):
        if not np.array_equal(a.tokens, b):
            raise AssertionError(f"paged mesh request {i}: "
                                 f"{a.tokens.tolist()} != {b.tolist()}")
    psched = peng.scheduler()
    first = psched._shards[0].cache
    if not all(torch.equal(sh.cache[n], first[n])
               for sh in psched._shards[1:] for n in ("k", "v")):
        raise AssertionError("the paged mesh's pool replicas differ")
    pstats = dict(psched.stats)
    president = peng.resident_bytes_per_device()
    if pstats["prefix_hits"] < 1:
        raise AssertionError("the paged mesh served no prefix hit")
    del peng, psched, frozen_p
    torch.cuda.empty_cache()

    # two replicas on the card, then replica 0 killed at its second poll
    kw = dict(kv_bits=1, prefill_chunk=LM_CHUNK, slots=LM_SLOTS,
              max_len=LM_MAX_LEN, seed=seed)
    stats = {}
    for name, plan in (("fault-free", None),
                       ("death@replica0:1",
                        FaultPlan([Fault("death", "replica0", 1)]))):
        srv = ReplicaServer(cfg, frozen, devices=[dev, dev], fault_plan=plan,
                            **kw)
        t0 = time.perf_counter()
        out = srv.generate(list(reqs6))
        wall = time.perf_counter() - t0
        for i, (a, b) in enumerate(zip(out, tokens6, strict=True)):
            if not np.array_equal(a, b):
                raise AssertionError(f"replicas ({name}) request {i}: "
                                     f"{a.tolist()} != phase 6's "
                                     f"{b.tolist()}")
        st = srv.stats()
        want_health = 2 if plan is None else 1
        if st["healthy"] != want_health or \
                st["failovers"] != (plan is not None):
            raise AssertionError(f"replicas ({name}): stats {st}")
        stats[name] = {"wall_s": wall, "tokens_out": st["tokens_out"],
                       "healthy": st["healthy"],
                       "failovers": st["failovers"],
                       "per_replica": [
                           {k: e[k] for k in ("device", "healthy")}
                           | {"completed": e.get("scheduler", {}).get(
                               "completed", 0)} for e in st["per_replica"]]}
        del srv
    torch.cuda.empty_cache()
    rep = {"steps": steps, "launches_per_step": step_mesh["launches"],
           "resident": resident, "one": rep_one, "mesh": rep_mesh,
           "step_one": step_one, "step_mesh": step_mesh,
           "paged_stats": pstats, "paged_resident": president,
           "paged_launches": paged_launches, "replicas": stats,
           "sampled_tokens": [t.tolist() for t in got[len(reqs6):]]}
    return launches, rep


def mesh_cli(dev):
    """The serving CLI's --mesh 2,2 and --replicas 2 at smoke size on the
    card, in two processes started together: each must exit 0 and print
    the single-device `req i:` lines' count and its own lines."""
    import repro_torch
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            LM_ARCH, "--smoke", "--freeze", "--kv-bits", "1", "--batch", "3",
            "--prompt-len", "12", "--max-new", "8", "--device", str(dev)]
    t0 = time.perf_counter()
    procs = {flag: subprocess.Popen(base + flag.split(), env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
             for flag in ("--mesh 2,2", "--replicas 2")}
    out = {}
    for flag, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        if p.returncode:
            raise AssertionError(f"serve CLI {flag} exited {p.returncode}: "
                                 f"{stderr[-2000:]}")
        out[flag] = stdout.splitlines()
    mesh_lines, rep_lines = out["--mesh 2,2"], out["--replicas 2"]
    shard_lines = [ln for ln in mesh_lines if "(data " in ln]
    if not any(ln.startswith("serving mesh: data=2 x model=2")
               for ln in mesh_lines) or len(shard_lines) != 4 \
            or sum(ln.startswith("req ") for ln in mesh_lines) != 3:
        raise AssertionError("serve CLI --mesh lines:\n"
                             + "\n".join(mesh_lines))
    if not rep_lines[0].startswith("2 replicas (2 healthy") \
            or sum(ln.startswith("req ") for ln in rep_lines) != 3:
        raise AssertionError("serve CLI --replicas lines:\n"
                             + "\n".join(rep_lines))
    return {"seconds": time.perf_counter() - t0, "mesh": mesh_lines,
            "replicas": rep_lines}


def mesh_phase(base_cfg, seed, dev, card, dev_gen, reqs6, tokens6):
    """Phase 17, serving over a mesh on the card: the TP wrappers against
    their unsharded launches, the mesh engines and the replicas against one
    device's tokens, the CLI. Returns (launches of the mesh run, report)."""
    t0 = time.perf_counter()
    gemm_rows = tp_gemm_checks(dev_gen, dev, base_cfg)
    attn_rows = tp_attention_checks(dev_gen, dev, base_cfg, seed)
    torch.cuda.empty_cache()
    print(f"tensor-parallel wrappers (phase 17) on {card}: one launch per "
          f"shard; GEMM dots and words bit for bit, attention dots bit for "
          f"bit and outputs within ATTN_TOL (largest error beside); device "
          f"ms of the wrapper (split and join included), of its shards' "
          f"launches on pieces cut beforehand, and of the unsharded launch:")
    for r in gemm_rows + attn_rows:
        print(f"  {r['what']:48s} parts {r['parts']}  wrapper "
              f"{r['tp_ms']:.4f}  shards {r['shards_ms']:.4f}  unsharded "
              f"{r['one_ms']:.4f}  (err {r['max_abs_err']})")
    launches, rep = mesh_serving_checks(base_cfg, seed, dev, card, reqs6,
                                        tokens6)
    per_step = {k: v / max(1, rep["steps"]) for k, v in launches.items()
                if v}
    print(f"mesh serving (phase 17) on {card}: {LM_ARCH} full width, depth "
          f"{LM_CHECK_DEPTH}, kv_bits=1, chunk {LM_CHUNK}, {LM_SLOTS} slots, "
          f"max_len {LM_MAX_LEN}, mesh data=2 x model=2 of {dev} x 4: "
          f"{LM_REQUESTS} greedy + {MESH_SAMPLED} requests at temperature "
          f"{MESH_TEMP}: tokens equal the single-device engine's (phase 6's "
          f"for the greedy ones); sampled {rep['sampled_tokens']}; launches "
          f"{launches} over {rep['steps']} decode steps (per step, chunks "
          f"included: {per_step})")
    for shard, b in rep["resident"].items():
        print(f"  {shard}: {b['total'] / 1e6:.3f} MB = weights "
              f"{b['weights'] / 1e6:.3f} + cache {b['cache'] / 1e6:.3f} + "
              f"state {b['state'] / 1e6:.6f}")
    for name in ("one", "mesh"):
        print(f"  {name} device, phase 6's traffic:")
        print_serve_report(rep[name])
    print_trace(f"  decode step, one device ({LM_SLOTS} slots at "
                f"{MESH_POS})", rep["step_one"])
    print_trace(f"  decode step, mesh (2 shards of {LM_SLOTS // 2} slots at "
                f"{MESH_POS})", rep["step_mesh"])
    ps = rep["paged_stats"]
    print(f"  paged + prefix cache on a data=4 mesh, phase 6b's traffic: "
          f"tokens equal one device's; pool replicas equal; prefix hits "
          f"{ps['prefix_hits']}, tokens saved {ps['prefill_tokens_saved']}; "
          f"launches {rep['paged_launches']}; per shard "
          + ", ".join(f"{k}: {v['total'] / 1e6:.3f} MB"
                      for k, v in rep["paged_resident"].items()))
    for name, st in rep["replicas"].items():
        print(f"  2 replicas on {dev}, {name}: tokens equal phase 6's; "
              f"{st['healthy']} healthy, {st['failovers']} failover rounds, "
              f"{st['tokens_out']} tokens in {st['wall_s']:.3f} s; "
              f"{st['per_replica']}")
    cli = mesh_cli(dev)
    print(f"  serve CLI --mesh 2,2 and --replicas 2 on {dev} "
          f"({cli['seconds']:.1f} s, exit 0):")
    for ln in cli["mesh"] + cli["replicas"]:
        if "(data " in ln or ln.startswith(("serving mesh", "req ")) \
                or "replicas (" in ln or ln.startswith("  cuda"):
            print(f"    {ln}")
    rep.update({"tp_gemm": gemm_rows, "tp_attention": attn_rows, "cli": cli,
                "seconds": time.perf_counter() - t0})
    print(f"phase 17 (mesh): {rep['seconds']:.1f} s")
    return launches, rep


# the mesh train (phase 18): phi3-medium-14b at full width, depth
# LM_TRAIN_DEPTH, one step on a data-2 mesh of the card against one
# device's step from the same init; musicgen-large at full width, depth cut
# to MESH_TRAIN_DEPTH (checkpoint bytes and script time), through the
# Trainer (placed by the JAX specs) on data 2 and 2 x 2 (MESH_TRAIN_STEPS
# steps), stopped at step 2 on 2 x 2, resumed there and restored on data
# 4, data 2 and one device; EF-SignSGD's compressed step against the dense
# step for MESH_EF_STEPS steps of SGD(MESH_EF_LR); the 2 x 2-trained
# masters' packed checkpoint served on one device, on a 2 x 1 mesh and
# through the plain versions
MESH_TRAIN_ARCH, MESH_TRAIN_DEPTH, MESH_TRAIN_STEPS = "musicgen-large", 8, 4
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 8, 256
MESH_EF_STEPS, MESH_EF_LR, MESH_EF_BOUND = 6, 0.02, 0.08
# the Trainer's layouts: straight runs on each of MESH_TRAIN_STRAIGHT, the
# stopped run and the bit-for-bit resume on MESH_TRAIN_STOPPED, its
# checkpoint restored on each of MESH_TRAIN_RESTORE
MESH_TRAIN_STRAIGHT = ("data 2", "2 x 2")
MESH_TRAIN_STOPPED = "2 x 2"
MESH_TRAIN_RESTORE = ("data 4", "data 2", "one device")
MESH_SERVE_PLAIN = 4     # requests of the trained serve held to the plain path
# a shard's weight gradient is its bf16 GEMM over its rows, rounded once
# to bf16, and the shards' are summed in float32; one device's is one bf16
# GEMM over every row: they agree to bf16's rounding (2^-8 of an element)
# where the halves do not cancel, so moments are held to MESH_GRAD_REL of
# each tensor's largest magnitude, and params through the moments
MESH_GRAD_REL = 2.0 ** -6
MESH_LOSS_REL = 1e-3         # a mean of the shards' means, bf16 logits
# S-AdaMax's first-step scale AP2(lr / (1 - b1)) at lr 1e-3
MESH_ADAMAX_SCALE = float(2.0 ** np.round(np.log2(np.float32(1e-3)
                                                  / np.float32(0.1))))


def mesh_step_check(seed, dev, card):
    """phi3-medium-14b at full width, depth LM_TRAIN_DEPTH, bbp_det,
    S-AdaMax, batch LM_TRAIN_BATCH x LM_TRAIN_SEQ: step 0 on a data-2 mesh
    of the card against one device's from the same init (only step 0: the
    reference's backward reaches inf from step 2, ROADMAP Queue C); then
    one profiled step of each. Returns the report."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import LMDataConfig, SyntheticLM
    from repro_torch.launch.shardings import place
    from repro_torch.models.api import get_model
    from repro_torch.optim.base import tree_leaves, tree_map
    from repro_torch.train.step import default_optimizer, make_train_step
    cfg = get_config(LM_ARCH).scaled(n_layers=LM_TRAIN_DEPTH)
    model, opt = get_model(cfg), default_optimizer(cfg, 1e-3)
    data = SyntheticLM(LMDataConfig(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ,
                                    global_batch=LM_TRAIN_BATCH, seed=seed))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(0).items()}
    mesh = card_mesh(dev, 2)
    runs, peaks = {}, {}
    for name in ("one", "mesh"):
        gen = torch.Generator(device=dev).manual_seed(seed)
        p = model.init(gen, device=dev)
        st = opt.init(p)
        step = make_train_step(model, opt, mesh=mesh if name == "mesh"
                               else None)
        if name == "mesh":
            p, st = (tree_map(lambda x: place(x, mesh, ()), t)
                     for t in (p, st))
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p, st, m = step(p, st, batch)
        loss = float(m["loss"])
        wall = (time.perf_counter() - t0) * 1e3
        peaks[name] = torch.cuda.max_memory_allocated() - base_bytes
        if name == "mesh":
            p, st = (tree_map(lambda a: a[0, 0], t) for t in (p, st))
        runs[name] = (p, st, loss, wall)
    (p1, s1, l1, w1), (p2, s2, l2, w2) = runs["one"], runs["mesh"]
    if not np.isfinite(l2) or abs(l2 - l1) > MESH_LOSS_REL * abs(l1):
        raise AssertionError(f"data-2 loss {l2!r} against one device's "
                             f"{l1!r}")
    worst = max(max_rel(a, b) for a, b in zip(
        tree_leaves((s2.m, s2.u)), tree_leaves((s1.m, s1.u)), strict=True))
    counts = moments_parity((p2, s2), (p1, s1), MESH_GRAD_REL,
                            MESH_ADAMAX_SCALE)
    traces = {}
    for name in ("one", "mesh"):
        p, st = runs[name][:2]
        if name == "mesh":
            p, st = (tree_map(lambda x: place(x, mesh, ()), t)
                     for t in (p, st))
        step = make_train_step(model, opt, mesh=mesh if name == "mesh"
                               else None)
        box = [p, st]

        def one_step():
            box[0], box[1], _ = step(box[0], box[1], batch)
        traces[name] = trace(one_step, top=6)
        del box, p, st
    del runs, p1, s1, p2, s2
    torch.cuda.empty_cache()
    rep = {"loss_one": l1, "loss_mesh": l2,
           "loss_rel": abs(l2 - l1) / abs(l1), "moments_max_rel": worst,
           "params_parted": counts, "first_step_wall_ms": {"one": w1,
                                                          "mesh": w2},
           "peak_above_inputs_bytes": peaks, "trace": traces}
    print(f"mesh train step (phase 18) on {card}: {LM_ARCH} full width, "
          f"depth {LM_TRAIN_DEPTH}, {cfg.quant}, {cfg.dtype} activations, "
          f"S-AdaMax, batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, step 0 from "
          f"one init: data 2 over {dev} x 2 loss {l2:.6f} against one "
          f"device's {l1:.6f} (rel {rep['loss_rel']:.3e}, limit "
          f"{MESH_LOSS_REL}); moments within {worst:.3e} (limit "
          f"{MESH_GRAD_REL}); params held through the moments, parted "
          f"{counts}; first step wall {w2:.1f} ms against {w1:.1f} ms; "
          f"peak above the step's inputs {peaks['mesh'] / 1e9:.3f} GB "
          f"against {peaks['one'] / 1e9:.3f} GB")
    for name in ("one", "mesh"):
        print_trace(f"  train step, {name} (a later step)", traces[name])
    return rep


def mesh_trainer(cfg, ckpt_dir, seed, **kw):
    from repro_torch.train.trainer import TrainConfig, Trainer
    tc = TrainConfig(steps=MESH_TRAIN_STEPS, global_batch=MESH_TRAIN_BATCH,
                     seq_len=MESH_TRAIN_SEQ, ckpt_every=2, keep=1,
                     ckpt_dir=str(ckpt_dir), log_every=1, seed=seed)
    return Trainer(cfg, tc, **kw)


def state_equal(a, b) -> bool:
    from repro_torch.optim.base import tree_leaves
    return all(same_bits(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b),
                                                strict=True))


def mesh_train_depth(base_cfg, root):
    """MESH_TRAIN_DEPTH, or 2 where the disk under `root` cannot hold one
    checkpoint being written beside another (fp32 masters, S-AdaMax m and
    u) and the packed one."""
    free = shutil.disk_usage(root).free
    need = 2.2 * ckpt_bytes_estimate(base_cfg.scaled(
        n_layers=MESH_TRAIN_DEPTH))
    depth = MESH_TRAIN_DEPTH if free >= need else 2
    print(f"mesh train: {free / 1e9:.1f} GB free under {root}, "
          f"{need / 1e9:.1f} GB wanted at depth {MESH_TRAIN_DEPTH}: depth "
          f"{depth}")
    return depth


def train_layout(dev, name):
    """The Trainer's keywords for a layout of the card: "one device",
    "data N" or "D x M" (data x model, placed by the JAX specs)."""
    if name == "one device":
        return dict(device=dev)
    if name.startswith("data "):
        return dict(mesh=card_mesh(dev, int(name[5:])))
    data, model = (int(n) for n in name.split(" x "))
    return dict(mesh=card_mesh(dev, data, model))


def mesh_trainer_checks(base_cfg, seed, dev, card, root):
    """musicgen-large at full width through the Trainer on meshes of the
    card, every one placed by the JAX specs: a straight
    MESH_TRAIN_STEPS-step run on each of MESH_TRAIN_STRAIGHT (writing no
    checkpoint); a run on MESH_TRAIN_STOPPED
    stopped after 2 steps (the SIGTERM path: its checkpoint is step 2, the
    one alive); restored on each of MESH_TRAIN_RESTORE (every restored
    leaf byte-equal to the stopped run's state; steps 2-3 taken by the
    trainer's step, the losses within MESH_LOSS_REL of the straight run's
    on the stopped layout); resumed on MESH_TRAIN_STOPPED by `run` (the
    checkpoint deleted once restored): losses of steps 2-3 and final
    params and moments equal its straight run's bit for bit. Returns (the
    stopped layout's straight trainer, its config, report)."""
    from repro_torch.optim.base import tree_leaves
    depth = mesh_train_depth(base_cfg, root)
    cfg = base_cfg.scaled(n_layers=depth)
    runs = {}
    for name in MESH_TRAIN_STRAIGHT:
        tr = mesh_trainer(cfg, root / "straight", seed,
                          **train_layout(dev, name))
        # the reference runs write no checkpoint: the stopped and the
        # resumed runs' saves are the ones read back
        tr._save = lambda step: None
        out = tr.run()
        shutil.rmtree(root / "straight")
        losses = {h["step"]: h["loss"] for h in out["history"]}
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{name} train losses {losses}")
        walls = list(tr.step_times)
        runs[name] = {"losses": losses,
                      "step_ms": sorted(walls[1:])[len(walls[1:]) // 2] * 1e3,
                      "step_ms_all": [t * 1e3 for t in walls],
                      "resident": tr.resident_bytes_per_device()}
        if name == MESH_TRAIN_STOPPED:
            straight = tr
        del tr
        torch.cuda.empty_cache()
    losses = runs[MESH_TRAIN_STOPPED]["losses"]
    killed = mesh_trainer(cfg, root / "resume", seed,
                          **train_layout(dev, MESH_TRAIN_STOPPED))
    orig = killed._batch

    def stop_at_2(step):
        if step == 1:
            killed._stop = True
        return orig(step)
    killed._batch = stop_at_2
    out_k = killed.run()
    killed._batch = orig
    if not out_k["interrupted"] or killed.ckpt.latest_step() != 2:
        raise AssertionError(f"the stopped {MESH_TRAIN_STOPPED} run: {out_k}")
    saved = killed.full_state()
    del killed
    resumed = {}
    for name in MESH_TRAIN_RESTORE:
        tr = mesh_trainer(cfg, root / "resume", seed,
                          **train_layout(dev, name))
        t0 = time.perf_counter()
        if not tr.maybe_restore() or tr.start_step != 2:
            raise AssertionError(f"{name}: no step-2 checkpoint restored")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if not state_equal(tr.full_state(), saved):
            raise AssertionError(f"{name}: a restored leaf differs from the "
                                 f"saved state")
        got = {}
        for step in range(2, MESH_TRAIN_STEPS):
            tr.params, tr.opt_state, m = tr.train_step(
                tr.params, tr.opt_state, tr._batch(step))
            got[step] = float(m["loss"])
        rel = max(abs(got[s] - losses[s]) / abs(losses[s]) for s in got)
        if rel > MESH_LOSS_REL:
            raise AssertionError(f"{name}: losses {got} against the straight "
                                 f"run's {losses}")
        worst = max(max_rel(a, b) for a, b in zip(
            *(tree_leaves(t[1]) for t in (tr.full_state(),
                                          straight.full_state()))))
        resumed[name] = {"losses": got, "loss_rel": rel,
                         "restore_s": restore_s, "moments_max_rel": worst}
        del tr
        torch.cuda.empty_cache()
    del saved
    torch.cuda.empty_cache()
    tr = mesh_trainer(cfg, root / "resume", seed,
                      **train_layout(dev, MESH_TRAIN_STOPPED))
    t0 = time.perf_counter()
    if not tr.maybe_restore() or tr.start_step != 2:
        raise AssertionError(f"{MESH_TRAIN_STOPPED}: no step-2 checkpoint "
                             f"restored")
    restore_s = time.perf_counter() - t0
    shutil.rmtree(root / "resume" / "step_2")     # one checkpoint alive
    out_r = tr.run()
    got = {h["step"]: h["loss"] for h in out_r["history"]}
    if sorted(got) != [2, 3] or any(got[s] != losses[s] for s in got):
        raise AssertionError(f"resumed on {MESH_TRAIN_STOPPED}: losses {got} "
                             f"!= the straight run's {losses}")
    if not state_equal(tr.full_state(), straight.full_state()):
        raise AssertionError(f"resumed on {MESH_TRAIN_STOPPED}: params or "
                             f"moments differ from the straight run's")
    ckpt_bytes = step_bytes(tr.ckpt, MESH_TRAIN_STEPS)
    del tr
    shutil.rmtree(root / "resume")
    torch.cuda.empty_cache()
    rep = {"depth": depth, "straight": runs, "stopped": MESH_TRAIN_STOPPED,
           "resumed": resumed, "restore_stopped_s": restore_s,
           "ckpt_bytes": ckpt_bytes}
    print(f"mesh trainer (phase 18) on {card}: {cfg.name} full width (d "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}), depth {depth} (cut from "
          f"{base_cfg.n_layers}), {cfg.quant}, {cfg.dtype} activations, "
          f"S-AdaMax, batch {MESH_TRAIN_BATCH} x {MESH_TRAIN_SEQ}, meshes "
          f"of {dev} placed by JAX's param_specs; checkpoint "
          f"{ckpt_bytes / 1e9:.3f} GB; resumed on {MESH_TRAIN_STOPPED} at "
          f"step 2 ({restore_s:.2f} s): losses of steps 2-3 and final params "
          f"and moments equal the straight run's bit for bit")
    for name, r in runs.items():
        print(f"  straight on {name}: losses "
              + ", ".join(f"step {k} {v:.6f}"
                          for k, v in sorted(r["losses"].items()))
              + f"; step {r['step_ms']:.1f} ms (median of steps 1-"
              f"{MESH_TRAIN_STEPS - 1}, wall)")
        for shard, b in r["resident"].items():
            print(f"    {shard}: {b['total'] / 1e9:.3f} GB = params "
                  f"{b['params'] / 1e9:.3f} + optimizer state "
                  f"{b['opt_state'] / 1e9:.3f} (its pieces by the JAX specs)")
    for name, r in resumed.items():
        print(f"  {MESH_TRAIN_STOPPED}'s step 2 restored on {name}: every "
              f"restored leaf byte-equal to the saved state "
              f"({r['restore_s']:.2f} s); losses "
              + ", ".join(f"step {k} {v:.6f}" for k, v in r["losses"].items())
              + f" (rel {r['loss_rel']:.3e}, limit {MESH_LOSS_REL}); final "
              f"moments within {r['moments_max_rel']:.3e} of the straight "
              f"run's")
    return straight, cfg, rep


def compressed_check(cfg, seed, dev, card):
    """EF-SignSGD over data 2 of the card against the dense single-device
    step, MESH_EF_STEPS steps of SGD(MESH_EF_LR) from one init on random
    batches of MESH_TRAIN_BATCH x MESH_TRAIN_SEQ: every step's loss within
    MESH_EF_BOUND of the dense step's (the JAX package's bound,
    tests/test_compressed.py), the residuals non-zero. Returns the
    report."""
    from repro_torch.launch.shardings import join, place
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import sgd
    from repro_torch.optim.base import tree_leaves, tree_map
    from repro_torch.optim.ef_signsgd import compressed_bytes
    from repro_torch.train.compressed import (
        init_ef_sharded, make_compressed_train_step,
    )
    from repro_torch.train.step import make_train_step
    model, opt, mesh = get_model(cfg), sgd(MESH_EF_LR), card_mesh(dev, 2)
    gen = torch.Generator(device=dev).manual_seed(seed + 40)
    p = model.init(gen, device=dev)
    dense = tree_map(torch.clone, p)
    od = opt.init(dense)
    pc = tree_map(lambda x: place(x, mesh, ()), p)
    oc = tree_map(lambda x: place(x, mesh, ()), opt.init(p))
    ef = init_ef_sharded(p, mesh)
    cstep = make_compressed_train_step(model, opt, mesh)
    dstep = make_train_step(model, opt)
    rng = np.random.default_rng(seed + 41)
    losses, walls = [], []
    for _ in range(MESH_EF_STEPS):
        b = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (MESH_TRAIN_BATCH, MESH_TRAIN_SEQ)).astype(
                np.int32)).to(dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pc, oc, ef, mc = cstep(pc, oc, ef, b)
        lc = float(mc["loss"])
        walls.append((time.perf_counter() - t0) * 1e3)
        dense, od, md = dstep(dense, od, b)
        losses.append((lc, float(md["loss"])))
        if not abs(lc - losses[-1][1]) < MESH_EF_BOUND:
            raise AssertionError(f"compressed loss {lc} against dense "
                                 f"{losses[-1][1]}")
    resid = sum(float(join(e, mesh, ("data",)).abs().sum())
                for e in tree_leaves(ef))
    if not resid > 0:
        raise AssertionError("the EF residuals stayed zero")
    wire = compressed_bytes(p)
    dense_bytes = sum(x.numel() * 4 for x in tree_leaves(p))
    del p, dense, od, pc, oc, ef
    torch.cuda.empty_cache()
    rep = {"losses": losses, "residual_abs_sum": resid,
           "compressed_bytes": wire, "float32_grad_bytes": dense_bytes,
           "step_ms": sorted(walls[1:])[len(walls[1:]) // 2]}
    print(f"compressed step (phase 18) on {card}: {cfg.name} depth "
          f"{cfg.n_layers}, EF-SignSGD over data 2 of {dev} against the "
          f"dense step, SGD({MESH_EF_LR}), {MESH_EF_STEPS} steps: losses "
          + ", ".join(f"{a:.5f}/{b:.5f}" for a, b in losses)
          + f" (compressed/dense, each within {MESH_EF_BOUND}); residuals "
          f"|e| sum {resid:.4e}; compressed_bytes {wire} per worker per "
          f"step against {dense_bytes} of float32 gradients; step "
          f"{rep['step_ms']:.1f} ms (median, wall)")
    return rep


def mesh_trained_serve(tr, cfg, seed, dev, root):
    """The trained masters saved with packed_binary=True, restored as
    PackedWeights and served at kv_bits=1, chunk LM_CHUNK on one device
    and on a 2 x 1 mesh of the card (greedy tokens equal), and its first
    MESH_SERVE_PLAIN requests through the kernels and the plain versions
    (greedy tokens equal); one device's launches as `family_expected`
    counts them, the mesh run's through kernels 1, 2, 5, 6 and 8 and no
    other. Returns (the mesh run's launches, report)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.packed import PackedWeight
    from repro_torch.serving.engine import Request
    mgr = CheckpointManager(root / "packed", async_save=False)
    step = MESH_TRAIN_STEPS + 100
    params = tr.full_state()[0]
    mgr.save(step, params, packed_binary=True)
    packed = mgr.restore(step, params, device=dev)
    if not isinstance(packed["blocks"]["attn"]["wq"], PackedWeight):
        raise AssertionError("the packed checkpoint did not restore to "
                             "PackedWeights")
    packed_bytes = step_bytes(mgr, step)
    scfg = cfg.scaled(kv_bits=1)
    prompts = lm_traffic(seed, cfg.vocab)
    reqs = [Request(p, max_new_tokens=LM_NEW) for p in prompts]
    one = lm_engine(scfg, packed, seed=seed)
    sched = one.scheduler()
    reset_all_launches()
    comps = one.serve(reqs)
    torch.cuda.synchronize()
    counts_one = all_launches()
    steps = sched.stats["decode_steps"]
    chunks = sum(-(-len(p) // LM_CHUNK) for p in prompts)
    want = family_expected(scfg, cfg.n_layers, chunks + steps, chunks, steps,
                           False)
    if counts_one != want:
        raise AssertionError(f"one-device serve launches {counts_one} != "
                             f"{want}")
    mesh = lm_engine(scfg, packed, seed=seed, mesh=card_mesh(dev, 2))
    reset_all_launches()
    got = mesh.generate(reqs)
    torch.cuda.synchronize()
    launches = all_launches()
    for i, (a, c) in enumerate(zip(got, comps, strict=True)):
        if not np.array_equal(a, c.tokens):
            raise AssertionError(f"mesh-trained checkpoint, request {i}: 2 x 1 "
                                 f"mesh {a.tolist()} != one device's "
                                 f"{c.tokens.tolist()}")
    path = {"binary_gemm_packed", "binary_gemm_packed_rhs", "pack_bits",
            "decode_attention_packed", "prefill_attention_packed"}
    if any(bool(launches[kn]) != (kn in path) for kn in REPLACES):
        raise AssertionError(f"mesh serve launches {launches}")
    few = reqs[:MESH_SERVE_PLAIN]
    plain = lm_engine(scfg, packed, kernel_path="ref", seed=seed)
    for i, (a, b) in enumerate(zip(plain.generate(few), one.generate(few),
                                   strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"mesh-trained checkpoint, request {i}: "
                                 f"plain path {a.tolist()} != the kernels' "
                                 f"{b.tolist()}")
    del one, mesh, plain, sched, packed
    shutil.rmtree(root / "packed")
    torch.cuda.empty_cache()
    print(f"mesh-trained checkpoint serve (phase 18): packed_binary "
          f"{packed_bytes / 1e6:.1f} MB, restored to PackedWeights; "
          f"kv_bits=1, chunk {LM_CHUNK}, {len(reqs)} requests: greedy tokens "
          f"on a 2 x 1 mesh of {dev} equal one device's, and the plain "
          f"versions' one device's on the first {len(few)}; one device's "
          f"launches {dict((k, v) for k, v in counts_one.items() if v)} "
          f"({chunks} chunks, {steps} decode steps, {cfg.n_layers} layers); "
          f"the mesh's {dict((k, v) for k, v in launches.items() if v)}")
    return launches, {"packed_ckpt_bytes": packed_bytes,
                      "one_launches": counts_one, "mesh_launches": launches}


def mesh_train_phase(seed, dev, card):
    """Phase 18, training over a mesh of the card: phi3's data-2 step
    against one device's, the musicgen Trainer across meshes, EF-SignSGD
    against the dense step, the mesh-trained checkpoint served. Returns
    (the mesh serve's launches, report)."""
    from repro_torch.configs.base import get_config
    t0 = time.perf_counter()
    parts = {}
    rep = {"step": mesh_step_check(seed, dev, card)}
    parts["phi3 step"] = time.perf_counter() - t0
    root = ROOT / "build" / "mesh_train"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    try:
        tr, cfg, rep["trainer"] = mesh_trainer_checks(
            get_config(MESH_TRAIN_ARCH), seed, dev, card, root)
        parts["musicgen trainer"] = time.perf_counter() - t0 - sum(
            parts.values())
        rep["compressed"] = compressed_check(cfg, seed, dev, card)
        parts["compressed"] = time.perf_counter() - t0 - sum(parts.values())
        launches, rep["serve"] = mesh_trained_serve(tr, cfg, seed, dev, root)
        del tr
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    parts["serve"] = time.perf_counter() - t0 - sum(parts.values())
    rep["seconds"], rep["parts_s"] = time.perf_counter() - t0, parts
    print(f"phase 18 parts on {card}: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    print(f"phase 18 (mesh train): {rep['seconds']:.1f} s")
    return launches, rep


# the placed train (phase 19): the JAX package's placement over data x model
# (`launch.shardings.param_specs`: masters and S-AdaMax state in pieces,
# each weight gathered per use, gradients reduced onto the pieces,
# projections, vocabulary and experts over 'model'), every mesh `cuda:0`
# repeated: phi3-medium-14b at full width, depth LM_TRAIN_DEPTH, one step
# on a 2 x 2 mesh against one device's from the same init. (The musicgen
# Trainer on 2 x 2, its resume and restores and its served checkpoint are
# phase 18's: `Trainer(mesh=)` places by the specs on every mesh.)
# float32 activations: the placed step is the one-device step's function,
# its sums in another order (measured 7.6e-8 / 8.2e-6 on the card)
PLACED_F32_LOSS_REL = 1e-5
# bfloat16 (the config): set after the first card run, not predicted. The
# 2 x 2 step moves wq / wk's moments by 2.17e-2 of their largest; the
# witness without a mesh (one device's step with the head's dx split as
# 'model' 2 splits lm_head's vocabulary, `HalvesHead`) moves them by the
# same 2.174e-2 / 2.092e-2: the float32 sum of the two vocabulary halves'
# dx differs from one bf16 GEMM's over all 100,352 columns by bf16 ulps,
# and wq / wk's moments carry it most. `--bf16-witness` runs every split
# (the +-1 products, their dx, the head's dx); data 2 alone gives 6.2e-3
# (phase 18's 2^-6)
PLACED_WITNESS = ("head's dx by vocabulary",)
PLACED_BF16_REL = 2.0 ** -5


def placed_bytes(params, st, mesh):
    """({position: params + S-AdaMax state bytes of its pieces}, the
    whole's bytes, the sharded leaves' whole bytes (params and moments:
    float32 masters, so m and u are each a master's bytes)."""
    from repro_torch.core.placed import _axes, whole_shape
    from repro_torch.launch.shardings import param_specs, resident_bytes
    from repro_torch.optim.base import tree_leaves, tree_map
    per = resident_bytes((params, st), mesh)
    specs = []
    tree_map(lambda _, sp: specs.append(sp), params,
             param_specs(tree_map(lambda a: a.flat[0], params)))
    whole = sharded = 0
    for a, sp in zip(tree_leaves(params), specs):
        n = int(np.prod(whole_shape(a, mesh, sp))) * a.flat[0].element_size()
        whole += 3 * n                     # the master, m and u
        if any(mesh.shape[x] > 1 for e in sp for x in _axes(e)):
            sharded += 3 * n
    whole += st.step.flat[0].numel() * st.step.flat[0].element_size()
    return per, whole, sharded


def halves_forward(ctx, xq, w, u):
    """`core.layers._BinaryWeightMatmul`'s forward as two column halves,
    each its own GEMM, concatenated: the products of a 'model' 2 column
    split, on one device (a witness of `--bf16-witness`)."""
    from repro_torch.core.layers import _binary_weight
    ctx.save_for_backward(xq, w, u)
    wb = _binary_weight(w, xq.dtype, u)[1]
    h = wb.shape[-1] // 2
    return torch.cat([torch.matmul(xq, wb[..., :h].contiguous()),
                      torch.matmul(xq, wb[..., h:].contiguous())], dim=-1)


def k_halves_forward(ctx, xq, w, u):
    """`_BinaryWeightMatmul`'s forward as two K halves' float32 products
    summed in float32 and cast once: the products of a 'model' 2 row split
    (wo, w_down), on one device (a witness of `--bf16-witness`)."""
    from repro_torch.core.layers import _binary_weight
    ctx.save_for_backward(xq, w, u)
    wb = _binary_weight(w, xq.dtype, u)[1]
    h = wb.shape[-2] // 2
    return (torch.matmul(xq[..., :h].float(), wb[..., :h, :].float())
            + torch.matmul(xq[..., h:].float(), wb[..., h:, :].float())
            ).to(xq.dtype)


def halves_backward(ctx, g):
    """`core.layers._BinaryWeightMatmul`'s backward with dx as the two
    column halves' float32 products summed in float32 and cast once (a
    'model' 2 column split's order), dw as it is: phase 19's witness for
    its bf16 limit, on one device."""
    from repro_torch.core.layers import _binary_weight, _masked_weight_grad
    xq, w, u = ctx.saved_tensors
    wc, wb = _binary_weight(w, xq.dtype, u)
    gx = gw = None
    if ctx.needs_input_grad[0]:
        h = wb.shape[-1] // 2
        gx = (torch.matmul(g[..., :h].float(),
                           wb[..., :h].float().transpose(-1, -2))
              + torch.matmul(g[..., h:].float(),
                             wb[..., h:].float().transpose(-1, -2))
              ).to(g.dtype)
    del wb
    if ctx.needs_input_grad[1]:
        gw = _masked_weight_grad(xq, g, wc, True).to(w.dtype)
    return gx, gw, None


class HalvesHead(torch.autograd.Function):
    """x @ w.to(x.dtype), the head's float product, with dx as the two
    vocabulary halves' float32 products summed in float32 and cast once
    (a 'model' 2 split of the head), dw autograd's: phase 19's witness,
    on one device."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x, w.to(x.dtype))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            leaf = w.detach().requires_grad_(True)
            gw, = torch.autograd.grad(torch.matmul(x, leaf.to(x.dtype)),
                                      leaf, g)
        wc, h = w.to(x.dtype), w.shape[-1] // 2
        gx = (torch.matmul(g[..., :h].float(),
                           wc[..., :h].float().transpose(-1, -2))
              + torch.matmul(g[..., h:].float(),
                             wc[..., h:].float().transpose(-1, -2))
              ).to(x.dtype)
        return gx, gw


def placed_pair(cfg, seed, dev, shape=(2, 2), profile=False, witness=()):
    """Step 0 of `cfg` (batch LM_TRAIN_BATCH x LM_TRAIN_SEQ, S-AdaMax) on one
    device and on a `shape` mesh of the card placed by the JAX specs, from
    one init: (losses, per-leaf moment differences (max |diff| / max |one
    device's|), parted params counted by `moments_parity` at `rel`, first
    step walls, peaks above each step's inputs, positions' bytes, the
    trace of a later placed step or None; for each name in `witness`, the
    moment differences from one device's plain step of one device's step
    with that sum split in two as a 'model' 2 split takes it: the +-1
    products by columns or by K (`halves_forward`, `k_halves_forward`),
    their dx (`halves_backward`), the head's dx (`HalvesHead`)). The
    moments are checked by the caller."""
    from repro_torch.data.synthetic import LMDataConfig, SyntheticLM
    from repro_torch.launch.shardings import join, param_specs, place
    from repro_torch.models.api import get_model
    from repro_torch.optim.base import (
        tree_leaves, tree_map, tree_map_with_path,
    )
    from repro_torch.train.step import (
        default_optimizer, init_placed_state, make_train_step,
        state_shardings,
    )
    model, opt = get_model(cfg), default_optimizer(cfg, 1e-3)
    data = SyntheticLM(LMDataConfig(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ,
                                    global_batch=LM_TRAIN_BATCH, seed=seed))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(0).items()}
    mesh = card_mesh(dev, *shape)

    def timed(step, p, st):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p, st, m = step(p, st, batch)
        loss = float(m["loss"])
        return p, st, loss, (time.perf_counter() - t0) * 1e3, \
            torch.cuda.max_memory_allocated() - base
    p = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    p1, s1, l1, w1, k1 = timed(make_train_step(model, opt), p,
                               opt.init(p))
    names = []
    tree_map_with_path(lambda path, _: names.append("/".join(map(str, path))),
                       p1)

    def moment_rels(st_got):
        return {f"{what} {name}": max_rel(a, b)
                for what, a_t, b_t in (("m", st_got.m, s1.m),
                                       ("u", st_got.u, s1.u))
                for name, a, b in zip(names, tree_leaves(a_t),
                                      tree_leaves(b_t), strict=True)}
    from repro_torch.core import layers
    from repro_torch.models import transformer
    cls = layers._BinaryWeightMatmul
    splits = {"+-1 products by columns": [(cls, "forward",
                                           staticmethod(halves_forward))],
              "+-1 products by K": [(cls, "forward",
                                     staticmethod(k_halves_forward))],
              "+-1 products' dx by columns": [
                  (cls, "backward", staticmethod(halves_backward))],
              "head's dx by vocabulary": [(transformer, "float_matmul",
                                           HalvesHead.apply)]}
    wrels = {}
    for name in witness:
        patches = splits[name]
        plain = [(obj, attr, obj.__dict__[attr]) for obj, attr, _ in patches]
        for obj, attr, fn in patches:
            setattr(obj, attr, fn)
        try:
            p = model.init(torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
            _, sw, _ = make_train_step(model, opt)(p, opt.init(p), batch)
        finally:
            for obj, attr, fn in plain:
                setattr(obj, attr, fn)
        wrels[name] = moment_rels(sw)
        del p, sw
        torch.cuda.empty_cache()
    p = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    specs = param_specs(p)
    pp = tree_map(lambda x, sp: place(x, mesh, sp), p, specs)
    del p
    st = init_placed_state(opt, pp, mesh)
    per, whole, sharded = placed_bytes(pp, st, mesh)
    step = make_train_step(model, opt, mesh=mesh, specs=specs)
    pp, st, l2, w2, k2 = timed(step, pp, st)
    p2 = tree_map(lambda a, sp: join(a, mesh, sp), pp, specs)
    s2 = tree_map(lambda a, sp: join(a, mesh, sp), st,
                  state_shardings(st, pp, specs, ()))
    rels = moment_rels(s2)
    rep = {"dtype": cfg.dtype, "loss_one": l1, "loss_placed": l2,
           "loss_rel": abs(l2 - l1) / abs(l1), "moments_rel": rels,
           "moments_max_rel": max(rels.values()),
           "first_step_wall_ms": {"one": w1, "placed": w2},
           "peak_above_inputs_bytes": {"one": k1, "placed": k2},
           "resident": per, "whole_bytes": whole, "sharded_bytes": sharded,
           "witness_rel": wrels, "moments": ((p2, s2), (p1, s1))}
    del p1, s1, p2, s2
    torch.cuda.empty_cache()
    rep["trace"] = None
    if profile:
        box = [pp, st]

        def one_step():
            box[0], box[1], _ = step(box[0], box[1], batch)
        reset_all_launches()
        rep["trace"] = trace(one_step, top=6)
        if any(all_launches().values()):
            raise AssertionError(f"the train step launched a serving "
                                 f"kernel: {all_launches()}")
        del box
    del pp, st
    torch.cuda.empty_cache()
    return rep


def placed_step_check(seed, dev, card, data2_peak):
    """phi3-medium-14b at full width, depth LM_TRAIN_DEPTH, bbp_det,
    S-AdaMax, batch LM_TRAIN_BATCH x LM_TRAIN_SEQ, step 0 on a 2 x 2 mesh of
    the card placed by the JAX specs against one device's from the same
    init (`placed_pair`): with float32 activations the function's check
    (loss within PLACED_F32_LOSS_REL, moments within LM_TRAIN_REL, params
    held through the moments); at the config's bfloat16 the same at
    MESH_LOSS_REL and PLACED_BF16_REL; each position's bytes; the bf16
    step's peak memory above its inputs beside one device's and phase
    18's data-2 step's; one profiled later bf16 step; the bf16 limit's
    witness without a mesh (PLACED_WITNESS; reported, not gated).
    Returns the report."""
    from repro_torch.configs.base import get_config
    base = get_config(LM_ARCH).scaled(n_layers=LM_TRAIN_DEPTH)
    rep = {}
    for cfg, loss_rel, rel in (
            (base.scaled(dtype="float32"), PLACED_F32_LOSS_REL, LM_TRAIN_REL),
            (base, MESH_LOSS_REL, PLACED_BF16_REL)):
        r = placed_pair(cfg, seed, dev, profile=cfg.dtype == base.dtype,
                        witness=PLACED_WITNESS if cfg.dtype == base.dtype
                        else ())
        got, want = r.pop("moments")
        top = sorted(r["moments_rel"].items(), key=lambda kv: -kv[1])[:4]
        print(f"placed train step (phase 19) on {card}: {LM_ARCH} full "
              f"width, depth {LM_TRAIN_DEPTH}, {cfg.quant}, {cfg.dtype} "
              f"activations, S-AdaMax, batch {LM_TRAIN_BATCH} x "
              f"{LM_TRAIN_SEQ}, step 0 from one init: 2 x 2 over {dev} x 4 "
              f"(JAX's param_specs) loss {r['loss_placed']:.6f} against one "
              f"device's {r['loss_one']:.6f} (rel {r['loss_rel']:.3e}, limit "
              f"{loss_rel}); moments within {r['moments_max_rel']:.3e} of "
              f"each tensor's largest (limit {rel}; largest "
              + ", ".join(f"{k} {v:.3e}" for k, v in top) + f"); first step "
              f"wall {r['first_step_wall_ms']['placed']:.1f} ms against "
              f"{r['first_step_wall_ms']['one']:.1f} ms; peak above the "
              f"step's inputs "
              f"{r['peak_above_inputs_bytes']['placed'] / 1e9:.3f} GB "
              f"against one device's "
              f"{r['peak_above_inputs_bytes']['one'] / 1e9:.3f} GB")
        if not np.isfinite(r["loss_placed"]) or r["loss_rel"] > loss_rel \
                or r["moments_max_rel"] > rel:
            raise AssertionError(f"{cfg.dtype} 2 x 2 step against one "
                                 f"device's: loss rel {r['loss_rel']}, "
                                 f"moments {r['moments_max_rel']}")
        r["params_parted"] = moments_parity(got, want, rel, MESH_ADAMAX_SCALE)
        print(f"  params held through the moments, parted "
              f"{r['params_parted']}")
        for name, wr in r["witness_rel"].items():
            wtop = sorted(wr.items(), key=lambda kv: -kv[1])[:4]
            print(f"  witness, no mesh: one device's step with its "
                  f"{name} split in two as 'model' 2 splits them, against "
                  f"its plain step: moments within {max(wr.values()):.3e} "
                  f"(largest "
                  + ", ".join(f"{k} {v:.3e}" for k, v in wtop) + ")")
        del got, want
        torch.cuda.empty_cache()
        rep[cfg.dtype] = r
    r = rep[base.dtype]
    r["peak_above_inputs_bytes"]["data2 (phase 18)"] = data2_peak
    print(f"  phase 18's data-2 step (bfloat16): peak above its inputs "
          + (f"{data2_peak / 1e9:.3f} GB" if data2_peak else "not run"))
    print(f"  params + S-AdaMax state {r['whole_bytes'] / 1e9:.3f} GB whole, "
          f"of it sharded leaves {r['sharded_bytes'] / 1e9:.3f} GB (a "
          f"quarter {r['sharded_bytes'] / 4e9:.3f} GB)")
    for shard, b in r["resident"].items():
        print(f"  {shard}: {b / 1e9:.3f} GB "
              f"({b / r['whole_bytes']:.4f} of the whole)")
    print_trace("  train step, 2 x 2 placed, bfloat16 (a later step)",
                r["trace"])
    return rep


def bf16_witness(card, seed, dev) -> int:
    """`--bf16-witness`: phi3 (full width, depth LM_TRAIN_DEPTH, bf16) step
    0 on 2 x 2 against one device's, beside one device's steps with each
    split of `placed_pair`'s witnesses; prints each one's moments."""
    from repro_torch.configs.base import get_config
    cfg = get_config(LM_ARCH).scaled(n_layers=LM_TRAIN_DEPTH)
    r = placed_pair(cfg, seed, dev, witness=(
        "+-1 products by columns", "+-1 products by K",
        "+-1 products' dx by columns", "head's dx by vocabulary"))
    print(f"bf16 witnesses on {card}: {LM_ARCH} depth {LM_TRAIN_DEPTH}, "
          f"2 x 2 against one device: moments within "
          f"{r['moments_max_rel']:.3e}")
    for name, wr in r["witness_rel"].items():
        top = sorted(wr.items(), key=lambda kv: -kv[1])[:2]
        print(f"  one device, {name} split in two: moments within "
              f"{max(wr.values()):.3e} ("
              + ", ".join(f"{k} {v:.3e}" for k, v in top) + ")")
    return 0


def placed_train_phase(seed, dev, card, data2_peak=None):
    """Phase 19, training over data x model as the JAX package places it,
    on a mesh of the card: phi3's 2 x 2 step against one device's, with
    the bf16 limit's witness. Returns the report (the train step launches
    no kernel of the kernels line)."""
    t0 = time.perf_counter()
    rep = {"step": placed_step_check(seed, dev, card, data2_peak)}
    rep["seconds"] = time.perf_counter() - t0
    print(f"phase 19 (placed train): {rep['seconds']:.1f} s")
    return rep


def attention_times(card, popc_per_s) -> int:
    """The attention kernels' times alone (`--attention-times`): the lm
    kernel times of kernels 5-9 at the main path's shapes, then the
    long-context prefill and decode times, with the port imported from the
    checkout or from `--port-src`."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attention as da
    cfg = get_config(LM_ARCH)
    dev = torch.device("cuda", 0)
    dev_gen = torch.Generator(device=dev).manual_seed(0)
    print(f"attention times of the port in {Path(da.__file__).parents[2]}")
    rows, _ = lm_kernel_times(cfg, dev_gen, dev, popc_per_s)
    print_attention_rows(f"lm kernel times on {card} (ms):", rows, 45)
    print_attention_rows(f"lm long-context prefill times on {card} (ms):",
                         lm_long_prefill_times(cfg, dev_gen, dev, popc_per_s))
    print_attention_rows(f"lm long-context decode times on {card} (ms):",
                         lm_long_decode_times(cfg, dev_gen, dev, popc_per_s),
                         40)
    return 0


def decode_times(card, seed, repeats) -> int:
    """Phase 7's timed run alone (`--decode-times N`): phi3-medium-14b at
    full width and depth on phase 6's chunked kv_bits=1 engine, one device,
    served N times on phase 7's traffic; prints each serve's decode tokens/s
    and ms per decode step as one JSON line, with the port imported from the
    checkout or from `--port-src` (so that processes of a parent tree and of
    the change can alternate in one call)."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving import scheduler
    dev = torch.device("cuda", 0)
    rep, eng = lm_timed_run(get_config(LM_ARCH), seed, dev, card)
    prompts = lm_traffic(seed, eng.cfg.vocab)
    runs = [rep] + [serve_report(eng, prompts, LM_NEW)[0]
                    for _ in range(repeats - 1)]
    print("decode times " + json.dumps({
        "port": str(Path(scheduler.__file__).parents[2]), "card": card,
        "decode_tok_per_s": [r["decode_tok_per_s"] for r in runs],
        "decode_ms_per_step": [1e3 * r["decode_s"] / r["decode_steps"]
                               for r in runs]}))
    return 0


def packed_plan_sweep(dev_gen, sms):
    """Kernel 1's small-M kernel at each width (32, 64, 128, 256 channels a
    block) and K split (1, 2, 4, 8) on phi3's q, K|V and gate|up at 4 and
    32 rows (the plan forced, device ms, one launch a call, each result
    equal to the plan's), beside the width and split `gemm_plan` picks: the
    measurement its rule rests on."""
    from dataclasses import replace
    from unittest import mock
    from repro_torch.kernels import binary_gemm as bg
    kn, rows = "binary_gemm_packed", []
    for m in (LM_SLOTS, LM_CHUNK):
        for kname, _, k, n, what in LM_GEMMS:
            if kname != kn:
                continue
            op = Operands(dev_gen, m, k, n)
            plan = bg.gemm_plan(kn, m, n, k, sms)
            want = op.call(kn, "packed")
            ms = {}
            for block_n in (32, 64, 128, 256):
                for split in (1, 2, 4, 8):
                    forced = replace(plan, split=split, block_n=block_n,
                                     blocks=-(-n // block_n) * split)
                    with mock.patch.object(bg, "gemm_plan",
                                           lambda *_, forced=forced: forced):
                        check_equal(f"{kn} {block_n}/{split}",
                                    op.call(kn, "packed"), want)
                        ms[(block_n, split)] = device_ms(
                            lambda: op.call(kn, "packed"), wrapper=kn)
            rows.append({"where": f"{what}.M{m}", "M": m, "K": k, "N": n,
                         "plan": (plan.block_n, plan.split), "ms": ms})
    return rows


def gemm_scan_times(card, popc_per_s, exp_per_s, fp64_per_s, sms) -> int:
    """Kernels 1 and 10 alone (`--gemm-scan-times`): kernel 1 at the LM's
    packed-lhs shapes (phi3's q, K|V, gate|up) at decode and chunk rows and
    at the MLP and CNN output layers, kernel 10 at the decode, chunk and
    long-prefill shapes, with the port imported from the checkout or from
    `--port-src`."""
    from repro_torch.configs.base import get_config
    from repro_torch.configs.bnn_paper import BNN_CIFAR10, BNN_MNIST
    from repro_torch.kernels import binary_gemm as bg
    dev = torch.device("cuda", 0)
    dev_gen = torch.Generator(device=dev).manual_seed(0)
    kn = "binary_gemm_packed"
    print(f"gemm and scan times of the port in {Path(bg.__file__).parents[2]}")
    rows = lm_gemm_times(dev_gen, popc_per_s, sms, kernels=(kn,))
    for kname, lhs, m, k, n, where in main_path_shapes(BNN_MNIST, BNN_CIFAR10):
        if kname == kn:
            op = Operands(dev_gen, m, k, n)
            lib_name, lib_fn = library_call(op)
            rows.append({"kernel": kn, "lhs": lhs, "M": m, "K": k, "N": n,
                         "where": where, "library": lib_name,
                         "plan": plan_text(kn, m, k, n, sms),
                         **shape_times(lambda: op.call(kn, lhs), kn,
                                       lambda: op.call(kn, lhs, plain=True),
                                       lib_fn),
                         **bound(kn, lhs, m, k, n, popc_per_s)})
    print_gemm_rows(f"{kn} times on {card} (ms per launch, as phase 7):", rows)
    if hasattr(bg, "PLANNED"):
        print(f"{kn} plan sweep on {card} (small-M kernel, device ms at "
              f"channels a block / K split; * the plan's pick):")
        for r in packed_plan_sweep(dev_gen, sms):
            print(f"  {r['where']:14s} " + "  ".join(
                f"{bn}/{sp} {t:.4f}{'*' if (bn, sp) == r['plan'] else ''}"
                for (bn, sp), t in r["ms"].items()))
    cfg = get_config(SSM_ARCH)
    scan_kernel_times(dev_gen, dev, card, exp_per_s, fp64_per_s,
                      cfg.expand * cfg.d_model, cfg.ssm_state)
    return 0


# ---------------------------------------------------------------------------
# Phase 20: the dry run's counter beside the card's measurements, the
# kernel-repetition analysis and the paper's energy table
# ---------------------------------------------------------------------------
# (b): the counter's peak live bytes above the step's inputs against the
# card's peak above its inputs (the same autograd graph runs in both; the
# gap is cuBLAS workspaces and the allocator's rounding)
DRYRUN_TEMP_REL = 0.15
# the paper nets' layers as benchmarks/bench_energy.py composes them:
# CIFAR-10 CNN convs (cin, cout, k, h, w) and fully connected (m, k, n)
ENERGY_CNN_CONVS = [(3, 128, 3, 32, 32), (128, 128, 3, 32, 32),
                    (128, 256, 3, 16, 16), (256, 256, 3, 16, 16),
                    (256, 512, 3, 8, 8), (512, 512, 3, 8, 8)]
ENERGY_CNN_FCS = [(1, 8192, 1024), (1, 1024, 1024), (1, 1024, 10)]
ENERGY_MLP = [(1, 784, 1024), (1, 1024, 1024), (1, 1024, 1024),
              (1, 1024, 10)]
ENERGY_DEDUP = 0.37          # the paper's unique-kernel share (§4.2)


def dryrun_count(cfg, shape=None):
    """The dry run's count (`roofline.count`, on this host's CPU) of cfg's
    train step (S-AdaMax, a fresh state, batch LM_TRAIN_BATCH x
    LM_TRAIN_SEQ) on one fake device, or on a `shape` mesh of fake devices
    placed by JAX's specs (the mesh of phase 19), the batch on the host.
    Returns (the count, the mesh or None)."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.shardings import param_specs, place
    from repro_torch.models.api import get_model
    from repro_torch.optim.base import tree_map
    from repro_torch.roofline import count as C
    from repro_torch.train.step import (
        default_optimizer, init_placed_state, make_train_step,
    )
    model, opt = get_model(cfg), default_optimizer(cfg, 1e-3)
    with C.fake_mode():
        host = torch.device("cpu")
        batch = {"tokens": torch.zeros((LM_TRAIN_BATCH, LM_TRAIN_SEQ),
                                       dtype=torch.int32, device=host)}
        if shape is None:
            dev = torch.device("meta", 0)
            p = model.init(torch.Generator(), device=dev)
            rep = C.count(make_train_step(model, opt), p, opt.init(p),
                          {k: v.to(dev) for k, v in batch.items()})
            mesh = None
        else:
            mesh = make_serving_mesh(*shape, devices=C.fake_devices(
                shape[0] * shape[1], shape[1]))
            p = model.init(torch.Generator(), device=host)
            specs = param_specs(p)
            pp = tree_map(lambda x, sp: place(x, mesh, sp), p, specs)
            del p
            rep = C.count(make_train_step(model, opt, mesh=mesh,
                                          specs=specs),
                          pp, init_placed_state(opt, pp, mesh), batch,
                          mesh=mesh)
        del rep["result"]
    return rep, mesh


def energy_table() -> dict:
    """The paper's energy table (`core.energy`, Horowitz 45 nm pJ) of the
    MLP and the CNN in fp32, fp16, BinaryConnect and BBP, and the CNN's
    BBP with ENERGY_DEDUP unique kernels, as benchmarks/bench_energy.py
    composes it: {net: {mode: pJ}}."""
    from repro_torch.core.energy import conv_layer_energy, dense_layer_energy

    def net(mode, name, dedup=1.0):
        total = 0.0
        if name == "cnn":
            for cin, cout, k, h, w in ENERGY_CNN_CONVS:
                total += conv_layer_energy(cin, cout, k, h, w, mode=mode,
                                           unique_kernel_fraction=dedup
                                           ).total_pj()
        for m, kk, n in ENERGY_CNN_FCS if name == "cnn" else ENERGY_MLP:
            total += dense_layer_energy(m, kk, n, mode=mode).total_pj()
        return total
    out = {name: {mode: net(mode, name) for mode in ("fp32", "fp16", "bc",
                                                     "bbp")}
           for name in ("mlp", "cnn")}
    out["cnn"][f"bbp dedup {ENERGY_DEDUP}"] = net("bbp", "cnn", ENERGY_DEDUP)
    return out


def dedup_check(convs, seed, dev) -> dict:
    """The kernel-repetition analysis (`core.kernel_dedup`) of the trained
    CNN's conv weights: each layer's unique 2D-kernel share and the
    XNOR-popcount reduction 1 / mean, as examples/train_bnn_cifar10.py
    prints them; each layer's `apply_dedup` on the card against the CPU's
    on the same inputs, bit for bit."""
    from repro_torch.core.kernel_dedup import (
        apply_dedup, dedup_plan, unique_kernel_fraction,
    )
    fracs = [unique_kernel_fraction(w.numpy()) for w in convs]
    gen = torch.Generator().manual_seed(seed)
    for i, w in enumerate(convs):
        plan = dedup_plan(w.numpy())
        x = torch.randn((2, 8, 8, plan["n_unique"]), generator=gen)
        want = apply_dedup(x, plan)
        got = apply_dedup(x.to(dev), plan)
        check_equal(f"apply_dedup conv {i}", got.cpu(), want)
    print("unique 2D kernels/layer (phase 8's trained bnn-cifar10):",
          [f"{100 * f:.0f}%" for f in fracs])
    print(f"=> XNOR-popcount op reduction {1 / np.mean(fracs):.2f}x (§4.2); "
          f"apply_dedup on the card equals the CPU's bit for bit, every "
          f"conv")
    return {"unique_fraction": fracs, "reduction": 1 / float(np.mean(fracs))}


def dryrun_phase(card, seed, dev, lm_train, placed, convs) -> dict:
    """Phase 20: the dry run's counter (`roofline.count`) on this host's
    CPU, at shapes the card measured earlier: (a) phase 14's step's
    roofline bound (H100 SXM datasheet peaks) at most its profiled busy
    time, and its useful-FLOP share; (b) phase 19's one-device step's
    predicted peak above its inputs within DRYRUN_TEMP_REL of the card's;
    (c) phase 19's 2 x 2 step: each position's predicted params and
    S-AdaMax bytes equal to phase 19's, and its predicted cross-device
    bytes (one card cannot measure them); (d) the kernel-repetition
    analysis of phase 8's CNN; (e) the paper's energy table. Returns the
    report."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.roofline import count as C
    t0 = time.perf_counter()
    rep = {"energy_pj": energy_table()}
    e = rep["energy_pj"]
    print("energy (pJ, Horowitz 45 nm, core.energy; as "
          "benchmarks/bench_energy.py): " + "; ".join(
              f"{net} " + ", ".join(f"{m} {v:.4g}" for m, v in modes.items())
              for net, modes in e.items())
          + f"; fp32/bbp mlp {e['mlp']['fp32'] / e['mlp']['bbp']:.0f}x, cnn "
          f"{e['cnn']['fp32'] / e['cnn']['bbp']:.0f}x; bbp/dedup cnn "
          f"{e['cnn']['bbp'] / e['cnn'][f'bbp dedup {ENERGY_DEDUP}']:.2f}x")
    # (a), (b): one device
    cfg = get_config(LM_ARCH).scaled(n_layers=lm_train["depth"])
    one, _ = dryrun_count(cfg)
    d = one["devices"]["meta:0"]
    terms = {"compute": d["flops"] / M.PEAK_FLOPS_BF16,
             "memory": d["hbm_bytes"] / M.HBM_BW,
             "collective": d["collectives"]["total_bytes"] / M.LINK_BW}
    bound_ms = max(terms.values()) * 1e3
    busy_ms = lm_train["trace"]["busy_ms"]
    useful = 6.0 * cfg.n_active_params() * LM_TRAIN_BATCH * LM_TRAIN_SEQ
    peak = placed["bfloat16"]["peak_above_inputs_bytes"]["one"]
    temp = d["memory"]["temp_size_in_bytes"]
    rep["one"] = {"flops": d["flops"], "hbm_bytes": d["hbm_bytes"],
                  "terms_ms": {k: v * 1e3 for k, v in terms.items()},
                  "bound_ms": bound_ms, "busy_ms": busy_ms,
                  "bound_over_busy": bound_ms / busy_ms,
                  "useful_flops_ratio": useful / d["flops"],
                  "temp_bytes": temp, "peak_above_inputs_bytes": peak,
                  "temp_rel": (temp - peak) / peak}
    print(f"dry run (phase 20) of phase 14's step ({LM_ARCH} depth "
          f"{lm_train['depth']}, {cfg.dtype}, {cfg.quant}, remat "
          f"{cfg.remat}, S-AdaMax, {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, one "
          f"device), counted on this host's CPU: {d['flops']:.4e} FLOPs, "
          f"{d['hbm_bytes']:.4e} bytes (each aten op's operands and "
          f"results, unfused); priced at H100 SXM datasheet peaks "
          f"(not measured): compute {terms['compute'] * 1e3:.3f} ms, memory "
          f"{terms['memory'] * 1e3:.3f} ms; bound {bound_ms:.3f} ms against "
          f"phase 14's profiled busy {busy_ms:.3f} ms on {card} (ratio "
          f"{bound_ms / busy_ms:.4f}); useful FLOPs (6 N T) / counted "
          f"{useful / d['flops']:.4f}")
    if not bound_ms <= busy_ms:
        raise AssertionError(f"the roofline bound {bound_ms} ms exceeds the "
                             f"measured busy time {busy_ms} ms")
    print(f"  predicted peak above the step's inputs {temp / 1e9:.3f} GB "
          f"against phase 19's one-device step on the card {peak / 1e9:.3f} "
          f"GB (rel {(temp - peak) / peak:+.4f}, limit {DRYRUN_TEMP_REL})")
    if abs(temp - peak) > DRYRUN_TEMP_REL * peak:
        raise AssertionError(f"predicted temp {temp} against the card's "
                             f"peak above the inputs {peak}")
    # (c): the 2 x 2 placed step
    placed_rep, mesh = dryrun_count(cfg, (2, 2))
    card_bytes = {name.split(" (", 1)[1]: b
                  for name, b in placed["bfloat16"]["resident"].items()}
    rep["placed"] = {}
    for ix in np.ndindex(*mesh.devices.shape):
        where = mesh.shard_name(ix).split(" (", 1)[1]
        r = placed_rep["devices"][str(mesh.devices[ix])]
        args = r["memory"]["argument_size_in_bytes"]
        coll = r["collectives"]
        rep["placed"][where] = {"argument_bytes": args,
                                "card_bytes": card_bytes[where],
                                "cross_device_bytes": coll}
        print(f"  2 x 2 ({where}: predicted params + S-AdaMax bytes {args} "
              f"(phase 19: {card_bytes[where]}), cross-device bytes in "
              f"{coll['total_bytes']} {coll['per_op']} (predicted; one card "
              f"cannot measure them), temp "
              f"{r['memory']['temp_size_in_bytes'] / 1e9:.3f} GB")
        if args != card_bytes[where]:
            raise AssertionError(f"{where}: predicted argument bytes {args} "
                                 f"against phase 19's {card_bytes[where]}")
    if placed_rep["host"]["ops"]:
        print(f"  ops whose output lands on the host (kept apart): "
              f"{placed_rep['host']['ops']}")
    # (d)
    rep["dedup"] = dedup_check(convs, seed, dev)
    rep["seconds"] = time.perf_counter() - t0
    print(f"phase 20 (dry run): {rep['seconds']:.1f} s")
    return rep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full report as JSON here")
    ap.add_argument("--attention-times", action="store_true",
                    help="only build the kernels and time the attention "
                         "kernels (the lm kernel, long-context prefill and "
                         "long-context decode times), then stop")
    ap.add_argument("--bf16-witness", action="store_true",
                    help="only build the kernels and run phase 19's bf16 "
                         "2 x 2 step beside one device's steps with each "
                         "sum a 'model' 2 split reorders split in two "
                         "(the witnesses of PLACED_BF16_REL), then stop")
    ap.add_argument("--gemm-scan-times", action="store_true",
                    help="only build the kernels and time kernels 1 and 10 "
                         "(binary_gemm_packed at its LM and output-layer "
                         "shapes, selective_scan at its decode, chunk and "
                         "long-prefill shapes), then stop")
    ap.add_argument("--decode-times", type=int, default=0, metavar="N",
                    help="only build the kernels and serve phase 7's timed "
                         "run N times (decode tokens/s and ms per step of "
                         "each serve), then stop")
    ap.add_argument("--record-shapes", type=Path, default=None,
                    help="write every route-table bucket this run resolves "
                         "outside a fixed-rule pin (the serving and "
                         "paper-net paths) to this JSON file at exit: the "
                         "card's standard shapes of kernels.tune")
    ap.add_argument("--port-src", type=Path, default=None,
                    help="import the port from this src directory instead "
                         "of the checkout's (with --attention-times, "
                         "--gemm-scan-times or --decode-times: time another "
                         "tree, such as a parent commit's, in the same call)")
    args = ap.parse_args()
    if args.port_src is not None:
        sys.path.insert(0, str(args.port_src.resolve()))
    else:
        print(f"port: {find_port()}")

    # ---------------------------------------------------------------- device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from repro_torch.configs.bnn_paper import BNN_CIFAR10, BNN_MNIST
    from repro_torch.kernels import _build
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.kernels import tune
    from repro_torch.models import paper_nets as pn

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(smi("clocks.max.sm").split()[0])
    popc_per_s = sms * tune.POPC_PER_CLOCK_PER_SM * max_mhz * 1e6
    exp_per_s = sms * EXP_PER_CLOCK_PER_SM * max_mhz * 1e6
    fp64_per_s = sms * FP64_PER_CLOCK_PER_SM * max_mhz * 1e6
    print(f"device: {name}, count {count}, {sms} SMs, max SM clock "
          f"{max_mhz:.0f} MHz, popc peak {popc_per_s / 1e12:.3f} T/s")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    report = {"card": card, "device": name, "kernels": {}, "forwards": {}}
    if args.record_shapes is not None:
        atexit.register(write_shapes, args.record_shapes, card)

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    built = _build.build_all()
    nvcc_ver = subprocess.run([_build.nvcc_path(), "--version"], check=True,
                              capture_output=True, text=True).stdout
    print(f"build: {time.perf_counter() - t0:.1f} s, "
          f"{nvcc_ver.strip().splitlines()[-1]}")
    for b in built.values():
        print(f"  {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                print(f"    {line.strip()}")
    start = time.perf_counter()
    clock = [start]

    def lap(what):
        """Print the seconds since the last lap (or the build's end)."""
        now = time.perf_counter()
        print(f"{what}: {now - clock[0]:.1f} s")
        clock[0] = now

    if args.attention_times:
        return attention_times(card, popc_per_s)
    if args.gemm_scan_times:
        return gemm_scan_times(card, popc_per_s, exp_per_s, fp64_per_s, sms)
    if args.decode_times:
        return decode_times(card, args.seed, args.decode_times)
    if args.bf16_witness:
        return bf16_witness(card, args.seed, dev)

    # --------------------------------------------- kernels vs plain on card
    # each kernel at the fixed rule's launch (`gemm_plan`, `attention_plan`):
    # the checks hold one entry point to another bit for bit at one plan
    with tune.route_override(**FIXED_RULE):
        gen = torch.Generator().manual_seed(args.seed)
        shapes = main_path_shapes(BNN_MNIST, BNN_CIFAR10)
        checks = [(kn, lhs, m, k, n, where) for kn, lhs, m, k, n, where in shapes]
        for m, k, n in RAGGED:
            checks += [("binary_gemm_packed", "packed", m, k, n, "ragged"),
                       ("binary_gemm_packed_rhs", "float", m, k, n, "ragged"),
                       ("binary_gemm_fused", "float", m, k, n, "ragged"),
                       ("binary_gemm_fused", "packed", m, k, n, "ragged")]
        # the LM's GEMMs at chunk and decode rows (phi3's and falcon-mamba's),
        # then kernels 2 and 3 at the edges of their dispatch rule
        for m, where in ((LM_CHUNK, "lm.chunk"), (LM_SLOTS, "lm.decode")):
            checks += [(kn, lhs, m, k, n, where) for kn, lhs, k, n, _ in LM_GEMMS]
            checks.append(("binary_gemm_fused", "bf16", m, 300, 77, "ragged"))
        # the hybrid's GEMMs at decode and chunk rows and a 200-row prompt
        from repro_torch.configs.base import get_config
        hyb_cfg = get_config(HYBRID_ARCH)
        for m, where in ((LM_SLOTS, "rg.decode"), (LM_CHUNK, "rg.chunk"),
                         (200, "rg.prompt")):
            checks += [(kn, lhs, m, k, n, where)
                       for kn, lhs, k, n, _ in hybrid_gemms(hyb_cfg)]
        # the other dense-stack families' GEMMs at decode, chunk and prompt rows
        fam_cfgs = [get_config(arch) for arch in FAMILY_ARCHS]
        checks += family_gemm_checks(fam_cfgs)
        # the MoE configs' attention GEMMs (their FFN GEMMs are batched, below)
        moe_cfgs = [get_config(arch) for arch in MOE_ARCHS]
        checks += [ch for ch in family_gemm_checks(moe_cfgs)
                   if not ch[5].endswith((".gate", ".down"))]
        # the vlm family's: its self blocks', the cross q / wo, the image K/V
        vlm_cfg = get_config(VLM_ARCH)
        checks += vlm_gemm_checks(vlm_cfg)
        checks += [(*edge, "edge") for edge in REGIME_EDGES]
        checks += [("binary_gemm_packed", "packed", m, k, n, "edge")
                   for m, k, n in PACKED_EDGES]
        err = {kn: 0 for kn in REPLACES}
        dev_gen = torch.Generator(device=dev).manual_seed(args.seed)
        operands = {}
        for kn, lhs, m, k, n, where in checks:
            if (m, k, n) not in operands:
                operands[(m, k, n)] = Operands(dev_gen, m, k, n)
            err[kn] = max(err[kn], check_gemm(operands[(m, k, n)], kn, lhs,
                                              where, sms))
        main_keys = {(m, k, n) for _, _, m, k, n, _ in shapes}
        for key in [key for key in operands if key not in main_keys]:
            del operands[key]                  # kept: the main paths' operands
        packed_split_checks(dev_gen, sms)
        lm_cfg = get_config(LM_ARCH)
        err.update(lm_kernel_checks(lm_cfg, dev_gen, dev))
        err["pack_bits"] = max(err["pack_bits"],
                               pack_rows_checks(pack_rows_cases(lm_cfg), dev_gen,
                                                dev))
        err.update(lm_paged_kernel_checks(lm_cfg, dev_gen, args.seed, dev))
        for kn, e in lm_long_prefill_checks(lm_cfg, dev_gen, args.seed, dev,
                                            sms).items():
            err[kn] = max(err[kn], e)
        for kn, e in lm_long_decode_checks(lm_cfg, dev_gen, args.seed, dev,
                                           sms).items():
            err[kn] = max(err[kn], e)
        err["decode_attention_packed"] = max(
            err["decode_attention_packed"],
            hybrid_kernel_checks(hyb_cfg, dev_gen, dev, sms))
        err["pack_bits"] = max(
            err["pack_bits"],
            pack_checks(hybrid_pack_check_shapes(hyb_cfg), dev_gen, dev),
            pack_rows_checks(hybrid_pack_rows_cases(hyb_cfg), dev_gen, dev))
        for kn, e in family_kernel_checks(fam_cfgs, dev_gen, args.seed, dev,
                                          sms).items():
            err[kn] = max(err[kn], e)
        for kn, e in moe_kernel_checks(moe_cfgs, dev_gen, args.seed, dev,
                                       sms).items():
            err[kn] = max(err[kn], e)
        for kn, e in vlm_kernel_checks(vlm_cfg, dev_gen, args.seed, dev,
                                       sms).items():
            err[kn] = max(err[kn], e)
    lap("phase 3 (kernels)")

    # ------------------------------------------------------------------ mlp
    cfg = BNN_MNIST
    params = pn.init_mlp(gen, cfg.in_dim, cfg.hidden, cfg.n_hidden,
                         cfg.n_classes, device=dev)
    frozen = pn.freeze_mlp(params)
    n_batches = 3
    xs = [(torch.round((torch.rand(cfg.batch, cfg.in_dim, generator=gen)
                        * 2 - 1) * 128) / 128).to(dev)
          for _ in range(n_batches)]
    bg.reset_launches()
    outs = []
    for x in xs:
        hidden = []
        outs.append((pn.mlp_forward(frozen, x, hidden=hidden), hidden))
    torch.cuda.synchronize()
    mlp_launches = dict(bg.launches)
    want = {"binary_gemm_fused": 2 * n_batches,
            "binary_gemm_packed": n_batches, "binary_gemm_packed_rhs": 0,
            MXU: 0}
    if mlp_launches != want:
        raise AssertionError(f"mlp launches {mlp_launches} != {want}")
    for x, (scores, hidden) in zip(xs, outs):
        if scores.shape != (cfg.batch, cfg.n_classes) \
                or not torch.isfinite(scores).all():
            raise AssertionError("mlp scores are not finite (B, 10)")
        plain_hidden = []
        check_equal("mlp scores vs plain path", scores,
                    pn.mlp_forward(frozen, x, kernel_path="ref",
                                   hidden=plain_hidden))
        for h, p in zip(hidden, plain_hidden, strict=True):
            check_equal("mlp hidden words vs plain path", h.packed, p.packed)
        check_equal("mlp scores vs fp32 masters", scores,
                    pn.mlp_forward(params, x))
    check_equal("mlp scores vs CPU", outs[0][0][:8],
                pn.mlp_forward(to_device(frozen, "cpu"), xs[0][:8].cpu()))
    print(f"mlp: {n_batches} batches of {cfg.batch}, launches {mlp_launches}, "
          f"scores and {len(outs[0][1])} hidden words per batch equal the "
          f"plain path's and the masters'")

    # ------------------------------------------------------------------ cnn
    cfg = BNN_CIFAR10
    params, bn = pn.init_cnn(gen, cfg.in_ch, cfg.widths, cfg.fc,
                             cfg.n_classes, cfg.img, device=dev)
    fan_in = [9 * cfg.in_ch] + [9 * w for w in cfg.widths[:-1]]
    for i, cp in enumerate(params["convs"]):
        spread = 1 / 3 if i == 0 else 1.0   # float pixels vs +-1 inputs
        cp["bn"], bn["convs"][i] = random_bn(gen, cfg.widths[i], fan_in[i],
                                             spread, dev)
    flat = (cfg.img // 8) ** 2 * cfg.widths[-1]
    params["fc1"]["bn"], bn["fc1"] = random_bn(gen, cfg.fc, flat, 1.0, dev)
    params["fc2"]["bn"], bn["fc2"] = random_bn(gen, cfg.fc, cfg.fc, 1.0, dev)
    frozen = pn.freeze_cnn(params, bn, bn_kind=cfg.bn_kind)
    n_batches = 2
    xs = [(torch.round((torch.rand(cfg.batch, cfg.img, cfg.img, cfg.in_ch,
                                   generator=gen) * 2 - 1) * 128) / 128).to(dev)
          for _ in range(n_batches)]
    bg.reset_launches()
    outs = []
    for x in xs:
        hidden = []
        outs.append((pn.cnn_forward(frozen, bn, x, bn_kind=cfg.bn_kind,
                                    hidden=hidden)[0], hidden))
    torch.cuda.synchronize()
    cnn_launches = dict(bg.launches)
    n_binary_convs = len(cfg.widths) - 1
    want = {"binary_gemm_packed_rhs": n_binary_convs * n_batches,
            "binary_gemm_fused": 2 * n_batches,
            "binary_gemm_packed": n_batches, MXU: 0}
    if cnn_launches != want:
        raise AssertionError(f"cnn launches {cnn_launches} != {want}")
    for x, (scores, hidden) in zip(xs, outs):
        if scores.shape != (cfg.batch, cfg.n_classes) \
                or not torch.isfinite(scores).all():
            raise AssertionError("cnn scores are not finite (B, 10)")
        plain_hidden = []
        check_equal("cnn scores vs plain path", scores, pn.cnn_forward(
            frozen, bn, x, bn_kind=cfg.bn_kind, kernel_path="ref",
            hidden=plain_hidden)[0])
        for h, p in zip(hidden, plain_hidden, strict=True):
            check_equal("cnn hidden words vs plain path", h.packed, p.packed)
        check_equal("cnn scores vs fp32 masters", scores,
                    pn.cnn_forward(params, bn, x, bn_kind=cfg.bn_kind)[0])
    check_equal("cnn scores vs CPU", outs[0][0][:2], pn.cnn_forward(
        to_device(frozen, "cpu"), to_device(bn, "cpu"), xs[0][:2].cpu(),
        bn_kind=cfg.bn_kind)[0])
    bits = [h.unpack() for h in outs[0][1]]
    print(f"cnn: {n_batches} batches of {cfg.batch}, launches {cnn_launches}, "
          f"scores and {len(outs[0][1])} hidden words per batch equal the "
          f"plain path; share of +1 bits in fc1/fc2: "
          + ", ".join(f"{float((b > 0).float().mean()):.3f}" for b in bits))

    lap("phases 4-5 (mlp, cnn)")

    # ------------------------------------------------ lm: tokens vs plain
    lm_launches, lm_chunks, lm_reqs, lm_tokens = lm_engine_check(
        lm_cfg, args.seed, dev)
    paged_launches = lm_paged_engine_check(lm_cfg, args.seed, dev)
    default_launches, report["lm_default"] = lm_default_engine_check(
        lm_cfg, args.seed, dev)
    path_launches = {kn: mlp_launches.get(kn, 0) + cnn_launches.get(kn, 0)
                     + lm_launches[kn] + paged_launches[kn]
                     + default_launches[kn] for kn in REPLACES}
    lap("phase 6 (lm, paged, default engine)")

    # ---------------------------------------------------------------- times
    print(f"times on {card} (ms; kernel and library: device time, CUDA "
          f"events over calls queued behind a spin kernel; wrapper, plain "
          f"and library wall: CUDA events over back-to-back calls; bound = "
          f"max(bytes / 3.35 TB/s, min(popc / {popc_per_s / 1e12:.3f} T/s, "
          f"2MNK / 1979 TOP/s int8 TC)))")
    totals = {kn: {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                   "library_ms": 0.0, "library_wall_ms": 0.0}
              for kn in REPLACES}
    rows = []
    for kn, lhs, m, k, n, where in shapes:
        op = operands[(m, k, n)]
        lib_name, lib_fn = library_call(op)
        got = lib_fn()
        ref_dots = op.call("binary_gemm_packed", "packed")
        check_equal(f"{lib_name} vs kernel dots {where}", got.to(torch.int32),
                    ref_dots)
        row = {"kernel": kn, "lhs": lhs, "M": m, "K": k, "N": n,
               "where": where, "library": lib_name,
               **shape_times(lambda: op.call(kn, lhs), kn,
                             lambda: op.call(kn, lhs, plain=True), lib_fn),
               **bound(kn, lhs, m, k, n, popc_per_s)}
        rows.append(row)
        for key in totals[kn]:
            totals[kn][key] += row[key]
        print(f"  {where:9s} {kn:24s} {lhs:6s} M={m:6d} K={k:5d} N={n:5d} "
              f"kernel {row['ms']:.4f} (wrapper {row['wrapper_ms']:.4f})  "
              f"plain {row['plain_ms']:.3f}  {lib_name} "
              f"{row['library_ms']:.4f} (wall {row['library_wall_ms']:.4f})"
              f"  bound {row['bound_ms']:.4f} ({bound_by(row)}; popc "
              f"{row['popc_ms']:.4f}, int8 TC {row['int8_tc_ms']:.4f})  "
              f"{plan_text(kn, m, k, n, sms)}")
    operands.clear()
    report["shapes"] = rows
    lm_gemm_rows = lm_gemm_times(dev_gen, popc_per_s, sms)
    print_gemm_rows(f"lm gemm times on {card} (ms per launch, as above; not "
                    f"in the kernels line):", lm_gemm_rows)
    report["lm_gemm_shapes"] = lm_gemm_rows

    fwd = {}
    cfg_m, cfg_c = BNN_MNIST, BNN_CIFAR10
    mlp_params = pn.init_mlp(gen, cfg_m.in_dim, cfg_m.hidden, cfg_m.n_hidden,
                             cfg_m.n_classes, device=dev)
    mlp_frozen = pn.freeze_mlp(mlp_params)
    xm = (torch.round((torch.rand(cfg_m.batch, cfg_m.in_dim, generator=gen)
                       * 2 - 1) * 128) / 128).to(dev)
    xc = xs[0]
    fwd["mlp frozen (kernels)"] = cuda_ms(lambda: pn.mlp_forward(mlp_frozen, xm))
    fwd["mlp frozen (plain)"] = cuda_ms(
        lambda: pn.mlp_forward(mlp_frozen, xm, kernel_path="ref"), warmup=1)
    fwd["mlp fp32 masters"] = cuda_ms(lambda: pn.mlp_forward(mlp_params, xm))
    fwd["cnn frozen (kernels)"] = cuda_ms(
        lambda: pn.cnn_forward(frozen, bn, xc, bn_kind=cfg_c.bn_kind), warmup=2)
    fwd["cnn frozen (plain)"] = cuda_ms(
        lambda: pn.cnn_forward(frozen, bn, xc, bn_kind=cfg_c.bn_kind,
                               kernel_path="ref"), warmup=1, max_iters=5)
    fwd["cnn fp32 masters"] = cuda_ms(
        lambda: pn.cnn_forward(params, bn, xc, bn_kind=cfg_c.bn_kind), warmup=2)
    print(f"forward per batch on {card} (ms; mlp batch {cfg_m.batch}, "
          f"cnn batch {cfg_c.batch}):")
    for key, ms in fwd.items():
        print(f"  {key:22s} {ms:.4f}")
    report["forwards"] = fwd

    # where a frozen forward's time goes: one profiled call each
    traces = {
        "mlp": trace(lambda: pn.mlp_forward(mlp_frozen, xm)),
        "cnn": trace(lambda: pn.cnn_forward(frozen, bn, xc,
                                            bn_kind=cfg_c.bn_kind))}
    for key, t in traces.items():
        print_trace(f"trace {key} frozen on {card}", t)
    report["traces"] = traces

    # ------------------------------------------- lm: kernel times, timed run
    lm_rows, lm_totals = lm_kernel_times(lm_cfg, dev_gen, dev, popc_per_s)
    print_attention_rows(
        f"lm kernel times on {card} (ms per launch, as above; bound = "
        f"max(bytes / 3.35 TB/s, popc / {popc_per_s / 1e12:.3f} T/s, V adds "
        f"/ 67 TFLOP/s); pack_bits has no single PyTorch call computing it):",
        lm_rows, 45)
    totals.update(lm_totals)
    report["lm_shapes"] = lm_rows
    parts = pack_wrapper_parts(lm_cfg, dev_gen, dev)
    print(f"pack_bits wrapper call on {card}, decode-step shapes (ms per "
          f"call, CUDA events over back-to-back calls): the whole wrapper = "
          f"the bare C entry (ctypes launch) + torch.empty of the output + "
          f"the wrapper's checks and argument reads:")
    for entry, p in parts.items():
        print(f"  {entry:16s} wrapper {p['wrapper_ms']:.4f} = C entry "
              f"{p['c_entry_ms']:.4f} + alloc {p['alloc_ms']:.4f} + checks "
              f"{p['checks_ms']:.4f}")
    report["pack_wrapper_parts"] = parts
    long_rows = lm_long_prefill_times(lm_cfg, dev_gen, dev, popc_per_s)
    print_attention_rows(f"lm long-context prefill times on {card} (ms, as "
                         f"above; not in the kernels line):", long_rows)
    report["lm_long_prefill"] = long_rows
    sweep = prefill_split_sweep(lm_cfg, dev_gen, dev, sms)
    print(f"prefill T split sweep on {card} (kernel 8, one slot's 32-row "
          f"chunk, bf16; device ms at split 1 / 2 / 4 / 8):")
    for r in sweep:
        print(f"  T={r['T']:5d} q_pos={r['q_pos']:5d}  "
              + " / ".join(f"{r['ms'][sp]:.4f}" for sp in (1, 2, 4, 8))
              + f"  (attention_plan: split {r['plan_split']})")
    report["prefill_split_sweep"] = sweep
    long_rows = lm_long_decode_times(lm_cfg, dev_gen, dev, popc_per_s)
    print_attention_rows(f"lm long-context decode times on {card} (ms, as "
                         f"above; not in the kernels line):", long_rows, 40)
    report["lm_long_decode"] = long_rows
    sweep = decode_split_sweep(lm_cfg, dev_gen, dev, sms)
    print(f"decode split sweep on {card} (kernels 6 and 7, 4 slots' decode "
          f"step, bf16; device ms at split 1 / 2 / 4 / 8):")
    for r in sweep:
        print(f"  {r['kernel']:30s} T={r['T']:5d} lens {r['lens']}  "
              + " / ".join(f"{r['ms'][sp]:.4f}" for sp in (1, 2, 4, 8))
              + f"  (attention_plan: split {r['plan_split']})")
    report["decode_split_sweep"] = sweep
    timed, eng = lm_timed_run(lm_cfg, args.seed, dev, card)
    sched = eng.scheduler()
    pos = torch.full((LM_SLOTS,), 300, dtype=torch.int32, device=dev)
    step = trace(lambda: sched.model.decode(sched.params, sched._state["cur"],
                                            sched._cache, pos))
    print_trace(f"trace lm decode step (depth {lm_cfg.n_layers}, {LM_SLOTS} "
                f"slots at position 300) on {card}", step)
    timed["decode_step_trace"] = step
    timed["route_table_step"] = route_table_step(
        lambda: sched.model.decode(sched.params, sched._state["cur"],
                                   sched._cache, pos), lm_cfg, card)
    report["lm_timed"] = timed
    report["lm_paged_timed"] = lm_paged_timed_run(
        lm_cfg.scaled(kv_bits=1), eng.params, args.seed, dev, card)
    report["lm_default_timed"] = lm_default_timed_run(
        lm_cfg, eng.params, args.seed, dev, card, timed["cache_packed_bytes"])
    report["lm_f32_whole_vs_chunked"] = lm_f32_whole_vs_chunked(
        lm_cfg, eng.params, args.seed, dev, card)
    del eng, sched
    torch.cuda.empty_cache()
    report["float_attention"] = float_attention_times(lm_cfg, dev_gen, dev,
                                                      card)
    torch.cuda.empty_cache()
    lap("phase 7 (times)")

    # ----------------------------------------------------------------- train
    err[MXU], train_launches, mxu_rows, report["train"] = train_phase(
        args.seed, dev, card, dev_gen)
    trained_convs = report["train"].pop("trained_convs")
    path_launches[MXU] += train_launches
    for row in mxu_rows:
        for key in totals[MXU]:
            totals[MXU][key] += row[key]

    # ------------------------------------------------------------------- ssm
    err[SCAN], ssm_launches, totals[SCAN], report["ssm"] = ssm_phase(
        args.seed, dev, card, dev_gen, exp_per_s, fp64_per_s)
    for kn in REPLACES:
        path_launches[kn] += ssm_launches[kn]

    # ---------------------------------------------------------------- hybrid
    hybrid_launches, report["hybrid"] = hybrid_phase(
        args.seed, dev, card, dev_gen, popc_per_s)
    for kn in REPLACES:
        path_launches[kn] += hybrid_launches[kn]

    # ------------------------------------------------------ dense families
    late = time.perf_counter() - start > FAMILY_LATE_S
    family_launches, report["families"] = family_phase(
        args.seed, dev, card, dev_gen, popc_per_s, sms, late)
    for kn in REPLACES:
        path_launches[kn] += family_launches[kn]

    # ------------------------------------------------------------------ moe
    moe_launches, report["moe"] = moe_phase(args.seed, dev, card, dev_gen,
                                            popc_per_s, sms, late)
    for kn in REPLACES:
        path_launches[kn] += moe_launches[kn]

    # ------------------------------------------------------------------ vlm
    vlm_launches, report["vlm"] = vlm_phase(args.seed, dev, card, dev_gen,
                                            popc_per_s, sms)
    for kn in REPLACES:
        path_launches[kn] += vlm_launches[kn]

    # ------------------------------------------------------------- lm train
    lm_train_launches, report["lm_train"] = lm_train_phase(args.seed, dev,
                                                           card)
    for kn in REPLACES:
        path_launches[kn] += lm_train_launches[kn]

    # ------------------------------------------------------------ lifecycle
    lifecycle_launches, report["lifecycle"] = lifecycle_phase(
        lm_cfg, args.seed, dev, card, lm_reqs, lm_tokens)
    for kn in REPLACES:
        path_launches[kn] += lifecycle_launches[kn]

    # ----------------------------------------------------------- route table
    report["route_table"] = route_table_phase(
        card, sms, report["lifecycle"]["cli_lines"])

    # ----------------------------------------------------------------- mesh
    mesh_launches, report["mesh"] = mesh_phase(
        lm_cfg, args.seed, dev, card, dev_gen, lm_reqs, lm_tokens)
    for kn in REPLACES:
        path_launches[kn] += mesh_launches[kn]

    # ------------------------------------------------------------ mesh train
    mesh_train_launches, report["mesh_train"] = mesh_train_phase(
        args.seed, dev, card)
    for kn in REPLACES:
        path_launches[kn] += mesh_train_launches[kn]

    # ---------------------------------------------------------- placed train
    report["placed_train"] = placed_train_phase(
        args.seed, dev, card,
        report["mesh_train"]["step"]["peak_above_inputs_bytes"]["mesh"])

    # --------------------------------------------------------------- dry run
    report["dryrun"] = dryrun_phase(card, args.seed, dev,
                                    report["lm_train"],
                                    report["placed_train"]["step"],
                                    trained_convs)

    kernels = []
    for kn in REPLACES:
        t = totals[kn]
        kernels.append({
            "name": kn, "route": "cuda", "source": SOURCES[kn],
            "replaces": REPLACES[kn], "launches": path_launches[kn],
            "max_abs_err": err[kn], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
            "library_ms": t["library_ms"]})
    report["kernels"] = kernels
    report["kernel_totals"] = totals
    for kn, t in totals.items():
        lib = "—" if t["library_ms"] is None else \
            f"{t['library_ms']:.4f} (wall {t['library_wall_ms']:.4f})"
        print(f"total {kn:24s} kernel {t['ms']:.4f} (wrapper "
              f"{t['wrapper_ms']:.4f})  plain {t['plain_ms']:.3f}  library "
              f"{lib}  bound {t['bound_ms']:.6f}")
    report["launches"] = {"mlp": mlp_launches, "cnn": cnn_launches,
                          "lm": lm_launches, "lm_chunks": lm_chunks,
                          "lm_paged": paged_launches,
                          "lm_default": default_launches, "ssm": ssm_launches,
                          "hybrid": hybrid_launches,
                          "families": family_launches, "moe": moe_launches,
                          "vlm": vlm_launches, "mesh": mesh_launches,
                          "mesh_train": mesh_train_launches}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print("kernels line: ms and library_ms are device times (device_ms), "
          "plain_ms CUDA-event time; the popcount GEMMs' times are summed "
          "over one mlp and one cnn forward's launches of each kernel, "
          f"{MXU}'s over one bnn-cifar10 train step's five; pack_bits "
          "(two shared packs and one K|V rows pack each), decode and "
          "prefill attention times (contiguous and paged) over "
          "one LM layer's launches in one decode step and one prefill chunk "
          "(the two chunk shapes weighted 1/2), and selective_scan's over "
          "one falcon-mamba layer's in one decode step and one prefill "
          "chunk; the paged kernels' library_ms leaves out the gather "
          "(printed beside it); launches count the mlp, cnn, depth-2 "
          "contiguous and paged LM runs, the depth-2 default engine's run, "
          f"the auto route's {TRAIN_STEPS} train steps, the depth-2 "
          "falcon-mamba runs (chunked and whole-prompt), the depth-5 "
          "recurrentgemma runs (chunked kv_bits=1 and the default engine) "
          "the depth-2 runs of deepseek-67b, qwen2-72b, nemotron-4-15b, "
          "musicgen-large, dbrx-132b and llama4-scout-17b-a16e and the "
          "depth-10 runs of llama-3.2-vision-11b (chunked kv_bits=1, the "
          "default engine, paged kv_bits=1 with the prefix cache) and "
          "phase 14's serve of the trained phi3-medium-14b checkpoint "
          "and phase 15's lifecycle runs (fault-free, faulted, and the "
          "engine switched by freeze(kv_bits=1)) and phase 17's run of "
          "phase 6's engine on a 2 x 2 mesh of the card and phase 18's "
          "serve of the 2 x 2-trained musicgen-large checkpoint on a 2 x 1 "
          "mesh of the card")
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s after the build")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
