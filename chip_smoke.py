#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from this checkout, holds each against its plain
PyTorch version, drives kaffpa end to end at a 1M-vertex mesh, kahypar
end to end at a 131k-vertex power-law hypergraph, zamba2-2.7B at full
width (a 2048-token forward and a served request stream), and the node
separator at the 1M-vertex mesh with a nested-dissection ordering and an
edge partition beside it, then the memetic programs (kaffpaE at a
262k-vertex mesh, KaBaPE, kahyparE, the memetic separator), process
mapping with the ILP improvement, and the distributed programs (parhip,
parhyp, the distributed edge partition, the island ring) on a world of
one, through an NCCL process group where a mesh is asked for, then the
attention decoders at their published widths (minicpm-2B whole and
served, llama4-scout's MoE with expert placement by kaffpa, deepseek-v2's
MLA), rwkv6-7B (forward, O(1)-state decode, served) and whisper-medium
(encoder and cross-attention), then trains minicpm-2B at full width
(with the hybrid and ssm families and pipeline stages beside it), runs
every model family under a (1, 1) NCCL mesh (the tensor-parallel code
path at a model extent of 1) and sizes every arch's per-rank blocks, then
writes and reads the graph and partition file formats at the 1M-vertex
mesh beside a recorded kaffpa and serves deepseek-v2 with live telemetry
and its traffic hypergraph partitioned by kahypar, and prints what it
measured.  Any failure exits non-zero before the result
line.
Phases:

 1. The card's name and power limit; build kernels/csrc/lp_affinity.cu,
    kernels/csrc/pin_count.cu, kernels/csrc/ssd_scan.cu and
    kernels/csrc/attention_fwd.cu for sm_90a (one nvcc each, started
    together) and print the build times.
 2. lp_affinity against ``ref.affinity_ref`` at the sweep shapes of
    tests/test_kernels.py plus k = 16 (a register bucket) and k = 33 (the
    shared-memory histogram), B = 1 and 4: integer weights exactly, float
    weights within 1e-5.
 3. The kaffpa main path: ``interface.kaffpa`` with mode ECO on
    grid2d(1024, 1024) (1,048,576 vertices, 2,095,104 edges), nparts=16,
    imbalance=0.03, seed=1.  The kernel's launch count is set to 0 just
    before and read just after; the partition must be feasible and the
    count > 0.
 4. The same run with ``use_kernel=False`` (the plain COO path on the
    card): the partition must be identical and launch nothing.
 5. ECOSOCIAL on barabasi_albert(65536, 4) at k=8 (LP-clustering
    coarsening on the card): feasible, and the kernel launched.
 6. lp_affinity at the kaffpa main path's level-0 shape (the run's own ELL
    view and partition, B = 1 and 4): agreement, then times of the kernel,
    the plain version and one PyTorch call computing the same function
    (``scatter_add_``, timed only), beside the least time the card could
    take for the bytes this run's inputs need (padding slots' ids are not
    counted: no version needs them).
 7. pin_count's two entries against their plain versions, B = 1 and 4,
    0/1 masks exactly and float masks within 1e-5 (abs, and relative to
    the count): the CSR entry (``pin_count_csr_cuda``, the pin list by net
    offsets) against ``ref.pin_count_csr_ref`` at the sweep shapes of
    tests/test_hypergraph.py plus k = 8 and at a skewed hypergraph with one
    net of 4100 pins (nets above 32 pins are split across a warp), the ELL
    entry (``pin_count_cuda``) against ``ref.pin_count_ref`` at the sweep
    and, 0/1 masks only, at the skewed hypergraph's 8192-slot ELL (every
    row split across a warp).
 8. The kahypar main path: ``interface.kahypar`` with mode ECO, objective
    km1, on rmat_hypergraph(17, seed=1) (131,072 vertices, 131,072 nets,
    707,640 pins), nparts=8, imbalance=0.03, seed=1.  The pin-count
    kernel's launch count is set to 0 just before and read just after; the
    partition must be feasible, the count > 0, and ``to_ell_h`` called 0
    times (the kernel path reads the pin list).
 9. The same run with ``use_kernel=False``: the identical partition, and
    no launch.
10. The cut-net objective on rmat_hypergraph(14, seed=2) at k=4: feasible,
    the kernel launched, and the cut below a random partition's.
11. pin_count at the kahypar main path's level-0 shape (the run's own
    partition, B = 1 and 4): the CSR entry on the level's pin list, exact
    against its plain version, then times of the kernel (device time per
    launch by torch.profiler, and per wrapper call back to back), the plain
    version and the COO ``scatter_add_`` of ``M.pin_counts_device`` (timed
    only), beside the bound (the real pins' ids and masks, the offsets,
    labels and cnt); the host seconds of the level's ``to_ell_h`` (which
    the kernel path no longer pays), then the ELL entry on that view, 0/1
    masks exactly and float masks within 1e-5, timed the same way beside
    its own bound, plain version and ``scatter_add_``.  A device time per
    launch is read only from a trace that holds every launch of its calls.
12. ssd_scan against ``ref.ssd_scan_ref`` at the sweep shapes of
    tests/test_kernels.py::test_ssd_scan_sweep (inputs drawn as that test
    draws them) within 3e-4 abs and rel, and the grouped form
    (``heads`` in 1, 3 rows sharing one row of B and C) against
    ``ref.ssd_scan_grouped_ref``.
13. zamba2-2.7B at full width (the published config: 54 layers, d_model
    2560, 2,341,405,600 f32 parameters made on the card from seed 0): the
    full-sequence forward on tokens (B = 2, L = 2048) on the kernel path
    (``engine=None``) with the SSD launch count zeroed just before and
    read just after (54: one per Mamba layer), and on the plain path
    (``engine="chunked"``, no launch); the logits agree within 1e-3 of
    max |logits|.  On both paths the fused attention kernel's launch
    count and the composed attention's count, zeroed just before and read
    just after, are 9 and 0: the shared block's every application takes
    the kernel.  Walls after one warm-up each, and each path's peak
    memory.  Then the kernel at the forward's shape (BH = 160, L = 2048,
    P = N = 64, chunk 128) on the first layer's real inputs, grouped (80
    heads per row of B and C, as the main path calls it) and per row (B
    and C expanded), each held to 1e-3 of max |y| against the exact
    recurrence.
14. Serving: ``serve_stream`` with 6 requests (prompts of 16–64 tokens,
    16 new tokens each, arrival ticks 0–8, 4 slots, max_len 256): every
    request finishes with 16 tokens; wall, tokens/s and the SSD launch
    count (0: decode runs the recurrence).
15. Each request's prefill logits (token by token through the batcher's
    ``prefill_step``)
    against the kernel-path forward on its prompt at the last position,
    within 2e-3 of max |logits|, and whether the argmax agrees.
16. ssd_scan timed at the forward's shape in both forms (3xTF32) beside
    the plain recurrence, the chunked torch engines (``ssd_chunked``,
    ``ssd_chunked_grouped``) and the bounds, and each form's device time
    per launch (state pass, chunk pass, output pass) by torch.profiler,
    from a trace that holds all 3 launches of each of its 10 calls.

17. sep_affinity (kernel 1 at k = 3 over the neighbours' vertex weights,
    ``ops.sep_weights``) against ``ref.affinity_ref`` on the same slot
    weights at the sweep shapes below k = 130 and on grid2d(16, 16), whose
    256 vertices fill their 256-row view (padding slots point at a real
    vertex), B = 1 and 4, integer and float vertex weights: bit for bit.
18. The separator main path: ``interface.node_separator`` with nparts=2,
    imbalance=0.2, mode ECO, seed=1 on grid2d(1024, 1024).  The counts of
    lp_affinity and sep_affinity launches and of ``to_ell`` calls are set
    to 0 just before and read just after; the separator must be feasible,
    pass ``verify_separator``, have launched sep_affinity, and have built
    at most one ELL view per level.
19. The same run with ``use_kernel=False``: identical labels, no launch
    and no ELL view.
20. sep_affinity at the main path's level-0 shape (its own labels, B = 1
    and 4): bit for bit, then times as in phase 6 (CUDA events over
    back-to-back calls) of the kernel's launch, the whole
    ``ops.sep_affinity`` call, the plain version and ``scatter_add_`` on
    the same ELL and slot weights (timed only), beside the bound (the
    weight array, live slots' ids, labels and the (B, n_pad, 3) output).
21. ``interface.reduced_nd`` (ECO) on grid2d(64, 64): a permutation, the
    number of separator subproblems and waves, and the launches.
22. ``edge_partition`` k=4 (ECO) on grid2d(256, 256): every edge in a
    block of [0, 4), replication and balance beside a naive split's, and
    lp_affinity launched.

23. The memetic main path: ``interface.kaffpaE`` with mode ECO on
    grid2d(512, 512) (262,144 vertices), nparts=16, imbalance=0.03,
    seed=1, 2 islands x 2 members, 2 generations, lp_affinity's launch
    count zeroed just before and read just after: feasible, launched, and
    a cut no worse than ``interface.kaffpa``'s at the same mode and seed
    (member 0 of island 0 is that run); the spans population /
    generation / generation_sweep / migration and the memetic/* counters.
24. The same evolution on grid2d(256, 256) (cut from 512 x 512 to keep
    the slice's phases near their time budget), once through
    ``interface.kaffpaE`` and once on the plain path (``evolve_islands``
    over a ``GraphMedium`` with ``use_kernel=False``): the identical
    partition, and no launch on the plain path.
25. KaBaPE: ``kabape.kabapeE`` (``evolve.kaffpaE(enable_kabape=True)``)
    on grid2d(256, 256), k=8, eps=0, 2 x 2, 2 generations: strictly
    balanced (every block <= ceil(W/k) = 8192), lp_affinity launched,
    and the launches made by the gain matrix counted apart.
26. kahyparE: ``interface.kahyparE`` ECO km1 on rmat_hypergraph(14,
    seed=2) at k=4, 2 x 2, 2 generations: feasible, km1 no worse than
    ``interface.kahypar``'s at its seed, pin_count launched and
    ``to_ell_h`` called 0 times (every launch is the CSR entry).
27. The memetic separator: ``memetic_node_separator`` ECO, eps=0.2, on
    grid2d(256, 256), 2 x 2, 2 generations: feasible, ``verify_separator``
    true, a weight no heavier than the multilevel
    ``interface.node_separator``'s at its seed, sep_affinity launched.
28. ``interface.process_mapping`` ECO on grid2d(512, 512), hierarchy
    [4, 4], distances [1, 10], depth 2, seed 1: the blocks a permutation of
    the partition's, the QAP below the identity mapping's on the same
    partition, lp_affinity launched; then ``ilp.ilp_improve`` on
    grid2d(64, 64) at k=4 from a kaffpa partition (timeout 5 s): never
    worse.

29. ``parhip.parhip`` fastmesh on grid2d(1024, 1024), k=16, ε=0.03,
    seed 1, ``mesh=None`` (a world of one on the card), lp_affinity's
    count zeroed just before and read just after: feasible, at least one
    distributed round (``parhip/dist_rounds``), lp_affinity launched
    (the tournament; the force-balance repairs); the cut beside phase
    3's, the wall and ``parhip/repairs``.  The first lp_affinity call of
    each distinct shape keeps a copy of its inputs; after the count is
    read, each is held against ``ref.affinity_ref`` bit for bit (the
    coarsest level's ELL with the tournament's rows and k, and whatever
    else the path launched).
30. parhip ultrafastsocial on barabasi_albert(65536, 4), k=8: feasible;
    cut, wall, launches; lp_affinity held at the path's shapes as in 29.
31. The collectives on the card: an NCCL process group of one rank
    (``dist.HashStore``, no network) as a ``core.mesh.Mesh``.  parhip on
    grid2d(256, 256) k=4 through it gives ``mesh=None``'s partition,
    ``parhyp_refine`` on rmat_hypergraph(12) k=4 through its ``nets``
    view gives ``mesh=None``'s, and ``ring_roll`` of an (8, 65536) int32
    matrix through it equals ``np.roll`` at shifts -1..8; the counts of
    all-reduce, all-gather and point-to-point calls are logged.
32. ``interface.parhyp`` fast km1 on rmat_hypergraph(17, seed=1), k=8
    (the device-resident V-cycle: n > ``_DEVICE_MIN_N``), pin_count's
    count zeroed just before and read just after: feasible, at least 2
    device levels, pin_count's CSR entry launched (the per-shard Φ of
    every distributed round), ``to_ell_h`` called 0 times; km1 beside
    phase 8's, wall, peak memory and the spans.  Then every pin_count
    call of the path (one per distinct shape, its own inputs: the
    per-shard Φ at each device level, the coarsest level's kahypar)
    against ``ref.pin_count_csr_ref``, max |err| 0, and lp_affinity's
    calls, if any, as in 29.  (rmat_hypergraph(20)
    took 45 s on an H100 80GB HBM3, 700.00 W: ``tools/parhyp_scale.py``
    measures it outside this script.)
33. parhyp fast km1 and cut on rmat_hypergraph(14, seed=2), k=4, on the
    kernel path and with ``use_kernel=False``: identical partitions, no
    launch on the plain path.  Then the shard's Φ at phase 32's level-0
    shape (its own partition, B = 1) by ``ops.pin_count_csr`` against
    the scatter and ``ref.pin_count_csr_ref``, max |err| 0, and timed as
    phase 11 beside its bound, plain version and the scatter; and on
    each coarse level of phase 32's device hierarchy (random labels),
    where merged duplicates stay inside their net's range as mask-0
    pins, the CSR route against the scatter, max |err| 0.
34. ``edgepart.distributed_edge_partition`` fastmesh k=4 on grid2d(256,
    256): every edge in a block of [0, 4), lp_affinity launched,
    replication beside phase 22's; lp_affinity held at the path's shapes
    as in 29.

35. minicpm-2B, the published config (40 layers, d_model 2304, 36 heads,
    d_ff 5760, vocab_pad 122880, tied; 2,725,173,504 f32 parameters made
    on the card from seed 0, counted and checked): the full-sequence
    forward at B = 2, L = 2048 (wall after a warm-up, peak memory, finite
    logits of shape (2, 2048, 122880)); the timed forward takes the fused
    attention kernel in all 40 layers and the composed path in none (the
    counts zeroed just before and read just after; each timed forward of
    phases 35-43 prints its two counts).  At L = 2048, S·Skv is exactly
    ``ONLINE_THRESHOLD²``, so the composed path (the one with gradients)
    is the masked one: layer 0's real q, k, v of a 4096-token prompt also
    go through ``_sdpa_online`` and ``_sdpa``, which agree within 1e-4 of
    max |out|.
36. minicpm decode: ``prefill_step`` (one forward at cache_pos=0) of
    prompts of 64 and 48 tokens into two slots of one cache, then 16
    batched ``decode_step``s with per-row cursors; the prefills' last
    logits and every step's within 2e-3 of max |logits| of the full
    forward over that row's sequence; the host-clock time per decode step
    beside the weight-read bound (the f32 weights at 3.35 TB/s).
37. minicpm serve: phase 14's stream (6 requests, prompts of 16–64
    tokens, 16 new tokens each, arrival ticks 0–8, 4 slots, max_len 256):
    wall, tokens/s, step spans; every request gives 16 tokens inside the
    vocabulary; each batcher prefill (token by token, as the JAX batcher
    runs it) within 2e-3 of the forward at the prompt's last position.
38. llama4-scout at its published width, 2 of 48 layers (6,475,146,240
    parameters, untied): the forward at B = 1, L = 2048, then once more
    with ``observe_gates``: each layer reports 2048 x 1 expert ids in
    [0, 16); the expert-load histograms.  At capacity factor 8 (nothing
    drops) token-by-token decode of 16 tokens within 2e-3 of the forward;
    a batched decode of 4 rows with per-row cursors (each row dispatched
    alone) within 1e-4 of each row decoded alone, over 8 steps, with the
    layer-steps where two rows chose one expert counted.
    ``expert_placement`` of layer 0's gates onto 4 shards on the card,
    lp_affinity's count zeroed just before and read just after: a
    permutation, at least one launch, every call held against its plain
    version; ``place_experts`` keeps layer 0's ``moe_ffn`` output (rtol
    1e-4, atol 1e-5).
39. deepseek-v2 at its published width, 2 of 60 layers (8,992,814,080
    parameters): the forward at B = 1, L = 1024; at capacity factor 8 a
    48-token ``prefill_step`` and 16 absorbed one-token decode steps
    within 2e-3 of the forward; the cache bytes per token.
40. rwkv6-7B, the published config (32 layers, d_model 4096, 64 heads of
    64, d_ff 14336, vocab 65536, tied; 7,266,111,488 f32 parameters made
    on the card from seed 0, counted and checked): the forward at B = 2,
    L = 2048 (wall after a warm-up, peak memory, finite logits of shape
    (2, 2048, 65536)); then layer 0's time mix alone on its real inputs at
    B = 1, L = 2048, 8192 and 32768, the time per token of each (the
    chunked WKV, a loop over chunks of 16, is linear in L).
41. rwkv6 decode: as phase 36, with ``prefill_step`` running the 64- and
    48-token prompts token by token (the state takes one step per call):
    every logit row within 2e-3 of max |logits| of the forward; the host
    ms per step beside the weight-read bound; the state's bytes per row,
    (2·4096 + 64·64·64)·4 B per layer at any position (checked at
    max_len 1 and 4096).
42. rwkv6 serve: phase 37 on rwkv6-7B (a reused slot's state is zeroed
    before its prefill).
43. whisper-medium, the published config (24 encoder and 24 decoder
    layers, d_model 1024, 16 heads, d_ff 4096, vocab_pad 52224, tied;
    959,571,968 parameters from seed 0): the forward on seeded normal
    frames (2, 1500, 1024) and 448 decoder tokens (wall after a warm-up,
    peak memory, finite logits of shape (2, 448, 52224)); the encoder
    alone timed beside it.
44. whisper transcription: ``prefill_step`` of 4- and 8-token prompts,
    each row with its own frames, at cache_pos 0 (it fills ``k``/``v``
    and the cross-attention ``xk``/``xv``), then 16 batched
    ``decode_step``s with per-row cursors and no frames: every step
    within 2e-3 of the forward over that row's sequence with its frames;
    ``xk``/``xv`` non-zero after the prefills and unchanged by decode; the
    host ms per step beside the bound (decoder and tied-head weights plus
    both rows' ``xk``/``xv``).
    Each model is freed before the next; each prints its peak memory.
    No kernel runs on phases 35-44's model paths but expert placement's.
45. minicpm-2B trains at its published config (2,725,173,504 f32
    parameters from seed 0, counted and checked):
    ``make_train_step(remat="full", microbatches=2)`` with AdamW/WSD on
    ``batches`` of global batch 2 x seq_len 2048; a warm-up step, then 3
    timed steps, each ending in a sync: loss and grad_norm per step
    (finite), ms per step, tokens/s, peak memory, FLOP per step
    (``train_flops``) and FLOP/s against the f32 peak; every parameter's
    gradient non-zero after the warm-up (a graph cut by a kernel without
    a backward would leave zeros); ``adamw_update`` alone beside its
    byte bound; then 4 steps on one fixed batch at a constant lr 3e-4,
    and the loss after them below the first.
46. The train step's equivalences at full width, 2 layers deep (B = 2,
    S = 512): the grads under remat "full" and "dots" within 1e-5 of
    "none" (of each reference leaf's max |g|); ``microbatches=2``
    against 1 from the same weights, loss and grads within 1e-5
    relative; ``grad_compress=True``, one step, every int8 residual
    non-zero; ``prefill_step`` + ``decode_step`` on the trained model
    give logits without a graph.
47. zamba2-2.7B at full width, 6 layers (one group plus the shared
    block), and rwkv6-7B at full width, 2 layers, B = 1, S = 2048: a
    warm-up and a timed train step each (finite loss, every gradient
    non-zero: the Mamba2 and time-mix parameters included); zamba2's
    forward under grad on ``engine="kernel"`` raises (the SSD kernel has
    no backward) and launches nothing.
48. ``partition_layers`` of mistral-large-123B (88 layers) into 8
    pipeline stages on the card: equal to ``device="cpu"``, contiguous,
    stage sizes within 1; lp_affinity's launches counted from 0 (> 0,
    ``launches_by_path["partition_layers"]``) and each call held against
    its plain version.
49. The collectives tensor parallelism adds, through an NCCL group of
    one rank (as phase 31 builds it) made a (data 1, model 1) mesh by
    ``launch.mesh.make_mesh``: ``Mesh.all_to_all`` over ``model`` and the
    per-axis ``Mesh.all_gather`` (over ``model`` on dims 1 and 2, over
    ``data``, over the whole mesh) keep a (1, 4096, 5120) f32 tensor;
    the all-to-all timed; the calls counted.
50. minicpm-2B whole and llama4-scout at 2 layers, at full width, made
    with ``init_params(mesh=)`` on that mesh: the forward at B = 1, L =
    2048, and a 64-token ``prefill_step`` + 16 greedy ``decode_step``s
    (caches from ``init_caches(mesh=)``), under ``shardings.use_mesh`` of
    the mesh, give logits bit for bit equal to the same runs without a
    mesh.
51. The per-rank bytes of the f32 parameters of all ten archs at their
    published configs (shapes only, under ``FakeTensorMode``) on (data,
    model) = (1, 4) and (2, 2): under the reference's ``param_specs``,
    and under the port's explicit layout (the ``model`` blocks only),
    one line each.
52. The file formats and the recorded kaffpa path at phase 3's graph
    (grid2d(1024, 1024)): ``write_metis``, then ``graph2binary`` and
    ``graph2binary_external`` (byte-identical files, each converter
    timed), ``read_binary`` giving back ``xadj`` and ``adjncy``;
    ``interface.kaffpa`` ECO k=16 seed 1 in turns with no recorder, with
    ``report=`` a ``Recorder`` (lp_affinity's
    launches counted from 0, > 0 and equal to the recorder's count,
    every distinct shape held against its plain version), with one
    again, and with none: the same partition as each other and as phase
    3, the four walls logged; the partition through ``write_partition`` /
    ``read_partition`` and the binary pair; ``write_jsonl`` /
    ``read_jsonl`` keep every event; the Chrome trace's B/E events
    balance on every tid; inside a short torch.profiler window (kaffpa
    on grid2d(64, 64)) the profiler's events carry the recorder's span
    names (``multilevel``, ``refine``) as host operations, none of them
    a user annotation or a device event.
53. (Run inside phase 39's section, on deepseek-v2's 2-layer weights.)
    Phase 14's stream through ``serve_stream`` with
    ``ServeTelemetry(recorder=, traffic=)`` and the gate tap
    (``moe.observe_gates``) into a ``TrafficAccumulator(160,
    decay=0.95)``, again with neither, and with telemetry but no tap:
    identical tokens, the three walls; the queue,
    prefill, decode and end-to-end p50/p95/p99 and the tokens/s of
    ``tele.snapshot()``; in the Chrome trace the tracks ``slot 0`` …
    ``slot 3`` and ``queue``, every request's ``req``/``prefill``/
    ``decode`` B/E pairs nested and closed, one ``tok`` instant per token
    after the first; the snapshot hypergraph passes ``check()`` with 160
    vertices; ``kahypar(hg, 4, preset="eco")`` on the card (pin_count's
    launches counted from 0, > 0, every call's inputs held against the
    plain version) and its km1 beside the identity placement's (experts
    40·r … 40·r+39 on shard r); after ``set_baseline()`` a second stream
    (seed 3), then ``advise``: the drift and both gauges.

54. (Run after phase 16.) ``ops.ssd_scan`` grouped at zamba2's per-rank
    shape on (data 1, model 4): 2 rows of B and C, each shared by 20 of
    the 80 SSM heads (BH = 40), L = 2048, P = N = 64, chunk 128, on the
    sweep's draws: within 3e-4 (abs + rel) of
    ``ref.ssd_scan_grouped_ref``, timed beside the plain version and its
    byte bound (in the kernels line as the grouped row's
    ``per_rank_shape``).
55. (Run after phase 50, through the same mesh.) zamba2-2.7B, rwkv6-7B
    and whisper-medium whole and deepseek-v2 at 2 layers, full width:
    the forward at B = 1 (L = 2048; whisper 448 tokens on 1500 frames,
    deepseek-v2 1024), a 16-token ``prefill_step`` (token by token on
    the hybrid and ssm families, with the frames on whisper) and 4
    greedy decode steps under ``use_mesh`` of the (1, 1) mesh: bit for
    bit the runs without a mesh (``tp_rmsnorm``, the Mamba2 segments and
    rwkv6's gathered receptance at a model extent of 1).
56. (Run with phase 51.) Phase 51's port bytes are the blocks
    ``shardings.tp_block`` gives a rank (the Mamba2 segments, rwkv6's
    per-head leaves), every arch now having a tensor-parallel form; and
    deepseek-v2 at the depth tools/serve_torch_sharded.py's deepseek mode
    takes on this card (the most of its 60 layers that leave 15 GB
    free): its per-rank bytes under the specs and the port's blocks.
    The port's blocks are `shardings.rank_block`'s: on (2, 2) each rank
    also holds its FSDP shard over data.
57. (Run after phase 55, through the same mesh.) gemma2-9B at full width
    cut to 2 layers (1.31 B parameters): three train steps of 1 x 2048
    tokens (remat "full", AdamW/WSD) under ``use_mesh`` of the (1, 1)
    mesh, on the FSDP + tensor-parallel code path (its gathers and
    collectives at extents of 1), bit for bit equal to three steps
    without a mesh; both timed.
58. (Run after phase 57.) zamba2-2.7B whole at B = 1, max_len 32768:
    the caches filled from seeded draws to 32752
    (tools/serve_torch_sharded.py's ``fill_zamba2``), then 16
    teacher-forced decode steps on the sequence-split cache path
    (`shardings.SeqSplitCaches`: the owned-position writes, the
    whole-batch dispatch; a split of one merges nothing) under the
    (1, 1) mesh, bit for bit equal to the same steps without a mesh,
    both timed; and ``Mesh.reduce_scatter`` of a (4096, 5120) f32
    tensor over the data axis of one rank: its input back, timed, one
    ``mesh/reduce_scatter`` counted per call.

59. (Run after phase 52.) ``repro_torch.analysis`` on the card: every
    registry entry on CUDA tensors (``use_kernel=None``) — the padding
    self-composition of the 17 padding entries, bit for bit, with
    kernels 1 and 2 launched in both runs of each of the 12 that reach
    them (lp_affinity, sep_affinity, pin_count_csr, pin_count on the
    ELL, pin_affinity, kway_lp_round, the three refinement scans, the
    parhyp rounds); the op trace of every entry (host reads per call,
    each allowed one named, no float64; the SSD scan traced for hygiene
    only); the replication check on a world of one; both lints: zero
    findings.  A planted fault (lp_affinity with its padding weights
    unmasked) is flagged ``padding-flows-into-output`` on the card.
60. The dry run (``launch/dryrun.py``: shapes only, on the host) against
    this run: phase 45's minicpm-2B step (B = 2 x 2048, f32, remat
    "full", 2 microbatches) extrapolated from 1 and 2 layers — its
    parameter and optimizer bytes exactly the live model's, its
    predicted peak and FLOPs beside phase 45's ``max_memory_allocated``
    and 8·N·T with their ratios — and gemma2-9B at 2 layers on a (1, 1)
    stand-in, whose collectives per step equal phase 57's ``mesh/*``
    counter deltas on the NCCL (1, 1) mesh.
61. The fused attention kernel (``ops.attention_fwd`` →
    kernels/csrc/attention_fwd.cu) at the benchmark cells' calls:
    minicpm-2B's (24 × 2048, 36 heads of 64) and the hybrid's shared
    block (32 × 2048, 32 heads of 80), causal, on seeded draws: within
    1e-5 of max |out| of the composed path (``models/attention.
    composed``, in batch chunks), timed beside its bound (the causal
    FLOPs at 67 TFLOP/s FFMA against q, k, v and o at 3.35 TB/s), the
    composed path on the whole batch, and PyTorch's
    ``scaled_dot_product_attention`` (``library_ms``, timed only: the
    port never calls it); then minicpm-2B at full width cut to 2 layers,
    B = 2 × 2048: a forward without gradient launches the kernel once per
    layer and takes the composed path nowhere, a forward under grad mode
    with gradients takes it in every layer, and their logits agree within
    1e-4 of max |logits| (each count zeroed just before its forward).  The
    kernels line gives each cell's row the launches of its model's main
    path: phase 13's hybrid forward and phase 35's minicpm forward.

It prints a JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``.  No jax and nothing of the JAX package is imported.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import datetime
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): device memory and f32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12
# (n_pad, dmax, k) of tests/test_kernels.py's sweep, plus k = 16 (inside
# the kernel's register buckets, the main path's k) and k = 33 (just above
# them: the shared-memory histogram)
SWEEP = [(128, 8, 2), (256, 24, 5), (128, 16, 130), (384, 40, 17),
         (256, 8, 16), (256, 16, 33)]
# (vertices, nets, k) of tests/test_hypergraph.py's pin-count sweep, + k=8
PIN_SWEEP = [(100, 150, 2), (300, 500, 5), (64, 90, 130), (200, 260, 8)]
# pin_count's float-mask tolerance: abs + relative to the count (a net
# split across a warp sums its pins in another order)
PIN_FLOAT_TOL = 1e-5
# (BH, L, P, N, chunk) of tests/test_kernels.py::test_ssd_scan_sweep
SSD_SWEEP = [(2, 128, 8, 4, 64), (3, 256, 16, 8, 128), (1, 64, 32, 16, 32),
             (2, 200, 8, 8, 64)]
# heads per row of B and C in phase 12's grouped form
SSD_HEADS = (1, 3)
# (n_pad, dmax) of SWEEP's shapes below k = 130, at the separator's k = 3
SEP_SWEEP = [(128, 8), (256, 24), (384, 40), (256, 16)]
# grid sides of phases 18-22: the separator main path (1,048,576
# vertices), the ordering (cut to 4096 vertices: its recursion makes one
# host-bound separator call per ~50 vertices, and 128 x 128 took 104 s on
# an H100 80GB HBM3, 700.00 W) and the edge partition (a SPAC graph of
# 261,120 vertices)
SEP_GRID, ND_GRID, EP_GRID = 1024, 64, 256
# phases 23-28: the memetic main path (262,144 vertices, the size class of
# the Walshaw archive graphs KaFFPaE was evaluated on), its comparison with
# the plain path (cut to 65,536 vertices: the new phases took 142 s at 512
# x 512 on an H100 80GB HBM3, 700.00 W, against a budget of ~90 s), KaBaPE,
# the memetic separator, the process mapping and the ILP model's graph
MEM_GRID, PLAIN_GRID, KABAPE_GRID, MSEP_GRID = 512, 256, 256, 256
MAP_GRID, ILP_GRID = 512, 64
# islands x members x generations of every memetic phase
MEM_ISLANDS, MEM_POP, MEM_GENS = 2, 2, 2
# phases 35-39: the attention decoder families at their published widths,
# f32 weights from seed 0.  llama4-scout (109B parameters) and deepseek-v2
# (236B) do not fit one 80 GB card: their depth is cut to 2 layers.  The
# parameter counts follow the reference pytree's shapes.
DEC_DEPTH = {"minicpm_2b": None, "llama4_scout_17b_a16e": 2,
             "deepseek_v2_236b": 2, "rwkv6_7b": None, "whisper_medium": None}
DEC_PARAMS = {"minicpm_2b": 2_725_173_504,
              "llama4_scout_17b_a16e": 6_475_146_240,
              "deepseek_v2_236b": 8_992_814_080,
              "rwkv6_7b": 7_266_111_488, "whisper_medium": 959_571_968}
# (B, L) of each model's full-sequence forward; whisper's 448 tokens are
# its decoder context, beside the encoder's 1500 frames of 30 s of audio
# (arXiv:2212.04356)
DEC_FWD = {"minicpm_2b": (2, 2048), "llama4_scout_17b_a16e": (1, 2048),
           "deepseek_v2_236b": (1, 1024), "rwkv6_7b": (2, 2048),
           "whisper_medium": (2, 448)}
# phase 40: rwkv6's layer-0 time mix alone at these lengths (B = 1)
TMIX_L = (2048, 8192, 32768)
# phase 44: whisper's prompts, one per row, each with its own frames
WHISPER_PROMPTS = (4, 8)
# phase 35's online-against-dense attention check: one prompt of this length
ONLINE_L = 4096
# phase 36: two prompts in separate slots, then batched decode steps
DEC_PROMPTS, DEC_STEPS = (64, 48), 16
# phases 45-48: training.  Phase 45: minicpm-2B whole, global batch x
# sequence (the batches' seq_len), in microbatches, a warm-up step, timed
# steps, then steps on one fixed batch at a constant rate
TRAIN_FWD, TRAIN_MB, TRAIN_TIMED = (2, 2048), 2, 3
FIXED_STEPS, FIXED_LR = 4, 3e-4
# phase 46: the equivalences at full width, 2 layers deep
EQ_DEPTH, EQ_FWD = 2, (2, 512)
# phase 47: the hybrid (one group of 6 Mamba layers + the shared block) and
# ssm families at full width, cut in depth, B x L
TRAIN_DEPTH = {"zamba2_2p7b": 6, "rwkv6_7b": 2}
TRAIN_CUT_FWD = (1, 2048)
# phase 48: pipeline stages of the deepest dense config
PIPE_ARCH, PIPE_STAGES = "mistral_large_123b", 8
# phase 54: the SSD scan at zamba2's per-rank shape on (data 1, model 4):
# B x L, and 80 SSM heads over 4 ranks sharing each row of B and C
SSD_RANK_FWD, SSD_RANK_HEADS = (2, 2048), 20
# phase 55: the four families PR 22's (1, 1) check left out, each a
# forward at B = 1 (whisper on its 1500 frames), a prompt and decode steps
MESH_FAMILIES = {"zamba2_2p7b": None, "rwkv6_7b": None,
                 "whisper_medium": None, "deepseek_v2_236b": 2}
MESH_FWD = {"zamba2_2p7b": 2048, "rwkv6_7b": 2048, "whisper_medium": 448,
            "deepseek_v2_236b": 1024}
MESH_PROMPT, MESH_STEPS = 16, 4
# phases 57-58: gemma2's tokens per train step, zamba2's max_len and steps
DATA_TRAIN_SEQ, DATA_CP_LEN, DATA_CP_STEPS = 2048, 32768, 16


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: int, adds: int):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the additions over
    the f32 rate, and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, adds / PEAK_F32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def affinity_inputs(torch, dev, n_pad, dmax, k, b, integer, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    nbr = torch.randint(0, n_pad, (n_pad, dmax), generator=g, device=dev,
                        dtype=torch.int32)
    live = torch.rand((n_pad, dmax), generator=g, device=dev) > 0.3
    w = (torch.randint(1, 10, (n_pad, dmax), generator=g, device=dev).float()
         if integer else torch.rand((n_pad, dmax), generator=g, device=dev))
    labels = torch.randint(0, k, (b, n_pad), generator=g, device=dev,
                           dtype=torch.int32)
    return nbr, (w * live).contiguous(), labels


def compare(torch, nbr, wgt, labels, k, integer) -> float:
    """Kernel vs plain version on the same inputs; returns max |diff|."""
    from repro_torch.kernels import lp_affinity, ref
    got = lp_affinity.affinity_cuda(nbr, wgt, labels, k)
    want = ref.affinity_ref(nbr, wgt, labels, k)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"shape {tuple(got.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    tol = 0.0 if integer else 1e-5
    check(err <= tol, f"lp_affinity disagrees with affinity_ref at "
          f"{tuple(labels.shape)}x{tuple(nbr.shape)} k={k}: {err} > {tol}")
    return err


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def span_seconds(rec, names) -> dict:
    """Host-clock seconds of the named spans, summed per name."""
    open_ts, total = {}, {n: 0.0 for n in names}
    for ev in rec.events:
        if ev.get("name") not in total:
            continue
        key = (ev["name"], ev["tid"], ev.get("depth"))
        if ev["ph"] == "B":
            open_ts[key] = ev["ts"]
        elif ev["ph"] == "E" and key in open_ts:
            total[ev["name"]] += (ev["ts"] - open_ts.pop(key)) / 1e6
    return total


def run_kaffpa(torch, g, k, mode, seed, dev, use_kernel=None):
    """One kaffpa run with the launch count zeroed just before and read
    just after.  ``use_kernel=None`` goes through the C-API entry point a
    user calls; ``False`` runs the same engine with the plain path."""
    from repro_torch import obs
    from repro_torch.core import interface, kaffpa as K, multilevel as ML
    from repro_torch.core.partition import edge_cut
    from repro_torch.kernels.lp_affinity import LAUNCHES
    rec = obs.Recorder("kaffpa")
    torch.cuda.synchronize()
    obs.metrics.reset(LAUNCHES)
    t0 = time.perf_counter()
    if use_kernel is None:
        cut, part = interface.kaffpa(g.n, None, g.xadj, None, g.adjncy, k,
                                     0.03, seed=seed, mode=mode,
                                     report=rec, device=dev)
    else:
        cfg = dataclasses.replace(K.PRESETS[interface._MODE_NAMES[mode]],
                                  use_kernel=use_kernel)
        part = ML.run(K.GraphMedium(g, cfg, recorder=rec, device=dev), k,
                      0.03, seed)
        cut = edge_cut(g, part)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = int(obs.metrics.get(LAUNCHES))
    return cut, part, wall, launches, rec


def pin_inputs(torch, dev, n, m, k, b, integer, seed):
    """A random hypergraph's ELL-H view on the card, with 0/1 masks or
    (``integer=False``) float masks on the real slots, and B label rows."""
    from repro_torch.core.hypergraph.container import to_ell_h
    from repro_torch.io.generators import random_hypergraph
    ell = to_ell_h(random_hypergraph(n, m, seed=n + k, wmax=4), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = ell.pin_mask
    if not integer:
        mask = (mask * torch.rand(mask.shape, generator=g,
                                  device=dev)).contiguous()
    labels = torch.randint(0, k, (b, ell.n_pad), generator=g, device=dev,
                           dtype=torch.int32)
    return ell.pins, mask, ell.netw, labels


def compare_pins(torch, pins, mask, netw, labels, k, integer) -> float:
    """pin_count's ELL entry vs its plain version on the same inputs;
    returns max |diff| over both outputs."""
    from repro_torch.kernels import pin_affinity, ref
    got = pin_affinity.pin_count_cuda(pins, mask, netw, labels, k)
    want = ref.pin_count_ref(pins, mask, netw, labels, k)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"shape {tuple(g.shape)}")
        err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
    tol = 0.0 if integer else PIN_FLOAT_TOL
    check(err <= tol, f"pin_count disagrees with pin_count_ref at "
          f"{tuple(labels.shape)}x{tuple(pins.shape)} k={k}: {err} > {tol}")
    return err


def skewed_hypergraph(np):
    """2000 nets of 1-47 pins and one of 4100 on 20,000 vertices: nets above
    32 pins, and the long one above all, are split across a warp."""
    from repro_torch.core.hypergraph.container import Hypergraph
    rng = np.random.default_rng(5)
    nets = [rng.choice(20000, int(s), replace=False)
            for s in rng.integers(1, 48, 2000)]
    nets.insert(1000, rng.choice(20000, 4100, replace=False))
    return Hypergraph.from_nets(20000, nets)


def csr_inputs(torch, hc, k, b, integer, seed):
    """Pin weights on ``hc``'s real pins (0/1 with some zeros inside nets,
    or floats) and B label rows, on hc's device."""
    g = torch.Generator(device=hc.device).manual_seed(seed)
    p = int(hc.eptr[-1])
    w = torch.rand(p, generator=g, device=hc.device)
    mask = hc.mask.clone()
    mask[:p] = (w > 0.1).float() if integer else w
    labels = torch.randint(0, k, (b, hc.n_pad), generator=g,
                           device=hc.device, dtype=torch.int32)
    return mask, labels


def compare_csr(torch, hc, mask, labels, k, integer) -> float:
    """pin_count's CSR entry vs its plain version on the same inputs;
    returns max |diff|.  0/1 masks must agree exactly; float masks within
    PIN_FLOAT_TOL abs + relative."""
    from repro_torch.kernels import pin_affinity, ref
    got = pin_affinity.pin_count_csr_cuda(hc.eptr, hc.pv, mask, labels, k)
    want = ref.pin_count_csr_ref(hc.eptr, hc.pv, mask, labels, k)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"shape {tuple(got.shape)}")
    diff = (got - want).abs()
    err = float(diff.max()) if got.numel() else 0.0
    excess = (float((diff - PIN_FLOAT_TOL * want.abs()).max())
              if got.numel() else 0.0)
    ok = err == 0.0 if integer else excess <= PIN_FLOAT_TOL
    check(ok, f"pin_count_csr disagrees with pin_count_csr_ref at "
          f"{tuple(labels.shape)} e_pad={hc.e_pad} k={k}: max |err| {err}")
    return err


def run_kahypar(torch, hg, k, mode, objective, seed, dev, use_kernel=None):
    """One kahypar run with the pin-count launch count zeroed just before
    and read just after.  ``use_kernel=None`` goes through the C-API entry
    point a user calls; ``False`` runs the same engine on the plain path."""
    from repro_torch import obs
    from repro_torch.core import interface, multilevel as ML
    from repro_torch.core.hypergraph import driver as D
    from repro_torch.core.hypergraph.metrics import connectivity, cut_net
    from repro_torch.kernels.pin_affinity import LAUNCHES
    rec = obs.Recorder("kahypar")
    torch.cuda.synchronize()
    obs.metrics.reset(LAUNCHES)
    t0 = time.perf_counter()
    if use_kernel is None:
        obj, part = interface.kahypar(hg.n, hg.m, None, None, hg.eptr,
                                      hg.eind, k, 0.03, seed=seed, mode=mode,
                                      objective=objective, report=rec,
                                      device=dev)
    else:
        cfg = dataclasses.replace(D.PRESETS[interface._MODE_NAMES[mode]],
                                  use_kernel=use_kernel)
        part = ML.run(D.HypergraphMedium(hg, cfg, objective, recorder=rec,
                                         device=dev), k, 0.03, seed)
        obj = (connectivity if objective == "km1" else cut_net)(hg, part)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = int(obs.metrics.get(LAUNCHES))
    return obj, part, wall, launches, rec


def kahypar_phases(torch, np, dev, card) -> tuple:
    """Phases 7-11; returns the pin_count row of the kernels line (the
    CSR entry, the main path's call) and the main path's km1."""
    from repro_torch.core import interface
    from repro_torch.core import hypergraph as H
    from repro_torch.core.hypergraph import container as HC
    from repro_torch.core.hypergraph import metrics as M
    from repro_torch.core.hypergraph.initial import random_partition
    from repro_torch.core.hypergraph.metrics import (balance, connectivity,
                                                     cut_net, is_feasible)
    from repro_torch.core.hypergraph.refine import k_bucket
    from repro_torch.io.generators import random_hypergraph, rmat_hypergraph
    from repro_torch.kernels import pin_affinity, ref

    # -- 7. both entries vs their plain versions at the sweep shapes --------
    csr_err = ell_err = 0.0
    cases = [(random_hypergraph(n, m, seed=n + k, wmax=4), k)
             for (n, m, k) in PIN_SWEEP]
    cases.append((skewed_hypergraph(np), 8))
    for i, (hg, k) in enumerate(cases):
        hc = HC.to_pincoo(hg, device=dev)
        for b in (1, 4):
            for integer in (True, False):
                mask, labels = csr_inputs(torch, hc, k, b, integer,
                                          seed=100 * i + 10 * b + integer)
                csr_err = max(csr_err, compare_csr(torch, hc, mask, labels,
                                                   k, integer))
    for (n, m, k) in PIN_SWEEP:
        for b in (1, 4):
            for integer in (True, False):
                ins = pin_inputs(torch, dev, n, m, k, b, integer,
                                 seed=n + m + k + b)
                ell_err = max(ell_err, compare_pins(torch, *ins, k, integer))
    # the ELL entry on the skewed hypergraph: pmax 8192, every row split
    # across its warp; 0/1 masks, exact
    ell = HC.to_ell_h(cases[-1][0], device=dev)
    for b in (1, 4):
        labels = torch.randint(0, 8, (b, ell.n_pad), device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(b), dtype=torch.int32)
        ell_err = max(ell_err, compare_pins(torch, ell.pins, ell.pin_mask,
                                            ell.netw, labels, 8, True))
    log(f"sweep: pin_count_csr == pin_count_csr_ref at {len(PIN_SWEEP)} "
        f"shapes + a net of 4100 pins x B=1,4 x 0/1 (exact) and float masks "
        f"(max |err| {csr_err:g}); pin_count (ELL) == pin_count_ref at "
        f"{len(PIN_SWEEP)} shapes x B=1,4 x 0/1 and float masks and on the "
        f"4100-pin net's {tuple(ell.pins.shape)} ELL (max |err| "
        f"{ell_err:g})")

    # -- 8. the kahypar main path at real size ----------------------------
    k_main = 8
    hg = rmat_hypergraph(17, seed=1)
    log(f"hypergraph rmat_hypergraph(17, seed=1): n={hg.n} m={hg.m} "
        f"pins={hg.pins} max_net={int(hg.net_sizes().max())} "
        f"max_degree={int(hg.vertex_degrees().max())}")
    ell_builds = []
    real_to_ell_h = HC.to_ell_h

    def counted_to_ell_h(*args, **kwargs):
        ell_builds.append(1)
        return real_to_ell_h(*args, **kwargs)

    HC.to_ell_h = H.to_ell_h = counted_to_ell_h
    try:
        km1, part, wall, launches, rec = run_kahypar(
            torch, hg, k_main, interface.ECO, "km1", 1, dev)
    finally:
        HC.to_ell_h = H.to_ell_h = real_to_ell_h
    feas = is_feasible(hg, part, k_main, 0.03)
    ctr = rec.counters()
    spans = span_seconds(rec, ("hierarchy", "initial_tournament",
                               "uncoarsen"))
    rnd = random_partition(hg, k_main, seed=0)
    log(f"main path kahypar ECO km1 k={k_main}: km1={km1} (random "
        f"partition {connectivity(hg, rnd)}) "
        f"balance={balance(hg, part, k_main):.4f} feasible={feas} "
        f"wall_s={wall:.3f} levels={int(ctr.get('engine/levels', 0))} "
        f"launches={launches} to_ell_h calls={len(ell_builds)} view_builds="
        f"{int(ctr.get('engine/view_builds', 0))} spans_s="
        f"{json.dumps({n: round(s, 3) for n, s in spans.items()})}")
    check(feas, "kahypar main path partition infeasible")
    check(launches > 0, "kahypar main path never launched pin_count")
    check(not ell_builds, "the kahypar kernel path built an ELL-H view")
    main_launches = launches

    # -- 9. the same run on the plain path ---------------------------------
    km1_2, part2, wall2, launches2, _ = run_kahypar(
        torch, hg, k_main, interface.ECO, "km1", 1, dev, use_kernel=False)
    log(f"plain path kahypar ECO km1 k={k_main}: km1={km1_2} "
        f"wall_s={wall2:.3f} launches={launches2}")
    check(launches2 == 0, "use_kernel=False launched pin_count")
    check(np.array_equal(part, part2),
          "kahypar kernel path and plain path partitions differ")

    # -- 10. the cut-net objective -----------------------------------------
    hg14 = rmat_hypergraph(14, seed=2)
    cut, part3, wall3, launches3, _ = run_kahypar(
        torch, hg14, 4, interface.ECO, "cut", 1, dev)
    rnd_cut = cut_net(hg14, random_partition(hg14, 4, seed=0))
    feas3 = is_feasible(hg14, part3, 4, 0.03)
    log(f"cut path kahypar ECO cut rmat_hypergraph(14, seed=2) k=4: "
        f"cut={cut} (random partition {rnd_cut}) "
        f"balance={balance(hg14, part3, 4):.4f} feasible={feas3} "
        f"wall_s={wall3:.3f} launches={launches3}")
    check(feas3, "cut-objective partition infeasible")
    check(launches3 > 0, "cut-objective run never launched pin_count")
    check(cut < rnd_cut, "cut objective not below a random partition's")

    # -- 11. the kernel at the main path's level-0 shape ------------------
    hc = HC.to_pincoo(hg, device=dev)
    k_pad = k_bucket(k_main)
    lab1 = torch.zeros(1, hc.n_pad, dtype=torch.int32, device=dev)
    lab1[0, :hg.n] = torch.from_numpy(part.astype(np.int32)).to(dev)

    def level0_labels(b):
        labels = lab1.expand(b, -1).contiguous()
        if b > 1:      # other rows: other candidate partitions
            gen = torch.Generator(device=dev).manual_seed(b)
            labels[1:] = torch.randint(0, k_main, (b - 1, hc.n_pad),
                                       generator=gen, device=dev,
                                       dtype=torch.int32)
        return labels

    p = int(hc.eptr[-1])
    rows_out = {}
    for b in (1, 4):
        labels = level0_labels(b)
        csr_err = max(csr_err, compare_csr(torch, hc, hc.mask, labels, k_pad,
                                           True))
        fmask, _ = csr_inputs(torch, hc, k_pad, b, False, seed=7 + b)
        csr_err = max(csr_err, compare_csr(torch, hc, fmask, labels, k_pad,
                                           False))
        check(torch.equal(M.pin_counts_device(hc, labels, k_pad),
                          pin_affinity.pin_count_csr_cuda(
                              hc.eptr, hc.pv, hc.mask, labels, k_pad)),
              "scatter_add_ yardstick disagrees with the CSR kernel")
        def kernel():
            return pin_affinity.pin_count_csr_cuda(hc.eptr, hc.pv, hc.mask,
                                                   labels, k_pad)

        ms = launch_ms(torch, kernel, {"pin_count_kernel": 1},
                       calls=20)["pin_count_kernel"]
        call_ms = cuda_ms(torch, kernel)
        plain_ms = cuda_ms(torch, lambda: ref.pin_count_csr_ref(
            hc.eptr, hc.pv, hc.mask, labels, k_pad), iters=5)
        library_ms = cuda_ms(torch, lambda: M.pin_counts_device(
            hc, labels, k_pad), iters=5)
        # what the function must move: the real pins' masks (each is a
        # weight), the ids of those with a live mask, the offsets, the
        # labels and cnt
        live = int((hc.mask[:p] != 0).sum())
        nbytes = (p * 4 + live * 4 + hc.eptr.numel() * 4 + labels.numel() * 4
                  + b * hc.e_pad * k_pad * 4)
        bms, by = bound_ms(nbytes, b * live)
        rows_out[b] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bms, bound_by=by)
        log(f"pin_count_csr B={b} e_pad={hc.e_pad} pins={p} k={k_pad} "
            f"n_pad={hc.n_pad}: kernel {ms:.4f} ms per launch "
            f"(torch.profiler; {call_ms:.4f} ms per wrapper call back to "
            f"back), plain {plain_ms:.4f} ms, "
            f"scatter_add_ (M.pin_counts_device) {library_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({nbytes} bytes at {PEAK_BYTES_PER_S / 1e12} "
            f"TB/s) [{card}]")

    # the ELL entry on the level's ELL-H view: what the kernel path no
    # longer builds (its host seconds), and the redesigned body's time on it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ell = HC.to_ell_h(hg, device=dev)
    torch.cuda.synchronize()
    log(f"to_ell_h at level 0 (the view the kernel path no longer builds): "
        f"{time.perf_counter() - t0:.4f} s host [{card}]")
    e_pad, pmax = ell.pins.shape
    for b in (1, 4):
        labels = level0_labels(b)
        ell_err = max(ell_err, compare_pins(torch, ell.pins, ell.pin_mask,
                                            ell.netw, labels, k_pad, True))
        fmask = (ell.pin_mask * torch.rand(
            ell.pin_mask.shape, device=dev,
            generator=torch.Generator(device=dev).manual_seed(7 + b))
                 ).contiguous()
        ell_err = max(ell_err, compare_pins(torch, ell.pins, fmask, ell.netw,
                                            labels, k_pad, False))
        pins_l = ell.pins.long()

        def library():
            return torch.zeros(b, e_pad, k_pad, device=dev).scatter_add_(
                2, labels.long()[:, pins_l], ell.pin_mask.expand(b, -1, -1))

        check(torch.equal(library(), pin_affinity.pin_count_cuda(
            ell.pins, ell.pin_mask, ell.netw, labels, k_pad)[0]),
              "scatter_add_ yardstick disagrees with the ELL entry")
        def kernel():
            return pin_affinity.pin_count_cuda(ell.pins, ell.pin_mask,
                                               ell.netw, labels, k_pad)

        ms = launch_ms(torch, kernel, {"pin_count_kernel": 1},
                       calls=20)["pin_count_kernel"]
        call_ms = cuda_ms(torch, kernel)
        plain_ms = cuda_ms(torch, lambda: ref.pin_count_ref(
            ell.pins, ell.pin_mask, ell.netw, labels, k_pad), iters=5)
        library_ms = cuda_ms(torch, library, iters=5)
        # the whole mask (it marks the live slots), the pin ids of live
        # slots only, netw of nets with a live pin, the labels, both outputs
        live = ell.pin_mask != 0
        nbytes = (ell.pin_mask.numel() * 4 + int(live.sum()) * 4
                  + int(live.any(1).sum()) * 4 + labels.numel() * 4
                  + 2 * b * e_pad * k_pad * 4)
        bms, by = bound_ms(nbytes, b * int(live.sum()))
        log(f"pin_count (ELL entry) B={b} e_pad={e_pad} pmax={pmax} "
            f"k={k_pad} n_pad={ell.n_pad}: kernel {ms:.4f} ms per launch "
            f"(torch.profiler; {call_ms:.4f} ms per wrapper call), plain "
            f"{plain_ms:.4f} ms, scatter_add_ {library_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({nbytes} bytes at {PEAK_BYTES_PER_S / 1e12} "
            f"TB/s); max |err| {ell_err:g} [{card}]")
    main = rows_out[1]    # level-0 refinement launches one row
    return {"name": "pin_count", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/pin_count.cu",
            "replaces": "src/repro/kernels/pin_affinity.py:33",
            "launches": main_launches, "max_abs_err": csr_err,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "call_ms": main["call_ms"],
            "shape": [1, hc.e_pad, p, k_pad, hc.n_pad]}, km1


def ssd_sweep_inputs(np, bh, l, p, n):
    """tests/test_kernels.py::test_ssd_scan_sweep's inputs, drawn as it
    draws them (numpy arrays)."""
    rng = np.random.default_rng(bh * l + p)
    x = rng.standard_normal((bh, l, p)).astype(np.float32)
    ld = (-0.05 - 0.5 * rng.random((bh, l))).astype(np.float32)
    b = (rng.standard_normal((bh, l, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bh, l, n)) * 0.3).astype(np.float32)
    return x, ld, b, c


def ssd_grouped_inputs(np, g, heads, l, p, n):
    """The sweep's inputs in the grouped form: x and log-decay for g *
    heads rows, B and C for g groups (numpy arrays)."""
    rng = np.random.default_rng(g * heads * l + p)
    x = rng.standard_normal((g * heads, l, p)).astype(np.float32)
    ld = (-0.05 - 0.5 * rng.random((g * heads, l))).astype(np.float32)
    b = (rng.standard_normal((g, l, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((g, l, n)) * 0.3).astype(np.float32)
    return x, ld, b, c


def ssd_excess(got, want) -> float:
    """max(|got − want| − 3e-4 |want|): at most 3e-4 passes the sweep's
    abs + rel tolerance."""
    return float(((got - want).abs() - 3e-4 * want.abs()).max())


def ssd_bound(bh, l, p, n, q, groups):
    """(ms, by, readings) for the SSD scan at one shape: the bytes (x, y,
    log-decay, and B and C per group) against the operations the kernel
    does, the chunked form's FLOP over the causal half at the 3xTF32 rate
    (three TF32 products each): C·Bᵀ once per (group, chunk), G·X, the
    chunk states and the off-diagonal term per row.  ``readings`` (for the
    log line only: worked out from peak rates, not measured) also holds the
    exact recurrence's FLOP at f32 and the chunked form's at plain TF32."""
    tri = q * (q + 1) // 2
    nbytes = 4 * (2 * bh * l * p + bh * l + 2 * groups * l * n)
    chunked = (groups * (l // q) * 2 * tri * n
               + bh * (l // q) * (2 * tri * p + 4 * q * n * p))
    recurrence = bh * l * 5 * n * p
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 3 * chunked / PEAK_TF32_PER_S
    readings = {"bytes": nbytes, "bytes_ms": t_bytes * 1e3,
                "chunked_flop": chunked,
                "chunked_3xtf32_ms": t_ops * 1e3,
                "chunked_tf32_ms": chunked / PEAK_TF32_PER_S * 1e3,
                "recurrence_flop": recurrence,
                "recurrence_f32_ms": recurrence / PEAK_F32_PER_S * 1e3}
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", readings)


def launch_ms(torch, call, per_call, calls=10) -> dict:
    """Mean device ms per launch of each kernel named in ``per_call`` (name
    → its launches per call) over ``calls`` calls, as torch.profiler saw
    them.  The profiler traces one round of calls as a warm-up and reads
    the next; a trace that does not hold exactly ``calls`` × that many
    launches of every name is taken again, and after 5 such traces the
    check fails."""
    from torch.profiler import ProfilerActivity, profile, schedule
    call()
    torch.cuda.synchronize()
    want = {name: calls * n for name, n in per_call.items()}
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    call()
                torch.cuda.synchronize()
                prof.step()
        seen = {name: [0, 0.0] for name in per_call}
        for ev in prof.key_averages():
            for name in per_call:
                if name in ev.key:
                    seen[name][0] += ev.count
                    seen[name][1] += ev.device_time_total
        got = {name: c for name, (c, _) in seen.items()}
        if got == want:
            break
    check(got == want, f"torch.profiler recorded {got} launches, not "
          f"{want}, in 5 traces of {calls} calls")
    return {name: t / c / 1e3 for name, (c, t) in seen.items()}


#: the benchmark cells' attention calls: (batch, length, heads, head size)
ATTN_SHAPES = {"minicpm-2b": (24, 2048, 36, 64),
               "hybrid-mamba2-2.3b": (32, 2048, 32, 80)}


def attention_bound(b, l, h, hd) -> tuple:
    """(ms, by, flop, bytes) of one causal self-attention call: 2·hd FLOP
    for the score and 2·hd for the value of each of the L (L + 1) / 2
    query-key pairs per head at the f32 FFMA rate, against q, k, v read
    once and o written once."""
    flop = 4 * hd * b * h * (l * (l + 1) // 2)
    nbytes = 4 * 4 * b * l * h * hd
    t_ops, t_bytes = flop / PEAK_F32_PER_S, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flop, nbytes)


def attention_phase(torch, np, dev, card) -> list:
    """Phase 61; returns the kernels line's row per cell shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    rows = []
    for cell, (b, l, h, hd) in ATTN_SHAPES.items():
        torch.cuda.empty_cache()
        g = torch.Generator(device=dev).manual_seed(b * l + h)
        q, k, v = (torch.randn((b, l, h, hd), generator=g, device=dev)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(hd)

        def kernel():
            return ops.attention_fwd(q, k, v, scale=scale)

        def plain():
            return A.composed(q, k, v, scale=scale)

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, scale=scale).transpose(1, 2)

        got = kernel()
        gap = 0.0
        for lo in range(0, b, 4):
            want = A.composed(q[lo:lo + 4], k[lo:lo + 4], v[lo:lo + 4],
                              scale=scale)
            gap = max(gap, max_rel(torch, got[lo:lo + 4], want)[1])
            del want
        check(gap <= 1e-5, f"attention kernel at {cell}'s shape: "
              f"{gap:.3e} of max |out| from the composed path (> 1e-5)")
        lib_gap = max_rel(torch, library(), got)[1]
        del got
        ms = cuda_ms(torch, kernel, iters=10, warmup=2)
        library_ms = cuda_ms(torch, library, iters=5, warmup=1)
        torch.cuda.empty_cache()
        plain_ms = cuda_ms(torch, plain, iters=3, warmup=1)
        torch.cuda.empty_cache()
        bms, by, flop, nbytes = attention_bound(b, l, h, hd)
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bms, bound_by=by, max_rel_err=gap,
                   library_rel_gap=lib_gap, roofline=bms / ms,
                   tflop_s=flop / ms / 1e9, shape=[b, l, h, hd])
        log(f"attention {cell} B={b} L={l} heads={h}x{hd} causal: kernel "
            f"{ms:.4f} ms ({flop / ms / 1e9:.2f} TFLOP/s, {bms / ms:.2%} "
            f"of its bound {bms:.4f} ms by {by}: {flop} FLOP, {nbytes} B), "
            f"composed {plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{library_ms:.4f} ms (gap {lib_gap:.3e}), max rel err "
            f"{gap:.3e} [{card}]")
        rows.append(row)
        del q, k, v
    # the dispatch on a real forward: minicpm-2B's width, 2 layers
    cfg, model = cut_model(torch, T, "minicpm_2b", 2, dev)
    gen = torch.Generator(device=dev).manual_seed(61)
    tokens = torch.randint(0, cfg.vocab, (2, 2048), generator=gen,
                           device=dev)
    attention_paths()
    with torch.no_grad():
        fused = T.forward(model, cfg, tokens)[0]
    launches, composed = attention_paths(True).values()
    for prm in model.parameters():
        prm.requires_grad_(True)
    attention_paths()
    with torch.enable_grad():
        plain = T.forward(model, cfg, tokens)[0].detach()
    grad_launches, grad_composed = attention_paths(True).values()
    _, gap = max_rel(torch, fused, plain)
    log(f"attention dispatch, {cfg.name} at 2 layers, B=2 L=2048: no grad "
        f"{launches:g} launches, {composed:g} composed; with gradients "
        f"{grad_launches:g} launches, {grad_composed:g} composed; logits "
        f"{gap:.3e} of max |logits| apart [{card}]")
    check(launches == cfg.n_layers and composed == 0,
          "a forward without gradient did not take the kernel in every layer")
    check(grad_launches == 0 and grad_composed == cfg.n_layers,
          "a forward with gradients launched the attention kernel")
    check(gap <= 1e-4, f"kernel and composed forwards {gap:.3e} apart")
    del model, fused, plain
    torch.cuda.empty_cache()
    rows[0]["launches_by_path"] = {"dispatch_2_layers": launches}
    return rows


def max_rel(torch, got, want) -> tuple:
    """(max |got − want|, that over max |want|)."""
    err = float((got - want).abs().max())
    return err, err / float(want.abs().max())


def step_spans(rec) -> dict:
    """Count and host-clock seconds of the serve step spans: the
    ``serve/prefill_step`` spans (one per request, its prompt run token by
    token) under "prefill", the ``serve/decode_step`` spans keyed by the
    batch rows of the step."""
    out, open_ts = {}, {}
    for ev in rec.events:
        name = ev.get("name")
        if name not in ("serve/prefill_step", "serve/decode_step"):
            continue
        if ev["ph"] == "B":
            key = ("prefill" if name == "serve/prefill_step"
                   else str(ev["args"]["batch"]))
            open_ts[ev["tid"]] = (ev["ts"], key)
        elif ev["ph"] == "E":
            ts, key = open_ts.pop(ev["tid"])
            n, secs = out.get(key, (0, 0.0))
            out[key] = (n + 1, round(secs + (ev["ts"] - ts) / 1e6, 4))
    return out


def attention_paths(count=None) -> dict:
    """Zero the fused attention kernel's launch count and the composed
    attention's call count (``count=None``), or read them both
    (``count=True``) as {"launches", "composed"}."""
    from repro_torch import obs
    from repro_torch.kernels.attention import LAUNCHES
    from repro_torch.models.attention import COMPOSED
    names = {"launches": LAUNCHES, "composed": COMPOSED}
    if count is None:
        for name in names.values():
            obs.metrics.reset(name)
        return {}
    return {k: int(obs.metrics.get(v)) for k, v in names.items()}


def run_forward(torch, T, model, cfg, tokens, engine):
    """One full-sequence forward with the SSD launch count and the
    attention counts zeroed just before and read just after; returns
    (logits, wall s, SSD launches, ``attention_paths``)."""
    from repro_torch import obs
    from repro_torch.kernels.ssd_scan import LAUNCHES
    torch.cuda.synchronize()
    obs.metrics.reset(LAUNCHES)
    attention_paths()
    t0 = time.perf_counter()
    logits, _ = T.forward(model, cfg, tokens, engine=engine)
    torch.cuda.synchronize()
    return (logits, time.perf_counter() - t0,
            int(obs.metrics.get(LAUNCHES)), attention_paths(True))


def ssd_rank_phase(torch, np, dev, card, p, n, q) -> dict:
    """Phase 54: the grouped scan at zamba2's per-rank shape on (data 1,
    model 4) (`SSD_RANK_FWD`, `SSD_RANK_HEADS` heads per row of B and C,
    head dim ``p``, state ``n``, chunk ``q``) on the sweep's draws, held
    to ``ref.ssd_scan_grouped_ref`` within 3e-4 abs + rel and timed
    beside its bound."""
    from repro_torch.kernels import ops, ref
    (g, l), heads = SSD_RANK_FWD, SSD_RANK_HEADS
    gins = [torch.from_numpy(a).to(dev)
            for a in ssd_grouped_inputs(np, g, heads, l, p, n)]
    got = ops.ssd_scan(*gins, heads=heads)
    want = ref.ssd_scan_grouped_ref(*gins, heads)
    torch.cuda.synchronize()
    excess = ssd_excess(got, want)
    err = float((got - want).abs().max())
    check(got.shape == want.shape and excess <= 3e-4,
          f"ssd_scan at the per-rank shape {tuple(gins[0].shape)} heads="
          f"{heads}: |err| − 3e-4|want| = {excess}")
    ms = cuda_ms(torch, lambda: ops.ssd_scan(*gins, heads=heads))
    plain_ms = cuda_ms(torch, lambda: ref.ssd_scan_grouped_ref(*gins, heads),
                       iters=3, warmup=1)
    bh = g * heads
    bms, by, rd = ssd_bound(bh, l, p, n, q, g)
    log(f"ssd_scan grouped at zamba2's per-rank shape on (1, 4): BH={bh} "
        f"heads={heads} L={l} P={p} N={n} chunk={q}: within 3e-4 of "
        f"ssd_scan_grouped_ref (max |err| {err:g}); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by} "
        f"({rd['bytes']} B at {PEAK_BYTES_PER_S / 1e12} TB/s) [{card}]")
    return {"shape": [bh, l, p, n, q, heads], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "max_abs_err": err}


def zamba2_phases(torch, np, dev, card) -> tuple:
    """Phases 12-16 and 54; returns the ssd_scan rows of the kernels line
    (the per-row form, comparable with earlier runs, and the grouped form
    the main path runs, with phase 54's per-rank shape) and the attention
    counts of phase 13's forward on the kernel path."""
    from repro_torch import obs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ssd_scan import LAUNCHES
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import rmsnorm
    from repro_torch.serve.batching import serve_stream

    # -- 12. kernel vs plain version at the sweep shapes -------------------
    max_err = {"per-row": 0.0, "grouped": 0.0}   # each form's largest |err|
    for (bh, l, p, n, chunk) in SSD_SWEEP:
        ins = [torch.from_numpy(a).to(dev)
               for a in ssd_sweep_inputs(np, bh, l, p, n)]
        got = ops.ssd_scan(*ins, chunk=chunk)
        want = ref.ssd_scan_ref(*ins)
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"ssd_scan shape {tuple(got.shape)}")
        excess = ssd_excess(got, want)
        check(excess <= 3e-4, f"ssd_scan disagrees with ssd_scan_ref at "
              f"{(bh, l, p, n, chunk)}: |err| − 3e-4|want| = {excess}")
        max_err["per-row"] = max(max_err["per-row"],
                                 float((got - want).abs().max()))
        for heads in SSD_HEADS:   # the grouped form: B, C per `heads` rows
            gins = [torch.from_numpy(a).to(dev)
                    for a in ssd_grouped_inputs(np, bh, heads, l, p, n)]
            got = ops.ssd_scan(*gins, chunk=chunk, heads=heads)
            want = ref.ssd_scan_grouped_ref(*gins, heads)
            torch.cuda.synchronize()
            check(got.shape == want.shape,
                  f"grouped ssd_scan shape {tuple(got.shape)}")
            excess = ssd_excess(got, want)
            check(excess <= 3e-4, f"grouped ssd_scan disagrees with "
                  f"ssd_scan_grouped_ref at {(bh, l, p, n, chunk)} heads="
                  f"{heads}: |err| − 3e-4|want| = {excess}")
            max_err["grouped"] = max(max_err["grouped"],
                                     float((got - want).abs().max()))
    log(f"sweep: ssd_scan == ssd_scan_ref at {len(SSD_SWEEP)} shapes, per "
        f"row and grouped (heads {list(SSD_HEADS)}), within 3e-4 abs + rel "
        f"(max |err| per row {max_err['per-row']:g}, grouped "
        f"{max_err['grouped']:g})")

    # -- 13. zamba2-2.7B forward at full width -----------------------------
    cfg = get_config("zamba2_2p7b")
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"zamba2-2.7B: {n_params} f32 parameters made on the card in "
        f"{time.perf_counter() - t0:.3f} s (layers {cfg.n_layers}, d_model "
        f"{cfg.d_model}, vocab_pad {cfg.vocab_pad}, ssm heads "
        f"{cfg.ssm_nheads} x P {cfg.ssm_head_dim}, N {cfg.ssm_state})")
    bsz, seq = 2, 2048
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (bsz, seq), generator=gen,
                           device=dev)
    walls, peaks = {}, {}
    for engine in (None, "chunked"):
        run_forward(torch, T, model, cfg, tokens, engine)     # warm-up
        torch.cuda.reset_peak_memory_stats()
        walls[engine] = run_forward(torch, T, model, cfg, tokens, engine)
        peaks[engine] = torch.cuda.max_memory_allocated()
    logits, wall_k, launches_k, attn_k = walls[None]
    logits_c, wall_c, launches_c, attn_c = walls["chunked"]
    check(logits.shape == (bsz, seq, cfg.vocab_pad),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    err_abs, err_rel = max_rel(torch, logits, logits_c)
    log(f"main path zamba2 forward B={bsz} L={seq}: kernel path wall_s="
        f"{wall_k:.4f} launches={launches_k} (grouped ssd_scan calls); "
        f"chunked path wall_s={wall_c:.4f} launches={launches_c}; logits "
        f"max |err| {err_abs:g} rel {err_rel:g} (max |logits| "
        f"{float(logits.abs().max()):g}); peak memory {peaks[None]} B kernel "
        f"path, {peaks['chunked']} B chunked path [{card}]")
    check(launches_k == cfg.n_layers, f"kernel path launched ssd_scan "
          f"{launches_k} times, expected {cfg.n_layers}")
    check(launches_c == 0, "engine='chunked' launched ssd_scan")
    check(err_rel <= 1e-3, f"kernel and chunked logits differ: {err_rel}")
    shared = cfg.n_layers // cfg.attn_every
    log(f"main path zamba2 forward attention: {attn_k} on the kernel path, "
        f"{attn_c} on the chunked path ({shared} shared-block "
        f"applications) [{card}]")
    for attn in (attn_k, attn_c):
        check(attn == {"launches": shared, "composed": 0},
              f"zamba2 forward attention {attn}, expected the kernel in "
              f"all {shared} shared-block applications")
    del logits_c, walls

    # the kernel on the first Mamba layer's real inputs (the forward's
    # shape), grouped as the main path calls it and per row with B and C
    # expanded to every head, against the exact recurrence
    blk = model.blocks[0]
    nh = cfg.ssm_nheads
    with torch.no_grad():
        x0 = model.embed[tokens] * math.sqrt(cfg.d_model)
        _, _, x_eff, ld, bmat, cmat, _ = M2.scan_inputs(
            blk.mamba, rmsnorm(x0, blk.ln1, cfg.norm_eps), cfg)
        xs, lds, bg, cg = M2.merge_heads(x_eff, ld, bmat, cmat)
    bs, cs = (m[:, None].expand(bsz, nh, seq, m.shape[-1])
              .reshape(bsz * nh, seq, m.shape[-1]).contiguous()
              for m in (bg, cg))
    y_ref = ref.ssd_scan_ref(xs, lds, bs, cs)
    s_min = float(torch.cumsum(lds.reshape(lds.shape[0], -1, 128),
                               -1).min())
    model_rel = {}
    for form, y in (("grouped", ops.ssd_scan(xs, lds, bg, cg, heads=nh)),
                    ("per-row", ops.ssd_scan(xs, lds, bs, cs))):
        torch.cuda.synchronize()
        y_abs, y_rel = max_rel(torch, y, y_ref)
        model_rel[form] = y_rel
        log(f"ssd_scan ({form}) at the forward's shape {tuple(xs.shape)} N="
            f"{bs.shape[-1]}: max |err| {y_abs:g}, rel to max |y| {y_rel:g} "
            f"(in-chunk log-decay cumsum down to {s_min:g})")
        check(y_rel <= 1e-3, f"ssd_scan ({form}) at the forward's shape: "
              f"rel {y_rel}")
        max_err[form] = max(max_err[form], y_abs)

    # -- 14. serving ---------------------------------------------------------
    stream = phase14_stream(np, cfg)
    rec = obs.Recorder("serve")
    torch.cuda.synchronize()
    obs.metrics.reset(LAUNCHES)
    t0 = time.perf_counter()
    with obs.use(rec):
        reqs = serve_stream(model, cfg, stream, batch_slots=4, max_len=256)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_launches = int(obs.metrics.get(LAUNCHES))
    n_new = sum(len(r.out) for r in reqs)
    n_prompt = sum(len(p) for _, p, _ in stream)
    steps = step_spans(rec)
    log(f"serve zamba2 6 requests (prompts {[len(p) for _, p, _ in stream]}"
        f", arrival ticks {[a for a, _, _ in stream]}, 4 slots, max_len "
        f"256): wall_s={serve_wall:.4f} new tokens={n_new} "
        f"({n_new / serve_wall:.2f} tokens/s; with the {n_prompt} prompt "
        f"tokens {(n_new + n_prompt) / serve_wall:.2f} tokens/s) "
        f"ssd_scan launches={serve_launches}; step spans (host clock, "
        f"count and s: prefill, and decode by batch rows): {json.dumps(steps)} [{card}]")
    for r in reqs:
        check(r.done and len(r.out) == 16,
              f"request {r.rid} finished with {len(r.out)} tokens")
        check(all(0 <= t < cfg.vocab_pad for t in r.out),
              f"request {r.rid} produced a token outside the vocabulary")
    check(serve_launches == 0, "decode launched ssd_scan")

    # -- 15. batcher prefill vs the kernel-path forward --------------------
    worst, agree = 0.0, 0
    for r, (_, prompt, _) in zip(reqs, stream):
        full, _ = T.forward(model, cfg, torch.tensor([prompt], device=dev))
        want = full[0, -1]
        _, rel = max_rel(torch, r.logits, want)
        worst = max(worst, rel)
        agree += int(int(r.logits.argmax()) == int(want.argmax()))
    log(f"cross-check: batcher prefill vs kernel-path forward at the "
        f"prompt's last position: worst rel {worst:g}, argmax agrees "
        f"{agree}/{len(reqs)}")
    check(worst <= 2e-3, f"batcher prefill and forward differ: {worst}")

    # -- 16. the kernel timed at the forward's shape, both forms ------------
    bh, l, p = xs.shape
    n, q = bs.shape[-1], 128
    plain_ms = cuda_ms(torch, lambda: ref.ssd_scan_ref(xs, lds, bs, cs),
                       iters=3, warmup=1)
    x4, ld3 = (xs.reshape(bsz, nh, l, p), lds.reshape(bsz, nh, l))
    # the per-row form, comparable with earlier runs, is off the main path:
    # the forward makes only grouped calls
    forms = {
        "per-row": dict(
            name="ssd_scan", groups=bh, launches=0,
            kernel=lambda: ops.ssd_scan(xs, lds, bs, cs),
            chunked=lambda: M2.ssd_chunked(xs, lds, bs, cs),
            chunked_name="ssd_chunked"),
        "grouped": dict(
            name="ssd_scan_grouped", groups=bsz, launches=launches_k,
            kernel=lambda: ops.ssd_scan(xs, lds, bg, cg, heads=nh),
            chunked=lambda: M2.ssd_chunked_grouped(x4, ld3, bg, cg),
            chunked_name="ssd_chunked_grouped"),
    }
    rows = []
    for form, f in forms.items():
        ms = cuda_ms(torch, f["kernel"])
        chunked_ms = cuda_ms(torch, f["chunked"], iters=5)
        bms, by, rd = ssd_bound(bh, l, p, n, q, f["groups"])
        log(f"ssd_scan {form} BH={bh} heads={bh // f['groups']} L={l} P={p} "
            f"N={n} chunk={q}: kernel {ms:.4f} ms (3xTF32), plain "
            f"(sequential recurrence) {plain_ms:.4f}"
            f" ms, {f['chunked_name']} (composed torch ops) {chunked_ms:.4f} "
            f"ms, no single PyTorch call; bound {bms:.4f} ms by {by} "
            f"({rd['bytes']} B: {rd['bytes_ms']:.4f} ms at "
            f"{PEAK_BYTES_PER_S / 1e12} TB/s; the chunked form's "
            f"{rd['chunked_flop']} FLOP as 3xTF32 {rd['chunked_3xtf32_ms']:.4f}"
            f" ms, as plain TF32 {rd['chunked_tf32_ms']:.4f} ms at "
            f"{PEAK_TF32_PER_S / 1e12} TFLOP/s; the recurrence's "
            f"{rd['recurrence_flop']} FLOP at f32 "
            f"{rd['recurrence_f32_ms']:.4f} ms at {PEAK_F32_PER_S / 1e12} "
            f"TFLOP/s) [{card}]")
        per_call = {"ssd_state_kernel": 1, "ssd_pass_kernel": 1,
                    "ssd_out_kernel": 1}
        per_launch = launch_ms(torch, f["kernel"], per_call)
        log(f"ssd_scan {form} device launches per call "
            f"{sum(per_call.values())} (all seen by torch.profiler), device "
            f"ms per launch (torch.profiler, 10 calls): "
            f"{json.dumps(per_launch)} [{card}]")
        rows.append({"name": f["name"], "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "replaces": "src/repro/kernels/ssd_scan.py:27",
                     "launches": f["launches"],
                     "max_abs_err": max_err[form],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": None, "form": form,
                     "main_path": f["launches"] > 0,
                     "chunked_ms": chunked_ms, "rel_err": model_rel[form],
                     "device_launches_per_call": sum(per_call.values()),
                     "launch_ms": per_launch,
                     "shape": [bh, l, p, n, q, bh // f["groups"]]})

    # -- 54. the grouped scan at zamba2's per-rank shape --------------------
    check(cfg.ssm_nheads == 4 * SSD_RANK_HEADS, f"{cfg.ssm_nheads} SSM heads")
    rows[1]["per_rank_shape"] = ssd_rank_phase(torch, np, dev, card, p, n, q)
    err = rows[1]["per_rank_shape"]["max_abs_err"]
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"], err)
    return rows, attn_k


def compare_sep(torch, nbr, wgt, vwgt, labels) -> float:
    """sep_affinity on the card vs the plain version on the same slot
    weights ``ops.sep_weights``; bit for bit (slots are summed in order).
    Returns max |diff| (0)."""
    from repro_torch.kernels import ops, ref
    got = ops.sep_affinity(nbr, wgt, vwgt, labels)
    want = ref.affinity_ref(nbr, ops.sep_weights(nbr, wgt, vwgt), labels, 3)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"sep_affinity shape {tuple(got.shape)}")
    err = float((got - want).abs().max())
    check(err == 0.0, f"sep_affinity disagrees with affinity_ref at "
          f"{tuple(labels.shape)}x{tuple(nbr.shape)}: max |err| {err}")
    return err


def run_nodesep(torch, np, g, seed, dev, use_kernel=None):
    """One 2-way separator run, ε = 0.2, with the counts of lp_affinity
    launches, sep_affinity launches and ``to_ell`` calls zeroed just before
    and read just after.  ``use_kernel=None`` goes through the C-API entry
    point a user calls (its 3-label state read where the program hands it
    to ``split_labels``); ``False`` runs the same engine on the plain path.
    Returns (labels, wall s, counts, recorder)."""
    from repro_torch import obs
    from repro_torch.core import csr, interface
    from repro_torch.core import multilevel as ML
    from repro_torch.core.nodesep import driver as D
    from repro_torch.kernels import ops
    from repro_torch.kernels.lp_affinity import LAUNCHES
    rec = obs.Recorder("nodesep")
    names = {"lp_affinity": LAUNCHES, "sep_affinity": ops.SEP_LAUNCHES,
             "to_ell": csr.TO_ELL_BUILDS}
    torch.cuda.synchronize()
    for name in names.values():
        obs.metrics.reset(name)
    t0 = time.perf_counter()
    if use_kernel is None:
        captured = []
        real = D.nodesep_labels

        def recording(*args, **kwargs):
            captured.append(real(*args, **kwargs))
            return captured[-1]

        D.nodesep_labels = recording
        try:
            num, sep = interface.node_separator(
                g.n, None, g.xadj, None, g.adjncy, 2, 0.2, seed=seed,
                mode=interface.ECO, report=rec, device=dev)
        finally:
            D.nodesep_labels = real
        labels = captured[0]
        check(num == len(sep) and np.array_equal(
            sep, np.flatnonzero(labels == D.SEP)),
              "node_separator's ids are not its labels' separator")
    else:
        cfg = dataclasses.replace(D.PRESETS["eco"], use_kernel=use_kernel)
        labels = ML.run(D.SeparatorMedium(g, cfg, recorder=rec, device=dev),
                        2, 0.2, seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (labels, wall, {k: int(obs.metrics.get(v))
                           for k, v in names.items()}, rec)


def nodesep_phases(torch, np, dev, card) -> tuple:
    """Phases 17-22; returns the sep_affinity row of the kernels line and
    phase 22's replication."""
    from repro_torch import obs
    from repro_torch.core import interface
    from repro_torch.core.csr import to_coo, to_ell
    from repro_torch.core.edgepart import edge_partition, naive_edge_partition
    from repro_torch.core.nodesep import driver as D
    from repro_torch.core.nodesep.refine import (separator_caps,
                                                 separator_is_feasible,
                                                 separator_weight)
    from repro_torch.core.partition import edge_partition_metrics
    from repro_torch.core.separator import verify_separator
    from repro_torch.io.generators import grid2d
    from repro_torch.kernels import lp_affinity, ops, ref
    from repro_torch.kernels.lp_affinity import LAUNCHES

    # -- 17. sep_affinity (kernel 1 at k = 3) vs its plain version ---------
    max_err, cases = 0.0, 0
    for (n_pad, dmax) in SEP_SWEEP:
        for b in (1, 4):
            for integer in (True, False):
                nbr, wgt, labels = affinity_inputs(
                    torch, dev, n_pad, dmax, 3, b, True,
                    seed=n_pad + dmax + b)
                gen = torch.Generator(device=dev).manual_seed(n_pad + b)
                vwgt = (torch.randint(1, 10, (n_pad,), generator=gen,
                                      device=dev).float() if integer
                        else torch.rand(n_pad, generator=gen, device=dev))
                max_err = max(max_err, compare_sep(torch, nbr, wgt, vwgt,
                                                   labels))
                cases += 1
    # n == n_pad: grid2d(16, 16) has 256 vertices in a 256-row view, so
    # the padding slots' id n_pad - 1 is a real vertex of weight > 0
    small = grid2d(16, 16)
    coo = to_coo(small, device=dev)
    ell = to_ell(small, row_tile=coo.n_pad, device=dev)
    check(small.n == ell.n_pad, f"n={small.n} != n_pad={ell.n_pad}")
    for b in (1, 4):
        for integer in (True, False):
            gen = torch.Generator(device=dev).manual_seed(b + 2 * integer)
            vwgt = (torch.randint(1, 10, (ell.n_pad,), generator=gen,
                                  device=dev).float() if integer
                    else torch.rand(ell.n_pad, generator=gen, device=dev))
            labels = torch.randint(0, 3, (b, ell.n_pad), generator=gen,
                                   device=dev, dtype=torch.int32)
            max_err = max(max_err, compare_sep(torch, ell.nbr, ell.wgt, vwgt,
                                               labels))
            cases += 1
    log(f"sweep: sep_affinity == affinity_ref on ops.sep_weights at "
        f"{len(SEP_SWEEP)} shapes + grid2d(16,16) (n == n_pad, padding "
        f"slots aliasing vertex {ell.n_pad - 1}) x B=1,4 x integer and float "
        f"vertex weights: {cases} cases bit for bit (max |err| {max_err:g})")

    # -- 18. the separator main path at real size -------------------------
    g = grid2d(SEP_GRID, SEP_GRID)
    log(f"graph grid2d({SEP_GRID},{SEP_GRID}): n={g.n} m={g.m}")
    labels, wall, counts, rec = run_nodesep(torch, np, g, 1, dev)
    sep = np.flatnonzero(labels == D.SEP)
    part2 = np.where(labels == 1, 1, 0)
    t0 = time.perf_counter()
    verified = verify_separator(g, part2, sep, 2)
    verify_s = time.perf_counter() - t0
    feas = separator_is_feasible(g, labels, 0.2)
    blocks = [int(g.vwgt[labels == b].sum()) for b in (0, 1)]
    levels = int(rec.counters().get("engine/levels", 0))
    spans = span_seconds(rec, ("hierarchy", "initial_tournament",
                               "uncoarsen"))
    log(f"main path node_separator ECO eps=0.2: separator "
        f"{len(sep)} vertices, weight {separator_weight(g, labels)} "
        f"(geometric {SEP_GRID}), blocks {blocks} (cap "
        f"{separator_caps(g, 0.2)[0]:.1f}) feasible={feas} "
        f"verify_separator={verified} ({verify_s:.3f} s) wall_s={wall:.3f} "
        f"levels={levels} launches={json.dumps(counts)} spans_s="
        f"{json.dumps({n: round(s, 3) for n, s in spans.items()})}")
    check(feas, "separator main path infeasible")
    check(verified, "verify_separator failed on the main path")
    check(counts["sep_affinity"] > 0,
          "separator main path never launched sep_affinity")
    check(0 < counts["to_ell"] <= levels, f"{counts['to_ell']} to_ell calls "
          f"for {levels} levels")
    main_launches = counts["sep_affinity"]

    # -- 19. the same run on the plain path --------------------------------
    labels2, wall2, counts2, _ = run_nodesep(torch, np, g, 1, dev,
                                             use_kernel=False)
    log(f"plain path node_separator ECO eps=0.2: separator "
        f"{int((labels2 == D.SEP).sum())} vertices wall_s={wall2:.3f} "
        f"launches={json.dumps(counts2)}")
    check(counts2["lp_affinity"] == 0 and counts2["sep_affinity"] == 0,
          "use_kernel=False launched lp_affinity")
    check(counts2["to_ell"] == 0, "use_kernel=False built an ELL view")
    check(np.array_equal(labels, labels2),
          "separator kernel path and plain path labels differ")

    # -- 20. sep_affinity at the main path's level-0 shape ----------------
    coo = to_coo(g, device=dev)
    ell = to_ell(g, row_tile=coo.n_pad, device=dev)
    vw_nbr = ops.sep_weights(ell.nbr, ell.wgt, ell.vwgt)
    n_pad, dmax = ell.nbr.shape
    lab1 = torch.zeros(1, n_pad, dtype=torch.int32, device=dev)
    lab1[0, :g.n] = torch.from_numpy(labels.astype(np.int32)).to(dev)
    nbr_l = ell.nbr.long()
    live = int((vw_nbr != 0).sum())
    rows_out = {}
    for b in (1, 4):
        lab = lab1.expand(b, -1).contiguous()
        if b > 1:      # other rows: other candidate 3-labellings
            gen = torch.Generator(device=dev).manual_seed(b)
            lab[1:] = torch.randint(0, 3, (b - 1, n_pad), generator=gen,
                                    device=dev, dtype=torch.int32)
        max_err = max(max_err, compare_sep(torch, ell.nbr, ell.wgt, ell.vwgt,
                                           lab))

        def library():
            return torch.zeros(b, n_pad, 3, device=dev).scatter_add_(
                2, lab.long()[:, nbr_l], vw_nbr.expand(b, -1, -1))

        def kernel():
            return ops.sep_affinity(ell.nbr, ell.wgt, ell.vwgt, lab,
                                    vw_nbr=vw_nbr)

        check(torch.equal(library(), kernel()), "scatter_add_ yardstick "
              "disagrees with sep_affinity")
        # as phase 6: the launch sep_affinity makes, then the whole wrapper
        ms = cuda_ms(torch, lambda: lp_affinity.affinity_cuda(
            ell.nbr, vw_nbr, lab, 3))
        call_ms = cuda_ms(torch, kernel)
        plain_ms = cuda_ms(torch, lambda: ref.affinity_ref(
            ell.nbr, vw_nbr, lab, 3), iters=5)
        library_ms = cuda_ms(torch, library, iters=5)
        # the whole weight array (it marks the live slots), the neighbour
        # ids of live slots only, the labels and the (B, n_pad, 3) output
        nbytes = (vw_nbr.numel() * 4 + live * 4 + lab.numel() * 4
                  + b * n_pad * 3 * 4)
        bms, by = bound_ms(nbytes, b * live)
        rows_out[b] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bms, bound_by=by)
        log(f"sep_affinity B={b} n_pad={n_pad} dmax={dmax} k=3 live slots "
            f"{live}: kernel {ms:.4f} ms ({call_ms:.4f} ms per "
            f"ops.sep_affinity call, both back to back), plain "
            f"{plain_ms:.4f} ms, scatter_add_ {library_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({nbytes} bytes at {PEAK_BYTES_PER_S / 1e12} "
            f"TB/s) [{card}]")

    # -- 21. nested-dissection ordering ------------------------------------
    gnd = grid2d(ND_GRID, ND_GRID)
    waves = []
    real_wave = D.nodesep_labels_wave

    def counted_wave(graphs, *args, **kwargs):
        waves.append(len(graphs))
        return real_wave(graphs, *args, **kwargs)

    torch.cuda.synchronize()
    for name in (LAUNCHES, ops.SEP_LAUNCHES):
        obs.metrics.reset(name)
    D.nodesep_labels_wave = counted_wave
    t0 = time.perf_counter()
    try:
        inv = interface.reduced_nd(gnd.n, gnd.xadj, gnd.adjncy, seed=1,
                                   mode=interface.ECO, device=dev)
    finally:
        D.nodesep_labels_wave = real_wave
    torch.cuda.synchronize()
    nd_wall = time.perf_counter() - t0
    nd_launches = {"lp_affinity": int(obs.metrics.get(LAUNCHES)),
                   "sep_affinity": int(obs.metrics.get(ops.SEP_LAUNCHES))}
    log(f"reduced_nd ECO grid2d({ND_GRID},{ND_GRID}) (n={gnd.n}): "
        f"wall_s={nd_wall:.3f} separator subproblems={sum(waves)} in "
        f"{len(waves)} waves {waves} launches={json.dumps(nd_launches)}")
    check(np.array_equal(np.sort(inv), np.arange(gnd.n)),
          "reduced_nd did not return a permutation")
    check(nd_launches["sep_affinity"] > 0,
          "reduced_nd never launched sep_affinity")

    # -- 22. edge partitioning ---------------------------------------------
    gep = grid2d(EP_GRID, EP_GRID)
    torch.cuda.synchronize()
    obs.metrics.reset(LAUNCHES)
    t0 = time.perf_counter()
    epart = edge_partition(gep, 4, preset="eco", seed=1, device=dev)
    torch.cuda.synchronize()
    ep_wall = time.perf_counter() - t0
    ep_launches = int(obs.metrics.get(LAUNCHES))
    metrics = edge_partition_metrics(gep, epart, 4)
    naive = edge_partition_metrics(gep, naive_edge_partition(gep, 4), 4)
    log(f"edge_partition ECO k=4 grid2d({EP_GRID},{EP_GRID}) (m={gep.m}, "
        f"SPAC n={2 * gep.m}): {json.dumps(metrics)} (naive replication "
        f"{naive['replication']:.4f}) wall_s={ep_wall:.3f} "
        f"launches={ep_launches}")
    check(epart.shape == (gep.m,) and int(epart.min()) >= 0
          and int(epart.max()) < 4, "an edge has no block in [0, 4)")
    check(ep_launches > 0, "edge_partition never launched lp_affinity")

    main = rows_out[1]    # the scan launches one row per refine
    return {"name": "sep_affinity", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lp_affinity.cu",
            "replaces": "src/repro/kernels/lp_affinity.py:30",
            "launches": main_launches, "max_abs_err": max_err,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "call_ms": main["call_ms"],
            "shape": [1, n_pad, dmax, 3]}, metrics["replication"]


def memetic_counters(rec) -> dict:
    return {k: int(v) for k, v in sorted(rec.counters().items())
            if k.startswith("memetic/")}


def rounded(spans: dict) -> str:
    return json.dumps({n: round(v, 3) for n, v in spans.items()})


def counting(module, name, ticks):
    """Replace ``module.name`` by a wrapper that appends, per call, the
    number of lp_affinity launches the call made; returns the original."""
    from repro_torch import obs
    from repro_torch.kernels.lp_affinity import LAUNCHES
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        before = obs.metrics.get(LAUNCHES)
        out = real(*args, **kwargs)
        ticks.append(int(obs.metrics.get(LAUNCHES) - before))
        return out

    setattr(module, name, wrapper)
    return real


@contextlib.contextmanager
def capturing(torch, module, name, every: bool = False):
    """Replace the kernel wrapper ``module.name`` while the block runs by
    one that keeps a copy of its inputs (passed by position, as
    ``kernels/ops.py`` passes them) at the first call of each distinct
    shape, or with ``every`` at every call; yields those calls.  The
    wrapper's own launch count is untouched, so the path's count stays
    its own."""
    real = getattr(module, name)
    calls = {}

    def wrapper(*args):
        out = real(*args)
        key = len(calls) if every else tuple(
            tuple(a.shape) if torch.is_tensor(a) else a for a in args)
        if key not in calls:
            calls[key] = tuple(a.clone() if torch.is_tensor(a) else a
                               for a in args)
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def replay_lp(torch, calls, what) -> float:
    """lp_affinity against affinity_ref on the inputs a path gave it, one
    call per distinct shape: bit for bit where the weights are integers,
    else within 1e-5.  Returns max |diff|."""
    err = 0.0
    for nbr, wgt, labels, k in calls.values():
        integer = bool(torch.equal(wgt, wgt.round()))
        err = max(err, compare(torch, nbr, wgt, labels, k, integer))
    shapes = [[*lab.shape, *nbr.shape, k]
              for nbr, _, lab, k in calls.values()]
    log(f"{what}: lp_affinity == affinity_ref on the path's own inputs at "
        f"its {len(calls)} shapes [B, n_pad, n_pad, dmax, k] {shapes} "
        f"(max |err| {err:g})")
    return err


def label_rows(torch, np, part, n_pad, rows, k, dev):
    """(rows, n_pad) int32 labels on the card: row 0 a path's own result,
    the others random k-labellings (the other rows of a sweep)."""
    gen = torch.Generator(device=dev).manual_seed(rows * 1000 + k)
    lab = torch.randint(0, k, (rows, n_pad), generator=gen, device=dev,
                        dtype=torch.int32)
    lab[0] = 0
    lab[0, :len(part)] = torch.from_numpy(
        np.asarray(part, dtype=np.int32)).to(dev)
    return lab


def level0_views(g, dev):
    """(coo, ell): the level-0 views a GraphMedium on the kernel path
    builds for ``g``."""
    from repro_torch.core import kaffpa as K
    cfg = dataclasses.replace(K.PRESETS["eco"], use_kernel=True)
    return K.GraphMedium(g, cfg, device=dev).views


def check_lp_level0(torch, np, g, part, k, dev, what) -> float:
    """lp_affinity against its plain version on ``g``'s level-0 ELL, at
    ``k``, with B = 1 and one row per island; integer weights, so bit for
    bit.  Returns max |diff| (0)."""
    _, ell = level0_views(g, dev)
    err = 0.0
    for b in (1, MEM_ISLANDS):
        lab = label_rows(torch, np, part, ell.nbr.shape[0], b, k, dev)
        err = max(err, compare(torch, ell.nbr, ell.wgt, lab, k, True))
    log(f"{what}: lp_affinity == affinity_ref at level 0 "
        f"{tuple(ell.nbr.shape)} k={k} B=1,{MEM_ISLANDS} (max |err| {err:g})")
    return err


def memetic_phases(torch, np, dev, card) -> dict:
    """Phases 23-28; returns the launches of each path by kernel and,
    under "errors", each kernel's largest difference from its plain
    version at these paths' own level-0 shapes.

    The comparisons run after each path's counts are read, so none of
    their launches is counted as the path's."""
    from repro_torch import obs
    from repro_torch.core import (ilp, interface, kabape, kaffpa as K,
                                  mapping, memetic as MEM)
    from repro_torch.core import hypergraph as H
    from repro_torch.core.hypergraph import container as HC
    from repro_torch.core.nodesep import driver as D
    from repro_torch.core.nodesep.refine import (separator_is_feasible,
                                                 separator_weight)
    from repro_torch.core.partition import (block_weights, edge_cut,
                                            is_feasible)
    from repro_torch.core.separator import verify_separator
    from repro_torch.io.generators import grid2d, rmat_hypergraph
    from repro_torch.kernels import ops, pin_affinity
    from repro_torch.kernels.lp_affinity import LAUNCHES
    mem = dict(n_islands=MEM_ISLANDS, population=MEM_POP,
               generations=MEM_GENS)
    spans = ("population", "generation", "generation_sweep", "migration")
    out = {}

    def zero(*names):
        torch.cuda.synchronize()
        for name in names:
            obs.metrics.reset(name)
        return time.perf_counter()

    def read(t0, name=LAUNCHES):
        torch.cuda.synchronize()
        return time.perf_counter() - t0, int(obs.metrics.get(name))

    # -- 23. the memetic main path: kaffpaE at real size --------------------
    g = grid2d(MEM_GRID, MEM_GRID)
    rec = obs.Recorder("kaffpaE")
    t0 = zero(LAUNCHES)
    cut, part = interface.kaffpaE(g.n, None, g.xadj, None, g.adjncy, 16,
                                  0.03, seed=1, mode=interface.ECO,
                                  report=rec, device=dev, **mem)
    wall, launches = read(t0)
    t0 = time.perf_counter()
    cut1, _ = interface.kaffpa(g.n, None, g.xadj, None, g.adjncy, 16, 0.03,
                               seed=1, mode=interface.ECO, device=dev)
    wall1 = time.perf_counter() - t0
    feas = is_feasible(g, part, 16, 0.03)
    log(f"memetic main path kaffpaE ECO grid2d({MEM_GRID},{MEM_GRID}) k=16 "
        f"{MEM_ISLANDS}x{MEM_POP} generations={MEM_GENS}: cut={cut} "
        f"(kaffpa at its seed {cut1}, {wall1:.3f} s) feasible={feas} "
        f"wall_s={wall:.3f} launches={launches} spans_s="
        f"{rounded(span_seconds(rec, spans))} counters="
        f"{json.dumps(memetic_counters(rec))}")
    check(feas, "kaffpaE partition infeasible")
    check(launches > 0, "kaffpaE never launched lp_affinity")
    check(cut <= cut1, f"kaffpaE cut {cut} above kaffpa's {cut1} at its seed")
    out["kaffpaE"] = launches
    errs = {"lp_affinity": check_lp_level0(torch, np, g, part, 16, dev,
                                           "kaffpaE")}

    # -- 24. kernel path against plain path, on the smaller grid -------------
    gp = grid2d(PLAIN_GRID, PLAIN_GRID)
    t0 = zero(LAUNCHES)
    _, kpart = interface.kaffpaE(gp.n, None, gp.xadj, None, gp.adjncy, 16,
                                 0.03, seed=1, mode=interface.ECO,
                                 device=dev, **mem)
    wall2k, launches2k = read(t0)
    cfg = dataclasses.replace(K.PRESETS["eco"], use_kernel=False)
    t0 = zero(LAUNCHES)
    state = MEM.evolve_islands(
        K.GraphMedium(gp, cfg, device=dev), 16, 0.03,
        MEM.MemeticConfig(time_limit=10.0, **mem), 1)
    wall2, launches2 = read(t0)
    part2 = state.best_part()
    log(f"kaffpaE ECO grid2d({PLAIN_GRID},{PLAIN_GRID}) k=16: kernel path "
        f"cut={edge_cut(gp, kpart)} wall_s={wall2k:.3f} launches="
        f"{launches2k}; plain path cut={edge_cut(gp, part2)} "
        f"wall_s={wall2:.3f} launches={launches2}")
    check(launches2k > 0, "kaffpaE never launched lp_affinity")
    check(launches2 == 0, "the plain memetic path launched lp_affinity")
    check(np.array_equal(kpart, part2),
          "kaffpaE kernel path and plain path partitions differ")

    # -- 25. KaBaPE: strictly balanced ------------------------------------
    gk = grid2d(KABAPE_GRID, KABAPE_GRID)
    cap = int(math.ceil(gk.total_vwgt() / 8))
    ticks = []
    real = counting(kabape, "_gain_matrix", ticks)
    try:
        t0 = zero(LAUNCHES)
        kpart = kabape.kabapeE(gk, 8, eps=0.0, seed=1, device=dev, **mem)
        wall3, launches3 = read(t0)
    finally:
        kabape._gain_matrix = real
    bw = block_weights(gk, kpart, 8)
    log(f"kabapeE grid2d({KABAPE_GRID},{KABAPE_GRID}) k=8 eps=0 "
        f"{MEM_ISLANDS}x{MEM_POP} generations={MEM_GENS}: cut="
        f"{edge_cut(gk, kpart)} blocks max {int(bw.max())} min "
        f"{int(bw.min())} (cap {cap}) wall_s={wall3:.3f} launches="
        f"{launches3} gain_matrix calls={len(ticks)} launches="
        f"{sum(ticks)}")
    check(int(bw.max()) <= cap, f"kabapeE not strictly balanced: a block "
          f"of {int(bw.max())} > {cap}")
    check(launches3 > 0 and sum(ticks) > 0,
          "kabapeE never launched lp_affinity from its gain matrix")
    out["kabapeE"] = launches3
    out["kabape_gain_matrix"] = sum(ticks)
    errs["lp_affinity"] = max(errs["lp_affinity"], check_lp_level0(
        torch, np, gk, kpart, 8, dev, "kabapeE"))
    # the gain matrix's kernel route (ELL through lp_affinity, reduced on
    # the card) against its COO route on the card and its CPU route, on
    # the result, a random partition (many tied gains: the lowest id must
    # win) and one with block 7 empty (its row and column of nodes -1)
    coo, ell = level0_views(gk, dev)
    rng = np.random.default_rng(1)
    for name, p in (("result", kpart),
                    ("random", rng.integers(0, 8, gk.n)),
                    ("block 7 empty", rng.integers(0, 7, gk.n))):
        got = kabape._gain_matrix(gk, p, 8, coo, ell)
        for route, want in (
                ("COO on the card", kabape._gain_matrix(gk, p, 8, coo)),
                ("CPU", kabape._gain_matrix(gk, p, 8, device="cpu"))):
            check(all(np.array_equal(a, b) for a, b in zip(got, want)),
                  f"kabape gain matrix: kernel route differs from the "
                  f"{route} route on the {name} partition")
    log("kabapeE: the gain matrix's kernel route == its COO route on the "
        "card == its CPU route, both arrays, on 3 partitions")

    # -- 26. kahyparE: km1 on a power-law hypergraph ----------------------
    hg = rmat_hypergraph(14, seed=2)
    ell_builds = []
    real_to_ell_h = HC.to_ell_h

    def counted_to_ell_h(*args, **kwargs):
        ell_builds.append(1)
        return real_to_ell_h(*args, **kwargs)

    HC.to_ell_h = H.to_ell_h = counted_to_ell_h
    rec = obs.Recorder("kahyparE")
    try:
        t0 = zero(pin_affinity.LAUNCHES, LAUNCHES)
        km1, hpart = interface.kahyparE(hg.n, hg.m, None, None, hg.eptr,
                                        hg.eind, 4, 0.03, seed=1,
                                        mode=interface.ECO, report=rec,
                                        device=dev, **mem)
        wall4, launches4 = read(t0, pin_affinity.LAUNCHES)
        lp4 = int(obs.metrics.get(LAUNCHES))
    finally:
        HC.to_ell_h = H.to_ell_h = real_to_ell_h
    t0 = time.perf_counter()
    km1_single, _ = interface.kahypar(hg.n, hg.m, None, None, hg.eptr,
                                      hg.eind, 4, 0.03, seed=1,
                                      mode=interface.ECO, device=dev)
    wall4s = time.perf_counter() - t0
    feas = H.is_feasible(hg, hpart, 4, 0.03)
    log(f"kahyparE ECO km1 rmat_hypergraph(14, seed=2) (n={hg.n} "
        f"pins={hg.pins}) k=4 {MEM_ISLANDS}x{MEM_POP} generations="
        f"{MEM_GENS}: km1={km1} (kahypar at its seed {km1_single}, "
        f"{wall4s:.3f} s) feasible={feas} wall_s={wall4:.3f} "
        f"pin_count launches={launches4} lp_affinity launches={lp4} "
        f"to_ell_h calls={len(ell_builds)} spans_s="
        f"{rounded(span_seconds(rec, spans))} counters="
        f"{json.dumps(memetic_counters(rec))}")
    check(feas, "kahyparE partition infeasible")
    check(km1 <= km1_single, f"kahyparE km1 {km1} above kahypar's "
          f"{km1_single} at its seed")
    check(launches4 > 0, "kahyparE never launched pin_count's CSR entry")
    check(not ell_builds, "kahyparE built an ELL-H view")
    out["kahyparE"] = launches4
    out["kahyparE_lp_affinity"] = lp4
    # pin_count's CSR entry on the level-0 pin list the medium builds
    hc = HC.to_pincoo(hg, device=dev)
    errs["pin_count"] = 0.0
    for b in (1, MEM_ISLANDS):
        lab = label_rows(torch, np, hpart, hc.n_pad, b, 4, dev)
        errs["pin_count"] = max(errs["pin_count"], compare_csr(
            torch, hc, hc.mask, lab, 4, integer=True))
    log(f"kahyparE: pin_count_csr == pin_count_csr_ref at level 0 "
        f"e_pad={hc.e_pad} pins={int(hc.eptr[-1])} k=4 B=1,{MEM_ISLANDS} "
        f"(max |err| {errs['pin_count']:g})")

    # -- 27. the memetic separator ------------------------------------------
    gs = grid2d(MSEP_GRID, MSEP_GRID)
    t0 = zero(LAUNCHES, ops.SEP_LAUNCHES)
    sep, part2 = D.memetic_node_separator(gs, 0.2, "eco", seed=1,
                                          device=dev, **mem)
    wall5, launches5 = read(t0, ops.SEP_LAUNCHES)
    lp5 = int(obs.metrics.get(LAUNCHES))
    labels = part2.copy()
    labels[sep] = D.SEP
    t0 = time.perf_counter()
    _, sep1 = interface.node_separator(gs.n, None, gs.xadj, None, gs.adjncy,
                                       2, 0.2, seed=1, mode=interface.ECO,
                                       device=dev)
    wall5s = time.perf_counter() - t0
    weight, weight1 = (int(gs.vwgt[sep].sum()), int(gs.vwgt[sep1].sum()))
    verified = verify_separator(gs, part2, sep, 2)
    feas = separator_is_feasible(gs, labels, 0.2)
    log(f"memetic node separator ECO eps=0.2 grid2d({MSEP_GRID},"
        f"{MSEP_GRID}) {MEM_ISLANDS}x{MEM_POP} generations={MEM_GENS}: "
        f"separator weight {weight} (multilevel at its seed {weight1}, "
        f"{wall5s:.3f} s; geometric {MSEP_GRID}) feasible={feas} "
        f"verify_separator={verified} wall_s={wall5:.3f} sep_affinity "
        f"launches={launches5} lp_affinity launches={lp5} (those at "
        f"k = 3 included)")
    check(weight == separator_weight(gs, labels), "separator ids and "
          "labels disagree")
    check(feas, "memetic separator infeasible")
    check(verified, "verify_separator failed on the memetic separator")
    check(weight <= weight1, f"memetic separator weight {weight} above the "
          f"multilevel separator's {weight1} at its seed")
    check(launches5 > 0, "the memetic separator never launched sep_affinity")
    out["memetic_separator"] = launches5
    out["memetic_separator_lp_affinity"] = lp5
    # sep_affinity on the level-0 ELL, row 0 the separator's own labels
    _, ell = level0_views(gs, dev)
    errs["sep_affinity"] = 0.0
    for b in (1, MEM_ISLANDS):
        lab = label_rows(torch, np, labels, ell.nbr.shape[0], b, 3, dev)
        errs["sep_affinity"] = max(errs["sep_affinity"], compare_sep(
            torch, ell.nbr, ell.wgt, ell.vwgt, lab))
    log(f"memetic separator: sep_affinity == affinity_ref at level 0 "
        f"{tuple(ell.nbr.shape)} B=1,{MEM_ISLANDS} (max |err| "
        f"{errs['sep_affinity']:g})")

    # -- 28. process mapping and the ILP improvement -----------------------
    gm = grid2d(MAP_GRID, MAP_GRID)
    hierarchy, distances, k = [4, 4], [1, 10], 16
    captured, starts = [], []
    real_map, real_start = mapping.kaffpa_with_mapping, mapping._multisection

    def recording(*args, **kwargs):
        captured.append(real_map(*args, **kwargs))
        return captured[-1]

    def recording_start(*args, **kwargs):
        starts.append(real_start(*args, **kwargs))
        return starts[-1]

    mapping.kaffpa_with_mapping = recording
    mapping._multisection = recording_start
    try:
        t0 = zero(LAUNCHES)
        mcut, qap, final = interface.process_mapping(
            gm.n, None, gm.xadj, None, gm.adjncy, hierarchy, distances, 2,
            0.03, seed=1, mode_partitioning=interface.ECO, device=dev)
        wall6, launches6 = read(t0)
    finally:
        mapping.kaffpa_with_mapping = real_map
        mapping._multisection = real_start
    (mpart, procs, _), = captured
    start, = starts
    src = gm.edge_sources()
    ext = mpart[src] != mpart[gm.adjncy]
    comm = np.zeros((k, k), dtype=np.int64)
    np.add.at(comm, (mpart[src[ext]], mpart[gm.adjncy[ext]]),
              gm.adjwgt[ext])
    dist = mapping.processor_distance_matrix(hierarchy, distances)
    start_qap = mapping.qap_cost(comm, dist, start)
    # a reading only: the algorithm does not promise to beat the identity
    # (block b on processor b) on a kaffpa partition; on the CPU it lands
    # above it at 2 of seeds 1-3 (tools/mapping_identity_cpu.py)
    identity = mapping.qap_cost(comm, dist, np.arange(k))
    log(f"process_mapping ECO grid2d({MAP_GRID},{MAP_GRID}) hierarchy "
        f"{hierarchy} distances {distances}: cut={mcut} qap={qap} "
        f"(multisection start {start_qap}; identity mapping {identity}, "
        f"not checked) processors {procs.tolist()} wall_s={wall6:.3f} "
        f"launches={launches6}")
    check(sorted(procs.tolist()) == list(range(k))
          and np.array_equal(final, procs[mpart]),
          "process_mapping's blocks are not a permutation of its partition")
    check(qap == mapping.qap_cost(comm, dist, procs), "reported qap is not "
          "the mapping's")
    # what the algorithm guarantees: the swap search starts from the
    # multisection and only takes swaps that lower the QAP
    check(sorted(start.tolist()) == list(range(k)),
          "the multisection start is not a permutation")
    check(np.array_equal(procs, mapping._swap_local_search(comm, dist,
                                                           start)),
          "the mapping is not the swap search from its multisection start")
    check(qap <= start_qap, f"the mapping's qap {qap} is above its "
          f"multisection start's {start_qap}")
    check(launches6 > 0, "process_mapping never launched lp_affinity")
    out["process_mapping"] = launches6

    gi = grid2d(ILP_GRID, ILP_GRID)
    ipart = K.kaffpa(gi, 4, 0.03, "eco", seed=1, device=dev)
    t0 = time.perf_counter()
    improved = ilp.ilp_improve(gi, ipart, 4, timeout=5, seed=1)
    wall7 = time.perf_counter() - t0
    log(f"ilp_improve grid2d({ILP_GRID},{ILP_GRID}) k=4 from kaffpa ECO: "
        f"cut {edge_cut(gi, ipart)} -> {edge_cut(gi, improved)} feasible="
        f"{is_feasible(gi, improved, 4, 0.03)} wall_s={wall7:.3f}")
    check(edge_cut(gi, improved) <= edge_cut(gi, ipart)
          and is_feasible(gi, improved, 4, 0.03), "ilp_improve worsened")
    out["errors"] = errs
    return out

def distributed_phases(torch, np, dev, card, main_cut, kahypar_km1,
                       ep_replication) -> dict:
    """Phases 29-34; returns the launches of each path by kernel, the
    per-shard pin_count row (time, bound, plain and library times) and,
    under "errors", each kernel's largest difference from its plain
    version on these paths.  Comparisons and timings run after each
    path's counts are read."""
    import torch.distributed as dist
    from repro_torch import obs
    from repro_torch.core import interface, memetic as MEM
    from repro_torch.core.edgepart import distributed_edge_partition
    from repro_torch.core.hypergraph import container as HC
    from repro_torch.core import hypergraph as H
    from repro_torch.core.hypergraph import dist as HD
    from repro_torch.core.hypergraph import metrics as M
    from repro_torch.core.hypergraph.initial import random_partition
    from repro_torch.core.hypergraph.refine import k_bucket
    from repro_torch.core.mesh import ALL_GATHER, ALL_REDUCE, PPERMUTE, Mesh
    from repro_torch.core.parhip import parhip
    from repro_torch.core.partition import (edge_cut, edge_partition_metrics,
                                            is_feasible)
    from repro_torch.io.generators import (barabasi_albert, grid2d,
                                           rmat_hypergraph)
    from repro_torch.kernels import lp_affinity, ops, pin_affinity, ref
    from repro_torch.kernels.lp_affinity import LAUNCHES
    out, errs = {}, {}

    def zero(*names):
        torch.cuda.synchronize()
        for name in names:
            obs.metrics.reset(name)
        return time.perf_counter()

    def read(t0, name=LAUNCHES):
        torch.cuda.synchronize()
        return time.perf_counter() - t0, int(obs.metrics.get(name))

    def parhip_run(g, k, preconfiguration, what):
        rec = obs.Recorder("parhip")
        with capturing(torch, lp_affinity, "affinity_cuda") as calls:
            t0 = zero(LAUNCHES)
            part = parhip(g, k, 0.03, preconfiguration, seed=1, report=rec,
                          device=dev)
            wall, launches = read(t0)
        ctr = rec.counters()
        cut, feas = edge_cut(g, part), is_feasible(g, part, k, 0.03)
        log(f"{what}: cut={cut} feasible={feas} wall_s={wall:.3f} "
            f"lp_affinity launches={launches} parhip/dist_rounds="
            f"{int(ctr.get('parhip/dist_rounds', 0))} parhip/repairs="
            f"{int(ctr.get('parhip/repairs', 0))} levels="
            f"{int(ctr.get('engine/levels', 0))} [{card}]")
        check(feas, f"{what}: partition infeasible")
        check(ctr.get("parhip/dist_rounds", 0) > 0,
              f"{what}: no distributed round ran")
        check(launches > 0, f"{what}: lp_affinity never launched")
        errs["lp_affinity"] = max(errs.get("lp_affinity", 0.0),
                                  replay_lp(torch, calls, what))
        return part, launches

    # -- 29. parhip, the world of one on the card --------------------------
    g = grid2d(1024, 1024)
    _, out["parhip"] = parhip_run(
        g, 16, "fastmesh", f"parhip fastmesh grid2d(1024,1024) k=16 "
        f"(kaffpa ECO's cut in phase 3: {main_cut})")

    # -- 30. parhip's social preset ----------------------------------------
    _, out["parhip_social"] = parhip_run(
        barabasi_albert(65536, 4, seed=1), 8, "ultrafastsocial",
        "parhip ultrafastsocial barabasi_albert(65536,4) k=8")

    # -- 31. the collectives on the card: an NCCL world of one -------------
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = Mesh.world(("nodes",), device=dev)
        counts = (ALL_REDUCE, ALL_GATHER, PPERMUTE)
        zero(*counts)
        g2 = grid2d(256, 256)
        p_mesh = parhip(g2, 4, 0.03, "fastmesh", seed=1, mesh=mesh)
        p_none = parhip(g2, 4, 0.03, "fastmesh", seed=1, device=dev)
        check(np.array_equal(p_mesh, p_none),
              "parhip on the NCCL mesh differs from mesh=None")
        hg12 = rmat_hypergraph(12, seed=3)
        part0 = random_partition(hg12, 4, seed=1)
        r_mesh = HD.parhyp_refine(hg12, part0, 4, 0.03,
                                  mesh.view((1,), ("nets",)), rounds=8,
                                  seed=2)
        r_none = HD.parhyp_refine(hg12, part0, 4, 0.03, rounds=8, seed=2,
                                  device=dev)
        check(np.array_equal(r_mesh, r_none),
              "parhyp_refine on the NCCL mesh differs from mesh=None")
        parts = np.random.default_rng(31).integers(
            0, 16, (8, 65536)).astype(np.int32)
        for shift in range(-1, 9):
            check(np.array_equal(MEM.ring_roll(parts, shift, mesh),
                                 np.roll(parts, shift, axis=0)),
                  f"ring_roll on the NCCL mesh != np.roll at shift {shift}")
        torch.cuda.synchronize()
        calls = {c: int(obs.metrics.get(c)) for c in counts}
        log(f"NCCL world of one ({dist.get_backend()}): parhip fastmesh "
            f"grid2d(256,256) k=4 == mesh=None (cut "
            f"{edge_cut(g2, p_mesh)}); parhyp_refine rmat_hypergraph(12) "
            f"k=4 == mesh=None (km1 {M.connectivity(hg12, r_mesh)}); "
            f"ring_roll (8, 65536) int32 == np.roll at shifts -1..8; "
            f"collective calls {json.dumps(calls)}")
        check(calls[ALL_REDUCE] > 0 and calls[ALL_GATHER] > 0,
              "the NCCL mesh issued no collective")
    finally:
        dist.destroy_process_group()

    # -- 32. interface.parhyp: the device-resident V-cycle -----------------
    hg = rmat_hypergraph(17, seed=1)
    ell_builds = []
    real_to_ell_h = HC.to_ell_h

    def counted_to_ell_h(*args, **kwargs):
        ell_builds.append(1)
        return real_to_ell_h(*args, **kwargs)

    HC.to_ell_h = H.to_ell_h = counted_to_ell_h
    rec = obs.Recorder("parhyp")
    try:
        with capturing(torch, pin_affinity, "pin_count_csr_cuda") as pins, \
                capturing(torch, lp_affinity, "affinity_cuda") as lps:
            torch.cuda.reset_peak_memory_stats()
            t0 = zero(pin_affinity.LAUNCHES, LAUNCHES)
            km1, part = interface.parhyp(hg.n, hg.m, None, None, hg.eptr,
                                         hg.eind, 8, 0.03, seed=1,
                                         preconfiguration="fast",
                                         report=rec, device=dev)
            wall, launches = read(t0, pin_affinity.LAUNCHES)
            lp = int(obs.metrics.get(LAUNCHES))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        HC.to_ell_h = H.to_ell_h = real_to_ell_h
    ctr = rec.counters()
    feas = M.is_feasible(hg, part, 8, 0.03)
    levels = int(ctr.get("parhyp/device_levels", 0))
    spans = rounded(span_seconds(rec, ("parhyp_coarsen", "parhyp_initial",
                                       "parhyp_level")))
    log(f"parhyp fast km1 rmat_hypergraph(17, seed=1) k=8: km1={km1} "
        f"(kahypar ECO in phase 8: {kahypar_km1}) feasible={feas} "
        f"wall_s={wall:.3f} peak_GiB={peak:.3f} device_levels={levels} "
        f"dist_rounds={int(ctr.get('parhyp/dist_rounds', 0))} repairs="
        f"{int(ctr.get('parhyp/repairs', 0))} pin_count launches="
        f"{launches} lp_affinity launches={lp} to_ell_h calls="
        f"{len(ell_builds)} spans_s={spans} [{card}]")
    check(feas, "parhyp partition infeasible")
    check(levels >= 2, "parhyp did not coarsen on the device")
    check(launches > 0, "parhyp never launched pin_count's CSR entry")
    check(not ell_builds, "parhyp built an ELL-H view")
    out["parhyp"] = launches
    # every pin_count call of the path, one per distinct shape, on its own
    # inputs: the per-shard Φ of each device level and the coarsest
    # level's kahypar; counts are integer sums, so bit for bit
    errs["pin_count"] = 0.0
    for eptr, pv, mask, labels, k in pins.values():
        got = ops.pin_count_csr(eptr, pv, mask, labels, k)
        want = ref.pin_count_csr_ref(eptr, pv, mask, labels, k)
        torch.cuda.synchronize()
        errs["pin_count"] = max(errs["pin_count"],
                                float((got - want).abs().max()))
    shapes = [[*lab.shape, e.numel() - 1, p.numel(), k]
              for e, p, _, lab, k in pins.values()]
    log(f"parhyp: pin_count_csr == pin_count_csr_ref on the path's own "
        f"inputs at its {len(pins)} shapes [B, n_pad, e_rows, p, k] "
        f"{shapes} (max |err| {errs['pin_count']:g})")
    check(errs["pin_count"] == 0.0, f"pin_count_csr differs from its plain "
          f"version on parhyp's inputs: {errs['pin_count']}")
    if lps:
        errs["lp_affinity"] = max(errs["lp_affinity"],
                                  replay_lp(torch, lps, "parhyp"))

    # -- 33. kernel path against plain path; the per-shard Φ ---------------
    hg14 = rmat_hypergraph(14, seed=2)
    for objective in ("km1", "cut"):
        t0 = zero(pin_affinity.LAUNCHES)
        pk = HD.parhyp(hg14, 4, 0.03, "fast", seed=1, objective=objective,
                       device=dev)
        wall_k, launches_k = read(t0, pin_affinity.LAUNCHES)
        t0 = zero(pin_affinity.LAUNCHES)
        pp = HD.parhyp(hg14, 4, 0.03, "fast", seed=1, objective=objective,
                       use_kernel=False, device=dev)
        wall_p, launches_p = read(t0, pin_affinity.LAUNCHES)
        score = M.connectivity if objective == "km1" else M.cut_net
        log(f"parhyp fast {objective} rmat_hypergraph(14, seed=2) k=4: "
            f"{score(hg14, pk)} kernel path ({wall_k:.3f} s, {launches_k} "
            f"launches), {score(hg14, pp)} plain path ({wall_p:.3f} s, "
            f"{launches_p} launches) [{card}]")
        check(np.array_equal(pk, pp), f"parhyp {objective}: kernel path "
              f"and plain path partitions differ")
        check(launches_k > 0 and launches_p == 0,
              f"parhyp {objective}: launches {launches_k} / {launches_p}")
    sh = HD.shard_hypergraph(hg, 1)
    lay = HD._layout(Mesh.local(("nets",), dev), sh)
    L = HD._level0(lay, sh, dev)
    k_pad = k_bucket(8)
    labels = torch.zeros(1, sh.n_pad, dtype=torch.int32, device=dev)
    labels[0, :hg.n] = torch.from_numpy(part.astype(np.int32)).to(dev)
    got = ops.pin_count_csr(L.eptr, L.pv, L.mask, labels, k_pad)[0]
    scatter = HD._pin_counts(lay, L, labels[0], k_pad, use_kernel=False)
    plain = ref.pin_count_csr_ref(L.eptr, L.pv, L.mask, labels, k_pad)[0]
    torch.cuda.synchronize()
    level0_err = max(float((got - scatter).abs().max()),
                     float((got - plain).abs().max()))
    errs["pin_count"] = max(errs["pin_count"], level0_err)
    check(level0_err == 0.0, f"the shard's Φ by pin_count_csr differs from "
          f"the scatter: {level0_err}")
    # the coarse device levels, where a contraction's merged duplicates
    # stay inside their net's range as mask-0 pins: the CSR route by each
    # level's eptr against the scatter by its pin → net ids
    cfg = HD.PRESETS[HD.PARHYP_PRESETS["fast"]["preset"]]
    dlevels, _ = HD._device_hierarchy(sh, lay.mesh, cfg, 8, 1, obs.NULL)
    gen = torch.Generator(device=dev).manual_seed(33)
    coarse = []
    for li, Lc in enumerate(dlevels[1:], 1):
        lab = torch.randint(0, 8, (sh.n_pad,), generator=gen, device=dev,
                            dtype=torch.int32)
        got_c = ops.pin_count_csr(Lc.eptr, Lc.pv, Lc.mask, lab[None],
                                  k_pad)[0]
        want_c = HD._pin_counts(lay, Lc, lab, k_pad, use_kernel=False)
        live_c = int(Lc.eptr[-1])
        dead_c = int((Lc.mask[:live_c] == 0).sum())
        err_c = float((got_c - want_c).abs().max())
        coarse.append([li, live_c, dead_c, err_c])
        errs["pin_count"] = max(errs["pin_count"], err_c)
    log(f"the shard's Φ on rmat_hypergraph(17)'s coarse device levels "
        f"[level, pins in nets, mask-0 pins among them, max |err|]: "
        f"{coarse}")
    check(coarse and all(c[3] == 0.0 for c in coarse),
          f"the shard's Φ by pin_count_csr differs from the scatter at a "
          f"coarse level: {coarse}")
    check(any(c[2] > 0 for c in coarse),
          "no coarse level holds a mask-0 pin inside a net's range")

    def kernel():
        return pin_affinity.pin_count_csr_cuda(L.eptr, L.pv, L.mask, labels,
                                               k_pad)

    ms = launch_ms(torch, kernel, {"pin_count_kernel": 1},
                   calls=20)["pin_count_kernel"]
    call_ms = cuda_ms(torch, kernel)
    plain_ms = cuda_ms(torch, lambda: ref.pin_count_csr_ref(
        L.eptr, L.pv, L.mask, labels, k_pad), iters=5)
    library_ms = cuda_ms(torch, lambda: HD._pin_counts(
        lay, L, labels[0], k_pad, use_kernel=False), iters=5)
    # as phase 11: the real pins' masks, the ids of live pins, the
    # offsets, the labels and the (e_rows, k) output
    p = int(L.eptr[-1])
    live = int((L.mask[:p] != 0).sum())
    nbytes = (p * 4 + live * 4 + L.eptr.numel() * 4 + labels.numel() * 4
              + lay.e_rows * k_pad * 4)
    bms, by = bound_ms(nbytes, live)
    out["per_shard"] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bms,
                            bound_by=by,
                            shape=[1, lay.e_rows, p, k_pad, sh.n_pad])
    log(f"pin_count_csr on the shard's pin list (S=1, rmat_hypergraph(17) "
        f"level 0) B=1 e_rows={lay.e_rows} pins={p} k={k_pad}: == the "
        f"scatter and the plain version (max |err| {errs['pin_count']:g}); "
        f"kernel {ms:.4f} ms per launch (torch.profiler; {call_ms:.4f} ms "
        f"per wrapper call), plain {plain_ms:.4f} ms, scatter (index_add_) "
        f"{library_ms:.4f} ms, bound {bms:.4f} ms ({nbytes} bytes at "
        f"{PEAK_BYTES_PER_S / 1e12} TB/s) [{card}]")

    # -- 34. the distributed edge partition --------------------------------
    gep = grid2d(EP_GRID, EP_GRID)
    with capturing(torch, lp_affinity, "affinity_cuda") as calls:
        t0 = zero(LAUNCHES)
        epart = distributed_edge_partition(gep, 4, seed=1, device=dev)
        wall, out["distributed_edge_partition"] = read(t0)
    metrics = edge_partition_metrics(gep, epart, 4)
    log(f"distributed_edge_partition fastmesh k=4 grid2d({EP_GRID},"
        f"{EP_GRID}): {json.dumps(metrics)} (edge_partition ECO in phase "
        f"22: replication {ep_replication:.4f}) wall_s={wall:.3f} "
        f"lp_affinity launches={out['distributed_edge_partition']} "
        f"[{card}]")
    check(epart.shape == (gep.m,) and int(epart.min()) >= 0
          and int(epart.max()) < 4, "an edge has no block in [0, 4)")
    check(out["distributed_edge_partition"] > 0,
          "distributed_edge_partition never launched lp_affinity")
    errs["lp_affinity"] = max(errs["lp_affinity"], replay_lp(
        torch, calls, "distributed_edge_partition"))
    out["errors"] = errs
    return out


def make_decoder(torch, T, arch, dev, card):
    """The model of phases 35-39 at its published width (depth cut as
    DEC_DEPTH says), made on the card from seed 0; its parameter count
    is checked against DEC_PARAMS."""
    from repro_torch.configs.base import get_config
    full = get_config(arch)
    cfg = (dataclasses.replace(full, n_layers=DEC_DEPTH[arch])
           if DEC_DEPTH[arch] else full)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, secs = timed(torch, lambda: T.init_params(cfg, seed=0, device=dev))
    n = sum(p.numel() for p in model.parameters())
    log(f"{cfg.name}: {n} f32 parameters ({n * 4 / 1e9:.1f} GB) made on the "
        f"card in {secs:.3f} s (layers {cfg.n_layers} of {full.n_layers}, "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"vocab_pad {cfg.vocab_pad}, tied embeddings {cfg.tie_embeddings}) "
        f"[{card}]")
    check(n == DEC_PARAMS[arch], f"{cfg.name}: {n} parameters, expected "
          f"{DEC_PARAMS[arch]}")
    return cfg, model


def timed(torch, fn):
    """(fn(), host-clock seconds) from a synchronised start to a
    synchronised end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed_forward(torch, T, model, cfg, tokens, card, **kw):
    """A warm-up, then one full-sequence forward (``kw`` passed on)
    timed with its peak memory and its attention counts; the logits must
    be finite, of shape (B, L, vocab_pad).  Returns (the wall,
    ``attention_paths`` of the timed forward)."""
    T.forward(model, cfg, tokens, **kw)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    attention_paths()
    logits, wall = timed(torch, lambda: T.forward(model, cfg, tokens,
                                                  **kw)[0])
    paths = attention_paths(True)
    peak = torch.cuda.max_memory_allocated()
    b, l = tokens.shape
    log(f"{cfg.name} forward B={b} L={l}: wall_s={wall:.4f} "
        f"({b * l / wall:.1f} tokens/s), peak memory {peak} B "
        f"({peak / 2**30:.2f} GiB); attention calls: {paths['launches']} "
        f"fused kernel launches, {paths['composed']} composed [{card}]")
    check(logits.shape == (b, l, cfg.vocab_pad),
          f"{cfg.name}: logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()),
          f"{cfg.name}: non-finite logits")
    return wall, paths


def decode_against_forward(torch, np, T, model, cfg, prompts, steps, dev,
                           card, frames=None):
    """Each prompt prefilled into its own slot of one cache
    (``prefill_step`` on the slot's view: one forward at cache_pos=0, or
    token by token on the ssm family), then ``steps`` batched greedy
    ``decode_step``s with per-row cursors; each prefill's last logits and
    every step's against the full forward over that row's sequence,
    within 2e-3 of max |logits| (the bound of
    tests/test_models.py::test_decode_matches_full_forward).  ``frames``
    (rows, F, d): each row's encoder frames, given to its prefill and its
    forward only; the cross-attention cache must be non-zero after the
    prefills and unchanged by the decode steps.  Returns the host-clock
    seconds of each decode step."""
    from repro_torch.serve.serve_step import decode_step, prefill_step
    smax = max(len(p) for p in prompts) + steps
    caches = T.init_caches(cfg, len(prompts), smax, device=dev,
                           enc_len=None if frames is None else frames.shape[1])
    first = []
    for r, p in enumerate(prompts):
        view = {k: v[:, r:r + 1] for k, v in caches.items()}
        first.append(prefill_step(
            model, cfg, p[None], view,
            enc_frames=None if frames is None else frames[r:r + 1])[0][0])
    if frames is not None:
        cross = {k: caches[k].clone() for k in ("xk", "xv")}
        check(all(bool(c[:, r].abs().amax() > 0)
                  for c in cross.values() for r in range(len(prompts))),
              f"{cfg.name}: a row's cross-attention cache is zero after "
              f"its prefill")
    tok = torch.stack(first).argmax(-1)
    pos = torch.tensor([len(p) for p in prompts], device=dev)
    fed, outs, walls = [], [], []
    for _ in range(steps):
        (lg, _), wall = timed(torch, lambda: decode_step(
            model, cfg, tok[:, None], caches, pos))
        walls.append(wall)
        fed.append(tok)
        outs.append(lg)
        tok, pos = lg.argmax(-1), pos + 1
    if frames is not None:
        check(all(torch.equal(caches[k], c) for k, c in cross.items()),
              f"{cfg.name}: decode changed the cross-attention cache")
    worst = 0.0
    for r, p in enumerate(prompts):
        seq = torch.cat([p, torch.stack(fed)[:, r]])[None]
        want = T.forward(
            model, cfg, seq,
            enc_frames=None if frames is None else frames[r:r + 1]
        )[0][0, len(p) - 1:]
        got = torch.stack([first[r]] + [o[r] for o in outs])
        worst = max(worst, max_rel(torch, got, want)[1])
    log(f"{cfg.name} decode: prefill of {[len(p) for p in prompts]} tokens "
        f"in separate slots, then {steps} batched decode steps with per-row "
        f"cursors: worst rel to the full forward {worst:g} (max 2e-3); host "
        f"clock per decode step median {np.median(walls) * 1e3:.3f} ms (min "
        f"{min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}) [{card}]")
    check(worst <= 2e-3, f"{cfg.name}: decode and forward differ: {worst}")
    return walls


def expert_loads(np, gates, n_experts, cap) -> list:
    """Per observed MoE layer: its expert-load histogram and the pairs
    beyond the capacity ``cap`` (dropped)."""
    out = []
    for g in gates:
        load = np.bincount(g.reshape(-1), minlength=n_experts)
        out.append({"load": load.tolist(),
                    "dropped": int(np.maximum(load - cap, 0).sum())})
    return out


def phase14_stream(np, cfg, seed: int = 2) -> list:
    """Phase 14's request stream: 6 requests, prompts of 16–64 tokens
    drawn from ``seed``, 16 new tokens each, arrival ticks 0–8."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 9)),
             rng.integers(0, cfg.vocab, int(rng.integers(16, 65))).tolist(),
             16) for _ in range(6)]


def serve_phase(torch, np, T, model, cfg, dev, card) -> None:
    """Phase 14's stream (6 requests, prompts of 16–64 tokens, 16 new
    tokens each, arrival ticks 0–8, 4 slots, max_len 256) through
    ``serve_stream``: wall, tokens/s, step spans; every request gives 16
    tokens inside the vocabulary, and each batcher prefill (token by
    token, as the JAX batcher runs it, in a fresh or a reused slot) lies
    within 2e-3 of the forward at the prompt's last position."""
    from repro_torch import obs
    from repro_torch.serve.batching import serve_stream
    stream = phase14_stream(np, cfg)
    rec = obs.Recorder("serve")
    with obs.use(rec):
        reqs, wall = timed(torch, lambda: serve_stream(
            model, cfg, stream, batch_slots=4, max_len=256))
    n_new = sum(len(r.out) for r in reqs)
    log(f"serve {cfg.name} 6 requests (prompts "
        f"{[len(p) for _, p, _ in stream]}, arrival ticks "
        f"{[a for a, _, _ in stream]}, 4 slots, max_len 256): wall_s="
        f"{wall:.4f} new tokens={n_new} ({n_new / wall:.2f} tokens/s); step "
        f"spans (host clock, count and s: prefill, and decode by batch "
        f"rows): {json.dumps(step_spans(rec))} [{card}]")
    for r in reqs:
        check(r.done and len(r.out) == 16,
              f"request {r.rid} finished with {len(r.out)} tokens")
        check(all(0 <= t < cfg.vocab_pad for t in r.out),
              f"request {r.rid} produced a token outside the vocabulary")
    worst = max(max_rel(torch, r.logits, T.forward(
        model, cfg, torch.tensor([p], device=dev))[0][0, -1])[1]
        for r, (_, p, _) in zip(reqs, stream))
    log(f"cross-check: batcher prefill (token by token) vs the forward at "
        f"the prompt's last position: worst rel {worst:g} (max 2e-3)")
    check(worst <= 2e-3, f"batcher prefill and forward differ: {worst}")


def param_bytes(model, skip: str = "") -> int:
    """The bytes of the model's parameters, those whose name starts with
    ``skip`` (when given) left out."""
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters()
               if not (skip and name.startswith(skip)))


def log_step_bound(np, cfg, walls, n_bytes, what, card) -> None:
    log(f"{cfg.name} decode step: host clock median "
        f"{np.median(walls) * 1e3:.3f} ms against {what} bound "
        f"{n_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms ({n_bytes} B at "
        f"{PEAK_BYTES_PER_S / 1e12} TB/s) [{card}]")


def minicpm_phases(torch, np, dev, card, tokens) -> dict:
    """Phases 35-37: minicpm-2B's forward, decode and serve; returns the
    attention counts of phase 35's timed forward."""
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import (apply_rope, causal_mask, rmsnorm,
                                           rope_freqs)

    # -- 35. minicpm-2B, the full published config ---------------------------
    cfg, model = make_decoder(torch, T, "minicpm_2b", dev, card)
    _, paths = timed_forward(torch, T, model, cfg,
                             tokens(cfg, *DEC_FWD["minicpm_2b"]), card)
    check(paths == {"launches": cfg.n_layers, "composed": 0},
          f"minicpm-2b forward attention {paths}, expected the kernel in "
          f"all {cfg.n_layers} layers")
    # at L = 2048 the composed path (taken with gradients) is the masked
    # one (S·Skv is exactly ONLINE_THRESHOLD²): layer 0's real q, k, v of a
    # longer prompt through both composed attentions
    blk = model.blocks[0]
    x = rmsnorm(model.embed[tokens(cfg, 1, ONLINE_L)]
                * math.sqrt(cfg.d_model), blk.ln1, cfg.norm_eps)
    cos, sin = rope_freqs(torch.arange(ONLINE_L, device=dev)[None], cfg.hd,
                          cfg.rope_theta)
    q, k, v = ((x @ w).reshape(1, ONLINE_L, -1, cfg.hd)
               for w in (blk.attn.wq, blk.attn.wk, blk.attn.wv))
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    scale = 1.0 / math.sqrt(cfg.hd)
    online, wall_on = timed(torch, lambda: A._sdpa_online(
        q, k, v, None, scale, q_offset=0))
    dense, wall_de = timed(torch, lambda: A._sdpa(
        q, k, v, causal_mask(ONLINE_L, ONLINE_L, 0, dev), None, scale))
    err, rel = max_rel(torch, online, dense)
    log(f"minicpm-2b layer 0 attention on a {ONLINE_L}-token prompt: "
        f"_sdpa_online {wall_on:.4f} s, _sdpa {wall_de:.4f} s, max |err| "
        f"{err:g}, rel to max |out| {rel:g} (max 1e-4) [{card}]")
    check(rel <= 1e-4, f"online and dense attention differ: {rel}")
    del q, k, v, x, online, dense

    # -- 36. minicpm decode --------------------------------------------------
    walls = decode_against_forward(
        torch, np, T, model, cfg, [tokens(cfg, n) for n in DEC_PROMPTS],
        DEC_STEPS, dev, card)
    log_step_bound(np, cfg, walls, param_bytes(model), "the weight-read",
                   card)

    # -- 37. minicpm serve: phase 14's stream --------------------------------
    serve_phase(torch, np, T, model, cfg, dev, card)
    log(f"minicpm-2b phases: peak memory "
        f"{torch.cuda.max_memory_allocated()} B [{card}]")
    return paths


def llama4_phases(torch, np, dev, card, tokens, gen) -> tuple:
    """Phase 38: llama4-scout's forward with the gate tap, decode,
    per-row dispatch and expert placement; returns (lp_affinity launches
    on the placement path, max |err| of its calls)."""
    from repro_torch import obs
    from repro_torch.kernels import lp_affinity
    from repro_torch.kernels.lp_affinity import LAUNCHES
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import prefill_step
    arch = "llama4_scout_17b_a16e"
    cfg, model = make_decoder(torch, T, arch, dev, card)
    toks = tokens(cfg, *DEC_FWD[arch])
    timed_forward(torch, T, model, cfg, toks, card)
    gates = []
    with MOE.observe_gates(gates.append):
        T.forward(model, cfg, toks)
    t = toks.numel()
    check(len(gates) == cfg.n_layers, f"gate tap: {len(gates)} reports")
    for g in gates:
        check(g.shape == (t, cfg.top_k) and g.min() >= 0
              and g.max() < cfg.n_experts,
              f"gate tap: shape {g.shape}, range {g.min()}..{g.max()}")
    cap = MOE.capacity(t, cfg)
    log(f"llama4-scout gates per layer ({t} tokens x top-{cfg.top_k}, "
        f"capacity {cap}): "
        f"{json.dumps(expert_loads(np, gates, cfg.n_experts, cap))}")
    # at capacity factor 8 nothing drops, so token by token equals the
    # forward (tests/test_models.py::test_moe_mismatch_is_capacity_drops_only)
    cfg8 = dataclasses.replace(cfg, capacity_factor=8.0)
    seq = toks[:, :DEC_STEPS]
    full = T.forward(model, cfg8, seq)[0]
    caches = T.init_caches(cfg8, 1, DEC_STEPS, device=dev)
    inc = torch.cat([T.forward(model, cfg8, seq[:, i:i + 1], caches=caches,
                               cache_pos=i)[0] for i in range(DEC_STEPS)], 1)
    _, rel = max_rel(torch, inc, full)
    log(f"llama4-scout token-by-token decode vs forward over {DEC_STEPS} "
        f"tokens at capacity factor 8: rel {rel:g} (max 2e-3)")
    check(rel <= 2e-3, f"llama4 decode and forward differ: {rel}")
    # a batched decode of 4 rows (per-row cursors: each row dispatches
    # alone, with its own capacity) equals each row decoded alone
    lens = (5, 9, 3, 7)
    smax = max(lens) + 8
    caches = T.init_caches(cfg, len(lens), smax, device=dev)
    solo = [T.init_caches(cfg, 1, smax, device=dev) for _ in lens]
    last = []
    for r, n in enumerate(lens):
        p = tokens(cfg, 1, n)
        view = {k: v[:, r:r + 1] for k, v in caches.items()}
        last.append(prefill_step(model, cfg, p, view)[0][0].argmax())
        prefill_step(model, cfg, p, solo[r])
    tok, pos = torch.stack(last), torch.tensor(lens, device=dev)
    worst, step_gates = 0.0, []
    for _ in range(8):
        with MOE.observe_gates(step_gates.append):
            lg = T.forward(model, cfg, tok[:, None], caches=caches,
                           cache_pos=pos)[0][:, 0]
        for r in range(len(lens)):
            alone = T.forward(model, cfg, tok[r:r + 1, None], caches=solo[r],
                              cache_pos=int(pos[r]))[0][0, 0]
            worst = max(worst, max_rel(torch, lg[r], alone)[1])
        tok, pos = lg.argmax(-1), pos + 1
    shared = sum(len(set(g[:, 0].tolist())) < len(lens) for g in step_gates)
    log(f"llama4-scout batched decode of {len(lens)} rows vs each row alone, "
        f"8 steps: worst rel {worst:g} (max 1e-4); layer-steps where two "
        f"rows chose one expert: {shared} of {len(step_gates)} (one group "
        f"of {len(lens)} tokens would have capacity "
        f"{MOE.capacity(len(lens), cfg)})")
    check(worst <= 1e-4, f"batched decode differs from rows alone: {worst}")
    # expert placement of layer 0 on 4 shards by the port's kaffpa
    with capturing(torch, lp_affinity, "affinity_cuda") as calls:
        torch.cuda.synchronize()
        obs.metrics.reset(LAUNCHES)
        perm, wall = timed(torch, lambda: MOE.expert_placement(
            gates[0], cfg.n_experts, 4, seed=1, device=dev))
        launches = int(obs.metrics.get(LAUNCHES))
    load = np.bincount(gates[0].reshape(-1), minlength=cfg.n_experts)
    log(f"expert_placement(layer 0's gates, {cfg.n_experts}, 4): perm "
        f"{perm.tolist()}, shard loads "
        f"{load[perm].reshape(4, -1).sum(1).tolist()}, wall_s={wall:.4f}, "
        f"lp_affinity launches={launches} [{card}]")
    check(sorted(perm.tolist()) == list(range(cfg.n_experts)),
          "expert_placement is not a permutation")
    check(launches > 0, "expert_placement never launched lp_affinity")
    lp_err = replay_lp(torch, calls, "expert placement")
    p0 = model.blocks[0].moe
    x = torch.randn(1, 64, cfg.d_model, generator=gen, device=dev) * 0.1
    y0 = MOE.moe_ffn(p0, x, cfg)
    y1 = MOE.moe_ffn(MOE.place_experts(p0, perm), x, cfg)
    excess = float(((y1 - y0).abs() - 1e-4 * y0.abs()).max())
    log(f"place_experts: layer 0's moe_ffn with the placed stacks vs "
        f"unplaced: max |err| {float((y1 - y0).abs().max()):g}, "
        f"|err| - 1e-4|y| max {excess:g} (max 1e-5, "
        f"tests/test_models.py's rtol and atol)")
    check(excess <= 1e-5, f"placed experts change moe_ffn: {excess}")
    log(f"llama4-scout phases: peak memory "
        f"{torch.cuda.max_memory_allocated()} B [{card}]")
    return launches, lp_err


def deepseek_phases(torch, np, dev, card, tokens) -> dict:
    """Phase 39: deepseek-v2's forward and absorbed decode; then phase 53
    on the same weights.  Returns phase 53's pin_count launches and the
    largest difference of its calls from the plain version."""
    from repro_torch.models import transformer as T
    arch = "deepseek_v2_236b"
    cfg, model = make_decoder(torch, T, arch, dev, card)
    toks = tokens(cfg, *DEC_FWD[arch])
    timed_forward(torch, T, model, cfg, toks, card)
    # the absorbed one-token steps against the forward, nothing dropped
    decode_against_forward(
        torch, np, T, model, dataclasses.replace(cfg, capacity_factor=8.0),
        [toks[0, :DEC_PROMPTS[1]]], DEC_STEPS, dev, card)
    per_token = (cfg.kv_lora + cfg.rope_head_dim) * 4 * cfg.n_layers
    full_kv = (2 * cfg.n_heads * (cfg.nope_head_dim + cfg.rope_head_dim) * 4
               * cfg.n_layers)
    log(f"deepseek-v2 cache: {per_token} B per token at {cfg.n_layers} "
        f"layers ((kv_lora {cfg.kv_lora} + rope {cfg.rope_head_dim}) x 4 B "
        f"x layers; K and V of {cfg.n_heads} heads would take {full_kv} B)")
    out = traffic_phase(torch, np, T, model, cfg, dev, card)
    log(f"deepseek-v2 phases: peak memory "
        f"{torch.cuda.max_memory_allocated()} B [{card}]")
    return out


def check_slot_tracks(rec, n_req, n_after_first) -> dict:
    """Phase 53's trace checks: the Chrome trace has tracks ``slot 0`` …
    ``slot 3`` and ``queue``; on every slot track each request's
    ``req``/``prefill``/``decode`` B/E pairs nest and close; one ``tok``
    instant per generated token after the first.  Returns the counts."""
    from repro_torch import obs
    trace = obs.chrome_trace(rec, registry_gauges=True)["traceEvents"]
    names = {e["tid"]: e["args"]["name"] for e in trace if e["ph"] == "M"}
    check({"slot 0", "slot 1", "slot 2", "slot 3", "queue"}
          <= set(names.values()), f"tracks {sorted(names.values())}")
    stacks = {tid: [] for tid in names}
    opened = {"req": 0, "prefill": 0, "decode": 0}
    toks = 0
    for e in trace:
        if e["ph"] == "B":
            check(e["tid"] in stacks, f"span {e['name']} off the tracks")
            stacks[e["tid"]].append(e["name"])
            opened[e["name"].split()[0]] += 1
        elif e["ph"] == "E":
            st = stacks[e["tid"]]
            check(bool(st) and st.pop() == e["name"],
                  f"unbalanced end of {e['name']} on {names[e['tid']]}")
        elif e["ph"] == "i" and e["name"] == "tok":
            toks += 1
    check(not any(stacks.values()), f"open spans {stacks}")
    check(opened == {"req": n_req, "prefill": n_req, "decode": n_req},
          f"spans per request {opened}")
    check(toks == n_after_first,
          f"{toks} tok instants for {n_after_first} tokens")
    return {**opened, "tok": toks, "events": len(trace)}


def traffic_phase(torch, np, T, model, cfg, dev, card) -> dict:
    """Phase 53: phase 14's stream served with ``ServeTelemetry`` and the
    gate tap into a ``TrafficAccumulator``, without either, and with
    telemetry alone (identical tokens, three walls); the latency
    quantiles and tokens/s; the trace's tracks, spans and instants; the
    traffic hypergraph through kahypar on the card beside the identity
    placement, every pin_count launch held against its plain version; a
    second stream's drift."""
    from repro_torch import obs
    from repro_torch.core.hypergraph import connectivity, kahypar
    from repro_torch.kernels import lp_affinity, pin_affinity, ref
    from repro_torch.models import moe as MOE
    from repro_torch.serve.batching import serve_stream

    # -- 53. serve telemetry and the live traffic hypergraph ---------------
    stream = phase14_stream(np, cfg)
    rec = obs.Recorder("serve_telemetry")
    acc = obs.TrafficAccumulator(cfg.n_experts, decay=0.95)
    tele = obs.ServeTelemetry(recorder=rec, traffic=acc)
    with MOE.observe_gates(acc):
        reqs, wall = timed(torch, lambda: serve_stream(
            model, cfg, stream, batch_slots=4, max_len=256, telemetry=tele))
    # read at once: the rates decay, and later runs count into the registry
    snap = tele.snapshot()
    served = {k: v for k, v in rec.counters().items()
              if k.startswith("serve/")}
    plain, wall0 = timed(torch, lambda: serve_stream(
        model, cfg, stream, batch_slots=4, max_len=256))
    # the telemetry's share of the tapped run's extra time, without the tap
    untapped, wall1 = timed(torch, lambda: serve_stream(
        model, cfg, stream, batch_slots=4, max_len=256,
        telemetry=obs.ServeTelemetry(recorder=obs.Recorder("untapped"))))
    n_new = sum(len(r.out) for r in reqs)
    check(all(r.done and len(r.out) == 16 for r in reqs),
          "a request did not finish with 16 tokens")
    check([r.out for r in reqs] == [r.out for r in plain]
          == [r.out for r in untapped],
          "served tokens differ with telemetry on and off")
    lat = {k: {q: round(v, 1) for q, v in qs.items()}
           for k, qs in snap["latency_us"].items()}
    log(f"deepseek-v2 served phase 14's stream (6 requests, 4 slots, "
        f"max_len 256) with ServeTelemetry and the gate tap: wall_s="
        f"{wall:.4f} ({n_new / wall:.2f} tokens/s), without either: wall_s="
        f"{wall0:.4f} ({n_new / wall0:.2f} tokens/s), telemetry without the "
        f"tap: wall_s={wall1:.4f}; tokens identical; "
        f"latency quantiles (us) {json.dumps(lat)}; tok_per_s window "
        f"{snap['tok_per_s_window']:.2f}, ewma {snap['tok_per_s_ewma']:.2f};"
        f" total_tokens {snap['total_tokens']}, steps {snap['steps']} "
        f"[{card}]")
    check(snap["total_tokens"] == n_new and snap["total_requests"] == 6,
          f"telemetry counted {snap['total_tokens']} tokens, "
          f"{snap['total_requests']} requests")
    check(set(lat) == {"queue_us", "prefill_us", "decode_us", "e2e_us"},
          f"latency sketches {sorted(lat)}")
    counts = check_slot_tracks(rec, len(reqs), n_new - len(reqs))
    log(f"serve trace: {json.dumps(counts)}; serve counters "
        f"{json.dumps(served)}")
    check(served.get("serve/tokens") == n_new
          and served.get("serve/requests_finished") == len(reqs),
          f"serve counters {served}")
    hg = acc.snapshot()
    hg.check()
    check(hg.n == cfg.n_experts, f"traffic hypergraph of {hg.n} vertices")
    k = 4
    with capturing(torch, pin_affinity, "pin_count_csr_cuda",
                   every=True) as pins, \
            capturing(torch, lp_affinity, "affinity_cuda") as lps:
        torch.cuda.synchronize()
        obs.metrics.reset(pin_affinity.LAUNCHES)
        part, kwall = timed(torch, lambda: kahypar(hg, k, preset="eco",
                                                   seed=1, device=dev))
        launches = int(obs.metrics.get(pin_affinity.LAUNCHES))
    identity = np.arange(hg.n) // (hg.n // k)
    km1, km1_id = connectivity(hg, part), connectivity(hg, identity)
    log(f"traffic hypergraph: {hg.n} experts, {hg.m} nets, {hg.pins} pins "
        f"from {acc.events} routed tokens; kahypar eco k={k}: km1 {km1} "
        f"against the identity placement's {km1_id}, block loads "
        f"{np.bincount(part, weights=hg.vwgt, minlength=k).astype(int).tolist()}, "
        f"wall_s={kwall:.4f}, pin_count launches={launches} [{card}]")
    check(launches > 0, "kahypar on the traffic hypergraph never launched "
          "pin_count")
    err = 0.0
    for eptr, pv, mask, labels, kk in pins.values():
        got = pin_affinity.pin_count_csr_cuda(eptr, pv, mask, labels, kk)
        want = ref.pin_count_csr_ref(eptr, pv, mask, labels, kk)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
    log(f"traffic kahypar: pin_count_csr == pin_count_csr_ref on each of "
        f"its {len(pins)} calls' inputs (max |err| {err:g})")
    check(err == 0.0, f"pin_count_csr differs from its plain version on "
          f"the traffic hypergraph: {err}")
    lp_err = replay_lp(torch, lps, "traffic kahypar") if lps else 0.0
    acc.set_baseline()
    with MOE.observe_gates(acc):
        serve_stream(model, cfg, phase14_stream(np, cfg, seed=3),
                     batch_slots=4, max_len=256)
    advised = acc.advise(rec)
    log(f"traffic drift after a second stream (seed 3): {acc.drift():.4f}; "
        f"gauges serve/traffic_drift="
        f"{obs.metrics.gauge('serve/traffic_drift'):.4f}, "
        f"serve/repartition_advised="
        f"{obs.metrics.gauge('serve/repartition_advised')} "
        f"(advised {advised})")
    return {"traffic_kahypar": launches, "pin_count_err": err,
            "lp_affinity_err": lp_err}


def rwkv6_phases(torch, np, dev, card, tokens) -> None:
    """Phases 40-42: rwkv6-7B's forward and time mix, decode and serve."""
    from repro_torch.models import rwkv6 as R6
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import rmsnorm

    # -- 40. rwkv6-7B, the full published config -----------------------------
    cfg, model = make_decoder(torch, T, "rwkv6_7b", dev, card)
    timed_forward(torch, T, model, cfg, tokens(cfg, *DEC_FWD["rwkv6_7b"]),
                  card)
    # layer 0's time mix alone on real inputs: the chunked WKV (a loop over
    # chunks of 16) is linear in L
    blk = model.blocks[0]
    per_token = {}
    for length in TMIX_L:
        x = rmsnorm(model.embed[tokens(cfg, 1, length)]
                    * math.sqrt(cfg.d_model), blk.ln1, cfg.norm_eps)
        R6.rwkv6_time_mix(blk.tmix, x, cfg)
        torch.cuda.reset_peak_memory_stats()
        (y, _), wall = timed(torch, lambda: R6.rwkv6_time_mix(blk.tmix, x,
                                                              cfg))
        check(bool(torch.isfinite(y).all()),
              f"rwkv6 time mix at L={length}: non-finite output")
        per_token[length] = wall / length
        log(f"rwkv6-7b layer 0 time mix B=1 L={length}: wall_s={wall:.4f}, "
            f"{per_token[length] * 1e6:.3f} us per token, peak memory "
            f"{torch.cuda.max_memory_allocated()} B [{card}]")
        del x, y
    log(f"rwkv6-7b time mix: time per token at L={TMIX_L[-1]} over that at "
        f"L={TMIX_L[0]}: {per_token[TMIX_L[-1]] / per_token[TMIX_L[0]]:.3f} "
        f"(1 = linear in L)")

    # -- 41. rwkv6 decode ----------------------------------------------------
    walls = decode_against_forward(
        torch, np, T, model, cfg, [tokens(cfg, n) for n in DEC_PROMPTS],
        DEC_STEPS, dev, card)
    log_step_bound(np, cfg, walls, param_bytes(model), "the weight-read",
                   card)
    h = cfg.d_model // cfg.ssm_head_dim
    per_layer = (2 * cfg.d_model + h * cfg.ssm_head_dim ** 2) * 4
    for max_len in (1, 4096):
        row = sum(c.numel() * c.element_size() for c in
                  T.init_caches(cfg, 1, max_len, device=dev).values())
        check(row == per_layer * cfg.n_layers,
              f"rwkv6 state of {row} B per row at max_len {max_len}")
    log(f"rwkv6-7b decode state: {per_layer * cfg.n_layers} B per row at any "
        f"position ((2 x {cfg.d_model} + {h} x {cfg.ssm_head_dim} x "
        f"{cfg.ssm_head_dim}) x 4 B = {per_layer} B per layer x "
        f"{cfg.n_layers} layers)")

    # -- 42. rwkv6 serve: phase 14's stream ----------------------------------
    serve_phase(torch, np, T, model, cfg, dev, card)
    log(f"rwkv6-7b phases: peak memory "
        f"{torch.cuda.max_memory_allocated()} B [{card}]")


def whisper_phases(torch, np, dev, card, tokens, gen) -> None:
    """Phases 43-44: whisper-medium's forward and transcription."""
    from repro_torch.models import transformer as T

    # -- 43. whisper-medium, the full published config -----------------------
    cfg, model = make_decoder(torch, T, "whisper_medium", dev, card)
    b, l = DEC_FWD["whisper_medium"]
    frames = torch.randn(b, cfg.enc_positions, cfg.d_model, generator=gen,
                         device=dev)
    wall, _ = timed_forward(torch, T, model, cfg, tokens(cfg, b, l), card,
                            enc_frames=frames)
    # the encoder alone (warm from the forward): its share of the wall
    enc, wall_enc = timed(torch, lambda: T._run_encoder(model, cfg, frames))
    check(bool(torch.isfinite(enc).all()), "whisper encoder: non-finite")
    log(f"whisper-medium forward B={b} frames={cfg.enc_positions} tokens={l}: "
        f"whole forward wall_s={wall:.4f}, the encoder alone wall_s="
        f"{wall_enc:.4f}, the decoder and head the difference "
        f"{wall - wall_enc:.4f} [{card}]")
    del enc

    # -- 44. whisper transcription -------------------------------------------
    walls = decode_against_forward(
        torch, np, T, model, cfg, [tokens(cfg, n) for n in WHISPER_PROMPTS],
        DEC_STEPS, dev, card, frames=frames)
    xkv = (2 * cfg.n_layers * len(WHISPER_PROMPTS) * cfg.enc_positions
           * cfg.n_kv_heads * cfg.hd * 4)
    log_step_bound(np, cfg, walls, param_bytes(model, skip="enc_") + xkv,
                   f"the decoder and tied-head weights and both rows' "
                   f"xk/xv ({xkv} B)", card)
    log(f"whisper-medium phases: peak memory "
        f"{torch.cuda.max_memory_allocated()} B [{card}]")


def cut_model(torch, T, arch, n_layers, dev):
    """The published width of ``arch`` at ``n_layers`` layers, made on the
    card from seed 0."""
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return cfg, T.init_params(cfg, seed=0, device=dev)


def grads_of(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def check_grads(torch, model, what) -> None:
    """Every parameter has a finite, non-zero gradient: a cut graph (a
    result filled outside autograd) leaves zeros upstream of the cut."""
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or not bool(p.grad.abs().amax() > 0)]
    check(not bad, f"{what}: zero or non-finite gradients on {len(bad)} "
          f"parameters, e.g. {bad[:4]}")


def leaf_excess(torch, model, got: dict, want: dict) -> float:
    """The largest |got − want| of any reference leaf (the port tensors
    that stack into it, `weights.leaf_groups`) over that leaf's max
    |want|."""
    from repro_torch.models.weights import leaf_groups
    worst = 0.0
    for leaf in leaf_groups(model).values():
        top = max(float(want[n].abs().max()) for n in leaf.names)
        diff = max(float((got[n] - want[n]).abs().max()) for n in leaf.names)
        worst = max(worst, diff / max(top, 1e-30))
    return worst


def train_flops(model, cfg, b, s) -> float:
    """FLOP of one train step of a dense decoder under remat "full": the
    blocks' matmuls and masked attention (the full S², below
    ONLINE_THRESHOLD) run four times over (forward, recomputation, and
    twice in the backward), the head's matmul three times."""
    blocks = sum(p.numel() for n, p in model.named_parameters()
                 if n.startswith("blocks.") and p.dim() == 2)
    attn = 4 * b * s * s * cfg.n_heads * cfg.hd * cfg.n_layers
    head = 2 * b * s * cfg.d_model * cfg.vocab_pad
    return 4 * (2 * b * s * blocks + attn) + 3 * head


def timed_steps(torch, step, model, opt, batch_fn, n):
    """``n`` train steps, each on ``batch_fn()`` and each ending in a
    sync; returns [(loss, grad_norm, seconds)]."""
    out = []
    for _ in range(n):
        batch = batch_fn()
        (_, _, m), wall = timed(torch, lambda: step(model, opt, batch))
        out.append((float(m["loss"]), float(m["grad_norm"]), wall))
    return out


def train_phases(torch, np, dev, card) -> dict:
    """Phases 45-48: training at full width, its equivalences, the hybrid
    and ssm families under grad, pipeline stages on the card; returns
    lp_affinity's launches on the partition_layers path and, under
    "errors", the largest difference of its calls from the plain
    version."""
    from repro_torch import obs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import lp_affinity
    from repro_torch.kernels.lp_affinity import LAUNCHES
    from repro_torch.kernels.ssd_scan import LAUNCHES as SSD_LAUNCHES
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import decode_step, prefill_step
    from repro_torch.train.data import DataConfig, batches
    from repro_torch.train.optimizer import OptConfig, adamw_update
    from repro_torch.train.pipeline import partition_layers
    from repro_torch.train.train_step import (init_opt_state,
                                              make_train_step,
                                              next_token_loss)

    # -- 45. minicpm-2B trains at its published width ------------------------
    cfg, model = make_decoder(torch, T, "minicpm_2b", dev, card)
    b, s = TRAIN_FWD
    data = batches(DataConfig(cfg.vocab, s, b), device=dev)
    opt = init_opt_state(model)
    step = make_train_step(cfg, OptConfig(), remat="full",
                           microbatches=TRAIN_MB)
    warm = timed_steps(torch, step, model, opt, lambda: next(data), 1)
    check_grads(torch, model, "minicpm-2b after the warm-up step")
    torch.cuda.reset_peak_memory_stats()
    runs = timed_steps(torch, step, model, opt, lambda: next(data),
                       TRAIN_TIMED)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for r in warm + runs for x in r[:2]),
          f"minicpm-2b: non-finite loss or grad_norm {warm + runs}")
    walls = [r[2] for r in runs]
    flops = train_flops(model, cfg, b, s)
    med = float(np.median(walls))
    rate = flops / med
    log(f"minicpm-2b train step B={b} S={s} ({TRAIN_MB} microbatches, remat "
        f"full, AdamW/WSD, f32): warm-up {warm[0][2]:.4f} s (loss "
        f"{warm[0][0]:.4f}); timed steps (loss, grad_norm, s): "
        f"{[tuple(round(x, 4) for x in r) for r in runs]}; median "
        f"{med * 1e3:.1f} ms per step, {b * s / med:.1f} tokens/s, peak "
        f"memory {peak} B ({peak / 2**30:.2f} GiB), {flops:.4g} FLOP per "
        f"step at {rate / 1e12:.2f} TFLOP/s ({rate / PEAK_F32_PER_S:.3f} of "
        f"the {PEAK_F32_PER_S / 1e12:.0f} TFLOP/s f32 peak) [{card}]")
    # the update alone (one more step on the last gradients) against what
    # it must move: each parameter, gradient and moment read once, each
    # parameter and moment written once
    _, upd = timed(torch, lambda: adamw_update(model, opt, OptConfig()))
    nbytes = 7 * param_bytes(model)
    log(f"minicpm-2b adamw_update alone: {upd * 1e3:.1f} ms against the "
        f"{nbytes / PEAK_BYTES_PER_S * 1e3:.1f} ms bound ({nbytes} B at "
        f"{PEAK_BYTES_PER_S / 1e12} TB/s) [{card}]")
    # one fixed batch, a constant rate: the loss must fall
    fixed = next(data)
    fstep = make_train_step(cfg, OptConfig(peak_lr=FIXED_LR, warmup_steps=1),
                            remat="full", microbatches=TRAIN_MB)
    frun = timed_steps(torch, fstep, model, opt, lambda: fixed, FIXED_STEPS)
    with torch.no_grad():
        after = float(next_token_loss(model, cfg, fixed))
    log(f"minicpm-2b on one fixed batch at lr {FIXED_LR}: step losses "
        f"{[round(r[0], 4) for r in frun]}, then {after:.4f} [{card}]")
    check(after < frun[0][0], f"minicpm-2b: the loss on a fixed batch did "
          f"not fall ({frun[0][0]} -> {after})")
    # what phase 60's dry run of this step is held to
    train45 = {"peak_bytes": int(peak), "param_bytes": param_bytes(model),
               "opt_bytes": sum(t.numel() * t.element_size() for t in
                                (*opt["mu"].values(), *opt["nu"].values(),
                                 opt["step"])),
               "flops": flops, "flops_8nt": 8 * cfg.param_count() * b * s,
               "step_s": med}
    del model, opt, step, fstep, fixed
    torch.cuda.empty_cache()

    # -- 46. the train step's equivalences at full width, 2 layers deep -----
    cfg, model = cut_model(torch, T, "minicpm_2b", EQ_DEPTH, dev)
    b, s = EQ_FWD
    batch = next(batches(DataConfig(cfg.vocab, s, b), device=dev))
    model.requires_grad_(True)
    grads = {}
    for remat in T.REMAT:
        model.zero_grad(set_to_none=True)
        next_token_loss(model, cfg, batch, remat).backward()
        grads[remat] = grads_of(model)
    excess = {r: leaf_excess(torch, model, grads[r], grads["none"])
              for r in ("full", "dots")}
    log(f"minicpm-2b {EQ_DEPTH} layers B={b} S={s}: grads under remat "
        f"full and dots vs none, worst of leaf max: {excess} (max 1e-5)")
    check(max(excess.values()) <= 1e-5, f"remat changes the grads: {excess}")
    del grads
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = {}
    for mb in (1, 2):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        _, _, m = make_train_step(cfg, OptConfig(), microbatches=mb)(
            model, init_opt_state(model), batch)
        out[mb] = (float(m["loss"]), grads_of(model))
    rel_loss = abs(out[2][0] - out[1][0]) / abs(out[1][0])
    rel_grad = leaf_excess(torch, model, out[2][1], out[1][1])
    log(f"microbatches 2 vs 1: loss rel {rel_loss:g}, grads worst of leaf "
        f"max {rel_grad:g} (max 1e-5)")
    check(rel_loss <= 1e-5 and rel_grad <= 1e-5,
          f"microbatches change the step: {rel_loss}, {rel_grad}")
    del out, start
    copt = init_opt_state(model, grad_compress=True)
    _, _, m = make_train_step(cfg, OptConfig(), grad_compress=True)(
        model, copt, batch)
    zero = [n for n, e in copt["err"].items() if not bool(e.abs().amax() > 0)]
    log(f"grad_compress: loss {float(m['loss']):.4f}, int8 residuals "
        f"non-zero on {len(copt['err']) - len(zero)} of {len(copt['err'])} "
        f"parameters")
    check(math.isfinite(float(m["loss"])) and not zero,
          f"grad_compress: zero residuals on {zero[:4]}")
    caches = T.init_caches(cfg, 1, 16, device=dev)
    last, caches = prefill_step(model, cfg, batch["tokens"][:1, :8], caches)
    logits, _ = decode_step(model, cfg, last.argmax(-1)[:, None], caches, 8)
    log(f"serve on the trained model: decode logits requires_grad="
        f"{logits.requires_grad}, finite={bool(torch.isfinite(logits).all())}")
    check(not logits.requires_grad and not last.requires_grad,
          "serving the trained model built a graph")
    del model, copt, caches
    torch.cuda.empty_cache()

    # -- 47. the hybrid and ssm families train on the card ------------------
    for arch, depth in TRAIN_DEPTH.items():
        cfg, model = cut_model(torch, T, arch, depth, dev)
        b, s = TRAIN_CUT_FWD
        data = batches(DataConfig(cfg.vocab, s, b), device=dev)
        step = make_train_step(cfg, OptConfig())
        opt = init_opt_state(model)
        warm = timed_steps(torch, step, model, opt, lambda: next(data), 1)
        check_grads(torch, model, f"{cfg.name} ({depth} layers)")
        torch.cuda.reset_peak_memory_stats()
        (loss, gn, wall), = timed_steps(torch, step, model, opt,
                                        lambda: next(data), 1)
        n = sum(p.numel() for p in model.parameters())
        log(f"{cfg.name} {depth} layers ({n} parameters) train step B={b} "
            f"S={s} (remat full, chunked scan where there is one): warm-up "
            f"{warm[0][2]:.4f} s, step {wall:.4f} s, loss {loss:.4f}, "
            f"grad_norm {gn:.4f}, peak memory "
            f"{torch.cuda.max_memory_allocated()} B [{card}]")
        check(math.isfinite(loss) and math.isfinite(gn),
              f"{cfg.name}: non-finite loss or grad_norm")
        if cfg.family == "hybrid":
            # the kernel has no backward: under grad it must refuse, and
            # launch nothing
            obs.metrics.reset(SSD_LAUNCHES)
            try:
                T.forward(model, cfg, next(data)["tokens"][:, :-1],
                          engine="kernel")
            except RuntimeError as e:
                check("no backward" in str(e), f"unexpected error: {e}")
                log(f"{cfg.name} forward under grad on the SSD kernel "
                    f"raises: {e}")
            else:
                raise SmokeError("the SSD kernel ran under grad")
            check(obs.metrics.get(SSD_LAUNCHES) == 0,
                  "the SSD kernel launched under grad")
        del model, opt, step
        torch.cuda.empty_cache()

    # -- 48. pipeline stages by kaffpa on the card ---------------------------
    pcfg = get_config(PIPE_ARCH)
    with capturing(torch, lp_affinity, "affinity_cuda") as calls:
        torch.cuda.synchronize()
        obs.metrics.reset(LAUNCHES)
        stage, wall = timed(torch, lambda: partition_layers(
            pcfg, PIPE_STAGES, device=dev))
        launches = int(obs.metrics.get(LAUNCHES))
    want = partition_layers(pcfg, PIPE_STAGES, device="cpu")
    sizes = np.bincount(stage, minlength=PIPE_STAGES)
    log(f"partition_layers({pcfg.name}, {PIPE_STAGES}) on the card: stage "
        f"sizes {sizes.tolist()}, wall_s={wall:.4f}, lp_affinity launches="
        f"{launches}; equal to device='cpu': {np.array_equal(stage, want)} "
        f"[{card}]")
    check(np.array_equal(stage, want), "partition_layers differs by device")
    check(bool(np.all(np.diff(stage) >= 0)) and sizes.max() - sizes.min()
          <= 1, f"stages not contiguous or not balanced: {sizes}")
    check(launches > 0, "partition_layers never launched lp_affinity")
    lp_err = replay_lp(torch, calls, "partition_layers")
    return {"partition_layers": launches, "errors": {"lp_affinity": lp_err},
            "train45": train45}


def mesh_phases(torch, np, dev, card) -> list:
    """Phases 49-51, 55-58: the collectives tensor parallelism adds,
    through an NCCL group of one; minicpm-2B and llama4-scout (2 layers),
    then zamba2, rwkv6, whisper and deepseek-v2 (2 layers), under a
    (1, 1) mesh, bit for bit equal to no mesh; gemma2-9B (2 layers)
    trained and zamba2 decoded on the sequence-split path under it, bit
    for bit equal to no mesh, and its reduce-scatter; the per-rank bytes
    of the ten archs' specs and of the port's blocks on (1, 4) and
    (2, 2), and of deepseek-v2 at the 4-card tool's depth.  Returns the
    collectives of each of phase 57's steps under the mesh."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import obs
    from repro_torch.configs.base import ARCH_IDS, get_config
    from repro_torch.core.mesh import ALL_GATHER, ALL_REDUCE, ALL_TO_ALL
    from repro_torch.launch.dryrun import (FREE_BYTES, RankStandIn,
                                           fitting_depth, rank_bytes,
                                           spec_param_bytes)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import decode_step, prefill_step

    gen = torch.Generator(device=dev).manual_seed(49)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        # -- 49. all_to_all and the per-axis all_gather through NCCL --------
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        counts = (ALL_REDUCE, ALL_GATHER, ALL_TO_ALL)
        for c in counts:
            obs.metrics.reset(c)
        x = torch.randn(1, 4096, 5120, generator=gen, device=dev)
        check(torch.equal(mesh.all_to_all(x, "model"), x),
              "all_to_all over a model axis of one changed its input")
        for axis, dim in (("model", 1), ("model", 2), ("data", 0),
                          (None, 0)):
            check(torch.equal(mesh.all_gather(x, axis, dim=dim), x),
                  f"all_gather over {axis} on dim {dim} changed its input")
        a2a_ms = cuda_ms(torch, lambda: mesh.all_to_all(x, "model"), iters=10)
        torch.cuda.synchronize()
        calls = {c: int(obs.metrics.get(c)) for c in counts}
        log(f"NCCL (data 1, model 1) mesh ({dist.get_backend()}): all_to_all "
            f"and all_gather over model (dims 1, 2), data and the whole mesh "
            f"keep a (1, 4096, 5120) f32 input; all_to_all of it "
            f"{a2a_ms:.4f} ms; collective calls {json.dumps(calls)} [{card}]")
        check(calls[ALL_TO_ALL] > 0 and calls[ALL_GATHER] >= 4,
              "the NCCL mesh issued no all_to_all or all_gather")

        # -- 50. the decoder stack under a (1, 1) mesh: bit for bit ---------
        for arch in ("minicpm_2b", "llama4_scout_17b_a16e"):
            full = get_config(arch)
            cfg = (dataclasses.replace(full, n_layers=DEC_DEPTH[arch])
                   if DEC_DEPTH[arch] else full)
            torch.cuda.empty_cache()
            model = T.init_params(cfg, seed=0, mesh=mesh)
            toks = torch.randint(0, cfg.vocab, (1, 2048), generator=gen,
                                 device=dev)
            prompt = toks[:, :DEC_PROMPTS[0]]
            runs = {}
            for name, ctx in (("none", contextlib.nullcontext()),
                              ("mesh", SH.use_mesh(mesh))):
                with ctx, torch.no_grad():
                    logits = T.forward(model, cfg, toks)[0]
                    caches = T.init_caches(
                        cfg, 1, len(prompt[0]) + DEC_STEPS, device=dev,
                        mesh=None if name == "none" else mesh)
                    lg, _ = prefill_step(model, cfg, prompt, caches)
                    steps = [lg]
                    for i in range(DEC_STEPS):
                        lg, _ = decode_step(model, cfg, lg.argmax(-1)[:, None],
                                            caches, len(prompt[0]) + i)
                        steps.append(lg)
                runs[name] = (logits, torch.stack(steps))
            same_fwd = torch.equal(*[runs[n][0] for n in runs])
            same_dec = torch.equal(*[runs[n][1] for n in runs])
            log(f"{cfg.name} ({cfg.n_layers} layers) under use_mesh of the "
                f"NCCL (1, 1) mesh: forward B=1 L=2048 logits bit for bit "
                f"equal to no mesh: {same_fwd}; prefill of "
                f"{len(prompt[0])} tokens + {DEC_STEPS} decode steps: "
                f"{same_dec} [{card}]")
            check(same_fwd and same_dec,
                  f"{cfg.name}: a (1, 1) mesh changed the logits")
            del model, runs, logits, caches

        # -- 55. the four other families under the (1, 1) mesh -------------
        for arch, depth in MESH_FAMILIES.items():
            full = get_config(arch)
            cfg = dataclasses.replace(full, n_layers=depth) if depth else full
            torch.cuda.empty_cache()
            model = T.init_params(cfg, seed=0, mesh=mesh)
            toks = torch.randint(0, cfg.vocab, (1, MESH_FWD[arch]),
                                 generator=gen, device=dev)
            frames = (torch.randn(1, cfg.enc_positions, cfg.d_model,
                                  generator=gen, device=dev)
                      if cfg.enc_layers else None)
            prompt = toks[:, :MESH_PROMPT]
            runs = {}
            for name, ctx in (("none", contextlib.nullcontext()),
                              ("mesh", SH.use_mesh(mesh))):
                with ctx, torch.no_grad():
                    logits = T.forward(model, cfg, toks, enc_frames=frames)[0]
                    caches = T.init_caches(
                        cfg, 1, MESH_PROMPT + MESH_STEPS, device=dev,
                        mesh=None if name == "none" else mesh)
                    lg, _ = prefill_step(model, cfg, prompt, caches,
                                         enc_frames=frames)
                    steps = [lg]
                    for i in range(MESH_STEPS):
                        lg, _ = decode_step(model, cfg, lg.argmax(-1)[:, None],
                                            caches, MESH_PROMPT + i)
                        steps.append(lg)
                runs[name] = (logits, torch.stack(steps))
            same_fwd = torch.equal(*[runs[n][0] for n in runs])
            same_dec = torch.equal(*[runs[n][1] for n in runs])
            log(f"{cfg.name} ({cfg.n_layers} layers) under use_mesh of the "
                f"NCCL (1, 1) mesh: forward B=1 L={MESH_FWD[arch]}"
                f"{'' if frames is None else f' on {frames.shape[1]} frames'}"
                f" logits bit for bit equal to no mesh: {same_fwd}; prefill "
                f"of {MESH_PROMPT} tokens + {MESH_STEPS} decode steps: "
                f"{same_dec} [{card}]")
            check(same_fwd and same_dec,
                  f"{cfg.name}: a (1, 1) mesh changed the logits")
            del model, runs, logits, caches
        calls57 = data_axis_phases(torch, np, dev, card, mesh, gen)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # -- 51, 56. the per-rank bytes of the specs and of the port's blocks ----
    axes = ("data", "model")
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        SH.check_tp(cfg, 4)
        with FakeTensorMode():
            total = 4 * sum(p.numel() for p in
                            T.init_params(cfg, 0, device="cpu").parameters())
        rows = {sizes: (spec_param_bytes(cfg, axes, sizes),
                        rank_bytes(cfg, cfg.n_layers, RankStandIn(axes, sizes),
                                   fsdp=True))
                for sizes in ((1, 4), (2, 2))}
        log(f"param_specs {cfg.name}: {total} B of f32 parameters; per rank "
            + "; ".join(f"(data {d}, model {m}): specs {sb} B "
                        f"({sb / 1e9:.2f} GB), the port's blocks {pb} B "
                        f"({pb / 1e9:.2f} GB)"
                        for (d, m), (sb, pb) in rows.items()))
    cfg = get_config("deepseek_v2_236b")
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    rank = RankStandIn(axes, (1, 4))
    depth = fitting_depth(cfg, rank, card_bytes)
    nbytes = rank_bytes(cfg, depth, rank)
    spec_b = spec_param_bytes(dataclasses.replace(cfg, n_layers=depth), axes,
                              (1, 4))
    port_b = rank_bytes(cfg, depth, rank, fsdp=True)
    log(f"param_specs {cfg.name} at {depth} of 60 layers (the most that "
        f"leave {FREE_BYTES / 1e9:g} GB of this card's {card_bytes} B "
        f"free: tools/serve_torch_sharded.py's deepseek depth): per rank on "
        f"(data 1, model 4) specs {spec_b} B ({spec_b / 1e9:.2f} GB), the "
        f"port's model-axis blocks {port_b} B ({port_b / 1e9:.2f} GB) "
        f"[{card}]")
    check(port_b == nbytes and depth > 2,
          f"deepseek-v2's sizing: {depth} layers, {port_b} != {nbytes} B")
    return calls57


def data_axis_phases(torch, np, dev, card, mesh, gen) -> list:
    """Phases 57-58 on the NCCL (1, 1) ``mesh``: gemma2-9B (2 layers)
    trained on the FSDP + tensor-parallel path, zamba2 decoded on the
    sequence-split cache path, each bit for bit equal to no mesh; the
    mesh's reduce-scatter.  Returns the ``mesh/*`` counter deltas of each
    of phase 57's steps under the mesh."""
    from repro_torch import obs
    from repro_torch.configs.base import get_config
    from repro_torch.core.mesh import (ALL_GATHER, ALL_REDUCE, ALL_TO_ALL,
                                       REDUCE_SCATTER)
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import decode_step
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_opt_state, make_train_step
    sys.path.insert(0, str(ROOT / "tools"))
    from serve_torch_sharded import fill_zamba2

    def under(m):
        return SH.use_mesh(m) if m is not None else contextlib.nullcontext()

    # -- 57. gemma2-9B (2 layers) trained under the (1, 1) mesh -------------
    cfg = dataclasses.replace(get_config("gemma2_9b"), n_layers=2)
    toks = torch.randint(0, cfg.vocab, (3, 1, DATA_TRAIN_SEQ + 1),
                         generator=gen, device=dev)
    runs = {}
    calls57 = []
    for name, m in (("none", None), ("mesh", mesh)):
        torch.cuda.empty_cache()
        model = T.init_params(cfg, seed=0, device=dev, mesh=m)
        opt = init_opt_state(model)
        step = make_train_step(cfg, OptConfig(), remat="full")
        walls, losses = [], []
        kinds = (ALL_REDUCE, ALL_GATHER, REDUCE_SCATTER, ALL_TO_ALL)
        with under(m):
            for i in range(3):
                before = {c: obs.metrics.get(c) for c in kinds}
                (_, _, met), wall = timed(torch, lambda: step(
                    model, opt, {"tokens": toks[i]}))
                walls.append(wall)
                losses.append(float(met["loss"]))
                if m is not None:
                    calls57.append({c: int(obs.metrics.get(c) - before[c])
                                    for c in kinds})
        del opt
        runs[name] = ({n: p.detach() for n, p in model.named_parameters()},
                      walls, losses)
        del model
    same = all(torch.equal(runs["none"][0][n], p)
               for n, p in runs["mesh"][0].items())
    flop = 8 * cfg.param_count() * DATA_TRAIN_SEQ      # remat: 8·N·T
    log(f"{cfg.name} ({cfg.n_layers} layers, full width) 3 train steps of "
        f"1 x {DATA_TRAIN_SEQ} tokens (remat full, AdamW/WSD, f32) under "
        f"use_mesh of the NCCL (1, 1) mesh (FSDP + TP path): parameters "
        f"bit for bit equal to no mesh: {same}; step walls "
        f"{[round(w, 4) for w in runs['mesh'][1]]} s (no mesh "
        f"{[round(w, 4) for w in runs['none'][1]]} s), "
        f"{flop / sorted(runs['mesh'][1])[1] / 1e12:.2f} TFLOP/s at the "
        f"median (8·N·T = {flop:.3e} FLOP), losses "
        f"{[round(x, 5) for x in runs['mesh'][2]]}; collectives per step "
        f"{json.dumps(calls57)} [{card}]")
    check(same, f"{cfg.name}: a (1, 1) mesh changed the trained weights")
    del runs

    # -- 58. zamba2 decoded on the sequence-split path, and reduce_scatter --
    torch.cuda.empty_cache()
    cfg = get_config("zamba2_2p7b")
    model = T.init_params(cfg, seed=0, mesh=mesh)
    upto = DATA_CP_LEN - DATA_CP_STEPS
    toks = torch.randint(0, cfg.vocab, (1, DATA_CP_STEPS), generator=gen,
                         device=dev)
    runs = {}
    for name, m in (("none", None), ("mesh", mesh)):
        caches = T.init_caches(cfg, 1, DATA_CP_LEN, device=dev, mesh=m)
        if m is not None:
            caches = SH.SeqSplitCaches(caches)
        fill_zamba2(torch, caches, cfg, upto, 4096, 58, m, dev)
        steps, walls = [], []
        with torch.no_grad(), under(m):
            for i in range(DATA_CP_STEPS):
                (lg, _), wall = timed(torch, lambda: decode_step(
                    model, cfg, toks[:, i:i + 1], caches, upto + i))
                steps.append(lg)
                walls.append(wall)
        runs[name] = (torch.stack(steps), sorted(walls))
        del caches
    same = torch.equal(runs["none"][0], runs["mesh"][0])
    log(f"{cfg.name} B=1 max_len={DATA_CP_LEN}, caches drawn to {upto}: "
        f"{DATA_CP_STEPS} decode steps on the sequence-split cache path "
        f"under the NCCL (1, 1) mesh: logits bit for bit equal to no mesh: "
        f"{same}; ms per step median "
        f"{runs['mesh'][1][DATA_CP_STEPS // 2] * 1e3:.3f} (no mesh "
        f"{runs['none'][1][DATA_CP_STEPS // 2] * 1e3:.3f}) [{card}]")
    check(same, f"{cfg.name}: the sequence-split path changed the logits")
    del model, runs
    x = torch.randn(4096, 5120, generator=gen, device=dev)
    before = obs.metrics.get(REDUCE_SCATTER)
    check(torch.equal(mesh.reduce_scatter(x, "data"), x),
          "reduce_scatter over a data axis of one changed its input")
    check(obs.metrics.get(REDUCE_SCATTER) == before + 1,
          "reduce_scatter was not counted once")
    rs_ms = cuda_ms(torch, lambda: mesh.reduce_scatter(x, "data"), iters=10)
    log(f"NCCL (1, 1) mesh: reduce_scatter of a (4096, 5120) f32 tensor "
        f"over data keeps it; {rs_ms:.4f} ms [{card}]")
    torch.cuda.empty_cache()
    return calls57


def decoder_phases(torch, np, dev, card) -> dict:
    """Phases 35-44 and 53, one model at a time (each freed before the
    next); returns lp_affinity's launches on the expert placement path,
    pin_count's on phase 53's kahypar, the attention counts of phase 35's
    forward and, under "errors", each kernel's largest difference from the
    plain version on those paths' calls."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def tokens(cfg, *shape):
        return torch.randint(0, cfg.vocab, shape, generator=gen, device=dev)

    minicpm_attention = minicpm_phases(torch, np, dev, card, tokens)
    torch.cuda.empty_cache()
    launches, lp_err = llama4_phases(torch, np, dev, card, tokens, gen)
    torch.cuda.empty_cache()
    traffic = deepseek_phases(torch, np, dev, card, tokens)
    torch.cuda.empty_cache()
    rwkv6_phases(torch, np, dev, card, tokens)
    torch.cuda.empty_cache()
    whisper_phases(torch, np, dev, card, tokens, gen)
    torch.cuda.empty_cache()
    return {"expert_placement": launches,
            "minicpm_attention": minicpm_attention,
            "traffic_kahypar": traffic["traffic_kahypar"],
            "errors": {"lp_affinity": max(lp_err,
                                          traffic["lp_affinity_err"]),
                       "pin_count": traffic["pin_count_err"]}}


def formats_phase(torch, np, g, part3, dev, card) -> tuple:
    """Phase 52: the file formats at phase 3's graph and the recorded
    kaffpa path; returns (lp_affinity launches of the recorded run, max
    |err| of its calls against the plain version)."""
    import shutil
    from repro_torch import obs
    from repro_torch.core import interface
    from repro_torch.io import binio
    from repro_torch.io.generators import grid2d
    from repro_torch.io.metis import read_partition, write_metis, write_partition
    from repro_torch.kernels import lp_affinity
    from repro_torch.kernels.lp_affinity import LAUNCHES

    # -- 52. file formats and the recorded kaffpa path ---------------------
    work = ROOT / "build" / "formats"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    text, ram, ext = (work / "grid.graph", work / "grid.bin",
                      work / "grid.ext.bin")
    secs = {}
    for what, fn in (("write_metis", lambda: write_metis(g, str(text))),
                     ("graph2binary",
                      lambda: binio.graph2binary(str(text), str(ram))),
                     ("graph2binary_external",
                      lambda: binio.graph2binary_external(str(text),
                                                          str(ext)))):
        t0 = time.perf_counter()
        fn()
        secs[what] = round(time.perf_counter() - t0, 3)
    check(ram.read_bytes() == ext.read_bytes(),
          "graph2binary and graph2binary_external files differ")
    back, rsecs = timed(torch, lambda: binio.read_binary(str(ram)))
    check(np.array_equal(back.xadj, g.xadj)
          and np.array_equal(back.adjncy, g.adjncy),
          "read_binary does not give back the graph")
    log(f"file formats on grid2d(1024,1024) (n={g.n}, m={g.m}): seconds "
        f"{json.dumps({**secs, 'read_binary': round(rsecs, 3)})}; Metis "
        f"{text.stat().st_size} B, binary {ram.stat().st_size} B, both "
        f"converters byte-identical [{card}]")
    args = (g.n, None, g.xadj, None, g.adjncy, 16, 0.03)

    def run(rec):
        return timed(torch, lambda: interface.kaffpa(
            *args, seed=1, mode=interface.ECO, report=rec, device=dev))

    # in turns: unrecorded, recorded (its launches counted from 0 and its
    # kernel calls kept), recorded, unrecorded
    (_, part0), wall0 = run(None)
    with capturing(torch, lp_affinity, "affinity_cuda") as calls:
        torch.cuda.synchronize()
        obs.metrics.reset(LAUNCHES)
        rec = obs.Recorder("kaffpa_recorded")
        (cut, part), wall = run(rec)
        launches = int(obs.metrics.get(LAUNCHES))
        ctr = rec.counters()
    (_, part1), wall1 = run(obs.Recorder("again"))
    (_, part2), wall2 = run(None)
    log(f"kaffpa ECO k=16 on the 1M grid, in turns: wall_s without a "
        f"recorder {wall0:.3f}, under a Recorder "
        f"{wall:.3f}, again {wall1:.3f}, without {wall2:.3f}; cut={cut}; "
        f"lp_affinity launches={launches} (the recorder's count "
        f"{int(ctr.get(LAUNCHES, 0))}), events {len(rec.events)}, kernel "
        f"builds {rec.compile_count} [{card}]")
    check(all(np.array_equal(part, p) for p in (part0, part1, part2)),
          "the recorded kaffpa partition differs from the unrecorded one")
    check(np.array_equal(part, part3), "phase 52's partition differs from "
          "phase 3's")
    check(launches > 0 and ctr.get(LAUNCHES, 0) == launches,
          f"the recorded kaffpa launched lp_affinity {launches} times, its "
          f"recorder counted {ctr.get(LAUNCHES, 0)}")
    err = replay_lp(torch, calls, "recorded kaffpa")
    write_partition(part, str(work / "tmppartition16"))
    binio.write_partition_binary(part, str(work / "tmppartition16.bin"))
    check(np.array_equal(read_partition(str(work / "tmppartition16")), part)
          and np.array_equal(binio.read_partition_binary(
              str(work / "tmppartition16.bin")), part),
          "a partition file does not read back")
    n_lines = obs.write_jsonl(rec, str(work / "kaffpa.jsonl"))
    headers, events = obs.read_jsonl(str(work / "kaffpa.jsonl"))
    check(len(headers) == 1 and len(events) == len(rec.events)
          == n_lines - 1, f"journal: {len(events)} of {len(rec.events)} "
          f"events read back")
    depth = {}
    for e in obs.chrome_trace(rec)["traceEvents"]:
        if e["ph"] in ("B", "E"):
            depth[e["tid"]] = depth.get(e["tid"], 0) + (
                1 if e["ph"] == "B" else -1)
            check(depth[e["tid"]] >= 0, f"span {e['name']} ends unopened")
    check(set(depth.values()) == {0}, f"open spans per tid {depth}")
    # a short profiler window: the spans appear by name beside the kernels
    small = grid2d(64, 64)
    prec = obs.Recorder("kaffpa_profiled")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        interface.kaffpa(small.n, None, small.xadj, None, small.adjncy, 4,
                         0.03, seed=1, mode=interface.ECO, report=prec,
                         device=dev)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    spans = {e["name"] for e in prec.events if e["ph"] == "B"}
    annotated = {e.name for e in prof.events() if e.name in spans and (
        e.is_user_annotation
        or e.device_type != torch.autograd.DeviceType.CPU)}
    log(f"journal: {n_lines} lines read back; Chrome trace spans balance on "
        f"{len(depth)} tids; torch.profiler window (kaffpa on grid2d(64,64)):"
        f" {len(names)} event names, the recorder's spans among them: "
        f"{sorted(names & {'multilevel', 'refine', 'hierarchy', 'uncoarsen'})}"
        f", as annotations or device events: {sorted(annotated)}")
    check({"multilevel", "refine"} <= names,
          "the recorder's spans are missing from the profiler's events")
    check(not annotated, f"spans {sorted(annotated)} reached the profiler "
          f"as annotations or device events")
    shutil.rmtree(work)
    return launches, err


def padding_leak_entry():
    """A planted fault for phase 59: ``ops.lp_affinity`` called with its
    padding slots' weights set to 1 (the mask not applied), so the
    garbage the perturbation aims there reaches real rows."""
    from repro_torch.analysis import registry as REG
    from repro_torch.kernels import ops
    base = REG.default_registry()["kernels/lp_affinity"]

    def build(device, mesh=None):
        _, args = base.build(device)

        def fn(nbr, wgt, labels):
            return ops.lp_affinity(nbr, wgt + (wgt == 0).float(), labels, 4)
        return fn, args

    return REG.EntryPoint(name="fixture/unmasked_padding", build=build,
                          tags=frozenset({"padding"}), padding=base.padding,
                          kernels=base.kernels)


def analysis_phase(torch, np, dev, card) -> dict:
    """Phase 59: `repro_torch.analysis` on the card — every registry entry
    on CUDA tensors (padding self-composition with the kernels launched,
    the op trace's host syncs and wide dtypes, spmd on a world of one),
    both lints, zero findings; a planted fault caught on the card."""
    from repro_torch import analysis
    from repro_torch.analysis import padding, registry as REG
    reg = REG.default_registry()
    traces = {}
    t0 = time.perf_counter()
    findings = analysis.analyze(device=dev, traces=traces)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = {}
    for name, t in sorted(traces.items()):
        sites = t.sync_sites()
        syncs[name] = sites
        allowed = sorted(loc for loc in sites
                         if reg[name].allowed(loc) is not None)
        launched = {k.split("/")[1]: int(v) for k, v in t.launches.items()}
        log(f"analysis {name} on the card: {len(t.ops)} ops, host reads "
            f"per call {json.dumps(sites)} (allowed: {allowed}), kernel "
            f"launches {json.dumps(launched)}")
    padded = sorted(n for n, e in reg.items() if "padding" in e.tags)
    kernel_padded = sorted(n for n in padded if reg[n].kernels)
    log(f"analysis on the card: {len(reg)} entries + lints in {wall:.3f} s, "
        f"{len(findings)} findings; {len(padded)} padding entries "
        f"bit-identical under garbage in their padding slots, "
        f"{len(kernel_padded)} of them through kernels 1 and 2 "
        f"({', '.join(kernel_padded)}), each kernel launched in both runs "
        f"[{card}]")
    for f in findings:
        log(f"  finding [{f.severity}] {f.checker} {f.entry} {f.code} "
            f"{f.location}: {f.message}")
    check(not findings, f"analysis found {len(findings)} faults on the card")
    check(len(kernel_padded) >= 12, f"only {kernel_padded} ran kernels")
    leak = padding.check_padding(padding_leak_entry(), dev)
    log(f"planted fault (lp_affinity with its padding weights unmasked) on "
        f"the card: {[f.code for f in leak]}")
    check([f.code for f in leak] == ["padding-flows-into-output"],
          f"the unmasked padding was not caught on the card: {leak}")
    return syncs


def dryrun_phase(torch, np, dev, card, train45: dict, calls57: list) -> None:
    """Phase 60: the dry run (`repro_torch.launch.dryrun`, shapes only,
    on the host) against this run's own measurements: minicpm-2B's phase
    45 step (parameter and optimizer bytes exactly; the peak and FLOPs
    beside the measured peak and 8·N·T) and gemma2-9B at 2 layers on a
    (1, 1) stand-in beside phase 57's counters on the NCCL (1, 1) mesh.
    At extents of 1 the model path issues no tensor-parallel or FSDP
    collective, so that agreement is of zeros: it shows only that neither
    side counts a call the step does not make.  The counts at extents
    above 1 are held by ``tests/test_torch_dryrun.py`` on 4 gloo ranks."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun as D
    t0 = time.perf_counter()
    cfg = get_config("minicpm_2b")
    b, s = TRAIN_FWD
    shape = {"kind": "train", "global_batch": b, "seq_len": s}
    got = D.extrapolated(cfg, shape, None, torch.float32, "full", TRAIN_MB)
    predicted = sum(got[k] for k in ("params", "optimizer", "batch",
                                     "activation_peak"))
    measured = train45["peak_bytes"]
    log(f"dry run of phase 45's step (minicpm-2B, B={b} S={s}, f32, remat "
        f"full, {TRAIN_MB} microbatches, from 1- and 2-layer variants): "
        f"parameters {got['params']} B (live model "
        f"{train45['param_bytes']} B), optimizer {got['optimizer']} B "
        f"(live {train45['opt_bytes']} B), batch {got['batch']} B, "
        f"activation peak {got['activation_peak']} B; predicted peak "
        f"{predicted} B vs measured max_memory_allocated {measured} B "
        f"(ratio {predicted / measured:.4f}); FLOPs per step "
        f"{got['flops']:.6g} vs 8·N·T {train45['flops_8nt']:.6g} (ratio "
        f"{got['flops'] / train45['flops_8nt']:.4f}) and phase 45's "
        f"train_flops {train45['flops']:.6g} (ratio "
        f"{got['flops'] / train45['flops']:.4f}); at the measured "
        f"{train45['step_s']:.4f} s per step the counted FLOPs run at "
        f"{got['flops'] / train45['step_s'] / 1e12:.2f} TFLOP/s [{card}]")
    check(got["params"] == train45["param_bytes"]
          and got["optimizer"] == train45["opt_bytes"],
          "the dry run's parameter or optimizer bytes differ from the live "
          "model's")
    gcfg = dataclasses.replace(get_config("gemma2_9b"), n_layers=2)
    rank = D.RankStandIn(("data", "model"), (1, 1))
    g = D.step_costs(gcfg, {"kind": "train", "global_batch": 1,
                            "seq_len": DATA_TRAIN_SEQ}, rank, torch.float32)
    calls = g["collectives"]["calls"]
    want = {k: calls[k] for k in calls57[0]}
    log(f"dry run of phase 57's step (gemma2-9B 2 layers, 1 x "
        f"{DATA_TRAIN_SEQ}, remat full) on a (1, 1) stand-in: collectives "
        f"{json.dumps(want)}; phase 57's steps on the NCCL (1, 1) mesh "
        f"counted {json.dumps(calls57)} (extents of 1: no spurious call on "
        f"either side, not a check of the counts at extents above 1); "
        f"{time.perf_counter() - t0:.3f} s for both dry runs [{card}]")
    check(all(c == want for c in calls57),
          "the dry run or phase 57 counted a collective the (1, 1) step "
          "does not make")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"error: {SRC / 'repro_torch'} not found: run chip_smoke.py "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false: chip_smoke.py "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from repro_torch.core import interface
    from repro_torch.core.csr import to_coo, to_ell
    from repro_torch.core.partition import balance, is_feasible
    from repro_torch.io.generators import barabasi_albert, grid2d
    from repro_torch.kernels import (attention, lp_affinity, pin_affinity,
                                     ref, ssd_scan)

    # -- 1. card, build -----------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()

    def timed_build(build):
        lib = build()
        return lib, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        builds = [pool.submit(timed_build, b)
                  for b in (lp_affinity.build, pin_affinity.build,
                            ssd_scan.build, attention.build)]
        for fut in builds:
            lib, secs = fut.result()
            log(f"built {lib.relative_to(ROOT)} in {secs:.3f} s")

    # -- 2. kernel vs plain version at the sweep shapes ------------------
    max_err = 0.0
    for (n_pad, dmax, k) in SWEEP:
        for b in (1, 4):
            for integer in (True, False):
                ins = affinity_inputs(torch, dev, n_pad, dmax, k, b, integer,
                                      seed=n_pad + dmax + k + b)
                max_err = max(max_err, compare(torch, *ins, k, integer))
    log(f"sweep: lp_affinity == affinity_ref at {len(SWEEP)} shapes x "
        f"B=1,4 x int/float weights (max |err| {max_err:g})")

    # -- 3. the main path at real size -------------------------------------
    rows = cols = 1024
    k_main = 16
    g = grid2d(rows, cols)
    log(f"graph grid2d({rows},{cols}): n={g.n} m={g.m}")
    cut, part, wall, launches, rec = run_kaffpa(torch, g, k_main,
                                                interface.ECO, 1, dev)
    feas = is_feasible(g, part, k_main, 0.03)
    ctr = rec.counters()
    spans = span_seconds(rec, ("hierarchy", "initial_tournament",
                               "uncoarsen"))
    log(f"main path kaffpa ECO k={k_main}: cut={cut} (geometric 4x4 cut "
        f"6144) balance={balance(g, part, k_main):.4f} feasible={feas} "
        f"wall_s={wall:.3f} levels={int(ctr.get('engine/levels', 0))} "
        f"launches={launches} view_builds="
        f"{int(ctr.get('engine/view_builds', 0))} spans_s="
        f"{json.dumps({n: round(s, 3) for n, s in spans.items()})}")
    check(feas, "main path partition infeasible")
    check(launches > 0, "main path never launched the lp_affinity kernel")
    main_launches = launches

    # -- 4. the same run on the plain path ---------------------------------
    cut2, part2, wall2, launches2, _ = run_kaffpa(
        torch, g, k_main, interface.ECO, 1, dev, use_kernel=False)
    log(f"plain path kaffpa ECO k={k_main}: cut={cut2} wall_s={wall2:.3f} "
        f"launches={launches2}")
    check(launches2 == 0, "use_kernel=False launched the kernel")
    check(np.array_equal(part, part2),
          "kernel path and plain path partitions differ")

    # -- 5. social preset: LP-clustering coarsening on the card -----------
    ba = barabasi_albert(65536, 4, seed=1)
    cut3, part3, wall3, launches3, rec3 = run_kaffpa(
        torch, ba, 8, interface.ECOSOCIAL, 1, dev)
    feas3 = is_feasible(ba, part3, 8, 0.03)
    log(f"social path kaffpa ECOSOCIAL barabasi_albert(65536,4) k=8: "
        f"cut={cut3} balance={balance(ba, part3, 8):.4f} feasible={feas3} "
        f"wall_s={wall3:.3f} levels="
        f"{int(rec3.counters().get('engine/levels', 0))} "
        f"launches={launches3}")
    check(feas3, "ECOSOCIAL partition infeasible")
    check(launches3 > 0, "ECOSOCIAL run never launched the kernel")

    # -- 6. the kernel at the main path's level-0 shape -------------------
    coo = to_coo(g, device=dev)
    ell = to_ell(g, row_tile=coo.n_pad, device=dev)
    n_pad, dmax = ell.nbr.shape
    lab1 = torch.zeros(1, n_pad, dtype=torch.int32, device=dev)
    lab1[0, :g.n] = torch.from_numpy(part.astype(np.int32)).to(dev)
    rows_out = {}
    for b in (1, 4):
        labels = lab1.expand(b, -1).contiguous()
        if b > 1:      # other rows: other candidate partitions
            gen = torch.Generator(device=dev).manual_seed(b)
            labels[1:] = torch.randint(0, k_main, (b - 1, n_pad),
                                       generator=gen, device=dev,
                                       dtype=torch.int32)
        max_err = max(max_err, compare(torch, ell.nbr, ell.wgt, labels,
                                       k_main, integer=True))
        fnbr, fwgt, flab = affinity_inputs(torch, dev, n_pad, dmax, k_main,
                                           b, integer=False, seed=7 + b)
        max_err = max(max_err, compare(torch, fnbr, fwgt, flab, k_main,
                                       integer=False))
        nbr_l = ell.nbr.long()

        def library():
            return torch.zeros(b, n_pad, k_main, device=dev).scatter_add_(
                2, labels.long()[:, nbr_l], ell.wgt.expand(b, -1, -1))

        check(torch.equal(library(), lp_affinity.affinity_cuda(
            ell.nbr, ell.wgt, labels, k_main)), "scatter_add_ yardstick "
              "disagrees with the kernel")
        ms = cuda_ms(torch, lambda: lp_affinity.affinity_cuda(
            ell.nbr, ell.wgt, labels, k_main))
        plain_ms = cuda_ms(torch, lambda: ref.affinity_ref(
            ell.nbr, ell.wgt, labels, k_main), iters=5)
        library_ms = cuda_ms(torch, library, iters=5)
        # what the function must move: the whole weight array (it marks
        # the live slots), the neighbour ids of live slots only, the labels
        # and the output
        live = int((ell.wgt != 0).sum())
        nbytes = (ell.wgt.numel() * 4 + live * 4 + labels.numel() * 4
                  + b * n_pad * k_main * 4)
        bms, by = bound_ms(nbytes, b * live)
        rows_out[b] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bms, bound_by=by)
        log(f"lp_affinity B={b} n_pad={n_pad} dmax={dmax} k={k_main}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, scatter_add_ "
            f"{library_ms:.4f} ms, bound {bms:.4f} ms ({nbytes} bytes "
            f"at {PEAK_BYTES_PER_S / 1e12} TB/s) [{card}]")

    main = rows_out[1]    # level-0 refinement launches one row
    pin_row, kahypar_km1 = kahypar_phases(torch, np, dev, card)
    ssd_rows, hybrid_attention = zamba2_phases(torch, np, dev, card)
    sep_row, ep_replication = nodesep_phases(torch, np, dev, card)
    paths = memetic_phases(torch, np, dev, card)
    dpaths = distributed_phases(torch, np, dev, card, cut, kahypar_km1,
                                ep_replication)
    dec = decoder_phases(torch, np, dev, card)
    trn = train_phases(torch, np, dev, card)
    calls57 = mesh_phases(torch, np, dev, card)
    rec_launches, rec_err = formats_phase(torch, np, g, part, dev, card)
    analysis_phase(torch, np, dev, card)
    dryrun_phase(torch, np, dev, card, trn["train45"], calls57)
    attn_rows = attention_phase(torch, np, dev, card)
    # each cell's attention row counts its model's main path: phase 35's
    # minicpm forward and phase 13's hybrid forward
    for row, counts in zip(attn_rows, (dec["minicpm_attention"],
                                       hybrid_attention)):
        row["launches"] = counts["launches"]
    # the launches of the memetic slice's paths, each counted from 0 around
    # its own run (phases 23, 25-28), beside the main path's; lp_affinity's
    # count on a path includes the launches it made as sep_affinity
    pin_row["launches_by_path"] = {"kahyparE": paths["kahyparE"],
                                   "parhyp": dpaths["parhyp"],
                                   "traffic_kahypar": dec["traffic_kahypar"]}
    pin_row["per_shard"] = dpaths["per_shard"]
    sep_row["launches_by_path"] = {
        "memetic_separator": paths["memetic_separator"]}
    errs = paths["errors"]
    derrs = dpaths["errors"]
    max_err = max(max_err, errs["lp_affinity"], derrs["lp_affinity"],
                  dec["errors"]["lp_affinity"], trn["errors"]["lp_affinity"],
                  rec_err)
    pin_row["max_abs_err"] = max(pin_row["max_abs_err"], errs["pin_count"],
                                 derrs["pin_count"],
                                 dec["errors"]["pin_count"])
    sep_row["max_abs_err"] = max(sep_row["max_abs_err"],
                                 errs["sep_affinity"])
    log(json.dumps({"kernels": [{
        "name": "lp_affinity", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lp_affinity.cu",
        "replaces": "src/repro/kernels/lp_affinity.py:30",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": [1, n_pad, dmax, k_main],
        "launches_by_path": {
            "kaffpaE": paths["kaffpaE"], "kabapeE": paths["kabapeE"],
            "kabape_gain_matrix": paths["kabape_gain_matrix"],
            "kahyparE": paths["kahyparE_lp_affinity"],
            "memetic_separator": paths["memetic_separator_lp_affinity"],
            "process_mapping": paths["process_mapping"],
            "parhip": dpaths["parhip"],
            "parhip_social": dpaths["parhip_social"],
            "distributed_edge_partition": dpaths[
                "distributed_edge_partition"],
            "expert_placement": dec["expert_placement"],
            "partition_layers": trn["partition_layers"],
            "kaffpa_recorded": rec_launches}},
        pin_row, *ssd_rows, sep_row,
        *({"name": "attention_fwd", "route": "cuda", "cell": cell,
           "source": "src/repro_torch/kernels/csrc/attention_fwd.cu",
           "replaces": None, **row}
          for cell, row in zip(ATTN_SHAPES, attn_rows))]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
