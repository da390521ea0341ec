#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end, and check
it: the flow-level simulator, the analytic arc-load engines behind its
reference theta, the serving and training paths of smollm-135m and
mamba2-130m, the paper's topology families and fault model, its cost
model and analytic tools (the orbit shortcut, Tables 2-6, the
adversarial table), the fabric layer (placement, the planner, a placed
job's simulation), observability, the serving path of the MoE, MLA
and RG-LRU families (granite-moe-3b-a800m at full width), that of
the memory-input families (seamless-m4t-large-v2 at full width), and
the training of both (granite and seamless at full width), the
training of mamba2-130m at full width through the SSD's backward, the
``REPRO_PERF`` flags that act on one card, heads of 256:
recurrentgemma-9b served at full width and depth and trained at full
width, and the mesh layer: rank 0's share of a production-mesh train
step on the card, whose collective bytes feed the fabric planner, for
the dense, SSM and MoE families (MLA included), under the
``microbatch`` flag and ``grad_compress`` too.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of the CUDA kernels from ``src/repro_torch/
   kernels/csrc`` into ``build/torch_ext/``.
2. The simulator-step kernels against their plain PyTorch versions on
   the card, on the real PN(27) route tables: ``fused_step_update`` at
   the VC1 width (1514) and the compacted VC0 width (757) with dead
   tiles, float64 at rtol 1e-12 and float32 at rtol 1e-5 of the max;
   ``fused_decision`` in float64 with thr 0 and 16, identical wherever
   the comparison is clear of rounding (|lhs - rhs| > 1e-9 of the
   scale).  Then each kernel's time, its plain version's time and its
   HBM bound at the main path's shapes.
3. The mask+GEMM kernels (``frontier_step``, ``backward_step``) against
   their plain versions on the card, at PN(27) (S = N = 1514) and on the
   first PN(64) source block (S = 756, N = 8322): every BFS level and
   dependency level of the real sweep, plus random integer fronts up to
   2^20; float64 at rtol 1e-12 and float32 at rtol 1e-6 of the max,
   ``dist'`` and the any-new flag exactly, and every output bit for bit
   the tiled mirror of the kernels' summation order
   (``ref.*_step_tiled_ref`` at the plan's chunk).  Then S = 37 rows of
   N = 30,011 float64, too long for a block's shared memory (the chunked
   route), against both.  Then, at level 2 and at the deepest dependency
   level, a repeated launch bit for bit and each kernel's time beside
   its plain version's, the dense ``torch.matmul`` and
   ``torch.sparse.mm`` on the CSR of A^T (cuSPARSE on the same sparse
   storage; two yardsticks without the epilogue, which the port never
   calls) and the HBM bound; and every level of the PN(64) block by CUDA
   events, summed per source block (printed again beside phase 5's
   profile).
4. The analytic main path: ``saturation_report`` of PN(16) uniform and of
   the PN(27) points demand under ``ugal`` on the fused kernels, the
   exact engine that ``auto`` resolves to on the card (``engine=
   "fused"``: both demands are uniform-shaped, so ``auto`` would take
   the orbit shortcut of phase 19), each within rtol 1e-9 of the
   reference's value recorded below; launch counts zeroed just before
   and read just after (4 frontier and 3 backward launches per source
   block and sweep).
5. Full width for the analytic engines, PN(64) (8322 routers, degree
   65): ``utilization`` on the fused engine (u = 1 within 1e-12, kbar =
   20673/8321 and sum(loads) = kbar x pairs at rtol 1e-12) and where its
   device time goes (torch.profiler, by kernel, and the idle share), then
   ``saturation_report`` of ``random_permutation(0)`` under ``ugal`` on
   the fused and on the dense engine, loads within rtol 1e-9; seconds
   per sweep and peak device memory.
6. PN(16) uniform under ugal_threshold(0): 24 steps on the fused float32
   step and on the dense float64 step, both on the card, delivered
   histories within 1e-5; then a saturation sweep whose knee must land
   within 0.025 of phase 4's analytic theta.
7. The simulator's main path at full width: PN(27) (1514 routers), every
   source to the 757 points, ugal_threshold(0), ``backend="auto"`` (must
   resolve to the fused step on 757 compacted columns), theta from phase
   4.  Kernel launch counts are zeroed just before the sweep and read
   just after; the knee must land within 0.025 of the analytic theta
   with every probe's residual <= 1e-4.  The sweep then runs again with
   ``theta_analytic=None``, so that it computes its own theta through
   the mask+GEMM kernels, and must land within 0.025 of it too.  One
   probe runs twice and must repeat bitwise.
8. Where a PN(27) step's device time goes: torch.profiler over a short
   run, device time per step by kernel and the device's idle share.
9. The flash-attention forward (kernel #5) against its plain version on
   the card: smollm's serve shape (B=1, Hq=9, Hkv=3, D=64, bf16, causal,
   S = 1000 and 2048), a window, a q_offset, float32, non-causal, MQA and
   D = 32 / 128 cases in both dtypes and a head of 16 (zero-padded to 32)
   in bf16, ragged lengths throughout; bf16 runs the tensor-core kernel,
   float32 the CUDA-core one.  float32 at 3e-5, bf16 within one bf16
   rounding (1e-4 + 2^-7 |o|) and equal to the plain float32 o rounded to
   bf16 in at least SAME_SHARE of the entries, the log-sum-exp at 3e-5.
   At S = 2048 the plain version with p cast to one bf16 (no three-way
   split) must fail that share.  Then its time at S = 2048 beside SDPA's
   (``scaled_dot_product_attention(..., is_causal=True,
   enable_gqa=True)`` in bf16, the yardstick; the port never calls it)
   and its bound (see phase 14): bytes at the HBM rate against Q K^T
   and P.V on the bf16 tensor cores, P.V three times.
10. The SSD chunked scan (kernel #8) against its plain version at
    mamba2's serve shape (B=1, H=24, P=64, G=1, N=128, chunk 256, L =
    1000, 2048 and 300): y and the final state at 3e-4 with float32
    operands (the CUDA-core kernel); with bf16 x, B, C (the tensor-core
    kernels) the state at 3e-4, y within one bf16 rounding and equal to
    the plain float32 y rounded to bf16 in at least SAME_SHARE of the
    entries.  At L = 2048 the plain three-phase mirror with the scores,
    x dt w and S_in cast to one bf16 must fail that share and the state's
    3e-4.  An initial state, G = 2, chunk 64 and heads of 16 in both
    dtypes.  Then its time at L = 2048 and its bound (C B^T once per
    chunk and group, the products with one float32 operand, dt folded
    into the float32 scores, three times on the bf16 tensor cores).
11. smollm-135m at full width (30 x 576, vocab 49152, random weights
    from a seeded torch.Generator) served through ``Engine.run``: 8
    requests of 256-1536 prompt tokens (drawn from a seed), 32 new
    tokens each, batches of 4, 2048 cache slots.  Kernel #5 must launch
    exactly 30 times per request around ``Engine.run`` alone; every
    emitted token must lie within 0.05 of the max logit of a solo
    teacher-forced run on the card, whose logits must be finite.  Prints
    prefill ms per request (each, in serving order), ms per batched
    decode step, tokens/s and peak device memory; then serves the same
    requests again through a new Engine, so that the first run's
    first-call costs show beside a warm run's.
12. mamba2-130m at full width (24 x 768, 24 heads of 64, d_state 128,
    chunk 256), the same traffic and checks; kernel #8 must launch
    exactly 24 times per request, and the SSD states must be finite.
13. Where smollm's device time goes: torch.profiler over one 1536-token
    prefill and over 8 batched decode steps at batch 4.
14. The flash-attention backward kernels, #6 (dq) and #7 (dk, dv per q
    head), against their plain versions on the card: smollm's training
    shape (B=8, Hq=9, Hkv=3, S=2048, D=64, causal), a window, MQA, D =
    32 and 128, non-causal and ragged lengths, each in bf16 (the
    tensor-core kernels) and float32 (the CUDA-core kernels); float32 dq
    at 2e-5, bf16 dq within one bf16 rounding (1e-4 + 2^-7 |dq|) and
    equal to the plain float32 dq rounded to bf16 in at least 0.95 of
    its entries, the float32 per-head dk, dv at 2e-4 + 2e-5 |d|; and the
    whole backward with a zero-padded head of 16 in both dtypes (bf16
    outputs within one bf16 rounding).  At the training shape the plain
    recompute with p and ds cast to one bf16 each (no three-way split)
    must fail those checks.  Then each kernel's time at the training
    shape by CUDA events and by device time (torch.profiler, which must
    record every launch), its plain version's, its bound and the
    backward of ``scaled_dot_product_attention`` at the same shape,
    timed both ways (the yardstick of #6 and #7 together; the port never
    calls it); and #5 beside SDPA's forward at that shape.  A bound is the least time for the work at float32
    precision: the bytes at the HBM rate against the products on the
    bf16 tensor cores at 989 TFLOP/s, a product with one float32 operand
    counted three times (the exact three-way bf16 split of that
    operand).  Last, the HGMMA (wgmma) instructions, registers and stack
    of each bf16 instantiation of #5, #6, #7 (D = 32, 64, 128) and of
    #8's two product kernels (N = 64, 128, 256) in the built library
    (``cuobjdump``, where the toolkit has it): no HGMMA raises.
15. smollm-135m trained at full width (30 x 576, vocab 49152, weights
    from a seeded torch.Generator) through ``launch.train.train``: 8
    steps of 8 x 2048 tokens of the reference's synthetic data (seed 0),
    the launcher's cosine schedule at lr 1e-3.  Launches counted around
    the run: exactly 60 of #5, 30 of #6 and 30 of #7 per step (remat
    recomputes each forward); every loss finite, the first within 0.5 of
    ln 49152, the last below the first.  Then a run with checkpoints
    every 4 steps that crashes at step 6 and resumes: its last loss
    equals the uncrashed run's at rtol 1e-4.  Then one step of the same
    model cut to 4 layers at B=1, S=256 on the card and on the CPU from
    the same weights: loss within 5e-3 and global gradient norm within
    1e-2 relative.  Prints ms per warm step, tokens/s, peak memory, and
    one step under torch.profiler: the idle share and the shares of #5,
    #6 and #7.

16. The paper's comparison on the card, every graph built by the port
    itself (no ``convert``): ``saturation_report`` of ``uniform`` under
    ``minimal`` and ``ugal`` on demi-PN(16), OFT(4), the 8 x 16 torus
    and dragonfly(3) on the fused all-source path (``engine="fused"``),
    each theta within rtol 1e-9 of the reference's
    value recorded below, #3 / #4 launched in whole sweeps of the
    graph's depth (its sources' largest BFS distance); at full width,
    demi-PN(64) (4161 routers), OFT(27) (2271) and the 16^3 torus (4096,
    diameter 24), fused against dense on the card, loads within rtol
    1e-9, OFT's u = 1 and kbar = 2; then the simulator on three rows of
    ``benchmarks/sim_bench.py::SIM_CASES`` with their own parameters on
    the fused step, each knee within 0.025 of the analytic theta, 3
    launches of #1 and one of #2 (ugal) a step.
17. The fault model, analytic, on the card: the ten degradation rows of
    ``BENCH_6.json`` (five graphs x minimal / ugal, k = 0, 1, 2, 5 dead
    links, 4 trials, seed 0; ``engine="fused"``, so that the pristine
    report runs all sources), every mean, worst, best, p10, p50 and p90
    within 1e-6 of the recorded six digits, the curves non-increasing,
    #3 / #4 launched for every sweep at least as deep as the pristine
    graph's;
    ``degraded_report`` of PN(64) with ``random_faults(k_links=5,
    seed=0)``, minimal and ugal, fused against dense within rtol 1e-9 and
    below the pristine theta; one ``targeted_faults`` round on PN(27) at
    least as damaging as the random mean.
18. Faults in the simulator, on the fused step: BENCH_6's live row
    (the 8 x 16 torus, minimal, two dead links) as a static knee (event
    at step 0) and a mid-run knee (event at step 259 of 648), within
    0.025 of each other and of BENCH_6's static knee; phase 7's PN(27)
    instance with five dead links, static and mid-run (event at step 16
    of 40), knee gap at most 0.025, every probe's residual at most 1e-4
    with the dropped fluid counted, #1 and #2 launched 3 and 1 times a
    step; a faulted probe repeated bitwise; a point router of PN(27)
    dying mid-run, its fluid dropped, counted and conserved.
19. The orbit shortcut on the card: ``utilization`` of PN(64),
    demi-PN(64) and OFT(27) (leaf mask) with ``engine="orbit"`` and the
    default ``auto``, one sweep per used vertex orbit (S = 1; #3 launched
    ecc + 1 and #4 ecc times per orbit), loads within rtol 1e-9 of the
    fused all-source sweep (phase 5's for PN(64)), kbar and diameter
    exact, PN(64) u = 1 within 1e-12 and kbar = 20673/8321, OFT u = 1
    and kbar = 2; ``orbit_info``'s host time printed apart from the
    sweep.  #3 and #4 at S = 1 at every level of a PN(64) sweep and of an
    OFT(27) leaf-restricted sweep, bit for bit the tiled mirror.  Then
    the paper's Tables 2-6 and Fig. 6 through ``repro_torch.
    paper_tables`` on the card: each ``max_rel_err`` within 1e-9
    relative of BENCH_2's (Fig. 6: the reference's), every row's T, R,
    N, Delta0, cables, $ and W (Table 2: N, diameter, kbar, u) equal to
    the reference's rows recorded below.
20. The adversarial table (``adversarial_report``, 8 sampled
    permutations, seed 0, minimal / valiant / ugal): BENCH_3's six cases
    under the default engine, every theta, kbar_eff and alpha within
    rtol 1e-9 of ``BENCH_3.json``, worst patterns and ``realized_by``
    equal by name or, where a name differs, tied (the port's report of
    BENCH_3's pick within 1e-9 of BENCH_3's numbers), and BENCH_3's
    identities (theta_ugal >= max(theta_minimal, theta_valiant), equal
    to theta_minimal on uniform) within 1e-9; Table 5's ~25k-terminal
    line-up at full width, PN(31), demi-PN(37) and dragonfly(9), fused
    against dense the same way, with one report profiled; and
    ``worst_case(PN(31), "ugal", faults=random_faults(k_links=5,
    seed=0))`` under auto, fused and dense within 1e-9, never taking the
    orbit path.
21. The fabric layer (``repro_torch.fabric``, ``sim.simulate_placement``,
    ``placement_tables``): BENCH_4's four cases through
    ``placement_one`` on the fused engine, every row held against
    ``BENCH_4.json`` (theta and u within 1e-6 of the six recorded digits,
    max_bytes and alpha at rtol 1e-9, best, beats_linear and max_rel_err
    as recorded; a greedy_swap(30) row that differs passes only if its
    descent parts from the reference's on a tie within 1e-9).  At full
    width, PN(31) as the planner sizes it for Table 5 (1,986 routers,
    delta0 13, 25,818 terminals) with an 8,192-chip (16, 512) job under
    both profiles: ``placement_search`` fused, the geometric strategies'
    theta, u and kbar_eff within 1e-9 of the dense engine and of the
    reference's values recorded below, greedy_swap(30) never below
    group; ``fragmentation_sweep`` of two such jobs under tornado within
    1e-9 of the reference, packed >= interleaved; ``plan`` at 25,000
    terminals with its placement and resilience columns, every row
    printed and equal to the reference's (before rounding within 1e-9;
    a greedy-layout row's dollars by the seed-order fingerprint),
    ranking equal; ``simulate_placement`` of the group placement on the
    fused step (every residual <= 1e-4; #1 3 launches a step, #2 one
    under ugal) sustaining 0.9x the analytic theta (delivered / offered
    > 0.99) under minimal routing and under ``ugal_threshold(0)``
    (float32 against float64 within 1e-4), and under
    ``ugal_threshold(0)`` at the default 1.2x delivering at most what is
    offered; and one greedy_swap(30) descent
    under the profiler (wall, device time, idle share, host-to-device
    copies, #3 / #4 per objective evaluation).
22. Observability on the card (``repro_torch.obs``): phase 7's PN(27)
    sweep with no session, under ``session("metrics")`` and under
    ``session("trace")`` with series, a flight recorder and a
    ``continue`` watchdog (residual, nonfinite, step_time): every SimRun
    field and history bit for bit equal across the three, the
    ``sim.injected`` / ``delivered`` / ``accepted`` / ``diverted`` /
    ``dropped`` counters equal to the runs' own sums bit for bit, #1 / #2
    3 and 1 launches a step in all three, and one 30-step run profiled
    each way: no session and ``metrics`` make the same host copies, the
    monitor one more read a step; wall per step of each way.  A PN(27)
    run at twice the analytic theta halted by a ``dest_stability``
    watchdog: its bundle, written under ``build/obs_smoke/`` and
    reloaded, holds a recorder window equal to the run's history bit for
    bit.  Phase 21's full-width greedy_swap(30) descent under
    ``metrics``: ``placement.swap_evals`` equal to the history's
    evaluations less the start, ``util.dispatch[fused]`` equal to the
    #3 / #4 source blocks (#3 less #4 launches), three an evaluation.
    Then three smollm-135m train steps (phase 15's shape) and a full-width
    ``launch.serve.serve`` under ``session("trace")``: one
    ``train.step`` span a step and one ``serve.run`` span, each at least
    the CUDA-event time of its own work; a Chrome trace and an HTML
    report written to ``build/obs_smoke/``, their sizes printed.
23. The MoE, MLA and RG-LRU families on the serving path.  First #5 at
    their shapes against its plain version, bf16 at S = 1536 within phase
    9's 1e-4 + 2^-7 |o| and SAME_SHARE: granite-moe's full-width layer
    (Hq 24, Hkv 8, D 64), and deepseek reduced's MLA (Hq = Hkv = 4, q/k
    32, v 16) through ``ops.attention``, held against the plain version
    on the zero-padded v cut back to 16.  A: one
    full-width granite-moe-3b-a800m MoE layer (40 experts top-8, d_model
    1536, expert width 512) on random bf16 inputs at T = 1536 and T = 4:
    the port's route (bins of T rows per expert, three batched products,
    the k picks weighted and summed in float32) within one bf16 rounding
    (1e-4 + 2^-7 |y|) of ``ref.moe_dense_ref`` (the reference's dense
    path) weighting and summing in float32, a repeated call bit for bit,
    both timed by CUDA events.  B:
    granite-moe-3b-a800m at full width (32 x 1536, 24 q / 8 kv heads of
    64, vocab 49155, 3.37B float32 parameters from a seeded generator)
    served as phase 11 serves smollm: #5 exactly 32 times per request
    (256) inside ``Engine.run``, every emitted token within 0.05 of the
    solo teacher-forced max logit, tok/s, prefill ms, decode ms per
    step, peak memory and a warm run (the device time of a prefill and
    a decode step stands in PERF.md; their profiles are left out to pay
    for phase 33).  C: deepseek-v3-671b
    (MLA through #5 with v zero-padded from 16 to 32, a shared expert, a
    dense first layer) and recurrentgemma-9b (two RG-LRU layers and one
    MQA layer of window 64 on a 64-slot ring cache) at ``reduced()``,
    served the same way: #5 3 and 1 times per request.  #5's launches in
    the three ``Engine.run`` calls go under its ``phase_launches``.
24. The memory-input families on the serving path.  A: #5 in bf16,
    non-causal, against its plain version (phase 9's 1e-4 + 2^-7 |o|,
    SAME_SHARE, lse at 3e-5) at seamless-m4t-large-v2's encoder shape
    (B=1, 16 / 16 heads of 64, Sq = Skv = 384 frames), its cross prefill
    (Sq 1536, Skv 384), its cross decode step (B=4, Sq = 1) and one
    full-width llama-3.2-vision-90b cross layer (64 / 8 heads of 128, Sq
    1536, Skv 1600), each timed by CUDA events beside its plain version,
    SDPA's forward and its bound.  B: seamless-m4t-large-v2 at full
    width (24 encoder and 24 decoder layers x 1024, vocab 256,206, 1.63B
    float32 parameters from a seeded generator, every cross gate set to
    1.0: zero, as initialised, would shut the memory out) served with
    phase 11's traffic and one memory of 384 frames drawn by
    ``data.pipeline.synthetic_batch``: #5 exactly 2064 times inside
    ``Engine.run`` (72 a request: 24 encoder, 24 self, 24 cross; 24 a
    decode step), every emitted token within 0.05 of the solo
    teacher-forced max logit, a second memory draw moving the first
    request's last prefill logits by more than 0.05, tok/s, prefill ms,
    decode ms per step, peak memory and a warm run (its profiles left
    out, as phase 23's).  C:
    llama-3.2-vision-90b at ``reduced()`` with 10 layers (cross layers 4
    and 9) and 16 image tokens, gates at 1.0, served the same way: #5
    exactly 204 times (10 a request, 2 a decode step).  #5's launches in
    the two ``Engine.run`` calls go under its ``phase_launches``.

25. Training of the MoE, MLA + MTP, RG-LRU and memory-input families.
    A: #6 and #7 in bf16 against their plain versions at the new training
    shapes, to phase 14's limits, each timed by CUDA events and by device
    time beside its plain version, SDPA's backward and its bound:
    seamless-m4t-large-v2's cross layer with a ragged memory (16 / 16
    heads of 64, Sq 1500, Skv 375), its encoder (384 x 384), one
    full-width llama-3.2-vision-90b cross layer (64 / 8 heads of 128,
    1536 x 1600), all non-causal, and deepseek-v3 reduced's MLA (q/k 32,
    v 16 zero-padded to 32, causal), whose backward through
    ``ops.attention`` must give the kernels' dq, dk and dv cut to 16 bit
    for bit.  B: granite-moe-3b-a800m at full width (3.37B float32
    parameters, a 54 GB train state) through ``launch.train.train``: a
    donating step, B=2, S=2048, 6 steps of AdamW with the cosine
    schedule, #5 / #6 / #7 exactly 64 / 32 / 32 times a step, finite
    losses (the first within 0.5 of ln 49155, the last below it), peak
    memory under 80 GB; ms a step, tokens/s, model FLOP/s (6 N_active
    D), the idle share and leading device operations of one profiled
    step.  At 2 layers: a step on the card against the CPU (B=1, S=256;
    loss within 5e-3, grad norm within 1e-2) and a donated step against
    a non-donated one, bit for bit.  C: seamless-m4t-large-v2 at full
    width through the ``Trainer`` with the pipeline's frame embeddings
    (B=2, S=1536, 384 frames, gates at 1.0), 6 steps, #5 / #6 / #7
    exactly 144 / 72 / 72 a step, the loss rule, a second memory draw
    moving the first step's loss by more than 1e-3, the same records as
    B.  D: deepseek-v3 (MLA, MoE, MTP; bf16 weights and moments),
    recurrentgemma (window 64) and llama-3.2-vision (10 layers, 16 image
    tokens, gates at 1.0, through the ``Trainer``) at ``reduced()``, B=8,
    S=256, 4 steps each with exact launches and the loss rule; granite
    reduced crashed at step 6 and resumed, its last loss within rtol
    1e-4 of an uncrashed run's.  #5-#7's launches in B-D go under their
    ``phase_launches``.
26. Training through the SSD.  A: the SSD scan's backward
    (``ssd_scan_bwd``; bf16 operands: the tensor-core kernels of
    ``ssd_scan_bwd.cu``, float32: the CUDA-core kernels of
    ``ssd_scan_bwd_fma.cu``) against its plain version at phase 10's
    shapes (H 24, P 64, G 1, N 128, chunk 256, L = 1000, 2048 and 300, B
    = 1, and B = 8 at L = 2048) and at mamba2's reduced widths (P, N 16,
    chunk 32, padded by the bf16 route), both dtypes, with and without an
    initial state and final-state gradient: every gradient within 3e-4
    (float32) or 2^-7 (bf16) of its leaf's largest magnitude, d a_log and
    ddt within 1e-5, the bf16 route within 1e-5 of
    ``ssd_scan_bwd_ref(terms=3)``, a repeat bit for bit; the bf16 route's
    time by CUDA events and by device time, launch by launch, at B = 1
    and 8, L = 2048, beside its plain version's and its bound (no
    PyTorch call computes it), and the float32 route's device time.  B:
    mamba2-130m at full width through ``launch.train.train`` in phase
    15's cell (8 steps of 8 x 2048 tokens, a checkpoint every 4): #8 and
    its backward exactly 48 and 24 times a step, phase 15's loss rule,
    ms a step, tokens/s, peak memory, a profiled step's device time and
    idle share; crashed at step 6 and resumed, the last loss within rtol
    1e-4 of the uncrashed run's.  C: at 2 layers, B=1, S=256, a step on
    the card against the CPU (loss within 5e-3, grad norm within 1e-2)
    and a donated step against a non-donated one, bit for bit.  #8's
    launches go under its ``phase_launches``; its backward's main-path
    count is B's uncrashed run.
27. The ``REPRO_PERF`` flags (``repro_torch.perf``), each set through
    ``set_flags`` and restored after its part.  A: #5-#7 under
    ``prob_bf16`` (#5's and #7's variants; #6 on the variant's o and
    lse) against their plain versions at smollm's shapes (B 1 and 8, S
    2048, causal), a windowed case and seamless's ragged cross shape
    (non-causal): o, dq, dk, dv within 2^-7 of each leaf's largest
    magnitude, lse within 1e-5 of the default variant's (D = 64), a
    repeat bit for bit; #5 at B 1 and 8 and #7 at B 8 timed by CUDA
    events and device time beside the default variants', their bounds
    and SDPA's forward and backward.  B: #8 and 8' at chunks 64 and 128
    at the mamba2 layer (B 1 and 8, L 2048, bf16) under phase 10's and
    26's rules, repeated bit for bit; device times at chunks 64, 128 and
    256 and the bounds.  C: smollm-135m under ``prob_bf16,gqa_grouped``
    served as in phase 11 (30 launches of #5 a request, the emitted-token
    rule against solo runs under the same flags) and trained 3 steps of
    8 x 2048 (60 / 30 / 30 a step, phase 15's loss rule); mamba2-130m at
    ``ssd_chunk=128`` trained 3 steps (48 / 24 a step, every scan at
    chunk 128, its first loss within 1e-3 relative of phase 26's at
    chunk 256); at ``microbatch=2`` and at 1, 2 steps each at full width:
    smollm-135m (8 x 2048) with its losses within rel 2e-4, and
    granite-moe-3b-a800m (2 x 2048, ``PERF_MB_MOE_LAYERS`` = 8 of its 32
    layers) with the first step's cross-entropy
    within rel 2e-4 (its router aux loss is per microbatch, as in the
    reference, so its losses differ and are logged), peak memory under
    80 GB, ms a step.  D: ``obs=metrics`` and ``util_engine=dense``
    as the defaults of an engine-less session and ``utilization(PN(16))``
    (loads equal to ``engine="dense"``'s), ``sim_backend=fused`` as the
    step a default-config PN(16) ``Simulator`` picks (bit for bit an
    explicit one).  The launches of C and D go under ``phase_launches``;
    the rows of A and B beside #5's, #7's, #8's and 8''s in the
    ``kernels`` line (``prob_bf16``, ``chunks``).
28. Head size 256 (#5-#7's D = 256 instantiations).  A: #5, #6 and #7,
    default and ``prob_bf16`` variants, against their plain versions
    under phases 9, 14 and 27's rules, each launch repeated bit for bit:
    a recurrentgemma-9b attention layer as served (B 1, 16 q heads over
    one kv head, S 1536, window 2048) and as trained (S 4096: the
    window's edge crosses the tiles), a ragged shape with a q_offset and
    a window, and a full-width deepseek-v3 MLA layer (128 heads, q/k 192
    and v 128 zero-padded to 256, S 2048) whose backward through
    ``ops.attention`` gives the kernels' gradients cut back, bit for bit.
    Each kernel's time by CUDA events and device time, its plain
    version's, its bound at the caller's widths, its registers and stack
    from the build, and SDPA's forward and backward on the unpadded
    inputs (the leading kernel names the backend).  B: recurrentgemma-9b
    at full width and depth (38 layers, 10.44B float32 parameters)
    served as phase 11 serves smollm: #5 exactly 12 times a request (96),
    every token within 0.05 of the solo teacher-forced max logit or, on
    a near-tie, the solo run's second choice with its top two within
    2^-4 (logged and counted), peak memory, prefill and decode ms (the
    device time of its prefill and decode step stands in PERF.md; their
    profiles are left out to pay for phase 33).  C:
    recurrentgemma-9b at full width cut to 3 layers (2.75B parameters)
    through ``launch.train.train`` (B 1 x S 4096, window 2048, 4 donated
    steps, remat, AdamW): #5 / #6 / #7 exactly 2 / 1 / 1 a step, phase
    15's loss rule, peak under 80 GB, ms a step, tokens/s.  D: one step
    of its ``reduced()``
    config with heads of 256 on the card against the CPU (loss within
    5e-3, grad norm within 1e-2) and donated against kept, bit for bit.
    B-D's launches go under ``phase_launches``; A's rows beside #5-#7's
    in the ``kernels`` line (``head256``).
29. The mesh layer: rank 0's share of a production-mesh train step on
    the card (``repro_torch.launch.dryrun.lower_cell``: a fake process
    group of 256 ranks, the (16, 16) ("data", "model") mesh, the local
    blocks of the state placed directly, every collective counted and
    none carried).  A: smollm-135m ``train_4k`` on ``pod1`` (16 rows x
    4096 tokens a device; 9 q and 3 kv heads replicate, vocabulary and
    ff split 16 ways): #5 (forward and recompute), #6 and #7 launched,
    the record's bytes by kind and by (phase, axis), FLOPs, peak memory
    and wall time; the data-parallel gradient all-reduce exactly
    133,293,312 B (the float32 gradients of the 33,323,328 local
    parameters).  The values of the step are garbage (the fake group
    carries nothing), so each cell's kernels are held apart at its own
    local problem (the record's ``kernel_problems``) on fresh seeded
    inputs: #5-#7 through ``models.layers.attention_block`` (the
    kernel call of ``local_attention``, with its cut of k and v) forward
    and backward, bit for bit the kernels' own, o, lse, dq and dk / dv
    against the plain versions on k and v picked by the global group
    map, to phases 9 and 14's limits.  B: the same cell with ``zero1``:
    the all-reduce, reduce-scatter and all-gather bytes and the ratio of
    the totals (logged beside the reference's claim that the bytes
    halve; not a gate).  C: h2o-danube-3-4b (``fsdp``, sequence parallel; 2 of 32 q
    heads a device, the 8 kv heads replicated): the per-layer weight
    all-gathers and gradient reduce-scatters over ``data``, the
    data-parallel all-reduce exactly 752,640 B; #5-#7 held as in A at
    model ranks 0, 5 and 15 (kv heads 0, 2 and 7; D 120 padded to 128).
    D: mamba2-130m: #8 (forward and recompute) and 8' launched, the
    data-parallel all-reduce exactly 408,820,992 B; #8 and 8' held at
    the local problem through ``ops.ssd`` (bit for bit the kernels'),
    y and the state to phase 10's limits, the gradients to phase 26's.
    E: ``fabric.plan`` on A's record (``StepProfile.from_dryrun``, 256
    terminals, the (16, 16) mesh placed), which runs #3 and #4; its top
    rows.  F: ``train.remesh``
    and ``reshard_state`` on a (1, 1) mesh of the card (a one-rank NCCL
    group): a state's round trip bit for bit.  Every launch goes under
    ``phase_launches``; the phase logs its time.
30. The MoE all-to-all dispatch and MLA under the production mesh, as
    phase 29 runs its cells.  A: granite-moe-3b-a800m ``train_4k`` on
    ``pod1`` at full width and depth under the default flags
    (``moe_3d``: the tokens enter the all-to-all body in the residual's
    layout; 16 x 256 = 4096 tokens a device, C = 1024, 40 experts padded
    to 48): the all-to-all bytes exactly 32 x 6 x 48 x 1024 x 1536 x 2 =
    28,991,029,248, all over ``model`` in the loss phase; the
    data-parallel gradient all-reduce exactly the local gradients not
    sharded over ``data``; #5-#7 held at the cell's local attention
    problem as in phase 29; the body's local arithmetic (slots, bins,
    both ``bf16_experts`` settings, combine) at the cell's local shape
    against the same steps on the CPU in float64, within one bf16
    rounding.  B: the same cell at ``moe_3d=0`` (the flattened tokens
    over every axis): the bins' bytes equal A's, DTensor's re-layout
    bytes logged beside A's; it runs first, so that A's step is not the
    phase's first (whose DTensor and cuBLAS calls run cold).  C: the same
    cell under ``bf16_experts``: bytes and FLOPs equal A's, peak and step
    time against A's.  D:
    deepseek-v3-671b at full width (``MLA_DEPTH``: all 61 layers, or a
    logged cut): the bins' bytes exactly 6 x 256 x 160 x 7168 x 2 a MoE
    layer (58 at full depth), the data-parallel bytes exact, #5-#7 held
    at the local MLA problem (8 of 128 heads, q/k 192 and v 128 padded
    to 256) through ``models.layers.mla_block``, bit for bit the
    kernels'.  E: ``fabric.plan`` on A's record.  Every peak under 80
    GB; the launches go under ``phase_launches``.
31. The RG-LRU and the memory-input families under the production mesh,
    as phase 29 runs its cells (``train_4k`` on ``pod1``, full width).
    A: recurrentgemma-9b at 38 layers (the RG-LRU's width 4096 split
    over ``model``, 256 columns a device; its attention layers sequence
    parallel, its RG-LRU layers batch-only).  B: llama-3.2-vision-90b at
    full depth (``VISION_DEPTH``: all 100 layers, 20 of them cross
    layers, or a logged cut), its batch carrying (16, 1600, 8192) bf16
    image embeddings a device.  C: seamless-m4t-large-v2 (24 encoder and
    24 decoder layers) at the cell's 16 rows a device (a global batch of
    256) under ``microbatch=4`` (``AUDIO_MB``): its vocabulary does not
    divide ``model``, so its float32 logits sit whole on every device,
    67.2 GB at 16 rows, 16.8 GB at a microbatch's 4; its batch carries
    (16, 1024, 1024) bf16 frames, routed into the microbatches by one
    all-to-all over ``data`` exactly ``AUDIO_SPLIT_BYTES``; each
    loss-phase axis exactly 4 times the 4-row cell's bytes, #5-#7 4
    times its 144 / 72 / 72 launches.  Each cell: the
    data-parallel gradient all-reduce exactly the local gradients not
    sharded over ``data`` (the 0-d cross gates too), every collective's
    bytes by kind, phase and axis, FLOPs, the state and the peak split
    into parts (``peak_parts``), the step's seconds; #5-#7 launched and
    held at each of its local problems (non-causal ones too: vision's
    cross layers at Sq 4096 against Skv 1600, seamless's encoder and
    cross layers) as in phase 29.  D: ``fabric.plan`` on each record.
    Every peak under 80 GB; the launches go under ``phase_launches``.
32. Serving on the production mesh: the dry run's serve cells of
    smollm-135m, h2o-danube-3-4b, mamba2-130m and recurrentgemma-9b on
    ``pod1`` at full width and depth (rank 0's share, as phase 29 runs
    its cells).  A: ``prefill_32k`` (2 rows of 32,768 tokens a device):
    each record's collective bytes by kind, by phase and axis and one by
    one (adding up, all under ``prefill``), FLOPs, ``peak_parts`` and
    the step's seconds; #5 launched exactly once an attention layer (30,
    24, 12) and #8 24 times; #5 held through ``attention_block`` at the
    cell's local problem cut to Sq = Skv = ``SERVE_HOLD_SEQ`` (the plain
    versions' scores at 32,768 would not fit; logged), #8 at the cell's
    local problem (``_hold_mesh_ssd``), to phases 9 and 10's limits.  B:
    ``decode_32k`` (8 rows) for the four, ``long_500k`` (1 row) for the
    three sub-quadratic ones: the same record; the cache's local bytes
    leaf by leaf exactly the reckoning from the config
    (``dryrun.reckon_cache_bytes``), k + v exactly PERF.md's
    (``DECODE_KV_BYTES``);
    no kernel launched (decode attends the cache in plain torch).  C:
    ``Engine(mesh=)`` on a (1, 1) mesh of the card (a one-rank NCCL
    group) serves phase 11's eight smollm-135m requests: every token and
    every prefill logit bit for bit phase 11's meshless engine's and
    prefill's, #5 30 times a request.  D: ``fabric.plan`` on h2o's
    ``decode_32k`` record.  The launches go under ``phase_launches``.
33. Serving the MoE / MLA and memory-input families on the production
    mesh, as phase 32 runs its cells.  A: ``prefill_32k`` of
    granite-moe-3b-a800m (32 layers; the MoE on the all-to-all path),
    deepseek-v3-671b (``MLA_DEPTH`` layers: 3 dense, 2 MoE, MLA over 8
    of 128 heads a device), llama-3.2-vision-90b (``VISION_LAYERS`` = 10
    of its 100 layers, 2 of them cross layers; its prefill
    carrying 1,600 image tokens a row) and seamless-m4t-large-v2
    (24 + 24 layers at 2 rows of ``AUDIO_PREFILL_SEQ`` = 8,192 tokens,
    2,048 frames: its whole-vocabulary float32 logits at 32,768 would be
    67.2 GB; logged): each record as in phase 32; the cache's local
    bytes leaf by leaf exactly ``reckon_cache_bytes`` and its headline
    leaves ``FAMILY_CACHE_BYTES``; the bins' all-to-all exactly
    ``FAMILY_BINS_BYTES``, all over ``model``; #5 launched 32, 5, 10
    and 72 times; #5-#7 held at each local problem (MLA's at heads
    padded to 256, the cross and encoder problems non-causal) cut to Sq
    = ``SERVE_HOLD_SEQ`` (logged), to phases 9, 14 and 28's limits.  B:
    ``decode_32k`` (8 rows): granite, deepseek at ``MLA_DEPTH``, vision
    at ``VISION_LAYERS`` = 10 (its cache at 100 layers is 87.2 GB on
    rank 0; logged), seamless: the cache's bytes exactly as in A; #5 0,
    0, 2 and 24 times (the cross layers at Sq = 1); the MoE decode
    gathers no expert weight and all-reduces its (E_local, C, M) float32
    bins over ``data`` twice a MoE layer.  C: ``Engine(mesh=)`` on a (1,
    1) mesh of the card serves phase 23's granite-moe-3b-a800m requests
    and phase 24's seamless-m4t-large-v2 requests (384 frames, gates at
    1.0): every token and every prefill logit bit for bit those phases'
    meshless engine's and prefill's; #5 32 times a granite request, 72 a
    seamless request and 24 a decode step.  D: ``fabric.plan`` on
    granite's ``prefill_32k`` record (its all-to-all bytes in the
    profile).  The launches go under ``phase_launches``.
34. The mesh step's ``microbatch`` flag and ``grad_compress``.  A:
    smollm-135m ``train_4k`` on ``pod1`` under ``microbatch=2``
    (``MESH_MB``) beside phase 29 A's cell at 1: the data-parallel
    all-reduce exactly 133,293,312 B in both (one reduction a step); the
    microbatches' re-placement over ``data`` exactly one all-to-all of
    each rank's 16 rows of 4096 int32 tokens, under its own phase
    ``split``; every loss-phase collective twice as often at half its
    bytes; the gradient and optimizer phases equal; #5-#7 twice phase 29
    A's launches and held at the microbatch's local problem as in phase
    29; the peak, its parts and the step's seconds beside A's.  B: one
    mesh step of smollm-135m cut to ``COMPRESS_DEPTH`` = 2 layers with
    ``grad_compress`` on the fake 256-rank world: every ``ef`` leaf at
    its parameter's placements and local shape after the step, the
    compress route's gathered leaves (``optim.gather_bytes``) and the
    ``compress`` phase's all-gather bytes exactly ``COMPRESS_GATHERED``,
    reckoned from the specs before the run; the card's int8 codes and
    scales of an in-place leaf's local block (w_down, 96 x 576) and of a
    gathered leaf (w_up, 576 x 1536, cut back to rank 0's 96 columns)
    bit for bit the CPU's on the same float32 input.  The launches go
    under ``phase_launches``.

Output: the card's name and power limit, then a ``kernels`` JSON line,
then ``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero
with no result where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# the reference's analytic ugal theta of each demand
# (repro.core.traffic.saturation_report), the expected values of phase 4
THETA_PN16_UGAL = 6.971407072988353
THETA_PN27_POINTS_UGAL = 9.454058876003565
THETA_RTOL = 1e-9
KNEE_BUDGET = 0.025
KERNEL_SRC = "src/repro_torch/kernels/csrc/sim_step.cu"
MASK_SRC = "src/repro_torch/kernels/csrc/mask_gemm.cu"
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
SSD_SRC = "src/repro_torch/kernels/csrc/ssd_scan.cu"
FLASH_BWD_SRC = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
SSD_BWD_SRC = "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
SSD_BWD_FMA_SRC = "src/repro_torch/kernels/csrc/ssd_scan_bwd_fma.cu"
# phase 3's (S, N) whose float64 rows do not fit a block's shared memory
WIDE_SHAPE = (37, 30011)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def hbm_bytes_per_s(name: str) -> float:
    """Published HBM bandwidth of the card model (NVIDIA data sheets)."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    if "H200" in name:
        return 4.8e12
    if "H100" in name:
        return 3.35e12
    raise RuntimeError(f"no published HBM bandwidth for {name!r}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def points_demand(g, q: int) -> np.ndarray:
    """All sources -> every point of PG(2, q), busiest source = 1."""
    from repro_torch.core import normalize_demand
    npts = q * q + q + 1
    dem = np.zeros((g.n, g.n))
    dem[:, :npts] = 1.0
    np.fill_diagonal(dem, 0.0)
    return normalize_demand(dem)


def hold_sim_kernels(label, t, cols, rand) -> dict:
    """#1 at the tables' full width and at the compacted width ``cols``
    (float64 and float32) and #2 at the compacted width (float64, thr 0
    and 16), each against its plain version on random queues over the
    real route tables ``t``; returns the largest float32 errors."""
    from repro_torch.kernels import sim_step as K
    from repro_torch.kernels.ref import (fused_decision_ref,
                                         fused_step_update_ref)
    n, k, m = t.n, t.k, t.m
    errs = {"fused_step_update": 0.0, "fused_decision": 0.0}
    for compact, (width, split_w, deliver_w) in enumerate((
            (m, t.split, t.deliver),
            (len(cols), t.split[:, :, cols].contiguous(),
             t.deliver[:, :, cols].contiguous()))):
        nt = K.n_tiles(width)
        mask = (rand(nt) < 0.7).to(torch.int32)
        mask[0], mask[-1] = 1, 0                    # live and dead tiles
        for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            args = (rand(n, k, width, dtype=dtype), split_w.to(dtype),
                    deliver_w.to(dtype), rand(n, k, dtype=dtype),
                    rand(n, k, dtype=dtype), rand(n, width, dtype=dtype),
                    mask)
            q_out, o_out = K.fused_step_update(*args)
            ref_q, ref_o = fused_step_update_ref(*args)
            torch.cuda.synchronize()
            for got, want in ((q_out, ref_q), (o_out, ref_o)):
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                if not err <= rtol * scale:
                    raise AssertionError(
                        f"{label}fused_step_update W={width} {dtype}: max "
                        f"error {err} > {rtol} * {scale}")
                if dtype == torch.float32:
                    errs["fused_step_update"] = max(
                        errs["fused_step_update"], err)
            log(f"{label}fused_step_update W={width} {dtype}: ok")
        # the decision at the compacted vc0 width, float64
        if compact:
            b0 = rand(n, k) * (rand(n, k) < 0.5)
            dist = t.dist_act[:, cols].contiguous()
            hval = t.hval_rem[:, cols].contiguous()
            cand = rand(n, width)
            q_val = rand(n) * 0.05
            for thr in (0.0, 16.0):
                dargs = (b0 * (1.0 + 40.0 * (thr > 0)), split_w, dist, hval,
                         cand, q_val, mask)
                got = K.fused_decision(*dargs, thr)
                want = fused_decision_ref(*dargs, thr)
                q_min = (dargs[0][:, :, None] * split_w).sum(1)
                lhs = dist * q_min
                rhs = thr + hval * q_val[:, None]
                scale = float(torch.maximum(lhs.abs().max(),
                                            rhs.abs().max()))
                clear = (lhs - rhs).abs() > 1e-9 * scale
                bad = int(((got != want) & clear).sum())
                live = float((want != 0).double().mean())
                if bad or not 0.0 < live < 1.0:
                    raise AssertionError(
                        f"{label}fused_decision thr={thr}: {bad} clear "
                        f"cells differ (diverting share {live})")
                errs["fused_decision"] = max(
                    errs["fused_decision"],
                    float(((got - want).abs() * clear).max()))
                log(f"{label}fused_decision thr={thr} float64: ok "
                    f"(diverting share {live:.3f})")
    return errs


def check_kernels(dev, bw):
    """Phase 2: kernels against plain versions on the PN(27) tables, and
    their times at the main path's shapes."""
    from repro_torch.core import pn_graph
    from repro_torch.kernels import sim_step as K
    from repro_torch.kernels.ref import (fused_decision_ref,
                                         fused_step_update_ref)
    from repro_torch.sim.tables import build_tables

    g = pn_graph(27)
    t = build_tables(g, np.arange(g.n), dtype=torch.float64, device=dev)
    n, k, m = t.n, t.k, t.m
    cols = torch.arange(757, device=dev)            # the 757 points
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.float64):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    errs = hold_sim_kernels("", t, cols, rand)

    # times at the main path's shapes (float32; every tile live, as the
    # vc1 plane at PN(27) is once phase-1 fluid reaches every mid)
    f4 = 4
    timing = {}
    args = (rand(n, k, m, dtype=torch.float32),
            t.split.to(torch.float32), t.deliver.to(torch.float32),
            rand(n, k, dtype=torch.float32), rand(n, k, dtype=torch.float32),
            rand(n, m, dtype=torch.float32),
            torch.ones(K.n_tiles(m), dtype=torch.int32, device=dev))
    nt = K.n_tiles(m)
    nbytes = f4 * (4 * n * k * m + 2 * n * k + n * m + n * k) + 4 * nt
    timing["fused_step_update"] = dict(
        ms=cuda_ms(lambda: K.fused_step_update(*args), 20),
        plain_ms=cuda_ms(lambda: fused_step_update_ref(*args), 5),
        bound_ms=nbytes / bw * 1e3, nbytes=nbytes,
        shape=f"N={n} K={k} W={m} float32")
    del args
    c = 757
    split_c = t.split[:, :, cols].to(torch.float32).contiguous()
    dargs = ((rand(n, k, dtype=torch.float32) * 2.0), split_c,
             t.dist_act[:, cols].to(torch.float32).contiguous(),
             t.hval_rem[:, cols].to(torch.float32).contiguous(),
             rand(n, c, dtype=torch.float32),
             rand(n, dtype=torch.float32),
             torch.ones(K.n_tiles(c), dtype=torch.int32, device=dev))
    nbytes = f4 * (n * k + n * k * c + 3 * n * c + n + n * c) \
        + 4 * K.n_tiles(c)
    timing["fused_decision"] = dict(
        ms=cuda_ms(lambda: K.fused_decision(*dargs, 0.0), 20),
        plain_ms=cuda_ms(lambda: fused_decision_ref(*dargs, 0.0), 5),
        bound_ms=nbytes / bw * 1e3, nbytes=nbytes,
        shape=f"N={n} K={k} C={c} float32")
    for name, row in timing.items():
        log(f"{name} [{row['shape']}]: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['nbytes'] / 1e9:.3f} GB)")
    del t, dargs, split_c
    torch.cuda.empty_cache()
    return errs, timing


def level_states(g, rows: int, dev, dtype=torch.float64, sources=None,
                 targets=None):
    """The real level states of ``rows`` sources of ``g`` (the first
    ``rows`` vertices, or ``sources``): the forward sweep's inputs
    ``(front, dist, sigma, lvl)`` per BFS level and the backward sweep's
    ``(coeff, dist, sigma, delta, lvl - 1)`` per dependency level
    (uniform traffic to every vertex, or to the ``targets`` mask), from
    the plain epilogues on the dense adjacency."""
    from repro_torch.core.graph import adjacency_dense
    from repro_torch.kernels.ref import backward_epilogue, frontier_epilogue
    n = g.n
    a = adjacency_dense(g, dtype, dev)
    r = torch.arange(rows, device=dev)
    src = r if sources is None else torch.as_tensor(
        np.asarray(sources, dtype=np.int64), device=dev)
    w = 1.0 if targets is None else torch.as_tensor(
        np.asarray(targets, dtype=bool), device=dev).to(dtype)
    front = torch.zeros((rows, n), dtype=dtype, device=dev)
    front[r, src] = 1.0
    dist = torch.full((rows, n), -1, dtype=torch.int32, device=dev)
    dist[r, src] = 0
    sigma = front.clone()
    fwd, lvl = [], 0
    while True:
        lvl += 1
        fwd.append((front, dist, sigma, lvl))
        front, dist, sigma, any_new = frontier_epilogue(front @ a, dist,
                                                        sigma, lvl)
        if not int(any_new):
            break
    bwd = []
    delta = torch.zeros_like(sigma)
    for lv in range(lvl - 1, 0, -1):
        m = dist == lv
        coeff = torch.where(m, (w + delta) / torch.where(m, sigma, 1.0),
                            0.0)
        bwd.append((coeff, dist, sigma, delta, lv - 1))
        delta = backward_epilogue(coeff @ a, dist, sigma, delta, lv - 1)
    return fwd, bwd, a


def _wide_level(gen, dev, s: int, n: int, degree: int = 12):
    """A random weighted A given by column (integer weights 1..3, about
    ``degree`` entries a column, no dense copy) and ``s`` rows of level
    state: integer fronts up to 2^14, dist in [-1, 2]."""
    nnz = n * degree
    cols = torch.randint(0, n, (nnz,), generator=gen, device=dev).sort()[0]
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.bincount(cols, minlength=n).cumsum(0)
    csr = (indptr.to(torch.int32),
           torch.randint(0, n, (nnz,), generator=gen, device=dev,
                         dtype=torch.int32),
           torch.randint(1, 4, (nnz,), generator=gen,
                         device=dev).to(torch.float64))
    dist = torch.randint(-1, 3, (s, n), generator=gen, device=dev,
                         dtype=torch.int32)
    front = (torch.randint(0, 2**14, (s, n), generator=gen, device=dev)
             * (torch.rand((s, n), generator=gen, device=dev) < 0.3)).double()
    sigma = torch.randint(1, 2**12, (s, n), generator=gen,
                          device=dev).double()
    delta = torch.rand((s, n), generator=gen, device=dev,
                       dtype=torch.float64)
    coeff = torch.rand((s, n), generator=gen, device=dev,
                       dtype=torch.float64) * (dist == 2)
    return csr, front, dist, sigma, delta, coeff


def sparse_transpose(csr, n: int):
    """A^T as torch's CSR tensor, for torch.sparse.mm: the kernels'
    compressed-column triple of A with each column's entries sorted by
    row (torch and cuSPARSE require sorted, distinct columns in a CSR
    row; the kernels take any order)."""
    indptr, indices, data = csr
    col = torch.repeat_interleave(torch.arange(n, device=indices.device),
                                  (indptr[1:] - indptr[:-1]).long())
    order = torch.argsort(col * n + indices.long())
    return torch.sparse_csr_tensor(indptr, indices[order], data[order],
                                   (n, n), check_invariants=True)


def max_error(name, got, want, rtol) -> float:
    """The largest |got - want|; raises above ``rtol`` of the larger of
    want's max and 1."""
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1.0)
    if not err <= rtol * scale:
        raise AssertionError(f"{name}: max error {err} > {rtol} * {scale}")
    return err


def hold_frontier(name, args, rtol) -> float:
    """#3 on ``args`` against its plain version (nxt and sigma' within
    ``rtol``, dist' and any_new exactly) and bit for bit the tiled mirror
    of its summation order; returns the largest error."""
    from repro_torch.kernels import mask_gemm as MG
    from repro_torch.kernels.ref import (frontier_step_ref,
                                         frontier_step_tiled_ref)
    got = MG.frontier_step(*args)
    want = frontier_step_ref(*args)
    mirror = frontier_step_tiled_ref(*args, chunk=MG._plan_for(args[0])[1])
    torch.cuda.synchronize()
    err = max(max_error(name, got[0], want[0], rtol),
              max_error(name, got[2], want[2], rtol))
    if not (torch.equal(got[1], want[1]) and int(got[3]) == int(want[3])):
        raise AssertionError(f"{name}: dist' or any_new differ")
    if not all(torch.equal(a, b) for a, b in zip(got, mirror)):
        raise AssertionError(f"{name}: not bit for bit the tiled mirror")
    return err


def hold_backward(name, args, rtol) -> float:
    """#4 on ``args`` against its plain version and bit for bit the
    tiled mirror; returns the largest error."""
    from repro_torch.kernels import mask_gemm as MG
    from repro_torch.kernels.ref import (backward_step_ref,
                                         backward_step_tiled_ref)
    got = MG.backward_step(*args)
    want = backward_step_ref(*args)
    mirror = backward_step_tiled_ref(*args, chunk=MG._plan_for(args[0])[1])
    torch.cuda.synchronize()
    err = max_error(name, got, want, rtol)
    if not torch.equal(got, mirror):
        raise AssertionError(f"{name}: not bit for bit the tiled mirror")
    return err


def check_mask_gemm(dev, bw):
    """Phase 3: the mask+GEMM kernels against their plain versions and
    bit for bit against the mirror of their summation order at the main
    path's shapes, then their times: every level of the first PN(64)
    source block, and level 2 and the deepest dependency level beside
    their plain versions, the dense torch.matmul and torch.sparse.mm."""
    from repro_torch.core import pn_graph
    from repro_torch.core.graph import adjacency_csr
    from repro_torch.kernels import mask_gemm as MG
    from repro_torch.kernels.ref import backward_step_ref, frontier_step_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {"frontier_step": 0.0, "backward_step": 0.0}
    timing = {}

    def close(name, got, want, rtol, record):
        err = max_error(name, got, want, rtol)
        if record:
            key = name.split()[0]
            errs[key] = max(errs[key], err)

    def check_frontier(name, args, rtol, record):
        err = hold_frontier(name, args, rtol)
        if record:
            errs["frontier_step"] = max(errs["frontier_step"], err)

    def check_backward(name, args, rtol, record):
        err = hold_backward(name, args, rtol)
        if record:
            errs["backward_step"] = max(errs["backward_step"], err)

    for label, q, rows in (("PN(27)", 27, None), ("PN(64) block", 64, 756)):
        g = pn_graph(q)
        rows = g.n if rows is None else min(rows, g.n)
        fwd, bwd, a = level_states(g, rows, dev)
        n = g.n
        # random integer fronts up to 2^20 against a partly reached table
        rnd = (torch.randint(0, 2**20, (rows, n), generator=gen,
                             device=dev, dtype=torch.int64).double()
               * (torch.rand((rows, n), generator=gen, device=dev) < 0.3))
        rdist = torch.randint(-1, 3, (rows, n), generator=gen, device=dev,
                              dtype=torch.int32)
        cases = fwd + [(rnd, rdist, fwd[-1][2], 3)]
        for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
            csr = adjacency_csr(g, dtype, dev)
            record = dtype == torch.float64
            for front, dist, sigma, lvl in cases:
                check_frontier(f"frontier_step {label} lvl={lvl} {dtype}",
                               (front.to(dtype), csr, dist, sigma.to(dtype),
                                lvl), rtol, record)
            for coeff, dist, sigma, delta, lvl in bwd:
                check_backward(f"backward_step {label} lvl={lvl} {dtype}",
                               (coeff.to(dtype), csr, dist, sigma.to(dtype),
                                delta.to(dtype), lvl), rtol, record)
            log(f"mask_gemm {label} S={rows} N={n} {dtype}: "
                f"{len(cases)} frontier and {len(bwd)} backward levels ok, "
                f"plan (rows, chunk, col_splits) "
                f"{MG._plan_for(fwd[0][0].to(dtype))}, bit for bit the "
                f"tiled mirror")

        # times at this shape, float64: the widest forward level (2) and
        # the deepest dependency level (lvl 3 -> 2, dist == 2 masks half
        # the cells), beside the plain version, the dense product and
        # cuSPARSE's product on the same compressed storage (A^T in CSR
        # is A by column); none of the three yardsticks has the epilogue
        csr = adjacency_csr(g, torch.float64, dev)
        at = sparse_transpose(csr, n)
        nnz = len(g.indices)
        csr_bytes = nnz * 12 + (n + 1) * 4
        front, dist, sigma, lvl = fwd[1]
        coeff, bdist, bsigma, delta, blvl = bwd[0]
        close(f"torch.sparse.mm {label}",
              torch.sparse.mm(at, front.t()).t(), front @ a, 1e-12, False)
        cells = rows * n
        rows_t = {}
        for name, kern, ref, args, x, nbytes in (
                ("frontier_step", MG.frontier_step, frontier_step_ref,
                 (front, csr, dist, sigma, lvl), front,
                 cells * 40 + csr_bytes),
                ("backward_step", MG.backward_step, backward_step_ref,
                 (coeff, csr, bdist, bsigma, delta, blvl), coeff,
                 cells * 36 + csr_bytes)):
            flops = 2.0 * rows * n * n
            first, again = kern(*args), kern(*args)
            torch.cuda.synchronize()
            same = (all(torch.equal(u, v) for u, v in zip(first, again))
                    if isinstance(first, tuple) else torch.equal(first, again))
            if not same:
                raise AssertionError(f"{name} {label}: a repeated launch "
                                     f"differs")
            rows_t[name] = dict(
                ms=cuda_ms(lambda: kern(*args), 20),
                plain_ms=cuda_ms(lambda: ref(*args), 5),
                library_ms=cuda_ms(lambda: torch.matmul(x, a), 5),
                sparse_mm_ms=cuda_ms(lambda: torch.sparse.mm(at, x.t()), 5),
                bound_ms=nbytes / bw * 1e3, nbytes=nbytes,
                dense_flop_ms=flops / 67e12 * 1e3, flops=flops,
                shape=f"{label} S={rows} N={n} nnz={nnz} float64")
            r = rows_t[name]
            log(f"{name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, torch.matmul {r['library_ms']:.4f}"
                f" ms, torch.sparse.mm {r['sparse_mm_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB); dense "
                f"product {flops / 1e9:.1f} GFLOP = "
                f"{r['dense_flop_ms']:.3f} ms at 67 TFLOP/s; a repeated "
                f"launch bit for bit")
        if label == "PN(64) block":
            # every level of the block, as phase 5's sweep launches them;
            # a level that sums nothing moves no front/coeff and no A
            for name, kern, levels, width, idle in (
                    ("frontier_step", MG.frontier_step,
                     [((f, csr, d, sg, lv), bool((d < 0).any()))
                      for f, d, sg, lv in fwd], 40, 32),
                    ("backward_step", MG.backward_step,
                     [((c, csr, d, sg, dl, lv), bool((d == lv).any()))
                      for c, d, sg, dl, lv in bwd], 36, 28)):
                per = []
                for args, busy in levels:
                    ms = cuda_ms(lambda args=args: kern(*args), 20)
                    nb = cells * width + csr_bytes if busy else cells * idle
                    per.append((args[-1], ms, nb / bw * 1e3))
                r = rows_t[name]
                r["level_ms"] = [ms for _, ms, _ in per]
                r["block_ms"] = sum(r["level_ms"])
                r["block_bound_ms"] = sum(b for _, _, b in per)
                r["block_launches"] = len(per)
                log(f"{name} {label} by level: " + ", ".join(
                    f"lvl={lv} {ms:.4f} ms (bound {b:.4f})"
                    for lv, ms, b in per)
                    + f"; per source block {r['block_ms']:.4f} ms in "
                      f"{len(per)} launches (bound "
                      f"{r['block_bound_ms']:.4f} ms)")
        timing[label] = rows_t
        del fwd, bwd, a, rnd, rdist, csr, at, cases
        torch.cuda.empty_cache()

    # rows too long for a block's shared memory: the chunked route
    s_w, n_w = WIDE_SHAPE
    csr, front, dist, sigma, delta, coeff = _wide_level(gen, dev, s_w, n_w)
    plan = MG._plan_for(front)
    if not plan[1] < n_w:
        raise AssertionError(f"plan {plan} does not chunk N={n_w}")
    check_frontier(f"frontier_step S={s_w} N={n_w} float64",
                   (front, csr, dist, sigma, 3), 1e-12, True)
    check_backward(f"backward_step S={s_w} N={n_w} float64",
                   (coeff, csr, dist, sigma, delta, 1), 1e-12, True)
    log(f"mask_gemm S={s_w} N={n_w} float64, rows that do not fit a "
        f"block: plan (rows, chunk, col_splits) {plan}, both steps ok, "
        f"bit for bit the tiled mirror")
    del csr, front, dist, sigma, delta, coeff
    torch.cuda.empty_cache()
    return errs, timing["PN(64) block"]


def check_analytic(dev):
    """Phase 4: the analytic main path, saturation_report on the card."""
    from repro_torch.core import pn_graph, saturation_report
    from repro_torch.core.utilization import resolve_engine
    from repro_torch.kernels import mask_gemm as MG

    if resolve_engine("auto", dev) != "fused":
        raise AssertionError("engine='auto' does not resolve to the fused "
                             "kernels on the card")
    thetas, launches = {}, {}
    g27 = pn_graph(27)
    for label, g, pat, want in (
            ("pn16 uniform", pn_graph(16), "uniform", THETA_PN16_UGAL),
            ("pn27 points", g27, points_demand(g27, 27),
             THETA_PN27_POINTS_UGAL)):
        MG.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the all-source path: under "auto" these uniform-shaped demands
        # would take the orbit shortcut (phase 19)
        rep = saturation_report(g, pat, routing="ugal", engine="fused",
                                device=dev)
        seconds = time.perf_counter() - t0
        got = dict(MG.LAUNCHES)
        rel = abs(rep.theta - want) / want
        log(f"{label} ugal: theta {rep.theta!r} (alpha {rep.alpha}) vs "
            f"reference {want!r}, rel err {rel:.3e}; {seconds:.2f} s; "
            f"launches {got}")
        if not rel <= THETA_RTOL:
            raise AssertionError(f"{label} theta rel err {rel} > "
                                 f"{THETA_RTOL}")
        # one source block each; minimal + two Valiant phases
        if got != {"frontier_step": 12, "backward_step": 9}:
            raise AssertionError(f"{label}: launches {got}, expected 4 "
                                 f"frontier and 3 backward per sweep, "
                                 f"3 sweeps")
        thetas[label] = rep.theta
        for key, count in got.items():
            launches[key] = launches.get(key, 0) + count
    return thetas, launches


def check_pn64(dev, block_ms: dict, q: int = 64):
    """Phase 5: the analytic engines at full width, PN(64).  From a point
    of PN(q), its q + 1 lines lie at 1 hop, the other points at 2 and
    the remaining lines at 3: kbar = 20673/8321 at q = 64.  ``block_ms``:
    phase 3's per-source-block sums of each mask+GEMM kernel by CUDA
    events, printed beside the profile's."""
    from repro_torch.core import pn_graph, saturation_report, utilization
    from repro_torch.kernels import mask_gemm as MG

    g = pn_graph(q)
    pairs = g.n * (g.n - 1)
    npts = q * q + q + 1
    kbar = ((q + 1) + 2 * (npts - 1) + 3 * (npts - q - 1)) / (g.n - 1)
    MG.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = utilization(g, engine="fused", device=dev)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"pn64 utilization (N={g.n}, {2 * g.num_edges} arcs) fused: u "
        f"{rep.u!r}, kbar {rep.kbar!r}, diameter {rep.diameter}; "
        f"{seconds:.2f} s; peak memory {peak / 2**30:.2f} GiB; launches "
        f"{dict(MG.LAUNCHES)}")
    if not abs(rep.u - 1.0) <= 1e-12:
        raise AssertionError(f"pn64 u = {rep.u!r}, not 1 within 1e-12")
    if not abs(rep.kbar - kbar) <= 1e-12 * kbar:
        raise AssertionError(f"pn64 kbar {rep.kbar!r} != {kbar!r}")
    total = float(rep.loads.sum())
    if not abs(total - kbar * pairs) <= 1e-12 * kbar * pairs:
        raise AssertionError(f"pn64 sum(loads) {total!r} != kbar x pairs")
    all_source = rep
    blocks = MG.LAUNCHES["backward_step"] // 3
    profile_device(lambda: utilization(g, engine="fused", device=dev),
                   blocks, "source block", "profile pn64")
    log("profile pn64: phase 3's first source block by CUDA events: "
        + ", ".join(f"{name} {ms:.4f} ms in {launches} launches"
                    for name, (ms, launches) in block_ms.items()))
    reps = {}
    for engine in ("fused", "dense"):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps[engine] = saturation_report(g, "random_permutation(0)",
                                         routing="ugal", engine=engine,
                                         device=dev)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        r = reps[engine]
        log(f"pn64 random_permutation(0) ugal {engine}: theta {r.theta!r} "
            f"(alpha {r.alpha}); {seconds:.2f} s for 3 sweeps "
            f"({seconds / 3:.2f} s per sweep); peak memory "
            f"{peak / 2**30:.2f} GiB")
    want = reps["dense"].loads
    err = float(np.abs(reps["fused"].loads - want).max())
    if not err <= 1e-9 * float(np.abs(want).max()):
        raise AssertionError(f"pn64 fused vs dense loads: max error {err}")
    log(f"pn64 fused vs dense: loads max abs error {err:.3e}, theta rel "
        f"{abs(reps['fused'].theta / reps['dense'].theta - 1):.3e}")
    return all_source


def check_pn16(dev, th):
    """Phase 6: fused float32 vs dense float64 on the card, then a knee
    against the analytic theta ``th``."""
    from repro_torch.core import make_pattern, normalize_demand, pn_graph
    from repro_torch.sim import SimConfig, Simulator, saturation_sweep

    g = pn_graph(16)
    dem = normalize_demand(make_pattern("uniform").demand(g, None))
    hist = {}
    for backend in ("fused", "dense"):
        sim = Simulator(g, SimConfig(routing="ugal_threshold(0)",
                                     backend=backend), demand=dem,
                        device=dev)
        r = sim.run(dem, 0.5, 24)
        hist[backend] = r.history["delivered"]
        log(f"pn16 {backend} {sim.dtype}: 24 steps, residual "
            f"{r.residual:.3e}")
    ref = hist["dense"]
    gap = float(np.abs(hist["fused"] - ref).max() / np.abs(ref).max())
    log(f"pn16 fused-vs-dense delivered gap {gap:.3e}")
    if not gap <= 1e-5:
        raise AssertionError(f"pn16 fused/dense gap {gap} > 1e-5")
    t0 = time.perf_counter()
    sw = saturation_sweep(g, "uniform", routing="ugal_threshold(0)",
                          loads=np.array([0.97, 1.08]) * th, steps=40,
                          refine=2, config=SimConfig(backend="fused"),
                          theta_analytic=th, device=dev)
    rel = abs(sw.theta - th) / th
    log(f"pn16 sweep: theta {sw.theta:.4f} vs analytic {th:.4f} "
        f"({sw.theta / th:.4f}x, err {rel:.4f}) in "
        f"{time.perf_counter() - t0:.1f} s, {len(sw.runs)} probes")
    if not rel <= KNEE_BUDGET:
        raise AssertionError(f"pn16 knee error {rel} > {KNEE_BUDGET}")
    return sw


def check_pn27(dev, th):
    """Phase 7: the simulator's main path at full width, against the
    analytic theta ``th`` and then against its own."""
    from repro_torch.core import pn_graph
    from repro_torch.kernels import mask_gemm as MG
    from repro_torch.kernels import sim_step as K
    from repro_torch.sim import SimConfig, Simulator, saturation_sweep

    g = pn_graph(27)
    dem = points_demand(g, 27)
    cfg = SimConfig(routing="ugal_threshold(0)")           # backend=auto
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    MG.reset_launches()
    t0 = time.perf_counter()
    sw = saturation_sweep(g, dem, routing="ugal_threshold(0)", config=cfg,
                          loads=np.array([0.95, 1.08]) * th, steps=30,
                          refine=2, theta_analytic=th, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if any(MG.LAUNCHES.values()):
        raise AssertionError("the sweep given theta_analytic launched the "
                             "mask+GEMM kernels")
    peak = torch.cuda.max_memory_allocated()
    for r in sw.runs:
        log(f"pn27 probe offered {r.offered:.4f}: theta {r.theta:.4f} "
            f"residual {r.residual:.2e} backend {r.backend}")
        if r.backend != "fused":
            raise AssertionError(f"pn27 ran on {r.backend}, not fused")
        if not r.residual <= 1e-4:
            raise AssertionError(f"pn27 residual {r.residual} > 1e-4")
    n_bisect = len(sw.runs) - 2
    rel = abs(sw.theta - th) / th
    log(f"pn27 sweep: theta {sw.theta:.4f} vs analytic {th:.4f} "
        f"({sw.theta / th:.4f}x, err {rel:.4f}); bracket "
        f"[{sw.theta:.4f}, {sw.theta_unstable:.4f}] after {n_bisect} "
        f"bisection steps; {seconds:.1f} s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    if not rel <= KNEE_BUDGET:
        raise AssertionError(f"pn27 knee error {rel} > {KNEE_BUDGET}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 f"path")

    # the same sweep computing its own analytic theta on the card
    K.reset_launches()
    MG.reset_launches()
    t0 = time.perf_counter()
    sw = saturation_sweep(g, dem, routing="ugal_threshold(0)", config=cfg,
                          loads=np.array([0.95, 1.08]) * th, steps=30,
                          refine=2, theta_analytic=None, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    own = {**K.LAUNCHES, **MG.LAUNCHES}
    rel = abs(sw.theta - sw.theta_analytic) / sw.theta_analytic
    log(f"pn27 sweep, theta_analytic=None: own analytic theta "
        f"{sw.theta_analytic!r}, knee {sw.theta:.4f} (err {rel:.4f}); "
        f"{seconds:.1f} s; launches {own}")
    if not abs(sw.theta_analytic - th) <= THETA_RTOL * th:
        raise AssertionError(f"pn27 sweep's own theta {sw.theta_analytic} "
                             f"!= {th}")
    if not rel <= KNEE_BUDGET:
        raise AssertionError(f"pn27 knee error {rel} > {KNEE_BUDGET} "
                             f"(own theta)")
    for name, count in own.items():
        if count <= 0:
            raise AssertionError(f"{name} was never launched in the sweep "
                                 f"with theta_analytic=None")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = Simulator(g, cfg, demand=dem, device=dev)
    torch.cuda.synchronize()
    log(f"pn27 Simulator set-up (tables, arc index, step): "
        f"{time.perf_counter() - t0:.2f} s")
    if sim.backend != "fused" or sim.dest_cols is None \
            or len(sim.dest_cols) != 757:
        raise AssertionError(f"pn27 auto resolved to {sim.backend} with "
                             f"{None if sim.dest_cols is None else len(sim.dest_cols)} "
                             f"columns, not fused on 757")
    steps = 30
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    a = sim.run(dem, th, steps)
    end.record()
    torch.cuda.synchronize()
    ms_step = start.elapsed_time(end) / steps
    b = sim.run(dem, th, steps)
    for key, va in a.history.items():
        if not np.array_equal(va, b.history[key]):
            raise AssertionError(f"pn27 history[{key!r}] not bitwise "
                                 f"reproducible")
    log(f"pn27 step: {ms_step:.3f} ms/step (CUDA events, {steps} steps, "
        f"history read included); repeat run bitwise equal")
    profile_steps(sim, dem, th)
    return launches


def profile_steps(sim, dem, offered, steps: int = 6):
    """Where a PN(27) step's device time goes (phase 8)."""
    profile_device(lambda: sim.run(dem, offered, steps), steps, "step")


# CUPTI drops the records of the first kernels of a profiling session,
# those launched while its first activity buffer is requested (the lost
# launch calls overlap kineto's "Activity Buffer Request"), however long
# the host idles first.  So each session starts with WARM_LAUNCHES small
# kernels, then idles PROFILE_PAD_S, and only the calls that follow are
# read.  The device's clock, as kineto reads it, also sits up to some
# milliseconds off the host's, either way, by an amount that changes
# between sessions; the pads keep the calls' kernels inside the window.
# The records of the first launches after the pad go missing too now and
# then (one whole run lost the first in 6 sessions of phase 25, 3 in a
# row; with one opener, a later run lost the one after it in 3 sessions
# of phase 26 in a row), so the measured span opens with SPAN_OPENERS
# small launches of its own, which are not read.  Late in a whole run the
# loss can grow past them and stay (one run lost the first 1 to 3
# launches after 8 openers in phase 28's kernel sessions, and the first 6
# of recurrentgemma-9b's prefill and decode profiles in every session),
# so a session that lost a record is run again, up to PROFILE_TRIES
# times, each time with twice the openers.  Where every session lost
# one, a caller whose check reads the records fails; :func:`profile_device`,
# which only prints where the device time goes, prints its profile as
# not measured and goes on.
WARM_LAUNCHES = 32
SPAN_OPENERS = 8
PROFILE_PAD_S = 0.1
PROFILE_TRIES = 6
RUNTIME_API = re.compile(r"^cu[A-Z]|^cuda[A-Z]")
LAUNCH_API = re.compile(r"^cu(da)?LaunchKernel")


class ProfilerLostRecords(AssertionError):
    """Every profiling session lost a kernel record of the calls."""


def device_rows(fn, reps: int = 1):
    """torch.profiler over ``reps`` calls of ``fn``: ``(rows, wall_ms,
    busy_ms, lead_us)``, rows ``(ms, launches, kernel name)`` of the
    device time by kernel of the work that the calls enqueued, the calls'
    wall time (CUDA events), the device's busy time, and the least time
    from a kernel launch call to that kernel's start on the profiler's
    clocks (a few microseconds where the host's and the device's clocks
    agree; negative where the device's reads early).  Every kernel
    launch call of the calls must have its kernel's record: a session
    that lost one is logged and run again with twice the openers, and
    the last of ``PROFILE_TRIES`` such sessions raises
    :class:`ProfilerLostRecords`.  The kernels' launch counts keep only
    the session that is read, so a caller that counts the calls'
    launches counts them once."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import flash_attention, mask_gemm, sim_step
    from repro_torch.kernels import ssd_scan
    counts = [m.LAUNCHES for m in (flash_attention, mask_gemm, sim_step,
                                   ssd_scan)]
    before = [dict(c) for c in counts]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    warm = torch.zeros(1, device="cuda")
    for attempt in range(PROFILE_TRIES):
        n_open = SPAN_OPENERS << attempt
        for c, b in zip(counts, before):    # a session run again: once
            c.update(b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(WARM_LAUNCHES):
                warm.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            with record_function("chip_smoke: measured calls"):
                for _ in range(n_open):
                    warm.add_(1.0)      # the span's openers, not read
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = prof.profiler.kineto_results.events()
        span = next(e for e in events
                    if e.name() == "chip_smoke: measured calls"
                    and str(e.device_type()).endswith("CPU"))
        calls = {e.correlation_id(): e for e in events
                 if RUNTIME_API.match(e.name())
                 and span.start_ns() <= e.start_ns() <= span.end_ns()}
        device = [e for e in events if str(e.device_type()).endswith("CUDA")
                  and not e.is_user_annotation()
                  and e.correlation_id() in calls]
        began = {e.correlation_id(): e.start_ns() for e in device}
        launched = sorted((e.start_ns(), c) for c, e in calls.items()
                          if LAUNCH_API.match(e.name()))
        # the openers: their kernels, if recorded, are no part of the calls
        openers = {c for _, c in launched[:n_open]}
        opened = len(openers & began.keys())
        first_ns = launched[0][0] if launched else 0
        launched = launched[n_open:]
        device = [e for e in device if e.correlation_id() not in openers]
        lost = [i for i, (_, c) in enumerate(launched) if c not in began]
        if not lost:
            break
        # a loss of unknown cause: the session is run again, not read
        log(f"profiler: no record of the kernels of {len(lost)} of "
            f"{len(launched)} launch calls (calls {lost[:8]} in launch "
            f"order, {[calls[launched[i][1]].name() for i in lost[:4]]}; "
            f"{opened} of {n_open} openers recorded; the last lost call "
            f"{(launched[lost[-1]][0] - first_ns) / 1e3:.1f} us after the "
            f"first opener's); profiling again")
    else:
        raise ProfilerLostRecords(f"the profiler lost kernel records in "
                                  f"{PROFILE_TRIES} sessions running")
    by_name = {}
    for e in device:
        ms, count = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
    rows = sorted(((ms, count, name) for name, (ms, count)
                   in by_name.items()), reverse=True)
    lead_us = min((began[c] - t for t, c in launched),
                  default=float("nan")) / 1e3
    return rows, start.elapsed_time(end), sum(r[0] for r in rows), lead_us


def profile_device(fn, per: int, unit: str, label: str = "profile"):
    """Prints :func:`device_rows` of one call of ``fn`` per ``unit``
    (``per`` units in the call) and the device's idle share of the
    call's wall time; returns them.  Where the profiler lost a kernel
    record in every session, the profile is printed as not measured and
    the rows are empty, with no device time."""
    try:
        rows, wall_ms, busy_ms, lead_us = device_rows(fn)
    except ProfilerLostRecords as e:
        log(f"{label}: device time not measured ({e})")
        return [], float("nan"), 0.0
    if busy_ms <= 0:
        log(f"{label}: the profiler saw no device time (CUDA events only)")
        return rows, wall_ms, busy_ms
    log(f"{label}: {per} {unit}s, wall {wall_ms / per:.3f} ms/{unit}, "
        f"device busy {busy_ms / per:.3f} ms/{unit}, idle share "
        f"{1.0 - busy_ms / wall_ms:.3f}; every launch recorded, kernels "
        f"start {lead_us:.1f} us or more after their launch calls")
    for ms, count, key in rows[:14]:
        log(f"{label}:   {ms / per:8.4f} ms/{unit} {count / per:6.1f} "
            f"launches/{unit}  {key[:90]}")
    return rows, wall_ms, busy_ms


# ---------------------------------------------------------------------------
# The serving path: kernels #5 and #8, then smollm-135m and mamba2-130m
# ---------------------------------------------------------------------------

BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak (data sheet)
SERVE = dict(requests=8, min_len=256, max_len_prompt=1536, max_new=32,
             max_batch=4, max_len=2048, gap=0.05)


def _close_or_raise(name, got, want, atol, rtol):
    """Max abs error of got vs want, and the max relative error over the
    elements with |want| > atol; raises beyond atol + rtol * |want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond "
                             f"{atol} + {rtol}|want|, max error "
                             f"{float(diff.max())}")
    big = want.abs() > atol
    rel = float((diff[big] / want.abs()[big]).max()) if bool(big.any()) \
        else 0.0
    return float(diff.max()), rel


# the least share of a bf16 kernel output's entries (#5's o, #6's dq, #8's
# y) equal to the plain float32 output rounded to bf16.  Sums at float32
# precision differ from the plain ones by float32 roundings (grown where
# a sum cancels: each row of ds sums to zero), so only entries that close
# to a rounding boundary round the other way; one bf16 cast of the
# float32 operand (p, ds, the scores) moves every term of a sum by up to
# 2^-9 of itself, and a fair share of the entries with it (the plain
# emulations measured 0.61 for o, 0.58 for dq, 0.70 for y)
SAME_SHARE = 0.95


def _same_share(got, want32):
    """The share of entries of ``got`` equal to ``want32`` rounded to
    ``got``'s dtype."""
    return float((got == want32.to(got.dtype)).float().mean())


def _check_same_share(name, got, want32) -> float:
    """Raises unless ``got`` equals ``want32`` rounded to its dtype in at
    least SAME_SHARE of the entries; returns the share."""
    share = _same_share(got, want32)
    if share < SAME_SHARE:
        raise AssertionError(f"{name}: {share:.4f} of the entries equal the "
                             f"plain float32 output rounded to bf16, under "
                             f"{SAME_SHARE}")
    return share


def _single_cast_fails(name, what, share, beyond=None, tol=""):
    """The plain version with ``what`` cast to one bf16 before its
    products (what a kernel without the three-way split computes) must
    fail the checks that the kernel passes on the same inputs: its bf16
    output equal to the plain float32 output's rounding in under
    SAME_SHARE of the entries (``share``) and, where the kernel is held to
    a tolerance ``tol`` too, entries beyond it in each output of
    ``beyond`` (counts by output name)."""
    beyond = beyond or {}
    note = "".join(f", {n} {key}" for key, n in beyond.items())
    log(f"{name}: one bf16 cast of {what} instead of the split: "
        f"{share:.5f} of the entries equal to the plain output in bf16"
        f"{note}{' entries beyond ' + tol if beyond else ''}")
    if share >= SAME_SHARE or (beyond and min(beyond.values()) == 0):
        raise AssertionError(f"{name}: the checks do not tell one bf16 cast "
                             f"of {what} from the split")


def check_flash(dev, bw):
    """Kernel #5 against its plain version at the serve shapes and around
    them, then its time at S = 2048 beside SDPA (the yardstick)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import flash_attention_ref

    gen = torch.Generator(device=dev).manual_seed(5)
    err = 0.0
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (hq, hkv, sq, skv, d, causal, window, q_offset, dtype)
        (9, 3, 1000, 1000, 64, True, None, 0, bf16),
        (9, 3, 2048, 2048, 64, True, None, 0, bf16),
        (9, 3, 1000, 1000, 64, True, None, 0, f32),
        (9, 3, 777, 777, 64, True, 128, 0, bf16),
        (9, 3, 300, 1300, 64, True, None, 1000, bf16),
        (9, 3, 333, 333, 64, False, None, 0, f32),
        (4, 1, 257, 257, 32, True, 64, 0, f32),
        (4, 2, 130, 130, 128, True, None, 0, f32),
        # every tensor-core instantiation: D = 32, 128, and 16 padded to 32
        (4, 1, 257, 257, 32, True, 64, 0, bf16),
        (4, 2, 130, 130, 128, True, None, 0, bf16),
        (4, 2, 100, 100, 16, True, 24, 0, bf16),
    ]
    for hq, hkv, sq, skv, d, causal, window, off, dtype in cases:
        q = torch.randn((1, hq, sq, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((1, hkv, skv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((1, hkv, skv, d), generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, window=window, q_offset=off)
        o, lse = FA.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        w_o, w_lse = flash_attention_ref(q, k, v, **kw)
        # both sides compute in float32 from the same inputs: float32 o at
        # 3e-5; bf16 o within one bf16 rounding (a relative 2^-7), far
        # inside |o| (about 0.03 at S = 2048), so a wrong P.V shows
        atol, rtol = ((1e-4, 2.0 ** -7) if dtype == torch.bfloat16
                      else (3e-5, 3e-5))
        name = (f"flash_attention Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} D={d} "
                f"causal={causal} window={window} q_offset={off} {dtype}")
        e, rel = _close_or_raise(name, o, w_o, atol, rtol)
        _close_or_raise(name + " lse", lse, w_lse, 3e-5, 3e-5)
        if dtype == torch.bfloat16 and hq == 9 and window is None:
            err = max(err, e)
        note = ""
        if dtype == torch.bfloat16:
            # P V at float32 precision rounds to the same bf16 as the
            # plain float32 o nearly everywhere; one bf16 cast of p would
            # not (shown below at S = 2048)
            note = (f"; {_check_same_share(name, o, w_o):.5f} of o equal "
                    f"to the plain o in bf16")
        log(f"{name}: ok (max abs err {e:.3e}, max rel err {rel:.3e}; "
            f"limit {atol} + {rtol:.3e}|o|{note})")
        if (sq, dtype) == (2048, torch.bfloat16):
            o1, _ = flash_attention_ref(q, k, v, p_terms=1, **kw)
            _single_cast_fails(name, "p", _same_share(o1, w_o))

    # time at the longest serve prompt, one smollm layer, bf16 causal
    hq, hkv, s, d = 9, 3, 2048, 64
    q = torch.randn((1, hq, s, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((1, hkv, s, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((1, hkv, s, d), generator=gen, device=dev).bfloat16()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = s * (s + 1) // 2                        # live (q, k) pairs
    # Q K^T has two bf16 operands; P.V a float32 one (the probabilities)
    qk_flops = pv_flops = 2.0 * d * hq * pairs
    nbytes = 2 * (2 * hq * s * d + 2 * hkv * s * d) + 4 * hq * s
    fwd = lambda: FA.flash_attention(q, k, v)
    lib = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
    # each timed twice: by CUDA events over back-to-back calls, where a
    # slow host can stretch a short call, and by its device time alone
    row = dict(
        ms=cuda_ms(fwd, 20), device_ms=device_rows(fwd, 20)[2] / 20,
        plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v), 5),
        library_ms=cuda_ms(lib, 20),
        library_device_ms=device_rows(lib, 20)[2] / 20,
        **_bound(nbytes, bf16_flops=qk_flops, f32_bf16_flops=pv_flops,
                 bw=bw))
    log(f"flash_attention_fwd [B=1 Hq=9 Hkv=3 S=2048 D=64 bf16 causal]: "
        f"{row['ms']:.4f} ms by CUDA events, {row['device_ms']:.4f} ms of "
        f"device time, plain {row['plain_ms']:.4f} ms, SDPA "
        f"{row['library_ms']:.4f} / {row['library_device_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms by "
        f"{row['bound_by']} (Q K^T {qk_flops / 1e9:.3f} GFLOP bf16 x bf16 "
        f"+ P.V {pv_flops / 1e9:.3f} GFLOP float32 x bf16, three times: "
        f"{row['tc_flops'] / 1e9:.3f} GFLOP at 989 TFLOP/s = "
        f"{row['ops_ms']:.4f} ms; {nbytes / 1e6:.2f} MB = "
        f"{row['bytes_ms']:.4f} ms); "
        f"{(qk_flops + pv_flops) / row['ms'] / 1e9:.2f} TFLOP/s achieved")
    return err, row


def _bound(nbytes, *, bw, bf16_flops=0.0, f32_bf16_flops=0.0):
    """The least time for the work at float32 precision: the larger of its
    bytes at the HBM rate and its products on the bf16 tensor cores, each
    counted by its operand types.  A product of two bf16 operands runs
    once; one with a float32 operand runs as three, against the three bf16
    terms of that operand's exact split (hi + mid + lo).  (No kernel here
    has a product of two float32 operands: its split would take six.)"""
    bytes_ms = nbytes / bw * 1e3
    tc_flops = bf16_flops + 3 * f32_bf16_flops
    ops_ms = tc_flops / BF16_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                ops_ms=ops_ms, tc_flops=tc_flops,
                bound_by="operations" if ops_ms > bytes_ms else "bytes")


def _ssd_inputs(gen, dev, length, h=24, p=64, g=1, n=128, batch=1):
    """One mamba2 layer's SSD operands: x, B, C from unit normals, dt
    from softplus of a normal, a_log = log(linspace(1, 16)), d_skip 1."""
    x = torch.randn((batch, length, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((batch, length, h), generator=gen, device=dev))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    b = torch.randn((batch, length, g, n), generator=gen, device=dev)
    c = torch.randn((batch, length, g, n), generator=gen, device=dev)
    return x, dt, a_log, b, c, torch.ones(h, device=dev)


def check_ssd(dev, bw, chunk: int = 256):
    """Kernel #8 against its plain version at the serve shapes, then its
    time at L = 2048 (no single PyTorch call computes it)."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels.ref import ssd_scan_chunked_ref, ssd_scan_ref

    gen = torch.Generator(device=dev).manual_seed(8)
    err = 0.0
    for length in (1000, 2048, 300):
        x, dt, a_log, b, c, ds = _ssd_inputs(gen, dev, length)
        # float32 operands holding bf16 values: y and state at 3e-4
        f32 = [t.bfloat16().float() for t in (x, b, c)]
        args = (f32[0], dt, a_log, f32[1], f32[2], ds)
        y, st = SS.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        w_y, w_st = ssd_scan_ref(*args, chunk=chunk)
        name = f"ssd_scan L={length} H=24 P=64 N=128 chunk={chunk}"
        e = max(_close_or_raise(name + " f32 y", y, w_y, 3e-4, 3e-4)[0],
                _close_or_raise(name + " f32 state", st, w_st, 3e-4,
                                3e-4)[0])
        # the serve dtype: bf16 x, B, C; state at 3e-4, y after rounding
        # both sides to bf16 (one bf16 ulp is 2^-8 of the value)
        bargs = (x.bfloat16(), dt, a_log, b.bfloat16(), c.bfloat16(), ds)
        y, st = SS.ssd_scan(*bargs, chunk=chunk)
        torch.cuda.synchronize()
        w_y, w_st = ssd_scan_ref(*bargs, chunk=chunk)
        e = max(e, _close_or_raise(name + " bf16 state", st, w_st, 3e-4,
                                   3e-4)[0])
        eb, rel = _close_or_raise(name + " bf16 y", y, w_y, 3e-4, 2.0 ** -7)
        # the split products round y to the same bf16 as the plain
        # float32 y nearly everywhere; one bf16 cast of the scores (and of
        # x dt w and S_in) would not
        share = _check_same_share(name + " bf16 y", y, w_y)
        err = max(err, e)
        log(f"{name}: ok (max abs err {e:.3e} on float32 y and both "
            f"states; bf16 y {eb:.3e}, max rel err {rel:.3e}; {share:.5f} "
            f"of bf16 y equal to the plain y in bf16)")
        if length == 2048:
            y1, st1 = ssd_scan_chunked_ref(*bargs, chunk=chunk, terms=1)
            beyond = {"state": int(((st1 - w_st).abs()
                                    > 3e-4 + 3e-4 * w_st.abs()).sum())}
            _single_cast_fails(name + " bf16 y", "the scores, x dt w and "
                               "S_in", _same_share(y1, w_y), beyond,
                               "3e-4 + 3e-4 |s|")
    # an initial state, a short chunk and several groups (h = 8 heads of
    # 16, zero-padded to 64 by the bf16 route's wrapper), both dtypes
    x, dt, a_log, b, c, ds = _ssd_inputs(gen, dev, 200, h=8, p=16, g=2,
                                         n=64)
    s0 = torch.randn((1, 8, 64, 16), generator=gen, device=dev)
    for dtype, rtol in ((torch.float32, 3e-4), (torch.bfloat16, 2.0 ** -7)):
        args = (x.to(dtype), dt, a_log, b.to(dtype), c.to(dtype), ds)
        got = SS.ssd_scan(*args, chunk=64, state=s0)
        want = ssd_scan_ref(*args, chunk=64, state=s0)
        for gv, wv, what, tol in zip(got, want, ("y", "state"),
                                     (rtol, 3e-4)):
            _close_or_raise(f"ssd_scan with state, G=2 {dtype} {what}", gv,
                            wv, 3e-4, tol)
        log(f"ssd_scan with an initial state, G=2, chunk 64, {dtype}: ok")

    length, h, p, n = 2048, 24, 64, 128
    x, dt, a_log, b, c, ds = _ssd_inputs(gen, dev, length)
    args = (x.bfloat16(), dt, a_log, b.bfloat16(), c.bfloat16(), ds)
    # C B^T has two bf16 operands and is one product per chunk and group
    # (G = 1: the heads share it); the decayed scores times x dt, with dt
    # a scalar per source column folded into the float32 scores, C S_in
    # and B^T (decay dt x) each a float32 and a bf16 operand
    bound = _ssd_fwd_bound(1, length, bw, chunk, h=h, p=p, g=b.shape[2],
                           n=n)
    cb_flops, sx_flops, state_flops, nbytes = (
        bound.pop(key) for key in ("cb_flops", "sx_flops", "state_flops",
                                   "nbytes"))
    rest_flops = sx_flops + state_flops
    scan = lambda: SS.ssd_scan(*args, chunk=chunk)
    rows, _, busy_ms, _ = device_rows(scan, 20)
    row = dict(
        ms=cuda_ms(scan, 20), device_ms=busy_ms / 20,
        plain_ms=cuda_ms(lambda: ssd_scan_ref(*args, chunk=chunk), 5),
        library_ms=None, **bound)
    kernel_name = re.compile(r"::(\w+(?:<\d+>)?)\(")
    phases = ", ".join(f"{kernel_name.search(key)[1]} {ms / 20:.4f} ms"
                       for ms, _, key in rows)
    log(f"ssd_scan [B=1 L=2048 H=24 P=64 G=1 N=128 chunk 256, x bf16]: "
        f"{row['ms']:.4f} ms by CUDA events, {row['device_ms']:.4f} ms of "
        f"device time ({phases}), plain {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']} (C B^T "
        f"{cb_flops / 1e9:.3f} GFLOP bf16 x bf16 + C S_in and B^T (x dt) "
        f"{state_flops / 1e9:.3f} GFLOP and scores (x dt) "
        f"{sx_flops / 1e9:.3f} GFLOP float32 x bf16, three times: "
        f"{row['tc_flops'] / 1e9:.3f} GFLOP at 989 TFLOP/s = "
        f"{row['ops_ms']:.4f} ms; {nbytes / 1e6:.2f} MB = "
        f"{row['bytes_ms']:.4f} ms); "
        f"{(cb_flops + rest_flops) / row['ms'] / 1e9:.2f} TFLOP/s achieved")
    return err, row


def serve_arch(dev, arch: str, kernel: str, seed: int = 0, *,
               reduced: bool = False, max_len: int = SERVE["max_len"],
               n_layers=None, memory=None, flip=None):
    """Serve ``arch`` (at full width, or its ``reduced()`` config, with
    ``n_layers`` layers where given) through Engine.run with ``max_len``
    cache slots: 8 requests of 256-1536 prompt tokens, 32 new tokens
    each, batches of 4; with ``memory`` (1, T, M), the frame or image
    embeddings that every prefill takes, and every cross layer's gate set
    to 1.0 (seeded weights leave it at zero, which would shut the memory
    out).  Counts the kernels' launches around Engine.run alone: one of
    ``kernel`` a request per layer of its kind, or with a memory the
    counts of :func:`_memory_launches` a request and a batched decode
    step.  Then holds every
    emitted token against a solo teacher-forced run on the card: within
    SERVE["gap"] of its max logit or, where ``flip`` is given, the solo
    run's second choice with its top two within ``flip`` of each other (a
    near-tie flipped by the batched run's rounding; each such token is
    logged and counted).  Returns
    ``(model, launches of kernel, times)``, times with the prompts."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import build, layer_plan, layers_of
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_arch(arch).reduced() if reduced else get_arch(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
        arch = f"{arch} ({n_layers} layers)"
    if reduced:
        arch = f"{arch} reduced"
    bundle = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = bundle.init(seed, dev)
    if memory is not None:
        with torch.no_grad():
            for pname, prm in model.named_parameters():
                if pname.endswith(".gate"):
                    prm.fill_(1.0)
    torch.cuda.synchronize()
    log(f"{arch}: {cfg.n_layers} layers x d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, {bundle.num_params(model) / 1e6:.2f}M parameters, "
        f"random init in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    lens = rng.integers(SERVE["min_len"], SERVE["max_len_prompt"] + 1,
                        SERVE["requests"])
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in lens]
    eng = Engine(cfg, model, ServeConfig(max_batch=SERVE["max_batch"],
                                         max_len=max_len),
                 device=dev)
    rids = [eng.submit(pr, max_new=SERVE["max_new"]) for pr in prompts]
    mem = None if memory is None else torch.as_tensor(memory, device=dev)
    FA.reset_launches()
    SS.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run(memory=mem)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {**FA.LAUNCHES, **SS.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    kind = "ssd" if kernel == "ssd_scan" else "attn"
    per_req, per_step = (
        _memory_launches(cfg) if memory is not None
        else (sum(k == kind for k in layer_plan(cfg).kinds), 0))
    n_batches = -(-len(prompts) // SERVE["max_batch"])
    want = {k: (per_req * len(prompts)
                + per_step * n_batches * (SERVE["max_new"] - 1)
                if k == kernel else 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches} in Engine.run, "
                             f"expected {want}")
    n_tok = sum(len(v) for v in out.values())
    st = eng.stats
    decode_ms = sum(st["decode_ms"]) / sum(st["decode_steps"])
    log(f"{arch} serve: {len(out)} requests, {n_tok} tokens in "
        f"{seconds:.3f} s ({n_tok / seconds:.1f} tok/s, "
        f"{(sum(lens) + n_tok) / seconds:.0f} tok/s with prompts); prefill "
        f"{np.mean(st['prefill_ms']):.2f} ms per request; batched decode "
        f"step {decode_ms:.3f} ms at batch {SERVE['max_batch']}; peak "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    each = [(int(n), round(ms, 2)) for n, ms in zip(lens, st["prefill_ms"])]
    steps = [round(ms / k, 3)
             for ms, k in zip(st["decode_ms"], st["decode_steps"])]
    log(f"{arch} serve: (prompt tokens, prefill ms) in serving order "
        f"{each}; decode ms per step by batch {steps}")

    # the same requests again through a new Engine: a warm run
    eng2 = Engine(cfg, model, ServeConfig(max_batch=SERVE["max_batch"],
                                          max_len=max_len),
                  device=dev)
    for pr in prompts:
        eng2.submit(pr, max_new=SERVE["max_new"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng2.run(memory=mem)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    st2 = eng2.stats
    warm_decode = sum(st2["decode_ms"]) / sum(st2["decode_steps"])
    each = [(int(n), round(ms, 2)) for n, ms in zip(lens, st2["prefill_ms"])]
    log(f"{arch} serve, warm run: {n_tok} tokens in {warm_s:.3f} s "
        f"({n_tok / warm_s:.1f} tok/s); prefill "
        f"{np.mean(st2['prefill_ms']):.2f} ms per request {each}; batched "
        f"decode step {warm_decode:.3f} ms")

    # solo teacher-forced runs on the card (not counted above)
    worst, top, flips = 0.0, 0.0, []
    for rid, prompt in zip(rids, prompts):
        toks = out[rid]
        if len(toks) != SERVE["max_new"]:
            raise AssertionError(f"{arch} req {rid}: {len(toks)} tokens")
        tok_t = torch.tensor(toks, device=dev)
        logits, cache = bundle.prefill(
            model, torch.as_tensor(prompt[None], device=dev).long(),
            memory=mem, cache_slots=max_len)
        lg = [logits[0, -1]]
        finite = [torch.isfinite(logits).all()]
        finite += [torch.isfinite(c["mixer"]["state"]).all()
                   for c in layers_of(cache) if "state" in c["mixer"]]
        for i in range(len(toks) - 1):
            pos = torch.full((1, 1), len(prompt) + i, device=dev)
            logits, cache = bundle.decode_step(model, cache,
                                               tok_t[i].view(1, 1).long(),
                                               pos)
            lg.append(logits[0, 0])
            finite.append(torch.isfinite(logits).all())
        lg = torch.stack(lg)
        gaps = lg.max(-1).values - lg.gather(1, tok_t[:, None].long())[:, 0]
        if not bool(torch.stack(finite).all()):
            raise AssertionError(f"{arch} req {rid}: non-finite logits or "
                                 f"recurrent state")
        g = float(gaps.max())
        worst = max(worst, g)
        top2, idx2 = lg.topk(2, -1)
        top = max(top, float(top2[:, 0].abs().max()))
        for i in torch.nonzero(gaps > SERVE["gap"]).flatten().tolist():
            second = int(idx2[i, 1]) == toks[i]
            gap2 = float(top2[i, 0] - top2[i, 1])
            flips.append((rid, i, float(top2[i, 0]), gap2))
            if flip is None or not (second and gap2 <= flip):
                raise AssertionError(
                    f"{arch} req {rid}: an emitted token is "
                    f"{float(gaps[i]):.4f} below the solo max logit at step "
                    f"{i} (max logit {float(top2[i, 0]):.4f}, the solo "
                    f"run's {'second' if second else 'third or later'} "
                    f"choice)")
    states = {k: "SSD" if k == "ssd" else "RG-LRU"
              for k in layer_plan(cfg).kinds if k in ("ssd", "rglru")}
    if flips:
        log(f"{arch}: tokens beyond {SERVE['gap']}, each the solo run's "
            f"second choice (request, step, max logit, top-two gap): "
            f"{flips}")
    log(f"{arch}: every emitted token within {worst:.4f} of the solo "
        f"teacher-forced max logit (limit {SERVE['gap']}"
        f"{f', or a flip of a top two within {flip}' if flip else ''}: "
        f"{len(flips)} of {n_tok} tokens; max |logit| {top:.3f}); logits"
        f"{''.join(f' and {v} states' for v in states.values())} finite; "
        f"{per_req} launches of {kernel} per request"
        f"{f' and {per_step} per decode step' if per_step else ''}")
    return model, launches[kernel], dict(
        seconds=seconds, tok_s=n_tok / seconds, decode_ms=decode_ms,
        prefill_ms=float(np.mean(st["prefill_ms"])), peak=peak,
        prompts=prompts, tokens=[out[r] for r in rids])


def profile_serve(dev, model, arch: str, seed: int = 1):
    """Where a full-width prefill's and a batched decode step's device
    time goes (torch.profiler, by kernel, and the idle share)."""
    from repro_torch.models import build
    cfg = model.cfg
    bundle = build(cfg)
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 1536)),
                             device=dev)
    profile_device(lambda: bundle.prefill(model, prompt,
                                          cache_slots=SERVE["max_len"]),
                   1, "prefill", f"profile {arch} prefill S=1536")
    caches = [bundle.prefill(model, prompt[:, :n], cache_slots=2048)[1]
              for n in (256, 700, 1100, 1536)]
    cache = bundle.concat_caches(caches)
    tok = torch.zeros((4, 1), dtype=torch.long, device=dev)
    pos = torch.tensor([[256], [700], [1100], [1536]], device=dev)
    steps = 8

    def decode():
        nonlocal cache
        for i in range(steps):
            _, cache = bundle.decode_step(model, cache, tok, pos + i)

    decode()          # warm
    profile_device(decode, steps, "decode step",
                   f"profile {arch} decode batch 4")


# ---------------------------------------------------------------------------
# The training path: kernels #6 and #7, then smollm-135m trained at full
# width
# ---------------------------------------------------------------------------

TRAIN = dict(steps=8, seq=2048, batch=8, lr=1e-3, ckpt_every=4, crash_at=6)
TRAIN_DIR = ROOT / "build" / "train_smoke"


# the bf16 instantiations of the tensor-core kernels: #5, #6, #7 at
# D = 32 / 64 / 128 / 256, #8's two product kernels at N = 64 / 128 / 256
TC_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
              "ssd_states_kernel", "ssd_output_kernel", "ssd_bwd_sums_kernel",
              "ssd_bwd_rows_kernel", "ssd_bwd_cols_kernel")
# bf16 instantiations: #5, #6, #7 at four head sizes and #5, #7 again for
# the prob_bf16 variant; #8's two product kernels and 8''s sums kernel at
# three d_state; the rows and columns kernels of 8' at three d_state
# times four head sizes
TC_INSTANCES = 4 * 3 + 4 * 2 + 3 * 3 + 2 * 3 * 4


@functools.cache
def tc_usage():
    """``{instance: (HGMMA, SASS instructions, registers, stack bytes)}``
    of each bf16 instantiation of the product kernels of #5, #6, #7, #8
    and 8' in the built library (``flash_fwd_kernel<256, 0>`` and so
    on), from the CUDA toolkit's cuobjdump; None where it has none."""
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels._build import BUILD_DIR
    tool = shutil.which("cuobjdump")
    if tool is None and CUDA_HOME:
        tool = str(Path(CUDA_HOME) / "bin" / "cuobjdump")
    if tool is None or not Path(tool).exists():
        return None
    lib = str(BUILD_DIR / "repro_torch_kernels.so")

    def dump(flag):
        return subprocess.run([tool, flag, lib], capture_output=True,
                              text=True, timeout=300, check=True).stdout

    kernel = re.compile(rf"({'|'.join(TC_KERNELS)})ILi(\d+)E(?:Li(\d+)E)?"
                        rf"(?:Lb([01])E)?")

    def instance(m):
        return f"{m.group(1)}<{', '.join(filter(None, m.groups()[1:]))}>"

    instruction = re.compile(r"/\*[0-9a-f]{4,}\*/\s+\S")
    hgmma, total = {}, {}
    for part in dump("-sass").split("Function : ")[1:]:
        m = kernel.search(part.split(None, 1)[0])
        if m:
            hgmma[instance(m)] = part.count("HGMMA")
            total[instance(m)] = len(instruction.findall(part))
    usage = {}
    for m in re.finditer(r"Function (\S+):\s+REG:(\d+) STACK:(\d+)",
                         dump("-res-usage")):
        k = kernel.search(m.group(1))
        if k:
            usage[instance(k)] = (int(m.group(2)), int(m.group(3)))
    return {name: (hgmma[name], total[name], *usage.get(name, (None, None)))
            for name in hgmma}


def check_tensor_cores():
    """The wgmma instructions (HGMMA in the SASS), all SASS instructions,
    and the registers and stack of each bf16 instantiation of the product
    kernels of #5, #6, #7, #8 and 8' in the built library
    (:func:`tc_usage`); raises if an instantiation has no HGMMA."""
    usage = tc_usage()
    if usage is None:
        log("tensor cores: no cuobjdump in the CUDA toolkit, not checked")
        return
    for name in sorted(usage):
        hgmma, total, regs, stack = usage[name]
        log(f"tensor cores: {name}: {hgmma} HGMMA among {total} SASS "
            f"instructions, {regs} registers, {stack} bytes of stack")
    if len(usage) != TC_INSTANCES or not all(u[0] for u in usage.values()):
        raise AssertionError(f"the bf16 kernels must run on the tensor "
                             f"cores: HGMMA counts "
                             f"{ {k: u[0] for k, u in usage.items()} }")


def _single_cast_bwd(q, k, v, do, lse, dsum, kw, w_dq32, w_dk, w_dv):
    """#6 and #7's plain recompute with p and ds each cast to one bf16
    before their products: the share of its bf16 dq equal to the plain
    float32 dq rounded to bf16, and its dk and dv entries beyond phase
    14's 2e-4 + 2e-5 |d|."""
    from repro_torch.kernels import ref
    scale = q.shape[-1] ** -0.5
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkh, dvh = torch.zeros_like(w_dk), torch.zeros_like(w_dv)
    dof = do.float()
    for k0, qf, kt, pr, ds in ref._bwd_tiles(
            q, k, v, do, lse, dsum, kw["causal"], kw["window"],
            kw["q_offset"], scale, 64):
        n = kt.shape[2]
        pb, dsb = pr.bfloat16().float(), ds.bfloat16().float()
        dq += (dsb @ kt) * scale
        dkh[:, :, k0:k0 + n] = (dsb.transpose(-1, -2) @ qf) * scale
        dvh[:, :, k0:k0 + n] = pb.transpose(-1, -2) @ dof
    beyond = {what: int(((g - w).abs() > 2e-4 + 2e-5 * w.abs()).sum())
              for what, g, w in (("dk", dkh, w_dk), ("dv", dvh, w_dv))}
    return _same_share(dq.to(q.dtype), w_dq32), beyond


def check_flash_bwd(dev, bw):
    """Kernels #6 and #7 against their plain versions around smollm's
    training shape, then their times at it beside SDPA's backward (the
    yardstick of both together)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(6)
    errs = {"flash_attention_dq": 0.0, "flash_attention_dkv": 0.0}
    cases = [  # (b, hq, hkv, sq, skv, d, causal, window, q_offset)
        (8, 9, 3, 2048, 2048, 64, True, None, 0),
        (2, 9, 3, 1000, 1000, 64, True, None, 0),
        (1, 9, 3, 777, 777, 64, True, 128, 0),
        (1, 9, 3, 300, 1300, 64, True, None, 1000),
        (1, 4, 1, 257, 257, 32, True, 64, 0),
        (1, 4, 2, 130, 130, 128, True, None, 0),
        (2, 6, 2, 333, 333, 64, False, None, 0),
        (1, 8, 1, 200, 200, 64, True, None, 0),
    ]
    # each case in bf16 (the tensor-core kernels) and float32 (the CUDA-
    # core kernels of flash_attention_bwd_fma.cu)
    for (b, hq, hkv, sq, skv, d, causal, window, off), dtype in (
            (case, dtype) for case in cases
            for dtype in (torch.bfloat16, torch.float32)):
        q, do = (torch.randn((b, hq, sq, d), generator=gen,
                             device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn((b, hkv, skv, d), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=off)
        o, lse = FA.flash_attention(q, k, v, **kw)
        dsum = (do.float() * o.float()).sum(-1, keepdim=True)
        dq = FA.flash_attention_dq(q, k, v, do, lse, dsum, **kw)
        dkh, dvh = FA.flash_attention_dkv(q, k, v, do, lse, dsum, **kw)
        torch.cuda.synchronize()
        # the plain version's float32 dq before its cast to q's dtype
        # (the same arithmetic: it upcasts its operands first)
        w_dq32 = ref.flash_attention_dq_ref(
            *(t.float() for t in (q, k, v, do)), lse, dsum, **kw)
        w_dk, w_dv = ref.flash_attention_dkv_ref(q, k, v, do, lse, dsum, **kw)
        name = (f"flash_attention bwd B={b} Hq={hq} Hkv={hkv} Sq={sq} "
                f"Skv={skv} D={d} causal={causal} window={window} "
                f"q_offset={off} {dtype}")
        # both sides sum float32 products of the same inputs: float32 dq
        # at 2e-5; bf16 dq within one bf16 rounding; dk, dv stay float32
        # per q head on both sides (longer sums: 2e-4 + 2e-5 |d|)
        atol, rtol = ((1e-4, 2.0 ** -7) if dtype == torch.bfloat16
                      else (2e-5, 2e-5))
        e_dq, rel = _close_or_raise(name + " dq", dq, w_dq32.to(dtype),
                                    atol, rtol)
        e_kv = max(_close_or_raise(name + " dk", dkh, w_dk, 2e-4, 2e-5)[0],
                   _close_or_raise(name + " dv", dvh, w_dv, 2e-4, 2e-5)[0])
        errs["flash_attention_dq"] = max(errs["flash_attention_dq"], e_dq)
        errs["flash_attention_dkv"] = max(errs["flash_attention_dkv"], e_kv)
        note = ""
        if dtype == torch.bfloat16:
            # ds K at float32 precision rounds to the same bf16 as the
            # plain float32 dq nearly everywhere; one bf16 cast of ds
            # would not (shown below at the training shape)
            share = _check_same_share(name + " dq", dq, w_dq32)
            note = f"; {share:.5f} of dq equal to the plain dq in bf16"
        log(f"{name}: ok (dq max abs err {e_dq:.3e}, max rel err "
            f"{rel:.3e}; dk, dv max abs err {e_kv:.3e}{note})")
        if (b, sq, dtype) == (8, 2048, torch.bfloat16):
            share, beyond = _single_cast_bwd(q, k, v, do, lse, dsum, kw,
                                             w_dq32, w_dk, w_dv)
            _single_cast_fails(name + " dq", "p and ds", share, beyond,
                               "2e-4 + 2e-5 |d|")
    # the whole backward with a head of 16, zero-padded to 32 and cut back
    for dtype, atol, rtol in ((torch.float32, 2e-4, 2e-5),
                              (torch.bfloat16, 1e-4, 2.0 ** -7)):
        q, do = (torch.randn((1, 4, 100, 16), generator=gen,
                             device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn((1, 2, 100, 16), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        o, lse = FA.flash_attention(q, k, v, window=24)
        got = FA.flash_attention_bwd(q, k, v, o, lse, do, window=24)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=24)
        for g, w, what in zip(got, want, ("dq", "dk", "dv")):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"padded backward {what}: {g.shape} "
                                     f"{g.dtype}")
            # bf16 outputs within one bf16 rounding of the plain version's
            _close_or_raise(f"padded backward D=16 {dtype} {what}", g, w,
                            atol, rtol)
        log(f"flash_attention_bwd with a head of 16 (padded to 32), "
            f"{dtype}: ok")

    # one smollm layer of the training step: B=8, S=2048, bf16, causal
    b, hq, hkv, s, d = 8, 9, 3, 2048, 64
    q, do = (torch.randn((b, hq, s, d), generator=gen,
                         device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    o, lse = FA.flash_attention(q, k, v)
    dsum = (do.float() * o.float()).sum(-1, keepdim=True)
    args = (q, k, v, do, lse, dsum)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    o_sdpa = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, is_causal=True, enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(o_sdpa, (qg, kg, vg), do,
                                           retain_graph=True)
    # each call timed twice: back to back by CUDA events, where a slow host
    # can stretch a short call, and by its device time alone
    reps = 20
    sdpa_bwd_ms = cuda_ms(sdpa_bwd, reps)
    _, _, busy_ms, lead_us = device_rows(sdpa_bwd, reps)
    sdpa_dev_ms = busy_ms / reps
    log(f"SDPA backward [B=8 Hq=9 Hkv=3 S=2048 D=64 bf16 causal, GQA]: "
        f"{sdpa_bwd_ms:.4f} ms per call by CUDA events, {sdpa_dev_ms:.4f} "
        f"ms of device time per call (torch.profiler, every launch "
        f"recorded; kernels start {lead_us:.1f} us or more after their "
        f"launch calls)")
    pairs = s * (s + 1) // 2
    mm = 2.0 * d * hq * b * pairs      # one product over the live pairs
    in_bytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d) \
        + 8 * b * hq * s
    rows = {}
    # Q K^T and dO V^T have two bf16 operands; #6's ds K and #7's p^T dO
    # and ds^T Q one float32 operand (p or ds) and one bf16
    for kname, fn, plain, split_mm, out_bytes in (
            ("flash_attention_dq", FA.flash_attention_dq,
             ref.flash_attention_dq_ref, 1, 2 * b * hq * s * d),
            ("flash_attention_dkv", FA.flash_attention_dkv,
             ref.flash_attention_dkv_ref, 2, 2 * 4 * b * hq * s * d)):
        ev_ms = cuda_ms(lambda: fn(*args), 20)
        _, _, busy_ms, lead_us = device_rows(lambda: fn(*args), reps)
        rows[kname] = dict(
            ms=ev_ms, device_ms=busy_ms / reps,
            plain_ms=cuda_ms(lambda: plain(*args), 3),
            library_ms=sdpa_bwd_ms, library_device_ms=sdpa_dev_ms,
            **_bound(in_bytes + out_bytes, bf16_flops=2 * mm,
                     f32_bf16_flops=split_mm * mm, bw=bw))
        r = rows[kname]
        log(f"{kname} [B=8 Hq=9 Hkv=3 S=2048 D=64 bf16 causal]: "
            f"{r['ms']:.4f} ms by CUDA events, {r['device_ms']:.4f} ms of "
            f"device time (every launch recorded, kernels start "
            f"{lead_us:.1f} us or more after their launch calls); plain "
            f"{r['plain_ms']:.4f} ms; SDPA backward (dq, "
            f"dk, dv together) {sdpa_bwd_ms:.4f} / {sdpa_dev_ms:.4f} ms; "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} (Q K^T and dO "
            f"V^T {2 * mm / 1e9:.3f} GFLOP bf16 x bf16 + {split_mm} "
            f"product(s) on float32 p or ds {split_mm * mm / 1e9:.3f} GFLOP "
            f"float32 x bf16, three times: {r['tc_flops'] / 1e9:.3f} GFLOP "
            f"at 989 TFLOP/s = {r['ops_ms']:.4f} ms; "
            f"{(in_bytes + out_bytes) / 1e6:.2f} MB = {r['bytes_ms']:.4f} "
            f"ms); {r['tc_flops'] / r['device_ms'] / 1e9:.1f} TFLOP/s of "
            f"tensor-core work achieved")
    pair = sum(r["device_ms"] for r in rows.values())
    log(f"flash-attention backward, #6 and #7 together: {pair:.4f} ms of "
        f"device time against SDPA backward's {sdpa_dev_ms:.4f} ms "
        f"({pair / sdpa_dev_ms:.2f}x)")
    # kernel #5 at the same shape beside SDPA's forward: reads q, k, v,
    # writes o and lse
    fwd_fn = lambda: FA.flash_attention(q, k, v)
    sdpa_fwd = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    fwd_b = _bound(in_bytes - 4 * b * hq * s, bf16_flops=mm,
                   f32_bf16_flops=mm, bw=bw)
    fwd = dict(train_ms=cuda_ms(fwd_fn, 20),
               train_device_ms=device_rows(fwd_fn, reps)[2] / reps,
               train_library_ms=cuda_ms(sdpa_fwd, 20),
               train_library_device_ms=device_rows(sdpa_fwd, reps)[2] / reps,
               train_bound_ms=fwd_b["bound_ms"])
    log(f"flash_attention_fwd [B=8 Hq=9 Hkv=3 S=2048 D=64 bf16 causal]: "
        f"{fwd['train_ms']:.4f} ms by CUDA events, "
        f"{fwd['train_device_ms']:.4f} ms of device time; SDPA forward "
        f"{fwd['train_library_ms']:.4f} / "
        f"{fwd['train_library_device_ms']:.4f} ms; bound "
        f"{fwd_b['bound_ms']:.4f} ms by {fwd_b['bound_by']} "
        f"({fwd_b['tc_flops'] / 1e9:.3f} GFLOP of tensor-core work); "
        f"{fwd_b['tc_flops'] / fwd['train_device_ms'] / 1e9:.1f} TFLOP/s "
        f"of tensor-core work achieved")
    check_tensor_cores()
    return errs, rows, fwd


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def train_smollm(dev):
    """Phase 15: smollm-135m trained at full width through the
    launcher's entry point; launch counts, losses, crash and resume, a
    card-vs-CPU step, timings and a profile."""
    import shutil
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.train import train
    from repro_torch.train import (TrainStepConfig, init_train_state,
                                   make_train_step)

    cfg = get_arch("smollm-135m")
    steps = TRAIN["steps"]
    tokens = TRAIN["seq"] * TRAIN["batch"]
    kw = dict(steps=steps, seq=TRAIN["seq"],
              batch=TRAIN["batch"], lr=TRAIN["lr"],
              ckpt_every=TRAIN["ckpt_every"], log_every=1, device=dev)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, state = train("smollm-135m", ckpt_dir=str(TRAIN_DIR / "a"),
                           **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(FA.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n = len(trainer.history)
    want = {"flash_attention_fwd": 60 * n, "flash_attention_dq": 30 * n,
            "flash_attention_dkv": 30 * n}
    if n != steps or launches != want:
        raise AssertionError(f"train: {n} steps, launches {launches}, "
                             f"expected {want}")
    losses = [h.loss for h in trainer.history]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: non-finite loss in {losses}")
    if abs(losses[0] - np.log(cfg.vocab)) > 0.5:
        raise AssertionError(f"train: first loss {losses[0]:.4f} is not "
                             f"within 0.5 of ln {cfg.vocab}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")
    warm = sorted(h.seconds for h in trainer.history[1:])
    warm_ms = warm[len(warm) // 2] * 1e3
    log(f"smollm-135m train: {n} steps of {TRAIN['batch']} x {TRAIN['seq']} "
        f"tokens in {seconds:.2f} s (checkpoints every "
        f"{TRAIN['ckpt_every']} included); losses "
        f"{[round(x, 4) for x in losses]}; step ms "
        f"{[round(h.seconds * 1e3, 1) for h in trainer.history]}; warm step "
        f"(median of steps 1-{n - 1}) {warm_ms:.1f} ms, "
        f"{tokens / warm_ms * 1e3:.0f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches per step "
        f"{ {k: v // n for k, v in launches.items()} }")
    shutil.rmtree(TRAIN_DIR / "a", ignore_errors=True)

    # crash at step 6, resume from the step-4 checkpoint, replay
    crashed = []

    def fault(step):
        if step == TRAIN["crash_at"] and not crashed:
            crashed.append(step)
            return "crash"
        return None

    tr2, state2 = train("smollm-135m", ckpt_dir=str(TRAIN_DIR / "b"),
                        fault_hook=fault, **kw)
    replay = [h.step for h in tr2.history]
    if tr2.restarts != 1 or int(state2["step"]) != steps:
        raise AssertionError(f"crash run: restarts {tr2.restarts}, step "
                             f"{int(state2['step'])}, steps {replay}")
    last = tr2.history[-1].loss
    if not np.isclose(last, losses[-1], rtol=1e-4, atol=0.0):
        raise AssertionError(f"crash run: last loss {last} vs uncrashed "
                             f"{losses[-1]}")
    log(f"smollm-135m crash at step {TRAIN['crash_at']} and resume: steps "
        f"{replay}; last loss {last:.6f} vs uncrashed {losses[-1]:.6f} "
        f"(rel {abs(last - losses[-1]) / abs(losses[-1]):.2e}, limit 1e-4)")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    del state2, tr2

    # one step under the profiler, on the trained state
    batch = trainer._device_batch(steps)
    rows, wall_ms, busy_ms = profile_device(
        lambda: trainer.step_fn(state, batch), 1, "step",
        "profile smollm-135m train step")
    if busy_ms > 0:
        shares = {kname: sum(ms for ms, _, key in rows if kname in key)
                  / busy_ms
                  for kname in ("flash_fwd_kernel", "flash_dq_kernel",
                                "flash_dkv_kernel")}
        log(f"profile smollm-135m train step: device busy {busy_ms:.2f} ms "
            f"of {wall_ms:.2f} ms wall (idle share "
            f"{1.0 - busy_ms / wall_ms:.3f}); shares of device time: #5 "
            f"{shares['flash_fwd_kernel']:.3f}, #6 "
            f"{shares['flash_dq_kernel']:.3f}, #7 "
            f"{shares['flash_dkv_kernel']:.3f}")
    del state, trainer

    # the card against the CPU: full width cut to 4 layers, B=1, S=256
    cfg4 = cfg.replace(n_layers=4)
    ts = TrainStepConfig()
    gpu_state = init_train_state(cfg4, 0, ts, dev)
    cpu_state = _tree_to(gpu_state, "cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (1, 256))
    tok = tok.astype(np.int32)
    _, m_gpu = make_train_step(cfg4, dev, ts)(gpu_state, {"tokens": tok})
    _, m_cpu = make_train_step(cfg4, "cpu", ts)(cpu_state, {"tokens": tok})
    lg, lc = float(m_gpu["loss"]), float(m_cpu["loss"])
    ng, nc = float(m_gpu["grad_norm"]), float(m_cpu["grad_norm"])
    # bf16 activations, rounded by cuBLAS on the card and by the CPU's
    # kernels elsewhere: loss within 5e-3, gradient norm within 1e-2
    if not (abs(lg - lc) <= 5e-3 and abs(ng - nc) <= 1e-2 * nc):
        raise AssertionError(f"card vs CPU step: loss {lg} vs {lc}, grad "
                             f"norm {ng} vs {nc}")
    log(f"smollm-135m (4 layers, B=1, S=256) one step, card vs CPU: loss "
        f"{lg:.6f} vs {lc:.6f} (limit 5e-3), grad norm {ng:.6f} vs "
        f"{nc:.6f} (rel {abs(ng - nc) / nc:.2e}, limit 1e-2)")
    return launches, dict(warm_ms=warm_ms, tok_s=tokens / warm_ms * 1e3,
                          peak=peak)


# ---------------------------------------------------------------------------
# The paper's topology families and the fault model: phases 16-18
# ---------------------------------------------------------------------------

# the reference's analytic thetas (repro.core.traffic.saturation_report,
# engine "numpy"), the expected values of phase 16
FAMILY_THETAS = {
    ("demi_pn16", "uniform", "minimal"): 8.5,
    ("demi_pn16", "uniform", "ugal"): 8.5,
    ("oft4", "uniform", "minimal"): 5.0,
    ("oft4", "uniform", "ugal"): 5.0,
    ("torus2d_8x16", "uniform", "minimal"): 0.49609375,
    ("torus2d_8x16", "uniform", "ugal"): 0.49609375,
    ("dragonfly3", "uniform", "minimal"): 2.2773512476007673,
    ("dragonfly3", "uniform", "ugal"): 2.2773512476007673,
    ("torus2d_8x16", "tornado", "ugal"): 0.41471354166666663,
}
# three rows of benchmarks/sim_bench.py::SIM_CASES with their own
# parameters: (graph, pattern, sim routing, load grid, steps, refine)
SIM_ROWS = (("demi_pn16", "uniform", "minimal", (0.90, 1.06), 64, 2),
            ("oft4", "uniform", "ugal_threshold(0)", (0.90, 1.06), 96, 2),
            ("torus2d_8x16", "tornado", "ugal_threshold(0)", (0.90, 1.06),
             320, 3))
# BENCH_6.json's degradation rows (benchmarks/fault_bench.py: uniform,
# k = 0, 1, 2, 5 link failures, 4 trials, seed 0), rounded there to six
# digits; it records the same curves under minimal and ugal for every
# graph (uniform traffic: the ugal blend is pure minimal)
BENCH6_K = (0, 1, 2, 5)
BENCH6_ROWS = {
    "pn16": {
        "mean_theta": [6.971407, 6.954706, 6.937996, 6.903575],
        "worst_theta": [6.971407, 6.954706, 6.937996, 6.902914],
        "best_theta": [6.971407, 6.954706, 6.937996, 6.905339],
        "p10": [6.971407, 6.954706, 6.937996, 6.90294],
        "p50": [6.971407, 6.954706, 6.937996, 6.903024],
        "p90": [6.971407, 6.954706, 6.937996, 6.904651],
    },
    "demi_pn16": {
        "mean_theta": [8.5, 8.02952, 8.013534, 7.982969],
        "worst_theta": [8.5, 8.02952, 7.995097, 7.965829],
        "best_theta": [8.5, 8.02952, 8.02952, 8.02952],
        "p10": [8.5, 8.02952, 7.996568, 7.966413],
        "p50": [8.5, 8.02952, 8.01476, 7.968264],
        "p90": [8.5, 8.02952, 8.02952, 8.011289],
    },
    "oft4": {
        "mean_theta": [5.0, 4.0, 3.911397, 3.33186],
        "worst_theta": [5.0, 4.0, 3.870533, 2.87797],
        "best_theta": [5.0, 4.0, 3.952261, 3.762317],
        "p10": [5.0, 4.0, 3.870533, 2.914579],
        "p50": [5.0, 4.0, 3.911397, 3.343577],
        "p90": [5.0, 4.0, 3.952261, 3.739768],
    },
    "torus2d_8x16": {
        "mean_theta": [0.496094, 0.428256, 0.392447, 0.353193],
        "worst_theta": [0.496094, 0.364706, 0.35244, 0.341207],
        "best_theta": [0.496094, 0.491807, 0.489407, 0.361721],
        "p10": [0.496094, 0.364706, 0.355761, 0.344184],
        "p50": [0.496094, 0.428256, 0.36397, 0.354923],
        "p90": [0.496094, 0.491807, 0.451915, 0.360819],
    },
    "dragonfly3": {
        "mean_theta": [2.277351, 2.142933, 2.11705, 2.041241],
        "worst_theta": [2.277351, 2.052739, 2.052739, 1.955211],
        "best_theta": [2.277351, 2.226016, 2.223527, 2.196189],
        "p10": [2.277351, 2.06057, 2.06057, 1.965475],
        "p50": [2.277351, 2.14649, 2.095967, 2.006781],
        "p90": [2.277351, 2.222452, 2.190396, 2.144574],
    },
}
BENCH6_TOL = 1e-6
# BENCH_6.json's live row: torus2d_8x16, minimal, random_faults(k_links=2,
# seed=0); its fault set, analytic degraded theta and static knee
BENCH6_LIVE = dict(faults="links[15-127,46-62]", theta_analytic=0.487234,
                   theta_static=0.500633, steps=648)


def build_family(name: str):
    """The port's own graph of each family name of phases 16-18."""
    from repro_torch.core import demi_pn_graph, dragonfly_graph, oft_graph
    from repro_torch.core import pn_graph
    from repro_torch.fabric import torus3d_graph
    return {"pn16": lambda: pn_graph(16),
            "pn31": lambda: pn_graph(31),
            "demi_pn37": lambda: demi_pn_graph(37),
            "dragonfly9": lambda: dragonfly_graph(9),
            "torus3d_444": lambda: torus3d_graph(4, 4, 4),
            "demi_pn16": lambda: demi_pn_graph(16),
            "oft4": lambda: oft_graph(4),
            "torus2d_8x16": lambda: torus3d_graph(8, 16, 1),
            "dragonfly3": lambda: dragonfly_graph(3),
            "demi_pn64": lambda: demi_pn_graph(64),
            "oft27": lambda: oft_graph(27),
            "torus3d_16": lambda: torus3d_graph(16, 16, 16)}[name]()


def _sources_ecc(g, dev) -> int:
    """The largest BFS distance from the graph's active sources (the leaf
    set of an indirect network): the depth of every sweep over them."""
    from repro_torch.core import bfs_distances_batched
    leaf = g.meta.get("leaf_mask")
    src = np.arange(g.n) if leaf is None else np.nonzero(leaf)[0]
    return int(bfs_distances_batched(g, src, dev).max())


def _mask_gemm_sweeps(name, launches: dict, ecc: int, blocks: int) -> int:
    """The arc-load sweeps behind ``launches`` of #3 / #4: each source
    block launches #3 once per BFS level (ecc + 1) and #4 once per
    dependency level (ecc)."""
    fwd, bwd = launches["frontier_step"], launches["backward_step"]
    per_fwd, per_bwd = blocks * (ecc + 1), blocks * ecc
    sweeps = fwd // per_fwd
    if sweeps < 1 or fwd != sweeps * per_fwd or bwd != sweeps * per_bwd:
        raise AssertionError(
            f"{name}: launches {launches} are not whole sweeps of "
            f"{blocks} source block(s) at depth {ecc}")
    return sweeps


def _source_blocks(g) -> int:
    from repro_torch.core.utilization import _source_block_rows
    leaf = g.meta.get("leaf_mask")
    n_src = g.n if leaf is None else int(np.count_nonzero(leaf))
    return -(-n_src // _source_block_rows(g.n))


def check_families(dev):
    """Phase 16: the paper's comparison on the card, every family built
    by the port itself."""
    from repro_torch.core import saturation_report
    from repro_torch.kernels import mask_gemm as MG
    from repro_torch.kernels import sim_step as K
    from repro_torch.sim import SimConfig, saturation_sweep

    launches = {"frontier_step": 0, "backward_step": 0}
    for name in ("demi_pn16", "oft4", "torus2d_8x16", "dragonfly3"):
        g = build_family(name)
        ecc = _sources_ecc(g, dev)
        for routing in ("minimal", "ugal"):
            want = FAMILY_THETAS[(name, "uniform", routing)]
            MG.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # all sources: demi-PN and OFT would take the orbit
            # shortcut under "auto" (phase 19)
            rep = saturation_report(g, "uniform", routing=routing,
                                    engine="fused", device=dev)
            seconds = time.perf_counter() - t0
            got = dict(MG.LAUNCHES)
            sweeps = _mask_gemm_sweeps(f"{name} {routing}", got, ecc,
                                       _source_blocks(g))
            rel = abs(rep.theta - want) / want
            log(f"{name} ({g.n} routers, {2 * g.num_edges} arcs) uniform "
                f"{routing}: theta {rep.theta!r} vs reference {want!r}, "
                f"rel err {rel:.3e}; {seconds:.3f} s; launches {got} "
                f"({sweeps} sweeps of depth {ecc})")
            if not rel <= THETA_RTOL:
                raise AssertionError(f"{name} {routing} theta rel err {rel}")
            for key in launches:
                launches[key] += got[key]

    # full width: fused against dense on the card
    for name in ("demi_pn64", "oft27", "torus3d_16"):
        g = build_family(name)
        ecc = _sources_ecc(g, dev)
        blocks = _source_blocks(g)
        for routing in ("minimal", "ugal"):
            reps = {}
            for engine in ("fused", "dense"):
                MG.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                reps[engine] = saturation_report(g, "uniform",
                                                 routing=routing,
                                                 engine=engine, device=dev)
                seconds = time.perf_counter() - t0
                got = dict(MG.LAUNCHES)
                r = reps[engine]
                log(f"{name} ({g.n} routers, {2 * g.num_edges} arcs) "
                    f"uniform {routing} {engine}: theta {r.theta!r}, u "
                    f"{r.u!r}, kbar {r.kbar_eff!r}, diameter {r.diameter}; "
                    f"{seconds:.3f} s; launches {got}")
                if engine == "fused":
                    sweeps = _mask_gemm_sweeps(f"{name} {routing}", got,
                                               ecc, blocks)
                    log(f"{name} {routing}: {sweeps} sweeps of {blocks} "
                        f"source blocks at depth {ecc}")
                    for key in launches:
                        launches[key] += got[key]
                elif any(got.values()):
                    raise AssertionError("the dense engine launched the "
                                         "mask+GEMM kernels")
            want = reps["dense"].loads
            err = float(np.abs(reps["fused"].loads - want).max())
            if not err <= THETA_RTOL * float(np.abs(want).max()):
                raise AssertionError(f"{name} {routing} fused vs dense "
                                     f"loads: max error {err}")
            log(f"{name} {routing}: fused vs dense loads max abs error "
                f"{err:.3e}")
            if name == "oft27" and routing == "minimal":
                r = reps["fused"]
                if not (abs(r.u - 1.0) <= 1e-12
                        and abs(r.kbar_eff - 2.0) <= 1e-12):
                    raise AssertionError(f"oft27: u {r.u!r}, kbar "
                                         f"{r.kbar_eff!r}, not 1 and 2")

    # the simulator on three SIM_CASES rows, on the fused step
    sim_launches = {"fused_step_update": 0, "fused_decision": 0}
    for name, pattern, routing, grid, steps, refine in SIM_ROWS:
        g = build_family(name)
        th = FAMILY_THETAS[(name, pattern,
                            "minimal" if routing == "minimal" else "ugal")]
        K.reset_launches()
        MG.reset_launches()
        t0 = time.perf_counter()
        sw = saturation_sweep(g, pattern, routing=routing,
                              loads=np.asarray(grid) * th, steps=steps,
                              refine=refine, theta_analytic=th,
                              config=SimConfig(backend="fused"), device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = dict(K.LAUNCHES)
        total_steps = sum(r.steps for r in sw.runs)
        rel = abs(sw.theta - th) / th
        log(f"sim {name}:{pattern}:{routing}: knee {sw.theta:.5f} vs "
            f"analytic {th:.5f} (err {rel:.4f}), bracket "
            f"[{sw.theta:.5f}, {sw.theta_unstable:.5f}], {len(sw.runs)} "
            f"probes x {steps} steps in {seconds:.2f} s "
            f"({1e3 * seconds / total_steps:.2f} ms/step); launches {got}")
        if any(r.backend != "fused" for r in sw.runs):
            raise AssertionError(f"sim {name} fell back to the dense step")
        if any(MG.LAUNCHES.values()):
            raise AssertionError("a sweep given its theta launched #3/#4")
        if not rel <= KNEE_BUDGET:
            raise AssertionError(f"sim {name} knee error {rel}")
        want = {"fused_step_update": 3 * total_steps,
                "fused_decision": total_steps if routing != "minimal" else 0}
        if got != want:
            raise AssertionError(f"sim {name}: launches {got}, expected "
                                 f"{want} (3 of #1 and one of #2 a step)")
        for r in sw.runs:
            if not r.residual <= 1e-4:
                raise AssertionError(f"sim {name} residual {r.residual}")
        for key in sim_launches:
            sim_launches[key] += got[key]
    return {**launches, **sim_launches}


def check_faults_analytic(dev):
    """Phase 17: the fault model's analytic side on the card."""
    from repro_torch.core import (degradation_sweep, degraded_report,
                                  pn_graph, random_faults, targeted_faults)
    from repro_torch.kernels import mask_gemm as MG

    launches = {"frontier_step": 0, "backward_step": 0}
    for name, want in BENCH6_ROWS.items():
        g = build_family(name)
        # dead links only lengthen routes: every sweep of a row is at
        # least as deep as the pristine graph's
        ecc, blocks = _sources_ecc(g, dev), _source_blocks(g)
        for routing in ("minimal", "ugal"):
            MG.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # all sources: the pristine k = 0 report would take the
            # orbit shortcut under "auto" (phase 19)
            sw = degradation_sweep(g, k_failures=BENCH6_K, trials=4,
                                   pattern="uniform", routing=routing,
                                   kind="links", seed=0, engine="fused",
                                   device=dev)
            seconds = time.perf_counter() - t0
            got = dict(MG.LAUNCHES)
            curves = {"mean_theta": sw.mean, "worst_theta": sw.worst,
                      "best_theta": sw.best, "p10": sw.bands[10],
                      "p50": sw.bands[50], "p90": sw.bands[90]}
            err = max(float(np.abs(np.asarray(curves[key])
                                   - np.asarray(want[key])).max())
                      for key in want)
            log(f"faults[{name}:{routing}]: mean "
                f"{np.round(sw.mean, 6).tolist()}, worst "
                f"{np.round(sw.worst, 6).tolist()}; max |err| against "
                f"BENCH_6 {err:.2e}; {seconds:.2f} s for 13 reports; "
                f"launches {got}")
            if not err <= BENCH6_TOL:
                raise AssertionError(f"faults[{name}:{routing}] off "
                                     f"BENCH_6 by {err}")
            for curve in (sw.mean, sw.worst):
                if (np.diff(curve) > 1e-12 * curve[0]).any():
                    raise AssertionError(f"faults[{name}:{routing}] curve "
                                         f"rises: {curve}")
            # the pristine report and 12 degraded ones, 1 or 3 sweeps each
            sweeps = 13 * (1 if routing == "minimal" else 3)
            if not (got["frontier_step"] >= sweeps * blocks * (ecc + 1)
                    and got["backward_step"] >= sweeps * blocks * ecc):
                raise AssertionError(f"faults[{name}:{routing}]: launches "
                                     f"{got} short of {sweeps} sweeps at "
                                     f"depth {ecc} or more")
            for key in launches:
                launches[key] += got[key]

    # full width: PN(64) with five dead links, fused against dense
    g = pn_graph(64)
    q = g.meta["q"]
    npts = q * q + q + 1
    kbar = ((q + 1) + 2 * (npts - 1) + 3 * (npts - q - 1)) / (g.n - 1)
    pristine = (q + 1) / kbar       # uniform theta of PN(q): u = 1
    t0 = time.perf_counter()
    fs = random_faults(g, k_links=5, seed=0)
    log(f"pn64 random_faults(k_links=5, seed=0): {fs.label} in "
        f"{time.perf_counter() - t0:.2f} s")
    for routing in ("minimal", "ugal"):
        reps = {}
        for engine in ("fused", "dense"):
            MG.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reps[engine] = degraded_report(g, "uniform", fs, routing=routing,
                                           engine=engine, device=dev)
            seconds = time.perf_counter() - t0
            got = dict(MG.LAUNCHES)
            r = reps[engine]
            log(f"pn64 degraded {routing} {engine}: theta {r.theta!r} "
                f"(pristine {pristine!r}, {r.theta / pristine:.6f}x), "
                f"kbar {r.kbar_eff!r}, diameter {r.diameter}; "
                f"{seconds:.2f} s; launches {got}")
            if engine == "fused":
                if not (got["frontier_step"] > 0
                        and got["backward_step"] > 0):
                    raise AssertionError("pn64 degraded report never "
                                         "launched #3 / #4")
                for key in launches:
                    launches[key] += got[key]
        want = reps["dense"].loads
        err = float(np.abs(reps["fused"].loads - want).max())
        if not err <= THETA_RTOL * float(np.abs(want).max()):
            raise AssertionError(f"pn64 degraded {routing}: fused vs dense "
                                 f"max error {err}")
        if not reps["fused"].theta < pristine:
            raise AssertionError(f"pn64 degraded {routing} theta "
                                 f"{reps['fused'].theta} not below "
                                 f"{pristine}")
        log(f"pn64 degraded {routing}: fused vs dense loads max abs error "
            f"{err:.3e}")
    # where a degraded report's time goes: a weighted sweep
    profile_device(lambda: degraded_report(g, "uniform", fs, device=dev),
                   1, "report", "profile pn64 degraded minimal")

    # one targeted round on PN(27) against the random mean
    g = pn_graph(27)
    MG.reset_launches()
    t0 = time.perf_counter()
    fs = targeted_faults(g, k=1, kind="links", engine="fused", device=dev)
    th_t = degraded_report(g, "uniform", fs, device=dev).theta
    th_r = [degraded_report(g, "uniform", random_faults(g, k_links=1,
                                                        seed=s),
                            device=dev).theta for s in range(4)]
    got = dict(MG.LAUNCHES)
    log(f"pn27 targeted_faults(k=1): {fs.label}, theta {th_t!r} against "
        f"the random mean {np.mean(th_r)!r} ({th_r}); "
        f"{time.perf_counter() - t0:.2f} s; launches {got}")
    if not th_t <= float(np.mean(th_r)) * (1 + 1e-9):
        raise AssertionError("the targeted cut is less damaging than the "
                             "random mean")
    for key in launches:
        launches[key] += got[key]
    return launches


def _uniform_demand(g) -> np.ndarray:
    from repro_torch.core import make_pattern, normalize_demand
    return normalize_demand(make_pattern("uniform").demand(g))


def check_faults_sim(dev, th_pn27: float):
    """Phase 18: faults in the simulator, on the fused step."""
    from repro_torch.core import FaultSet, degraded_report, pn_graph
    from repro_torch.core import random_faults
    from repro_torch.kernels import sim_step as K
    from repro_torch.sim import SimConfig, Simulator, saturation_sweep

    launches = {"fused_step_update": 0, "fused_decision": 0}

    def count(label, sw, per_decision):
        got = dict(K.LAUNCHES)
        steps = sum(r.steps for r in sw.runs)
        want = {"fused_step_update": 3 * steps,
                "fused_decision": per_decision * steps}
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        for r in sw.runs:
            if r.backend != "fused":
                raise AssertionError(f"{label} fell back to {r.backend}")
            if not r.residual <= 1e-4:
                raise AssertionError(f"{label} residual {r.residual}")
        for key in launches:
            launches[key] += got[key]
        return steps

    # BENCH_6's live row: torus2d_8x16, minimal, two dead links
    g = build_family("torus2d_8x16")
    fs = random_faults(g, k_links=2, seed=0)
    ref = degraded_report(g, "uniform", fs, routing="minimal",
                          device=dev).theta
    if fs.label != BENCH6_LIVE["faults"] or not abs(
            ref - BENCH6_LIVE["theta_analytic"]) <= BENCH6_TOL:
        raise AssertionError(f"torus2d_8x16 faults {fs.label}, theta "
                             f"{ref} are not BENCH_6's")
    cfg = SimConfig(backend="fused")
    knees = {}
    for label, steps, at in (("static", None, 0),
                             ("mid-run", BENCH6_LIVE["steps"],
                              int(0.4 * BENCH6_LIVE["steps"]))):
        K.reset_launches()
        t0 = time.perf_counter()
        sw = saturation_sweep(g, "uniform", "minimal",
                              loads=np.array([0.96, 1.05]) * ref, refine=2,
                              theta_analytic=ref, steps=steps,
                              events=[(at, fs)], config=cfg, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n_steps = count(f"torus2d_8x16 {label}", sw, 0)
        knees[label] = sw.theta
        log(f"torus2d_8x16 {label} (event at step {at}): knee "
            f"{sw.theta:.6f}, {len(sw.runs)} probes of {sw.runs[0].steps} "
            f"steps, {seconds:.2f} s ({1e3 * seconds / n_steps:.2f} "
            f"ms/step); dropped {[r.dropped for r in sw.runs]}")
    tsim = Simulator(g, cfg, device=dev)
    profile_device(lambda: tsim.run(_uniform_demand(g), ref, 24,
                                    events=[(8, fs)]),
                   24, "step", "profile torus2d_8x16 faulted")
    gap = abs(knees["static"] - knees["mid-run"]) / knees["static"]
    off = max(abs(k - BENCH6_LIVE["theta_static"])
              / BENCH6_LIVE["theta_static"] for k in knees.values())
    log(f"torus2d_8x16: static vs mid-run knee gap {gap:.4f}, largest "
        f"gap to BENCH_6's {BENCH6_LIVE['theta_static']} {off:.4f}")
    if not (gap <= KNEE_BUDGET and off <= KNEE_BUDGET):
        raise AssertionError(f"torus2d_8x16 knee gaps {gap}, {off}")

    # full width: phase 7's PN(27) instance with five dead links
    g = pn_graph(27)
    dem = points_demand(g, 27)
    fs = random_faults(g, k_links=5, seed=0)
    t0 = time.perf_counter()
    th = degraded_report(g, dem, fs, routing="ugal", device=dev).theta
    log(f"pn27 points {fs.label}: degraded ugal theta {th!r} (pristine "
        f"{th_pn27!r}) in {time.perf_counter() - t0:.2f} s")
    if not th <= th_pn27 * (1 + 1e-12):
        raise AssertionError("pn27 degraded theta above the pristine one")
    cfg = SimConfig(routing="ugal_threshold(0)", backend="fused")
    steps, at = 40, 16
    knees = {}
    for label, event in (("static", 0), ("mid-run", at)):
        K.reset_launches()
        t0 = time.perf_counter()
        sw = saturation_sweep(g, dem, routing="ugal_threshold(0)",
                              config=cfg, loads=np.array([0.96, 1.05]) * th,
                              steps=steps, refine=3, theta_analytic=th,
                              events=[(event, fs)], device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n_steps = count(f"pn27 {label}", sw, 1)
        knees[label] = sw.theta
        for r in sw.runs:
            log(f"pn27 {label} probe offered {r.offered:.4f}: theta "
                f"{r.theta:.4f} residual {r.residual:.2e} dropped "
                f"{r.dropped:.3e}")
        log(f"pn27 {label} (event at step {event}): knee {sw.theta:.4f} vs "
            f"degraded analytic {th:.4f} ({sw.theta / th:.4f}x), "
            f"{seconds:.2f} s for {n_steps} steps "
            f"({1e3 * seconds / n_steps:.2f} ms/step, tables included); "
            f"launches {dict(K.LAUNCHES)}")
    gap = abs(knees["static"] - knees["mid-run"]) / knees["static"]
    log(f"pn27: static vs mid-run knee gap {gap:.4f}")
    if not gap <= KNEE_BUDGET:
        raise AssertionError(f"pn27 static vs mid-run knee gap {gap}")

    sim = Simulator(g, cfg, demand=dem, device=dev)
    q = g.meta["q"]
    if sim.dest_cols is None or len(sim.dest_cols) != q * q + q + 1:
        raise AssertionError("pn27 does not run on the points' compacted "
                             "columns")
    a = sim.run(dem, th, steps, events=[(at, fs)])
    b = sim.run(dem, th, steps, events=[(at, fs)])
    for key, va in a.history.items():
        if not np.array_equal(va, b.history[key]):
            raise AssertionError(f"pn27 faulted history[{key!r}] not "
                                 f"bitwise reproducible")
    profile_device(lambda: sim.run(dem, th, 8, events=[(2, fs)]), 8,
                   "step", "profile pn27 faulted")
    # a point router dies mid-run: its column stays, its fluid is dropped
    dead = FaultSet(routers=(5,))
    K.reset_launches()
    r = sim.run(dem, 0.9 * th, steps, events=[(at, dead)])
    got = dict(K.LAUNCHES)
    log(f"pn27 faulted probe repeated bitwise; router 5 dies at step {at}: "
        f"dropped {r.dropped!r}, residual {r.residual:.2e}, theta "
        f"{r.theta:.4f} of {r.offered:.4f} offered, live links "
        f"{len(r.link_util)} (max utilization {r.link_util.max():.3f}); "
        f"launches {got}")
    if not (r.dropped > 0 and r.residual <= 1e-4
            and r.faults == dead.label):
        raise AssertionError("pn27 router fault: no drop counted or not "
                             "conserved")
    if got != {"fused_step_update": 3 * steps, "fused_decision": steps}:
        raise AssertionError(f"pn27 router fault run: launches {got}")
    for key in launches:
        launches[key] += got[key]
    return launches


# ---------------------------------------------------------------------------
# The orbit shortcut, the paper's tables and the adversarial table:
# phases 19-20
# ---------------------------------------------------------------------------

# BENCH_2.json's max_rel_err of each table (benchmarks/paper_tables.py)
# and the reference's fig6 error (benchmarks/paper_figures.py::fig6, on
# the CPU), the expected values of phase 19
BENCH2_ERR = {"table2_topological_params": 0.12328767123287676,
              "table3_structural_params": 0.0,
              "table4_10k_nodes": 0.004015892681676331,
              "table5_25k_nodes": 0.010695901239843222,
              "table6_indirect": 7.799156131299498e-06,
              "fig6": 0.013962500000000044}
# the reference's rows (benchmarks/paper_tables.py, paper_figures.py
# ::fig6, on the CPU): these columns of each row, in order
TABLE_COLUMNS = {
    "table2_topological_params": ("family", "N", "diameter", "kbar", "u"),
    "table3_structural_params": ("family", "N", "degree"),
    "table4_10k_nodes": ("name", "T", "R", "N", "delta0",
                         "electrical_cables", "optical_cables",
                         "cost_per_node_usd", "power_per_node_w"),
    "table6_indirect": ("name", "T", "R", "N", "delta0", "cables",
                        "cost_per_node_usd", "power_per_node_w"),
    "fig6": ("q", "N", "u", "kbar"),
}
TABLE_COLUMNS["table5_25k_nodes"] = TABLE_COLUMNS["table4_10k_nodes"]
TABLE_ROWS = {
    "table2_topological_params": [
        ('complete', 24, 1, 1.0, 1.0),
        ('turan_r3', 24, 2, 1.3043, 1.0),
        ('bipartite', 24, 2, 1.4783, 1.0),
        ('hamming2', 256, 2, 1.8824, 1.0),
        ('demi_pn', 273, 2, 1.9377, 0.9724),
        ('mms', 578, 2, 1.9567, 0.9216),
        ('pn', 366, 3, 2.4247, 1.0),
        ('dragonfly', 876, 3, 2.8103, 1.0),
        ('hamming3', 512, 3, 2.6301, 1.0),
    ],
    "table3_structural_params": [
        ('demi_pn', 73, 9),
        ('pn', 146, 9),
        ('mms', 338, 19),
        ('dragonfly', 264, 11),
        ('hamming2', 81, 16),
        ('hypercube', 128, 7),
        ('bipartite', 18, 9),
    ],
    "table4_10k_nodes": [
        ('Hamming K22^2', 10648, 64, 484, 22, 5082, 5082, 1145.42, 8.15),
        ('demi-PN(27)', 10598, 42, 757, 14, 1654, 8930, 1254.59, 8.4),
        ('SF MMS(19)', 9386, 42, 722, 13, 3971, 6498, 1294.52, 9.05),
        ('PN(23)', 9954, 33, 1106, 9, 1895, 11377, 1547.16, 10.27),
        ('dragonfly(7)', 9702, 27, 1386, 7, 9205, 4655, 1410.06, 10.8),
    ],
    "table5_25k_nodes": [
        ('Hamming K29^2', 24389, 85, 841, 29, 11774, 11774, 1168.18, 8.21),
        ('demi-PN(37)', 26733, 57, 1407, 19, 2622, 24092, 1293.52, 8.4),
        ('SF MMS(27)', 26244, 59, 1458, 18, 10935, 18954, 1344.11, 9.18),
        ('PN(31)', 25818, 45, 1986, 13, 1889, 29887, 1513.79, 9.69),
        ('dragonfly(9)', 26406, 35, 2934, 9, 25101, 13041, 1457.39, 10.89),
    ],
    "table6_indirect": [
        ('MLFM(22)', 9702, 42, 693, 21, 9702, 1297.19, 8.4),
        ('MLFM(30)', 25230, 58, 1305, 29, 25230, 1321.76, 8.4),
        ('OFT(16)', 9282, 34, 819, 17, 9282, 1282.2, 8.4),
        ('OFT(23)', 26544, 48, 1659, 24, 26544, 1312.14, 8.4),
    ],
    "fig6": [
        (5, 50, 1.0, 1.8571),
        (7, 98, 0.8756, 1.8866),
        (8, 128, 0.9167, 1.9055),
        (9, 162, 0.9508, 1.9193),
        (11, 242, 0.8824, 1.9295),
        (13, 338, 0.9317, 1.9436),
        (16, 512, 0.904, 1.953),
        (17, 578, 0.9216, 1.9567),
        (19, 722, 0.8859, 1.9598),
        (23, 1058, 0.8866, 1.9669),
        (25, 1250, 0.9111, 1.9704),
    ],
}
# the rows of Tables 4 and 5 whose electrical groups come from the greedy
# partitioner (core/layout.py::_greedy_groups), by family and q: its seed
# order np.argsort(-degrees) is not a stable sort, so equal degrees come
# out in the order of the host's numpy build and CPU, and the groups, the
# cable split and the dollars with them.  The order's fingerprint (the
# first 12 hex digits of the sha1 of its int64 bytes) on the host that
# computed TABLE_ROWS (numpy 2.0.2, AVX-512):
GREEDY_ROWS = {"PN(23)": ("pn", 23, "a2c77280ffc9"),
               "PN(31)": ("pn", 31, "2a7383425ec9"),
               "demi-PN(27)": ("demi_pn", 27, "f0856e7404d6"),
               "demi-PN(37)": ("demi_pn", 37, "dc1df14c2a25")}
LAYOUT_COLUMNS = ("electrical_cables", "optical_cables",
                  "cost_per_node_usd")
# the tables whose functions run utilization sweeps (2, 4, 5, fig6)
SWEEPING_TABLES = ("table2_topological_params", "table4_10k_nodes",
                   "table5_25k_nodes", "fig6")
# BENCH_3's six cases (benchmarks/routing_bench.py: n_random 8, seed 0,
# minimal / valiant / ugal) and the paper's ~25k-terminal line-up of
# Table 5 at full width
BENCH3_CASES = ("pn16", "demi_pn16", "oft4", "torus3d_444",
                "torus2d_8x16", "dragonfly3")
LINEUP = ("pn31", "demi_pn37", "dragonfly9")
N_RANDOM = 8


def _orbit_launches(g, info, targets, dev) -> dict:
    """#3 / #4 launches of one orbit sweep: the representative of each
    vertex orbit that the targets use runs ecc + 1 BFS levels and ecc
    dependency levels (ecc its largest distance to any vertex)."""
    from repro_torch.core import bfs_distances_batched
    reps = info.vertex_reps[np.unique(info.vertex_orbit[targets])]
    ecc = bfs_distances_batched(g, reps, dev).max(dim=1).values.cpu()
    ecc = ecc.numpy().astype(np.int64)
    return {"frontier_step": int((ecc + 1).sum()),
            "backward_step": int(ecc.sum())}


def _orbit_sweep(label, g, dev, all_source=None):
    """``utilization`` of ``g`` by the orbit shortcut on the card against
    the fused all-source sweep (``all_source``, or run here): loads
    within rtol 1e-9, kbar and diameter exact, the launches one sweep
    per used vertex orbit; ``auto`` takes the same path.  Returns the
    orbit report and the launches of the orbit and auto sweeps."""
    from repro_torch.core import orbit_info, utilization
    from repro_torch.kernels import mask_gemm as MG

    leaf = g.meta.get("leaf_mask")
    targets = (np.ones(g.n, dtype=bool) if leaf is None
               else np.asarray(leaf, dtype=bool))
    t0 = time.perf_counter()
    info = orbit_info(g, None if leaf is None else targets)
    host_s = time.perf_counter() - t0
    if info is None or orbit_info(g, None if leaf is None
                                  else targets.copy()) is not info:
        raise AssertionError(f"{label}: orbit_info missing or not cached")
    if all_source is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_source = utilization(g, engine="fused", device=dev)
        all_s = f"{time.perf_counter() - t0:.3f} s"
    else:
        all_s = "phase 5"
    want = _orbit_launches(g, info, targets, dev)
    launches = {"frontier_step": 0, "backward_step": 0}
    reps = {}
    for engine in ("orbit", "auto"):
        MG.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps[engine] = utilization(g, engine=engine, device=dev)
        seconds = time.perf_counter() - t0
        got = dict(MG.LAUNCHES)
        if got != want:
            raise AssertionError(f"{label} {engine}: launches {got}, "
                                 f"expected {want} (one sweep per used "
                                 f"vertex orbit)")
        for key in launches:
            launches[key] += got[key]
        log(f"{label} {engine}: {seconds:.4f} s on the card (orbit_info "
            f"cached); launches {got}")
    rep = reps["orbit"]
    if not np.array_equal(reps["auto"].loads, rep.loads):
        raise AssertionError(f"{label}: auto's loads are not the orbit "
                             f"path's")
    ref = all_source.loads
    err = float(np.abs(rep.loads - ref).max())
    if not err <= THETA_RTOL * float(np.abs(ref).max()):
        raise AssertionError(f"{label}: orbit loads off the all-source "
                             f"sweep by {err}")
    if rep.kbar != all_source.kbar or rep.diameter != all_source.diameter:
        raise AssertionError(f"{label}: kbar {rep.kbar!r} / diameter "
                             f"{rep.diameter} against {all_source.kbar!r} "
                             f"/ {all_source.diameter}")
    log(f"{label} ({g.n} routers, {len(g.arc_src)} arcs): orbit_info "
        f"{host_s:.3f} s on the host ({info.n_vertex_orbits} vertex and "
        f"{len(info.arc_sizes)} arc orbits); u {rep.u!r}, kbar "
        f"{rep.kbar!r}, diameter {rep.diameter}; loads max abs error "
        f"{err:.3e} against the fused all-source sweep ({all_s})")
    return rep, launches


def _hold_single_source(label, g, src: int, targets, dev) -> float:
    """#3 and #4 at S = 1, every level of the sweep from ``src``, bit for
    bit the tiled mirror of their summation order and within 1e-12 of
    the plain versions; returns the largest error against them."""
    from repro_torch.core.graph import adjacency_csr
    from repro_torch.kernels import mask_gemm as MG
    fwd, bwd, _ = level_states(g, 1, dev, sources=[src], targets=targets)
    csr = adjacency_csr(g, torch.float64, dev)
    worst = 0.0
    for front, dist, sigma, lvl in fwd:
        worst = max(worst, hold_frontier(
            f"frontier_step {label} S=1 lvl={lvl}",
            (front, csr, dist, sigma, lvl), 1e-12))
    for coeff, dist, sigma, delta, lvl in bwd:
        worst = max(worst, hold_backward(
            f"backward_step {label} S=1 lvl={lvl}",
            (coeff, csr, dist, sigma, delta, lvl), 1e-12))
    log(f"mask_gemm {label} S=1 from vertex {src}: {len(fwd)} frontier "
        f"and {len(bwd)} backward levels bit for bit the tiled mirror, "
        f"max error against the plain versions {worst:.3e}; plan (rows, "
        f"chunk, col_splits) {MG._plan_for(fwd[0][0])}")
    return worst


def _greedy_order_differs() -> dict:
    """The GREEDY_ROWS whose seed order this host's numpy breaks ties in
    differently from the host of TABLE_ROWS: {row name: fingerprint}."""
    import hashlib
    from repro_torch.core import demi_pn_graph, pn_graph
    out = {}
    for name, (family, q, want) in GREEDY_ROWS.items():
        g = (pn_graph if family == "pn" else demi_pn_graph)(q)
        order = np.argsort(-g.degrees).astype(np.int64)
        got = hashlib.sha1(order.tobytes()).hexdigest()[:12]
        if got != want:
            out[name] = got
    return out


def _same_rows(name, rows, reordered: dict):
    """Each row's columns equal to the reference's; a greedy-layout row
    whose seed order differs on this host (``reordered``) is held on its
    layout-free columns, and its cables and dollars are printed beside
    the reference's."""
    cols = TABLE_COLUMNS[name]
    want = TABLE_ROWS[name]
    if len(rows) != len(want):
        raise AssertionError(f"{name}: {len(rows)} rows")
    for row, ref in zip(rows, want):
        have = tuple(row[c] for c in cols)
        label = have[0]
        keep = [i for i, c in enumerate(cols)
                if label not in reordered or c not in LAYOUT_COLUMNS]
        if [have[i] for i in keep] != [ref[i] for i in keep]:
            raise AssertionError(f"{name}: row {have} is not the "
                                 f"reference's {ref}")
        if len(keep) < len(cols):
            layout = {c: (row[c], ref[cols.index(c)])
                      for c in LAYOUT_COLUMNS}
            log(f"{name} {label}: this host's numpy orders equal degrees "
                f"another way (seed order {reordered[label]}, reference "
                f"{GREEDY_ROWS[label][2]}): greedy layout (here, "
                f"reference) {layout}")


def _case_err(name, rows, reordered: dict) -> float:
    """Table 4's or 5's max_rel_err against the paper, recomputed from
    its rows as its table function does (power, subscription, dollars
    above the paper's), the dollars of a ``reordered`` greedy row taken
    from the reference host's layout."""
    from repro_torch.paper_tables import PAPER_T4, PAPER_T5
    paper = PAPER_T4 if name == "table4_10k_nodes" else PAPER_T5
    col = TABLE_COLUMNS[name].index("cost_per_node_usd")
    ref = {r[0]: r[col] for r in TABLE_ROWS[name]}
    errs = []
    for row in rows:
        pt = paper[row["name"]]
        cost = (ref[row["name"]] if row["name"] in reordered
                else row["cost_per_node_usd"])
        errs += [abs(row["power_per_node_w"] - pt[6]) / pt[6],
                 abs(row["subscription"] - pt[4]) / pt[4],
                 max(0.0, (cost - pt[5]) / pt[5])]
    return max(errs)


def check_orbits(dev, pn64):
    """Phase 19: the orbit shortcut on the card and the paper's tables
    through it.  ``pn64``: phase 5's fused all-source report of PN(64)."""
    from repro_torch.core import orbit_info, pn_graph
    from repro_torch.kernels import mask_gemm as MG
    from repro_torch.paper_tables import TABLES, fig6

    launches = {"frontier_step": 0, "backward_step": 0}

    def add(got):
        for key in launches:
            launches[key] += got[key]

    g = pn_graph(64)
    q = g.meta["q"]
    npts = q * q + q + 1
    kbar = ((q + 1) + 2 * (npts - 1) + 3 * (npts - q - 1)) / (g.n - 1)
    rep, got = _orbit_sweep("pn64", g, dev, all_source=pn64)
    add(got)
    if not (abs(rep.u - 1.0) <= 1e-12
            and abs(rep.kbar - kbar) <= 1e-12 * kbar):
        raise AssertionError(f"pn64 orbit: u {rep.u!r}, kbar {rep.kbar!r} "
                             f"(expected 1 and {kbar!r})")
    _, got = _orbit_sweep("demi_pn64", build_family("demi_pn64"), dev)
    add(got)
    g_oft = build_family("oft27")
    rep, got = _orbit_sweep("oft27", g_oft, dev)
    add(got)
    if not (abs(rep.u - 1.0) <= 1e-12 and abs(rep.kbar - 2.0) <= 1e-12):
        raise AssertionError(f"oft27 orbit: u {rep.u!r}, kbar {rep.kbar!r}, "
                             f"not 1 and 2")

    # #3 / #4 at S = 1, the orbit sweeps' shape
    leaf = np.asarray(g_oft.meta["leaf_mask"], dtype=bool)
    info = orbit_info(g_oft, leaf)
    src = int(info.vertex_reps[info.vertex_orbit[np.nonzero(leaf)[0][0]]])
    errs = [_hold_single_source("pn64", g, 0, None, dev),
            _hold_single_source("oft27", g_oft, src, leaf, dev)]
    del g, g_oft
    torch.cuda.empty_cache()

    # the paper's Tables 2-6 and Fig. 6 through the port
    reordered = _greedy_order_differs()
    log(f"numpy {np.__version__}: greedy seed orders that differ from "
        f"the reference host's: {reordered or 'none'}")
    for name, fn in (*TABLES.items(), ("fig6", fig6)):
        MG.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, err = fn(device=dev)
        seconds = time.perf_counter() - t0
        got = dict(MG.LAUNCHES)
        want = BENCH2_ERR[name]
        log(f"{name}: max_rel_err {err!r} (reference {want!r}); "
            f"{len(rows)} rows; {seconds:.3f} s; launches {got}")
        if any(r.get("name") in reordered for r in rows):
            # BENCH_2's error includes the dollars of the reference
            # host's greedy layout: hold the rest of it
            if _case_err(name, rows, {}) != err:
                raise AssertionError(f"{name}: max_rel_err recomputed "
                                     f"from the rows is not {err!r}")
            err = _case_err(name, rows, reordered)
            log(f"{name}: max_rel_err {err!r} with the reference host's "
                f"greedy dollars")
        if not abs(err - want) <= 1e-9 * abs(want):
            raise AssertionError(f"{name}: max_rel_err {err!r} against "
                                 f"{want!r}")
        _same_rows(name, rows, reordered)
        sweeps = name in SWEEPING_TABLES
        if sweeps != (got["frontier_step"] > 0 and got["backward_step"] > 0):
            raise AssertionError(f"{name}: launches {got}")
        add(got)
    log(f"phase 19: #3 / #4 at S = 1 within {max(errs):.3e} of the plain "
        f"versions; launches {launches}")
    return launches


def _identity_err(rows) -> float:
    """BENCH_3's identities (benchmarks/routing_bench.py::routing_one):
    how far theta_ugal falls below max(theta_minimal, theta_valiant) on
    any pattern and how far uniform theta_ugal is from theta_minimal."""
    by = {}
    for r in rows:
        by.setdefault(r["pattern"], {})[r["routing"]] = r["theta"]
    err = 0.0
    for pattern, cells in by.items():
        pure = max(cells["minimal"], cells["valiant"])
        err = max(err, (pure - cells["ugal"]) / pure)
        if pattern == "uniform":
            err = max(err, abs(cells["ugal"] - cells["minimal"])
                      / cells["minimal"])
    return err


def _same_slab(label, g, got, want, engine, dev) -> tuple[float, list]:
    """``adversarial_report``'s (rows, worst) against ``want`` (BENCH_3's
    record or another engine's): every theta, kbar_eff and alpha within
    rtol 1e-9, worst patterns and ``realized_by`` equal by name.  Where
    a name differs, the two candidates must tie: the port's report of
    ``want``'s pick must reach ``want``'s numbers within 1e-9 (Valiant
    gives every fixed-point-free permutation one theta in exact
    arithmetic, and rounding picks among them).  Returns the largest
    relative error and the ties met."""
    from repro_torch.core import saturation_report
    rows, worst = got
    want_rows, want_worst = want
    err, ties = 0.0, []

    def rel(a, b, what):
        nonlocal err
        e = abs(a - b) / abs(b) if b else abs(a)
        if not e <= THETA_RTOL:
            raise AssertionError(f"{label} {what}: {a!r} against {b!r}")
        err = max(err, e)

    def tie(spec, routing, theta):
        r = saturation_report(g, spec, routing=routing, engine=engine,
                              device=dev)
        rel(r.theta, theta, f"{routing} tie {spec}")
        ties.append(f"{routing}:{spec}")
        return r

    if len(rows) != len(want_rows):
        raise AssertionError(f"{label}: {len(rows)} rows against "
                             f"{len(want_rows)}")
    for a, b in zip(rows, want_rows):
        what = f"{b['pattern']}/{b['routing']}"
        if (a["pattern"], a["routing"]) != (b["pattern"], b["routing"]):
            raise AssertionError(f"{label}: row {a} against {b}")
        rel(a["theta"], b["theta"], what)
        cell = a
        if a.get("realized_by") != b.get("realized_by"):
            cell = tie(b["realized_by"], b["routing"], b["theta"])
            cell = {"kbar_eff": cell.kbar_eff, "alpha": cell.alpha}
        rel(cell["kbar_eff"], b["kbar_eff"], f"{what} kbar_eff")
        if "alpha" in b:
            rel(cell["alpha"], b["alpha"], f"{what} alpha")
    for model, w in want_worst.items():
        rel(worst[model]["min_theta"], w["min_theta"], f"{model} worst")
        if worst[model]["worst_pattern"] != w["worst_pattern"]:
            tie(w["worst_pattern"], model, w["min_theta"])
    return err, ties


def check_adversary(dev):
    """Phase 20: the adversarial table on the card."""
    import importlib
    from repro_torch.core import (adversarial_report, orbit_info,
                                  random_faults, worst_case)
    from repro_torch.kernels import mask_gemm as MG

    launches = {"frontier_step": 0, "backward_step": 0}

    def add(got):
        if not (got["frontier_step"] > 0 and got["backward_step"] > 0):
            raise AssertionError(f"a report never launched #3 / #4: {got}")
        for key in launches:
            launches[key] += got[key]

    def report(label, g, engine):
        MG.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = adversarial_report(g, n_random=N_RANDOM, seed=0,
                                 engine=engine, device=dev)
        seconds = time.perf_counter() - t0
        got = dict(MG.LAUNCHES)
        if engine != "dense":
            add(got)
        elif any(got.values()):
            raise AssertionError("the dense engine launched #3 / #4")
        worst = {m: f"{w['min_theta']:.6f}@{w['worst_pattern']}"
                 for m, w in out[1].items()}
        log(f"{label} ({g.n} routers) {engine}: {seconds:.2f} s; worst "
            f"{worst}; launches {got}")
        return out

    # BENCH_3's six cases under the default engine
    bench3 = {e["name"]: e for e in
              json.loads((ROOT / "BENCH_3.json").read_text())["entries"]}
    for name in BENCH3_CASES:
        g = build_family(name)
        entry = bench3[f"routing[{name}]"]
        got = report(name, g, "auto")
        err, ties = _same_slab(name, g, got, (entry["rows"],
                                              entry["worst"]), "auto", dev)
        ident = _identity_err(got[0])
        log(f"{name}: against BENCH_3 max rel err {err:.3e}, ties "
            f"{ties or 'none'}; identities {ident:.3e} (BENCH_3 "
            f"{entry['max_rel_err']})")
        if not ident <= THETA_RTOL:
            raise AssertionError(f"{name}: BENCH_3's identities off by "
                                 f"{ident}")

    # Table 5's line-up at full width, fused against dense
    for name in LINEUP:
        g = build_family(name)
        fused = report(name, g, "fused")
        dense = report(name, g, "dense")
        err, ties = _same_slab(name, g, fused, dense, "fused", dev)
        ident = max(_identity_err(fused[0]), _identity_err(dense[0]))
        log(f"{name}: fused vs dense max rel err {err:.3e}, ties "
            f"{ties or 'none'}; identities {ident:.3e}")
        if not ident <= THETA_RTOL:
            raise AssertionError(f"{name}: identities off by {ident}")
        if name == "pn31":
            profile_device(lambda: adversarial_report(
                g, n_random=N_RANDOM, seed=0, engine="fused", device=dev),
                1, "report", "profile pn31 adversarial fused")

    # a faulted worst case on PN(31): never the orbit path
    U = importlib.import_module("repro_torch.core.utilization")
    g = build_family("pn31")
    fs = random_faults(g, k_links=5, seed=0)
    if orbit_info(fs.apply(g)) is not None:
        raise AssertionError("a degraded graph has orbits")
    real, hits = U._loads_orbit, []

    def spy(*args):
        res = real(*args)
        hits.append(res is not None)
        return res

    U._loads_orbit = spy
    try:
        reps = {}
        for engine in ("auto", "fused", "dense"):
            MG.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reps[engine] = worst_case(g, "ugal", n_random=N_RANDOM, seed=0,
                                      faults=fs, engine=engine, device=dev)
            seconds = time.perf_counter() - t0
            got = dict(MG.LAUNCHES)
            r = reps[engine]
            log(f"pn31 {fs.label} worst_case ugal {engine}: "
                f"{r.worst_theta!r} at {r.worst_pattern}; {seconds:.2f} s; "
                f"launches {got}")
            if engine != "dense":
                add(got)
            elif any(got.values()):
                raise AssertionError("the dense engine launched #3 / #4")
    finally:
        U._loads_orbit = real
    if any(hits):
        raise AssertionError("a degraded worst case took the orbit path")
    want = reps["dense"]
    for engine in ("auto", "fused"):
        for spec, theta in want.thetas.items():
            got = reps[engine].thetas[spec]
            if not abs(got - theta) <= THETA_RTOL * theta:
                raise AssertionError(f"pn31 faulted {spec}: {engine} "
                                     f"{got!r} against dense {theta!r}")
        pick = reps[engine].worst_pattern
        if not want.thetas[pick] <= want.worst_theta * (1 + THETA_RTOL):
            raise AssertionError(f"pn31 faulted: {engine}'s worst {pick} "
                                 f"is not a worst of dense's "
                                 f"({want.worst_pattern})")
    log(f"pn31 faulted worst case: auto = fused = dense within "
        f"{THETA_RTOL}, orbit path never taken ({len(hits)} checks); "
        f"launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# The fabric layer: phase 21
# ---------------------------------------------------------------------------

# the paper's Table 5 machine as the planner sizes it (fabric/planner.py::
# candidate_fabrics): PN(31), 1,986 routers of degree 32, delta0 =
# round(2 * 32 / 5) = 13, 25,818 terminals; on it an 8,192-chip job
FABRIC_Q = 31
FABRIC_ROUTERS = 1986
FABRIC_DEGREE = 32
FABRIC_DELTA0 = 13
FABRIC_TERMINALS = 25_818
FABRIC_MESH = (16, 512)
FABRIC_AXES = ("model", "data")
GEOMETRIC = ("linear", "group", "random", "orbit")
GREEDY = "greedy_swap(30,group)"
# the reference's rows of that job on the CPU (repro.fabric, engine
# "numpy", benchmarks/placement_bench.py's PROFILES, ugal): (theta, u,
# kbar_eff) of placement_search's geometric strategies
FULL_SEARCH = {
    "ep_heavy": {
        "linear": (1.3886646029432, 0.6930225104156182, 4.8013829732510365),
        "group": (1.755844346282704, 0.6170548261611359, 4.936020151133501),
        "random": (1.1202461720831214, 0.6633232147989924,
                   4.595703372336105),
        "orbit": (1.755844346282704, 0.6170548261611359, 4.936020151133501),
    },
    "dp_heavy": {
        "linear": (7.544005423415833, 0.544484001843014, 4.936020151133503),
        "group": (1.1121338451898313, 0.6925044904202795, 4.9360201511335),
        "random": (1.073107618801108, 0.670120085578353, 4.845729921297629),
        "orbit": (1.1121338451898313, 0.6925044904202795, 4.9360201511335),
    },
}
# fragmentation_sweep of two such ep_heavy jobs under tornado, ugal
FULL_FRAG = {"packed": (0.7676226572233565, 0.6580115227770764,
                        4.936020151133503),
             "interleaved": (0.6075992958610469, 0.6770423162455099,
                             4.936020151133503),
             "linear": (0.6075622524990484, 0.7152932101610964,
                        4.923324477510332)}
# plan(ep_heavy, min_terminals=25_000, max_radix=64, mesh_shape=(16, 512),
# placement_strategy="group", routing="ugal", resilience_k=5,
# resilience_trials=4): the reference's rows in its order, and each
# candidate's columns before the planner's rounding
PLAN_KW = dict(min_terminals=25_000, max_radix=64, mesh_shape=FABRIC_MESH,
               placement_strategy="group", routing="ugal", resilience_k=5,
               resilience_trials=4)
PLAN_ROWS = [
    {"fabric": "SF-MMS(27)", "terminals": 26244, "radix": 59, "kbar": 1.972,
     "u": 0.887, "kbar_over_u": 2.223, "step_comm_ms": 195.191,
     "usd_per_node": 1344.11, "watts_per_node": 9.18, "resilience_k": 5,
     "resilience_theta": 17.989, "resilience_frac": 0.9754,
     "placed_comm_ms": 86.419, "placement_strategy": "group",
     "placement_routing": "ugal"},
    {"fabric": "PN(31)", "terminals": 25818, "radix": 45, "kbar": 2.468,
     "u": 1.0, "kbar_over_u": 2.468, "step_comm_ms": 200.522,
     "usd_per_node": 1513.79, "watts_per_node": 9.69, "resilience_k": 5,
     "resilience_theta": 12.9327, "resilience_frac": 0.9974,
     "placed_comm_ms": 108.17, "placement_strategy": "group",
     "placement_routing": "ugal"},
    {"fabric": "demi-PN(37)", "terminals": 26733, "radix": 57,
     "kbar": 1.973, "u": 0.987, "kbar_over_u": 1.999,
     "step_comm_ms": 199.853, "usd_per_node": 1293.52,
     "watts_per_node": 8.4, "resilience_k": 5, "resilience_theta": 18.4854,
     "resilience_frac": 0.9729, "placed_comm_ms": 160.184,
     "placement_strategy": "group", "placement_routing": "ugal"},
    {"fabric": "dragonfly(9)", "terminals": 26406, "radix": 35,
     "kbar": 2.878, "u": 1.0, "kbar_over_u": 2.878, "step_comm_ms": 199.239,
     "usd_per_node": 1457.39, "watts_per_node": 10.89},
]
PLAN_RAW = {
    "demi-PN(37)": {"kbar": 1.9729921819474059, "u": 0.9871977240398293,
                    "step_comm_ms": 199.8533370046912,
                    "usd_per_node": 1293.5246999588524,
                    "watts_per_node": 8.399999999999999,
                    "resilience_theta": 18.485391661402396,
                    "pristine_theta": 18.999999999999996,
                    "placed_comm_ms": 160.18425581897},
    "PN(31)": {"kbar": 2.4680100755667507, "u": 1.0,
               "step_comm_ms": 200.5217537551272,
               "usd_per_node": 1513.7941879309008,
               "watts_per_node": 9.692307692307692,
               "resilience_theta": 12.93270186294129,
               "pristine_theta": 12.965911410491938,
               "placed_comm_ms": 108.17048919238036},
    "SF-MMS(27)": {"kbar": 1.971859986273164, "u": 0.8870021611608522,
                   "step_comm_ms": 195.1911274792803,
                   "usd_per_node": 1344.1142222222222,
                   "watts_per_node": 9.177777777777777,
                   "resilience_theta": 17.988989160162657,
                   "pristine_theta": 18.44303797468354,
                   "placed_comm_ms": 86.41936649252018},
    "dragonfly(9)": {"kbar": 2.8779406750767134, "u": 1.0,
                     "step_comm_ms": 199.23881831471618,
                     "usd_per_node": 1457.3880327198365,
                     "watts_per_node": 10.888888888888888},
}
# BENCH_4's greedy_swap(30) descents (placement_bench.py: from group,
# seed 0, ugal) on the reference's numpy engine, by case and profile: the
# start's objective and each accepted step with its new objective, which
# together give the whole history
BENCH4_DESCENTS = {
    "pn16/ep_heavy": (5356934700.4857, ()),
    "pn16/dp_heavy": (10485914732.865625, ((4, 10483580679.978416),
                                           (20, 10406556934.700487),
                                           (24, 10404222881.813276))),
    "demi_pn9/ep_heavy": (5111111111.111111, ()),
    "demi_pn9/dp_heavy": (9555555555.555557, ((3, 9401894107.926016),
                                              (6, 9253096459.401978),
                                              (28, 9248179061.55241))),
    "torus3d_444/ep_heavy": (13629629629.629631, ()),
    "torus3d_444/dp_heavy": (25481481481.48148, ((3, 25310052910.05291),
                                                 (6, 25085052910.05291),
                                                 (9, 24982473544.97354))),
    "dragonfly3/ep_heavy": (8183734372.055037, ()),
    "dragonfly3/dp_heavy": (15968115957.566565, ((3, 15637320968.199957),
                                                 (6, 15603882475.983097))),
}
GREEDY_ITERS = 30
# steps of the 0.9x ugal_threshold(0) runs of phase 21: three times the
# simulator's default for PN(31) (48 + 32 x its 3 hops), the default
# length still in the transient there (delivered / offered 0.9889 after
# 144 steps, 0.9941 after 432 on the H100)
SETTLE_STEPS = 432
# BENCH_4 rounds theta and u to six digits
BENCH4_DIGITS = 1e-6
FABRIC_KERNELS = ("fused_step_update", "fused_decision", "frontier_step",
                  "backward_step")
MASK_KERNEL = re.compile(r"mask_gemm_kernel<.*,\s*(true|false)>")


def _launch_counts() -> dict:
    from repro_torch.kernels import mask_gemm as MG
    from repro_torch.kernels import sim_step as K
    return {**K.LAUNCHES, **MG.LAUNCHES}


def _timed(fn):
    """(result, seconds, launches of #1-#4) of one call, the card
    synchronised on both sides."""
    before = _launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = _launch_counts()
    return out, seconds, {k: after[k] - before[k] for k in FABRIC_KERNELS}


def _need_mask_gemm(label, got):
    if not (got["frontier_step"] > 0 and got["backward_step"] > 0):
        raise AssertionError(f"{label} never launched #3 / #4: {got}")


def _rel(got, want) -> float:
    return abs(got - want) / max(abs(want), 1e-300)


def _descent_history(start, accepted, iters=GREEDY_ITERS) -> list:
    hist = [start] * (iters + 1)
    for step, val in accepted:
        hist[step:] = [val] * (iters + 1 - step)
    return hist


def _parting_step(hist, ref_hist):
    """The first step at which two greedy descents decide otherwise (a
    swap is kept exactly when the history strictly drops), or None; the
    histories must agree within THETA_RTOL before it, and there the side
    that kept its swap must tie its incumbent within THETA_RTOL."""
    if not _rel(hist[0], ref_hist[0]) <= THETA_RTOL:
        raise AssertionError(f"descent starts {hist[0]} / {ref_hist[0]}")
    for i in range(1, len(ref_hist)):
        took, ref_took = hist[i] < hist[i - 1], ref_hist[i] < ref_hist[i - 1]
        if took != ref_took:
            h = hist if took else ref_hist
            if not h[i] >= h[i - 1] * (1 - THETA_RTOL):
                raise AssertionError(f"the descents part at step {i} on a "
                                     f"non-tie: {h[i - 1]!r} -> {h[i]!r}")
            return i
        if not _rel(hist[i], ref_hist[i]) <= THETA_RTOL:
            raise AssertionError(f"descent step {i}: {hist[i]} against "
                                 f"{ref_hist[i]}")
    return None


def _bench4_descent(name, pname, g, mesh, axes, delta0, dev):
    """A greedy_swap(30) row that differs from BENCH_4's: replay the
    port's descent and hold it against the reference's by the tie rule;
    returns the step at which they part."""
    from repro_torch import placement_tables as PT
    from repro_torch.fabric import (collective_traffic, greedy_improve,
                                    place_mesh, schedule_from_profile)
    sched = schedule_from_profile(PT.PROFILES[pname], axes)
    p0 = place_mesh(g, mesh, axes, delta0, "group", device=dev)
    _, _, hist = greedy_improve(p0, collective_traffic(mesh, axes, sched),
                                iters=GREEDY_ITERS, seed=0, routing="ugal",
                                engine="fused", return_history=True,
                                device=dev)
    start, accepted = BENCH4_DESCENTS[f"{name}/{pname}"]
    step = _parting_step(hist, _descent_history(start, accepted))
    if step is None:
        raise AssertionError(f"{name} {pname}: the greedy row differs from "
                             f"BENCH_4's, yet the descents agree")
    return step


def _hold_bench4(name, g, mesh, axes, delta0, out, entry, dev) -> dict:
    """placement_one's (rows, summary, max_rel_err) against BENCH_4's
    entry: theta and u within 1e-6 of the six recorded digits, max_bytes
    and alpha at rtol 1e-9, the summary's best and beats_linear and
    max_rel_err as recorded; a greedy row that differs passes only under
    the tie rule.  Returns {profile: parting step} of such rows."""
    rows, summary, err = out
    want = entry["rows"]
    if [(r["profile"], r["strategy"]) for r in rows] != \
            [(r["profile"], r["strategy"]) for r in want]:
        raise AssertionError(f"{name}: rows {[r['strategy'] for r in rows]}")
    ties = {}
    for row, ref in zip(rows, want):
        bad = [k for k in ("theta", "u")
               if not abs(row[k] - ref[k]) <= BENCH4_DIGITS * (1 + 1e-9)]
        bad += [k for k in ("max_bytes", "alpha")
                if k in ref and not (
                    (row[k] is None and ref[k] is None)
                    or (row[k] is not None and ref[k] is not None
                        and abs(row[k] - ref[k])
                        <= THETA_RTOL * max(abs(ref[k]), 1.0)))]
        if not bad:
            continue
        if row["strategy"] != GREEDY:
            raise AssertionError(f"{name} {row['profile']} "
                                 f"{row['strategy']}: {bad} {row} against "
                                 f"BENCH_4's {ref}")
        ties[row["profile"]] = _bench4_descent(name, row["profile"], g, mesh,
                                               axes, delta0, dev)
        log(f"{name} {row['profile']}: the greedy descent parts from the "
            f"reference's at step {ties[row['profile']]} on a tie; row "
            f"{row} against BENCH_4's {ref}")
    for key, s in entry["summary"].items():
        fields = ("best", "beats_linear") if "beats_linear" in s else ("best",)
        for f in fields:
            if summary[key][f] != s[f] and key not in ties:
                raise AssertionError(f"{name} {key} {f}: {summary[key][f]} "
                                     f"against BENCH_4's {s[f]}")
    if not ties and not abs(err - entry["max_rel_err"]) <= 1e-12:
        raise AssertionError(f"{name}: max_rel_err {err} against "
                             f"{entry['max_rel_err']}")
    return ties


def _hold_rows(label, got: dict, want: dict):
    """(theta, u, kbar_eff) rows within THETA_RTOL; the largest error."""
    worst = 0.0
    for strat, ref in want.items():
        row = got[strat]
        for key, val in zip(("theta", "u", "kbar_eff"), ref):
            e = _rel(row[key], val)
            worst = max(worst, e)
            if not e <= THETA_RTOL:
                raise AssertionError(f"{label} {strat} {key}: {row[key]!r} "
                                     f"against {val!r}")
    return worst


def _row_tuple(row) -> tuple:
    return tuple(row[k] for k in ("theta", "u", "kbar_eff"))


def _check_plan(dev):
    """plan() at 25,000 terminals against the reference's rows: each
    candidate's columns before the planner's rounding within 1e-9, the
    rounded rows and the ranking equal (a greedy-layout row whose seed
    order differs on this host keeps its dollars apart).  plan() is
    _ranked(_plan_rows(...)); the two halves are called apart here to
    read the columns before the rounding."""
    import importlib
    from repro_torch import placement_tables as PT
    PL = importlib.import_module("repro_torch.fabric.planner")
    kw = dict(PLAN_KW, axis_names=FABRIC_AXES, seed=0, resilience_seed=0,
              device=dev)
    raw, seconds, got = _timed(lambda: PL._plan_rows(
        PT.PROFILES["ep_heavy"], **kw))
    rows = PL._ranked(raw, placed=True)
    _need_mask_gemm("plan", got)
    for row in rows:
        log(f"plan row: {json.dumps(row)}")
    log(f"plan: {len(rows)} candidates in {seconds:.2f} s; launches {got}")
    reordered = _greedy_order_differs()
    if [r["fabric"] for r in rows] != [r["fabric"] for r in PLAN_ROWS]:
        raise AssertionError(f"plan ranks {[r['fabric'] for r in rows]}")
    for row, ref in zip(rows, PLAN_ROWS):
        if set(row) != set(ref):
            raise AssertionError(f"plan {row['fabric']}: columns {set(row)}")
        for key, val in ref.items():
            if key == "usd_per_node" and row["fabric"] in reordered:
                log(f"plan {row['fabric']}: this host's numpy orders equal "
                    f"degrees another way (seed order "
                    f"{reordered[row['fabric']]}, reference "
                    f"{GREEDY_ROWS[row['fabric']][2]}): $/node "
                    f"{row[key]} here, {val} on the reference's host")
            elif row[key] != val:
                raise AssertionError(f"plan {row['fabric']} {key}: "
                                     f"{row[key]!r} against {val!r}")
    # the columns before the planner's rounding
    worst = 0.0
    for row in raw:
        name = row["fabric"]
        want = dict(PLAN_RAW[name])
        want["kbar_over_u"] = want["kbar"] / want["u"]
        if "pristine_theta" in want:
            want["resilience_frac"] = (want["resilience_theta"]
                                       / want.pop("pristine_theta"))
        if name in reordered:
            del want["usd_per_node"]
        for key, val in want.items():
            e = _rel(row[key], val)
            worst = max(worst, e)
            if not e <= THETA_RTOL:
                raise AssertionError(f"plan {name} {key} before rounding: "
                                     f"{row[key]!r} against {val!r}")
    log(f"plan: every column before rounding within {worst:.3e} of the "
        f"reference's; rows and ranking equal after it")


def _descent_evals(p0, history, seed=0) -> int:
    """Objective evaluations of a greedy_swap descent from its history:
    the start, and each drawn pair whose chips sat on two routers (the
    descent skips a same-router pair, and keeps a swap exactly where the
    history drops)."""
    pairs = np.random.default_rng(seed).integers(
        0, p0.n_chips, (len(history) - 1, 2))
    cur, evals = p0.router_of.copy(), 1
    for (i, j), before, after in zip(pairs, history, history[1:]):
        if cur[i] != cur[j]:
            evals += 1
        if after < before:
            cur[i], cur[j] = cur[j], cur[i]
    return evals


def _profile_descent(dev, g, prof):
    """One greedy_swap(30) descent of the full-width job under the
    profiler: wall and device time, idle share, host-to-device copies,
    #3 / #4 per objective evaluation."""
    from repro_torch.fabric import (collective_traffic, greedy_improve,
                                    place_mesh, schedule_from_profile)
    sched = schedule_from_profile(prof, FABRIC_AXES)
    traffic = collective_traffic(FABRIC_MESH, FABRIC_AXES, sched)
    p0 = place_mesh(g, FABRIC_MESH, FABRIC_AXES, FABRIC_DELTA0, "group",
                    device=dev)
    seen = {}

    def descent():
        seen["before"] = _launch_counts()
        seen["history"] = greedy_improve(
            p0, traffic, iters=GREEDY_ITERS, seed=0, routing="ugal",
            engine="fused", return_history=True, device=dev)[2]
        seen["after"] = _launch_counts()

    rows, wall_ms, busy_ms, _ = device_rows(descent)
    evals = _descent_evals(p0, seen["history"])
    got = {k: seen["after"][k] - seen["before"][k] for k in FABRIC_KERNELS}
    _need_mask_gemm("the profiled descent", got)
    copies = [r for r in rows if "Memcpy HtoD" in r[2]]
    kern = {"true": [0.0, 0], "false": [0.0, 0]}
    for ms, count, name in rows:
        m = MASK_KERNEL.search(name)
        if m:
            kern[m[1]][0] += ms
            kern[m[1]][1] += count
    log(f"profile greedy_swap(30) descent (PN({FABRIC_Q}), "
        f"{int(np.prod(FABRIC_MESH)):,} chips, ugal, fused): {evals} "
        f"objective evaluations, wall {wall_ms:.1f} ms "
        f"({wall_ms / evals:.2f} ms an evaluation), device busy "
        f"{busy_ms:.1f} ms, idle share {1.0 - busy_ms / wall_ms:.3f}; "
        f"{sum(r[1] for r in copies)} host-to-device copies "
        f"{sum(r[0] for r in copies):.1f} ms; per evaluation #3 "
        f"{kern['true'][1] / evals:.1f} launches {kern['true'][0] / evals:.3f}"
        f" ms, #4 {kern['false'][1] / evals:.1f} launches "
        f"{kern['false'][0] / evals:.3f} ms (counters {got})")
    for ms, count, key in rows[:12]:
        log(f"profile descent:   {ms:9.3f} ms {count:6d} launches  "
            f"{key[:90]}")
    return {"evals": evals, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle": 1.0 - busy_ms / wall_ms}


def _hold_placement_kernels(dev, g, prof):
    """#1 and #2 against their plain versions at the shapes
    simulate_placement gives them on the full-width job: PN(31)'s route
    tables over all 1,986 routers, compacted to the group placement's
    demanded columns (random queues, as phase 2)."""
    from repro_torch.fabric import place_mesh, placement_demand
    from repro_torch.sim.tables import build_tables
    p = place_mesh(g, FABRIC_MESH, FABRIC_AXES, FABRIC_DELTA0, "group",
                   device=dev)
    used = np.nonzero(placement_demand(prof, p).sum(axis=0) > 0)[0]
    t = build_tables(g, np.arange(g.n), dtype=torch.float64, device=dev)
    cols = torch.as_tensor(used, device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)

    def rand(*shape, dtype=torch.float64):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    errs = hold_sim_kernels(f"PN({FABRIC_Q}) placement: ", t, cols, rand)
    log(f"PN({FABRIC_Q}) placement: #1 and #2 equal their plain versions "
        f"at N={t.n} K={t.k} W={t.m} and C={len(used)} (float32 max "
        f"errors {errs})")
    del t, cols
    torch.cuda.empty_cache()


def _check_simulation(dev, g, prof):
    """simulate_placement of the group placement on the fused step: 0.9x
    the analytic theta sustained (delivered / offered > 0.99) under
    minimal routing, whose fluid theta is the simulator's exact knee (the
    reference's own test of simulate_placement), and under
    ugal_threshold(0), float32 against float64 within 1e-4; at the
    default 1.2x delivering at most what is offered.  Per-hop UGAL's
    queues settle slowly at this load (most fluid takes two-phase
    Valiant paths), so its 0.9x runs take SETTLE_STEPS, and the run of
    the default length is printed beside them."""
    import repro_torch.sim as S
    from repro_torch.fabric import place_mesh, placement_report
    from repro_torch.sim import SimConfig, simulate_placement
    p = place_mesh(g, FABRIC_MESH, FABRIC_AXES, FABRIC_DELTA0, "group",
                   device=dev)
    th = {r: placement_report(p, prof, routing=r, engine="fused",
                              device=dev).theta for r in ("minimal", "ugal")}

    def run(label, routing, offered, dtype="float32", steps=None):
        cfg = SimConfig(backend="fused", dtype=dtype)
        r, seconds, got = _timed(lambda: simulate_placement(
            p, prof, routing=routing, offered=offered, steps=steps,
            config=cfg, device=dev))
        want = {"fused_step_update": 3 * r.steps,
                "fused_decision": 0 if routing == "minimal" else r.steps}
        for k, n in want.items():
            if got[k] != n:
                raise AssertionError(f"simulate_placement {label}: {k} "
                                     f"launched {got[k]} times in "
                                     f"{r.steps} steps, expected {n}")
        if r.backend != "fused" or not r.residual <= 1e-4:
            raise AssertionError(f"simulate_placement {label}: backend "
                                 f"{r.backend}, residual {r.residual}")
        log(f"simulate_placement {label}: offered {r.offered:.6f}, "
            f"delivered {r.theta:.6f} ({r.theta / r.offered:.4f} of "
            f"offered), alpha {r.alpha:.4f}, latency {r.latency:.2f} steps, "
            f"occupancy {r.occupancy:.1f}, residual {r.residual:.2e}; "
            f"{r.steps} steps in {seconds:.2f} s "
            f"({1e3 * seconds / r.steps:.2f} ms/step); launches {got}")
        return r

    m = run("minimal 0.9x", "minimal", 0.9 * th["minimal"])
    ugal = "ugal_threshold(0)"
    short = run("ugal_threshold(0) 0.9x float32, default length", ugal,
                0.9 * th["ugal"])
    f64 = run("ugal_threshold(0) 0.9x float64, default length", ugal,
              0.9 * th["ugal"], dtype="float64")
    # the plain witness of #1 / #2: the dense step (torch operations, no
    # kernel) on the same inputs.  Its (router, slot, dest) state is
    # 1,986 x 32 x 1,986 = 126M cells, above SIM_MAX_CELLS (the cap sized
    # for a host's memory) and about 1 GB a float64 tensor on the card
    cap, S.SIM_MAX_CELLS = S.SIM_MAX_CELLS, g.n * g.max_degree * g.n
    torch.cuda.reset_peak_memory_stats()
    try:
        dense, seconds, got = _timed(lambda: simulate_placement(
            p, prof, routing=ugal, offered=0.9 * th["ugal"],
            config=SimConfig(backend="dense", dtype="float64"), device=dev))
    finally:
        S.SIM_MAX_CELLS = cap
    if got["fused_step_update"] or got["fused_decision"] \
            or dense.backend != "dense" or dense.steps != f64.steps:
        raise AssertionError(f"dense witness: backend {dense.backend}, "
                             f"{dense.steps} steps, launches {got}")
    worst = 0.0
    for key in ("offered", "theta", "alpha", "latency", "delivered_rate",
                "accepted_rate", "occupancy"):
        e = _rel(getattr(f64, key), getattr(dense, key))
        worst = max(worst, e)
        if not e <= THETA_RTOL:
            raise AssertionError(f"simulate_placement {ugal} 0.9x float64 "
                                 f"{key}: fused {getattr(f64, key)!r} "
                                 f"against dense {getattr(dense, key)!r}")
    log(f"simulate_placement {ugal} 0.9x float64: the fused run within "
        f"{worst:.3e} of the dense step's (theta, alpha, latency, "
        f"occupancy, rates) over {dense.steps} steps; dense "
        f"{seconds:.2f} s, {torch.cuda.max_memory_allocated() / 2**30:.1f}"
        f" GiB allocated at its peak")
    torch.cuda.empty_cache()
    u32 = run("ugal_threshold(0) 0.9x float32", ugal, 0.9 * th["ugal"],
              steps=SETTLE_STEPS)
    u64 = run("ugal_threshold(0) 0.9x float64", ugal, 0.9 * th["ugal"],
              dtype="float64", steps=SETTLE_STEPS)
    for label, r in (("minimal", m), (ugal, u32)):
        if not r.theta / r.offered > 0.99:
            raise AssertionError(f"{label}: 0.9x the analytic theta is not "
                                 f"sustained: {r.theta / r.offered}")
    gap = abs(u32.theta / u32.offered - u64.theta / u64.offered)
    if not gap <= 1e-4:
        raise AssertionError(f"ugal_threshold(0) 0.9x: float32 and float64 "
                             f"delivered / offered {gap} apart")
    over = run("ugal_threshold(0) default (1.2x)", ugal, None)
    if not _rel(over.offered, 1.2 * th["ugal"]) <= THETA_RTOL:
        raise AssertionError(f"default offered {over.offered} is not "
                             f"1.2 x {th['ugal']}")
    # float32 fluid: delivered may exceed offered by float32 roundings
    if not over.theta <= over.offered * (1 + 1e-5):
        raise AssertionError(f"delivered {over.theta} above offered "
                             f"{over.offered}")
    log(f"simulate_placement: minimal sustains 0.9x its analytic theta "
        f"{th['minimal']:.6f} ({m.theta / m.offered:.6f}); per-hop "
        f"ugal_threshold(0) at 0.9x the fluid ugal theta {th['ugal']:.6f} "
        f"delivers {u32.theta / u32.offered:.6f} of offered over "
        f"{u32.steps} steps (float64 {u64.theta / u64.offered:.6f}; "
        f"{short.theta / short.offered:.6f} over {short.steps}); plateau "
        f"at 1.2x {over.theta:.6f} = {over.theta / th['ugal']:.4f} of the "
        f"fluid theta")


def check_fabric(dev):
    """Phase 21: the fabric layer on the card."""
    from repro_torch import placement_tables as PT
    from repro_torch.core import pn_graph
    from repro_torch.fabric import (evaluate_placements, fragmentation_sweep,
                                    placement_search)
    from repro_torch.kernels import mask_gemm as MG
    from repro_torch.kernels import sim_step as K

    g = pn_graph(FABRIC_Q)
    if (g.n, g.max_degree, round(2 * (FABRIC_Q + 1) / 5),
            g.n * FABRIC_DELTA0) != (FABRIC_ROUTERS, FABRIC_DEGREE,
                                     FABRIC_DELTA0, FABRIC_TERMINALS):
        raise AssertionError(f"PN({FABRIC_Q}): {g.n} routers of degree "
                             f"{g.max_degree}")
    # the comparisons with the plain versions launch #1 / #2 before the
    # counters are zeroed
    _hold_placement_kernels(dev, g, PT.PROFILES["ep_heavy"])
    MG.reset_launches()
    K.reset_launches()

    # BENCH_4's four cases at their recorded sizes, fused
    bench4 = {e["name"]: e for e in
              json.loads((ROOT / "BENCH_4.json").read_text())["entries"]}
    for name, case_g, mesh, axes, delta0, expect in PT.placement_cases():
        out, seconds, got = _timed(lambda: PT.placement_one(
            case_g, mesh, axes, delta0, expect, engine="fused", device=dev))
        _need_mask_gemm(name, got)
        ties = _hold_bench4(name, case_g, mesh, axes, delta0, out,
                            bench4[f"placement[{name}]"], dev)
        s = out[1]
        log(f"placement[{name}] ({case_g.n} routers, mesh {mesh}, delta0 "
            f"{delta0}): {seconds:.2f} s, launches {got}; ep best "
            f"{s['ep_heavy']['best']}@{s['ep_heavy']['best_theta']:.4f}, "
            f"dp best {s['dp_heavy']['best']}, fragmentation best "
            f"{s['fragmentation']['best']}, max_rel_err {out[2]}; rows "
            f"{'equal to' if not ties else 'tied with'} BENCH_4's "
            f"(BENCH_4's CPU record {bench4[f'placement[{name}]']['seconds']}"
            f" s)")

    # full width: PN(31) as the planner sizes it, an 8,192-chip job
    args = (g, FABRIC_MESH, FABRIC_AXES, FABRIC_DELTA0)
    for pname, prof in PT.PROFILES.items():
        out, seconds, got = _timed(lambda: placement_search(
            *args, prof, strategies=PT.STRATEGIES, routing="ugal",
            engine="fused", device=dev))
        _need_mask_gemm(f"search {pname}", got)
        dense, dense_s, dense_got = _timed(lambda: evaluate_placements(
            *args, prof, strategies=GEOMETRIC, routing="ugal",
            engine="dense", device=dev))
        if dense_got["frontier_step"] or dense_got["backward_step"]:
            raise AssertionError("the dense engine launched #3 / #4")
        rows = out["rows"]
        geo = {s: rows[s] for s in GEOMETRIC}
        e_dense = _hold_rows(f"search {pname} fused vs dense", geo,
                             {s: _row_tuple(r) for s, r in dense.items()})
        e_ref = _hold_rows(f"search {pname} vs the reference", geo,
                           FULL_SEARCH[pname])
        greedy, group = rows[GREEDY]["theta"], rows["group"]["theta"]
        # a swap is kept only on a strictly lower max load; normalised by
        # the same per-chip bytes, it can round one ulp either way
        if not greedy >= group * (1 - 1e-12):
            raise AssertionError(f"search {pname}: greedy {greedy} below "
                                 f"group {group}")
        log(f"search {pname} (PN({FABRIC_Q}), mesh {FABRIC_MESH}, delta0 "
            f"{FABRIC_DELTA0}, ugal, fused): {seconds:.2f} s, launches "
            f"{got}; dense {dense_s:.2f} s; best {out['best']}; "
            + ", ".join(f"{s} {r['theta']:.6f} (u {r['u']:.4f}, kbar_eff "
                        f"{r['kbar_eff']:.4f}, alpha {r['alpha']})"
                        for s, r in rows.items())
            + f"; geometric rows within {e_dense:.3e} of dense, "
              f"{e_ref:.3e} of the reference")

    jobs = [(FABRIC_MESH, FABRIC_AXES, PT.PROFILES["ep_heavy"])] * 2
    frag, seconds, got = _timed(lambda: fragmentation_sweep(
        g, jobs, FABRIC_DELTA0, routing="ugal", background="tornado",
        engine="fused", device=dev))
    _need_mask_gemm("fragmentation", got)
    lay = frag["layouts"]
    e_frag = _hold_rows("fragmentation", lay, FULL_FRAG)
    if not lay["packed"]["theta"] >= lay["interleaved"]["theta"]:
        raise AssertionError(f"fragmentation: interleaved beats packed "
                             f"{lay}")
    chips = int(np.prod(FABRIC_MESH))
    log(f"fragmentation (two {chips:,}-chip ep_heavy jobs, {2 * chips:,} "
        f"of {FABRIC_TERMINALS:,} terminals, tornado, ugal): {seconds:.2f} s, "
        f"launches {got}; "
        + ", ".join(f"{k} {r['theta']:.6f}" for k, r in lay.items())
        + f"; best {frag['best']}; within {e_frag:.3e} of the reference")

    _check_plan(dev)
    _check_simulation(dev, g, PT.PROFILES["ep_heavy"])
    _profile_descent(dev, g, PT.PROFILES["ep_heavy"])

    # the counters were zeroed at the phase's start
    launches = {k: v for k, v in _launch_counts().items()
                if k in FABRIC_KERNELS}
    if not all(launches[k] > 0 for k in FABRIC_KERNELS):
        raise AssertionError(f"phase 21 never launched a kernel: {launches}")
    log(f"phase 21: launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# Observability on the card: phase 22
# ---------------------------------------------------------------------------

OBS_DIR = ROOT / "build" / "obs_smoke"
# phase 22's halting run: PN(27) points at twice the analytic theta, the
# dest-stability watchdog of the reference's postmortem test over a
# shorter window
OBS_HALT = dict(factor=2.0, steps=120, ratio=0.8, window=8, warmup=8,
                recorder=64)


def _same_run(label, a, b):
    """Every SimRun field of ``b`` equal to ``a``'s, bit for bit."""
    for key, va in vars(a).items():
        vb = getattr(b, key)
        if isinstance(va, dict):
            same = va.keys() == vb.keys() and all(
                np.array_equal(np.asarray(va[k]), np.asarray(vb[k]),
                               equal_nan=True) for k in va)
        elif isinstance(va, np.ndarray):
            same = np.array_equal(va, vb, equal_nan=True)
        elif isinstance(va, float) and np.isnan(va):
            same = isinstance(vb, float) and np.isnan(vb)
        else:
            same = va == vb
        if not same:
            raise AssertionError(f"{label}: SimRun.{key} differs: {vb!r} "
                                 f"against {va!r}")


def _copies(rows) -> dict:
    """Host-to-device and device-to-host copies among device_rows' rows."""
    return {way: sum(r[1] for r in rows if f"Memcpy {way}" in r[2])
            for way in ("HtoD", "DtoH")}


def _obs_sweeps(dev, g, dem, th):
    """Phase 22 A: phase 7's PN(27) sweep with no session, under
    ``metrics`` and under ``trace`` with the monitor armed."""
    from repro_torch import obs
    from repro_torch.kernels import sim_step as K
    from repro_torch.sim import SimConfig, Simulator, saturation_sweep

    cfg = SimConfig(routing="ugal_threshold(0)")
    ways = {}
    # the first sweep of the phase pays first-call costs: a warm-up
    # sweep with no session goes first and is not compared
    for way in ("warm-up", "off", "metrics", "trace+monitor"):
        if way in ("warm-up", "off"):
            ctx = obs.session(None)
        elif way == "metrics":
            ctx = obs.session("metrics")
        else:
            wd = obs.Watchdog([obs.residual(tol=1e-4), obs.nonfinite(),
                               obs.step_time()], action="continue",
                              dir=str(OBS_DIR / "sweep"))
            ctx = obs.session("trace", series=True,
                              recorder=obs.FlightRecorder(64), watchdog=wd)
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx as sess:
            sw = saturation_sweep(g, dem, routing="ugal_threshold(0)",
                                  config=cfg,
                                  loads=np.array([0.95, 1.08]) * th,
                                  steps=30, refine=2, theta_analytic=th,
                                  device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        steps = sum(r.steps for r in sw.runs)
        per = {k: v / steps for k, v in K.LAUNCHES.items()}
        if per != {"fused_step_update": 3.0, "fused_decision": 1.0}:
            raise AssertionError(f"obs {way}: launches {K.LAUNCHES} in "
                                 f"{steps} steps")
        ways[way] = dict(sweep=sw, sess=sess, seconds=seconds, steps=steps)
        log(f"obs {way}: pn27 sweep of {len(sw.runs)} probes, {steps} "
            f"steps in {seconds:.3f} s ({1e3 * seconds / steps:.2f} ms a "
            f"step of wall); knee {sw.theta:.6f}; launches a step {per}")
    del ways["warm-up"]
    base = ways["off"]["sweep"]
    for way in ("metrics", "trace+monitor"):
        sw = ways[way]["sweep"]
        if (sw.theta, sw.theta_unstable, len(sw.runs)) != \
                (base.theta, base.theta_unstable, len(base.runs)):
            raise AssertionError(f"obs {way}: knee {sw.theta} / "
                                 f"{sw.theta_unstable} against {base.theta}")
        for i, (a, b) in enumerate(zip(base.runs, sw.runs)):
            _same_run(f"obs {way} probe {i}", a, b)
        m = ways[way]["sess"].metrics
        for key in ("injected", "delivered", "accepted", "diverted",
                    "dropped"):
            want = 0.0
            for r in sw.runs:
                want += r.dropped if key == "dropped" else r.totals[key]
            got = m.counter(f"sim.{key}").value
            if got != want:
                raise AssertionError(f"obs {way}: sim.{key} {got!r} against "
                                     f"the runs' own {want!r}")
        if m.counter("sim.steps").value != ways[way]["steps"] or \
                m.counter("sim.runs").value != len(sw.runs):
            raise AssertionError(f"obs {way}: sim.steps / sim.runs")
    sess = ways["trace+monitor"]["sess"]
    rec, wd = sess.recorder, sess.watchdog
    # the window's last entries are the last probe's steps (earlier
    # probes' steps sit before them, numbered from 0 again)
    last = base.runs[-1]
    win = {k: v[-last.steps:] for k, v in rec.window_arrays().items()}
    if not np.array_equal(win["step"], np.arange(last.steps)):
        raise AssertionError(f"obs recorder steps {win['step']}")
    for key in ("delivered", "accepted", "offered", "occupancy",
                "src_backlog", "diverted"):
        if not np.array_equal(win[key], last.history[key]):
            raise AssertionError(f"obs recorder channel {key} differs from "
                                 f"the last probe's history")
    if len(sess.metrics.series("sim.occ_vc0")) != ways["trace+monitor"][
            "steps"]:
        raise AssertionError("obs: the occupancy series missed steps")
    log(f"obs: the three sweeps agree bit for bit (every SimRun field and "
        f"history); sim.injected / delivered / accepted / diverted / "
        f"dropped equal the runs' own sums bit for bit under metrics and "
        f"trace; the recorder's window equals the last probe's history; "
        f"watchdog fired {wd.fired}; spans "
        f"{ {k: v['count'] for k, v in sess.span_summary().items()} }")

    # host copies of one 30-step run: none added with no session or
    # metrics; the monitor reads one digest a step
    sim = Simulator(g, cfg, demand=dem, device=dev)
    sim.run(dem, th, 30)
    copies = {}
    for way in ("off", "metrics", "trace+monitor"):
        def one():
            if way == "off":
                sim.run(dem, th, 30)
                return
            kw = ({} if way == "metrics" else dict(
                series=True, recorder=obs.FlightRecorder(64),
                watchdog=obs.Watchdog([obs.residual(tol=1e-4),
                                       obs.nonfinite(), obs.step_time()],
                                      dir=str(OBS_DIR / "copies"))))
            with obs.session("metrics" if way == "metrics" else "trace",
                             **kw):
                sim.run(dem, th, 30)
        rows, wall_ms, busy_ms, _ = device_rows(one)
        copies[way] = _copies(rows)
        log(f"obs {way}: one 30-step pn27 run: {copies[way]} copies, wall "
            f"{wall_ms / 30:.3f} ms a step, device busy {busy_ms / 30:.3f} "
            f"ms a step (idle share {1.0 - busy_ms / wall_ms:.3f})")
    if copies["metrics"] != copies["off"]:
        raise AssertionError(f"obs metrics copies {copies['metrics']} "
                             f"against {copies['off']} with no session")
    if not copies["trace+monitor"]["DtoH"] >= copies["off"]["DtoH"] + 30:
        raise AssertionError(f"obs trace+monitor: {copies['trace+monitor']}"
                             f" copies, expected a read a step")
    return {way: 1e3 * w["seconds"] / w["steps"] for way, w in ways.items()}


def _obs_halt(dev, g, dem, th):
    """Phase 22 B: a past-knee PN(27) run halted by the dest-stability
    watchdog; the bundle's recorder window against the run's history."""
    from repro_torch import obs
    from repro_torch.sim import SimConfig, Simulator

    h = OBS_HALT
    sim = Simulator(g, SimConfig(routing="ugal_threshold(0)"), demand=dem,
                    device=dev)
    offered = h["factor"] * th
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = sim.run(dem, offered, h["steps"])
    off_s = time.perf_counter() - t0
    wd = obs.Watchdog([obs.dest_stability(ratio=h["ratio"],
                                          window=h["window"],
                                          warmup=h["warmup"])],
                      action="halt", dir=str(OBS_DIR / "postmortem"))
    fired = None
    t0 = time.perf_counter()
    try:
        with obs.session("metrics", recorder=obs.FlightRecorder(
                h["recorder"]), watchdog=wd):
            sim.run(dem, offered, h["steps"])
    except obs.WatchdogFired as e:
        fired = e
    torch.cuda.synchronize()
    halt_s = time.perf_counter() - t0
    if fired is None:
        raise AssertionError(f"pn27 at {h['factor']}x theta: the "
                             f"dest-stability watchdog did not halt the run")
    bundle = obs.load_bundle(fired.path)
    idx = np.asarray(bundle["recorder"]["steps"], dtype=np.int64)
    step = bundle["sample"]["step"]
    if idx[-1] != step or len(idx) != min(h["recorder"], step + 1):
        raise AssertionError(f"bundle window {idx[0]}..{idx[-1]}, fired at "
                             f"{step}")
    for key in ("delivered", "accepted", "offered", "occupancy",
                "src_backlog", "diverted"):
        got = np.asarray(bundle["recorder"]["channels"][key])
        if not np.array_equal(got, full.history[key][idx]):
            raise AssertionError(f"bundle channel {key} differs from the "
                                 f"run's history")
    log(f"obs halt: pn27 at {h['factor']}x theta halted at step {step} of "
        f"{h['steps']} ({fired.reason}); bundle {fired.path} reloaded, its "
        f"recorder window (steps {idx[0]}..{idx[-1]}) equal to the run's "
        f"history bit for bit; wall {1e3 * off_s / h['steps']:.2f} ms a "
        f"step with obs off, {1e3 * halt_s / (step + 1):.2f} ms with the "
        f"monitor and its per-dest digest")
    return bundle


def _obs_descent(dev):
    """Phase 22 C: phase 21's full-width greedy_swap(30) descent under
    ``metrics``."""
    from repro_torch import obs
    from repro_torch import placement_tables as PT
    from repro_torch.core import pn_graph
    from repro_torch.fabric import (collective_traffic, greedy_improve,
                                    place_mesh, schedule_from_profile)

    g = pn_graph(FABRIC_Q)
    sched = schedule_from_profile(PT.PROFILES["ep_heavy"], FABRIC_AXES)
    traffic = collective_traffic(FABRIC_MESH, FABRIC_AXES, sched)
    p0 = place_mesh(g, FABRIC_MESH, FABRIC_AXES, FABRIC_DELTA0, "group",
                    device=dev)
    with obs.session("metrics") as sess:
        (_, _, hist), seconds, got = _timed(lambda: greedy_improve(
            p0, traffic, iters=GREEDY_ITERS, seed=0, routing="ugal",
            engine="fused", return_history=True, device=dev))
    evals = _descent_evals(p0, hist)
    m = sess.metrics
    swaps = m.counter("placement.swap_evals").value
    # a source block launches #3 once more than #4 (depth + 1 against
    # depth), so the blocks are the difference
    blocks = got["frontier_step"] - got["backward_step"]
    dispatch = m.counter("util.dispatch[fused]").value
    if swaps != evals - 1:
        raise AssertionError(f"placement.swap_evals {swaps} against the "
                             f"history's {evals} evaluations less the start")
    if not dispatch == blocks == 3 * evals:
        raise AssertionError(f"util.dispatch[fused] {dispatch}, source "
                             f"blocks {blocks}, evaluations {evals}")
    log(f"obs descent (PN({FABRIC_Q}), {int(np.prod(FABRIC_MESH)):,} chips, "
        f"ugal, fused, metrics): {seconds:.2f} s; placement.swap_evals "
        f"{swaps:.0f} (+1 start = the history's {evals}), swap_accepted "
        f"{m.counter('placement.swap_accepted').value:.0f}; "
        f"util.dispatch[fused] {dispatch:.0f} = #3 - #4 source blocks "
        f"{blocks} = 3 a evaluation; routing.blend.solves "
        f"{m.counter('routing.blend.solves').value:.0f}; launches {got}")


def _obs_model_spans(dev):
    """Phase 22 D: smollm-135m's train.step and serve.run spans under
    ``trace``, each against the CUDA-event time of its own work."""
    import repro_torch.launch.serve as LS
    from repro_torch import obs
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_arch("smollm-135m")
    events = {"train": [], "serve": []}

    def bracket(kind, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        events[kind].append((start, end))
        return out

    steps = 3
    tr = Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                                 global_batch=TRAIN["batch"]),
                 TrainerConfig(total_steps=steps, checkpoint_every=100,
                               checkpoint_dir=str(OBS_DIR / "ckpt"),
                               log_every=steps),
                 device=dev)
    inner = tr.step_fn
    tr.step_fn = lambda state, batch: bracket(
        "train", lambda: inner(state, batch))

    class TimedEngine(LS.Engine):
        def run(self):
            return bracket("serve", super().run)

    base = LS.Engine
    LS.Engine = TimedEngine
    try:
        with obs.session("trace") as sess:
            tr.run()
            results, serve_s, _ = LS.serve(
                "smollm-135m", full=True, requests=SERVE["requests"],
                max_new=SERVE["max_new"], max_batch=SERVE["max_batch"],
                max_len=SERVE["max_len"], device=dev)
    finally:
        LS.Engine = base
    torch.cuda.synchronize()
    spans = {name: [e for e in sess.events if e[0] == name]
             for name in ("train.step", "serve.run")}
    if len(spans["train.step"]) != steps or len(spans["serve.run"]) != 1:
        raise AssertionError(f"spans { {k: len(v) for k, v in spans.items()} }")
    rows = []
    for name, kind in (("train.step", "train"), ("serve.run", "serve")):
        for ev, (start, end) in zip(spans[name], events[kind]):
            span_ms, work_ms = ev[2] / 1e6, start.elapsed_time(end)
            if not span_ms >= work_ms:
                raise AssertionError(f"{name}: span {span_ms:.3f} ms "
                                     f"shorter than its work's {work_ms:.3f}"
                                     f" ms by CUDA events")
            rows.append(f"{name} {span_ms:.2f} >= {work_ms:.2f}")
    n_tok = sum(len(v) for v in results.values())
    if spans["serve.run"][0][2] / 1e9 != serve_s:
        raise AssertionError("serve.run: the launcher's seconds are not "
                             "the span's")
    log(f"obs spans (ms, span >= CUDA events of its work): {rows}; serve "
        f"{n_tok} tokens, {n_tok / serve_s:.1f} tok/s")
    return sess


def check_obs(dev):
    """Phase 22: obs on the card."""
    from repro_torch.core import pn_graph
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mask_gemm as MG
    from repro_torch.kernels import sim_step as K
    from repro_torch.obs import report

    shutil.rmtree(OBS_DIR, ignore_errors=True)
    OBS_DIR.mkdir(parents=True)
    K.reset_launches()
    MG.reset_launches()
    FA.reset_launches()
    g = pn_graph(27)
    dem = points_demand(g, 27)
    th = THETA_PN27_POINTS_UGAL
    wall = _obs_sweeps(dev, g, dem, th)
    bundle = _obs_halt(dev, g, dem, th)
    _obs_descent(dev)
    sess = _obs_model_spans(dev)
    trace = OBS_DIR / "trace.json"
    sess.write_chrome(str(trace))
    page = OBS_DIR / "report.html"
    report.render_report(str(page), sessions=[
        ("phase 22", sess.snapshot(), report.session_series(sess))],
        bundles=[bundle], title="chip_smoke.py phase 22")
    log(f"obs: Chrome trace {trace.relative_to(ROOT)} "
        f"{trace.stat().st_size} bytes, report {page.relative_to(ROOT)} "
        f"{page.stat().st_size} bytes; wall per pn27 step "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in wall.items()))
    launches = {**K.LAUNCHES, **MG.LAUNCHES,
                **{k: FA.LAUNCHES[k] for k in ("flash_attention_fwd",
                                               "flash_attention_dq",
                                               "flash_attention_dkv")}}
    if not all(launches[k] > 0 for k in launches):
        raise AssertionError(f"phase 22 never launched a kernel: "
                             f"{launches}")
    log(f"phase 22: launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 23: the MoE, MLA and RG-LRU families on the serving path
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-3b-a800m"
MOE_TOKENS = (1536, 4)     # a 1536-token prefill, a batch-4 decode step
RING_SLOTS = 64            # recurrentgemma reduced's window: a ring cache


def _hold_arch_attention(dev):
    """Phase 23's shapes of #5 against its plain version, on random bf16
    inputs: granite-moe's full-width layer (Hq 24, Hkv 8, D 64, causal)
    at the longest prompt, S = 1536, through the kernel's wrapper; and
    deepseek reduced's MLA (Hq = Hkv = 4, q/k head 32, v head 16, scale
    32^-0.5, causal) at S = 1536 through ``ops.attention``, which pads v
    with zeros to 32 for the kernel, launches it once and cuts the output
    back to 16.  The plain version runs on the same q, k and the
    zero-padded v, its output cut the same way.  o within phase 9's
    1e-4 + 2^-7 |o| and equal to the plain float32 o rounded to bf16 in
    at least SAME_SHARE of the entries; granite's lse at 3e-5."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref

    gen = torch.Generator(device=dev).manual_seed(230)
    s = SERVE["max_len_prompt"]

    def rand(h, d):
        return torch.randn((1, h, s, d), generator=gen,
                           device=dev).bfloat16()

    cfg = get_arch(MOE_ARCH)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = rand(hq, d), rand(hkv, d), rand(hkv, d)
    o, lse = FA.flash_attention(q, k, v)
    w_o, w_lse = flash_attention_ref(q, k, v)
    name = f"flash_attention {MOE_ARCH} Hq={hq} Hkv={hkv} S={s} D={d} bf16"
    e, rel = _close_or_raise(name, o, w_o, 1e-4, 2.0 ** -7)
    _close_or_raise(name + " lse", lse, w_lse, 3e-5, 3e-5)
    log(f"{name}: ok (max abs err {e:.3e}, max rel err {rel:.3e}; "
        f"{_check_same_share(name, o, w_o):.5f} of o equal to the plain o "
        f"in bf16)")

    mla_cfg = get_arch("deepseek-v3-671b").reduced()
    mla = mla_cfg.mla
    h, dqk = mla_cfg.n_heads, mla.qk_nope + mla.qk_rope
    q, k, v = rand(h, dqk), rand(h, dqk), rand(h, mla.v_head)
    scale = dqk ** -0.5
    before = FA.LAUNCHES["flash_attention_fwd"]
    with torch.no_grad():
        o = ops.attention(q, k, v, causal=True, scale=scale)
    if FA.LAUNCHES["flash_attention_fwd"] != before + 1:
        raise AssertionError("ops.attention with a narrow v did not launch "
                             "#5 once")
    v_pad = torch.nn.functional.pad(v, (0, dqk - mla.v_head))
    w_o = flash_attention_ref(q, k, v_pad, scale=scale)[0][..., :mla.v_head]
    name = (f"ops.attention deepseek-v3-671b reduced MLA Hq=Hkv={h} S={s} "
            f"q/k {dqk} v {mla.v_head} bf16")
    if o.shape != w_o.shape:
        raise AssertionError(f"{name}: shape {tuple(o.shape)}, want "
                             f"{tuple(w_o.shape)}")
    e, rel = _close_or_raise(name, o, w_o, 1e-4, 2.0 ** -7)
    log(f"{name}: ok (max abs err {e:.3e}, max rel err {rel:.3e}; "
        f"{_check_same_share(name, o, w_o):.5f} of o equal to the plain o "
        f"in bf16)")


def _hold_moe_route(dev, bw):
    """Phase 23 A: one full-width granite-moe MoE layer (40 experts top-8,
    d_model 1536, width 512, random weights from a seed) on random bf16
    inputs at T = 1536 and T = 4: the port's route (bins of T rows, three
    batched products, the k picks weighted and summed in float32) against
    ``moe_dense_ref`` (the reference's dense path, every expert on every
    token) weighting and summing in float32, within one bf16 rounding
    (phase 9's 1e-4 + 2^-7 |y|), and a repeated call bit for bit.  Prints
    the share of entries equal to the oracle's, the difference from the
    oracle in bf16 throughout (the reference's rounding of the weights
    and sums), both times by CUDA events and the bound of the routed
    work (T k products of the expert MLP on the bf16 tensor cores, or
    the bytes of x, y and the bf16 expert weights)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ref import moe_dense_ref
    from repro_torch.models.layers import cast_weight
    from repro_torch.models.moe import MoE, router_topk

    cfg = get_arch(MOE_ARCH)
    moe = cfg.moe
    m, f, e, k = cfg.d_model, moe.d_ff_expert, moe.n_experts, moe.top_k
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(23)
    block = MoE(cfg, device=dev, generator=gen)
    rows = {}
    with torch.no_grad():
        for t in MOE_TOKENS:
            x2d = torch.randn((t, m), device=dev, generator=gen).to(bf)
            _, top_w, top_idx = router_topk(
                cfg, x2d @ cast_weight(block, "router", bf))

            def route():
                return block.route(x2d, top_w, top_idx)

            def plain(acc=torch.float32):
                return moe_dense_ref(x2d, block.w_gate, block.w_up,
                                     block.w_down, top_w, top_idx,
                                     acc_dtype=acc)

            got, again = route(), route()
            if not torch.equal(got, again):
                raise AssertionError(f"moe route T={t}: a repeated call "
                                     f"differs")
            want = plain()
            err, rel = _close_or_raise(f"moe route T={t}", got, want, 1e-4,
                                       2 ** -7)
            same = float((got == want).float().mean())
            err_bf = float((got.float() - plain(None).float()).abs().max())
            reps = 5 if t > 64 else 50
            ms, plain_ms = cuda_ms(route, reps), cuda_ms(plain, reps)
            nbytes = 2 * (2 * t * m + 3 * e * m * f) + 4 * t * k
            bound = _bound(nbytes, bw=bw, bf16_flops=6.0 * t * k * m * f)
            rows[t] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                           bound_ms=bound["bound_ms"])
            log(f"moe route T={t} (E={e}, k={k}, M={m}, F={f}, bf16): max "
                f"abs err {err:.3e} (max rel {rel:.3e}) against the dense "
                f"oracle summed in float32, {same:.4f} of the entries "
                f"equal; {err_bf:.3e} against the oracle in bf16 (the "
                f"reference's rounding); a repeat bit for bit; {ms:.4f} ms "
                f"(the dense oracle {plain_ms:.4f} ms), bound "
                f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} (the "
                f"routed {6.0 * t * k * m * f / 1e9:.3f} GFLOP; the bins "
                f"compute {e / k:.0f}x that)")
    return rows


def check_archs(dev, bw, out: dict):
    """Phase 23: the MoE route at full width (A), granite-moe-3b-a800m
    served at full width (B), deepseek-v3-671b and recurrentgemma-9b
    served at ``reduced()`` (C); #5's launches inside the three
    Engine.run calls.  First #5 at granite's and deepseek's MLA shapes
    against its plain version.  Puts granite's prompts and emitted
    tokens into ``out`` (phase 33 C serves them again on a mesh)."""
    _hold_arch_attention(dev)
    _hold_moe_route(dev, bw)
    model, n_moe, out["granite"] = serve_arch(dev, MOE_ARCH,
                                              "flash_attention_fwd")
    del model
    torch.cuda.empty_cache()
    _, n_mla, _ = serve_arch(dev, "deepseek-v3-671b", "flash_attention_fwd",
                             reduced=True)
    _, n_lru, _ = serve_arch(dev, "recurrentgemma-9b", "flash_attention_fwd",
                             reduced=True, max_len=RING_SLOTS)
    log(f"phase 23: #5 launched {n_moe} + {n_mla} + {n_lru} times in "
        f"Engine.run")
    return {"flash_attention_fwd": n_moe + n_mla + n_lru}


# ---------------------------------------------------------------------------
# Phase 24: the memory-input families on the serving path
# ---------------------------------------------------------------------------

ENC_ARCH = "seamless-m4t-large-v2"
VISION_ARCH = "llama-3.2-vision-90b"
VISION_LAYERS = 10         # reduced() keeps 4 layers: no xattn among them
MEMORY_SEEDS = (24, 25)    # the served memory, and a second draw


def _memory_draw(cfg, tokens: int, seed: int) -> np.ndarray:
    """One (1, tokens, d_model) float32 memory from the data pipeline's
    stub frontend (``synthetic_batch``'s ``memory``, uniform in [-1,
    1))."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    return synthetic_batch(DataConfig(
        vocab=cfg.vocab, seq_len=SERVE["max_len_prompt"], global_batch=1,
        seed=seed, memory_tokens=tokens, d_model=cfg.d_model), 0)["memory"]


def _memory_launches(cfg) -> tuple[int, int]:
    """#5 launches a request's prefill makes (encoder layers, then one per
    self- and one per cross-attention) and a decode step makes (one per
    cross layer: the decoder's self-attention decodes in plain torch)."""
    from repro_torch.models import layer_plan
    kinds = layer_plan(cfg).kinds
    n_self = sum(k in ("attn", "dec_xattn") for k in kinds)
    n_cross = sum(k in ("xattn", "dec_xattn") for k in kinds)
    n_enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    return n_enc + n_self + n_cross, n_cross


def _hold_memory_attention(dev, bw) -> dict:
    """Phase 24 A: #5 in bf16, non-causal, at the memory families' shapes
    against its plain version: seamless's encoder (Sq = Skv = 384 frames,
    16 / 16 heads of 64), its cross prefill (Sq 1536, Skv 384), its cross
    decode step (B = 4, Sq = 1) and one full-width llama-3.2-vision cross
    layer (64 / 8 heads of 128, Sq 1536, Skv 1600).  o within phase 9's
    1e-4 + 2^-7 |o| and equal to the plain float32 o rounded to bf16 in at
    least SAME_SHARE of the entries, lse at 3e-5.  Each timed by CUDA
    events beside its plain version and SDPA's forward (``enable_gqa``,
    no mask; the yardstick, which the port never calls), with its bound:
    the bytes of q, k, v, o and lse at the HBM rate against Q K^T (bf16
    operands) and P.V (p float32, three times) on the tensor cores, over
    all Sq x Skv pairs.  #5 and SDPA are also timed by their device time
    alone (:func:`device_rows`)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import flash_attention_ref

    enc, vis = get_arch(ENC_ARCH), get_arch(VISION_ARCH)
    frames = SERVE["max_len_prompt"] // enc.encoder.frame_ratio
    s = SERVE["max_len_prompt"]
    he, de = enc.n_heads, enc.resolved_head_dim
    shapes = {  # name: (b, hq, hkv, sq, skv, d)
        "seamless encoder": (1, he, enc.n_kv_heads, frames, frames, de),
        "seamless cross prefill": (1, he, enc.n_kv_heads, s, frames, de),
        "seamless cross decode": (SERVE["max_batch"], he, enc.n_kv_heads,
                                  1, frames, de),
        "llama-3.2-vision cross": (1, vis.n_heads, vis.n_kv_heads, s,
                                   vis.vision.n_image_tokens,
                                   vis.resolved_head_dim)}
    gen = torch.Generator(device=dev).manual_seed(24)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, err = {}, 0.0
    for label, (b, hq, hkv, sq, skv, d) in shapes.items():
        q = torch.randn((b, hq, sq, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, hkv, skv, d), generator=gen,
                        device=dev).bfloat16()
        v = torch.randn((b, hkv, skv, d), generator=gen,
                        device=dev).bfloat16()
        o, lse = FA.flash_attention(q, k, v, causal=False)
        w_o, w_lse = flash_attention_ref(q, k, v, causal=False)
        name = (f"flash_attention {label} B={b} Hq={hq} Hkv={hkv} Sq={sq} "
                f"Skv={skv} D={d} bf16 non-causal")
        e, rel = _close_or_raise(name, o, w_o, 1e-4, 2.0 ** -7)
        _close_or_raise(name + " lse", lse, w_lse, 3e-5, 3e-5)
        share = _check_same_share(name, o, w_o)
        err = max(err, e)
        reps = 50 if sq == 1 else 20
        flops = 2.0 * d * b * hq * sq * skv     # Q K^T, and P.V alike
        nbytes = 2 * (2 * b * hq * sq * d + 2 * b * hkv * skv * d) \
            + 4 * b * hq * sq
        fwd = lambda: FA.flash_attention(q, k, v, causal=False)
        lib = lambda: sdpa(q, k, v, enable_gqa=True)
        # CUDA events over back-to-back calls read the host's launch work
        # at the small shapes; the device time reads the kernels alone
        row = dict(
            ms=cuda_ms(fwd, reps), device_ms=device_rows(fwd, reps)[2] / reps,
            plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v,
                                                         causal=False), 3),
            library_ms=cuda_ms(lib, reps),
            library_device_ms=device_rows(lib, reps)[2] / reps,
            max_abs_err=e,
            **_bound(nbytes, bw=bw, bf16_flops=flops, f32_bf16_flops=flops))
        rows[label] = row
        log(f"{name}: ok (max abs err {e:.3e}, max rel err {rel:.3e}; "
            f"{share:.5f} of o equal to the plain o in bf16); "
            f"{row['ms']:.4f} ms by CUDA events, {row['device_ms']:.4f} ms "
            f"of device time, plain {row['plain_ms']:.4f} ms, SDPA "
            f"{row['library_ms']:.4f} / {row['library_device_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
            f"({row['tc_flops'] / 1e9:.3f} GFLOP on the tensor cores = "
            f"{row['ops_ms']:.4f} ms; {nbytes / 1e6:.2f} MB = "
            f"{row['bytes_ms']:.4f} ms)")
    return rows


def check_memory(dev, bw, out: dict):
    """Phase 24: #5 at the memory families' shapes (A);
    seamless-m4t-large-v2 at full width served with one memory of 384
    frames, its gates at 1.0 (B): #5 exactly 72 times a request and 24 a
    decode step inside Engine.run, tokens within 0.05 of the solo max
    logit, a second memory draw moving the first request's last prefill
    logits by more than 0.05; llama-3.2-vision-90b at ``reduced()`` with 10 layers and
    16 image tokens (C): #5 10 times a request and 2 a decode step.
    Puts seamless's prompts, memory and emitted tokens into ``out``
    (phase 33 C serves them again on a mesh)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build

    _hold_memory_attention(dev, bw)

    cfg = get_arch(ENC_ARCH)
    frames = SERVE["max_len_prompt"] // cfg.encoder.frame_ratio
    memory = _memory_draw(cfg, frames, MEMORY_SEEDS[0])
    model, n_enc, info = serve_arch(dev, ENC_ARCH, "flash_attention_fwd",
                                    memory=memory)
    out["seamless"] = dict(info, memory=memory)
    bundle = build(cfg)
    prompt = torch.as_tensor(info["prompts"][0][None], device=dev).long()
    last = [bundle.prefill(model, prompt, memory=torch.as_tensor(
        _memory_draw(cfg, frames, seed), device=dev))[0][0, -1]
            for seed in MEMORY_SEEDS]
    moved = float((last[0] - last[1]).abs().max())
    log(f"{ENC_ARCH}: a second memory draw moves the first request's last "
        f"prefill logits by {moved:.4f} (max abs; must exceed "
        f"{SERVE['gap']})")
    if not moved > SERVE["gap"]:
        raise AssertionError(f"{ENC_ARCH}: the memory does not reach the "
                             f"logits (moved {moved:.4f})")
    del model, last
    torch.cuda.empty_cache()

    vcfg = get_arch(VISION_ARCH).reduced().replace(n_layers=VISION_LAYERS)
    _, n_vis, _ = serve_arch(
        dev, VISION_ARCH, "flash_attention_fwd", reduced=True,
        n_layers=VISION_LAYERS,
        memory=_memory_draw(vcfg, vcfg.vision.n_image_tokens,
                            MEMORY_SEEDS[0]))
    log(f"phase 24: #5 launched {n_enc} + {n_vis} times in Engine.run")
    return {"flash_attention_fwd": n_enc + n_vis}


# ---------------------------------------------------------------------------
# Phase 25: training of the MoE, MLA + MTP, RG-LRU and memory-input families
# ---------------------------------------------------------------------------

# granite-moe-3b-a800m at full width: 4096 tokens a step
MOE_TRAIN = dict(batch=2, seq=2048, steps=6, lr=1e-3)
# seamless-m4t-large-v2 at full width: 3072 tokens and 768 frames a step
ENC_TRAIN = dict(batch=2, seq=1536, steps=6, lr=1e-3)
# the reduced families (and granite reduced's crash and resume): 2048
# tokens a step (at 512, one batch's loss stands some 0.1 from the next,
# as much as four steps learn: vision's went 6.599 -> 6.616)
SMALL_TRAIN = dict(batch=8, seq=256, steps=4, lr=1e-3, crash_steps=8,
                   ckpt_every=4, crash_at=6)
TRAIN25_DIR = ROOT / "build" / "train_smoke25"
PEAK_LIMIT = 80e9          # bytes: the 80 GB card's capacity


def _train_launches(cfg) -> dict:
    """The model kernels' launches in one train step, read from the
    model's layer plan: #5 once per attention (each self or cross layer,
    each encoder layer) and, under remat, again for its recompute in the
    backward, #6 and #7 once each; the MTP head's block (not under remat)
    adds one of each.  #8 likewise once per SSD layer (twice under remat)
    and its backward once."""
    from repro_torch.models import layer_plan
    kinds = layer_plan(cfg).kinds
    n = (sum(k in ("attn", "xattn") for k in kinds)
         + 2 * sum(k == "dec_xattn" for k in kinds)
         + (cfg.encoder.n_layers if cfg.encoder is not None else 0))
    n_ssd = sum(k == "ssd" for k in kinds)
    twice = 2 if cfg.remat else 1
    fwd, bwd = n * twice, n
    if cfg.mtp:
        fwd, bwd = fwd + 1, bwd + 1
    return {"flash_attention_fwd": fwd, "flash_attention_dq": bwd,
            "flash_attention_dkv": bwd, "ssd_scan": n_ssd * twice,
            "ssd_scan_bwd": n_ssd}


def _counted(total: dict, label: str, per_step: dict, steps: int, fn):
    """Runs ``fn`` with the model kernels' counts (#5-#8 and #8's
    backward) at 0, requires exactly ``steps`` times ``per_step``
    launches of each, adds those launched to ``total``; returns ``fn``'s
    result."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS
    FA.reset_launches()
    SS.reset_launches()
    out = fn()
    got = {**FA.LAUNCHES, **SS.LAUNCHES}
    want = {k: per_step[k] * steps for k in got}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want} "
                             f"({per_step} a step, {steps} steps)")
    ran = [k for k in got if got[k]]
    for k in ran:
        total[k] = total.get(k, 0) + got[k]
    log(f"{label}: {' / '.join(ran)} launched "
        f"{' / '.join(str(got[k]) for k in ran)} times "
        f"({' / '.join(str(per_step[k]) for k in ran)} a step, as the "
        f"layer plan says)")
    return out


def _loss_rule(label, losses, vocab):
    """Finite losses, the first within 0.5 of ln V, the last below the
    first."""
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss in {losses}")
    if abs(losses[0] - np.log(vocab)) > 0.5:
        raise AssertionError(f"{label}: first loss {losses[0]:.4f} is not "
                             f"within 0.5 of ln {vocab} = "
                             f"{np.log(vocab):.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")


def _gates_to_one(params: dict) -> int:
    """Sets every cross layer's gate to 1.0 (zero, as initialised, shuts
    the memory out); returns how many."""
    gates = [t for name, t in params.items() if name.endswith(".gate")]
    with torch.no_grad():
        for t in gates:
            t.fill_(1.0)
    return len(gates)


def _hold_train_attention(dev, bw):
    """Phase 25 A: #6 and #7 in bf16 at the new training shapes against
    their plain versions, to phase 14's limits (dq within 1e-4 + 2^-7
    |dq| of the plain float32 dq in bf16 and equal to it in SAME_SHARE of
    the entries; dk and dv per q head within 2e-4 + 2e-5 |d|): seamless's
    cross layer with a ragged memory (Sq 1500, Skv 375: edge tiles on
    both axes), its encoder (384 x 384), one full-width llama-3.2-vision
    cross layer (64 / 8 heads of 128, Sq 1536, Skv 1600), all
    non-causal, and deepseek reduced's MLA (q/k 32, causal) with its
    value head of 16 zero-padded to 32 as ``ops.attention`` pads it;
    there the backward also runs through ``ops.attention`` (autograd
    through ``F.pad``) and must give the kernels' dq, dk and dv cut to 16
    to the bit.  Each kernel is timed by CUDA events and by device time
    beside its plain version, SDPA's backward (dq, dk, dv together, on
    the same inputs) and its bound (phase 14's rule)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref

    enc, vis = get_arch(ENC_ARCH), get_arch(VISION_ARCH)
    mla_cfg = get_arch("deepseek-v3-671b").reduced()
    mla = mla_cfg.mla
    b = ENC_TRAIN["batch"]
    frames = ENC_TRAIN["seq"] // enc.encoder.frame_ratio
    he, hke, de = enc.n_heads, enc.n_kv_heads, enc.resolved_head_dim
    dqk = mla.qk_nope + mla.qk_rope
    shapes = {  # label: (b, hq, hkv, sq, skv, d, causal)
        "seamless cross, ragged": (b, he, hke, 1500, 375, de, False),
        "seamless encoder": (b, he, hke, frames, frames, de, False),
        "llama-3.2-vision cross": (1, vis.n_heads, vis.n_kv_heads,
                                   ENC_TRAIN["seq"],
                                   vis.vision.n_image_tokens,
                                   vis.resolved_head_dim, False),
        "deepseek-v3 reduced MLA, v 16 padded": (
            b, mla_cfg.n_heads, mla_cfg.n_heads, SERVE["max_len_prompt"],
            SERVE["max_len_prompt"], dqk, True)}
    gen = torch.Generator(device=dev).manual_seed(25)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, (b_, hq, hkv, sq, skv, d, causal) in shapes.items():
        q, do = (torch.randn((b_, hq, sq, d), generator=gen,
                             device=dev).bfloat16() for _ in range(2))
        k, v = (torch.randn((b_, hkv, skv, d), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        narrow = label.startswith("deepseek")
        if narrow:
            # the zero-padded value head, and the cotangent of the padded
            # columns, which the cut after the kernel makes zero
            v[..., mla.v_head:] = 0
            do[..., mla.v_head:] = 0
        kw = dict(causal=causal, window=None, q_offset=0)
        o, lse = FA.flash_attention(q, k, v, causal=causal)
        dsum = (do.float() * o.float()).sum(-1, keepdim=True)
        args = (q, k, v, do, lse, dsum)
        dq = FA.flash_attention_dq(*args, **kw)
        dkh, dvh = FA.flash_attention_dkv(*args, **kw)
        torch.cuda.synchronize()
        w_dq32 = ref.flash_attention_dq_ref(
            *(t.float() for t in (q, k, v, do)), lse, dsum, **kw)
        w_dk, w_dv = ref.flash_attention_dkv_ref(*args, **kw)
        name = (f"flash_attention bwd {label} B={b_} Hq={hq} Hkv={hkv} "
                f"Sq={sq} Skv={skv} D={d} bf16 "
                f"{'causal' if causal else 'non-causal'}")
        e_dq, rel = _close_or_raise(name + " dq", dq, w_dq32.to(q.dtype),
                                    1e-4, 2.0 ** -7)
        e_kv = max(_close_or_raise(name + " dk", dkh, w_dk, 2e-4, 2e-5)[0],
                   _close_or_raise(name + " dv", dvh, w_dv, 2e-4, 2e-5)[0])
        share = _check_same_share(name + " dq", dq, w_dq32)
        log(f"{name}: ok (dq max abs err {e_dq:.3e}, max rel err "
            f"{rel:.3e}, {share:.5f} of dq equal to the plain dq in bf16; "
            f"dk, dv max abs err {e_kv:.3e})")
        if narrow:
            qg, kg = (t.detach().requires_grad_() for t in (q, k))
            vg = v[..., :mla.v_head].detach().requires_grad_()
            out = ops.attention(qg, kg, vg, causal=True, scale=dqk ** -0.5)
            gq, gk, gv = torch.autograd.grad(
                out, (qg, kg, vg), do[..., :mla.v_head].contiguous())
            dk = dkh.to(k.dtype)            # Hq = Hkv: one q head a group
            dv = dvh[..., :mla.v_head].to(v.dtype)
            if not (torch.equal(gq, dq) and torch.equal(gk, dk)
                    and torch.equal(gv, dv)):
                raise AssertionError(f"{name}: ops.attention's backward "
                                     f"through the padded v differs from "
                                     f"the kernels'")
            log(f"{name}: ops.attention's backward (v {mla.v_head} padded "
                f"to {dqk}, autograd through F.pad) gives the kernels' dq, "
                f"dk and dv cut to {mla.v_head}, bit for bit")
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        mm = 2.0 * d * hq * b_ * pairs
        in_bytes = 2 * (2 * b_ * hq * sq * d + 2 * b_ * hkv * skv * d) \
            + 8 * b_ * hq * sq
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        o_sdpa = sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True)
        lib = lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), do,
                                          retain_graph=True)
        reps = 10
        lib_ms = cuda_ms(lib, reps)
        lib_dev = device_rows(lib, reps)[2] / reps
        pair = 0.0
        for kname, fn, plain, split, out_bytes in (
                ("flash_attention_dq", FA.flash_attention_dq,
                 ref.flash_attention_dq_ref, 1, 2 * b_ * hq * sq * d),
                ("flash_attention_dkv", FA.flash_attention_dkv,
                 ref.flash_attention_dkv_ref, 2,
                 2 * 4 * b_ * hq * skv * d)):
            call = lambda fn=fn: fn(*args, **kw)
            r = dict(ms=cuda_ms(call, reps),
                     device_ms=device_rows(call, reps)[2] / reps,
                     plain_ms=cuda_ms(lambda p=plain: p(*args, **kw), 3),
                     library_ms=lib_ms, library_device_ms=lib_dev,
                     **_bound(in_bytes + out_bytes, bw=bw,
                              bf16_flops=2 * mm, f32_bf16_flops=split * mm))
            pair += r["device_ms"]
            log(f"{kname} [{label}]: {r['ms']:.4f} ms by CUDA events, "
                f"{r['device_ms']:.4f} ms of device time, plain "
                f"{r['plain_ms']:.4f} ms; SDPA backward "
                f"(dq, dk, dv together) {lib_ms:.4f} / {lib_dev:.4f} ms; "
                f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
                f"({r['tc_flops'] / 1e9:.3f} GFLOP on the tensor cores = "
                f"{r['ops_ms']:.4f} ms; "
                f"{(in_bytes + out_bytes) / 1e6:.2f} MB = "
                f"{r['bytes_ms']:.4f} ms); "
                f"{r['tc_flops'] / r['device_ms'] / 1e9:.1f} TFLOP/s of "
                f"tensor-core work achieved")
        log(f"flash-attention backward [{label}], #6 and #7 together: "
            f"{pair:.4f} ms of device time against SDPA backward's "
            f"{lib_dev:.4f} ms ({pair / lib_dev:.2f}x)")
        del o_sdpa, lib


def _step_profile(label, trainer, state, tokens: int, flops: float):
    """Prints one more train step of ``trainer`` on ``state`` under the
    profiler: the device's busy time and idle share, the leading device
    operations, and model FLOP/s by wall and by device time."""
    batch = trainer._device_batch(trainer.tcfg.total_steps)
    rows, wall_ms, busy_ms = profile_device(
        lambda: trainer.step_fn(state, batch), 1, "step", label)
    if busy_ms > 0:
        log(f"{label}: {tokens} tokens, model {flops / 1e12:.2f} TFLOP "
            f"(6 N_active D) a step: {flops / wall_ms / 1e9:.1f} TFLOP/s by "
            f"the profiled step's wall, {flops / busy_ms / 1e9:.1f} TFLOP/s "
            f"by its device time; idle share {1.0 - busy_ms / wall_ms:.3f}; "
            f"{sum(count for _, count, _ in rows)} device operations "
            f"(kernels and copies)")


def _report_run(label, trainer, seconds, tokens, flops, peak):
    """Prints a trainer run's losses, step times, tokens/s, model FLOP/s
    and peak memory, which must stay under PEAK_LIMIT."""
    hist = trainer.history
    warm = sorted(h.seconds for h in hist[1:])
    warm_ms = warm[len(warm) // 2] * 1e3
    log(f"{label}: {len(hist)} steps of {tokens} tokens in {seconds:.2f} s "
        f"(the first step's set-up included); losses "
        f"{[round(h.loss, 4) for h in hist]}; step ms "
        f"{[round(h.seconds * 1e3, 1) for h in hist]}; warm step (median "
        f"of steps 1-{len(hist) - 1}) {warm_ms:.1f} ms, "
        f"{tokens / warm_ms * 1e3:.0f} tokens/s, model "
        f"{flops / warm_ms / 1e9:.1f} TFLOP/s (6 N_active D = "
        f"{flops / 1e12:.2f} TFLOP a step); peak memory "
        f"{peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB), limit "
        f"{PEAK_LIMIT / 1e9:.0f} GB")
    if not peak < PEAK_LIMIT:
        raise AssertionError(f"{label}: peak memory {peak / 1e9:.2f} GB")


def _two_layer_step(dev, total: dict, cfg, label: str, seed: int,
                    n_layers: int = 2):
    """``cfg`` cut to ``n_layers`` layers, one step on B=1, S=256
    tokens drawn from ``seed``: a donated step against a non-donated one
    on the card, bit for bit, and the card against the CPU (loss within
    5e-3, grad norm within 1e-2 relative)."""
    from repro_torch.train import (TrainStepConfig, init_train_state,
                                   make_train_step)

    cfg2 = cfg.replace(n_layers=n_layers)
    ts = TrainStepConfig()
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (1, 256))
    batch = {"tokens": tok.astype(np.int32)}
    kept = init_train_state(cfg2, 0, ts, dev)
    given = init_train_state(cfg2, 0, ts, dev)
    cpu_state = _tree_to(kept, "cpu")
    old = {k: t for k, t in given["params"].items()}

    def two_steps():
        return (make_train_step(cfg2, dev, ts, donate=False)(kept, batch),
                make_train_step(cfg2, dev, ts)(given, batch))

    (new_k, m_k), (new_g, m_g) = _counted(
        total, f"{label} ({n_layers} layers) donated and kept steps",
        _train_launches(cfg2), 2, two_steps)
    leaves = 0
    for part in ("params", "m", "v"):
        a = new_k[part] if part == "params" else new_k["opt"][part]
        g = new_g[part] if part == "params" else new_g["opt"][part]
        for key in a:
            leaves += 1
            if not torch.equal(a[key], g[key]):
                raise AssertionError(f"donated step: {part} {key} differs "
                                     f"from the non-donated step's")
    same_metrics = all(torch.equal(m_k[key], m_g[key]) for key in m_k)
    if not (same_metrics and all(new_g["params"][k] is old[k] for k in old)
            and int(new_g["step"]) == int(new_k["step"]) == 1):
        raise AssertionError("donated step: metrics, step or storage differ")
    log(f"{label} ({n_layers} layers, B=1, S=256) donated step against a "
        f"non-donated one on the card: {leaves} params / m / v leaves and "
        f"every metric equal bit for bit; the donated state is the old "
        f"tensors")
    _, m_cpu = make_train_step(cfg2, "cpu", ts)(cpu_state, batch)
    lg, lc = float(m_k["loss"]), float(m_cpu["loss"])
    ng, nc = float(m_k["grad_norm"]), float(m_cpu["grad_norm"])
    if not (abs(lg - lc) <= 5e-3 and abs(ng - nc) <= 1e-2 * nc):
        raise AssertionError(f"card vs CPU step: loss {lg} vs {lc}, grad "
                             f"norm {ng} vs {nc}")
    log(f"{label} ({n_layers} layers, B=1, S=256) one step, card vs CPU: loss "
        f"{lg:.6f} vs {lc:.6f} (limit 5e-3), grad norm {ng:.6f} vs "
        f"{nc:.6f} (rel {abs(ng - nc) / nc:.2e}, limit 1e-2)")
    del kept, given, new_k, new_g, cpu_state
    torch.cuda.empty_cache()


def _train_moe_full(dev, total: dict):
    """Phase 25 B: granite-moe-3b-a800m at full width through the
    launcher's ``train`` (a donating step, AdamW with the cosine
    schedule, B=2, S=2048, 6 steps, no checkpoint), the exact launches,
    the loss rule, peak memory under 80 GB, a profiled step; then at
    ``n_layers=2`` a step on the card against the CPU (B=1, S=256) and a
    donated step against a non-donated one, bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    from repro_torch.models import build, count_params

    cfg = get_arch(MOE_ARCH)
    bundle = build(cfg)
    tokens = MOE_TRAIN["batch"] * MOE_TRAIN["seq"]
    flops = bundle.flops(tokens)
    log(f"{MOE_ARCH}: {bundle.num_active_params():,} active of "
        f"{count_params(cfg):,} parameters (count_params)")
    shutil.rmtree(TRAIN25_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, state = _counted(
        total, f"{MOE_ARCH} train", _train_launches(cfg),
        MOE_TRAIN["steps"], lambda: train(
            MOE_ARCH, steps=MOE_TRAIN["steps"],
            seq=MOE_TRAIN["seq"], batch=MOE_TRAIN["batch"],
            lr=MOE_TRAIN["lr"], ckpt_dir=str(TRAIN25_DIR / "granite"),
            ckpt_every=MOE_TRAIN["steps"] + 1, log_every=1, device=dev))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _loss_rule(MOE_ARCH, [h.loss for h in trainer.history], cfg.vocab)
    _report_run(f"{MOE_ARCH} train", trainer, seconds, tokens, flops, peak)
    _counted(total, f"{MOE_ARCH} profiled step", _train_launches(cfg), 1,
             lambda: _step_profile(f"profile {MOE_ARCH} train step",
                                   trainer, state, tokens, flops))
    del trainer, state
    torch.cuda.empty_cache()

    _two_layer_step(dev, total, cfg, MOE_ARCH, seed=25)


def _train_memory_full(dev, total: dict):
    """Phase 25 C: seamless-m4t-large-v2 at full width through the
    ``Trainer`` with the pipeline's frame embeddings (B=2, S=1536, 384
    frames a sequence, bf16), every cross gate at 1.0, 6 donated steps:
    the exact launches, the loss rule, peak memory, a profiled step, and
    a second memory draw moving the first step's loss."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import build, loss_fn
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.train import (TrainStepConfig, Trainer, TrainerConfig,
                                   train_state_from_model)

    cfg = get_arch(ENC_ARCH)
    bundle = build(cfg)
    steps, seq, b = ENC_TRAIN["steps"], ENC_TRAIN["seq"], ENC_TRAIN["batch"]
    frames = seq // cfg.encoder.frame_ratio
    tokens = b * seq
    flops = bundle.flops(tokens)
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=b,
                      memory_tokens=frames, d_model=cfg.d_model)
    ts = TrainStepConfig(optimizer=AdamWConfig(lr=cosine_schedule(
        ENC_TRAIN["lr"], warmup=min(20, steps // 10 + 1), total=steps)))
    trainer = Trainer(cfg, data, TrainerConfig(
        total_steps=steps, checkpoint_every=steps + 1,
        checkpoint_dir=str(TRAIN25_DIR / "seamless"), log_every=1), ts,
        device=dev)
    torch.cuda.reset_peak_memory_stats()
    model = bundle.init(0, dev)
    batch = trainer._device_batch(0)
    n_gates = _gates_to_one(dict(model.named_parameters()))
    state = train_state_from_model(cfg, model, ts)
    other = synthetic_batch(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=b, seed=1,
        memory_tokens=frames, d_model=cfg.d_model), 0)["memory"]
    with torch.no_grad():
        first = float(loss_fn(cfg, model, batch)[0])
        moved = float(loss_fn(cfg, model, {
            "tokens": batch["tokens"], "memory": torch.as_tensor(
                other, device=dev).bfloat16()})[0])
    log(f"{ENC_ARCH}: {n_gates} cross gates at 1.0; a second memory draw "
        f"moves the first step's loss from {first:.6f} to {moved:.6f} "
        f"({abs(moved - first):.2e}; must exceed 1e-3)")
    if not abs(moved - first) > 1e-3:
        raise AssertionError(f"{ENC_ARCH}: the memory does not reach the "
                             f"loss")
    del model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = _counted(total, f"{ENC_ARCH} train", _train_launches(cfg),
                     steps, lambda: trainer.run(state=state))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [h.loss for h in trainer.history]
    if abs(losses[0] - first) > 1e-3:
        raise AssertionError(f"{ENC_ARCH}: the trainer's first loss "
                             f"{losses[0]} is not the memory's {first}")
    _loss_rule(ENC_ARCH, losses, cfg.vocab)
    _report_run(f"{ENC_ARCH} train", trainer, seconds, tokens, flops, peak)
    _counted(total, f"{ENC_ARCH} profiled step", _train_launches(cfg), 1,
             lambda: _step_profile(f"profile {ENC_ARCH} train step",
                                   trainer, state, tokens, flops))
    del trainer, state
    torch.cuda.empty_cache()


def _train_reduced(dev, total: dict):
    """Phase 25 D: deepseek-v3-671b reduced (MLA, a shared expert, MTP;
    bf16 weights and moments) through ``make_train_step``,
    recurrentgemma-9b reduced (window 64) through the launcher, and
    llama-3.2-vision-90b reduced at 10 layers with 16 image tokens and
    its gates at 1.0 through the ``Trainer`` as the launcher builds it
    (the launcher's own reduced config keeps 4 layers, none of them a
    cross layer): 4 steps each, exact launches, the loss rule; then
    granite reduced crashed at step 6 and resumed from its step-4
    checkpoint, its last loss against an uncrashed run's at rtol 1e-4."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.train import train
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.train import (TrainStepConfig, Trainer, TrainerConfig,
                                   init_train_state, make_train_step)

    steps, seq, b = (SMALL_TRAIN["steps"], SMALL_TRAIN["seq"],
                     SMALL_TRAIN["batch"])
    ts = TrainStepConfig(optimizer=AdamWConfig(lr=cosine_schedule(
        SMALL_TRAIN["lr"], warmup=min(20, steps // 10 + 1), total=steps)))

    cfg = get_arch("deepseek-v3-671b").reduced()
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=b)
    state = init_train_state(cfg, 0, ts, dev)
    if not all(t.dtype == torch.bfloat16 for part in ("m", "v")
               for t in state["opt"][part].values()):
        raise AssertionError("deepseek: the moments must be bf16")
    step_fn = make_train_step(cfg, dev, ts)

    def deepseek_steps():
        out = []
        for step in range(steps):
            _, m = step_fn(state, synthetic_batch(data, step))
            out.append({k: float(v) for k, v in m.items()})
        return out

    metrics = _counted(total, "deepseek-v3-671b reduced train",
                       _train_launches(cfg), steps, deepseek_steps)
    # the loss rule on ce; the whole loss (ce + aux + 0.3 mtp) must fall
    # too, and the MTP term start finite within 0.5 of ln V
    _loss_rule("deepseek-v3-671b reduced ce", [m["ce"] for m in metrics],
               cfg.vocab)
    loss, mtp = [m["loss"] for m in metrics], [m["mtp"] for m in metrics]
    if not (np.all(np.isfinite(loss + mtp)) and loss[-1] < loss[0]
            and abs(mtp[0] - np.log(cfg.vocab)) <= 0.5):
        raise AssertionError(f"deepseek-v3-671b reduced: loss {loss}, mtp "
                             f"{mtp}")
    log(f"deepseek-v3-671b reduced (MLA, MoE, MTP; bf16 weights and "
        f"moments): {steps} steps of {b} x {seq}; loss "
        f"{[round(m['loss'], 4) for m in metrics]}, ce "
        f"{[round(m['ce'], 4) for m in metrics]}, mtp "
        f"{[round(m['mtp'], 4) for m in metrics]}, aux "
        f"{[round(m['aux'], 6) for m in metrics]}")
    del state, step_fn

    cfg = get_arch("recurrentgemma-9b").reduced()
    trainer, _ = _counted(
        total, "recurrentgemma-9b reduced train", _train_launches(cfg),
        steps, lambda: train("recurrentgemma-9b", reduced=True,
                             steps=steps, seq=seq, batch=b,
                             lr=SMALL_TRAIN["lr"],
                             ckpt_dir=str(TRAIN25_DIR / "rgemma"),
                             ckpt_every=steps + 1, log_every=1,
                             device=dev))
    losses = [h.loss for h in trainer.history]
    _loss_rule("recurrentgemma-9b reduced", losses, cfg.vocab)
    log(f"recurrentgemma-9b reduced (window {cfg.window}, S {seq}): losses "
        f"{[round(x, 4) for x in losses]}")

    cfg = get_arch(VISION_ARCH).reduced().replace(n_layers=VISION_LAYERS)
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=b,
                      memory_tokens=cfg.vision.n_image_tokens,
                      d_model=cfg.d_model)
    trainer = Trainer(cfg, data, TrainerConfig(
        total_steps=steps, checkpoint_every=steps + 1,
        checkpoint_dir=str(TRAIN25_DIR / "vision"), log_every=1), ts,
        device=dev)
    state = trainer.fresh_state(0)
    n_gates = _gates_to_one(state["params"])
    if trainer._device_batch(0)["memory"].dtype != torch.bfloat16:
        raise AssertionError("the trainer's memory must be bf16")
    _counted(total, f"{VISION_ARCH} reduced ({VISION_LAYERS} layers) train",
             _train_launches(cfg), steps, lambda: trainer.run(state=state))
    losses = [h.loss for h in trainer.history]
    _loss_rule(f"{VISION_ARCH} reduced", losses, cfg.vocab)
    log(f"{VISION_ARCH} reduced ({VISION_LAYERS} layers, {n_gates} cross "
        f"gates at 1.0, {cfg.vision.n_image_tokens} image tokens of bf16 "
        f"memory a sequence): losses {[round(x, 4) for x in losses]}")
    del state, trainer

    # crash at step 6, resume from the step-4 checkpoint, replay
    cfg = get_arch(MOE_ARCH).reduced()
    crashed = []

    def fault(step):
        if step == SMALL_TRAIN["crash_at"] and not crashed:
            crashed.append(step)
            return "crash"
        return None

    kw = dict(reduced=True, steps=SMALL_TRAIN["crash_steps"], seq=seq,
              batch=b, lr=SMALL_TRAIN["lr"],
              ckpt_every=SMALL_TRAIN["ckpt_every"],
              log_every=100, device=dev)
    n_steps = SMALL_TRAIN["crash_steps"]
    plain, _ = _counted(total, f"{MOE_ARCH} reduced uncrashed",
                        _train_launches(cfg), n_steps,
                        lambda: train(MOE_ARCH,
                                      ckpt_dir=str(TRAIN25_DIR / "a"), **kw))
    replayed = n_steps + SMALL_TRAIN["crash_at"] - SMALL_TRAIN["ckpt_every"]
    tr2, state2 = _counted(total, f"{MOE_ARCH} reduced crashed",
                           _train_launches(cfg), replayed,
                           lambda: train(MOE_ARCH, fault_hook=fault,
                                         ckpt_dir=str(TRAIN25_DIR / "b"),
                                         **kw))
    last, want = tr2.history[-1].loss, plain.history[-1].loss
    if (tr2.restarts != 1 or int(state2["step"]) != n_steps
            or not np.isclose(last, want, rtol=1e-4, atol=0.0)):
        raise AssertionError(f"crash run: restarts {tr2.restarts}, last "
                             f"loss {last} vs uncrashed {want}")
    _loss_rule(f"{MOE_ARCH} reduced", [h.loss for h in plain.history],
               cfg.vocab)
    log(f"{MOE_ARCH} reduced crash at step {SMALL_TRAIN['crash_at']} and "
        f"resume: steps {[h.step for h in tr2.history]}; last loss "
        f"{last:.6f} vs uncrashed {want:.6f} (rel "
        f"{abs(last - want) / abs(want):.2e}, limit 1e-4)")
    shutil.rmtree(TRAIN25_DIR, ignore_errors=True)


def check_train_archs(dev, bw):
    """Phase 25: #6 and #7 at the new training shapes (A), then training
    of granite-moe-3b-a800m (B) and seamless-m4t-large-v2 (C) at full
    width, and of deepseek-v3, recurrentgemma and llama-3.2-vision at
    ``reduced()`` plus granite's crash and resume (D).  #5-#7's launches
    in B-D go under their ``phase_launches``."""
    _hold_train_attention(dev, bw)
    total = {}
    _train_moe_full(dev, total)
    _train_memory_full(dev, total)
    _train_reduced(dev, total)
    log(f"phase 25: #5 / #6 / #7 launched {total['flash_attention_fwd']} / "
        f"{total['flash_attention_dq']} / {total['flash_attention_dkv']} "
        f"times in training")
    return total


# ---------------------------------------------------------------------------
# Training through the SSD: phase 26
# ---------------------------------------------------------------------------

SSD_ARCH = "mamba2-130m"
TRAIN26_DIR = ROOT / "build" / "train_smoke26"
# the backward kernels against their plain version: every gradient within
# this share of its leaf's largest magnitude; d a_log and ddt (at this
# phase's serve decay) within SSD_BWD_CANCEL in both dtypes, which a lost
# cancellation of M's row and column sums (some 2e-4) fails
SSD_BWD_TOL = {torch.float32: 3e-4, torch.bfloat16: 2.0 ** -7}
SSD_BWD_CANCEL = 1e-5
# the bf16 route against the plain version with its split products
# emulated (ssd_scan_bwd_ref(terms=3)): every leaf within this share of its
# largest magnitude, which one bf16 cast of each float32 operand
# (terms=1, some 1e-3) fails
SSD_BWD_SPLIT = 1e-5
SSD_BWD_NAMES = ("dx", "ddt", "da_log", "db", "dc", "dd_skip", "dstate")
# (B, L, H, P, N, chunk): phase 10's shapes and B 8 at mamba2-130m's
# widths; its reduced widths, which the bf16 route pads to N 64, P 64
SSD_BWD_SHAPES = ((1, 1000, 24, 64, 128, 256), (1, 2048, 24, 64, 128, 256),
                  (1, 300, 24, 64, 128, 256), (8, 2048, 24, 64, 128, 256),
                  (2, 1000, 16, 16, 16, 32))


def _ssd_bwd_bound(bsz, length, bw, h=24, p=64, g=1, n=128, chunk=256):
    """:func:`_bound` of the SSD backward with bf16 x, B, C and dy, no
    initial state and no final-state gradient (the training path):
    inputs read once, float32 gradients written once; C B^T and dy x^T
    (two bf16 operands) once over each chunk's lower triangle, and the
    products with a float32 operand: (C B^T L)^T dy, (G L dt) B, (G L)^T
    C over the triangle, B dS, dy S_in^T, x dS^T, C^T (exp(cum) dy) and
    B^T (x dt w) over each chunk."""
    bf16_flops = f32_flops = 0.0
    for c0 in range(0, length, chunk):
        qc = min(chunk, length - c0)
        tri = qc * (qc + 1) / 2
        bf16_flops += 2 * tri * (n * g + p * h)
        f32_flops += 2 * tri * (p + 2 * n) * h + 5 * 2 * qc * n * p * h
    tokens = bsz * length
    nbytes = (2 * (2 * tokens * h * p + 2 * tokens * g * n) + 4 * tokens * h
              + 8 * h + 4 * (tokens * h * p + tokens * h + 2 * tokens * g * n
                             + 2 * h))
    return _bound(nbytes, bw=bw, bf16_flops=bsz * bf16_flops,
                  f32_bf16_flops=bsz * f32_flops)


def _kernel_short(key: str) -> str:
    """A profiler kernel name without its namespace and arguments: the
    port's kernels with their template arguments, PyTorch's by the
    kernel template's name (``reduce_kernel``)."""
    m = re.search(r"(?:^|::)(\w+(?:<[\w ,]+>)?)\(", key)
    if m and m[1] != "operator":
        return m[1]
    m = re.search(r"(?:^|\s)(?:\w+::)*(\w+)<", key)
    return m[1] if m else key[:40]


def _hold_ssd_bwd(dev, bw):
    """Phase 26 A: the backward kernels (bf16: tensor cores; float32: CUDA
    cores) against their plain version, then their time at the training
    shape.  Returns ``(max abs err, row)``."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels.ref import ssd_scan_bwd_ref

    gen = torch.Generator(device=dev).manual_seed(26)
    err = 0.0
    for bsz, length, h, p, n, chunk in SSD_BWD_SHAPES:
        x, dt, a_log, b, c, ds = _ssd_inputs(gen, dev, length, h=h, p=p, n=n,
                                             batch=bsz)
        dy = torch.randn(x.shape, generator=gen, device=dev)
        s0, dfinal = (torch.randn((bsz, h, n, p), generator=gen, device=dev)
                      for _ in range(2))
        for dtype in (torch.float32, torch.bfloat16):
            args = (x.to(dtype), dt, a_log, b.to(dtype), c.to(dtype), ds,
                    dy.to(dtype))
            tol = SSD_BWD_TOL[dtype]
            for given in (True, False):
                kw = dict(chunk=chunk, state=s0 if given else None,
                          dfinal=dfinal if given else None)
                got = SS.ssd_scan_bwd(*args, **kw)
                again = SS.ssd_scan_bwd(*args, **kw)
                torch.cuda.synchronize()
                want = ssd_scan_bwd_ref(*args, **kw)
                name = (f"ssd_scan_bwd B={bsz} L={length} H={h} P={p} N={n} "
                        f"chunk={chunk} {str(dtype)[6:]}")
                worst = []
                for leaf, gv, av, wv in zip(SSD_BWD_NAMES, got, again, want):
                    if wv is None:
                        continue
                    scale = float(wv.abs().max())
                    e = float((gv - wv).abs().max())
                    limit = (SSD_BWD_CANCEL if leaf in ("ddt", "da_log")
                             else tol)
                    if not (torch.isfinite(gv).all() and e <= limit * scale):
                        raise AssertionError(f"{name} {leaf}: max abs err {e}"
                                             f" against {limit} x {scale}")
                    if not torch.equal(gv, av):
                        raise AssertionError(f"{name} {leaf}: a repeat "
                                             f"differs")
                    worst.append(f"{leaf} {e / scale:.2e}")
                    err = max(err, e)
                log(f"{name}, state and dfinal "
                    f"{'given' if given else 'zero'}: ok, a repeat bit for "
                    f"bit; max abs err over each leaf's largest magnitude: "
                    f"{', '.join(worst)} (limits {tol:.3g}; ddt, da_log "
                    f"{SSD_BWD_CANCEL:.0e})")
                if dtype != torch.bfloat16:
                    continue
                split = ssd_scan_bwd_ref(*args, terms=3, **kw)
                worst = []
                for leaf, gv, sv in zip(SSD_BWD_NAMES, got, split):
                    if sv is None:
                        continue
                    scale = float(sv.abs().max())
                    e = float((gv - sv).abs().max())
                    if e > SSD_BWD_SPLIT * scale:
                        raise AssertionError(f"{name} {leaf}: max abs err "
                                             f"{e} against terms=3, limit "
                                             f"{SSD_BWD_SPLIT} x {scale}")
                    worst.append(f"{leaf} {e / scale:.2e}")
                log(f"{name}, state and dfinal "
                    f"{'given' if given else 'zero'}: against "
                    f"ssd_scan_bwd_ref(terms=3): {', '.join(worst)} (limit "
                    f"{SSD_BWD_SPLIT:.0e})")
                del split
        del x, dt, b, c, dy, s0, dfinal, got, again, want

    for bsz in (1, 8):
        x, dt, a_log, b, c, ds = _ssd_inputs(gen, dev, 2048, batch=bsz)
        dy = torch.randn(x.shape, generator=gen, device=dev)
        args = (x.bfloat16(), dt, a_log, b.bfloat16(), c.bfloat16(), ds,
                dy.bfloat16())
        bwd = lambda: SS.ssd_scan_bwd(*args, chunk=256)
        rows, _, busy_ms, _ = device_rows(bwd, 10)
        row = dict(ms=cuda_ms(bwd, 10), device_ms=busy_ms / 10,
                   plain_ms=cuda_ms(lambda: ssd_scan_bwd_ref(*args,
                                                             chunk=256), 2),
                   library_ms=None, **_ssd_bwd_bound(bsz, 2048, bw))
        parts = ", ".join(f"{_kernel_short(key)} {ms / 10:.4f} ms"
                          for ms, _, key in rows)
        log(f"ssd_scan_bwd [B={bsz} L=2048 H=24 P=64 G=1 N=128 chunk 256, "
            f"bf16]: {row['ms']:.4f} ms by CUDA events, "
            f"{row['device_ms']:.4f} ms of device time ({parts}), plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']} ({row['tc_flops'] / 1e9:.3f} GFLOP at 989 "
            f"TFLOP/s = {row['ops_ms']:.4f} ms; {row['bytes_ms']:.4f} ms of "
            f"bytes); no PyTorch call computes it")
        row["launch_ms"] = {}
        for ms, _, key in rows:
            short = _kernel_short(key)
            row["launch_ms"][short] = (row["launch_ms"].get(short, 0.0)
                                       + ms / 10)
        if bsz == 8:
            f32 = [t.float() for t in args]
            fma = lambda: SS.ssd_scan_bwd(*f32, chunk=256)
            _, _, fma_ms, _ = device_rows(fma, 3)
            row["fma_device_ms"] = fma_ms / 3
            log(f"ssd_scan_bwd [B=8, float32 operands, CUDA cores]: "
                f"{row['fma_device_ms']:.4f} ms of device time")
            del f32
        del x, dt, b, c, dy, args
    return err, row


def _train_ssd_full(dev, total: dict):
    """Phase 26 B: mamba2-130m at full width through the launcher in
    phase 15's cell, then crashed and resumed.  Returns the backward's
    launches in the uncrashed run and its first loss."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    from repro_torch.models import build

    cfg = get_arch(SSD_ARCH)
    per = _train_launches(cfg)
    steps = TRAIN["steps"]
    tokens = TRAIN["seq"] * TRAIN["batch"]
    flops = build(cfg).flops(tokens)
    kw = dict(steps=steps, seq=TRAIN["seq"], batch=TRAIN["batch"],
              lr=TRAIN["lr"], ckpt_every=TRAIN["ckpt_every"], log_every=1,
              device=dev)
    shutil.rmtree(TRAIN26_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = total.get("ssd_scan_bwd", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, state = _counted(
        total, f"{SSD_ARCH} train", per, steps,
        lambda: train(SSD_ARCH, ckpt_dir=str(TRAIN26_DIR / "a"), **kw))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    main_launches = total["ssd_scan_bwd"] - before
    peak = torch.cuda.max_memory_allocated()
    losses = [h.loss for h in trainer.history]
    if trainer.cfg != cfg or len(losses) != steps:
        raise AssertionError(f"{SSD_ARCH}: trained {trainer.cfg.name} "
                             f"for {len(losses)} steps")
    _loss_rule(SSD_ARCH, losses, cfg.vocab)
    _report_run(f"{SSD_ARCH} train", trainer, seconds, tokens, flops, peak)
    _counted(total, f"{SSD_ARCH} profiled step", per, 1,
                 lambda: _step_profile(f"profile {SSD_ARCH} train step",
                                       trainer, state, tokens, flops))
    del trainer, state
    shutil.rmtree(TRAIN26_DIR / "a", ignore_errors=True)
    torch.cuda.empty_cache()

    crashed = []

    def fault(step):
        if step == TRAIN["crash_at"] and not crashed:
            crashed.append(step)
            return "crash"
        return None

    replayed = steps + TRAIN["crash_at"] - TRAIN["ckpt_every"]
    tr2, state2 = _counted(
        total, f"{SSD_ARCH} crashed", per, replayed,
        lambda: train(SSD_ARCH, ckpt_dir=str(TRAIN26_DIR / "b"),
                      fault_hook=fault, **kw))
    last = tr2.history[-1].loss
    if (tr2.restarts != 1 or int(state2["step"]) != steps
            or not np.isclose(last, losses[-1], rtol=1e-4, atol=0.0)):
        raise AssertionError(f"{SSD_ARCH} crash run: restarts "
                             f"{tr2.restarts}, step {int(state2['step'])}, "
                             f"last loss {last} vs uncrashed {losses[-1]}")
    log(f"{SSD_ARCH} crash at step {TRAIN['crash_at']} and resume from "
        f"step {TRAIN['ckpt_every']}: steps {[h.step for h in tr2.history]}"
        f"; last loss {last:.6f} vs uncrashed {losses[-1]:.6f} (rel "
        f"{abs(last - losses[-1]) / abs(losses[-1]):.2e}, limit 1e-4)")
    del tr2, state2
    shutil.rmtree(TRAIN26_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return main_launches, losses[0]


def check_train_ssd(dev, bw, out: dict):
    """Phase 26: the SSD backward kernel against its plain version and
    timed (A), mamba2-130m trained at full width and crashed and resumed
    (B), and its 2-layer step card vs CPU and donated vs kept (C).  Puts
    the backward's max abs err, timing row, main-path launches and the
    first loss of B into ``out``; returns the phase's launches of #8 and
    its backward."""
    out["err"], out["row"] = _hold_ssd_bwd(dev, bw)
    total = {}
    out["launches"], out["first_loss"] = _train_ssd_full(dev, total)
    from repro_torch.configs import get_arch
    _two_layer_step(dev, total, get_arch(SSD_ARCH), SSD_ARCH, seed=26)
    log(f"phase 26: #8 / its backward launched {total['ssd_scan']} / "
        f"{total['ssd_scan_bwd']} times in training")
    return total


# ---------------------------------------------------------------------------
# The REPRO_PERF flags: phase 27
# ---------------------------------------------------------------------------

PERF_DIR = ROOT / "build" / "train_smoke27"
# phase 27's training runs: smollm and mamba2 in phase 15's cell cut to 3
# steps; at microbatch 2 and 1, smollm in that cell and granite in phase
# 25's, 2 steps each
PERF_TRAIN = dict(steps=3, seq=2048, batch=8, lr=1e-3)
PERF_MB = 2
# granite-moe-3b-a800m's depth in phase 27 C's microbatch runs: 8 of its
# 32 layers (each a MoE layer, so the aux loss per microbatch shows at
# any depth); phase 25 trains it at full depth, and the cut pays for
# phase 34
PERF_MB_MOE_LAYERS = 8
# #5-#7 under prob_bf16 against their plain versions: every output within
# this share of its leaf's largest magnitude (one bf16 rounding)
PB_TOL = 2.0 ** -7
# lse under the flag against the default variant's, at D = 64 (q scale
# exact in bf16: the cast of p does not touch lse)
PB_LSE = 1e-5
# microbatch 2 against microbatch 1: smollm's losses, granite's first
# cross-entropy (the reference's own rule for the loss of a model with no
# aux loss, tests/test_perf_flags.py)
MB_RTOL = 2e-4
# mamba2's first loss at ssd_chunk 128 against phase 26's at chunk 256
CHUNK_RTOL = 1e-3


@contextlib.contextmanager
def perf_flags(**kw):
    """``kw`` set through ``repro_torch.perf.set_flags`` for the block,
    then as they were (whatever the block raises is raised)."""
    from repro_torch import perf
    old = {k: getattr(perf.flags(), k) for k in kw}
    perf.set_flags(**kw)
    try:
        yield
    finally:
        perf.set_flags(**old)


def _share_of_max(name, got, want, tol):
    """max |got - want| / max |want|, which must stay within ``tol``;
    got finite."""
    scale = float(want.float().abs().max())
    e = float((got.float() - want.float()).abs().max())
    if not (bool(torch.isfinite(got).all()) and e <= tol * scale):
        raise AssertionError(f"{name}: max abs err {e} against {tol} x "
                             f"{scale}")
    return e / scale


def _hold_prob_bf16(dev, bw):
    """Phase 27 A: #5, #6 and #7 under ``prob_bf16`` (the variants of #5
    and #7; #6 on the variant's o and lse) against their plain versions
    at phase 9 / 14's smollm shapes (B 1 and 8), a windowed case and
    phase 25's seamless cross shape (non-causal, ragged): o, dq, dk and
    dv within PB_TOL of each leaf's largest magnitude, lse within PB_LSE
    of the default variant's, a repeat bit for bit.  Then the variants'
    times by CUDA events and device time beside the default variants'
    in this call, their bounds and SDPA's forward and backward, which
    round p to one bf16 too.  Returns ``(fwd row, dkv row)``."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    enc = get_arch(ENC_ARCH)
    shapes = {  # label: (b, hq, hkv, sq, skv, d, causal, window)
        "smollm B=1": (1, 9, 3, 2048, 2048, 64, True, None),
        "smollm B=8": (8, 9, 3, 2048, 2048, 64, True, None),
        "smollm windowed": (1, 9, 3, 777, 777, 64, True, 128),
        "seamless cross, ragged": (ENC_TRAIN["batch"], enc.n_heads,
                                   enc.n_kv_heads, 1500, 375,
                                   enc.resolved_head_dim, False, None)}
    gen = torch.Generator(device=dev).manual_seed(27)
    tensors = {}
    for label, (b, hq, hkv, sq, skv, d, causal, window) in shapes.items():
        q, do = (torch.randn((b, hq, sq, d), generator=gen,
                             device=dev).bfloat16() for _ in range(2))
        k, v = (torch.randn((b, hkv, skv, d), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=0)
        o, lse = FA.flash_attention(q, k, v, prob_bf16=True, **kw)
        o2, lse2 = FA.flash_attention(q, k, v, prob_bf16=True, **kw)
        _, lse0 = FA.flash_attention(q, k, v, **kw)
        dsum = (do.float() * o.float()).sum(-1, keepdim=True)
        args = (q, k, v, do, lse, dsum)
        dq = FA.flash_attention_dq(*args, **kw)
        dkh, dvh = FA.flash_attention_dkv(*args, prob_bf16=True, **kw)
        dkh2, dvh2 = FA.flash_attention_dkv(*args, prob_bf16=True, **kw)
        torch.cuda.synchronize()
        name = (f"prob_bf16 {label} B={b} Hq={hq} Hkv={hkv} Sq={sq} "
                f"Skv={skv} D={d} {'causal' if causal else 'non-causal'}"
                f"{f' window {window}' if window else ''}")
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)
                and torch.equal(dkh, dkh2) and torch.equal(dvh, dvh2)):
            raise AssertionError(f"{name}: a repeat differs")
        e_lse = float((lse - lse0).abs().max())
        if d == 64 and e_lse > PB_LSE:
            raise AssertionError(f"{name}: lse {e_lse} from the default "
                                 f"variant's (limit {PB_LSE} at D = 64)")
        w_o, _ = ref.flash_attention_ref(q, k, v, prob_bf16=True, **kw)
        w_dq = ref.flash_attention_dq_ref(*args, **kw)
        w_dk, w_dv = ref.flash_attention_dkv_ref(*args, prob_bf16=True,
                                                 **kw)
        rel = {leaf: _share_of_max(f"{name} {leaf}", got, want, PB_TOL)
               for leaf, got, want in (("o", o, w_o), ("dq", dq, w_dq),
                                       ("dk", dkh, w_dk), ("dv", dvh, w_dv))}
        log(f"{name}: ok, a repeat bit for bit; max abs err over the "
            f"leaf's largest magnitude "
            f"{', '.join(f'{k} {v:.2e}' for k, v in rel.items())} (limit "
            f"{PB_TOL:.3e}); lse {e_lse:.2e} from the default variant's "
            f"(limit {PB_LSE:.0e})")
        if label.startswith("smollm B="):
            tensors[label] = (q, k, v, do, lse, dsum)
        del o, o2, w_o, w_dq, w_dk, w_dv, dq, dkh, dvh, dkh2, dvh2

    sdpa = torch.nn.functional.scaled_dot_product_attention
    reps = 20
    hq, hkv, s, d = 9, 3, 2048, 64
    pairs = s * (s + 1) // 2
    rows = {}
    for b in (1, 8):
        q, k, v, do, lse, dsum = tensors[f"smollm B={b}"]
        mm = 2.0 * d * hq * b * pairs      # one product over the live pairs
        nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d) \
            + 4 * b * hq * s
        fwd = lambda pb: lambda: FA.flash_attention(q, k, v, prob_bf16=pb)
        lib = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        row = dict(ms=cuda_ms(fwd(True), reps),
                   device_ms=device_rows(fwd(True), reps)[2] / reps,
                   default_device_ms=device_rows(fwd(False), reps)[2] / reps,
                   plain_ms=cuda_ms(lambda: ref.flash_attention_ref(
                       q, k, v, prob_bf16=True), 3),
                   library_ms=cuda_ms(lib, reps),
                   library_device_ms=device_rows(lib, reps)[2] / reps,
                   # Q K^T and P.V: two bf16 operands each
                   **_bound(nbytes, bf16_flops=2 * mm, bw=bw))
        rows[f"fwd B={b}"] = row
        log(f"flash_attention_fwd prob_bf16 [B={b} Hq=9 Hkv=3 S=2048 D=64 "
            f"bf16 causal]: {row['ms']:.4f} ms by CUDA events, "
            f"{row['device_ms']:.4f} ms of device time (the default variant "
            f"{row['default_device_ms']:.4f} ms in this call), plain "
            f"{row['plain_ms']:.4f} ms, SDPA forward {row['library_ms']:.4f}"
            f" / {row['library_device_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
            f"({row['tc_flops'] / 1e9:.3f} GFLOP of bf16 x bf16 products at "
            f"989 TFLOP/s = {row['ops_ms']:.4f} ms; {nbytes / 1e6:.2f} MB = "
            f"{row['bytes_ms']:.4f} ms)")
    b = 8
    q, k, v, do, lse, dsum = tensors["smollm B=8"]
    args = (q, k, v, do, lse, dsum)
    mm = 2.0 * d * hq * b * pairs
    in_bytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d) + 8 * b * hq * s
    out_bytes = 2 * 4 * b * hq * s * d
    dkv = lambda pb: lambda: FA.flash_attention_dkv(*args, prob_bf16=pb)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    o_sdpa = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
    lib = lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), do,
                                      retain_graph=True)
    row = dict(ms=cuda_ms(dkv(True), reps),
               device_ms=device_rows(dkv(True), reps)[2] / reps,
               default_device_ms=device_rows(dkv(False), reps)[2] / reps,
               plain_ms=cuda_ms(lambda: ref.flash_attention_dkv_ref(
                   *args, prob_bf16=True), 3),
               library_ms=cuda_ms(lib, reps),
               library_device_ms=device_rows(lib, reps)[2] / reps,
               # S^T, dP^T and dv's p^T dO: two bf16 operands; dk's ds^T Q
               # one float32 operand, split in three
               **_bound(in_bytes + out_bytes, bf16_flops=3 * mm,
                        f32_bf16_flops=mm, bw=bw))
    log(f"flash_attention_dkv prob_bf16 [B=8 Hq=9 Hkv=3 S=2048 D=64 bf16 "
        f"causal]: {row['ms']:.4f} ms by CUDA events, "
        f"{row['device_ms']:.4f} ms of device time (the default variant "
        f"{row['default_device_ms']:.4f} ms in this call), plain "
        f"{row['plain_ms']:.4f} ms, SDPA backward (dq, dk, dv together, p "
        f"in bf16 too) {row['library_ms']:.4f} / "
        f"{row['library_device_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"by {row['bound_by']} ({row['tc_flops'] / 1e9:.3f} GFLOP on the "
        f"tensor cores = {row['ops_ms']:.4f} ms; "
        f"{(in_bytes + out_bytes) / 1e6:.2f} MB = {row['bytes_ms']:.4f} ms)")
    del o_sdpa, lib, tensors
    return rows, row


def _ssd_fwd_bound(bsz, length, bw, chunk, h=24, p=64, g=1, n=128):
    """:func:`_bound` of the SSD forward with bf16 x, B, C: C B^T (two
    bf16 operands) once per chunk's lower triangle and group, the
    decayed scores times x dt over the triangle and C S_in and B^T (decay
    dt x) over each chunk (a float32 and a bf16 operand); the bytes of
    x, B, C, dt, y and the final state once.  Adds each part's GFLOP."""
    cb_flops = sx_flops = state_flops = 0.0
    for c0 in range(0, length, chunk):
        qc = min(chunk, length - c0)
        tri = qc * (qc + 1) / 2
        cb_flops += 2 * tri * n * g
        sx_flops += 2 * tri * p * h
        state_flops += 4 * qc * n * p * h
    nbytes = bsz * (2 * (2 * length * h * p + 2 * length * n)
                    + 4 * length * h + 4 * h * n * p) + 8 * h
    return dict(cb_flops=bsz * cb_flops, sx_flops=bsz * sx_flops,
                state_flops=bsz * state_flops, nbytes=nbytes,
                **_bound(nbytes, bf16_flops=bsz * cb_flops,
                         f32_bf16_flops=bsz * (state_flops + sx_flops),
                         bw=bw))


def _hold_ssd_chunks(dev, bw):
    """Phase 27 B: #8 and 8' at chunks 64 and 128 at the mamba2 layer (B
    1 and 8, L 2048, bf16) against their plain versions under phase 10's
    rules (state 3e-4; y 3e-4 + 2^-7 |y|, equal to the plain float32 y in
    bf16 in SAME_SHARE of the entries) and phase 26's (every gradient
    within 2^-7 of its leaf's largest magnitude, d a_log and ddt within
    1e-5, within 1e-5 of ``terms=3``), each repeated bit for bit; then
    each chunk's device time beside chunk 256's in this call, and the
    bounds.  Returns ``(fwd rows, bwd rows)`` by chunk."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels.ref import (ssd_scan_bwd_ref,
                                         ssd_scan_chunked_ref, ssd_scan_ref)

    gen = torch.Generator(device=dev).manual_seed(28)
    fwd_rows, bwd_rows = {}, {}
    for bsz in (1, 8):
        x, dt, a_log, b, c, ds = _ssd_inputs(gen, dev, 2048, batch=bsz)
        dy = torch.randn(x.shape, generator=gen, device=dev)
        bargs = (x.bfloat16(), dt, a_log, b.bfloat16(), c.bfloat16(), ds)
        gargs = bargs + (dy.bfloat16(),)
        for chunk in (64, 128):
            name = f"ssd_scan B={bsz} L=2048 H=24 P=64 N=128 chunk={chunk}"
            y, st = SS.ssd_scan(*bargs, chunk=chunk)
            y2, st2 = SS.ssd_scan(*bargs, chunk=chunk)
            got = SS.ssd_scan_bwd(*gargs, chunk=chunk)
            again = SS.ssd_scan_bwd(*gargs, chunk=chunk)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(st, st2) and all(
                    torch.equal(a, b_) for a, b_ in zip(got, again)
                    if a is not None)):
                raise AssertionError(f"{name}: a repeat differs")
            w_y, w_st = ssd_scan_ref(*bargs, chunk=chunk)
            e = _close_or_raise(name + " bf16 state", st, w_st, 3e-4,
                                3e-4)[0]
            ey, rel = _close_or_raise(name + " bf16 y", y, w_y, 3e-4,
                                      2.0 ** -7)
            share = _check_same_share(name + " bf16 y", y, w_y)
            want = ssd_scan_bwd_ref(*gargs, chunk=chunk)
            split = ssd_scan_bwd_ref(*gargs, chunk=chunk, terms=3)
            worst = []
            for leaf, gv, wv, sv in zip(SSD_BWD_NAMES, got, want, split):
                if wv is None:
                    continue
                limit = (SSD_BWD_CANCEL if leaf in ("ddt", "da_log")
                         else SSD_BWD_TOL[torch.bfloat16])
                worst.append(f"{leaf} {_share_of_max(f'{name} {leaf}', gv, wv, limit):.2e}")
                _share_of_max(f"{name} {leaf} against terms=3", gv, sv,
                              SSD_BWD_SPLIT)
            log(f"{name}: ok, forward and backward repeated bit for bit; "
                f"state {e:.3e}, bf16 y {ey:.3e} (max rel err {rel:.3e}, "
                f"{share:.5f} equal to the plain y in bf16); the backward's "
                f"max abs err over each leaf's largest magnitude "
                f"{', '.join(worst)} (limits 2^-7; ddt, da_log 1e-5), "
                f"within {SSD_BWD_SPLIT:.0e} of terms=3")
            del y, y2, st, st2, got, again, want, split, w_y, w_st
        reps = 10
        for chunk in (64, 128, 256):
            fwd = lambda: SS.ssd_scan(*bargs, chunk=chunk)
            bwd = lambda: SS.ssd_scan_bwd(*gargs, chunk=chunk)
            fb = _ssd_fwd_bound(bsz, 2048, bw, chunk)
            bb = _ssd_bwd_bound(bsz, 2048, bw, chunk=chunk)
            frow = dict(ms=cuda_ms(fwd, reps),
                        device_ms=device_rows(fwd, reps)[2] / reps,
                        bound_ms=fb["bound_ms"], bound_by=fb["bound_by"])
            brow = dict(ms=cuda_ms(bwd, reps),
                        device_ms=device_rows(bwd, reps)[2] / reps,
                        bound_ms=bb["bound_ms"], bound_by=bb["bound_by"])
            fwd_rows[f"B={bsz} chunk={chunk}"] = frow
            bwd_rows[f"B={bsz} chunk={chunk}"] = brow
            log(f"ssd_scan / ssd_scan_bwd [B={bsz} L=2048 H=24 P=64 G=1 "
                f"N=128 chunk {chunk}, bf16]: forward {frow['ms']:.4f} ms by "
                f"CUDA events, {frow['device_ms']:.4f} ms of device time, "
                f"bound {frow['bound_ms']:.4f} ms by {frow['bound_by']}; "
                f"backward {brow['ms']:.4f} / {brow['device_ms']:.4f} ms, "
                f"bound {brow['bound_ms']:.4f} ms by {brow['bound_by']}")
        del x, dt, b, c, dy, bargs, gargs
    return fwd_rows, bwd_rows


def _perf_smollm(dev, total: dict):
    """Phase 27 C, smollm-135m under ``prob_bf16,gqa_grouped``: phase
    11's 8 requests served (30 launches of #5 a request, every emitted
    token against a solo run under the same flags), then 3 steps of 8 x
    2048 through the launcher (60 / 30 / 30 launches a step, phase 15's
    loss rule)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    cfg = get_arch("smollm-135m")
    with perf_flags(prob_bf16=True, gqa_grouped=True):
        model, n, _ = serve_arch(dev, "smollm-135m", "flash_attention_fwd")
        total["flash_attention_fwd"] = (total.get("flash_attention_fwd", 0)
                                        + n)
        del model
        trainer, _ = _counted(
            total, "smollm-135m train, prob_bf16", _train_launches(cfg),
            PERF_TRAIN["steps"],
            lambda: train("smollm-135m", ckpt_dir=str(PERF_DIR / "smollm"),
                          ckpt_every=PERF_TRAIN["steps"] + 1, log_every=1,
                          device=dev, **PERF_TRAIN))
    losses = [h.loss for h in trainer.history]
    _loss_rule("smollm-135m prob_bf16", losses, cfg.vocab)
    log(f"smollm-135m train under prob_bf16,gqa_grouped: losses "
        f"{[round(x, 4) for x in losses]}; step ms "
        f"{[round(h.seconds * 1e3, 1) for h in trainer.history]}")
    del trainer
    torch.cuda.empty_cache()


def _perf_mamba2(dev, total: dict, first_256: float):
    """Phase 27 C, mamba2-130m under ``ssd_chunk=128``: 3 steps of 8 x
    2048 through the launcher (48 / 24 launches a step), its first loss
    within CHUNK_RTOL of phase 26's at chunk 256 (``first_256``: the same
    weights and batch), the loss rule."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch.train import train
    cfg = get_arch(SSD_ARCH)
    chunks = []
    scan = SS.ssd_scan

    def spy(*args, chunk, **kw):        # the chunk each launch was given
        chunks.append(chunk)
        return scan(*args, chunk=chunk, **kw)

    SS.ssd_scan = spy
    try:
        with perf_flags(ssd_chunk=128):
            trainer, _ = _counted(
                total, f"{SSD_ARCH} train, ssd_chunk=128",
                _train_launches(cfg), PERF_TRAIN["steps"],
                lambda: train(SSD_ARCH, ckpt_dir=str(PERF_DIR / "mamba2"),
                              ckpt_every=PERF_TRAIN["steps"] + 1,
                              log_every=1, device=dev, **PERF_TRAIN))
    finally:
        SS.ssd_scan = scan
    losses = [h.loss for h in trainer.history]
    rel = abs(losses[0] - first_256) / abs(first_256)
    if set(chunks) != {128} or rel > CHUNK_RTOL:
        raise AssertionError(f"{SSD_ARCH} ssd_chunk=128: chunks "
                             f"{sorted(set(chunks))}, first loss "
                             f"{losses[0]} vs {first_256} at chunk 256")
    _loss_rule(f"{SSD_ARCH} ssd_chunk=128", losses, cfg.vocab)
    log(f"{SSD_ARCH} train under ssd_chunk=128: every scan at chunk 128; "
        f"losses {[round(x, 6) for x in losses]}; first loss against phase "
        f"26's at chunk 256 {first_256:.6f}: rel {rel:.2e} (limit "
        f"{CHUNK_RTOL:.0e}); step ms "
        f"{[round(h.seconds * 1e3, 1) for h in trainer.history]}")
    del trainer
    torch.cuda.empty_cache()


def _microbatch_runs(dev, total: dict, arch: str, batch: int,
                     steps: int = 2, n_layers=None):
    """``arch`` at full width (cut to ``n_layers`` where given), ``batch``
    x 2048 tokens, ``steps`` donated steps through ``make_train_step``
    (the launcher's seed, data and schedule) under
    ``microbatch=PERF_MB`` (#5-#8 as many times the step's layer plan)
    and again at 1.  Returns each run's per-step metrics (with its ms)
    and peak memory, by microbatch."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.train import (TrainStepConfig, init_train_state,
                                   make_train_step)
    cfg = get_arch(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    data = DataConfig(vocab=cfg.vocab, seq_len=2048, global_batch=batch)
    ts = TrainStepConfig(optimizer=AdamWConfig(lr=cosine_schedule(
        1e-3, warmup=min(20, steps // 10 + 1), total=steps)))
    per = _train_launches(cfg)
    runs = {}
    for mb in (PERF_MB, 1):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(cfg, 0, ts, dev)
        step_fn = make_train_step(cfg, dev, ts)

        def run():
            out = []
            for step in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, m = step_fn(state, synthetic_batch(data, step))
                torch.cuda.synchronize()
                out.append({**{k: float(v) for k, v in m.items()},
                            "ms": (time.perf_counter() - t0) * 1e3})
            return out

        with perf_flags(microbatch=mb):
            metrics = _counted(total, f"{arch} train, microbatch={mb}",
                               {k: v * mb for k, v in per.items()}, steps,
                               run)
        runs[mb] = dict(metrics=metrics,
                        peak=torch.cuda.max_memory_allocated())
        del state, step_fn
    torch.cuda.empty_cache()
    return runs


def _col(ms, key, nd=6):
    return [round(m[key], nd) for m in ms]


def _perf_microbatch(dev, total: dict) -> dict:
    """Phase 27 C, ``microbatch=2`` at full width.  smollm-135m (8 x 2048,
    no aux loss): each step's loss within MB_RTOL of microbatch 1's, the
    reference's own rule.  granite-moe-3b-a800m in phase 25's cell (2 x
    2048, two microbatches of one sequence) cut to PERF_MB_MOE_LAYERS
    layers: the first step's
    cross-entropy within MB_RTOL of microbatch 1's (a mean over tokens,
    which equal microbatches average exactly); its router aux loss is the
    mean of the microbatches' own, as the reference computes it, so the
    losses and, through the aux gradient and the clip, the second step
    differ, and are logged; the microbatched run's peak memory under 80
    GB and its warm step's ms.  Returns granite's numbers."""
    runs = _microbatch_runs(dev, total, "smollm-135m", 8)
    got, want = runs[PERF_MB]["metrics"], runs[1]["metrics"]
    rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
              for a, b in zip(got, want))
    log(f"smollm-135m train (B 8, S 2048, 2 steps): microbatch={PERF_MB} "
        f"losses {_col(got, 'loss')}, microbatch=1 {_col(want, 'loss')}: "
        f"max rel {rel:.2e} (limit {MB_RTOL:.0e}); step ms "
        f"{_col(got, 'ms', 1)} against {_col(want, 'ms', 1)}")
    if rel > MB_RTOL:
        raise AssertionError(f"smollm-135m microbatch={PERF_MB}: {got} vs "
                             f"{want}")
    from repro_torch.configs import get_arch
    runs = _microbatch_runs(dev, total, MOE_ARCH, MOE_TRAIN["batch"],
                            n_layers=PERF_MB_MOE_LAYERS)
    got, want = runs[PERF_MB]["metrics"], runs[1]["metrics"]
    rel = abs(got[0]["ce"] - want[0]["ce"]) / abs(want[0]["ce"])
    peak = runs[PERF_MB]["peak"]
    log(f"{MOE_ARCH} train ({PERF_MB_MOE_LAYERS} of 32 layers, B 2, S 2048, "
        f"2 steps): microbatch={PERF_MB} "
        f"ce {_col(got, 'ce')}, microbatch=1 ce {_col(want, 'ce')}: first "
        f"step rel {rel:.2e} (limit {MB_RTOL:.0e}); loss "
        f"{_col(got, 'loss')} against {_col(want, 'loss')}, of which the "
        f"router's aux loss {_col(got, 'aux')} against {_col(want, 'aux')} "
        f"(per microbatch, as the reference computes it), grad norm "
        f"{_col(got, 'grad_norm', 4)} against {_col(want, 'grad_norm', 4)}"
        f"; step ms {_col(got, 'ms', 1)} against {_col(want, 'ms', 1)}; "
        f"peak memory {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB) against "
        f"{runs[1]['peak'] / 1e9:.2f} GB at microbatch 1, limit "
        f"{PEAK_LIMIT / 1e9:.0f} GB")
    vocab = get_arch(MOE_ARCH).vocab
    if (rel > MB_RTOL or not peak < PEAK_LIMIT
            or not all(np.isfinite(_col(got, "loss")))
            or abs(got[0]["ce"] - np.log(vocab)) > 0.5):
        raise AssertionError(f"{MOE_ARCH} microbatch={PERF_MB}: {got} vs "
                             f"{want}, peak {peak}")
    return dict(peak=peak, step_ms=got[-1]["ms"], step_ms_mb1=want[-1]["ms"],
                ce_rel=rel)


def _perf_defaults(dev, total: dict):
    """Phase 27 D: ``obs=metrics`` makes an engine-less ``obs.session()``
    record; under it ``util_engine=dense`` routes an engine-less
    ``utilization(pn_graph(16))`` to the dense engine (loads equal to
    ``engine="dense"``'s bit for bit); ``sim_backend=fused`` gives a
    PN(16) ``Simulator`` with the default config the fused step, its run
    bit for bit an explicit ``backend="fused"`` run's."""
    from repro_torch import obs
    from repro_torch.core import (make_pattern, normalize_demand, pn_graph,
                                  utilization)
    from repro_torch.kernels import sim_step
    from repro_torch.sim import SimConfig, Simulator
    g = pn_graph(16)
    with perf_flags(obs="metrics", util_engine="dense"):
        with obs.session() as sess:
            rep = utilization(g)
        counters = {k: v["value"] for k, v in
                    sess.snapshot()["metrics"].items()
                    if v["type"] == "counter"}
    want = utilization(g, engine="dense")
    if (sess.mode != "metrics" or counters.get("util.dispatch[dense]") != 1.0
            or not np.array_equal(rep.loads, want.loads)):
        raise AssertionError(f"obs / util_engine defaults: mode "
                             f"{sess.mode}, counters {counters}")
    dem = normalize_demand(make_pattern("uniform").demand(g, None))
    runs = []
    sim_step.reset_launches()
    for backend, flag in (("auto", "fused"), ("fused", "auto")):
        with perf_flags(sim_backend=flag):
            sim = Simulator(g, SimConfig(backend=backend), demand=dem)
            if sim.backend != "fused":
                raise AssertionError(f"sim_backend={flag}: backend "
                                     f"{sim.backend}")
            runs.append(sim.run(dem, 0.5, 12))
    launches = dict(sim_step.LAUNCHES)
    for key in runs[0].history:
        if not np.array_equal(runs[0].history[key], runs[1].history[key]):
            raise AssertionError(f"sim_backend=fused: history {key} "
                                 f"differs from backend='fused'")
    if not launches["fused_step_update"]:     # the minimal routing: no
        raise AssertionError(f"sim_backend=fused launched {launches}")
    for k, n in launches.items():               # decision kernel
        if n:
            total[k] = total.get(k, 0) + n
    log(f"phase 27 defaults: obs=metrics session recorded "
        f"{len(counters)} counters; util_engine=dense ran "
        f"util.dispatch[dense] {counters['util.dispatch[dense]']:.0f} time, "
        f"loads equal to engine='dense'; sim_backend=fused picked the fused "
        f"step ({launches}), bit for bit an explicit backend='fused' run")


def check_perf_flags(dev, bw, first_256: float, out: dict):
    """Phase 27: the REPRO_PERF flags on one card, set through
    ``repro_torch.perf.set_flags`` and restored after each part: #5-#7
    under ``prob_bf16`` (A), #8 and 8' at chunks 64 and 128 (B),
    smollm-135m served and trained under ``prob_bf16,gqa_grouped``,
    mamba2-130m trained at ``ssd_chunk=128``, smollm-135m and
    granite-moe-3b-a800m at ``microbatch=2`` at full width (C), and the
    flags that set defaults (D).  Puts the timing rows into ``out``; returns the phase's
    launches."""
    out["attention"] = _hold_prob_bf16(dev, bw)
    out["ssd"] = _hold_ssd_chunks(dev, bw)
    total = {}
    shutil.rmtree(PERF_DIR, ignore_errors=True)
    _perf_smollm(dev, total)
    _perf_mamba2(dev, total, first_256)
    out["granite"] = _perf_microbatch(dev, total)
    shutil.rmtree(PERF_DIR, ignore_errors=True)
    _perf_defaults(dev, total)
    log(f"phase 27: launches {total}")
    return total


# ---------------------------------------------------------------------------
# Phase 28: #5-#7 at head size 256, recurrentgemma-9b at full width
# ---------------------------------------------------------------------------

RGEMMA_ARCH = "recurrentgemma-9b"
# B 1 x S 4096: the window of 2048 crosses the q tiles
RGEMMA_TRAIN = dict(batch=1, seq=4096, steps=4, lr=1e-3)
# one (rglru, rglru, attn) group at full width: 2.75B parameters, a 44.1
# GB train state (the 38 layers' 167 GB wait for a mesh).  Two groups (6
# layers, 3.41B, 54.6 GB) trained here at a peak of 75.60 GB, past the 75
# GB that leaves room on an 80 GB card
RGEMMA_TRAIN_LAYERS = 3
H256_DIR = ROOT / "build" / "train_smoke28"
# the largest top-two gap of a solo run that a batched token may flip:
# random weights give recurrentgemma-9b flat logits over 256,000 tokens,
# all under 4.9 (bf16 steps of 2^-6 and 2^-5), and 38 bf16 layers batched
# 4 at a time round apart from solo ones; the one token of 256 beyond
# 0.05 here was the solo run's second choice, its top two 0.0625 apart
FLIP_GAP = 2.0 ** -4
H256_KERNELS = {"flash_attention_fwd": "flash_fwd_kernel<256, {pb}>",
                "flash_attention_dq": "flash_dq_kernel<256>",
                "flash_attention_dkv": "flash_dkv_kernel<256, {pb}>"}


def _live_pairs(sq, skv, causal, window, q_offset) -> int:
    """The (query, key) pairs that the masks leave live."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, pos + 1) if causal else np.full(sq, skv)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def _attn_work(kname, b, hq, hkv, sq, skv, dqk, dv, pairs, pb):
    """``(bytes, bf16 x bf16 FLOP, float32 x bf16 FLOP)`` of one call of
    #5, #6 or #7 by phase 14's rule: each input read once and each output
    written once; the products over the live pairs at the caller's
    widths, q and k ``dqk`` and v ``dv`` (MLA: 192 and 128, whatever
    the kernel pads them to); under ``pb`` p enters P.V (#5) and p^T dO
    (#7) as one bf16 operand."""
    qk, pv = 2.0 * dqk * hq * b * pairs, 2.0 * dv * hq * b * pairs
    q_b, o_b = 2 * b * hq * sq * dqk, 2 * b * hq * sq * dv
    kv_b, rows = 2 * b * hkv * skv * (dqk + dv), 4 * b * hq * sq
    if kname == "flash_attention_fwd":      # q, k, v -> o, lse
        return (q_b + kv_b + o_b + rows, qk + (pv if pb else 0.0),
                0.0 if pb else pv)
    if kname == "flash_attention_dq":       # + dO, lse, dsum -> dq
        return 2 * q_b + kv_b + o_b + 2 * rows, qk + pv, qk
    out = 4 * b * hq * skv * (dqk + dv)     # dk, dv per q head, float32
    return (q_b + kv_b + o_b + 2 * rows + out,
            qk + pv + (pv if pb else 0.0), qk + (0.0 if pb else pv))


def _sdpa_mask(sq, skv, causal, window, q_offset, dev):
    """SDPA's boolean mask for the kernels' masks, or None where
    ``is_causal`` (q_offset 0, no window inside the keys) says it."""
    if q_offset == 0 and (not window or window >= skv):
        return None
    q_pos = q_offset + torch.arange(sq, device=dev)[:, None]
    k_pos = torch.arange(skv, device=dev)[None, :]
    live = k_pos > q_pos - window if window else torch.ones_like(k_pos > 0)
    return live & (k_pos <= q_pos) if causal else live


def _hold_head256(dev, bw):
    """Phase 28 A: #5, #6 and #7 at head size 256, both variants (the
    default and ``prob_bf16``), against their plain versions: one
    recurrentgemma-9b attention layer as served (B 1, 16 q heads over one
    kv head, S 1536, window 2048) and as trained (S 4096: the window's
    edge crosses the tiles), a ragged shape with a q_offset and a window,
    and one full-width deepseek-v3 MLA layer (128 heads, q/k 192 and v
    128 zero-padded to 256, S 2048), whose backward through
    ``ops.attention`` (192 -> 256 by the wrapper, v 128 -> 192 -> 256)
    must give the kernels' dq, dk and dv cut back, bit for bit.  Default
    variant: phase 9's and 14's limits (o and dq within one bf16
    rounding, in SAME_SHARE of the entries equal to the plain float32
    result rounded, lse at 3e-5, dk and dv per q head within 2e-4 + 2e-5
    |d|); ``prob_bf16``: phase 27's (each leaf within PB_TOL of its
    largest magnitude; lse within PB_LSE of the default's where the scale
    is a power of two, 256^-0.5 = 1/16 being one).  Every launch repeats
    bit for bit.  Then each kernel's time by CUDA events and by device
    time, its plain version's, its bound (phase 14's rule, at the
    caller's widths), its registers and stack from the build, and SDPA's
    forward and backward on the unpadded inputs, with the backend that
    ran (the leading kernel's name).  Returns ``{kernel: {shape:
    row}}``."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref

    rg, ds = get_arch(RGEMMA_ARCH), get_arch("deepseek-v3-671b")
    mla = ds.mla
    hq, hkv, win = rg.n_heads, rg.n_kv_heads, rg.window
    s_serve, s_train = SERVE["max_len_prompt"], RGEMMA_TRAIN["seq"]
    shapes = {  # label: (b, hq, hkv, sq, skv, causal, window, q_offset)
        "recurrentgemma serve layer": (1, hq, hkv, s_serve, s_serve, True,
                                       win, 0),
        "recurrentgemma train layer": (1, hq, hkv, s_train, s_train, True,
                                       win, 0),
        "ragged, q_offset": (2, 8, 2, 333, 1333, True, 700, 1000),
        "deepseek-v3 MLA layer": (1, ds.n_heads, ds.n_heads, 2048, 2048,
                                  True, None, 0)}
    gen = torch.Generator(device=dev).manual_seed(28)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    usage = tc_usage() or {}
    rows = {k: {} for k in H256_KERNELS}
    reps = 10
    for label, (b, hq_, hkv_, sq, skv, causal, window, off) in \
            shapes.items():
        narrow = label.startswith("deepseek")
        dqk, dv = ((mla.qk_nope + mla.qk_rope, mla.v_head) if narrow
                   else (rg.resolved_head_dim,) * 2)
        q = torch.randn((b, hq_, sq, dqk), generator=gen, device=dev)
        k = torch.randn((b, hkv_, skv, dqk), generator=gen, device=dev)
        v = torch.randn((b, hkv_, skv, dv), generator=gen, device=dev)
        do = torch.randn((b, hq_, sq, dv), generator=gen, device=dev)
        q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
        qp, kp, vp, dop = (torch.nn.functional.pad(t, (0, 256 - t.shape[-1]))
                           for t in (q, k, v, do))
        kw = dict(causal=causal, window=window, q_offset=off,
                  scale=dqk ** -0.5)
        name = (f"head 256 {label} B={b} Hq={hq_} Hkv={hkv_} Sq={sq} "
                f"Skv={skv} q/k {dqk} v {dv} "
                f"{'causal' if causal else 'non-causal'}"
                f"{f' window {window}' if window else ''}"
                f"{f' q_offset {off}' if off else ''}")
        lse_default = None
        for pb in (False, True):
            variant = f"{name} {'prob_bf16' if pb else 'default'}"
            o, lse = FA.flash_attention(qp, kp, vp, prob_bf16=pb, **kw)
            dsum = (dop[..., :dv].float() * o[..., :dv].float()).sum(
                -1, keepdim=True)
            args = (qp, kp, vp, dop, lse, dsum)
            dq = FA.flash_attention_dq(*args, **kw)
            dkh, dvh = FA.flash_attention_dkv(*args, prob_bf16=pb, **kw)
            again = (*FA.flash_attention(qp, kp, vp, prob_bf16=pb, **kw),
                     FA.flash_attention_dq(*args, **kw),
                     *FA.flash_attention_dkv(*args, prob_bf16=pb, **kw))
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in
                       zip((o, lse, dq, dkh, dvh), again)):
                raise AssertionError(f"{variant}: a repeat differs")
            del again
            w_o, w_lse = ref.flash_attention_ref(qp, kp, vp, prob_bf16=pb,
                                                 **kw)
            w_dk, w_dv = ref.flash_attention_dkv_ref(*args, prob_bf16=pb,
                                                     **kw)
            if pb:
                w_dq = ref.flash_attention_dq_ref(*args, **kw)
                errs = {leaf: _share_of_max(f"{variant} {leaf}", got, want,
                                            PB_TOL)
                        for leaf, got, want in (
                            ("o", o, w_o), ("dq", dq, w_dq),
                            ("dk", dkh, w_dk), ("dv", dvh, w_dv))}
                e_lse = float((lse - lse_default).abs().max())
                if not narrow and e_lse > PB_LSE:
                    raise AssertionError(f"{variant}: lse {e_lse} from the "
                                         f"default variant's")
                log(f"{variant}: ok, a repeat bit for bit; max abs err over "
                    f"the leaf's largest magnitude "
                    f"{', '.join(f'{k_} {v_:.2e}' for k_, v_ in errs.items())}"
                    f" (limit {PB_TOL:.3e}); lse {e_lse:.2e} from the "
                    f"default variant's")
            else:
                w_dq32 = ref.flash_attention_dq_ref(
                    *(t.float() for t in (qp, kp, vp, dop)), lse, dsum, **kw)
                e_o, _ = _close_or_raise(variant + " o", o, w_o, 1e-4,
                                         2.0 ** -7)
                e_lse, _ = _close_or_raise(variant + " lse", lse, w_lse,
                                           3e-5, 3e-5)
                e_dq, _ = _close_or_raise(variant + " dq", dq,
                                          w_dq32.to(dq.dtype), 1e-4,
                                          2.0 ** -7)
                errs = {"o": e_o, "dq": e_dq}
                for leaf, got, want in (("dk", dkh, w_dk), ("dv", dvh, w_dv)):
                    errs[leaf] = _close_or_raise(f"{variant} {leaf}", got,
                                                 want, 2e-4, 2e-5)[0]
                shares = (_check_same_share(variant + " o", o, w_o),
                          _check_same_share(variant + " dq", dq, w_dq32))
                lse_default = lse
                log(f"{variant}: ok, a repeat bit for bit; max abs err o "
                    f"{e_o:.3e}, lse {e_lse:.3e}, dq {e_dq:.3e}, dk "
                    f"{errs['dk']:.3e}, dv {errs['dv']:.3e}; "
                    f"{shares[0]:.5f} of o and {shares[1]:.5f} of dq equal "
                    f"to the plain float32 result in bf16")
                del w_dq32
            if narrow and not pb:
                qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
                out = ops.attention(qg, kg, vg, causal=True,
                                    scale=dqk ** -0.5)
                gq, gk, gv = torch.autograd.grad(out, (qg, kg, vg), do)
                if not (torch.equal(out, o[..., :dv])
                        and torch.equal(gq, dq[..., :dqk])
                        and torch.equal(gk, dkh[..., :dqk].to(k.dtype))
                        and torch.equal(gv, dvh[..., :dv].to(v.dtype))):
                    raise AssertionError(f"{variant}: ops.attention differs "
                                         f"from the kernels on the padded "
                                         f"head")
                log(f"{variant}: ops.attention (q/k {dqk} padded to 256 by "
                    f"the wrapper, v {dv} to {dqk} and then 256) gives the "
                    f"kernels' o, dq, dk and dv cut back, bit for bit")
                del out, gq, gk, gv
            for kname, err in zip(H256_KERNELS, (
                    errs["o"], errs["dq"], max(errs["dk"], errs["dv"]))):
                rows[kname].setdefault(label, {})[
                    "prob_bf16_err" if pb else "max_abs_err"] = err
            del w_o, w_lse, w_dk, w_dv

        # times, default variant (device time of the prob_bf16 variants
        # of #5 and #7 beside), on the last variant's lse and dsum
        pairs = _live_pairs(sq, skv, causal, window, off)
        mask = _sdpa_mask(sq, skv, causal, window, off, dev)
        sk = dict(attn_mask=mask, is_causal=mask is None and causal,
                  enable_gqa=hq_ != hkv_, scale=dqk ** -0.5)
        fwd_lib = lambda: sdpa(q, k, v, **sk)
        f_rows = device_rows(fwd_lib, reps)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        o_sdpa = sdpa(qs, ks, vs, **sk)
        bwd_lib = lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), do,
                                              retain_graph=True)
        b_rows = device_rows(bwd_lib, reps)
        lib = {"flash_attention_fwd": (cuda_ms(fwd_lib, reps),
                                       f_rows[2] / reps, f_rows[0][0][2]),
               "flash_attention_dq": (cuda_ms(bwd_lib, reps),
                                      b_rows[2] / reps, b_rows[0][0][2])}
        lib["flash_attention_dkv"] = lib["flash_attention_dq"]
        calls = {
            "flash_attention_fwd": (
                lambda pb=False: FA.flash_attention(qp, kp, vp, prob_bf16=pb,
                                                    **kw),
                lambda: ref.flash_attention_ref(qp, kp, vp, **kw)),
            "flash_attention_dq": (
                lambda pb=False: FA.flash_attention_dq(*args, **kw),
                lambda: ref.flash_attention_dq_ref(*args, **kw)),
            "flash_attention_dkv": (
                lambda pb=False: FA.flash_attention_dkv(*args, prob_bf16=pb,
                                                        **kw),
                lambda: ref.flash_attention_dkv_ref(*args, **kw))}
        for kname, (call, plain) in calls.items():
            nbytes, f_bb, f_fb = _attn_work(kname, b, hq_, hkv_, sq, skv,
                                            dqk, dv, pairs, False)
            inst = H256_KERNELS[kname].format(pb=0)
            regs, stack = usage.get(inst, (None,) * 4)[2:]
            row = rows[kname][label]
            row.update(ms=cuda_ms(call, reps),
                       device_ms=device_rows(call, reps)[2] / reps,
                       plain_ms=cuda_ms(plain, 1), library_ms=lib[kname][0],
                       library_device_ms=lib[kname][1],
                       library_kernel=lib[kname][2][:80], registers=regs,
                       stack_bytes=stack,
                       **_bound(nbytes, bw=bw, bf16_flops=f_bb,
                                f32_bf16_flops=f_fb))
            if kname != "flash_attention_dq":
                pb_nbytes, f_bb, f_fb = _attn_work(
                    kname, b, hq_, hkv_, sq, skv, dqk, dv, pairs, True)
                pb_use = usage.get(H256_KERNELS[kname].format(pb=1),
                                   (None,) * 4)
                row.update(prob_bf16_device_ms=device_rows(
                    lambda call=call: call(True), reps)[2] / reps,
                           prob_bf16_bound_ms=_bound(
                               pb_nbytes, bw=bw, bf16_flops=f_bb,
                               f32_bf16_flops=f_fb)["bound_ms"],
                           prob_bf16_registers=pb_use[2],
                           prob_bf16_stack_bytes=pb_use[3])
            log(f"{kname} [{label}]: {row['ms']:.4f} ms by CUDA events, "
                f"{row['device_ms']:.4f} ms of device time"
                f"{_pb_note(row)}, plain {row['plain_ms']:.4f} ms; SDPA "
                f"{'forward' if kname.endswith('fwd') else 'backward'} "
                f"{row['library_ms']:.4f} / {row['library_device_ms']:.4f} "
                f"ms ({row['library_kernel']}); bound "
                f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
                f"({row['tc_flops'] / 1e9:.3f} GFLOP on the tensor cores = "
                f"{row['ops_ms']:.4f} ms; {nbytes / 1e6:.2f} MB = "
                f"{row['bytes_ms']:.4f} ms; {pairs} live pairs a head); "
                f"{inst}: {regs} registers, {stack} bytes of stack")
        del o_sdpa, qs, ks, vs, args, calls, fwd_lib, bwd_lib
        torch.cuda.empty_cache()
    return rows


def _pb_note(row) -> str:
    if "prob_bf16_device_ms" not in row:
        return ""
    return (f" (prob_bf16 variant {row['prob_bf16_device_ms']:.4f} ms, "
            f"bound {row['prob_bf16_bound_ms']:.4f} ms, "
            f"{row['prob_bf16_registers']} registers, "
            f"{row['prob_bf16_stack_bytes']} bytes of stack)")


def _serve_rgemma(dev, total: dict) -> dict:
    """Phase 28 B: recurrentgemma-9b at full width and depth (38 layers,
    12 of them local MQA attention over heads of 256) served as phase 11
    serves smollm: #5 exactly 12 times a request inside ``Engine.run``,
    every emitted token within 0.05 of the solo teacher-forced max logit
    (or a near-tie flip, FLIP_GAP), prefill ms, decode ms a step and peak
    memory."""
    from repro_torch.configs import get_arch
    from repro_torch.models import count_params
    log(f"{RGEMMA_ARCH}: {count_params(get_arch(RGEMMA_ARCH)):,} "
        f"parameters (count_params), float32 weights")
    torch.cuda.empty_cache()
    model, n, times = serve_arch(dev, RGEMMA_ARCH, "flash_attention_fwd",
                                 flip=FLIP_GAP)
    total["flash_attention_fwd"] = total.get("flash_attention_fwd", 0) + n
    del model
    torch.cuda.empty_cache()
    return {key: times[key] for key in ("tok_s", "prefill_ms", "decode_ms",
                                        "peak")}


def _train_rgemma(dev, total: dict) -> dict:
    """Phase 28 C: recurrentgemma-9b at full width cut to
    RGEMMA_TRAIN_LAYERS layers through the launcher's ``train`` (a
    donating step, remat, AdamW with the cosine schedule, B 1 x S 4096, 4
    steps): #5 / #6 / #7 exactly as the layer plan says (2 / 1 / 1 a
    step at 3 layers), the loss rule, peak memory under 80 GB, ms a step
    and tokens/s."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    from repro_torch.models import build, count_params

    layers = RGEMMA_TRAIN_LAYERS
    cfg = get_arch(RGEMMA_ARCH).replace(n_layers=layers)
    bundle = build(cfg)
    tokens = RGEMMA_TRAIN["batch"] * RGEMMA_TRAIN["seq"]
    flops = bundle.flops(tokens)
    label = f"{RGEMMA_ARCH} ({layers} layers) train"
    log(f"{label}: {count_params(cfg):,} parameters (count_params)")
    shutil.rmtree(H256_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, state = _counted(
        total, label, _train_launches(cfg), RGEMMA_TRAIN["steps"],
        lambda: train(RGEMMA_ARCH, n_layers=layers,
                      steps=RGEMMA_TRAIN["steps"], seq=RGEMMA_TRAIN["seq"],
                      batch=RGEMMA_TRAIN["batch"], lr=RGEMMA_TRAIN["lr"],
                      ckpt_dir=str(H256_DIR / "rgemma"),
                      ckpt_every=RGEMMA_TRAIN["steps"] + 1, log_every=1,
                      device=dev))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [h.loss for h in trainer.history]
    _loss_rule(label, losses, cfg.vocab)
    _report_run(label, trainer, seconds, tokens, flops, peak)
    warm = sorted(h.seconds for h in trainer.history[1:])
    del trainer, state
    shutil.rmtree(H256_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(layers=layers, losses=losses, peak=peak,
                warm_ms=warm[len(warm) // 2] * 1e3)


def check_head256(dev, bw, out: dict):
    """Phase 28: #5-#7 at head size 256 against their plain versions (A),
    recurrentgemma-9b served at full width and depth (B) and trained at
    full width with its depth cut (C), and one step of its reduced config
    with heads of 256 on the card against the CPU (D).  Puts A's rows
    and B's and C's records into ``out``; returns the phase's
    launches."""
    from repro_torch.configs import get_arch
    out["attention"] = _hold_head256(dev, bw)
    total = {}
    out["serve"] = _serve_rgemma(dev, total)
    out["train"] = _train_rgemma(dev, total)
    cfg = get_arch(RGEMMA_ARCH).reduced().replace(head_dim=256)
    _two_layer_step(dev, total, cfg, f"{RGEMMA_ARCH} reduced, heads of 256",
                    seed=28, n_layers=cfg.n_layers)
    log(f"phase 28: launches {total}")
    return total


# phase 29: the data-parallel gradient all-reduce of each cell, bytes a
# device: the float32 gradients of the parameters not sharded over
# "data" on the (16, 16) mesh (33,323,328 / 188,160 / 102,205,248 of them)
MESH_DP_BYTES = {"smollm-135m": 133_293_312, "h2o-danube-3-4b": 752_640,
                 "mamba2-130m": 408_820_992}


def _mesh_cell(dev, arch: str, label: str, total: dict, *, cfg=None,
               shape=None, **flag_kw):
    """One ``train_4k`` cell of phases 29-31 on ``pod1`` (``cfg``: the
    published config cut, ``shape``: the shape's rows cut, where given)
    under the perf flags ``flag_kw``: its record, its launches added to
    ``total``, its bytes and memory logged."""
    from repro_torch.launch.dryrun import lower_cell

    with perf_flags(**flag_kw):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec = lower_cell(arch, "train_4k", False, dev, cfg=cfg, shape=shape)
        wall = time.perf_counter() - t0
    if rec["status"] != "ok":
        raise AssertionError(f"{label}: {rec}")
    for kname, n in rec["launches"].items():
        total[kname] = total.get(kname, 0) + n
    coll = rec["collective_bytes_per_device"]
    mem = rec["memory"]
    log(f"{label}: collective bytes a device {json.dumps(coll)}")
    log(f"{label}: by phase/axis "
        f"{json.dumps(rec['collective_bytes_by_phase_axis'])}")
    log(f"{label}: the largest collectives "
        f"{json.dumps(rec['collectives'][:6])}")
    log(f"{label}: {rec['collective_calls']} collectives; FLOPs "
        f"{rec['flops']:.4e} (aten {rec['aten_flops']:.4e}, kernels "
        f"{rec['kernel_flops']:.4e}; the kernels' head padding adds "
        f"{rec['kernel_padding_flops']:.4e}); state "
        f"{mem['argument_bytes'] / 2**30:.3f}"
        f" GiB, peak {mem['peak_bytes'] / 2**30:.3f} GiB above the state "
        f"(temp {mem['temp_bytes'] / 2**30:.3f} GiB); step "
        f"{rec['step_seconds']:.2f} s, cell {wall:.2f} s; launches "
        f"{rec['launches']}; rows a device {rec['per_device_batch']}")
    parts = mem.get("peak_parts") or {}
    log(f"{label}: the state and the peak by part, GiB: " + ", ".join(
        f"{k} {v / 2**30:.3f}" for k, v in parts.items() if v is not None))
    if mem["peak_bytes"] + mem["argument_bytes"] > 80e9:
        raise AssertionError(f"{label}: over 80 GB")
    return rec


def _check_dp_bytes(label: str, rec: dict, arch: str, zero1: bool):
    dp = rec["dp_gradient_bytes"]
    want = MESH_DP_BYTES[arch]
    got = dp.get("all-reduce", 0)
    if zero1:
        # a ZeRO-1 leaf's gradient is reduce-scattered: its all-reduce
        # bytes leave the total, 1/16 of them come back as reduce-scatter
        got += dp.get("reduce-scatter", 0) * 16
    log(f"{label}: data-parallel gradient bytes {json.dumps(dp)} "
        f"(all-reduce{' + 16 x reduce-scatter' if zero1 else ''} {got:,} "
        f"B, expected {want:,} B)")
    if got != want:
        raise AssertionError(f"{label}: data-parallel gradient bytes {got} "
                             f"!= {want}")


def _mesh_attention_problem(label: str, cfg, rec: dict):
    """A cell's one local attention problem, as its step handed it to
    the kernels: ``(B, Hq, Hkv, Sq, Skv, D, window, causal)``."""
    problems = rec["kernel_problems"].get("attention", [])
    if len(problems) != 1:
        raise AssertionError(f"{label}: local attention problems "
                             f"{problems}")
    *problem, calls = problems[0]
    if calls < cfg.n_layers:
        raise AssertionError(f"{label}: {calls} attention calls booked")
    return tuple(problem)


def _hold_mesh_attention(dev, label: str, cfg, rec: dict, ranks=(0,),
                         problem=None):
    """Phase 29: #5-#7 at a cell's own local problem, on fresh seeded
    inputs, against their plain versions.  The q heads of a model rank
    and every kv head go through ``models.layers.attention_block`` (the
    kernel call of ``local_attention``, with its cut of k and v to the
    kv heads that rank's q heads read, ``kv_heads_read``) forward and
    backward: its output and gradients equal the kernels' own, called
    directly on the cut, bit for bit; o and lse are held to phase 9's
    limits (o within 1e-4 + 2^-7 |o|, lse within 3e-5 + 3e-5 |lse|, o
    equal to the plain o in bf16 in SAME_SHARE of the entries), dq and
    dk / dv per q head to phase 14's, all against the plain versions on
    k and v picked by the global group map (q head h reads kv head h //
    (Hq / Hkv)), so a wrong cut of k and v shows.  Phase 30 holds
    granite-moe's cell likewise, phase 31 each of its cells' problems
    (``problem``; a non-causal one, Sq against the memory's Skv, too).
    Returns the largest errors of the last rank held."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.layers import attention_block, kv_heads_read

    if problem is None:
        problem = _mesh_attention_problem(label, cfg, rec)
    b, hq_l, hkv_l, sq, skv, d, window, causal = problem
    hq, hkv = cfg.n_heads, max(1, cfg.n_kv_heads)
    split = hq_l != hq
    n_model = hq // hq_l
    group = hq // hkv
    gen = torch.Generator(device=dev).manual_seed(29)
    kw = dict(causal=causal, window=window, q_offset=0)
    for rank in (ranks if split else (0,)):
        kv = kv_heads_read(hq, hkv, n_model, rank) if split else None
        lo, hi = kv if kv is not None else (0, hkv)
        if hi - lo != hkv_l:
            raise AssertionError(f"{label}: the step handed the kernel "
                                 f"{hkv_l} kv heads, rank {rank} reads "
                                 f"{hi - lo}")
        first = rank * hq_l if split else 0
        q, do = (torch.randn((b, hq_l, sq, d), generator=gen,
                             device=dev).bfloat16() for _ in range(2))
        k, v = (torch.randn((b, hkv, skv, d), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        name = (f"{label} attention rank {rank}: B={b} Hq={hq_l} of {hq} "
                f"(kv heads {lo}:{hi} of {hkv}) Sq={sq} Skv={skv} D={d} "
                f"window={window} {'causal' if causal else 'non-causal'}")
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_block(*leaves, kv, causal=causal, window=window)
        gq, gk, gv = torch.autograd.grad(out, leaves, do)
        kl, vl = k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous()
        o, lse = FA.flash_attention(q, kl, vl, **kw)
        dsum = (do.float() * o.float()).sum(-1, keepdim=True)
        dp = FA._pad_head(d)
        pad = (lambda t: torch.nn.functional.pad(t, (0, dp - d))) \
            if dp != d else (lambda t: t)
        bargs = (pad(q), pad(kl), pad(vl), pad(do), lse, dsum)
        bkw = dict(kw, scale=d ** -0.5)
        dq = FA.flash_attention_dq(*bargs, **bkw)[..., :d]
        dkh, dvh = FA.flash_attention_dkv(*bargs, **bkw)
        torch.cuda.synchronize()
        # summed over each kv group at the padded width and cut, as
        # flash_attention_bwd does
        dk, dv = (t.view(b, hi - lo, hq_l // (hi - lo), skv, dp).sum(2)
                  [..., :d].contiguous().to(k.dtype) for t in (dkh, dvh))
        dkh, dvh = dkh[..., :d], dvh[..., :d]
        outside = torch.ones(hkv, dtype=torch.bool, device=dev)
        outside[lo:hi] = False
        if not (torch.equal(out, o) and torch.equal(gq, dq)
                and torch.equal(gk[:, lo:hi], dk)
                and torch.equal(gv[:, lo:hi], dv)
                and not gk[:, outside].any() and not gv[:, outside].any()):
            raise AssertionError(f"{name}: attention_block's output or "
                                 f"gradients differ from the kernels'")
        idx = torch.tensor([(first + h) // group for h in range(hq_l)],
                           device=dev)
        kr, vr = k[:, idx], v[:, idx]
        errs = _hold_attention_rows(name, (q, kr, vr, do), (o, lse, dq, dkh,
                                                             dvh), dsum, kw)
        log(f"{name}: attention_block bit for bit the kernels' o, dq, dk, "
            f"dv; against the plain versions on the global group map: o "
            f"max abs err {errs['o']:.3e} (max rel {errs['rel']:.3e}, "
            f"{errs['share_o']:.5f} equal in bf16), dq {errs['dq']:.3e} "
            f"({errs['share_dq']:.5f} equal in bf16), dk / dv per q head "
            f"{errs['kv']:.3e}")
        del (q, k, v, do, leaves, out, gq, gk, gv, o, lse, dsum, dq, dkh,
             dvh, kr, vr)
    return errs


def _hold_attention_rows(name, inputs, outs, dsum, kw, scores=2e9):
    """#5-#7's outputs ``outs`` = (o, lse, dq, dk, dv per q head) on
    ``inputs`` = (q, k, v, do), k and v at the q heads, against the
    plain versions, a few batch rows at a time (the plain versions hold
    float32 (rows, H, Sq, Skv) scores of at most ``scores`` bytes): o and
    lse to phase 9's limits and dq, dk / dv to phase 14's, o and dq equal
    to the plain output in bf16 in SAME_SHARE of each slice's entries.
    Returns the largest errors and the least shares."""
    from repro_torch.kernels import ref

    q = inputs[0]
    b, hq, sq, _ = q.shape
    skv = inputs[1].shape[2]
    step = max(1, int(scores // (hq * sq * skv * 4)))
    worst = {"o": 0.0, "rel": 0.0, "dq": 0.0, "kv": 0.0, "share_o": 1.0,
             "share_dq": 1.0}
    for r0 in range(0, b, step):
        cut = slice(r0, r0 + step)
        qs, ks, vs, dos = (t[cut] for t in inputs)
        o, lse, dq, dkh, dvh = (t[cut] for t in outs)
        tag = f"{name} rows {r0}:{min(b, r0 + step)}"
        w_o, w_lse = ref.flash_attention_ref(qs, ks, vs, **kw)
        e_o, rel = _close_or_raise(tag + " o", o, w_o, 1e-4, 2.0 ** -7)
        _close_or_raise(tag + " lse", lse, w_lse, 3e-5, 3e-5)
        share_o = _check_same_share(tag + " o", o, w_o)
        w_dq32 = ref.flash_attention_dq_ref(
            *(t.float() for t in (qs, ks, vs, dos)), lse, dsum[cut], **kw)
        w_dk, w_dv = ref.flash_attention_dkv_ref(qs, ks, vs, dos, lse,
                                                 dsum[cut], **kw)
        e_dq = _close_or_raise(tag + " dq", dq, w_dq32.to(q.dtype), 1e-4,
                               2.0 ** -7)[0]
        share_dq = _check_same_share(tag + " dq", dq, w_dq32)
        e_kv = max(_close_or_raise(tag + " dk", dkh, w_dk, 2e-4, 2e-5)[0],
                   _close_or_raise(tag + " dv", dvh, w_dv, 2e-4, 2e-5)[0])
        worst = {"o": max(worst["o"], e_o), "rel": max(worst["rel"], rel),
                 "dq": max(worst["dq"], e_dq), "kv": max(worst["kv"], e_kv),
                 "share_o": min(worst["share_o"], share_o),
                 "share_dq": min(worst["share_dq"], share_dq)}
        del w_o, w_lse, w_dq32, w_dk, w_dv
    return worst


def _hold_mesh_ssd(dev, label: str, rec: dict, groups: int = 4):
    """Phase 29 D: #8 and 8' at the cell's own local SSD problem, on
    fresh seeded inputs in bf16 (phase 10's operands), against their
    plain versions: ``ops.ssd`` forward and backward (the kernel call of
    the SSD's ``local_map``) equal the kernels' own y and gradients bit
    for bit; y and the final state to phase 10's limits, each gradient
    to phase 26's (its largest magnitude times 2^-7, d dt and d a_log
    1e-5).  The plain versions run on ``groups`` slices of the batch
    (the per-head gradients summed over them)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels.ref import ssd_scan_bwd_ref, ssd_scan_ref

    problems = rec["kernel_problems"].get("ssd", [])
    if len(problems) != 1:
        raise AssertionError(f"{label}: local SSD problems {problems}")
    bsz, length, h, p, g, n, chunk, _ = problems[0]
    gen = torch.Generator(device=dev).manual_seed(29)
    x, dt, a_log, b, c, ds = _ssd_inputs(gen, dev, length, h=h, p=p, g=g,
                                         n=n, batch=bsz)
    x, b, c = x.bfloat16(), b.bfloat16(), c.bfloat16()
    dy = torch.randn(x.shape, generator=gen, device=dev).bfloat16()
    name = (f"{label} SSD: B={bsz} L={length} H={h} P={p} G={g} N={n} "
            f"chunk={chunk} bf16")
    args = (x, dt, a_log, b, c, ds)
    leaves = [t.detach().requires_grad_() for t in args]
    y_path, _ = ops.ssd(*leaves, chunk=chunk)
    path_grads = torch.autograd.grad(y_path, leaves, dy)
    y, st = SS.ssd_scan(*args, chunk=chunk)
    got = SS.ssd_scan_bwd(*args, dy, chunk=chunk)
    torch.cuda.synchronize()
    casts = (x.dtype, None, None, b.dtype, c.dtype, None)
    if not torch.equal(y_path, y) or not all(
            torch.equal(pg, gv if dt_ is None else gv.to(dt_))
            for pg, gv, dt_ in zip(path_grads, got, casts)):
        raise AssertionError(f"{name}: ops.ssd's output or gradients "
                             f"differ from the kernels'")
    rows = -(-bsz // groups)
    w_y, w_st, want = [], [], None
    for r0 in range(0, bsz, rows):
        part = [t[r0:r0 + rows] for t in (x, dt)] + [a_log] + \
            [t[r0:r0 + rows] for t in (b, c)] + [ds]
        wy, wst = ssd_scan_ref(*part, chunk=chunk)
        w_y.append(wy)
        w_st.append(wst)
        wg = ssd_scan_bwd_ref(*part, dy[r0:r0 + rows], chunk=chunk)
        want = list(wg) if want is None else [
            None if a is None else
            (a + w if i in (2, 5) else torch.cat([a, w]))
            for i, (a, w) in enumerate(zip(want, wg))]
    w_y, w_st = torch.cat(w_y), torch.cat(w_st)
    e = _close_or_raise(name + " state", st, w_st, 3e-4, 3e-4)[0]
    ey, rel = _close_or_raise(name + " y", y, w_y, 3e-4, 2.0 ** -7)
    share = _check_same_share(name + " y", y, w_y)
    worst = []
    for leaf, gv, wv in zip(SSD_BWD_NAMES, got, want):
        if wv is None:
            continue
        scale = float(wv.abs().max())
        err = float((gv - wv).abs().max())
        limit = (SSD_BWD_CANCEL if leaf in ("ddt", "da_log")
                 else SSD_BWD_TOL[torch.bfloat16])
        if not (torch.isfinite(gv).all() and err <= limit * scale):
            raise AssertionError(f"{name} {leaf}: max abs err {err} "
                                 f"against {limit} x {scale}")
        worst.append(f"{leaf} {err / scale:.2e}")
    log(f"{name}: ops.ssd bit for bit the kernels' y and gradients; "
        f"against the plain versions: state max abs err {e:.3e}, y "
        f"{ey:.3e} (max rel {rel:.3e}, {share:.5f} equal in bf16); "
        f"gradients over each leaf's largest magnitude {', '.join(worst)}")


def check_mesh(dev, out: dict):
    """Phase 29 (see the module's docstring): A-F.  Puts the records of
    A-D and E's rows into ``out``; returns the phase's launches."""
    from repro_torch.configs import get_arch
    from repro_torch.fabric.planner import StepProfile, plan
    from repro_torch.kernels import mask_gemm as MG

    total = {}
    t0 = time.perf_counter()
    rec = _mesh_cell(dev, "smollm-135m", "phase 29 A smollm-135m train_4k "
                     "pod1", total)
    _check_dp_bytes("phase 29 A", rec, "smollm-135m", False)
    for kname in ("flash_attention_fwd", "flash_attention_dq",
                  "flash_attention_dkv"):
        if not rec["launches"].get(kname):
            raise AssertionError(f"phase 29 A: {kname} never launched")
    _hold_mesh_attention(dev, "phase 29 A", get_arch("smollm-135m"), rec)
    out["smollm"] = rec
    log(f"phase 29 A: {time.perf_counter() - t0:.1f} s")

    z = _mesh_cell(dev, "smollm-135m", "phase 29 B smollm-135m train_4k "
                   "pod1 zero1", total, zero1=True)
    _check_dp_bytes("phase 29 B", z, "smollm-135m", True)
    zc, pc = z["collective_bytes_per_device"], rec[
        "collective_bytes_per_device"]
    ratio = zc["total"] / pc["total"]
    dp_ratio = sum(z["dp_gradient_bytes"].values()) / sum(
        rec["dp_gradient_bytes"].values())
    log(f"phase 29 B: zero1 all-reduce {zc.get('all-reduce', 0):,} B, "
        f"reduce-scatter {zc.get('reduce-scatter', 0):,} B, all-gather "
        f"{zc.get('all-gather', 0):,} B; total {zc['total']:,} B against "
        f"{pc['total']:,} B without: ratio {ratio:.4f} (the reference's "
        f"docstring claims the bytes halve at scale; not a gate); the "
        f"gradient reduction alone {dp_ratio:.4f}")
    out["smollm_zero1"] = z
    log(f"phase 29 B: {time.perf_counter() - t0:.1f} s")

    h = _mesh_cell(dev, "h2o-danube-3-4b", "phase 29 C h2o-danube-3-4b "
                   "train_4k pod1", total)
    _check_dp_bytes("phase 29 C", h, "h2o-danube-3-4b", False)
    data_loss = h["collective_bytes_by_phase_axis"].get("loss/data", {})
    if not (data_loss.get("all-gather") and data_loss.get(
            "reduce-scatter")):
        raise AssertionError(f"phase 29 C: no fsdp weight all-gather or "
                             f"gradient reduce-scatter over data: "
                             f"{data_loss}")
    # rank 0 is the rank the step ran; ranks 5 and 15 read kv heads 2
    # and 7
    _hold_mesh_attention(dev, "phase 29 C", get_arch("h2o-danube-3-4b"), h,
                         ranks=(0, 5, 15))
    out["h2o"] = h
    log(f"phase 29 C: {time.perf_counter() - t0:.1f} s")

    m = _mesh_cell(dev, "mamba2-130m", "phase 29 D mamba2-130m train_4k "
                   "pod1", total)
    _check_dp_bytes("phase 29 D", m, "mamba2-130m", False)
    for kname in ("ssd_scan", "ssd_scan_bwd"):
        if not m["launches"].get(kname):
            raise AssertionError(f"phase 29 D: {kname} never launched")
    _hold_mesh_ssd(dev, "phase 29 D", m)
    out["mamba2"] = m
    log(f"phase 29 D: {time.perf_counter() - t0:.1f} s")

    MG.reset_launches()
    profile = StepProfile.from_dryrun(rec)
    rows = plan(profile, min_terminals=256, mesh_shape=(16, 16),
                axis_names=("data", "model"), device=dev)
    mg = dict(MG.LAUNCHES)
    for kname in ("frontier_step", "backward_step"):
        if not mg.get(kname):
            raise AssertionError(f"phase 29 E: {kname} never launched")
        total[kname] = total.get(kname, 0) + mg[kname]
    log(f"phase 29 E: plan(StepProfile.from_dryrun(A), min_terminals=256, "
        f"mesh (16, 16)) on the card, #3 / #4 launched "
        f"{mg['frontier_step']} / {mg['backward_step']} times; profile "
        f"{json.dumps(profile.bytes_by_kind)}")
    for r in rows[:5]:
        log(f"phase 29 E:   {json.dumps(r)}")
    out["plan"] = rows[:5]
    log(f"phase 29 E: {time.perf_counter() - t0:.1f} s")

    _check_remesh(dev)
    log(f"phase 29 F: {time.perf_counter() - t0:.1f} s")
    log(f"phase 29: launches {total}")
    return total


def _check_remesh(dev):
    """Phase 29 F: ``remesh`` over the one card's rank and a state's
    round trip through ``reshard_state``, bit for bit."""
    import torch.distributed as dist
    from repro_torch.train import largest_submesh_shape, remesh, \
        reshard_state

    gen = torch.Generator().manual_seed(29)
    state = {"w": torch.randn((64, 48), generator=gen),
             "opt": {"m": torch.randn((48,), generator=gen),
                     "count": np.int32(7)}}
    specs = {"w": ("model", None), "opt": {"m": ("data",), "count": ()}}
    try:
        mesh = remesh([0], model_axis=1, device_type="cuda")
        if tuple(mesh.shape) != largest_submesh_shape(1, 1) \
                or mesh.mesh_dim_names != ("data", "model"):
            raise AssertionError(f"phase 29 F: mesh {mesh}")
        placed = reshard_state(state, mesh, specs)
        back = {"w": placed["w"].full_tensor().cpu(),
                "m": placed["opt"]["m"].full_tensor().cpu(),
                "count": placed["opt"]["count"].full_tensor().cpu()}
        if placed["w"].to_local().device.type != "cuda":
            raise AssertionError("phase 29 F: the state is not on the card")
        if not (torch.equal(back["w"], state["w"])
                and torch.equal(back["m"], state["opt"]["m"])
                and int(back["count"]) == 7):
            raise AssertionError("phase 29 F: the round trip changed bits")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    log(f"phase 29 F: remesh([0], 1) -> {tuple(mesh.shape)} "
        f"{mesh.mesh_dim_names} on the card; reshard_state round trip bit "
        f"for bit")


# ---------------------------------------------------------------------------
# Phase 30: the MoE all-to-all dispatch and MLA under the production mesh
# ---------------------------------------------------------------------------

MOE_ARCH, MLA_ARCH = "granite-moe-3b-a800m", "deepseek-v3-671b"
# granite-moe's bins: 32 MoE layers x 6 all-to-alls (forward, remat
# recompute, backward; each both ways) of (48, 1024, 1536) bf16, 40
# experts padded to 48 on the 16-way model axis, C = ceil(4096 x 8 / 40
# x 1.25) for the 16 x 256 tokens a device
MOE_BINS_BYTES = 32 * 6 * 48 * 1024 * 1536 * 2
# deepseek-v3's depth in phase 30 D: None runs the config's 61 layers (3
# dense, 58 MoE); a number cuts it to the 3 dense layers and the rest MoE.
# 5 (2 MoE layers) keeps the whole script inside its time with phase 31:
# the 61-layer step took 35-40 s (PR 32's runs)
MLA_DEPTH = 5


def _bins_bytes(cfg, rec: dict) -> int:
    """The all-to-all bytes a device of a step's MoE layers: 6 exchanges
    a layer of the (E_pad, C, M) bf16 bins, t_loc the device's tokens."""
    from repro_torch.models.moe import capacity, expert_pad
    from repro_torch.models.transformer import layer_plan

    rows, seq = rec["per_device_batch"]
    t_loc = rows * seq // 16
    return (sum(layer_plan(cfg).has_moe) * 6
            * expert_pad(cfg.moe.n_experts, 16)
            * capacity(t_loc, cfg.moe) * cfg.d_model * 2)


def _dp_bytes(cfg) -> int:
    """The data-parallel gradient all-reduce a device on (16, 16): the
    gradients, in the parameters' dtype, of the local blocks not sharded
    over ``data``; a MoE's shared-expert norm, which the loss never
    reads (the reference carries it unused too), gets a zero gradient
    that nothing reduces."""
    from repro_torch.models import build
    from repro_torch.models.common import local_shape
    from repro_torch.models.model import param_shapes

    mesh = {"data": 16, "model": 16}
    specs = build(cfg).param_specs(mesh)
    total = 0
    for name, (shape, dt) in param_shapes(cfg).items():
        spec = specs[name]
        axes = [a for e in spec if e for a in ((e,) if isinstance(e, str)
                                               else e)]
        if "data" in axes or name.endswith("mlp.shared.norm"):
            continue
        total += int(np.prod(local_shape(shape, spec, mesh))) \
            * torch.empty((), dtype=dt).element_size()
    return total


def _check_moe_cell(label: str, cfg, rec: dict, want_bins=None):
    """A phase 30 cell's all-to-all bytes (all over ``model`` in the
    loss phase: the bins') against :func:`_bins_bytes` (and
    ``want_bins``), its data-parallel gradient bytes against
    :func:`_dp_bytes`, and #5-#7 launched."""
    coll = rec["collective_bytes_per_device"]
    bins = _bins_bytes(cfg, rec)
    a2a = coll.get("all-to-all", 0)
    at = {k: v.get("all-to-all", 0) for k, v in
          rec["collective_bytes_by_phase_axis"].items()
          if v.get("all-to-all")}
    log(f"{label}: all-to-all {a2a:,} B, by phase/axis {json.dumps(at)}; "
        f"the bins' {bins:,} B"
        f"{'' if want_bins is None else f' (expected {want_bins:,} B)'}")
    if a2a != bins or at != {"loss/model": bins} or (
            want_bins is not None and bins != want_bins):
        raise AssertionError(f"{label}: all-to-all bytes {at}, the bins' "
                             f"{bins}")
    dp = rec["dp_gradient_bytes"]
    want = _dp_bytes(cfg)
    log(f"{label}: data-parallel gradient bytes {json.dumps(dp)} "
        f"(expected all-reduce {want:,} B)")
    if dp != {"all-reduce": want}:
        raise AssertionError(f"{label}: data-parallel gradient bytes {dp} "
                             f"!= {want}")
    for kname in ("flash_attention_fwd", "flash_attention_dq",
                  "flash_attention_dkv"):
        if not rec["launches"].get(kname):
            raise AssertionError(f"{label}: {kname} never launched")


def _hold_moe_body(dev, label: str, cfg, rec: dict):
    """Phase 30 A: the all-to-all body's local arithmetic
    (``models.moe.a2a_body`` without its collectives: one device's
    tokens routed, slotted, scattered into the (E_pad, C, M) bins,
    through the experts and combined) at the cell's local shape on the
    card, against the same steps on the CPU in float64 from the card's
    picks: slots, kept picks and bins exactly (the reference's cumulative
    count over the one-hot too), the experts' output and the combined
    output within one bf16 rounding of each leaf's largest magnitude
    (2^-8 and 2^-7), with ``bf16_experts`` off and on; the float64 side
    rounds where the function does (bf16 operands and ``silu(g) * u``
    under the flag)."""
    import torch.nn.functional as F
    from repro_torch.models import moe as M

    moe = cfg.moe
    rows, seq = rec["per_device_batch"]
    t, m, f, e = rows * seq // 16, cfg.d_model, moe.d_ff_expert, \
        moe.n_experts
    e_pad, cap = M.expert_pad(e, 16), M.capacity(rows * seq // 16, moe)
    gen = torch.Generator(device=dev).manual_seed(30)
    # every token shares a component u that the router turns into some
    # +2 on the first 4 experts' logits, so their bins overflow and picks
    # drop, as a skewed router drops them
    u = torch.randn((m,), generator=gen, device=dev)
    x = (torch.randn((t, m), generator=gen, device=dev) + u).bfloat16()
    router = torch.randn((m, e), generator=gen, device=dev) * m ** -0.5
    router[:, :4] += (2.0 * u / u.dot(u))[:, None]
    ws = [torch.randn(shape, generator=gen, device=dev) * fan ** -0.5
          for shape, fan in (((e, m, f), m), ((e, m, f), m), ((e, f, m), f))]
    ex = M.Exchange()
    wg, wu, wd = (ex.weights(w, dim, e_pad) for w, dim in zip(ws, (2, 2, 1)))
    _, top_w, top_idx = M.router_topk(cfg, x @ router.to(x.dtype))
    slot, keep = M.slot_rule(top_idx, e_pad, cap)
    bins, index = M.dispatch(x, top_idx, slot, keep, e_pad, cap)
    idx_c, w_c = top_idx.cpu(), top_w.double().cpu()
    slot_c, keep_c = M.slot_rule(idx_c, e_pad, cap)
    flat = idx_c.reshape(-1)
    onehot = F.one_hot(flat, e_pad)
    cum = ((torch.cumsum(onehot, 0) * onehot - 1) * onehot).sum(-1)
    bins_c, index_c = M.dispatch(x.cpu().double(), idx_c, slot_c, keep_c,
                                 e_pad, cap)
    if not (torch.equal(slot.cpu(), slot_c) and torch.equal(slot_c, cum)
            and torch.equal(keep.cpu(), keep_c)
            and torch.equal(index.cpu(), index_c)
            and torch.equal(bins.cpu().double(), bins_c)):
        raise AssertionError(f"{label} a2a body: slots, kept picks or bins "
                             f"differ from the CPU's")
    dropped = int((~keep_c).sum())
    wc = [w.cpu().double() for w in (wg, wu, wd)]
    errs = {}
    for on in (False, True):
        with perf_flags(bf16_experts=on):
            y = M.expert_mlp(bins, wg, wu, wd)
            out = M.combine(y.to(x.dtype), index, top_w, keep)
        rnd = (lambda t_: t_.to(torch.bfloat16).double()) if on else \
            (lambda t_: t_)
        xb, g_, u_, d_ = rnd(bins_c), rnd(wc[0]), rnd(wc[1]), rnd(wc[2])
        h = F.silu(torch.bmm(xb, g_)) * torch.bmm(xb, u_)
        y64 = torch.bmm(rnd(h), d_)
        flat64 = torch.cat([y64.reshape(-1, m), y64.new_zeros((1, m))])
        out64 = (flat64[index_c].view(t, moe.top_k, m)
                 * (w_c * keep_c.view(t, -1))[..., None]).sum(1)
        tag = f"{label} a2a body bf16_experts={int(on)}"
        errs[on] = (_share_of_max(tag + " experts", y.cpu(), y64, 2.0 ** -8),
                    _share_of_max(tag + " out", out.cpu(), out64,
                                  2.0 ** -7))
        del y, out, h, y64, flat64, out64
    log(f"{label} a2a body at t_loc {t}, E_pad {e_pad}, C {cap}, M {m}, F "
        f"{f}: slots, {int(keep_c.sum())} kept picks ({dropped} dropped) "
        f"and bins equal the CPU's (and the reference's cumulative count); "
        f"experts' output / combined output within "
        f"{errs[False][0]:.2e} / {errs[False][1]:.2e} of their largest "
        f"magnitude (bf16_experts off), {errs[True][0]:.2e} / "
        f"{errs[True][1]:.2e} (on)")
    return {"dropped": dropped, "errs": {str(k): v for k, v in errs.items()}}


def _hold_mesh_mla(dev, label: str, cfg, rec: dict):
    """Phase 30 D: #5-#7 at the cell's local MLA problem (the record's
    ``kernel_problems["mla"]``) on fresh seeded bf16 inputs:
    ``models.layers.mla_block`` (the kernel call of
    ``local_mla_attention``: k_nope beside the shared rotated key, q/k
    and v padded to 256) forward and backward gives the kernels' o, dq,
    dk and dv on the padded heads cut back, bit for bit, and the shared
    key's gradient their sum over the heads within one bf16 rounding;
    the kernels' outputs against the plain versions to phases 9 and
    14's limits (:func:`_hold_attention_rows`)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.layers import mla_block

    problems = rec["kernel_problems"].get("mla", [])
    if len(problems) != 1:
        raise AssertionError(f"{label}: local MLA problems {problems}")
    b, h, sq, _, dqk, dv, calls = problems[0]
    nope = cfg.mla.qk_nope
    gen = torch.Generator(device=dev).manual_seed(30)
    rnd = lambda *shape: torch.randn(shape, generator=gen,
                                     device=dev).bfloat16()
    q, kv, krl, do = (rnd(b, h, sq, dqk), rnd(b, h, sq, nope + dv),
                      rnd(b, 1, sq, dqk - nope), rnd(b, h, sq, dv))
    scale = dqk ** -0.5
    leaves = [t.detach().requires_grad_() for t in (q, kv, krl)]
    out = mla_block(*leaves, nope=nope, scale=scale)
    gq, gkv, gkr = torch.autograd.grad(out, leaves, do)
    k = torch.cat([kv[..., :nope], krl.expand(b, h, sq, -1)], dim=-1)
    pad = lambda t: torch.nn.functional.pad(t, (0, 256 - t.shape[-1]))
    qp, kp, vp, dop = pad(q), pad(k), pad(kv[..., nope:]), pad(do)
    kw = dict(causal=True, window=None, q_offset=0, scale=scale)
    o, lse = FA.flash_attention(qp, kp, vp, **kw)
    dsum = (dop[..., :dv].float() * o[..., :dv].float()).sum(-1,
                                                             keepdim=True)
    bargs = (qp, kp, vp, dop, lse, dsum)
    dq = FA.flash_attention_dq(*bargs, **kw)
    dkh, dvh = FA.flash_attention_dkv(*bargs, **kw)
    torch.cuda.synchronize()
    name = (f"{label} MLA: B={b} H={h} of {cfg.n_heads} S={sq} q/k {dqk} "
            f"v {dv} padded to 256, {calls} calls booked")
    if not (torch.equal(out, o[..., :dv]) and torch.equal(gq, dq[..., :dqk])
            and torch.equal(gkv[..., :nope],
                            dkh[..., :nope].to(kv.dtype))
            and torch.equal(gkv[..., nope:], dvh[..., :dv].to(kv.dtype))):
        raise AssertionError(f"{name}: mla_block's output or gradients "
                             f"differ from the kernels'")
    e_kr = _share_of_max(name + " shared key gradient", gkr,
                         dkh[..., nope:dqk].to(kv.dtype).float()
                         .sum(1, keepdim=True), 2.0 ** -7)
    errs = _hold_attention_rows(name, (qp, kp, vp, dop),
                                (o, lse, dq, dkh, dvh), dsum, kw)
    log(f"{name}: mla_block bit for bit the kernels' o, dq, dk, dv cut "
        f"back, the shared key's gradient within {e_kr:.2e} of the heads' "
        f"sum; against the plain versions: o max abs err {errs['o']:.3e} "
        f"(max rel {errs['rel']:.3e}, {errs['share_o']:.5f} equal in bf16), "
        f"dq {errs['dq']:.3e} ({errs['share_dq']:.5f} equal in bf16), dk / "
        f"dv {errs['kv']:.3e}")
    return errs


def _cell_line(rec: dict) -> dict:
    """The numbers of a phase 30 cell that PERF.md keeps."""
    mem = rec["memory"]
    return {"collective_bytes_per_device": rec["collective_bytes_per_device"],
            "collective_bytes_by_phase_axis":
                rec["collective_bytes_by_phase_axis"],
            "dp_gradient_bytes": rec["dp_gradient_bytes"],
            "flops": rec["flops"], "aten_flops": rec["aten_flops"],
            "kernel_flops": rec["kernel_flops"],
            "kernel_padding_flops": rec["kernel_padding_flops"],
            "state_bytes": mem["argument_bytes"],
            "peak_above_state_bytes": mem["peak_bytes"],
            "peak_parts": mem.get("peak_parts"),
            "step_seconds": rec["step_seconds"], "launches": rec["launches"]}


def check_moe_mesh(dev, out: dict):
    """Phase 30 (see the module's docstring): A-E.  Puts each cell's
    numbers and E's rows into ``out``; returns the phase's launches."""
    from repro_torch.configs import get_arch
    from repro_torch.fabric.planner import StepProfile, plan
    from repro_torch.kernels import mask_gemm as MG

    total = {}
    t0 = time.perf_counter()
    g = get_arch(MOE_ARCH)
    # B first: the phase's first step runs its DTensor and cuBLAS calls
    # cold, and C's time is held against A's
    b2 = _mesh_cell(dev, MOE_ARCH, f"phase 30 B {MOE_ARCH} train_4k pod1 "
                    f"(moe_3d=0)", total, moe_3d=False)
    _check_moe_cell("phase 30 B", g, b2, MOE_BINS_BYTES)
    log(f"phase 30 B: {time.perf_counter() - t0:.1f} s")

    a = _mesh_cell(dev, MOE_ARCH, f"phase 30 A {MOE_ARCH} train_4k pod1 "
                   f"(moe_3d)", total)
    _check_moe_cell("phase 30 A", g, a, MOE_BINS_BYTES)
    _hold_mesh_attention(dev, "phase 30 A", g, a)
    out["body"] = _hold_moe_body(dev, "phase 30 A", g, a)
    out["A"] = _cell_line(a)
    ca, cb = a["collective_bytes_per_device"], b2[
        "collective_bytes_per_device"]
    extra = {k: cb.get(k, 0) - ca.get(k, 0) for k in set(ca) | set(cb)}
    log(f"phase 30 B: the 2D dispatch's re-layout bytes beside A's, by "
        f"kind {json.dumps(extra)} (the bins' all-to-all "
        f"{cb['all-to-all']:,} B in both)")
    out["B"] = _cell_line(b2)
    log(f"phase 30 A: {time.perf_counter() - t0:.1f} s")

    c = _mesh_cell(dev, MOE_ARCH, f"phase 30 C {MOE_ARCH} train_4k pod1 "
                   f"(bf16_experts)", total, bf16_experts=True)
    _check_moe_cell("phase 30 C", g, c, MOE_BINS_BYTES)
    if c["collective_bytes_per_device"] != ca or c["flops"] != a["flops"]:
        raise AssertionError(f"phase 30 C: bytes or FLOPs differ from A's: "
                             f"{c['collective_bytes_per_device']}, "
                             f"{c['flops']} against {ca}, {a['flops']}")
    log(f"phase 30 C: bytes and FLOPs equal A's; bf16_experts step "
        f"{c['step_seconds']:.2f} s against A's {a['step_seconds']:.2f} s; "
        f"peak above the state {c['memory']['peak_bytes'] / 2**30:.3f} GiB "
        f"against {a['memory']['peak_bytes'] / 2**30:.3f}")
    out["C"] = _cell_line(c)
    log(f"phase 30 C: {time.perf_counter() - t0:.1f} s")

    ds = get_arch(MLA_ARCH)
    cut = ds if MLA_DEPTH is None else ds.replace(n_layers=MLA_DEPTH)
    reason = "" if MLA_DEPTH is None else \
        " (cut: the whole script stays inside its time with phase 31)"
    log(f"phase 30 D: {MLA_ARCH} at {cut.n_layers} of {ds.n_layers} layers"
        f"{reason}")
    d = _mesh_cell(dev, MLA_ARCH, f"phase 30 D {MLA_ARCH} train_4k pod1, "
                   f"{cut.n_layers} layers", total, cfg=cut)
    _check_moe_cell("phase 30 D", cut, d,
                    58 * 6 * 256 * 160 * 7168 * 2 if MLA_DEPTH is None
                    else None)
    out["D_mla"] = _hold_mesh_mla(dev, "phase 30 D", cut, d)
    out["D"] = {**_cell_line(d), "n_layers": cut.n_layers}
    log(f"phase 30 D: {time.perf_counter() - t0:.1f} s")

    MG.reset_launches()
    profile = StepProfile.from_dryrun(a)
    rows = plan(profile, min_terminals=256, mesh_shape=(16, 16),
                axis_names=("data", "model"), device=dev)
    mg = dict(MG.LAUNCHES)
    for kname in ("frontier_step", "backward_step"):
        if not mg.get(kname):
            raise AssertionError(f"phase 30 E: {kname} never launched")
        total[kname] = total.get(kname, 0) + mg[kname]
    log(f"phase 30 E: plan(StepProfile.from_dryrun(A), min_terminals=256, "
        f"mesh (16, 16)) on the card, #3 / #4 launched "
        f"{mg['frontier_step']} / {mg['backward_step']} times; profile "
        f"{json.dumps(profile.bytes_by_kind)}")
    for r in rows[:5]:
        log(f"phase 30 E:   {json.dumps(r)}")
    out["plan"] = rows[:5]
    log(f"phase 30 E: {time.perf_counter() - t0:.1f} s")
    log(f"phase 30: launches {total}")
    return total


# ---------------------------------------------------------------------------
# Phase 31: the RG-LRU and the memory-input families under the production
# mesh
# ---------------------------------------------------------------------------

# llama-3.2-vision-90b's depth in phase 31 B: None runs the config's 100
# layers (20 of them cross layers); a number cuts it, the pattern kept.
# 10 (2 cross layers, as phase 24 serves it) pays, with the profiles left
# out of phases 23, 24 and 28, for phase 33 (the 100-layer cell took
# about half of phase 31's time)
VISION_DEPTH = 10
# seamless-m4t-large-v2's microbatches in phase 31 C: its 256,206-token
# vocabulary does not divide the 16-way model axis, so its float32 logits
# sit whole on every device, as in the reference's specs: (16, 4096,
# 256206) at the cell's 16 rows, 67.2 GB, and as much again for their
# gradient; under microbatch=4 a microbatch holds 4 rows a device, and
# the uncut cell (global batch 256) fits one card
AUDIO_MB = 4


def _check_memory_cell(label: str, cfg, rec: dict, n_mem: int):
    """A phase 31 cell: its data-parallel gradient bytes against
    :func:`_dp_bytes` (every 0-d cross gate among them), the memory its
    batch carried, #5-#7 launched; its local attention problems, each
    with its calls, returned."""
    dp = rec["dp_gradient_bytes"]
    want = _dp_bytes(cfg)
    log(f"{label}: data-parallel gradient bytes {json.dumps(dp)} "
        f"(expected all-reduce {want:,} B); memory tokens a row "
        f"{rec['memory_tokens']} (expected {n_mem})")
    if dp != {"all-reduce": want} or rec["memory_tokens"] != n_mem:
        raise AssertionError(f"{label}: data-parallel gradient bytes {dp} "
                             f"!= {want}, or memory {rec['memory_tokens']}")
    for kname in ("flash_attention_fwd", "flash_attention_dq",
                  "flash_attention_dkv"):
        if not rec["launches"].get(kname):
            raise AssertionError(f"{label}: {kname} never launched")
    problems = [(tuple(p[:-1]), p[-1])
                for p in rec["kernel_problems"]["attention"]]
    log(f"{label}: local attention problems (B, Hq, Hkv, Sq, Skv, D, "
        f"window, causal) and calls {problems}")
    return problems


# the local bytes a device of seamless's microbatched cell: the split's
# all-to-all over "data" (each rank's 16 rows of 4096 int32 tokens and of
# 1024 x 1024 bf16 frames), and the loss phase of the cell at 4 rows a
# device (a global batch of 64), which each of the 4 microbatches repeats
AUDIO_SPLIT_BYTES = 16 * 4096 * 4 + 16 * 1024 * 1024 * 2
AUDIO_LOSS_BYTES = {"loss/model": 14_914_945_024, "loss/data": 4}


def _check_audio_microbatches(label: str, rec: dict):
    """Phase 31 C's microbatched cell: 4 microbatches of 4 rows a device,
    the split's all-to-all exactly ``AUDIO_SPLIT_BYTES``, each loss-phase
    axis exactly ``AUDIO_MB`` times the 4-row cell's, #5-#7 ``AUDIO_MB``
    times its 144 / 72 / 72 launches."""
    by = rec["collective_bytes_by_phase_axis"]
    split = by.get("split/data", {})
    want_launch = {"flash_attention_fwd": 144 * AUDIO_MB,
                   "flash_attention_dq": 72 * AUDIO_MB,
                   "flash_attention_dkv": 72 * AUDIO_MB}
    log(f"{label}: microbatch {rec['microbatch']}, rows a device "
        f"{rec['per_device_batch']}; split {json.dumps(split)} (expected "
        f"all-to-all {AUDIO_SPLIT_BYTES:,} B); loss/model "
        f"{by['loss/model']} (expected {AUDIO_MB} x "
        f"{AUDIO_LOSS_BYTES['loss/model']:,} B)")
    if rec["microbatch"] != AUDIO_MB or rec["per_device_batch"] != [4, 4096] \
            or split != {"all-to-all": AUDIO_SPLIT_BYTES}:
        raise AssertionError(f"{label}: microbatches {rec['microbatch']}, "
                             f"rows {rec['per_device_batch']}, split {split}")
    for key, b in AUDIO_LOSS_BYTES.items():
        if by[key] != {"all-reduce": AUDIO_MB * b}:
            raise AssertionError(f"{label}: {key} {by[key]} != {AUDIO_MB} x "
                                 f"{b}")
    if rec["launches"] != want_launch:
        raise AssertionError(f"{label}: launches {rec['launches']} != "
                             f"{want_launch}")


def check_memory_mesh(dev, out: dict):
    """Phase 31 (see the module's docstring): A-D.  Puts each cell's
    numbers, its kernel holds and D's rows into ``out``; returns the
    phase's launches."""
    from repro_torch.configs import get_arch
    from repro_torch.fabric.planner import StepProfile, plan
    from repro_torch.kernels import mask_gemm as MG

    total = {}
    t0 = time.perf_counter()
    vision = get_arch(VISION_ARCH)
    if VISION_DEPTH is not None:
        vision = vision.replace(n_layers=VISION_DEPTH)
        log(f"phase 31 B: {VISION_ARCH} cut to {VISION_DEPTH} of 100 "
            f"layers")
    cells = (("A", RGEMMA_ARCH, get_arch(RGEMMA_ARCH), None, 0),
             ("B", VISION_ARCH, vision, None,
              vision.vision.n_image_tokens),
             ("C", ENC_ARCH, get_arch(ENC_ARCH), {"microbatch": AUDIO_MB},
              4096 // 4))
    recs = {}
    for key, arch, cfg, flag_kw, n_mem in cells:
        label = f"phase 31 {key}"
        rows = "" if not flag_kw else \
            f", microbatch={AUDIO_MB} (16 rows a device in {AUDIO_MB} " \
            f"microbatches)"
        enc = "" if cfg.encoder is None else \
            f" and {cfg.encoder.n_layers} encoder layers"
        rec = _mesh_cell(dev, arch, f"{label} {arch} train_4k pod1, "
                         f"{cfg.n_layers} layers{enc}{rows}", total,
                         cfg=cfg if cfg.n_layers != get_arch(arch).n_layers
                         else None, **(flag_kw or {}))
        if flag_kw:
            _check_audio_microbatches(label, rec)
        holds = []
        for problem, calls in _check_memory_cell(label, cfg, rec, n_mem):
            errs = _hold_mesh_attention(dev, label, cfg, rec,
                                        problem=problem)
            holds.append({"problem": list(problem), "calls": calls,
                          "errs": errs})
        recs[key] = rec
        out[key] = {**_cell_line(rec), "n_layers": cfg.n_layers,
                    "per_device_batch": rec["per_device_batch"],
                    "kernel_problems": rec["kernel_problems"],
                    "holds": holds}
        log(f"{label}: {time.perf_counter() - t0:.1f} s")

    for key, rec in recs.items():
        MG.reset_launches()
        profile = StepProfile.from_dryrun(rec)
        rows = plan(profile, min_terminals=256, mesh_shape=(16, 16),
                    axis_names=("data", "model"), device=dev)
        mg = dict(MG.LAUNCHES)
        for kname in ("frontier_step", "backward_step"):
            if not mg.get(kname):
                raise AssertionError(f"phase 31 D: {kname} never launched")
            total[kname] = total.get(kname, 0) + mg[kname]
        log(f"phase 31 D: plan(StepProfile.from_dryrun({key}), "
            f"min_terminals=256, mesh (16, 16)) on the card, #3 / #4 "
            f"launched {mg['frontier_step']} / {mg['backward_step']} times; "
            f"profile {json.dumps(profile.bytes_by_kind)}")
        for r in rows[:3]:
            log(f"phase 31 D {key}:   {json.dumps(r)}")
        out[f"plan_{key}"] = rows[:3]
    log(f"phase 31 D: {time.perf_counter() - t0:.1f} s")
    log(f"phase 31: launches {total}")
    return total


# ---------------------------------------------------------------------------
# Phase 32: serving on the production mesh
# ---------------------------------------------------------------------------

SERVE_MESH_ARCHS = ("smollm-135m", "h2o-danube-3-4b", "mamba2-130m",
                    RGEMMA_ARCH)
# the k and v bytes of rank 0's decode cache, the reckoning of PERF.md
# section 4: layers x 2 x rows x kv heads (replicated: none divides 16)
# x min(seq_len, window) slots x head x 2 B
DECODE_KV_BYTES = {
    ("smollm-135m", "decode_32k"): 30 * 2 * 8 * 3 * 32768 * 64 * 2,
    ("h2o-danube-3-4b", "decode_32k"): 24 * 2 * 8 * 8 * 4096 * 120 * 2,
    ("h2o-danube-3-4b", "long_500k"): 24 * 2 * 1 * 8 * 4096 * 120 * 2,
    ("mamba2-130m", "decode_32k"): 0, ("mamba2-130m", "long_500k"): 0,
    (RGEMMA_ARCH, "decode_32k"): 12 * 2 * 8 * 1 * 2048 * 256 * 2,
    (RGEMMA_ARCH, "long_500k"): 12 * 2 * 1 * 1 * 2048 * 256 * 2}
# the sequence at which phase 32 A holds #5 against its plain versions:
# the cells' 32,768 would take (2, 9, 32768, 32768) float32 scores (77
# GB) in the plain versions; 8,192 is past h2o's window of 4,096 and
# recurrentgemma's of 2,048
SERVE_HOLD_SEQ = 8192


def _serve_cell(dev, arch: str, shape_name: str, label: str, total: dict,
                *, cfg=None, shape=None):
    """One serve cell of phases 32 and 33 on ``pod1`` at full width (and
    depth, unless ``cfg`` cuts it; ``shape`` cuts the shape's rows or
    sequence): its record, checked for consistency (the collectives'
    bytes by kind, by phase and axis and one by one add up, every one
    under the cell's phase; FLOPs the aten ops' plus the kernels'; the
    peak's parts add up and stay under 80 GB), its launches added to
    ``total``, its numbers logged."""
    from repro_torch.launch.dryrun import lower_cell

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = lower_cell(arch, shape_name, False, dev, cfg=cfg, shape=shape)
    wall = time.perf_counter() - t0
    if rec["status"] != "ok":
        raise AssertionError(f"{label}: {rec}")
    kind = "prefill" if shape_name == "prefill_32k" else "decode"
    coll = rec["collective_bytes_per_device"]
    by = rec["collective_bytes_by_phase_axis"]
    kinds = sum(v for k, v in coll.items() if k != "total")
    phased = sum(sum(row.values()) for row in by.values())
    listed = sum(r["bytes"] * r["count"] for r in rec["collectives"])
    if not (coll["total"] == kinds == phased == listed) or any(
            not at.startswith(f"{kind}/") for at in by):
        raise AssertionError(f"{label}: collective bytes {coll} by phase "
                             f"and axis {by}, listed {listed}")
    if rec["flops"] != rec["aten_flops"] + rec["kernel_flops"] \
            or rec["flops"] <= 0:
        raise AssertionError(f"{label}: FLOPs {rec['flops']}")
    mem = rec["memory"]
    parts = mem["peak_parts"]
    if parts["rest"] < 0 or mem["peak_bytes"] + mem["argument_bytes"] \
            > PEAK_LIMIT:
        raise AssertionError(f"{label}: memory {mem}")
    for kname, n in rec["launches"].items():
        total[kname] = total.get(kname, 0) + n
    log(f"{label}: collective bytes a device {json.dumps(coll)}; by "
        f"phase/axis {json.dumps(by)}")
    log(f"{label}: the largest collectives "
        f"{json.dumps(rec['collectives'][:6])}")
    log(f"{label}: {rec['collective_calls']} collectives; FLOPs "
        f"{rec['flops']:.4e} (aten {rec['aten_flops']:.4e}, kernels "
        f"{rec['kernel_flops']:.4e}; head padding adds "
        f"{rec['kernel_padding_flops']:.4e}); arguments "
        f"{mem['argument_bytes'] / 2**30:.3f} GiB, outputs "
        f"{mem['output_bytes'] / 2**30:.3f} GiB, peak "
        f"{mem['peak_bytes'] / 2**30:.3f} GiB above them (temp "
        f"{mem['temp_bytes'] / 2**30:.3f} GiB); step "
        f"{rec['step_seconds']:.3f} s, cell {wall:.2f} s; launches "
        f"{rec['launches']}; rows a device {rec['per_device_batch']}, "
        f"context {rec['context']}")
    log(f"{label}: peak parts, GiB: " + ", ".join(
        f"{k} {v / 2**30:.3f}" for k, v in parts.items())
        + f"; cache by leaf, B: {json.dumps(mem['cache_parts'])}")
    return rec


def _serve_engine_on_mesh(dev, smollm_serve: dict, total: dict) -> dict:
    """Phase 32 C: ``Engine(mesh=)`` on a (1, 1) mesh of the card (a
    one-rank NCCL group) serves phase 11's eight smollm-135m requests,
    the weights seeded as phase 11's and placed by their specs: every
    emitted token equals phase 11's meshless engine's and every
    request's prefill logits (``cache_slots`` 2,048, as the engine's)
    equal the meshless prefill's, bit for bit; #5 launches 30 times a
    request."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build, place_params
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_arch("smollm-135m")
    bundle = build(cfg)
    prompts = smollm_serve["prompts"]
    plain = bundle.init(0, dev)
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        model = place_params(bundle.init(0, dev), mesh)
        worst = 0
        for i, prompt in enumerate(prompts):
            tok = torch.as_tensor(prompt[None], device=dev).long()
            want, _ = bundle.prefill(plain, tok, cache_slots=SERVE["max_len"])
            got, _ = bundle.prefill(model, tok, cache_slots=SERVE["max_len"],
                                    mesh=mesh)
            got = got.full_tensor()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"phase 32 C: request {i}'s prefill logits on the mesh "
                    f"differ from the meshless ones by "
                    f"{float((got - want).abs().max())}")
            worst = max(worst, int(prompt.shape[0]))
        del plain
        eng = Engine(cfg, model, ServeConfig(max_batch=SERVE["max_batch"],
                                             max_len=SERVE["max_len"]),
                     device=dev, mesh=mesh)
        rids = [eng.submit(p, max_new=SERVE["max_new"]) for p in prompts]
        FA.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(FA.LAUNCHES)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    toks = [out[r] for r in rids]
    if toks != smollm_serve["tokens"]:
        bad = [i for i, (a, b) in enumerate(zip(toks, smollm_serve["tokens"]))
               if a != b]
        raise AssertionError(f"phase 32 C: requests {bad} emit other tokens "
                             f"on the mesh than phase 11's engine")
    want = {"flash_attention_fwd": 30 * len(prompts)}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"phase 32 C: launches {launches}, expected "
                             f"{want}")
    total["flash_attention_fwd"] = total.get("flash_attention_fwd", 0) + \
        want["flash_attention_fwd"]
    n_tok = sum(len(t) for t in toks)
    st = eng.stats
    log(f"phase 32 C: Engine(mesh=(1, 1) NCCL) served {len(toks)} "
        f"requests, {n_tok} tokens in {seconds:.3f} s ({n_tok / seconds:.1f} "
        f"tok/s; phase 11 meshless {smollm_serve['seconds']:.3f} s); prefill "
        f"{np.mean(st['prefill_ms']):.2f} ms a request, decode "
        f"{sum(st['decode_ms']) / sum(st['decode_steps']):.3f} ms a step "
        f"(phase 11 {smollm_serve['prefill_ms']:.2f} / "
        f"{smollm_serve['decode_ms']:.3f}); every token phase 11's and every "
        f"prefill logit the meshless prefill's, bit for bit; #5 launched "
        f"{launches['flash_attention_fwd']} times")
    return {"seconds": seconds, "tokens": n_tok,
            "prefill_ms": float(np.mean(st["prefill_ms"])),
            "decode_ms": sum(st["decode_ms"]) / sum(st["decode_steps"])}


def check_serve_mesh(dev, smollm_serve: dict, out: dict):
    """Phase 32 (see the module's docstring): A-D.  Puts each cell's
    numbers, C's and D's rows into ``out``; returns the phase's
    launches."""
    from repro_torch.configs import get_arch
    from repro_torch.fabric.planner import StepProfile, plan
    from repro_torch.kernels import mask_gemm as MG
    from repro_torch.launch.dryrun import reckon_cache_bytes

    total = {}
    t0 = time.perf_counter()
    for arch in SERVE_MESH_ARCHS:
        cfg = get_arch(arch)
        label = f"phase 32 A {arch} prefill_32k pod1"
        rec = _serve_cell(dev, arch, "prefill_32k", label, total)
        n_attn = sum(cfg.pattern[i % len(cfg.pattern)] == "attn"
                     for i in range(cfg.n_layers))
        want = ({"flash_attention_fwd": n_attn} if n_attn else
                {"ssd_scan": cfg.n_layers})
        if rec["launches"] != want:
            raise AssertionError(f"{label}: launches {rec['launches']}, "
                                 f"expected {want}")
        holds = {}
        if n_attn:
            problems = rec["kernel_problems"]["attention"]
            if len(problems) != 1 or problems[0][-1] != n_attn:
                raise AssertionError(f"{label}: local attention problems "
                                     f"{problems}, {n_attn} calls expected")
            problem = tuple(problems[0][:-1])
            cut = problem[:3] + (SERVE_HOLD_SEQ, SERVE_HOLD_SEQ) + problem[5:]
            log(f"{label}: #5 held at its local problem {problem} cut to "
                f"Sq = Skv = {SERVE_HOLD_SEQ}")
            holds["attention"] = _hold_mesh_attention(dev, label, cfg, rec,
                                                      problem=cut)
        else:
            _hold_mesh_ssd(dev, label, rec)
        out[f"{arch}/prefill_32k"] = {**_cell_line(rec), "holds": holds}
        log(f"{label}: {time.perf_counter() - t0:.1f} s")

    decode_recs = {}
    for arch in SERVE_MESH_ARCHS:
        cfg = get_arch(arch)
        for shape_name in ("decode_32k", "long_500k"):
            if shape_name == "long_500k" and not cfg.sub_quadratic:
                continue
            label = f"phase 32 B {arch} {shape_name} pod1"
            rec = _serve_cell(dev, arch, shape_name, label, total)
            rows, slots = rec["per_device_batch"][0], rec["context"]
            want = reckon_cache_bytes(cfg, rows, slots)
            got = rec["memory"]["cache_parts"]
            kv = got.get("k", 0) + got.get("v", 0)
            if got != want or kv != DECODE_KV_BYTES[(arch, shape_name)] \
                    or rec["launches"]:
                raise AssertionError(
                    f"{label}: cache bytes {got}, reckoned {want}, k + v "
                    f"{kv} against {DECODE_KV_BYTES[(arch, shape_name)]}; "
                    f"launches {rec['launches']}")
            log(f"{label}: cache bytes leaf by leaf the reckoning; k + v "
                f"{kv:,} B ({kv / 1e9:.2f} GB)")
            decode_recs[(arch, shape_name)] = rec
            out[f"{arch}/{shape_name}"] = _cell_line(rec)
    log(f"phase 32 B: {time.perf_counter() - t0:.1f} s")

    out["engine"] = _serve_engine_on_mesh(dev, smollm_serve, total)
    log(f"phase 32 C: {time.perf_counter() - t0:.1f} s")

    rec = decode_recs[("h2o-danube-3-4b", "decode_32k")]
    MG.reset_launches()
    profile = StepProfile.from_dryrun(rec)
    rows = plan(profile, min_terminals=256, mesh_shape=(16, 16),
                axis_names=("data", "model"), device=dev)
    mg = dict(MG.LAUNCHES)
    for kname in ("frontier_step", "backward_step"):
        if not mg.get(kname):
            raise AssertionError(f"phase 32 D: {kname} never launched")
        total[kname] = total.get(kname, 0) + mg[kname]
    log(f"phase 32 D: plan(StepProfile.from_dryrun(h2o decode_32k), "
        f"min_terminals=256, mesh (16, 16)) on the card, #3 / #4 launched "
        f"{mg['frontier_step']} / {mg['backward_step']} times; profile "
        f"{json.dumps(profile.bytes_by_kind)}")
    for r in rows[:3]:
        log(f"phase 32 D:   {json.dumps(r)}")
    out["plan"] = rows[:3]
    log(f"phase 32 D: {time.perf_counter() - t0:.1f} s")
    log(f"phase 32: launches {total}")
    return total


# ---------------------------------------------------------------------------
# Phase 33: serving the MoE / MLA and memory-input families on the
# production mesh
# ---------------------------------------------------------------------------

FAMILY_SERVE_ARCHS = (MOE_ARCH, MLA_ARCH, VISION_ARCH, ENC_ARCH)
# seamless-m4t-large-v2's prefill_32k cell in phase 33 A: its 256,206-token
# vocabulary does not divide the 16-way model axis, so its float32 logits
# sit whole on every device, 67.2 GB at the cell's 2 rows of 32,768
# tokens; 2 rows of 8,192 (2,048 frames) hold 16.8 GB
AUDIO_PREFILL_SEQ = 8192
# llama-3.2-vision-90b's cells in phase 33 run at VISION_LAYERS (10
# layers, 2 cross layers): at 100 layers rank 0's decode cache is 87.2
# GB, and its prefill at 100 took a fifth of phase 33's time (the cut
# pays for phase 34)
_MLA_LAYERS = MLA_DEPTH or 61
# the headline cache leaves of rank 0 (PERF.md section 4's reckoning):
# prefill 2 rows of 32,768 (seamless 8,192, its memory 2,048 frames),
# decode 8 rows; kv heads split over "model" only where 16 divides them
FAMILY_CACHE_BYTES = {
    (MOE_ARCH, "prefill_32k"): {"k+v": 32 * 2 * 2 * 8 * 32768 * 64 * 2},
    (MLA_ARCH, "prefill_32k"): {
        "ckv+krope": _MLA_LAYERS * 2 * 32768 * (512 + 64) * 2},
    (VISION_ARCH, "prefill_32k"): {
        "k+v": VISION_LAYERS * 4 // 5 * 2 * 2 * 8 * 32768 * 128 * 2,
        "cross_k+cross_v": VISION_LAYERS // 5 * 2 * 2 * 8 * 1600 * 128 * 2},
    (ENC_ARCH, "prefill_32k"): {
        "k+v": 24 * 2 * 2 * 1 * 8192 * 64 * 2,
        "cross_k+cross_v": 24 * 2 * 2 * 1 * 2048 * 64 * 2,
        "enc_memory": 2 * 2048 * 1024 * 2},
    (MOE_ARCH, "decode_32k"): {"k+v": 17_179_869_184,
                               "kpos": 33_554_432},
    (MLA_ARCH, "decode_32k"): {
        "ckv+krope": _MLA_LAYERS * 8 * 32768 * (512 + 64) * 2},
    (VISION_ARCH, "decode_32k"): {
        "k+v": VISION_LAYERS * 4 // 5 * 2 * 8 * 8 * 32768 * 128 * 2,
        "cross_k+cross_v": VISION_LAYERS // 5 * 2 * 8 * 8 * 1600 * 128 * 2,
        "enc_memory": 8 * 1600 * 8192 * 2},
    (ENC_ARCH, "decode_32k"): {"k+v": 1_610_612_736, "kpos": 25_165_824,
                               "cross_k+cross_v": 402_653_184,
                               "enc_memory": 134_217_728}}
# the bins' all-to-all of a prefill_32k cell (PERF.md section 4): a MoE
# layer's two exchanges (there and back, forward only) of the (E_pad, C,
# M) bf16 bins, C = ceil(4096 x 8 / E x 1.25) for the 2 x 32,768 / 16
# tokens a device
FAMILY_BINS_BYTES = {
    MOE_ARCH: 32 * 2 * 48 * 1024 * 1536 * 2,
    MLA_ARCH: (_MLA_LAYERS - 3) * 2 * 256 * 160 * 7168 * 2}


def _family_cell_cfg(arch: str, shape_name: str):
    """``(cfg, shape, note)`` of a phase 33 cell: deepseek-v3 at
    MLA_DEPTH layers, vision at VISION_LAYERS, seamless's
    prefill at AUDIO_PREFILL_SEQ tokens a row (None: the published
    config or the named shape); the note names the cut."""
    from repro_torch.configs import ShapeConfig, get_arch

    cfg = get_arch(arch)
    shape, note = None, ""
    if arch == MLA_ARCH and MLA_DEPTH is not None:
        cfg, note = cfg.replace(n_layers=MLA_DEPTH), \
            f", cut to {MLA_DEPTH} of 61 layers"
    if arch == VISION_ARCH:
        cfg, note = cfg.replace(n_layers=VISION_LAYERS), \
            (f", cut to {VISION_LAYERS} of 100 layers" + (
                " (rank 0's cache at 100 is 87.2 GB)"
                if shape_name == "decode_32k" else ""))
    if arch == ENC_ARCH and shape_name == "prefill_32k":
        shape = ShapeConfig("prefill_32k", AUDIO_PREFILL_SEQ, 32, "prefill")
        note = (f", 2 rows of {AUDIO_PREFILL_SEQ} (its whole-vocabulary "
                f"float32 logits at 32,768 are 67.2 GB)")
    return cfg, shape, note


def _check_family_cell(label: str, cfg, rec: dict, key) -> dict:
    """A phase 33 cell against the reckonings: the cache's local bytes
    leaf by leaf exactly ``reckon_cache_bytes`` and its headline leaves
    FAMILY_CACHE_BYTES; #5's launches one per attention layer in a
    prefill (MLA's and a memory config's encoder, self and cross layers,
    :func:`_memory_launches`) and one per cross layer in decode; in a MoE
    prefill the bins' all-to-all exactly FAMILY_BINS_BYTES, all over
    ``model``; in a MoE decode no expert weight gathered and the bins'
    (E_local, C, M) float32 partial sums all-reduced over ``data`` twice
    a MoE layer.  Returns the cache's bytes by leaf."""
    from repro_torch.launch.dryrun import reckon_cache_bytes
    from repro_torch.models import layer_plan
    from repro_torch.models.moe import capacity

    arch, shape_name = key
    prefill = shape_name == "prefill_32k"
    rows, slots = rec["per_device_batch"][0], rec["context"]
    n_mem = rec["memory_tokens"]
    got = rec["memory"]["cache_parts"]
    want = reckon_cache_bytes(cfg, rows, slots, memory_len=n_mem)
    heads = {name: sum(got.get(part, 0) for part in name.split("+"))
             for name in FAMILY_CACHE_BYTES[key]}
    if got != want or heads != FAMILY_CACHE_BYTES[key]:
        raise AssertionError(f"{label}: cache bytes {got}, reckoned {want}; "
                             f"{heads} against {FAMILY_CACHE_BYTES[key]}")
    log(f"{label}: cache bytes leaf by leaf the reckoning; " + ", ".join(
        f"{k} {v:,} B ({v / 1e9:.3f} GB)" for k, v in heads.items()))
    n_self = sum(k in ("attn", "dec_xattn") for k in layer_plan(cfg).kinds)
    if cfg.encoder is not None or cfg.vision is not None:
        n_pre, n_dec = _memory_launches(cfg)
    else:
        n_pre, n_dec = n_self, 0
    n5 = n_pre if prefill else n_dec
    if rec["launches"] != ({"flash_attention_fwd": n5} if n5 else {}):
        raise AssertionError(f"{label}: launches {rec['launches']}, "
                             f"expected {n5} of #5")
    if cfg.moe is None:
        return heads
    coll = rec["collective_bytes_per_device"]
    by = rec["collective_bytes_by_phase_axis"]
    n_moe = sum(layer_plan(cfg).has_moe)
    if prefill:
        bins = FAMILY_BINS_BYTES[arch]
        a2a = {k: v["all-to-all"] for k, v in by.items()
               if v.get("all-to-all")}
        log(f"{label}: the bins' all-to-all {coll.get('all-to-all', 0):,} B "
            f"by phase/axis {json.dumps(a2a)} (expected {bins:,} B)")
        if coll.get("all-to-all") != bins or a2a != {"prefill/model": bins}:
            raise AssertionError(f"{label}: all-to-all {a2a}, expected "
                                 f"{bins}")
        return heads
    moe, m = cfg.moe, cfg.d_model
    e_loc = moe.n_experts // 16 if moe.n_experts % 16 == 0 else \
        moe.n_experts
    f_loc = moe.d_ff_expert // 16
    shape = f"f32[{e_loc},{capacity(128, moe)},{m}]"
    bins = [(r["at"], r["count"]) for r in rec["collectives"]
            if r["kind"] == "all-reduce" and r["shape"] == shape]
    gathers = [r for r in rec["collectives"] if r["kind"] == "all-gather"]
    experts = [r for r in gathers if re.search(
        rf",({m},{f_loc}|{f_loc},{m}|{m},{moe.d_ff_expert}|"
        rf"{moe.d_ff_expert},{m})\]$", r["shape"])]
    logits = [r for r in gathers
              if r["shape"] == f"f32[128,{moe.n_experts}]"]
    log(f"{label}: the bins' all-reduces {shape} {bins} (expected "
        f"decode/data x {2 * n_moe}); the router's logits all-gathered "
        f"{[(r['at'], r['count']) for r in logits]}; expert weights "
        f"gathered {len(experts)}")
    if bins != [("decode/data", 2 * n_moe)] or experts or \
            sum(r["count"] for r in logits) != n_moe:
        raise AssertionError(f"{label}: bins {bins}, expert weight gathers "
                             f"{experts}, logits {logits}")
    return heads


def _hold_family_kernels(dev, label: str, cfg, rec: dict) -> list:
    """Phase 33 A: #5-#7 at each of a prefill cell's local problems, cut
    to Sq (and a causal problem's Skv) of SERVE_HOLD_SEQ where longer
    (logged): an attention problem through ``attention_block``
    (:func:`_hold_mesh_attention`; the encoder's and the cross layers'
    non-causal), MLA's through ``mla_block`` at its heads padded to 256
    (:func:`_hold_mesh_mla`), to phases 9, 14 and 28's limits."""
    holds = []
    for family, problems in rec["kernel_problems"].items():
        for problem in problems:
            *problem, calls = problem
            if family == "mla":
                b, h, sq, skv, dqk, dv = problem
                cut = min(sq, SERVE_HOLD_SEQ)
                log(f"{label}: MLA held at its local problem {problem} cut "
                    f"to Sq = Skv = {cut}")
                errs = _hold_mesh_mla(dev, label, cfg, {"kernel_problems": {
                    "mla": [[b, h, cut, cut, dqk, dv, calls]]}})
                holds.append({"problem": problem, "cut": cut,
                              "calls": calls, "errs": errs})
                continue
            b, hq, hkv, sq, skv, d, window, causal = problem
            cut_q = min(sq, SERVE_HOLD_SEQ)
            cut_kv = cut_q if causal else skv
            log(f"{label}: #5 held at its local problem {problem} cut to "
                f"Sq = {cut_q}, Skv = {cut_kv}")
            errs = _hold_mesh_attention(
                dev, label, cfg, rec, problem=(b, hq, hkv, cut_q, cut_kv, d,
                                               window, causal))
            holds.append({"problem": problem, "cut": [cut_q, cut_kv],
                          "calls": calls, "errs": errs})
    return holds


def _family_engine_on_mesh(dev, mesh, arch: str, info: dict, total: dict,
                           memory=None) -> dict:
    """Phase 33 C: ``Engine(mesh=)`` on the one-rank mesh serves the
    requests of phase 23 (granite-moe-3b-a800m) or 24
    (seamless-m4t-large-v2, ``memory`` its 384 frames, the gates at 1.0),
    the weights seeded as there and placed by their specs: every request's
    prefill logits (``cache_slots`` 2,048, as the engine's) equal the
    meshless prefill's and every emitted token that phase's meshless
    engine's, bit for bit; #5's launches one a prefill's attention layer
    (and, with a memory, one a decode step's cross layer)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import build, layer_plan, place_params
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_arch(arch)
    bundle = build(cfg)
    prompts = info["prompts"]
    mem = None if memory is None else torch.as_tensor(memory, device=dev)

    def seeded():
        model = bundle.init(0, dev)
        if memory is not None:
            with torch.no_grad():
                for name, prm in model.named_parameters():
                    if name.endswith(".gate"):
                        prm.fill_(1.0)
        return model

    plain = seeded()
    model = place_params(seeded(), mesh)
    for i, prompt in enumerate(prompts):
        tok = torch.as_tensor(prompt[None], device=dev).long()
        want, _ = bundle.prefill(plain, tok, memory=mem,
                                 cache_slots=SERVE["max_len"])
        got, _ = bundle.prefill(model, tok, memory=mem,
                                cache_slots=SERVE["max_len"], mesh=mesh)
        got = got.full_tensor()
        if not torch.equal(got, want):
            raise AssertionError(
                f"phase 33 C {arch}: request {i}'s prefill logits on the "
                f"mesh differ from the meshless ones by "
                f"{float((got - want).abs().max())}")
        del want, got
    del plain
    torch.cuda.empty_cache()
    eng = Engine(cfg, model, ServeConfig(max_batch=SERVE["max_batch"],
                                         max_len=SERVE["max_len"]),
                 device=dev, mesh=mesh)
    rids = [eng.submit(p, max_new=SERVE["max_new"]) for p in prompts]
    FA.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run(memory=mem)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in FA.LAUNCHES.items() if v}
    toks = [out[r] for r in rids]
    if toks != info["tokens"]:
        bad = [i for i, (a, b) in enumerate(zip(toks, info["tokens"]))
               if a != b]
        raise AssertionError(f"phase 33 C {arch}: requests {bad} emit other "
                             f"tokens on the mesh than the meshless engine")
    if memory is not None:
        per_req, per_step = _memory_launches(cfg)
    else:
        per_req = sum(k == "attn" for k in layer_plan(cfg).kinds)
        per_step = 0
    n_batches = -(-len(prompts) // SERVE["max_batch"])
    n5 = per_req * len(prompts) + per_step * n_batches * (
        SERVE["max_new"] - 1)
    if launches != {"flash_attention_fwd": n5}:
        raise AssertionError(f"phase 33 C {arch}: launches {launches}, "
                             f"expected {n5} of #5")
    total["flash_attention_fwd"] = total.get("flash_attention_fwd", 0) + n5
    n_tok = sum(len(t) for t in toks)
    st = eng.stats
    row = {"seconds": seconds, "tokens": n_tok,
           "prefill_ms": float(np.mean(st["prefill_ms"])),
           "decode_ms": sum(st["decode_ms"]) / sum(st["decode_steps"])}
    log(f"phase 33 C: {arch} through Engine(mesh=(1, 1) NCCL): "
        f"{len(toks)} requests, {n_tok} tokens in {seconds:.3f} s (the "
        f"meshless engine {info['seconds']:.3f} s); prefill "
        f"{row['prefill_ms']:.2f} ms a request, decode "
        f"{row['decode_ms']:.3f} ms a step (meshless "
        f"{info['prefill_ms']:.2f} / {info['decode_ms']:.3f}); every token "
        f"and every prefill logit the meshless engine's, bit for bit; #5 "
        f"launched {n5} times ({per_req} a request"
        f"{f', {per_step} a decode step' if per_step else ''})")
    del model, eng
    torch.cuda.empty_cache()
    return row


def check_family_serve_mesh(dev, served: dict, out: dict):
    """Phase 33 (see the module's docstring): A-D.  Puts each cell's
    numbers, its kernel holds, C's and D's rows into ``out``; returns the
    phase's launches."""
    import torch.distributed as dist
    from repro_torch.fabric.planner import StepProfile, plan
    from repro_torch.kernels import mask_gemm as MG
    from repro_torch.launch.mesh import make_host_mesh

    total = {}
    t0 = time.perf_counter()
    recs = {}
    for shape_name, part in (("prefill_32k", "A"), ("decode_32k", "B")):
        for arch in FAMILY_SERVE_ARCHS:
            cfg, shape, note = _family_cell_cfg(arch, shape_name)
            label = f"phase 33 {part} {arch} {shape_name} pod1{note}"
            rec = _serve_cell(dev, arch, shape_name, label, total,
                              cfg=cfg, shape=shape)
            heads = _check_family_cell(label, cfg, rec, (arch, shape_name))
            holds = (_hold_family_kernels(dev, label, cfg, rec)
                     if part == "A" else [])
            recs[(arch, shape_name)] = rec
            out[f"{arch}/{shape_name}"] = {
                **_cell_line(rec), "n_layers": cfg.n_layers,
                "per_device_batch": rec["per_device_batch"],
                "memory_tokens": rec["memory_tokens"],
                "cache_parts": rec["memory"]["cache_parts"], "cache": heads,
                "kernel_problems": rec["kernel_problems"], "holds": holds}
            log(f"{label}: {time.perf_counter() - t0:.1f} s")
        log(f"phase 33 {part}: {time.perf_counter() - t0:.1f} s")

    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        out["engine"] = {
            MOE_ARCH: _family_engine_on_mesh(dev, mesh, MOE_ARCH,
                                             served["granite"], total),
            ENC_ARCH: _family_engine_on_mesh(
                dev, mesh, ENC_ARCH, served["seamless"], total,
                memory=served["seamless"]["memory"])}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    log(f"phase 33 C: {time.perf_counter() - t0:.1f} s")

    rec = recs[(MOE_ARCH, "prefill_32k")]
    MG.reset_launches()
    profile = StepProfile.from_dryrun(rec)
    rows = plan(profile, min_terminals=256, mesh_shape=(16, 16),
                axis_names=("data", "model"), device=dev)
    mg = dict(MG.LAUNCHES)
    for kname in ("frontier_step", "backward_step"):
        if not mg.get(kname):
            raise AssertionError(f"phase 33 D: {kname} never launched")
        total[kname] = total.get(kname, 0) + mg[kname]
    if not profile.bytes_by_kind.get("all-to-all"):
        raise AssertionError(f"phase 33 D: the profile carries no "
                             f"all-to-all: {profile.bytes_by_kind}")
    log(f"phase 33 D: plan(StepProfile.from_dryrun({MOE_ARCH} prefill_32k), "
        f"min_terminals=256, mesh (16, 16)) on the card, #3 / #4 launched "
        f"{mg['frontier_step']} / {mg['backward_step']} times; profile "
        f"{json.dumps(profile.bytes_by_kind)}")
    for r in rows[:3]:
        log(f"phase 33 D:   {json.dumps(r)}")
    out["plan"] = rows[:3]
    log(f"phase 33 D: {time.perf_counter() - t0:.1f} s")
    log(f"phase 33: launches {total}")
    return total


# ---------------------------------------------------------------------------
# Phase 34: the mesh step's microbatch flag and grad_compress
# ---------------------------------------------------------------------------

# phase 34 A's microbatches of smollm-135m's train_4k cell (16 rows a
# device: 8 a microbatch)
MESH_MB = 2
# phase 34 B: smollm-135m cut to 2 of its 30 layers (the leaves' local
# blocks are the cell's), and the compress route's gathers reckoned from
# its specs on (16, 16) before the run: each layer's w_gate and w_up
# (576, 1536) cut over the ff dim on "model" (96 columns a device: no
# contiguous run of the flat order) are all-gathered whole in float32;
# wq / wk / wv (heads that do not divide 16) and the norms are
# replicated, w_down (96 rows a device: 216 whole 256-blocks) and the
# embedding (3,072 rows: 6,912 blocks) are compressed in place
COMPRESS_DEPTH = 2
COMPRESS_GATHERED = {f"blocks.{i}.mlp.{w}": [576 * 1536 * 4]
                     for i in range(COMPRESS_DEPTH) for w in ("w_gate",
                                                              "w_up")}
# phase 34 B's two leaves held card against CPU: an in-place leaf's local
# block and a gathered leaf's whole gradient
COMPRESS_HOLD = {"blocks.0.mlp.w_down": (96, 576),
                 "blocks.0.mlp.w_up": (576, 1536)}


def _loss_rows(rec: dict, mb: int = 1) -> list:
    """A record's loss-phase collectives as (phase/axis, kind, bytes,
    count), sorted; with ``mb``, as ``mb`` microbatches would issue them:
    each ``mb`` times as often, at 1/mb of its bytes (a scalar's
    unchanged)."""
    return sorted((r["at"], r["kind"], r["bytes"] if r["shape"].endswith(
        "[]") else r["bytes"] // mb, r["count"] * mb)
        for r in rec["collectives"] if r["at"].startswith("loss/"))


def _check_microbatched_cell(label: str, one: dict, rec: dict, mb: int):
    """Phase 34 A: the microbatched cell against the plain one (phase 29
    A's record): the data-parallel bytes exact in both; the split's
    all-to-all over ``data`` exactly each rank's rows of int32 tokens;
    every loss-phase collective ``mb`` times as often at 1/mb of its
    bytes (the scalars' all-reduce over ``data`` ``mb`` times); the
    gradient and optimizer phases equal; #5-#7 ``mb`` times the plain
    step's launches."""
    _check_dp_bytes(label, rec, "smollm-135m", False)
    pa = one["collective_bytes_by_phase_axis"]
    pb = dict(rec["collective_bytes_by_phase_axis"])
    rows, seq = one["per_device_batch"]
    split = pb.pop("split/data", None)
    want_split = {"all-to-all": rows * seq * 4}
    log(f"{label}: split {split} (expected {want_split}); by phase/axis "
        f"against microbatch=1: " + ", ".join(
            f"{k} {pb.get(k)} / {pa.get(k)}" for k in sorted(set(pa) | set(
                pb))))
    if split != want_split or set(pa) != set(pb):
        raise AssertionError(f"{label}: split {split}, phases {sorted(pb)} "
                             f"against {sorted(pa)}")
    for key in pa:
        if key.startswith("loss/"):
            continue
        if pa[key] != pb[key]:
            raise AssertionError(f"{label}: {key} {pb[key]} != {pa[key]}")
    mine, scaled = _loss_rows(rec), _loss_rows(one, mb)
    if mine != scaled:
        raise AssertionError(f"{label}: loss-phase collectives {mine[:8]} "
                             f"... against microbatch=1's scaled "
                             f"{scaled[:8]} ...")
    want = {k: mb * n for k, n in one["launches"].items()}
    if rec["launches"] != want:
        raise AssertionError(f"{label}: launches {rec['launches']} != "
                             f"{want}")
    mem_a, mem_b = one["memory"], rec["memory"]
    log(f"{label}: peak {mem_b['peak_bytes'] / 2**30:.3f} GiB above the "
        f"state against {mem_a['peak_bytes'] / 2**30:.3f} at "
        f"microbatch=1; parts " + ", ".join(
            f"{k} {v / 2**30:.3f}" for k, v in mem_b["peak_parts"].items()
            if v is not None) + f"; step {rec['step_seconds']:.3f} s "
        f"against {one['step_seconds']:.3f} s")


def _compress_step(dev, total: dict) -> dict:
    """Phase 34 B (see the module's docstring): one mesh step of smollm
    cut to ``COMPRESS_DEPTH`` layers with ``grad_compress`` on a fake
    256-rank world; returns the compress phase's collectives."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.dryrun import (CollectiveCounter, _from_local,
                                           fake_world, local_train_state)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.common import local_shape, placements
    from repro_torch.models.model import param_shapes
    from repro_torch.optim import gather_bytes
    from repro_torch.train.train_step import (TrainStepConfig, batch_pspec,
                                              make_train_state_specs,
                                              make_train_step)

    cfg = get_arch("smollm-135m").replace(n_layers=COMPRESS_DEPTH)
    ts = TrainStepConfig(grad_compress=True)
    label = f"phase 34 B smollm-135m ({COMPRESS_DEPTH} layers) grad_compress"
    with fake_world(256):
        mesh = make_production_mesh(device_type="cuda")
        specs = make_train_state_specs(cfg, mesh, ts)
        state = local_train_state(cfg, mesh, specs, dev)
        shapes = param_shapes(cfg)
        state["ef"] = {n: _from_local(torch.zeros(
            local_shape(shape, specs["ef"][n], mesh), dtype=torch.float32,
            device=dev), mesh, specs["ef"][n], shape)
            for n, (shape, _) in shapes.items()}
        route = {n: gather_bytes(shape, placements(specs["params"][n], mesh),
                                 mesh) for n, (shape, _) in shapes.items()}
        route = {n: b for n, b in route.items() if b}
        if route != COMPRESS_GATHERED:
            raise AssertionError(f"{label}: gathered leaves {route} != the "
                                 f"reckoning {COMPRESS_GATHERED}")
        data = DataConfig(vocab=cfg.vocab, seq_len=4096, global_batch=256)
        local = torch.as_tensor(synthetic_batch(data, 0, slice(0, 16))
                                ["tokens"], device=dev)
        batch = {"tokens": _from_local(local, mesh, batch_pspec(mesh),
                                       (256, 4096))}
        step_fn = make_train_step(cfg, dev, ts, donate=True, mesh=mesh)
        FA.reset_launches()
        t0 = time.perf_counter()
        with CollectiveCounter(mesh) as counter:
            state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        for kname, n in FA.LAUNCHES.items():
            total[kname] = total.get(kname, 0) + n
        placed = all(
            tuple(state["ef"][n].placements) == tuple(p.placements)
            and state["ef"][n].to_local().shape == p.to_local().shape
            for n, p in state["params"].items())
        rows = [r for r in counter.table() if r["at"].startswith(
            "compress/")]
    booked = {}
    for r in rows:
        key = (r["at"], r["kind"])
        booked[key] = booked.get(key, 0) + r["bytes"] * r["count"]
    want = {("compress/model", "all-gather"):
            sum(sum(b) for b in COMPRESS_GATHERED.values())}
    log(f"{label}: step {step_s:.2f} s; every ef leaf at its parameter's "
        f"placements and local shape: {placed}; compress collectives "
        f"{json.dumps(rows)} (reckoned {want[('compress/model', 'all-gather')]:,}"
        f" B of all-gathers over model, {len(COMPRESS_GATHERED)} leaves)")
    if not placed or booked != want:
        raise AssertionError(f"{label}: ef placed {placed}; compress bytes "
                             f"{booked} != {want}")
    return {"step_seconds": step_s, "compress": rows}


def _hold_compress(label: str, dev):
    """Phase 34 B: the card's codes and scales of ``COMPRESS_HOLD``'s
    in-place block and gathered leaf, bit for bit the CPU's on the same
    seeded float32 input (the gathered one also cut back to rank 0's
    block), and its round trip's error."""
    from repro_torch.optim import compress, decompress

    gen = torch.Generator().manual_seed(34)
    for name, shape in COMPRESS_HOLD.items():
        x = torch.randn(shape, generator=gen) * 1e-2
        x[0, :256] = 0.0                  # an all-zero block: scale 1
        got = compress(x.to(dev))
        want = compress(x)
        same = all(torch.equal(g.cpu(), w) for g, w in zip(got[:2],
                                                           want[:2]))
        approx = decompress(*got, shape).cpu()
        if shape[1] == 1536:              # rank 0's 96 ff columns
            same &= torch.equal(approx[:, :96],
                                decompress(*want, shape)[:, :96])
        err = float((x - approx).abs().max())
        log(f"{label}: {name} {tuple(shape)}: codes and scales on the card "
            f"bit for bit the CPU's: {same}; round trip max abs err "
            f"{err:.3e}")
        if not same:
            raise AssertionError(f"{label}: {name}: the card's codes differ "
                                 f"from the CPU's")


def check_mesh_step(dev, smollm_rec: dict, out: dict):
    """Phase 34 (see the module's docstring): A, B.  ``smollm_rec``:
    phase 29 A's record (``microbatch=1``); returns the phase's
    launches."""
    total = {}
    t0 = time.perf_counter()
    rec = _mesh_cell(dev, "smollm-135m", f"phase 34 A smollm-135m train_4k "
                     f"pod1 microbatch={MESH_MB}", total, microbatch=MESH_MB)
    _check_microbatched_cell("phase 34 A", smollm_rec, rec, MESH_MB)
    from repro_torch.configs import get_arch
    _hold_mesh_attention(dev, "phase 34 A", get_arch("smollm-135m"), rec)
    out["A"] = _cell_line(rec)
    log(f"phase 34 A: {time.perf_counter() - t0:.1f} s")
    out["B"] = _compress_step(dev, total)
    _hold_compress("phase 34 B", dev)
    log(f"phase 34 B: {time.perf_counter() - t0:.1f} s")
    log(f"phase 34: launches {total}")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import extension

    card = card_line()
    name = torch.cuda.get_device_name(0)
    bw = hbm_bytes_per_s(name)
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul must stay off")
    t0 = time.perf_counter()
    extension()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")

    t_start = time.perf_counter()
    last = [t_start]

    def done(phases: str):
        now = time.perf_counter()
        log(f"[{now - t_start:7.1f} s] phases {phases} done "
            f"({now - last[0]:.1f} s)")
        last[0] = now

    errs, timing = check_kernels(dev, bw)
    mg_errs, mg_timing = check_mask_gemm(dev, bw)
    thetas, mg_launches = check_analytic(dev)
    pn64 = check_pn64(dev, {name: (mg_timing[name]["block_ms"],
                                   mg_timing[name]["block_launches"])
                            for name in ("frontier_step", "backward_step")})
    check_pn16(dev, thetas["pn16 uniform"])
    launches = check_pn27(dev, thetas["pn27 points"])
    done("2-8")
    errs["flash_attention_fwd"], timing["flash_attention_fwd"] = \
        check_flash(dev, bw)
    errs["ssd_scan"], timing["ssd_scan"] = check_ssd(dev, bw)
    smollm, launches["flash_attention_fwd"], smollm_serve = serve_arch(
        dev, "smollm-135m", "flash_attention_fwd")
    _, launches["ssd_scan"], _ = serve_arch(dev, "mamba2-130m", "ssd_scan")
    profile_serve(dev, smollm, "smollm-135m")
    del smollm
    done("9-13")
    bwd_errs, bwd_timing, fwd_train = check_flash_bwd(dev, bw)
    errs.update(bwd_errs)
    timing.update(bwd_timing)
    timing["flash_attention_fwd"].update(fwd_train)
    done("14")
    train_launches, _ = train_smollm(dev)
    for kname in bwd_errs:
        launches[kname] = train_launches[kname]
    done("15")
    # phases 16-34 run kernels #1-#4 (22, 25 and 28 #5-#7, 23 and 24 #5,
    # 26 #8, 27 all but #3 and #4, 29 #3-#8 and 8', 30 and 31 #3-#7, 32
    # #3-#5 and #8, 33 #3-#7, 34 #5-#7) on new paths: their
    # launches there go beside each kernel's main-path count; phase 26's
    # path is the SSD backward's main path
    phase_launches = {}
    ssd_bwd, perf, h256, mesh, moe_mesh, mem_mesh, serve_mesh = \
        {}, {}, {}, {}, {}, {}, {}
    served, family_mesh, mesh_step = {}, {}, {}
    for phase, fn in (("16", lambda: check_families(dev)),
                      ("17", lambda: check_faults_analytic(dev)),
                      ("18", lambda: check_faults_sim(
                          dev, thetas["pn27 points"])),
                      ("19", lambda: check_orbits(dev, pn64)),
                      ("20", lambda: check_adversary(dev)),
                      ("21", lambda: check_fabric(dev)),
                      ("22", lambda: check_obs(dev)),
                      ("23", lambda: check_archs(dev, bw, served)),
                      ("24", lambda: check_memory(dev, bw, served)),
                      ("25", lambda: check_train_archs(dev, bw)),
                      ("26", lambda: check_train_ssd(dev, bw, ssd_bwd)),
                      ("27", lambda: check_perf_flags(
                          dev, bw, ssd_bwd["first_loss"], perf)),
                      ("28", lambda: check_head256(dev, bw, h256)),
                      ("29", lambda: check_mesh(dev, mesh)),
                      ("30", lambda: check_moe_mesh(dev, moe_mesh)),
                      ("31", lambda: check_memory_mesh(dev, mem_mesh)),
                      ("32", lambda: check_serve_mesh(dev, smollm_serve,
                                                      serve_mesh)),
                      ("33", lambda: check_family_serve_mesh(
                          dev, served, family_mesh)),
                      ("34", lambda: check_mesh_step(dev, mesh["smollm"],
                                                     mesh_step))):
        t0 = time.perf_counter()
        for kname, count in fn().items():
            phase_launches.setdefault(kname, {})[phase] = count
        log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
        done(phase)

    errs.update(mg_errs)
    timing.update(mg_timing)
    launches.update(mg_launches)
    errs["ssd_scan_bwd"], timing["ssd_scan_bwd"] = ssd_bwd["err"], \
        ssd_bwd["row"]
    launches["ssd_scan_bwd"] = ssd_bwd["launches"]
    # phase 27: the prob_bf16 variants' rows beside #5's and #7's, the
    # chunk 64 / 128 / 256 rows beside #8's and 8''s
    (timing["flash_attention_fwd"]["prob_bf16"],
     timing["flash_attention_dkv"]["prob_bf16"]) = perf["attention"]
    (timing["ssd_scan"]["chunks"],
     timing["ssd_scan_bwd"]["chunks"]) = perf["ssd"]
    # phase 28: #5-#7 at head size 256, by shape
    for kname, by_shape in h256["attention"].items():
        timing[kname]["head256"] = by_shape
    replaces = {"fused_step_update": "src/repro/kernels/sim_step.py:53",
                "fused_decision": "src/repro/kernels/sim_step.py:129",
                "frontier_step": "src/repro/kernels/mask_gemm.py:49",
                "backward_step": "src/repro/kernels/mask_gemm.py:70",
                "flash_attention_fwd":
                    "src/repro/kernels/flash_attention.py:62",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:31",
                "flash_attention_dq":
                    "src/repro/kernels/flash_attention.py:152",
                "flash_attention_dkv":
                    "src/repro/kernels/flash_attention.py:192",
                # no Pallas kernel: the reference differentiates its jnp
                # chunked scan, _ssd_jnp_chunked
                "ssd_scan_bwd": "src/repro/kernels/ops.py:145"}
    sources = {"fused_step_update": KERNEL_SRC, "fused_decision": KERNEL_SRC,
               "frontier_step": MASK_SRC, "backward_step": MASK_SRC,
               "flash_attention_fwd": FLASH_SRC, "ssd_scan": SSD_SRC,
               "flash_attention_dq": FLASH_BWD_SRC,
               "flash_attention_dkv": FLASH_BWD_SRC,
               "ssd_scan_bwd": SSD_BWD_SRC}
    # the two routes of 8', by operand dtype ("source" is the main path's)
    routes = {"ssd_scan_bwd": {
        "bfloat16": {"source": SSD_BWD_SRC, "cores": "tensor",
                     "device_ms": timing["ssd_scan_bwd"]["device_ms"]},
        "float32": {"source": SSD_BWD_FMA_SRC, "cores": "cuda",
                    "device_ms": timing["ssd_scan_bwd"]["fma_device_ms"]}}}
    kernels = [{"name": kname, "route": "cuda", "source": sources[kname],
                "replaces": replaces[kname], "launches": launches[kname],
                "max_abs_err": errs[kname],
                "ms": timing[kname]["ms"],
                "plain_ms": timing[kname]["plain_ms"],
                "bound_ms": timing[kname]["bound_ms"],
                "bound_by": timing[kname].get("bound_by", "bytes"),
                "library_ms": timing[kname].get("library_ms"),
                **({"phase_launches": phase_launches[kname]}
                   if kname in phase_launches else {}),
                **({"routes": routes[kname]} if kname in routes else {}),
                **{key: timing[kname][key]
                   for key in ("device_ms", "launch_ms", "library_device_ms",
                               "train_ms", "train_device_ms",
                               "train_library_ms",
                               "train_library_device_ms", "train_bound_ms",
                               "sparse_mm_ms", "level_ms", "block_ms",
                               "block_launches", "block_bound_ms",
                               "prob_bf16", "chunks", "head256")
                   if key in timing[kname]}}
               for kname in replaces]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
