#!/usr/bin/env python3
"""Drive the PyTorch port of FlowGNN on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --only wide    # phase 4f alone (no result lines)
    python3 chip_smoke.py --only lm_families    # phase 9 alone (the same)
    python3 chip_smoke.py --only train          # phase 10 alone (the same)
    python3 chip_smoke.py --only mesh           # phase 11 alone (the same)
    python3 chip_smoke.py --only model_parallel # phase 12 alone (the same)
    python3 chip_smoke.py --only model_train    # phase 13 alone (the same)
    python3 chip_smoke.py --only roofline       # phase 14 alone (the same)

Phases, each printing its own lines:

  1. device  — a CUDA device must be present; prints ``nvidia-smi``'s name
               and power limit; TF32 off for every fp32 product, and no
               reduced-precision reductions in bf16 products.
  2. build   — builds every CUDA kernel of the paths from ``src/
               repro_torch/kernels/csrc`` with nvcc (all nine sources at
               once); the NT tile's instantiations' registers and spills
               (f32, bf16, f16; nt_mlp.cu and fused_nt_scatter.cu).
  3. kernels — each kernel against its plain PyTorch version on the card,
               at stated tolerances, bitwise across runs and launch shapes,
               empty destinations exact; kernel, plain and bound times. The
               cases: synthetic ones at N=1024 (997), and the inputs every
               path of phase 4 hands its kernel in its first two layers at
               both serving buckets, and each path of phase 4c at its
               first packed batch of max_batch 8 and 64, recorded at the
               wrapper. For every
               layer_fused case an identity first layer also reads out the
               dense layer's input row (the self term's sum; the scalers or
               field row), whose empty destinations must equal the plain
               version's exactly; every case bitwise at 1, 3, 8 and 16
               rows per block. layer_fused also on a w1 larger than shared
               memory (PNA's form at d_in 2080: the weight ring), ragged
               widths (D=9, d_ff 25), weights and biases as views off 4
               bytes, one layer replayed from a CUDA graph; each case's
               output bytes as a sha256 line (to hold against another
               tree's run); first, its kernel instantiations' registers,
               shared memory and spills from the ptxas log.
               The scatter kernels of impl='kernel' (mp_scatter,
               mp_scatter_multi, seg_softmax) also on an empty-destination
               tail, a fully masked stream and receivers outside [0, N)
               (masked and not), seg_softmax also on unmasked receivers
               in the JAX kernel's padding rows [N, ceil(N, num_banks)),
               normalised there as that kernel does, with one PyTorch
               call's time beside mp_scatter's (``index_add_``).
               mp_scatter and mp_scatter_multi also torch.equal to the
               float32 stream-order fold on the host (``np.add.at`` and
               friends), on a hub row (5,000 of 8,192 edges, bf16 D=2048
               and f32 D=100; 2,500 of 4,096 in the block form), every
               edge to one row, N > E, E off every chunk, bf16 D=2047,
               message views off 16 bytes, rows of 33-128 edges and of 129
               throughout (E=65,536), GAT's packed buckets and olmoe's
               decode dispatch and combine, each with its launch plan
               printed, bitwise at 1, 3, 8 and 16 rows per block, in the
               other form (where it takes the call) and from a CUDA
               graph's replay; first, each of mp_scatter.cu's kernel
               instantiations' registers, shared memory and spills from
               the ptxas log.
               ``mp_pipeline`` (five
               statistics; attention) and ``layer_fused`` (self form) also
               on receivers and senders outside [0, N) (ROADMAP queue 3's
               input): a receiver there adds nothing, a sender there
               gathers a zero row. The owner-bucketed kernels
               (``mp_pipeline``, ``seg_softmax``) also on a hub row (5,000
               of 8,192 edges), every edge into one row, N=8192 > E=1000,
               an E past one bucketing (N=4096, E=65,536) and inputs off
               16 bytes (mp_pipeline at D=64 with attention, H=4, and with
               all five statistics and a full src_weight), every case of
               both bitwise at 1, 3, 8 and 16 rows per block; first, the
               registers and spills of each of their instantiations.
  4. slice   — the paper configs served end to end through
               ``GraphStreamEngine.process`` (each graph alone in a bucket
               of max_batch 8 graph slots), which answers each bucket from
               one CUDA graph captured on the bucket's first graph, each
               path with the launch counts set to 0 just before it and read
               just after: GIN, GAT, PNA and DGN under impl='fused_layer'
               (then 16 graphs of each again under ``torch.profiler``:
               device-busy share, top device and host ops), GCN and GIN-VN
               under 'fused_layer', GIN, GCN, PNA and DGN under 'pipeline',
               all six under 'kernel' (GAT's profiled too). The first graph
               of every bucket the traffic reaches is served first (that
               builds and captures each bucket's program; its time is
               logged), then every graph under ``torch.profiler``. Each
               path checks its wrappers' counts (a forward's per program
               built: its warm-up run and its capture; a replay runs no
               wrapper), the kernels the card ran in the replays (the
               profiler's device events by symbol: a forward's per graph;
               the ``launches`` the result line reports), that every bucket
               is a captured graph whose kernel nodes
               (``CUDAGraph.debug_dump``) hold each kernel as often as a
               forward launches it, its passes over the edges, its answers
               against the eager forward composed here
               (``build_graph_batch`` + ``model.apply``): to 1e-5 as
               served (the readout's ``index_add_`` adds with atomics; two
               eager runs' spread logged beside), bitwise for an engine
               captured under torch's deterministic algorithms (two eager
               runs bitwise there too), and agreement with the plain
               ``impl='fused'`` path on the card and with the CPU. Then the
               graphs are served again with the profiler off: p50 / p99.
  4b. host   — GIN, GAT and PNA under 'fused_layer' and GAT under 'kernel'
               on phase 4's 72 graphs: the eager forward (composed)
               against the captured engine, side by side: p50 / p99,
               forward-span throughput, device-busy us a graph and share of
               the wall; each host step alone (eager: build_graph_batch,
               the forward's enqueue, .cpu(); captured: padding into pinned
               memory, enqueueing the one copy, the replay's launch, the
               copy-out and wait); the host cost of one mp_scatter call
               eager against its share of a replay. One ``[host] json``
               line holds them all.
  4c. packed — the same four paths serve phase 4's 72 graphs through
               ``submit`` / ``drain`` (the packer, the scheduler, one
               executor's dispatch and complete threads on a captured
               program per packed bucket), counts from 0, after
               ``warmup_all`` and one unrecorded pass: at max_batch 8 and
               64 with max_wait 5 ms and no eager flush, and at max_batch 8
               with eager flush: p50 / p99, mean batch size, forward-span
               and wall (aggregate) throughputs; under ``torch.profiler``
               device-busy us a graph, the busy share and the device
               kernel events (a forward's per batch served); every answer
               within 1e-5 of the same graph through ``process``; under
               deterministic algorithms each packed answer bitwise the
               graph served alone in its packed bucket. Then GIN at
               max_batch 1,024 (1,024 molecules in one batch: its bucket,
               its replay's span, layer_fused timed there) and the
               reference example's two tenants (per-queue p50 / p90).
               Phase 3 also checks these paths' kernels at their first
               packed batch of max_batch 8 and 64. One ``[packed] json``
               line holds them all.
  4d. faults — GIN ``fused_layer`` at the paper config through ``submit`` /
               ``drain`` at max_batch 8 on 16 molecules and 4 kNN graphs of
               phase 4, counts from 0, with faults planted (``FaultInjector``):
               (a) a poison graph fails alone with ``PoisonGraph``, the others
               bitwise the fault-free run under deterministic algorithms
               (1e-5 as served), no program built for retries or bisection;
               (b) a NaN output trips the breaker, the bucket re-captured on
               ``pipeline``: its kernel nodes and one replay's device events
               hold ``mp_pipeline`` and no ``layer_fused``, answers within
               1e-4 of rung 0's; (c) ``break_impl("fused_layer")`` under
               audits of every batch: the audit demotes exactly that
               bucket, a probe of the broken rung is demoted again, a probe
               after ``fix_impl`` brings ``layer_fused`` back (nodes and
               events); (d) ``update_params`` to seed-1 weights under live
               traffic: every answer within 1e-5 of the eager forward under
               the version its batch ran, no bucket captured again, the
               copy into the captured weights timed; a NaN leaf refused,
               answers bitwise unchanged; (e) two executors on the card:
               one killed (work re-placed, every future once, respawned),
               one stalled past the watchdog (``DeadlineExceeded``,
               respawned, its programs and pool kept); (f) a checkpoint
               round trip serves bitwise. Phases 4–4c must trip no breaker,
               4d only where it plants a fault, never on a build failure.
               One ``[faults] json`` line.
  4e. tune   — per-bucket autotune on the captured programs (GIN, GAT and
               PNA configured ``fused_layer``, PNA and DGN configured
               ``kernel``, at the paper configs, through ``process`` at
               phase 4's molhiv and hep buckets), counts from 0: (a) each
               bucket tuned on its first real graph (every candidate, the
               configured impl, ``pipeline`` and ``fused_layer`` at rows
               per block None, 1, 8, captured once and timed by the span
               of its replays; the winner beside the kernels' own launch
               shape; captures and tune ms), the winner's capture kept as
               the bucket's program (no capture more), its kernel nodes its
               impl's kernel, answers within 1e-5 of the eager forward
               under the winner; then a second engine tuned on
               ``warmup_all``'s synthetic batch, its winners beside the
               real ones; (b) an engine on the JSON cache (a) wrote tunes
               nothing and captures one program a bucket; (c) the
               reference test's drift scenario (GCN, fill 4, then singles):
               a retune fires and the bucket keeps serving; (d) GIN with
               ``max_cached_programs=2`` through four buckets three times:
               evictions, at most two programs, no tune after the first
               cycle, the card's reserved memory flat. No candidate may
               fail, no breaker trip. One ``[tune] json`` line.
  4f. wide   — wide placement at the paper's GIN (5 layers, hidden 100):
               one graph over the largest bucket split across a gang of
               four executors of the card, counts from 0. (a) An engine
               with the default buckets, ``wide=True, wide_k=4``,
               ``devices=["cuda"] * 4`` serves 8 ``mesh_like`` graphs of
               1,100-2,040 nodes among 16 molecules through ``submit`` /
               ``drain``: every wide answer within ``EAGER_RTOL`` of the
               eager single-device forward at the 4,096 bucket and
               ``SLICE_RTOL`` of ``impl='fused'`` (max abs error and
               bitwise printed), the molecules within ``EAGER_RTOL`` of
               theirs, one ``CapturedWideProgram`` for both size classes,
               the edge passes under ``("wide", 4, 1024, 4096)``, ``wide[4]``
               in ``by_device``, one replay's device events 20
               ``layer_fused`` and no other of the nine kernels, and how far
               the shards' kernels ran side by side. (b) All six models at
               K=4, one wide graph each (GAT 20 ``mp_pipeline``, PNA and
               DGN 16 ``layer_fused``). (c) K=2 as the program alone:
               ``build_wide_forward`` on two executors' streams, captured,
               8 graphs of 1,000 nodes. (d) p50 from ``submit`` to answer,
               replay spans and graphs/s of the gang against a K=1 pool
               (buckets + 4,096, ``max_batch`` 1, 4 executors):
               ``speedup_vs_k1``, reported only; each ring step's ms from
               the eager schedule; halo rows and bytes a layer; capture
               ms. (e) ``update_params`` under wide traffic (the next
               answer under the new weights, no capture again), a planted
               transient failure retried and served, a random graph of
               900 nodes and 3,600 edges ``GraphTooLarge`` on buckets up
               to 512. One ``[wide] json`` line. ``--only wide`` runs
               phases 1, 2 (two sources) and 4f alone.
  5. nt      — ``ops.nt_mlp`` and ``ops.fused_nt_scatter`` driven at GIN's
               MLP (100->200->100) on the serving buckets' graphs and at
               the standard point (N=1024, E=4096, MLP 64->128->64), and
               on bf16 and f16 operands (GIN at the hep bucket), odd
               widths (d_in 9, d_ff 25, N=997) and views off 16 bytes,
               counts from 0; each against its plain version (a 16-bit
               nt_mlp result within half a unit in its last place more),
               bitwise across runs and at 1, 3, 8, 16 rows per block,
               fused_nt_scatter bitwise equal to nt_mlp + mp_pipeline on
               the operands widened to f32; the programmatic dependent
               launch named; times beside the bound and, for float32, the
               library chains (nt_mlp: cuBLAS's addmm -> relu -> addmm;
               fused_nt_scatter: those, index_select, add, relu and
               index_add_).
  6. moe     — the MoE data path at olmoe-1b-7b's full width (d_model 2048,
               64 experts, top-8, moe_d_ff 1024, capacity factor 1.25,
               bf16, one group of 1,024 tokens): ``nn/moe.py``'s routing
               and capacity, ``moe_dispatch`` (bf16 mp_scatter), its SwiGLU
               experts (``torch.einsum``),
               ``moe_combine`` (gather_rows, f32 mp_scatter), counts from
               0; the dispatch bitwise against the plain path and under a
               permutation, gather_rows bitwise, the combine against the
               plain path and a float64 sum on the host, both mp_scatter
               calls bitwise the stream-order fold, the dispatch captured
               in a CUDA graph and replayed bitwise; the three calls
               timed beside ``index_add_`` / ``index_select``.
  7. flash   — first, per instantiation of csrc/flash_attention.cu (bf16
               on the tensor cores, float32 on them too, each operand in
               three bf16 terms; each head width): the registers, shared
               memory and spill bytes of the build's ``-Xptxas -v`` log
               and the HGMMA count of its SASS (``cuobjdump -sass``);
               fails if one holds no HGMMA. Then ``flash_attention``
               against its plain version at llama3-8b's prefill (B=1 in
               bf16 and float32; the LM path's B=2 in bf16), gemma2-27b's
               local layer (8192 tokens, window 4096, softcap 50 reached by
               scaled queries, bf16 and float32), causal Sq > Sk (rows that
               see no key are 0), D = 16, 32, 64 (window 128, softcap 30)
               and 256, and a ragged Sq = Sk = 1000 at D=128 with window
               300, each in bf16 and float32: bf16 within one bf16 unit,
               float32 within 2e-5 (and each float32 case's kernel and
               plain version against a float64 one); at each shape the
               tolerance fails planted faults (one of the kernel's own kv
               tiles skipped, the window or the softcap ignored); bitwise
               across two runs; times beside the bound (float32: six bf16
               products a product on the tensor cores, the FMA bound
               beside it) and, at the LM shapes,
               ``scaled_dot_product_attention``.
  8. lm      — llama3-8b at full width: depth 2 in float32 against the plain
               attention path; then ``serve_lm(full=True)``, all 32 layers in
               bf16, B=2 prompts of 2048 tokens and 32 generated tokens each,
               counts from 0 (prefill 32 ``flash_attention`` launches, decode
               none), the last-position logits against the plain attention
               path's, prefill ms and decode tokens/s.
  9. lm_families — the MoE, SSM and hybrid LM paths at full width, each
               freed before the next, the LM traffic of phase 8, counts
               from 0: olmoe-1b-7b (MoE through ``nn/moe.py`` on
               ``mp_scatter`` / ``gather_rows``, and ``flash_attention``),
               mamba2-2.7b (no kernel: the SSD runs outside any, as in the
               reference) and recurrentgemma-2b (``flash_attention`` on its
               local layers, D=256, window 2048, one KV head). First each at
               depth 2 (3 for the hybrid's group) in float32: the prefill
               and three decode steps through the kernels against their
               plain versions (the MoE's routing compared), mamba2's
               chunked prefill against the prompt fed token by token
               through ``decode_step``. Then ``serve_lm(full=True)`` in
               bf16: launches of the prefill and of every decode step
               against the layers (olmoe: 16 flash_attention, 32
               mp_scatter, 16 gather_rows, then 32 and 16 a step); the
               first MoE layer's dispatch, gather and combine of the
               prefill and of the first decode step, and the first
               attention layer's flash_attention, each again against its
               plain version on the served inputs and timed; the prefill's
               logits against the same serve through the plain kernels,
               and planted kernel faults outside that tolerance; prefill
               ms, decode tokens/s, peak memory, the MoE's drop share and
               aux loss; a prefill and a decode step again under
               ``torch.profiler``, whose device events must be the same
               counts. One ``[lm9] json`` line; ``--only lm_families``
               runs phases 1, 2 (three sources) and 9 alone.
  10. train  — the LM training path ([train] lines). (a) the backward
               kernel ``flash_attention_bwd`` (csrc/flash_attention_bwd.cu:
               bf16 on wgmma and TMA, float32 on wgmma too, each operand
               in three bf16 terms; dQ and delta, then dK / dV) against
               its plain version at qwen1.5-0.5b's, llama3-8b's,
               gemma2-27b's local (softcap 50, q x50) and
               recurrentgemma-2b's local (D=256, window 2048) training
               shapes, Sq < Sk and a ragged 1000, bf16 and float32 (each
               gradient within 2^-7 of its scale, float32 within 2e-5, and
               each float32 case's kernel and plain version against a
               float64 one), the forward's lse from the forward kernel;
               bitwise across two runs; planted faults (dq skipping one kv
               tile, the softcap's derivative dropped) must fail the
               tolerance; each instantiation's registers, spills and SASS
               HGMMA count (every one must hold HGMMA, none an ATOM or
               RED); times beside the bound (10 D operations a visible
               pair; float32 six bf16 products each, the FMA bound beside
               it) and
               SDPA's backward (with an explicit end-aligned mask under a
               window or Sq < Sk; a refusal is logged). (b) qwen1.5-0.5b and
               olmoe-1b-7b at full width, depth 2, float32: ``lm_loss`` and
               every parameter's gradient through the kernels against the
               plain path (within 1e-4 of each scale), the MoE's routing
               compared, launches
               from 0 (mp_scatter and gather_rows also as each other's
               backward). (c) the ``Trainer`` on qwen1.5-0.5b at full width
               and depth (24 layers, bf16, AdamW, remat) for 20 steps of
               B=8 x S=2048 synth tokens, counts from 0 against the layers
               (two forward and two backward launches an attention layer a
               step), step ms (median, p90), tokens/s, peak memory, the
               loss falling, one step's busy share and top device ops
               under ``torch.profiler``. ``--only train`` runs phases 1, 2
               (four sources) and 10 alone.
  11. mesh   — the mesh ([mesh] lines), its positions on the card (spread
               over the cards where there are several), each on its own
               stream, one thread a position inside ``shard_map``. (a) On a
               (4,) ring at 4 x 16 MB float32: ``ring_shift`` for every
               step count (``torch.roll``), ``broadcast_from`` every source,
               ``psum`` / ``pmax`` bitwise the fold in position order on
               one stream. (b) GPipe: qwen1.5-0.5b's 24 blocks (bf16,
               seed-0 weights) as 4 stages of 6 over a ring of 4, 8
               microbatches of 1 x 2048 synth tokens, counts from 0 (4 x
               (8 + 3) x 6 = 264 flash_attention: every stage runs at every
               step), against the blocks in sequence on one stream at
               phase 8's bf16 tolerance; both timed. (c) data parallelism:
               at depth 2 in float32 (qwen1.5-0.5b, olmoe-1b-7b, phase 10's
               shapes) the DP step on a (2, 1) mesh against the unsharded
               step, one step at learning rate 0, every gradient (AdamW's
               m) within 1e-5 of the scale; then the ``Trainer`` on
               qwen1.5-0.5b at full width and depth (bf16, AdamW, remat),
               5 steps of 8 x 2048, on one position and on a (2, 1) mesh,
               counts from 0 each step (48 flash_attention and 48
               flash_attention_bwd a position), the two replicas bitwise
               after every step, each step's loss within 2e-2 of the one
               position's; step ms and tokens/s of both. (d) compression:
               ``tree_ef_compressed_psum`` of qwen's gradient tree over the
               2 positions against the plain ``psum``, each element within
               K x s_max / 2 plus the pmax-of-scales term; both timed; the
               reference's least-squares convergence on a (4,) ring (200
               steps, loss < 1e-3). (e) elastic: (c)'s parameters and
               AdamW state saved and restored through ``elastic_restore``
               onto (1, 1) and (4, 1), bitwise; ``remesh_plan`` of
               llama3-8b on the production mesh (meta positions); an
               indivisible case's message. One ``[mesh] json`` line;
               ``--only mesh`` runs phases 1, 2 (four sources) and 11
               alone.
  12. model_parallel — serving on a model axis ([mp] lines): positions
               (1, 2) on the card (spread over the cards where there are
               several), the steps of ``make_prefill_step(cfg, rules, mesh)``
               / ``make_decode_step(cfg, rules, mesh)``. (a) float32 (TF32
               off) at full widths: depth 2 at llama3-8b's, at its widths
               with one KV head (the cache split by sequence), at
               olmoe-1b-7b's (32 experts a bank) and at mamba2-2.7b's (the
               SSD's 80 heads and the state split, the mixer repeated);
               depth 3 (one group) at recurrentgemma-2b's (the RG-LRU's
               width split, its local layer's cache by sequence): a
               prefill of 2 x 512 and 4 decode steps against the unsharded
               steps on the same weights, every call's logits and every
               tensor of the caches within 1e-5 of the scale. (b)
               llama3-8b, (c) olmoe-1b-7b, (d) mamba2-2.7b and (e)
               recurrentgemma-2b at full width and depth in bf16, seed-0
               weights, nothing cut, phase 8's traffic: the unsharded
               serve, then the same weights placed on the mesh and served
               with the counts from 0, stated before the run (prefill:
               llama 64 ``flash_attention``; olmoe 32 / 64 ``mp_scatter``
               / 32 ``gather_rows``, and 64 / 32 a decode step; mamba2
               none; recurrentgemma 16 ``flash_attention``), each timed
               after a warm run; a prefill and a decode step under
               ``torch.profiler`` (the device events must be the
               launches; busy share); the prefill's logits within 0.05 of
               the scale of the unsharded serve's, and the greedy first
               tokens equal wherever the unsharded top-2 margin exceeds
               twice the logits' largest difference. One ``[mp] json``
               line; ``--only model_parallel`` runs phases 1, 2 (three
               sources) and 12 alone.
  13. model_train — training under the model axis ([mt] lines): the
               sharded ``make_train_step(cfg, tcfg, rules, mesh)`` of
               ``build_rules``' table, positions on the card (spread over
               the cards where there are several), every sharded step
               under a 60 s rendezvous watchdog (a position waiting
               longer fails the phase naming the collective). (a) float32
               (TF32 off), per-layer remat, B=4 x 256, one step at
               learning rate 0 against the unsharded step on the same
               card (run first, freed): llama3-8b at depth 2 on (1, 2),
               olmoe-1b-7b at depth 2 on (1, 2), deepseek-67b at depth 1
               on (2, 2) (FSDP and the model axis, four positions),
               mamba2-2.7b at depth 2 and recurrentgemma-2b at depth 3 on
               (1, 2); the loss within 1e-5 of itself, every gradient
               (AdamW's first moment) within 1e-5 of the gradients'
               scale; launches each position's forward, recompute and
               backward. (b) bf16, AdamW, remat: llama3-8b at depth 4 on
               (1, 2), B=2 x 2048, deepseek-67b at depth 2 on (2, 2), B=4
               x 2048, mamba2-2.7b at depth 16 and recurrentgemma-2b at
               depth 12 on (1, 2), B=2 x 2048 (each run's peak under ~60
               GB), three steps unsharded then (freed) on the mesh, launches
               counted from 0 and stated before the run, one more step of
               each under ``torch.profiler`` (device kernels by symbol
               equal to the launches, busy share); step ms, tokens/s,
               the losses within 2e-2 of the unsharded run's. One ``[mt]
               json`` line; ``--only model_train`` runs phases 1, 2 (four
               sources) and 13 alone.
  14. roofline — the dry run's count held against the card ([roof]
               lines): each step built by ``launch/steps.py::
               lowering_bundle``, run once under ``counter.py``'s
               counter on meta positions and once on positions of the
               card. (a) qwen1.5-0.5b's training step, phase 10's cell
               (24 layers, B=8 x 2048, bf16, AdamW, remat) on (1, 1): the
               products' FLOPs, the op bytes and the kernels' launches
               and declared work equal; the backward counted on
               autograd's worker thread (its products about three times
               the forward's: twice, plus remat's recompute); the meta
               peak at full depth and extrapolated from 1 and 2 layers
               (``launch/hlo_cost.py``) each within 25% of the card's
               ``max_memory_allocated``; the step without the counter,
               median of 5, beside phase 10's ``Trainer`` step, and
               ``model_flops`` over it at 989 TFLOP/s. (b) llama3-8b's
               prefill, phase 8's cell (B=2 x 2048, 32 layers, bf16) on
               (1, 1): the counts equal, timed, its share. (c) llama3-8b
               at depth 2 prefilling on (1, 2) positions of the card:
               each position's collective records (kind, group, count,
               bytes) equal the (1, 2) meta mesh's. One ``[roof] json``
               line; ``--only roofline`` runs phases 1, 2 (two sources)
               and 14 alone.
  15. result — one JSON line with every kernel's numbers, the card's
               ``nvidia-smi`` line, then ``{"ok": true, "device": ...}``.

Any failure raises and exits non-zero; without a CUDA device the script
exits non-zero before printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# kernel vs plain version on the card: both fp32, sums in another order
# (atomics in index_add_, blocked products in cuBLAS), so agreement to a
# few hundred ulp of the output's scale
RTOL = 1e-4
ATOL_OF_SCALE = 1e-4
# the served prediction vs the plain impl='fused' path: five layers of
# those differences, compounded
SLICE_RTOL = 1e-4
# the served prediction vs the eager forward of the same model and impl on
# the card: the same kernels, but the readout's index_add_ and DGN's field
# sums add with atomics in an order that changes run to run. On an H100,
# two eager runs of a path's graphs were read up to 2.3e-6 apart (relative
# to max(1, |ref|); GIN-VN, whose virtual node sums with index_add_ in
# every layer) and the served answers up to 2.0e-6 from one (PERF.md §6):
# four times the largest
EAGER_RTOL = 1e-5


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def close(a, b, rtol=RTOL, atol_of_scale=ATOL_OF_SCALE):
    """Max abs error, max error relative to max(1, max|b|) (the scale), and
    whether |a - b| <= atol_of_scale*scale + rtol*|b| with ``a`` finite."""
    import torch
    diff = (a - b).abs()
    scale = max(1.0, float(b.abs().max()))
    ok = bool((diff <= atol_of_scale * scale + rtol * b.abs()).all())
    return float(diff.max()), float(diff.max()) / scale, ok and bool(
        torch.isfinite(a).all())


def time_ms(fn, reps: int = 21, inner: int = 20):
    """(device ms, call ms) of one call of ``fn``, medians over ``reps``.

    Device ms: ``inner`` calls queued behind a GPU spin long enough to
    cover their host dispatch, between two CUDA events, so the card runs
    them back to back and only its own time is counted. Call ms: one call
    at a time between two events, the host's dispatch included (what a
    caller at batch 1 waits).
    """
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # the spin: torch.cuda._sleep runs ~1.5-2 cycles per ns; ask for 3x
    # the enqueue time at 1 cycle per ns so the queue never drains
    spin = int(3 * enqueue_s * 1e9) + 1_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    dev, call = [], []
    for _ in range(reps):
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end) / inner)
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        call.append(start.elapsed_time(end))
    return statistics.median(dev), statistics.median(call)


def bitwise_stable(phase: str, label: str, run, out,
                   rows_per_block=(1, 3, 16)) -> None:
    """Call ``run()`` again and ``run(rows_per_block=r)`` for each ``r``;
    raise unless every output is bitwise ``out`` (a tensor, or a dict of
    tensors)."""
    import torch
    runs = [run()] + [run(rows_per_block=r) for r in rows_per_block]
    torch.cuda.synchronize()
    for r in runs:
        same = (all(torch.equal(r[k], out[k]) for k in out)
                if isinstance(out, dict) else torch.equal(r, out))
        if not same:
            raise AssertionError(f"{label} is not bitwise stable across runs "
                                 f"and rows per block")
    log(phase, f"{label}: bitwise equal across 2 runs and at "
        f"{', '.join(map(str, rows_per_block))} rows/block")


def timed_row(card: str, phase: str, label: str, kernel_fn, plain_fn, bound,
              *, err: float, rel=None, library=None, library_txt: str = "",
              library_key: str = "library_ms", reps: int = 21,
              inner: int = 20) -> dict:
    """Time one case: the kernel call ``kernel_fn``, its plain version
    ``plain_fn`` and, where there is one, the ``library`` call (stored
    under ``library_key``), each by ``time_ms(fn, reps, inner)``; log them
    beside ``bound`` (ms, what bounds it, bytes, operations) and return the
    case's row."""
    bound_ms, bound_by, nbytes, flops = bound
    ms, call_ms = time_ms(kernel_fn, reps, inner)
    plain_ms, plain_call_ms = time_ms(plain_fn, reps, inner)
    lib_ms = None if library is None else time_ms(library, reps, inner)[0]
    row = {"max_abs_err": err, "max_rel_err": rel, "ms": ms,
           "plain_ms": plain_ms, "call_ms": call_ms,
           "plain_call_ms": plain_call_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "flops": flops,
           "library_ms": None}
    lib_txt = ""
    if lib_ms is not None:
        row[library_key] = lib_ms
        lib_txt = f"; {library_txt} {lib_ms * 1e3:.2f} us"
    log(phase, f"{label}: device time kernel {ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us{lib_txt}; one call with host dispatch "
        f"kernel {call_ms * 1e3:.1f} us, plain {plain_call_ms * 1e3:.1f} us; "
        f"bound {bound_ms * 1e3:.3f} us ({bound_by}: {nbytes / 1e6:.3f} MB, "
        f"{flops / 1e6:.3f} MFLOP) on {card}")
    return row


def counted(run):
    """``run()`` with every kernel's launch count set to 0 just before it
    and read just after: (what it returned, the counts by kernel)."""
    import torch
    from repro_torch.kernels.ops import launch_counters
    kernels = launch_counters()
    for fn in kernels.values():
        fn.launches = 0
    result = run()
    torch.cuda.synchronize()
    return result, {k: fn.launches for k, fn in kernels.items()}


def check_launches(phase: str, label: str, launches: dict, expected: dict,
                   why: str) -> None:
    """Raise unless every kernel launched as often as ``expected`` says (0
    for a kernel it does not name)."""
    want = {k: expected.get(k, 0) for k in launches}
    log(phase, f"{label}: launches {launches} (expected {want}: {why})")
    if launches != want:
        raise AssertionError(f"{label}: the path did not run the expected "
                             f"kernel launches")


# ---------------------------------------------------------------------------
# layer_fused cases
# ---------------------------------------------------------------------------

def glorot(r, d_in, d_out):
    return (r.normal(size=(d_in, d_out)) * np.sqrt(2.0 / (d_in + d_out))
            ).astype(np.float32)


def random_inputs(r, n, e, d, *, sw=None, edge_term=False, bias=None,
                  empty_tail=0, mask_p=0.8):
    """Numpy node buffer, edge stream and phi terms of one random call (a
    dict of keyword args); ``bias`` names the bias's keyword, if any."""
    kw = {
        "x": r.normal(size=(n, d)).astype(np.float32),
        "senders": r.integers(0, n, size=e).astype(np.int64),
        # the last ``empty_tail`` destinations receive no edge
        "receivers": r.integers(0, n - empty_tail, size=e).astype(np.int64),
        "edge_mask": r.random(e) < mask_p,
        "num_nodes": n,
    }
    if sw == "scalar":
        kw["src_weight"] = r.normal(size=(e,)).astype(np.float32)
    elif sw == "full":
        kw["src_weight"] = r.normal(size=(e, d)).astype(np.float32)
    elif sw == "head":
        kw["src_weight"] = r.normal(size=(e, 4)).astype(np.float32)
    if edge_term:
        kw["edge_term"] = r.normal(size=(e, d)).astype(np.float32)
    if bias:
        kw[bias] = r.normal(size=(d,)).astype(np.float32)
    return kw


def lf_case(seed, n, e, d, d_ff, d_out=None, *, self_coeff="scalar",
            sw=None, edge_term=True, phi_bias=False, relu_phi=True,
            out_relu=False, empty_tail=0):
    """Numpy inputs of one layer_fused call in the self form (a dict of
    keyword args)."""
    r = np.random.default_rng(seed)
    kw = random_inputs(r, n, e, d, sw=sw, edge_term=edge_term,
                       bias="phi_bias" if phi_bias else None,
                       empty_tail=empty_tail)
    kw["w1"] = glorot(r, d, d_ff)
    kw["b1"] = (0.1 * r.normal(size=(d_ff,))).astype(np.float32)
    kw["phi_activation"] = "relu" if relu_phi else "none"
    kw["out_activation"] = "relu" if out_relu else "none"
    if d_out is not None:
        kw["w2"] = glorot(r, d_ff, d_out)
        kw["b2"] = (0.1 * r.normal(size=(d_out,))).astype(np.float32)
    if self_coeff == "scalar":
        kw["self_coeff"] = np.array([1.1], np.float32)
    elif self_coeff == "node":
        kw["self_coeff"] = r.random(n).astype(np.float32)
    return kw


def out_of_range_case(kernel: str, *, heads: int = 0):
    """ROADMAP queue 3's input: ``default_rng(5)``, N=32, E=160, D=8, 80% of
    the edges unmasked; a quarter of the receivers redrawn from [-4, 0) or
    [N, N+12) and a quarter of the senders from [-4, 0) or [N, N+8). A
    receiver outside [0, N) adds nothing; a sender there gathers a zero row
    and still counts. ``mp_pipeline``: all five statistics, edge term,
    bias and relu (or GAT's attention with ``heads``); ``layer_fused``: the
    self form, self_coeff 1.5, w1 8 -> 16."""
    r = np.random.default_rng(5)
    n, e, d = 32, 160, 8
    mp = kernel == "mp_pipeline"
    kw = random_inputs(r, n, e, d, edge_term=not heads,
                       bias=None if heads else ("bias" if mp else "phi_bias"))
    redraw_out_of_range(r, kw)
    if mp:
        kw["stats"] = ("sum", "count") if heads else ALL_STATS
        kw["activation"] = "none" if heads else "relu"
        if heads:
            kw["att_src"] = r.normal(size=(n, heads)).astype(np.float32)
            kw["att_dst"] = r.normal(size=(n, heads)).astype(np.float32)
    else:
        kw["w1"] = glorot(r, d, 16)
        kw["b1"] = (0.1 * r.normal(size=(16,))).astype(np.float32)
        kw["phi_activation"] = "relu"
        kw["out_activation"] = "none"
        kw["self_coeff"] = np.array([1.5], np.float32)
    return kw


def redraw_out_of_range(r, kw):
    """A quarter of ``kw``'s receivers redrawn from [-4, 0) or [N, N+12)
    and a quarter of its senders from [-4, 0) or [N, N+8), drawn from
    ``r``, in place."""
    n, e = kw["num_nodes"], kw["senders"].shape[0]
    for stream, past in (("receivers", 12), ("senders", 8)):
        pick = r.random(e) < 0.25
        draw = np.where(r.random(e) < 0.5, r.integers(-4, 0, size=e),
                        r.integers(n, n + past, size=e))
        kw[stream] = np.where(pick, draw, kw[stream]).astype(np.int64)


def owned_edges(kw_np):
    """The edges that count: unmasked, with a receiver in [0, N)."""
    rcv = kw_np["receivers"]
    return kw_np["edge_mask"] & (rcv >= 0) & (rcv < kw_np["num_nodes"])


def degrees_of(kw):
    """In-degrees over a case's owned edges, as float32."""
    return np.bincount(kw["receivers"][owned_edges(kw)],
                       minlength=kw["num_nodes"]).astype(np.float32)


def lf_scalers_case(seed, n, e, d, *, empty_tail=0, delta=1.3):
    """PNA's form: node_input and edge_term of width d, relu phi, PNA's
    three degree scalers, w1 over d + 12d, out relu."""
    r = np.random.default_rng(seed)
    kw = random_inputs(r, n, e, d, edge_term=True, bias="phi_bias",
                       empty_tail=empty_tail)
    kw["node_input"] = r.normal(size=(n, d)).astype(np.float32)
    kw["degrees"] = degrees_of(kw)
    log_deg = np.log(kw["degrees"] + 1.0)
    kw["scalers"] = np.stack([np.ones_like(log_deg), log_deg / delta,
                              delta / np.maximum(log_deg, 1e-3)],
                             axis=-1).astype(np.float32)
    kw["w1"] = glorot(r, 13 * d, d)
    kw["b1"] = (0.1 * r.normal(size=(d,))).astype(np.float32)
    kw["phi_activation"] = "relu"
    kw["out_activation"] = "relu"
    return kw


def lf_field_case(seed, n, e, d, *, empty_tail=0):
    """DGN's form: the stacked [x | x] gather buffer, the full (E, 2d)
    [1 | w] src_weight of a random field, its sums, w1 over 3d, out relu."""
    r = np.random.default_rng(seed)
    kw = random_inputs(r, n, e, d, empty_tail=empty_tail)
    w = r.normal(size=(e,)).astype(np.float32)
    kw["node_input"] = np.concatenate([kw["x"], kw["x"]], axis=-1)
    kw["src_weight"] = np.concatenate(
        [np.ones((e, d), np.float32), np.repeat(w[:, None], d, axis=1)],
        axis=-1)
    kw["degrees"] = degrees_of(kw)
    wsum = np.zeros(n, np.float32)
    np.add.at(wsum, kw["receivers"][kw["edge_mask"]], w[kw["edge_mask"]])
    kw["field_wsum"] = wsum
    kw["w1"] = glorot(r, 3 * d, d)
    kw["b1"] = (0.1 * r.normal(size=(d,))).astype(np.float32)
    kw["phi_activation"] = "none"
    kw["out_activation"] = "relu"
    return kw


def on_device(kw, dev):
    import torch
    return {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
            else v for k, v in kw.items()}


POSITIONAL = ("x", "senders", "receivers", "edge_mask", "num_nodes")
# the positional arguments of each kernel wrapper, in order
KERNEL_POSITIONAL = {
    "layer_fused": POSITIONAL, "mp_pipeline": POSITIONAL,
    "mp_scatter": ("msg", "receivers", "edge_mask", "num_nodes"),
    "mp_scatter_multi": ("msg", "receivers", "edge_mask", "num_nodes"),
    "seg_softmax": ("logits", "receivers", "edge_mask", "num_nodes"),
}


def call(fn, kw, positional=POSITIONAL, **extra):
    """``fn`` (a kernel wrapper or its plain version) on a dict of inputs."""
    kw = dict(kw, **extra)
    return fn(*[kw.pop(k) for k in positional], **kw)


# the kernels' per-edge streams: a masked edge contributes nothing, so the
# function needs these only for the edges whose mask is set
EDGE_STREAMS = ("senders", "receivers", "src_weight", "edge_term")


def input_bytes(kw):
    """Bytes the function must read: the edge mask once, the per-edge
    streams of the unmasked edges once (indices at
    ``kernels/cost.py::INDEX_BYTES``: the function needs int32 indices,
    the port's graphs hold int64, which the bound does not charge), every
    node-side input and weight once."""
    from repro_torch.kernels.cost import INDEX_BYTES
    e = kw["senders"].shape[0]
    valid = int(kw["edge_mask"].sum())
    nbytes = 0
    for k, v in kw.items():
        if not isinstance(v, np.ndarray):
            continue
        if k in ("senders", "receivers"):
            nbytes += INDEX_BYTES * valid
        elif k in EDGE_STREAMS:
            nbytes += v.nbytes // e * valid
        else:
            nbytes += v.nbytes
    return nbytes


def lf_bound(kw):
    """The least time (ms) the card could take for this call, the larger of
    two. Bytes at the memory rate: ``input_bytes``, then the output written
    once. Operations at the fp32 rate: those this run's data needs: the
    unmasked edges' phi and accumulation at the message width (sum; with
    degree scalers also the square and its sum, max and min), then the
    epilogue (the self term; or the scalers form's mean, variance, std and
    scaled copies; or the field form's mean and |s1 - x*wsum|) and the
    dense layers over the first layer's input width."""
    n, d_x = kw["x"].shape
    d = kw["node_input"].shape[1] if "node_input" in kw else d_x
    valid = int(kw["edge_mask"].sum())
    d_in, d_ff = kw["w1"].shape
    two = "w2" in kw
    d_out = kw["w2"].shape[1] if two else d_ff
    nbytes = input_bytes(kw) + n * d_out * 4                 # + the output
    per_edge = 1 + ("src_weight" in kw) + ("edge_term" in kw) + (
        "phi_bias" in kw) + (kw["phi_activation"] == "relu")
    if "scalers" in kw:
        per_edge += 4                      # square, its sum, max, min
    flops = valid * d * per_edge
    if "scalers" in kw:
        # per row 1/max(deg, 1); per lane mean 1, variance 4, std 2, and
        # the four statistics times each scaler
        flops += 2 * n + n * d * (7 + 4 * kw["scalers"].shape[1])
    elif "field_wsum" in kw:
        # per row 1/max(deg, 1); per lane of x the mean 1, |s1 - x*wsum| 3
        flops += 2 * n + 4 * n * d_x
    elif "self_coeff" in kw:
        flops += 2 * n * d
    flops += 2 * n * d_in * d_ff + n * d_ff
    if two:
        flops += n * d_ff + 2 * n * d_ff * d_out + n * d_out
    flops += n * d_out if kw["out_activation"] == "relu" else 0
    return work_bound(nbytes, flops)


def to_numpy(kw):
    import torch
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else v for k, v in kw.items()}


def epilogue_rows_check(name, kw, kw_np, layer_fused, layer_fused_ref):
    """The first dense layer's input row z (the self term's sum, or the
    scalers or field epilogue's row), read out through an identity first
    layer (each output one product by 1 among zeros, exact on both sides):
    equal to the plain version's on the empty destinations, within
    tolerance elsewhere. These launches are not on the main path."""
    import torch
    d_in = kw_np["w1"].shape[0]
    probe = {k: v for k, v in kw.items() if k not in ("w2", "b2")}
    dev = kw["x"].device
    probe.update(w1=torch.eye(d_in, device=dev),
                 b1=torch.zeros(d_in, device=dev), out_activation="none")
    z = call(layer_fused, probe)
    z_plain = call(layer_fused_ref, probe)
    torch.cuda.synchronize()
    empty = torch.from_numpy(degrees_of(kw_np) == 0).to(dev)
    n_empty = int(empty.sum())
    if not torch.equal(z[empty], z_plain[empty]):
        raise AssertionError(f"layer_fused {name}: the epilogue's input on "
                             f"the {n_empty} empty destinations is not "
                             f"exactly the plain version's")
    err, _, ok = close(z, z_plain)
    log("kernels", f"layer_fused {name}: epilogue input z (width {d_in}) "
        f"exact on {n_empty} empty destinations, max_abs_err={err:.3e} "
        f"elsewhere {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"layer_fused {name}: the epilogue's input "
                             f"disagrees with the plain version's")


def lf_build_report() -> dict:
    """Per instantiation of csrc/layer_fused.cu's kernel (the scalers form's
    four accumulators, or one for the self and field forms; the block-local
    or the grid form): registers, spill bytes and static shared memory from
    the build's ``-Xptxas -v`` log."""
    import re

    def instance(symbol):
        m = re.search(r"layer_fused_kernelILb(\d)ELb(\d)E", symbol)
        return None if m is None else (
            ("scalers" if m.group(1) == "1" else "self_field")
            + ("_grid" if m.group(2) == "1" else "_block"))
    report = ptxas_report("layer_fused", instance)
    for name, info in sorted(report.items()):
        log("kernels", f"layer_fused.cu instantiation {name}: "
            f"{info['registers']} registers, spill stores/loads "
            f"{info['spill_stores']}/{info['spill_loads']} bytes, "
            f"{info['smem']} bytes static shared memory (ptxas -v log)")
    if len(report) != 4:
        raise AssertionError(f"layer_fused.cu: {len(report)} kernel "
                             f"instantiations in the ptxas log, expected 4")
    return report


def lf_hub_case(seed, n, e, d, *, share=0.75):
    """GIN's self form with ``share`` of the edges into row n // 3: its
    tile's segment is longer than the grid form's list, so that tile is
    swept."""
    kw = lf_case(seed, n, e, d, 200, d)
    hub = np.random.default_rng(seed + 1).random(e) < share
    kw["receivers"] = np.where(hub, n // 3, kw["receivers"]).astype(np.int64)
    return kw


def lf_out_of_range(kw, seed):
    """``kw`` with indices outside [0, N) as ``out_of_range_case`` draws
    them, from ``default_rng(seed)``."""
    kw = dict(kw)
    redraw_out_of_range(np.random.default_rng(seed), kw)
    return kw


# the dense layers' weights and biases, which the kernel stages on chip
LF_WEIGHTS = ("w1", "b1", "w2", "b2")


def off_by_4_bytes(kw):
    """``kw`` with each weight and bias a contiguous view that starts 4
    bytes into a buffer of its own: off every 16-byte boundary, so the
    kernel stages them 4 bytes a copy."""
    import torch
    out = dict(kw)
    for k in LF_WEIGHTS:
        if k in kw:
            buf = torch.empty(kw[k].numel() + 1, device=kw[k].device)
            buf[1:].copy_(kw[k].reshape(-1))
            out[k] = buf[1:].view(kw[k].shape)
    return out


def lf_cases() -> dict:
    """Phase 3's synthetic layer_fused cases in numpy, by name."""
    return {
        "a_gin_paper_width": lf_case(1, 1024, 4096, 100, 200, 100,
                                     empty_tail=64),
        "b_gcn_form": lf_case(2, 1024, 4096, 9, 100, self_coeff="node",
                              sw="scalar", edge_term=False, relu_phi=False,
                              out_relu=True, empty_tail=32),
        "c_full_src_weight_bias_no_self": lf_case(
            3, 1024, 4096, 100, 100, self_coeff=None, sw="full",
            phi_bias=True, relu_phi=False),
        "d_ragged_head_src_weight": lf_case(4, 997, 3001, 100, 200, 100,
                                            sw="head", empty_tail=5),
        "d_pna_scalers_form": lf_scalers_case(5, 1024, 4096, 80,
                                              empty_tail=64),
        "d_dgn_field_form": lf_field_case(6, 1024, 4096, 100,
                                          empty_tail=64),
        "g_out_of_range_self_form": out_of_range_case("layer_fused"),
        # w1 (2,080 x 160, 1.33 MB) larger than shared memory: the ring
        "h_pna_ring_d_in_2080": lf_scalers_case(7, 256, 2048, 160,
                                                empty_tail=16),
        # k * n_dim and the biases off multiples of 4 floats
        "h_ragged_d9_dff25": lf_case(8, 997, 3001, 9, 25, 9, empty_tail=5),
        # GIN's paper width with weights and biases off 16 bytes
        "h_weights_off_4_bytes": lf_case(9, 1024, 4096, 100, 200, 100,
                                         empty_tail=64),
        # the grid form (LF_GRID_CASES): the packed buckets of 64 and 1,024
        # graphs in each epilogue (PNA's w1 through the ring, restaged a
        # tile), a hub row's tile swept, N > E, indices outside [0, N)
        "i_gin_grid_n2048": lf_case(21, 2048, 4096, 100, 200, 100,
                                    empty_tail=64),
        "i_pna_grid_n2048": lf_scalers_case(22, 2048, 4096, 80,
                                            empty_tail=64),
        "i_dgn_grid_n2048": lf_field_case(23, 2048, 4096, 100,
                                          empty_tail=64),
        "j_gin_grid_n32768": lf_case(24, 32768, 65536, 100, 200, 100,
                                     empty_tail=64),
        "j_pna_grid_n32768": lf_scalers_case(25, 32768, 65536, 80,
                                             empty_tail=64),
        "j_dgn_grid_n32768": lf_field_case(26, 32768, 65536, 100,
                                           empty_tail=64),
        "k_grid_hub_row_n8192": lf_hub_case(27, 8192, 16384, 100),
        "k_grid_n_gt_e": lf_case(28, 16384, 4000, 100, 200, 100),
        "k_grid_out_of_range": lf_out_of_range(
            lf_case(29, 4096, 8192, 100, 200, 100), 29),
    }


# phase 3's cases that must take layer_fused's grid form: "j_" and "k_" by
# the wrapper's own rule, "i_" (N=2048, E=4096, where the rule keeps the
# block-local form: the crossover) through its private hook, every call
LF_GRID_CASES = ("i_", "j_", "k_")
LF_FORCED_GRID = ("i_",)


@contextmanager
def lf_forced(name):
    """The grid form forced for a case of LF_FORCED_GRID, else nothing."""
    from repro_torch.kernels import layer_fused as lf
    if not name.startswith(LF_FORCED_GRID):
        yield
        return
    lf._force_form = "grid"
    try:
        yield
    finally:
        lf._force_form = None


def lf_form(kw_np) -> str:
    """The form ``layer_fused`` takes for a case at its own rows per
    block on this card."""
    import torch
    from repro_torch.kernels.layer_fused import launch_form
    return launch_form(kw_np["x"].shape[0], kw_np["senders"].shape[0], None,
                       torch.cuda.get_device_properties(0)
                       .multi_processor_count)


def other_form_check(label, kw, out, form):
    """The case in the form it does not take (the wrapper's private
    hook): bitwise ``out``. These launches are not on the main path."""
    import torch
    from repro_torch.kernels import layer_fused as lf
    other = "block" if form == "grid" else "grid"
    forced = lf._force_form
    lf._force_form = other
    try:
        again = call(lf.layer_fused, kw)
    finally:
        lf._force_form = forced
    torch.cuda.synchronize()
    if not torch.equal(again, out):
        raise AssertionError(f"{label}: the {other} form is not bitwise the "
                             f"{form} form")
    log("kernels", f"{label}: the {other} form bitwise equal to the {form} "
        f"form it takes")


def lf_on_device(name, kw_np):
    """A layer_fused case on the card (its weights as views off 4 bytes
    for the case that asks for it)."""
    kw = on_device(kw_np, "cuda")
    return off_by_4_bytes(kw) if name == "h_weights_off_4_bytes" else kw


def kernel_phase(card: str, main_inputs):
    """Phase 3: layer_fused against layer_fused_ref on the card."""
    cases = lf_cases()
    for name, kw in main_inputs.items():
        cases[name] = to_numpy(kw)
    rows = {}
    for name, kw_np in cases.items():
        with lf_forced(name):
            rows[name] = kernel_case(card, name, kw_np)
    return rows


def kernel_case(card, name, kw_np) -> dict:
    """One phase-3 case of layer_fused: its checks, then its timed row."""
    import torch
    from repro_torch.kernels import layer_fused as lf
    from repro_torch.kernels.layer_fused import layer_fused, layer_fused_ref
    tol = f"|k-p| <= {ATOL_OF_SCALE:g}*max(1,max|p|) + {RTOL:g}*|p|"
    kw = lf_on_device(name, kw_np)
    launch = lf._force_form or lf_form(kw_np)
    if name.startswith(LF_GRID_CASES) and launch != "grid":
        raise AssertionError(f"layer_fused {name} takes the {launch} "
                             f"form, not the grid form")
    out = call(layer_fused, kw)
    plain = call(layer_fused_ref, kw)
    torch.cuda.synchronize()
    err, rel, ok = close(out, plain)
    form = ("scalers" if "scalers" in kw_np else "field"
            if "field_wsum" in kw_np else "self")
    log("kernels", f"layer_fused {name}: {form} form, {launch} launch, "
        f"N={kw_np['x'].shape[0]} E={kw_np['senders'].shape[0]} "
        f"D_x={kw_np['x'].shape[1]} "
        f"D_in={kw_np['w1'].shape[0]} max_abs_err={err:.3e} "
        f"max_rel_err={rel:.3e} tol: {tol} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"layer_fused {name} disagrees with its "
                             f"plain version")
    # the output's bytes, to hold against another tree's run
    log("kernels", f"layer_fused {name}: output sha256 "
        f"{hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()}")
    epilogue_rows_check(name, kw, kw_np, layer_fused, layer_fused_ref)
    label = f"layer_fused {name}"
    bitwise_stable("kernels", label,
                   lambda **extra: call(layer_fused, kw, **extra), out,
                   (1, 3, 8, 16))
    other_form_check(label, kw, out, launch)
    replay = captured(lambda: call(layer_fused, kw))
    if not torch.equal(replay, out):
        raise AssertionError(f"{label}: the CUDA graph's replay is "
                             f"not bitwise the eager call")
    log("kernels", f"{label}: one layer captured in a CUDA graph, "
        f"replayed bitwise equal to the eager call")
    return timed_row(card, "kernels", label,
                     lambda: call(layer_fused, kw),
                     lambda: call(layer_fused_ref, kw),
                     lf_bound(dict(kw_np, edge_mask=owned_edges(kw_np))),
                     err=err, rel=rel)


# ---------------------------------------------------------------------------
# mp_pipeline cases
# ---------------------------------------------------------------------------

BIG = 1e30
# what an empty destination must hold, exactly, per output
MP_EMPTY = {"sum": 0.0, "sumsq": 0.0, "count": 0.0, "max": -BIG, "min": BIG,
            "att_max": -BIG, "att_denom": 0.0}


def mp_case(seed, n, e, d, *, stats, sw=None, edge_term=False, bias=False,
            relu=False, heads=0, empty_tail=0, mask_p=0.8, hub=0):
    """Numpy inputs of one mp_pipeline call (a dict of keyword args);
    ``hub`` edges, at random places in the stream, go to row N // 3."""
    r = np.random.default_rng(seed)
    kw = random_inputs(r, n, e, d, sw=sw, edge_term=edge_term,
                       bias="bias" if bias else None, empty_tail=empty_tail,
                       mask_p=mask_p)
    if hub:
        kw["receivers"][r.choice(e, size=hub, replace=False)] = n // 3
    kw["stats"] = stats
    kw["activation"] = "relu" if relu else "none"
    if heads:
        kw["att_src"] = r.normal(size=(n, heads)).astype(np.float32)
        kw["att_dst"] = r.normal(size=(n, heads)).astype(np.float32)
    return kw


def mp_bound(kw):
    """The least time (ms) the card could take for this call, the larger of
    two. Bytes at the memory rate: ``input_bytes``, then each output
    written once. Operations at the fp32 rate: those this run's data needs
    (per unmasked edge the phi terms and each statistic on every lane; with
    attention per edge and head the logit's add, its leaky_relu (2), the
    max, one exponential with its difference and the denominator's add, and
    per lane the weight's product and add; the normalisation)."""
    n, d = kw["x"].shape
    valid = int(kw["edge_mask"].sum())
    heads = kw["att_src"].shape[1] if "att_src" in kw else 0
    widths = {"sum": d, "sumsq": d, "count": 1, "max": d, "min": d}
    nbytes = input_bytes(kw) + sum(n * widths[s] * 4 for s in kw["stats"])
    nbytes += 2 * n * heads * 4                    # att_max, att_denom
    flops = 0
    lane_ops = (sum(k in kw for k in ("src_weight", "edge_term", "bias"))
                + (kw["activation"] == "relu"))
    if heads:
        lane_ops += 2
        flops += valid * heads * 7 + n * d + n * heads
    else:
        lane_ops += sum({"sum": 1, "sumsq": 2, "max": 1, "min": 1}.get(s, 0)
                        for s in kw["stats"])
    flops += valid * d * lane_ops + valid * ("count" in kw["stats"])
    return work_bound(nbytes, flops)


# the rows per block every case of the owner-bucketed kernels must be
# bitwise stable across
ROWS_PER_BLOCK = (1, 3, 8, 16)
# the mp_pipeline inputs placed off 16 bytes by the case ``n_views_off_16``
MP_FLOAT_INPUTS = ("x", "src_weight", "edge_term", "bias", "att_src",
                   "att_dst")


def mp_kernel_phase(card: str, main_inputs):
    """Phase 3: mp_pipeline against mp_pipeline_ref on the card."""
    import torch
    from repro_torch.kernels.mp_pipeline import mp_pipeline, mp_pipeline_ref
    all_stats = ("sum", "sumsq", "count", "max", "min")
    full = dict(stats=all_stats, sw="full", edge_term=True, bias=True,
                relu=True)
    att = dict(stats=("sum", "count"), heads=4)
    cases = {
        "a_all_stats_full_src_weight": mp_case(
            11, 1024, 4096, 100, stats=all_stats, sw="full", edge_term=True,
            bias=True, relu=True, empty_tail=64),
        "b_gcn_scalar_src_weight": mp_case(12, 1024, 4096, 100,
                                           stats=("sum",), sw="scalar",
                                           empty_tail=32),
        "c_ragged_head_src_weight": mp_case(13, 997, 3001, 64,
                                            stats=all_stats, sw="head",
                                            empty_tail=5),
        "d_attention_gat_width": mp_case(14, 1024, 4096, 64,
                                         stats=("sum", "count"), heads=4,
                                         empty_tail=64),
        "g_out_of_range_all_stats": out_of_range_case("mp_pipeline"),
        "h_out_of_range_attention": out_of_range_case("mp_pipeline",
                                                      heads=2),
        # the owner buckets' edge cases: a hub row (5,000 of 8,192 edges;
        # rows past 128 edges are put in stream order by a sweep of the
        # tile), every edge into one row, N > E with most rows empty, an E
        # past what a block buckets at once (16 tiles), inputs off 16 bytes
        "i_hub_row_attention": mp_case(15, 1024, 8192, 64, mask_p=1.0,
                                       hub=5000, **att),
        "j_hub_row_all_stats_full_src_weight": mp_case(
            16, 1024, 8192, 64, mask_p=1.0, hub=5000, **full),
        "k_every_edge_to_one_row_attention": mp_case(17, 64, 4096, 64,
                                                     hub=4096, **att),
        "k_every_edge_to_one_row_all_stats": mp_case(18, 64, 4096, 64,
                                                     hub=4096, **full),
        "l_more_rows_than_edges": mp_case(19, 8192, 1000, 64, **full),
        "l_more_rows_than_edges_attention": mp_case(20, 8192, 1000, 64,
                                                    **att),
        "m_edges_past_one_bucketing": mp_case(21, 4096, 65536, 64, **full),
        "m_edges_past_one_bucketing_attention": mp_case(22, 4096, 65536,
                                                        64, **att),
        "n_views_off_16_all_stats": mp_case(23, 1024, 4096, 100,
                                            empty_tail=64, **full),
        "n_views_off_16_attention": mp_case(24, 1024, 4096, 64,
                                            empty_tail=64, **att),
    }
    for name, kw in main_inputs.items():
        cases[name] = to_numpy(kw)
    tol = f"|k-p| <= {ATOL_OF_SCALE:g}*max(1,max|p|) + {RTOL:g}*|p|"
    rows = {}
    for name, kw_np in cases.items():
        kw = on_device(kw_np, "cuda")
        if name.startswith("n_views_off_16"):
            kw.update({k: placed(kw[k], "float32", 1)
                       for k in MP_FLOAT_INPUTS if k in kw})
        out = call(mp_pipeline, kw)
        plain = call(mp_pipeline_ref, kw)
        torch.cuda.synchronize()
        if tuple(out) != tuple(plain):
            raise AssertionError(f"mp_pipeline {name}: outputs {tuple(out)} "
                                 f"!= plain {tuple(plain)}")
        n = kw_np["x"].shape[0]
        reached = torch.from_numpy(degrees_of(kw_np) > 0).cuda()
        err, rel = 0.0, 0.0
        for stat, want in plain.items():
            got = out[stat]
            empty = MP_EMPTY[stat]
            if not (bool((got[~reached] == empty).all())
                    and bool((want[~reached] == empty).all())):
                raise AssertionError(f"mp_pipeline {name}: {stat} of empty "
                                     f"destinations is not {empty:g}")
            e_abs, e_rel, ok = close(got[reached], want[reached])
            err, rel = max(err, e_abs), max(rel, e_rel)
            if not ok:
                raise AssertionError(f"mp_pipeline {name}: {stat} disagrees "
                                     f"with its plain version ({e_abs:.3e})")
        n_empty = int((~reached).sum())
        log("kernels", f"mp_pipeline {name}: N={n} "
            f"E={kw_np['senders'].shape[0]} D={kw_np['x'].shape[1]} "
            f"stats {'+'.join(out)}; max_abs_err={err:.3e} "
            f"max_rel_err={rel:.3e} tol: {tol}; {n_empty} empty "
            f"destinations exact; longest row "
            f"{int(degrees_of(kw_np).max())} edges, x data_ptr % 16 = "
            f"{kw['x'].data_ptr() % 16}; ok")
        label = f"mp_pipeline {name}"
        bitwise_stable("kernels", label,
                       lambda **extra: call(mp_pipeline, kw, **extra), out,
                       ROWS_PER_BLOCK)
        rows[name] = timed_row(card, "kernels", label,
                               lambda: call(mp_pipeline, kw),
                               lambda: call(mp_pipeline_ref, kw),
                               mp_bound(dict(kw_np,
                                             edge_mask=owned_edges(kw_np))),
                               err=err, rel=rel)
    return rows


# ---------------------------------------------------------------------------
# the scatter kernels of impl='kernel': mp_scatter, mp_scatter_multi,
# seg_softmax
# ---------------------------------------------------------------------------

ALL_STATS = ("sum", "sumsq", "count", "max", "min")
# what an empty destination must hold, exactly, per mp_scatter_multi output
SCATTER_EMPTY = {"sum": 0.0, "sumsq": 0.0, "count": 0.0,
                 "max": -float("inf"), "min": float("inf")}
# seg_softmax vs its plain version: weights <= 1, exponentials and sums in
# another order (online rescale vs max first): the reference's 1e-5
SOFTMAX_TOL = 1e-5


def scatter_case(seed, n, e, d, *, kernel, stats=None, empty_tail=0,
                 mask_p=0.8, out_of_range=False, num_banks=None, hub=0,
                 dtype="float32", rows_of=0, slots=False):
    """Numpy inputs of one mp_scatter / mp_scatter_multi / seg_softmax call
    (a dict of keyword args, as the model code passes them); ``d`` is the
    message width or the head count (0: (E,) logits). ``out_of_range``
    draws receivers from [-4, N + 12): edges outside [0, N), masked and
    unmasked, which must add nothing. ``num_banks`` (seg_softmax) is
    passed on, and the first five edges go unmasked to the padding rows
    [N, n_pad) of the JAX kernel's banks (two to row N, three to row
    n_pad - 1), the sixth to row n_pad, past them. ``hub`` edges, at
    random places in the stream, go to row N // 3; with ``dtype``
    bfloat16 the messages are float32 values a bfloat16 holds exactly.
    ``rows_of`` > 0 sends each run of ``rows_of`` edges to one row (rows
    0, 1, ... in random stream order: rows of exactly that many edges);
    ``slots`` sends each unmasked edge to a slot of its own, as the MoE
    dispatch does, and each masked one past the buffer (row N)."""
    r = np.random.default_rng(seed)
    softmax = kernel == "seg_softmax"
    stream = r.normal(size=(e, d) if d else (e,)) * (3 if softmax else 1)
    lo, hi = (-4, n + 12) if out_of_range else (0, n - empty_tail)
    kw = {
        "logits" if softmax else "msg": stream.astype(np.float32),
        "receivers": r.integers(lo, hi, size=e).astype(np.int64),
        "edge_mask": r.random(e) < mask_p,
        "num_nodes": n,
    }
    if hub:
        kw["receivers"][r.choice(e, size=hub, replace=False)] = n // 3
    if rows_of:
        kw["receivers"] = (np.arange(e) // rows_of)[r.permutation(e)]
    if slots:
        own = kw["edge_mask"]
        kw["receivers"] = np.full(e, n, np.int64)
        kw["receivers"][own] = r.permutation(n)[:int(own.sum())]
    if dtype == "bfloat16":
        import torch
        kw["msg"] = torch.from_numpy(kw["msg"]).to(torch.bfloat16).float(
            ).numpy()
    if stats is not None:
        kw.update({f"want_{s}": s in stats for s in ALL_STATS})
    if num_banks is not None:
        n_pad = -(-n // num_banks) * num_banks
        kw["receivers"][:6] = [n, n, n_pad - 1, n_pad - 1, n_pad - 1, n_pad]
        kw["edge_mask"][:6] = True
        kw["num_banks"] = num_banks
    return kw


SCATTER_CASES = {
    "mp_scatter": {
        "a_gin_width": dict(n=1024, e=4096, d=100, empty_tail=64),
        "b_ragged_gcn_width": dict(n=997, e=3001, d=9, empty_tail=5),
        "c_fully_masked": dict(n=64, e=1024, d=100, mask_p=0.0),
        "d_out_of_range_receivers": dict(n=1024, e=4096, d=100,
                                         out_of_range=True),
        # the owner buckets' edge cases: a hub row (5,000 of 8,192 unmasked
        # edges; in the grid form a row longer than its warps sort is
        # folded by blocks, its segment sorted alone), every edge to one
        # row, N > E with most rows empty, E off every chunk of the grid,
        # bf16 rows that 16-byte loads cannot take (D = 2047), message
        # views off 16 bytes (``offset`` elements into their buffer) and
        # rows of 33-128 edges
        "e_hub_row_bf16_d2048": dict(n=1024, e=8192, d=2048, mask_p=1.0,
                                     hub=5000, dtype="bfloat16"),
        "f_hub_row_d100": dict(n=1024, e=8192, d=100, mask_p=1.0, hub=5000),
        "g_every_edge_to_one_row": dict(n=64, e=4096, d=100, hub=4096),
        "h_more_rows_than_edges": dict(n=8192, e=1000, d=100),
        "i_edges_off_the_chunk": dict(n=1000, e=8229, d=64),
        "j_bf16_d2047": dict(n=512, e=4096, d=2047, dtype="bfloat16"),
        "k_unaligned_view": dict(n=1024, e=4096, d=100, offset=1),
        "l_unaligned_view_bf16": dict(n=1024, e=4096, d=2048, offset=1,
                                      dtype="bfloat16"),
        "m_rows_of_33_to_128_edges": dict(n=64, e=4096, d=100),
        # rows of 129 edges throughout, one past the grid form's warp sort
        # (its long rows: 508 of them, each folded by a block), a hub row
        # at E = 4,096 (the block form), GAT impl='kernel' at the packed
        # buckets of 8 and 64 graphs, and olmoe-1b-7b's decode dispatch (2
        # tokens x 64 assignments into 512 slots) and combine
        "n_rows_of_129_edges": dict(n=509, e=65536, d=100, mask_p=1.0,
                                    rows_of=129),
        "o_hub_row_block_form": dict(n=1024, e=4096, d=100, mask_p=1.0,
                                     hub=2500),
        "p_gat_packed_n256": dict(n=256, e=512, d=64),
        "q_gat_packed_n2048": dict(n=2048, e=4096, d=64),
        "r_olmoe_decode_dispatch": dict(n=512, e=128, d=2048, mask_p=0.96,
                                        slots=True, dtype="bfloat16"),
        "s_olmoe_decode_combine": dict(n=2, e=128, d=2048, mask_p=0.96,
                                       rows_of=64),
    },
    "mp_scatter_multi": {
        "a_all_stats": dict(n=1024, e=4096, d=80, stats=ALL_STATS,
                            empty_tail=64),
        "b_pna_four_stats": dict(n=1024, e=4096, d=80,
                                 stats=("sum", "sumsq", "max", "min"),
                                 empty_tail=64),
        "c_dgn_sum_only": dict(n=1024, e=4096, d=200, stats=("sum",),
                               empty_tail=64),
        "d_fully_masked": dict(n=64, e=1024, d=80, stats=ALL_STATS,
                               mask_p=0.0),
        "e_out_of_range_receivers": dict(n=1024, e=4096, d=80,
                                         stats=ALL_STATS, out_of_range=True),
        # the owner buckets' edge cases (see mp_scatter's below)
        "f_hub_row_d100": dict(n=1024, e=8192, d=100, stats=ALL_STATS,
                               mask_p=1.0, hub=5000),
        "g_every_edge_to_one_row": dict(n=64, e=4096, d=80, stats=ALL_STATS,
                                        hub=4096),
        "h_more_rows_than_edges": dict(n=8192, e=1000, d=80,
                                       stats=ALL_STATS),
        "i_edges_off_the_chunk": dict(n=1000, e=8229, d=200,
                                      stats=("sum", "count", "max")),
        "j_bf16_d2047": dict(n=512, e=4096, d=2047, stats=("sum", "max"),
                             dtype="bfloat16"),
        "k_unaligned_view": dict(n=1024, e=4096, d=80, stats=ALL_STATS,
                                 offset=1),
        "l_rows_of_33_to_128_edges": dict(n=64, e=4096, d=80,
                                          stats=ALL_STATS),
        "m_rows_of_129_edges": dict(n=509, e=65536, d=80, stats=ALL_STATS,
                                    mask_p=1.0, rows_of=129),
        "n_hub_row_block_form": dict(n=1024, e=4096, d=100, stats=ALL_STATS,
                                     mask_p=1.0, hub=2500),
    },
    "seg_softmax": {
        "a_gat_heads": dict(n=1024, e=4096, d=4, empty_tail=64),
        "b_ragged_1d": dict(n=997, e=3001, d=0, empty_tail=5),
        "c_fully_masked": dict(n=64, e=1024, d=4, mask_p=0.0),
        "d_out_of_range_receivers": dict(n=1024, e=4096, d=4,
                                         out_of_range=True),
        # edges into the JAX kernel's padding rows [N, ceil(N, banks))
        "e_padding_row_receivers": dict(n=30, e=40, d=2, mask_p=1.0,
                                        num_banks=4),
        "f_padding_row_receivers_1d": dict(n=29, e=40, d=0, mask_p=1.0,
                                           num_banks=8),
        # the owner buckets' edge cases (see mp_scatter's above; E=65,536
        # is past what a block buckets at once: 16 tiles, swept twice)
        "g_hub_row": dict(n=1024, e=8192, d=4, mask_p=1.0, hub=5000),
        "h_every_edge_to_one_row": dict(n=64, e=4096, d=4, hub=4096),
        "i_more_rows_than_edges": dict(n=8192, e=1000, d=4),
        "j_edges_past_one_bucketing": dict(n=4096, e=65536, d=4),
        "k_unaligned_view": dict(n=1024, e=4096, d=4, offset=1,
                                 empty_tail=64),
    },
}


def owned(kw_np):
    """The edges a scatter keeps: unmasked, with a receiver in [0, N) (for
    seg_softmax [0, n_pad), the JAX kernel's rows padded to a multiple of
    ``num_banks``)."""
    rcv = kw_np["receivers"]
    rows = kw_np["num_nodes"]
    if "logits" in kw_np:
        from repro_torch.kernels.seg_softmax import padded_rows
        rows = padded_rows(rows, kw_np.get("num_banks", 4))
    return kw_np["edge_mask"] & (rcv >= 0) & (rcv < rows)


def stats_of(kw):
    return tuple(s for s in ALL_STATS if kw.get(f"want_{s}"))


def scatter_plain(kernel, kw):
    """The plain version's outputs as a dict of named tensors."""
    from repro_torch.kernels import ops
    pos = KERNEL_POSITIONAL[kernel]
    args = [kw[k] for k in pos]
    if kernel == "mp_scatter":
        return {"sum": ops.mp_scatter_ref(*args)}
    if kernel == "mp_scatter_multi":
        return ops.mp_scatter_multi_ref(*args, stats_of(kw))
    return {"weights": ops.segment_softmax_ref(
        *args, num_banks=kw.get("num_banks", 4))}


def scatter_kernel(kernel, kw, **extra):
    """The kernel wrapper's outputs as a dict of named tensors."""
    from repro_torch.kernels import ops
    out = call(getattr(ops, kernel), kw, KERNEL_POSITIONAL[kernel], **extra)
    if kernel == "mp_scatter":
        return {"sum": out}
    if kernel == "seg_softmax":
        return {"weights": out}
    return out


def work_bound(nbytes, flops, dtype="float32"):
    """(least ms, what bounds it, bytes, operations): the larger of the
    bytes at the card's memory rate and the operations at its peak for
    ``dtype`` (``launch/roofline.py``: bf16 on the tensor cores, float32
    outside them)."""
    from repro_torch.launch import roofline
    t_bytes = nbytes / roofline.HBM_BW * 1e3
    t_ops = flops / (roofline.PEAK_FLOPS if dtype == "bfloat16"
                     else roofline.PEAK_FP32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def scatter_bound(kernel, kw):
    """The least time (ms) the card could take for this call: the work of
    ``kernels/cost.py::scatter_work`` for the edges this run keeps
    (unmasked, receiver in range), its operations at the fp32 rate."""
    from repro_torch.kernels import cost
    x = kw["logits" if kernel == "seg_softmax" else "msg"]
    width = x.shape[1] if x.ndim == 2 else 1
    return work_bound(*cost.scatter_work(
        kernel, x.shape[0], width, kw["num_nodes"], x.dtype.itemsize,
        valid=int(owned(kw).sum()),
        stats=stats_of(kw) if kernel == "mp_scatter_multi" else ("sum",)))


def gather_bound(y, idx, mask):
    """The least time (ms) of ``gather_rows`` on these inputs: the bytes of
    ``kernels/cost.py::gather_rows_work`` for the rows whose mask is set, at
    the memory rate (it does no arithmetic)."""
    from repro_torch.kernels import cost
    return work_bound(*cost.gather_rows_work(
        idx.shape[0], y.shape[1], y.element_size(), valid=int(mask.sum())))


INDEX_ADD_TXT = "library index_add_ (atomics, order not fixed)"
# a bf16 sum against the plain version's f32 one: rounding to the nearest
# bf16 moves a value by at most half a bf16 unit, 2^-8 of it (8 significant
# bits), on top of the f32 sums' other order (the atol)
BF16_SUM_RTOL = 2.0 ** -8


def library_call(kernel, kw, plain):
    """One PyTorch call that computes the kernel's function, where there is
    one: ``index_add_`` of the stream into an (N+1, D) buffer of the
    messages' dtype, masked and out-of-range edges routed to row N
    (mp_scatter, and mp_scatter_multi asked for the sum alone). It
    accumulates with atomics, in no fixed order, and in bf16 for bf16
    messages: the same function only where each row takes at most one
    message, as in the MoE dispatch. None where no one call computes the
    function."""
    import torch
    if kernel == "seg_softmax" or (kernel == "mp_scatter_multi"
                                   and stats_of(kw) != ("sum",)):
        return None
    msg, n = kw["msg"], kw["num_nodes"]
    rcv = kw["receivers"]
    own = kw["edge_mask"] & (rcv >= 0) & (rcv < n)
    if (msg.dtype == torch.bfloat16 and bool(own.any())
            and int(torch.bincount(rcv[own]).max()) > 1):
        return None
    rcv = torch.where(own, rcv, n)
    buf = torch.zeros((n + 1, msg.shape[1]), dtype=msg.dtype,
                      device=msg.device)
    check = buf.clone().index_add_(0, rcv, msg)[:n]
    _, _, ok = close(check.float(), plain["sum"].float())
    if not ok:
        raise AssertionError(f"{kernel}: index_add_ disagrees with the "
                             f"plain version")
    return lambda: buf.index_add_(0, rcv, msg)


def placed(msg, dtype: str, offset: int):
    """``msg`` on the card as ``dtype``; ``offset`` > 0 puts it that many
    elements into a larger buffer, so that its data pointer is off 16
    bytes."""
    import torch
    buf = torch.empty(msg.numel() + offset, dtype=getattr(torch, dtype),
                      device="cuda")
    view = buf[offset:].view(msg.shape)
    view.copy_(msg)
    return view


STREAM_ORDER_TXT = ("torch.equal to the float32 stream-order fold on the "
                    "host (np.add.at / maximum.at / minimum.at)")


def stream_order_ref(kernel, kw_np, dtype: str = "float32"):
    """What mp_scatter / mp_scatter_multi must return bitwise: each row's
    owned edges folded in stream order in float32 on the host, from 0,
    -inf and +inf (numpy's unbuffered ``ufunc.at``; squares taken in f32),
    count by ones; mp_scatter's sum rounded to ``dtype`` (nearest even).
    ``kw_np['msg']`` holds the messages' values as float32."""
    import torch
    msg = kw_np["msg"].astype(np.float32)
    n, d = kw_np["num_nodes"], msg.shape[1]
    keep = owned(kw_np)
    idx, m = kw_np["receivers"][keep], msg[keep]
    stats = ("sum",) if kernel == "mp_scatter" else stats_of(kw_np)
    out = {}
    for stat in stats:
        if stat == "count":
            a = np.zeros((n, 1), np.float32)
            np.add.at(a, idx, np.float32(1.0))
        elif stat in ("max", "min"):
            a = np.full((n, d), -np.inf if stat == "max" else np.inf,
                        np.float32)
            (np.maximum if stat == "max" else np.minimum).at(a, idx, m)
        else:
            a = np.zeros((n, d), np.float32)
            np.add.at(a, idx, m if stat == "sum" else m * m)
        out[stat] = torch.from_numpy(a).cuda()
    if kernel == "mp_scatter":
        out["sum"] = out["sum"].to(getattr(torch, dtype))
    return out


def check_stream_order(label, out, ref) -> None:
    """Raise unless every output is bitwise its stream-order reference."""
    import torch
    for stat, want in ref.items():
        if not torch.equal(out[stat], want):
            bad = int((out[stat] != want).sum())
            raise AssertionError(f"{label}: {stat} is not bitwise the "
                                 f"stream-order fold ({bad} values differ)")


def scatter_grid(kernel, kw, rows_per_block=None) -> str:
    """How mp_scatter.cu launches this call: its form, its grid, the rows a
    block takes and its dynamic shared memory."""
    from repro_torch.kernels.mp_scatter import launch_plan
    msg = kw["msg"]
    plan = launch_plan(kw["num_nodes"], msg.shape[0], msg.shape[1],
                       msg.dtype, multi=kernel == "mp_scatter_multi",
                       rows_per_block=rows_per_block)
    grid = (f"{plan['grid']} x {plan['chunks']} blocks" if plan["form"] ==
            "block" else f"{plan['grid']} cooperative blocks")
    return (f"{plan['form']} form, {grid} of {plan['rows']} rows, "
            f"{plan['smem']} bytes of shared memory")


def ptxas_report(name: str, instance) -> dict:
    """Per kernel instantiation of ``csrc/<name>.cu``, under the key
    ``instance(mangled entry name)`` gives (None skips the entry):
    registers, spill bytes and shared memory from the build's ``-Xptxas
    -v`` log."""
    import re
    from repro_torch.kernels import build
    log_text = build.library_path(name).with_suffix(".log").read_text()
    report, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = instance(m.group(1))
            if cur is not None:
                report[cur] = {"registers": None, "spill_stores": None,
                               "spill_loads": None, "smem": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[cur]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[cur]["spill_stores"] = int(m.group(1))
            report[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            report[cur]["smem"] = int(m.group(1))
    return report


def scatter_build_report() -> dict:
    """Per instantiation of csrc/mp_scatter.cu's kernel (message type,
    multi or sum alone, form; the grid form's slices a lane and edges in
    flight): registers, spill bytes and shared memory from the build's
    ``-Xptxas -v`` log."""
    import re

    def instance(symbol):
        k = re.search(r"mp_scatter_kernelI(\w+?)Li(\d)ELi(\d)ELb(\d)E"
                      r"Lb(\d)E", symbol)
        if k is None:
            return None
        grid = k.group(5) == "1"
        return (f"{'bf16' if 'bfloat16' in k.group(1) else 'f32'} "
                f"{'multi' if k.group(4) == '1' else 'sum'} "
                + (f"grid S={k.group(2)} U={k.group(3)}" if grid
                   else "block"))
    report = ptxas_report("mp_scatter", instance)
    for name, info in sorted(report.items()):
        log("kernels", f"mp_scatter.cu instantiation {name}: "
            f"{info['registers']} registers, spill stores/loads "
            f"{info['spill_stores']}/{info['spill_loads']} bytes, "
            f"{info['smem']} bytes shared memory (ptxas -v log)")
    if len(report) != 10:
        raise AssertionError(f"mp_scatter.cu: {len(report)} kernel "
                             f"instantiations in the ptxas log, expected 10")
    return report


# mp_pipeline.cuh's forms by their template arguments (src_weight mode, edge
# term, bias, relu, attention, statistics, check_src, generic)
PIPELINE_FORMS = {
    ("0", "0", "0", "0", "1", "1", "0", "0"): "GAT attention",
    ("0", "1", "0", "1", "0", "1", "0", "0"): "GIN sum",
    ("1", "0", "0", "0", "0", "1", "0", "0"): "GCN scalar src_weight",
    ("0", "1", "1", "1", "0", "15", "0", "0"): "PNA four statistics",
    ("2", "0", "0", "0", "0", "1", "0", "0"): "DGN full src_weight",
    ("0", "1", "0", "1", "0", "1", "1", "0"): "fused_nt_scatter check_src",
    ("n1", "1", "1", "1", "0", "15", "0", "1"): "generic",
    ("n1", "1", "1", "1", "1", "1", "0", "1"): "generic attention",
}
# the NT form (NtFormOf<edge_feat type>): its Form's arguments and types
NT_FORM_ARGS = ("0", "1", "0", "1", "0", "1", "1", "0")
NT_EDGE_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def nt_build_report() -> dict:
    """Per instantiation of the NT tile (csrc/nt_tile.cuh's kernel, by its
    operand and y types, in nt_mlp.cu and fused_nt_scatter.cu): registers,
    spill bytes and static shared memory from the builds' ``-Xptxas -v``
    logs."""
    import re
    names = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}

    def tile(symbol):
        m = re.search(r"mlp_tile_kernelI(f|13__nv_bfloat16|6__half)"
                      r"(f|S2_)E", symbol)
        return None if m is None else (
            f"{names[m.group(1)]} -> "
            f"{'f32' if m.group(2) == 'f' else names[m.group(1)]}")
    report = {}
    for source in ("nt_mlp", "fused_nt_scatter"):
        found = ptxas_report(source, tile)
        for name, info in sorted(found.items()):
            log("nt", f"{source}.cu NT tile {name}: "
                f"{info['registers']} registers, spill stores/loads "
                f"{info['spill_stores']}/{info['spill_loads']} bytes, "
                f"{info['smem']} bytes static shared memory (ptxas -v log)")
        if len(found) != 3:
            raise AssertionError(f"{source}.cu: {len(found)} NT tile "
                                 f"instantiations in the ptxas log, "
                                 f"expected 3")
        report.update({f"{source}: {k}": v for k, v in found.items()})
    return report


def pipeline_build_report() -> dict:
    """Per instantiation of the owner-bucketed kernels (mp_pipeline.cuh's
    forms in mp_pipeline.cu and fused_nt_scatter.cu, seg_softmax.cu's
    kernel): registers, spill bytes and static shared memory from the
    builds' ``-Xptxas -v`` logs."""
    import re

    def form(symbol):
        nt = re.search(r"mp_pipeline_kernelI\w*?NtFormOfI(f|13__nv_bfloat16"
                       r"|6__half)E", symbol)
        if nt is not None:   # the NT form, by its edge_feat type
            return (f"{PIPELINE_FORMS[NT_FORM_ARGS]}, edge_feat "
                    f"{NT_EDGE_TYPES[nt.group(1)]}")
        m = re.search(r"mp_pipeline_kernelI\w*?FormILi(n?\d+)ELb(\d)ELb(\d)"
                      r"ELb(\d)ELb(\d)ELi(\d+)ELb(\d)ELb(\d)E", symbol)
        return None if m is None else PIPELINE_FORMS.get(m.groups(),
                                                         str(m.groups()))
    report = {}
    for source, instance, want in (
            ("mp_pipeline", form, len(PIPELINE_FORMS)),
            ("fused_nt_scatter", form, 3),
            ("seg_softmax", lambda sym: "seg_softmax"
             if "seg_softmax_kernel" in sym else None, 1)):
        found = ptxas_report(source, instance)
        for name, info in sorted(found.items()):
            log("kernels", f"{source}.cu instantiation {name}: "
                f"{info['registers']} registers, spill stores/loads "
                f"{info['spill_stores']}/{info['spill_loads']} bytes, "
                f"{info['smem']} bytes static shared memory (ptxas -v log)")
        if len(found) != want:
            raise AssertionError(f"{source}.cu: {len(found)} kernel "
                                 f"instantiations in the ptxas log, expected "
                                 f"{want}")
        report.update({f"{source}: {k}": v for k, v in found.items()})
    return report


def scatter_forms_check(label, kernel, kw, out) -> str:
    """mp_scatter / mp_scatter_multi in the form the wrapper did not pick
    (where that form takes the call: the block form holds at most 4,096
    edges) and replayed from a CUDA graph: raise unless both are bitwise
    ``out``; what was checked."""
    import torch
    from repro_torch.kernels import mp_scatter as ms
    msg = kw["msg"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    form = ms.launch_form(kw["num_nodes"], msg.shape[0], msg.shape[1],
                          msg.dtype, kernel == "mp_scatter_multi", None, sms)
    other = "grid" if form == "block" else "block"
    done = []
    if other == "grid" or msg.shape[0] <= ms.LOCAL_EDGES:
        ms._force_form = other
        try:
            again = scatter_kernel(kernel, kw)
            plan = scatter_grid(kernel, kw)
        finally:
            ms._force_form = None
        torch.cuda.synchronize()
        if not all(torch.equal(again[k], out[k]) for k in out):
            raise AssertionError(f"{label}: the {other} form is not bitwise "
                                 f"the {form} form")
        done.append(f"the {other} form ({plan}) bitwise equal")
    replayed = captured(lambda: scatter_kernel(kernel, kw))
    if not all(torch.equal(replayed[k], out[k]) for k in out):
        raise AssertionError(f"{label}: the CUDA graph's replay is not "
                             f"bitwise the eager call")
    done.append("captured in a torch.cuda.CUDAGraph and replayed: bitwise "
                "equal")
    return "; ".join(done)


def scatter_kernel_phase(card: str, kernel: str, main_inputs):
    """Phase 3: one scatter kernel of impl='kernel' against its plain
    version on the card, on synthetic cases and the main path's inputs;
    mp_scatter and mp_scatter_multi also bitwise against the stream-order
    fold, in the other form and from a CUDA graph's replay, with their
    launch plan printed."""
    import torch
    cases, layout = {}, {}
    for i, (name, spec) in enumerate(SCATTER_CASES[kernel].items()):
        spec = dict(spec)
        offset = spec.pop("offset", 0)
        layout[name] = (spec.get("dtype", "float32"), offset)
        cases[name] = scatter_case(11 + i, kernel=kernel, **spec)
    for name, kw in main_inputs.items():
        cases[name] = to_numpy(kw)
    rows = {}
    for name, kw_np in cases.items():
        dtype, offset = layout.get(name, ("float32", 0))
        kw = on_device(kw_np, "cuda")
        stream = "logits" if kernel == "seg_softmax" else "msg"
        kw[stream] = placed(kw[stream], dtype, offset)
        if kernel == "seg_softmax":
            rtol, atol = SOFTMAX_TOL, SOFTMAX_TOL
        elif kernel == "mp_scatter" and dtype == "bfloat16":
            rtol, atol = BF16_SUM_RTOL, ATOL_OF_SCALE
        else:
            rtol, atol = RTOL, ATOL_OF_SCALE
        tol = f"|k-p| <= {atol:g}*max(1,max|p|) + {rtol:g}*|p|"
        out = scatter_kernel(kernel, kw)
        plain = scatter_plain(kernel, kw)
        torch.cuda.synchronize()
        if tuple(out) != tuple(plain):
            raise AssertionError(f"{kernel} {name}: outputs {tuple(out)} != "
                                 f"plain {tuple(plain)}")
        keep_np = owned(kw_np)
        n = kw_np["num_nodes"]
        if kernel == "seg_softmax":
            # a masked or out-of-range edge, and so every edge of an empty
            # destination, weighs exactly 0 on both sides
            empty = ~torch.from_numpy(keep_np).cuda()
            what = (f"{int(empty.sum())} masked or out-of-range edges "
                    f"exactly 0")
        else:
            reached = np.zeros(n, bool)
            reached[kw_np["receivers"][keep_np]] = True
            empty = ~torch.from_numpy(reached).cuda()
            what = (f"{int(empty.sum())} empty destinations exactly "
                    + ", ".join(f"{s} {SCATTER_EMPTY[s]:g}" for s in out))
        err, rel = 0.0, 0.0
        for stat, want in plain.items():
            got = out[stat]
            neutral = SCATTER_EMPTY.get(stat, 0.0)
            if not (bool((got[empty] == neutral).all())
                    and bool((want[empty] == neutral).all())):
                raise AssertionError(f"{kernel} {name}: {stat} is not "
                                     f"{neutral:g} where it must be")
            keep = ~empty
            if bool(keep.any()):
                e_abs, e_rel, ok = close(got[keep].float(), want[keep],
                                         rtol, atol)
                err, rel = max(err, e_abs), max(rel, e_rel)
                if not ok:
                    raise AssertionError(f"{kernel} {name}: {stat} disagrees "
                                         f"with its plain version "
                                         f"({e_abs:.3e})")
        label = f"{kernel} {name}"
        longest = int(np.bincount(kw_np["receivers"][keep_np],
                                  minlength=1).max()) if keep_np.any() else 0
        layout_txt = (f"data_ptr % 16 = {kw[stream].data_ptr() % 16}, "
                      f"longest row {longest} edges")
        if kernel == "seg_softmax":
            what += f" ({layout_txt})"
        else:
            check_stream_order(label, out,
                               stream_order_ref(kernel, kw_np, dtype))
            what += (f"; {STREAM_ORDER_TXT} ({dtype}, {layout_txt}); "
                     f"{scatter_grid(kernel, kw)}; "
                     f"{scatter_forms_check(label, kernel, kw, out)}")
        shape = tuple(kw_np["logits" if kernel == "seg_softmax"
                            else "msg"].shape)
        log("kernels", f"{label}: N={n} E x width={shape} "
            f"outputs {'+'.join(out)}; max_abs_err={err:.3e} "
            f"max_rel_err={rel:.3e} tol: {tol}; {what}; ok")
        bitwise_stable("kernels", label,
                       lambda **extra: scatter_kernel(kernel, kw, **extra),
                       out, ROWS_PER_BLOCK)
        rows[name] = timed_row(card, "kernels", label,
                               lambda: scatter_kernel(kernel, kw),
                               lambda: scatter_plain(kernel, kw),
                               scatter_bound(kernel, kw), err=err, rel=rel,
                               library=library_call(kernel, kw, plain),
                               library_txt=INDEX_ADD_TXT)
    return rows


# ---------------------------------------------------------------------------
# the NT kernels: nt_mlp and fused_nt_scatter
# ---------------------------------------------------------------------------

GIN_MLP = (100, 200, 100)          # the paper's GIN update MLP
STD_MLP = (64, 128, 64)            # the standard point's MLP
MLP_POSITIONAL = ("x", "w1", "b1", "w2", "b2")
FUSED_POSITIONAL = MLP_POSITIONAL + ("senders", "receivers", "edge_mask",
                                     "edge_feat")


def serving_buckets(device: str = "cuda"):
    """The two serving buckets' padded batches, one graph each: (key,
    bucket name, batch) for molhiv (32/64) and hep (64/1024)."""
    from repro_torch.core.graph import build_graph_batch, pad_bucket
    from repro_torch.data.graphs import hep_like, molhiv_like
    for key, bucket, g in (
            ("e", "molhiv_bucket", next(molhiv_like(seed=0, n_graphs=1))),
            ("f", "hep_bucket", next(hep_like(seed=2, n_graphs=1)))):
        yield key, bucket, build_graph_batch(
            g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
            node_pos=g.node_pos, node_pad=pad_bucket(g.node_feat.shape[0]),
            edge_pad=pad_bucket(g.senders.shape[0]), device=device)


def edge_stream(batch):
    """A padded batch's (senders, receivers, edge_mask) in numpy."""
    return tuple(t.cpu().numpy() for t in (batch.senders, batch.receivers,
                                           batch.edge_mask))


def nt_case(seed, n, mlp, edges=None):
    """Numpy inputs of one nt_mlp call and, given an edge stream (senders,
    receivers, edge_mask), of one fused_nt_scatter call: x, glorot weights,
    small biases, and random edge features."""
    r = np.random.default_rng(seed)
    d_in, d_ff, d = mlp
    kw = {"x": r.normal(size=(n, d_in)).astype(np.float32),
          "w1": glorot(r, d_in, d_ff),
          "b1": (0.1 * r.normal(size=(d_ff,))).astype(np.float32),
          "w2": glorot(r, d_ff, d),
          "b2": (0.1 * r.normal(size=(d,))).astype(np.float32)}
    if edges is not None:
        kw["senders"], kw["receivers"], kw["edge_mask"] = edges
        kw["edge_feat"] = r.normal(size=(len(edges[0]), d)).astype(
            np.float32)
    return kw


def nt_cases(graphs) -> dict:
    """Phase 5's main-path cases in numpy, {kernel: {name: inputs}}: GIN's
    MLP at N=32, 64 and 1024 and the standard point's for nt_mlp; GIN's on
    the serving buckets' edge streams (``graphs``: bucket name ->
    (senders, receivers, edge_mask)) and the standard point for
    fused_nt_scatter."""
    r = np.random.default_rng(21)
    n_std, e_std = 1024, 4096
    standard = (r.integers(0, n_std, size=e_std).astype(np.int64),
                r.integers(0, n_std - 64, size=e_std).astype(np.int64),
                r.random(e_std) < 0.8)
    return {
        "nt_mlp": {
            "a_gin_molhiv_bucket": nt_case(31, 32, GIN_MLP),
            "b_gin_hep_bucket": nt_case(32, 64, GIN_MLP),
            "c_gin_n1024": nt_case(33, 1024, GIN_MLP),
            "d_standard_point": nt_case(34, 1024, STD_MLP),
        },
        "fused_nt_scatter": {
            "a_gin_molhiv_bucket": nt_case(35, 32, GIN_MLP,
                                           graphs["molhiv_bucket"]),
            "b_gin_hep_bucket": nt_case(36, 64, GIN_MLP,
                                        graphs["hep_bucket"]),
            "c_standard_point": nt_case(37, n_std, STD_MLP, standard),
        },
    }


# bytes of one value of each dtype the NT kernels take
NT_ELEM = {"float32": 4, "bfloat16": 2, "float16": 2}
# the float operands of an NT call: those a case's "dtype" applies to
NT_FLOATS = ("x", "w1", "b1", "w2", "b2", "edge_feat")
# half a unit in the last place of a 16-bit result, relative to it: what
# rounding the kernel's f32 result into x's dtype adds (8 significant bits
# in bf16, 11 in f16)
NT_ROUNDING = {"float32": 0.0, "bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


def nt_extra_cases(graphs) -> dict:
    """Phase 5's cases beside the main path's: GIN's MLP on the hep bucket
    with bf16 and f16 operands (``dtype``), odd widths (d_in 9, d_ff 25:
    short quads, weight chunks off 4 floats) at N=997 (not a multiple of
    any rows per block), and weights, biases and x as views 4 bytes into
    buffers of their own (``offset``: off 16 bytes)."""
    r = np.random.default_rng(22)
    n_odd, e_odd = 997, 3001
    ragged = (r.integers(0, n_odd, size=e_odd).astype(np.int64),
              r.integers(0, n_odd, size=e_odd).astype(np.int64),
              r.random(e_odd) < 0.8)
    hep = graphs["hep_bucket"]
    out = {"nt_mlp": {}, "fused_nt_scatter": {}}
    for i, dt in enumerate(("bfloat16", "float16")):
        out["nt_mlp"][f"e_gin_hep_bucket_{dt}"] = dict(
            nt_case(38 + i, 64, GIN_MLP), dtype=dt)
        out["fused_nt_scatter"][f"d_gin_hep_bucket_{dt}"] = dict(
            nt_case(40 + i, 64, GIN_MLP, hep), dtype=dt)
    out["nt_mlp"]["f_odd_widths_d9_dff25"] = nt_case(42, n_odd, (9, 25, 9))
    out["fused_nt_scatter"]["e_odd_widths_d9_dff25"] = nt_case(
        43, n_odd, (9, 25, 9), ragged)
    out["nt_mlp"]["g_gin_n1024_views_off_16_bytes"] = dict(
        nt_case(44, 1024, GIN_MLP), offset=4)
    standard = (r.integers(0, 1024, size=4096).astype(np.int64),
                r.integers(0, 1024 - 64, size=4096).astype(np.int64),
                r.random(4096) < 0.8)
    out["fused_nt_scatter"]["f_standard_point_views_off_16_bytes"] = dict(
        nt_case(45, 1024, STD_MLP, standard), offset=4)
    return out


def nt_on_device(kw):
    """A phase-5 case's tensors on the card: the float operands in the
    case's ``dtype`` (float32 by default), each a view ``offset`` bytes into
    a buffer of its own where the case gives one."""
    import torch
    dt = getattr(torch, kw.get("dtype", "float32"))
    offset = kw.get("offset", 0)
    out = {}
    for k, v in kw.items():
        if k in ("dtype", "offset"):
            continue
        t = torch.from_numpy(v).to("cuda")
        if k in NT_FLOATS:
            t = t.to(dt)
            if offset:
                skip = offset // t.element_size()
                buf = torch.empty(t.numel() + skip, dtype=dt, device="cuda")
                buf[skip:].copy_(t.reshape(-1))
                t = buf[skip:].view(t.shape)
        out[k] = t
    return out


def mlp_flops(kw):
    """The MLP's operations: both products, the two biases and the relu."""
    n = kw["x"].shape[0]
    d_in, d_ff = kw["w1"].shape
    d = kw["w2"].shape[1]
    return 2 * n * (d_in * d_ff + d_ff * d) + 2 * n * d_ff + n * d


def nt_bound(kw):
    """The least time (ms) the card could take for this call, the larger of
    two. Bytes at the memory rate: x and the weights read once (in the
    case's dtype), the edge mask once, the unmasked in-range edges' indices
    (at ``kernels/cost.py::INDEX_BYTES``) and features once, the output
    written once (nt_mlp's in x's dtype, fused_nt_scatter's in f32).
    Operations at the fp32 rate: the MLP's (``mlp_flops``), then per such
    edge and lane the add, the relu and the sum."""
    from repro_torch.kernels.cost import INDEX_BYTES
    n = kw["x"].shape[0]
    d = kw["w2"].shape[1]
    elem = NT_ELEM[kw.get("dtype", "float32")]
    fused = "senders" in kw
    nbytes = (sum(kw[k].size for k in MLP_POSITIONAL) * elem
              + (4 if fused else elem) * n * d)
    flops = mlp_flops(kw)
    if fused:
        keep = (kw["edge_mask"] & (kw["senders"] >= 0) & (kw["senders"] < n)
                & (kw["receivers"] >= 0) & (kw["receivers"] < n))
        valid = int(keep.sum())
        nbytes += kw["edge_mask"].nbytes + valid * (2 * INDEX_BYTES
                                                    + elem * d)
        flops += 3 * valid * d
    return work_bound(nbytes, flops)


def nt_library_chain(kernel, kw, want):
    """The PyTorch calls that compute the case's function, where its
    operands are float32 (cuBLAS, TF32 off), checked against the plain
    version ``want``: for nt_mlp the three calls addmm -> relu_ -> addmm;
    for fused_nt_scatter those, then index_select of y's sender rows, the
    add of edge_feat, relu_, and index_add_ into an (N+1, D) buffer zeroed
    first (atomics, order not fixed; masked and out-of-range edges routed
    to row N). None for 16-bit operands (cuBLAS would round h and y into
    them)."""
    import torch
    x, w1, b1, w2, b2 = (kw[k] for k in MLP_POSITIONAL)
    if x.dtype != torch.float32:
        return None

    def mlp():
        return torch.addmm(b2, torch.addmm(b1, x, w1).relu_(), w2)
    chain = mlp
    if kernel == "fused_nt_scatter":
        n = x.shape[0]
        snd, rcv, ef = kw["senders"], kw["receivers"], kw["edge_feat"]
        keep = (kw["edge_mask"] & (snd >= 0) & (snd < n) & (rcv >= 0)
                & (rcv < n))
        src = torch.where(keep, snd, 0)
        dst = torch.where(keep, rcv, n)
        buf = torch.empty((n + 1, w2.shape[1]), device=x.device)

        def chain():
            msg = (mlp().index_select(0, src) + ef).relu_()
            return buf.zero_().index_add_(0, dst, msg)[:n]
    c = chain()
    torch.cuda.synchronize()
    if not close(c, want)[2]:
        raise AssertionError(f"{kernel}: the library chain disagrees with "
                             f"the plain version")
    return chain


NT_CHAIN_TXT = {
    "nt_mlp": "three calls addmm -> relu_ -> addmm (cuBLAS, TF32 off)",
    "fused_nt_scatter": "chain addmm -> relu_ -> addmm, index_select, add, "
                        "relu_, zero_, index_add_ (atomics, order not "
                        "fixed)"}


def nt_phase(card: str, graphs):
    """nt_mlp and fused_nt_scatter driven through their ``ops`` entry
    points at GIN's widths on the serving buckets' graphs and at the
    standard point, and on the extra cases (``nt_extra_cases``: bf16 and
    f16 operands, odd widths, views off 16 bytes), with the launch counts
    set to 0 just before and read just after; then each against its plain
    version, fused_nt_scatter also bitwise against nt_mlp followed by
    mp_pipeline's relu(y[src] + edge_term) sum on the operands widened to
    float32, both bitwise across runs and rows per block, and timed beside
    their library chains. ``graphs`` maps a bucket's name to its padded
    graph's (senders, receivers, edge_mask) in numpy."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.mp_pipeline import mp_pipeline
    cases = nt_cases(graphs)
    for kernel, extra in nt_extra_cases(graphs).items():
        cases[kernel].update(extra)
    dev = {k: {name: nt_on_device(kw) for name, kw in c.items()}
           for k, c in cases.items()}

    def run(kernel, kw, **extra):
        if kernel == "nt_mlp":
            return call(ops.nt_mlp, kw, MLP_POSITIONAL, node_tile=1,
                        k_tile=1, **extra)
        return call(ops.fused_nt_scatter, kw, FUSED_POSITIONAL,
                    node_tile=1, **extra)

    def plain(kernel, kw):
        if kernel == "nt_mlp":
            return call(ops.nt_mlp_ref, kw, MLP_POSITIONAL)
        # the oracle's order: edge_feat before edge_mask
        return call(ops.fused_nt_scatter_ref, kw, MLP_POSITIONAL + (
            "senders", "receivers", "edge_feat", "edge_mask"))

    # the path: every case once through the entry points
    outs, launches = counted(lambda: {
        k: {name: run(k, kw) for name, kw in c.items()}
        for k, c in dev.items()})
    check_launches("nt", "ops.nt_mlp and ops.fused_nt_scatter on every case",
                   launches, {"nt_mlp": len(cases["nt_mlp"]),
                              "fused_nt_scatter":
                                  2 * len(cases["fused_nt_scatter"])},
                   "one a call, two a call")
    log("nt", "fused_nt_scatter: its second launch goes through "
        "cudaLaunchKernelEx with cudaLaunchAttributeProgrammaticStream"
        "Serialization (programmaticStreamSerializationAllowed = 1), "
        "mp_pipeline.cuh's launch_form<NtFormOf<...>>; the NT tile issues "
        "griddepcontrol.launch_dependents as each block starts, the edge "
        "phase griddepcontrol.wait before its first fold")

    rows = {k: {} for k in cases}
    for kernel, kcases in dev.items():
        for name, kw in kcases.items():
            kw_np = cases[kernel][name]
            dtype = kw_np.get("dtype", "float32")
            out = outs[kernel][name]
            want = plain(kernel, kw)
            torch.cuda.synchronize()
            n, d = out.shape
            out_dtype = (getattr(torch, dtype) if kernel == "nt_mlp"
                         else torch.float32)
            if out.dtype != out_dtype or tuple(want.shape) != (n, d):
                raise AssertionError(f"{kernel} {name}: output {out.dtype} "
                                     f"{tuple(out.shape)}")
            # a 16-bit nt_mlp result: the kernel's f32 value rounded once
            rtol = RTOL + (NT_ROUNDING[dtype] if kernel == "nt_mlp" else 0)
            err, rel, ok = close(out.float(), want, rtol=rtol)
            tol = (f"|k-p| <= {ATOL_OF_SCALE:g}*max(1,max|p|) + "
                   f"{rtol:.6g}*|p|")
            if not ok:
                raise AssertionError(f"{kernel} {name} disagrees with its "
                                     f"plain version ({err:.3e})")
            extra = ""
            if kernel == "fused_nt_scatter":
                # the same function through the two kernels' own wrappers,
                # on the operands widened to f32 (exact)
                y = run("nt_mlp", {k_: kw[k_].float()
                                   for k_ in MLP_POSITIONAL})
                two = mp_pipeline(y, kw["senders"], kw["receivers"],
                                  kw["edge_mask"], n, stats=("sum",),
                                  edge_term=kw["edge_feat"].float(),
                                  activation="relu")["sum"]
                torch.cuda.synchronize()
                # the same NT tile and the same edge fold (slices fixed by
                # D, stream order): bitwise equal for in-range senders
                if not torch.equal(out, two):
                    e2 = close(out, two)[0]
                    raise AssertionError(f"fused_nt_scatter {name} is not "
                                         f"bitwise nt_mlp + mp_pipeline "
                                         f"({e2:.3e})")
                extra = ("; bitwise equal to nt_mlp + mp_pipeline on the "
                         "operands widened to f32")
            e_txt = (f" E={kw_np['senders'].shape[0]}"
                     if "senders" in kw_np else "")
            off = kw_np.get("offset", 0)
            label = f"{kernel} {name}"
            log("nt", f"{label}: N={n}{e_txt} MLP "
                f"{kw_np['w1'].shape[0]}->{kw_np['w1'].shape[1]}->{d} "
                f"{dtype}{f', views {off} bytes off 16' if off else ''}; "
                f"output {out.dtype}; max_abs_err={err:.3e} "
                f"max_rel_err={rel:.3e} tol: {tol}{extra}; ok")
            bitwise_stable("nt", label,
                           lambda **extra: run(kernel, kw, **extra), out,
                           (1, 3, 8, 16))
            rows[kernel][name] = timed_row(
                card, "nt", label, lambda: run(kernel, kw),
                lambda: plain(kernel, kw), nt_bound(kw_np), err=err,
                rel=rel, library=nt_library_chain(kernel, kw, want),
                library_key=("three_calls_ms" if kernel == "nt_mlp"
                             else "chain_ms"),
                library_txt=NT_CHAIN_TXT[kernel])
    return rows, {"launches": launches}


# ---------------------------------------------------------------------------
# the MoE data path at olmoe-1b-7b's width
# ---------------------------------------------------------------------------

# olmoe-1b-7b (repro/configs/archs.py, arXiv:2409.02060): 64 experts,
# top-8, moe_d_ff 1024, silu, at d_model 2048; nn/moe.py's capacity factor
# 1.25 and bf16 activations; one token group of 1,024 tokens
OLMOE = {"d_model": 2048, "experts": 64, "top_k": 8, "moe_d_ff": 1024,
         "capacity_factor": 1.25, "tokens": 1024, "shared_direction": 0.2}


def captured(run):
    """``run()`` (one kernel call) captured in a ``torch.cuda.CUDAGraph``
    (after a warm-up call on the capture's side stream), replayed once; its
    output (a tensor, or a dict of tensors)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    outs = out if isinstance(out, dict) else {None: out}
    for v in outs.values():
        v.zero_()
    graph.replay()
    torch.cuda.synchronize()
    outs = {k: v.clone() for k, v in outs.items()}
    return outs if isinstance(out, dict) else outs[None]


def moe_phase(card: str):
    """The MoE data path at olmoe-1b-7b's full width: one token group
    routed, dispatched, through the experts and combined, with the launch
    counts set to 0 just before and read just after; then its kernels
    against their plain versions, the combine against a float64 sum on the
    host, the dispatch under a permutation of the assignments, and the
    three kernel calls timed."""
    import torch
    from repro_torch.kernels.gather_rows import gather_rows, gather_rows_ref
    from repro_torch.kernels.moe_dispatch import moe_combine, moe_dispatch
    from repro_torch.kernels.mp_scatter import mp_scatter, mp_scatter_ref
    from repro_torch.nn import moe
    t, d, e_total = OLMOE["tokens"], OLMOE["d_model"], OLMOE["experts"]
    k, ff = OLMOE["top_k"], OLMOE["moe_d_ff"]
    cap = moe._capacity(t, k, e_total, OLMOE["capacity_factor"])
    slots = e_total * cap
    g = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=dtype) * scale

    # the tokens share a direction (a fifth of their scale), as hidden
    # states do, so the router loads the experts unevenly and some
    # assignments pass capacity
    x = (randn(t, d) + randn(d, scale=OLMOE["shared_direction"])).to(bf16)
    rw = randn(d, e_total, scale=d ** -0.5)
    wg = randn(e_total, d, ff, scale=d ** -0.5, dtype=bf16)
    wu = randn(e_total, d, ff, scale=d ** -0.5, dtype=bf16)
    wd = randn(e_total, ff, d, scale=ff ** -0.5, dtype=bf16)
    r = moe.route(x, rw, k=k, capacity=cap)
    st, slot, own, sw = (r[n] for n in ("token_ids", "slot", "own",
                                        "weights"))
    s = st.shape[0]
    dropped = float((~own).float().mean())
    log("moe", f"olmoe-1b-7b width: T={t} tokens, d_model={d}, "
        f"{e_total} experts, top-{k}, moe_d_ff={ff}, capacity {cap} "
        f"(factor {OLMOE['capacity_factor']}): {slots} slots, S={s} "
        f"assignments, {int((~own).sum())} past capacity "
        f"(drop share {dropped:.4f}) pointing at the trash slot {slots}; "
        f"expert weights {3 * wg.numel() * 2 / 1e9:.3f} GB bf16")
    if not bool((~own).any()):
        raise AssertionError("no assignment passed capacity: the trash slot "
                             "is not exercised")

    # the path, once, with the counts from 0
    def path():
        buf = moe_dispatch(x, st, slot, own, slots)
        y = moe.expert_ffn(buf.reshape(e_total, cap, d), wg, wu, wd,
                           torch.nn.functional.silu).reshape(slots, d)
        return buf, y, moe_combine(y, st, slot, own, sw, t)
    (buf, y, out), launches = counted(path)
    check_launches("moe", "dispatch -> expert FFN -> combine", launches,
                   {"mp_scatter": 2, "gather_rows": 1},
                   "one mp_scatter a dispatch, one gather_rows and one "
                   "mp_scatter a combine")
    if (buf.dtype != bf16 or tuple(buf.shape) != (slots, d)
            or out.dtype != torch.float32 or tuple(out.shape) != (t, d)
            or not bool(torch.isfinite(out).all())):
        raise AssertionError(f"MoE path: buffer {buf.dtype} "
                             f"{tuple(buf.shape)}, output {out.dtype} "
                             f"{tuple(out.shape)}")

    # the checks; these launches are not the path's
    msg = x[st]
    plain_buf = mp_scatter_ref(msg, slot, own, slots).to(bf16)
    gathered = gather_rows(y, slot, own)
    plain_gathered = gather_rows_ref(y, slot, own)
    cmsg = plain_gathered * sw[:, None]
    plain_out = mp_scatter_ref(cmsg, st, own, t)
    perm = torch.randperm(s, generator=torch.Generator().manual_seed(1))
    perm = perm.to("cuda")
    buf_perm = moe_dispatch(x, st[perm], slot[perm], own[perm], slots)
    torch.cuda.synchronize()
    if not torch.equal(buf, plain_buf):
        raise AssertionError("MoE dispatch: the buffer is not bitwise the "
                             "plain path's")
    if not torch.equal(buf, buf_perm):
        raise AssertionError("MoE dispatch: the buffer changed under a "
                             "permutation of the assignments")
    if not torch.equal(gathered, plain_gathered):
        raise AssertionError("gather_rows: not bitwise its plain version")
    err, rel, ok = close(out, plain_out)
    keep = own.cpu()
    f64 = torch.float64
    host = torch.zeros((t, d), dtype=f64).index_add_(
        0, st.cpu()[keep], sw.cpu().to(f64)[keep, None]
        * y.cpu().to(f64)[slot.cpu()[keep]])
    err64, rel64, ok64 = close(out.cpu().to(f64), host)
    tol = f"|k-p| <= {ATOL_OF_SCALE:g}*max(1,max|p|) + {RTOL:g}*|p|"
    log("moe", f"dispatch buffer bitwise equal to the plain path and under "
        f"a permutation of the {s} assignments; gather_rows bitwise equal "
        f"to its plain version; combine max_abs_err={err:.3e} "
        f"(max_rel_err={rel:.3e}) vs the plain path, {err64:.3e} "
        f"({rel64:.3e}) vs a float64 sum of w * y[slot] on the host, tol: "
        f"{tol}; {'ok' if ok and ok64 else 'FAIL'}")
    if not (ok and ok64):
        raise AssertionError("MoE combine disagrees with its references")
    # both mp_scatter calls bitwise the stream-order fold; the dispatch
    # replayed from a CUDA graph bitwise its eager call
    dispatch_np = {"msg": msg.float().cpu().numpy(),
                   "receivers": slot.cpu().numpy(),
                   "edge_mask": own.cpu().numpy(), "num_nodes": slots}
    combine_np = {"msg": cmsg.cpu().numpy(), "receivers": st.cpu().numpy(),
                  "edge_mask": own.cpu().numpy(), "num_nodes": t}
    check_stream_order("MoE dispatch", {"sum": buf},
                       stream_order_ref("mp_scatter", dispatch_np,
                                        "bfloat16"))
    check_stream_order("MoE combine", {"sum": out},
                       stream_order_ref("mp_scatter", combine_np))
    graph_buf = captured(lambda: mp_scatter(msg, slot, own, slots))
    if not torch.equal(graph_buf, buf):
        raise AssertionError("MoE dispatch: the CUDA graph's replay is not "
                             "bitwise the eager call")
    grids = {k: scatter_grid("mp_scatter", {"msg": m, "num_nodes": nn})
             for k, m, nn in (("dispatch", msg, slots), ("combine", cmsg, t))}
    log("moe", f"dispatch and combine each {STREAM_ORDER_TXT}; the dispatch "
        f"captured in a torch.cuda.CUDAGraph and replayed: bitwise equal; "
        f"dispatch {grids['dispatch']}; combine {grids['combine']}")

    # the three kernel calls of the path, timed at its shapes
    idx_safe = slot.clamp(max=slots - 1)
    dispatch_kw = dict(msg=msg, receivers=slot, edge_mask=own,
                       num_nodes=slots)
    combine_kw = dict(msg=cmsg, receivers=st, edge_mask=own, num_nodes=t)
    rows = {
        "moe_dispatch_bf16": timed_row(
            card, "moe", "mp_scatter moe_dispatch_bf16",
            lambda: scatter_kernel("mp_scatter", dispatch_kw),
            lambda: scatter_plain("mp_scatter", dispatch_kw),
            scatter_bound("mp_scatter", dispatch_kw),
            err=float((buf.float() - plain_buf.float()).abs().max()),
            library=library_call("mp_scatter", dispatch_kw,
                                 {"sum": plain_buf}),
            library_txt=INDEX_ADD_TXT),
        "moe_gather": timed_row(
            card, "moe", "gather_rows moe_gather",
            lambda: gather_rows(y, slot, own),
            lambda: gather_rows_ref(y, slot, own),
            gather_bound(y, slot, own),
            err=float((gathered - plain_gathered).abs().max()),
            library=lambda: torch.index_select(y, 0, idx_safe),
            library_txt="library torch.index_select (bf16 rows out, no "
                        "mask, indices clamped)"),
        "moe_combine_f32": timed_row(
            card, "moe", "mp_scatter moe_combine_f32",
            lambda: scatter_kernel("mp_scatter", combine_kw),
            lambda: scatter_plain("mp_scatter", combine_kw),
            scatter_bound("mp_scatter", combine_kw), err=err, rel=rel,
            library=library_call("mp_scatter", combine_kw,
                                 {"sum": plain_out}),
            library_txt=INDEX_ADD_TXT),
    }
    del wg, wu, wd
    torch.cuda.empty_cache()
    return rows, {"launches": launches, "drop_share": dropped}


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# kernel vs plain version, |k - p| <= atol + rtol |p|. Both sides compute
# in float32 and round the output once to q's dtype. In float32 they sum
# in another order: the reference's 2e-5 (tests/test_kernels.py). In
# bfloat16 the two float32 results (~1e-6 apart, relative) round to the
# same value or, where they straddle a rounding point, to neighbours: one
# bf16 unit, at most 2^-7 |p| (8 significant bits). The atol of 1e-5 is
# for outputs so near 0 that float32's ~1e-7 absolute difference is a
# large share of them; typical outputs are 0.03-0.07 at these shapes
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -7, 1e-5)}
# (B, H, Sq, Sk, D, causal, window, softcap, q scale, dtype, library
# call): llama3-8b's prefill (repro/configs/archs.py:50: 32 heads of 128,
# the KV heads repeated) at B=1 and at the LM path's B=2; gemma2-27b's
# local layer at 8192 tokens (archs.py:40: 32 heads of 128, window 4096,
# attention softcap 50), where the window binds, with q scaled by 50 so
# that the scores' spread (50) reaches the cap and tanh bends them (on
# N(0, 1) scores a cap of 50 is close to the identity); causal Sq > Sk,
# whose first Sq - Sk rows see no key
FLASH_CASES = {
    "a_llama3_8b_prefill_bf16": (1, 32, 2048, 2048, 128, True, None, None,
                                 1.0, "bfloat16", "sdpa"),
    "b_llama3_8b_prefill_f32": (1, 32, 2048, 2048, 128, True, None, None,
                                1.0, "float32", "sdpa"),
    "c_gemma2_27b_local_bf16": (1, 32, 8192, 8192, 128, True, 4096, 50.0,
                                50.0, "bfloat16", None),
    "d_rows_seeing_no_key_f32": (1, 2, 256, 128, 128, True, None, None,
                                 1.0, "float32", None),
    "e_lm_path_llama3_8b_b2_bf16": (2, 32, 2048, 2048, 128, True, None, None,
                                    1.0, "bfloat16", "sdpa"),
    "f_gemma2_27b_local_f32": (1, 32, 8192, 8192, 128, True, 4096, 50.0,
                               50.0, "float32", None),
    # every other head width the bf16 tensor-core kernel takes (B=1, H=4,
    # S=512, causal; D=64 with window 128 and softcap 30, reached by q
    # scaled by 30), and a ragged length with the window's edge inside
    # the kv tiles; kernel checks, not timed against a library call
    "g_d16_bf16": (1, 4, 512, 512, 16, True, None, None, 1.0, "bfloat16",
                   None),
    "h_d32_bf16": (1, 4, 512, 512, 32, True, None, None, 1.0, "bfloat16",
                   None),
    "i_d64_window_softcap_bf16": (1, 4, 512, 512, 64, True, 128, 30.0, 30.0,
                                  "bfloat16", None),
    "j_d256_bf16": (1, 4, 512, 512, 256, True, None, None, 1.0, "bfloat16",
                    None),
    "k_ragged_1000_window_bf16": (1, 4, 1000, 1000, 128, True, 300, None,
                                  1.0, "bfloat16", None),
    # the same five in float32 (the three-term kernel at every head width)
    "l_d16_f32": (1, 4, 512, 512, 16, True, None, None, 1.0, "float32",
                  None),
    "m_d32_f32": (1, 4, 512, 512, 32, True, None, None, 1.0, "float32",
                  None),
    "n_d64_window_softcap_f32": (1, 4, 512, 512, 64, True, 128, 30.0, 30.0,
                                 "float32", None),
    "o_d256_f32": (1, 4, 512, 512, 256, True, None, None, 1.0, "float32",
                   None),
    "p_ragged_1000_window_f32": (1, 4, 1000, 1000, 128, True, 300, None,
                                 1.0, "float32", None),
}


def flash_tiling(d: int, dtype: str):
    """(query rows a block owns, keys per staged tile, dynamic shared memory
    bytes a block asks for) of the kernel that takes ``dtype`` at head
    width ``d``, as the built library reports them
    (``flash_attention_tiling``)."""
    import ctypes
    from repro_torch.kernels import build
    fn = build.load("flash_attention").flash_attention_tiling
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(3)]
    err = fn(d, int(dtype == "bfloat16"), *(ctypes.byref(x) for x in out))
    if err:
        raise RuntimeError(f"flash_attention_tiling({d}, {dtype}): error "
                           f"{err}")
    return tuple(x.value for x in out)


def flash_close(a, b, dtype: str):
    """(max |a - b|, whether |a - b| <= atol + rtol |b| with ``a``
    finite) under ``FLASH_TOL[dtype]``."""
    import torch
    rtol, atol = FLASH_TOL[dtype]
    diff = (a.float() - b.float()).abs()
    ok = bool((diff <= atol + rtol * b.float().abs()).all()
              and torch.isfinite(a).all())
    return float(diff.max()), ok


def dense_attention(q, k, v, mask, softcap):
    """One head's attention, q (Sq, D) over k, v (Sk, D) under an explicit
    (Sq, Sk) ``mask``, by the plain version's rules (scale q first, float32
    softmax, 0 for a row that sees no key), in q's dtype."""
    import torch
    f32 = torch.float32
    s = (q.to(f32) / math.sqrt(q.shape[-1])) @ k.to(f32).T
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask, s, -1e30)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return ((p @ v.to(f32)) / l).to(q.dtype)


def planted_faults(sq, sk, causal, window, softcap, device, tiles):
    """{label: (mask, softcap)} of the faults the tolerance must see, as one
    head's mask and softcap: the kernel's last query block (``tiles`` =
    its query rows per block, keys per tile) skips one of its kv tiles in
    the middle of the keys every one of its rows sees; the window ignored;
    the softcap ignored."""
    from repro_torch.kernels.flash_attention import visible
    bq, bk = tiles
    mask = visible(sq, sk, causal=causal, window=window, device=device)
    rows = slice((sq - 1) // bq * bq, sq)
    seen = mask[rows].all(0)
    full = [t for t in range(0, sk - bk + 1, bk)
            if bool(seen[t:t + bk].all())]
    faults = {}
    if full:
        mid = full[len(full) // 2]
        skipped = mask.clone()
        skipped[rows, mid:mid + bk] = False
        faults[f"the last query block skips keys [{mid}, "
               f"{mid + bk})"] = (skipped, softcap)
    if window is not None:
        faults["the window ignored"] = (
            visible(sq, sk, causal=causal, window=None, device=device),
            softcap)
    if softcap is not None:
        faults["the softcap ignored"] = (mask, None)
    return mask, faults


def check_planted_faults(name, q, k, v, out, ref, *, causal, window,
                         softcap, dtype):
    """The tolerance's own check on head (0, 0): the plain rules under the
    true mask hold against the kernel's output, and each planted fault,
    taken as if it were the kernel's output, fails against the plain
    version's. Raise otherwise."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    mask, faults = planted_faults(sq, sk, causal, window, softcap, q.device,
                                  flash_tiling(d, dtype)[:2])
    q0, k0, v0 = q[0, 0], k[0, 0], v[0, 0]
    err, ok = flash_close(out[0, 0], dense_attention(q0, k0, v0, mask,
                                                     softcap), dtype)
    if not ok:
        raise AssertionError(f"flash_attention {name}: head (0, 0) disagrees "
                             f"with one head's plain rules ({err:.3e})")
    seen = []
    for label, (fmask, fcap) in faults.items():
        err, ok = flash_close(dense_attention(q0, k0, v0, fmask, fcap),
                              ref[0, 0], dtype)
        if ok:
            raise AssertionError(f"flash_attention {name}: the tolerance "
                                 f"passes a planted fault, {label}")
        seen.append(f"{label} ({err:.3e})")
    log("flash", f"flash_attention {name}: the tolerance fails each planted "
        f"fault on head (0, 0): {'; '.join(seen)}")


SDPA_TXT = ("library torch.nn.functional.scaled_dot_product_attention "
            "(is_causal; Sq = Sk, so its top-left alignment is the "
            "kernel's end alignment)")


def split_bound(nbytes, flops, dtype):
    """``work_bound`` of a flash kernel's work on the route it takes: bf16
    on the tensor cores; float32 by the fp32-accurate route of
    ``csrc/split3.cuh``, its operations six times over (each product six
    bf16 products of three-term operands) at the bf16 tensor-core rate, or
    its bytes where they take longer. ``kernels/cost.py``'s declared work
    stays the function's own."""
    if dtype == "bfloat16":
        return work_bound(nbytes, flops, dtype)
    return work_bound(nbytes, 6 * flops, "bfloat16")


def log_fma_bound(phase, label, bound, dtype):
    """For float32: the FMA bound (the work at float32's 67 TFLOP/s outside
    the tensor cores) beside the split bound; returns it (ms), or None."""
    if dtype != "float32":
        return None
    fma = work_bound(bound[2], bound[3] / 6, "float32")
    log(phase, f"{label}: float32 bounds: split {bound[0] * 1e3:.3f} us "
        f"(by {bound[1]}; the operations six times over at bf16's 989 "
        f"TFLOP/s), FMA {fma[0] * 1e3:.3f} us (by {fma[1]}; the "
        f"operations at float32's 67 TFLOP/s)")
    return fma[0]


def flash_bound(b, h, sq, sk, d, causal, window, dtype):
    """The least time (ms): the work of ``kernels/cost.py::flash_work`` (q,
    k, v and out once each; 4 D operations per visible (query, key) pair,
    the pairs this mask leaves) by ``split_bound``."""
    from repro_torch.kernels import cost
    return split_bound(*cost.flash_work(
        b, h, sq, sk, d, causal=causal, window=window,
        itemsize=2 if dtype == "bfloat16" else 4), dtype)


def flash_instantiation(symbol: str):
    """(dtype, D) of a mangled kernel name of csrc/flash_attention.cu, or
    None: ``tc::flash_attention_wgmma<D>`` is bf16, ``x3::flash_attention_
    x3<D>`` float32."""
    import re
    m = re.search(r"flash_attention_(wgmma|x3)ILi(\d+)E", symbol)
    if not m:
        return None
    return ("bfloat16" if m.group(1) == "wgmma" else "float32",
            int(m.group(2)))


def flash_build_report() -> dict:
    """Per instantiation of csrc/flash_attention.cu: registers, spill bytes
    and static shared memory from the build's ``-Xptxas -v`` log, the
    dynamic shared memory a block asks for, and the count of HGMMA (wgmma)
    instructions in the library's SASS (``cuobjdump -sass`` of the toolkit
    beside nvcc). Raises unless every instantiation, bf16 and float32,
    holds HGMMA."""
    from repro_torch.kernels import build
    lib = build.library_path("flash_attention")
    report = ptxas_report("flash_attention", flash_instantiation)
    for info in report.values():
        info["static_smem"] = info.pop("smem")
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    for part in sass.split("Function : ")[1:]:
        key = flash_instantiation(part.split(None, 1)[0])
        if key in report:
            report[key]["hgmma"] = part.count("HGMMA")
    rows = {}
    for (dtype, d), info in sorted(report.items()):
        info["dynamic_smem"] = flash_tiling(d, dtype)[2]
        log("flash", f"flash_attention {dtype} D={d}: {info['registers']} "
            f"registers, spill stores/loads {info['spill_stores']}/"
            f"{info['spill_loads']} bytes, shared memory "
            f"{info['dynamic_smem']} bytes dynamic + {info['static_smem']} "
            f"static, {info.get('hgmma', 0)} HGMMA in its SASS "
            f"(ptxas -v log, cuobjdump -sass)")
        rows[f"{dtype}_d{d}"] = info
    missing = [f"{dtype} D={d}" for (dtype, d) in report
               if not report[(dtype, d)].get("hgmma")]
    if missing or len(report) != 10:
        raise AssertionError(f"flash_attention's SASS: {len(report)} "
                             f"instantiations, without HGMMA: {missing}")
    return rows


def flash_phase(card: str):
    """``flash_attention`` against its plain version on the card at the LM
    path's shapes and every bf16 head width, bitwise across two runs,
    timed beside its bound and, where one call computes the same function,
    PyTorch's ``scaled_dot_product_attention``. These launches are not the
    path's. Returns the cases' rows and ``flash_build_report()``."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    report = flash_build_report()
    rows = {}
    g = torch.Generator(device="cuda").manual_seed(3)
    for name, (b, h, sq, sk, d, causal, window, cap, q_scale, dtype,
               lib) in FLASH_CASES.items():
        dt = getattr(torch, dtype)
        q = (torch.randn(b, h, sq, d, generator=g, device="cuda")
             * q_scale).to(dt)
        k = torch.randn(b, h, sk, d, generator=g, device="cuda").to(dt)
        v = torch.randn(b, h, sk, d, generator=g, device="cuda").to(dt)
        kw = dict(causal=causal, window=window, softcap=cap)

        def kern():
            return flash_attention(q, k, v, **kw, q_tile=sq, kv_tile=sk)

        def plain():
            return flash_attention_ref(q, k, v, **kw)

        out, ref = kern(), plain()
        torch.cuda.synchronize()
        rtol, atol = FLASH_TOL[dtype]
        err, ok = flash_close(out, ref, dtype)
        zero_rows = ""
        if sq > sk and causal:
            blind = slice(0, sq - sk)
            if not (bool((out[:, :, blind] == 0).all())
                    and bool((ref[:, :, blind] == 0).all())):
                raise AssertionError(f"flash_attention {name}: rows that "
                                     f"see no key are not 0")
            zero_rows = f"; the {sq - sk} rows that see no key are 0"
        f64 = ""
        if dtype == "float32":
            exact = flash_attention_ref(q.double(), k.double(), v.double(),
                                        **kw)
            f64 = (f"; against float64: kernel "
                   f"{float((out.double() - exact).abs().max()):.3e}, plain "
                   f"{float((ref.double() - exact).abs().max()):.3e}")
            del exact
        log("flash", f"flash_attention {name}: B={b} H={h} Sq={sq} Sk={sk} "
            f"D={d} causal={causal} window={window} softcap={cap} "
            f"q x{q_scale:g} {dtype}; max_abs_err={err:.3e} tol: |k-p| <= "
            f"{atol:g} + {rtol:g}|p|{zero_rows}{f64}; "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention {name} disagrees with its "
                                 f"plain version")
        check_planted_faults(name, q, k, v, out, ref, causal=causal,
                             window=window, softcap=cap, dtype=dtype)
        again = kern()
        torch.cuda.synchronize()
        if not torch.equal(again, out):
            raise AssertionError(f"flash_attention {name} is not bitwise "
                                 f"stable across runs")
        log("flash", f"flash_attention {name}: bitwise equal across 2 runs")
        library = None
        if lib == "sdpa":
            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True)
        # calls over ~1 ms are timed with fewer repetitions
        long = time_ms(plain, reps=1, inner=1)[0] > 1.0
        bound = flash_bound(b, h, sq, sk, d, causal, window, dtype)
        rows[name] = timed_row(
            card, "flash", f"flash_attention {name}", kern, plain, bound,
            err=err, library=library, library_txt=SDPA_TXT,
            **(dict(reps=5, inner=3) if long else {}))
        rows[name]["fma_bound_ms"] = log_fma_bound(
            "flash", f"flash_attention {name}", bound, dtype)
        del q, k, v, out, ref, again
        torch.cuda.empty_cache()
    return rows, report


# ---------------------------------------------------------------------------
# the dense LM path: llama3-8b at full width
# ---------------------------------------------------------------------------

# the LM path's traffic: B prompts of S tokens from numpy's default_rng(0)
# (serve_lm's own), then greedy decode to GEN tokens each
LM_BATCH, LM_PROMPT, LM_GEN = 2, 2048, 32
# the full path against the same path with attention through the plain
# version, last-position logits, bf16 through 32 layers: each attention
# output's bf16 rounding may differ by one unit (2^-8 relative) where the
# two float32 results straddle a rounding point, and such differences
# travel through 32 residual blocks and the unembedding. Held to 0.05 of
# the logits' scale, the reference's bf16 kernel tolerance
LM_BF16_TOL = 0.05
# the same at depth 2 in float32, TF32 off: the kernel's and the plain
# version's sums differ in order only (~1e-6 relative), through two blocks
LM_F32_TOL = 2e-5


def plain_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    q_tile=128, kv_tile=128):
    """``ops.flash_attention`` routed to its plain version (tiles ignored):
    the LM path's reference on the card."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               softcap=softcap)


def with_attention(fn, run):
    """``run()`` with ``ops.flash_attention`` replaced by ``fn``."""
    from repro_torch.kernels import ops
    real = ops.flash_attention
    ops.flash_attention = fn
    try:
        return run()
    finally:
        ops.flash_attention = real


def logits_close(label, a, b, tol):
    """Raise unless ``a`` is finite and within ``tol`` of max(1, max|b|)
    of ``b``; returns the error relative to that scale."""
    err, rel, ok = close(a.float(), b.float(), rtol=0.0, atol_of_scale=tol)
    log("lm", f"{label}: max_abs_err={err:.4e}, {rel:.3e} of the logits' "
        f"scale (tol {tol:g}); {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the logits disagree")
    return rel


def serve_full_lm(arch: str, gen: int):
    """``serve_lm`` of ``arch`` at full width and depth on the card: the LM
    traffic (LM_BATCH prompts of LM_PROMPT tokens), ``gen`` tokens each."""
    from repro_torch.launch import serve
    return serve.serve_lm(arch, gen, batch=LM_BATCH, prompt_len=LM_PROMPT,
                          max_len=LM_PROMPT + gen, full=True, device="cuda")


def serve_counted(serve_fn, profile_calls: int = 0):
    """``serve_fn()`` (a ``serve_lm`` call) with every count set to 0 just
    before and read just after, and each call of ``lm.prefill`` /
    ``lm.decode_step`` in it recorded by phase: (what it returned, the
    counts, {phase: [each call's counts]}, {phase: [for each of the first
    ``profile_calls`` calls, run under ``torch.profiler``: its device
    events by LM kernel (``kernels``), wall ms, the card's busy ms and the
    top device ops]})."""
    from repro_torch.kernels.ops import launch_counters
    from repro_torch.models import lm
    real = {"prefill": lm.prefill, "decode": lm.decode_step}
    per_call = {"prefill": [], "decode": []}
    events = {"prefill": [], "decode": []}

    def recording(phase):
        wrappers = launch_counters()

        def run(*args, **kw):
            before = {k: fn.launches for k, fn in wrappers.items()}
            if len(events[phase]) < profile_calls:
                out, on_device, wall = profiled(
                    lambda: real[phase](*args, **kw))
                events[phase].append({
                    "kernels": lm_events(on_device), "wall_ms": wall * 1e3,
                    "busy_ms": sum(t for t, _ in on_device.values()) / 1e3,
                    "top_device": top(on_device, 6)})
            else:
                out = real[phase](*args, **kw)
            per_call[phase].append(
                {k: fn.launches - before[k] for k, fn in wrappers.items()})
            return out
        return run

    lm.prefill, lm.decode_step = recording("prefill"), recording("decode")
    try:
        stats, launches = counted(serve_fn)
    finally:
        lm.prefill, lm.decode_step = real["prefill"], real["decode"]
    return stats, launches, per_call, events


def summed_calls(calls: list, kernels) -> dict:
    """Per-call counts summed, for every name of ``kernels``."""
    return {k: sum(c[k] for c in calls) for k in kernels}


def profile_lm(card: str, label: str, cfg, *, prompt_len: int,
               steps: int = 3):
    """The LM path's prefill and ``steps`` decode steps under
    ``torch.profiler`` (the weights drawn again from seed 0): wall time,
    the card's busy time and share, kernels run, the top device and host
    ops. Each decode step is timed again without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
    caches = lm.init_caches(cfg, LM_BATCH, prompt_len + 2 * steps, "cuda")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, prompt_len))).cuda()
    state = {"tok": None, "caches": caches, "pos": prompt_len}

    def prefill():
        logits, state["caches"] = lm.prefill(params, prompt, caches, cfg)
        state["tok"] = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]

    def decode():
        for _ in range(steps):
            logits, state["caches"] = lm.decode_step(
                params, state["tok"], state["caches"], cfg,
                position=state["pos"])
            state["tok"] = torch.argmax(logits[:, :cfg.vocab_size],
                                        -1)[:, None]
            state["pos"] += 1

    out = {}
    for name, run, n in (("prefill", prefill, 1), ("decode", decode, steps)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        on_device, on_host = event_tables(prof)
        busy_us = sum(t for t, _ in on_device.values())
        kernels = sum(c for _, c in on_device.values())
        out[name] = {"calls": n, "wall_ms": wall * 1e3,
                     "device_busy_us": busy_us,
                     "device_busy_share": busy_us / (wall * 1e6),
                     "device_ops": kernels, "top_device": top(on_device, 8),
                     "top_host": top(on_host, 6)}
        log("profile", f"{label}: {name} ({n} call(s), profiler on) "
            f"{wall * 1e3:.2f} ms wall, device busy {busy_us / 1e3:.2f} ms "
            f"({out[name]['device_busy_share']:.1%}), {kernels / n:.0f} "
            f"device ops a call, on {card}")
        for side in ("top_device", "top_host"):
            for row in out[name][side]:
                log("profile", f"  {side[4:]:6} {row['us']:10.1f} us "
                    f"x{row['count']:<5} {row['name']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    out["decode"]["step_ms_unprofiled"] = step_ms
    log("profile", f"{label}: a decode step without the profiler "
        f"{step_ms:.2f} ms")
    return out


def lm_phase(card: str):
    """The dense LM path: llama3-8b (repro/configs/archs.py:50) at full
    width. First a depth-2 float32 check of the kernel path against the
    plain one; then ``serve_lm(full=True)`` in bf16, all 32 layers, with
    the counts set to 0 just before and read just after (and per phase:
    prefill, decode), and the same path with plain attention."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.distributed.sharding import param_bytes
    from repro_torch.models import lm

    # depth 2, float32, full width: the tight check
    cfg = ARCHS["llama3-8b"].replace(num_layers=2, dtype=torch.float32)
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).cuda()

    def prefill32():
        caches = lm.init_caches(cfg, LM_BATCH, LM_PROMPT + 1, "cuda")
        return lm.prefill(params, prompt, caches, cfg)[0]
    got = prefill32()
    want = with_attention(plain_attention, prefill32)
    f32_rel = logits_close("llama3-8b width, depth 2, float32: prefill's "
                           "last-position logits, kernel vs plain attention",
                           got, want, LM_F32_TOL)
    del params, got, want
    torch.cuda.empty_cache()

    # the main path: full width and depth, bf16, counts per phase
    def serve_full():
        return serve_full_lm("llama3-8b", LM_GEN)

    torch.cuda.reset_peak_memory_stats()
    stats, launches, per_phase, _ = serve_counted(serve_full)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    full = ARCHS["llama3-8b"]
    label = "llama3-8b full width and depth, bf16"
    check_launches("lm", label, launches, {"flash_attention": full.num_layers},
                   "one flash_attention per attention layer in the prefill, "
                   "none in decode")

    def summed(phase):
        return summed_calls(per_phase[phase], launches)
    check_launches("lm", f"{label}: prefill", summed("prefill"),
                   {"flash_attention": full.num_layers},
                   "one per attention layer")
    check_launches("lm", f"{label}: {len(per_phase['decode'])} decode steps",
                   summed("decode"), {}, "dense decode attention, no kernel")
    tokens, logits = stats["tokens"], stats["last_logits"]
    if (tokens.shape != (LM_BATCH, LM_GEN)
            or tuple(logits.shape) != (LM_BATCH, full.vocab_pad)):
        raise AssertionError(f"{label}: tokens {tokens.shape}, logits "
                             f"{tuple(logits.shape)}")
    plain_stats = with_attention(plain_attention, serve_full)
    bf16_rel = logits_close(f"{label}: prefill's last-position logits, "
                            f"kernel vs plain attention", logits,
                            plain_stats["last_logits"], LM_BF16_TOL)
    agree = float((tokens == plain_stats["tokens"]).mean())
    first = float((tokens[:, 0] == plain_stats["tokens"][:, 0]).mean())
    kv_gb = (2 * full.num_layers * LM_BATCH * (LM_PROMPT + LM_GEN)
             * full.num_kv_heads * full.head_dim * 2 / 1e9)
    log("lm", f"{label}: B={LM_BATCH} prompts of {LM_PROMPT} tokens, "
        f"{LM_GEN} generated each; greedy tokens equal to the plain path's: "
        f"{agree:.3f} of all, {first:.3f} of the first (not gated: random "
        f"weights give near-flat logits); weights "
        f"{param_bytes(lm.lm_param_defs(full)) / 1e9:.2f} GB, "
        f"KV cache {kv_gb:.3f} GB, peak allocated {peak_gb:.2f} GB")
    log("lm", f"{label}: prefill {stats['prefill_s'] * 1e3:.2f} ms "
        f"({LM_BATCH * LM_PROMPT} tokens), decode "
        f"{stats['decode_tok_per_s']:.2f} tokens/s ({LM_GEN - 1} steps of "
        f"B={LM_BATCH}, {stats['decode_s'] * 1e3:.2f} ms); plain attention: "
        f"prefill {plain_stats['prefill_s'] * 1e3:.2f} ms, decode "
        f"{plain_stats['decode_tok_per_s']:.2f} tokens/s; on {card}")
    profiles = profile_lm(card, label, full, prompt_len=LM_PROMPT)
    torch.cuda.empty_cache()
    return {"launches": launches, "profile": profiles,
            "launches_prefill": summed("prefill"),
            "launches_decode": summed("decode"),
            "prefill_ms": stats["prefill_s"] * 1e3,
            "decode_tok_per_s": stats["decode_tok_per_s"],
            "plain_prefill_ms": plain_stats["prefill_s"] * 1e3,
            "plain_decode_tok_per_s": plain_stats["decode_tok_per_s"],
            "logits_rel_err_bf16": bf16_rel, "logits_rel_err_f32": f32_rel,
            "greedy_agreement": agree, "peak_allocated_gb": peak_gb}


# ---------------------------------------------------------------------------
# the MoE, SSM and hybrid LM families at full width
# ---------------------------------------------------------------------------

# each LM kernel's device symbols in csrc/, how the profiler's events are
# told apart (flash_attention: the bf16 wgmma body and the float32 one;
# gather_rows: its 16-byte and scalar forms)
LM_EVENT_SYMBOLS = {
    "flash_attention": ("flash_attention_wgmma", "flash_attention_kernel"),
    "mp_scatter": ("mp_scatter_kernel",),
    "gather_rows": ("gather_pieces_kernel", "gather_values_kernel")}
# mamba2's chunked prefill against the same prompt fed token by token
# through decode_step (the recurrence), last-position logits in float32:
# the two forms sum in other orders, held at the reference's own tolerance
# between them (tests/test_ssm.py, 2e-4), of the logits' scale
SSM_FORMS_TOL = 2e-4
# the families, (arch, depth of the float32 check): olmoe's MoE blocks,
# mamba2's SSD mixer, recurrentgemma's group (rec, rec, local)
LM_FAMILIES = (("olmoe-1b-7b", 2), ("mamba2-2.7b", 2),
               ("recurrentgemma-2b", 3))
# decode steps of the float32 check after its prefill: each MoE layer's
# decode-size dispatch (B=2 tokens, 16 assignments padded to 128, into
# capacity's floor of 8 slots an expert) through the kernels
F32_STEPS = 3
# serve_lm in bf16 at full width and depth against the same serve through
# the plain kernels: the prefill's last-position logits within this share
# of their scale, by family. Read on an H100 at 700 W, the same in two
# runs (every kernel and product of the path is deterministic):
#   olmoe-1b-7b: the sound run 1.25e-2 (bf16 attention and combine
#     roundings, and the routing flips they cause, through 16 layers);
#     planted faults 0.82 (flash_attention skipping its diagonal kv
#     tile), 7.1e-2 (gather_rows reading the neighbouring slot), 4.5e-2
#     (one 64-key tile's values lost). Twice the sound reading.
#   recurrentgemma-2b: the sound run 7.3e-3; the diagonal tile skipped
#     1.39e-2, one tile's values lost 1.05e-2: at random weights a fault
#     in the 8 local layers moves these logits little (why is not
#     measured). The tolerance sits between the sound run and the
#     diagonal fault; the calls' own checks at the served shape hold the
#     kernel to one bf16 unit
FAMILY_BF16_TOL = {"olmoe-1b-7b": 0.025, "recurrentgemma-2b": 0.01}


def lm_events(on_device: dict) -> dict:
    """Device events by LM kernel (``LM_EVENT_SYMBOLS``)."""
    return {k: sum(c for name, (_, c) in on_device.items()
                   if any(sym in name for sym in syms))
            for k, syms in LM_EVENT_SYMBOLS.items()}


LM_LAUNCHES_TXT = ("one flash_attention per attention layer in a prefill, "
                   "none in decode; two mp_scatter and one gather_rows per "
                   "MoE layer in each call; the SSD and the RG-LRU outside "
                   "any kernel")


def lm_launches(cfg):
    """The kernel launches of one prefill and of one decode step of
    ``cfg``'s stack, by kernel (kernels it never launches left out)."""
    from repro_torch.nn.transformer import stack_pattern
    sd = stack_pattern(cfg)
    kinds = sd.group * sd.num_groups + sd.remainder
    attn = sum(k in ("attn", "local") for k in kinds)
    moe = attn if cfg.num_experts else 0
    step = {"mp_scatter": 2 * moe, "gather_rows": moe}
    prefill = {"flash_attention": attn, **step}
    return ({k: v for k, v in prefill.items() if v},
            {k: v for k, v in step.items() if v})


def plain_kernels(run):
    """``run()`` with the LM path's three kernels routed to their plain
    versions: ``ops.flash_attention`` (``plain_attention``) and the MoE
    path's ``mp_scatter`` and ``gather_rows`` (as ``moe_dispatch.py``
    holds them)."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels.gather_rows import gather_rows_ref
    from repro_torch.kernels.mp_scatter import mp_scatter_ref
    real = md.mp_scatter, md.gather_rows
    md.mp_scatter = (lambda msg, rcv, mask, n, **kw:
                     mp_scatter_ref(msg, rcv, mask, n).to(msg.dtype))
    md.gather_rows = lambda y, idx, mask, **kw: gather_rows_ref(y, idx, mask)
    try:
        return with_attention(plain_attention, run)
    finally:
        md.mp_scatter, md.gather_rows = real


@contextmanager
def moe_taps():
    """Within: each MoE layer's routing (``slot`` and ``own``, in call
    order) and aux loss, recorded in the dict it yields."""
    from repro_torch.nn import moe, transformer
    real_route, real_ffn = moe.route, transformer.moe_ffn
    taps = {"slot": [], "own": [], "aux": []}

    def route(*args, **kw):
        r = real_route(*args, **kw)
        taps["slot"].append(r["slot"])
        taps["own"].append(r["own"])
        return r

    def ffn(*args, **kw):
        out, aux = real_ffn(*args, **kw)
        taps["aux"].append(aux)
        return out, aux

    moe.route, transformer.moe_ffn = route, ffn
    try:
        yield taps
    finally:
        moe.route, transformer.moe_ffn = real_route, real_ffn


@contextmanager
def patched(owner, name: str, fn):
    """Within: ``owner.name`` is ``fn``."""
    real = getattr(owner, name)
    setattr(owner, name, fn)
    try:
        yield real
    finally:
        setattr(owner, name, real)


@contextmanager
def kept_calls(wanted: dict):
    """Within: every call of ``moe_dispatch``'s ``mp_scatter`` and
    ``gather_rows`` and of ``ops.flash_attention`` goes to the real
    wrapper, and the arguments of those whose index in call order (from 0,
    per wrapper) ``wanted[name]`` lists are kept in the dict it yields,
    {(name, index): (args, kwargs)}."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ops
    owners = {"mp_scatter": md, "gather_rows": md, "flash_attention": ops}
    real = {k: getattr(o, k) for k, o in owners.items()}
    seen = dict.fromkeys(owners, 0)
    kept = {}

    def tap(name):
        def run(*args, **kw):
            i = seen[name]
            seen[name] += 1
            if i in wanted.get(name, ()):
                kept[(name, i)] = (args, kw)
            return real[name](*args, **kw)
        return run
    for k, o in owners.items():
        setattr(o, k, tap(k))
    try:
        yield kept
    finally:
        for k, o in owners.items():
            setattr(o, k, real[k])


def served_indices(want_prefill: dict, want_step: dict) -> dict:
    """The calls of the served run that phase 9 keeps, by wrapper: the
    prefill's first attention layer's ``flash_attention``, and for the MoE
    the first layer's dispatch, gather and combine in the prefill and in
    the first decode step."""
    keep = {}
    if want_prefill.get("flash_attention"):
        keep["flash_attention"] = (0,)
    if want_step.get("gather_rows"):
        p, g = want_prefill["mp_scatter"], want_prefill["gather_rows"]
        keep["mp_scatter"] = (0, 1, p, p + 1)
        keep["gather_rows"] = (0, g)
    return keep


def served_call_rows(card: str, arch: str, kept: dict,
                     want_prefill: dict) -> dict:
    """Each kept call of the served run again through its kernel and its
    plain version on the same inputs: the MoE dispatch and gather_rows
    bitwise, the combine within RTOL / ATOL_OF_SCALE, flash_attention
    within ``FLASH_TOL`` (which must fail a planted skipped kv tile); each
    timed beside its bound and, where one call computes the same function,
    the library's. These launches are not the path's. Rows by
    ``<arch>_<prefill|decode>_<dispatch|gather|combine|attention>``."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.gather_rows import gather_rows, gather_rows_ref
    rows = {}
    for (name, i), (args, kw) in sorted(kept.items()):
        where = "prefill" if i < want_prefill[name] else "decode"
        if name == "mp_scatter":
            what = "dispatch" if i % 2 == 0 else "combine"
            msg, rcv, mask, n = args
            skw = dict(msg=msg, receivers=rcv, edge_mask=mask, num_nodes=n)
            got = scatter_kernel("mp_scatter", skw)["sum"]
            plain = scatter_plain("mp_scatter", skw)["sum"]
            torch.cuda.synchronize()
            label = (f"{arch} served {where}, first MoE layer's {what}: "
                     f"mp_scatter of {msg.shape[0]} x {msg.shape[1]} "
                     f"{str(msg.dtype)[6:]} rows into {n}")
            if what == "dispatch":
                # each slot takes at most one row: the sum is that row
                ok = torch.equal(got, plain.to(got.dtype))
                err, rel = float((got.float() - plain).abs().max()), None
                txt = "bitwise the plain version"
            else:
                err, rel, ok = close(got, plain)
                txt = (f"max_abs_err={err:.3e} (max_rel_err={rel:.3e}), tol "
                       f"|k-p| <= {ATOL_OF_SCALE:g}*max(1,max|p|) + "
                       f"{RTOL:g}*|p|")
            log("lm9", f"{label}: {txt}; {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{label}: the kernel disagrees with "
                                     f"its plain version")
            rows[f"{arch}_{where}_{what}"] = timed_row(
                card, "lm9", label,
                lambda: scatter_kernel("mp_scatter", skw),
                lambda: scatter_plain("mp_scatter", skw),
                scatter_bound("mp_scatter", skw), err=err, rel=rel,
                library=library_call("mp_scatter", skw, {"sum": plain}),
                library_txt=INDEX_ADD_TXT)
        elif name == "gather_rows":
            y, idx, mask = args
            got, plain = gather_rows(y, idx, mask), gather_rows_ref(y, idx,
                                                                   mask)
            torch.cuda.synchronize()
            label = (f"{arch} served {where}, first MoE layer's gather: "
                     f"gather_rows of {idx.shape[0]} rows of y "
                     f"{tuple(y.shape)} {str(y.dtype)[6:]}")
            ok = torch.equal(got, plain)
            log("lm9", f"{label}: bitwise the plain version; "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{label}: the kernel disagrees with "
                                     f"its plain version")
            safe = idx.clamp(max=y.shape[0] - 1)
            rows[f"{arch}_{where}_gather"] = timed_row(
                card, "lm9", label, lambda: gather_rows(y, idx, mask),
                lambda: gather_rows_ref(y, idx, mask),
                gather_bound(y, idx, mask),
                err=float((got - plain).abs().max()),
                library=lambda: torch.index_select(y, 0, safe),
                library_txt="library torch.index_select (bf16 rows out, no "
                            "mask, indices clamped)")
        else:
            q, k, v = args
            causal, window, cap = (kw.get("causal", True), kw.get("window"),
                                   kw.get("softcap"))
            b, h, sq, d = q.shape
            sk = k.shape[2]
            dtype = str(q.dtype)[6:]
            got = flash_attention(q, k, v, **kw)
            plain = flash_attention_ref(q, k, v, causal=causal,
                                        window=window, softcap=cap)
            torch.cuda.synchronize()
            label = (f"{arch} served prefill, first attention layer: "
                     f"flash_attention B={b} H={h} S={sq} D={d} causal="
                     f"{causal} window={window} softcap={cap} {dtype}")
            err, ok = flash_close(got, plain, dtype)
            rtol, atol = FLASH_TOL[dtype]
            log("lm9", f"{label}: max_abs_err={err:.3e} tol |k-p| <= "
                f"{atol:g} + {rtol:g}|p|; {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{label}: the kernel disagrees with "
                                     f"its plain version")
            # a window as long as the keys hides none of them
            binding = window if window is not None and window < sk else None
            check_planted_faults(label, q, k, v, got, plain, causal=causal,
                                 window=binding, softcap=cap, dtype=dtype)
            library = None
            if binding is None and cap is None and causal and sq == sk:
                def library():
                    return torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=True)
            long = time_ms(lambda: flash_attention_ref(
                q, k, v, causal=causal, window=window, softcap=cap),
                reps=1, inner=1)[0] > 1.0
            rows[f"{arch}_prefill_attention"] = timed_row(
                card, "lm9", label, lambda: flash_attention(q, k, v, **kw),
                lambda: flash_attention_ref(q, k, v, causal=causal,
                                            window=window, softcap=cap),
                flash_bound(b, h, sq, sk, d, causal, window, dtype),
                err=err, library=library, library_txt=SDPA_TXT,
                **(dict(reps=5, inner=3) if long else {}))
        del got, plain
    torch.cuda.empty_cache()
    return rows


def gather_next_slot(real):
    """A planted fault: ``gather_rows`` reads each owned row's neighbouring
    slot (index ^ 1), an indexing error of the kernel."""
    import torch

    def run(y, idx, mask, **kw):
        return real(y, torch.where(mask, idx ^ 1, idx), mask, **kw)
    return run


def attention_drops_tile(real):
    """A planted fault: ``flash_attention`` loses one 64-key tile's values
    (keys [S/2, S/2 + 64) add to the softmax's denominator but nothing to
    the output), a skipped P @ V product of the kernel."""
    def run(q, k, v, **kw):
        mid = v.shape[2] // 2
        v = v.clone()
        v[:, :, mid:mid + 64] = 0
        return real(q, k, v, **kw)
    return run


def attention_skips_diagonal(real):
    """A planted fault: ``flash_attention``'s causal loop stops one 64-key
    tile short, so each query row loses the keys of the tile that holds
    its own position (a row of the first tile sees none and comes out 0),
    an off-by-one of the kernel. Computed densely in float32."""
    import torch

    def run(q, k, v, *, causal=True, window=None, softcap=None, **kw):
        f32 = torch.float32
        s = (q.to(f32) / math.sqrt(q.shape[-1])) @ k.to(f32).transpose(-1,
                                                                        -2)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        sq, sk = q.shape[2], k.shape[2]
        i = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        j = torch.arange(sk, device=q.device)[None, :]
        keep = j < i // 64 * 64
        if window is not None:
            keep &= j > i - window
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
        return (p.nan_to_num(0.0) @ v.to(f32)).to(q.dtype)
    return run


def served_vs_plain(card: str, arch: str, cfg, stats: dict) -> dict:
    """``serve_lm`` of ``arch`` at full width and depth in bf16 (``stats``,
    the counted run) against the same serve through the plain kernels
    (``plain_kernels``): the prefill's last-position logits within
    ``FAMILY_BF16_TOL[arch]`` of their scale; then each planted fault of
    the path's kernels, served again (its prefill), must fall outside that
    tolerance, except the loss of one kv tile's values, which is read
    only (at recurrentgemma-2b's width it lies about as far from the
    tolerance as the sound run; the call's own check at the served shape
    sees it). The plain path's times, and the greedy tokens' agreement
    (not gated: random weights give near-flat logits)."""
    import torch
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ops
    v = cfg.vocab_size
    tol = FAMILY_BF16_TOL[arch]
    label = f"{arch} full width and depth, bf16"
    plain = plain_kernels(lambda: serve_full_lm(arch, LM_GEN))
    want = plain["last_logits"][:, :v]
    rel = logits_close(f"{label}: prefill's last-position logits, kernels "
                       f"vs plain kernels", stats["last_logits"][:, :v],
                       want, tol)
    agree = float((stats["tokens"] == plain["tokens"]).mean())
    log("lm9", f"{label}: greedy tokens equal to the plain path's: "
        f"{agree:.3f} of all (not gated); the plain path: prefill "
        f"{plain['prefill_s'] * 1e3:.2f} ms, decode "
        f"{plain['decode_tok_per_s']:.2f} tokens/s; on {card}")
    # (what, where, which wrapper, the fault, gated)
    faults = [("flash_attention skips the kv tile on its diagonal", ops,
               "flash_attention", attention_skips_diagonal, True),
              ("flash_attention loses one kv tile's values", ops,
               "flash_attention", attention_drops_tile, False)]
    if cfg.num_experts:
        faults.append(("gather_rows reads the neighbouring slot", md,
                       "gather_rows", gather_next_slot, True))
    seen = {}
    for what, owner, name, fault, gated in faults:
        with patched(owner, name, fault(getattr(owner, name))):
            got = serve_full_lm(arch, 1)["last_logits"][:, :v]
        err, seen[what], ok = close(got.float(), want.float(), rtol=0.0,
                                    atol_of_scale=tol)
        fault_fails(f"{label}: planted fault, {what}", err, seen[what], ok,
                    tol, gated)
    out = {"logits_rel_err_bf16": rel, "greedy_agreement": agree,
           "plain_prefill_ms": plain["prefill_s"] * 1e3,
           "plain_decode_tok_per_s": plain["decode_tok_per_s"],
           "planted_fault_rel_err": seen}
    del plain, want, got
    torch.cuda.empty_cache()
    return out


def fault_fails(label: str, err: float, rel: float, ok: bool,
                tol: float, gated: bool) -> None:
    """Log a planted fault's logits against the tolerance; if ``gated``,
    raise when they lie within it."""
    where = "within" if ok else "outside"
    verdict = ("FAIL: " if ok else "ok: ") if gated else "read only: "
    log("lm9", f"{label}: max_abs_err={err:.4e}, {rel:.3e} of the logits' "
        f"scale (tol {tol:g}); {verdict}{where} the tolerance")
    if gated and ok:
        raise AssertionError(f"{label}: the tolerance passes it")


def lm_prompt(cfg):
    import torch
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).cuda()


def family_f32_check(card: str, arch: str, depth: int) -> dict:
    """``arch`` at full width, ``depth`` layers, float32 (TF32 off), seed-0
    weights, the LM prompts. MoE and hybrid: the prefill and
    ``F32_STEPS`` decode steps (fed the same tokens) through the kernels,
    counts from 0, against the same calls through their plain versions,
    each call's logits within ``LM_F32_TOL`` of scale (the MoE's routing
    decisions compared too). SSM: the chunked prefill against the prompt
    fed token by token through ``decode_step``, within
    ``SSM_FORMS_TOL``."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.models import lm
    cfg = ARCHS[arch].replace(num_layers=depth, dtype=torch.float32)
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
    prompt = lm_prompt(cfg)
    label = f"{arch} width, depth {depth}, float32"
    # the padded vocabulary's logits are -1e30 and would set the scale
    v = cfg.vocab_size
    out = {}
    if cfg.layer_pattern == "ssm":
        def prefill():
            caches = lm.init_caches(cfg, LM_BATCH, LM_PROMPT + 1, "cuda")
            return lm.prefill(params, prompt, caches, cfg)[0]
        chunked, launches = counted(prefill)
        caches = lm.init_caches(cfg, LM_BATCH, LM_PROMPT, "cuda")
        for i in range(LM_PROMPT):
            step, caches = lm.decode_step(params, prompt[:, i:i + 1], caches,
                                          cfg, position=i)
        torch.cuda.synchronize()
        check_launches("lm9", f"{label}: prefill", launches, {},
                       "the SSD runs outside any kernel, as the reference "
                       "computes it outside Pallas")
        out["logits_rel_err_forms"] = logits_close(
            f"{label}: chunked prefill's last-position logits vs the "
            f"{LM_PROMPT} tokens fed one by one through decode_step",
            chunked[:, :v], step[:, :v], SSM_FORMS_TOL)
    else:
        fed = torch.from_numpy(np.random.default_rng(1).integers(
            0, v, (LM_BATCH, F32_STEPS))).cuda()

        def prefill_and_steps():
            caches = lm.init_caches(cfg, LM_BATCH, LM_PROMPT + F32_STEPS,
                                    "cuda")
            logits, caches = lm.prefill(params, prompt, caches, cfg)
            calls = [logits]
            for i in range(F32_STEPS):
                logits, caches = lm.decode_step(
                    params, fed[:, i:i + 1], caches, cfg,
                    position=LM_PROMPT + i)
                calls.append(logits)
            return calls
        with moe_taps() as kernel_taps:
            got, launches = counted(prefill_and_steps)
        with moe_taps() as plain_taps:
            want = plain_kernels(prefill_and_steps)
        per_prefill, per_step = lm_launches(cfg)
        check_launches("lm9", f"{label}: prefill and {F32_STEPS} decode "
                       f"steps", launches,
                       {k: per_prefill.get(k, 0) + F32_STEPS
                        * per_step.get(k, 0) for k in launches},
                       LM_LAUNCHES_TXT)
        moved = sum(int((a != b).sum()) for a, b in
                    zip(kernel_taps["slot"], plain_taps["slot"]))
        if cfg.num_experts:
            total = sum(int(a.numel()) for a in kernel_taps["slot"])
            aux = [float(sum(t["aux"])) for t in (kernel_taps, plain_taps)]
            log("lm9", f"{label}: routing of the prefill and the decode "
                f"steps: {moved} of {total} assignments' slots differ "
                f"between the kernel and the plain path; the prefill's aux "
                f"loss {float(sum(kernel_taps['aux'][:depth])):.6f} (kernel "
                f"path) and {float(sum(plain_taps['aux'][:depth])):.6f} "
                f"(plain); all calls' {aux[0]:.6f} and {aux[1]:.6f}")
            out.update(slots_moved=moved,
                       aux_f32=float(sum(kernel_taps["aux"][:depth])))
        calls = ["prefill's last-position"] + [
            f"decode step {i}'s" for i in range(1, F32_STEPS + 1)]
        out["logits_rel_err_f32"] = max(
            logits_close(f"{label}: {call} logits, kernel vs plain kernels",
                         a[:, :v], b[:, :v], LM_F32_TOL)
            for call, a, b in zip(calls, got, want))
    out["launches_f32"] = launches
    del params
    torch.cuda.empty_cache()
    return out


def family_phase(card: str, arch: str, depth: int) -> dict:
    """One family: the float32 check at ``depth``, then ``serve_lm`` at
    full width and depth in bf16 with the counts from 0 (per call of the
    prefill and of each decode step, checked against the layers), its
    times, peak memory and output; then a prefill and one decode step
    again under ``torch.profiler``, the kernels' device events checked the
    same way. For the MoE: the share of the prefill's assignments dropped
    past capacity and its aux loss."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.distributed.sharding import param_bytes
    from repro_torch.models import lm
    out = family_f32_check(card, arch, depth)
    full = ARCHS[arch]
    label = f"{arch} full width and depth, bf16"
    want_prefill, want_step = lm_launches(full)
    moe_layers = want_step.get("gather_rows", 0)
    why = LM_LAUNCHES_TXT

    torch.cuda.reset_peak_memory_stats()
    with moe_taps() as taps, kept_calls(
            served_indices(want_prefill, want_step)) as kept:
        stats, launches, per_call, _ = serve_counted(
            lambda: serve_full_lm(arch, LM_GEN))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = len(per_call["decode"])
    check_launches("lm9", label, launches,
                   {k: want_prefill.get(k, 0) + steps * want_step.get(k, 0)
                    for k in launches}, why)
    check_launches("lm9", f"{label}: prefill",
                   summed_calls(per_call["prefill"], launches),
                   want_prefill, why)
    for i, c in enumerate(per_call["decode"]):
        if c != {k: want_step.get(k, 0) for k in c}:
            raise AssertionError(f"{label}: decode step {i} launched {c}")
    log("lm9", f"{label}: each of the {steps} decode steps launched "
        f"{want_step or 'no kernel'}")
    tokens, logits = stats["tokens"], stats["last_logits"]
    if (tokens.shape != (LM_BATCH, LM_GEN)
            or tuple(logits.shape) != (LM_BATCH, full.vocab_pad)
            or not bool(torch.isfinite(logits[:, :full.vocab_size]).all())
            or int(tokens.max()) >= full.vocab_size):
        raise AssertionError(f"{label}: tokens {tokens.shape}, logits "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    if full.num_experts:
        # the prefill's layers come first in call order
        own = taps["own"][:moe_layers]
        drop = float(sum(int((~o).sum()) for o in own)
                     / sum(o.numel() for o in own))
        aux = float(sum(taps["aux"][:moe_layers]))
        log("lm9", f"{label}: the prefill's {moe_layers} MoE layers dropped "
            f"{drop:.4%} of their {own[0].numel()} assignments each past "
            f"capacity {full.capacity_factor} on average; aux loss {aux:.6f} "
            f"(summed over layers; a layer in perfect balance gives "
            f"top-k = {full.num_experts_per_tok})")
        out.update(drop_share=drop, aux=aux)
    del taps
    # the kernels against their plain versions at the served shapes, call
    # by call and end to end
    out["rows"] = served_call_rows(card, arch, kept, want_prefill)
    del kept
    if want_prefill:
        out.update(served_vs_plain(card, arch, full, stats))
    weights_gb = param_bytes(lm.lm_param_defs(full)) / 1e9
    log("lm9", f"{label}: B={LM_BATCH} prompts of {LM_PROMPT} tokens, "
        f"{LM_GEN} generated each: prefill {stats['prefill_s'] * 1e3:.2f} ms, "
        f"decode {stats['decode_tok_per_s']:.2f} tokens/s ({steps} steps, "
        f"{stats['decode_s'] * 1e3:.2f} ms); weights {weights_gb:.2f} GB, "
        f"peak allocated {peak_gb:.2f} GB; on {card}")
    torch.cuda.empty_cache()

    # the same traffic's prefill and first decode step under the profiler
    _, _, _, events = serve_counted(lambda: serve_full_lm(arch, 2),
                                    profile_calls=1)
    for phase, want in (("prefill", want_prefill), ("decode", want_step)):
        ev = events[phase][0]
        got = ev["kernels"]
        log("lm9", f"{label}: {phase}'s device events {got} (expected "
            f"{want or 'none'}); profiler on: {ev['wall_ms']:.2f} ms wall, "
            f"the card busy {ev['busy_ms']:.2f} ms; top device ops "
            + "; ".join(f"{r['name']} {r['us']:.1f} us x{r['count']}"
                        for r in ev["top_device"]))
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"{label}: the {phase}'s device events are "
                                 f"not its kernels' launches")
    torch.cuda.empty_cache()
    out.update({"launches": launches,
                "launches_prefill": summed_calls(per_call["prefill"],
                                                 launches),
                "launches_decode_step": per_call["decode"][0],
                "profiled": {k: v[0] for k, v in events.items()},
                "prefill_ms": stats["prefill_s"] * 1e3,
                "decode_tok_per_s": stats["decode_tok_per_s"],
                "peak_allocated_gb": peak_gb, "weights_gb": weights_gb})
    return out


def lm_families_phase(card: str) -> dict:
    """Phase 9: olmoe-1b-7b (MoE on mp_scatter and gather_rows, and
    flash_attention), mamba2-2.7b (no kernel) and recurrentgemma-2b
    (flash_attention on its local layers, D=256, window 2048, one KV head)
    at full width and depth, each freed before the next."""
    t0 = time.perf_counter()
    out = {f"lm_{arch}": family_phase(card, arch, depth)
           for arch, depth in LM_FAMILIES}
    log("lm9", f"phase 9 took {time.perf_counter() - t0:.1f} s; on {card}")
    return out


# ---------------------------------------------------------------------------
# the slice, end to end
# ---------------------------------------------------------------------------

def init_params(name: str, device: str):
    """The paper config of any of the six models and random weights from
    ``torch.Generator().manual_seed(0)``."""
    import torch
    from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn
    cfg = PAPER_GNN_CONFIGS[name]
    return cfg, make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                                   device=device)


def main_path_inputs(name: str, impl: str, kernel: str, batch):
    """What the main path of ``name`` under ``impl`` hands the ``kernel``
    wrapper in its first two layers on one padded graph on the card: the
    arguments of each call, recorded at the wrapper as the model code calls
    it (terms it leaves out dropped)."""
    import torch
    from repro_torch.core.message_passing import DataflowConfig
    from repro_torch.core.models import make_gnn
    from repro_torch.kernels import ops
    cfg, params = init_params(name, "cuda")
    real = getattr(ops, kernel)
    seen = []

    def record(*args, **kw):
        seen.append({**dict(zip(KERNEL_POSITIONAL[kernel], args)),
                     **{k: v for k, v in kw.items() if v is not None}})
        return real(*args, **kw)

    setattr(ops, kernel, record)
    try:
        with torch.inference_mode():
            make_gnn(cfg).apply(params, batch, cfg, DataflowConfig(impl=impl))
    finally:
        setattr(ops, kernel, real)
    if len(seen) != cfg.num_layers:
        raise AssertionError(f"{name} {impl}: {len(seen)} {kernel} calls, "
                             f"expected one per layer ({cfg.num_layers})")
    return seen[:2]


# each kernel's symbol in csrc/ and the wrappers that launch it: how a
# captured graph's kernel nodes and the profiler's device events are told
# apart
KERNEL_SYMBOLS = {"layer_fused_kernel": ("layer_fused",),
                  "mp_pipeline_kernel": ("mp_pipeline",),
                  "mp_scatter_kernel": ("mp_scatter", "mp_scatter_multi"),
                  "seg_softmax_kernel": ("seg_softmax",)}
SYMBOL_OF = {w: sym for sym, ws in KERNEL_SYMBOLS.items() for w in ws}
# where the captured graphs' debug dumps go (Graphviz, one per program)
GRAPH_DUMPS = REPO / "build" / "repro_torch" / "graphs"
# eager forwards of every graph, as served and under deterministic
# algorithms
EAGER_RUNS = 2


def graph_args(g):
    return g.node_feat, g.senders, g.receivers, g.edge_feat, g.node_pos


def bucket_of(engine, g):
    """The engine's bucket key for graph ``g`` served alone: its graph slots
    are the default queue's ``max_batch``, as in the reference."""
    from repro_torch.core.graph import pad_bucket
    return (pad_bucket(max(g.node_feat.shape[0], 1), engine.buckets),
            pad_bucket(max(g.senders.shape[0], 1), engine.buckets),
            engine._scheduler.graph_pads()[0])


def alone_batch(g, bucket):
    """Graph ``g`` alone in a ``PackedBatch`` sealed to ``bucket``."""
    from repro_torch.core.packing import PackedBatch, PackItem
    return PackedBatch(items=[PackItem(*graph_args(g))], node_pad=bucket[0],
                       edge_pad=bucket[1], graph_pad=bucket[2])


def program_of(engine, g, bucket=None):
    """The program of the engine's first executor that serves ``g`` alone
    (in ``bucket``, else its own; built already, the executor idle), and
    the batch of ``g`` alone in that bucket."""
    bucket = bucket_of(engine, g) if bucket is None else bucket
    ex = engine._executors[0]
    pb = alone_batch(g, bucket)
    with ex.on_device():
        return engine._ensure_program(ex, bucket, pb), pb


def warm_buckets(engine, graphs):
    """Serve, unrecorded, the first graph of every bucket ``graphs`` reach,
    so that no program is built (captured) inside a timed run: {bucket:
    (its first graph, host seconds to serve it: the program's build, i.e.
    staging, the warm-up run and the capture, then its first replay)}."""
    first = {}
    for g in graphs:
        first.setdefault(bucket_of(engine, g), g)
    out = {}
    for bucket, g in first.items():
        t0 = time.perf_counter()
        engine.warmup(*graph_args(g))
        out[bucket] = (g, time.perf_counter() - t0)
    return out


def kernel_nodes(prog, path) -> list:
    """The kernel nodes of a ``CapturedProgram``'s graph, one label each,
    as ``CUDAGraph.debug_dump`` writes them (Graphviz) to ``path``: what
    the graph launches, read from the graph rather than the counts."""
    prog.graph.debug_dump(str(path))
    text = Path(path).read_text(errors="replace")
    nodes = re.split(r'"graph_\d+_node_\d+"\s*\[', text)[1:]
    return [node for node in nodes if "KERNEL" in node]


def device_kernels(run):
    """``run()`` under ``torch.profiler`` with CUDA activity: (what it
    returned, the device kernel events of each symbol of
    ``KERNEL_SYMBOLS``). Each kernel the card ran is one event, those
    inside a CUDA-graph replay too."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = run()
        torch.cuda.synchronize()
    on_device, _ = event_tables(prof)
    return result, {sym: sum(c for name, (_, c) in on_device.items()
                             if sym in name) for sym in KERNEL_SYMBOLS}


def by_symbol(per_graph: dict, times: int) -> dict:
    """``per_graph`` launches (by wrapper) ``times`` over, by symbol."""
    return {sym: times * sum(per_graph.get(w, 0) for w in wrappers)
            for sym, wrappers in KERNEL_SYMBOLS.items()}


def eager_forward(engine, g):
    """The parent's batch-1 path, composed here from the engine's parts:
    the admission check, ``build_graph_batch`` (nine copies from pageable
    memory), the eager forward between two CUDA events and the output on
    the host. (prediction, forward span s, host latency s)."""
    import torch
    from repro_torch.core.graph import build_graph_batch
    from repro_torch.core.validate import check_graph
    t0 = time.perf_counter()
    cfg = engine.cfg
    reason = check_graph(*graph_args(g), node_feat_dim=cfg.node_feat_dim,
                         edge_feat_dim=cfg.edge_feat_dim,
                         pos_dim=cfg.pos_dim)
    if reason is not None:
        raise AssertionError(reason)
    node_pad, edge_pad, graph_pad = bucket_of(engine, g)
    batch = build_graph_batch(
        g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
        node_pos=g.node_pos, node_pad=node_pad, edge_pad=edge_pad,
        graph_pad=graph_pad, pos_dim=cfg.pos_dim, device=engine.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    with torch.inference_mode():
        out = engine.model.apply(engine.params, batch, cfg, engine.dataflow)
    end.record()
    pred = out.cpu().numpy()[0]
    return pred, start.elapsed_time(end) * 1e-3, time.perf_counter() - t0


def rel_diff(a, b) -> float:
    """max |a - b| relative to max(1, max |b|)."""
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


@contextmanager
def deterministic():
    """torch's deterministic algorithms while the block runs: ``index_add_``
    on the card then sums without atomics (the readout, the statistics,
    DGN's field), so two eager forwards are bitwise equal. ``warn_only``:
    cuBLAS asks for a workspace setting this script does not make (its
    products run on one stream here, in a fixed order, either way)."""
    import torch
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def as_eager(label: str, preds, eager, det_preds, det_eager) -> dict:
    """Hold the served predictions ``preds`` to the eager forward of their
    graphs (composed here: ``eager_forward``), run ``EAGER_RUNS`` times as
    served (``eager``) and as often under ``deterministic()``
    (``det_eager``). As served the readout's ``index_add_`` and DGN's field
    sums add with atomics, in an order that changes from run to run: the
    answers must agree with the first eager run to ``EAGER_RTOL``, and the
    eager runs' own spread is logged beside. Under ``deterministic()``
    every eager run must be bitwise the first, and so must the answers of
    an engine captured there (``det_preds``)."""
    spread = max(rel_diff(r[i], eager[0][i]) for r in eager
                 for i in range(len(preds)))
    worst = max(rel_diff(p, eager[0][i]) for i, p in enumerate(preds))
    runs_equal = all(np.array_equal(r[i], det_eager[0][i])
                     for r in det_eager for i in range(len(preds)))
    bitwise = sum(bool(np.array_equal(p, det_eager[0][i]))
                  for i, p in enumerate(det_preds))
    log("slice", f"{label}: vs the eager forward (composed from "
        f"build_graph_batch and model.apply): as served worst "
        f"{worst:.3e} relative to max(1, |ref|) (tol {EAGER_RTOL:g}; "
        f"{len(eager)} eager runs spread {spread:.3e}); under deterministic "
        f"algorithms {len(det_eager)} eager runs "
        f"{'bitwise equal' if runs_equal else 'NOT bitwise equal'} and a "
        f"captured engine's answers bitwise equal to them on {bitwise}/"
        f"{len(preds)} graphs")
    if not runs_equal or bitwise != len(preds) or worst > EAGER_RTOL:
        raise AssertionError(f"{label}: the captured engine's answers "
                             f"differ from the eager forward's")
    return {"bitwise_deterministic": bitwise, "graphs": len(preds),
            "worst_rel_as_served": worst, "eager_spread_as_served": spread}


def check_captured(label: str, engine, builds: dict, per_graph: dict) -> dict:
    """Raise unless every program of ``engine`` is a captured CUDA graph
    whose kernel nodes (``kernel_nodes``: read from the graph, not the
    counts) hold each kernel's symbol as often as ``per_graph`` says a
    forward launches it; each program's build time (``builds``, from
    ``warm_buckets``) and kernel nodes."""
    from repro_torch.core.engine import CapturedProgram
    GRAPH_DUMPS.mkdir(parents=True, exist_ok=True)
    want = by_symbol(per_graph, 1)
    out = {}
    for (bucket, widths), prog in engine.compiled.items():
        if not isinstance(prog, CapturedProgram):
            raise AssertionError(f"{label}: bucket {bucket} is not served "
                                 f"from a captured graph")
        tag = "_".join(map(str, bucket))
        nodes = kernel_nodes(prog, GRAPH_DUMPS / f"{label.split()[0]}_"
                             f"{label.split()[-1]}_{tag}.dot")
        found = {sym: sum(sym in n for n in nodes) for sym in want}
        build_s = builds[bucket][1]
        log("slice", f"{label}: bucket {bucket}: built in "
            f"{build_s * 1e3:.1f} ms (staging, warm-up run, capture, first "
            f"replay); the graph holds {len(nodes)} kernel nodes, ours by "
            f"symbol {found} (expected {want})")
        if not out:
            log("slice", f"{label}: one of its kernel nodes as debug_dump "
                f"writes it: " + " ".join(next((n for n in nodes if any(
                    sym in n for sym in want)), "")[:240].split()))
        if found != want:
            raise AssertionError(f"{label}: the captured graph of bucket "
                                 f"{bucket} does not hold the expected "
                                 f"kernels")
        out[tag] = {"build_ms": build_s * 1e3, "kernel_nodes": len(nodes),
                    "ours_by_symbol": found}
    return out


def serve_path(card: str, name: str, impl: str, graphs, *,
               per_graph: dict, passes: int, profile: bool = False):
    """Serve ``graphs`` with the paper config of ``name`` under ``impl``
    through the engine, which answers each bucket from one captured CUDA
    graph. The main path's run: the launch counts set to 0, then the first
    graph of every bucket the traffic reaches served unrecorded (each
    bucket's program is built then: one eager warm-up run, then the
    capture), then every graph served under ``torch.profiler``, then the
    counts read. The wrappers count where they enqueue a launch, so they
    must show ``per_graph`` twice per program built (its warm-up run and
    its capture; a replay counts nothing, 0 for a kernel not named); the
    profiler's device kernel events must show ``per_graph`` per graph
    served, by symbol: the launches the card ran in the replays, which is
    what the path reports as its ``launches``. Each captured graph must hold
    those kernels (``check_captured``); every bucket must show ``passes``
    passes over the edges; the predictions must be finite, agree with the
    eager forward's (``as_eager``), match the plain ``impl='fused'`` path on
    the card and, for a sample, the CPU path. Then the graphs are served
    again with the profiler off, for the latencies."""
    import torch
    from repro_torch.core.engine import GraphStreamEngine, StreamStats
    from repro_torch.core.message_passing import DataflowConfig

    cfg, params = init_params(name, "cuda")
    label = f"{name.upper()} paper config, {impl}"
    engine = GraphStreamEngine(cfg, params, DataflowConfig(impl=impl),
                               device="cuda")

    def serve():
        builds = warm_buckets(engine, graphs)
        preds, on_device = device_kernels(
            lambda: [engine.process(*graph_args(g)) for g in graphs])
        return builds, preds, on_device
    (builds, preds, on_device), counts = counted(serve)
    built = len(engine.compiled)
    if built != len(builds):
        raise AssertionError(f"{label}: {built} programs for "
                             f"{len(builds)} buckets")
    log("slice", f"{label}: served {len(graphs)} graphs (+{len(builds)} "
        f"warmup, one per bucket) under the profiler")
    check_launches("slice", label, counts,
                   {k: 2 * v * built for k, v in per_graph.items()},
                   f"{per_graph} per forward x {built} programs x 2: each "
                   f"program's warm-up run and its capture; a replay runs "
                   f"no wrapper")
    want = by_symbol(per_graph, len(graphs))
    log("slice", f"{label}: device kernel events in the {len(graphs)} "
        f"replays (torch.profiler) by symbol {on_device} (expected {want}: "
        f"{per_graph} per graph)")
    if on_device != want:
        raise AssertionError(f"{label}: the replays did not run the "
                             f"expected kernels on the card")
    launches = {k: on_device[SYMBOL_OF[k]] if k in per_graph else 0
                for k in counts}
    programs = check_captured(label, engine, builds, per_graph)
    log("slice", f"{label}: edge passes per bucket {engine.edge_passes}")
    if set(engine.edge_passes.values()) != {passes}:
        raise AssertionError(f"{label}: expected {passes} passes over the "
                             f"edges per forward")
    eager = [[eager_forward(engine, g)[0] for g in graphs]
             for _ in range(EAGER_RUNS)]
    with deterministic():
        det = GraphStreamEngine(cfg, params, DataflowConfig(impl=impl),
                                device="cuda")
        det_preds = [det.process(*graph_args(g)) for g in graphs]
        det_eager = [[eager_forward(det, g)[0] for g in graphs]
                     for _ in range(EAGER_RUNS)]
        det.close()
    vs_eager = as_eager(label, preds, eager, det_preds, det_eager)

    plain = GraphStreamEngine(cfg, params, DataflowConfig(impl="fused"),
                              device="cuda")
    ref = [plain.process(*graph_args(g)) for g in graphs]
    cpu = GraphStreamEngine(cfg, params, DataflowConfig(impl=impl),
                            device="cpu")
    worst = 0.0
    for i, (p, r) in enumerate(zip(preds, ref)):
        if p.shape != (cfg.out_dim,) or not np.isfinite(p).all():
            raise AssertionError(f"{label}: graph {i}: bad prediction {p}")
        worst = max(worst, rel_diff(p, r))
        if i % 9 == 0:                         # a sample against the CPU
            c = cpu.process(*graph_args(graphs[i]))
            np.testing.assert_allclose(p, c, rtol=SLICE_RTOL,
                                       atol=SLICE_RTOL * max(1.0, float(
                                           np.abs(c).max())))
    n_cpu = len(range(0, len(graphs), 9))
    log("slice", f"{label}: predictions finite, shape ({cfg.out_dim},); "
        f"worst error vs impl='fused' on the card {worst:.3e} relative to "
        f"max(1, |ref|) (tol {SLICE_RTOL:g}); a sample of {n_cpu} matches "
        f"the CPU path")
    if worst > SLICE_RTOL:
        raise AssertionError(f"{label}: served predictions disagree with "
                             f"the plain path")
    engine.stats = StreamStats()
    t0 = time.perf_counter()
    for g in graphs:
        engine.process(*graph_args(g))
    wall = time.perf_counter() - t0
    summary = engine.stats.summary()
    plain_summary = plain.stats.summary()
    log("slice", f"{label}, batch 1 (profiler off): p50 "
        f"{summary['p50_ms']:.3f} ms, p90 {summary['p90_ms']:.3f} ms, p99 "
        f"{summary['p99_ms']:.3f} ms; forward span (CUDA events around the "
        f"replay) {summary['device_mean_ms']:.3f} ms/graph, "
        f"{summary['throughput_gps']:.1f} graphs/s of forward span; "
        f"{len(graphs) / wall:.1f} graphs/s wall; same graphs under "
        f"impl='fused' (plain PyTorch, captured too): p50 "
        f"{plain_summary['p50_ms']:.3f} ms, forward span "
        f"{plain_summary['device_mean_ms']:.3f} ms/graph; on {card}")
    result = {"model": name, "impl": impl, "graphs": len(graphs),
              "launches": launches, "wrapper_launches": counts,
              "summary": summary, "plain_summary": plain_summary,
              "wall_s": wall, "worst_rel_err_vs_fused": worst,
              "vs_eager": vs_eager, "programs": programs,
              "edge_passes": {str(k): v for k, v in
                              engine.edge_passes.items()}}
    if profile:
        result["profile"] = profile_serving(
            label, lambda g: captured_span(engine, g), graphs[:16], card)
    for e in (engine, plain, cpu):
        e.close()
    torch.cuda.synchronize()
    return result


def captured_span(engine, g) -> float:
    """Serve ``g`` through the engine (recorded); its replay's span (s)."""
    engine.process(*graph_args(g))
    return engine.stats.device_s[-1]


def slice_graphs():
    """Phase 4's traffic: 64 molecules, then 8 kNN graphs."""
    from repro_torch.data.graphs import hep_like, molhiv_like
    return (list(molhiv_like(seed=0, n_graphs=64))
            + list(hep_like(seed=2, n_graphs=8)))


def slice_phase(card: str, graphs):
    """Phase 4: every path of the slice, each with its own counts."""
    # the pipeline and kernel runs are shorter: 16 molecules and 4 kNN graphs
    short = graphs[:16] + graphs[64:68]
    lf, mp = "layer_fused", "mp_pipeline"
    sc, scm, ss = "mp_scatter", "mp_scatter_multi", "seg_softmax"
    # (model, impl, graphs, launches per graph, passes per bucket, profiled)
    paths = [
        ("gin", "fused_layer", graphs, {lf: 5}, 5, True),
        ("gat", "fused_layer", graphs, {mp: 5}, 5, True),
        ("gcn", "fused_layer", graphs, {lf: 5}, 6, False),
        ("pna", "fused_layer", graphs, {lf: 4}, 5, True),
        ("dgn", "fused_layer", graphs, {lf: 4}, 7, True),
        ("gin_vn", "fused_layer", graphs, {lf: 5}, 5, False),
        ("gin", "pipeline", short, {mp: 5}, 5, False),
        ("gcn", "pipeline", short, {mp: 5}, 6, False),
        ("pna", "pipeline", short, {mp: 4}, 5, False),
        ("dgn", "pipeline", short, {mp: 4}, 7, False),
        # impl='kernel': the message is built by PyTorch ops, then every
        # aggregation is one scatter launch
        ("gin", "kernel", short, {sc: 5}, 10, False),
        ("gcn", "kernel", short, {sc: 5}, 11, False),
        ("gin_vn", "kernel", short, {sc: 5}, 10, False),
        ("gat", "kernel", short, {sc: 5, ss: 5}, 20, True),
        ("pna", "kernel", short, {scm: 4}, 9, False),
        ("dgn", "kernel", short, {scm: 4}, 11, False),
    ]
    return {f"{name}_{impl}": serve_path(card, name, impl, gs,
                                         per_graph=per_graph, passes=passes,
                                         profile=profile)
            for name, impl, gs, per_graph, passes, profile in paths}


def event_tables(prof):
    """A profile's device events (kernel time) and host events (self CPU
    time), each ``{name: (us, count)}``."""
    import torch
    on_device, on_host = {}, {}
    for ev in prof.events():
        cuda = ev.device_type == torch.autograd.DeviceType.CUDA
        table = on_device if cuda else on_host
        us = (ev.time_range.elapsed_us() if cuda
              else ev.self_cpu_time_total)
        t, c = table.get(ev.name, (0.0, 0))
        table[ev.name] = (t + us, c + 1)
    return on_device, on_host


def top(table, k):
    """The ``k`` entries of an event table with the most time."""
    return [{"name": name[:70], "us": t, "count": c} for name, (t, c) in
            sorted(table.items(), key=lambda kv: -kv[1][0])[:k]]


def profile_serving(label: str, serve, graphs, card: str) -> dict:
    """Device-busy share and the top device and host ops while ``serve(g)``
    answers each of ``graphs`` (``torch.profiler``); ``serve`` returns its
    forward's span (s), summed beside the profiler's busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        spans = [serve(g) for g in graphs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_device, on_host = event_tables(prof)
    busy_us = sum(t for t, _ in on_device.values())
    span_us = sum(spans) * 1e6
    out = {"graphs": len(graphs), "wall_ms": wall * 1e3,
           "device_busy_us": busy_us,
           "device_busy_share": busy_us / (wall * 1e6),
           # graphs per second of the card's own busy time: what one card
           # would serve if the host kept it fed
           "busy_throughput_gps": (len(graphs) / (busy_us * 1e-6)
                                   if busy_us else None),
           "span_us": span_us,
           "host_self_us": sum(t for t, _ in on_host.values()),
           "top_device": top(on_device, 10), "top_host": top(on_host, 10)}
    if not busy_us:
        log("profile", f"{label}: the profiler saw no device events")
    log("profile", f"{label}: {len(graphs)} graphs in {wall * 1e3:.2f} ms "
        f"wall (profiler on); device busy {busy_us:.1f} us "
        f"({out['device_busy_share']:.1%} of wall), "
        f"{busy_us / len(graphs):.1f} us/graph; forward spans "
        f"{span_us / len(graphs):.1f} us/graph; on {card}")
    for side in ("top_device", "top_host"):
        for row in out[side]:
            log("profile", f"  {side[4:]:6} {row['us']:10.1f} us "
                f"x{row['count']:<5} {row['name']}")
    return out


# ---------------------------------------------------------------------------
# the batch-1 host path: the parent's eager forward against the captured
# engine
# ---------------------------------------------------------------------------

# (model, impl): the paths whose host side phase 4b breaks down
HOST_PATHS = (("gin", "fused_layer"), ("gat", "fused_layer"),
              ("pna", "fused_layer"), ("gat", "kernel"))
HOST_REPS = 3       # each step of each graph timed this many times


def median_us(xs) -> float:
    return statistics.median(xs) * 1e6


def host_steps(engine, graphs) -> dict:
    """Each step of both paths' host side timed alone on the host clock, the
    card idle before each (median us over ``graphs`` x ``HOST_REPS``).
    Eager (the parent's): ``build_graph_batch`` (padding and nine copies
    from pageable memory), the forward's enqueue (``model.apply``), the
    output's copy and wait (``.cpu()``). Captured: padding into pinned
    memory (``stage``), enqueueing the one copy (``upload``), launching the
    replay (``replay``), the copy-out and the wait (``copy_out`` +
    ``wait``), on the program's stream, outside the engine's threads."""
    import torch
    from repro_torch.core.graph import build_graph_batch
    steps = {k: [] for k in ("build_graph_batch", "apply_enqueue",
                             "cpu_wait", "stage", "upload", "replay",
                             "download")}
    for g in graphs:
        prog, pb = program_of(engine, g)
        node_pad, edge_pad, graph_pad = bucket_of(engine, g)
        for _ in range(HOST_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = build_graph_batch(
                g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
                node_pos=g.node_pos, node_pad=node_pad, edge_pad=edge_pad,
                graph_pad=graph_pad, pos_dim=engine.cfg.pos_dim,
                device=engine.device)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            with torch.inference_mode():
                out = engine.model.apply(engine.params, batch, engine.cfg,
                                         engine.dataflow)
            t3 = time.perf_counter()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            out.cpu()
            t5 = time.perf_counter()
            steps["build_graph_batch"].append(t1 - t0)
            steps["apply_enqueue"].append(t3 - t2)
            steps["cpu_wait"].append(t5 - t4)
            with torch.cuda.stream(prog.stream):
                t0 = time.perf_counter()
                prog.stage(pb, 0)
                t1 = time.perf_counter()
                prog.upload(0)
                t2 = time.perf_counter()
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                prog.replay(0)
                t4 = time.perf_counter()
                torch.cuda.synchronize()
                t5 = time.perf_counter()
                prog.copy_out(0)
                prog.wait(0)
                t6 = time.perf_counter()
            steps["stage"].append(t1 - t0)
            steps["upload"].append(t2 - t1)
            steps["replay"].append(t4 - t3)
            steps["download"].append(t6 - t5)
    return {k: median_us(v) for k, v in steps.items()}


def scatter_host_cost(engine, graphs) -> dict:
    """The host cost of one ``mp_scatter`` call in the eager forward (its
    wrapper timed on the host clock while the card is kept busy, so no call
    waits on the queue) against its share of a replay (the replay's launch
    over the graph's kernel nodes), median over ``graphs``."""
    import torch
    from repro_torch.core.graph import build_graph_batch
    from repro_torch.kernels import ops
    real = ops.mp_scatter
    calls = []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        calls.append(time.perf_counter() - t0)
        return out

    ops.mp_scatter = timed
    try:
        for g in graphs:
            node_pad, edge_pad, graph_pad = bucket_of(engine, g)
            batch = build_graph_batch(
                g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
                node_pos=g.node_pos, node_pad=node_pad, edge_pad=edge_pad,
                graph_pad=graph_pad, pos_dim=engine.cfg.pos_dim,
                device=engine.device)
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)        # ~25 ms of the card
            with torch.inference_mode():
                engine.model.apply(engine.params, batch, engine.cfg,
                                   engine.dataflow)
            torch.cuda.synchronize()
    finally:
        ops.mp_scatter = real
    replays, per_node, nodes = [], [], None
    for g in graphs:
        prog, _ = program_of(engine, g)
        nodes = len(kernel_nodes(prog, GRAPH_DUMPS / "scatter_host.dot"))
        with torch.cuda.stream(prog.stream):
            for _ in range(HOST_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prog.replay(0)
                replays.append(time.perf_counter() - t0)
                per_node.append(replays[-1] / max(nodes, 1))
        torch.cuda.synchronize()
    return {"eager_call_us": median_us(calls), "eager_calls": len(calls),
            "replay_us": median_us(replays), "kernel_nodes": nodes,
            "replay_share_per_node_us": median_us(per_node)}


def host_phase(card: str, graphs) -> dict:
    """Phase 4b: for each of ``HOST_PATHS`` on phase 4's graphs, the
    parent's eager forward (composed: ``eager_forward``) against the
    captured engine, in one process: p50 / p99 latency, forward-span
    throughput, device-busy us a graph and share of the wall (16 molecules
    under the profiler), each host step alone (``host_steps``), and for
    GAT ``kernel`` the host cost of one ``mp_scatter`` call eager against
    its share of a replay."""
    from repro_torch.core.engine import GraphStreamEngine, StreamStats
    from repro_torch.core.message_passing import DataflowConfig
    out = {}
    for name, impl in HOST_PATHS:
        label = f"{name.upper()} {impl}"
        cfg, params = init_params(name, "cuda")
        engine = GraphStreamEngine(cfg, params, DataflowConfig(impl=impl),
                                   device="cuda")
        for g, _ in warm_buckets(engine, graphs).values():
            eager_forward(engine, g)
        eager = [eager_forward(engine, g) for g in graphs]
        lat = np.array([e[2] for e in eager])
        eager_row = {"p50_ms": float(np.percentile(lat, 50) * 1e3),
                     "p99_ms": float(np.percentile(lat, 99) * 1e3),
                     "throughput_gps": len(eager) / sum(e[1] for e in eager)}
        engine.stats = StreamStats()
        for g in graphs:
            engine.process(*graph_args(g))
        summary = engine.stats.summary()
        captured_row = {k: summary[k] for k in ("p50_ms", "p99_ms",
                                                "throughput_gps")}
        eager_row["profile"] = profile_serving(
            f"{label} eager", lambda g: eager_forward(engine, g)[1],
            graphs[:16], card)
        captured_row["profile"] = profile_serving(
            f"{label} captured", lambda g: captured_span(engine, g),
            graphs[:16], card)
        steps = host_steps(engine, graphs)
        for row, p in ((eager_row, eager_row["profile"]),
                       (captured_row, captured_row["profile"])):
            row["busy_us_per_graph"] = p["device_busy_us"] / p["graphs"]
            row["busy_share"] = p["device_busy_share"]
            row["busy_throughput_gps"] = p["busy_throughput_gps"]
        out[f"{name}_{impl}"] = {"eager": eager_row,
                                 "captured": captured_row, "steps": steps}
        for kind, row in (("eager", eager_row), ("captured", captured_row)):
            log("host", f"{label} {kind:8}: p50 {row['p50_ms']:.3f} ms, p99 "
                f"{row['p99_ms']:.3f} ms, {row['throughput_gps']:.1f} "
                f"graphs/s of forward span; device busy "
                f"{row['busy_us_per_graph']:.1f} us/graph, "
                f"{row['busy_share']:.1%} of the wall; on {card}")
        log("host", f"{label} host steps alone, median us over "
            f"{len(graphs)} graphs x {HOST_REPS}: eager build_graph_batch "
            f"{steps['build_graph_batch']:.1f}, apply (enqueue) "
            f"{steps['apply_enqueue']:.1f}, .cpu() {steps['cpu_wait']:.1f}; "
            f"captured stage (pad into pinned) {steps['stage']:.1f}, upload "
            f"(enqueue one copy) {steps['upload']:.1f}, replay (launch) "
            f"{steps['replay']:.1f}, download (copy out + sync) "
            f"{steps['download']:.1f}; on {card}")
        if impl == "kernel":
            hep = [g for g in graphs if bucket_of(engine, g)[1] == 1024]
            cost = scatter_host_cost(engine, hep)
            out[f"{name}_{impl}"]["mp_scatter_host"] = cost
            log("host", f"{label} mp_scatter host cost at the hep bucket: "
                f"eager {cost['eager_call_us']:.1f} us a call (median of "
                f"{cost['eager_calls']}); captured: a replay's launch "
                f"{cost['replay_us']:.1f} us for {cost['kernel_nodes']} "
                f"kernel nodes, {cost['replay_share_per_node_us']:.2f} us "
                f"a node; on {card}")
        engine.close()
    return out


# ---------------------------------------------------------------------------
# packed serving: submit / drain through the scheduler and an executor
# ---------------------------------------------------------------------------

# launches one forward makes, by wrapper, on each of HOST_PATHS
HOST_LAUNCHES = {("gin", "fused_layer"): {"layer_fused": 5},
                 ("gat", "fused_layer"): {"mp_pipeline": 5},
                 ("pna", "fused_layer"): {"layer_fused": 4},
                 ("gat", "kernel"): {"mp_scatter": 5, "seg_softmax": 5}}
# (max_batch, eager_flush) of each packed run, and the packers' max_wait
PACKED_RUNS = ((8, False), (64, False), (8, True))
PACKED_WAIT_MS = 5.0
# the paper's largest batch (Fig. 7), one GIN run
PACKED_LARGEST = 1024


def stream(engine, graphs, record=True, queue=None):
    """Submit every graph of ``graphs``, then drain: (the answers in order,
    host seconds from the first submit to the drain's end)."""
    t0 = time.perf_counter()
    futs = [engine.submit(*graph_args(g), record=record, queue=queue)
            for g in graphs]
    engine.drain(timeout=600)
    wall = time.perf_counter() - t0
    return [f.result(timeout=60) for f in futs], wall


def completed(engine) -> list:
    """From now on, record each batch the engine's executors complete: the
    returned list gets their ``CompletedBatch`` (its bucket and graphs, the
    dispatch thread's enqueue from ``t_build_start`` to ``t_dispatch``, the
    replay's span ``device_s``)."""
    seen = []
    for ex in engine._executors:
        def record(e, done, real=ex._on_complete):
            seen.append(done)
            real(e, done)
        ex._on_complete = record
    return seen


def buckets_by_request(done: list) -> dict:
    """{request id: the bucket its batch was served in}."""
    return {it.payload.req_id: d.batch.bucket for d in done
            for it in d.batch.items}


def profiled(run):
    """``run()`` under ``torch.profiler`` with CUDA activity: (what it
    returned, the device events ``{name: (us, count)}``, wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_device, _ = event_tables(prof)
    return result, on_device, wall


def events_by_symbol(on_device: dict) -> dict:
    return {sym: sum(c for name, (_, c) in on_device.items() if sym in name)
            for sym in KERNEL_SYMBOLS}


def profiled_pass(tag: str, engine, per_graph: dict, serve) -> tuple:
    """``serve()`` under ``torch.profiler``, the engine's stats reset first:
    raise unless the card's kernel events are a forward's (``per_graph``)
    for each batch served and each program built inside the pass (its
    warm-up run runs on the card); (device events, wall s, batches)."""
    from repro_torch.core.engine import StreamStats
    built = len(engine.compiled)
    engine.stats = StreamStats()
    _, on_device, wall = profiled(serve)
    batches = len(engine.stats.batch_sizes)
    built_inside = len(engine.compiled) - built
    got = events_by_symbol(on_device)
    want = by_symbol(per_graph, batches + built_inside)
    log("packed", f"{tag}: device kernel events under the profiler by "
        f"symbol {got} (expected {want}: {per_graph} per forward x "
        f"({batches} batches served + {built_inside} programs built in the "
        f"pass, whose warm-up run runs on the card))")
    if got != want:
        raise AssertionError(f"{tag}: the replays did not run the expected "
                             f"kernels on the card")
    return on_device, wall, batches


def packed_run(card: str, label: str, name: str, impl: str, graphs, ref, *,
               max_batch: int, eager_flush: bool) -> dict:
    """One packed run of ``graphs`` through ``submit`` / ``drain``, counts
    from 0: ``warmup_all``, one unrecorded pass (it builds the buckets the
    stream reaches beyond warmup_all's), the measured pass (profiler off:
    p50 / p99, mean batch size, forward-span and wall throughputs), then a
    pass under ``torch.profiler`` (device-busy us a graph and share of the
    wall; the device kernel events, which must be a forward's for each
    batch served and for each program built inside the pass). The wrappers
    must count two forwards per program built; every answer must be within
    ``EAGER_RTOL`` of ``ref`` (the graphs served through ``process``)."""
    from repro_torch.core.engine import GraphStreamEngine, StreamStats
    from repro_torch.core.message_passing import DataflowConfig
    cfg, params = init_params(name, "cuda")
    per_graph = HOST_LAUNCHES[(name, impl)]
    tag = (f"{label}, max_batch {max_batch}, "
           + ("eager flush" if eager_flush
              else f"max_wait {PACKED_WAIT_MS:g} ms, no eager flush"))
    engine = GraphStreamEngine(cfg, params, DataflowConfig(impl=impl),
                               device="cuda", max_batch=max_batch,
                               max_wait_ms=PACKED_WAIT_MS,
                               eager_flush=eager_flush)

    def run():
        warmed = engine.warmup_all()
        stream(engine, graphs, record=False)
        engine.stats = StreamStats()
        done = completed(engine)
        preds, wall = stream(engine, graphs)
        summary = engine.stats.summary()
        summary["enqueue_us_per_batch"] = statistics.median(
            (d.t_dispatch - d.t_build_start) * 1e6 for d in done)
        summary["span_us_per_batch"] = statistics.median(
            d.device_s * 1e6 for d in done)
        on_device, pwall, batches = profiled_pass(
            tag, engine, per_graph, lambda: stream(engine, graphs))
        return warmed, preds, wall, summary, on_device, pwall, batches
    (warmed, preds, wall, summary, on_device, pwall,
     batches), counts = counted(run)
    programs = len(engine.compiled)
    check_launches("packed", tag, counts,
                   {k: 2 * v * programs for k, v in per_graph.items()},
                   f"{per_graph} per forward x {programs} programs x 2: "
                   f"each program's warm-up run and its capture "
                   f"({len(warmed)} from warmup_all); a replay runs no "
                   f"wrapper")
    got = events_by_symbol(on_device)
    worst = max(rel_diff(p, r) for p, r in zip(preds, ref))
    log("packed", f"{tag}: {len(graphs)} answers vs the same graphs served "
        f"through process: worst {worst:.3e} relative to max(1, |ref|) "
        f"(tol {EAGER_RTOL:g})")
    if worst > EAGER_RTOL or not all(np.isfinite(p).all() for p in preds):
        raise AssertionError(f"{tag}: packed answers disagree with process")
    if not eager_flush and summary["mean_batch_size"] <= 1:
        raise AssertionError(f"{tag}: no batch held more than one graph")
    busy_us = sum(t for t, _ in on_device.values())
    row = {k: summary[k] for k in ("p50_ms", "p99_ms", "mean_batch_size",
                                   "throughput_gps", "aggregate_gps",
                                   "device_mean_ms", "queue_wait_mean_ms",
                                   "enqueue_us_per_batch",
                                   "span_us_per_batch")}
    row.update({"max_batch": max_batch, "eager_flush": eager_flush,
                "wall_s": wall, "graphs": len(graphs),
                "busy_us_per_graph": busy_us / len(graphs),
                "busy_share": busy_us / (pwall * 1e6),
                "profiled_batches": batches, "programs": programs,
                "launches": {k: got[SYMBOL_OF[k]] if k in per_graph else 0
                             for k in counts},
                "wrapper_launches": counts, "worst_rel_vs_process": worst,
                "buckets": sorted({str(k) for k, _ in engine.compiled})})
    log("packed", f"{tag}: p50 {row['p50_ms']:.3f} ms, p99 "
        f"{row['p99_ms']:.3f} ms, mean batch {row['mean_batch_size']:.2f} "
        f"graphs, {row['throughput_gps']:.1f} graphs/s of forward span "
        f"(CUDA events around each replay), aggregate "
        f"{row['aggregate_gps']:.1f} graphs/s (wall, first dispatch to "
        f"last completion), queue wait mean {row['queue_wait_mean_ms']:.3f} "
        f"ms; a batch's enqueue on the dispatch thread (pad, upload, "
        f"replay, copy-out) {row['enqueue_us_per_batch']:.1f} us against "
        f"its replay's span {row['span_us_per_batch']:.1f} us (medians); "
        f"under the profiler device busy {row['busy_us_per_graph']:.1f} "
        f"us/graph, {row['busy_share']:.1%} of the wall; {programs} "
        f"programs; on {card}")
    engine.close()
    return row


def packed_deterministic(card: str, label: str, name: str, impl: str,
                         graphs) -> dict:
    """The max_batch 8 run (no eager flush) under torch's deterministic
    algorithms: each graph's packed answer bitwise the same graph served
    alone in its packed bucket, through the same engine's program."""
    from repro_torch.core.engine import GraphStreamEngine
    from repro_torch.core.message_passing import DataflowConfig
    cfg, params = init_params(name, "cuda")
    with deterministic():
        engine = GraphStreamEngine(cfg, params, DataflowConfig(impl=impl),
                                   device="cuda", max_batch=8,
                                   max_wait_ms=PACKED_WAIT_MS,
                                   eager_flush=False)
        done = completed(engine)
        preds, _ = stream(engine, graphs)
        seen = buckets_by_request(done)
        buckets = [seen[i] for i in sorted(seen)]
        same = 0
        for g, p, bucket in zip(graphs, preds, buckets):
            prog, pb = program_of(engine, g, bucket)
            same += bool(np.array_equal(
                p, prog.wait(prog.enqueue(pb, prog.params))[0][0]))
        engine.close()
    log("packed", f"{label}, max_batch 8 under deterministic algorithms: "
        f"{same}/{len(graphs)} answers bitwise equal to the graph served "
        f"alone in its packed bucket ({len(set(buckets))} buckets); on "
        f"{card}")
    if same != len(graphs):
        raise AssertionError(f"{label}: packed answers are not bitwise the "
                             f"graphs served alone")
    return {"bitwise_alone": same, "graphs": len(graphs),
            "buckets": len(set(buckets))}


def packed_largest(card: str) -> dict:
    """GIN ``fused_layer`` at the paper's largest batch: 1,024
    ``molhiv_like(seed=0)`` graphs in one batch (``max_batch`` 1,024),
    counts from 0: its bucket, the batch's replay span, the first 16
    answers within ``EAGER_RTOL`` of those graphs served through
    ``process``, the kernel events of a pass under the profiler
    (``profiled_pass``), and ``layer_fused`` on GIN's first layer at that
    bucket against its plain version and its bound."""
    import torch
    from repro_torch.core.engine import GraphStreamEngine, StreamStats
    from repro_torch.core.message_passing import DataflowConfig
    from repro_torch.core.packing import PackedBatch, PackItem
    from repro_torch.data.graphs import molhiv_like
    from repro_torch.kernels.layer_fused import layer_fused, layer_fused_ref
    cfg, params = init_params("gin", "cuda")
    graphs = list(molhiv_like(seed=0, n_graphs=PACKED_LARGEST))
    label = f"GIN fused_layer, max_batch {PACKED_LARGEST}"
    engine = GraphStreamEngine(cfg, params, DataflowConfig(
        impl="fused_layer"), device="cuda")
    ref = [engine.process(*graph_args(g)) for g in graphs[:16]]
    engine.close()
    engine = GraphStreamEngine(cfg, params, DataflowConfig(
        impl="fused_layer"), device="cuda", max_batch=PACKED_LARGEST,
        max_wait_ms=600_000.0, eager_flush=False)

    def run():
        stream(engine, graphs, record=False)       # builds the bucket
        engine.stats = StreamStats()
        done = completed(engine)
        preds, wall = stream(engine, graphs)
        seen = buckets_by_request(done)
        summary = engine.stats.summary()
        on_device, _, _ = profiled_pass(label, engine, {"layer_fused": 5},
                                        lambda: stream(engine, graphs))
        return preds, wall, seen, summary, on_device
    (preds, wall, seen, summary, on_device), counts = counted(run)
    programs = len(engine.compiled)
    check_launches("packed", label, counts, {"layer_fused": 10 * programs},
                   "5 per forward x 2 (warm-up run, capture) per program")
    (bucket,) = set(seen.values())
    worst = max(rel_diff(p, r) for p, r in zip(preds, ref))
    if worst > EAGER_RTOL:
        raise AssertionError(f"{label}: answers disagree with process")
    engine.close()
    pb = PackedBatch(items=[PackItem(*graph_args(g)) for g in graphs],
                     node_pad=bucket[0], edge_pad=bucket[1],
                     graph_pad=bucket[2])
    kw = main_path_inputs("gin", "fused_layer", "layer_fused",
                          pb.build(pos_dim=cfg.pos_dim, device="cuda"))[0]
    out, plain = call(layer_fused, kw), call(layer_fused_ref, kw)
    torch.cuda.synchronize()
    err, rel, ok = close(out, plain)
    if not ok:
        raise AssertionError(f"{label}: layer_fused disagrees with its "
                             f"plain version at {bucket}")
    kw_np = to_numpy(kw)
    lf = timed_row(card, "packed", f"layer_fused GIN L0 at {bucket}",
                   lambda: call(layer_fused, kw),
                   lambda: call(layer_fused_ref, kw),
                   lf_bound(dict(kw_np, edge_mask=owned_edges(kw_np))),
                   err=err, rel=rel, reps=11, inner=10)
    log("packed", f"{label}: one batch of {summary['count']:.0f} graphs in "
        f"bucket {bucket} ({sum(g.node_feat.shape[0] for g in graphs)} "
        f"nodes, {sum(g.senders.shape[0] for g in graphs)} edges); its "
        f"replay's span {summary['device_mean_ms'] * 1e3:.1f} us "
        f"({summary['device_mean_ms'] * 1e3 / summary['count']:.3f} us a "
        f"graph); p50 {summary['p50_ms']:.3f} ms; first 16 answers vs "
        f"process worst {worst:.3e} (tol {EAGER_RTOL:g}); layer_fused "
        f"there {lf['ms'] * 1e3:.2f} us (max_abs_err {err:.3e}); on {card}")
    return {"bucket": list(bucket), "summary": summary, "wall_s": wall,
            "worst_rel_vs_process": worst, "layer_fused": lf,
            "launches": {k: events_by_symbol(on_device)[SYMBOL_OF[k]]
                         if k == "layer_fused" else 0 for k in counts},
            "wrapper_launches": counts}


def two_tenants(card: str) -> dict:
    """The reference example's two tenants
    (``examples/gnn_streaming.py::stream_two_tenants``) on GIN
    ``fused_layer``, 64 ``molhiv_like(seed=0)`` graphs: a bulk queue
    (weight 1, 20 ms, max_batch 16) given each graph three times, then a
    latency queue (weight 16, 1 ms, max_batch 2) given the first 16, after
    ``warmup_all`` and one unrecorded pass, then a pass under the profiler
    (``profiled_pass``); counts from 0. Per-queue p50 / p90 (profiler off);
    whether the latency queue's p90 is below the bulk queue's is a reading,
    not a check."""
    from repro_torch.core.engine import GraphStreamEngine, StreamStats
    from repro_torch.core.message_passing import DataflowConfig
    from repro_torch.core.scheduler import QueueConfig
    from repro_torch.data.graphs import molhiv_like
    cfg, params = init_params("gin", "cuda")
    graphs = list(molhiv_like(seed=0, n_graphs=64))
    queues = [QueueConfig("bulk", weight=1.0, max_wait_ms=20.0,
                          max_batch=16),
              QueueConfig("latency", weight=16.0, max_wait_ms=1.0,
                          max_batch=2)]
    engine = GraphStreamEngine(cfg, params, DataflowConfig(
        impl="fused_layer"), device="cuda", queues=queues, eager_flush=False)

    def tenants():
        bulk = [engine.submit(*graph_args(g), queue="bulk")
                for g in graphs for _ in range(3)]
        lat = [engine.submit(*graph_args(g), queue="latency")
               for g in graphs[:16]]
        engine.drain(timeout=600)
        return [f.result(timeout=60) for f in bulk + lat]

    def run():
        engine.warmup_all()
        tenants()
        engine.stats = StreamStats()
        preds = tenants()
        summary = engine.stats.summary()
        on_device, _, _ = profiled_pass("two tenants", engine,
                                        {"layer_fused": 5}, tenants)
        return preds, summary, on_device
    (preds, s, on_device), counts = counted(run)
    programs = len(engine.compiled)
    check_launches("packed", "two tenants", counts,
                   {"layer_fused": 10 * programs},
                   "5 per forward x 2 (warm-up run, capture) per program")
    if not all(np.isfinite(p).all() for p in preds):
        raise AssertionError("two tenants: non-finite answers")
    engine.close()
    out = {q: {k: s["queues"][q][k] for k in ("count", "p50_ms", "p90_ms",
                                              "mean_batch_size")}
           for q in ("bulk", "latency")}
    below = out["latency"]["p90_ms"] < out["bulk"]["p90_ms"]
    for q, row in out.items():
        log("packed", f"two tenants, GIN fused_layer: queue {q:8s} "
            f"{row['count']:.0f} graphs, p50 {row['p50_ms']:.3f} ms, p90 "
            f"{row['p90_ms']:.3f} ms, mean batch "
            f"{row['mean_batch_size']:.2f}; on {card}")
    log("packed", f"two tenants: the latency queue's p90 is "
        f"{'below' if below else 'NOT below'} the bulk queue's (a reading)")
    out.update({"latency_p90_below_bulk": below, "programs": programs,
                "launches": {k: events_by_symbol(on_device)[SYMBOL_OF[k]]
                             if k == "layer_fused" else 0 for k in counts},
                "wrapper_launches": counts})
    return out


def packed_phase(card: str, graphs) -> dict:
    """Phase 4c: each of ``HOST_PATHS`` serves phase 4's 72 graphs through
    ``submit`` / ``drain`` at each of ``PACKED_RUNS`` (``packed_run``) and
    under deterministic algorithms (``packed_deterministic``); then GIN at
    max_batch 1,024 (``packed_largest``) and the two tenants
    (``two_tenants``). Each run's answers against the same graphs served
    through ``process``. {path name: its row}, each with ``launches``."""
    from repro_torch.core.engine import GraphStreamEngine
    from repro_torch.core.message_passing import DataflowConfig
    out = {}
    for name, impl in HOST_PATHS:
        label = f"{name.upper()} {impl}"
        cfg, params = init_params(name, "cuda")
        engine = GraphStreamEngine(cfg, params, DataflowConfig(impl=impl),
                                   device="cuda")
        ref = [engine.process(*graph_args(g)) for g in graphs]
        engine.close()
        for max_batch, eager_flush in PACKED_RUNS:
            key = (f"packed{max_batch}{'_eager' if eager_flush else ''}_"
                   f"{name}_{impl}")
            out[key] = packed_run(card, label, name, impl, graphs, ref,
                                  max_batch=max_batch,
                                  eager_flush=eager_flush)
        out[f"packed8_{name}_{impl}"]["deterministic"] = (
            packed_deterministic(card, label, name, impl, graphs))
    out[f"packed{PACKED_LARGEST}_gin_fused_layer"] = packed_largest(card)
    out["packed_two_tenants_gin_fused_layer"] = two_tenants(card)
    return out


# ---------------------------------------------------------------------------
# phase 4d: failure semantics and defense in depth on the captured programs
# ---------------------------------------------------------------------------

# every breaker trip of every engine since ``record_trips``: (engine id,
# bucket, reason). Phases 4-4c must add none (a kernel that fails to build
# or launch would otherwise be served quietly on a lower rung); phase 4d
# only the ones it plants.
TRIPS: list = []
FAULT_WAIT_MS = 10_000.0     # batches flush when full or at the drain
FAULT_COOLDOWN_S = 0.5       # (c): the breaker's cooldown before a probe
FAULT_TIMEOUT_S = 0.5        # (e): the watchdog's in-flight timeout
FAULT_STALL_S = 1.5          # (e): the injected stall, past the timeout
CHECKPOINTS = REPO / "build" / "repro_torch" / "checkpoints"


def record_trips() -> None:
    """Keep every breaker trip of every ``GraphStreamEngine`` in
    ``TRIPS`` from now on."""
    from repro_torch.core.engine import GraphStreamEngine
    real = GraphStreamEngine._record_trip_locked

    def recorded(self, key, reason, now):
        TRIPS.append((id(self), key, reason))
        return real(self, key, reason, now)
    GraphStreamEngine._record_trip_locked = recorded


def check_trips(where: str, planted: list) -> None:
    """Raise unless the trips recorded since the last check are exactly
    ``planted`` (reasons, in order), and none is a build failure."""
    seen = [reason for _, _, reason in TRIPS]
    TRIPS.clear()
    log("faults", f"{where}: breaker trips {seen} (planted {planted})")
    if any(r.startswith("build_failure") for r in seen):
        raise AssertionError(f"{where}: a program failed to build and the "
                             f"breaker served a lower rung: {seen}")
    if seen != planted:
        raise AssertionError(f"{where}: breaker trips {seen}, planted "
                             f"{planted}")


@contextmanager
def captures(keep: bool = True):
    """Every ``CapturedProgram`` built while the block runs, in order (with
    ``keep=False`` a None for each: their count, keeping none alive)."""
    from repro_torch.core import engine as tengine
    real = tengine.CapturedProgram.__init__
    built = []

    def counting(self, *args, **kw):
        real(self, *args, **kw)
        built.append(self if keep else None)
    tengine.CapturedProgram.__init__ = counting
    try:
        yield built
    finally:
        tengine.CapturedProgram.__init__ = real


def fault_engine(params, **kw):
    """GIN ``fused_layer`` at the paper config through ``submit`` / ``drain``
    at max_batch 8, batches sealed when full or at the drain (no eager
    flush): the same stream packs the same way every run."""
    from repro_torch.core.engine import GraphStreamEngine
    from repro_torch.core.message_passing import DataflowConfig
    from repro_torch.core.models import PAPER_GNN_CONFIGS
    kw.setdefault("device", "cuda")
    return GraphStreamEngine(PAPER_GNN_CONFIGS["gin"], params,
                             DataflowConfig(impl="fused_layer"), max_batch=8,
                             max_wait_ms=FAULT_WAIT_MS, eager_flush=False,
                             **kw)


def submit_all(engine, graphs) -> list:
    """Submit ``graphs``, drain; the futures, every one resolved."""
    futs = [engine.submit(*graph_args(g)) for g in graphs]
    engine.drain(timeout=600)
    if not all(f.done() for f in futs):
        raise AssertionError("a future was left unresolved")
    return futs


def answers(engine, graphs) -> list:
    return [f.result(timeout=60) for f in submit_all(engine, graphs)]


def breaker(engine) -> dict:
    return {k: v["breaker"] for k, v in engine.autotune_report().items()
            if "breaker" in v}


def only_program(engine, bucket):
    (prog,) = [p for (b, _), p in engine.compiled.items() if b == bucket]
    return prog


def nodes_by_symbol(prog, tag: str) -> dict:
    GRAPH_DUMPS.mkdir(parents=True, exist_ok=True)
    nodes = kernel_nodes(prog, GRAPH_DUMPS / f"faults_{tag}.dot")
    return {sym: sum(sym in n for n in nodes) for sym in KERNEL_SYMBOLS}


def alone_in(engine, g, bucket, params, dataflow=None):
    """``g`` alone in ``bucket`` through the eager forward under
    ``params`` (and ``dataflow``, else the engine's): what a captured
    replay of that bucket must answer."""
    import torch
    from repro_torch.core.graph import build_graph_batch
    batch = build_graph_batch(
        g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
        node_pos=g.node_pos, node_pad=bucket[0], edge_pad=bucket[1],
        graph_pad=bucket[2], pos_dim=engine.cfg.pos_dim, device="cuda")
    with torch.inference_mode():
        out = engine.model.apply(params, batch, engine.cfg,
                                 dataflow or engine.dataflow)
    return out.cpu().numpy()[0]


def faults_poison(card: str, params, gs) -> dict:
    """(a) Request 3 poisoned in a packed batch: exactly one
    ``PoisonGraph``, every other answer bitwise the fault-free run's under
    deterministic algorithms and within ``EAGER_RTOL`` as served, and no
    program built beyond the fault-free run's."""
    from repro_torch.core.errors import PoisonGraph
    from repro_torch.core.faults import FaultInjector
    runs = {}
    for tag, det, poison in (("fault-free", True, False),
                             ("poisoned", True, True),
                             ("poisoned as served", False, True)):
        with (deterministic() if det else nullcontext()), \
                captures() as built:
            inj = FaultInjector(seed=0)
            if poison:
                inj.poison_request(3)
            eng = fault_engine(params, fault_injector=inj)
            done = completed(eng)
            futs = submit_all(eng, gs)
            s = eng.stats.summary()
            eng.close()
        runs[tag] = {"futs": futs, "captures": len(built), "summary": s,
                     "replays": sum(d.err is None for d in done),
                     "failed_dispatches": sum(d.err is not None
                                              for d in done),
                     "injected": inj.summary()["dispatch_error"]}
    ref = [f.result() for f in runs["fault-free"]["futs"]]
    out = {}
    for tag in ("poisoned", "poisoned as served"):
        r = runs[tag]
        failed = [i for i, f in enumerate(r["futs"])
                  if f.exception() is not None]
        if failed != [3] or not isinstance(r["futs"][3].exception(),
                                           PoisonGraph):
            raise AssertionError(f"(a) {tag}: failed futures {failed}, "
                                 f"expected one PoisonGraph at 3")
        got = [f.result() for i, f in enumerate(r["futs"]) if i != 3]
        want = [a for i, a in enumerate(ref) if i != 3]
        bitwise = sum(bool(np.array_equal(a, b)) for a, b in zip(got, want))
        worst = max(rel_diff(a, b) for a, b in zip(got, want))
        log("faults", f"(a) {tag}: one PoisonGraph (request 3); the "
            f"{len(got)} others bitwise the fault-free run on {bitwise}, "
            f"worst {worst:.3e} (tol {EAGER_RTOL:g}); programs captured "
            f"{r['captures']} (fault-free {runs['fault-free']['captures']}); "
            f"replays {r['replays']} against {runs['fault-free']['replays']}"
            f", dispatches failed {r['failed_dispatches']}; retries "
            f"{r['summary']['retries']}, quarantined "
            f"{r['summary']['quarantined_graphs']}; on {card}")
        if tag == "poisoned" and bitwise != len(got):
            raise AssertionError("(a) survivors are not bitwise the "
                                 "fault-free run under deterministic "
                                 "algorithms")
        if worst > EAGER_RTOL:
            raise AssertionError(f"(a) {tag}: survivors disagree with the "
                                 f"fault-free run")
        if r["captures"] != runs["fault-free"]["captures"]:
            raise AssertionError(f"(a) {tag}: retries or bisection built "
                                 f"a program")
        out[tag] = {"bitwise": bitwise, "worst_rel": worst,
                    "captures": r["captures"], "replays": r["replays"],
                    "failed_dispatches": r["failed_dispatches"],
                    "retries": r["summary"]["retries"]}
    out["fault_free"] = {k: runs["fault-free"][k]
                         for k in ("captures", "replays")}
    out["retry_replays"] = (runs["poisoned"]["replays"]
                            - runs["fault-free"]["replays"])
    return out


def faults_nan(card: str, params, gs) -> dict:
    """(b) Request 2 of 8 copies of one molecule (one batch, one bucket)
    NaN-injected: one ``PoisonGraph``, the bucket demoted to ``pipeline``;
    its re-captured program's kernel nodes and the profiler's device events
    of its replay hold ``mp_pipeline`` and no ``layer_fused``; its answers
    within ``SLICE_RTOL`` of rung 0's. Then two more NaN graphs (requests
    26 and 34, in the fourth and fifth batches): the card's ladder ends at
    ``pipeline``, so both trips leave the bucket on the same program."""
    from repro_torch.core.errors import PoisonGraph
    from repro_torch.core.faults import FaultInjector
    batch = [gs[0]] * 8
    inj = FaultInjector(seed=0).nan_request(2).nan_request(26)
    inj.nan_request(34)
    eng = fault_engine(params, breaker_cooldown_s=3600.0,
                       fault_injector=inj)
    futs = submit_all(eng, batch)
    if ([i for i, f in enumerate(futs) if f.exception() is not None] != [2]
            or not isinstance(futs[2].exception(), PoisonGraph)):
        raise AssertionError("(b) the NaN graph was not the one quarantined")
    rung0 = [f.result() for i, f in enumerate(futs) if i != 2]
    health = breaker(eng)
    (bucket_s, h), = health.items()
    if (h["level"], h["last_reason"], h["serving_impl"]) != (
            1, "nan_gate", "pipeline"):
        raise AssertionError(f"(b) the bucket was not demoted: {health}")
    with captures() as built:
        demoted = answers(eng, batch)
    bucket = tuple(map(int, bucket_s.split("x")))
    prog = only_program(eng, bucket)
    if built != [prog]:
        raise AssertionError("(b) the demoted bucket was not re-captured "
                             "once")
    nodes = nodes_by_symbol(prog, "nan_demoted")
    _, on_device = device_kernels(lambda: answers(eng, batch))
    worst = max(rel_diff(a, b) for a, b in zip(demoted[:7], rung0))
    log("faults", f"(b) NaN gate: bucket {bucket} demoted to pipeline "
        f"({h}); re-captured in {prog.build_s * 1e3:.1f} ms; its kernel "
        f"nodes by symbol {nodes}; one replay's device events {on_device}; "
        f"answers vs rung 0 worst {worst:.3e} (tol {SLICE_RTOL:g}); on "
        f"{card}")
    if (nodes["mp_pipeline_kernel"] != 5 or nodes["layer_fused_kernel"]
            or on_device["mp_pipeline_kernel"] != 5
            or on_device["layer_fused_kernel"]):
        raise AssertionError("(b) the demoted bucket does not run "
                             "mp_pipeline alone")
    if worst > SLICE_RTOL:
        raise AssertionError("(b) the demoted bucket's answers disagree "
                             "with rung 0's")
    with captures() as again:
        for _ in range(2):
            futs = submit_all(eng, batch)
            if not isinstance(futs[2].exception(), PoisonGraph):
                raise AssertionError("(b) a later NaN graph was not "
                                     "quarantined")
    (h,) = breaker(eng).values()
    log("faults", f"(b) two more NaN graphs: {h}; programs captured "
        f"{len(again)}; on {card}")
    if ((h["level"], h["serving_impl"]) != (1, "pipeline") or again
            or only_program(eng, bucket) is not prog):
        raise AssertionError("(b) the card's ladder went below pipeline")
    eng.close()
    return {"bucket": list(bucket), "recapture_ms": prog.build_s * 1e3,
            "kernel_nodes": nodes, "device_events": on_device,
            "worst_rel_vs_rung0": worst,
            "floor": {"level": h["level"], "serving": h["serving_impl"]}}


def faults_audit(card: str, params, gs) -> dict:
    """(c) ``break_impl("fused_layer")`` under audits of every batch: a
    bystander bucket and the bucket under attack (8 copies of one
    molecule) served and audited clean, then the attack: the audit demotes
    exactly that bucket; after the cooldown a probe serves the broken rung
    again and is demoted; after ``fix_impl`` a probe confirms and the
    bucket's replays launch ``layer_fused`` again."""
    from repro_torch.core.faults import FaultInjector
    inj = FaultInjector(seed=0)
    eng = fault_engine(params, fault_injector=inj, audit_sample_rate=1.0,
                       breaker_cooldown_s=FAULT_COOLDOWN_S)
    attacked, bystander = [gs[1]] * 8, gs[-4:-2]

    def wave(graphs):
        out = answers(eng, graphs)
        if not eng.flush_audits(timeout=120):
            raise AssertionError("(c) the audits did not finish")
        return out
    wave(bystander)
    ref = wave(attacked)
    if breaker(eng):
        raise AssertionError("(c) a clean audit tripped the breaker")
    ladder = []
    with captures() as built:
        inj.break_impl("fused_layer", eps=0.05)
        wave(attacked)
        ladder.append(("broken", dict(breaker(eng))))
        time.sleep(FAULT_COOLDOWN_S)
        wave(attacked)           # served on pipeline; its completion probes
        wave(attacked)           # the probe, on the broken fused_layer
        ladder.append(("probe of the broken rung", dict(breaker(eng))))
        inj.fix_impl("fused_layer")
        time.sleep(FAULT_COOLDOWN_S)
        wave(attacked)
        healed = wave(attacked)  # the probe, on the healed fused_layer
        ladder.append(("healed", dict(breaker(eng))))
    for tag, health in ladder:
        log("faults", f"(c) {tag}: breaker {health}")
    (bucket_s, first), = ladder[0][1].items()
    if (first["level"], first["last_reason"], first["serving_impl"]) != (
            1, "audit_mismatch", "pipeline"):
        raise AssertionError("(c) the audit did not demote the bucket")
    (_, probe), = ladder[1][1].items()
    if (probe["level"], probe["probes"], probe["trips"]) != (1, 1, 2):
        raise AssertionError("(c) the probe of the broken rung was not "
                             "demoted again")
    (_, last), = ladder[2][1].items()
    if (last["level"], last["probing"], last["serving_impl"]) != (
            0, False, "fused_layer"):
        raise AssertionError("(c) the healed bucket was not promoted")
    bucket = tuple(map(int, bucket_s.split("x")))
    prog = only_program(eng, bucket)
    nodes = nodes_by_symbol(prog, "audit_healed")
    _, on_device = device_kernels(lambda: answers(eng, attacked))
    worst = max(rel_diff(a, b) for a, b in zip(healed, ref))
    audits = eng.stats.audits
    per_s = audits / eng.audit_seconds
    log("faults", f"(c) audits: {audits} on the CPU mirror in "
        f"{eng.audit_seconds:.3f} s ({per_s:.1f} batches/s of 8 graphs), "
        f"{eng.stats.audit_mismatches} mismatches; the bucket re-captured "
        f"{len(built)} times ({', '.join(f'{p.build_s * 1e3:.1f}' for p in built)}"
        f" ms); healed: kernel nodes {nodes}, one replay's device events "
        f"{on_device}; answers vs before the attack worst {worst:.3e} (tol "
        f"{EAGER_RTOL:g}); on {card}")
    if (nodes["layer_fused_kernel"] != 5 or nodes["mp_pipeline_kernel"]
            or on_device["layer_fused_kernel"] != 5
            or on_device["mp_pipeline_kernel"]):
        raise AssertionError("(c) the healed bucket does not run "
                             "layer_fused alone")
    if worst > EAGER_RTOL:
        raise AssertionError("(c) the healed bucket's answers disagree")
    eng.close()
    return {"bucket": list(bucket), "audits": audits,
            "audit_s": eng.audit_seconds, "audits_per_s": per_s,
            "audit_mismatches": eng.stats.audit_mismatches,
            "recaptures": len(built),
            "recapture_ms": [p.build_s * 1e3 for p in built],
            "ladder": ladder,
            "healed_kernel_nodes": nodes, "healed_device_events": on_device}


def faults_reload(card: str, params, gs) -> dict:
    """(d) ``update_params`` to weights from seed 1 while traffic is in
    flight (under deterministic algorithms): every answer within
    ``EAGER_RTOL`` of the eager forward of its graph alone in its bucket
    under the version its batch ran (what catches stale captured weights),
    no bucket captured again, the copy into the captured weights timed;
    then a canary with a NaN leaf raises ``ParamUpdateFailed`` and the
    answers stay bitwise."""
    import torch
    from repro_torch.core.errors import ParamUpdateFailed
    from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn
    cfg = PAPER_GNN_CONFIGS["gin"]
    params1 = make_gnn(cfg).init(torch.Generator().manual_seed(1), cfg,
                                 device="cuda")
    out = {}
    with deterministic():
        eng = fault_engine(params)
        answers(eng, gs)
        before = {k: id(p) for k, p in eng.compiled.items()}
        canary_s = []
        real = eng._run_canary

        def timed(*a):
            t0 = time.perf_counter()
            try:
                return real(*a)
            finally:
                canary_s.append(time.perf_counter() - t0)
        eng._run_canary = timed
        done = completed(eng)
        with captures() as built:
            futs = [eng.submit(*graph_args(g)) for g in gs[:10]]
            t0 = time.perf_counter()
            version = eng.update_params(params1)
            update_s = time.perf_counter() - t0
            futs += [eng.submit(*graph_args(g)) for g in gs]
            eng.drain(timeout=600)
        served = {it.payload.req_id: (d.batch.bucket, d.params_version)
                  for d in done for it in d.batch.items}
        first = min(served)
        graphs = gs[:10] + gs
        worst, bitwise, versions = 0.0, 0, {0: 0, 1: 0}
        for i, (g, f) in enumerate(zip(graphs, futs)):
            bucket, v = served[first + i]
            want = alone_in(eng, g, bucket, params if v == 0 else params1)
            got = f.result()
            worst = max(worst, rel_diff(got, want))
            bitwise += bool(np.array_equal(got, want))
            versions[v] += 1
        swapped = [ex for ex in eng._executors if ex.swaps]
        swap_ms = [ex.swap_ms() for ex in swapped]
        new = list(built)
        for p in new:
            key = next(k for k, q in eng.compiled.items() if q is p)
            if key in before:
                raise AssertionError(f"(d) bucket {key} was captured again")
        if any(id(eng.compiled[k]) != v for k, v in before.items()
               if k in eng.compiled):
            raise AssertionError("(d) a program was rebuilt")
        log("faults", f"(d) update_params to version {version} in "
            f"{update_s * 1e3:.2f} ms (canary {canary_s[0] * 1e3:.2f} ms) "
            f"under live traffic: {len(futs)} answers ({versions[0]} on "
            f"version 0, {versions[1]} on version 1) vs the eager forward "
            f"alone in their bucket under their version: worst "
            f"{worst:.3e} (tol {EAGER_RTOL:g}), {bitwise} bitwise; the "
            f"executor copied the new weights once into the tree its "
            f"{len(before)} programs built before the swap read "
            f"({', '.join(f'{m * 1e3:.2f}' for m in swap_ms)} us on the "
            f"card), {len(new)} captured for new buckets; on {card}")
        if worst > EAGER_RTOL or not versions[1] or not swapped:
            raise AssertionError("(d) answers after the swap are not the "
                                 "new weights'")
        steady = answers(eng, gs)
        nan = {k: v for k, v in params1.items()}
        nan["node_enc"] = dict(params1["node_enc"])
        nan["node_enc"]["w"] = params1["node_enc"]["w"].clone()
        nan["node_enc"]["w"][0, 0] = float("nan")
        try:
            eng.update_params(nan)
        except ParamUpdateFailed as exc:
            refused = str(exc)
        else:
            raise AssertionError("(d) a canary with a NaN leaf passed")
        again = answers(eng, gs)
        same = sum(bool(np.array_equal(a, b)) for a, b in zip(steady, again))
        log("faults", f"(d) NaN leaf: ParamUpdateFailed ({refused}); "
            f"answers after it bitwise those before on {same}/{len(gs)}")
        if same != len(gs):
            raise AssertionError("(d) a refused update changed the answers")
        out.update({"update_ms": update_s * 1e3,
                    "canary_ms": canary_s[0] * 1e3,
                    "swap_us": [m * 1e3 for m in swap_ms],
                    "answers": len(futs), "on_version": versions,
                    "worst_rel": worst, "bitwise": bitwise,
                    "new_captures": len(new),
                    "rollbacks": eng.stats.param_rollbacks})
        eng.close()
    return out


def faults_death(card: str, params, graphs, gs) -> dict:
    """(e) Two executors on the one card (``devices=["cuda:0"] * 2``, each
    its own stream, graph pool and parameter replica). Executor 0 killed on
    its third dispatch: its work re-placed on the survivor, every future
    resolved once, the slot respawned; answers within ``EAGER_RTOL`` of a
    fault-free pool's. Then a stall past ``inflight_timeout_s``:
    ``DeadlineExceeded`` for its batch, its executor marked dead and
    respawned, its programs and pool still referenced."""
    from repro_torch.core.errors import DeadlineExceeded
    from repro_torch.core.faults import FaultInjector
    from repro_torch.core.graph import pad_bucket
    pool = ["cuda:0", "cuda:0"]
    clean = fault_engine(params, device=None, devices=pool)
    ref = answers(clean, graphs)
    reps = {id(ex.params["node_enc"]["w"]) for ex in clean._executors}
    clean.close()
    inj = FaultInjector(seed=0).kill_executor(0, after_batches=2)
    eng = fault_engine(params, device=None, devices=pool,
                       respawn_executors=True, fault_injector=inj)
    resolved = {}
    with captures() as built:
        futs = [eng.submit(*graph_args(g)) for g in graphs]
        for i, f in enumerate(futs):
            f.add_done_callback(lambda f, i=i: resolved.__setitem__(
                i, resolved.get(i, 0) + 1))
        eng.drain(timeout=600)
    s = eng.stats.summary()
    got = [f.result(timeout=60) for f in futs]
    worst = max(rel_diff(a, b) for a, b in zip(got, ref))
    log("faults", f"(e) kill_executor(0, after_batches=2) on two executors "
        f"of one card ({len(reps)} parameter replicas): {len(futs)} futures "
        f"resolved {sorted(set(resolved.values()))} time(s) each; deaths "
        f"{s['executor_deaths']}, respawns {s['respawns']}, retries "
        f"{s['retries']}, pool degraded {s['pool_degraded']}; "
        f"{len(built)} programs captured; answers vs a fault-free pool worst "
        f"{worst:.3e} (tol {EAGER_RTOL:g}); on {card}")
    if len(reps) != 2 or resolved != {i: 1 for i in range(len(futs))}:
        raise AssertionError("(e) a future did not resolve exactly once, "
                             "or the executors share a parameter replica")
    if (inj.summary()["crash"] != 1 or s["executor_deaths"] != 1
            or s["respawns"] != 1 or worst > EAGER_RTOL):
        raise AssertionError("(e) the killed executor's work was not "
                             "re-placed and its slot respawned")
    eng.close()
    kill = {"futures": len(futs), "deaths": s["executor_deaths"],
            "respawns": s["respawns"], "retries": s["retries"],
            "captures": len(built), "worst_rel": worst,
            "replicas": len(reps)}

    # the watchdog: warm the bucket of 8 copies of one molecule on both
    # executors first (the in-flight clock counts a capture)
    batch = [gs[2]] * 8
    n, e = batch[0].node_feat.shape[0], batch[0].senders.shape[0]
    inj = FaultInjector(seed=0, stall_s=FAULT_STALL_S)
    eng = fault_engine(params, device=None, devices=pool,
                       respawn_executors=True, fault_injector=inj,
                       inflight_timeout_s=FAULT_TIMEOUT_S)
    eng.warmup_all(pairs=[(pad_bucket(8 * n, eng.buckets),
                           pad_bucket(8 * e, eng.buckets))])
    inj.stall_request(eng._req_seq + 3)
    t0 = time.perf_counter()
    stamps = []
    futs = [eng.submit(*graph_args(g)) for g in batch]
    for f in futs:
        f.add_done_callback(lambda f: stamps.append(time.perf_counter()))
    eng.drain(timeout=600)
    reclaim_s = max(stamps) - t0
    if not all(isinstance(f.exception(), DeadlineExceeded) for f in futs):
        raise AssertionError("(e) the stalled batch did not fail with "
                             "DeadlineExceeded")
    deadline = time.perf_counter() + 60
    while not eng.stats.respawns and time.perf_counter() < deadline:
        time.sleep(0.01)         # the respawn follows the reclaim
    dead = eng._dead_executors
    kept = (len(dead) == 1 and dead[0].dead and bool(dead[0].compiled)
            and (dead[0].pool is not None or dead[0].device.type == "cpu"))
    s = eng.stats.summary()
    time.sleep(FAULT_STALL_S)         # the stalled completion, then dropped
    after = answers(eng, batch)
    log("faults", f"(e) stall of {FAULT_STALL_S} s past an in-flight "
        f"timeout of {FAULT_TIMEOUT_S} s: 8 futures DeadlineExceeded "
        f"{reclaim_s * 1e3:.1f} ms after submit; deaths "
        f"{s['executor_deaths']}, respawns {s['respawns']}; the dead "
        f"executor's {len(dead[0].compiled) if dead else 0} programs and "
        f"pool still referenced: {kept}; the same batch served again after "
        f"the stall, finite: {all(np.isfinite(a).all() for a in after)}")
    if (not kept or s["executor_deaths"] != 1 or s["respawns"] != 1
            or not all(np.isfinite(a).all() for a in after)):
        raise AssertionError("(e) the watchdog did not reclaim the wedged "
                             "executor")
    eng.close()
    return {"kill": kill, "watchdog": {
        "timeout_s": FAULT_TIMEOUT_S, "stall_s": FAULT_STALL_S,
        "reclaim_ms": reclaim_s * 1e3, "deaths": s["executor_deaths"],
        "respawns": s["respawns"]}}


def faults_checkpoint(card: str, params, gs) -> dict:
    """(f) The engine's params ``save``d and ``restore``d onto the card
    serve bitwise the same answers (deterministic algorithms)."""
    import shutil
    from repro_torch.checkpoint import checkpoint as ckpt
    shutil.rmtree(CHECKPOINTS, ignore_errors=True)
    with deterministic():
        eng = fault_engine(params)
        want = answers(eng, gs)
        t0 = time.perf_counter()
        path = ckpt.save(CHECKPOINTS, 1, eng.params, extra={"model": "gin"})
        save_s = time.perf_counter() - t0
        eng.close()
        t0 = time.perf_counter()
        restored, extra = ckpt.restore(CHECKPOINTS, 1, params)
        restore_s = time.perf_counter() - t0
        eng = fault_engine(restored)
        got = answers(eng, gs)
        eng.close()
    same = sum(bool(np.array_equal(a, b)) for a, b in zip(got, want))
    files = len(list(path.glob("leaf_*.npy")))
    log("faults", f"(f) checkpoint: {files} leaves saved in "
        f"{save_s * 1e3:.1f} ms, restored onto the card in "
        f"{restore_s * 1e3:.1f} ms (extra {extra}); answers bitwise on "
        f"{same}/{len(gs)}")
    shutil.rmtree(CHECKPOINTS, ignore_errors=True)
    if same != len(gs):
        raise AssertionError("(f) restored params serve other answers")
    return {"leaves": files, "save_ms": save_s * 1e3,
            "restore_ms": restore_s * 1e3, "bitwise": same}


def faults_phase(card: str, graphs) -> dict:
    """Phase 4d: failure semantics and defense in depth on GIN
    ``fused_layer``'s captured programs at the paper config, through
    ``submit`` / ``drain`` at max_batch 8, on phase 4's molhiv and hep
    graphs (16 molecules and 4 kNN graphs), counts from 0: (a) poison, (b)
    the NaN gate and demotion, (c) audits, (d) hot reload under live
    traffic, (e) an executor's death and the watchdog on two executors of
    the card, (f) a checkpoint round trip. The breaker must trip exactly
    where a sub-phase plants it. The wrappers count two forwards for each
    program captured (its warm-up run and the capture) and one for each
    canary."""
    from repro_torch.core.engine import GraphStreamEngine
    gs = graphs[:16] + graphs[64:68]
    _, params = init_params("gin", "cuda")
    out = {}
    t0 = time.perf_counter()
    canaries = []
    real = GraphStreamEngine._run_canary

    def counted_canary(self, host, alive, replicas):
        err = real(self, host, alive, replicas)
        if err is None:              # every replica ran its forward
            canaries.append(len(replicas))
        return err
    GraphStreamEngine._run_canary = counted_canary

    def run():
        with captures() as built:
            out["a_poison"] = faults_poison(card, params, gs)
            check_trips("(a)", [])
            out["b_nan_gate"] = faults_nan(card, params, gs)
            check_trips("(b)", ["nan_gate"] * 3)
            out["c_audits"] = faults_audit(card, params, gs)
            check_trips("(c)", ["audit_mismatch", "audit_mismatch"])
            out["d_reload"] = faults_reload(card, params, gs)
            check_trips("(d)", [])
            out["e_death"] = faults_death(card, params, graphs, gs)
            check_trips("(e)", [])
            out["f_checkpoint"] = faults_checkpoint(card, params, gs)
            check_trips("(f)", [])
        return len(built)
    try:
        captured, counts = counted(run)
    finally:
        GraphStreamEngine._run_canary = real
    # every forward of the phase: two a capture, one a replica of a canary
    # that passed (a NaN leaf is refused before any forward), the eager
    # forwards of (d)'s checks; each is 5 launches of layer_fused or of
    # mp_pipeline
    eager = out["d_reload"]["answers"]
    forwards = 2 * captured + sum(canaries) + eager
    total = counts["layer_fused"] + counts["mp_pipeline"]
    log("faults", f"wrapper launches {counts} over {captured} captures, "
        f"{sum(canaries)} canary forwards and {eager} eager forwards "
        f"(5 launches each: {5 * forwards})")
    if (total != 5 * forwards or not counts["layer_fused"]
            or not counts["mp_pipeline"]
            or any(v for k, v in counts.items()
                   if k not in ("layer_fused", "mp_pipeline"))):
        raise AssertionError("phase 4d did not run the expected launches")
    out.update({"captures": captured, "launches": counts,
                "seconds": time.perf_counter() - t0})
    log("faults", f"phase 4d took {out['seconds']:.1f} s; on {card}")
    return out


# ---------------------------------------------------------------------------
# phase 4e: per-bucket autotune, drift retune and LRU eviction
# ---------------------------------------------------------------------------

#: (model, configured impl) of the tuned engines: the configured impl is
#: the first candidate, then pipeline and fused_layer
TUNE_PATHS = (("gin", "fused_layer"), ("gat", "fused_layer"),
              ("pna", "fused_layer"), ("pna", "kernel"), ("dgn", "kernel"))
TUNE_CACHE = REPO / "build" / "repro_torch" / "autotune.json"
#: (c): the pause between the fill-4 regime and the singles (s)
DRIFT_LULL_S = 0.1
#: (d): n_mean of the four buckets the eviction engine cycles through
EVICT_SIZES = (10, 60, 200, 400)


def bucket_name(bucket) -> str:
    return "x".join(map(str, bucket))


def forward_symbols(name: str, impl: str, layers: int) -> dict:
    """The kernel nodes one forward of ``name`` under ``impl`` holds, by
    symbol (GAT has no layer_fused form: its fused_layer is the
    pipeline's attention sweep)."""
    per = {"pipeline": {"mp_pipeline_kernel": 1},
           "fused_layer": ({"mp_pipeline_kernel": 1} if name == "gat"
                           else {"layer_fused_kernel": 1}),
           "kernel": ({"mp_scatter_kernel": 1, "seg_softmax_kernel": 1}
                      if name == "gat" else {"mp_scatter_kernel": 1})}[impl]
    return {sym: layers * per.get(sym, 0) for sym in KERNEL_SYMBOLS}


def tuned_engine(name: str, impl: str, **kw):
    """``name`` at the paper config under ``impl`` on the card with
    ``autotune``, at max_batch 8 (``process`` pads a graph to 8 slots)."""
    from repro_torch.core.engine import GraphStreamEngine
    from repro_torch.core.message_passing import DataflowConfig
    cfg, params = init_params(name, "cuda")
    return GraphStreamEngine(cfg, params, DataflowConfig(impl=impl),
                             device="cuda", autotune=True, **kw)


def kernels_own_shape(engine, bucket) -> str:
    """The name of ``bucket``'s first candidate: the configured impl with
    each kernel picking its own launch shape (rows per block None)."""
    dev = engine._executors[0].device
    return engine._candidate_name(
        engine._candidate_dataflows(bucket, dev)[0])


def tune_log_line(tag: str, entry: dict, default: str, card: str) -> str:
    spans = ", ".join(f"{k} {v:.2f}" for k, v in
                      sorted(entry["candidates_us"].items(),
                             key=lambda kv: kv[1]))
    d = entry["candidates_us"].get(default)
    return (f"{tag}: replay spans us [{spans}]; winner {entry['winner']} "
            f"{entry['best_us']:.2f} us against the kernels' own launch "
            f"shape ({default}) {d:.2f} us ({entry['best_us'] / d:.3f}x); "
            f"{entry['programs']} captures, tune {entry['tune_ms']:.1f} ms; "
            f"on {card}")


def tune_winners(card: str, gs, built: list) -> dict:
    """(a) Each path tunes each bucket on its first real graph: every
    candidate captured once and timed by its replays' spans, no candidate
    failed, the winner's capture kept as the bucket's program (no capture
    more to serve the bucket's other graphs), its kernel nodes its impl's
    kernel, every answer within ``EAGER_RTOL`` of the eager forward under
    the winning dataflow; then a second engine tunes the same buckets on
    ``warmup_all``'s synthetic batch (two nodes, one edge)."""
    out = {}
    for name, impl in TUNE_PATHS:
        path = f"{name}_{impl}"
        res = out[path] = {"real": {}, "synthetic": {}}
        with tuned_engine(name, impl, autotune_cache=str(TUNE_CACHE)) as eng:
            first = {}
            for g in gs:
                first.setdefault(bucket_of(eng, g), g)
            for bucket, g in first.items():
                n0 = len(built)
                eng.process(*graph_args(g))
                entry = eng.autotune_report()[bucket_name(bucket)]
                prog = only_program(eng, bucket)
                if (entry["source"] != "autotuned" or entry["failed"]
                        or len(built) - n0 != entry["programs"]
                        or len(entry["candidates_us"]) != entry["programs"]
                        or not any(prog is b for b in built[n0:])
                        or prog.dataflow != eng._tuned[bucket]):
                    raise AssertionError(
                        f"(a) {path} {bucket}: the tune did not time every "
                        f"candidate once and keep the winner's capture: "
                        f"{entry}, {len(built) - n0} captures")
                rest = [x for x in gs if bucket_of(eng, x) == bucket]
                n1 = len(built)
                preds = [eng.process(*graph_args(x)) for x in rest]
                if len(built) != n1:
                    raise AssertionError(f"(a) {path} {bucket}: serving the "
                                         f"tuned bucket captured again")
                worst = max(rel_diff(p, alone_in(eng, x, bucket, eng.params,
                                                 prog.dataflow))
                            for p, x in zip(preds, rest))
                nodes = nodes_by_symbol(
                    prog, f"tune_{path}_{bucket_name(bucket)}")
                want = forward_symbols(name, prog.dataflow.impl,
                                       eng.cfg.num_layers)
                default = kernels_own_shape(eng, bucket)
                log("tune", tune_log_line(f"(a) {path} {bucket} real first "
                                          f"graph", entry, default, card))
                log("tune", f"(a) {path} {bucket}: winner "
                    f"{prog.dataflow.impl} rows {prog.dataflow.rows_per_block}"
                    f"; kernel nodes {nodes} (want {want}); {len(rest)} "
                    f"answers, worst {worst:.3e} against the eager forward "
                    f"under the winner (tol {EAGER_RTOL:g})")
                if nodes != want:
                    raise AssertionError(f"(a) {path} {bucket}: the winner's "
                                         f"graph does not hold its impl's "
                                         f"kernel")
                if worst > EAGER_RTOL:
                    raise AssertionError(f"(a) {path} {bucket}: an answer "
                                         f"disagrees with the eager forward")
                res["real"][bucket_name(bucket)] = {
                    **{k: entry[k] for k in ("candidates_us", "winner",
                                             "best_us", "programs",
                                             "tune_ms")},
                    "default": default,
                    "default_us": entry["candidates_us"][default],
                    "impl": prog.dataflow.impl,
                    "rows_per_block": prog.dataflow.rows_per_block,
                    "answers": len(rest), "worst_rel": worst}
        with tuned_engine(name, impl) as syn:
            n0 = len(built)
            keys = syn.warmup_all(pairs=[b[:2] for b in first])
            report = syn.autotune_report()
            for key in keys:
                entry = report[bucket_name(key)]
                if entry["failed"] or entry["source"] != "autotuned":
                    raise AssertionError(f"(a) {path} {key}: the synthetic "
                                         f"tune failed: {entry}")
                real = res["real"][bucket_name(key)]
                log("tune", tune_log_line(
                    f"(a) {path} {key} synthetic batch", entry,
                    kernels_own_shape(syn, key),
                    card) + f"; the real first graph's winner "
                    f"{real['winner']}")
                res["synthetic"][bucket_name(key)] = {
                    k: entry[k] for k in ("candidates_us", "winner",
                                          "best_us", "programs", "tune_ms")}
            res["synthetic_captures"] = len(built) - n0
    return out


def tune_cached(card: str, gs, built: list) -> dict:
    """(b) Each path again on the cache (a) wrote: nothing is tuned (every
    bucket's source ``cache``), one capture a bucket, the cached winner
    served, answers within ``EAGER_RTOL`` of the eager forward under it."""
    out = {}
    for name, impl in TUNE_PATHS:
        path = f"{name}_{impl}"
        with tuned_engine(name, impl, autotune_cache=str(TUNE_CACHE)) as eng:
            first = {}
            for g in gs:
                first.setdefault(bucket_of(eng, g), g)
            n0 = len(built)
            worst = 0.0
            for bucket, g in first.items():
                pred = eng.process(*graph_args(g))
                prog = only_program(eng, bucket)
                worst = max(worst, rel_diff(pred, alone_in(
                    eng, g, bucket, eng.params, prog.dataflow)))
            report = eng.autotune_report()
            sources = {k: v["source"] for k, v in report.items()}
            timed = [k for k, v in report.items() if "candidates_us" in v]
            captured = len(built) - n0
            log("tune", f"(b) {path} on the cache: sources {sources}, "
                f"captures {captured} for {len(first)} buckets, winners "
                f"{ {k: (v['impl'], v['rows_per_block']) for k, v in report.items()} }, "
                f"worst {worst:.3e}; on {card}")
            if (set(sources.values()) != {"cache"} or timed
                    or captured != len(first) or worst > EAGER_RTOL):
                raise AssertionError(f"(b) {path}: the cached engine tuned "
                                     f"or captured more than one program a "
                                     f"bucket")
            out[path] = {"captures": captured, "buckets": len(first),
                         "worst_rel": worst}
    return out


def tune_drift(card: str, built: list) -> dict:
    """(c) The reference test's drift scenario on the card: GCN
    ``fused_layer`` at the paper config, tuned at fill 4 (four batches of
    four 20-node graphs), then, after a lull of ``DRIFT_LULL_S``, six
    single 80-node graphs in the same bucket: at least one retune fires,
    and the bucket keeps serving."""
    from repro_torch.core.scheduler import QueueConfig
    from repro_torch.data.graphs import sized_stream
    n0 = len(built)
    with tuned_engine("gcn", "fused_layer", max_autotune=2,
                      queues=(QueueConfig("default", max_batch=4,
                                          max_wait_ms=3.0),),
                      eager_flush=False, drift_window=4,
                      drift_cooldown_s=0.05, drift_fill_factor=1.3,
                      max_retunes=2) as eng:
        futs = []
        full = list(sized_stream(seed=0, n_graphs=16, n_mean=20, n_std=0,
                                 e_per_node=2.2))
        for i in range(0, 16, 4):
            futs += [eng.submit(*graph_args(g)) for g in full[i:i + 4]]
            eng.drain(timeout=600)
        singles = list(sized_stream(seed=1, n_graphs=6, n_mean=80, n_std=0,
                                    e_per_node=2.6))
        # the mix shifts after a lull: on the card the fill-4 regime takes a
        # few ms, inside the 50 ms cooldown that spaces retunes
        time.sleep(DRIFT_LULL_S)
        for g in singles:
            futs.append(eng.submit(*graph_args(g)))
            eng.drain(timeout=600)
        retunes = eng.stats.retunes
        post = list(sized_stream(seed=2, n_graphs=4, n_mean=20, n_std=0,
                                 e_per_node=2.2))
        futs += [eng.submit(*graph_args(g)) for g in post]
        eng.drain(timeout=600)
        finite = all(bool(np.all(np.isfinite(f.result(timeout=60))))
                     for f in futs)
        report = eng.autotune_report()
        loads = {k: v["load"] for k, v in report.items() if "load" in v}
        winners = {k: (v["impl"], v["rows_per_block"], v.get("winner"))
                   for k, v in report.items()}
    log("tune", f"(c) drift: {retunes} retunes after the fill-4 regime and "
        f"6 singles ({eng.stats.retunes} in all), loads {loads}, winners "
        f"{winners}, {len(futs)} answers all finite {finite}, captures "
        f"{len(built) - n0}; on {card}")
    if retunes < 1 or not finite:
        raise AssertionError("(c) no drift retune fired, or the retuned "
                             "bucket did not keep serving")
    return {"retunes": eng.stats.retunes, "loads": loads,
            "winners": {k: list(v) for k, v in winners.items()},
            "captures": len(built) - n0, "answers": len(futs)}


def tune_evict(card: str, built: list) -> dict:
    """(d) GIN ``fused_layer`` tuned at max_batch 1 with
    ``max_cached_programs=2`` through four buckets three times: evictions,
    at most two programs held, every later visit one capture of the cached
    winner and no tune, the card's reserved memory no larger after the
    second cycle than after the first (nor after the third). ``built``
    keeps no program alive (``captures(keep=False)``), so that what the
    card holds is what the engine holds."""
    import torch
    from repro_torch.data.graphs import sized_stream
    graphs = [next(sized_stream(seed=nm, n_graphs=1, n_mean=nm, n_std=0))
              for nm in EVICT_SIZES]
    cycles = []
    with tuned_engine("gin", "fused_layer", max_batch=1,
                      max_cached_programs=2) as eng:
        ex = eng._executors[0]
        for cycle in range(3):
            n0 = len(built)
            logs = {k: v["tune_ms"] for k, v in eng._tune_log.items()}
            preds = [eng.process(*graph_args(g)) for g in graphs]
            torch.cuda.synchronize()
            cycles.append({
                "captures": len(built) - n0,
                "tuned": sum(eng._tune_log[k]["tune_ms"] != logs.get(k)
                             for k in eng._tune_log),
                "held": len(ex.compiled), "retired": len(ex.retired),
                "evictions": eng.stats.program_evictions,
                "reserved": torch.cuda.memory_reserved(),
                "allocated": torch.cuda.memory_allocated(),
                "finite": all(bool(np.all(np.isfinite(p))) for p in preds)})
        report = eng.autotune_report()
    log("tune", f"(d) eviction, buckets {sorted(report)}: per cycle "
        f"{cycles}; evictions by bucket "
        f"{ {k: v.get('evictions', 0) for k, v in report.items()} }; "
        f"on {card}")
    c1, c2, c3 = cycles
    if (c3["evictions"] < 1 or any(c["held"] > 2 for c in cycles)
            or not all(c["finite"] for c in cycles)
            or c1["tuned"] != len(graphs) or c2["tuned"] or c3["tuned"]
            or c2["captures"] != len(graphs)
            or c3["captures"] != len(graphs)):
        raise AssertionError("(d) eviction did not bound the programs or an "
                             "evicted bucket was tuned again")
    if c2["reserved"] > c1["reserved"] or c3["reserved"] > c2["reserved"]:
        raise AssertionError("(d) the pool's memory grew on a later cycle")
    return {"cycles": cycles}


def tune_phase(card: str, graphs) -> dict:
    """Phase 4e: per-bucket autotune on the captured programs (a) on a
    real first graph and on the synthetic batch, (b) from its JSON cache,
    (c) drift retune, (d) LRU eviction; counts from 0, no breaker trip."""
    gs = graphs[:16] + graphs[64:68]
    TUNE_CACHE.parent.mkdir(parents=True, exist_ok=True)
    if TUNE_CACHE.exists():
        TUNE_CACHE.unlink()
    out = {}
    t0 = time.perf_counter()

    def run():
        with captures() as built:
            out["a_winners"] = tune_winners(card, gs, built)
            out["b_cached"] = tune_cached(card, gs, built)
            out["c_drift"] = tune_drift(card, built)
        n = len(built)
        del built[:]
        with captures(keep=False) as counted_only:
            out["d_evict"] = tune_evict(card, counted_only)
        return n + len(counted_only)
    captured, counts = counted(run)
    check_trips("phase 4e", [])
    log("tune", f"wrapper launches {counts} over {captured} captures and "
        f"the eager checks")
    used = ("layer_fused", "mp_pipeline", "mp_scatter_multi")
    if (not all(counts[k] for k in used)
            or any(v for k, v in counts.items() if k not in used)):
        raise AssertionError("phase 4e did not run the expected kernels")
    out.update({"captures": captured, "launches": counts,
                "seconds": time.perf_counter() - t0})
    log("tune", f"phase 4e took {out['seconds']:.1f} s; on {card}")
    return out


# ---------------------------------------------------------------------------
# phase 4f: wide placement, one oversized graph on a gang of executors
# ---------------------------------------------------------------------------

WIDE_K = 4
# (a)'s oversized traffic: mesh_like graphs of 1,100 to 2,040 nodes (over
# the largest default bucket, 1,024), every one in one WideBucket at K=4:
# n_own_pad 512, h_pad 32, n_pad 1024, e_pad 4096, node_pad_full 4096
WIDE_SIZES = (1100, 1234, 1368, 1502, 1636, 1770, 1904, 2040)
WIDE_KEY = ("wide", WIDE_K, 1024, 4096)
# the nine kernels' symbols in csrc/ (nt_mlp and fused_nt_scatter share
# the NT tile, gather_rows has two)
NINE_SYMBOLS = ("layer_fused_kernel", "mp_pipeline_kernel",
                "mp_scatter_kernel", "seg_softmax_kernel", "mlp_tile_kernel",
                "gather_pieces_kernel", "gather_values_kernel",
                "flash_attention_kernel")
# (c): K=2 as the program alone, as the reference's wide_bench times it
WIDE_K2_NODES = 1000


def wide_graphs():
    from repro_torch.data.graphs import mesh_like
    return [next(mesh_like(seed=100 + i, n_graphs=1, n_nodes=n))
            for i, n in enumerate(WIDE_SIZES)]


def single_forward(cfg, params, g, impl: str):
    """The port's eager single-device forward of ``g`` on the card at the
    bucket of its size (4,096 nodes for (a)'s graphs), on the host."""
    import torch
    from repro_torch.core.graph import build_graph_batch, pad_bucket
    from repro_torch.core.message_passing import DataflowConfig
    from repro_torch.core.models import make_gnn
    n, e = g.node_feat.shape[0], g.senders.shape[0]
    batch = build_graph_batch(
        g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
        node_pos=g.node_pos, node_pad=pad_bucket(n), edge_pad=pad_bucket(e),
        pos_dim=cfg.pos_dim, device="cuda")
    with torch.inference_mode():
        out = make_gnn(cfg).apply(params, batch, cfg,
                                  DataflowConfig(impl=impl))
    return out.cpu().numpy()[0]


def wide_engine(cfg, params, **kw):
    """``cfg`` under ``fused_layer`` on ``WIDE_K`` executors of the card
    with wide placement on (the default buckets unless given)."""
    from repro_torch.core.engine import GraphStreamEngine
    from repro_torch.core.message_passing import DataflowConfig
    return GraphStreamEngine(cfg, params, DataflowConfig(impl="fused_layer"),
                             wide=True, wide_k=WIDE_K,
                             devices=["cuda"] * WIDE_K, **kw)


def overlap(intervals) -> dict:
    """How far kernel intervals (start, end in us) ran side by side: the
    most at once, and the us during which two or more ran."""
    points = sorted([(a, 1) for a, _ in intervals]
                    + [(b, -1) for _, b in intervals])
    running = most = 0
    side_by_side = 0.0
    last = None
    for t, step in points:
        if last is not None and running >= 2:
            side_by_side += t - last
        running += step
        most = max(most, running)
        last = t
    return {"kernels": len(intervals), "max_concurrent": most,
            "side_by_side_us": side_by_side,
            "kernel_us": sum(b - a for a, b in intervals)}


def replay_events(run):
    """``run()`` under ``torch.profiler``: (what it returned, the device
    events of each of ``NINE_SYMBOLS``, how far the GNN kernels' intervals
    overlapped)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = run()
        torch.cuda.synchronize()
    counts = {sym: 0 for sym in NINE_SYMBOLS}
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for sym in NINE_SYMBOLS:
            if sym in ev.name:
                counts[sym] += 1
                spans.append((ev.time_range.start, ev.time_range.end))
    return result, counts, overlap(spans)


def check_replay(label: str, counts: dict, want: dict) -> None:
    want = {sym: want.get(sym, 0) for sym in NINE_SYMBOLS}
    log("wide", f"{label}: one replay's device kernel events {counts} "
        f"(expected {want})")
    if counts != want:
        raise AssertionError(f"{label}: the wide replay did not run the "
                             f"expected kernels")


def wide_answers(label: str, cfg, params, graphs, outs) -> dict:
    """Hold each wide answer to the eager single-device forward of its
    graph on the card under ``fused_layer`` (``EAGER_RTOL``) and under the
    plain ``fused`` (``SLICE_RTOL``); report the largest error and whether
    each is bitwise the former."""
    rows = []
    for g, out in zip(graphs, outs):
        ref = single_forward(cfg, params, g, "fused_layer")
        plain = single_forward(cfg, params, g, "fused")
        rows.append({"nodes": int(g.node_feat.shape[0]),
                     "max_abs_err": float(np.abs(out - ref).max()),
                     "rel": rel_diff(out, ref),
                     "rel_vs_fused": rel_diff(out, plain),
                     "bitwise": bool(np.array_equal(out, ref))})
    worst = max(r["rel"] for r in rows)
    worst_plain = max(r["rel_vs_fused"] for r in rows)
    bitwise = sum(r["bitwise"] for r in rows)
    log("wide", f"{label}: {len(rows)} wide answers vs the eager "
        f"single-device forward: max abs err "
        f"{max(r['max_abs_err'] for r in rows):.3e}, worst {worst:.3e} "
        f"relative to max(1, |ref|) (tol {EAGER_RTOL:g}), bitwise on "
        f"{bitwise}/{len(rows)}; vs impl='fused' {worst_plain:.3e} (tol "
        f"{SLICE_RTOL:g})")
    if worst > EAGER_RTOL or worst_plain > SLICE_RTOL:
        raise AssertionError(f"{label}: wide answers differ from the "
                             f"single-device forward")
    return {"worst_rel": worst, "worst_rel_vs_fused": worst_plain,
            "bitwise": bitwise, "answers": rows}


def wide_served(card: str, eng, cfg, params, graphs) -> dict:
    """(a): the oversized graphs and 16 molecules through one engine's
    ``submit`` / ``drain``, interleaved."""
    from repro_torch.data.graphs import molhiv_like
    narrow = list(molhiv_like(seed=0, n_graphs=16))
    mixed = []
    for i in range(16):
        mixed.append(narrow[i])
        if i % 2:
            mixed.append(graphs[i // 2])
    t0 = time.perf_counter()
    futs = [eng.submit(*graph_args(g)) for g in mixed]
    eng.drain(timeout=600)
    outs = [f.result(timeout=60) for f in futs]
    wall = time.perf_counter() - t0
    wide_out = [o for g, o in zip(mixed, outs) if g.node_feat.shape[0] > 1024]
    narrow_out = [o for g, o in zip(mixed, outs)
                  if g.node_feat.shape[0] <= 1024]
    out = {"wall_s": wall, "wide": wide_answers("(a) GIN", cfg, params,
                                                graphs, wide_out)}
    worst = max(rel_diff(o, eager_forward(eng, g)[0])
                for g, o in zip(narrow, narrow_out))
    log("wide", f"(a) 16 narrow answers on the same engine vs the eager "
        f"forward: worst {worst:.3e} (tol {EAGER_RTOL:g})")
    if worst > EAGER_RTOL:
        raise AssertionError("(a): narrow answers differ from the eager "
                             "forward")
    progs = list(eng._wide_programs.values())
    by_device = eng.stats.by_device
    log("wide", f"(a) wide programs {len(progs)} "
        f"({', '.join(type(p).__name__ for p in progs)}), edge passes "
        f"{eng.edge_passes.get(WIDE_KEY)} under {WIDE_KEY}, by_device "
        f"{sorted(by_device)}")
    if (len(progs) != 1 or type(progs[0]).__name__ != "CapturedWideProgram"
            or WIDE_KEY not in eng.edge_passes
            or f"wide[{WIDE_K}]" not in by_device):
        raise AssertionError("(a): not one captured wide program serving "
                             "both size classes")
    _, counts, ov = replay_events(
        lambda: eng.submit(*graph_args(graphs[0])).result(timeout=60))
    check_replay("(a) GIN", counts, {"layer_fused_kernel": WIDE_K * 5})
    log("wide", f"(a) GIN replay: {ov['kernels']} kernels, at most "
        f"{ov['max_concurrent']} at once, {ov['side_by_side_us']:.1f} of "
        f"{ov['kernel_us']:.1f} kernel us side by side")
    out.update({"narrow_worst_rel": worst, "capture_s": progs[0].build_s,
                "edge_passes": eng.edge_passes[WIDE_KEY],
                "replay_events": counts, "overlap": ov})
    return out


def wide_models(card: str, g) -> dict:
    """(b): each paper model at K=4 serves one wide graph."""
    out = {}
    for name in ("gin", "gin_vn", "gcn", "gat", "pna", "dgn"):
        cfg, params = init_params(name, "cuda")
        eng = wide_engine(cfg, params)
        try:
            t0 = time.perf_counter()
            eng.submit(*graph_args(g)).result(timeout=300)
            first_s = time.perf_counter() - t0
            ans, counts, ov = replay_events(
                lambda: eng.submit(*graph_args(g)).result(timeout=60))
            sym = ("mp_pipeline_kernel" if name == "gat"
                   else "layer_fused_kernel")
            check_replay(f"(b) {name}", counts,
                         {sym: WIDE_K * cfg.num_layers})
            (prog,) = eng._wide_programs.values()
            out[name] = {**wide_answers(f"(b) {name}", cfg, params, [g],
                                        [ans]),
                         "replay_events": counts, "overlap": ov,
                         "capture_s": prog.build_s, "first_s": first_s,
                         "span_ms": eng.stats.device_s[-1] * 1e3}
            log("wide", f"(b) {name}: capture {prog.build_s * 1e3:.1f} ms, "
                f"replay span {out[name]['span_ms']:.3f} ms, at most "
                f"{ov['max_concurrent']} kernels at once; on {card}")
        finally:
            eng.close(timeout=60)
    return out


def ring_steps_ms(cfg, params, plan, stacked, executors) -> list:
    """The ms of each ring step of the eager schedule on ``executors``'
    streams, between CUDA events (the capture hides them): one entry per
    (layer, step), the members joined around each step."""
    import torch
    from repro_torch.core.message_passing import DataflowConfig
    from repro_torch.distributed.wide import build_wide_forward, wide_mesh
    fwd = build_wide_forward(
        cfg, plan, wide_mesh([ex.device for ex in executors],
                             [ex.stream for ex in executors]),
        DataflowConfig(impl="fused_layer"))
    with executors[0].on_device():
        fwd(params, stacked)                      # warm
        events = []
        fwd(params, stacked, ring_events=events)
        torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def wide_k2(card: str, cfg, params) -> dict:
    """(c): K=2 as the program alone, as the reference's wide_bench times
    it: ``build_wide_forward`` on two executors' streams, captured once,
    for 8 ``mesh_like`` graphs of 1,000 nodes planned with no budget (each
    graph's plan, shard arrays and replay timed), against the
    single-device forward at the 1,024 bucket."""
    import torch
    from repro_torch.core.engine import CapturedWideProgram
    from repro_torch.core.engine import GraphStreamEngine
    from repro_torch.core.message_passing import DataflowConfig
    from repro_torch.data.graphs import mesh_like
    from repro_torch.distributed.wide import (build_wide_forward, plan_wide,
                                              stack_shard_arrays, wide_mesh)
    graphs = list(mesh_like(seed=7, n_graphs=8, n_nodes=WIDE_K2_NODES))
    plans = [plan_wide(g.senders, g.receivers, WIDE_K2_NODES, k=2)
             for g in graphs]
    buckets = {p.bucket for p in plans}
    (bucket,) = buckets
    if (bucket.n_pad, bucket.e_pad) != (1024, 4096):
        raise AssertionError(f"(c): K=2 bucket {bucket}")
    pair = GraphStreamEngine(cfg, params, DataflowConfig(impl="fused_layer"),
                             devices=["cuda"] * 2)
    ex0, ex1 = pair._executors
    fwd = build_wide_forward(cfg, bucket, wide_mesh(
        ["cuda"] * 2, [ex0.stream, ex1.stream]),
        DataflowConfig(impl="fused_layer"))
    stacked = [stack_shard_arrays(p, g.node_feat, g.edge_feat, g.node_pos)
               for p, g in zip(plans, graphs)]
    with ex0.on_device():
        prog = CapturedWideProgram(
            fwd, params, stacked[0], pool=torch.cuda.graph_pool_handle(),
            stream=ex0.stream, warm_stream=ex0.warm_stream)
        for st in stacked:
            prog.run(st, params)                  # warm
        t0 = time.perf_counter()
        outs, spans = [], []
        for g in graphs:
            p = plan_wide(g.senders, g.receivers, WIDE_K2_NODES, k=2)
            o, span = prog.run(stack_shard_arrays(
                p, g.node_feat, g.edge_feat, g.node_pos), params)
            outs.append(o[0])
            spans.append(span)
        wall = time.perf_counter() - t0
    steps = ring_steps_ms(cfg, params, plans[0], stacked[0], [ex0, ex1])
    pair.close(timeout=60)
    out = {"bucket": bucket.__dict__, "capture_s": prog.build_s,
           "gps": len(graphs) / wall, "span_ms": [s * 1e3 for s in spans],
           "ring_step_ms": steps,
           "halo_rows_per_layer": plans[0].halo_rows_per_layer,
           "halo_bytes_per_layer": plans[0].halo_bytes_per_layer(
               cfg.hidden_dim),
           **wide_answers("(c) GIN K=2", cfg, params, graphs, outs)}
    log("wide", f"(c) K=2 program: {out['gps']:.1f} graphs/s (plan, shard "
        f"arrays, replay), replay span p50 "
        f"{statistics.median(out['span_ms']):.3f} ms, ring steps "
        f"{', '.join(f'{s:.4f}' for s in steps)} ms, halo "
        f"{out['halo_rows_per_layer']} rows / {out['halo_bytes_per_layer']} "
        f"bytes a layer, capture {prog.build_s * 1e3:.1f} ms; on {card}")
    return out


def wide_vs_k1(card: str, eng, cfg, params, graphs) -> dict:
    """(d): the wide graphs through the K=4 gang against a K=1 pool (the
    default buckets plus 4096, max_batch 1, 4 executors: one graph a
    device), each served once to warm, then timed through submit / drain:
    p50 from submit to answer, replay spans, graphs per second of wall
    (the reference's ``speedup_vs_k1``, reported, not gated); the ring
    steps' ms of the eager schedule and the halo a layer."""
    from repro_torch.core.engine import GraphStreamEngine, StreamStats
    from repro_torch.core.message_passing import DataflowConfig
    from repro_torch.distributed.wide import plan_wide, stack_shard_arrays

    def timed(engine) -> dict:
        stream(engine, graphs, record=False)
        engine.stats = StreamStats()
        outs, wall = stream(engine, graphs)
        s = engine.stats.summary()
        return {"outs": outs, "wall_s": wall, "gps": len(graphs) / wall,
                "p50_ms": s["p50_ms"], "p99_ms": s["p99_ms"],
                "span_ms": [d * 1e3 for d in engine.stats.device_s]}

    wide = timed(eng)
    k1_eng = GraphStreamEngine(cfg, params, DataflowConfig(impl="fused_layer"),
                               buckets=(32, 64, 128, 256, 512, 1024, 4096),
                               max_batch=1, devices=["cuda"] * WIDE_K)
    try:
        k1_eng.warmup_all(pairs=[(4096, 8192)])    # every executor's capture
        k1 = timed(k1_eng)
    finally:
        k1_eng.close(timeout=60)
    same = sum(bool(np.array_equal(a, b))
               for a, b in zip(wide["outs"], k1["outs"]))
    worst = max(rel_diff(a, b) for a, b in zip(wide["outs"], k1["outs"]))
    if worst > EAGER_RTOL:
        raise AssertionError("(d): the gang's answers differ from the K=1 "
                             "pool's")
    plan = plan_wide(graphs[-1].senders, graphs[-1].receivers,
                     graphs[-1].node_feat.shape[0], k=WIDE_K,
                     node_budget=1024)
    g = graphs[-1]
    steps = ring_steps_ms(cfg, eng.params, plan, stack_shard_arrays(
        plan, g.node_feat, g.edge_feat, g.node_pos), eng._executors)
    halo = [plan_wide(x.senders, x.receivers, x.node_feat.shape[0],
                      k=WIDE_K).halo_rows_per_layer for x in graphs]
    out = {"wide": {k: v for k, v in wide.items() if k != "outs"},
           "k1": {k: v for k, v in k1.items() if k != "outs"},
           "speedup_vs_k1": wide["gps"] / k1["gps"],
           "bitwise_vs_k1": same, "worst_rel_vs_k1": worst,
           "ring_step_ms": steps, "halo_rows_per_layer": halo,
           "halo_bytes_per_layer": [h * cfg.hidden_dim * 4 for h in halo]}
    log("wide", f"(d) K={WIDE_K} gang: p50 {wide['p50_ms']:.3f} ms, p99 "
        f"{wide['p99_ms']:.3f} ms, replay span p50 "
        f"{statistics.median(wide['span_ms']):.3f} ms, {wide['gps']:.1f} "
        f"graphs/s; K=1 pool: p50 {k1['p50_ms']:.3f} ms, replay span p50 "
        f"{statistics.median(k1['span_ms']):.3f} ms, {k1['gps']:.1f} "
        f"graphs/s; speedup_vs_k1 {out['speedup_vs_k1']:.3f} (reported, "
        f"not gated); answers bitwise the K=1 pool's on {same}/"
        f"{len(graphs)}, worst {worst:.3e}; on {card}")
    log("wide", f"(d) ring steps of the eager schedule at n="
        f"{g.node_feat.shape[0]} ({cfg.num_layers - 1} exchanges x "
        f"{WIDE_K - 1} steps): {', '.join(f'{s:.4f}' for s in steps)} ms; "
        f"halo rows a layer {halo} ({cfg.hidden_dim} floats a row)")
    return out


def wide_faults(card: str, eng, cfg, graphs) -> dict:
    """(e): ``update_params`` under wide traffic, the next wide answer
    under the new version; a planted transient failure of the wide program
    retried, then served; a random graph with no locality refused."""
    import torch
    from repro_torch.core.engine import GraphStreamEngine
    from repro_torch.core.errors import GraphTooLarge
    from repro_torch.core.message_passing import DataflowConfig
    from repro_torch.core.models import make_gnn
    new = make_gnn(cfg).init(torch.Generator().manual_seed(1), cfg,
                             device="cuda")
    leader = eng._executors[0]
    swaps0 = leader.swaps
    futs = [eng.submit(*graph_args(g)) for g in graphs[:4]]
    t0 = time.perf_counter()
    version = eng.update_params(new)
    update_ms = (time.perf_counter() - t0) * 1e3
    eng.drain(timeout=600)
    for f in futs:
        f.result(timeout=60)
    after = eng.submit(*graph_args(graphs[4])).result(timeout=60)
    rel_new = rel_diff(after, single_forward(cfg, new, graphs[4],
                                             "fused_layer"))
    log("wide", f"(e) update_params to version {version} under wide "
        f"traffic ({update_ms:.1f} ms): the next wide answer vs the new "
        f"weights' eager forward {rel_new:.3e} (tol {EAGER_RTOL:g}); "
        f"leader swaps {leader.swaps - swaps0}, wide programs "
        f"{len(eng._wide_programs)}")
    if (rel_new > EAGER_RTOL or len(eng._wide_programs) != 1
            or leader.swaps == swaps0):
        raise AssertionError("(e): the wide program did not serve the new "
                             "weights from its one capture")
    (prog,) = eng._wide_programs.values()
    real, calls = prog.run, []

    def flaky(stacked, params):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("planted transient failure")
        return real(stacked, params)
    retries0 = eng.stats.retries
    prog.run = flaky
    try:
        out = eng.submit(*graph_args(graphs[5])).result(timeout=60)
    finally:
        del prog.run
    rel_retry = rel_diff(out, single_forward(cfg, new, graphs[5],
                                             "fused_layer"))
    log("wide", f"(e) a planted transient failure: {len(calls)} runs, "
        f"retries {eng.stats.retries - retries0}, the answer "
        f"{rel_retry:.3e} from the eager forward")
    if len(calls) != 2 or eng.stats.retries != retries0 + 1 or (
            rel_retry > EAGER_RTOL):
        raise AssertionError("(e): the transient failure was not retried "
                             "and served")
    rng = np.random.default_rng(0)
    small = GraphStreamEngine(cfg, new, DataflowConfig(impl="fused_layer"),
                              buckets=(32, 64, 128, 256, 512), wide=True,
                              wide_k=WIDE_K, devices=["cuda"] * WIDE_K)
    try:
        small.submit(rng.normal(size=(900, 9)).astype(np.float32),
                     rng.integers(0, 900, 3600).astype(np.int32),
                     rng.integers(0, 900, 3600).astype(np.int32),
                     rng.normal(size=(3600, 3)).astype(np.float32))
        raise AssertionError("(e): a graph with no locality was admitted")
    except GraphTooLarge as exc:
        refused = str(exc)
    finally:
        small.close(timeout=60)
    log("wide", f"(e) a random graph of 900 nodes and 3,600 edges on "
        f"buckets up to 512: GraphTooLarge ({refused})")
    return {"update_ms": update_ms, "rel_after_update": rel_new,
            "swaps": leader.swaps - swaps0, "retry_runs": len(calls),
            "rel_after_retry": rel_retry, "refused": refused}


def wide_phase(card: str) -> dict:
    """Phase 4f: wide placement, counts from 0, no breaker trip."""
    out = {}
    t0 = time.perf_counter()

    def run():
        cfg, params = init_params("gin", "cuda")
        graphs = wide_graphs()
        eng = wide_engine(cfg, params)
        try:
            out["a_served"] = wide_served(card, eng, cfg, params, graphs)
            out["d_vs_k1"] = wide_vs_k1(card, eng, cfg, params, graphs)
            out["e_faults"] = wide_faults(card, eng, cfg, graphs)
        finally:
            eng.close(timeout=60)
        out["b_models"] = wide_models(card, graphs[-1])
        out["c_k2_program"] = wide_k2(card, cfg, params)
    _, counts = counted(run)
    check_trips("phase 4f", [])
    used = ("layer_fused", "mp_pipeline")
    log("wide", f"wrapper launches {counts} (the captures' warm-up runs "
        f"and captures, the eager checks)")
    if (not all(counts[k] for k in used)
            or any(v for k, v in counts.items() if k not in used)):
        raise AssertionError("phase 4f did not run the expected kernels")
    out.update({"launches": counts, "seconds": time.perf_counter() - t0})
    log("wide", f"phase 4f took {out['seconds']:.1f} s; on {card}")
    return out


def record_main_inputs():
    """What each path of phase 4 hands its kernel in its first two layers
    (the first reads the raw features or their encoding, the second the
    hidden width), with the slice's own models and seeds, at both buckets,
    and what each path of phase 4c hands its kernels at its first packed
    batch of max_batch 8 and 64 (``packed_buckets``): ({kernel: {case
    name: inputs}}, {bucket: its edge stream in numpy}, the two batch-1
    buckets only)."""
    users = {"layer_fused": (("gin", "fused_layer"), ("gcn", "fused_layer"),
                             ("pna", "fused_layer"), ("dgn", "fused_layer"),
                             ("gin_vn", "fused_layer")),
             "mp_pipeline": (("gat", "fused_layer"), ("gin", "pipeline"),
                             ("gcn", "pipeline"), ("pna", "pipeline"),
                             ("dgn", "pipeline")),
             "mp_scatter": (("gin", "kernel"), ("gcn", "kernel"),
                            ("gin_vn", "kernel"), ("gat", "kernel")),
             "mp_scatter_multi": (("pna", "kernel"), ("dgn", "kernel")),
             "seg_softmax": (("gat", "kernel"),)}
    main_inputs = {kernel: {} for kernel in users}
    bucket_edges = {}
    for key, bucket, batch in serving_buckets():
        bucket_edges[bucket] = edge_stream(batch)
        for kernel, runs in users.items():
            for name, impl in runs:
                for l, kw in enumerate(main_path_inputs(name, impl, kernel,
                                                        batch)):
                    main_inputs[kernel][
                        f"{key}_{name}_{impl}_L{l}_{bucket}"] = kw
    # phase 4c's paths at their first packed bucket
    for key, bucket, batch in packed_buckets():
        for (name, impl), per_graph in HOST_LAUNCHES.items():
            for kernel in per_graph:
                for l, kw in enumerate(main_path_inputs(name, impl, kernel,
                                                        batch)):
                    main_inputs[kernel][
                        f"{key}_{name}_{impl}_L{l}_{bucket}"] = kw
    return main_inputs, bucket_edges


def packed_buckets(device: str = "cuda"):
    """Phase 4c's first batch at max_batch 8 and at 64: the first 8 and 64
    ``molhiv_like(seed=0)`` graphs packed and padded as the packer seals
    them (the engine's bucket table), (key, bucket name, batch)."""
    from repro_torch.core.graph import pad_bucket
    from repro_torch.core.packing import DEFAULT_BUCKETS, PackedBatch, PackItem
    from repro_torch.data.graphs import molhiv_like
    graphs = list(molhiv_like(seed=0, n_graphs=64))
    for key, k in (("g", 8), ("h", 64)):
        items = [PackItem(*graph_args(g)) for g in graphs[:k]]
        pb = PackedBatch(
            items=items,
            node_pad=pad_bucket(sum(it.num_nodes for it in items),
                                DEFAULT_BUCKETS),
            edge_pad=pad_bucket(sum(it.num_edges for it in items),
                                DEFAULT_BUCKETS), graph_pad=k)
        yield key, f"packed{k}_bucket", pb.build(device=device)


# ---------------------------------------------------------------------------
# 10. training: the flash backward kernel, gradients through the kernels,
# and qwen1.5-0.5b trained at full width and depth
# ---------------------------------------------------------------------------

# flash_attention_bwd against its plain version, each gradient within this
# share of its own scale (max |plain|): float32 sums the kernel and the
# plain version take in other orders over up to 4,096 rows or keys;
# bfloat16: the plain version computes in float32, the kernel's tensor
# cores take P and dS rounded to bf16 (one term each, within 2^-8 of each
# value) and sum in float32; both round each gradient once, so they may
# differ by one bf16 unit (2^-8 to 2^-7 of the value) where the two
# float32 values straddle a rounding point, and P's and dS's rounding
# moves the float32 values by less than a unit: held at 2^-7 of the scale
FLASH_BWD_TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
# (B, H, Sq, Sk, D, causal, window, softcap, q scale, dtype, library call):
# the training shapes of qwen1.5-0.5b (archs.py:22: 16 heads of 64, the
# phase's B=8 x S=2048) and llama3-8b (32 heads of 128, KV repeated);
# gemma2-27b's local layer (window 4096, softcap 50, q scaled by 50 so the
# cap bends the scores) at S=4096; recurrentgemma-2b's local layer (10
# heads of 256, window 2048) at S=4096, where the window binds; one
# float32 case; Sq < Sk; a ragged length with the window's edge inside
# the tiles. The library call: SDPA's backward, causal ("sdpa") or under an
# explicit end-aligned boolean mask ("sdpa_mask": a window, or Sq < Sk,
# which is_causal aligns at the top); none with a softcap
FLASH_BWD_CASES = {
    "a_qwen1.5_0.5b_train_bf16": (8, 16, 2048, 2048, 64, True, None, None,
                                  1.0, "bfloat16", "sdpa"),
    "b_llama3_8b_train_bf16": (1, 32, 2048, 2048, 128, True, None, None,
                               1.0, "bfloat16", "sdpa"),
    "c_gemma2_27b_local_bf16": (1, 8, 4096, 4096, 128, True, 4096, 50.0,
                                50.0, "bfloat16", None),
    "d_recurrentgemma_2b_local_bf16": (1, 10, 4096, 4096, 256, True, 2048,
                                       None, 1.0, "bfloat16", "sdpa_mask"),
    "e_qwen1.5_0.5b_f32": (1, 16, 2048, 2048, 64, True, None, None, 1.0,
                           "float32", "sdpa"),
    "f_sq_lt_sk_bf16": (1, 4, 512, 1024, 64, True, None, None, 1.0,
                        "bfloat16", "sdpa_mask"),
    "g_ragged_1000_window_bf16": (1, 4, 1000, 1000, 128, True, 300, None,
                                  1.0, "bfloat16", "sdpa_mask"),
    # float32 (the three-term kernels) at llama3-8b's D=128, gemma2's
    # softcap, recurrentgemma's D=256 window, Sq < Sk and a ragged length
    "h_llama3_8b_train_f32": (1, 32, 2048, 2048, 128, True, None, None, 1.0,
                              "float32", "sdpa"),
    "i_gemma2_27b_local_f32": (1, 8, 4096, 4096, 128, True, 4096, 50.0,
                               50.0, "float32", None),
    "j_recurrentgemma_2b_local_f32": (1, 10, 4096, 4096, 256, True, 2048,
                                      None, 1.0, "float32", "sdpa_mask"),
    "k_sq_lt_sk_f32": (1, 4, 512, 1024, 64, True, None, None, 1.0,
                       "float32", "sdpa_mask"),
    "l_ragged_1000_window_f32": (1, 4, 1000, 1000, 128, True, 300, None,
                                 1.0, "float32", "sdpa_mask"),
}
SDPA_BWD_TXT = {"sdpa": "library scaled_dot_product_attention("
                        "is_causal=True)'s backward (torch.autograd.grad "
                        "of its output)",
                "sdpa_mask": "library scaled_dot_product_attention("
                             "attn_mask=the end-aligned boolean mask)'s "
                             "backward (torch.autograd.grad of its output)"}
# the depth-2 float32 gradient check (TF32 off): the loss within this
# share of itself and every parameter's gradient within this share of its
# own scale, the kernels against their plain versions (float32 sums in
# other orders, through two blocks and the loss)
TRAIN_F32_TOL = 1e-4
TRAIN_CHECK = (("qwen1.5-0.5b", 2, 2, 512), ("olmoe-1b-7b", 2, 2, 256))
# the training run: qwen1.5-0.5b at full width and depth (bf16, AdamW,
# per-layer remat), B x S synth tokens, this many steps
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen1.5-0.5b", 8, 2048, 20
TRAIN_LR = 1e-3


def flash_bwd_tiling(d: int, dtype: str):
    """(query rows a dQ block owns, keys a dQ block takes per kv tile) of
    the kernel of ``csrc/flash_attention_bwd.cu`` that runs ``dtype`` at
    head width ``d``, as the built library reports them."""
    import ctypes
    from repro_torch.kernels import build
    fn = build.load("flash_attention_bwd").flash_attention_bwd_tiling
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(3)]
    err = fn(d, int(dtype == "bfloat16"), *(ctypes.byref(x) for x in out))
    if err:
        raise RuntimeError(f"flash_attention_bwd_tiling({d}): error {err}")
    return out[0].value, out[1].value


def flash_bwd_instantiation(symbol: str):
    """(launch, D, dtype) of a mangled kernel name of
    csrc/flash_attention_bwd.cu, or None: ``tc::flash_bwd_{dkv,dq}_
    wgmma<D>`` run bfloat16, ``x3::flash_bwd_{dkv,dq}_x3<D>`` float32."""
    m = re.search(r"flash_bwd_(dkv|dq)_(wgmma|x3)ILi(\d+)E", symbol)
    if not m:
        return None
    return (m.group(1), int(m.group(3)),
            "bfloat16" if m.group(2) == "wgmma" else "float32")


def flash_bwd_build_report() -> dict:
    """Per instantiation of csrc/flash_attention_bwd.cu: registers and
    spill bytes from the build's ``-Xptxas -v`` log and the count of HGMMA
    (wgmma), ATOM* and RED instructions in the library's SASS (``cuobjdump
    -sass``). Raises unless there are 20 (dQ and dK / dV at five widths
    for bf16 and for float32), every one holds HGMMA and none holds an
    atomic."""
    from repro_torch.kernels import build
    report = {f"{dt}_{launch}_d{d}": info for (launch, d, dt), info in
              sorted(ptxas_report("flash_attention_bwd",
                                  flash_bwd_instantiation).items())}
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass",
         str(build.library_path("flash_attention_bwd"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    for part in sass.split("Function : ")[1:]:
        key = flash_bwd_instantiation(part.split(None, 1)[0])
        if key is None:
            continue
        info = report[f"{key[2]}_{key[0]}_d{key[1]}"]
        info["hgmma"] = part.count("HGMMA")
        info["atomics"] = len(re.findall(r"\b(?:ATOM[SG]?|RED)[.\s]",
                                         part))
    for key, info in report.items():
        log("train", f"flash_attention_bwd {key}: {info['registers']} "
            f"registers, spill stores/loads {info['spill_stores']}/"
            f"{info['spill_loads']} bytes, {info.get('hgmma', 0)} HGMMA and "
            f"{info.get('atomics', 0)} ATOM/RED in its SASS (ptxas -v log, "
            f"cuobjdump -sass)")
    missing = [k for k, info in report.items() if not info.get("hgmma")]
    atomics = [k for k, info in report.items() if info.get("atomics")]
    if len(report) != 20 or missing or atomics:
        raise AssertionError(f"flash_attention_bwd's build: {len(report)} "
                             f"instantiations (not 20), without HGMMA: "
                             f"{missing}, with atomics: "
                             f"{atomics}")
    return report


def dense_attention_bwd(q, k, v, out, lse, dout, mask, softcap, *,
                        skip_rows=None, skip_keys=None, drop_dcap=False,
                        with_ds=False):
    """One head's (dq, dk, dv) by the plain rules in float32, from q (Sq,
    D), k, v (Sk, D), the forward's out and lse (the residuals ``_bwd``
    reads) and dout, under an explicit mask (and ds, (Sq, Sk), with
    ``with_ds``); a planted fault drops keys ``skip_keys`` from rows
    ``skip_rows``' dq alone, or the softcap's derivative."""
    import torch
    f32 = torch.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs, kk, vv, go = (t.to(f32) for t in (q, k, v, dout))
    qs = qs * scale
    s = qs @ kk.T
    dcap = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        dcap, s = 1.0 - t * t, softcap * t
    p = torch.where(mask, torch.exp(s - lse[:, None]), 0.0)
    ds = p * (go @ vv.T - (go * out.to(f32)).sum(-1, keepdim=True))
    if dcap is not None and not drop_dcap:
        ds = ds * dcap
    dsq = ds
    if skip_rows is not None:
        dsq = ds.clone()
        dsq[skip_rows, skip_keys] = 0.0
    grads = ((dsq @ kk) * scale, ds.T @ qs, p.T @ go)
    return grads + (ds,) if with_ds else grads


def flash_bwd_close(ours, want, dtype: str):
    """(max |ours - want|, the worst share of a gradient's scale, whether
    each gradient is within ``FLASH_BWD_TOL[dtype]`` of its scale and
    finite)."""
    import torch
    errs, rels, ok = [], [], True
    for a, b in zip(ours, want):
        err = float((a.float() - b.float()).abs().max())
        scale = max(1e-30, float(b.float().abs().max()))
        errs.append(err)
        rels.append(err / scale)
        ok &= err <= FLASH_BWD_TOL[dtype] * scale and bool(
            torch.isfinite(a).all())
    return max(errs), max(rels), ok


def worst_share(got, exact):
    """The largest share of its own scale (max |exact|) by which a
    gradient of ``got`` misses ``exact``, in float64."""
    return max(float((a.double() - e.double()).abs().max())
               / max(1e-30, float(e.abs().max()))
               for a, e in zip(got, exact))


def check_bwd_planted_faults(name, q, k, v, out, lse, dout, grads, plain, *,
                             causal, window, softcap, dtype):
    """On head (0, 0): the one-head plain rules hold against the kernel's
    gradients, and each planted fault, taken as if it were the kernel's,
    fails the tolerance against the plain version's: dq of one of the
    kernel's q blocks skipping one kv tile of its sweep, and (with a
    softcap) the softcap's derivative dropped. The (q block, kv tile) is
    the one whose keys move that block's dq most: a peaked softmax (the
    saturated softcap) leaves most tiles' share below any tolerance.
    Raise otherwise."""
    import torch
    from repro_torch.kernels.flash_attention import visible
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    bq, bk = flash_bwd_tiling(d, dtype)
    mask = visible(sq, sk, causal=causal, window=window, device=q.device)
    heads = [t[0, 0] for t in (q, k, v, out, lse, dout)]
    *one, ds = dense_attention_bwd(*heads, mask, softcap, with_ds=True)
    err, rel, ok = flash_bwd_close([g[0, 0] for g in grads], one, dtype)
    if not ok:
        raise AssertionError(f"flash_attention_bwd {name}: head (0, 0) "
                             f"disagrees with one head's plain rules "
                             f"({rel:.3e} of scale)")
    # each (q block, kv tile)'s share of that block's dq: ds and k padded
    # to whole tiles, (q blocks, rows, kv tiles, D), its largest entry
    nq, nk = -(-sq // bq), -(-sk // bk)
    dsp = torch.nn.functional.pad(ds, (0, nk * bk - sk, 0, nq * bq - sq))
    kp = torch.nn.functional.pad(heads[1].float(), (0, 0, 0, nk * bk - sk))
    share = torch.einsum("aibj,bjd->aibd", dsp.reshape(nq, bq, nk, bk),
                         kp.reshape(nk, bk, -1)).abs().amax(dim=(1, 3))
    a, t = divmod(int(share.argmax()), nk)
    faults = {f"dq of q block [{a * bq}, {min(sq, (a + 1) * bq)}) skips "
              f"keys [{t * bk}, {min(sk, (t + 1) * bk)})":
              dense_attention_bwd(*heads, mask, softcap,
                                  skip_rows=slice(a * bq, (a + 1) * bq),
                                  skip_keys=slice(t * bk, (t + 1) * bk))}
    if softcap is not None:
        faults["the softcap's derivative dropped"] = dense_attention_bwd(
            *heads, mask, softcap, drop_dcap=True)
    seen_txt = []
    for label, fault in faults.items():
        err, rel, ok = flash_bwd_close(fault, [g[0, 0] for g in plain],
                                       dtype)
        if ok:
            raise AssertionError(f"flash_attention_bwd {name}: the "
                                 f"tolerance passes a planted fault, {label}")
        seen_txt.append(f"{label} ({rel:.3e} of scale)")
    log("train", f"flash_attention_bwd {name}: the tolerance fails each "
        f"planted fault on head (0, 0): {'; '.join(seen_txt)}")


def flash_bwd_bound(b, h, sq, sk, d, causal, window, dtype):
    """The least time (ms) of the backward's function: the work of
    ``kernels/cost.py::flash_bwd_work`` (q, k, v, out, dout and lse read
    once, dq, dk, dv written once; its five products, 10 D operations per
    visible pair) by ``split_bound``."""
    from repro_torch.kernels import cost
    return split_bound(*cost.flash_bwd_work(
        b, h, sq, sk, d, causal=causal, window=window,
        itemsize=2 if dtype == "bfloat16" else 4), dtype)


def flash_bwd_phase(card: str):
    """``flash_attention_bwd`` against its plain version on the card at
    the training shapes (``FLASH_BWD_CASES``), bitwise across two runs,
    the planted faults, timed beside its bound and, where one call
    computes the same function, SDPA's backward. The forward's lse comes
    from the forward kernel. These launches are not the path's. Returns
    the cases' rows and the instantiations' build report."""
    import torch
    from repro_torch.kernels.flash_attention import (
        _forward_with_lse, _launch, flash_attention_bwd,
        flash_attention_bwd_ref, visible)
    report = flash_bwd_build_report()
    rows = {}
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, (b, h, sq, sk, d, causal, window, cap, q_scale, dtype,
               lib) in FLASH_BWD_CASES.items():
        dt = getattr(torch, dtype)
        q = (torch.randn(b, h, sq, d, generator=g, device="cuda")
             * q_scale).to(dt)
        k, v, dout = (torch.randn(b, h, n, d, generator=g,
                                  device="cuda").to(dt)
                      for n in (sk, sk, sq))
        kw = dict(causal=causal, window=window, softcap=cap)
        out, lse = _forward_with_lse(q, k, v, causal, window, cap)

        def kern():
            return flash_attention_bwd(q, k, v, out, lse, dout, **kw)

        def plain():
            return flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)

        grads, want = kern(), plain()
        torch.cuda.synchronize()
        err, rel, ok = flash_bwd_close(grads, want, dtype)
        f64 = ""
        if dtype == "float32":
            # the same function in float64 on the same inputs and residuals
            exact = flash_attention_bwd_ref(
                *(t.double() for t in (q, k, v, out, lse, dout)), **kw)
            f64 = (f"; against float64 (share of scale): kernel "
                   f"{worst_share(grads, exact):.3e}, plain "
                   f"{worst_share(want, exact):.3e}")
            del exact
        log("train", f"flash_attention_bwd {name}: B={b} H={h} Sq={sq} "
            f"Sk={sk} D={d} causal={causal} window={window} softcap={cap} "
            f"q x{q_scale:g} {dtype}; dq, dk, dv max_abs_err={err:.3e}, "
            f"{rel:.3e} of the worst gradient's scale (tol "
            f"{FLASH_BWD_TOL[dtype]:g}){f64}; {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention_bwd {name} disagrees "
                                 f"with its plain version")
        if sq > sk and causal and bool(grads[0][:, :, :sq - sk].any()):
            raise AssertionError(f"flash_attention_bwd {name}: rows that "
                                 f"see no key have a gradient")
        check_bwd_planted_faults(name, q, k, v, out, lse, dout, grads, want,
                                 **kw, dtype=dtype)
        again = kern()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b_) for a, b_ in zip(again, grads)):
            raise AssertionError(f"flash_attention_bwd {name} is not "
                                 f"bitwise stable across runs")
        log("train", f"flash_attention_bwd {name}: bitwise equal across 2 "
            f"runs")
        library = None
        if lib is not None:
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            mask = visible(sq, sk, causal=causal, window=window,
                           device="cuda") if lib == "sdpa_mask" else None
            try:
                sdpa_out = torch.nn.functional.scaled_dot_product_attention(
                    *leaves, attn_mask=mask, is_causal=mask is None)
                torch.autograd.grad(sdpa_out, leaves, dout,
                                    retain_graph=True)
                torch.cuda.synchronize()

                def library():
                    return torch.autograd.grad(sdpa_out, leaves, dout,
                                               retain_graph=True)
            except RuntimeError as exc:
                log("train", f"flash_attention_bwd {name}: SDPA refused "
                    f"the shape ({str(exc).splitlines()[0][:200]})")
        bound = flash_bwd_bound(b, h, sq, sk, d, causal, window, dtype)
        rows[name] = timed_row(
            card, "train", f"flash_attention_bwd {name}", kern, plain,
            bound, err=err, rel=rel, library=library,
            library_txt=SDPA_BWD_TXT.get(lib, ""), reps=5, inner=3)
        rows[name]["fma_bound_ms"] = log_fma_bound(
            "train", f"flash_attention_bwd {name}", bound, dtype)
        # the forward kernel as training calls it (writing lse) and as
        # serving calls it (not), in turns
        fwd = {"serving": lambda: _launch(q, k, v, **kw),
               "with_lse": lambda: _launch(q, k, v, **kw, lse=lse)}
        times = {key: [] for key in fwd}
        for key in ("serving", "with_lse", "with_lse", "serving"):
            times[key].append(time_ms(fwd[key], reps=5, inner=5)[0])
        rows[name].update(fwd_ms=min(times["serving"]),
                          fwd_lse_ms=min(times["with_lse"]))
        log("train", f"flash_attention {name}: forward "
            f"{rows[name]['fwd_ms'] * 1e3:.2f} us as serving calls it, "
            f"{rows[name]['fwd_lse_ms'] * 1e3:.2f} us writing lse (least of "
            f"two, in turns; on {card})")
        del q, k, v, dout, out, lse, grads, want, again
        library = None
        torch.cuda.empty_cache()
    return rows, report


def train_launches(cfg) -> dict:
    """The kernel launches of one ``lm_loss`` forward and backward of
    ``cfg``'s stack, by kernel: each attention layer's forward once, again
    in its remat recompute, and its backward's two launches; each MoE
    layer's dispatch / combine (two mp_scatter, one gather_rows) in the
    forward and once more in the recompute (the layer's remat, the token
    group's own, or both: PyTorch's nested checkpoint recomputes the inner
    one within the outer's recompute, where the reference recomputes it a
    third time), and its backward: a gather_rows for each mp_scatter, an
    mp_scatter for the gather_rows."""
    from repro_torch.nn.transformer import stack_pattern
    sd = stack_pattern(cfg)
    kinds = sd.group * sd.num_groups + sd.remainder
    attn = sum(k in ("attn", "local") for k in kinds)
    moe = attn if cfg.num_experts else 0
    sets = 1 + int(cfg.remat or cfg.moe_inner_remat)
    want = {"flash_attention": attn * (1 + int(cfg.remat)),
            "flash_attention_bwd": 2 * attn,
            "mp_scatter": moe * (2 * sets + 1),
            "gather_rows": moe * (sets + 2)}
    return {k: v for k, v in want.items() if v}


TRAIN_LAUNCHES_TXT = ("per attention layer one flash_attention forward "
                      "(with lse) and one more in the remat recompute, two "
                      "flash_attention_bwd launches (dQ with delta, dK/dV); "
                      "per MoE "
                      "layer two mp_scatter and one gather_rows in the "
                      "forward and in its recompute, then a "
                      "gather_rows per mp_scatter and an mp_scatter per "
                      "gather_rows in the backward")


def token_batch(cfg, batch: int, seq: int, step: int = 0):
    """``synth_batch`` (seed 0) on the card."""
    import torch
    from repro_torch.data.tokens import TokenDataConfig, synth_batch
    data = synth_batch(TokenDataConfig(cfg.vocab_size, seq, batch), step)
    return {k: torch.from_numpy(v).cuda() for k, v in data.items()}


def train_grad_check(card: str, arch: str, depth: int, batch: int,
                     seq: int) -> dict:
    """``arch`` at full width, ``depth`` layers, float32 (TF32 off), seed-0
    weights: ``lm_loss`` and every parameter's gradient through the
    kernels (counts from 0) against the same through their plain versions,
    within ``TRAIN_F32_TOL``; the MoE's routing compared."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import tree_leaves
    cfg = ARCHS[arch].replace(num_layers=depth, dtype=torch.float32)
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    data = token_batch(cfg, batch, seq)
    label = f"{arch} width, depth {depth}, float32, B={batch} S={seq}"

    def step():
        loss, _ = lm.lm_loss(params, data, cfg)
        return loss.detach(), torch.autograd.grad(loss, leaves)
    with moe_taps() as kernel_taps:
        (loss, grads), launches = counted(step)
    check_launches("train", f"{label}: lm_loss forward and backward",
                   launches, train_launches(cfg), TRAIN_LAUNCHES_TXT)
    with moe_taps() as plain_taps:
        loss_p, grads_p = plain_kernels(step)
    torch.cuda.synchronize()
    rel_loss = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    worst, worst_at = 0.0, None
    for i, (a, b) in enumerate(zip(grads, grads_p)):
        rel = float((a - b).abs().max()) / max(1e-30, float(b.abs().max()))
        if rel > worst:
            worst, worst_at = rel, i
    ok = (rel_loss <= TRAIN_F32_TOL and worst <= TRAIN_F32_TOL
          and all(bool(torch.isfinite(g).all()) for g in grads))
    out = {"loss": float(loss), "loss_rel_err": rel_loss,
           "grad_rel_err": worst, "launches": launches,
           "leaves": len(leaves)}
    if cfg.num_experts:
        moved = sum(int((a != b).sum()) for a, b in
                    zip(kernel_taps["slot"], plain_taps["slot"]))
        total = sum(int(a.numel()) for a in kernel_taps["slot"])
        log("train", f"{label}: routing: {moved} of {total} assignments' "
            f"slots differ between the kernel and the plain path")
        out.update(slots_moved=moved, assignments=total)
        ok &= moved == 0
    log("train", f"{label}: loss {float(loss):.6f} (plain {float(loss_p):.6f}"
        f", {rel_loss:.2e} apart); {len(leaves)} parameter gradients, the "
        f"worst {worst:.2e} of its scale (leaf {worst_at}); tol "
        f"{TRAIN_F32_TOL:g}; {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the kernels' gradients disagree "
                             f"with the plain path's")
    del params, leaves, grads, grads_p
    torch.cuda.empty_cache()
    return out


def train_run(card: str) -> dict:
    """The ``Trainer`` on qwen1.5-0.5b at full width and depth (bf16 params,
    AdamW, per-layer remat), ``TRAIN_STEPS`` steps of B x S synth tokens,
    counts from 0: step ms (median, p90), tokens/s, peak memory, the first
    and last losses (the last must be lower), launches per step against
    the layers; then one more step under ``torch.profiler``: the card's
    busy share and top ops."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.optimizers import tree_leaves
    cfg = ARCHS[TRAIN_ARCH]
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=5,
                       total_steps=TRAIN_STEPS, checkpoint_every=0, seed=0)
    tr = Trainer(cfg, tcfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                 device="cuda")
    tr.init_state()
    n_params = sum(p.numel() for p in tree_leaves(tr.params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run, launches = counted(lambda: tr.run(TRAIN_STEPS, log_every=5))
    peak = torch.cuda.max_memory_allocated()
    label = (f"{TRAIN_ARCH} full width and depth ({cfg.num_layers} layers, "
             f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
             f"{n_params / 1e6:.1f}M params, bf16, AdamW, remat), "
             f"B={TRAIN_BATCH} S={TRAIN_SEQ}")
    per_step = train_launches(cfg)
    check_launches("train", f"{label}: {TRAIN_STEPS} steps", launches,
                   {k: TRAIN_STEPS * v for k, v in per_step.items()},
                   f"{TRAIN_STEPS} x ({TRAIN_LAUNCHES_TXT})")
    losses = run["losses"]
    steps_ms = [s * 1e3 for s in run["step_s"]]
    # the first step carries the first calls' set-up (cuBLAS handles,
    # the kernels' loads): the steady steps are the rest
    steady = sorted(s * 1e3 for s in run["step_s"][1:])
    med = statistics.median(steady)
    p90 = steady[min(len(steady) - 1, int(0.9 * len(steady)))]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"steps": TRAIN_STEPS, "losses": losses, "first_loss": losses[0],
           "last_loss": losses[-1], "step_ms_median": med,
           "step_ms_p90": p90, "first_step_ms": run["step_s"][0] * 1e3,
           "tokens_per_s": tokens / (med / 1e3), "peak_mem_gb": peak / 1e9,
           "launches": launches, "launches_per_step": per_step,
           "params": n_params, "straggler_events": run["straggler_events"]}
    log("train", f"{label}: step {med:.1f} ms median, {p90:.1f} ms p90 over "
        f"steps 2-{TRAIN_STEPS} (the first {out['first_step_ms']:.1f} ms); "
        f"{out['tokens_per_s']:.0f} tokens/s; peak memory "
        f"{peak / 1e9:.2f} GB; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"all step ms {[round(s, 1) for s in steps_ms]}; on {card}")
    if not losses[-1] < losses[0] or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: the loss did not fall "
                             f"({losses[0]} -> {losses[-1]})")
    data = token_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, step=TRAIN_STEPS)
    _, on_device, wall = profiled(
        lambda: tr.step_fn(tr.params, tr.opt_state, data))
    busy_us = sum(t for t, _ in on_device.values())
    out.update(profiled_step_ms=wall * 1e3, busy_ms=busy_us / 1e3,
               busy_share=busy_us / (wall * 1e6),
               top_device=top(on_device, 10))
    log("train", f"{label}: one step under torch.profiler: {wall * 1e3:.1f} "
        f"ms wall, the card busy {busy_us / 1e3:.1f} ms "
        f"({out['busy_share']:.1%}); on {card}")
    for row in out["top_device"]:
        log("train", f"  device {row['us']:10.1f} us x{row['count']:<5} "
            f"{row['name']}")
    del tr
    torch.cuda.empty_cache()
    return out


def train_phase(card: str) -> dict:
    """Phase 10: the backward kernel against its plain version, the
    depth-2 float32 gradients of qwen1.5-0.5b and olmoe-1b-7b through the
    kernels against their plain versions, then the training run. Returns
    {"rows": the backward's cases, "build": its instantiations, "paths":
    each run's record with its launches}."""
    rows, build_report = flash_bwd_phase(card)
    paths = {f"train_grads_{arch}": train_grad_check(card, arch, depth, b,
                                                     s)
             for arch, depth, b, s in TRAIN_CHECK}
    paths[f"train_{TRAIN_ARCH}"] = train_run(card)
    return {"rows": rows, "build": build_report, "paths": paths}


# ---------------------------------------------------------------------------
# phase 11: the mesh
# ---------------------------------------------------------------------------

# the GPipe case: qwen1.5-0.5b's blocks as this many stages over a ring of
# as many positions, this many microbatches of one sequence each
MESH_ARCH = "qwen1.5-0.5b"
MESH_STAGES, MESH_MICRO, MESH_SEQ = 4, 8, 2048
# the data-parallel run: a global batch of B x S over a (K, 1) mesh
MESH_DP_K, MESH_DP_BATCH, MESH_DP_STEPS = 2, 8, 5
# the DP run's per-step loss against the one-position Trainer's: the
# reference's tolerance for a sharded step (tests/test_distributed.py:56)
MESH_LOSS_TOL = 2e-2
# the depth-2 float32 DP gradients against the unsharded ones: float32
# sums over the shards in another order
MESH_GRAD_TOL = 1e-5
MESH_CKPT = REPO / "build" / "repro_torch" / "mesh_checkpoint"


def mesh_devices(k: int) -> list:
    """Positions for a mesh of ``k``: all on the card, or spread over the
    cards round-robin where there are several."""
    import torch
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(k)]


def wall_ms(run, reps: int = 3, warm: bool = True) -> tuple:
    """(median wall ms of ``run()`` between two device synchronisations,
    over ``reps`` after one warm-up call unless ``warm`` is off; the last
    result)."""
    import torch
    out = run() if warm else None
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def mesh_collectives(card: str) -> dict:
    """(a) On a (4,) ring of positions: ``ring_shift`` for every step count
    (``torch.roll`` of the parts), ``broadcast_from`` every source, and
    ``psum`` / ``pmax`` bitwise against the fold in position order on one
    stream, at 4 x 16 MB float32."""
    import torch
    from repro_torch.distributed.collectives import pmax, psum, shard_map
    from repro_torch.distributed.pipeline import broadcast_from, ring_shift
    from repro_torch.distributed.sharding import P, make_mesh
    mesh = make_mesh((4,), ("ring",), devices=mesh_devices(4))
    streams = {id(s) for s in mesh.streams.flat}
    if len(streams) != 4 or None in list(mesh.streams.flat):
        raise AssertionError("the positions do not each have a stream")
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((4, 2048, 2048), generator=gen, device="cuda")

    def run(f, out_spec=P("ring")):
        return shard_map(f, mesh=mesh, in_specs=(P("ring"),),
                         out_specs=out_spec)(x)
    out = {}
    for s in range(1, 4):
        got = run(lambda v: ring_shift(v, "ring", steps=s)).gather("cuda")
        out[f"ring_shift_{s}"] = bool(torch.equal(got, torch.roll(x, s, 0)))
    for src in range(4):
        got = run(lambda v: broadcast_from(v, "ring", src))
        out[f"broadcast_from_{src}"] = all(
            torch.equal(t.to("cuda")[0], x[src]) for t in got.pieces.flat)
    want_sum = ((x[0] + x[1]) + x[2]) + x[3]
    want_max = torch.maximum(torch.maximum(torch.maximum(x[0], x[1]), x[2]),
                             x[3])
    got = run(lambda v: psum(v, "ring"), P())
    out["psum"] = all(torch.equal(t.to("cuda")[0], want_sum)
                      for t in got.pieces.flat)
    got = run(lambda v: pmax(v, "ring"), P())
    out["pmax"] = all(torch.equal(t.to("cuda")[0], want_max)
                      for t in got.pieces.flat)
    psum_ms, _ = wall_ms(lambda: run(lambda v: psum(v, "ring"), P()))
    log("mesh", f"(a) collectives on a (4,) ring over "
        f"{sorted({str(d) for d in mesh.devices.flat})}, each position on "
        f"its own stream, 4 x {x[0].numel() * 4 / 1e6:.1f} MB float32: "
        f"{out}; psum wall {psum_ms:.2f} ms; on {card}")
    if not all(out.values()):
        raise AssertionError("(a) a collective is not bitwise its reference")
    return {"checks": out, "psum_wall_ms": psum_ms}


def mesh_gpipe(card: str) -> dict:
    """(b) qwen1.5-0.5b's blocks (bf16, seed-0 weights) as MESH_STAGES
    stages of equal depth over a ring of as many positions, MESH_MICRO
    microbatches of 1 x MESH_SEQ synth tokens' embeddings, counts from 0,
    against the same blocks run in sequence on one stream."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import make_mesh, map_tree
    from repro_torch.models import lm
    from repro_torch.nn.transformer import stack_pattern
    cfg = ARCHS[MESH_ARCH]
    sd = stack_pattern(cfg)
    if sd.group != ("attn",) or sd.remainder:
        raise AssertionError(f"{MESH_ARCH}: expected one stacked attn group")
    depth = sd.num_groups // MESH_STAGES
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
    stacked = params["stack"]["groups"][0]
    stage_params = map_tree(lambda v: v.reshape(
        (MESH_STAGES, depth) + tuple(v.shape[1:])), stacked)
    tokens = token_batch(cfg, MESH_MICRO, MESH_SEQ)["tokens"]
    positions = torch.arange(MESH_SEQ, dtype=torch.int32,
                             device="cuda").expand(1, MESH_SEQ)
    with torch.inference_mode():
        xs = lm._embed(params, tokens, cfg, None)[:, None]

    def stage_fn(p, x):
        return run_blocks(p, x, depth, positions.to(x.device), cfg)

    mesh = make_mesh((MESH_STAGES,), ("pod",),
                     devices=mesh_devices(MESH_STAGES))

    def piped():
        with torch.inference_mode():
            return pipeline_apply(stage_fn, stage_params, xs, mesh=mesh,
                                  axis_name="pod")

    def sequential():
        with torch.inference_mode():
            return torch.stack([run_blocks(stacked, xs[m], sd.num_groups,
                                           positions, cfg)
                                for m in range(MESH_MICRO)])
    out, launches = counted(piped)           # also the warm-up run
    steps = MESH_MICRO + MESH_STAGES - 1
    check_launches("mesh", f"(b) GPipe {MESH_STAGES} stages x {depth} "
                   f"blocks, {MESH_MICRO} microbatches", launches,
                   {"flash_attention": MESH_STAGES * steps * depth},
                   f"{MESH_STAGES} stages x ({MESH_MICRO} + "
                   f"{MESH_STAGES - 1}) steps x {depth} attention layers: "
                   f"every stage runs at every step, bubbles included")
    ref = sequential()
    got = out.gather("cuda")
    err, rel, ok = close(got.float(), ref.float(), rtol=0.0,
                         atol_of_scale=LM_BF16_TOL)
    pieces_equal = all(torch.equal(t.to("cuda"), got)
                       for t in out.pieces.flat)
    pipe_ms, _ = wall_ms(piped, reps=1, warm=False)
    seq_ms, _ = wall_ms(sequential, reps=1)
    _, pipe_dev, pipe_wall = profiled(piped)
    _, seq_dev, seq_wall = profiled(sequential)
    res = {"stages": MESH_STAGES, "blocks_per_stage": depth,
           "microbatches": MESH_MICRO, "seq": MESH_SEQ,
           "launches": launches, "max_abs_err": err, "rel_err": rel,
           "bitwise_sequential": bool(torch.equal(got, ref)),
           "replicated_outputs_equal": pieces_equal,
           "gpipe_ms": pipe_ms, "sequential_ms": seq_ms,
           "gpipe_profiled": {"wall_ms": pipe_wall * 1e3,
                              "busy_ms": sum(t for t, _ in
                                             pipe_dev.values()) / 1e3,
                              "top_device": top(pipe_dev, 6)},
           "sequential_profiled": {"wall_ms": seq_wall * 1e3,
                                   "busy_ms": sum(t for t, _ in
                                                  seq_dev.values()) / 1e3}}
    log("mesh", f"(b) GPipe {MESH_ARCH}: {res}; on {card}")
    if not ok or not pieces_equal:
        raise AssertionError("(b) the pipeline's outputs disagree with the "
                             "sequential stack's, or between the stages")
    del params, stacked, stage_params, out, ref, got
    torch.cuda.empty_cache()
    return res


def run_blocks(stacked, x, layers, positions, cfg):
    """The first ``layers`` attention blocks of a stacked group on ``x``."""
    from repro_torch.nn.transformer import _layer, block_apply
    for i in range(layers):
        x, _, _ = block_apply(_layer(stacked, i), x, positions, cfg, "attn")
    return x


def mesh_grad_check(card: str, arch: str, depth: int, batch: int,
                    seq: int) -> dict:
    """(c) first: ``arch`` at full width, ``depth`` layers, float32, the DP
    step on a (MESH_DP_K, 1) mesh against the unsharded step from the same
    seed-0 state: one step at learning rate 0 (the parameters untouched,
    AdamW's m = (1 - b1) g), every gradient within MESH_GRAD_TOL of the
    gradients' scale, the loss beside; the replicas bitwise equal."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed.sharding import (NamedSharding, P,
                                                  device_put,
                                                  zeros_like_defs)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_rules, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import get_optimizer, tree_leaves
    cfg = ARCHS[arch].replace(num_layers=depth, dtype=torch.float32)
    tcfg = TrainConfig(learning_rate=0.0, warmup_steps=1, total_steps=10,
                       grad_clip=1e9)
    data = token_batch(cfg, batch, seq)
    mesh = make_host_mesh(MESH_DP_K, 1, devices=mesh_devices(MESH_DP_K))
    label = (f"{arch} width, depth {depth}, float32, B={batch} S={seq}, "
             f"({MESH_DP_K}, 1) mesh")

    def fresh():
        params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                                cfg, "cuda")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        odefs = get_optimizer(cfg.optimizer).state_defs(lm.lm_param_defs(cfg))
        return params, zeros_like_defs(odefs, "cuda")
    def on_mesh():
        replicated = NamedSharding(mesh, P())
        return tuple(device_put(t, replicated) for t in fresh())
    one = make_train_step(cfg, tcfg)
    (_, o1, m1), base = counted(lambda: one(*fresh(), data))
    g1 = [t.detach() for t in tree_leaves(o1["m"])]     # (1 - b1) g
    del _, o1
    torch.cuda.empty_cache()
    dp = make_train_step(cfg, tcfg, build_rules(cfg, mesh, "train", batch),
                         mesh)
    (p2, o2, m2), launches = counted(lambda: dp(*on_mesh(), data))
    check_launches("mesh", f"(c) {label}: one DP step", launches,
                   {k: MESH_DP_K * v for k, v in train_launches(cfg).items()},
                   f"each of {MESH_DP_K} positions one forward and backward "
                   f"({TRAIN_LAUNCHES_TXT})")
    g2 = [t.gather("cuda").detach() for t in tree_leaves(o2["m"])]
    scale = max(float(g.abs().max()) for g in g1)
    worst = max(float((a - b).abs().max()) for a, b in zip(g1, g2)) / scale
    rel_loss = abs(float(m1["loss"]) - float(m2["loss"])) / abs(
        float(m1["loss"]))
    replicas = all(torch.equal(t, leaf.pieces.flat[0].to(t.device))
                   for leaf in tree_leaves(o2) for t in leaf.pieces.flat)
    ok = worst <= MESH_GRAD_TOL and rel_loss <= MESH_GRAD_TOL and replicas
    log("mesh", f"(c) {label}: loss {float(m2['loss']):.6f} (unsharded "
        f"{float(m1['loss']):.6f}, {rel_loss:.2e} apart); gradients worst "
        f"{worst:.2e} of their scale (tol {MESH_GRAD_TOL:g}); replicas "
        f"bitwise {replicas}; {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"(c) {label}: the DP step disagrees with the "
                             f"unsharded step")
    del o2, p2, g1, g2
    torch.cuda.empty_cache()
    return {"loss_rel_err": rel_loss, "grad_rel_err": worst,
            "launches": launches, "unsharded_launches": base}


def mesh_train_run(card: str, k: int) -> tuple:
    """(c) The Trainer on qwen1.5-0.5b at full width and depth (bf16, AdamW,
    per-layer remat), MESH_DP_STEPS steps of MESH_DP_BATCH x TRAIN_SEQ
    synth tokens, one ``run(1)`` a step with the counts from 0: on one
    position (k = 1, no mesh) or on a (k, 1) mesh. Returns (its record,
    the Trainer)."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.optimizers import tree_leaves
    cfg = ARCHS[MESH_ARCH]
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=5,
                       total_steps=MESH_DP_STEPS, checkpoint_every=0, seed=0)
    mesh = (None if k == 1 else
            make_host_mesh(k, 1, devices=mesh_devices(k)))
    tr = Trainer(cfg, tcfg, global_batch=MESH_DP_BATCH, seq_len=TRAIN_SEQ,
                 mesh=mesh, device="cuda")
    tr.init_state()
    per_step = train_launches(cfg)
    losses, step_ms, replicas = [], [], []
    for i in range(MESH_DP_STEPS):
        run, launches = counted(lambda: tr.run(1, log_every=1000))
        losses += run["losses"]
        step_ms += [s * 1e3 for s in run["step_s"]]
        check_launches("mesh", f"(c) {MESH_ARCH} K={k} step {i + 1}",
                       launches, {n: k * v for n, v in per_step.items()},
                       f"{k} position(s) x ({TRAIN_LAUNCHES_TXT})")
        if mesh is not None:
            replicas.append(all(
                torch.equal(t.to(leaf.pieces.flat[0].device),
                            leaf.pieces.flat[0])
                for leaf in tree_leaves({"p": tr.params, "o": tr.opt_state})
                for t in leaf.pieces.flat))
    steady = sorted(step_ms[1:])
    med = statistics.median(steady)
    data = token_batch(cfg, MESH_DP_BATCH, TRAIN_SEQ, step=MESH_DP_STEPS)
    _, on_device, wall = profiled(
        lambda: tr.step_fn(tr.params, tr.opt_state, data))
    busy_ms = sum(t for t, _ in on_device.values()) / 1e3
    rec = {"k": k, "losses": losses, "step_ms": step_ms,
           "step_ms_median": med,
           "tokens_per_s": MESH_DP_BATCH * TRAIN_SEQ / (med / 1e3),
           "launches_per_step": {n: k * v for n, v in per_step.items()},
           "profiled_step_ms": wall * 1e3, "busy_ms": busy_ms,
           "busy_share": busy_ms / (wall * 1e3)}
    if mesh is not None:
        rec["replicas_bitwise_each_step"] = replicas
    log("mesh", f"(c) {MESH_ARCH} full width and depth, bf16, AdamW, remat, "
        f"B={MESH_DP_BATCH} S={TRAIN_SEQ}, K={k}: losses "
        f"{[round(x, 5) for x in losses]}; step ms "
        f"{[round(x, 1) for x in step_ms]} (median of steps 2-"
        f"{MESH_DP_STEPS}: {med:.1f}); {rec['tokens_per_s']:.0f} tokens/s; "
        f"one more step under torch.profiler {wall * 1e3:.1f} ms, the card "
        f"busy {busy_ms:.1f} ms ({rec['busy_share']:.1%})"
        f"{'; replicas bitwise after each step ' + str(replicas) if replicas else ''}"
        f"; on {card}")
    if replicas and not all(replicas):
        raise AssertionError("(c) the DP replicas drifted apart")
    return rec, tr


def mesh_compression(card: str, tr) -> dict:
    """(d) ``tree_ef_compressed_psum`` of qwen1.5-0.5b's gradient tree (each
    position's local gradient of its half of a synth batch, from the DP
    Trainer's state) against the plain ``psum``: each leaf within its
    quantisation bound, K x s_max / 2 an element for the rounding, plus the
    pmax-of-scales term the reference keeps (sum over positions of |x_i| x
    (s_max / s_i - 1)); wall time of each reduction. Then the reference's
    least-squares convergence case on a (4,) mesh (200 steps, loss <
    1e-3)."""
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.distributed.collectives import psum, shard_map
    from repro_torch.distributed.sharding import P, make_mesh
    from repro_torch.models import lm
    from repro_torch.optim.compression import (ef_compressed_psum,
                                               quantize_int8,
                                               tree_ef_compressed_psum)
    from repro_torch.optim.optimizers import tree_leaves
    mesh, cfg = tr.mesh, tr.cfg
    data = token_batch(cfg, MESH_DP_BATCH, TRAIN_SEQ, step=MESH_DP_STEPS)

    def local_grads(params, batch):
        # a position's remat is recomputed by collectives.grad in its own
        # thread (torch.autograd.grad stops at the remat's cuts)
        leaves = tree_leaves(params)
        loss, _ = lm.lm_loss(params, batch, cfg)
        return [g.float()[None] for g in collectives.grad(loss, leaves)]
    grads = shard_map(local_grads, mesh=mesh, in_specs=(P(), P("data")),
                      out_specs=P("data"))(tr.params, data)

    def plain(gs):
        return [x[None] for x in psum([g[0] for g in gs], "data")]

    def compressed(gs):
        errs = [torch.zeros_like(g[0]) for g in gs]
        red, _ = tree_ef_compressed_psum([g[0] for g in gs], errs, "data")
        return [x[None] for x in red]
    run_plain = shard_map(plain, mesh=mesh, in_specs=(P("data"),),
                          out_specs=P("data"))
    run_comp = shard_map(compressed, mesh=mesh, in_specs=(P("data"),),
                         out_specs=P("data"))
    plain_ms, want = wall_ms(lambda: run_plain(grads))
    comp_ms, got = wall_ms(lambda: run_comp(grads))
    k, leaves = mesh.size, len(want)
    worst_share, pmax_share, nbytes = 0.0, 0.0, 0
    eps = torch.finfo(torch.float32).eps
    for g, w, r in zip(grads, want, got):
        xs = [t[0].to("cuda") for t in g.pieces.flat]
        scales = [quantize_int8(x)[1].double() for x in xs]
        s_max = torch.stack(scales).max()
        pmax_term = sum(x.double().abs() * (s_max / s - 1) for x, s in
                        zip(xs, scales))
        r = r.pieces.flat[0][0].to("cuda").double()
        w = w.pieces.flat[0][0].to("cuda").double()
        # the bound, in float64, plus the float32 roundings of the plain
        # sum (k of them) and of the rescaling product (one)
        bound = (k * s_max / 2 + pmax_term
                 + (k + 1) * eps * (r.abs() + w.abs()))
        share = float(((r - w).abs() / bound.clamp(min=1e-300)).max())
        worst_share = max(worst_share, share)
        pmax_share = max(pmax_share, float((pmax_term / bound).max()))
        nbytes += xs[0].numel() * 4
    del grads, want, got
    torch.cuda.empty_cache()
    # the reference's convergence case
    ring = make_mesh((4,), ("pod",), devices=mesh_devices(4))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((64, 8), generator=gen, device="cuda")
    y = x @ torch.randn(8, generator=gen, device="cuda")

    def local(w, err, xb, yb):
        w = w.detach().requires_grad_()
        g, = torch.autograd.grad(torch.mean((xb @ w - yb) ** 2), w)
        g_sum, e2 = ef_compressed_psum(g, err[0], "pod")
        return (w - 0.05 * g_sum / 4).detach(), e2[None]
    step = shard_map(local, mesh=ring,
                     in_specs=(P(), P("pod"), P("pod"), P("pod")),
                     out_specs=(P(), P("pod")))
    w, err = torch.zeros(8, device="cuda"), torch.zeros(4, 8, device="cuda")
    t0 = time.perf_counter()
    for _ in range(200):
        w, err = step(w, err, x, y)
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    final = float(torch.mean((x @ w.gather("cuda") - y) ** 2))
    res = {"leaves": leaves, "grad_bytes": nbytes,
           "worst_share_of_bound": worst_share,
           "pmax_term_share_of_bound": pmax_share,
           "psum_ms": plain_ms, "compressed_psum_ms": comp_ms,
           "convergence_loss": final, "convergence_s": conv_s}
    log("mesh", f"(d) tree_ef_compressed_psum of {MESH_ARCH}'s gradients "
        f"({nbytes / 1e9:.2f} GB float32 a position) over {k} positions: "
        f"worst error {worst_share:.3f} of its bound (the pmax-of-scales "
        f"term up to {pmax_share:.3f} of it); wall {comp_ms:.1f} ms against "
        f"the plain psum's {plain_ms:.1f} ms; least squares on a (4,) mesh: "
        f"loss {final:.2e} after 200 steps ({conv_s:.2f} s); on {card}")
    if not worst_share <= 1.0 or not final < 1e-3:
        raise AssertionError("(d) the compressed reduction is out of bounds "
                             "or does not converge")
    return res


def mesh_elastic(card: str, tr) -> dict:
    """(e) The DP Trainer's parameters and AdamW state saved (one unsharded
    copy, position 0's) and restored through ``elastic_restore`` onto
    (1, 1) and (4, 1) meshes: every position's piece bitwise the saved
    leaf; ``remesh_plan`` of llama3-8b's full definitions on the
    production mesh (meta positions) without error, and an indivisible
    case's ValueError with the reference's message."""
    import shutil
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs.archs import ARCHS
    from repro_torch.distributed.elastic import elastic_restore, remesh_plan
    from repro_torch.distributed.sharding import ParamDef, make_rules, map_defs
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.launch.steps import build_rules
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import tree_leaves
    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    state = {"params": tr.params, "opt": tr.opt_state}
    t0 = time.perf_counter()
    ckpt.save(MESH_CKPT, tr.step, state, keep_n=1)
    save_s = time.perf_counter() - t0
    saved = [leaf.pieces.flat[0] for leaf in tree_leaves(state)]
    defs = {"params": tr.pdefs, "opt": tr.odefs}
    like = map_defs(lambda d: torch.empty(0), defs)
    out = {"save_s": save_s,
           "bytes": sum(t.numel() * t.element_size() for t in saved)}
    for shape in ((1, 1), (4, 1)):
        mesh = make_host_mesh(*shape, devices=mesh_devices(shape[0]))
        rules = build_rules(tr.cfg, mesh, "train", MESH_DP_BATCH)
        t0 = time.perf_counter()
        step, restored, _ = elastic_restore(MESH_CKPT, defs, rules, mesh,
                                            like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = step == tr.step and all(
            torch.equal(p.to(s.device), s)
            for s, leaf in zip(saved, tree_leaves(restored))
            for p in leaf.pieces.flat)
        out[f"{shape[0]}x{shape[1]}"] = {"bitwise": same,
                                         "restore_s": restore_s}
        del restored
        torch.cuda.empty_cache()
    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    prod = make_production_mesh()
    llama = ARCHS["llama3-8b"]
    plan = remesh_plan(lm.lm_param_defs(llama),
                       build_rules(llama, prod, "train"), prod)
    out["llama3_8b_production_plan_leaves"] = len(tree_leaves(plan))
    try:
        remesh_plan({"w": ParamDef((6, 5), ("embed", "heads"))},
                    make_rules(), prod)
        out["indivisible_message"] = None
    except ValueError as e:
        out["indivisible_message"] = str(e)
    want = ("cannot remesh: dim 5 of (6, 5) not divisible by axis product "
            "16 (('model',)) on mesh {'data': np.int64(16), 'model': "
            "np.int64(16)}")
    log("mesh", f"(e) elastic: {out}; on {card}")
    if (not out["1x1"]["bitwise"] or not out["4x1"]["bitwise"]
            or out["indivisible_message"] != want):
        raise AssertionError("(e) the elastic restore or the plan failed")
    return out


def mesh_phase(card: str) -> dict:
    """Phase 11: (a) the collectives, (b) GPipe, (c) data-parallel training
    (the depth-2 float32 gradient checks, then K=1 and K=MESH_DP_K), (d)
    compression, (e) elastic restore. Returns the ``[mesh] json`` record;
    its ``paths`` hold each run's launches."""
    import torch
    out = {"card": card, "device_count": torch.cuda.device_count(),
           "seconds": {}}
    t0 = time.perf_counter()

    def lap(part):
        nonlocal t0
        out["seconds"][part] = time.perf_counter() - t0
        t0 = time.perf_counter()
    out["collectives"] = mesh_collectives(card)
    lap("a")
    out["gpipe"] = mesh_gpipe(card)
    lap("b")
    out["dp_grads"] = {arch: mesh_grad_check(card, arch, depth, b, s)
                       for arch, depth, b, s in TRAIN_CHECK}
    lap("c_grads")
    one, tr = mesh_train_run(card, 1)
    del tr
    torch.cuda.empty_cache()
    lap("c_k1")
    dp, tr = mesh_train_run(card, MESH_DP_K)
    lap(f"c_k{MESH_DP_K}")
    dp["loss_abs_diff_vs_k1"] = [abs(a - b) for a, b in
                                 zip(dp["losses"], one["losses"])]
    out["dp_train"] = {"k1": one, f"k{MESH_DP_K}": dp}
    log("mesh", f"(c) K={MESH_DP_K} against K=1 per step: "
        f"{dp['loss_abs_diff_vs_k1']} (tol {MESH_LOSS_TOL:g})")
    if max(dp["loss_abs_diff_vs_k1"]) >= MESH_LOSS_TOL:
        raise AssertionError("(c) the DP losses left the one-position run's")
    out["compression"] = mesh_compression(card, tr)
    lap("d")
    out["elastic"] = mesh_elastic(card, tr)
    del tr
    torch.cuda.empty_cache()
    lap("e")
    log("mesh", f"seconds by part: {out['seconds']}")
    out["paths"] = {
        "mesh_gpipe": {"launches": out["gpipe"]["launches"]},
        f"mesh_dp_{MESH_ARCH}": {"launches": {
            n: MESH_DP_STEPS * v
            for n, v in dp["launches_per_step"].items()}}}
    return out


# ---------------------------------------------------------------------------
# phase 12: model-parallel serving
# ---------------------------------------------------------------------------

# (data, model) positions of the phase, all on the card (spread over the
# cards where there are several)
MP_SHAPE = (1, 2)
# the depth-2 float32 checks (TF32 off) against the unsharded steps on the
# same weights: float32 sums over the positions in another order, of the
# logits' scale
MP_F32_TOL = 1e-5
MP_F32_PROMPT, MP_F32_STEPS = 512, 4
# (arch, depth, config changes): llama3-8b's heads, ff and vocab split and
# its cache by KV heads; with one KV head its cache split by sequence (the
# reference's test_decode_seq_sharded_cache_matches); olmoe's banks;
# mamba2's SSD heads and state split, its mixer repeated; recurrentgemma's
# one group (rec, rec, local): the RG-LRU's width split, its local layer's
# cache by sequence
MP_F32_CASES = (("llama3-8b", 2, {}), ("llama3-8b", 2, {"num_kv_heads": 1}),
                ("olmoe-1b-7b", 2, {}), ("mamba2-2.7b", 2, {}),
                ("recurrentgemma-2b", 3, {}))
# the full-width bf16 serves on the mesh against the unsharded ones, last-
# position logits of the prefill, of the logits' scale: the row pieces'
# partial products are summed in float32 and rounded once, so what differs
# is cuBLAS's tilings at half widths and bf16 rounding carried through 32
# layers, as in phase 8's kernel-vs-plain checks (LM_BF16_TOL)
MP_BF16_TOL = LM_BF16_TOL
# the full runs, each with its part's letter
MP_ARCHS = {"llama3-8b": "b", "olmoe-1b-7b": "c", "mamba2-2.7b": "d",
            "recurrentgemma-2b": "e"}


def mp_steps(cfg, mesh=None):
    """(prefill step, decode step) of ``cfg``: on ``mesh`` the
    model-parallel steps of ``build_rules``' tables, else the unsharded
    ones."""
    from repro_torch.launch.steps import (build_rules, make_decode_step,
                                          make_prefill_step)
    if mesh is None:
        return make_prefill_step(cfg), make_decode_step(cfg)
    return (make_prefill_step(cfg, build_rules(cfg, mesh, "prefill",
                                               global_batch=LM_BATCH), mesh),
            make_decode_step(cfg, build_rules(cfg, mesh, "decode",
                                              global_batch=LM_BATCH), mesh))


def mp_cache_len(tokens: int) -> int:
    """A KV cache's rows for ``tokens``, rounded up to a multiple of the
    model axis: a model with fewer KV heads than positions splits its
    cache by sequence (recurrentgemma's one KV head), and each position
    holds an equal block. Rows past the tokens are never read."""
    k = MP_SHAPE[1]
    return -(-tokens // k) * k


def mp_placed(cfg, params, mesh):
    """``params`` on ``mesh``: each position's pieces by the prefill's
    rules (the decode's place the weights alike)."""
    from repro_torch.distributed.sharding import device_put, param_shardings
    from repro_torch.launch.steps import build_rules
    from repro_torch.models import lm
    rules = build_rules(cfg, mesh, "prefill", global_batch=LM_BATCH)
    return device_put(params, param_shardings(lm.lm_param_defs(cfg), rules,
                                              mesh))


def mp_run(cfg, params, tokens, prompt: int, steps: int, mesh=None,
           greedy: bool = False) -> dict:
    """A prefill of ``tokens[:, :prompt]`` and ``steps`` decode steps, fed
    ``tokens``' next columns or, ``greedy``, each step's argmax: each
    call's logits, the tokens fed, the caches, wall ms of the prefill and
    of the decode loop (the card synchronised)."""
    import torch
    from repro_torch.models import lm
    pre, dec = mp_steps(cfg, mesh)
    caches = lm.init_caches(cfg, LM_BATCH, mp_cache_len(prompt + steps),
                            "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = pre(params, caches, {"tokens": tokens[:, :prompt]})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, fed = [lg], []
    for i in range(steps):
        tok = (torch.argmax(lg[:, :cfg.vocab_size], -1)[:, None] if greedy
               else tokens[:, prompt + i:prompt + i + 1])
        fed.append(tok)
        lg, caches = dec(params, caches, {"token": tok,
                                          "position": prompt + i})
        logits.append(lg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"logits": logits, "fed": fed, "caches": caches,
            "prefill_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3}


def mp_on_card(mesh, out) -> None:
    """Raise unless every position is on the card and the step's logits
    came back there: no position runs on the CPU."""
    devs = {str(d) for d in mesh.devices.flat}
    if any(not d.startswith("cuda") for d in devs) or any(
            lg.device.type != "cuda" for lg in out["logits"]):
        raise AssertionError(f"a position or the logits left the card: "
                             f"{sorted(devs)}")


def mp_f32_check(card: str, arch: str, depth: int, changes: dict) -> dict:
    """(a) ``arch`` at full width, ``depth`` layers, float32 (TF32 off),
    ``changes`` applied: the prefill of MP_F32_PROMPT tokens and
    MP_F32_STEPS decode steps on MP_SHAPE against the unsharded steps on
    the same weights and tokens; every call's logits and every tensor of
    the caches within MP_F32_TOL of its scale."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.distributed.sharding import Sharded
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import tree_leaves
    cfg = ARCHS[arch].replace(num_layers=depth, dtype=torch.float32,
                              **changes)
    label = (f"(a) {arch} width, depth {depth}, float32"
             + "".join(f", {k}={v}" for k, v in changes.items())
             + f", mesh {MP_SHAPE}")
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, MP_F32_PROMPT + MP_F32_STEPS))).cuda()
    want = mp_run(cfg, params, tokens, MP_F32_PROMPT, MP_F32_STEPS)
    mesh = make_host_mesh(*MP_SHAPE, devices=mesh_devices(
        MP_SHAPE[0] * MP_SHAPE[1]))
    got = mp_run(cfg, mp_placed(cfg, params, mesh), tokens, MP_F32_PROMPT,
                 MP_F32_STEPS, mesh)
    mp_on_card(mesh, got)
    rels = []
    for i, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        _, rel, ok = close(a[:, :cfg.vocab_size].float(),
                           b[:, :cfg.vocab_size].float(), rtol=0.0,
                           atol_of_scale=MP_F32_TOL)
        rels.append(rel)
        if not ok:
            raise AssertionError(f"{label}: call {i}'s logits are "
                                 f"{rel:.3e} of the scale off")
    leaves = [(a, b) for a, b in zip(tree_leaves(got["caches"]),
                                     tree_leaves(want["caches"]))
              if isinstance(a, Sharded)]
    if not leaves:
        raise AssertionError(f"{label}: no cache tensor to compare")
    cache_rel = 0.0
    for a, b in leaves:
        _, rel, ok = close(a.gather("cuda").float(), b.float(), rtol=0.0,
                           atol_of_scale=MP_F32_TOL)
        cache_rel = max(cache_rel, rel)
        if not ok:
            raise AssertionError(f"{label}: a cache tensor {tuple(b.shape)} "
                                 f"is {rel:.3e} of the scale off")
    log("mp", f"{label}: prefill of {LM_BATCH} x {MP_F32_PROMPT} and "
        f"{MP_F32_STEPS} decode steps against the unsharded steps: logits "
        f"{max(rels):.3e} of the scale at worst, the caches' "
        f"{len(leaves)} tensors {cache_rel:.3e} (tol {MP_F32_TOL:g}); on "
        f"{card}")
    del params, got, want
    torch.cuda.empty_cache()
    return {"logits_rel_err": rels, "cache_rel_err": cache_rel}


def mp_full(card: str, arch: str) -> dict:
    """(b)-(e) ``arch`` at full width and depth in bf16, seed-0 weights,
    phase 8's traffic: the unsharded serve, then the same weights placed on
    MP_SHAPE and served again with the counts from 0 (prefill and decode
    apart), each timed after a warm run; a prefill and a decode step again
    under ``torch.profiler`` (device events by kernel, busy share); the
    prefill's last-position logits and greedy first tokens against the
    unsharded serve's."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    full = ARCHS[arch]
    k = MP_SHAPE[0] * MP_SHAPE[1]
    label = f"({MP_ARCHS[arch]}) {arch} full width and depth, bf16, mesh " \
        f"{MP_SHAPE}"
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            full, "cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, full.vocab_size, (LM_BATCH, LM_PROMPT))).cuda()
    steps = LM_GEN - 1

    def serve(p, mesh=None):
        return mp_run(full, p, tokens, LM_PROMPT, steps, mesh, greedy=True)
    def profile_steps(pre, dec, p):
        """A prefill and a decode step of ``p`` under the profiler: the
        device events of each and the wall seconds of each."""
        def one_prefill():
            c = lm.init_caches(full, LM_BATCH, mp_cache_len(LM_PROMPT + 1),
                               "cuda")
            return pre(p, c, {"tokens": tokens})
        (lg1, c1), on_pre, wall_pre = profiled(one_prefill)
        tok = torch.argmax(lg1[:, :full.vocab_size], -1)[:, None]
        _, on_dec, wall_dec = profiled(
            lambda: dec(p, c1, {"token": tok, "position": LM_PROMPT}))
        return on_pre, wall_pre, on_dec, wall_dec

    def busy_of(on_pre, wall_pre, on_dec, wall_dec):
        busy = {"prefill": sum(t for t, _ in on_pre.values()) / 1e3,
                "decode": sum(t for t, _ in on_dec.values()) / 1e3}
        return busy, {"prefill": busy["prefill"] / (wall_pre * 1e3),
                      "decode": busy["decode"] / (wall_dec * 1e3)}

    serve(params)
    one = serve(params)
    # the unsharded steps profiled in this call, beside the mesh's below
    one_busy, one_share = busy_of(*profile_steps(*mp_steps(full), params))
    mesh = make_host_mesh(*MP_SHAPE, devices=mesh_devices(k))
    placed = mp_placed(full, params, mesh)
    del params
    torch.cuda.empty_cache()
    serve(placed, mesh)
    want_prefill, want_step = lm_launches(full)
    want_prefill = {n: k * v for n, v in want_prefill.items()}
    want_step = {n: k * v for n, v in want_step.items()}
    log("mp", f"{label}: expecting launches {want_prefill} a prefill and "
        f"{want_step} a decode step ({LM_LAUNCHES_TXT}; on each of the {k} "
        f"positions)")
    pre, dec = mp_steps(full, mesh)
    caches = lm.init_caches(full, LM_BATCH, mp_cache_len(LM_PROMPT + steps),
                            "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (lg, caches), prefill_launches = counted(
        lambda: pre(placed, caches, {"tokens": tokens}))
    t1 = time.perf_counter()
    state = {"lg": lg, "caches": caches}

    def decode_loop():
        fed = []
        for i in range(steps):
            tok = torch.argmax(state["lg"][:, :full.vocab_size], -1)[:, None]
            fed.append(tok)
            state["lg"], state["caches"] = dec(
                placed, state["caches"],
                {"token": tok, "position": LM_PROMPT + i})
        return fed
    fed, decode_launches = counted(decode_loop)
    t2 = time.perf_counter()
    mp = {"logits": [lg, state["lg"]], "fed": fed,
          "prefill_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3}
    mp_on_card(mesh, mp)
    check_launches("mp", f"{label}: prefill", prefill_launches, want_prefill,
                   f"{LM_LAUNCHES_TXT}; on each of the {k} positions")
    check_launches("mp", f"{label}: {steps} decode steps", decode_launches,
                   {n: steps * v for n, v in want_step.items()},
                   f"{LM_LAUNCHES_TXT}; on each of the {k} positions")

    # the prefill's logits and first tokens against the unsharded serve's
    a, b = lg[:, :full.vocab_size].float(), one["logits"][0][
        :, :full.vocab_size].float()
    err, rel, ok = close(a, b, rtol=0.0, atol_of_scale=MP_BF16_TOL)
    if not ok or tuple(lg.shape) != (LM_BATCH, full.vocab_pad):
        raise AssertionError(f"{label}: the prefill's logits {tuple(lg.shape)}"
                             f" are {rel:.3e} of the scale off")
    top2 = torch.topk(b, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * err
    first_mp = torch.argmax(a, -1)
    first_one = torch.argmax(b, -1)
    same = first_mp == first_one
    if not bool(same[decided].all()):
        raise AssertionError(f"{label}: a first token whose margin exceeds "
                             f"twice the logits' difference changed")
    agree = float((torch.cat(mp["fed"], 1) == torch.cat(one["fed"], 1))
                  .float().mean())
    log("mp", f"{label}: the prefill's last-position logits against the "
        f"unsharded serve's: max_abs_err={err:.4e}, {rel:.3e} of the scale "
        f"(tol {MP_BF16_TOL:g}); greedy first tokens {first_mp.tolist()} vs "
        f"{first_one.tolist()} (held equal where the unsharded top-2 margin "
        f"exceeds 2 x max_abs_err: {decided.tolist()}); greedy tokens equal "
        f"to the unsharded serve's {agree:.3f} of all (not gated)")

    # a prefill and a decode step under the profiler
    on_pre, wall_pre, on_dec, wall_dec = profile_steps(pre, dec, placed)
    ev_pre, ev_dec = lm_events(on_pre), lm_events(on_dec)
    for what, got, want in (("prefill", ev_pre, want_prefill),
                            ("decode step", ev_dec, want_step)):
        want = {n: want.get(n, 0) for n in got}
        log("mp", f"{label}: a {what}'s device events {got} (expected "
            f"{want})")
        if got != want:
            raise AssertionError(f"{label}: the {what}'s device events are "
                                 f"not the launches")
    busy, share = busy_of(on_pre, wall_pre, on_dec, wall_dec)
    tok_s = LM_BATCH * steps / (mp["decode_ms"] / 1e3)
    one_tok_s = LM_BATCH * steps / (one["decode_ms"] / 1e3)
    log("mp", f"{label}: B={LM_BATCH} prompts of {LM_PROMPT} tokens, "
        f"{LM_GEN} generated each: prefill {mp['prefill_ms']:.2f} ms against "
        f"{one['prefill_ms']:.2f} unsharded; decode {tok_s:.2f} tokens/s "
        f"against {one_tok_s:.2f}; profiled: prefill {wall_pre * 1e3:.2f} ms "
        f"wall, busy {busy['prefill']:.2f} ({share['prefill']:.1%}), a "
        f"decode step {wall_dec * 1e3:.2f} ms wall, busy "
        f"{busy['decode']:.2f} ({share['decode']:.1%}); unsharded busy "
        f"{one_busy['prefill']:.2f} ({one_share['prefill']:.1%}) and "
        f"{one_busy['decode']:.2f} ({one_share['decode']:.1%}); top device "
        f"ops of the prefill {top(on_pre, 4)}; on {card}")
    del placed, state, caches
    torch.cuda.empty_cache()
    return {"launches": {n: prefill_launches[n] + decode_launches[n]
                         for n in prefill_launches},
            "launches_prefill": prefill_launches,
            "launches_decode": decode_launches,
            "events_prefill": ev_pre, "events_decode_step": ev_dec,
            "prefill_ms": mp["prefill_ms"], "decode_tok_per_s": tok_s,
            "unsharded_prefill_ms": one["prefill_ms"],
            "unsharded_decode_tok_per_s": one_tok_s,
            "busy_ms": busy, "busy_share": share,
            "unsharded_busy_ms": one_busy, "unsharded_busy_share": one_share,
            "profiled_wall_ms": {"prefill": wall_pre * 1e3,
                                 "decode": wall_dec * 1e3},
            "logits_max_abs_err": err, "logits_rel_err": rel,
            "first_tokens": first_mp.tolist(),
            "unsharded_first_tokens": first_one.tolist(),
            "first_token_decided": decided.tolist(),
            "greedy_agreement": agree}


def mp_phase(card: str) -> dict:
    """Phase 12: (a) the float32 checks, (b) llama3-8b, (c) olmoe-1b-7b,
    (d) mamba2-2.7b and (e) recurrentgemma-2b at full width and depth on
    MP_SHAPE. Returns the ``[mp] json`` record; its ``paths`` hold each
    full run's launches."""
    import torch
    out = {"card": card, "shape": list(MP_SHAPE),
           "device_count": torch.cuda.device_count(), "seconds": {}}
    t0 = time.perf_counter()
    out["f32"] = {}
    for arch, depth, changes in MP_F32_CASES:
        key = arch + "".join(f"_{k}{v}" for k, v in changes.items())
        out["f32"][key] = mp_f32_check(card, arch, depth, changes)
    out["seconds"]["a"] = time.perf_counter() - t0
    for arch in MP_ARCHS:
        t0 = time.perf_counter()
        out[arch] = mp_full(card, arch)
        out["seconds"][arch] = time.perf_counter() - t0
    log("mp", f"seconds by part: {out['seconds']}")
    out["paths"] = {f"mp_{arch}": {"launches": out[arch]["launches"]}
                    for arch in MP_ARCHS}
    return out


# ---------------------------------------------------------------------------
# phase 13: training under the model axis
# ---------------------------------------------------------------------------

# (a) the float32 checks (TF32 off) against the unsharded step on the same
# card, from the same seed-0 state and batch, one step at learning rate 0:
# (arch, depth, (data, model)); float32 sums over the positions in other
# orders: the loss within MT_F32_TOL of itself, every gradient (AdamW's
# m = (1 - b1) g) within MT_F32_TOL of the gradients' scale
MT_F32_CASES = (("llama3-8b", 2, (1, 2)), ("olmoe-1b-7b", 2, (1, 2)),
                ("deepseek-67b", 1, (2, 2)), ("mamba2-2.7b", 2, (1, 2)),
                ("recurrentgemma-2b", 3, (1, 2)))
MT_F32_BATCH, MT_F32_SEQ = 4, 256
MT_F32_TOL = 1e-5
# (b) bf16 at full width: (arch, depth, (data, model), batch) of 2048-token
# sequences, MT_STEPS steps each, sharded and unsharded in one call. Depth
# the only cut, each run's peak under ~60 GB: mamba2's (1, 2) positions
# each hold every mixer weight and its AdamW state (the rules repeat them),
# so 16 of its 64 layers; recurrentgemma's vocabulary table alone is 0.66B
# parameters, so 12 of its 26 layers (four whole groups)
MT_BF16_CASES = (("llama3-8b", 4, (1, 2), 2), ("deepseek-67b", 2, (2, 2), 4),
                 ("mamba2-2.7b", 16, (1, 2), 2),
                 ("recurrentgemma-2b", 12, (1, 2), 2))
MT_SEQ, MT_STEPS = 2048, 3
# (c) the watchdog: a position waiting longer at one rendezvous fails the
# phase, naming the collective
MT_TIMEOUT_S = 60.0
# the device kernels of a training step by kernel, the backward's two
# (dQ, dK/dV) included
MT_EVENT_SYMBOLS = {**LM_EVENT_SYMBOLS, "flash_attention_bwd": ("flash_bwd_",)}


def mt_events(on_device: dict) -> dict:
    return {k: sum(c for name, (_, c) in on_device.items()
                   if any(sym in name for sym in syms))
            for k, syms in MT_EVENT_SYMBOLS.items()}


def mt_state(cfg, rules=None, mesh=None):
    """Seed-0 parameters (``init_params``' draws, leaf by leaf) and zero
    optimizer state on the card: whole tensors (the parameters requiring
    grad), or with ``rules`` / ``mesh`` each leaf placed on the mesh as
    it is made, so that the whole tree never exists beside its pieces."""
    import torch
    from repro_torch.distributed.sharding import (init_one, map_tree,
                                                  param_shardings, shard)
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import get_optimizer
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    pdefs = lm.lm_param_defs(cfg)
    odefs = get_optimizer(cfg.optimizer).state_defs(pdefs)

    def made(defs, fill):
        if mesh is None:
            return map_tree(lambda d: fill(d), defs)
        return map_tree(lambda d, where: shard(fill(d), where), defs,
                        param_shardings(defs, rules, mesh))
    params = made(pdefs, lambda d: init_one(gen, d, dev).requires_grad_(
        mesh is None))
    state = made(odefs, lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                              device=dev))
    return params, state


def mt_step(cfg, tcfg, shape, batch: int):
    """(the train step, its rules, its mesh) of ``cfg``: on a ``shape``
    mesh of positions of the card (spread over the cards where there are
    several) by ``build_rules``' table, or unsharded without a shape."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_rules, make_train_step
    if shape is None:
        return make_train_step(cfg, tcfg), None, None
    mesh = make_host_mesh(*shape, devices=mesh_devices(shape[0] * shape[1]))
    rules = build_rules(cfg, mesh, "train", batch)
    return make_train_step(cfg, tcfg, rules, mesh), rules, mesh


def mt_watched(run):
    """``run()`` under the rendezvous watchdog: a position waiting more
    than MT_TIMEOUT_S at one rendezvous fails it, naming the collective."""
    from repro_torch.distributed.collectives import rendezvous_timeout
    with rendezvous_timeout(MT_TIMEOUT_S):
        return run()


def mt_f32_check(card: str, arch: str, depth: int, shape: tuple) -> dict:
    """(a) ``arch`` at full width, ``depth`` layers, float32, per-layer
    remat: one step at learning rate 0 on ``shape`` against the unsharded
    step (run first, its state freed but for the moments), the launches
    each position's forward, recompute and backward."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim.optimizers import tree_leaves
    cfg = ARCHS[arch].replace(num_layers=depth, dtype=torch.float32)
    tcfg = TrainConfig(learning_rate=0.0, warmup_steps=1, total_steps=10,
                       grad_clip=1e9)
    n = shape[0] * shape[1]
    label = (f"(a) {arch} width, depth {depth}, float32, B={MT_F32_BATCH} "
             f"S={MT_F32_SEQ}, mesh {shape}")
    data = token_batch(cfg, MT_F32_BATCH, MT_F32_SEQ)
    one, _, _ = mt_step(cfg, tcfg, None, MT_F32_BATCH)
    _, o1, m1 = one(*mt_state(cfg), data)
    # held on the host while the sharded step runs
    g1 = [t.detach().cpu() for t in tree_leaves(o1["m"])]
    loss1 = float(m1["loss"])
    del o1, _
    torch.cuda.empty_cache()
    step, rules, mesh = mt_step(cfg, tcfg, shape, MT_F32_BATCH)
    want = {k: n * v for k, v in train_launches(cfg).items()}
    log("mt", f"{label}: expecting launches {want} ({n} positions x "
        f"({TRAIN_LAUNCHES_TXT}))")
    t0 = time.perf_counter()
    (p2, o2, m2), launches = counted(
        lambda: mt_watched(lambda: step(*mt_state(cfg, rules, mesh),
                                        data)))
    wall = time.perf_counter() - t0
    check_launches("mt", label, launches, want, f"{n} positions x "
                   f"({TRAIN_LAUNCHES_TXT})")
    devs = {str(d) for d in mesh.devices.flat}
    if any(not d.startswith("cuda") for d in devs):
        raise AssertionError(f"{label}: a position left the card: {devs}")
    scale = max(float(g.abs().max()) for g in g1)
    worst, finite = 0.0, True
    for a, leaf in zip(g1, tree_leaves(o2["m"])):       # leaf by leaf
        b = leaf.gather("cuda").detach()
        worst = max(worst, float((a.cuda() - b).abs().max()) / scale)
        finite &= bool(torch.isfinite(b).all())
        del b
    rel_loss = abs(float(m2["loss"]) - loss1) / abs(loss1)
    split = sum(leaf.pieces.flat[0].shape != tuple(leaf.shape)
                for leaf in tree_leaves(p2))
    ok = worst <= MT_F32_TOL and rel_loss <= MT_F32_TOL and finite
    log("mt", f"{label}: loss {float(m2['loss']):.6f} (unsharded {loss1:.6f},"
        f" {rel_loss:.2e} apart); {len(g1)} gradients, the worst "
        f"{worst:.2e} of their scale (tol {MT_F32_TOL:g}); {split} leaves "
        f"split over the positions; the sharded step {wall:.2f} s; "
        f"{'ok' if ok else 'FAIL'}; on {card}")
    if not ok:
        raise AssertionError(f"{label}: the sharded step disagrees with the "
                             f"unsharded step")
    del p2, o2, g1
    torch.cuda.empty_cache()
    return {"loss": float(m2["loss"]), "loss_rel_err": rel_loss,
            "grad_rel_err": worst, "launches": launches,
            "split_leaves": split, "sharded_step_s": wall}


def mt_run(card: str, cfg, shape, batch: int, label: str) -> dict:
    """MT_STEPS steps of ``cfg`` (bf16, AdamW at lr 1e-3 after a warm-up of
    5 steps, as phases 10 and 11; remat) on ``shape`` (or unsharded) from
    the seed-0 state, each timed between two device
    synchronisations, the counts from 0 before the first; one more step
    under ``torch.profiler``. The state is freed before it returns."""
    import torch
    from repro_torch.configs.base import TrainConfig
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=5,
                       total_steps=MT_STEPS + 1, checkpoint_every=0, seed=0)
    step, rules, mesh = mt_step(cfg, tcfg, shape, batch)
    n = 1 if shape is None else shape[0] * shape[1]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params, opt_state = mt_state(cfg, rules, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    state = {"p": params, "o": opt_state}
    del params, opt_state

    def steps():
        for i in range(MT_STEPS):
            data = token_batch(cfg, batch, MT_SEQ, step=i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state["p"], state["o"], m = mt_watched(
                lambda: step(state["p"], state["o"], data))
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
    want = {k: MT_STEPS * n * v for k, v in train_launches(cfg).items()}
    log("mt", f"{label}: expecting launches {want} over {MT_STEPS} steps")
    _, launches = counted(steps)
    check_launches("mt", f"{label}: {MT_STEPS} steps", launches, want,
                   f"{MT_STEPS} steps x {n} position(s) x "
                   f"({TRAIN_LAUNCHES_TXT})")
    peak = torch.cuda.max_memory_allocated()
    data = token_batch(cfg, batch, MT_SEQ, step=MT_STEPS)
    result, on_device, wall = profiled(lambda: mt_watched(
        lambda: step(state["p"], state["o"], data)))
    del result                  # the state it returned is state's
    events = mt_events(on_device)
    per_step = {k: n * v for k, v in train_launches(cfg).items()}
    if {k: events.get(k, 0) for k in per_step} != per_step:
        raise AssertionError(f"{label}: a profiled step's device kernels "
                             f"{events} are not its launches {per_step}")
    busy_ms = sum(t for t, _ in on_device.values()) / 1e3
    steady = sorted(step_ms[1:])
    med = statistics.median(steady)
    tokens = batch * MT_SEQ
    rec = {"losses": losses, "step_ms": step_ms, "step_ms_median": med,
           "tokens_per_s": tokens / (med / 1e3), "launches": launches,
           "peak_mem_gb": peak / 1e9, "held_before_gb": before / 1e9,
           "profiled_step_ms": wall * 1e3,
           "busy_ms": busy_ms, "busy_share": busy_ms / (wall * 1e3),
           "device_kernels": events, "top_device": top(on_device, 6)}
    log("mt", f"{label}: losses {[round(x, 5) for x in losses]}; step ms "
        f"{[round(x, 1) for x in step_ms]} (median of steps 2-{MT_STEPS}: "
        f"{med:.1f}); {rec['tokens_per_s']:.0f} tokens/s; peak memory "
        f"{peak / 1e9:.2f} GB ({before / 1e9:.2f} GB held before the state "
        f"was made); one more step under torch.profiler "
        f"{wall * 1e3:.1f} ms, the card busy {busy_ms:.1f} ms "
        f"({rec['busy_share']:.1%}, kernel time summed over the positions' "
        f"streams); device kernels {events}; top {top(on_device, 4)}; on "
        f"{card}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    del state, step, rules, mesh
    torch.cuda.empty_cache()
    return rec


def mt_full(card: str, arch: str, depth: int, shape: tuple,
            batch: int) -> dict:
    """(b) ``arch`` at full width, ``depth`` layers, bf16: the unsharded
    steps, then (its state freed) the same on ``shape``; the losses side
    by side."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.distributed.sharding import param_count
    from repro_torch.models import lm
    cfg = ARCHS[arch].replace(num_layers=depth)
    label = (f"(b) {arch} full width, depth {depth} "
             f"({param_count(lm.lm_param_defs(cfg)) / 1e9:.2f}B params), "
             f"bf16, AdamW, remat, B={batch} S={MT_SEQ}")
    one = mt_run(card, cfg, None, batch, f"{label}, unsharded")
    mesh = mt_run(card, cfg, shape, batch, f"{label}, mesh {shape}")
    diff = [abs(a - b) for a, b in zip(mesh["losses"], one["losses"])]
    ratio = mesh["step_ms_median"] / one["step_ms_median"]
    log("mt", f"{label}: losses on the mesh against unsharded, per step "
        f"{diff}; step {mesh['step_ms_median']:.1f} ms against "
        f"{one['step_ms_median']:.1f} ({ratio:.2f}x)")
    if max(diff) >= MESH_LOSS_TOL:
        raise AssertionError(f"{label}: the mesh's losses left the unsharded "
                             f"run's")
    return {"mesh": mesh, "unsharded": one, "loss_abs_diff": diff,
            "shape": list(shape)}


def mt_phase(card: str) -> dict:
    """Phase 13: (a) the float32 checks, (b) the bf16 runs, every sharded
    step under (c) the watchdog. Returns the ``[mt] json`` record; its
    ``paths`` hold each run's launches."""
    import torch
    out = {"card": card, "device_count": torch.cuda.device_count(),
           "seconds": {}, "f32": {}}
    for arch, depth, shape in MT_F32_CASES:
        t0 = time.perf_counter()
        out["f32"][arch] = mt_f32_check(card, arch, depth, shape)
        out["seconds"][f"a_{arch}"] = time.perf_counter() - t0
    for arch, depth, shape, batch in MT_BF16_CASES:
        t0 = time.perf_counter()
        out[arch] = mt_full(card, arch, depth, shape, batch)
        out["seconds"][f"b_{arch}"] = time.perf_counter() - t0
    log("mt", f"seconds by part: {out['seconds']}")
    out["paths"] = {f"mt_f32_{arch}": {"launches": out["f32"][arch][
        "launches"]} for arch, _, _ in MT_F32_CASES}
    out["paths"].update({f"mt_{arch}": {"launches": out[arch]["mesh"][
        "launches"]} for arch, _, _, _ in MT_BF16_CASES})
    return out


# ---------------------------------------------------------------------------
# the dry run's count held against the card
# ---------------------------------------------------------------------------

# a counted peak against the card's max_memory_allocated: at most this
# share apart
ROOF_PEAK_TOL = 0.25
# llama3-8b's prefill of (b), phase 8's cell
ROOF_PREFILL = ("llama3-8b", LM_BATCH, LM_PROMPT)
# (c): llama3-8b at depth 2 on this mesh of positions of the card
ROOF_MESH = (1, 2)


def roof_inputs(cfg, shape, rules, mesh):
    """Seed-0 inputs on the card shaped as ``lowering_bundle``'s: the
    parameters, with the optimizer's zero state for training, placed on
    ``mesh`` leaf by leaf (a serving step takes whole tensors and splits
    them by view), and the batch of random tokens (and labels), int32."""
    import torch
    from repro_torch.distributed.sharding import (init_one, map_defs,
                                                  map_tree, param_shardings,
                                                  shard)
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import get_optimizer
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s = shape.global_batch, shape.seq_len
    pdefs = lm.lm_param_defs(cfg)

    def tokens():
        return torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device=dev, dtype=torch.int32)

    def zeros(d):
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)
    if shape.kind == "train":
        def placed(defs, fill):
            return map_tree(lambda d, where: shard(fill(d), where), defs,
                            param_shardings(defs, rules, mesh))
        params = placed(pdefs, lambda d: init_one(gen, d, dev))
        state = placed(get_optimizer(cfg.optimizer).state_defs(pdefs),
                       zeros)
        return params, state, {"tokens": tokens(), "labels": tokens()}
    params = map_defs(lambda d: init_one(gen, d, dev), pdefs)
    caches = map_defs(zeros, lm.lm_cache_defs(cfg, b, s))
    return params, caches, {"tokens": tokens()}


def roof_counted(step, args):
    """``step(*args)`` once under a counter and the rendezvous watchdog:
    {position: record}."""
    import torch
    from repro_torch.counter import Counter
    with Counter() as c:
        mt_watched(lambda: step(*args))
        torch.cuda.synchronize()
    return c.records


def roof_same(label: str, meta, card, keys) -> None:
    """Fail unless the meta and the card records agree on ``keys``,
    printing the ops whose calls, FLOPs or bytes differ."""
    a, b = meta.as_dict(), card.as_dict()
    bad = [k for k in keys if a[k] != b[k]]
    if not bad:
        log("roof", f"{label}: meta and card equal in {', '.join(keys)}")
        return
    ta, tb = meta.op_table(), card.op_table()
    for name in sorted(set(ta) | set(tb)):
        if ta.get(name) != tb.get(name):
            log("roof", f"  {name}: meta {ta.get(name)} card {tb.get(name)}")
    raise AssertionError(f"{label}: meta and card differ in {bad}: "
                         f"{ {k: (a[k], b[k]) for k in bad} }")


def roof_step(card: str, label: str, cfg, shape, tcfg=None,
              mesh_shape=(1, 1)) -> dict:
    """One step of ``cfg``'s ``shape`` built by ``lowering_bundle`` on a
    ``mesh_shape`` mesh of meta positions and on one of positions of the
    card, each run once under the counter: the meta and the card records
    by position, the card step with its inputs, the card's peak above
    what was allocated before the inputs, and the CUDA launches of each
    kernel in the counted run. Fails unless those launches, read from the
    wrappers' own launch counts (set to 0 just before the run), equal the
    launches the card's records declare, summed over the positions."""
    import torch
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.kernels.ops import launch_counters
    from repro_torch.launch.steps import build_rules, lowering_bundle
    axes = ("data", "model")
    meta_mesh = make_mesh(mesh_shape, axes, devices="meta")
    step_m, args_m = lowering_bundle(cfg, shape, meta_mesh, tcfg=tcfg)
    t0 = time.perf_counter()
    meta = roof_counted(step_m, args_m)
    meta_s = time.perf_counter() - t0
    del step_m, args_m
    mesh = make_mesh(mesh_shape, axes, devices=mesh_devices(
        mesh_shape[0] * mesh_shape[1]))
    rules = build_rules(cfg, mesh, shape.kind,
                        global_batch=shape.global_batch)
    step, _ = lowering_bundle(cfg, shape, mesh, tcfg=tcfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = roof_inputs(cfg, shape, rules, mesh)
    mt_watched(lambda: step(*args))                 # warm: cuBLAS, kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    card_recs = roof_counted(step, args)
    peak = torch.cuda.max_memory_allocated() - base
    launched = {n: fn.launches for n, fn in counters.items() if fn.launches}
    declared = {}
    for rec in card_recs.values():
        for n, k in rec.as_dict()["kernels"].items():
            declared[n] = declared.get(n, 0) + k["launches"]
    declared = {n: v for n, v in declared.items() if v}
    if launched != declared:
        raise AssertionError(f"{label}: the kernels launched {launched} on "
                             f"the card, the counter declared {declared}")
    log("roof", f"{label}: counted on {mesh_shape} meta positions in "
        f"{meta_s:.1f} s and on {mesh_shape} positions of the card; the "
        f"wrappers' CUDA launches {launched} equal the declared; on {card}")
    return {"meta": meta, "card": card_recs, "step": step, "args": args,
            "peak": peak, "launches": launched}


def roofline_phase(card: str, trainer_ms=None) -> dict:
    """Phase 14: the dry run's count (``repro_torch/counter.py``) held
    against the card. (a) qwen1.5-0.5b's training step (phase 10's cell)
    and (b) llama3-8b's prefill (phase 8's cell), each built by
    ``lowering_bundle`` and counted on a (1, 1) meta mesh and on a (1, 1)
    mesh of the card: products' FLOPs, bytes and the kernels' launches and
    declared work equal, and the declared launches equal the wrappers'
    CUDA launch counts in every part (``roof_step``); (a)'s backward seen on autograd's worker thread; (a)'s meta
    peak, at full depth and extrapolated from 1 and 2 layers
    (``launch/hlo_cost.py``), within ``ROOF_PEAK_TOL`` of the card's
    ``max_memory_allocated``; each step timed without the counter (median
    of 5) and its ``model_flops`` share of the bf16 peak. (c) llama3-8b at
    depth 2 prefilling on ``ROOF_MESH`` positions of the card: each
    position's collective records equal the meta mesh's."""
    import gc
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.launch import hlo_cost, roofline
    def free():
        gc.collect()
        torch.cuda.empty_cache()
    free()
    out = {"card": card}
    t_phase = time.perf_counter()

    # (a) qwen1.5-0.5b training, full depth, bf16, AdamW, remat
    cfg = ARCHS[TRAIN_ARCH]
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=5,
                       total_steps=TRAIN_STEPS, checkpoint_every=0, seed=0)
    label = (f"(a) {TRAIN_ARCH} training step, {cfg.num_layers} layers, "
             f"B={TRAIN_BATCH} x {TRAIN_SEQ}, bf16, AdamW, remat")
    run = roof_step(card, label, cfg, shape, tcfg)
    meta, rec = run["meta"][(0, 0)], run["card"][(0, 0)]
    roof_same(label, meta, rec, ("product_flops", "op_bytes", "kernels"))
    m, c = meta.as_dict(), rec.as_dict()
    fwd = c["product_flops"] - c["backward_product_flops"]
    log("roof", f"{label}: products {c['product_flops']:.4e} FLOP, of "
        f"which the backward {c['backward_product_flops']:.4e} "
        f"({c['backward_product_flops'] / max(fwd, 1):.2f}x the forward's "
        f"{fwd:.4e}: twice, plus remat's recompute); {c['ops_off_thread']} "
        f"of {c['ops']} ops counted on autograd's worker thread; kernels "
        f"{c['kernels']}; on {card}")
    if c["ops_off_thread"] == 0:
        raise AssertionError(f"{label}: no op counted off the position's "
                             f"thread: the backward was not seen there")
    est = hlo_cost.measured_costs(cfg, shape, make_mesh(
        (1, 1), ("data", "model"), devices="meta"), tcfg)
    peaks = {"meta_full_depth": m["peak_bytes"],
             "meta_extrapolated": est["peak_bytes"], "card": run["peak"]}
    log("roof", f"{label}: peak bytes: meta at full depth "
        f"{peaks['meta_full_depth'] / 1e9:.2f} GB, extrapolated from 1 and "
        f"2 layers {peaks['meta_extrapolated'] / 1e9:.2f} GB, the card's "
        f"max_memory_allocated {peaks['card'] / 1e9:.2f} GB (tolerance "
        f"{ROOF_PEAK_TOL:.0%}); on {card}")
    for k in ("meta_full_depth", "meta_extrapolated"):
        if abs(peaks[k] - peaks["card"]) > ROOF_PEAK_TOL * peaks["card"]:
            raise AssertionError(f"{label}: the {k} peak is more than "
                                 f"{ROOF_PEAK_TOL:.0%} from the card's")
    med, _ = wall_ms(lambda: mt_watched(lambda: run["step"](*run["args"])),
                     reps=5)
    mf = roofline.model_flops(cfg, shape)
    rep = roofline.roofline_report(m, 1, cfg, shape)
    out["a_train"] = {
        "label": label, "record": c, "launches": run["launches"],
        "peaks_bytes": peaks,
        "step_ms_median": med,
        "trainer_step_ms_median": trainer_ms, "model_flops": mf,
        "mfu": mf / (med / 1e3 * roofline.PEAK_FLOPS),
        "counted_flops_share": c["flops"] / (med / 1e3 * roofline.PEAK_FLOPS),
        "bound_ms": rep["step_time_lower_bound_s"] * 1e3,
        "bottleneck": rep["bottleneck"]}
    trainer = ("not run in this call" if trainer_ms is None
               else f"{trainer_ms:.1f} ms")
    log("roof", f"{label}: the step without the counter {med:.1f} ms "
        f"(median of 5 after a warm-up; phase 10's Trainer step "
        f"{trainer}); "
        f"model_flops 6ND = {mf:.4e} FLOP -> {out['a_train']['mfu']:.3f} of "
        f"989 TFLOP/s; the counted {c['flops']:.4e} FLOP -> "
        f"{out['a_train']['counted_flops_share']:.3f}; the count's bound "
        f"{out['a_train']['bound_ms']:.1f} ms ({rep['bottleneck']}); on "
        f"{card}")
    del run
    free()

    # (b) llama3-8b prefill, full depth, bf16
    arch, b, s = ROOF_PREFILL
    cfg = ARCHS[arch]
    shape = ShapeConfig("prefill", s, b, "prefill")
    label = (f"(b) {arch} prefill, {cfg.num_layers} layers, B={b} x {s}, "
             f"bf16")
    run = roof_step(card, label, cfg, shape)
    meta, rec = run["meta"][(0, 0)], run["card"][(0, 0)]
    roof_same(label, meta, rec, ("product_flops", "op_bytes", "kernels"))
    m, c = meta.as_dict(), rec.as_dict()
    med, _ = wall_ms(lambda: mt_watched(lambda: run["step"](*run["args"])),
                     reps=5)
    mf = roofline.model_flops(cfg, shape)
    rep = roofline.roofline_report(m, 1, cfg, shape)
    out["b_prefill"] = {
        "label": label, "record": c, "launches": run["launches"],
        "step_ms_median": med,
        "model_flops": mf,
        "mfu": mf / (med / 1e3 * roofline.PEAK_FLOPS),
        "counted_flops_share": c["flops"] / (med / 1e3 * roofline.PEAK_FLOPS),
        "peaks_bytes": {"meta_full_depth": m["peak_bytes"],
                        "card": run["peak"]},
        "bound_ms": rep["step_time_lower_bound_s"] * 1e3,
        "bottleneck": rep["bottleneck"]}
    log("roof", f"{label}: products {c['product_flops']:.4e} FLOP, kernels "
        f"{c['kernels']}; the prefill {med:.1f} ms (median of 5 after a "
        f"warm-up); model_flops 2ND = {mf:.4e} FLOP "
        f"-> {out['b_prefill']['mfu']:.3f} of 989 TFLOP/s; the counted "
        f"{c['flops']:.4e} -> {out['b_prefill']['counted_flops_share']:.3f};"
        f" peak meta {m['peak_bytes'] / 1e9:.2f} GB, card "
        f"{run['peak'] / 1e9:.2f} GB; the count's bound "
        f"{out['b_prefill']['bound_ms']:.1f} ms ({rep['bottleneck']}); on "
        f"{card}")
    del run
    free()

    # (c) llama3-8b depth 2 prefill on a model axis of card positions
    cfg = ARCHS[arch].replace(num_layers=2)
    label = (f"(c) {arch} depth 2 prefill, B={b} x {s}, bf16, mesh "
             f"{ROOF_MESH}")
    run = roof_step(card, label, cfg, shape, mesh_shape=ROOF_MESH)
    colls = {}
    for pos, rec in run["card"].items():
        mine, want = rec.as_dict(), run["meta"][pos].as_dict()
        if mine["collectives"] != want["collectives"]:
            raise AssertionError(
                f"{label}: position {pos}'s collectives differ: card "
                f"{mine['collectives']}, meta {want['collectives']}")
        colls[str(pos)] = mine["collectives"]
    log("roof", f"{label}: each position's collectives equal the meta "
        f"mesh's: {colls[str((0, 0))]}; on {card}")
    out["c_mesh"] = {"label": label, "collectives": colls,
                     "launches": run["launches"]}
    del run
    free()
    out["seconds"] = time.perf_counter() - t_phase
    log("roof", f"phase 14 took {out['seconds']:.1f} s; on {card}")
    return out


# what ``--only`` runs after phase 1: the sources it builds (phase 2) and
# its phase alone, with no result lines
ONLY_SOURCES = {"wide": ["layer_fused", "mp_pipeline"],
                "lm_families": ["mp_scatter", "gather_rows",
                                "flash_attention"],
                "train": ["flash_attention", "flash_attention_bwd",
                          "mp_scatter", "gather_rows"],
                "mesh": ["flash_attention", "flash_attention_bwd",
                         "mp_scatter", "gather_rows"],
                "model_parallel": ["flash_attention", "mp_scatter",
                                   "gather_rows"],
                "model_train": ["flash_attention", "flash_attention_bwd",
                                "mp_scatter", "gather_rows"],
                "roofline": ["flash_attention", "flash_attention_bwd"]}


def main(argv=None) -> int:
    import torch
    args = sys.argv[1:] if argv is None else list(argv)
    only = None
    if len(args) == 2 and args[0] == "--only" and args[1] in ONLY_SOURCES:
        only = args[1]
    elif args:
        print(f"usage: chip_smoke.py [--only {'|'.join(ONLY_SOURCES)}]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))

    # 1. device
    smi = gpu_line()
    card = f"{smi} (nvidia-smi name, power.limit)"
    log("device", f"{torch.cuda.get_device_name(0)}; count "
        f"{torch.cuda.device_count()}; {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build(ONLY_SOURCES[only] if only else [
        "layer_fused", "mp_pipeline", "mp_scatter", "seg_softmax",
        "gather_rows", "nt_mlp", "fused_nt_scatter", "flash_attention",
        "flash_attention_bwd"])
    log("build", f"nvcc {' '.join(build.NVCC_FLAGS)}: "
        f"{', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("build", line.strip())
    if only == "wide":
        # phase 4f alone: no result lines
        record_trips()
        log("wide", "json " + json.dumps(wide_phase(card), default=str))
        print(smi)
        return 0
    if only == "lm_families":
        # phase 9 alone: no result lines
        log("lm9", "json " + json.dumps(lm_families_phase(card),
                                        default=str))
        print(smi)
        return 0
    if only == "train":
        # phase 10 alone: no result lines
        train = train_phase(card)
        log("train", "json " + json.dumps(
            {"rows": train["rows"], "paths": train["paths"]}, default=str))
        print(smi)
        return 0
    if only == "mesh":
        # phase 11 alone: no result lines
        log("mesh", "json " + json.dumps(mesh_phase(card), default=str))
        print(smi)
        return 0
    if only == "model_parallel":
        # phase 12 alone: no result lines
        log("mp", "json " + json.dumps(mp_phase(card), default=str))
        print(smi)
        return 0
    if only == "model_train":
        # phase 13 alone: no result lines
        log("mt", "json " + json.dumps(mt_phase(card), default=str))
        print(smi)
        return 0
    if only == "roofline":
        # phase 14 alone: no result lines
        log("roof", "json " + json.dumps(roofline_phase(card), default=str))
        print(smi)
        return 0
    scatter_build = scatter_build_report()
    lf_build = lf_build_report()
    pipeline_build = pipeline_build_report()
    nt_build = nt_build_report()

    # 3 needs the main path's inputs first
    main_inputs, bucket_edges = record_main_inputs()

    # 3. kernels against their plain versions
    lf_rows = kernel_phase(card, main_inputs["layer_fused"])
    mp_rows = mp_kernel_phase(card, main_inputs["mp_pipeline"])
    scatter_rows = {k: scatter_kernel_phase(card, k, main_inputs[k])
                    for k in SCATTER_CASES}

    # 4. the slice end to end, 4b. its host path, eager against captured,
    # 4c. packed serving through submit / drain, with no breaker trip; 4d.
    # failure semantics and defense in depth
    graphs = slice_graphs()
    record_trips()
    paths = slice_phase(card, graphs)
    log("host", "json " + json.dumps(host_phase(card, graphs)))
    packed = packed_phase(card, graphs)
    log("packed", "json " + json.dumps(packed, default=str))
    paths.update(packed)
    check_trips("phases 4, 4b and 4c", [])
    faults = faults_phase(card, graphs)
    log("faults", "json " + json.dumps(faults, default=str))
    paths["faults_gin_fused_layer"] = faults
    # 4e. per-bucket autotune, its cache, drift retune and eviction
    tune = tune_phase(card, graphs)
    log("tune", "json " + json.dumps(tune, default=str))
    paths["tune"] = tune
    # 4f. wide placement: oversized graphs on a gang of four executors
    wide = wide_phase(card)
    log("wide", "json " + json.dumps(wide, default=str))
    paths["wide"] = wide

    # 5. the NT kernels through their entry points, 6. the MoE data path
    nt_rows, paths["nt"] = nt_phase(card, bucket_edges)
    moe_rows, paths["moe_olmoe"] = moe_phase(card)
    scatter_rows["mp_scatter"].update(
        {k: v for k, v in moe_rows.items() if k != "moe_gather"})

    # 7. flash_attention at the LM path's shapes, 8. the dense LM path at
    # llama3-8b's full width
    flash_rows, flash_build = flash_phase(card)
    paths["lm_llama3_8b"] = lm_phase(card)
    # 9. the MoE, SSM and hybrid LM families at full width and depth
    families = lm_families_phase(card)
    log("lm9", "json " + json.dumps(families, default=str))
    paths.update(families)
    # phase 9's kernel calls at the served shapes join each kernel's cases
    served = {k: v for fam in families.values()
              for k, v in fam.get("rows", {}).items()}
    scatter_rows["mp_scatter"].update(
        {k: v for k, v in served.items()
         if k.endswith(("_dispatch", "_combine"))})
    flash_rows.update({k: v for k, v in served.items()
                       if k.endswith("_attention")})
    # 10. training: the backward kernel, gradients through the kernels,
    # qwen1.5-0.5b trained at full width and depth
    train = train_phase(card)
    log("train", "json " + json.dumps(
        {"rows": train["rows"], "paths": train["paths"]}, default=str))
    paths.update(train["paths"])
    # 11. the mesh: collectives, GPipe, data-parallel training, compression
    # and elastic restore on positions of the card
    mesh = mesh_phase(card)
    log("mesh", "json " + json.dumps(mesh, default=str))
    paths.update(mesh["paths"])
    # 12. model-parallel serving: llama3-8b, olmoe-1b-7b, mamba2-2.7b and
    # recurrentgemma-2b on a model axis
    mp = mp_phase(card)
    log("mp", "json " + json.dumps(mp, default=str))
    paths.update(mp["paths"])
    # 13. training under the model axis: llama3-8b, olmoe-1b-7b,
    # deepseek-67b (FSDP), mamba2-2.7b and recurrentgemma-2b on (data,
    # model) meshes of positions of the card
    mt = mt_phase(card)
    log("mt", "json " + json.dumps(mt, default=str))
    paths.update(mt["paths"])
    # 14. the dry run's count held against the card: qwen1.5-0.5b's
    # training step, llama3-8b's prefill, llama3-8b on a model axis
    roof = roofline_phase(card, train["paths"][f"train_{TRAIN_ARCH}"][
        "step_ms_median"])
    log("roof", "json " + json.dumps(roof, default=str))

    # 15. result: each kernel's row at the largest shape its main path gives
    # it (the hep bucket for the GNN kernels), and its launches in its main
    # path's run
    def row(name, source, replaces, cases, main, path, shape):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": paths[path]["launches"][name],
                "max_abs_err": main["max_abs_err"], "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": main.get("library_ms"),
                **{k: main[k] for k in ("three_calls_ms", "chain_ms")
                   if main.get(k) is not None},
                "call_ms": main["call_ms"],
                "plain_call_ms": main["plain_call_ms"], "shape": shape,
                "main_path": path,
                "launches_by_path": {k: v["launches"].get(name, 0)
                                     for k, v in paths.items()},
                "cases": {k: {m: v.get(m) for m in (
                    "ms", "plain_ms", "bound_ms", "library_ms",
                    "three_calls_ms", "chain_ms", "max_abs_err") if m in v}
                          for k, v in cases.items()}}

    kernels = [
        row("layer_fused", "src/repro_torch/kernels/csrc/layer_fused.cu",
            "src/repro/kernels/layer_fused.py:203",
            lf_rows, lf_rows["f_gin_fused_layer_L0_hep_bucket"],
            "gin_fused_layer",
            "GIN layer at the hep bucket: N=64, E=1024, D=100, D_ff=200"),
        row("mp_pipeline", "src/repro_torch/kernels/csrc/mp_pipeline.cu",
            "src/repro/kernels/mp_pipeline.py:238",
            mp_rows, mp_rows["f_gat_fused_layer_L0_hep_bucket"],
            "gat_fused_layer",
            "GAT's first layer at the hep bucket: N=64, E=1024, D=64, H=4"),
        row("mp_scatter", "src/repro_torch/kernels/csrc/mp_scatter.cu",
            "src/repro/kernels/mp_scatter.py:116",
            scatter_rows["mp_scatter"],
            scatter_rows["mp_scatter"]["f_gin_kernel_L0_hep_bucket"],
            "gin_kernel",
            "GIN's first layer at the hep bucket: N=64, E=1024, D=100"),
        row("mp_scatter_multi", "src/repro_torch/kernels/csrc/mp_scatter.cu",
            "src/repro/kernels/mp_scatter.py:204",
            scatter_rows["mp_scatter_multi"],
            scatter_rows["mp_scatter_multi"]["f_pna_kernel_L0_hep_bucket"],
            "pna_kernel",
            "PNA's first layer at the hep bucket: N=64, E=1024, D=80, "
            "sum+sumsq+max+min"),
        row("seg_softmax", "src/repro_torch/kernels/csrc/seg_softmax.cu",
            "src/repro/kernels/seg_softmax.py:98",
            scatter_rows["seg_softmax"],
            scatter_rows["seg_softmax"]["f_gat_kernel_L0_hep_bucket"],
            "gat_kernel",
            "GAT's first layer at the hep bucket: E=1024, H=4, N=64; "
            "one launch"),
        row("nt_mlp", "src/repro_torch/kernels/csrc/nt_mlp.cu",
            "src/repro/kernels/nt_mlp.py:49", nt_rows["nt_mlp"],
            nt_rows["nt_mlp"]["c_gin_n1024"], "nt",
            "GIN's MLP 100->200->100 at N=1024"),
        row("fused_nt_scatter",
            "src/repro_torch/kernels/csrc/fused_nt_scatter.cu",
            "src/repro/kernels/fused_nt_scatter.py:74",
            nt_rows["fused_nt_scatter"],
            nt_rows["fused_nt_scatter"]["c_standard_point"], "nt",
            "N=1024, E=4096, MLP 64->128->64; both launches"),
        row("gather_rows", "src/repro_torch/kernels/csrc/gather_rows.cu",
            "src/repro/kernels/gather_rows.py:48",
            {"moe_gather": moe_rows["moe_gather"],
             **{k: v for k, v in served.items() if k.endswith("_gather")}},
            served["olmoe-1b-7b_prefill_gather"], "lm_olmoe-1b-7b",
            "olmoe-1b-7b served prefill's first MoE layer's combine: "
            "S=32768 rows of y (40960, 2048) bf16, f32 out"),
        row("flash_attention",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:81", flash_rows,
            flash_rows["e_lm_path_llama3_8b_b2_bf16"], "lm_llama3_8b",
            "llama3-8b prefill attention: B=2, H=32 (KV heads repeated), "
            "S=2048, D=128, causal, bf16"),
        row("flash_attention_bwd",
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/nn/flash.py:155 (_bwd, the custom VJP of flash_mha; "
            "jnp, no Pallas kernel)", train["rows"],
            train["rows"]["a_qwen1.5_0.5b_train_bf16"],
            f"train_{TRAIN_ARCH}",
            "qwen1.5-0.5b training attention backward: B=8, H=16, S=2048, "
            "D=64, causal, bf16; two launches (dQ with delta, dK/dV)"),
    ]
    kernels[-1]["instantiations"] = train["build"]
    kernels[-2]["instantiations"] = flash_build
    kernels[0]["instantiations"] = lf_build
    # mp_scatter.cu's instantiations: the sum's and the multi sweep's
    kernels[2]["instantiations"] = {k: v for k, v in scatter_build.items()
                                    if " sum " in k}
    kernels[3]["instantiations"] = {k: v for k, v in scatter_build.items()
                                    if " multi " in k}
    kernels[1]["instantiations"] = {
        k: v for k, v in pipeline_build.items()
        if not k.startswith("seg_softmax")}
    kernels[4]["instantiations"] = {
        k: v for k, v in pipeline_build.items()
        if k.startswith("seg_softmax")}
    kernels[5]["instantiations"] = {
        k: v for k, v in nt_build.items() if k.startswith("nt_mlp")}
    kernels[6]["instantiations"] = {
        k: v for k, v in nt_build.items() if k.startswith("fused")}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
