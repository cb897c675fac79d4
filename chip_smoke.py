#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

It drives the port's two main paths and holds every CUDA kernel of each
against its plain-PyTorch version:

- the paper's graph path: bfs/bsp, bfs/fast, pagerank/bsp and
  pagerank/fast through ``GraphEngine.program`` on a urand graph cut
  into P vertex blocks stacked on the card (kernels ``spmv_ell``,
  ``bfs_pull``);
- the rest of the BSP suite: sssp, cc, kcore and betweenness on the same
  partitions, triangles on an 8192-vertex urand graph, and bfs/fast, sssp
  and betweenness batched over four roots (kernel ``spmv_ell`` on
  betweenness's two combines, ``bfs_pull`` on batched bfs/fast);
- async supersteps and the incremental programs: bfs/async, sssp/async,
  cc/async and pagerank/async (staleness 1 and 2), cc/incremental,
  kcore/incremental and pagerank/warm on the same partitions (kernel
  ``spmv_ell`` on pagerank/async's and pagerank/warm's push combines);
- the programs over ``torch.distributed``, one part a rank
  (``DistComm``): all sixteen over NCCL at one rank, and the eight that
  launch a kernel or use the async exchange over gloo at four ranks
  sharing the card (kernels ``spmv_ell`` and ``bfs_pull`` on every
  rank), and int8 gradient compression on the card;
- fault injection, guards and checkpoint/rollback recovery: bfs/fast,
  pagerank/bsp, pagerank/fast, betweenness, bfs/async and pagerank/async
  guarded, checkpointed and recovered from a seeded drop + corrupt +
  stall schedule on the parts-4 partition (kernels ``spmv_ell`` and
  ``bfs_pull`` on the recovered runs);
- observability: every registered program's ``telemetry=True`` build
  beside its plain one on the same partitions, traced recovered runs of
  bfs/fast and pagerank/fast, and one Chrome trace of them all (kernels
  ``spmv_ell`` and ``bfs_pull``);
- the graph query server: ``serve.GraphServer`` over every registered
  program and ``launch/graph_serve.py::run`` replaying a Poisson trace
  (kernels ``spmv_ell`` and ``bfs_pull`` on the served pagerank,
  betweenness and bfs/fast queries);
- dynamic graphs and durability: ``GraphServer.mutate`` patching the
  resident graph in place, the rebuild path, a write-ahead-logged server
  recovered with ``GraphServer.recover``, and the launcher's replay under
  a mutation stream (kernels ``spmv_ell`` and ``bfs_pull`` over the
  patched and rebuilt ELL views);
- the graph dry-run: ``core/dryrun.py`` plans all sixteen programs of
  urand28 at 256 and 512 parts on meta tensors, then plans bfs/fast,
  pagerank/bsp and pagerank/fast on meta copies of the resident urand22
  arrays and runs the same static-trip builds on the card (kernels
  ``spmv_ell`` and ``bfs_pull``);
- LM token serving: ``launch/serve.py::serve`` on TinyLlama-1.1B at full
  width, weights drawn from a seeded ``torch.Generator`` on the card
  (kernel ``flash_attention_fwd``, one launch per prefill layer);
- LM training: ``launch/train.py::train`` on TinyLlama-1.1B at full
  width and depth (kernel ``flash_attention_fwd`` with its ``lse``, in
  each layer's forward and its remat recompute; the backward is plain
  torch, as the reference's is plain JAX);
- LM serving of the other families: ``launch/serve.py::serve`` on
  phi3.5-moe (depth cut to 4 layers), mamba2-1.3b (12 of 48), zamba2-7b
  (13 of 81), whisper-small and internvl2-1b at full width (kernel
  ``flash_attention_fwd`` at each of their attention shapes; none in
  mamba2);
- LM training of the other families: ``launch/train.py::train`` on
  phi3.5-moe (1 of 32 layers), mamba2-1.3b, zamba2-7b (18 of 81 mamba
  layers), whisper-small and internvl2-1b at full width (kernel
  ``flash_attention_fwd`` with its ``lse`` at their training shapes:
  non-causal, Sq != Sk, head dims 64, 112 and 128; none in mamba2);
- the sharded LM steps: ``launch/train.py::train(mesh=)``, prefill and
  decode of TinyLlama-1.1B (2 of 22 layers), phi3.5-moe, mamba2-1.3b,
  zamba2-7b, whisper-small and internvl2-1b at full width (depths cut)
  over a (data 2, model 2) mesh of four gloo ranks sharing the card,
  DTensor shardings and the train and inference policies (kernel
  ``flash_attention_fwd`` on every rank, on its own heads; none in
  mamba2);
- the LM dry-run: ``launch/steps.py::lower_cell`` plans, on meta
  tensors, the cells the phases above ran on the card, then
  ``launch/dryrun.py --arch`` plans registry cells on the host, one
  device of TinyLlama's sharded plan at 256 and 512 devices among them.

Phases, each of which raises on failure (the run then exits non-zero and
prints no result):

  card     the card's name and power limit, as nvidia-smi gives them.
  build    every kernel compiled from src/repro_torch/kernels/*/csrc, all
           at once (one nvcc per source), and, with --parent DIR, the
           graph kernels of the checkout at DIR (the first design, one
           launch a bucket, or this one's bucket-table interface; any
           other fails at load); registers and spill stores of
           each kernel instantiation, any ptxas warning, and any note
           that ptxas serialized a kernel's wgmma products.
  parity   each kernel against its plain version on the card: the shape
           sweeps of the JAX package's kernel tests, then every ELL bucket
           of the main-path graph one by one (ell_in, ell_dst, ell_out and
           ell_src for spmv_ell, ell_in for bfs_pull), then each ELL
           structure in one multi-bucket call.  Both graph kernels must
           match exactly (spmv_ell adds a row's slots left to right, as
           ref.py does: equal bits).
  main     the four programs once in local-ops mode ``auto`` (the
           kernels) at each parts count, launch counters zeroed just
           before and read just after: spmv_ell must launch once per
           spmv_pull or scatter_combine(add) call (a round of
           pagerank/bsp or pagerank/fast) and bfs_pull once per
           frontier_pull call (a round of bfs/fast).  BFS parents must
           equal the min-id in-neighbor one BFS level up (levels from a
           scipy sparse BFS) for both variants and every parts count;
           ranks must be within 1e-4 relative of a float64 scipy power
           iteration of the same round count; rounds must be equal across
           parts counts.
  plain    the same programs in mode ``ell`` (no kernels) on the card:
           parents and ranks bit-identical, rounds equal.
  times    per-program ms in both modes (median of 3 after a warm-up run),
           and each kernel at the main path's inputs beside its plain
           version, its bound and, for spmv_ell, a torch.sparse CSR
           matvec of the same function (timed here only; the port never
           calls it): spmv_ell over one call's buckets per structure
           (ell_in, ell_dst, and ell_out as a betweenness backward round
           calls it), with each bucket alone (rows, K, ms, gathers per
           second);
           bfs_pull over one bfs/fast run, round by round (push ``u`` or
           pull ``l``, live rows, ms).  With --parent, the same
           per-bucket and per-round lines of the parent's kernels on the
           same inputs, each result first held against the plain version
           (spmv_ell within SPMV_TOL, bfs_pull exactly).
  bsp      host references first (numpy / scipy, one CSR of the graph):
           Dijkstra under the synthesized weights, min-id weakly connected
           components, threshold peeling of the undirected multigraph, a
           float64 Brandes.  Then sssp, cc, kcore and betweenness in mode
           auto at each parts count, launch counters zeroed just before and
           read just after: spmv_ell launches once a round per launch
           table, forward rounds over ell_dst plus backward rounds over
           ell_out (the phases' rounds from a phase-wise run), the other
           programs launch nothing.  Outputs bit-identical to mode ell;
           sssp within 1e-5 relative (1e-4 absolute) of Dijkstra, labels,
           cores, kmax and peeling rounds exact, betweenness dist exact,
           sigma within 1e-6 relative (path counts below 2^24, exact in
           float32), bc within 1e-4 relative and absolute.  Triangles at 8192 vertices,
           parts 1 and 4: counts and total equal scipy's A o (A @ A).  Per
           program ms in both modes.  Then bfs/fast, sssp and betweenness
           batched over roots 0-3 (counters zeroed around the batched
           calls): each row and its rounds equal the single-source run
           with that root, and the batched call launches what those runs
           launched.
  async    a float64 PageRank run to convergence on the host, then at each
           parts count, launch counters zeroed just before and read just
           after each group: bfs/async, sssp/async and cc/async in mode
           auto (parents, dist and labels bit-identical to the bfs/fast,
           sssp and cc runs above, rounds within the registry's slack
           1.5 x BSP rounds + 4, one host sync a round, no kernel) and
           pagerank/async at staleness 1 and 2 (ASYNC_PR_PARAMS: rounds
           under the cap, rank within 1e-4 relative of the converged
           float64, max_age <= 2 x staleness + 1, spmv_ell launched rounds
           + 1 times, one sync a refresh); then cc/incremental and
           kcore/incremental from their cold seeds and from cc's labels and
           kcore's cores (outputs equal cc's and kcore's), and pagerank/warm
           from pagerank/fast's ranks (within 1e-4 of the converged float64,
           spmv_ell once a round).  Every run again in mode ell:
           bit-identical, equal rounds, no launch.  ``[async]`` lines: per
           run rounds, ms in modes auto and ell (median of 3 after the
           checked run), syncs, wire bytes per round by op, and the BSP
           sibling's ms and rounds from this run; ``[async done]`` the
           phase's seconds.
  dist     first the case for ``partitioned.part_sums``: how many rows
           of DIST_SPLIT_DRAWS seeded (DIST_WORLD, n_local) float32
           fields differ in bits between one batched row sum and one
           row at a time (``[dist] part sums`` line).  Then the
           programs and the guarded runs of bfs/fast and pagerank/bsp
           under DIST_CHAOS, over ``torch.distributed`` (``DistComm``,
           one part a rank) in mode auto, each against the same run over
           ``StackedComm`` on the same partitions, launch counters zeroed
           around each run.  One rank over NCCL at parts 1 in this
           process, all sixteen programs (triangles on the TRI_N-vertex
           graph): outputs bit for bit, rounds, guard verdicts, wire by
           (phase, op) and launches equal, each program's one checked
           run timed through both comms (after a warm-up of
           DIST_WARMUP).  Then DIST_PROGRAMS (the programs that
           launch a kernel or use the async exchange) on DIST_WORLD gloo
           ranks at parts DIST_WORLD, all on the one card (NCCL takes a
           card a rank):
           each rank a process of this script (``--dist-rank``) that
           loads its part from a file this process wrote
           (``GraphShards.take_part``), so no rank partitions the graph;
           every rank's exit code is checked, within DIST_TIMEOUT_S.
           Rank 0's gathered outputs bit for bit and every rank's digest
           of them, rounds, verdicts, wire and launches equal
           StackedComm's at parts DIST_WORLD, spmv_ell and bfs_pull
           launch on every rank, and the ops gloo staged through pinned
           host memory are printed.  The same ranks then run, each
           against the stacked run at parts DIST_WORLD computed here
           first: DIST_RECOVERY through ``CheckpointRunner`` at
           CHAOS_EVERY under the chaos phase's schedule (outputs,
           rounds, detections, recoveries, checkpoints equal; bfs/fast
           resumed from each rank's middle checkpoint; bfs/async's
           checkpoints hold its exchange in flight), ``[dist-recovery]``
           lines; a rank server (rank 0 leads) serving DIST_SERVED at
           the first two rungs of SERVE_ROOTS and a pagerank/fast
           refresh (rank 0's answers equal, the others return none),
           ``[dist-serve]`` lines; and a durable rank server on
           DIST_DURABLE_GRAPH's parts (MUTATE_DURABLE's batches sampled
           on the ranks, then a rebuilding batch), closed and recovered
           with ``GraphServer.recover(mesh=)`` (the WAL's bytes, every
           rank's mirrors and planner before and after recovery equal
           the stacked server's part), ``[dist-durable]`` line.  Each
           line gives ms or s a rank and a rank snapshot's bytes.  Then
           ``compress_tree`` over a seeded
           tree of the shapes of one TinyLlama layer and its embeddings,
           with a seeded carried residual: payloads, scales and
           residuals on the card bit-equal to the CPU's.  ``[dist]``
           lines: rounds, ms per comm, launches; ``[dist done]`` the
           phase's seconds.
  chaos    at parts 4 in mode auto, launch counters zeroed around each
           program: bfs/fast, pagerank/bsp, pagerank/fast, betweenness,
           bfs/async and pagerank/async (staleness 1, ASYNC_PR_PARAMS).
           Guarded with no schedule: ok, rounds and outputs bit-identical
           to the program's run in the phases above, the same launches as
           an unguarded run, at most one more ``Tensor.item`` call a round
           (init included).  ``CheckpointRunner(checkpoint_every=2)``
           clean: no recovery, bit-identical; for bfs/fast and
           pagerank/fast also resumed from the middle snapshot,
           bit-identical.  Chaos: ``drop@r{r1}p0 corrupt@r{r2}p1
           stall@r{r3}p0x2 seed=7`` (r1..r3 = 1, 2, 3 clipped to the run's
           rounds, as tests/test_chaos.py does): at least one detection
           and one recovery, outputs bit-identical, and the program's
           kernel launched in the recovered run.  ``[chaos]`` lines: ms
           unguarded and guarded (median of 3), checkpointed and
           recovered (the checked runs), syncs a round, snapshots, bytes
           and ms a snapshot, detections and recoveries; ``[chaos done]``
           the phase's seconds.
  obs      at parts 1 and 4 in mode auto (triangles on the TRI_N-vertex
           graph), launch counters zeroed at the start: every registered
           program (registry defaults; pagerank/async and pagerank/warm at
           ASYNC_PR_PARAMS, pagerank/warm from pagerank/fast's ranks, the
           other incremental programs from their cold seeds) run plain,
           with each round's halt test and probes read from its state,
           then through its ``telemetry=True`` build: outputs and rounds
           bit-identical, the series' rounds equal, its last halt 1
           unless the run hit max_rounds, its halt and probe columns
           exactly the plain run's values, and the ``Tensor.item`` count
           and kernel launches equal with telemetry on and off.  Then at
           parts 4 ``CheckpointRunner(telemetry=True, obs=SpanRecorder())``
           runs of bfs/fast and pagerank/fast under the chaos phase's
           schedules: detections and recoveries equal the chaos phase's,
           one fault_detection and one rollback event each and a
           checkpoint event a snapshot, ``telemetry["rounds"]`` the clean
           rounds, outputs bit-identical to the clean run, the program's
           kernel launched.  Then one Chrome trace of the layer spans
           every telemetry run and recovered run recorded (a track per
           layer) and the runner's spans and events, validated and
           written to build/obs/chip_smoke.json.  ``[obs]`` lines:
           rounds, wall ms and mean round ms of the telemetry run, ms with
           telemetry off and on (median of 3 each), syncs, launches, wire
           bytes a round by op; the recovered runs' events; the trace's
           events per ``ph``; ``[obs done]`` the phase's seconds.
  serve    at parts 1 and 4 in mode auto (triangles on the TRI_N-vertex
           graph): a ``GraphServer(buckets=(1, 8, 32), depth=2)`` warmed
           for every registered program (registry defaults; pagerank/async
           and pagerank/warm at ASYNC_PR_PARAMS); each rooted program
           served roots 0, 0-7 and 0-9 in three closed-loop calls (rungs 1
           and 8 full, rung 32 padded), each refresh program once, then
           the three seeded programs from the warm seeds the refreshes
           left in the seed store.  Every result ok, on the ladder's rung,
           its fields and rounds bit-identical to a direct
           ``engine.program(...)`` call on the same input (batched bfs/fast
           against a ``direction="pull"`` run).  Then at SERVE_PARTS
           ``launch/graph_serve.run`` on the same partition replays
           SERVE_REPLAY (``bfs:8,sssp:4,cc:1``, 16 q/s, 8 s): every query
           ok; q/s and p50/p95/p99 a (program, bucket) cell beside the
           card line.  Then a traced session (``obs=SpanRecorder()``):
           every stage's span kind present, latency cells derived from the
           query spans equal ``ServeMetrics``', the Chrome trace validated
           and written to build/obs/chip_smoke_serve.json, the medians of
           the ``dispatch`` and ``device`` spans.  ``spmv_ell`` and
           ``bfs_pull`` launches counted from zero around the serving
           calls (not the direct ones), each > 0.  ``[serve]`` lines:
           served and direct ms per call; ``[serve done]`` the phase's
           seconds.
  mutate   on MUTATE_GRAPH, generated and partitioned for the phase (its
           servers write the host mirrors).  At parts 1 and 4: a
           ``GraphServer`` and its ``DynamicGraph`` (index
           build s and bytes, peak host RSS); cc, kcore and pagerank/fast
           served at epoch 0 (the warm seeds); a delete-only batch of
           MUTATE_BATCH sampled live edges (kcore/incremental warm equals
           cold kcore); a mixed batch of MUTATE_BATCH deletes and as many
           sampled insertable edges (slots and arrays patched, host and
           device patch ms apart, no rebuild), with a bfs/fast query
           admitted before it answering the pre-mutation parents; every
           patched device tensor equal to its host mirror, and spmv_ell on
           ell_in, ell_dst and ell_out and bfs_pull on ell_in each in one
           multi-bucket call, bit-equal to the plain version; bfs/fast,
           pagerank/bsp, pagerank/fast, sssp, cc and betweenness served at
           the new epoch (root 0) equal to direct calls bit for bit, and
           against host references on ``current_edges()`` (min-id level
           parents, Dijkstra within 1e-5, min-id components, float64
           power iteration within 1e-4); pagerank/warm from the warm and
           from the cold seed, each within 1e-4 of the converged float64;
           an insert-only batch (cc/incremental warm
           equals cold cc).  Then on MUTATE_REBUILD_GRAPH at both parts
           counts an edge inserted just past its free pools: the rebuild
           path, mirrors on the device, the kernels and the served checks
           on the new layout.  Then at SERVE_PARTS a durable server
           (fsync, MUTATE_DURABLE: 4 batches of 64 edges, snapshots every
           2 epochs; snapshot bytes and ms, WAL append ms) recovered in
           this process, then again with its newest snapshot removed
           (snapshot 2 + two WAL records replayed): epoch, edge digest,
           bfs/fast and pagerank/fast bit-identical both times.  Then ``launch/graph_serve.run`` replays
           SERVE_REPLAY with a 64-edge batch every 3 s and a WAL
           (MUTATE_REPLAY): every query ok, final epoch 2 (a delete
           batch, then an insert batch), q/s and
           p50/p95/p99 a cell, each mutation's s; recovered from its
           directory (a snapshot at epoch 2) to epoch 2 and the same edge
           digest.  ``spmv_ell`` and ``bfs_pull`` launches counted around
           the served and replayed queries, each > 0.  ``[mutate]`` lines;
           ``[mutate done]`` the phase's seconds.
  llm-parity  flash_attention_fwd against its plain version (ref.py) on
           the shapes of tests/test_kernels_flash.py (sweep x {causal,
           causal + window 64, non-causal}, cross lengths, softcap 20,
           D = 120 through ops) and at the edges of the bf16 design's
           tiles (FLASH_EDGES), each in f32 and bf16, then at TinyLlama's
           prefill shape; within 2e-5 (f32) and 2e-2 (bf16), the
           tolerances of those tests.
  llm-main serve() on TinyLlama-1.1B, batch 8, prompt 1024, gen 64, the
           launch counters zeroed just before and read just after: 22
           flash launches (one per layer of the prefill), all 22 of the
           bf16 tensor-core design; generated tokens in range.  The kernel
           at layer 0's real q, k, v within 2e-2 of ref.py.  Prefill
           logits through the kernel against forward_prefill(impl="naive")
           on the card, and decode step by step over a 256-token prompt
           against the last logits of prefill through the kernel and of
           prefill with naive attention: finite, the same argmax but for
           ties within one bf16 ulp of the reference (counted and printed
           with each row's top-two gap), and within LOGIT_MAX_TOL
           (largest) and LOGIT_MEAN_TOL (mean) of each other.
  llm-times prefill ms and decode tok/s (median of 3 serve runs after the
           main-path run), and the flash kernel at the prefill shape beside
           its bound, ref.py's time and scaled_dot_product_attention's
           (timed here only; the port never calls it), the same at the
           head dims 128 and 120 (FLASH_WIDTHS); then one serve call
           with 8 decode steps under torch.profiler: device busy share and
           the kernels that take most.

  dryrun   (between serve and mutate) urand28 planned at 256 and 512
           parts, sixteen programs each, on meta tensors: each program's
           HBM a part and bottleneck (v5e and H100 terms); then at parts 1
           and 4 of urand22 bfs/fast, pagerank/bsp and pagerank/fast
           planned on meta copies of the resident arrays and run with the
           same static_iters on the card, through the kernels and on the
           ell route: planned argument bytes equal to the resident bytes,
           pagerank's planned exchanges equal to the run's, planned temp
           bytes beside the measured peaks; launches counted from zero.
  train    (after llm-times) TinyLlama-1.1B, default_train_config, batch
           8 x 1024: the kernel's lse at the training shape (o
           bit-identical with and without it; lse within LSE_TOL of
           ref.py; both timed), the plain flash backward at one layer's
           shape, step 0's loss and gradient leaves through the kernel
           against the plain chunked forward (TRAIN_LOSS_TOL; each leaf
           within TRAIN_GRAD_FACTOR x naive attention's gap to the plain
           forward), then train() for 6 steps from seeded weights
           with the launch counters zeroed (44 flash launches a step:
           each layer's forward and remat recompute), finite losses and
           grad norms, step-0 loss within 0.5 of ln 32000, ms a step,
           tokens/s and peak memory; a run to step 3 that writes a
           checkpoint (params, m and v in f32) and a run resumed from it
           to step 6 within rtol 1e-4 / atol 1e-5 of the uninterrupted
           one, with the write and read seconds.

  families (after train) each of FAMILIES in turn, seeded weights drawn
           on the card and freed after: serve() once with the launch
           counters zeroed around it (flash launches one an attention
           call of the prefill: 8 phi3.5-moe, 0 mamba2, 14 zamba2, 36
           whisper, 24 internvl2; all bf16), peak memory, served tokens
           in range; prefill ms and decode tok/s (median of 3 more serve
           calls); prefill logits through the kernel against
           impl="plain" on the card, and decode over FAMILY_STEPS tokens
           after a FAMILY_PREFIX-token prefill against a prefill over
           all of them, at every decoded position: max and mean within
           LOGIT_MAX_TOL / LOGIT_MEAN_TOL scaled to the logits' binade
           (logit_tols) or FAMILY_FLOOR_FACTOR x the same run's
           naive-vs-plain prefill difference, whichever is larger, and
           a changed argmax only where the reference scores the token
           within 2 x the max bound of its largest (family_diff).  For the
           MoE the share of (layer, token, k) choices that differ
           between the two runs is within FAMILY_FLOOR_FACTOR x the share
           between naive attention and the plain forward (the rounding
           floor, same run); its logits are held with the first run's
           routing replayed in the second, and its decode check runs at
           a capacity that drops nothing.  The kernel at every (q, k,
           options) its prefill met, on that call's real q, k, v, against
           ref.py (2e-2) and timed beside ref.py, SDPA and its bound; a
           torch.profiler serve call of 4 decode steps.

  train-families (after families) each of TRAIN_FAMILIES in turn at
           its depth, seeded weights drawn on the card and freed after:
           the resident bytes of its parameters, optimizer state and
           step-0 batch; step 0 through the kernel against impl="plain"
           and impl="naive" (the MoE's routing recorded in the kernel run
           and replayed in the other two, ``moe.route(choices=)``): the
           loss gap within TRAIN_LOSS_TOL or TRAIN_GRAD_FACTOR x naive's
           gap to plain, whichever is larger, each gradient leaf within
           TRAIN_GRAD_FACTOR x naive's gap (mamba2 has no attention and
           skips this, saying so); the kernel with ``return_lse`` at every
           (q, k, options) that step gave it (o bit-identical with and
           without lse, o within 2e-2 and lse within LSE_TOL of ref.py),
           timed beside ref.py, SDPA and its bound; then
           ``train()`` for TRAIN_FAMILY_STEPS steps of
           default_train_config with the launch counters zeroed (flash
           launches a step: 2 a stacked layer's attention call, forward
           and remat recompute, 4 a decoder block, 1 a shared-attention
           call, none in mamba2; all bf16), finite losses and grad norms,
           every parameter leaf changed, ms a step, tokens/s and peak
           bytes beside the card line.
  sharded  (after train-families) first one probe process a collective
           DTensor issues, each in a one-rank gloo group on a CUDA
           tensor (how each ended is printed; every one is staged
           through pinned host memory whatever it did, by backend and
           device).  Then each of SHARDED_RUNS at full width, depth cut:
           TinyLlama-1.1B (the dense family) and the MoE, SSM, hybrid,
           audio and vlm families (phi3.5-moe, mamba2-1.3b, zamba2-7b,
           whisper-small, internvl2-1b), batch SHARDED_BATCH, trained
           its steps by ``train()`` in this process through the kernel
           and through the plain forward (the bf16 floor; mamba2 has no
           attention and no floor), its prefill and decode through the
           kernel and naive attention; then the same steps by
           ``train(mesh=)`` on SHARDED_MESH, four gloo ranks sharing the
           card (``chip_smoke.py --sharded-rank``, one spawn for every
           run, a file rendezvous, exit codes checked within
           SHARDED_TIMEOUT_S; started with the phase, they take each
           arch once this process has run it, and ``lower_cell`` plans
           each train step at the mesh while they run; cuBLAS with
           full-precision reductions on both sides, as in the other LM
           phases).  Each arch: each rank's parameter, optimizer and
           batch shards (requested bytes around drawing them, and the
           shards' own bytes) equal to the plan's argument bytes; flash
           launched a train step's calls (``train_flash_calls``) on
           every rank at (B/2 * H/2, S, D); the losses within 1e-3 of
           the one-process run and every leaf within rtol 3e-3 / atol
           3e-4 (or twice the floor); what the steps did, by relative
           norms, which do not shrink with the warmup's learning rates:
           each step's gradient norm within SHARDED_GNORM_TOL and each
           leaf's update (trained minus initial) within
           SHARDED_DELTA_TOL of the one-process update (or twice their
           floors); phi3.5-moe with the one-process run's routing
           replayed on each rank's own groups, since a flipped choice
           moves its tokens by a whole expert.  TinyLlama's parameters
           are also saved from the mesh (equal to the ranks' shards) and
           restored onto (4, 1), equal.  Then prefill and
           SHARDED_DECODE decode steps on the mesh under the inference
           policy from the seeded initial weights (the cache the mesh's
           prefill built, gathered, padded and laid out by
           ``cache_shardings``), flash launched once a layer's
           attention call on every rank, the logits against one
           process's: TinyLlama's within llm-main's bounds, the other
           families' within [families]' (``family_diff`` against the
           naive floor), phi3.5-moe's own prefill routing flipping at
           most SHARDED_FLOOR_FACTOR x the naive-vs-kernel share.
           ``[sharded]`` lines: the probes and the ops staged, and
           TinyLlama's; ``[sharded-families]`` lines by family: losses,
           leaf gaps, grad norms, update gaps, ms a step by rank beside
           the one-process ms, bytes, planned collectives, peak bytes
           by rank, the serving logits' gaps; ``[sharded done]`` the
           phase's seconds.
  dryrun-lm (last) ``lower_cell`` plans on meta tensors each cell the
           card ran: llm-main's prefill, train's 8 x 1024 step, the
           train-families steps and the families' prefills, with the
           parameters in the dtype the run held: planned argument bytes
           equal to the bytes the run held resident (requested bytes of
           the caching allocator, read around drawing them), and the
           planned peak (arguments plus temps, the plain attention
           route's) not under the run's requested peak, the ratio and
           max_memory_allocated printed.  The passes of
           ``launch/dryrun.py --arch ...`` over DRYRUN_LM_PASSES start
           on the host when this phase starts, after the last timed
           phase (a pass of 5 worker processes at --mesh single, and
           TinyLlama's train_4k at --mesh pod and at --mesh multipod,
           beside the plans above), and are waited for: records in
           build/dryrun_lm, each cell's plan seconds and bottleneck; a
           sharded record's argument bytes a device equal to its
           shards' bytes (``param_shardings``, ``batch_shardings``,
           AdamW's state), its collective wire printed.

The last three lines are the kernels' JSON record, the card line, and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import gc
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

PROGRAMS = (("bfs", "bsp"), ("bfs", "fast"), ("pagerank", "bsp"),
            ("pagerank", "fast"))
INT_INF = 2 ** 30
ALPHA = 0.85
ROOT = 0
SEED = 42
GRAPH = "urand22"        # 4M vertices, 67M edges: the paper's urand family
PARTS = (1, 4)           # vertex blocks, all stacked on the one card

SPMV_TOL = 1e-5          # rtol = atol, cuSPARSE CSR matvec vs the kernel
PR_F64_TOL = 1e-4        # max rel err of ranks vs float64 power iteration

# the rest of the BSP suite (triangles on its own graph) and multi-source
BSP_PROGRAMS = ("sssp", "cc", "kcore", "betweenness")
TRI_N = 8192             # the largest graph triangles' n_budget admits
MULTI = (("bfs", "fast"), ("sssp", "default"), ("betweenness", "default"))
MULTI_ROOTS = (0, 1, 2, 3)
SSSP_RTOL, SSSP_ATOL = 1e-5, 1e-4     # tests/oracle.py's sssp check
# async supersteps and the incremental programs
ASYNC_MONOTONE = ("bfs", "sssp", "cc")
ASYNC_STALENESS = (1, 2)
# pagerank/async and pagerank/warm run to convergence: at parts > 1 the
# stale remote term slows pagerank/async to about 0.91 a round (188 and
# 202 rounds to 1e-7 at urand16 parts 4, staleness 1 and 2, on the CPU;
# the float32 residual fell below 1e-9 there), and 1e-7 keeps the ranks
# far inside 1e-4 of the converged float64
ASYNC_PR_PARAMS = {"iters": 300, "tol": 1e-7}
# the chaos phase: programs (with their params), at the parts count where
# exchanges cross parts; resumed from a middle snapshot where
# CHAOS_RESUME (pagerank/async would keep ~95 snapshots of ~0.1 GB)
CHAOS_PARTS = 4
CHAOS_PROGRAMS = (("bfs", "fast", {}), ("pagerank", "bsp", {}),
                  ("pagerank", "fast", {}), ("betweenness", "default", {}),
                  ("bfs", "async", {}),
                  ("pagerank", "async", {"staleness": 1}))
CHAOS_RESUME = (("bfs", "fast"), ("pagerank", "fast"))
CHAOS_EVERY = 2
INCREMENTAL = (("cc", "incremental"), ("kcore", "incremental"),
               ("pagerank", "warm"))
# the obs phase: recovered runs traced at CHAOS_PARTS, and the Chrome
# trace it writes (build/ is not committed)
OBS_RECOVERED = (("bfs", "fast"), ("pagerank", "fast"))
OBS_TRACE = HERE / "build" / "obs" / "chip_smoke.json"
# the serve phase: a GraphServer a parts count over every registered
# program (rooted ones served roots 0, 0-7 and 0-9: rungs 1 and 8 full,
# rung 32 padded), then the launcher's replay of the issue's mix and a
# traced session at SERVE_PARTS
SERVE_BUCKETS = (1, 8, 32)
SERVE_ROOTS = ((0,), tuple(range(8)), tuple(range(10)))
SERVE_PARTS = 4
SERVE_REPLAY = {"mix": "bfs:8,sssp:4,cc:1", "duration": 8.0, "rate": 16.0,
                "buckets": (1, 8, 32, 128), "depth": 2, "zipf_s": 1.05,
                "seed": SEED}
SERVE_TRACE = HERE / "build" / "obs" / "chip_smoke_serve.json"
SERVE_STAGES = ("admission", "validate", "coalesce_wait", "dispatch",
                "device", "demux", "query")
# the mutate phase, on MUTATE_GRAPH partitioned for it at each parts
# count: patch batches of MUTATE_BATCH edges a half (delete-only, mixed,
# insert-only: a urand graph has no COO slack at parts 1, so deletes come
# first), the programs served after them, the rebuild path on
# MUTATE_REBUILD_GRAPH (partitioned in seconds), a durable server at
# SERVE_PARTS (MUTATE_DURABLE) and the launcher's replay under churn
# (MUTATE_REPLAY: a delete batch at 3 s and an insert batch at 6 s of its
# 8 s trace; a snapshot at its last epoch, 2, so its recovery replays no
# record: the durable server's test does).  MUTATE_GRAPH is a quarter of
# GRAPH: at urand22 the phase's host work (oracles on 67M edges, 3.1 GiB
# snapshots, a 50 s rebuild in the replay) took 343-420 s of the run.
MUTATE_GRAPH = "urand20"
MUTATE_BATCH = 4096
MUTATE_SERVED = ("bfs/fast", "pagerank/bsp", "pagerank/fast", "sssp", "cc",
                 "betweenness")
MUTATE_REBUILD_GRAPH = "urand18"
MUTATE_DIR = HERE / "build" / "persist"
MUTATE_DURABLE = {"batches": 4, "size": 64, "snapshot_every": 2}
MUTATE_REPLAY = {**SERVE_REPLAY, "mutate_every": 3.0, "mutate_size": 64,
                 "snapshot_every": 2}
DIST_DIR = HERE / "build" / "dist"    # part hand-off files, rank logs
DIST_WORLD = 4           # gloo ranks sharing the card, one part each
DIST_TIMEOUT_S = 420     # a rank still running then fails the phase
DIST_CHAOS = "drop@r1p0 corrupt@r2p1"
DIST_CHAOS_PROGRAMS = (("bfs", "fast"), ("pagerank", "bsp"))
DIST_WARMUP = (("bfs", "fast"), ("pagerank", "bsp"))
# the programs over DistComm: those that launch a kernel or use the async
# exchange (the other eight run over StackedComm in every earlier phase)
DIST_PROGRAMS = (("bfs", "fast"), ("pagerank", "bsp"),
                      ("pagerank", "fast"), ("betweenness", "default"),
                      ("bfs", "async"), ("sssp", "async"), ("cc", "async"),
                      ("pagerank", "async"))
DIST_SPLIT_DRAWS = 4     # seeded fields part_sum_split reduces both ways
# the same rank spawn then runs [chaos]'s schedule (clipped to each run's
# rounds) through CheckpointRunner on three programs, bfs/async with an
# exchange in flight at every checkpoint; a rank server (rank 0 leads)
# over the serve phase's first two rungs and a pagerank/fast refresh;
# and a durable rank server on MUTATE_REBUILD_GRAPH's parts
# (MUTATE_DURABLE, then a rebuilding batch), recovered on the ranks
DIST_RECOVERY = (("bfs", "fast"), ("pagerank", "bsp"), ("bfs", "async"))
DIST_SERVED = ("bfs/fast", "sssp", "cc")
DIST_SERVE_BUCKETS = (1, 8)
DIST_DURABLE_GRAPH = MUTATE_REBUILD_GRAPH
ASYNC_SIBLING = {"bfs/async": "bfs/fast", "sssp/async": "sssp",
                 "cc/async": "cc", "pagerank/async": "pagerank/fast",
                 "cc/incremental": "cc", "kcore/incremental": "kcore",
                 "pagerank/warm": "pagerank/fast"}
SIGMA_RTOL = 1e-6        # path counts (tests/oracle.py)
BC_TOL = 1e-4            # rtol = atol of dependencies (tests/oracle.py)
HBM_SECTOR = 32          # bytes an HBM gather moves at the least
L2_BYTES = 50 * 2 ** 20  # H100 L2 cache

# NVIDIA H100 SXM published peaks (data sheet; at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12    # float32 outside the tensor cores

# shape sweeps of tests/test_kernels_spmv.py and test_kernels_frontier.py
# (rows, K, n_cols), plus a hub-width row block as rmat graphs have
SPMV_SWEEP = ((256, 8, 512), (512, 16, 1024), (1024, 4, 256),
              (256, 32, 2048), (128, 1, 128), (128, 1024, 4096))
FRONTIER_SWEEP = ((256, 8, 512), (512, 16, 1024), (128, 4, 4096),
                  (1024, 2, 128), (128, 1024, 4096))

SPMV_REPLACES = "src/repro/kernels/spmv/kernel.py:36"
BFS_REPLACES = "src/repro/kernels/frontier/kernel.py:41"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:80"

# the graph dry-run: every program planned on meta tensors at the
# paper's largest graph and production part counts; then bfs/fast and
# pagerank's two programs planned on meta copies of the resident urand22
# arrays and run with the same static trip counts on the card
DRYRUN_GRAPH = "urand28"
DRYRUN_MEASURED = (("bfs", "fast"), ("pagerank", "bsp"), ("pagerank", "fast"))

# LM serving at TinyLlama-1.1B's full width (all 22 layers)
LLM_ARCH = "tinyllama-1.1b"
LLM_BATCH, LLM_PROMPT, LLM_GEN = 8, 1024, 64
LLM_DECODE_PROMPT = 256   # prefill-vs-decode check
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels_flash
# Full-width logit checks.  The kernel path, the naive path and decode
# compute the same bf16 logits (|logit| up to about 4) with other rounding
# points (p rounded before or after normalising, other summation orders):
# an attention output may differ by a bf16 ulp per layer, and the
# difference grows with depth.  So each check bounds the largest difference
# at 16 bf16 ulps of logits in [2, 4), the mean difference, which a wrong
# mask or scale would raise everywhere, and the argmax of every row; the
# kernel itself is held to 2e-2 on this run's real layer-0 q, k, v.  A row
# whose two top logits are one bf16 ulp apart is a tie that two rounding
# schemes may break either way, so a row may take another token only where
# the reference scores it within one bf16 ulp of its largest (logit_diff).
LOGIT_MAX_TOL = 0.25
LOGIT_MEAN_TOL = 0.03
# the kernel's f32 log-sum-exp against ref.py's: f32 scores of the same
# products in another order, base-2 exponentials and log of 2 ulp
LSE_TOL = 1e-3
# LM training at full width and depth: default_train_config (grad_accum
# 1), batch 8 x 1024 tokens from TokenStream, 6 steps; a checkpoint of
# step 3 resumed to step 6 within the reference test's tolerance
# (tests/test_system.py: rtol 1e-4, atol 1e-5); the card's embedding and
# gather backwards may sum in another order from run to run
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_AT = 8, 1024, 6, 3
TRAIN_DIR = HERE / "build" / "ckpt_smoke"
RESUME_RTOL, RESUME_ATOL = 1e-4, 1e-5
# the kernel forward's step-0 loss and gradients against the plain
# chunked forward's, on the card.  The two forwards round differently
# (the kernel keeps its accumulator in f32, the plain one in bf16), so an
# attention output may differ by a bf16 ulp (0.39%) a layer, and the
# difference flows through 22 bf16 layers and their backward.  Gradient
# leaves are compared in relative norm against the noise floor of that
# computation, measured in the same run: the gap between two plain
# attentions that differ only in rounding points (the chunked forward
# and naive attention's materialized softmax).  The kernel's gap may be
# at most TRAIN_GRAD_FACTOR times the floor's, leaf by leaf.
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_FACTOR = 2.0
BF16_TC_OPS_PER_S = 989e12     # H100 SXM bf16 dense tensor-core peak
# (bh, s, d) sweep of tests/test_kernels_flash.py
FLASH_SWEEP = ((2, 256, 128), (4, 512, 128), (1, 128, 256))
# (bh, sq, sk, d, causal, window, softcap) at the edges of the bf16
# design's tiles (128-row q tiles; k tiles of 128, 64 or 32 keys; head
# dims padded to 64, 128 or 256): several q tiles, Sq != Sk both ways, a window
# ending inside a tile, rows with no key in their window, head dims on
# each side of the padded widths, softcap under causal masking
FLASH_EDGES = ((2, 1000, 1000, 64, True, 0, 0.0),
               (2, 1024, 1024, 128, True, 0, 0.0),
               (2, 700, 300, 64, True, 0, 0.0),
               (2, 300, 700, 128, True, 0, 0.0),
               (2, 500, 500, 64, True, 100, 0.0),
               (2, 600, 200, 64, True, 50, 0.0),
               (2, 400, 400, 128, True, 0, 30.0)) + tuple(
    (2, 200, 200, d, True, 0, 0.0) for d in (8, 72, 120, 136, 200, 256))
# timed beside the prefill shape: (BH, S, D) bf16 causal at the head dims
# of qwen2.5 / gemma3 (128) and danube3 (120), 64 heads of S = 1024
FLASH_WIDTHS = ((64, 1024, 128), (64, 1024, 120))
# LM serving of the other families at full width, seeded weights, through
# launch/serve.py: (arch, batch, prompt, gen, layers kept or None for the
# full depth).  phi3.5-moe is cut to 4 of its 32 layers: at f32 a layer
# holds 16 x 3 x 4096 x 6400 expert weights (5.0 GB), 32 layers would be
# 166 GB; 8 layers (43 GB) fit.  The run's time cut phi3.5-moe from 8
# layers, mamba2 from all 48 to 12 (it trains at full depth in
# train-families) and zamba2 from all 81 mamba layers to 13 (three
# shared-block calls): at full depth the two took about 87 s more of a
# run that reached 1,248 s on a slower host (PERF.md).  internvl2's
# prompt is 768 text tokens after its 256 vision tokens.
FAMILIES = (("phi3.5-moe-42b-a6.6b", 8, 1024, 16, 4),
            ("mamba2-1.3b", 8, 1024, 16, 12),
            ("zamba2-7b", 4, 1024, 16, 13),
            ("whisper-small", 8, 256, 16, None),
            ("internvl2-1b", 8, 768, 16, None))
# decode against prefill: prefill FAMILY_PREFIX tokens, decode
# FAMILY_STEPS more teacher-forced, and hold the last step's logits
# against a prefill over all of them (240 and 256 are whole SSD chunks
# of 256: min(256, S) divides S)
FAMILY_PREFIX, FAMILY_STEPS = 240, 16
# The families' logit checks hold the kernel path against impl="plain"
# and decode against prefill.  At these depths (MoE layers with
# logits up to 7; 12 and 13 mamba layers) two paths that differ only in
# bf16 rounding points differ by several ulps of the logits, so each
# bound is the larger of TinyLlama's (LOGIT_MAX_TOL / LOGIT_MEAN_TOL,
# scaled to the logits' binade: logit_tols) and FAMILY_FLOOR_FACTOR
# times the noise floor measured in the same run: naive attention's
# materialized softmax against the plain chunked forward, on the same
# prompt.  A wrong kernel moves the logits by far more than that.
#
# MoE routing: a near-tie between an expert and the next flips between
# two such paths, and a flipped token's residual moves by a whole
# expert's output, which flips more of its choices in the layers after.
# The share of (layer, token, k) choices that differ may be at most
# FAMILY_FLOOR_FACTOR times the share between naive attention and the
# plain forward.  The logits of the tokens whose routing agrees are
# reported but not held: attention couples them to the tokens that
# flipped (on the H100 they differed by up to 3.5, at logits up to 7.3).
# The logits are held with the first run's routing replayed in the
# second (``moe.route(choices=)``), so the two differ in rounding only.
FAMILY_FLOOR_FACTOR = 2.0
# LM training of the other families at full width through
# launch/train.py: (arch, batch, text tokens, layers kept or None for the
# full depth), TRAIN_FAMILY_STEPS steps of default_train_config each.
# Depths by memory: the functional AdamW holds p, g, m, v and the new p,
# m, v, about 28 B a parameter (TinyLlama: 40.34 GB at 1.10 B).
# phi3.5-moe keeps 1 of 32 layers (1.56 B parameters with its
# embeddings), zamba2 18 of 81 mamba layers (hybrid_attn_every 6 kept:
# three shared-block calls).  dbrx-132b does not fit: one layer and its
# embeddings are 72 GB of state before the new trees.  internvl2's 768
# text tokens follow its 256 vision tokens.
TRAIN_FAMILIES = (("phi3.5-moe-42b-a6.6b", 8, 1024, 1),
                  ("mamba2-1.3b", 8, 1024, None),
                  ("zamba2-7b", 4, 1024, 18),
                  ("whisper-small", 8, 256, None),
                  ("internvl2-1b", 8, 768, None))
TRAIN_FAMILY_STEPS = 3
# the LM dry-run CLI on the card's host (8 cores): every arch's train_4k
# cell and every cell of two archs (the whole registry takes longer than
# the run has: PERF.md), the two passes at once with (arch list, shape
# list, worker processes) each, the costliest cells first; they start
# with the dryrun-lm phase, after every timed phase, and seven workers
# leave a core to that phase's own plans
# the dry-run CLI's passes: (archs, shapes, mesh, worker processes).  The
# SSM, audio and vlm archs on one card (each plans in under 20 s on the
# card machine's host; this phase plans the MoE's and the hybrid's cells
# the card ran), and TinyLlama's sharded plan at pod and multipod
DRYRUN_LM_PASSES = (
    ("mamba2-1.3b,whisper-small,internvl2-1b", "train_4k", "single", 3),
    ("tinyllama-1.1b", "train_4k", "pod", 1),
    ("tinyllama-1.1b", "train_4k", "multipod", 1))
DRYRUN_LM_DIR = HERE / "build" / "dryrun_lm"
# the sharded LM steps: each family at full width, depth cut, on a
# (data 2, model 2) mesh of gloo ranks sharing the card (NCCL takes a
# card a rank), DTensor shardings and the train policy; held against the
# same seeded steps in one process within tests/test_system.py's
# tolerances (loss 1e-3; rtol 3e-3, atol 3e-4) or twice the bf16 floor.
# In its first steps (default_train_config's warmup: learning rates 3e-6
# to 9e-6) AdamW moves a weight by about the learning rate, far under
# that atol, so what the steps do is held by relative norms, which do
# not scale with the learning rate: each step's gradient norm and each
# leaf's update p_after - p_before against the one-process run's,
# within tests/test_torch_sharded_train.py's bounds or twice the floor
SHARDED_DIR = HERE / "build" / "sharded"
SHARDED_MESH = (2, 2)
SHARDED_TIMEOUT_S = 600  # a rank still running then fails the phase
SHARDED_PROBE_S = 120
SHARDED_LOSS_TOL = 1e-3
SHARDED_RTOL, SHARDED_ATOL = 3e-3, 3e-4
SHARDED_GNORM_TOL, SHARDED_DELTA_TOL = 5e-4, 0.3
SHARDED_FLOOR_FACTOR = 2.0
# then prefill and decode on the mesh under the inference policy: the
# prompt's last logits and SHARDED_DECODE steps on a cache of the prompt
# and SHARDED_CTX_PAD more positions, laid out by cache_shardings
SHARDED_DECODE, SHARDED_CTX_PAD = 2, 64
# (arch, layers kept, text tokens, steps) at batch SHARDED_BATCH, one
# spawn of rank processes for them all.  TinyLlama keeps 2 of its 22
# layers (cut from 4 for the run's time) and trains 3 steps, its
# parameters also saved from the mesh and restored onto (4, 1).  The
# other families ([sharded-families] lines) take 2 steps of one layer of
# each kind, by time: a rank's step is mostly DTensor's dispatch and
# staged collectives, a few seconds a layer and step at full width
# (PERF.md): phi3.5-moe 1 of 32 (its one-process state is 44 GB, so the
# ranks draw theirs after it is freed), mamba2 1 of 48, zamba2 1 of 81
# mamba layers after one shared-block call, whisper 1 + 1 of 12 + 12,
# internvl2 1 of 24 after its 256 vision tokens.  The ranks take each
# arch as soon as this process has run it (go_<arch>), the smallest
# first, so that they work while this process runs the MoE
SHARDED_RUNS = (("tinyllama-1.1b", 2, 1024, 3),
                ("whisper-small", 1, 256, 2),
                ("phi3.5-moe-42b-a6.6b", 1, 1024, 2),
                ("mamba2-1.3b", 1, 1024, 2),
                ("zamba2-7b", 1, 1024, 2),
                ("internvl2-1b", 1, 768, 2))
SHARDED_BATCH = 4
DRYRUN_LM_WAIT_S = 300   # a CLI pass still running then fails the phase


def check(ok, msg: str) -> None:
    """Raise when a result check fails (kept under ``python -O``)."""
    if not ok:
        raise AssertionError(msg)


def log(*args):
    print(*args, flush=True)


class Port:
    """The port's modules, imported from this checkout's ``src``."""

    def __init__(self):
        if not (SRC / "repro_torch").is_dir():
            raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found; "
                             "run from a checkout of the repository")
        sys.path.insert(0, str(SRC))
        import torch
        from repro_torch.configs import graph_workloads
        from repro_torch.core import CheckpointRunner, GraphEngine, \
            incremental, localops, partition_graph, registry, run_program, \
            superstep
        from repro_torch.core.partitioned import pack_bits, part_sums
        from repro_torch.graphs import generate_edges, urand_edges
        from repro_torch.kernels import _build, _ell
        from repro_torch.kernels.frontier import kernel as frontier_kernel
        from repro_torch.kernels.frontier.ref import bfs_pull_buckets_ref, \
            bfs_pull_ref
        from repro_torch.kernels.spmv import kernel as spmv_kernel
        from repro_torch.kernels.spmv.ref import spmv_ell_buckets_ref, \
            spmv_ell_ref
        from repro_torch.configs import registry as arch_registry
        from repro_torch.data import batch_at
        from repro_torch.kernels.flash_attention import kernel as flash_kernel
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.kernels.flash_attention.ref import \
            flash_attention_ref
        from repro_torch import models, obs
        from repro_torch import serve as graph_server
        from repro_torch.serve import persist
        from repro_torch.launch import graph_serve
        from repro_torch.launch.serve import serve
        from repro_torch.core import dryrun
        from repro_torch.launch import steps as train_steps
        from repro_torch.launch import train as trainer
        from repro_torch.data import TokenStream
        from repro_torch import tree
        from repro_torch.models import layers as model_layers
        from repro_torch.models import moe as model_moe
        from repro_torch.launch import serve as lm_serve
        from repro_torch.launch import mesh
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.distributed import actctx, compression
        from repro_torch.obs.telemetry import tally_delta
        from repro_torch import checkpoint
        from repro_torch.configs.base import ModelConfig, TrainConfig
        from repro_torch.models import params as model_params
        self.actctx = actctx
        self.compression = compression
        self.checkpoint = checkpoint
        self.ModelConfig = ModelConfig
        self.TrainConfig = TrainConfig
        self.params = model_params
        self.tally_delta = tally_delta
        self.mesh = mesh
        self.ShapeConfig = ShapeConfig
        self.model_moe = model_moe
        self.lm_serve = lm_serve
        self.dryrun = dryrun
        self.train_steps = train_steps
        self.trainer = trainer
        self.TokenStream = TokenStream
        self.tree = tree
        self.model_layers = model_layers
        self.graph_server = graph_server
        self.persist = persist
        self.graph_serve = graph_serve
        self.arch_registry = arch_registry
        self.batch_at = batch_at
        self.flash_kernel = flash_kernel
        self.flash_ops = flash_ops
        self.flash_attention_ref = flash_attention_ref
        self.models = models
        self.obs = obs
        self.serve = serve
        self.torch = torch
        self.graph_workloads = graph_workloads
        self.GraphEngine = GraphEngine
        self.CheckpointRunner = CheckpointRunner
        self.localops = localops
        self.registry = registry
        self.partition_graph = partition_graph
        self.pack_bits = pack_bits
        self.part_sums = part_sums
        self.generate_edges = generate_edges
        self.urand_edges = urand_edges
        self.run_program = run_program
        self.incremental = incremental
        self.superstep = superstep
        self.build = _build
        self.ell = _ell
        self.frontier_kernel = frontier_kernel
        self.spmv_kernel = spmv_kernel
        self.bfs_pull_ref = bfs_pull_ref
        self.bfs_pull_buckets_ref = bfs_pull_buckets_ref
        self.spmv_ell_ref = spmv_ell_ref
        self.spmv_ell_buckets_ref = spmv_ell_buckets_ref

    # the wrappers are read through their modules at each call
    def spmv_ell(self, *args, **kw):
        return self.spmv_kernel.spmv_ell(*args, **kw)

    def spmv_ell_buckets(self, *args, **kw):
        return self.spmv_kernel.spmv_ell_buckets(*args, **kw)

    def bfs_pull(self, *args):
        return self.frontier_kernel.bfs_pull(*args)

    def bfs_pull_buckets(self, *args, **kw):
        return self.frontier_kernel.bfs_pull_buckets(*args, **kw)

    def flash(self, *args, **kw):
        return self.flash_kernel.flash_attention_fwd(*args, **kw)

    def launches(self) -> dict:
        flash = self.flash_kernel.flash_attention_fwd
        return {"spmv_ell": self.spmv_kernel.spmv_ell.launches,
                "bfs_pull": self.frontier_kernel.bfs_pull.launches,
                "flash_attention_fwd": flash.launches,
                "flash_attention_fwd_tc": flash.launches_tc}

    def reset_launches(self) -> None:
        self.spmv_kernel.spmv_ell.launches = 0
        self.frontier_kernel.bfs_pull.launches = 0
        self.flash_kernel.flash_attention_fwd.launches = 0
        self.flash_kernel.flash_attention_fwd.launches_tc = 0


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def kernel_ms(torch, device, fn, reps: int = 20) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back runs after one warm-up,
    from CUDA events on the card (host clock elsewhere)."""
    fn()
    _sync(torch, device)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def median_ms(torch, device, fn, reps: int = 3) -> float:
    """Median host-clock ms of ``reps`` synchronized runs (the caller has
    warmed ``fn`` up)."""
    times = []
    for _ in range(reps):
        _sync(torch, device)
        t0 = time.perf_counter()
        fn()
        _sync(torch, device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(bytes_moved: int, ops: int,
          ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    """Least ms the H100 could take: bytes over HBM rate vs operations
    over the peak rate for their type (the f32 CUDA-core rate unless
    given), whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def requested_bytes(torch, device):
    """Bytes the CUDA caching allocator has handed out and not taken
    back, as requested (each tensor's storage bytes, not rounded to the
    allocator's blocks): what the dry-run plans.  None off the card.
    Unreachable cycles are collected first, so that tensors they hold do
    not count, nor are freed inside a reading."""
    if torch.device(device).type != "cuda":
        return None
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


class PeakBytes:
    """Within the context, the most bytes live on the card above what was
    live at its start (unreachable cycles collected first):
    ``peak`` as requested (the dry-run's measure) and ``peak_allocated``
    in the allocator's blocks (max_memory_allocated).  Both None off the
    card."""

    def __init__(self, torch, device):
        self.torch, self.on = torch, torch.device(device).type == "cuda"
        self.peak = self.peak_allocated = None

    def __enter__(self):
        if self.on:
            torch = self.torch
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            st = torch.cuda.memory_stats()
            self.base = st["requested_bytes.all.current"]
            self.base_allocated = st["allocated_bytes.all.current"]
        return self

    def __exit__(self, *exc):
        if self.on:
            torch = self.torch
            torch.cuda.synchronize()
            st = torch.cuda.memory_stats()
            self.peak = st["requested_bytes.all.peak"] - self.base
            self.peak_allocated = (st["allocated_bytes.all.peak"]
                                   - self.base_allocated)


# ---------------------------------------------------------------------------
# host references (numpy / scipy, independent of the port)
# ---------------------------------------------------------------------------

def out_matrix(edges: np.ndarray, n: int):
    """The graph as one scipy CSR matrix, src -> dst, parallel edges
    summed as multiplicities (float64): built once for every host
    check."""
    import scipy.sparse as sp
    return sp.csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                         shape=(n, n))


def bfs_levels(m, root: int) -> np.ndarray:
    """BFS level of every vertex from ``root`` (-1 if unreached), one
    sparse in-neighbor matvec (``m.T``) per level."""
    n = m.shape[0]
    level = np.full(n, -1, np.int64)
    level[root] = 0
    frontier = np.zeros(n)
    frontier[root] = 1.0
    d = 0
    while frontier.any():
        d += 1
        new = ((m.T @ frontier) > 0) & (level < 0)
        level[new] = d
        frontier = new.astype(np.float64)
    return level


def min_level_parents(edges: np.ndarray, n: int, root: int,
                      level: np.ndarray) -> np.ndarray:
    """Per vertex, the smallest in-neighbor one BFS level up (INT_INF if
    unreached; the root is its own parent)."""
    src, dst = edges[:, 0], edges[:, 1]
    lu = level[src]
    up = (lu >= 0) & (level[dst] == lu + 1)
    key = np.sort(dst[up] * n + src[up])
    v = key // n
    first = np.ones(v.size, bool)
    first[1:] = v[1:] != v[:-1]
    parents = np.full(n, INT_INF, np.int64)
    parents[v[first]] = key[first] % n
    parents[root] = root
    return parents


def pagerank_f64(m, rounds: set) -> dict:
    """Float64 power iteration of the port's update (rank0 = 1/n,
    rank = (1-alpha)/n + alpha * sum of in-neighbors' rank/out_degree,
    no dangling redistribution); the ranks after each count in
    ``rounds``."""
    n = m.shape[0]
    out_deg = np.asarray(m.sum(axis=1)).ravel()
    inv = np.where(out_deg > 0, 1.0 / np.maximum(out_deg, 1.0), 0.0)
    base = (1.0 - ALPHA) / n
    r = np.full(n, 1.0 / n)
    out = {}
    for t in range(1, max(rounds) + 1):
        r = base + ALPHA * (m.T @ (r * inv))
        if t in rounds:
            out[t] = r.copy()
    return out


def max_rel(a: np.ndarray, b: np.ndarray) -> float:
    """Elementwise max |a - b| / |b| (b has no zeros: ranks >= base)."""
    return float(np.max(np.abs(a.astype(np.float64) - b) / np.abs(b)))


def sssp_dijkstra(m, root: int) -> np.ndarray:
    """Distances from ``root`` by scipy's Dijkstra under the port's
    synthesized weights ``1 + (src * 2654435761 ^ dst * 40503) % 2**16 /
    2**16`` (uint32 hash; its low 16 bits, exact in int64).  Parallel
    edges have equal weights, so the deduplicated pairs of ``m``'s
    pattern carry exactly the minimum weight of each pair (a CSR built
    from the edge list would add them); inf where unreached."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    n = m.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(m.indptr))
    h = (rows * 2654435761) ^ (m.indices.astype(np.int64) * 40503)
    w = sp.csr_matrix((1.0 + (h & 0xFFFF) / 65536.0, m.indices, m.indptr),
                      shape=(n, n))
    return dijkstra(w, directed=True, indices=root)


def undirected_matrix(m):
    """The undirected multigraph (m + m.T, self-loops dropped) as CSR."""
    u = (m + m.T).tocsr()
    u.setdiag(0)
    u.eliminate_zeros()
    return u


def min_id_components(u, connection: str = "strong") -> np.ndarray:
    """Per vertex, the smallest vertex id of its weakly connected
    component: strong components of the symmetric ``u``, or
    ``connection="weak"`` components of a directed ``u``."""
    from scipy.sparse.csgraph import connected_components
    _, labels = connected_components(u, directed=True, connection=connection)
    _, first = np.unique(labels, return_index=True)
    return first[labels]


def core_numbers(u) -> tuple[np.ndarray, int]:
    """Core numbers of the undirected multigraph ``u`` by threshold
    peeling, and the peeling's round count: each round removes every
    alive vertex of degree <= k (core k) and, through its CSR row,
    decrements its neighbors once; a round that removes nothing advances
    k."""
    n = u.shape[0]
    deg = np.asarray(u.sum(axis=1)).ravel().astype(np.int64)
    alive = np.ones(n, bool)
    core = np.zeros(n, np.int64)
    k = rounds = 0
    while alive.any():
        rounds += 1
        kill = np.flatnonzero(alive & (deg <= k))
        if kill.size:
            core[kill] = k
            alive[kill] = False
            sub = u[kill]
            deg -= np.bincount(sub.indices, weights=sub.data,
                               minlength=n).astype(np.int64)
        else:
            k += 1
    return core, rounds


def brandes_f64(m, root: int):
    """Float64 Brandes from ``root`` on the directed multigraph ``m``
    (multiplicities are parallel shortest paths): (delta with delta(root)
    = 0, sigma, dist with INT_INF where unreached), one sparse matvec per
    level each way."""
    n = m.shape[0]
    dist = np.full(n, INT_INF, np.int64)
    dist[root] = 0
    sigma = np.zeros(n)
    sigma[root] = 1.0
    level = 0
    while True:
        fr = dist == level
        if not fr.any():
            break
        pushed = m.T @ (sigma * fr)
        newly = (pushed > 0) & (dist == INT_INF)
        dist[newly] = level + 1
        sigma[newly] = pushed[newly]
        level += 1
    delta = np.zeros(n)
    for lvl in range(level - 1, -1, -1):
        coef = np.where(dist == lvl + 1, (1.0 + delta)
                        / np.maximum(sigma, 1.0), 0.0)
        at = dist == lvl
        delta[at] = (sigma * (m @ coef))[at]
    delta[root] = 0.0
    return delta, sigma, dist


def triangle_counts(edges: np.ndarray, n: int) -> tuple[np.ndarray, int]:
    """Per-vertex triangles of the simple undirected graph (A o (A @ A),
    row sums halved) and the total, from scipy."""
    import scipy.sparse as sp
    a = sp.csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                      shape=(n, n))
    a = ((a + a.T) > 0).astype(np.float64).tocsr()
    a.setdiag(0)
    a.eliminate_zeros()
    per = np.asarray(a.multiply(a @ a).sum(axis=1)).ravel() / 2
    per = per.astype(np.int64)
    return per, int(per.sum()) // 3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def ptxas_entries(log_text: str, cxxfilt: str) -> list:
    """(kernel instantiation, registers, spill-store bytes) for each entry
    function in an ``nvcc -Xptxas -v`` log, the name as ``cu++filt``
    (beside nvcc) demangles it."""
    chunks = log_text.split("Compiling entry function '")[1:]
    mangled = [c.split("'", 1)[0] for c in chunks]
    names = subprocess.run(
        [cxxfilt], input="".join(m + "\n" for m in mangled),
        capture_output=True, text=True, check=True).stdout.splitlines()
    out = []
    for name, chunk in zip(names, chunks):
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(r"(\d+) bytes spill stores", chunk)
        out.append((name,
                    int(regs.group(1)) if regs else None,
                    int(spills.group(1)) if spills else None))
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip()


def nonempty_buckets(port: Port, buckets, flat):
    """(row0, rows, (P, rows, K) view) of each non-empty ELL bucket."""
    for r0, rows, k, blk in port.ell.bucket_views(flat, buckets):
        if k:
            yield r0, rows, blk


SPMV_DESIGN = ("persistent grid, one launch per call; a thread per row "
               "(a warp per row past K = 64), 32 gathers in flight, "
               "16-byte index loads, slot-order __fadd_rn sums, L2 "
               "evict_last x / evict_first indices")
BFS_DESIGN = ("persistent grid, one launch per call; a thread per row "
              "(a warp per row past K = 64), ballot skip of tiles with no "
              "live row, 16 word loads in flight, L2 evict_last bitmap / "
              "evict_first ids")


class Parent:
    """The graph kernels of another checkout, on the same inputs as this
    checkout's.  Two C interfaces are known: the first design's, which
    exports no ``*_interface`` version and takes one bucket a launch
    (declared here), and this checkout's bucket table, run through this
    checkout's launchers.  ``bind`` raises on any other version, so a
    parent whose interface this script does not know fails at load."""

    def __init__(self, port: Port, root: str):
        csrc = Path(root).resolve() / "src" / "repro_torch" / "kernels"
        self.port = port
        self.src = {"parent_spmv_ell": csrc / "spmv" / "csrc" / "spmv_ell.cu",
                    "parent_bfs_pull": csrc / "frontier" / "csrc"
                    / "bfs_pull.cu"}
        for path in self.src.values():
            if not path.exists():
                raise SystemExit(f"chip_smoke: {path} not found")
        self.spmv_lib = self.bfs_lib = None
        self.table = False

    def extra_builds(self):
        return tuple(self.src.items())

    def load(self):
        import ctypes as c
        build = self.port.build
        self.spmv_lib = build.load("parent_spmv_ell", self.src["parent_spmv_ell"])
        self.bfs_lib = build.load("parent_bfs_pull", self.src["parent_bfs_pull"])
        versioned = [hasattr(self.spmv_lib, "spmv_ell_interface"),
                     hasattr(self.bfs_lib, "bfs_pull_interface")]
        if any(versioned):
            self.port.spmv_kernel.bind(self.spmv_lib)
            self.port.frontier_kernel.bind(self.bfs_lib)
            self.table = True
            return
        self.spmv_lib.spmv_ell_launch.argtypes = [
            c.c_void_p, c.c_longlong, c.c_void_p, c.c_longlong, c.c_void_p,
            c.c_longlong, c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_int,
            c.c_void_p]
        self.bfs_lib.bfs_pull_launch.argtypes = [
            c.c_void_p, c.c_longlong, c.c_void_p, c.c_longlong, c.c_void_p,
            c.c_longlong, c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_void_p]

    def _stream(self):
        return self.port.torch.cuda.current_stream().cuda_stream

    def spmv(self, flat, x, buckets, skip):
        """The parent's spmv_ell over a bucket table (skip form; x may
        have part stride 0) as (row0, (P, rows) output) blocks: one for
        a table launch, one a non-empty bucket for the first interface."""
        torch = self.port.torch
        p = flat.shape[0]
        if self.table:
            y = torch.empty((p, sum(r for r, _ in buckets)),
                            device=flat.device)
            self.port.spmv_kernel.launch(self.spmv_lib, flat, None, x, y,
                                         tuple(buckets), skip)
            return [(0, y)]
        out = []
        for r0, rows, blk in nonempty_buckets(self.port, buckets, flat):
            y = torch.empty((p, rows), device=flat.device)
            code = self.spmv_lib.spmv_ell_launch(
                blk.data_ptr(), blk.stride(0), None, 0, x.data_ptr(),
                x.stride(0), y.data_ptr(), p, rows, blk.shape[2], skip,
                self._stream())
            self.port.build.check(self.spmv_lib, "spmv_ell", code)
            out.append((r0, y))
        return out

    def flags(self, unv):
        """The flags as the parent takes them: int32 for the first
        interface."""
        return unv if self.table else unv.to(self.port.torch.int32)

    def bfs(self, flat, bits_g, unv, buckets, skip):
        """The parent's bfs_pull over a bucket table (bits_g with a zero
        guard word, which the first interface reads for the sentinel;
        unv from ``flags``) as (row0, (P, rows) parents) blocks."""
        torch = self.port.torch
        p = flat.shape[0]
        if self.table:
            out = torch.empty((p, sum(r for r, _ in buckets)),
                              dtype=torch.int32, device=flat.device)
            self.port.frontier_kernel.launch(self.bfs_lib, flat, bits_g, unv,
                                             out, tuple(buckets), skip)
            return [(0, out)]
        res = []
        for r0, rows, blk in nonempty_buckets(self.port, buckets, flat):
            out = torch.empty((p, rows), dtype=torch.int32,
                              device=flat.device)
            code = self.bfs_lib.bfs_pull_launch(
                blk.data_ptr(), blk.stride(0), bits_g.data_ptr(),
                bits_g.stride(0), unv[:, r0:].data_ptr(), unv.stride(0),
                out.data_ptr(), p, rows, blk.shape[2], self._stream())
            self.port.build.check(self.bfs_lib, "bfs_pull", code)
            res.append((r0, out))
        return res


def same_bits(torch, a, b) -> bool:
    """Equal shapes and bit patterns (float32 compared as int32, bf16 as
    int16)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype in (torch.float32, torch.bfloat16):
        view = torch.int32 if a.dtype == torch.float32 else torch.int16
        a, b = (t.contiguous().view(view) for t in (a, b))
    return torch.equal(a, b)


class Parity:
    """Kernel-vs-plain comparisons, bit for bit; keeps each kernel's max
    abs error (0 when they pass)."""

    def __init__(self, port: Port, device):
        self.port, self.device = port, device
        self.torch = port.torch
        self.err = {"spmv_ell": 0.0, "bfs_pull": 0.0}
        self.cases = {"spmv_ell": 0, "bfs_pull": 0}

    def _same(self, name, got, want, what):
        torch = self.torch
        _sync(torch, self.device)
        if not same_bits(torch, got, want):
            bad = int((got != want).sum()) if got.shape == want.shape else -1
            err = ((got.double() - want.double()).abs().max().item()
                   if got.shape == want.shape else float("nan"))
            raise AssertionError(f"{name} differs from its plain version in "
                                 f"{bad} rows (max abs {err:.3e}) at {what}")
        self.err[name] = max(self.err[name], float(
            (got.double() - want.double()).abs().max().item()))
        self.cases[name] += 1

    def spmv(self, idx, val, x, skip=None):
        got = self.port.spmv_ell(idx, val, x, skip=skip)
        self._same("spmv_ell", got,
                   self.port.spmv_ell_ref(idx, val, x, skip=skip),
                   tuple(idx.shape))
        return got

    def spmv_table(self, flat, x, buckets, skip):
        self._same("spmv_ell", self.port.spmv_ell_buckets(
            flat, None, x, buckets, skip=skip),
            self.port.spmv_ell_buckets_ref(flat, None, x, buckets,
                                           skip=skip), f"table {buckets}")

    def frontier(self, nbr, bits, unv):
        got = self.port.bfs_pull(nbr, bits, unv)
        self._same("bfs_pull", got, self.port.bfs_pull_ref(nbr, bits, unv),
                   tuple(nbr.shape))
        return got

    def frontier_table(self, flat, bits, unv, buckets, skip):
        self._same("bfs_pull", self.port.bfs_pull_buckets(
            flat, bits, unv, buckets, skip=skip),
            self.port.bfs_pull_buckets_ref(flat, bits, unv, buckets,
                                           skip=skip), f"table {buckets}")

    def sweep(self, rng):
        """The JAX package's kernel-test cases, unbatched and as strided
        batches (how local ops hand the kernels ELL buckets)."""
        torch, dev = self.torch, self.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        for batch in (1, 3):
            for rows, k, n_cols in SPMV_SWEEP:
                flat = t(rng.integers(0, n_cols, (batch, rows * k + 5))
                         .astype(np.int32))
                idx = flat[:, 2:2 + rows * k].reshape(batch, rows, k)
                val = t(rng.normal(size=(batch, rows, k)).astype(np.float32))
                x = t(rng.normal(size=(batch, n_cols)).astype(np.float32))
                self.spmv(idx, val, x)
                self.spmv(idx, None, x, skip=7)
            for rows, k, n_cols in FRONTIER_SWEEP:
                flat = t(rng.integers(0, n_cols, (batch, rows * k + 5))
                         .astype(np.int32))
                nbr = flat[:, 2:2 + rows * k].reshape(batch, rows, k)
                bits = t(rng.integers(-2 ** 31, 2 ** 31,
                                      (batch, n_cols // 32 + 1))
                         .astype(np.int32))
                unv = t(rng.integers(0, 2, (batch, rows)).astype(np.int32))
                self.frontier(nbr, bits, unv)
        # bf16-valued inputs, computed in f32 by both
        idx = t(rng.integers(0, 512, (1, 256, 8)).astype(np.int32))
        val = t(rng.normal(size=(1, 256, 8)).astype(np.float32)) \
            .to(torch.bfloat16).float()
        x = t(rng.normal(size=(1, 512)).astype(np.float32)) \
            .to(torch.bfloat16).float()
        self.spmv(idx, val, x)
        # zero-padded slots contribute nothing
        zero = self.spmv(torch.zeros((1, 128, 4), dtype=torch.int32,
                                     device=dev),
                         torch.zeros((1, 128, 4), device=dev),
                         t(rng.normal(size=(1, 128)).astype(np.float32)))
        check(bool((zero == 0).all()), "zero-padded spmv is not 0")
        # visited rows are INT_INF
        nbr = t(rng.integers(0, 256, (1, 128, 4)).astype(np.int32))
        bits = t(rng.integers(-2 ** 31, 2 ** 31, (1, 9)).astype(np.int32))
        out = self.frontier(nbr, bits, torch.zeros((1, 128),
                                                   dtype=torch.int32,
                                                   device=dev))
        check(bool((out == INT_INF).all()), "visited rows must be INT_INF")
        # the smallest in-frontier neighbor wins
        words = np.zeros((1, 3), np.int64)
        for v in (5, 9, 40):
            words[0, v // 32] |= 1 << (v % 32)
        words = np.where(words >= 2 ** 31, words - 2 ** 32, words)
        out = self.frontier(
            t(np.tile(np.array([40, 9, 5, 63], np.int32), (1, 128, 1))),
            t(words.astype(np.int32)),
            torch.ones((1, 128), dtype=torch.int32, device=dev))
        check(bool((out == 5).all()), "min-id parent selection")
        # a multi-bucket table: widths 40 to 0, rows no multiple of 32, a
        # strided batch of parts sharing x (part stride 0), sentinels
        table = ((64, 40), (96, 24), (45, 16), (50, 8), (20, 0))
        n_cols, slots = 5000, sum(r * k for r, k in table)
        store = t(rng.integers(0, n_cols, (3, slots + 8)).astype(np.int32))
        store[:, 1::9] = n_cols
        flat = store[:, 4:4 + slots]
        x = t(rng.normal(size=(1, n_cols)).astype(np.float32)).expand(3, -1)
        self.spmv_table(flat, x, table, n_cols)
        bits = t(rng.integers(-2 ** 31, 2 ** 31, (1, n_cols // 32 + 1))
                 .astype(np.int32)).expand(3, -1)
        unv = t(rng.integers(0, 2, (3, sum(r for r, _ in table)))
                .astype(np.uint8))
        unv[:, 64:96] = 0                       # an all-dead warp tile
        self.frontier_table(flat, bits, unv, table, n_cols)
        self.frontier_table(flat, bits, unv.to(torch.int32), table, n_cols)

    def _inputs(self, g, name):
        """Random x, frontier bitmap (with its guard word) and flags for
        structure ``name``: ell_in gathers all-gathered contributions (one
        vector for every part, as broadcast_global gives it), the
        edge-position structures per-edge values of each part."""
        torch, dev, p = self.torch, self.device, g.parts
        meta = g.ell_meta[name]
        x = torch.rand((1 if name == "ell_in" else p, meta.sentinel),
                       device=dev).expand(p, -1)
        bits_g = torch.randint(-2 ** 31, 2 ** 31 - 1, (1, g.n // 32 + 1),
                               dtype=torch.int32, device=dev).expand(p, -1)
        unv = torch.randint(0, 2, (p, meta.n_rows), dtype=torch.uint8,
                            device=dev)
        return meta, x, bits_g, unv

    def graph_buckets(self, g, garr, rng):
        """Every ELL bucket a path hands a kernel, alone: ell_in (spmv and
        bfs_pull), ell_dst, ell_out (betweenness's two combines) and
        ell_src (spmv); then each structure in one multi-bucket call
        (``tables``).  Random x, bits and flags."""
        torch = self.torch
        shapes = []
        for name in ("ell_in", "ell_dst", "ell_out", "ell_src"):
            meta, x, bits_g, unv = self._inputs(g, name)
            for r0, rows, blk in nonempty_buckets(
                    self.port, meta.buckets, garr[f"{name}_idx"]):
                self.spmv(blk, None, x, skip=meta.sentinel)
                if name == "ell_in":
                    self.frontier(blk, bits_g,
                                  unv[:, r0:r0 + rows].to(torch.int32))
                shapes.append((name, tuple(blk.shape)))
        self.tables(g, garr, ("ell_in", "ell_dst", "ell_out", "ell_src"))
        return shapes

    def tables(self, g, garr, names) -> None:
        """Each structure of ``names`` in one multi-bucket call as the
        paths make it (x with no pad slot, the bitmap with no guard word,
        uint8 flags): spmv_ell on each, bfs_pull on ell_in.  Random x,
        bits and flags."""
        for name in names:
            meta, x, bits_g, unv = self._inputs(g, name)
            flat = garr[f"{name}_idx"]
            self.spmv_table(flat, x, meta.buckets, meta.sentinel)
            if name == "ell_in":
                self.frontier_table(flat, bits_g[:, :-1], unv,
                                    meta.buckets, meta.sentinel)


def run_programs(port: Port, eng, garr, mode: str) -> dict:
    """The four programs once each under local-ops ``mode``; per program
    the host field, rounds and kernel launches."""
    torch = port.torch
    res = {}
    with port.localops.using(mode):
        progs = {a + "/" + v: (eng.program(a, v), a) for a, v in PROGRAMS}
    for key, (prog, algo) in progs.items():
        before = port.launches()
        *outs, rounds = prog(garr, *((ROOT,) if algo == "bfs" else ()))
        _sync(torch, eng.device)
        after = port.launches()
        res[key] = {"field": eng.gather_vertex_field(outs[0]),
                    "rounds": int(rounds), "prog": prog,
                    "launches": {k: after[k] - before[k] for k in after}}
    return res


def rate(gathers: int, ms: float) -> str:
    """Gathers per second, in G/s."""
    return f"{gathers / ms / 1e6:.1f} G/s"


def kernel_times(port: Port, g, garr, level: np.ndarray, device,
                 parent: Parent | None) -> dict:
    """Each kernel at this graph's main-path inputs, beside its plain
    version, its bound and its library call: spmv_ell over one local-ops
    call per structure (a PageRank round over ell_in or ell_dst, a
    betweenness backward round over ell_out), whole and bucket by bucket;
    bfs_pull over every call of one bfs/fast run, round by round.  With
    ``parent``, the parent's kernels on the same inputs, each result
    checked before it is timed."""
    torch = port.torch
    p, n = g.parts, g.n
    out = {}
    gen = torch.Generator(device=device).manual_seed(SEED)

    for name in ("ell_in", "ell_dst", "ell_out"):
        meta = g.ell_meta[name]
        flat, skip, rows = garr[f"{name}_idx"], meta.sentinel, meta.n_rows
        # as the paths: ell_in gathers one all-gathered vector (part
        # stride 0), ell_dst (pagerank/fast, betweenness forward) and
        # ell_out (betweenness backward) each part's per-edge values; no
        # pad slot
        x = torch.rand((1 if name == "ell_in" else p, skip), device=device,
                       generator=gen).expand(p, -1)
        gathers = int((flat != skip).sum())

        def kern(flat=flat, x=x, meta=meta):
            return port.spmv_ell_buckets(flat, None, x, meta.buckets,
                                         skip=meta.sentinel)

        def plain(flat=flat, x=x, meta=meta):
            return port.spmv_ell_buckets_ref(flat, None, x, meta.buckets,
                                             skip=meta.sentinel)

        # the same y as one CSR matvec: rows of part q at q * rows, its
        # columns at q * n_cols unless x is one vector for all parts
        shared = x.stride(0) == 0
        r_idx, c_idx = [], []
        part = torch.arange(p, device=device)[:, None, None]
        for r0, br, blk in nonempty_buckets(port, meta.buckets, flat):
            keep = blk != skip
            row = part * rows + r0 + torch.arange(
                br, device=device)[None, :, None]
            r_idx.append(row.expand(blk.shape)[keep])
            c_idx.append((blk.long() + (0 if shared else part * skip))[keep])
        with warnings.catch_warnings():     # torch.sparse's beta notices
            warnings.simplefilter("ignore", UserWarning)
            coo = torch.sparse_coo_tensor(
                torch.stack([torch.cat(r_idx), torch.cat(c_idx)]),
                torch.ones(gathers, device=device),
                (p * rows, skip if shared else p * skip))
            csr = coo.coalesce().to_sparse_csr()
        del coo, r_idx, c_idx
        xf = x[0] if shared else x.reshape(-1)

        def library(csr=csr, xf=xf):
            return csr @ xf

        y = kern()
        torch.testing.assert_close(library().reshape(p, rows), y,
                                   rtol=SPMV_TOL, atol=SPMV_TOL)
        idx_bytes = 4 * flat.numel()
        b_ms, b_by = bound(idx_bytes + x.untyped_storage().nbytes()
                           + 4 * p * rows, gathers)
        cell = {"ms": kernel_ms(torch, device, kern),
                "plain_ms": kernel_ms(torch, device, plain, reps=5),
                "library_ms": kernel_ms(torch, device, library),
                "bound_ms": b_ms, "bound_by": b_by,
                "timed_launches": len(port.ell.launch_tables(meta.buckets)),
                "rows": p * rows, "slots": flat.numel(), "gathers": gathers}
        del csr
        if x.untyped_storage().nbytes() > L2_BYTES:
            # x past L2: each gather moves a 32-byte HBM sector at least
            cell["sector_bound_ms"] = (idx_bytes + HBM_SECTOR * gathers
                                       + 4 * p * rows) / HBM_BYTES_PER_S * 1e3
        log(f"[times] parts={p} spmv_ell/{name}: one call {cell['ms']:.4f} ms"
            f" ({rate(gathers, cell['ms'])}, {gathers:,} gathers)")
        buckets_out = []
        # the parent's results are held against the plain version (within
        # SPMV_TOL: the first design adds a row's slots in another order)
        want = plain() if parent is not None else None
        for r0, br, blk in nonempty_buckets(port, meta.buckets, flat):
            gb = int((blk != skip).sum())
            line = {"rows": p * br, "K": blk.shape[2], "gathers": gb,
                    "ms": kernel_ms(torch, device,
                                    lambda blk=blk, x=x, skip=skip:
                                    port.spmv_ell(blk, None, x, skip=skip))}
            msg = (f"[bucket] parts={p} spmv_ell/{name} rows={p * br} "
                   f"K={blk.shape[2]}: new {line['ms']:.4f} ms "
                   f"({rate(gb, line['ms'])})")
            if parent is not None:
                one = (blk.flatten(1), x, ((br, blk.shape[2]),), skip)
                (_, got), = parent.spmv(*one)
                torch.testing.assert_close(
                    got, want[:, r0:r0 + br], rtol=SPMV_TOL, atol=SPMV_TOL,
                    msg=lambda m: f"the parent's spmv_ell at {blk.shape}: {m}")
                line["old_ms"] = kernel_ms(
                    torch, device, lambda one=one: parent.spmv(*one))
                msg += f"; old {line['old_ms']:.4f} ms " \
                       f"({rate(gb, line['old_ms'])})"
            buckets_out.append(line)
            log(msg)
        cell["buckets"] = buckets_out
        if parent is not None:
            call = (flat, x, meta.buckets, skip)
            for r0, got in parent.spmv(*call):
                torch.testing.assert_close(
                    got, want[:, r0:r0 + got.shape[1]], rtol=SPMV_TOL,
                    atol=SPMV_TOL,
                    msg=lambda m: f"the parent's spmv_ell/{name}: {m}")
            cell["old_ms"] = kernel_ms(torch, device,
                                       lambda call=call: parent.spmv(*call))
            log(f"[times] parts={p} spmv_ell/{name}: the parent's "
                f"{cell['old_ms']:.4f} ms")
        out[f"spmv_ell/{name}"] = cell

    # bfs_pull over one bfs/fast run: each round's call rebuilt from the
    # BFS levels.  Round r reads the bitmap of level r - 1; a push round
    # (previous count under the pull threshold) passes the activated rows
    # (level r), a pull round every row not yet visited (level >= r).
    meta = g.ell_meta["ell_in"]
    flat = garr["ell_in_idx"]
    thresh = max(1, int(n * port.registry.get_spec("bfs", "fast")
                        .defaults["pull_threshold"]))
    lvl = np.full(n, INT_INF, np.int64)
    lvl[:level.size] = np.where(level >= 0, level, INT_INF)
    lvl = torch.from_numpy(lvl).to(device)
    perm = garr["ell_in_perm"].long()
    views = list(port.ell.bucket_views(flat, meta.buckets))
    # per ELL row: its width and its filled (non-sentinel) slots
    width = torch.cat([torch.full((p, rows), k, device=device)
                       for _, rows, k, _ in views], dim=1)
    fill = torch.cat([(blk != n).sum(dim=2) if k else
                      torch.zeros((p, rows), dtype=torch.int64,
                                  device=device)
                      for _, rows, k, blk in views], dim=1)
    rounds = []
    for r in range(1, int(level.max()) + 2):
        push = int((lvl == r - 1).sum()) < thresh
        rows_in = (lvl == r) if push else (lvl >= r)
        bits = port.pack_bits(lvl == r - 1)
        unv = torch.gather(rows_in.reshape(p, g.n_local).to(torch.uint8), 1,
                           perm)
        rounds.append({"mode": "u" if push else "l",
                       "bits": bits[None].expand(p, -1), "unv": unv,
                       "bits_g": torch.cat([bits, bits.new_zeros(1)])[None]
                       .expand(p, -1),
                       "live_rows": int(unv.sum()),
                       "gathers": int((fill * unv).sum()),
                       "live_slots": int((width * unv).sum())})

    def call(rd):
        return port.bfs_pull_buckets(flat, rd["bits"], rd["unv"],
                                     meta.buckets, skip=n)

    def kern():
        return [call(rd) for rd in rounds]

    def plain():
        return [port.bfs_pull_buckets_ref(flat, rd["bits"], rd["unv"],
                                          meta.buckets, skip=n)
                for rd in rounds]

    check(all(torch.equal(a, b) for a, b in zip(kern(), plain())),
          "bfs_pull differs from its plain version on the BFS rounds")
    per_round = []
    for i, rd in enumerate(rounds, 1):
        line = {k: rd[k] for k in ("mode", "live_rows", "gathers",
                                   "live_slots")}
        line["ms"] = kernel_ms(torch, device, lambda rd=rd: call(rd))
        msg = (f"[round] parts={p} bfs_pull round {i} {rd['mode']} "
               f"live_rows={rd['live_rows']:,} gathers={rd['gathers']:,}: "
               f"new {line['ms']:.4f} ms ({rate(rd['gathers'], line['ms'])})")
        if parent is not None:
            old = (flat, rd["bits_g"], parent.flags(rd["unv"]), meta.buckets,
                   n)
            want = call(rd)
            check(all(torch.equal(got, want[:, r0:r0 + got.shape[1]])
                      for r0, got in parent.bfs(*old)),
                  f"the parent's bfs_pull differs in round {i}")
            line["old_ms"] = kernel_ms(torch, device,
                                       lambda old=old: parent.bfs(*old))
            msg += (f"; old {line['old_ms']:.4f} ms "
                    f"({rate(rd['gathers'], line['old_ms'])})")
        per_round.append(line)
        log(msg)
    live_slots = sum(rd["live_slots"] for rd in rounds)
    gathers = sum(rd["gathers"] for rd in rounds)
    n_rows = meta.n_rows
    b_ms, b_by = bound(len(rounds) * (4 * (n // 32) + 5 * p * n_rows)
                       + 4 * live_slots, live_slots)
    cell = {"ms": kernel_ms(torch, device, kern),
            "plain_ms": kernel_ms(torch, device, plain, reps=5),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "timed_launches": len(rounds) * len(
                port.ell.launch_tables(meta.buckets)),
            "rows": p * n_rows, "live_slots": live_slots,
            "gathers": gathers,
            "rounds": "".join(rd["mode"] for rd in rounds),
            "per_round": per_round}
    if parent is not None:
        cell["old_ms"] = sum(line["old_ms"] for line in per_round)
    log(f"[times] parts={p} bfs_pull: one run {cell['ms']:.4f} ms "
        f"({rate(gathers, cell['ms'])}, {gathers:,} gathers)")
    out["bfs_pull/ell_in"] = cell
    return out


def run(graph: str, parts_list, device, parent_root: str | None = None) \
        -> dict:
    port = Port()
    torch = port.torch
    rng = np.random.default_rng(SEED)
    port.localops.set_mode("auto")
    on_card = torch.device(device).type == "cuda"
    parent = Parent(port, parent_root) if parent_root else None

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    extra = parent.extra_builds() if parent is not None else ()
    logs = port.build.build_all(extra) if on_card else {}
    log(f"[build] {len(logs)} builds in {time.perf_counter() - t0:.1f} s")
    cxxfilt = os.path.join(os.path.dirname(port.build._nvcc()), "cu++filt") \
        if logs else ""
    for name, text in logs.items():
        for entry, regs, spills in ptxas_entries(text, cxxfilt):
            log(f"[build] {name}: {entry}: {regs} registers, {spills} bytes "
                f"spill stores")
        for line in text.splitlines():
            if "warning" in line.lower() or "serialized" in line:
                log(f"[build] {name}: {line.strip()}")

    if parent is not None:
        parent.load()

    # -- parity: test sweeps -------------------------------------------------
    parity = Parity(port, device)
    parity.sweep(rng)
    log(f"[parity] test sweeps ok: {parity.cases} "
        f"max_abs_err={parity.err}")

    # -- graph ---------------------------------------------------------------
    gcfg = port.graph_workloads.ALL[graph]
    n = gcfg.num_vertices
    t0 = time.perf_counter()
    edges = port.generate_edges(gcfg, SEED)
    log(f"[graph] {graph}: {n:,} vertices, {len(edges):,} edges in "
        f"{time.perf_counter() - t0:.1f} s")
    engines = {}
    for parts in parts_list:
        t0 = time.perf_counter()
        g = port.partition_graph(edges, n, parts)
        t1 = time.perf_counter()
        eng = port.GraphEngine(g, device=device)
        garr = eng.device_graph()
        _sync(torch, device)
        nbytes = sum(t.numel() * t.element_size() for t in garr.values())
        log(f"[graph] parts={parts}: partitioned in {t1 - t0:.1f} s, "
            f"{nbytes / 2 ** 30:.2f} GiB on the device in "
            f"{time.perf_counter() - t1:.1f} s; buckets "
            + " ".join(f"{k}={list(m.buckets)}"
                       for k, m in g.ell_meta.items()
                       if k in ("ell_in", "ell_dst")))
        engines[parts] = (g, eng, garr)
        shapes = parity.graph_buckets(g, garr, rng)
        log(f"[parity] parts={parts}: {len(shapes)} ELL bucket shapes ok")
    log(f"[parity] max_abs_err={parity.err} cases={parity.cases}")
    parity_err = dict(parity.err)

    # -- main path -----------------------------------------------------------
    port.reset_launches()
    main = {parts: run_programs(port, eng, garr, "auto")
            for parts, (_, eng, garr) in engines.items()}
    main_launches = port.launches()
    log(f"[main] launches {main_launches}")
    # one launch per local-ops call (more only past MAX_BUCKETS buckets):
    # spmv_pull is a pagerank/bsp round, scatter_combine(add) a
    # pagerank/fast round, frontier_pull a bfs/fast round
    want = {"spmv_ell": 0, "bfs_pull": 0}
    for parts, res in main.items():
        g = engines[parts][0]
        tables = {k: len(port.ell.launch_tables(g.ell_meta[k].buckets))
                  for k in ("ell_in", "ell_dst")}
        per_prog = {"bfs/bsp": {},
                    "bfs/fast": {"bfs_pull": tables["ell_in"]},
                    "pagerank/bsp": {"spmv_ell": tables["ell_in"]},
                    "pagerank/fast": {"spmv_ell": tables["ell_dst"]}}
        for key, r in res.items():
            log(f"[main] parts={parts} {key:14s} rounds={r['rounds']:3d} "
                f"launches={r['launches']}")
            for name in want:
                calls = r["rounds"] * per_prog[key].get(name, 0)
                want[name] += calls
                check(r["launches"][name] == calls,
                      f"parts={parts} {key}: {name} launched "
                      f"{r['launches'][name]} times, want {calls} (one per "
                      f"local-ops call)")
    for name, calls in want.items():
        check(main_launches[name] == calls > 0,
              f"{name}: {main_launches[name]} main-path launches, want "
              f"{calls}")
    log(f"[main] one launch per local-ops call: {want}")

    t0 = time.perf_counter()
    m = out_matrix(edges, n)
    level = bfs_levels(m, ROOT)
    want_parents = min_level_parents(edges, n, ROOT, level)
    reached = int((level >= 0).sum())
    log(f"[check] scipy BFS: {reached:,} reached, {int(level.max())} levels, "
        f"{time.perf_counter() - t0:.1f} s")
    first = main[parts_list[0]]
    for parts, res in main.items():
        for key in ("bfs/bsp", "bfs/fast"):
            got = res[key]["field"]
            check(np.array_equal(got, first["bfs/bsp"]["field"]),
                f"parts={parts} {key} parents differ from bfs/bsp "
                f"parts={parts_list[0]}")
            check(np.array_equal((got < INT_INF), level >= 0),
                f"parts={parts} {key}: reachability differs from scipy")
            check(np.array_equal(got, want_parents),
                f"parts={parts} {key}: a parent is not the min-id "
                f"in-neighbor one level up")
        for key, r in res.items():
            check(r["rounds"] == first[key]["rounds"],
                f"{key}: rounds {r['rounds']} at parts={parts} vs "
                f"{first[key]['rounds']} at parts={parts_list[0]}")
    log(f"[check] BFS parents: bsp == fast == scipy min-id level parents "
        f"at parts {list(parts_list)}")

    t0 = time.perf_counter()
    pr_rounds = {first[k]["rounds"] for k in ("pagerank/bsp",
                                              "pagerank/fast")}
    want_ranks = pagerank_f64(m, pr_rounds)
    pr_err = {}
    for parts, res in main.items():
        for key in ("pagerank/bsp", "pagerank/fast"):
            err = max_rel(res[key]["field"], want_ranks[res[key]["rounds"]])
            pr_err[f"{key}/{parts}"] = err
            check(err < PR_F64_TOL,
                f"parts={parts} {key}: max rel err {err:.3e} vs float64")
        a, b = res["pagerank/bsp"]["field"], res["pagerank/fast"]["field"]
        log(f"[check] parts={parts} PageRank bsp-vs-fast max rel diff: "
            f"{np.abs(a - b).max() / a.max():.2e}")
    log(f"[check] PageRank vs float64 scipy power iteration, max rel err "
        f"{ {k: f'{v:.2e}' for k, v in pr_err.items()} } "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- plain path on the card ---------------------------------------------
    plain = {}
    for parts, (_, eng, garr) in engines.items():
        plain[parts] = res_p = run_programs(port, eng, garr, "ell")
        for key, r in res_p.items():
            k = main[parts][key]
            check(r["rounds"] == k["rounds"],
                f"plain parts={parts} {key}: rounds {r['rounds']} vs "
                f"kernel {k['rounds']}")
            check(sum(r["launches"].values()) == 0, "plain mode launched")
            a, b = np.asarray(r["field"]), np.asarray(k["field"])
            check(a.dtype == b.dtype and a.shape == b.shape
                  and a.tobytes() == b.tobytes(),
                  f"plain parts={parts} {key}: "
                  + ("parents" if key.startswith("bfs") else "ranks")
                  + " differ from the kernels' (max abs "
                  f"{np.abs(a.astype(np.float64) - b).max():.3e})")
    log("[plain] mode ell on the card: parents and ranks bit-identical to "
        "the kernels', rounds equal")

    # -- times ---------------------------------------------------------------
    program_ms = {}
    for parts, (_, eng, garr) in engines.items():
        for algo, variant in PROGRAMS:
            key = f"{algo}/{variant}"
            args = (garr,) + ((ROOT,) if algo == "bfs" else ())
            kp, pp = main[parts][key]["prog"], plain[parts][key]["prog"]
            cell = {"rounds": main[parts][key]["rounds"],
                    "ms": median_ms(torch, device, lambda: kp(*args)),
                    "plain_ms": median_ms(torch, device, lambda: pp(*args)),
                    "launches": main[parts][key]["launches"]}
            program_ms[f"{key}/parts={parts}"] = cell
            log(f"[times] parts={parts} {key:14s} rounds={cell['rounds']:3d}"
                f" kernels {cell['ms']:9.2f} ms   plain {cell['plain_ms']:9.2f}"
                f" ms")
    kernel_cells = {}
    for parts, (g, _, garr) in engines.items():
        for key, cell in kernel_times(port, g, garr, level, device,
                                      parent).items():
            kernel_cells[f"{key}/parts={parts}"] = cell
            log(f"[times] parts={parts} {key:16s} kernel {cell['ms']:.4f} ms"
                f"  plain {cell['plain_ms']:.4f} ms  bound "
                f"{cell['bound_ms']:.4f} ms ({cell['bound_by']})"
                + (f"  sector bound {cell['sector_bound_ms']:.4f} ms"
                   if "sector_bound_ms" in cell else "")
                + f"  library {cell['library_ms']} ms  timed launches "
                f"{cell['timed_launches']}"
                + (f"  old design {cell['old_ms']:.4f} ms"
                   if "old_ms" in cell else ""))
    log("[times] " + json.dumps({"graph": graph, "programs": program_ms,
                                 "kernels": kernel_cells}, default=str))

    # -- the rest of the BSP suite and multi-source -----------------------
    bsp = run_bsp(port, m, engines, device)
    # -- async supersteps and the incremental programs -------------------
    asy = run_async(port, m, engines, main, bsp, program_ms)
    # -- the programs over torch.distributed, one part a rank -----------
    dst = run_dist(port, engines, device)
    # -- fault injection, guards and recovery -----------------------------
    chaos = run_chaos(port, engines, main, bsp, asy)
    # -- observability: telemetry builds, probes, traced recovery ---------
    obs = run_obs(port, engines, main, chaos["cells"])
    # -- the graph query server and its launcher --------------------------
    served = run_serve(port, graph, engines)
    # -- the graph dry-run: plans, and plans against card runs ------------
    dry = run_dryrun(port, engines)
    # -- dynamic graphs and durability, on a graph of their own ----------
    mutated = run_mutate(port, MUTATE_GRAPH, parts_list, device, parity)
    return {"launches": main_launches, "parity_err": parity_err,
            "kernel_cells": kernel_cells, "parts": max(parts_list),
            "bsp_launches": bsp["launches"],
            "multi_launches": bsp["multi_launches"],
            "async_launches": asy["launches"],
            "inc_launches": asy["inc_launches"],
            "chaos_launches": chaos["launches"], "obs_launches": obs,
            "serve_launches": served, "dryrun_launches": dry,
            "mutate_launches": mutated, "dist_launches": dst["launches"],
            "dist_by_rank": dst["by_rank"]}

def suite_fields(eng, prog, outs) -> dict:
    """Output name -> host value (vertex fields gathered to numpy)."""
    p = prog.program
    return {nm: (eng.gather_vertex_field(o) if isv else o)
            for nm, o, isv in zip(p.output_names, outs, p.output_is_vertex)}


def run_suite(port: Port, eng, garr, mode: str, algos) -> dict:
    """Each program once under local-ops ``mode`` (rooted ones from ROOT);
    per program its fields, rounds, kernel launches and program."""
    torch = port.torch
    res = {}
    with port.localops.using(mode):
        progs = {a: eng.program(a) for a in algos}
    for algo, prog in progs.items():
        args = (ROOT,) * len(prog.spec.inputs)
        before = port.launches()
        *outs, rounds = prog(garr, *args)
        _sync(torch, eng.device)
        after = port.launches()
        res[algo] = {"fields": suite_fields(eng, prog, outs),
                     "rounds": rounds, "prog": prog, "args": args,
                     "launches": {k: after[k] - before[k] for k in after}}
    return res


def same_fields(a: dict, b: dict) -> bool:
    """Equal names, and each value bit for bit (numpy) or equal (host
    scalar)."""
    return a.keys() == b.keys() and all(
        (isinstance(a[k], np.ndarray) and a[k].dtype == b[k].dtype
         and a[k].tobytes() == b[k].tobytes())
        or (not isinstance(a[k], np.ndarray) and a[k] == b[k]) for k in a)


def close(what: str, got, want, rtol: float, atol: float) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; the
    largest |got - want| / |want| over nonzero ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    with np.errstate(invalid="ignore"):
        diff = np.where(got == want, 0.0, diff)       # equal infinities
    bad = int((diff > atol + rtol * np.abs(want)).sum())
    nz = np.abs(want) > 0
    rel = float((diff[nz] / np.abs(want[nz])).max()) if nz.any() else 0.0
    check(bad == 0, f"{what}: {bad} entries beyond rtol {rtol:.2e} atol "
                    f"{atol:.2e} (max rel {rel:.3e}, max abs "
                    f"{float(diff.max()):.3e})")
    return rel


def program_times(port: Port, eng, garr, runs: dict) -> dict:
    """Median ms of 3 synchronized calls of each run's program (the
    checked call was the warm-up)."""
    torch = port.torch
    return {algo: median_ms(torch, eng.device,
                            lambda r=r: r["prog"](garr, *r["args"]))
            for algo, r in runs.items()}


def run_bsp(port: Port, m, engines: dict, device) -> dict:
    """The rest of the BSP suite on the card: sssp, cc, kcore and
    betweenness on the main path's partitions, triangles on a TRI_N-vertex
    urand graph, each in local-ops modes auto and ell; then bfs/fast,
    sssp and betweenness batched over MULTI_ROOTS.  Checks against
    independent host references (numpy / scipy), bit-identity between the
    modes, spmv_ell's launch count on betweenness, and batched rows
    against single-source runs."""
    torch = port.torch
    t_phase = time.perf_counter()

    # -- host references -------------------------------------------------
    t0 = time.perf_counter()
    u = undirected_matrix(m)
    want_dist = sssp_dijkstra(m, ROOT)
    want_labels = min_id_components(u)
    want_core, want_kcore_rounds = core_numbers(u)
    want_bc, want_sigma, want_bdist = brandes_f64(m, ROOT)
    del u
    levels = int(want_bdist[want_bdist < INT_INF].max())
    log(f"[bsp] host references in {time.perf_counter() - t0:.1f} s: "
        f"dijkstra {int(np.isfinite(want_dist).sum()):,} reached; "
        f"{len(np.unique(want_labels)):,} components; kmax "
        f"{int(want_core.max())} in {want_kcore_rounds} peeling rounds; "
        f"Brandes {levels} levels, max sigma {want_sigma.max():.4g}")

    # -- the programs in mode auto: the path, counts zeroed around it ----
    algos = BSP_PROGRAMS
    port.reset_launches()
    auto = {parts: run_suite(port, eng, garr, "auto", algos)
            for parts, (_, eng, garr) in engines.items()}
    launches = port.launches()
    log(f"[bsp] launches {launches}")

    # -- mode ell: bit-identical; the betweenness phases split -----------
    plain, errs, want_spmv = {}, {}, 0
    for parts, (g, eng, garr) in engines.items():
        plain[parts] = run_suite(port, eng, garr, "ell", algos)
        tables = {k: len(port.ell.launch_tables(g.ell_meta[k].buckets))
                  for k in ("ell_dst", "ell_out")}
        fwd, back = auto[parts]["betweenness"]["prog"].program.phases
        with port.localops.using("ell"):
            (dist1, sigma1), r_f = port.run_program(fwd, garr, ROOT)
            _, r_b = port.run_program(back, garr, dist1, sigma1)
        for algo in algos:
            a, p = auto[parts][algo], plain[parts][algo]
            check(a["rounds"] == p["rounds"],
                  f"parts={parts} {algo}: rounds {a['rounds']} (auto) vs "
                  f"{p['rounds']} (ell)")
            check(same_fields(a["fields"], p["fields"]),
                  f"parts={parts} {algo}: outputs differ between modes auto "
                  f"and ell")
            check(sum(p["launches"].values()) == 0, "mode ell launched")
            calls = r_f * tables["ell_dst"] + r_b * tables["ell_out"] \
                if algo == "betweenness" else 0
            want_spmv += calls
            check(a["launches"]["spmv_ell"] == calls
                  and a["launches"]["bfs_pull"] == 0,
                  f"parts={parts} {algo}: launches {a['launches']}, want "
                  f"spmv_ell {calls} and bfs_pull 0")
        check(r_f + r_b == auto[parts]["betweenness"]["rounds"],
              f"parts={parts} betweenness: phases {r_f} + {r_b} rounds")
        log(f"[bsp] parts={parts} betweenness: {r_f} forward x "
            f"{tables['ell_dst']} + {r_b} backward x {tables['ell_out']} "
            f"spmv_ell launches, as counted; all programs bit-identical "
            f"between modes auto and ell")

        # -- against the host references -----------------------------------
        f = auto[parts]
        dist = f["sssp"]["fields"]["dist"]
        errs[f"sssp/{parts}"] = close(
            f"parts={parts} sssp dist vs dijkstra",
            np.where(dist >= 1e29, np.inf, dist), want_dist, SSSP_RTOL,
            SSSP_ATOL)
        check(np.array_equal(f["cc"]["fields"]["labels"], want_labels),
              f"parts={parts} cc: labels differ from the min vertex id of "
              f"each weakly connected component")
        kc = f["kcore"]
        cap = kc["prog"].program.max_rounds
        check(want_kcore_rounds <= cap,
              f"parts={parts} kcore stopped at max_rounds={cap} with "
              f"vertices alive (host peeling takes {want_kcore_rounds})")
        check(np.array_equal(kc["fields"]["core"], want_core)
              and kc["fields"]["kmax"] == int(want_core.max())
              and kc["rounds"] == want_kcore_rounds,
              f"parts={parts} kcore: cores, kmax {kc['fields']['kmax']} or "
              f"rounds {kc['rounds']} differ from host peeling "
              f"({int(want_core.max())}, {want_kcore_rounds} rounds)")
        bc = f["betweenness"]["fields"]
        check(np.array_equal(bc["dist"], want_bdist),
              f"parts={parts} betweenness: dist differs from host BFS")
        # sigma: path counts are integers, exact in float32 below 2**24
        check(want_sigma.max() < 2 ** 24,
              f"max sigma {want_sigma.max():.4g} past float32's exact "
              f"integers: SIGMA_RTOL needs the float32 error bound")
        errs[f"sigma/{parts}"] = close(
            f"parts={parts} betweenness sigma vs float64 Brandes",
            bc["sigma"], want_sigma, SIGMA_RTOL, 0.0)
        errs[f"bc/{parts}"] = close(
            f"parts={parts} betweenness bc vs float64 Brandes", bc["bc"],
            want_bc, BC_TOL, BC_TOL)
        check(bc["bc"][ROOT] == 0.0, "betweenness: delta_s(s) != 0")
        log(f"[bsp] parts={parts}: sssp == dijkstra (max rel "
            f"{errs[f'sssp/{parts}']:.3e}), cc == min-id components, kcore "
            f"== host peeling, betweenness sigma max rel "
            f"{errs[f'sigma/{parts}']:.3e} (tol {SIGMA_RTOL}), bc max rel "
            f"{errs[f'bc/{parts}']:.3e} (tol {BC_TOL})")
    check(launches["spmv_ell"] == want_spmv > 0
          and launches["bfs_pull"] == 0,
          f"bsp path: spmv_ell {launches['spmv_ell']} launches, want "
          f"{want_spmv}; bfs_pull {launches['bfs_pull']}, want 0")

    # -- triangles on a graph inside its n_budget --------------------------
    tri_edges = port.urand_edges(TRI_N, 16 * TRI_N, SEED)
    want_tri, want_total = triangle_counts(tri_edges, TRI_N)
    tri = {}
    for parts in engines:
        g_t = port.partition_graph(tri_edges, TRI_N, parts)
        check(g_t.n <= port.registry.get_spec("triangles").n_budget,
              f"triangles: n={g_t.n} past its n_budget")
        eng_t = port.GraphEngine(g_t, device=device)
        garr_t = eng_t.device_graph()
        a = run_suite(port, eng_t, garr_t, "auto", ("triangles",))
        p = run_suite(port, eng_t, garr_t, "ell", ("triangles",))
        ta, tp = a["triangles"], p["triangles"]
        check(ta["rounds"] == tp["rounds"] == parts
              and same_fields(ta["fields"], tp["fields"])
              and sum(ta["launches"].values()) == 0,
              f"triangles parts={parts}: modes differ, or a kernel ran")
        check(np.array_equal(ta["fields"]["triangles"], want_tri)
              and ta["fields"]["total"] == want_total,
              f"triangles parts={parts}: counts differ from scipy A o (A @ "
              f"A) (total {ta['fields']['total']} vs {want_total})")
        tri[parts] = {"rounds": ta["rounds"],
                      "ms": program_times(port, eng_t, garr_t, a)
                      ["triangles"],
                      "plain_ms": program_times(port, eng_t, garr_t, p)
                      ["triangles"]}
        log(f"[bsp] parts={parts} triangles n={TRI_N}: total {want_total:,}"
            f" == scipy, per vertex equal; auto {tri[parts]['ms']:.2f} ms, "
            f"ell {tri[parts]['plain_ms']:.2f} ms, rounds "
            f"{tri[parts]['rounds']}")
        del eng_t, garr_t

    # -- times -------------------------------------------------------------
    times = {}
    for parts, (_, eng, garr) in engines.items():
        ka = program_times(port, eng, garr, auto[parts])
        kp = program_times(port, eng, garr, plain[parts])
        for algo in algos:
            times[f"{algo}/parts={parts}"] = cell = {
                "rounds": auto[parts][algo]["rounds"], "ms": ka[algo],
                "plain_ms": kp[algo],
                "launches": auto[parts][algo]["launches"]["spmv_ell"]}
            log(f"[times] parts={parts} {algo:14s} rounds={cell['rounds']:3d}"
                f" kernels {cell['ms']:9.2f} ms   plain "
                f"{cell['plain_ms']:9.2f} ms")
    for parts, cell in tri.items():
        times[f"triangles/n={TRI_N}/parts={parts}"] = cell

    # -- multi-source: batched rows against single-source runs -------------
    single = {}
    for parts, (_, eng, garr) in engines.items():
        for algo, variant in MULTI:
            prog = eng.program(algo, variant)
            for r in MULTI_ROOTS:
                before = port.launches()
                *outs, rounds = prog(garr, r)
                _sync(torch, eng.device)
                after = port.launches()
                single[parts, algo, r] = (
                    suite_fields(eng, prog, outs), rounds,
                    {k: after[k] - before[k] for k in after})
    port.reset_launches()
    batched = {}
    for parts, (_, eng, garr) in engines.items():
        for algo, variant in MULTI:
            prog = eng.program(algo, variant, batch=len(MULTI_ROOTS))
            before = port.launches()
            *outs, rounds = prog(garr, MULTI_ROOTS)
            _sync(torch, eng.device)
            after = port.launches()
            batched[parts, algo] = (prog, outs, rounds,
                                    {k: after[k] - before[k] for k in after})
    multi_launches = port.launches()
    log(f"[multi] launches {multi_launches}")
    for (parts, algo), (prog, outs, rounds, launched) in batched.items():
        eng, garr = engines[parts][1], engines[parts][2]
        rows = {nm: eng.gather_batched_vertex_field(o)
                for nm, o in zip(prog.program.output_names, outs)}
        want_launched = {}
        for i, r in enumerate(MULTI_ROOTS):
            fields, r_rounds, r_launched = single[parts, algo, r]
            check(rounds[i] == r_rounds and same_fields(
                {nm: v[i] for nm, v in rows.items()}, fields),
                f"parts={parts} {algo} batched row {i} (root {r}) differs "
                f"from its single-source run")
            for k, v in r_launched.items():
                want_launched[k] = want_launched.get(k, 0) + v
        check(launched == want_launched,
              f"parts={parts} {algo} batched launches {launched}, want the "
              f"single-source runs' {want_launched}")
        ms = median_ms(torch, eng.device,
                       lambda: prog(garr, MULTI_ROOTS))
        name = f"{prog.spec.label}_x{len(MULTI_ROOTS)}"
        times[f"{name}/parts={parts}"] = {
            "rounds": rounds, "ms": ms, "launches": launched}
        log(f"[multi] parts={parts} {name}: rows and "
            f"rounds {rounds} == single-source runs, launches {launched}; "
            f"{ms:.2f} ms ({ms / len(MULTI_ROOTS):.2f} ms/query)")
    for name in ("spmv_ell", "bfs_pull"):
        check(multi_launches[name] > 0,
              f"multi-source path: {name} never launched")
    secs = time.perf_counter() - t_phase
    log("[times] " + json.dumps({"bsp": times, "errors": errs,
                                 "seconds": secs}, default=str))
    log(f"[bsp done] {secs:.1f} s")
    return {"launches": launches, "multi_launches": multi_launches,
            "auto": auto, "times": times}


# ---------------------------------------------------------------------------
# async supersteps and the incremental programs
# ---------------------------------------------------------------------------

class SyncCounter:
    """Counts ``Tensor.item`` calls (the async loops' device-to-host
    syncs) while active."""

    def __init__(self, torch):
        self.torch = torch
        self.count = 0

    def __enter__(self):
        item = self._item = self.torch.Tensor.item

        def counted(t):
            self.count += 1
            return item(t)

        self.torch.Tensor.item = counted
        return self

    def __exit__(self, *exc):
        self.torch.Tensor.item = self._item


def pagerank_f64_converged(m, tol: float = 1e-13,
                           max_rounds: int = 400) -> np.ndarray:
    """The float64 power iteration of ``pagerank_f64`` run until the L1
    change of a round is below ``tol`` (raises if it is not within
    ``max_rounds``)."""
    n = m.shape[0]
    out_deg = np.asarray(m.sum(axis=1)).ravel()
    inv = np.where(out_deg > 0, 1.0 / np.maximum(out_deg, 1.0), 0.0)
    base = (1.0 - ALPHA) / n
    mt = m.T.tocsr()
    r = np.full(n, 1.0 / n)
    for _ in range(max_rounds):
        new = base + ALPHA * (mt @ (r * inv))
        delta, r = np.abs(new - r).sum(), new
        if delta < tol:
            return r
    raise AssertionError(f"float64 PageRank not converged in {max_rounds} "
                         f"rounds (L1 change {delta:.3e})")


def async_run(port: Port, eng, garr, algo: str, variant: str, args,
              mode: str = "auto", **params) -> dict:
    """One run under local-ops ``mode``: host fields, rounds, syncs,
    launches and wire bytes per round by op."""
    torch = port.torch
    with port.localops.using(mode):
        prog = eng.program(algo, variant, **params)
    eng.comm.reset_wire()
    before = port.launches()
    with SyncCounter(torch) as syncs:
        *outs, rounds = prog(garr, *args)
        _sync(torch, eng.device)
    after = port.launches()
    return {"fields": suite_fields(eng, prog, outs), "rounds": rounds,
            "syncs": syncs.count, "prog": prog, "args": args,
            "params": params,
            "launches": {k: after[k] - before[k] for k in after},
            "wire": {op: b // max(rounds, 1)
                     for op, b in eng.comm.wire_by_op().items()}}


def run_async(port: Port, m, engines: dict, main: dict, bsp: dict,
              program_ms: dict) -> dict:
    """The async programs and the incremental variants on the main
    path's partitions: in local-ops mode auto (launch counters zeroed
    just before and read just after each of the two groups), checked
    against the BSP programs of the main and bsp phases and a converged
    float64 PageRank; then in mode ell (bit-identical, no launches);
    then timed beside their BSP siblings."""
    torch = port.torch
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    want_rank = pagerank_f64_converged(m)
    log(f"[async] float64 PageRank converged in "
        f"{time.perf_counter() - t0:.1f} s")
    slack = (port.superstep.ASYNC_ROUNDS_SLACK_FACTOR,
             port.superstep.ASYNC_ROUNDS_SLACK_CONST)

    # -- the async programs, mode auto: counts zeroed around them -------
    port.reset_launches()
    runs = {}
    for parts, (_, eng, garr) in engines.items():
        for algo in ASYNC_MONOTONE:
            runs[parts, f"{algo}/async"] = async_run(
                port, eng, garr, algo, "async",
                (ROOT,) if algo != "cc" else ())
        for s in ASYNC_STALENESS:
            runs[parts, f"pagerank/async s={s}"] = async_run(
                port, eng, garr, "pagerank", "async", (), staleness=s,
                **ASYNC_PR_PARAMS)
    async_launches = port.launches()
    log(f"[async] launches {async_launches}")

    # -- the incremental programs, mode auto: counts zeroed around them --
    port.reset_launches()
    for parts, (g, eng, garr) in engines.items():
        auto = bsp["auto"][parts]
        warm = {"cc": auto["cc"]["fields"]["labels"],
                "kcore": auto["kcore"]["fields"]["core"],
                "pagerank": main[parts]["pagerank/fast"]["field"]}
        for algo, variant in INCREMENTAL:
            spec = port.registry.get_spec(algo, variant)
            seeds = {"warm": warm[algo]}
            if algo != "pagerank":
                (seeds["cold"],) = port.incremental.cold_seed(spec, g)
            for kind, seed in seeds.items():
                runs[parts, f"{algo}/{variant} {kind}"] = async_run(
                    port, eng, garr, algo, variant,
                    (eng.scatter_vertex_field(seed),),
                    **(ASYNC_PR_PARAMS if algo == "pagerank" else {}))
    inc_launches = port.launches()
    log(f"[incremental] launches {inc_launches}")

    # -- checks against the BSP programs and float64 ---------------------
    want_async = want_inc = 0
    # spmv_ell launches once per launch table of a push combine's call
    tables = {parts: len(port.ell.launch_tables(g.ell_meta["ell_dst"]
                                                .buckets))
              for parts, (g, _, _) in engines.items()}
    for (parts, label), r in runs.items():
        what = f"parts={parts} {label}"
        f = r["fields"]
        algo = label.split("/")[0]
        auto = bsp["auto"][parts]
        if label.startswith(("pagerank/async", "pagerank/warm")):
            r["rank_err"] = err = max_rel(f["rank"], want_rank)
            check(r["rounds"] < ASYNC_PR_PARAMS["iters"],
                  f"{what}: not converged in {r['rounds']} rounds "
                  f"(err {f['err']:.3e})")
            check(err < PR_F64_TOL, f"{what}: max rel err {err:.3e} vs "
                                    f"converged float64")
            if label.startswith("pagerank/async"):
                s = r["params"]["staleness"]
                check(f["max_age"] <= 2 * s + 1,
                      f"{what}: max_age {f['max_age']} > {2 * s + 1}")
                want = (r["rounds"] + 1) * tables[parts]
                syncs = -(-r["rounds"] // s)
                want_async += want
            else:
                want = r["rounds"] * tables[parts]
                want_inc += want
            check(r["launches"]["spmv_ell"] == want
                  and r["launches"]["bfs_pull"] == 0,
                  f"{what}: launches {r['launches']}, want spmv_ell {want}")
            if label.startswith("pagerank/async"):
                check(r["syncs"] == syncs,
                      f"{what}: {r['syncs']} syncs in {r['rounds']} rounds")
            continue
        check(sum(r["launches"].values()) == 0,
              f"{what}: launched {r['launches']}")
        if label.endswith("/async"):
            if algo == "bfs":
                want = {"parents": main[parts]["bfs/fast"]["field"]}
                bsp_rounds = main[parts]["bfs/fast"]["rounds"]
            else:
                want = auto[algo]["fields"]
                bsp_rounds = auto[algo]["rounds"]
            cap = slack[0] * bsp_rounds + slack[1]
            check(r["rounds"] <= cap,
                  f"{what}: {r['rounds']} rounds, past {slack[0]} x "
                  f"{bsp_rounds} + {slack[1]}")
            check(r["syncs"] == r["rounds"],
                  f"{what}: {r['syncs']} syncs in {r['rounds']} rounds")
        else:
            want = auto[algo]["fields"]
        check(same_fields(f, want),
              f"{what}: outputs differ from the BSP program's")
    check(async_launches["spmv_ell"] == want_async > 0
          and async_launches["bfs_pull"] == 0,
          f"async path: spmv_ell {async_launches['spmv_ell']} launches, "
          f"want {want_async}")
    check(inc_launches["spmv_ell"] == want_inc > 0
          and inc_launches["bfs_pull"] == 0,
          f"incremental path: spmv_ell {inc_launches['spmv_ell']} "
          f"launches, want {want_inc}")
    log("[async] bfs/sssp/cc async == bfs/fast, sssp and cc bit for bit "
        "within the rounds slack, no kernel, one sync a round; "
        "pagerank/async and pagerank/warm converged within "
        f"{PR_F64_TOL} of float64, spmv_ell once a round (+1 at init for "
        "async); cc/incremental == cc, kcore/incremental == kcore from "
        "cold and warm seeds")

    # -- mode ell: bit-identical, equal rounds, no launches ---------------
    plain = {}
    for (parts, label), r in runs.items():
        _, eng, garr = engines[parts]
        spec = r["prog"].spec
        p = async_run(port, eng, garr, spec.algo, spec.variant, r["args"],
                      mode="ell", **r["params"])
        check(p["rounds"] == r["rounds"]
              and same_fields(p["fields"], r["fields"])
              and sum(p["launches"].values()) == 0,
              f"parts={parts} {label}: mode ell gives other outputs or "
              f"rounds ({p['rounds']} vs {r['rounds']}), or launched")
        plain[parts, label] = p
    log("[async] mode ell: every run bit-identical to mode auto, rounds "
        "equal, no launches")

    # -- times -----------------------------------------------------------
    times = {}
    for (parts, label), r in runs.items():
        _, eng, garr = engines[parts]
        sib = ASYNC_SIBLING[label.split(" ")[0]]
        sib_cell = program_ms.get(f"{sib}/parts={parts}") \
            or bsp["times"][f"{sib}/parts={parts}"]
        cell = {"rounds": r["rounds"], "syncs": r["syncs"],
                "wire_per_round": r["wire"],
                "launches": r["launches"]["spmv_ell"],
                "ms": median_ms(torch, eng.device,
                                lambda: r["prog"](garr, *r["args"])),
                "plain_ms": median_ms(
                    torch, eng.device,
                    lambda: plain[parts, label]["prog"](garr, *r["args"])),
                "bsp": sib, "bsp_ms": sib_cell["ms"],
                "bsp_rounds": sib_cell["rounds"]}
        if "rank_err" in r:
            cell["rank_err"] = r["rank_err"]
        if "max_age" in r["fields"]:
            cell["max_age"] = r["fields"]["max_age"]
        times[f"{label}/parts={parts}"] = cell
        log(f"[async] parts={parts} {label:24s} rounds={cell['rounds']:3d} "
            f"auto {cell['ms']:9.2f} ms  ell {cell['plain_ms']:9.2f} ms  "
            f"syncs {cell['syncs']:3d}  wire/round {cell['wire_per_round']}"
            f"  {sib} {cell['bsp_ms']:.2f} ms in {cell['bsp_rounds']} rounds"
            + (f"  rank err {cell['rank_err']:.2e}" if "rank_err" in cell
               else "")
            + (f"  max_age {cell['max_age']}" if "max_age" in cell
               else ""))
    secs = time.perf_counter() - t_phase
    log("[times] " + json.dumps({"async": times, "seconds": secs},
                                default=str))
    log(f"[async done] {secs:.1f} s")
    return {"launches": async_launches, "inc_launches": inc_launches,
            "runs": runs}


# ---------------------------------------------------------------------------
# the multi-rank exchange: DistComm over torch.distributed
# ---------------------------------------------------------------------------

def dist_params(algo: str, variant: str) -> dict:
    """Registry defaults, but pagerank/async and /warm at ASYNC_PR_PARAMS
    (as the async phase runs them)."""
    return dict(ASYNC_PR_PARAMS) if algo == "pagerank" \
        and variant in ("async", "warm") else {}


def dist_args(port: Port, eng, garr, spec) -> tuple:
    """Root ROOT, or the incremental programs' cold seeds (computed from
    the shards the engine holds, scattered to its parts)."""
    if any(k != "scalar" for k in spec.input_kinds):
        (seed,) = port.incremental.cold_seed(spec, eng.g)
        return (garr, eng.scatter_vertex_field(
            seed, port.incremental.KIND_DTYPES[spec.input_kinds[0]]))
    return (garr,) + (ROOT,) * len(spec.inputs)


def dist_programs(port: Port, eng, garr, programs, tri=None) -> dict:
    """Each of ``programs`` once in local-ops mode auto (triangles on the
    ``tri`` engine and arrays), launch counters zeroed just before and
    read just after each run, then the guarded chaos runs of
    DIST_CHAOS_PROGRAMS under DIST_CHAOS: per run the host fields
    (vertex fields gathered to every part), rounds, the wire it tallied
    by (phase, op), launches, the ok verdict of a guarded run, and the
    run's synchronized ms.  The same code under either comm."""
    torch = port.torch
    out = {}
    runs = [(a, v, {}) for a, v in programs] \
        + [(a, v, {"guard": True, "faults": DIST_CHAOS})
           for a, v in DIST_CHAOS_PROGRAMS]
    for algo, variant, opts in runs:
        e, ga = tri if algo == "triangles" else (eng, garr)
        spec = port.registry.get_spec(algo, variant)
        prog = e.program(algo, variant, **opts, **dist_params(algo, variant))
        args = dist_args(port, e, ga, spec)
        _sync(torch, e.device)
        before = e.comm.tally()
        port.reset_launches()
        t0 = time.perf_counter()
        res = prog(*args)
        _sync(torch, e.device)
        ms = (time.perf_counter() - t0) * 1e3
        launches = port.launches()
        ok = res[-1] if opts else None
        *outs, rounds = res[:-1] if opts else res
        key = f"{algo}/{variant}" + (" chaos" if opts else "")
        out[key] = {
            "fields": suite_fields(e, prog, outs),
            "rounds": rounds, "ok": ok, "ms": ms,
            "wire": port.tally_delta(before, e.comm.tally()),
            "launches": {k: launches[k] for k in ("spmv_ell", "bfs_pull")},
            "prog": prog, "args": args}
    return out


def hand_off(g, path: Path) -> int:
    """Write one part's shards (``GraphShards.take_part``) for a rank to
    load with :func:`load_part`; the file's bytes."""
    with open(path, "wb") as f:
        pickle.dump(g, f, protocol=5)
    return path.stat().st_size


def load_part(path: Path):
    """The shards :func:`hand_off` wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)


def wait_ranks(procs, timeout_s: float) -> None:
    """Wait for every rank process; fail the phase if one exits non-zero
    or is still running ``timeout_s`` after the wait began (every rank
    still running is then killed, so none outlives the phase)."""
    deadline = time.monotonic() + timeout_s
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.01))
            except subprocess.TimeoutExpired:
                check(False, f"rank {r} still running after "
                             f"{timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    check(not bad, f"ranks failed (rank, exit code): {bad}")


def fields_digest(fields: dict) -> str:
    """A digest of a run's host fields, to hold ranks' gathers equal."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(fields):
        v = fields[k]
        h.update(k.encode())
        h.update(v.dtype.str.encode() + v.tobytes()
                 if isinstance(v, np.ndarray) else repr(v).encode())
    return h.hexdigest()


def dist_same(tag: str, got: dict, want: dict, fields: bool = True) -> None:
    """Fail unless a DistComm run equals the StackedComm run of the same
    program: rounds, ok verdict, wire by (phase, op), kernel launches,
    and (``fields``) every output bit for bit."""
    check(got["rounds"] == want["rounds"],
          f"{tag}: rounds {got['rounds']} vs stacked {want['rounds']}")
    check(got["ok"] == want["ok"],
          f"{tag}: ok {got['ok']} vs stacked {want['ok']}")
    check(got["wire"] == want["wire"],
          f"{tag}: wire {got['wire']} vs stacked {want['wire']}")
    check(got["launches"] == want["launches"],
          f"{tag}: launches {got['launches']} vs stacked "
          f"{want['launches']}")
    if fields:
        check(same_fields(got["fields"], want["fields"]),
              f"{tag}: outputs differ from stacked")


def chaos_schedule(rounds: int) -> str:
    """The chaos phase's schedule, its events clipped to a run of
    ``rounds`` rounds."""
    r_top = max(rounds, 1) - 1
    return (f"drop@r{min(1, r_top)}p0 corrupt@r{min(2, r_top)}p1 "
            f"stall@r{min(3, r_top)}p0x2 seed=7")


def host_fields(port: Port, eng, program, outs) -> dict:
    """A run's outputs on the host: vertex fields gathered (to every
    part), tensor scalars as numpy."""
    torch = port.torch
    return {nm: (eng.gather_vertex_field(o) if isv
                 else o.cpu().numpy() if isinstance(o, torch.Tensor) else o)
            for nm, o, isv in zip(program.output_names, outs,
                                  program.output_is_vertex)}


def dist_recovery(port: Port, eng, garr, schedules: dict) -> dict:
    """DIST_RECOVERY through ``CheckpointRunner`` at CHAOS_EVERY under
    ``schedules`` (key -> schedule), launch counters zeroed just before
    and read just after each run: the outputs' digest, rounds,
    detections, recoveries, checkpoints, ms, and each snapshot's ms and
    bytes; bfs/fast also resumed from its middle checkpoint.  The same
    code on a rank and stacked."""
    torch = port.torch
    out = {}
    for algo, variant in DIST_RECOVERY:
        key = f"{algo}/{variant}"
        runner = port.CheckpointRunner(
            eng, algo, variant, checkpoint_every=CHAOS_EVERY,
            faults=schedules[key], keep_history=key == "bfs/fast",
            **dist_params(algo, variant))
        snaps, _ = timed_snapshots(port, runner, eng.device)
        _sync(torch, eng.device)
        port.reset_launches()
        t0 = time.perf_counter()
        rep = runner.run(garr, ROOT)
        _sync(torch, eng.device)
        ms = (time.perf_counter() - t0) * 1e3
        launches = port.launches()
        cell = {"digest": fields_digest(host_fields(
                    port, eng, runner.program, rep.outputs)),
                "rounds": rep.rounds, "detections": list(rep.detections),
                "recoveries": rep.recoveries,
                "checkpoints": rep.checkpoints, "ms": ms,
                "snap_ms": float(np.median([c[0] for c in snaps])),
                "snap_bytes": max(c[1] for c in snaps),
                "launches": {k: launches[k]
                             for k in ("spmv_ell", "bfs_pull")}}
        if rep.history:
            mid = rep.history[len(rep.history) // 2]
            t0 = time.perf_counter()
            rep2 = runner.run(garr, ROOT, resume_from=mid)
            _sync(torch, eng.device)
            cell.update(resumed_from=mid.rounds, resume_ms=(
                time.perf_counter() - t0) * 1e3, resumed=fields_digest(
                    host_fields(port, eng, runner.program, rep2.outputs)))
            del rep2, mid
        out[key] = cell
        del rep, runner
    return out


def dist_serve(port: Port, eng) -> dict:
    """A ``GraphServer`` over ``eng`` (over ranks rank 0 leads and the
    others follow) warmed for DIST_SERVED and pagerank/fast, then each
    served the first two rungs of SERVE_ROOTS (a refresh its queries
    sharing one launch) and one pagerank/fast refresh, launch counters
    zeroed around the serving: per call its ms and (rank 0, stacked) each
    answer's status, rounds, bucket and fields' digest."""
    torch, gs = port.torch, port.graph_server
    server = gs.GraphServer(eng, buckets=DIST_SERVE_BUCKETS, depth=2)
    t0 = time.perf_counter()
    server.warmup([*DIST_SERVED, "pagerank/fast"])
    warm_s = time.perf_counter() - t0
    port.reset_launches()
    calls = []
    for name, roots in [(n, r) for n in DIST_SERVED
                        for r in SERVE_ROOTS[:2]] + [("pagerank/fast", (0,))]:
        key = gs.make_key(name)
        _sync(torch, eng.device)
        t0 = time.perf_counter()
        res = server.serve([gs.Query(key, r if key.rooted else None)
                            for r in roots])
        _sync(torch, eng.device)
        calls.append({"name": name, "n": len(roots),
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "answers": [(r.status, r.rounds, r.bucket,
                                   fields_digest(r.fields)) for r in res]})
    launches = port.launches()
    server.close()
    return {"calls": calls, "warm_s": warm_s,
            "launches": {k: launches[k] for k in ("spmv_ell", "bfs_pull")}}


def part_digests(g, dyn) -> list:
    """One digest a held part: its COO and ELL mirrors and its planner
    state (occupancy, free stacks, the touched keys' position lists)."""
    import hashlib
    st = dyn.planner_state()
    out = []
    for lp in range(g.out_degree.shape[0]):
        h = hashlib.sha256()
        for k in ("out_src_local", "out_dst_global", "in_src_global",
                  "in_dst_local", "out_degree", "in_degree"):
            h.update(getattr(g, k)[lp].tobytes())
        for k in sorted(g.ell_arrays):
            h.update(k.encode() + g.ell_arrays[k][lp].tobytes())
        for name in sorted(st["occ"]):
            h.update(st["occ"][name][lp].tobytes())
        h.update(repr([st[k][lp] for k in ("free_out", "free_in",
                                           "pos_out", "pos_in")]).encode())
        out.append(h.hexdigest())
    return out


def dist_durable(port: Port, eng, pdir: Path) -> dict:
    """A durable ``GraphServer`` over ``eng`` in the empty ``pdir``:
    MUTATE_DURABLE's batches (deletes, then inserts, sampled from one
    generator), then copies of the first live edge just past the free
    pools (a rebuild); closed and recovered (over ranks every rank loads
    its part).  Each held part's digest after the batches and after the
    recovery, the sampled batches' digests, the WAL's and the
    snapshot files' bytes, and the times.  The same code on a rank and
    stacked."""
    torch, gs, persist = port.torch, port.graph_server, port.persist
    d = MUTATE_DURABLE
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    server = gs.GraphServer(eng, buckets=DIST_SERVE_BUCKETS, persistence=(
        gs.Persistence(dir=str(pdir), snapshot_every=d["snapshot_every"])))
    create_s = time.perf_counter() - t0
    dyn = server.dynamic_graph()
    sampled, batch_ms = [], []
    for i in range(d["batches"]):
        kind = "deletes" if i % 2 == 0 else "inserts"
        batch = dyn.sample_deletable(d["size"], rng) if i % 2 == 0 \
            else dyn.sample_insertable(d["size"], rng)
        sampled.append(fields_digest({kind: batch}))
        _sync(torch, eng.device)
        t0 = time.perf_counter()
        server.mutate(**{kind: batch})
        _sync(torch, eng.device)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    u, v = (int(x) for x in dyn.current_edges()[0])
    k = 1                                      # just past the free pools
    while not dyn.plan(np.tile([[u, v]], (k, 1)))[2]:
        k += 1
    t0 = time.perf_counter()
    stats = server.mutate(inserts=np.tile([[u, v]], (k, 1)))
    rebuild_s = time.perf_counter() - t0
    check(stats.rebuild, f"[dist-durable] {k} copies of ({u}, {v}) did not "
                         "rebuild")
    digests = part_digests(eng.g, dyn)
    on_device = mirrors_on_device(torch, eng.g, server.garr)
    epoch = server.epoch
    server.close()
    mine = f"rank{eng.comm.first_part:03d}-" if eng.distributed \
        else "snapshot-"
    snap_bytes = max(os.path.getsize(pdir / f) for f in os.listdir(pdir)
                     if f.startswith(mine) and f.endswith(".bin"))
    t0 = time.perf_counter()
    rec = gs.GraphServer.recover(str(pdir), mesh=eng.mesh,
                                 device=eng.device,
                                 buckets=DIST_SERVE_BUCKETS)
    recover_s = time.perf_counter() - t0
    rep = rec.recovery_report
    out = {"digests": digests, "on_device": on_device, "epoch": epoch,
           "sampled": sampled, "copies": k, "create_s": create_s,
           "batch_ms": batch_ms, "rebuild_s": rebuild_s,
           "snap_bytes": snap_bytes,
           "recovered": part_digests(rec.engine.g, rec.dynamic),
           "recovered_on_device": mirrors_on_device(torch, rec.engine.g,
                                                    rec.garr),
           "recovered_epoch": rec.epoch,
           "report": (rep.snapshot_epoch, rep.replayed, rep.rebuilds),
           "recover_s": recover_s,
           "wal": (persist.wal_path(str(pdir)) if os.path.exists(
               persist.wal_path(str(pdir))) else None)}
    rec.close()
    return out


def dist_rank_main(rank: int, d: Path) -> int:
    """One rank of the [dist] phase's gloo run (``chip_smoke.py
    --dist-rank R``): load this rank's part of the graph, build the
    engine over the process group (``DistComm``), warm up, run ``job.json``'s programs with
    :func:`dist_programs`, and write the results (rank 0 with its
    gathered fields; every rank its fields' digest)."""
    port = Port()
    torch = port.torch
    import torch.distributed as dist
    job = json.loads((d / "job.json").read_text())
    device = job["device"]
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // DIST_WORLD))
    dist.init_process_group("gloo", init_method=f"file://{d}/rdzv-gloo",
                            rank=rank, world_size=DIST_WORLD)
    try:
        port.localops.set_mode("auto")
        mesh = port.mesh.make_graph_mesh(DIST_WORLD)
        t0 = time.perf_counter()
        eng = port.GraphEngine(load_part(d / f"part{rank}.pkl"),
                               device=device, mesh=mesh)
        garr = eng.device_graph()
        _sync(torch, device)
        load_s = time.perf_counter() - t0
        dist_programs(port, eng, garr, DIST_WARMUP)
        programs = [tuple(p) for p in job["programs"]]
        t0 = time.perf_counter()
        res = dist_programs(port, eng, garr, programs)
        out = {"rank": rank, "comm": repr(eng.comm), "load_s": load_s,
               "run_s": time.perf_counter() - t0,
               "staged": sorted(eng.comm.staged_ops), "runs": {}}
        for key, r in res.items():
            cell = {k: r[k] for k in ("rounds", "ok", "ms", "wire",
                                      "launches")}
            cell["digest"] = fields_digest(r["fields"])
            if rank == 0:
                cell["fields"] = r["fields"]
            out["runs"][key] = cell
        del res
        out["recovery"] = dist_recovery(port, eng, garr, job["schedules"])
        out["serve"] = dist_serve(port, eng)
        del garr, eng
        out["durable"] = dist_durable(port, port.GraphEngine(
            load_part(d / f"durable{rank}.pkl"), device=device, mesh=mesh),
            d / "durable")
        with open(d / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f, protocol=5)
    finally:
        dist.destroy_process_group()
    return 0


def dist_rank_checks(ranks: list, want: dict, rec_want: dict,
                     serve_want: dict, dur_want: dict, by_rank: list,
                     card: str, on_card: bool) -> dict:
    """Hold the ranks' checkpointed runs, served answers and durable
    server to the stacked ones, print the [dist-recovery], [dist-serve]
    and [dist-durable] lines, and add the ranks' launches to
    ``by_rank``; the ms each part took a rank."""
    world = len(ranks)
    for key, w in rec_want.items():
        check(w["digest"] == fields_digest(want[key]["fields"])
              and w["rounds"] == want[key]["rounds"] and w["recoveries"],
              f"[dist-recovery] stacked {key}: not detected, or the "
              "recovered outputs differ from the uninterrupted run")
        for r, res in enumerate(ranks):
            got = res["recovery"][key]
            for k in ("digest", "rounds", "detections", "recoveries",
                      "checkpoints", "resumed", "resumed_from"):
                check(got.get(k) == w.get(k),
                      f"[dist-recovery] rank {r} {key}: {k} {got.get(k)} "
                      f"vs stacked {w.get(k)}")
        cells = [res["recovery"][key] for res in ranks]
        resumed = (f"; each rank resumed from its round-{w['resumed_from']} "
                   f"checkpoint bit-equal (ms a rank "
                   f"{[round(c['resume_ms'], 1) for c in cells]})"
                   if "resumed" in w else "")
        log(f"[dist-recovery] gloo world={world} {key:14s} rounds="
            f"{w['rounds']} detections={w['detections']} recoveries="
            f"{w['recoveries']} checkpoints={w['checkpoints']}: ms a rank "
            f"{[round(c['ms'], 1) for c in cells]} (stacked "
            f"{w['ms']:.1f} ms); a snapshot {cells[0]['snap_bytes'] / 2**20:.1f}"
            f" MiB a rank, median ms a rank "
            f"{[round(c['snap_ms'], 2) for c in cells]}; outputs bit-equal "
            f"to the stacked runner's{resumed}; launches a rank "
            f"{[c['launches'] for c in cells]}  ({card})")
    lead = ranks[0]["serve"]
    for i, w in enumerate(serve_want["calls"]):
        got = lead["calls"][i]
        check(got["answers"] == w["answers"]
              and all(a[0] == "ok" for a in w["answers"])
              and len(w["answers"]) == w["n"],
              f"[dist-serve] {w['name']} x{w['n']}: rank 0's answers "
              f"{got['answers']} vs stacked {w['answers']}")
        check(all(res["serve"]["calls"][i]["answers"] == []
                  for res in ranks[1:]),
              f"[dist-serve] {w['name']}: a follower returned results")
        log(f"[dist-serve] gloo world={world} {w['name']:14s} x{w['n']} "
            f"bucket={w['answers'][0][2]} rounds="
            f"{sorted({a[1] for a in w['answers']})}: served ms a rank "
            f"{[round(res['serve']['calls'][i]['ms'], 1) for res in ranks]}"
            f" (stacked {w['ms']:.1f} ms); answers bit-equal  ({card})")
    wal = Path(ranks[0]["durable"]["wal"]).read_bytes()
    check(wal == Path(dur_want["wal"]).read_bytes(),
          "[dist-durable] rank 0's WAL differs from the stacked server's")
    for r, res in enumerate(ranks):
        dd = res["durable"]
        for k in ("sampled", "copies", "epoch", "report"):
            check(dd[k] == dur_want[k],
                  f"[dist-durable] rank {r}: {k} {dd[k]} vs stacked "
                  f"{dur_want[k]}")
        check(dd["digests"] == dd["recovered"] == [dur_want["digests"][r]]
              and dd["recovered_epoch"] == dur_want["epoch"]
              and dd["on_device"] and dd["recovered_on_device"],
              f"[dist-durable] rank {r}: mirrors after the batches or "
              "after recovery differ from the stacked server's part")
    d = [res["durable"] for res in ranks]
    log(f"[dist-durable] gloo world={world} {DIST_DURABLE_GRAPH}: "
        f"{MUTATE_DURABLE['batches']} batches of {MUTATE_DURABLE['size']} "
        f"(ms a rank {[[round(x, 1) for x in c['batch_ms']] for c in d]}), "
        f"{dur_want['copies']} copies rebuilt (s a rank "
        f"{[round(c['rebuild_s'], 2) for c in d]}); created in s a rank "
        f"{[round(c['create_s'], 2) for c in d]}; a rank snapshot "
        f"{max(c['snap_bytes'] for c in d) / 2**20:.1f} MiB (stacked "
        f"{dur_want['snap_bytes'] / 2**20:.1f} MiB); recovered (snapshot "
        f"{dur_want['report'][0]} + {dur_want['report'][1]} WAL record) in "
        f"s a rank {[round(c['recover_s'], 2) for c in d]} (stacked "
        f"{dur_want['recover_s']:.2f} s); WAL ({len(wal)} bytes), every "
        f"rank's mirrors and planner before and after recovery equal to "
        f"the stacked server's  ({card})")
    for r, res in enumerate(ranks):
        counts = by_rank[r]
        for cell in list(res["recovery"].values()) + [res["serve"]]:
            for name in counts:
                counts[name] += cell["launches"][name]
        check(not on_card or all(counts.values()),
              f"[dist] gloo rank {r}: a kernel never launched {counts}")
    return {"recovery_ms": [sum(c["ms"] for c in res["recovery"].values())
                            for res in ranks],
            "serve_ms": [sum(c["ms"] for c in res["serve"]["calls"])
                         for res in ranks],
            "durable_s": [c["create_s"] + c["rebuild_s"] + c["recover_s"]
                          + sum(c["batch_ms"]) / 1e3 for c in d]}


def run_dist_compression(port: Port, device) -> dict:
    """``compress_tree`` on the card over a seeded tree of the shapes of
    one TinyLlama layer and its embeddings, with a seeded carried
    residual, against the same call on the CPU: payloads, scales and
    residuals bit for bit."""
    torch, comp, tree = port.torch, port.compression, port.tree
    cfg = dataclasses.replace(port.arch_registry.ARCHS[LLM_ARCH],
                              num_layers=1)
    shapes = port.models.abstract_params(port.models.param_spec(cfg))
    gen = torch.Generator(device=device).manual_seed(SEED)

    def draw(m, scale):
        return torch.randn(m.shape, generator=gen, device=device) * scale

    grads = tree.tree_map(lambda m: draw(m, 1e-3), shapes)
    resid = tree.tree_map(lambda m: draw(m, 1e-6), shapes)
    _sync(torch, device)
    t0 = time.perf_counter()
    q, s, r = comp.compress_tree(grads, resid)
    _sync(torch, device)
    card_ms = (time.perf_counter() - t0) * 1e3
    host = tree.tree_map(lambda t: t.cpu(), (grads, resid))
    del grads, resid
    t0 = time.perf_counter()
    qc, sc, rc = comp.compress_tree(*host)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    leaves = 0
    for name, a, b in (("q", q, qc), ("scale", s, sc), ("resid", r, rc)):
        la, lb = tree.leaves(a), tree.leaves(b)
        leaves = len(la)
        for i, (x, y) in enumerate(zip(la, lb)):
            x = x.cpu()
            check(x.dtype == y.dtype and x.shape == y.shape
                  and torch.equal(x.view(-1).view(torch.uint8),
                                  y.view(-1).view(torch.uint8)),
                  f"compression: {name} of leaf {i} differs between the "
                  "card and the CPU")
    n = sum(t.numel() for t in tree.leaves(q))
    del q, s, r
    return {"leaves": leaves, "elements": n, "card_ms": card_ms,
            "cpu_ms": cpu_ms}


def part_sum_split(port: Port, device, n_local: int) -> dict:
    """The case for ``partitioned.part_sums``: seeded float32 fields of
    the shape pagerank sums at parts DIST_WORLD, ``(DIST_WORLD,
    n_local)``, reduced in one call (``x.sum(dim=1)``, what the stacked
    parts would run without part_sums) against each part's ``(1,
    n_local)`` row alone (what a rank holding one part runs).  Counts
    the rows whose bits differ; ``part_sums`` must equal the one-row
    sums in every row."""
    torch = port.torch
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = differ = 0
    for _ in range(DIST_SPLIT_DRAWS):
        x = torch.rand((DIST_WORLD, n_local), generator=gen, device=device)
        one = torch.cat([x[p:p + 1].sum(dim=1) for p in range(DIST_WORLD)])
        differ += int((x.sum(dim=1) != one).sum())
        rows += DIST_WORLD
        check(torch.equal(port.part_sums(x), one),
              "part_sums differs from the one-row sums")
    return {"rows": rows, "differ": differ, "n_local": n_local}


def run_dist(port: Port, engines: dict, device) -> dict:
    """The graph programs over ``torch.distributed`` (``DistComm``), one
    part a rank, against ``StackedComm`` on the same partitions.

    1. One rank at parts 1 over NCCL on the card (gloo off it): every
       program (triangles on a TRI_N-vertex graph) through both comms
       in this process, outputs, rounds, wire and launches equal, each
       timed (one synchronized run each, after a warm-up of
       DIST_WARMUP over the comm) beside the other.
    2. DIST_WORLD gloo ranks at parts DIST_WORLD, all on the one card
       (NCCL takes a card a rank): this process hands each rank its
       part as a file, runs the
       programs with StackedComm for the references, starts the ranks
       (``chip_smoke.py --dist-rank``), waits for every one with a
       timeout, and holds their outputs, rounds, guard verdicts under
       DIST_CHAOS, wire and launches to the references; on the card
       spmv_ell and bfs_pull must launch on every rank.  These ranks
       take DIST_PROGRAMS, the programs that launch a kernel or use
       the async exchange.
    3. ``compress_tree`` on the card against the CPU."""
    import torch.distributed as dist
    torch = port.torch
    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    card = card_line() if on_card else "cpu"
    programs = tuple(port.registry.available())
    split = part_sum_split(port, device, engines[DIST_WORLD][0].n_local)
    log(f"[dist] part sums: {split['differ']} of {split['rows']} float32 "
        f"rows of ({DIST_WORLD}, {split['n_local']}) differ in bits between "
        "one batched x.sum(dim=1) and one-row sums; part_sums equals the "
        f"one-row sums ({card})")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    port.localops.set_mode("auto")
    launches = {"spmv_ell": 0, "bfs_pull": 0}

    # -- one rank over NCCL, parts 1 ---------------------------------------
    g, eng_s, garr_s = engines[1]
    g_t = port.partition_graph(port.urand_edges(TRI_N, 16 * TRI_N, SEED),
                               TRI_N, 1)
    eng_t = port.GraphEngine(g_t, device=device)
    want = dist_programs(port, eng_s, garr_s, programs,
                         (eng_t, eng_t.device_graph()))
    backend = "nccl" if on_card else "gloo"
    dist.init_process_group(
        backend, init_method=f"file://{DIST_DIR}/rdzv-one", rank=0,
        world_size=1, **({"device_id": torch.device(
            "cuda", torch.cuda.current_device())} if on_card else {}))
    one = {}
    try:
        mesh = port.mesh.make_graph_mesh(1)
        eng_d = port.GraphEngine(g, device=device, mesh=mesh)
        check(eng_d.distributed and eng_d.comm.backend == backend,
              f"one-rank engine: {eng_d.comm!r}")
        garr_d = eng_d.device_graph()
        eng_dt = port.GraphEngine(g_t, device=device, mesh=mesh)
        tri_d = (eng_dt, eng_dt.device_graph())
        # the communicator's first collectives, untimed and uncounted
        dist_programs(port, eng_d, garr_d, DIST_WARMUP)
        got = dist_programs(port, eng_d, garr_d, programs, tri_d)
        for key, w in want.items():
            r = got[key]
            dist_same(f"[dist] {backend} parts=1 {key}", r, w)
            for name in launches:
                launches[name] += r["launches"][name]
            one[key] = {"rounds": r["rounds"], "ok": r["ok"], "ms": r["ms"],
                        "stacked_ms": w["ms"], "launches": r["launches"]}
            log(f"[dist] {backend} world=1 parts=1 {key:24s} rounds="
                f"{r['rounds']:3d} DistComm {r['ms']:9.2f} ms  StackedComm "
                f"{w['ms']:9.2f} ms (one run each)  launches "
                f"{r['launches']}  ({card})")
        del garr_d, tri_d, got
    finally:
        dist.destroy_process_group()
    check(not on_card or all(launches.values()),
          f"[dist] one rank: a kernel never launched {launches}")

    # -- DIST_WORLD gloo ranks sharing the card, parts DIST_WORLD ----------
    programs = DIST_PROGRAMS
    g, eng_s, garr_s = engines[DIST_WORLD]
    want = dist_programs(port, eng_s, garr_s, programs)
    # the stacked references of the checkpointed runs, the served
    # queries and the durable server, at parts DIST_WORLD
    t0 = time.perf_counter()
    schedules = {f"{a}/{v}": chaos_schedule(want[f"{a}/{v}"]["rounds"])
                 for a, v in DIST_RECOVERY}
    rec_want = dist_recovery(port, eng_s, garr_s, schedules)
    serve_want = dist_serve(port, eng_s)
    gcfg = port.graph_workloads.ALL[DIST_DURABLE_GRAPH]
    g_d = port.partition_graph(port.generate_edges(gcfg, SEED),
                               gcfg.num_vertices, DIST_WORLD)
    handed_d = sum(hand_off(g_d.take_part(p), DIST_DIR / f"durable{p}.pkl")
                   for p in range(DIST_WORLD))
    dur_want = dist_durable(port, port.GraphEngine(g_d, device=device),
                            DIST_DIR / "durable-stacked")
    del g_d
    stacked_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    handed = sum(hand_off(g.take_part(p), DIST_DIR / f"part{p}.pkl")
                 for p in range(DIST_WORLD))
    log(f"[dist] handed {DIST_WORLD} parts to the ranks: "
        f"{handed / 2 ** 30:.2f} GiB of files in "
        f"{time.perf_counter() - t0:.1f} s, and {DIST_DURABLE_GRAPH}'s "
        f"{DIST_WORLD} parts ({handed_d / 2 ** 20:.1f} MiB); the stacked "
        f"checkpointed runs, served queries and durable server took "
        f"{stacked_s:.1f} s")
    (DIST_DIR / "job.json").write_text(json.dumps(
        {"programs": programs, "device": str(device),
         "schedules": schedules}))
    t0 = time.perf_counter()
    procs = []
    for r in range(DIST_WORLD):
        with open(DIST_DIR / f"rank{r}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "chip_smoke.py"), "--dist-rank",
                 str(r), "--dist-dir",
                 str(DIST_DIR)], cwd=HERE, stdout=f,
                stderr=subprocess.STDOUT))
    try:
        wait_ranks(procs, DIST_TIMEOUT_S)
    except BaseException:
        for r in range(DIST_WORLD):
            log(f"[dist] rank {r} log tail:\n"
                + (DIST_DIR / f"rank{r}.log").read_text()[-3000:])
        raise
    gloo_s = time.perf_counter() - t0
    ranks = [load_part(DIST_DIR / f"rank{r}.pkl")
             for r in range(DIST_WORLD)]
    by_rank = []
    for res in ranks:
        r = res["rank"]
        check(res["comm"].startswith(f"DistComm(parts={DIST_WORLD}, "
                                     f"rank={r}, backend=gloo"),
              f"rank {r}: {res['comm']}")
        counts = {"spmv_ell": 0, "bfs_pull": 0}
        for key, w in want.items():
            got = res["runs"][key]
            dist_same(f"[dist] gloo rank {r} {key}", got, w,
                      fields=False)
            check(got["digest"] == fields_digest(w["fields"]),
                  f"[dist] gloo rank {r} {key}: gathered outputs differ "
                  "from stacked")
            if r == 0:
                dist_same(f"[dist] gloo rank 0 {key}", got, w)
            for name in counts:
                counts[name] += got["launches"][name]
        check(not on_card or all(counts.values()),
              f"[dist] gloo rank {r}: a kernel never launched {counts}")
        by_rank.append(counts)
    staged = ranks[0]["staged"]
    check(set(staged) <= {"sum", "min", "or", "bcast", "perm", "psum",
                          "gather"} and bool(staged) == on_card,
          f"[dist] gloo staged {staged}")
    for key, w in want.items():
        got = ranks[0]["runs"][key]
        log(f"[dist] gloo world={DIST_WORLD} parts={DIST_WORLD} {key:24s} "
            f"rounds={got['rounds']:3d} ok={got['ok']} rank-0 "
            f"{got['ms']:9.2f} ms (one run; StackedComm {w['ms']:9.2f} ms)"
            f"  launches a rank {got['launches']}  ({card})")
    log(f"[dist] gloo: {DIST_WORLD} ranks in {gloo_s:.1f} s (each loaded "
        f"its part in {max(x['load_s'] for x in ranks):.1f} s at most and "
        f"ran the programs in {max(x['run_s'] for x in ranks):.1f} s); "
        f"outputs, rounds, guard verdicts and wire equal to StackedComm "
        f"at parts {DIST_WORLD}; launches by rank {by_rank}; ops staged "
        f"through pinned host memory (gloo on CUDA tensors): "
        f"{', '.join(staged) or 'none'}")
    rank_s = dist_rank_checks(ranks, want, rec_want, serve_want, dur_want,
                              by_rank, card, on_card)
    for c in by_rank:
        for name in launches:
            launches[name] += c[name]
    shutil.rmtree(DIST_DIR, ignore_errors=True)

    # -- compression -------------------------------------------------------
    comp = run_dist_compression(port, device)
    log(f"[dist] compress_tree over {comp['leaves']} leaves of one "
        f"{LLM_ARCH} layer's and its embeddings' shapes "
        f"({comp['elements']:,} elements): q, scales and residuals on the "
        f"card bit-equal to the CPU's; {comp['card_ms']:.1f} ms on the "
        f"card, {comp['cpu_ms']:.1f} ms on the CPU ({card})")

    secs = time.perf_counter() - t_phase
    out = {"one": one, "gloo": {k: {x: v[x] for x in ("rounds", "ok", "ms",
                                                      "launches")}
                                for k, v in ranks[0]["runs"].items()},
           "gloo_s": gloo_s, "staged": staged, "by_rank": by_rank,
           "part_sums": split, "compression": comp, "secs": secs,
           "rank_phases": rank_s}
    log("[dist] " + json.dumps(out, default=str))
    log(f"[dist done] {secs:.1f} s")
    return {"launches": launches, "by_rank": by_rank}


# ---------------------------------------------------------------------------
# fault injection, guards and checkpoint/rollback recovery
# ---------------------------------------------------------------------------

def _tensors(torch, tree):
    """The tensors of a (snapshot's) carry (a ``DistComm`` exchange's
    received rows, when it holds one)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(torch, x)
    elif type(tree).__name__ == "Pending":
        yield tree.recv


def carry_bytes(torch, tree) -> int:
    """Bytes of the tensors in a (snapshot's) carry."""
    return sum(t.numel() * t.element_size() for t in _tensors(torch, tree))


def timed_snapshots(port: Port, runner, device) -> tuple[list, list]:
    """Wrap ``runner``'s snapshot: each call's (ms, bytes) is appended to
    the first returned list (the device-to-host copy ends in a
    synchronize); the second holds the last carry snapshotted."""
    torch = port.torch
    snap, cells, last = runner._snapshot, [], [None]

    def timed(pi, carry):
        _sync(torch, device)
        t0 = time.perf_counter()
        ck = snap(pi, carry)
        _sync(torch, device)
        cells.append(((time.perf_counter() - t0) * 1e3,
                      carry_bytes(torch, ck.carry)))
        last[0] = carry
        return ck

    runner._snapshot = timed
    return cells, last


def pinned_copy_ms(port: Port, carry, device) -> float:
    """Median ms of 3 copies of ``carry``'s tensors into host buffers
    allocated (page-locked on the card) once beforehand: what a snapshot
    would cost with a reused pinned buffer in place of fresh pageable
    memory.  Timed here only; the runner does not do this."""
    torch = port.torch
    on_card = torch.device(device).type == "cuda"
    src = list(_tensors(torch, carry))
    dst = [torch.empty(t.shape, dtype=t.dtype, pin_memory=on_card)
           for t in src]

    def copy():
        for d, t in zip(dst, src):
            d.copy_(t, non_blocking=on_card)

    copy()
    return median_ms(torch, device, copy)


def run_chaos(port: Port, engines: dict, main: dict, bsp: dict,
              asy: dict) -> dict:
    """Guarded, checkpointed and recovered runs of CHAOS_PROGRAMS at
    CHAOS_PARTS in mode auto, each held bit for bit against the program's
    run in the phases above; launch counters zeroed around each program.
    Returns the phase's launches and its per-program cells."""
    torch = port.torch
    t_phase = time.perf_counter()
    parts = CHAOS_PARTS
    _, eng, garr = engines[parts]
    device = eng.device
    earlier = {key: {"fields": {"parents" if key.startswith("bfs")
                                else "rank": main[parts][key]["field"]},
                     "rounds": main[parts][key]["rounds"]}
               for key in ("bfs/fast", "pagerank/bsp", "pagerank/fast")}
    earlier.update({"betweenness/default": bsp["auto"][parts]["betweenness"],
                    "bfs/async": asy["runs"][parts, "bfs/async"],
                    "pagerank/async": asy["runs"][parts,
                                                  "pagerank/async s=1"]})
    total = {"spmv_ell": 0, "bfs_pull": 0}
    cells = {}
    for algo, variant, extra in CHAOS_PROGRAMS:
        key = f"{algo}/{variant}"
        params = {**(ASYNC_PR_PARAMS if key == "pagerank/async" else {}),
                  **extra}
        args = (ROOT,) if algo in ("bfs", "betweenness") else ()
        want = earlier[key]
        kernel = "bfs_pull" if key == "bfs/fast" \
            else "spmv_ell" if algo in ("pagerank", "betweenness") else None
        port.reset_launches()
        with port.localops.using("auto"):
            plain = eng.program(algo, variant, **params)
            guarded = eng.program(algo, variant, guard=True, **params)

        def fields(outs, prog=plain, want=want):
            return {k: v for k, v in suite_fields(eng, prog, outs).items()
                    if k in want["fields"]}

        def launched(fn):
            before = port.launches()
            out = fn()
            _sync(torch, device)
            after = port.launches()
            return out, {k: after[k] - before[k] for k in total}

        # unguarded, then guarded with no schedule: same bits, same
        # launches, at most one more sync a round
        with SyncCounter(torch) as s0:
            (*outs, rounds), l_plain = launched(lambda: plain(garr, *args))
        check(rounds == want["rounds"]
              and same_fields(fields(outs), want["fields"]),
              f"chaos {key}: the unguarded run differs from the earlier "
              f"phase's")
        with SyncCounter(torch) as s1:
            (*gouts, grounds, ok), l_guard = launched(
                lambda: guarded(garr, *args))
        phases = 2 if algo == "betweenness" else 1
        extra_syncs = s1.count - s0.count
        check(ok == 1 and grounds == rounds
              and same_fields(fields(gouts), want["fields"]),
              f"chaos {key}: guarded run ok={ok} rounds={grounds} or "
              f"outputs differ from the unguarded run")
        check(l_guard == l_plain,
              f"chaos {key}: guarded launches {l_guard} vs {l_plain}")
        check(extra_syncs <= rounds + phases,
              f"chaos {key}: guarded run made {extra_syncs} more syncs in "
              f"{rounds} rounds")
        del outs, gouts
        ms = median_ms(torch, device, lambda: plain(garr, *args))
        g_ms = median_ms(torch, device, lambda: guarded(garr, *args))

        # checkpointed, clean (and resumed from the middle snapshot)
        resume = (algo, variant) in CHAOS_RESUME
        with port.localops.using("auto"):
            runner = port.CheckpointRunner(eng, algo, variant,
                                           checkpoint_every=CHAOS_EVERY,
                                           keep_history=resume, **params)
        snaps, last = timed_snapshots(port, runner, device)
        t0 = time.perf_counter()
        rep, l_ck = launched(lambda: runner.run(garr, *args))
        ck_ms = (time.perf_counter() - t0) * 1e3
        check(rep.recoveries == 0 and rep.rounds == rounds
              and same_fields(fields(rep.outputs), want["fields"]),
              f"chaos {key}: checkpointed run recovered {rep.recoveries} "
              f"times or differs")
        check(l_ck == l_plain,
              f"chaos {key}: checkpointed launches {l_ck} vs {l_plain}")
        n_snaps = len(snaps)
        snap_ms = statistics.median(c[0] for c in snaps)
        snap_bytes = max(c[1] for c in snaps)
        pin_ms = pinned_copy_ms(port, last[0], device)
        del last
        if resume:
            mid = rep.history[len(rep.history) // 2]
            rep2 = runner.run(garr, *args, resume_from=mid)
            check(same_fields(fields(rep2.outputs), want["fields"]),
                  f"chaos {key}: resumed from round {mid.rounds}, outputs "
                  f"differ")
            del rep2, mid
        del rep, runner

        # chaos: detect, roll back, replay clean, same bits
        sched = chaos_schedule(rounds)
        with port.localops.using("auto"):
            chaos = port.CheckpointRunner(eng, algo, variant,
                                          checkpoint_every=CHAOS_EVERY,
                                          faults=sched, **params)
        t0 = time.perf_counter()
        rep3, l_rec = launched(lambda: chaos.run(garr, *args))
        rec_ms = (time.perf_counter() - t0) * 1e3
        check(rep3.recoveries >= 1 and len(rep3.detections) >= 1,
              f"chaos {key}: {sched!r} was not detected "
              f"({rep3.detections}, {rep3.recoveries} recoveries)")
        check(rep3.rounds == rounds
              and same_fields(fields(rep3.outputs), want["fields"]),
              f"chaos {key}: recovered outputs differ from the "
              f"uninterrupted run")
        if kernel is not None:
            check(l_rec[kernel] > 0,
                  f"chaos {key}: {kernel} not launched in the recovered run")
        launches = port.launches()
        for k in total:
            total[k] += launches[k]
        cells[key] = cell = {
            "rounds": rounds, "ms": ms, "guarded_ms": g_ms,
            "checkpointed_ms": ck_ms, "recovered_ms": rec_ms,
            "syncs_unguarded": s0.count, "syncs_guarded": s1.count,
            "extra_syncs_per_round": extra_syncs / max(rounds, 1),
            "snapshots": n_snaps, "snapshot_bytes": snap_bytes,
            "snapshot_ms": snap_ms, "pinned_copy_ms": pin_ms,
            "schedule": sched,
            "detections": list(rep3.detections),
            "recoveries": rep3.recoveries,
            "recovered_launches": l_rec,
            "launches": {k: launches[k] for k in total}}
        log(f"[chaos] parts={parts} {key:19s} rounds={rounds:3d} "
            f"ms {ms:.2f} guarded {g_ms:.2f} checkpointed {ck_ms:.2f} "
            f"recovered {rec_ms:.2f}; syncs {s0.count} -> {s1.count} "
            f"({cell['extra_syncs_per_round']:.3f} more a round); "
            f"{n_snaps} snapshots of {snap_bytes / 1e6:.1f} MB, "
            f"{snap_ms:.2f} ms each (last carry into a reused pinned "
            f"buffer {pin_ms:.2f} ms); {sched}: detections "
            f"{list(rep3.detections)}, recoveries {rep3.recoveries}, "
            f"launched {l_rec}")
        del chaos, rep3
    for name in total:
        check(total[name] > 0, f"chaos path: {name} never launched")
    secs = time.perf_counter() - t_phase
    log("[times] " + json.dumps({"chaos": cells, "seconds": secs},
                                default=str))
    log(f"[chaos done] {secs:.1f} s")
    return {"launches": total, "cells": cells}


# ---------------------------------------------------------------------------
# observability: telemetry builds, probes, traced recovery, Chrome trace
# ---------------------------------------------------------------------------

def recording(port: Port, program, rows: list):
    """A copy of ``program`` that appends, after each round (after
    ``fold`` for an async program), the row the telemetry series holds
    but ``done``: the halt test and the probes on the round's state,
    host numbers the loop already has (no sync)."""
    sup = port.superstep
    if isinstance(program, sup.PhasedProgram):
        return dataclasses.replace(program, phases=tuple(
            recording(port, ph, rows) for ph in program.phases))
    probe = program.probe or (lambda state: ())

    def row(state):
        rows.append([float(program.halt(state)),
                     *map(float, probe(state))])
        return state

    if isinstance(program, sup.AsyncSuperstepProgram):
        def fold(g, state, handle):
            state, handle = program.fold(g, state, handle)
            return row(state), handle
        return dataclasses.replace(program, fold=fold)
    return dataclasses.replace(
        program, step=lambda g, state: row(program.step(g, state)))


def run_obs(port: Port, engines: dict, main: dict, chaos: dict) -> dict:
    """Every registered program but the batched builds, plain and
    ``telemetry=True``, on the main path's partitions (triangles on its
    TRI_N-vertex graph) in mode auto; then CheckpointRunner(telemetry=True,
    obs=SpanRecorder()) recovered runs of OBS_RECOVERED under the chaos
    phase's schedules; then one Chrome trace of the layer spans those runs
    recorded and the runner's spans and events, written to OBS_TRACE and
    validated.
    Returns the launches of the telemetry runs (counters zeroed at the
    start of the phase; each equal to its plain run's)."""
    torch = port.torch
    obs = port.obs
    t_phase = time.perf_counter()
    tri_edges = port.urand_edges(TRI_N, 16 * TRI_N, SEED)
    targets = {}
    for parts, (g, eng, garr) in engines.items():
        g_t = port.partition_graph(tri_edges, TRI_N, parts)
        eng_t = port.GraphEngine(g_t, device=eng.device)
        targets[parts] = (g, eng, garr, eng_t, eng_t.device_graph())
    port.reset_launches()
    total = {"spmv_ell": 0, "bfs_pull": 0}
    cells = {}
    recorder = obs.SpanRecorder()   # the telemetry runs' layer spans
    for parts, (g, eng, garr, eng_t, garr_t) in targets.items():
        for algo, variant in port.registry.available():
            key = f"{algo}/{variant}"
            spec = port.registry.get_spec(algo, variant)
            params = ASYNC_PR_PARAMS if key in ("pagerank/async",
                                                "pagerank/warm") else {}
            e, ga = (eng_t, garr_t) if algo == "triangles" else (eng, garr)
            if key == "pagerank/warm":
                args = (e.scatter_vertex_field(
                    main[parts]["pagerank/fast"]["field"]),)
            elif spec.incremental is not None:
                (seed_arr,) = port.incremental.cold_seed(spec, e.g)
                args = (e.scatter_vertex_field(seed_arr),)
            else:
                args = (ROOT,) * len(spec.inputs)
            with port.localops.using("auto"):
                plain = e.program(algo, variant, **params)
                tprog = e.program(algo, variant, telemetry=True, **params)
            rows = []
            rec = recording(port, plain.program, rows)
            before = port.launches()
            with SyncCounter(torch) as s_off, port.localops.using(plain.mode):
                outs, rounds = port.run_program(rec, ga, *args)
                _sync(torch, e.device)
            mid = port.launches()
            with SyncCounter(torch) as s_on, obs.recording(recorder):
                *touts, trounds, series = tprog(ga, *args)
                _sync(torch, e.device)
            after = port.launches()
            l_off = {k: mid[k] - before[k] for k in total}
            l_on = {k: after[k] - mid[k] for k in total}
            what = f"obs parts={parts} {key}"
            check(trounds == rounds
                  and same_fields(suite_fields(e, plain, outs),
                                  suite_fields(e, plain, touts)),
                  f"{what}: telemetry build's outputs or rounds "
                  f"({trounds} vs {rounds}) differ from the plain run's")
            tel = tprog.run_telemetry(series)
            phases = getattr(plain.program, "phases", (plain.program,))
            capped = rounds >= sum(ph.max_rounds for ph in phases)
            check(tel.series.rounds == rounds
                  and (capped or tel.series.halt()[-1] == 1.0),
                  f"{what}: series of {tel.series.rounds} rounds, halt "
                  f"{tel.series.halt()[-1:]} for a {rounds}-round run")
            check(np.array_equal(tel.series.rows[:, 1:],
                                 np.asarray(rows, np.float32)
                                 .reshape(rounds, -1)),
                  f"{what}: series rows are not the plain run's halt and "
                  f"probe values")
            check(s_on.count == s_off.count,
                  f"{what}: {s_on.count} Tensor.item calls with telemetry, "
                  f"{s_off.count} without")
            check(l_on == l_off,
                  f"{what}: launches {l_on} with telemetry, {l_off} without")
            for k in total:
                total[k] += l_on[k]
            ms = median_ms(torch, e.device, lambda: plain(ga, *args))
            tel_ms = median_ms(torch, e.device, lambda: tprog(ga, *args))
            summ = tel.summary()
            cells[f"{key}/parts={parts}"] = cell = {
                "rounds": rounds, "wall_ms": summ["wall_ms"],
                "round_ms_mean": summ.get("round_ms_mean"),
                "ms": ms, "telemetry_ms": tel_ms,
                "syncs": s_on.count, "launches": l_on,
                "wire_per_round": summ["wire_bytes_per_round"],
                "wire_total": summ["wire_bytes_total"],
                "probes": list(tel.series.probe_names)}
            log(f"[obs] parts={parts} {key:19s} rounds={rounds:3d} "
                f"wall_ms {cell['wall_ms']:.3f} round_ms_mean "
                f"{cell['round_ms_mean']} ms off {ms:.3f} on {tel_ms:.3f} "
                f"({(tel_ms / ms - 1) * 100:+.1f}%) syncs {s_on.count} "
                f"launches {l_on} wire/round {cell['wire_per_round']}")
            del outs, touts, series
    for name in total:
        check(total[name] > 0, f"obs path: {name} never launched")

    # -- traced recovery: events against the chaos phase's counts ---------
    parts = CHAOS_PARTS
    _, eng, garr = engines[parts]
    for algo, variant in OBS_RECOVERED:
        key = f"{algo}/{variant}"
        want = chaos[key]
        args = (ROOT,) if algo == "bfs" else ()
        with port.localops.using("auto"):
            plain = eng.program(algo, variant)
            runner = port.CheckpointRunner(
                eng, algo, variant, checkpoint_every=CHAOS_EVERY,
                faults=want["schedule"], telemetry=True, obs=recorder)
        *outs, rounds = plain(garr, *args)
        n_ev = len(recorder.events())
        before = port.launches()
        t0 = time.perf_counter()
        with obs.recording(recorder):
            rep = runner.run(garr, *args)
        _sync(torch, eng.device)
        rec_ms = (time.perf_counter() - t0) * 1e3
        after = port.launches()
        events = recorder.events()[n_ev:]
        kinds = [ev.kind for ev in events]
        what = f"obs traced recovery {key}"
        check(list(rep.detections) == want["detections"]
              and rep.recoveries == want["recoveries"],
              f"{what}: detections {rep.detections}, recoveries "
              f"{rep.recoveries} vs the chaos phase's "
              f"{want['detections']}, {want['recoveries']}")
        check(kinds.count("fault_detection") == len(rep.detections)
              and kinds.count("rollback") == rep.recoveries
              and kinds.count("checkpoint") == rep.checkpoints,
              f"{what}: events {sorted(set(kinds))} do not match the "
              f"report")
        check(rep.telemetry["rounds"] == rep.rounds == rounds
              == want["rounds"],
              f"{what}: telemetry rounds {rep.telemetry['rounds']}, "
              f"clean {rounds}")
        check(same_fields(suite_fields(eng, plain, rep.outputs),
                          suite_fields(eng, plain, outs)),
              f"{what}: recovered outputs differ from the clean run")
        kernel = "bfs_pull" if algo == "bfs" else "spmv_ell"
        check(after[kernel] > before[kernel],
              f"{what}: {kernel} not launched")
        for k in total:
            total[k] += after[k] - before[k]
        cells[f"recovered {key}/parts={parts}"] = {
            "ms": rec_ms, "detections": list(rep.detections),
            "recoveries": rep.recoveries, "checkpoints": rep.checkpoints,
            "events": {k: kinds.count(k) for k in sorted(set(kinds))},
            "telemetry": rep.telemetry}
        log(f"[obs] parts={parts} recovered {key}: {want['schedule']}: "
            f"detections {list(rep.detections)}, recoveries "
            f"{rep.recoveries}, events "
            f"{cells[f'recovered {key}/parts={parts}']['events']}, "
            f"rounds {rep.rounds}, {rec_ms:.2f} ms")
        del outs, rep, runner

    # -- one Chrome trace of every engine track and the runner's spans ----
    t0 = time.perf_counter()
    trace = obs.chrome_trace(recorder.spans(), recorder.events())
    counts = obs.validate_chrome_trace(trace)
    validate_s = time.perf_counter() - t0
    written = obs.write_trace(OBS_TRACE, trace)
    check(written == counts and counts.get("X", 0) > 0
          and counts.get("i", 0) > 0,
          f"obs trace: counts {counts} / {written}")
    chunks = sum(sp.kind == "chunk" for sp in recorder.spans())
    calls = sum(sp.kind == "call" for sp in recorder.spans())
    log(f"[obs] trace {OBS_TRACE.relative_to(HERE)}: "
        f"{sum(counts.values())} events {counts} ({calls} engine "
        f"calls, {chunks} chunk spans, {len(recorder.events())} events of "
        f"the runner), built and validated in {validate_s:.3f} s")
    secs = time.perf_counter() - t_phase
    log("[times] " + json.dumps({"obs": cells, "trace": counts,
                                 "seconds": secs}, default=str))
    log(f"[obs done] {secs:.1f} s")
    return total


# ---------------------------------------------------------------------------
# the graph query server
# ---------------------------------------------------------------------------

def timed_direct(port: Port, eng, garr, prog, args) -> tuple:
    """One synchronized direct call: (fields, rounds, ms)."""
    torch = port.torch
    _sync(torch, eng.device)
    t0 = time.perf_counter()
    *outs, rounds = prog(garr, *args)
    _sync(torch, eng.device)
    ms = (time.perf_counter() - t0) * 1e3
    return suite_fields(eng, prog, outs), rounds, ms


def serve_checked(port: Port, server, key, tag: str, counted,
                  roots=SERVE_ROOTS, phase: str = "serve",
                  got: dict | None = None) -> dict:
    """``key``'s queries through ``server`` against direct calls of the
    engine's program on the same inputs: rooted keys served ``roots``
    (one closed-loop call each), refresh keys once, seeded keys once
    from the warm seed the store holds.  Every result ok, at the
    server's epoch, its bucket the ladder's, its rounds and fields
    bit-identical to the direct call's (``got`` collects the first
    result's fields under the key's label).  Returns the cells: bucket,
    rounds, served ms (the serve call, host clock) and direct ms (the
    direct calls it answers)."""
    serve, eng = port.graph_server, server.engine
    spec, params = key.spec, dict(key.params)
    cells = {}

    def one(queries, direct):
        res, ms = counted(lambda: server.serve(queries))
        bucket = server.ladder.pick(len(queries)) if key.rooted else 0
        for q, r, (fields, rounds, _) in zip(queries, res, direct):
            check(r.ok and r.bucket == bucket and r.epoch == server.epoch
                  and r.rounds == rounds and same_fields(r.fields, fields),
                  f"{phase} {tag} {key.label} root={q.root}: {r.status}, "
                  f"bucket {r.bucket} (want {bucket}), epoch {r.epoch}, "
                  f"rounds {r.rounds} (direct {rounds}), or fields differ "
                  f"from the direct call's")
        cell = {"n": len(queries), "bucket": bucket,
                "rounds": [r.rounds for r in res], "served_ms": ms,
                "direct_ms": sum(d[2] for d in direct)}
        if got is not None:
            got.setdefault(key.label, res[0].fields)
        log(f"[{phase}] {tag} {key.label:19s} n={cell['n']:2d} "
            f"bucket={bucket:2d} rounds {cell['rounds']} served "
            f"{ms:.2f} ms  direct {cell['direct_ms']:.2f} ms")
        return cell

    if key.rooted:
        # batched bfs/fast pins direction="pull": the direct run does too
        prog = eng.program(key.algo, key.variant,
                           **{**spec.batch_defaults, **params})
        direct = {r: timed_direct(port, eng, server.garr, prog, (r,))
                  for r in sorted(set(sum(roots, ())))}
        for rs in roots:
            cells[f"n={len(rs)}"] = one([serve.Query(key, r) for r in rs],
                                        [direct[r] for r in rs])
        return cells
    prog = eng.program(key.algo, key.variant, **params)
    args = ()
    if key.seeded:
        (seed,), warm = server.resolve_seed(key)
        check(warm, f"serve {tag} {key.label}: no warm seed in the store")
        args = (eng.scatter_vertex_field(
            seed, port.incremental.KIND_DTYPES[spec.input_kinds[0]]),)
    cells["n=1"] = one([serve.Query(key)],
                       [timed_direct(port, eng, server.garr, prog, args)])
    return cells


def run_serve(port: Port, graph: str, engines: dict) -> dict:
    """GraphServer over every registered program at each parts count
    (triangles on a TRI_N-vertex graph), served equal to direct; the
    launcher's replay of SERVE_REPLAY at SERVE_PARTS; a traced session
    whose latency cells reconcile with the metrics.  Returns the kernel
    launches of the serving calls (counted from zero around each; the
    direct calls they are checked against are not counted)."""
    serve, obs = port.graph_server, port.obs
    t_phase = time.perf_counter()
    total = {"spmv_ell": 0, "bfs_pull": 0}
    cells = {}

    def counted(fn):
        before = port.launches()
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
        after = port.launches()
        for k in total:
            total[k] += after[k] - before[k]
        return out, ms

    pairs = [(f"{a}/{v}", port.registry.get_spec(a, v))
             for a, v in port.registry.available()]
    tri_edges = port.urand_edges(TRI_N, 16 * TRI_N, SEED)
    with port.localops.using("auto"):
        for parts, (_, eng, _) in engines.items():
            eng_t = port.GraphEngine(
                port.partition_graph(tri_edges, TRI_N, parts),
                device=eng.device)
            for e, names in ((eng, [k for k, s in pairs
                                    if s.algo != "triangles"]),
                             (eng_t, ["triangles"])):
                tag = f"parts={parts}" + (f" n={TRI_N}" if e is eng_t
                                          else "")
                server = serve.GraphServer(e, buckets=SERVE_BUCKETS, depth=2)
                keys = [serve.make_key(name, **(
                    ASYNC_PR_PARAMS if name in ("pagerank/async",
                                                "pagerank/warm") else {}))
                        for name in names]
                n_warm, warm_ms = counted(lambda: server.warmup(keys))
                log(f"[serve] {tag}: warmed {n_warm} (program x rung) "
                    f"launches in {warm_ms:.1f} ms, ladder "
                    f"{server.ladder.sizes}")
                # seeded keys last: their warm seeds are the refreshes'
                for key in sorted(keys, key=lambda k: k.seeded):
                    for n, cell in serve_checked(port, server, key, tag,
                                                 counted).items():
                        cells[f"{key.label}/{n}/{tag}"] = cell
                del server
            del eng_t
    log(f"[serve] served == direct, bit for bit, for every registered "
        f"program at parts {list(engines)}; launches so far {total}")

    # -- the launcher's replay ---------------------------------------------
    eng = engines[SERVE_PARTS][1]
    card = card_line() if eng.device.type == "cuda" else "cpu"
    rp = SERVE_REPLAY
    n_trace = len(serve.synthetic_trace(
        eng.g.n_orig, rp["mix"], rate=rp["rate"], duration=rp["duration"],
        zipf_s=rp["zipf_s"], seed=rp["seed"]))
    with port.localops.using("auto"):
        server, run_ms = counted(lambda: port.graph_serve.run(
            graph, SERVE_PARTS, engine=eng, **rp))
    m = server.metrics
    rows = m.rows()
    check(sum(r["count"] for r in rows) == n_trace
          and not any(m.counts.values()),
          f"serve replay: {sum(r['count'] for r in rows)} of {n_trace} "
          f"queries ok, counts {m.counts}")
    qps = n_trace / m.window_s
    for r in rows:
        log(f"[serve] replay parts={SERVE_PARTS} {r['algo']:9s} bucket="
            f"{r['bucket']:3d} count {r['count']:3d}  p50 {r['p50_ms']} ms"
            f"  p95 {r['p95_ms']} ms  p99 {r['p99_ms']} ms  ({card})")
    log(f"[serve] replay parts={SERVE_PARTS} {rp['mix']} at {rp['rate']} "
        f"q/s for {rp['duration']} s: {n_trace} queries all ok, "
        f"{qps:.3f} q/s over {m.window_s:.3f} s ({card}); run() "
        f"{run_ms:.1f} ms with warmup")
    cells["replay"] = {"queries": n_trace, "qps": qps,
                       "window_s": m.window_s, "rows": rows, "card": card}
    del server

    # -- a traced session ----------------------------------------------------
    rec = obs.SpanRecorder()
    with port.localops.using("auto"):
        server = serve.GraphServer(eng, buckets=SERVE_BUCKETS, depth=2,
                                   obs=rec)
        queries = ([serve.query("bfs", root=r) for r in range(10)]
                   + [serve.query("sssp", root=r) for r in range(8)]
                   + [serve.query("pagerank"), serve.query("cc")])
        server.warmup(list(dict.fromkeys(q.key for q in queries)))
        res, ms = counted(lambda: server.serve(queries))
    check(all(r.ok for r in res), f"serve traced: statuses "
          f"{sorted({r.status for r in res})}")
    spans = rec.spans()
    kinds = {sp.kind for sp in spans}
    check(set(SERVE_STAGES) <= kinds,
          f"serve traced: span kinds {sorted(kinds)} lack "
          f"{sorted(set(SERVE_STAGES) - kinds)}")
    check(obs.derive_latency_cells(rec) == server.metrics.latencies(),
          "serve traced: latency cells from the query spans differ from "
          "ServeMetrics'")
    counts = obs.write_trace(SERVE_TRACE, obs.chrome_trace(spans,
                                                           rec.events()))
    split = {kind: [sp.dur * 1e3 for sp in spans if sp.kind == kind]
             for kind in ("dispatch", "device")}
    log(f"[serve] traced parts={SERVE_PARTS}: {len(res)} queries ok in "
        f"{ms:.2f} ms, {len(spans)} spans of {len(kinds)} kinds, latency "
        f"cells == ServeMetrics', trace {SERVE_TRACE.relative_to(HERE)} "
        f"{counts}; dispatch span median "
        f"{statistics.median(split['dispatch']):.3f} ms, device span "
        f"median {statistics.median(split['device']):.3f} ms "
        f"(per launch: dispatch "
        f"{[round(x, 3) for x in split['dispatch']]}, device "
        f"{[round(x, 3) for x in split['device']]})")
    cells["traced"] = {"queries": len(res), "ms": ms, "trace": counts,
                       "dispatch_ms": split["dispatch"],
                       "device_ms": split["device"]}
    del server, res
    for name in total:
        check(total[name] > 0, f"serve path: {name} never launched")
    secs = time.perf_counter() - t_phase
    log("[times] " + json.dumps({"serve": cells, "launches": total,
                                 "seconds": secs}, default=str))
    log(f"[serve done] {secs:.1f} s")
    return total


def host_mb() -> float:
    """Peak resident host memory of this process so far, MiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def index_bytes(dyn) -> int:
    """Bytes of the planner's arrays (occupancy, row layouts) and free
    stacks (8 bytes an entry)."""
    arrays = list(dyn._occ.values()) + [a for pair in
                                        dyn._row_layout.values()
                                        for a in pair]
    return sum(a.nbytes for a in arrays) + 8 * sum(
        len(x) for x in dyn._free_out + dyn._free_in)


def timed_apply(port: Port, server, **batch):
    """``server.mutate(**batch)`` with the device patches timed apart
    (each synchronized: the tensor's clone, the slot lists' copy to the
    card and the write): (stats, host ms, patch ms); host ms is the rest
    of ``apply``, the planner and the slot lists' assembly."""
    torch, dyn = port.torch, server.dynamic_graph()
    patch_s = []
    patch = dyn._patch_fn

    def timed(arr, slots, vals):
        _sync(torch, server.engine.device)
        t0 = time.perf_counter()
        out = patch(arr, slots, vals)
        _sync(torch, server.engine.device)
        patch_s.append(time.perf_counter() - t0)
        return out

    dyn._patch_fn = timed
    try:
        stats = server.mutate(**batch)
    finally:
        dyn._patch_fn = patch
    patch_ms = sum(patch_s) * 1e3
    return stats, stats.apply_s * 1e3 - patch_ms, patch_ms


def mirrors_on_device(torch, g, garr) -> bool:
    """Every device tensor equals its host mirror, bit for bit."""
    host = {k: getattr(g, k) for k in ("out_src_local", "out_dst_global",
                                       "in_src_global", "in_dst_local",
                                       "out_degree", "in_degree")}
    host.update(g.ell_arrays)
    return all(torch.equal(t.cpu(), torch.from_numpy(
        np.ascontiguousarray(host[k]))) for k, t in garr.items())


def oracle_checks(port: Port, server, got: dict, tag: str) -> tuple:
    """The served fields of MUTATE_SERVED against host references on the
    server's ``current_edges()``: BFS parents the min-id in-neighbour a
    level up, sssp within SSSP_RTOL / SSSP_ATOL of Dijkstra, cc labels the
    min-id components, pagerank within PR_F64_TOL of the float64 power
    iteration of the same rounds.  Returns the errors and the matrix."""
    t0 = time.perf_counter()
    cur = server.dynamic_graph().current_edges()
    n = server.engine.g.n_orig
    m = out_matrix(cur, n)
    level = bfs_levels(m, ROOT)
    check(np.array_equal(got["bfs_fast"]["parents"],
                         min_level_parents(cur, n, ROOT, level)),
          f"mutate {tag} bfs/fast: a parent is not the min-id in-neighbor "
          f"one level up on current_edges()")
    dist = got["sssp"]["dist"]
    errs = {"sssp": close(f"mutate {tag} sssp vs dijkstra",
                          np.where(dist >= 1e29, np.inf, dist),
                          sssp_dijkstra(m, ROOT), SSSP_RTOL, SSSP_ATOL)}
    check(np.array_equal(got["cc"]["labels"],
                         min_id_components(m, connection="weak")),
          f"mutate {tag} cc: labels differ from the min-id components")
    want = pagerank_f64(m, {got[label]["rounds"]
                            for label in ("pagerank_bsp", "pagerank_fast")})
    for label in ("pagerank_bsp", "pagerank_fast"):
        err = max_rel(got[label]["rank"], want[got[label]["rounds"]])
        check(err < PR_F64_TOL, f"mutate {tag} {label}: max rel err "
                                f"{err:.3e} vs float64")
        errs[label] = err
    log(f"[mutate] {tag} oracles on current_edges() ({len(cur):,} edges, "
        f"{time.perf_counter() - t0:.1f} s): bfs/fast parents exact, sssp "
        f"max rel {errs['sssp']:.3e}, cc labels exact, pagerank bsp / fast "
        f"max rel {errs['pagerank_bsp']:.3e} / {errs['pagerank_fast']:.3e}")
    return errs, m


def served_after(port: Port, server, tag: str, counted) -> dict:
    """MUTATE_SERVED through ``server`` at its epoch, root ROOT, each
    equal to a direct call on the same patched graph; the fields, with
    each pagerank's rounds."""
    serve, got, cells = port.graph_server, {}, {}
    for name in MUTATE_SERVED:
        key = serve.make_key(name)
        cells[key.label] = serve_checked(
            port, server, key, f"{tag} epoch={server.epoch}", counted,
            roots=((ROOT,),), phase="mutate", got=got)
        if not key.rooted:
            got[key.label] = dict(got[key.label],
                                  rounds=cells[key.label]["n=1"]
                                  ["rounds"][0])
    return got, cells


def run_mutate(port: Port, graph: str, parts_list, device, parity) -> dict:
    """Dynamic graphs and durability on the card (module docstring,
    ``mutate``) on ``graph``, partitioned for the phase at each of
    ``parts_list`` (its servers write those partitions' host mirrors).
    Returns the kernel launches of the phase's served and replayed
    queries (parity checks and direct calls are not counted)."""
    torch, serve, persist = port.torch, port.graph_server, port.persist
    t_phase = time.perf_counter()
    gcfg = port.graph_workloads.ALL[graph]
    edges = port.generate_edges(gcfg, SEED)
    engines = {parts: port.GraphEngine(port.partition_graph(
        edges, gcfg.num_vertices, parts), device=device)
        for parts in parts_list}
    log(f"[mutate] {graph}: {gcfg.num_vertices:,} vertices, {len(edges):,} "
        f"edges, generated and partitioned at parts {list(parts_list)} in "
        f"{time.perf_counter() - t_phase:.1f} s")
    del edges
    total = {"spmv_ell": 0, "bfs_pull": 0}
    cells = {}

    def counted(fn):
        before = port.launches()
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
        after = port.launches()
        for k in total:
            total[k] += after[k] - before[k]
        return out, ms

    def q(name, **kw):
        return serve.Query(serve.make_key(name, **kw))

    rng = np.random.default_rng(SEED)
    for parts, eng in engines.items():
        tag = f"parts={parts}"
        server = serve.GraphServer(eng, buckets=SERVE_BUCKETS, depth=2)
        # -- 1. the index over the resident graph --------------------------
        rss0, t0 = host_mb(), time.perf_counter()
        dyn = server.dynamic_graph()
        index_s = time.perf_counter() - t0
        log(f"[mutate] {tag}: index built in {index_s:.2f} s, "
            f"{index_bytes(dyn) / 2 ** 20:.1f} MiB of arrays and free "
            f"stacks, peak host RSS {rss0:.0f} -> {host_mb():.0f} MiB")
        cell = {"index_s": index_s, "index_bytes": index_bytes(dyn)}
        # epoch 0: the refreshes whose outputs seed the incremental ones
        res, _ = counted(lambda: server.serve(
            [q("cc"), q("kcore"), q("pagerank/fast")]))
        check(all(r.ok for r in res), f"mutate {tag}: epoch-0 refreshes")

        # -- delete-only batch: kcore/incremental warm == cold kcore ------
        stats, plan_ms, patch_ms = timed_apply(
            port, server, deletes=dyn.sample_deletable(MUTATE_BATCH, rng))
        check(not stats.rebuild, f"mutate {tag}: delete batch rebuilt")
        check(server.resolve_seed(serve.make_key("kcore/incremental"))[1],
              f"mutate {tag}: no warm kcore seed after a delete batch")
        (warm, cold), _ = counted(lambda: server.serve(
            [q("kcore/incremental"), q("kcore")]))
        check(warm.ok and cold.ok and same_fields(warm.fields, cold.fields),
              f"mutate {tag}: kcore/incremental warm differs from cold "
              f"kcore after a delete batch")
        log(f"[mutate] {tag} delete x{MUTATE_BATCH}: {stats.slots_patched} "
            f"slots in {stats.arrays_patched} arrays, host {plan_ms:.1f} "
            f"ms + patch {patch_ms:.1f} ms; kcore/incremental warm == cold "
            f"kcore, rounds {warm.rounds} warm vs {cold.rounds} cold")
        cell["delete"] = {"slots": stats.slots_patched, "plan_ms": plan_ms,
                          "patch_ms": patch_ms,
                          "kcore_rounds": (warm.rounds, cold.rounds)}

        # -- epoch isolation: admitted before the mixed batch -------------
        key_bfs = serve.make_key("bfs/fast")
        prog = eng.program("bfs", "fast", **key_bfs.spec.batch_defaults)
        before_fields, _, _ = timed_direct(port, eng, server.garr, prog,
                                           (ROOT,))
        epoch0 = server.epoch
        q_old = serve.Query(key_bfs, ROOT)
        server.submit_query(q_old)              # queued, not pumped

        # -- the mixed batch: the patch path measured --------------------
        dels = dyn.sample_deletable(MUTATE_BATCH, rng)
        ins = dyn.sample_insertable(MUTATE_BATCH, rng)
        stats, plan_ms, patch_ms = timed_apply(port, server, inserts=ins,
                                               deletes=dels)
        check(not stats.rebuild and stats.slots_patched > 0,
              f"mutate {tag}: the mixed batch rebuilt or patched nothing")
        log(f"[mutate] {tag} mixed x{MUTATE_BATCH}+{MUTATE_BATCH}: "
            f"rebuild {stats.rebuild}, {stats.slots_patched} slots in "
            f"{stats.arrays_patched} arrays, apply {stats.apply_s * 1e3:.1f}"
            f" ms = host {plan_ms:.1f} + device patch {patch_ms:.1f} ms")
        cell["mixed"] = {"slots": stats.slots_patched,
                         "arrays": stats.arrays_patched,
                         "apply_ms": stats.apply_s * 1e3,
                         "plan_ms": plan_ms, "patch_ms": patch_ms}
        counted(server.drain)
        old = server.results.pop(q_old.qid)
        check(old.ok and old.epoch == epoch0
              and same_fields(old.fields, before_fields),
              f"mutate {tag}: a bfs/fast query admitted before the batch "
              f"answered epoch {old.epoch}, or not the pre-mutation parents")
        log(f"[mutate] {tag}: a bfs/fast query admitted at epoch {epoch0} "
            f"answered the pre-mutation parents after the batch")

        # -- kernels on the patched views --------------------------------
        check(mirrors_on_device(torch, eng.g, server.garr),
              f"mutate {tag}: a patched device tensor differs from its "
              f"host mirror")
        parity.tables(eng.g, server.garr, ("ell_in", "ell_dst", "ell_out"))
        log(f"[mutate] {tag}: patched tensors == host mirrors; spmv_ell on "
            f"ell_in, ell_dst, ell_out and bfs_pull on ell_in bit-equal to "
            f"their plain versions (one multi-bucket call each)")

        # -- served after the mutation ------------------------------------
        got, cell["served"] = served_after(port, server, tag, counted)
        cell["oracle"], m = oracle_checks(port, server, got, tag)
        key = serve.make_key("pagerank/warm", **ASYNC_PR_PARAMS)
        check(server.resolve_seed(key)[1],
              f"mutate {tag}: no warm pagerank seed")
        cold_seed = port.incremental.cold_seed(key.spec, eng.g)
        (warm, cold), _ = counted(lambda: server.serve(
            [serve.Query(key), serve.Query(key, seed=cold_seed)]))
        want = pagerank_f64_converged(m)
        err = max(max_rel(r["rank"], want) for r in (warm, cold))
        check(warm.ok and cold.ok and err < PR_F64_TOL,
              f"mutate {tag} pagerank/warm: {warm.status} / {cold.status}, "
              f"max rel err {err:.3e} vs converged float64")
        del m
        log(f"[mutate] {tag} pagerank/warm after the mixed batch: rounds "
            f"{warm.rounds} warm vs {cold.rounds} cold, max rel {err:.3e} "
            f"vs converged float64")
        cell["pagerank_warm"] = {"rounds": (warm.rounds, cold.rounds),
                                 "err": err}

        # -- insert-only batch: cc/incremental warm == cold cc ------------
        stats, plan_ms, patch_ms = timed_apply(
            port, server, inserts=dyn.sample_insertable(MUTATE_BATCH, rng))
        check(not stats.rebuild, f"mutate {tag}: insert batch rebuilt")
        check(server.resolve_seed(serve.make_key("cc/incremental"))[1],
              f"mutate {tag}: no warm cc seed after an insert batch")
        (warm, cold), _ = counted(lambda: server.serve(
            [q("cc/incremental"), q("cc")]))
        check(warm.ok and cold.ok and same_fields(warm.fields, cold.fields),
              f"mutate {tag}: cc/incremental warm differs from cold cc "
              f"after an insert batch")
        log(f"[mutate] {tag} insert x{MUTATE_BATCH}: {stats.slots_patched} "
            f"slots, host {plan_ms:.1f} ms + patch {patch_ms:.1f} ms; "
            f"cc/incremental warm == cold cc, rounds {warm.rounds} warm vs "
            f"{cold.rounds} cold; epoch {server.epoch}")
        cell["insert"] = {"slots": stats.slots_patched, "plan_ms": plan_ms,
                          "patch_ms": patch_ms,
                          "cc_rounds": (warm.rounds, cold.rounds)}
        cells[tag] = cell
        del server, dyn

    # -- 7. the rebuild path on a graph that partitions in seconds ---------
    gcfg = port.graph_workloads.ALL[MUTATE_REBUILD_GRAPH]
    edges = port.generate_edges(gcfg, SEED)
    for parts in engines:
        tag = f"{MUTATE_REBUILD_GRAPH} parts={parts}"
        eng = port.GraphEngine(port.partition_graph(
            edges, gcfg.num_vertices, parts), device=device)
        server = serve.GraphServer(eng, buckets=SERVE_BUCKETS, depth=2)
        dyn = server.dynamic_graph()
        u, v = (int(x) for x in dyn.current_edges()[0])
        k = 1                                  # just past the free pools
        while not dyn.plan(np.tile([[u, v]], (k, 1)))[2]:
            k += 1
        g_before = eng.g
        stats = server.mutate(inserts=np.tile([[u, v]], (k, 1)))
        check(stats.rebuild and eng.g is not g_before,
              f"mutate {tag}: {k} copies of ({u}, {v}) did not rebuild")
        check(mirrors_on_device(torch, eng.g, server.garr),
              f"mutate {tag}: rebuilt device tensors differ from the mirrors")
        parity.tables(eng.g, server.garr, ("ell_in", "ell_dst", "ell_out"))
        got, _ = served_after(port, server, tag, counted)
        oracle_checks(port, server, got, tag)
        log(f"[mutate] {tag}: {k} copies of ({u}, {v}) overflowed; rebuilt "
            f"in {stats.apply_s:.2f} s; kernels bit-equal on the new "
            f"layout, served == direct, oracles hold")
        cells[f"rebuild/{tag}"] = {"rebuild_s": stats.apply_s, "copies": k}
        del server, dyn, eng

    # -- 8. durability at SERVE_PARTS ---------------------------------------
    import shutil
    eng = engines[SERVE_PARTS]
    card = card_line() if eng.device.type == "cuda" else "cpu"
    pdir = MUTATE_DIR / "durable"
    shutil.rmtree(pdir, ignore_errors=True)
    rec = port.obs.SpanRecorder()
    d = MUTATE_DURABLE
    t0 = time.perf_counter()
    server = serve.GraphServer(eng, buckets=SERVE_BUCKETS, depth=2,
                               obs=rec, persistence=serve.Persistence(
                                   dir=str(pdir),
                                   snapshot_every=d["snapshot_every"]))
    create_s = time.perf_counter() - t0         # upload, index, snapshot 0
    dyn = server.dynamic_graph()
    for i in range(d["batches"]):
        if i % 2 == 0:
            server.mutate(deletes=dyn.sample_deletable(d["size"], rng))
        else:
            server.mutate(inserts=dyn.sample_insertable(d["size"], rng))
    spans = {kind: [sp.dur * 1e3 for sp in rec.spans() if sp.kind == kind]
             for kind in ("snapshot", "wal_append")}
    snaps = persist.find_snapshots(str(pdir))
    snap_bytes = [os.path.getsize(path) for _, path in snaps]
    check(server.epoch == d["batches"]
          and [e for e, _ in snaps] == [4, 2]
          and not any(m["rebuild"] for m in server.mutation_log),
          f"mutate durable: epoch {server.epoch}, snapshots "
          f"{[e for e, _ in snaps]}, log {server.mutation_log}")
    want = {}
    for name in ("bfs/fast", "pagerank/fast"):
        (r,), _ = counted(lambda: server.serve(
            [serve.Query(serve.make_key(name),
                         ROOT if name == "bfs/fast" else None)]))
        want[name] = r
    digest = persist.edge_digest(dyn.current_edges())
    recover_s = []
    for drop in (None, snaps[0][1]):
        # then without the newest snapshot: snapshot 2 and two WAL
        # records replayed into the same slots
        if drop is not None:
            os.unlink(drop)
        t0 = time.perf_counter()
        recovered = serve.GraphServer.recover(str(pdir), device=eng.device,
                                              buckets=SERVE_BUCKETS)
        recover_s.append(time.perf_counter() - t0)
        rep = recovered.recovery_report
        check(recovered.epoch == server.epoch and persist.edge_digest(
                  recovered.dynamic.current_edges()) == digest
              and rep.replayed == (0 if drop is None else 2),
              f"mutate durable: recovered epoch {recovered.epoch}, "
              f"{rep.replayed} records replayed, or the edge digest differs "
              f"from the uninterrupted server's")
        for name, r in want.items():
            (r2,), _ = counted(lambda: recovered.serve(
                [serve.Query(serve.make_key(name),
                             ROOT if name == "bfs/fast" else None)]))
            check(r2.ok and r2.rounds == r.rounds
                  and same_fields(r2.fields, r.fields),
                  f"mutate durable: recovered {name} differs from the "
                  f"uninterrupted server's")
        del recovered
    log(f"[mutate] durable parts={SERVE_PARTS}: server with snapshot 0 in "
        f"{create_s:.2f} s; {d['batches']} batches of {d['size']} edges, "
        f"fsync; snapshots {[e for e, _ in snaps]} of "
        f"{[round(b / 2 ** 30, 3) for b in snap_bytes]} GiB, written in "
        f"{[round(x, 1) for x in spans['snapshot']]} ms (epochs 2, 4); "
        f"WAL appends {[round(x, 3) for x in spans['wal_append']]} ms; "
        f"recovered in {recover_s[0]:.2f} s (snapshot 4), and in "
        f"{recover_s[1]:.2f} s without it (snapshot 2 + 2 WAL records): "
        f"epoch {server.epoch}, edge digest, bfs/fast and pagerank/fast "
        f"bit-identical both times ({card})")
    cells["durable"] = {"create_s": create_s,
                        "snapshot_ms": spans["snapshot"],
                        "snapshot_bytes": snap_bytes,
                        "wal_append_ms": spans["wal_append"],
                        "recover_s": recover_s, "card": card}
    del server, dyn

    # -- 9. the launcher's replay under churn -----------------------------
    wal_dir = MUTATE_DIR / "replay"
    shutil.rmtree(wal_dir, ignore_errors=True)
    rp = MUTATE_REPLAY
    n_trace = len(serve.synthetic_trace(
        eng.g.n_orig, rp["mix"], rate=rp["rate"], duration=rp["duration"],
        zipf_s=rp["zipf_s"], seed=rp["seed"]))
    server, run_ms = counted(lambda: port.graph_serve.run(
        graph, SERVE_PARTS, engine=eng, wal_dir=str(wal_dir), obs=True,
        **rp))
    m = server.metrics
    rows = m.rows()
    n_mut = int(rp["duration"] / rp["mutate_every"] - 1e-9)
    muts = [(sp.args["rebuild"], sp.dur) for sp in server.obs.spans()
            if sp.kind == "mutation"]
    check(sum(r["count"] for r in rows) == n_trace
          and not any(m.counts.values()) and server.epoch == n_mut == 2
          and len(muts) == n_mut,
          f"mutate replay: {sum(r['count'] for r in rows)} of {n_trace} "
          f"queries ok, counts {m.counts}, epoch {server.epoch}")
    qps = n_trace / m.window_s
    for r in rows:
        log(f"[mutate] replay parts={SERVE_PARTS} {r['algo']:9s} bucket="
            f"{r['bucket']:3d} count {r['count']:3d}  p50 {r['p50_ms']} ms"
            f"  p95 {r['p95_ms']} ms  p99 {r['p99_ms']} ms  ({card})")
    log(f"[mutate] replay parts={SERVE_PARTS} {rp['mix']} at {rp['rate']} "
        f"q/s for {rp['duration']} s with a batch of {rp['mutate_size']} "
        f"edges every {rp['mutate_every']} s: {n_trace} queries all ok, "
        f"{qps:.3f} q/s over {m.window_s:.3f} s, final epoch "
        f"{server.epoch}; mutations (rebuild, s) "
        f"{[(rb, round(s, 2)) for rb, s in muts]}; run() {run_ms:.1f} ms "
        f"({card})")
    digest = persist.edge_digest(server.dynamic.current_edges())
    del server
    t0 = time.perf_counter()
    recovered = serve.GraphServer.recover(str(wal_dir), device=eng.device,
                                          buckets=SERVE_BUCKETS)
    recover_s = time.perf_counter() - t0
    rep = recovered.recovery_report
    check(recovered.epoch == n_mut and persist.edge_digest(
              recovered.dynamic.current_edges()) == digest,
          f"mutate replay: recovered epoch {recovered.epoch} or its edge "
          f"digest differs")
    log(f"[mutate] replay recovered in {recover_s:.2f} s: snapshot "
        f"{rep.snapshot_epoch} + {rep.replayed} WAL records ({rep.rebuilds} "
        f"rebuilds), epoch {recovered.epoch}, edge digest equal")
    cells["replay"] = {"queries": n_trace, "qps": qps, "window_s": m.window_s,
                       "rows": rows, "mutations": muts,
                       "recover_s": recover_s, "card": card}
    del recovered
    for name in total:
        check(total[name] > 0, f"mutate path: {name} never launched")
    secs = time.perf_counter() - t_phase
    log("[times] " + json.dumps({"mutate": cells, "launches": total,
                                 "seconds": secs}, default=str))
    log(f"[mutate done] {secs:.1f} s")
    return total


# ---------------------------------------------------------------------------
# the graph dry-run: plans on meta tensors, and plans against card runs
# ---------------------------------------------------------------------------

def nbytes(b) -> str:
    return "not measured" if b is None else f"{b:,} B"


def run_dryrun(port: Port, engines: dict) -> dict:
    """Plan all sixteen programs of DRYRUN_GRAPH at 256 and 512 parts on
    meta tensors (each program's HBM a part and bottleneck printed by
    the planner, under the v5e and the H100 constants).  Then at the
    resident graph's parts counts, plan DRYRUN_MEASURED on meta copies
    of its arrays and run the same static_iters builds on the card:
    through the kernels (mode auto, launches counted) and on the ell
    route the plan counts (the like-for-like temp comparison).  Planned
    argument bytes must equal the resident arrays' exactly, and
    pagerank's planned exchanges the ones its runs ship."""
    torch, dr = port.torch, port.dryrun
    t_phase = time.perf_counter()
    for mesh in ("pod", "multipod"):
        t0 = time.perf_counter()
        recs = dr.lower_graph_programs(DRYRUN_GRAPH, mesh)
        labels = [port.registry.program_label(a, v)
                  for a, v in port.registry.available()]
        check([r["program"] for r in recs] == labels and len(labels) == 16
              and all(r["status"] == "ok" for r in recs),
              f"dry-run {DRYRUN_GRAPH} x {mesh}: planned "
              f"{[r['program'] for r in recs]}")
        worst = max(recs, key=lambda r: r["arg_bytes_per_device"]
                    + r["temp_bytes_per_device"])
        log(f"[dryrun] {DRYRUN_GRAPH} x {mesh} ({recs[0]['devices']} "
            f"parts): {len(recs)} programs planned in "
            f"{time.perf_counter() - t0:.1f} s; bottlenecks v5e "
            f"{sorted({r['bottleneck'] for r in recs})}, H100 "
            f"{sorted({r['h100']['bottleneck'] for r in recs})}; most HBM "
            f"a part {worst['program']}")
    port.reset_launches()
    kernel_of = {"bfs": "bfs_pull", "pagerank": "spmv_ell"}
    cells = {}
    for parts, (_, eng, garr) in engines.items():
        for algo, variant in DRYRUN_MEASURED:
            it = dr.STATIC_ITERS[algo]
            params = dr.DRYRUN_PARAMS.get((algo, variant), {})
            before = port.launches()
            k = dr.measure_vs_plan(eng, garr, algo, variant, it, **params)
            after = port.launches()
            with port.localops.using("ell"):
                e = dr.measure_vs_plan(eng, garr, algo, variant, it,
                                       **params)
            check(port.launches() == after, "the ell route launched")
            name = kernel_of[algo]
            launched = after[name] - before[name]
            key = f"{algo}/{variant}/parts={parts}"
            for r in (k, e):
                check(r["planned_arg_bytes"] == r["resident_bytes"],
                      f"dry-run {key}: planned argument bytes "
                      f"{r['planned_arg_bytes']} != resident "
                      f"{r['resident_bytes']}")
                if algo == "pagerank":
                    check(r["planned_wire"] == r["run_wire"],
                          f"dry-run {key}: planned exchanges "
                          f"{r['planned_wire']} != the run's "
                          f"{r['run_wire']}")
            check(launched > 0, f"dry-run {key}: {name} never launched")
            cells[key] = c = {
                "static_iters": it, "resident_bytes": k["resident_bytes"],
                "planned_temp_bytes": k["planned_temp_bytes"],
                "measured_peak_kernels": k["measured_peak_bytes"],
                "measured_peak_ell": e["measured_peak_bytes"],
                "planned_wire": k["planned_wire"],
                "run_wire": k["run_wire"], "plan_s": k["plan_s"],
                "launches": launched}
            log(f"[dryrun] parts={parts} {algo}/{variant} static_iters={it}"
                f": args planned = resident = {k['resident_bytes']:,} B; "
                f"temp planned {k['planned_temp_bytes']:,} B (ell route) "
                f"vs measured peak {nbytes(e['measured_peak_bytes'])} (ell)"
                f" / {nbytes(k['measured_peak_bytes'])} (kernels); wire "
                f"planned "
                f"{k['planned_wire']} run {k['run_wire']}; {name} "
                f"{launched} launches; plan {k['plan_s']:.2f} s")
    launches = port.launches()
    secs = time.perf_counter() - t_phase
    log("[dryrun] " + json.dumps({"cells": cells, "launches": launches},
                                 default=str))
    log(f"[dryrun done] {secs:.1f} s")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# LM serving: flash_attention_fwd
# ---------------------------------------------------------------------------

def flash_bound(bh: int, sq: int, sk: int, d: int, itemsize: int,
                causal: bool, extra_bytes: int = 0) -> tuple[float, str]:
    """Least ms for one flash call: q, k, v read and o written once (and
    ``extra_bytes`` more, an lse output) over HBM rate, against q k^T and
    p @ v on the unmasked (query, key) pairs (2 ops a multiply-add, D of
    each per pair and product) over the bf16 tensor-core peak."""
    pairs = bh * (sum(min(q + 1, sk) for q in range(sq)) if causal
                  else sq * sk)
    return bound(itemsize * d * bh * (2 * sq + 2 * sk) + extra_bytes,
                 4 * d * pairs, BF16_TC_OPS_PER_S)


def flash_times(port: Port, device, q, k, v, batch: int,
                causal: bool = True) -> dict:
    """The flash kernel on (BH, Sq, D) bf16 q and (BH, Sk, D) k, v beside
    ref.py, scaled_dot_product_attention on the same inputs as (batch,
    BH / batch, S, D) (checked to agree with the kernel), and the
    bound."""
    torch = port.torch
    bh, sq, d = q.shape
    b_ms, b_by = flash_bound(bh, sq, k.shape[1], d, q.element_size(), causal)
    sdpa_in = [t.reshape(batch, bh // batch, t.shape[1], d)
               for t in (q, k, v)]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            *sdpa_in, is_causal=causal)

    check(torch.allclose(library().reshape(q.shape).float(),
                         port.flash(q, k, v, causal=causal).float(),
                         atol=FLASH_TOL["bfloat16"],
                         rtol=FLASH_TOL["bfloat16"]),
          f"scaled_dot_product_attention disagrees with the kernel at "
          f"{tuple(q.shape)} x {tuple(k.shape)}")
    return {"ms": kernel_ms(torch, device,
                            lambda: port.flash(q, k, v, causal=causal)),
            "plain_ms": kernel_ms(
                torch, device, lambda: port.flash_attention_ref(
                    q, k, v, causal=causal), reps=5),
            "library_ms": kernel_ms(torch, device, library),
            "bound_ms": b_ms, "bound_by": b_by}


class FlashParity:
    """flash_attention_fwd against ref.py; keeps the max abs error."""

    def __init__(self, port: Port, device):
        self.port, self.device = port, device
        self.err = {"float32": 0.0, "bfloat16": 0.0}
        self.lse_err = 0.0
        self.cases = 0

    def randn(self, shape, dtype, gen):
        torch = self.port.torch
        return torch.randn(shape, generator=gen, device=self.device) \
            .to(getattr(torch, dtype))

    def one(self, got, want, dtype, what):
        torch = self.port.torch
        _sync(torch, self.device)
        tol = FLASH_TOL[dtype]
        check(got.dtype == want.dtype, f"flash {what}: dtype {got.dtype}")
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"flash {what} "
                                   f"{dtype}: {m}")
        self.err[dtype] = max(self.err[dtype],
                              float((got.float() - want.float()).abs().max()))
        self.cases += 1

    def lse(self, q, k, v, what, **kw):
        """``return_lse=True``: o with the bits of the call without it,
        and the lse within LSE_TOL of ref.py's."""
        torch, port = self.port.torch, self.port
        o = port.flash(q, k, v, **kw)
        o2, lse = port.flash(q, k, v, return_lse=True, **kw)
        _, want = port.flash_attention_ref(q, k, v, return_lse=True, **kw)
        _sync(torch, self.device)
        check(same_bits(torch, o, o2), f"flash {what}: o with lse differs "
              f"from o without it")
        torch.testing.assert_close(lse, want, atol=LSE_TOL, rtol=LSE_TOL,
                                   msg=lambda m: f"flash lse {what}: {m}")
        self.lse_err = max(self.lse_err,
                           float((lse - want).abs().max()))

    def run(self, prefill_shape):
        port, torch = self.port, self.port.torch
        gen = torch.Generator(device=self.device).manual_seed(SEED)
        cases = [((bh, s, d), (bh, s, d), dict(causal=c, window=w))
                 for bh, s, d in FLASH_SWEEP
                 for c, w in ((True, 0), (True, 64), (False, 0))]
        cases += [((2, 128, 128), (2, 512, 128), dict(causal=False)),
                  ((1, 128, 128), (1, 128, 128),
                   dict(causal=True, softcap=20.0))]
        cases += [((bh, sq, d), (bh, sk, d),
                   dict(causal=c, window=w, softcap=cap))
                  for bh, sq, sk, d, c, w, cap in FLASH_EDGES]
        for dtype in ("float32", "bfloat16"):
            for qs, ks, kw in cases:
                q = self.randn(qs, dtype, gen)
                k, v = self.randn(ks, dtype, gen), self.randn(ks, dtype, gen)
                self.one(port.flash(q, k, v, **kw),
                         port.flash_attention_ref(q, k, v, **kw), dtype,
                         f"{qs}x{ks} {kw}")
                self.lse(q, k, v, f"{qs}x{ks} {kw} {dtype}", **kw)
            # danube3's head dim 120 through ops, (B, S, H, D)
            q, k, v = (self.randn((2, 128, 4, 120), dtype, gen)
                       for _ in range(3))
            want = port.flash_attention_ref(
                *(t.transpose(1, 2).reshape(8, 128, 120) for t in (q, k, v)),
                causal=True).reshape(2, 4, 128, 120).transpose(1, 2)
            self.one(port.flash_ops.flash_attention(q, k, v, causal=True),
                     want, dtype, "ops D=120")
        q, k, v = (self.randn(prefill_shape, "bfloat16", gen)
                   for _ in range(3))
        self.one(port.flash(q, k, v, causal=True),
                 port.flash_attention_ref(q, k, v, causal=True), "bfloat16",
                 f"prefill shape {prefill_shape}")
        self.lse(q, k, v, f"prefill shape {prefill_shape}", causal=True)
        return q, k, v


def device_profile(port: Port, cfg, model, batch: int, prompt_len: int,
                   device, gen: int = 8) -> dict:
    """torch.profiler over one serve call with ``gen`` decode steps: the
    device kernels' time, summed by name (one stream, so they do not
    overlap), against serve's own synchronized prefill and decode time,
    and the kernels that take most.  Tracing slows the host, so the busy
    share is a lower bound on the untraced run's."""
    torch = port.torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, stats = port.serve(cfg, batch=batch, prompt_len=prompt_len,
                              gen=gen, device=device, params=model)
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    wall_ms = (stats["prefill_s"] + stats["decode_s"]) * 1e3
    out = {"gen": gen, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "prefill_ms": stats["prefill_s"] * 1e3,
           "decode_ms": stats["decode_s"] * 1e3,
           "top_kernels": [{"name": k[:80], "ms": ms, "calls": n}
                           for k, ms, n in kernels[:10]]}
    log(f"[profile] serve gen={gen} under torch.profiler: prefill "
        f"{out['prefill_ms']:.1f} ms + decode {out['decode_ms']:.1f} ms, "
        f"device kernels {busy_ms:.1f} ms ({out['device_busy_share']:.1%})")
    for r in out["top_kernels"]:
        log(f"[profile]   {r['ms']:9.3f} ms  x{r['calls']:<5d} {r['name']}")
    return out


def logit_diff(torch, a, b, tie: float | None = None) -> dict:
    """Logits ``a`` against the reference ``b`` (rows of vocab logits):
    largest and mean difference, and the argmax row by row.  A row of
    ``a`` may take another token than ``b`` only where that token's logit
    in ``b`` is within one bf16 ulp of ``b``'s largest (a tie at the
    logits' own precision), or within ``tie`` when given; such rows are
    counted in ``argmax_ties``, any other in ``argmax_other``.
    ``top2_gap`` is each row's gap between ``b``'s two largest logits."""
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    top = b.topk(2, dim=-1).values
    ulp = torch.ldexp(torch.ones_like(top[:, 0]),
                      torch.frexp(top[:, 0].abs()).exponent - 8)
    if tie is not None:
        ulp = torch.full_like(ulp, tie)
    pick = a.argmax(-1)
    differ = pick != b.argmax(-1)
    tie = b.gather(-1, pick[:, None])[:, 0] >= top[:, 0] - ulp
    d = (a - b).abs()
    return {"max": float(d.max()), "mean": float(d.mean()),
            "argmax_ties": int((differ & tie).sum()),
            "argmax_other": int((differ & ~tie).sum()),
            "top2_gap": (top[:, 0] - top[:, 1]).tolist(),
            "max_logit": float(b.abs().max()),
            "finite": bool(torch.isfinite(a).all())}


def run_llm(port: Port, device, arch: str = LLM_ARCH, batch: int = LLM_BATCH,
            prompt_len: int = LLM_PROMPT, gen: int = LLM_GEN,
            decode_prompt: int = LLM_DECODE_PROMPT) -> dict:
    """The LM phases: parity, the serve main path and its checks, times."""
    torch, models = port.torch, port.models
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = port.arch_registry.get_arch(arch)
    prefill_shape = (batch * cfg.num_heads, prompt_len, cfg.head_dim)

    # -- llm-parity -----------------------------------------------------------
    parity = FlashParity(port, device)
    fq, fk, fv = parity.run(prefill_shape)
    log(f"[llm-parity] flash_attention_fwd: {parity.cases} cases ok, "
        f"max_abs_err {parity.err}; with return_lse o bit-identical, lse "
        f"max_abs_err {parity.lse_err:.3e}")

    # -- llm-main -------------------------------------------------------------
    t0 = time.perf_counter()
    before = requested_bytes(torch, device)
    model = models.Transformer(cfg, models.init_params(
        models.param_spec(cfg), torch.Generator(device=device).manual_seed(0),
        device))
    _sync(torch, device)
    param_bytes = None if before is None \
        else requested_bytes(torch, device) - before
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[llm-main] {arch}: {n_params:,} f32 parameters "
        f"({n_params * 4 / 1e9:.2f} GB) drawn on the device in "
        f"{time.perf_counter() - t0:.1f} s")
    port.reset_launches()
    toks, stats = port.serve(cfg, batch=batch, prompt_len=prompt_len,
                             gen=gen, device=device, params=model)
    _sync(torch, device)
    launches = port.launches()
    log(f"[llm-main] serve batch={batch} prompt={prompt_len} gen={gen}: "
        f"launches {launches}; prefill {stats['prefill_s'] * 1e3:.1f} ms, "
        f"decode {stats['tok_per_s']:.1f} tok/s; sample "
        f"{toks[0, :8].tolist()}")
    check(launches["flash_attention_fwd"] == cfg.num_layers,
          f"flash_attention_fwd launched {launches['flash_attention_fwd']} "
          f"times in serve, want {cfg.num_layers} (one per prefill layer)")
    check(launches["flash_attention_fwd_tc"] == cfg.num_layers,
          f"{launches['flash_attention_fwd_tc']} of the prefill's flash "
          f"launches ran the bf16 tensor-core design, want "
          f"{cfg.num_layers}")
    check(tuple(toks.shape) == (batch, gen) and toks.dtype == torch.int32,
          f"served tokens {tuple(toks.shape)} {toks.dtype}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "served tokens out of range")

    with torch.inference_mode():
        before = requested_bytes(torch, device)
        prompt = port.batch_at(0, global_batch=batch, seq_len=prompt_len,
                               vocab_size=cfg.vocab_size).to(device)
        resident = None if before is None \
            else param_bytes + requested_bytes(torch, device) - before
        # the kernel at layer 0's real q, k, v (kv heads repeated)
        layers, blk = models.layers, model.segments[0][0]
        h = layers.apply_norm(blk.ln1, models.model._embed(model, cfg, prompt),
                              cfg.norm)
        q, k, v = layers.attn_qkv(blk.attn, h, cfg,
                                  torch.arange(prompt_len, device=device))
        g = cfg.num_heads // cfg.num_kv_heads
        q, k, v = (port.flash_ops._to_bh(t) for t in (
            q, layers.repeat_kv(k, g), layers.repeat_kv(v, g)))
        parity.one(port.flash(q, k, v, causal=True),
                   port.flash_attention_ref(q, k, v, causal=True),
                   "bfloat16", "layer-0 q, k, v")
        del h, q, k, v

        with PeakBytes(torch, device) as pk:
            lg_k, _ = models.forward_prefill(model, cfg, {"tokens": prompt})
        lg_n, _ = models.forward_prefill(model, cfg, {"tokens": prompt},
                                         impl="naive")
        short = prompt[:, :decode_prompt]
        lg_p, _ = models.forward_prefill(model, cfg, {"tokens": short})
        lg_pn, _ = models.forward_prefill(model, cfg, {"tokens": short},
                                          impl="naive")
        cache = models.init_cache(cfg, batch, decode_prompt, device=device)
        for t in range(decode_prompt):
            lg_d, cache = models.forward_decode(model, cfg,
                                                short[:, t:t + 1], cache)
        _sync(torch, device)
        del cache
        errs = {}
        for what, a, b in (
                ("prefill kernel vs naive", lg_k, lg_n),
                (f"decode vs prefill ({decode_prompt} tokens)", lg_d, lg_p),
                (f"decode vs naive prefill ({decode_prompt} tokens)", lg_d,
                 lg_pn)):
            errs[what] = e = logit_diff(torch, a, b)
            log(f"[llm-main] logits, {what}: {e}")
            check(e["finite"], f"{what}: logits not finite")
            check(e["max"] <= LOGIT_MAX_TOL and e["mean"] <= LOGIT_MEAN_TOL
                  and e["argmax_other"] == 0,
                  f"{what}: {e} beyond max {LOGIT_MAX_TOL}, mean "
                  f"{LOGIT_MEAN_TOL} or argmax")
        del lg_n
    prefill_err = errs["prefill kernel vs naive"]["max"]
    decode_err = errs[f"decode vs prefill ({decode_prompt} tokens)"]["max"]

    # -- llm-times ------------------------------------------------------------
    runs = [port.serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                       device=device, params=model)[1] for _ in range(3)]
    prefill_ms = statistics.median(r["prefill_s"] for r in runs) * 1e3
    tok_s = statistics.median(r["tok_per_s"] for r in runs)
    flash = flash_times(port, device, fq, fk, fv, batch)
    b_ms, b_by = flash["bound_ms"], flash["bound_by"]
    share = cfg.num_layers * flash["ms"] / prefill_ms
    log(f"[times] llm {arch} batch={batch} prompt={prompt_len} gen={gen}: "
        f"prefill {prefill_ms:.2f} ms, decode {tok_s:.1f} tok/s "
        f"(runs {[round(r['prefill_s'] * 1e3, 2) for r in runs]} ms, "
        f"{[round(r['tok_per_s'], 1) for r in runs]} tok/s)")
    log(f"[times] flash_attention_fwd {prefill_shape} bf16 causal: kernel "
        f"{flash['ms']:.4f} ms  plain {flash['plain_ms']:.4f} ms  bound "
        f"{b_ms:.4f} ms ({b_by})  sdpa {flash['library_ms']:.4f} ms; "
        f"{cfg.num_layers} layers = {share:.1%} of prefill")
    gen_w = torch.Generator(device=device).manual_seed(SEED + 1)
    widths = {}
    for shape in FLASH_WIDTHS:
        q, k, v = (torch.randn(shape, generator=gen_w, device=device)
                   .to(torch.bfloat16) for _ in range(3))
        widths[str(shape)] = w = flash_times(port, device, q, k, v, batch)
        log(f"[times] flash_attention_fwd {shape} bf16 causal: kernel "
            f"{w['ms']:.4f} ms  plain {w['plain_ms']:.4f} ms  bound "
            f"{w['bound_ms']:.4f} ms ({w['bound_by']})  sdpa "
            f"{w['library_ms']:.4f} ms")
        del q, k, v
    profile = device_profile(port, cfg, model, batch, prompt_len, device)
    log("[times] " + json.dumps({
        "arch": arch, "prefill_ms": prefill_ms, "decode_tok_per_s": tok_s,
        "profile": profile,
        "flash": flash, "flash_widths": widths,
        "flash_share_of_prefill": share,
        "prefill_logit_err": prefill_err, "decode_logit_err": decode_err}))
    cell = {"cfg": cfg, "kind": "prefill", "batch": batch,
            "seq": prompt_len, "resident": resident,
            "peak": None if resident is None else resident + pk.peak,
            "peak_allocated_above": pk.peak_allocated}
    return {"launches": launches["flash_attention_fwd"],
            "parity_err": max(parity.err.values()), "flash": flash,
            "dryrun_cells": {f"llm-main {arch} prefill": cell}}


# ---------------------------------------------------------------------------
# LM training: flash_attention_fwd under autograd, AdamW, checkpoints
# ---------------------------------------------------------------------------

def grad_gaps(torch, tree, got, want) -> list:
    """Relative norm difference of each gradient leaf, in leaf order."""
    return [float((a.float() - b.float()).norm() / b.float().norm()
                  .clamp(min=1e-30))
            for a, b in zip(tree.leaves(got), tree.leaves(want))]


def run_train(port: Port, device, arch: str = LLM_ARCH,
              batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
              steps: int = TRAIN_STEPS, ckpt_at: int = TRAIN_CKPT_AT,
              ckpt_dir=TRAIN_DIR) -> dict:
    """The training phase (see the module docstring): the lse at the
    training shape, the kernel forward's step 0 against the plain
    forward's, then ``launch/train.py::train`` for ``steps`` steps from
    seeded weights (the main path, flash launches counted), a run to
    ``ckpt_at`` that writes a checkpoint, and a resumed run to ``steps``
    held against the uninterrupted one."""
    import shutil
    torch, st, tr, tree = port.torch, port.train_steps, port.trainer, \
        port.tree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    cfg = port.arch_registry.get_arch(arch)
    tc0 = st.default_train_config(cfg)
    check(tc0.grad_accum == 1, f"default_train_config: {tc0}")

    # -- the lse at the training shape, timed with and without it ------------
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    shape = (batch * cfg.num_heads, seq, cfg.head_dim)
    q, k, v = (torch.randn(shape, generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    parity = FlashParity(port, device)
    parity.lse(q, k, v, f"training shape {shape}", causal=True)
    lse_ms = kernel_ms(torch, device, lambda: port.flash(
        q, k, v, causal=True, return_lse=True))
    o_ms = kernel_ms(torch, device, lambda: port.flash(q, k, v, causal=True))
    log(f"[train] flash {shape} bf16 causal: lse max_abs_err "
        f"{parity.lse_err:.3e}, o bit-identical with and without lse; "
        f"{lse_ms:.4f} ms with lse, {o_ms:.4f} ms without")

    # -- the plain backward at one layer's shape ------------------------------
    L = port.model_layers
    q4, k4, v4 = (t.reshape(batch, cfg.num_heads, seq, cfg.head_dim)
                  .transpose(1, 2) for t in (q, k, v))
    o4, lse4 = L._flash_fwd_impl(q4, k4, v4, causal=True, window=0,
                                 softcap=0.0)
    do4 = torch.randn(o4.shape, generator=gen, device=device) \
        .to(torch.bfloat16)
    bwd_ms = median_ms(torch, device, lambda: L._flash_bwd_impl(
        q4, k4, v4, o4, lse4, do4, causal=True, window=0, softcap=0.0))
    fwd_plain_ms = median_ms(torch, device, lambda: L._flash_fwd_impl(
        q4, k4, v4, causal=True, window=0, softcap=0.0))
    log(f"[train] plain flash backward {tuple(q4.shape)}: {bwd_ms:.2f} ms "
        f"a layer (plain forward {fwd_plain_ms:.2f} ms, kernel "
        f"{lse_ms:.4f} ms)")
    del q, k, v, q4, k4, v4, o4, lse4, do4

    # -- step 0: the kernel forward against the plain forward ----------------
    before = requested_bytes(torch, device)
    params, opt = tr.build_state(cfg, tc0, device)
    b0 = tr.next_batch(port.TokenStream(
        global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size,
        seed=tc0.seed), cfg, tc0, device)
    b0 = {k: v.to(device) for k, v in b0.items()}
    resident = None if before is None \
        else requested_bytes(torch, device) - before
    del opt
    lk, _, gk = st.value_and_grad(cfg, params, b0)
    lp, _, gp = st.value_and_grad(cfg, params, b0, impl="plain")
    gaps = grad_gaps(torch, tree, gk, gp)
    del gk
    ln, _, gn = st.value_and_grad(cfg, params, b0, impl="naive")
    floor = grad_gaps(torch, tree, gn, gp)
    del gn, gp
    loss_gap = abs(float(lk) - float(lp))
    log(f"[train] step 0, kernel vs plain forward: loss {float(lk):.6f} vs "
        f"{float(lp):.6f} (gap {loss_gap:.3e}; naive {float(ln):.6f}); "
        f"gradient leaves' relative norm gaps {[round(x, 5) for x in gaps]}"
        f", naive vs plain (the floor) {[round(x, 5) for x in floor]}")
    check(loss_gap <= TRAIN_LOSS_TOL, f"step-0 loss gap {loss_gap}")
    check(all(a <= TRAIN_GRAD_FACTOR * b for a, b in zip(gaps, floor)),
          f"gradient gaps {gaps} beyond {TRAIN_GRAD_FACTOR} x the floor "
          f"{floor}")
    del params

    # -- the main path: train() from seeded weights ---------------------------
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    run_kw = dict(batch=batch, seq=seq, device=device, log_every=1)
    port.reset_launches()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    hist = []
    t0 = time.perf_counter()
    with PeakBytes(torch, device) as pk:
        p_full, _, _ = tr.train(cfg, dataclasses.replace(
            tc0, checkpoint_dir=str(ckpt_dir / "full"), checkpoint_every=0),
            steps=steps, resume=False, history=hist, **run_kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else None
    main_launches = port.launches()
    recs = [h for h in hist if "step" in h]
    losses = [h["loss"] for h in recs]
    norms = [h["grad_norm"] for h in recs]
    step_ms = [h["s"] * 1e3 for h in recs]
    check(len(recs) == steps and all(np.isfinite(losses + norms)),
          f"train: losses {losses}, grad norms {norms}")
    check(abs(losses[0] - np.log(cfg.vocab_size)) < 0.5,
          f"step-0 loss {losses[0]} vs ln {cfg.vocab_size}")
    per_step = 2 * cfg.num_layers     # the forward and its remat recompute
    check(main_launches["flash_attention_fwd"] == steps * per_step
          and main_launches["flash_attention_fwd_tc"] == steps * per_step,
          f"train launched flash {main_launches}, want {steps * per_step} "
          f"(a forward and a recompute a layer a step)")
    tokens_s = batch * seq / (statistics.median(step_ms) / 1e3)
    log(f"[train] {arch} batch={batch} seq={seq}: {steps} steps in "
        f"{wall:.1f} s; losses {[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 3) for x in norms]}; ms a step {[round(x, 1) for x in step_ms]}"
        f" (median {statistics.median(step_ms):.1f}), {tokens_s:.0f} tokens/s;"
        f" peak {nbytes(peak)}; flash launches {main_launches}")

    # -- checkpoint at ckpt_at, resume to steps -----------------------------
    tc_b = dataclasses.replace(tc0, checkpoint_dir=str(ckpt_dir / "resume"),
                               checkpoint_every=ckpt_at)
    hist_b, hist_c = [], []
    tr.train(cfg, tc_b, steps=ckpt_at, resume=False, history=hist_b,
             **run_kw)
    p_res, _, _ = tr.train(cfg, dataclasses.replace(tc_b,
                                                    checkpoint_every=0),
                           steps=steps, resume=True, history=hist_c,
                           **run_kw)
    _sync(torch, device)
    launches = port.launches()
    writes = [h["write_s"] for h in hist_b if "write_s" in h]
    reads = [h["read_s"] for h in hist_c if "read_s" in h]
    check(len(writes) == 1 and len(reads) == 1
          and hist_c[0]["restored"] == ckpt_at,
          f"checkpoint writes {hist_b}, reads {hist_c}")
    ckpt_bytes = sum(f.stat().st_size for f in (
        ckpt_dir / "resume").rglob("*.npy"))
    check(launches["flash_attention_fwd"] == 2 * steps * per_step,
          f"train runs launched flash {launches}")
    bits = sum(int(torch.equal(a, b)) for a, b in
               zip(tree.leaves(p_res), tree.leaves(p_full)))
    for i, (a, b) in enumerate(zip(tree.leaves(p_res),
                                   tree.leaves(p_full))):
        torch.testing.assert_close(
            a, b, rtol=RESUME_RTOL, atol=RESUME_ATOL,
            msg=lambda m, i=i: f"resumed leaf {i} vs uninterrupted: {m}")
    log(f"[train] checkpoint of step {ckpt_at}: {ckpt_bytes / 1e9:.2f} GB "
        f"written in {writes[0]:.1f} s, read in {reads[0]:.1f} s; resumed "
        f"to step {steps}: within rtol {RESUME_RTOL} / atol {RESUME_ATOL} "
        f"of the uninterrupted run, {bits} of {len(tree.leaves(p_full))} "
        f"leaves bit-identical")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del p_full, p_res
    secs = time.perf_counter() - t_phase
    out = {"arch": arch, "batch": batch, "seq": seq, "steps": steps,
           "losses": losses, "grad_norms": norms, "step_ms": step_ms,
           "tokens_per_s": tokens_s, "peak_bytes": peak,
           "ckpt_bytes": ckpt_bytes, "ckpt_write_s": writes[0],
           "ckpt_read_s": reads[0], "resume_bit_leaves": bits,
           "loss_gap_plain": loss_gap, "grad_gaps_plain": gaps,
           "grad_gaps_floor": floor,
           "lse_ms": lse_ms, "flash_ms": o_ms, "lse_err": parity.lse_err,
           "plain_bwd_ms": bwd_ms, "plain_fwd_ms": fwd_plain_ms,
           "launches": launches["flash_attention_fwd"], "secs": secs,
           "resident_bytes": resident, "peak_requested": pk.peak}
    log("[train] " + json.dumps(out))
    log(f"[train done] {secs:.1f} s")
    out["dryrun_cells"] = {f"train {arch}": {
        "cfg": cfg, "kind": "train", "batch": batch, "seq": seq,
        "tc": tc0, "resident": resident, "peak": pk.peak,
        "peak_allocated_above": pk.peak_allocated}}
    return out


# ---------------------------------------------------------------------------
# LM serving of the other families: flash_attention_fwd at their shapes
# ---------------------------------------------------------------------------

def flash_calls(port: Port, cfg) -> int:
    """flash_attention_fwd launches of one prefill: one an attention call
    (self and cross), the encoder's included."""
    per = {"attn": 1, "moe": 1, "shared_attn": 1, "xattn": 2, "mamba": 0}
    n = sum(per[s.kind] * s.count for s in port.models.build_plan(cfg))
    return n + (cfg.encoder_layers if cfg.family == "audio" else 0)


class FlashCapture:
    """Within the context, the flash wrapper as ``ops`` calls it keeps a
    copy of the first q, k, v of each distinct (shapes, options) it meets;
    every call goes on to the wrapper and its counters."""

    def __init__(self, port: Port):
        self.port, self.seen = port, {}

    def __enter__(self):
        ops = self.port.flash_ops
        self.orig = orig = ops.flash_attention_fwd

        def capture(q, k, v, **kw):
            key = (tuple(q.shape), tuple(k.shape), tuple(sorted(kw.items())))
            if key not in self.seen:
                self.seen[key] = (q.clone(), k.clone(), v.clone())
            return orig(q, k, v, **kw)

        ops.flash_attention_fwd = capture
        return self

    def __exit__(self, *exc):
        self.port.flash_ops.flash_attention_fwd = self.orig


class RouteRecorder:
    """Within the context (and when ``on``), each ``apply_moe`` call, as
    ``models/model.py`` makes it, records its routing, recomputed with
    ``moe.route`` on the same input: the top-k experts of each token in
    their order and which of those choices fit under capacity, one
    (B, S, K) pair a call (a prefill layer, or a decode step's layer)."""

    def __init__(self, port: Port, on: bool):
        self.port, self.on, self.calls = port, on, []

    def __enter__(self):
        moe = self.port.model_moe
        self.orig = orig = moe.apply_moe
        if not self.on:
            return self

        def record(p, x, cfg, *, capacity_factor=None, group_size=256):
            g = moe.group_tokens(x, group_size)
            E, K = cfg.num_experts, cfg.num_experts_per_tok
            C = moe._capacity(g.shape[1], E, K,
                              capacity_factor or cfg.capacity_factor)
            r = moe.route(p["router"], g, E, K, C)
            self.calls.append(tuple(t.reshape(x.shape[0], x.shape[1], K)
                                    for t in (r["gate_idx"], r["kept"])))
            return orig(p, x, cfg, capacity_factor=capacity_factor,
                        group_size=group_size)

        moe.apply_moe = record
        return self

    def __exit__(self, *exc):
        self.port.model_moe.apply_moe = self.orig

    def _kept_sets(self, calls):
        torch = self.port.torch
        return torch.stack([torch.where(kept > 0, idx, -1).sort(dim=-1)
                            .values for idx, kept in calls])

    def compare(self, other, last: int = 0):
        """(agree (B, S) bool: tokens whose kept choices are equal in
        every layer, the share of (layer, token, k) kept choices of this
        run that the other did not make, and that share layer by layer).
        With ``last`` this run's last calls are ``last`` decode steps
        (one call a layer a step), held against the other's last
        ``last`` positions."""
        b = self._kept_sets(other.calls)                      # (L, B, S, K)
        if last:
            a = self._kept_sets(self.calls[-last * b.shape[0]:])
            a = a.reshape(last, b.shape[0], *a.shape[1:])
            a = a[..., 0, :].permute(1, 2, 0, 3)              # (L, B, T, K)
            b = b[:, :, -last:]
        else:
            a = self._kept_sets(self.calls)
        differ = ~(a[..., :, None] == b[..., None, :]).any(dim=-1)
        per_layer = differ.float().mean(dim=(1, 2, 3)).tolist()
        return (~differ.any(dim=3).any(dim=0), float(differ.float().mean()),
                per_layer)

    def choices(self, layers: int):
        """Each layer's top-k experts over the whole sequence: a prefill's
        calls as they are, a prefill followed by decode steps joined
        along the sequence."""
        torch = self.port.torch
        idx = [c[0] for c in self.calls]
        return [torch.cat(idx[l::layers], dim=1) for l in range(layers)]


class RouteReplay:
    """Within the context, the i-th ``moe.route`` call takes the i-th
    entry of ``choices`` (B, S, K) for its top-k experts, with its own
    router probabilities as gates, so a run computes another run's
    routing and differs from it only in rounding."""

    def __init__(self, port: Port, choices: list):
        self.port, self.choices, self.i = port, choices, 0

    def __enter__(self):
        moe = self.port.model_moe
        self.orig = orig = moe.route

        def replay(router, x, E, K, C, choices=None):
            forced = self.choices[self.i].reshape(x.shape[0], x.shape[1], K)
            self.i += 1
            return orig(router, x, E, K, C, choices=forced)

        moe.route = replay
        return self

    def __exit__(self, *exc):
        self.port.model_moe.route = self.orig
        if exc[0] is None:
            check(self.i == len(self.choices),
                  f"route replayed {self.i} of {len(self.choices)} calls")


def family_logits(port: Port, model, cfg, batch: dict, impl: str,
                  last: int = 1):
    """The logits at the last ``last`` positions of a prefill forward
    (``forward_prefill``'s own steps: the encoder for the audio family,
    the vision tokens prepended for the vlm)."""
    torch, M = port.torch, port.models.model
    memory = (M._encode_audio(model, cfg, batch["enc_embeds"], impl)
              if cfg.family == "audio" else None)
    x = M._embed(model, cfg, batch["tokens"], batch)
    pos = torch.arange(x.shape[1], device=x.device)
    x, _ = M._run_segments(model, cfg, x, pos, impl=impl, memory=memory)
    return M._logits(model, cfg, x[:, -last:])


def family_diff(torch, a, b, floor: dict | None = None) -> dict:
    """logit_diff with the bounds of the families' checks kept in the
    record: logit_tols at ``b``'s largest magnitude, or
    FAMILY_FLOOR_FACTOR times ``floor``'s max and mean where larger.  A
    position may take another token where the two could trade places
    within the max bound (each moved at most that much): seeded weights
    give top-two gaps down to 0, and the paths differ by several ulps,
    so a one-ulp tie does not cover it."""
    t_max, t_mean = logit_tols(float(b.float().abs().max()))
    if floor is not None:
        t_max = max(t_max, FAMILY_FLOOR_FACTOR * floor["max"])
        t_mean = max(t_mean, FAMILY_FLOOR_FACTOR * floor["mean"])
    e = logit_diff(torch, a, b, tie=2 * t_max)
    e["bounds"] = (t_max, t_mean)
    return e


def logit_tols(max_logit: float) -> tuple[float, float]:
    """LOGIT_MAX_TOL and LOGIT_MEAN_TOL at the reference logits' largest
    magnitude: the two bounds are 16 bf16 ulps and about 2 of logits in
    [2, 4), and a bf16 ulp doubles with each binade above (phi3.5-moe's
    logits reach [4, 8))."""
    e = math.frexp(max(max_logit, 2.0))[1] - 1       # max_logit in [2^e, ..)
    scale = 2.0 ** (e - 1)
    return LOGIT_MAX_TOL * scale, LOGIT_MEAN_TOL * scale


def run_families(port: Port, device, families=FAMILIES,
                 prefix: int = FAMILY_PREFIX, steps: int = FAMILY_STEPS,
                 profile_gen: int = 4) -> dict:
    """The families phase (see the module docstring): each family served
    once through ``launch/serve.py`` with the counters zeroed around it,
    its checks, its times, and the flash kernel at every shape the
    family's prefill gave it."""
    torch, models = port.torch, port.models
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    parity = FlashParity(port, device)
    cells, shapes, total, dry_cells = {}, [], 0, {}
    for arch, batch, prompt_len, gen, keep in families:
        cfg = port.arch_registry.get_arch(arch)
        cut = keep is not None and keep < cfg.num_layers
        if cut:
            cfg = dataclasses.replace(cfg, num_layers=keep)
        depth = (f"{keep} of {port.arch_registry.get_arch(arch).num_layers}"
                 f" layers" if cut else "full depth")
        t0 = time.perf_counter()
        before = requested_bytes(torch, device)
        model = models.Transformer(cfg, models.init_params(
            models.param_spec(cfg),
            torch.Generator(device=device).manual_seed(0), device))
        _sync(torch, device)
        init_s = time.perf_counter() - t0
        param_bytes = None if before is None \
            else requested_bytes(torch, device) - before
        n_params = sum(p.numel() for p in model.parameters())
        log(f"[families] {arch} ({cfg.family}, {depth}): {n_params:,} f32 "
            f"parameters ({n_params * 4 / 1e9:.2f} GB) drawn on the device "
            f"in {init_s:.1f} s")

        # -- the main path: serve() with the counters zeroed --------------
        port.reset_launches()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        toks, stats = port.serve(cfg, batch=batch, prompt_len=prompt_len,
                                 gen=gen, device=device, params=model)
        _sync(torch, device)
        launches = port.launches()
        peak = torch.cuda.max_memory_allocated() if on_card else None
        want = flash_calls(port, cfg)
        log(f"[families] {arch} serve batch={batch} prompt={prompt_len} "
            f"gen={gen}: launches {launches}, want {want} flash; prefill "
            f"{stats['prefill_s'] * 1e3:.1f} ms, decode "
            f"{stats['tok_per_s']:.1f} tok/s; peak {nbytes(peak)}; sample "
            f"{toks[0, :8].tolist()}")
        check(launches["flash_attention_fwd"] == want
              and launches["flash_attention_fwd_tc"] == want,
              f"{arch}: flash launched {launches} in serve, want {want} "
              f"(one an attention call of the prefill), all bf16")
        check(tuple(toks.shape) == (batch, gen) and toks.dtype == torch.int32
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"{arch}: served tokens {tuple(toks.shape)} {toks.dtype} or "
              f"out of range")
        total += launches["flash_attention_fwd"]

        # -- times: median of 3 serve calls -------------------------------
        runs = [port.serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                           device=device, params=model)[1] for _ in range(3)]
        prefill_ms = statistics.median(r["prefill_s"] for r in runs) * 1e3
        tok_s = statistics.median(r["tok_per_s"] for r in runs)

        # -- the dry-run's cell: resident bytes, one prefill's peak --------
        with torch.inference_mode():
            before = requested_bytes(torch, device)
            pb = {"tokens": port.batch_at(
                0, global_batch=batch, seq_len=prompt_len,
                vocab_size=cfg.vocab_size).to(device),
                **port.lm_serve.frontend_embeds(cfg, batch, device)}
            resident = None if before is None \
                else param_bytes + requested_bytes(torch, device) - before
            with PeakBytes(torch, device) as pk:
                models.forward_prefill(model, cfg, pb)
            del pb
        dry_cells[f"families {arch} prefill"] = {
            "cfg": cfg, "kind": "prefill", "batch": batch,
            "seq": prompt_len, "resident": resident,
            "peak": None if resident is None else resident + pk.peak,
            "peak_allocated_above": pk.peak_allocated}

        # -- checks -------------------------------------------------------
        moe = cfg.family == "moe"
        vis = cfg.vision_tokens if cfg.family == "vlm" else 0
        extras = port.lm_serve.frontend_embeds(cfg, batch, device)
        flips = {}
        with torch.inference_mode():
            prompt = port.batch_at(0, global_batch=batch, seq_len=prompt_len,
                                   vocab_size=cfg.vocab_size).to(device)
            b = {"tokens": prompt, **extras}
            with FlashCapture(port) as cap, RouteRecorder(port, moe) as rk:
                lg_k = family_logits(port, model, cfg, b, "chunked",
                                     prompt_len if moe else 1)
            if moe:
                # the routing of the kernel run, the plain run and naive
                # attention's; the logits of the tokens whose routing
                # agrees are reported (attention couples them to the
                # tokens that flipped), and the plain run is held against
                # the kernel run with the kernel run's routing replayed
                with RouteRecorder(port, True) as rp:
                    lg_free = family_logits(port, model, cfg, b, "plain",
                                            prompt_len)
                with RouteRecorder(port, True) as rn:
                    family_logits(port, model, cfg, b, "naive")
                _, flips["floor_naive_vs_plain"], _ = rn.compare(rp)
                agree, flips["kernel_vs_plain"], \
                    flips["kernel_vs_plain_by_layer"] = rk.compare(rp)
                flips["tokens_agreeing"] = int(agree.sum())
                e_held = logit_diff(torch, lg_k[agree], lg_free[agree])
                flips["agreeing_tokens_logits"] = {
                    k: e_held[k] for k in ("max", "mean", "argmax_ties",
                                           "argmax_other")}
                del lg_free, e_held, rp, rn
                with RouteReplay(port, rk.choices(cfg.num_layers)):
                    lg_p = family_logits(port, model, cfg, b, "plain")
                with RouteReplay(port, rk.choices(cfg.num_layers)):
                    lg_n = family_logits(port, model, cfg, b, "naive")
                lg_k = lg_k[:, -1:]
            else:
                lg_p = family_logits(port, model, cfg, b, "plain")
                lg_n = family_logits(port, model, cfg, b, "naive")
            e_floor = family_diff(torch, lg_n, lg_p)
            e_plain = family_diff(torch, lg_k, lg_p, e_floor)
            del lg_k, lg_p, lg_n

            # decode against prefill at every decoded position; the MoE
            # at a capacity that drops nothing (a decode step is its own
            # group), its prefill replaying the decode run's routing
            dcfg = dataclasses.replace(
                cfg, capacity_factor=cfg.num_experts
                / cfg.num_experts_per_tok) if moe else cfg
            full = port.batch_at(1, global_batch=batch,
                                 seq_len=prefix + steps,
                                 vocab_size=cfg.vocab_size).to(device)
            fb = {"tokens": full, **extras}
            lg_d = []
            with RouteRecorder(port, moe) as rd:
                _, cache = models.forward_prefill(
                    model, dcfg, {"tokens": full[:, :prefix], **extras})
                cache = port.lm_serve.pad_cache_for_decode(
                    dcfg, cache, prefix + steps + vis, batch)
                for t in range(prefix, prefix + steps):
                    lg, cache = models.forward_decode(
                        model, dcfg, full[:, t:t + 1], cache)
                    lg_d.append(lg)
            del cache
            lg_d = torch.cat(lg_d, dim=1)                  # (B, steps, V)
            if moe:
                with RouteRecorder(port, True) as rf:
                    family_logits(port, model, dcfg, fb, "chunked")
                _, flips["decode_vs_prefill"], \
                    flips["decode_vs_prefill_by_layer"] = rd.compare(
                        rf, last=steps)
                with RouteReplay(port, rd.choices(cfg.num_layers)):
                    lg_f = family_logits(port, model, dcfg, fb, "chunked",
                                         steps)
                bound_f = FAMILY_FLOOR_FACTOR * flips["floor_naive_vs_plain"]
                log(f"[families] {arch} routing: {flips} (bound "
                    f"{FAMILY_FLOOR_FACTOR} x the floor = {bound_f:.4f})")
                for what in ("kernel_vs_plain", "decode_vs_prefill"):
                    check(flips[what] <= bound_f,
                          f"{arch}: routing flips {what} {flips[what]:.4f} "
                          f"beyond {bound_f:.4f}")
                del rk, rd, rf
            else:
                lg_f = family_logits(port, model, dcfg, fb, "chunked", steps)
            e_dec = family_diff(torch, lg_d, lg_f, e_floor)
            del lg_d, lg_f
            _sync(torch, device)
        replayed = " (kernel run's routing replayed)" if moe else ""
        log(f"[families] {arch} logits, the floor: prefill naive vs "
            f"plain{replayed}: "
            f"{ {k: v for k, v in e_floor.items() if k != 'top2_gap'} }")
        errs = {"prefill kernel vs plain" + replayed: e_plain,
                f"decode vs prefill ({prefix} + {steps} tokens, every "
                f"decoded position)": e_dec}
        for what, e in errs.items():
            log(f"[families] {arch} logits, {what}: "
                f"{ {k: v for k, v in e.items() if k != 'top2_gap'} }")
            tol_max, tol_mean = e["bounds"]
            check(e["finite"], f"{arch} {what}: logits not finite")
            check(e["max"] <= tol_max and e["mean"] <= tol_mean
                  and e["argmax_other"] == 0,
                  f"{arch} {what}: {e} beyond max {tol_max}, mean "
                  f"{tol_mean} or argmax")

        # -- the kernel at every shape the prefill gave it ----------------
        for (qs, ks, kw), (q, k, v) in cap.seen.items():
            kw = dict(kw)
            got = port.flash(q, k, v, **kw)
            want_o = port.flash_attention_ref(q, k, v, **kw)
            parity.one(got, want_o, "bfloat16", f"{arch} {qs} x {ks} {kw}")
            err = float((got.float() - want_o.float()).abs().max())
            check(not kw.get("window") and not kw.get("softcap"),
                  f"{arch}: flash options {kw}")
            t = flash_times(port, device, q, k, v, batch,
                            causal=kw.get("causal", True))
            shapes.append({"arch": arch, "q": list(qs), "kv": list(ks),
                           "causal": kw.get("causal", True),
                           "max_abs_err": err, **t})
            log(f"[times] flash_attention_fwd {arch} {qs} x {ks} bf16 "
                f"causal={kw.get('causal', True)}: kernel {t['ms']:.4f} ms  "
                f"plain {t['plain_ms']:.4f} ms  bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']})  sdpa {t['library_ms']:.4f} ms; "
                f"max_abs_err {err:.3e}")
            del got, want_o
        del cap
        prof = device_profile(port, cfg, model, batch, prompt_len, device,
                              gen=profile_gen)
        cells[arch] = {
            "family": cfg.family, "depth": depth, "params": n_params,
            "batch": batch, "prompt": prompt_len, "gen": gen,
            "vision_tokens": vis, "init_s": init_s,
            "flash_launches": launches["flash_attention_fwd"],
            "prefill_ms": prefill_ms, "decode_tok_per_s": tok_s,
            "prefill_runs_ms": [r["prefill_s"] * 1e3 for r in runs],
            "tok_per_s_runs": [r["tok_per_s"] for r in runs],
            "peak_bytes": peak, "routing_flips": flips or None,
            "logit_floor": {k: e_floor[k] for k in ("max", "mean",
                                                    "max_logit")},
            "logit_err": {k: {"max": e["max"], "mean": e["mean"],
                              "argmax_ties": e["argmax_ties"],
                              "max_logit": e["max_logit"],
                              "bounds": e["bounds"]}
                          for k, e in errs.items()},
            "profile": {k: prof[k] for k in ("device_busy_share",
                                             "top_kernels")}}
        log(f"[times] llm {arch} batch={batch} prompt={prompt_len} gen={gen}:"
            f" prefill {prefill_ms:.2f} ms, decode {tok_s:.1f} tok/s, peak "
            f"{nbytes(peak)}")
        del model, toks
        if on_card:
            torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    out = {"launches": total, "cells": cells, "shapes": shapes,
           "parity_err": parity.err["bfloat16"], "secs": secs}
    log("[families] " + json.dumps(out))
    log(f"[families done] {secs:.1f} s")
    out["dryrun_cells"] = dry_cells
    return out


# ---------------------------------------------------------------------------
# LM training of the other families: flash_attention_fwd with its lse at
# their training shapes
# ---------------------------------------------------------------------------

def train_flash_calls(port: Port, cfg, accum: int = 1) -> int:
    """flash_attention_fwd launches of one training step: a stacked
    layer's attention call runs in its forward and again in its remat
    recompute (self and cross attention: 4 a decoder block; 2 an encoder
    layer), a shared-attention call once (it is not rematerialised, as
    in the reference), a mamba layer never."""
    per = {"attn": 2, "moe": 2, "xattn": 4, "mamba": 0}
    n = sum(1 if s.kind == "shared_attn" else per[s.kind] * s.count
            for s in port.models.build_plan(cfg))
    if cfg.family == "audio":
        n += 2 * cfg.encoder_layers
    return n * accum


class RouteTape:
    """Within the context, each ``moe.route`` call records its top-k
    experts (``choices`` None) or takes the next of ``choices`` (with its
    own probabilities as gates): one run's routing, forward and remat
    recompute alike, replayed in another."""

    def __init__(self, port: Port, choices: list | None = None):
        self.port, self.choices, self.calls, self.i = port, choices, [], 0

    def __enter__(self):
        moe = self.port.model_moe
        self.orig = orig = moe.route

        def tape(router, x, E, K, C, choices=None):
            if self.choices is None:
                r = orig(router, x, E, K, C)
                self.calls.append(r["gate_idx"].detach().clone())
                return r
            self.i += 1
            return orig(router, x, E, K, C, choices=self.choices[self.i - 1])

        moe.route = tape
        return self

    def __exit__(self, *exc):
        self.port.model_moe.route = self.orig
        if exc[0] is None and self.choices is not None:
            check(self.i == len(self.choices),
                  f"route replayed {self.i} of {len(self.choices)} calls")


def lse_times(port: Port, device, q, k, v, batch: int, causal: bool) -> dict:
    """flash_times (the forward alone, beside ref.py, SDPA and its bound)
    plus the kernel and ref.py with ``return_lse=True`` and the bound of
    that call (the lse's f32 row written too)."""
    torch = port.torch
    t = flash_times(port, device, q, k, v, batch, causal=causal)
    bh, sq, d = q.shape
    t["lse_bound_ms"], t["lse_bound_by"] = flash_bound(
        bh, sq, k.shape[1], d, q.element_size(), causal,
        extra_bytes=4 * bh * sq)
    t["lse_ms"] = kernel_ms(torch, device, lambda: port.flash(
        q, k, v, causal=causal, return_lse=True))
    t["lse_plain_ms"] = kernel_ms(torch, device, lambda: port.
                                  flash_attention_ref(q, k, v, causal=causal,
                                                      return_lse=True),
                                  reps=5)
    return t


def run_train_families(port: Port, device, families=TRAIN_FAMILIES,
                       steps: int = TRAIN_FAMILY_STEPS) -> dict:
    """The train-families phase (see the module docstring): each family
    at its depth, step 0 through the kernel against the plain and naive
    forwards (the MoE's routing replayed), the kernel's lse at every
    shape the step gave it, then ``launch/train.py::train`` for
    ``steps`` steps with the launch counters zeroed around it."""
    torch, st, tr, tree = port.torch, port.train_steps, port.trainer, \
        port.tree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_phase = time.perf_counter()
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    parity = FlashParity(port, device)
    cells, shapes, dry_cells, total = {}, [], {}, 0
    for arch, batch, seq, keep in families:
        full = port.arch_registry.get_arch(arch)
        cfg = full if keep is None else dataclasses.replace(
            full, num_layers=keep)
        depth = ("full depth" if keep is None
                 else f"{keep} of {full.num_layers} layers")
        tc = st.default_train_config(cfg)
        t_arch = time.perf_counter()

        # -- step 0: resident state, then the kernel forward against the
        # plain forward, naive attention's gap to plain the floor --------
        before = requested_bytes(torch, device)
        params, opt = tr.build_state(cfg, tc, device)
        b0 = tr.next_batch(port.TokenStream(
            global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size,
            seed=tc.seed), cfg, tc, device)
        b0 = {k: v.to(device) for k, v in b0.items()}
        resident = None if before is None \
            else requested_bytes(torch, device) - before
        n_params = sum(t.numel() for t in tree.leaves(params))
        del opt
        first = [t.detach().flatten()[:4096].clone()
                 for t in tree.leaves(params)]
        vis = (f" + {cfg.vision_tokens} vision" if cfg.family == "vlm"
               else "")
        log(f"[train-families] {arch} ({cfg.family}, {depth}): "
            f"{n_params:,} f32 parameters; batch {batch} x {seq}{vis}"
            f"; default_train_config grad_accum {tc.grad_accum}; resident "
            f"params + m + v + batch {nbytes(resident)}")
        attention = cfg.family != "ssm"
        gaps = floor = None
        loss_gap = loss_floor = None
        if attention:
            moe = cfg.family == "moe"
            with FlashCapture(port) as cap, RouteTape(port) as tape:
                lk, mk, gk = st.value_and_grad(cfg, params, b0)
            with RouteTape(port, tape.calls if moe else None):
                lp, _, gp = st.value_and_grad(cfg, params, b0, impl="plain")
            gaps = grad_gaps(torch, tree, gk, gp)
            del gk
            with RouteTape(port, tape.calls if moe else None):
                ln, _, gn = st.value_and_grad(cfg, params, b0, impl="naive")
            floor = grad_gaps(torch, tree, gn, gp)
            del gn, gp
            loss_gap = abs(float(lk) - float(lp))
            loss_floor = abs(float(ln) - float(lp))
            loss_tol = max(TRAIN_LOSS_TOL, TRAIN_GRAD_FACTOR * loss_floor)
            replayed = (f" (the kernel run's routing, {len(tape.calls)} "
                        f"route calls, replayed)" if moe else "")
            metrics = {k: round(float(v), 6) for k, v in mk.items()}
            log(f"[train-families] {arch} step 0, kernel vs plain forward"
                f"{replayed}: loss {float(lk):.6f} vs {float(lp):.6f} (gap "
                f"{loss_gap:.3e}; naive {float(ln):.6f}, floor "
                f"{loss_floor:.3e}); metrics {metrics}"
                f"; gradient leaves' relative norm gaps "
                f"{[round(x, 5) for x in gaps]}, naive vs plain (the floor)"
                f" {[round(x, 5) for x in floor]}")
            check(loss_gap <= loss_tol, f"{arch}: step-0 loss gap "
                  f"{loss_gap} beyond {loss_tol}")
            check(all(a <= TRAIN_GRAD_FACTOR * b for a, b in zip(gaps, floor)),
                  f"{arch}: gradient gaps {gaps} beyond {TRAIN_GRAD_FACTOR}"
                  f" x the floor {floor}")
            del tape

            # -- the kernel's lse at every shape the step gave it --------
            for (qs, ks, kw), (q, k, v) in cap.seen.items():
                kw = dict(kw)
                check(kw.pop("return_lse", False) and not kw.get("window")
                      and not kw.get("softcap"),
                      f"{arch}: flash options {kw} in training")
                what = f"{arch} train {qs} x {ks} {kw}"
                parity.lse(q, k, v, what, **kw)
                got = port.flash(q, k, v, **kw)
                want_o = port.flash_attention_ref(q, k, v, **kw)
                parity.one(got, want_o, "bfloat16", what)
                err = float((got.float() - want_o.float()).abs().max())
                _, lse = port.flash(q, k, v, return_lse=True, **kw)
                _, lse_ref = port.flash_attention_ref(q, k, v,
                                                      return_lse=True, **kw)
                lse_err = float((lse - lse_ref).abs().max())
                causal = kw.get("causal", True)
                t = lse_times(port, device, q, k, v, batch, causal)
                shapes.append({"arch": arch, "q": list(qs), "kv": list(ks),
                               "causal": causal, "max_abs_err": err,
                               "lse_max_abs_err": lse_err, **t})
                log(f"[times] flash_attention_fwd lse {arch} {qs} x {ks} "
                    f"bf16 causal={causal}: kernel with lse "
                    f"{t['lse_ms']:.4f} ms (without {t['ms']:.4f})  plain "
                    f"{t['lse_plain_ms']:.4f} ms  bound "
                    f"{t['lse_bound_ms']:.4f} ms ({t['lse_bound_by']})  "
                    f"sdpa {t['library_ms']:.4f} ms; o max_abs_err "
                    f"{err:.3e}, lse {lse_err:.3e} ({card})")
                del got, want_o, lse, lse_ref
            del cap
        else:
            log(f"[train-families] {arch}: no attention, so no kernel "
                f"forward to hold against the plain one at step 0")
        del params, b0
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

        # -- the main path: train() with the counters zeroed --------------
        port.reset_launches()
        hist = []
        t0 = time.perf_counter()
        with PeakBytes(torch, device) as pk:
            p_end, _, _ = tr.train(cfg, dataclasses.replace(
                tc, checkpoint_every=0, checkpoint_dir=str(
                    TRAIN_DIR / "families")), batch=batch, seq=seq,
                steps=steps, resume=False, history=hist, device=device,
                log_every=1)
        wall = time.perf_counter() - t0
        launches = port.launches()
        recs = [h for h in hist if "step" in h]
        losses = [h["loss"] for h in recs]
        norms = [h["grad_norm"] for h in recs]
        step_ms = [h["s"] * 1e3 for h in recs]
        n_leaves = len(first)
        changed = sum(int(not torch.equal(a, b.detach().flatten()[:4096]))
                      for a, b in zip(first, tree.leaves(p_end)))
        del p_end, first
        want = steps * train_flash_calls(port, cfg, tc.grad_accum)
        log(f"[train-families] {arch} train() {steps} steps in {wall:.1f} s:"
            f" losses {[round(x, 4) for x in losses]}, grad norms "
            f"{[round(x, 3) for x in norms]}; launches {launches}, want "
            f"{want} flash; {changed} of {n_leaves} parameter leaves "
            f"changed")
        check(len(recs) == steps and all(np.isfinite(losses + norms)),
              f"{arch}: losses {losses}, grad norms {norms}")
        check(launches["flash_attention_fwd"] == want
              and launches["flash_attention_fwd_tc"] == want,
              f"{arch}: train launched flash {launches}, want {want} (a "
              f"stacked layer's attention in its forward and recompute, a "
              f"shared call once), all bf16")
        check(changed == n_leaves,
              f"{arch}: {changed} parameter leaves changed in {steps} steps")
        med = statistics.median(step_ms[1:]) if steps > 1 else step_ms[0]
        tokens_s = batch * seq / (med / 1e3)
        log(f"[times] train {arch} ({depth}) batch={batch} seq={seq}: "
            f"{med:.1f} ms a step (median of steps 1-{steps - 1}; all "
            f"{[round(x, 1) for x in step_ms]}), {tokens_s:.0f} text "
            f"tokens/s, peak {nbytes(pk.peak)} requested / "
            f"{nbytes(pk.peak_allocated)} allocated ({card})")
        total += launches["flash_attention_fwd"]
        cells[arch] = {
            "family": cfg.family, "depth": depth, "params": n_params,
            "batch": batch, "seq": seq, "grad_accum": tc.grad_accum,
            "losses": losses, "grad_norms": norms, "step_ms": step_ms,
            "ms_a_step": med, "tokens_per_s": tokens_s,
            "peak_requested": pk.peak, "peak_allocated": pk.peak_allocated,
            "resident_bytes": resident,
            "flash_launches": launches["flash_attention_fwd"],
            "flash_launches_a_step": want // steps,
            "loss_gap_plain": loss_gap, "loss_gap_floor": loss_floor,
            "grad_gaps_plain": gaps, "grad_gaps_floor": floor,
            "secs": time.perf_counter() - t_arch, "card": card}
        dry_cells[f"train-families {arch}"] = {
            "cfg": cfg, "kind": "train", "batch": batch, "seq": seq,
            "tc": tc, "resident": resident, "peak": pk.peak,
            "peak_allocated_above": pk.peak_allocated}
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    out = {"launches": total, "cells": cells, "lse_shapes": shapes,
           "parity_err": parity.err["bfloat16"], "lse_err": parity.lse_err,
           "secs": secs}
    log("[train-families] " + json.dumps(out))
    log(f"[train-families done] {secs:.1f} s")
    out["dryrun_cells"] = dry_cells
    return out



# ---------------------------------------------------------------------------
# the sharded LM steps: DTensor plans over gloo ranks sharing the card
# ---------------------------------------------------------------------------

def gloo_probe_main(op: str, d: Path) -> int:
    """One probe of the [sharded] phase (``chip_smoke.py --gloo-probe
    OP``): ``OP`` of torch's functional collectives on a CUDA tensor in
    a one-rank gloo group.  Exit code 0 when it returned."""
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{d}/probe-{op}",
                            rank=0, world_size=1)
    try:
        x = torch.arange(8, dtype=torch.float32, device="cuda")
        c10d, name = torch.ops._c10d_functional, dist.group.WORLD.group_name
        call = {"all_gather_into_tensor": lambda: c10d.all_gather_into_tensor(
                    x, 1, name),
                "reduce_scatter_tensor": lambda: c10d.reduce_scatter_tensor(
                    x, "sum", 1, name),
                "all_reduce": lambda: c10d.all_reduce(x, "sum", name),
                "all_to_all_single": lambda: c10d.all_to_all_single(
                    x, [8], [8], name)}[op]
        c10d.wait_tensor(call())
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    return 0


def start_gloo_probes(port: Port, d: Path) -> dict:
    """Start one probe process a collective DTensor issues
    (``actctx.FUNCOL_OPS``), each in a one-rank gloo group on a CUDA
    tensor: op -> process."""
    return {op: subprocess.Popen(
        [sys.executable, str(HERE / "chip_smoke.py"), "--gloo-probe", op,
         "--sharded-dir", str(d)], cwd=HERE, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL) for op in port.actctx.FUNCOL_OPS}


def gloo_probe_results(procs: dict) -> dict:
    """op -> "returned" or how its process ended (a signal's name)."""
    import signal
    out = {}
    for op, p in procs.items():
        try:
            rc = p.wait(timeout=SHARDED_PROBE_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            out[op] = f"still running after {SHARDED_PROBE_S} s"
            continue
        out[op] = ("returned" if rc == 0 else signal.Signals(-rc).name
                   if rc < 0 else f"exit code {rc}")
    return out


def sharded_prompt(port: Port, cfg, batch: int, seq: int, device):
    """The [sharded] phase's (batch, seq + SHARDED_DECODE) tokens: a
    prompt of ``seq`` and the tokens its decode steps take."""
    return port.batch_at(2, global_batch=batch,
                         seq_len=seq + SHARDED_DECODE,
                         vocab_size=cfg.vocab_size).to(device)


def decode_logits(port: Port, cfg, model, prompt, seq: int, cache,
                  lay=lambda t: t) -> list:
    """The logits of SHARDED_DECODE decode steps from ``cache`` on the
    tokens of ``prompt`` after its first ``seq``, each laid out by
    ``lay``."""
    out = []
    for t in range(seq, seq + SHARDED_DECODE):
        lg, cache = port.models.forward_decode(model, cfg,
                                               lay(prompt[:, t:t + 1]), cache)
        out.append(lg)
    return out


def family_cfg(port: Port, arch: str, layers: int):
    """``arch`` at full width with ``layers`` layers (the audio
    family's encoder cut to as many)."""
    cfg = port.arch_registry.get_arch(arch)
    cut = {"num_layers": layers}
    if cfg.family == "audio":
        cut["encoder_layers"] = layers
    return dataclasses.replace(cfg, **cut)


def family_inputs(port: Port, cfg, batch: int, seq: int, device) -> dict:
    """The [sharded] prompt of ``seq`` text tokens and the two
    decode steps' (``sharded_prompt``), and the stub frontends'
    embeddings (``launch/serve.py::frontend_embeds``)."""
    return {"prompt": sharded_prompt(port, cfg, batch, seq, device),
            **port.lm_serve.frontend_embeds(cfg, batch, device)}


def family_ctx(cfg, seq: int) -> int:
    """The decode cache's positions: the prompt (the vlm's vision tokens
    included) and SHARDED_CTX_PAD more."""
    return seq + SHARDED_CTX_PAD + (cfg.vision_tokens if cfg.family == "vlm"
                                    else 0)


def moe_groups(kind: str, rank: int, batch: int, seq: int,
               group_size: int = 256) -> list:
    """The one-process routing groups (``moe.group_tokens``' order: a
    row's groups in turn) that rank ``rank`` of a (2, 2) mesh routes in
    a sharded ``kind`` step, in its order (``models/moe.py::
    _apply_moe_sharded``).  Train: where half a row holds whole groups,
    rank (i, j) routes the j-th half of each of data rank i's rows, else
    the rows are whole and the model ranks share the data rank's groups
    out; prefill and decode (one token a group): the latter."""
    i, j = divmod(rank, 2)
    gs = min(group_size, 1 if kind == "decode" else seq)
    per_row, rows = (1 if kind == "decode" else seq // gs), batch // 2
    if kind == "train" and (seq // 2) % gs == 0:
        half = per_row // 2
        return [(i * rows + a) * per_row + j * half + c
                for a in range(rows) for c in range(half)]
    n = rows * per_row // 2
    return [i * rows * per_row + j * n + k for k in range(n)]


def sharded_rank_main(rank: int, d: Path) -> int:
    """One rank of the [sharded] phase (``chip_smoke.py --sharded-rank
    R``), started with the phase; for each run of the job in turn, once
    the parent's ``go_<arch>`` file is there (its one-process runs of
    the arch done): the bytes this rank holds once ``build_state`` and
    the batch's shard are drawn (requested bytes of the caching
    allocator around them, and the local shards' bytes);
    ``launch/train.py::train`` on the mesh (the MoE with the
    one-process run's routing replayed on its own groups), the flash
    wrapper's calls recorded by shape and its launches counted; this
    rank's shards of the trained parameters written to
    ``shards_<arch>_{R}.pt``; for an ``elastic`` run, the trained
    parameters saved from the mesh and restored onto (world, 1), each
    leaf compared with the saved one; then prefill and two decode steps
    on the mesh from the seeded initial weights under the inference
    policy, the decode cache the prefill's own (gathered, padded, laid
    out by ``cache_shardings``; the MoE first prefills with its own
    routing, recorded, then with the one-process routing replayed),
    launches counted around them; the run's peak device bytes.  Writes
    its record of each run to ``rank{R}_<arch>.json`` once the run is
    done (the parent checks it while the ranks go on), rank 0 the logits
    to ``serve_<arch>.pt``, each rank its MoE routing to
    ``routes_<arch>_{R}.pt``.

    cuBLAS runs with full-precision reductions, as this script's
    one-process LM runs do: with bf16 reductions allowed, a GEMM's
    split-K can depend on its rows, and internvl2's final-norm gradient
    (its odd vocab's logits) moved by 17% between a whole batch and a
    data rank's half of it."""
    from torch.distributed.tensor.experimental import implicit_replication
    port = Port()
    torch, st, tr, P = port.torch, port.train_steps, port.trainer, \
        port.params
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    job = json.loads((d / "job.json").read_text())
    device = torch.device(job["device"])
    on_card = device.type == "cuda"
    mesh = port.mesh.make_local_mesh(*job["mesh"])
    world = mesh.size
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"file://{d}/rdzv",
                            rank=rank, world_size=world)
    staged = port.actctx.staged_backend("gloo", device.type)

    def staging():
        return port.actctx.StagedCollectives() if staged \
            else contextlib.nullcontext()

    try:
        # a rank still running near the parent's deadline writes its
        # stacks into its log and exits (a hung collective shows where)
        faulthandler.dump_traceback_later(SHARDED_TIMEOUT_S - 20, exit=True)
        dm = port.mesh.device_mesh(mesh, device.type)
        for run in job["runs"]:
            cfg = port.ModelConfig(**run["cfg"])
            tc = port.TrainConfig(**run["tc"])
            arch, batch, seq, steps = cfg.name, run["batch"], run["seq"], \
                run["steps"]
            # the parent's own runs of the arch come first
            while not (d / f"go_{arch}").exists():
                time.sleep(0.05)
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            moe = cfg.family == "moe"
            tape = torch.load(d / f"routes_{arch}.pt") if moe else None
            spec = port.models.param_spec(cfg)
            sh = P.param_shardings(spec, mesh)
            shape = port.ShapeConfig("sharded", "train", seq, batch)
            before = requested_bytes(torch, device)
            params, opt = tr.build_state(cfg, tc, device, sh, dm)
            full = tr.next_batch(port.TokenStream(
                global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size,
                seed=tc.seed), cfg, tc, device)
            b = P.distribute(full, st.batch_shardings(cfg, shape, mesh,
                                                      full), dm)
            del full
            resident = None if before is None \
                else requested_bytes(torch, device) - before
            local = sum(st.tree_bytes(t) for t in (params, opt, b))
            del params, opt, b

            # each flash forward's (B*H, S, D): the wrapper's calls on the
            # card, the plain forward FlashAttention runs on CPU tensors
            calls = []
            mod, name = (port.flash_ops, "flash_attention_fwd") \
                if on_card else (port.model_layers, "_flash_fwd_impl")
            orig = getattr(mod, name)

            def record(q, k, v, **kw):
                calls.append(tuple(q.shape) if q.dim() == 3 else
                             (q.shape[0] * q.shape[2], q.shape[1],
                              q.shape[3]))
                return orig(q, k, v, **kw)

            pick = moe_groups("train", rank, batch, seq)
            replay = RouteTape(port, [c[pick].to(device)
                                      for c in tape["train"]]) \
                if moe else contextlib.nullcontext()
            setattr(mod, name, record)
            port.reset_launches()
            hist = []
            t0 = time.perf_counter()
            try:
                with replay:
                    params, _, _ = tr.train(
                        cfg, tc, batch=batch, seq=seq, steps=steps,
                        device=device, mesh=mesh, resume=False,
                        log_every=steps, history=hist)
            finally:
                setattr(mod, name, orig)
            rec = {"resident": resident, "local_bytes": local,
                   "launches": port.launches()["flash_attention_fwd"],
                   "flash_shapes": sorted(set(calls)),
                   "flash_calls": len(calls),
                   "steps": [h for h in hist if "step" in h],
                   "staged": next((h["staged"] for h in hist
                                   if "staged" in h), {}),
                   "train_s": time.perf_counter() - t0}
            # this rank's own shards of the trained leaves, as they lie
            t0 = time.perf_counter()
            torch.save([t.to_local().cpu() for t in port.tree.leaves(params)],
                       d / f"shards_{arch}_{rank}.pt")
            rec["shards_s"] = time.perf_counter() - t0
            if run["elastic"]:
                # saved from this mesh, restored onto (world, 1)
                with staging():
                    t0 = time.perf_counter()
                    port.checkpoint.save(d / f"ckpt_{arch}", steps, params)
                    rec["save_s"] = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    back = port.checkpoint.restore(
                        d / f"ckpt_{arch}", steps, params,
                        P.param_shardings(spec, port.mesh.make_local_mesh(
                            world, 1)))
                    rec["restore_s"] = time.perf_counter() - t0
                    rec["restored_equal"] = all(
                        bool(torch.equal(a.full_tensor(), r.full_tensor()))
                        for a, r in zip(port.tree.leaves(params),
                                        port.tree.leaves(back)))
                    rec["restored_layout"] = str(
                        port.tree.leaves(back)[0].placements)
                del back
            del params

            # prefill and decode on the mesh from the initial weights
            params, _ = tr.build_state(cfg, tc, device, sh, dm)
            pshape = port.ShapeConfig("sharded", "prefill", seq, batch)
            inp = family_inputs(port, cfg, batch, seq, device)
            prompt = inp.pop("prompt")

            def lay(bt):
                return P.distribute(bt, st.batch_shardings(
                    cfg, pshape, mesh, bt), dm)

            infer = port.actctx.make_infer_policy(
                mesh, batch_axes=port.mesh.batch_axes(mesh, batch))
            ctx = family_ctx(cfg, seq)
            port.reset_launches()
            own = RouteTape(port) if moe else contextlib.nullcontext()
            first = {"tokens": prompt[:, :seq], **inp}
            t0 = time.perf_counter()
            with staging() as sc, port.actctx.policy(infer), \
                    torch.no_grad(), implicit_replication():
                model = port.models.Transformer(cfg, params)
                with own:                # the MoE's own routing, recorded
                    lg, cache = port.models.forward_prefill(model, cfg,
                                                            lay(first))
                rec["prefill_launches"] = \
                    port.launches()["flash_attention_fwd"]
                if moe:
                    torch.save([c.cpu() for c in own.calls],
                               d / f"routes_{arch}_{rank}.pt")
                    # the first num_layers calls are the prefill's
                    L = cfg.num_layers
                    ppick = moe_groups("prefill", rank, batch, seq)
                    dpick = moe_groups("decode", rank, batch, seq)
                    with RouteTape(port, [
                            c[ppick if n < L else dpick].to(device)
                            for n, c in enumerate(tape["serve"])]):
                        lg, cache = port.models.forward_prefill(
                            model, cfg, lay(first))
                        logits = family_decode(port, cfg, model, lg, cache,
                                               prompt, seq, ctx, mesh, dm,
                                               lay)
                else:
                    logits = family_decode(port, cfg, model, lg, cache,
                                           prompt, seq, ctx, mesh, dm, lay)
                rec["serve_staged"] = dict(sc.staged) if staged else {}
            rec["serve_s"] = time.perf_counter() - t0
            rec["serve_launches"] = port.launches()["flash_attention_fwd"]
            del params, model, cache
            if rank == 0:
                torch.save(logits, d / f"serve_{arch}.pt")
            rec["peak"] = torch.cuda.max_memory_allocated(device) \
                if on_card else None
            tmp = d / f".rank{rank}_{arch}.json"
            tmp.write_text(json.dumps(rec))
            tmp.rename(d / f"rank{rank}_{arch}.json")
            if on_card:
                torch.cuda.empty_cache()
    finally:
        faulthandler.cancel_dump_traceback_later()
        dist.destroy_process_group()
    return 0


def assemble(torch, shards: list, i: int, sharding, mesh_shape) -> object:
    """Leaf ``i`` whole from every rank's own shard of it (``shards[r][i]``,
    rank r at row-major position r of ``mesh_shape``), as
    ``models/params.py::place`` split it: each mesh dim in turn splits
    the dim its placement names."""
    pl = sharding.placements()
    coords = [np.unravel_index(r, mesh_shape) for r in range(len(shards))]
    # the ranks that differ only on mesh dims that replicate the leaf hold
    # the same shard: keep the first, then join along each split dim,
    # innermost mesh dim first
    keep = {tuple(c[m] if pl[m].is_shard() else 0
                  for m in range(len(mesh_shape))): shards[r][i]
            for r, c in reversed(list(enumerate(coords)))}
    for m in reversed(range(len(mesh_shape))):
        if not pl[m].is_shard():
            continue
        joined = {}
        for c in sorted(keep):
            if c[m] == 0:
                parts = [keep[c[:m] + (j,) + c[m + 1:]]
                         for j in range(mesh_shape[m])]
                joined[c] = torch.cat(parts, dim=pl[m].dim)
        keep = joined
    (whole,) = keep.values()
    return whole.float()


def family_decode(port: Port, cfg, model, lg, cache, prompt, seq: int,
                  ctx: int, mesh, dm, lay) -> list:
    """The prefill's last logits and SHARDED_DECODE decode steps' on the
    mesh, gathered: the prefill's cache gathered, padded to ``ctx``
    positions and laid out by ``cache_shardings``, each step's token
    laid out by ``lay``."""
    st, P = port.train_steps, port.params
    batch = prompt.shape[0]
    full = port.tree.tree_map(
        lambda t: t.full_tensor() if port.actctx.is_dtensor(t) else t,
        cache)
    cache = P.distribute(port.lm_serve.pad_cache_for_decode(
        cfg, full, ctx, batch), st.cache_shardings(cfg, mesh, batch, ctx),
        dm)
    del full
    out = [lg] + decode_logits(port, cfg, model, prompt, seq, cache,
                               lambda t: lay({"tokens": t})["tokens"])
    return [x.full_tensor().float().cpu() for x in out]


def family_serve_one(port: Port, cfg, params, inp: dict, seq: int,
                     impl: str) -> list:
    """One process's prefill of ``inp``'s prompt and SHARDED_DECODE
    decode steps through ``impl``'s attention: the prefill's last
    logits and each step's, on the CPU."""
    torch, models = port.torch, port.models
    prompt = inp["prompt"]
    extras = {k: v for k, v in inp.items() if k != "prompt"}
    model = models.Transformer(cfg, params)
    with torch.no_grad():
        lg, cache = models.forward_prefill(
            model, cfg, {"tokens": prompt[:, :seq], **extras}, impl=impl)
        cache = port.lm_serve.pad_cache_for_decode(
            cfg, cache, family_ctx(cfg, seq), prompt.shape[0])
        out = [lg] + decode_logits(port, cfg, model, prompt, seq, cache)
    return [x.float().cpu() for x in out]


def route_flips(calls, other) -> float:
    """The share of (layer, token, k) top-k choices that two runs'
    routing records (``RouteTape.calls``) do not share."""
    n = sum(c.numel() for c in calls)
    return sum(int((a != b).sum()) for a, b in zip(calls, other)) / max(n, 1)


def wait_run(procs, d: Path, arch: str, deadline: float) -> list:
    """Every rank's record of ``arch`` (``rank{r}_<arch>.json``) once
    each rank has written it; fails the phase when a rank exits with an
    error first, or at ``deadline`` (``time.monotonic``)."""
    paths = [d / f"rank{r}_{arch}.json" for r in range(len(procs))]
    while not all(p.exists() for p in paths):
        bad = [(r, p.returncode) for r, p in enumerate(procs) if p.poll()]
        check(not bad, f"ranks failed (rank, exit code) before {arch} was "
                       f"done: {bad}")
        check(time.monotonic() < deadline, f"{arch}: ranks still running "
                                           f"after {SHARDED_TIMEOUT_S} s")
        time.sleep(0.05)
    return [json.loads(p.read_text()) for p in paths]


def run_sharded(port: Port, device, runs=SHARDED_RUNS,
                batch: int = SHARDED_BATCH) -> dict:
    """The [sharded] phase (see the module docstring): each of ``runs``
    (arch, layers, text tokens, steps) at full width trained on a
    SHARDED_MESH of gloo ranks sharing the card
    (``launch/train.py::train(mesh=)``: DTensor shardings, the train
    policy, explicit ZeRO-3 gathers, flash on each rank's own heads)
    against the same seeded steps in one process through the kernel,
    within the reference test's tolerances or twice the floor (the
    one-process kernel run against the plain one; the MoE with the
    one-process routing replayed, its own routing's flips within twice
    the naive-vs-kernel floor), each step's gradient norm and each
    leaf's update within SHARDED_GNORM_TOL and SHARDED_DELTA_TOL
    (relative) or twice their floors; each rank's shards and resident
    bytes against ``lower_cell``'s plan at the same mesh; the dense
    run's parameters saved from the mesh restored onto (world, 1) equal
    and equal to the assembled shards; then prefill and two decode
    steps on the mesh against one process (TinyLlama within llm-main's
    logit bounds, the other families within [families]' bounds against
    the naive floor).  One spawn of rank processes for every run."""
    import shutil
    torch, st, tr = port.torch, port.train_steps, port.trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    card = card_line() if on_card else "cpu"
    d = SHARDED_DIR
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    probes = start_gloo_probes(port, d) if on_card else {}
    mesh = port.mesh.make_local_mesh(*SHARDED_MESH)
    world = mesh.size
    jobs = []
    for arch, layers, seq, steps in runs:
        cfg = family_cfg(port, arch, layers)
        tc = dataclasses.replace(st.default_train_config(cfg),
                                 checkpoint_every=0,
                                 checkpoint_dir=str(d / "one"))
        jobs.append((cfg, tc, seq, steps))
    (d / "job.json").write_text(json.dumps({
        "device": str(device), "mesh": list(SHARDED_MESH),
        "runs": [{"cfg": dataclasses.asdict(cfg),
                  "tc": dataclasses.asdict(tc), "batch": batch, "seq": seq,
                  "steps": steps, "elastic": cfg.family == "dense"}
                 for cfg, tc, seq, steps in jobs]}))
    t0 = time.perf_counter()
    procs = []
    for r in range(world):
        with open(d / f"rank{r}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "chip_smoke.py"),
                 "--sharded-rank", str(r), "--sharded-dir", str(d)],
                cwd=HERE, stdout=f, stderr=subprocess.STDOUT))
    ref = {}
    try:
        # -- one process's runs of each arch, the ranks taking it after
        for cfg, tc, seq, steps in jobs:
            arch, moe = cfg.name, cfg.family == "moe"
            one = {}
            tape = RouteTape(port) if moe else contextlib.nullcontext()
            # the kernel run, then the floor: the plain forward (mamba2 has
            # no attention, so no floor), its gaps to the kernel run by
            # leaf taken on the card: (|plain - k|, its largest element)
            one["leaf_floor"] = None
            for impl in ("chunked", "plain") if cfg.num_heads \
                    else ("chunked",):
                hist = []
                with tape if impl == "chunked" else RouteTape(
                        port, tape.calls if moe else None):
                    p, _, _ = tr.train(cfg, tc, batch=batch, seq=seq,
                                       steps=steps, device=device,
                                       resume=False, log_every=steps,
                                       impl=impl, history=hist)
                one[impl] = ([h["loss"] for h in hist if "step" in h],
                             [h["s"] * 1e3 for h in hist if "step" in h],
                             [h["grad_norm"] for h in hist if "step" in h])
                if impl == "chunked":
                    one["leaves"] = [t.float().cpu()
                                     for t in port.tree.leaves(p)]
                else:
                    one["leaf_floor"] = [
                        (float((a.float() - k.to(a.device)).norm()),
                         float((a.float() - k.to(a.device)).abs().max()))
                        for a, k in zip(port.tree.leaves(p), one["leaves"])]
                del p
            p0, _ = tr.build_state(cfg, tc, device)
            inp = family_inputs(port, cfg, batch, seq, device)
            stape = RouteTape(port) if moe else contextlib.nullcontext()
            with stape:
                one["serve"] = family_serve_one(port, cfg, p0, inp, seq,
                                                "chunked")
            # TinyLlama's logits are held at llm-main's bounds, the other
            # families' at [families]' against naive attention's floor
            one["serve_floor"] = None
            if cfg.family != "dense":
                with RouteTape(port, stape.calls if moe else None):
                    one["serve_floor"] = family_serve_one(
                        port, cfg, p0, inp, seq, "naive")
            if moe:
                torch.save({"train": [c.cpu() for c in tape.calls],
                            "serve": [c.cpu() for c in stape.calls]},
                           d / f"routes_{arch}.pt")
                L = cfg.num_layers      # the prefill's calls come first
                one["prefill_routes"] = [c.cpu() for c in stape.calls[:L]]
                with RouteTape(port) as naive:
                    family_serve_one(port, cfg, p0, inp, seq, "naive")
                one["flip_floor"] = route_flips(naive.calls[:L],
                                                stape.calls[:L])
            del p0, inp
            if on_card:
                torch.cuda.empty_cache()
            ref[arch] = one
            # the ranks take the arch while this process goes on to the
            # next (the MoE's one-process state is freed by then)
            (d / f"go_{arch}").write_text("")
        t_go = time.perf_counter()
        # each train step's plan, while the ranks run
        for cfg, tc, seq, _ in jobs:
            plan, _ = st.lower_cell(cfg, port.ShapeConfig(
                "sharded", "train", seq, batch), mesh, tc)
            ref[cfg.name]["plan_bytes"] = plan.arg_bytes
            ref[cfg.name]["collectives"] = {
                f"{op}/{g}": calls
                for (op, g), (_, calls) in plan.cost.collectives.items()}
        probed = gloo_probe_results(probes)

        # -- checks, an arch at a time, each as soon as every rank has run
        # it (the ranks go on with the next) ---------------------------
        rec, staged = {}, {}
        by_rank = {"dense": [0] * world, "dense_serve": [0] * world,
                   "families": [0] * world}
        deadline = time.monotonic() + SHARDED_TIMEOUT_S - (
            time.perf_counter() - t0)
        for cfg, tc, seq, steps in jobs:
            arch, one, moe = cfg.name, ref[cfg.name], cfg.family == "moe"
            dense = cfg.family == "dense"
            got = wait_run(procs, d, arch, deadline)
            for k, v in got[0]["staged"].items():
                staged[k] = staged.get(k, 0) + v
            tag = ("[sharded] " if dense else "[sharded-families] ") + arch
            loss_k, ms_k, gnorm_k = one["chunked"]
            loss_p, _, gnorm_p = one.get("plain", one["chunked"])
            losses = [s["loss"] for s in got[0]["steps"]]
            check(len(losses) == steps and all(np.isfinite(losses))
                  and all([s["loss"] for s in g["steps"]] == losses
                          for g in got), f"{tag} losses {losses}")
            loss_floor = max(abs(a - b) for a, b in zip(loss_k, loss_p))
            loss_gap = max(abs(a - b) for a, b in zip(losses, loss_k))
            check(loss_gap <= max(SHARDED_LOSS_TOL,
                                  SHARDED_FLOOR_FACTOR * loss_floor),
                  f"{tag} loss gap {loss_gap} (floor {loss_floor})")
            gnorms = [s["grad_norm"] for s in got[0]["steps"]]
            gnorm_floor = max(abs(a / b - 1) for a, b in zip(gnorm_p, gnorm_k))
            gnorm_gap = max(abs(a / b - 1) for a, b in zip(gnorms, gnorm_k))
            check(gnorm_gap <= max(SHARDED_GNORM_TOL,
                                   SHARDED_FLOOR_FACTOR * gnorm_floor),
                  f"{tag} grad norms {gnorms} against {gnorm_k}: relative gap "
                  f"{gnorm_gap} (floor {gnorm_floor})")
            worst = worst_floor = delta_worst = delta_floor = 0.0
            bad = []
            shards = [torch.load(d / f"shards_{arch}_{r}.pt")
                      for r in range(world)]
            shardings = port.tree.leaves(port.params.param_shardings(
                port.models.param_spec(cfg), mesh))
            saved = d / f"ckpt_{arch}" / f"step_{steps}"
            # the initial weights drawn again (build_state is seeded), and on
            # the card each leaf's update against the one-process update:
            # (g - p0) - (k - p0) is g - k
            p0s, _ = tr.build_state(cfg, tc, device)
            floors = one["leaf_floor"] or [(0.0, 0.0)] * len(one["leaves"])
            for i, (k, p0, (f_norm, f_max)) in enumerate(zip(
                    one["leaves"], port.tree.leaves(p0s), floors)):
                k = k.to(device)
                g = assemble(torch, shards, i, shardings[i],
                             SHARDED_MESH).to(device)
                if dense and not torch.equal(torch.from_numpy(np.load(
                        saved / f"arr_{i}.npy")).float(), g.cpu()):
                    bad.append(f"leaf {i}: the checkpoint saved from the mesh "
                               "differs from the ranks' shards")
                norm = float((k - p0.float()).norm())
                if norm > 0:
                    rel = float((g - k).norm()) / norm
                    rel_floor = f_norm / norm
                    delta_worst = max(delta_worst, rel)
                    delta_floor = max(delta_floor, rel_floor)
                    if rel > max(SHARDED_DELTA_TOL,
                                 SHARDED_FLOOR_FACTOR * rel_floor):
                        bad.append(f"leaf {i} {tuple(k.shape)}: its update is "
                                   f"{rel:.3e} of the one-process update away "
                                   f"from it (floor {rel_floor:.3e})")
                floor = f_max
                excess = float(((g - k).abs() - SHARDED_ATOL
                                - SHARDED_RTOL * k.abs()).max())
                gap = float((g - k).abs().max())
                worst, worst_floor = max(worst, gap), max(worst_floor, floor)
                if excess > 0 and gap > SHARDED_FLOOR_FACTOR * floor:
                    bad.append(f"leaf {i} {tuple(k.shape)}: gap {gap} past "
                               f"rtol {SHARDED_RTOL} / atol {SHARDED_ATOL} "
                               f"and {SHARDED_FLOOR_FACTOR} x the floor "
                               f"{floor}")
            del p0s, shards
            check(not bad, f"{tag} " + "; ".join(bad))
            per_rank = train_flash_calls(port, cfg) * steps
            bh = batch // SHARDED_MESH[0] * cfg.num_heads // SHARDED_MESH[1]
            # each flash forward at (B/2 * H/2, S, D): S the text and vision
            # tokens, and the audio encoder's frames
            want = sorted({(bh, seq + (cfg.vision_tokens if cfg.family == "vlm"
                                       else 0), cfg.head_dim)}
                          | ({(bh, cfg.encoder_seq, cfg.head_dim)}
                             if cfg.family == "audio" else set())) \
                if cfg.num_heads else []
            for r, g in enumerate(got):
                check(g["flash_calls"] == per_rank
                      and [tuple(s) for s in g["flash_shapes"]] == want,
                      f"{tag} rank {r}: flash calls {g['flash_calls']} at "
                      f"{g['flash_shapes']}, want {per_rank} at {want}")
                check(not on_card or g["launches"] == per_rank,
                      f"{tag} rank {r} launched flash {g['launches']} times, "
                      f"want {per_rank}")
                check(g["local_bytes"] == one["plan_bytes"],
                      f"{tag} rank {r}: shards hold {g['local_bytes']} B, the "
                      f"plan {one['plan_bytes']}")
                check(g["resident"] is None
                      or g["resident"] == one["plan_bytes"],
                      f"{tag} rank {r}: resident {g['resident']} B, the plan "
                      f"{one['plan_bytes']}")
                want_serve = flash_calls(port, cfg)
                check(not on_card or g["prefill_launches"] == want_serve,
                      f"{tag} rank {r}: prefill launched flash "
                      f"{g['prefill_launches']} times, want {want_serve}")
                check(not dense or g["restored_equal"],
                      f"{tag} rank {r}: restore onto the other mesh differs")
                if dense:
                    by_rank["dense"][r] += g["launches"]
                    by_rank["dense_serve"][r] += g["serve_launches"]
                else:
                    by_rank["families"][r] += g["launches"] \
                        + g["serve_launches"]
            flips = flip_floor = None
            if moe:
                back = [c.clone() for c in one["prefill_routes"]]
                for r in range(world):
                    for b, loc in zip(back, torch.load(
                            d / f"routes_{arch}_{r}.pt")):
                        b[moe_groups("prefill", r, batch, seq)] = loc
                flips = route_flips(back, one["prefill_routes"])
                flip_floor = one["flip_floor"]
                check(flips <= SHARDED_FLOOR_FACTOR * flip_floor,
                      f"{tag} its own routing flips {flips:.4f} of the "
                      f"prefill's choices, past {SHARDED_FLOOR_FACTOR} x the "
                      f"floor {flip_floor:.4f}")
            serve_got = torch.load(d / f"serve_{arch}.pt")
            serve_err = {}
            for i, (a, b) in enumerate(zip(serve_got, one["serve"])):
                what = "prefill" if i == 0 else f"decode step {i}"
                if dense:
                    e = logit_diff(torch, a, b)
                    e["bounds"] = (LOGIT_MAX_TOL, LOGIT_MEAN_TOL)
                else:
                    e = family_diff(torch, a, b, logit_diff(
                        torch, one["serve_floor"][i], b))
                serve_err[what] = e
                check(a.shape == b.shape and e["finite"]
                      and e["max"] <= e["bounds"][0]
                      and e["mean"] <= e["bounds"][1]
                      and e["argmax_other"] == 0,
                      f"{tag} {what} logits on the mesh against one process: "
                      f"max {e['max']}, mean {e['mean']}, bounds "
                      f"{e['bounds']}, argmax {e['argmax_other']}")
            check(len(serve_got) == 1 + SHARDED_DECODE, f"{tag} serve logits")
            step_ms = [[round(s["s"] * 1e3, 1) for s in g["steps"]]
                       for g in got]
            peaks = [g["peak"] for g in got]
            g0 = got[0]
            log(f"{tag} {cfg.num_layers} layers"
                + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers
                   else "") + f" at full width, batch {batch} x {seq}, "
                f"{steps} steps, mesh {mesh.shape} of gloo ranks: losses "
                f"{[round(x, 6) for x in losses]} vs one process "
                f"{[round(x, 6) for x in loss_k]} (gap {loss_gap:.3e}; floor "
                f"{loss_floor:.3e}); grad norms "
                f"{[round(x, 6) for x in gnorms]}"
                f" (relative gap {gnorm_gap:.3e}, floor {gnorm_floor:.3e}); "
                f"leaves' worst gap {worst:.3e} (floor {worst_floor:.3e}); "
                f"each leaf's update within {delta_worst:.3e} of the "
                f"one-process update (floor {delta_floor:.3e})"
                + (f"; routing replayed, its own prefill routing flips "
                   f"{flips:.4f} (floor {flip_floor:.4f})" if moe else "")
                + f"; ms a step by rank {step_ms} (one process "
                f"{[round(x, 1) for x in ms_k]}); flash {per_rank} a rank, "
                f"launches by rank {[g['launches'] for g in got]} at "
                f"{g0['flash_shapes']}; bytes a rank held "
                f"{g0['local_bytes']:,} = planned {one['plan_bytes']:,} "
                f"(resident {nbytes(g0['resident'])}); planned collectives "
                f"{one['collectives']}; staged a rank "
                + (", ".join(f"{k} x{v}" for k, v in g0["staged"].items())
                   or "none")
                + f"; peak by rank "
                + (", ".join(f"{p / 1e9:.2f} GB" for p in peaks)
                   if on_card else "not measured")
                + f"; train {g0['train_s']:.1f} s, shards written "
                f"{g0['shards_s']:.1f} s"
                + (f"; restored onto {(world, 1)} equal "
                   f"({g0['restored_layout']}), save {g0['save_s']:.1f} s, "
                   f"restore {g0['restore_s']:.1f} s" if dense else "")
                + f" ({card})")
            log(f"{tag} prefill of {batch} x {seq} and {SHARDED_DECODE} "
                f"decode steps on the mesh: logits against one process "
                + "; ".join(f"{k} max {v['max']:.3e} mean {v['mean']:.3e} "
                            f"(bounds {v['bounds'][0]:.3e} / "
                            f"{v['bounds'][1]:.3e})"
                            for k, v in serve_err.items())
                + f"; flash launches by rank "
                f"{[g['serve_launches'] for g in got]}; {g0['serve_s']:.1f}"
                f" s on rank 0, staged "
                + (", ".join(f"{k} x{v}"
                             for k, v in g0["serve_staged"].items())
                   or "none") + f" ({card})")
            rec[arch] = {
                "family": cfg.family, "layers": cfg.num_layers, "batch": batch,
                "seq": seq, "steps": steps,
                "losses": losses, "one_process_losses": loss_k,
                "loss_gap": loss_gap, "loss_floor": loss_floor,
                "grad_norms": gnorms, "one_process_grad_norms": gnorm_k,
                "grad_norm_gap": gnorm_gap, "grad_norm_floor": gnorm_floor,
                "worst_leaf_gap": worst, "worst_leaf_floor": worst_floor,
                "update_gap": delta_worst, "update_floor": delta_floor,
                "flips": flips, "flip_floor": flip_floor,
                "serve_logits": {k: {"max": v["max"], "mean": v["mean"],
                                     "bounds": v["bounds"]}
                                 for k, v in serve_err.items()},
                "step_ms_by_rank": step_ms, "one_process_step_ms": ms_k,
                "flash_shapes": want,
                "launches_by_rank": [g["launches"] for g in got],
                "serve_launches_by_rank": [g["serve_launches"] for g in got],
                "planned_arg_bytes": one["plan_bytes"],
                "planned_collectives": one["collectives"],
                "resident_by_rank": [g["resident"] for g in got],
                "peak_by_rank": peaks, "staged": g0["staged"],
                "serve_staged": g0["serve_staged"],
                "train_s_by_rank": [g["train_s"] for g in got],
                "serve_s": g0["serve_s"]}
        wait_ranks(procs, max(deadline - time.monotonic(), 0.01))
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for r in range(world):
            log(f"[sharded] rank {r} log tail:\n"
                + (d / f"rank{r}.log").read_text()[-3000:])
        raise
    ranks_s, go_s = time.perf_counter() - t0, time.perf_counter() - t_go
    check(bool(staged) == on_card and set(staged)
          <= set(port.actctx.FUNCOL_OPS), f"[sharded] staged {staged}")
    log(f"[sharded] gloo on CUDA tensors under torch {torch.__version__}, "
        f"one op a one-rank group: "
        + (", ".join(f"{k} {v}" for k, v in probed.items()) or "not run")
        + "; staged through pinned host memory (by backend and device), "
        "rank 0's train steps: "
        + (", ".join(f"{k} x{v}" for k, v in staged.items()) or "none")
        + f" ({card})")
    secs = time.perf_counter() - t_phase
    log("[sharded] " + json.dumps(
        {"mesh": list(SHARDED_MESH), "runs": rec, "gloo_probe": probed,
         "staged": staged, "ranks_s": ranks_s, "after_go_s": go_s,
         "secs": secs}))
    log(f"[sharded done] {secs:.1f} s ({card})")
    shutil.rmtree(d, ignore_errors=True)
    return {"launches": sum(by_rank["dense"]), "by_rank": by_rank["dense"],
            "serve_launches": sum(by_rank["dense_serve"]),
            "serve_by_rank": by_rank["dense_serve"],
            "families_launches": sum(by_rank["families"]),
            "families_by_rank": by_rank["families"]}


# ---------------------------------------------------------------------------
# the LM dry-run: the cells the card ran, planned on meta tensors, then
# the registry's cells through the CLI
# ---------------------------------------------------------------------------

class DryrunCLI:
    """The dry-run CLI's passes (``passes``: arch list, shape list and
    worker processes, each pass a process of its own), started at once
    in the background so that their host work overlaps the phase's own
    plans; :meth:`finish` waits for them, prints each cell's lines and
    reads the records from ``out_dir``.  :meth:`stop` ends any still
    running (the script stops every process it starts)."""

    def __init__(self, passes=DRYRUN_LM_PASSES, out_dir=DRYRUN_LM_DIR,
                 smoke: bool = False):
        import shutil
        shutil.rmtree(out_dir, ignore_errors=True)
        self.out_dir, self.runs, self.smoke = out_dir, [], smoke
        env = dict(os.environ, PYTHONPATH=str(SRC))
        self.t0 = time.perf_counter()
        for archs, shapes_, mesh, jobs in passes:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", archs, "--shape", shapes_, "--mesh", mesh,
                   "--jobs", str(jobs), "--out", str(out_dir)] \
                + ["--smoke"] * smoke
            self.runs.append((archs, shapes_, mesh, jobs, cmd,
                              subprocess.Popen(
                                  cmd, env=env, cwd=HERE,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)))

    def finish(self) -> dict:
        passes = []
        for archs, shapes_, _, jobs, cmd, proc in self.runs:
            stdout, stderr = proc.communicate(timeout=DRYRUN_LM_WAIT_S)
            secs = time.perf_counter() - self.t0
            for line in stdout.splitlines():
                if line.startswith("[") or "per-device HBM" in line:
                    log(f"[dryrun-lm] {line.strip()}")
            check(proc.returncode == 0, f"dry-run CLI {' '.join(cmd[3:])} "
                  f"failed:\n{stdout[-2000:]}\n{stderr[-2000:]}")
            passes.append({"arch": archs, "shape": shapes_, "jobs": jobs,
                           "seconds": secs})
            log(f"[dryrun-lm] CLI --arch {archs} --shape {shapes_} --jobs "
                f"{jobs}: done {secs:.1f} s after it started, on the host")
        recs = [json.loads(p.read_text())
                for p in sorted(self.out_dir.glob("*.json"))]
        check(recs and all(r["status"] == "ok" for r in recs),
              "dry-run CLI records")
        return {"passes": passes, "raw": recs, "records": {
            f"{r['arch']}__{r['shape']}__{r['mesh']}": {
                "program": r["program"], "lower_s": r["lower_s"],
                "bottleneck_v5e": r["bottleneck"],
                "bottleneck_h100": r["h100"]["bottleneck"],
                "hbm_gb": (r["arg_bytes_per_device"]
                           + r["temp_bytes_per_device"]) / 1e9,
                "arg_bytes_per_device": r["arg_bytes_per_device"],
                "collective_wire_bytes": r["collective_wire_bytes"]}
            for r in recs}}

    def stop(self) -> None:
        for *_, proc in self.runs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def sharded_arg_bytes(port: Port, cfg, shape_name: str,
                      mesh_name: str) -> int:
    """One device's argument bytes of a sharded train cell from the
    plans alone: each parameter's shard (``param_shardings``) in f32
    three times (the parameter, AdamW's m and v), the optimizer's int32
    step, and each batch tensor's shard (``batch_shardings``)."""
    P, st = port.params, port.train_steps
    mesh = port.mesh.make_production_mesh(multi_pod=mesh_name == "multipod")
    shape = port.arch_registry.get_shape(shape_name)
    spec = port.models.param_spec(cfg)
    total = 4
    for s, sh in zip(port.tree.leaves(spec),
                     port.tree.leaves(P.param_shardings(spec, mesh))):
        total += 3 * 4 * math.prod(sh.shard_shape(s.shape))
    batch = st.input_specs(cfg, shape)
    for t, sh in zip(port.tree.leaves(batch), port.tree.leaves(
            st.batch_shardings(cfg, shape, mesh, batch))):
        total += t.element_size() * math.prod(sh.shard_shape(t.shape))
    return total


def run_dryrun_lm(port: Port, cells: dict, device, cli: DryrunCLI) -> dict:
    """Plan each cell the earlier phases ran on the card (``cells``: the
    configuration, kind, batch and sequence as run, the resident bytes
    and measured peak) with ``lower_cell`` on the one-card mesh.
    Planned argument bytes must equal the resident bytes, and the planned
    peak (arguments plus temps, the plain attention route's) must not be
    under the measured one.  Then wait for the dry-run CLI's passes
    (``cli``, started with this phase) and print each of their cells'
    plan time and bottleneck."""
    torch, st = port.torch, port.train_steps
    t_phase = time.perf_counter()
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    mesh = port.mesh.make_local_mesh()
    out = {}
    for name, c in cells.items():
        shape = port.ShapeConfig(name, c["kind"], c["seq"], c["batch"])
        plan, meta = st.lower_cell(c["cfg"], shape, mesh, c.get("tc"))
        planned_peak = plan.arg_bytes + plan.temp_bytes
        res, peak = c["resident"], c["peak"]
        ratio = None if peak is None else planned_peak / peak
        shown = "not measured" if ratio is None else f"{ratio:.4f}"
        log(f"[dryrun-lm] {name} ({meta['program']}, batch {c['batch']} x "
            f"{c['seq']}): args planned {plan.arg_bytes:,} B vs resident "
            f"{nbytes(res)}; peak planned {planned_peak:,} B "
            f"({plan.attention_route} attention) vs measured {nbytes(peak)}"
            f" requested (planned / measured {shown}"
            f"; the run's max_memory_allocated above its start "
            f"{nbytes(c['peak_allocated_above'])}); counted matmul "
            f"{plan.cost.matmul_flops:.4e} FLOPs; planned in "
            f"{plan.lower_s:.2f} s ({card})")
        if res is not None:
            check(plan.arg_bytes == res,
                  f"dry-run {name}: planned argument bytes {plan.arg_bytes} "
                  f"!= resident {res}")
            check(planned_peak >= peak,
                  f"dry-run {name}: planned peak {planned_peak} under the "
                  f"measured {peak}")
        out[name] = {"program": meta["program"],
                     "planned_arg_bytes": plan.arg_bytes,
                     "resident_bytes": res, "planned_peak": planned_peak,
                     "measured_peak": peak, "ratio": ratio,
                     "measured_peak_allocated_above":
                         c["peak_allocated_above"],
                     "matmul_flops": plan.cost.matmul_flops,
                     "plan_s": plan.lower_s}
    t_cells = time.perf_counter() - t_phase
    done = cli.finish()
    for r in done.pop("raw"):
        if r["mesh"] == "single":
            continue
        cfg = port.arch_registry.get_arch(r["arch"])
        if cli.smoke:
            cfg = port.arch_registry.smoke_config(r["arch"])
        want = sharded_arg_bytes(port, cfg, r["shape"], r["mesh"])
        log(f"[dryrun-lm] {r['arch']} x {r['shape']} x {r['mesh']}: "
            f"argument bytes a device {r['arg_bytes_per_device']:,} = "
            f"shards of param_shardings, batch_shardings and the "
            f"optimizer state {want:,}; collective wire "
            f"{r['collective_wire_bytes']:.4e} B a device "
            f"({r['collectives']['counts']}); planned in "
            f"{r['lower_s']} s on the host")
        check(r["arg_bytes_per_device"] == want,
              f"dry-run {r['arch']} x {r['mesh']}: argument bytes "
              f"{r['arg_bytes_per_device']} != the shards' {want}")
    secs = time.perf_counter() - t_phase
    res = {"cells": out, "cells_s": t_cells, "cli_passes": done["passes"],
           "cli_records": done["records"], "secs": secs}
    log("[dryrun-lm] " + json.dumps(res))
    log(f"[dryrun-lm done] {secs:.1f} s (the CLI passes started "
        f"{time.perf_counter() - cli.t0:.1f} s ago)")
    return res


def kernels_record(result: dict, llm: dict, trained: dict,
                   families: dict, train_families: dict,
                   sharded: dict) -> dict:
    """The contract record of each kernel: spmv_ell at pagerank/bsp's
    ell_in buckets and bfs_pull at bfs/fast's, at the largest parts
    count; flash_attention_fwd at one TinyLlama prefill layer.  A graph
    kernel's launches are those of every path it runs on (the main path,
    the rest of the BSP suite, multi-source, the async programs, the
    incremental ones, chaos, the telemetry runs, the query server, the
    dynamic graph), each counted from zero around its run."""
    p = result["parts"]
    paths = {"graph-main": result["launches"], "bsp-suite":
             result["bsp_launches"], "multi-source": result["multi_launches"],
             "async": result["async_launches"],
             "incremental": result["inc_launches"],
             "dist": result["dist_launches"],
             "chaos": result["chaos_launches"],
             "obs": result["obs_launches"],
             "serve": result["serve_launches"],
             "dryrun": result["dryrun_launches"],
             "mutate": result["mutate_launches"]}
    rows = []
    for name, src, replaces, cell_key, design in (
            ("spmv_ell", "src/repro_torch/kernels/spmv/csrc/spmv_ell.cu",
             SPMV_REPLACES, f"spmv_ell/ell_in/parts={p}", SPMV_DESIGN),
            ("bfs_pull", "src/repro_torch/kernels/frontier/csrc/bfs_pull.cu",
             BFS_REPLACES, f"bfs_pull/ell_in/parts={p}", BFS_DESIGN)):
        cell = result["kernel_cells"][cell_key]
        rows.append({"name": name, "route": "cuda", "design": design,
                     "source": src, "replaces": replaces,
                     "launches": sum(c[name] for c in paths.values()),
                     "launches_by_path": {k: c[name]
                                          for k, c in paths.items()},
                     "dist_gloo_launches_by_rank": [
                         c[name] for c in result["dist_by_rank"]],
                     "max_abs_err": result["parity_err"][name],
                     "ms": cell["ms"], "plain_ms": cell["plain_ms"],
                     "bound_ms": cell["bound_ms"],
                     "bound_by": cell["bound_by"],
                     "library_ms": cell["library_ms"],
                     "gathers_per_s": cell["gathers"] / cell["ms"] * 1e3})
    cell = llm["flash"]
    flash_paths = {"llm-main": llm["launches"], "train": trained["launches"],
                   "families": families["launches"],
                   "train-families": train_families["launches"],
                   "sharded": sharded["launches"],
                   "sharded-serve": sharded["serve_launches"],
                   "sharded-families": sharded["families_launches"]}
    rows.append({"name": "flash_attention_fwd", "route": "cuda",
                 "design": "wgmma (bf16 tensor cores, TMA k/v ring)",
                 "source": "src/repro_torch/kernels/flash_attention/csrc/"
                           "flash_attention_fwd.cu",
                 "replaces": FLASH_REPLACES,
                 "launches": sum(flash_paths.values()),
                 "launches_by_path": flash_paths,
                 "sharded_gloo_launches_by_rank": sharded["by_rank"],
                 "sharded_serve_launches_by_rank": sharded["serve_by_rank"],
                 "sharded_families_launches_by_rank":
                     sharded["families_by_rank"],
                 "max_abs_err": max(llm["parity_err"],
                                    families["parity_err"],
                                    train_families["parity_err"]),
                 "ms": cell["ms"],
                 "plain_ms": cell["plain_ms"], "bound_ms": cell["bound_ms"],
                 "bound_by": cell["bound_by"],
                 "library_ms": cell["library_ms"],
                 "lse_ms": trained["lse_ms"],
                 "lse_max_abs_err": max(trained["lse_err"],
                                        train_families["lse_err"]),
                 "family_shapes": families["shapes"],
                 "family_train_lse_shapes": train_families["lse_shapes"]})
    return {"kernels": rows}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="checkout whose graph kernels to time beside "
                         "these (per bucket and per BFS round)")
    ap.add_argument("--dist-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--sharded-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--sharded-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gloo-probe", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dist_rank is not None:
        # a rank of the [dist] phase's gloo run, started by run_dist
        return dist_rank_main(args.dist_rank, Path(args.dist_dir))
    if args.sharded_rank is not None:
        # a rank of the [sharded] phase, started by run_sharded
        return sharded_rank_main(args.sharded_rank, Path(args.sharded_dir))
    if args.gloo_probe is not None:
        return gloo_probe_main(args.gloo_probe, Path(args.sharded_dir))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "a card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = card_line()
    log(f"[card] {card}")
    out, dry, cli = {}, {}, []

    def dryrun_lm():
        # started after the last timed phase: its worker processes would
        # contend for the host cores that the step times depend on
        cli.append(DryrunCLI())
        return run_dryrun_lm(Port(), dry, "cuda", cli[0])

    try:
        for name, fn in (
                ("graph", lambda: run(GRAPH, PARTS, "cuda", args.parent)),
                ("llm", lambda: run_llm(Port(), "cuda")),
                ("train", lambda: run_train(Port(), "cuda")),
                ("families", lambda: run_families(Port(), "cuda")),
                ("train-families", lambda: run_train_families(Port(),
                                                              "cuda")),
                ("sharded", lambda: run_sharded(Port(), "cuda")),
                ("dryrun-lm", dryrun_lm)):
            out[name] = fn()
            dry.update(out[name].pop("dryrun_cells", {}))
            log(f"[{name} phase done] {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
    finally:
        for c in cli:
            c.stop()
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels_record(out["graph"], out["llm"], out["train"],
                                    out["families"], out["train-families"],
                                    out["sharded"])))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
