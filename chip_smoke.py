"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py

Phases, in the order they run (any failure raises, so the process exits
non-zero with no "ok" line):

0. analysis — on the host, before anything runs on the card: the port's
              static analyzer (``repro_torch.analysis``) over
              ``src/repro_torch`` with its suppressions file; one line of
              rules, files, findings and suppressed; any unsuppressed
              finding or unused suppression fails. Once the device phase
              has built the kernels (``analysis.sync``): TS002's
              cross-check on the card, the ``_SelectiveScan`` root
              (float32, ANALYSIS_SCAN_SHAPE, both hand-written kernels) and
              the ``_FlashFA2`` root (bfloat16, ANALYSIS_FA2_SHAPE) each
              forward and backward once under
              ``torch.cuda.set_sync_debug_mode("error")``: a synchronising
              call raises; the scan launches each kernel once.
1. device   — require CUDA; print the card's name and power limit
              (nvidia-smi); build the nine CUDA kernels from
              ``src/repro_torch/csrc`` for sm_90a, one nvcc per source, in
              parallel.
2. main     — the paper's pipeline at the EC2 scale, through the user entry
              points on the card: ``load_dataset("dblp", scale=1.0)``,
              ``dfep.partition(k=16, max_rounds=4000, stall_rounds=64)``
              with seeded starts, ``compile_plan``, ``Engine``, then SSSP
              from vertex 0, WCC and PageRank (30 supersteps). SSSP and WCC
              must equal a scipy.sparse.csgraph oracle exactly; PageRank
              must agree with the engine's plain path on the card and with a
              float64 numpy oracle to the relative tolerances below; SSSP,
              WCC and PageRank's counters, and SSSP's and WCC's states,
              must equal the engine's plain path's. The launch counters are
              zeroed before this phase; lane_cumsum (DFEP's rank cumsum)
              must have risen during ``dfep.partition``, and the engine's
              kernels (segment_reduce, exchange) by the phase's end, with
              one exchange launch a superstep and no masked_update.
3. gnn      — the second path on the main phase's plan, through the user
              entry points: ``engine_gcn_layer`` (x [V, 8], weight [8, 4]),
              ``engine_kge_score`` (entity [V, 8], relation [e_pad, 8]),
              ``engine_weighted_sssp(0)``, ``engine_bfs(0)``,
              ``engine_label_propagation`` and
              ``engine_personalized_pagerank`` (30 supersteps), inputs
              seeded from numpy. The counters are zeroed before it; gspmm
              must rise during gcn_layer and during kge_score, and every
              kernel of the path by its end (one exchange a superstep, no
              masked_update). wsssp, BFS and labelprop must
              equal host numpy/scipy oracles bit for bit; PPR must agree with
              the plain path on the card and with a float64 numpy oracle
              element by element, and gcn_layer and kge_score to a bound
              relative to their largest value (tolerances below).
4. serve    — the serving path on the main phase's graph and DFEP owner:
              ``compile_plan_cached`` (a miss, then a hit returning the
              same plan with its three kernel layouts built; the cache's
              counters 1 miss, 1 hit); ``multi_source_sssp`` from
              SERVE_LANES seeded sources against one ``engine_sssp`` per
              source (each lane bit for bit, equal supersteps, local
              iterations and convergence; the batch's exchange launches
              equal the longest lane's supersteps and its segment_reduce
              launches lie between the longest lane's sweeps and their
              sum; timed first and warm against the solo runs, warm);
              ``run_batched`` for bfs and wsssp at SERVE_SMALL lanes, cold
              and warm-started from a one-superstep batch with two rows
              +inf, each lane against its solo cold or warm run;
              ``run_batched`` of gcn_layer (batched x) and kge_score
              (batched entity and relation) at SERVE_SMALL lanes, the
              lanes on gspmm's feature axis (F = GSPMM_LANE_WIDTH): one
              gspmm launch for the batch's one sweep against one a lane
              solo, each lane within SERVE_ADD_ATOL of its solo run
              (relative to its largest |value| above 1), timed first and
              warm against the solo runs, warm; then a
              ``GraphServer`` on the card answering SERVE_REQUESTS seeded
              requests of SERVE_TENANTS tenants (sssp, bfs, wsssp with
              repeated sources, wcc, pagerank 20 and 30, ppr, labelprop,
              one gcn_layer), every answer equal to a solo ``Engine`` run
              (min programs bit for bit, add within SERVE_ADD_ATOL), every
              micro-batch through the kernels; ``serve`` and ``drain`` (a
              second stream of SERVE_DRAIN) timed. The counters are zeroed
              just before ``serve`` and read just after. Then a second
              server with ``ledger=CostLedger()`` answers the same
              requests: each answer equal to the first server's, the
              ledger's device seconds within LEDGER_DEVICE_RTOL of the
              server's ``device_time_s``, one ledger request a completed
              one, each dispatched batch's utilization (the cost model's
              least time over its device time) in (0, LEDGER_UTIL_MAX],
              every kernel of the path launched; per-tenant device
              seconds, utilization by program and bucket and the cost
              model's hits, misses and compile ms are logged. The q/s of
              the stream without and with a ledger is timed in turns,
              and a traced run of SERVE_TRACED requests under a monitor
              whose objective no request meets must dump one flight
              bundle for the alert; the bundle, a Chrome trace and the
              ledger are rendered by ``report`` and ``usage`` and
              printed.
5. stream   — streaming maintenance on the main phase's graph and DFEP
              owner, through the user entry points: ``StreamSession(g,
              StreamConfig(k=16, chunk_size=256), owner=owner)`` with the
              default slack and an ``AdaptiveCompactionPolicy``, kge_score's
              relation plane bound to the session (``bind_channel``, kept
              across patches), the recorder on, then STREAM_BATCHES batches
              of STREAM_FRAC of |E| deletes of live edges and as many
              inserts of seeded vertex pairs each. The first is applied
              while a ``GraphServer.from_session`` serves STREAM_REQUESTS
              seeded requests (one micro-batch pumped on the old plan, the
              rest drained on the new one; each answer bit for bit a solo
              run on the plan it was served from). Before the last batch the
              drift threshold is set below any drift, so its check fires a
              re-auction of the default radius; then a trickle of
              STREAM_TRICKLE deletes and as many inserts, with the threshold
              below any drift and the radius 0, fires a local re-auction
              that must come out as a patch that moves edges (each
              re-auction's rounds, ms a round and lane_cumsum launches
              logged). After each batch: SSSP(0) and WCC equal to scipy on
              ``session.graph()`` and PageRank(30) within STREAM_PR_ATOL and
              PR_ORACLE_RTOL of its float64 oracle, each query launching
              segment_reduce and one exchange a superstep; the same queries
              on a plan recompiled from the same graph (first and warm
              times); segment_reduce's device time on both plans; the
              kernels against their plain versions on the patched plan
              (segment_reduce min exact and add, the exchange min exact,
              gcn_layer's gspmm); the apply wall time, the ms of each
              ``stream.patch_plan`` and ``stream.layouts`` span the
              recorder took, the segment layout's counts (append slots,
              the longest append run of one target) and the replication
              factor against ``rf_base``. Then ``idle_tick`` must compact
              (an epoch) and the queries hold after it. The counters are
              zeroed before the phase; segment_reduce, exchange, gspmm and
              lane_cumsum must rise on the path (checks against plain
              versions not counted), masked_update must not.
6. etsch    — the paper's own dense ETSCH framework, metrics and baselines
              on the main phase's graph and DFEP owner, through the user
              entry points: ``etsch.compile_partitioning``, then
              ``etsch_sssp(0)`` (equal to scipy and to the main phase's
              engine SSSP), ``etsch_cc`` with seeded ids (each vertex the
              min id of its component), ``etsch_multi_sssp`` from 8 seeded
              sources (each row equal to scipy BFS), ``etsch_pagerank(30)``
              (PR_ORACLE_RTOL of the float64 oracle), ``etsch_mis`` with
              seeded priorities (a maximal independent set) and
              ``etsch_kcore`` (equal to a numpy peeling oracle), each timed
              first and warm; then ``metrics.evaluate`` (MESSAGES and the
              replication factor equal to the plan's, the gain equal to
              1 - supersteps / (eccentricity + 1)); the gain on the road
              network stand-in (usroads, full scale, DFEP K=16: > 0 and
              equal to the same formula); and the paper's Fig. 7
              comparison: hash, random, greedy and JaBeJa partitions
              through ``metrics.evaluate``. The counters are zeroed before
              it; minplus_sweep and frontier_min must rise in
              ``etsch_sssp`` and minplus_sweep in ``evaluate``; each
              problem's line logs its minplus_sweep launches by state
              rows ([K·V], [K·8·V], [V]).
7. dist     — the multi-device path over ``torch.distributed`` on the main
              phase's graph, DFEP owner and plan, at each world size of
              DIST_WORLDS (world 1 over NCCL, world 2 over gloo with CUDA
              tensors: NCCL refuses two ranks on one card), every rank a
              process spawned here on card 0 after the kernels are built:
              ``run_dfep_sharded`` at DIST_DFEP_ROUNDS fixed rounds from
              the main phase's starts (every live edge owned in [0, K),
              sizes summing to |E|, two ``lane_cumsum`` launches a round a
              rank, ``largest_norm`` and ms a round logged),
              ``sssp_sharded(0)`` (equal to scipy, the same supersteps at
              both worlds) and ``pagerank_sharded(30)`` (PR_ORACLE_RTOL of
              the float64 oracle) on the main phase's partitioning, and
              ``Engine(plan, group=...)``: SSSP(0) and WCC bit for bit and
              PageRank(30) within PR_PLAIN_RTOL of the main phase's
              single-device results, with the same supersteps and
              convergence (local sweeps equal at world 1, no more at world
              2, where they are the busiest rank's), ``segment_reduce``
              launched once a sweep on the busiest rank, ``masked_update``
              once a superstep a rank and ``exchange`` never; and
              ``multi_source_sssp`` of the serve phase's SERVE_LANES
              sources, each lane bit for bit its solo run with the same
              counters. The counters are zeroed just before each first
              call and read just after; each is then run warm with CUDA
              events around every collective (``collective_ms``). Every
              rank must return the same; a failing rank fails the phase.
8. lm       — Mamba serving at falcon-mamba-7b's full width and depth
              (64 layers, d_model 4096, d_inner 8192, d_state 16, vocab
              65,024): ``lm.init_params`` on the card from a seeded
              generator (float32, 27.1 GiB), then B = LM_BATCH seeded
              prompts of LM_PROMPT tokens through ``serve_step.prefill``
              (first and warm), ``decode`` steps (ms per step) and
              ``Engine.generate`` of LM_NEW tokens. The counters are zeroed
              just before ``generate``; selective_scan must have run once
              per layer and forward, n_layers · LM_NEW times. Checks: every
              logit finite; the decode logits for token s equal the last
              logits of a prefill of s + 1 tokens within a bound of the
              largest (bf16_rel), while decode from a wrong cache (the conv
              window padded as the reference pads it, or a zeroed state)
              must fall outside it. The scan's inputs at the first and the
              last layer of the prompt's prefill are kept for the kernels
              phase, and the model is freed before it.
9. lm.moe   — attention and MoE serving at qwen2-moe-a2.7b's full width and
              depth (24 layers, d_model 2048, 16 heads over 16 kv heads,
              qkv bias, 60 routed experts top-4 of width 1408 plus a
              4 × 1408 shared expert, vocab 151,936), after the lm phase's
              model is freed: ``lm.init_params`` on the card from a seeded
              generator (float32, 53.3 GiB), then the lm phase's prompts
              through ``lm.forward_lm`` (first and warm; the capacity
              drops per layer logged from ``layers.record_routing``; every
              logit finite, ``aux`` finite and positive), ``decode`` steps
              (ms a step) and ``Engine.generate`` of LM_NEW tokens (the
              counters zeroed just before it: the path has no TPU-kernel
              counterpart, and its launches are logged). Decode for token
              s must equal the last logits of a prefill of s + 1 within
              bf16_rel, and decode from a zeroed KV cache must fall outside
              it, on the sequences neither prefill dropped a token of (a
              token's capacity slot is its rank among every token routed
              to its expert, so the two prefills drop differently): the
              prompts' sequences free of drops, if any, and LM_DROPFREE
              prompts, too few tokens for any expert to overflow. Then one
              warm prefill and one decode step under ``torch.profiler``
              (kernels, device ms and busy share, the device ms of the
              weight casts and of the products), the port's flash scan
              against ``scaled_dot_product_attention`` at the prefill's
              attention shapes (a yardstick, timed only here), and peak
              MiB.
10. moe_dfep — before qwen2-moe is freed: the expert ids its first MoE
              layer routed in the prefill ([B·S, 4]) through
              ``moe_dfep.place_experts`` on the card (K = MOE_DFEP_SHARDS;
              the counters zeroed just before it: lane_cumsum must rise;
              rounds, ms a round and the imbalance against
              ``naive_imbalance`` logged); then that layer with its experts
              renamed by ``permute_expert_params`` on its prefill input:
              every token whose experts changed must have met a top-k
              boundary tie (broken lower index first), and every token
              routed the same within MOE_PERM_REL of the layer as it was.
11. lm.dense — qwen3-4b at full width and depth (36 layers, d_model 2560,
              32 heads over 8 kv heads, qk_norm, vocab 151,936), after
              qwen2-moe is freed: the same steps and checks, every
              sequence free of drops.
12. lm.hybrid — jamba-v0.1-52b at full width (d_model 4096, 32 heads over
              8 kv heads, d_ff 14336, 16 experts top-2 on every other
              layer, d_inner 8192, d_state 16, vocab 65,536), its depth
              cut to one block repeat (LM_HYBRID_LAYERS: ssm×4, attn,
              ssm×3), after qwen3-4b is freed: the same steps and checks;
              selective_scan must run once per SSM layer and forward in
              ``generate``, 7 · LM_NEW times, and the first SSM layer's
              scan arguments in a prefill are kept for the kernels phase.
13. lm.mla  — deepseek-v2-236b at full width (d_model 5120, 128 heads,
              MLA with kv_lora 512, q_lora 1536, rope 64, nope 128, v
              128, 160 routed experts top-6 of width 1536 and 2 shared,
              vocab 102,400), its depth cut to LM_MLA_LAYERS, after
              jamba is freed: the same steps and checks (the yardstick at
              dh 192 against dv 128).
14. lm.encdec — whisper-small whole (12 encoder and 12 decoder layers,
              d_model 768, 12 heads of 64, d_ff 3072, vocab 51,968
              padded), after deepseek-v2 is freed: LM_ENCDEC_BATCH prompts
              of LM_ENCDEC_PROMPT tokens and their 1,500 encoder frames
              from ``SyntheticPipeline`` (seed SEED). The same steps and
              checks at bf16_rel(24), with the encoder's wall time
              (``_encode``, first and warm), the cross k/v's and the
              decoder's prefill from the encoder's output logged apart;
              decode runs with the cross k/v, and zeroed cross k/v must
              fall outside the bound as a zeroed self-attention cache
              must; the same check again with the compute dtype float32
              within F32_DECODE_REL (the caches, offsets and cross k/v
              exactly); the yardstick at the decoder's self-attention,
              its cross-attention (224 queries over 1,500 keys) and the
              encoder's shapes. ``generate`` must launch none of the
              kernels.
15. lm.vlm  — llava-next-34b at full width (d_model 7168, 56 heads over 8
              kv heads of 128, d_ff 20480, vocab 64,000), its depth cut to
              LM_VLM_LAYERS (LM_VLM_CUT says why, and why 2 prompts),
              after whisper is freed: LM_VLM_BATCH prompts of
              LM_VLM_PROMPT tokens after 2,880 image embeddings from
              ``SyntheticPipeline`` (4,095 positions; the decode check
              prefills 4,096). The same steps and checks at
              bf16_rel(20), and in float32 within F32_DECODE_REL; decode
              writes and attends at 2,880 + s, and decode at the text's
              length s (where the reference's ``Engine.generate``
              decodes) must fall outside the bound. Every decode check
              also measures the two prefills' disagreement at their last
              shared position (``prefill_floor``); where that bf16 noise
              of the model itself exceeds bf16_rel (llava: the s and
              s + 1 prefills split their keys into 3 and 4 flash-scan
              blocks), the bf16 decode is held to the floor plus
              bf16_rel, beside the float32 check. ``generate`` must
              launch none of the kernels.
16. kernels — each kernel against its plain version on the main path's plan
              tensors and on a seeded plan-shaped input with deleted prefix
              slots, arrived vertices and a live append region
              (segment_reduce's add also against a second call, bit for
              bit, and its per-plan layout's build time and counts logged;
              gspmm at F = 1, 8 and 128, add/max/mean, scalar and per-feature
              weights, add also against a second call, bit for bit, and
              at the batched GNN runs' F = GSPMM_LANE_WIDTH;
              masked_update, the glob-form update that closes the dist
              path's exchanges, scalar and at the GNN state's F=8 on the
              main plan, and at a world-DIST_BLOCK_WORLD rank's block
              ([K/2, Vmax], [K/2, Vmax, 3], [K/2, Vmax, 8] and [K/2, Vmax,
              SERVE_LANES], each exact, and F = 1, 3, 8 at an odd,
              unaligned [3, Vmax - 1 or - 2]; timed beside its
              bound, its row's launches the dist phase's); exchange,
              the whole replica exchange, at F = 1 and 8, min/add/max, on
              the main path's plan, the patched one, a hub in all K
              partitions and the main graph compiled for K + 1 partitions
              (the last empty): bit for bit against its layout's plain
              walk, min and max exact and add within EXCHANGE_ADD_ATOL of
              the reference chain, two add calls the same bits, and each
              plan's layout build time and counts logged);
              lane_cumsum on DFEP's [2·e_pad, 16] and [V, 16] 0/1 arrays
              (int32, exact) and a float32 case, frontier_min on [16, V]
              with the real member mask and at multi-source SSSP's
              [16, N_SOURCES·V] (both timed; each of the two kernels'
              timing graphs is replayed once more on a changed input and
              held exact against the plain version, which catches look-back
              flags that were not reset), minplus_sweep on ETSCH's flat
              [K·V] state, the whole graph, multi-source SSSP's [K·8·V]
              state and usroads' flat state at costs 1 and 0, with and
              without a prebuilt layout (all exact; each timed, its timing
              graph replayed once more and held exact; the layouts' build
              time logged); then timed: device time from CUDA-graph replays
              (``ms``, ``plain_ms``, ``library_ms``) and eager back-to-back
              calls with their host launch cost (``*_eager_ms``), exchange
              at EXCHANGE_CASES against the parent's chain (its
              ``library_ms``: where, full, scatter_reduce_ and the
              masked_update kernel), also in turns (chain, kernel, kernel,
              chain), segment_reduce and exchange (min) at the serve
              path's lane widths SERVE_WIDTHS (exact against their plain
              versions; the rows gain ``lanes`` and ``serve_launches``),
              gspmm
              at F = 8 and 128 with scalar weights and at kge_score's F = 8
              with per-feature weights, also with only its largest hub run
              live and with no live slot (the difference is the hub run's
              time); prints one
              ``{"kernels": [...]}`` line (segment_reduce, exchange, gspmm
              and lane_cumsum rows also carry the stream phase's launches,
              ``stream_launches``; segment_reduce's ``stream`` lists its
              device ms per batch on the patched and the recompiled plan,
              lane_cumsum's ``reauction`` both re-auctions' rounds). selective_scan is held against
              its plain loop (y and h_last within SCAN_REL) on seeded
              inputs at the prefill shape with a zero and a random h0, at
              S = 1, and on the lm and lm.hybrid phases' captured layer
              inputs, and timed at the prefill shape, at S = 1 and on
              jamba's inputs, each beside its bound (bytes, float32
              operations, and exps at the SFUs' rate); its row also
              carries lm.hybrid's launches (``launches_hybrid``), and
              gspmm's the batched GNN runs' (``serve_lanes_launches``)
              and its times at F = GSPMM_LANE_WIDTH (``lanes``).
17. cpu     — dblp at scale 0.03, K=16, the same starts: the port on the card
              and the port on the CPU give the same DFEP owner array and
              rounds, the same engine SSSP result, the same ETSCH SSSP and CC
              (same ids) states and counters, and the same partition
              metrics; and the falcon-mamba, qwen2-moe, qwen3-4b, jamba,
              deepseek-v2, whisper and llava SMOKE models with the same
              parameters (and the same frames or image embeddings) on
              both: logits within bf16_rel of their depth, and the card's
              greedy tokens the CPU's (up to bfloat16 ties);
              then two gloo ranks run sharded DFEP and the sharded
              engine's SSSP on card 0 and on the CPU, which must give the
              same owner, rounds, state and counters.
18. train   — training, after the kernels phase (run before the cpu
              phase; every earlier model freed): qwen3-0.6b whole under
              the TUNED profile (FA-2's backward, the additive mask,
              block remat) through ``Trainer``: every parameter leaf's
              gradient finite and non-zero on the first batch; TRAIN_STEPS
              steps of TRAIN_BATCH × TRAIN_SEQ tokens from
              ``SyntheticPipeline`` with a checkpoint every
              TRAIN_CKPT_EVERY (warm median step, tokens/s, peak MiB,
              first and last loss, grad_norm); a Trainer restarted from a
              directory holding only the mid-run checkpoint must restore
              the state saved there bit for bit and reach TRAIN_STEPS; one
              step and one AdamW update under ``torch.profiler`` (the
              casts' and AdamW's shares of the step's device time);
              TRAIN_REPEAT_STEPS steps on one batch must lower its loss.
              ``flash_fa2`` against autograd through the plain flash scan
              at TRAIN_FLASH_SHAPE (FLASH_GRAD_REL). falcon-mamba-7b at
              full width cut to TRAIN_SSM_LAYERS layers: every leaf's
              gradient finite and non-zero, then TRAIN_SSM_STEPS steps of
              TRAIN_SSM_BATCH × TRAIN_SSM_SEQ with the counters zeroed just
              before and read just after (``selective_scan_bwd`` once a
              layer a step, ``selective_scan`` in the forward and the
              remat recompute); ``selective_scan_bwd`` held against
              ``selective_scan_bwd_ref`` and autograd through
              ``selective_scan_ref`` at TRAIN_SCAN_SHAPE with a random h0
              and dh_last, and against ``selective_scan_bwd_ref`` at
              SCAN_BWD_RAGGED (each of the seven gradients within
              SCAN_GRAD_REL), the forward's chunk states within SCAN_REL,
              timed beside its bound. Then one float32-compute train step
              of each of TRAIN_CPU_LAYERS on the card and on the CPU
              (loss, gradients, and AdamW on the same gradients). The
              kernels line gains the ``selective_scan_bwd`` row and the
              ``selective_scan`` row its ``train_launches``.
19. dryrun  — the launch tooling, after train. (a) ``launch.dryrun.run_cell``
              on the host for DRYRUN_CELLS on the production meshes
              (16×16, and 2×16×16 for the last): each record ``ok`` or
              ``skipped``, never ``error``; each one's roofline terms and
              ``count_s`` logged. (b) DRYRUN_CARD_CELLS on a 1×1 mesh,
              each counted on ``meta`` stand-ins by the dry run and then
              run once on the card under the same ``roofline.count``
              counter, through ``launch.dryrun.run_step`` on real tensors
              (seeded random weights, ``SyntheticPipeline`` batches; the
              decode cell's caches from a real prefill of its prompt,
              grown): qwen3-0.6b's train step under TUNED at TRAIN_BATCH ×
              TRAIN_SEQ, falcon-mamba-7b's at TRAIN_SSM_LAYERS layers and
              TRAIN_SSM_BATCH × TRAIN_SSM_SEQ (``selective_scan`` and
              ``selective_scan_bwd`` priced on ``meta``, launched on the
              card), and qwen3-4b's BASELINE decode step at LM_BATCH after
              an LM_PROMPT-token prompt. The dry run's argument bytes must
              equal the bytes of the real step's argument tensors, its
              FLOPs and bytes the card count's exactly, and its kernel
              launches both the card count's and ``ops.LAUNCHES``' rise.
              Logged, with no bound: the roofline time against the warm
              step's wall time (the median of DRYRUN_WARM steps), and the
              temp estimate against the step's rise of
              ``max_memory_allocated`` over what was allocated before it.
20. shard   — sharded execution over ``torch.distributed`` (``sharding.env``
              live meshes), every rank a process spawned here on card 0
              after the kernels are built (world 1 over NCCL, world 2 over
              gloo with CUDA tensors: NCCL refuses two ranks on one card).
              First, in this process, qwen2-moe-a2.7b's one-device prefill
              logits, drops and LM_NEW generated tokens on seeded prompts,
              and the one-device first train step of falcon-mamba-7b cut
              to SHARD_SSM_LAYERS. qwen3-0.6b whole under TUNED at
              TRAIN_BATCH x TRAIN_SEQ, every rank drawing the weights from
              the seeded generator and keeping its shard: at world 1,
              SHARD_STEPS one-device steps and SHARD_STEPS steps at a live
              1 x 1 mesh; at world 2, SHARD_STEPS steps at each of
              SHARD_MESHES; the first step's loss within SHARD_LOSS_REL
              and grad_norm within SHARD_GRAD_REL of the one-device
              step's (the later steps' printed beside theirs), every rank
              the same losses; warm step s, each rank's peak MiB,
              each collective kind's bytes and device ms (CUDA events)
              beside the dry run's ``collective_bytes`` rule for the same
              step. At world 2 also: falcon-mamba-7b cut to
              SHARD_SSM_LAYERS, one train step at SHARD_MOE_MESH (the
              launch counters zeroed just before it and read just after:
              ``selective_scan_bwd`` once a layer, ``selective_scan``
              twice (the forward and the remat recompute) on
              this rank's d_inner / 2 channels, its first call's arguments
              held against the plain scan within SCAN_REL), the loss and
              grad_norm against the one-device step's; qwen2-moe-a2.7b
              whole served at SHARD_MOE_MESH (the ranks draw the weights
              one after another): on the lm phase's prompts the capacity
              the one-device call's (dp = 1) and the drops per layer; on
              LM_DROPFREE prompts, which no capacity can drop, the
              gathered prefill logits within F32_DECODE_REL of the
              one-device prefill's largest logit in float32 compute. In
              bfloat16, the lm phase's prompts with the one-device run's
              experts replayed (``layers.replay_routing``) within
              SHARD_MOE_REL of its largest logit (the one-device
              prefill's own bfloat16 error against float32 compute on
              the same experts printed beside), with its drops; with
              each run routing on its own (the logits printed), on both
              prompt sets, the routing against the one-device run's: a
              token whose top-k holds a near-tie may choose another
              expert when the tp all-reduces round otherwise, which
              changes it and, through attention and the capacity slots,
              later tokens. Each token that did so at the first layer
              where any did had top-k router-logit gaps in the two runs
              that add to at most two bfloat16 ulps;
              SHARD_DECODE_STEPS decode steps (ms a step),
              ``Engine.generate``'s tokens against the one-device ones
              (the count that agree), each rank's peak MiB while drawing
              and while serving, the prefill's collective bytes beside
              the rule's. The kernels line's selective_scan rows gain
              ``shard_launches`` and ``shard_shape``.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402

# The H100 SXM's published peaks (NVIDIA data sheet) at a 700 W limit, from
# the port's one copy of them.
HBM_BYTES_PER_S = MESH.HBM_BW
FP32_FLOPS = MESH.FP32_FLOPS
# Tolerances, each with its reason:
#  * segment_reduce add: the kernel sums a run in slot order, or in a
#    warp's or a block's shuffle tree, then the target's append
#    slots in slot order; the plain version scatters with atomics in another
#    order. Hub runs hold thousands of float32 terms.
SEG_ADD_RTOL = 1e-4
#  * PageRank kernel path vs plain path on the card: the same sums in other
#    orders, 30 supersteps; ranks are ~3e-6, so the bound is relative.
PR_PLAIN_RTOL = 1e-4
#  * PageRank vs a float64 numpy oracle: float32 accumulation over 30 steps.
PR_ORACLE_RTOL = 1e-3
#  * gspmm add/mean vs plain, on non-negative features and weights: the
#    kernel sums a run in slot order over a tile's lane groups, or a hub's
#    chunks in a fixed tree and then in chunk order; the plain version
#    scatters with atomics in another order. Hub runs hold ~10^4 float32
#    terms.
GSPMM_ADD_RTOL = 1e-4
#    PPR is held element by element to PR_PLAIN_RTOL / PR_ORACLE_RTOL, as
#    PageRank is: its ranks are positive and ~3e-6 on average, so a bound
#    relative to the largest rank would pass a result wrong almost
#    everywhere.
#  * gcn_layer and kge_score, kernel path vs plain path on the card: the
#    same float32 sums in other orders; a bound relative to the largest
#    value, since their outputs change sign and cancel (an elementwise
#    relative bound is undefined near 0).
GNN_PLAIN_REL = 1e-4
#  * the same vs float64 numpy oracles: float32 accumulation (KGE's hub
#    sums run over ~10^5 unnormalised terms, where absolute bounds drift).
GNN_ORACLE_REL = 1e-3
#  * lane_cumsum on float32 values in [0, 1) against a float64 cumsum,
#    relative to the running sum: float32 rounding over 1.9 M terms, summed
#    per tile and per row group rather than in order. int32 is exact.
FLOAT_CUMSUM_RTOL = 1e-4
#  * exchange add vs the reference chain, on values in [0, 1): the same
#    sums of at most K = 16 terms in another order (the chain's atomics),
#    a few float32 roundings of sums below 16 (an ulp there is 1.9e-6).
#    Against the layout's plain walk every combine is bit for bit.
EXCHANGE_ADD_ATOL = 1e-5
#  * selective_scan kernel vs its plain loop, relative to the largest
#    |y| and |h_last|: both float32 and the same recurrence; the kernel
#    contracts multiply-adds and sums the 16-term dot in shuffle order
#    (~2e-7 measured on seeded inputs), and 512 steps compound that.
SCAN_REL = 1e-5
#  * two bfloat16 runs of the same n-layer model that round differently,
#    relative to the largest logit: bf16_rel(n) (below). Used for decode
#    logits vs the last logits of a prefill of one more token (cuBLAS sums
#    at M = 4 and at M = 2,052 in other orders; on the CPU the port gives
#    exactly 0.0 there), and for the SMOKE model on the card vs on the CPU
#    (cuBLAS vs the CPU's GEMMs), where greedy tokens must be the CPU's
#    wherever the CPU's top two logits are further apart than the bound
#    (bf16 logits tie, and a flip decides a tie).
#  * the MoE layer with its experts renamed by a placement's permutation
#    against the layer as it was, on the same input, relative to the
#    largest |y|: each token's float32 combine runs in ascending expert
#    id, which the renaming reorders, and a bfloat16 output near a
#    rounding boundary rounds the other way: two bf16 ulps, 2^-7.
MOE_PERM_REL = 2.0 ** -7
#  * the port's flash scan (float32) against SDPA (bfloat16, its own
#    kernel) at the prefill's shapes, relative to the largest |out|: both
#    round to bfloat16 at the end, SDPA's products in bfloat16 too; a
#    yardstick, not a check of the path.
SDPA_REL = 2.0 ** -6
#  * decode for token s against a prefill of s + 1 with the compute dtype
#    float32 (``layers.COMPUTE_DTYPE`` switched for the check), relative to
#    the largest logit: the same functions summed in other orders
#    (cuBLAS at M = B and at M = B·S, one softmax against the flash
#    scan's blocks) over at most 20,480 terms; 2.55e-5 measured on
#    llava-next-34b at 20 layers. It holds the caches, offsets and cross
#    k/v of the encdec and vlm phases exactly, where bf16 noise cannot
#    (below).
F32_DECODE_REL = 1e-4
DBLP_SCALE, K, SEED = 1.0, 16, 0
#: The analysis phase's sync cross-check: the selective-scan root at
#: float32 [B, S, Di, N] (with h0) and the FA-2 root at bfloat16 [B, H, S,
#: dh] (k and v with as many heads, causal, in ANALYSIS_FA2_BLOCK-key
#: blocks), forward and backward once each.
ANALYSIS_SCAN_SHAPE = (2, 256, 1024, 16)
ANALYSIS_FA2_SHAPE, ANALYSIS_FA2_BLOCK = (2, 8, 512, 64), 256
#: The lm phase: falcon-mamba-7b at full width and depth, B prompts of S
#: tokens, LM_NEW new tokens each.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "falcon-mamba-7b", 4, 512, 16
#: The lm.moe and lm.dense phases: qwen2-moe-a2.7b and qwen3-4b at full
#: width and depth, the lm phase's batch, prompts and new tokens.
LM_MOE_ARCH, LM_DENSE_ARCH = "qwen2-moe-a2.7b", "qwen3-4b"
#: The lm.hybrid and lm.mla phases: jamba-v0.1-52b and deepseek-v2-236b at
#: full width, their depth cut (``dataclasses.replace(cfg, n_layers=...)``)
#: to what one 80 GB card holds in float32: jamba to one block repeat (8
#: layers, 13.30 B parameters, 49.5 GiB), deepseek-v2 to 3 layers (12.96 B,
#: 48.3 GiB); the init's out-projection scale follows the cut n_layers.
LM_HYBRID_ARCH, LM_HYBRID_LAYERS = "jamba-v0.1-52b", 8
LM_MLA_ARCH, LM_MLA_LAYERS = "deepseek-v2-236b", 3
#: The lm.encdec phase: whisper-small whole (12 encoder and 12 decoder
#: layers), B prompts of S text tokens (S + LM_NEW stays inside whisper's
#: 448-position decoder context) over its 1,500 encoder frames.
LM_ENCDEC_ARCH, LM_ENCDEC_BATCH, LM_ENCDEC_PROMPT = "whisper-small", 4, 224
#: The lm.vlm phase: llava-next-34b at full width, its depth cut to 20 of
#: 60 layers (12.07 B parameters, 45.0 GiB in float32), B prompts of S
#: text tokens after its 2,880 image embeddings: 2,880 + 1,215 = 4,095 =
#: 3 x 1,365 keys, and the decode check's 4,096 = 4 x 1,024, both of which
#: the flash scan's block rule splits.
LM_VLM_ARCH, LM_VLM_LAYERS = "llava-next-34b", 20
LM_VLM_BATCH, LM_VLM_PROMPT = 2, 1215
LM_VLM_CUT = ("45.0 GiB of float32 weights at 20 layers (128.1 GiB at 60); "
              "2 prompts, not 4: the flash scan's [2, 8, 7, 4095, 1365] "
              "float32 score blocks (2.5 GB each, several live) put the "
              "peak near 60 GiB, and 4 prompts near 70")
#: The MoE model's drop-free decode check: B prompts of S tokens with
#: B · (S + 1) no more than the capacity's floor of 8 slots an expert, so
#: no prefill can drop a token (a token routes to an expert once).
LM_DROPFREE = (2, 3)
#: The moe_dfep phase: DFEP places qwen2-moe's 60 experts on this many
#: shards, from the expert ids its first MoE layer routed in the prefill.
MOE_DFEP_SHARDS = 8
CPU_CHECK_SCALE = 0.03
#: The kernels each path must launch.
MAIN_KERNELS = ("segment_reduce", "exchange")
GNN_KERNELS = ("gspmm", "segment_reduce", "exchange")
ETSCH_KERNELS = ("minplus_sweep", "frontier_min")
#: etsch_multi_sssp's seeded sources.
N_SOURCES = 8
#: etsch_kcore's k. The dblp stand-in (Barabási–Albert, m = 3) is
#: 3-degenerate: its 3-core is the whole graph and its 4-core is empty, so
#: no k has a core strictly between; k = 4 peels the whole graph away, the
#: longest run.
K_CORE = 4
#: exchange cases timed: (label, F, combine) — the main path's scalar min
#: (SSSP, WCC) and add (PageRank), the gnn path's [K, Vmax, 8] add and max.
EXCHANGE_CASES = (("f1_min", 1, "min"), ("f1_add", 1, "add"),
                  ("f8_add", 8, "add"), ("f8_max", 8, "max"))
#: The hub plan of the exchange check: a star of this many leaves.
EXCHANGE_HUB_LEAVES = 100_000
#: gspmm widths timed: the GNN programs' (8) and fig_gnn.py's widest (128).
GSPMM_WIDTHS = (8, 128)
#: Interleaved repeats of the largest hub run's timing (its spread is the
#: run-to-run noise of a difference of two device times).
HUB_REPEATS = 3
#: The serve phase: multi_source_sssp's lanes, run_batched's lanes for
#: bfs and wsssp and the rows of their warm block set to +inf (cold), the
#: GraphServer's tenants and its seeded request stream, and a second
#: stream for ``drain``. Add programs (pagerank, ppr, gcn_layer) are held
#: to their solo runs within SERVE_ADD_ATOL (the reference's oracle
#: bound); min programs bit for bit.
SERVE_LANES, SERVE_SMALL, SERVE_COLD_ROWS = 32, 8, (2, 5)
SERVE_TENANTS, SERVE_REQUESTS, SERVE_DRAIN = 4, 256, 64
#: The ledger-wired server: its device seconds must reconcile with the
#: server's device_time_s within LEDGER_DEVICE_RTOL (the reference's
#: accounting invariant), and each dispatched batch's utilization (the
#: cost model's least time over the measured time) must lie in
#: (0, LEDGER_UTIL_MAX]: above 1 the count prices work the batch did not
#: do; the 5% allow for the host clock around the copy to the host.
LEDGER_DEVICE_RTOL, LEDGER_UTIL_MAX = 0.01, 1.05
#: Requests of the traced run whose forced alert dumps a flight bundle.
SERVE_TRACED = 64
#: Turns of (plain, ledger, ledger, plain) serves timing the ledger's
#: host cost: one turn's two ratios spread by a third on the card.
LEDGER_QPS_PAIRS = 3
SERVE_ADD_ATOL = 1e-5
SERVE_KERNELS = ("segment_reduce", "exchange", "gspmm")
#: gspmm's width in the serve phase's batched GNN runs: SERVE_SMALL lanes
#: of gcn_layer's 8 input features or kge_score's 8 on its feature axis.
GSPMM_LANE_WIDTH = SERVE_SMALL * 8
#: Lane widths at which segment_reduce and exchange are timed: a full
#: micro-batch of the default buckets (32) and a middle one (8).
SERVE_WIDTHS = (8, 32)
#: The stream phase: update batches of STREAM_FRAC of |E| deletes and as
#: many inserts each (benchmarks/fig_stream.py:54-57's default batch), the
#: trickle after them (STREAM_TRICKLE deletes and as many inserts: its
#: radius-0 re-auction region stays a few thousand edges, so its moves fit
#: the partitions' slack and come out as a patch), the seeded requests
#: served across the first patch, and PageRank(30) against its float64
#: oracle within STREAM_PR_ATOL (the reference's oracle bound) beside
#: PR_ORACLE_RTOL.
STREAM_BATCHES, STREAM_FRAC, STREAM_REQUESTS = 4, 0.04, 56
STREAM_TRICKLE = 1024
STREAM_PR_ATOL = 1e-5
STREAM_KERNELS = ("segment_reduce", "exchange", "gspmm", "lane_cumsum")
#: The dist phase: (world size, backend), every rank a process on card 0.
#: NCCL refuses two ranks on one device, so world 2 runs over gloo with
#: CUDA tensors. DFEP at fig8_scalability's fixed rounds
#: (benchmarks/fig8_scalability.py:27); a collective that waits longer
#: than DIST_TIMEOUT_S raises in its rank.
DIST_WORLDS = ((1, "nccl"), (2, "gloo"))
DIST_DFEP_ROUNDS = 60
DIST_TIMEOUT_S = 300
DIST_KERNELS = ("segment_reduce", "masked_update", "lane_cumsum",
                "frontier_min", "minplus_sweep")
#: masked_update is timed at a rank's block of the main plan at this world
#: size, at F = 1 and at the serve phase's SERVE_LANES lanes.
DIST_BLOCK_WORLD = 2


def bf16_rel(n_layers: int) -> float:
    """Bound between two bf16 runs of one n-layer model that round
    differently: each layer's residual output may round one bf16 ulp
    (2^-8 relative) the other way, and such flips add like a random walk,
    √n · 2^-8; the bound is twice that (6.25% at 64 layers, 1.6% at 4)."""
    return 2 * n_layers ** 0.5 * 2.0 ** -8


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def wall(fn):
    """(result, seconds) of ``fn()`` on the host clock, after the device has
    finished its work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def eager_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn`` in ms over ``iters`` back-to-back eager calls
    (CUDA events): device time, or the host's launch cost where that is
    longer."""
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


def device_ms(fn, iters: int = 20, replays: int = 5, check=None) -> float:
    """Mean device time of one ``fn`` call in ms: ``iters`` calls captured
    in a CUDA graph, replayed ``replays`` times between CUDA events, so no
    host launch cost is in the number. ``fn`` is warmed first (lazy
    library loads, memoised plan indices) on a side stream. With ``check``,
    after the timing replays ``check(replay, out)`` is called with the
    graph's replay and the output of its last ``fn`` call, to hold one more
    replay against the plain version."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    if check is not None:
        check(graph.replay, out)
    return start.elapsed_time(end) / (iters * replays)


def peak_mib() -> float:
    return torch.cuda.max_memory_allocated() / 2**20


# ---------------------------------------------------------------------------
# Oracles (host, independent of the port)
# ---------------------------------------------------------------------------

def csr_of(g):
    from scipy.sparse import coo_matrix
    u, v = g.as_numpy()
    n = g.n_vertices
    a = coo_matrix((np.ones(len(u)), (u, v)), shape=(n, n)).tocsr()
    return (a + a.T).tocsr()


def sssp_oracle(csr, source: int) -> np.ndarray:
    from scipy.sparse.csgraph import shortest_path
    return shortest_path(csr, unweighted=True, indices=source).astype(np.float32)


def wcc_oracle(csr) -> np.ndarray:
    from scipy.sparse.csgraph import connected_components
    n_comp, labels = connected_components(csr, directed=False)
    mins = np.full(n_comp, csr.shape[0], np.int64)
    np.minimum.at(mins, labels, np.arange(csr.shape[0]))
    return mins[labels].astype(np.float32)


def pagerank_oracle(g, iters: int = 30, damping: float = 0.85,
                    personalization=None) -> np.ndarray:
    """Float64 PageRank; with ``personalization`` p, personalized PageRank
    (``rank <- (1-d) p + d inflow``, starting from p)."""
    u, v = g.as_numpy()
    n = g.n_vertices
    deg = np.maximum(np.bincount(np.concatenate([u, v]), minlength=n), 1)
    tele = np.full(n, 1.0 / n) if personalization is None \
        else np.asarray(personalization, np.float64)
    rank = tele.copy()
    for _ in range(iters):
        c = rank / deg
        inflow = np.bincount(v, c[u], n) + np.bincount(u, c[v], n)
        rank = (1.0 - damping) * tele + damping * inflow
    return rank


def wsssp_oracle(g, source: int, weights: np.ndarray) -> np.ndarray:
    """Weighted shortest paths as a float32 min-plus fixpoint: every
    relaxation is ``min(d[t], f32(d[s] + w))``, the engine's operation, so
    the fixpoint is bit-equal to it (the logic of the reference's
    ``reference_weighted_sssp``; the per-target min is a ``reduceat`` over
    target-sorted half-edges)."""
    u, v = g.as_numpy()
    src, dst = np.concatenate([u, v]), np.concatenate([v, u])
    w = np.concatenate([weights, weights]).astype(np.float32)
    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    starts = np.flatnonzero(np.r_[True, dst[1:] != dst[:-1]])
    tgt = dst[starts]
    dist = np.full(g.n_vertices, np.inf, np.float32)
    dist[source] = 0.0
    for _ in range(g.n_vertices):
        best = np.minimum.reduceat((dist[src] + w).astype(np.float32), starts)
        new = dist.copy()
        new[tgt] = np.minimum(new[tgt], best)
        if np.array_equal(new, dist):
            break
        dist = new
    return dist


def labelprop_oracle(csr, labels: np.ndarray) -> np.ndarray:
    """Every vertex takes the smallest label of its component."""
    from scipy.sparse.csgraph import connected_components
    n_comp, comp = connected_components(csr, directed=False)
    mins = np.full(n_comp, np.inf, np.float32)
    np.minimum.at(mins, comp, labels)
    return mins[comp]


def gcn_oracle(g, x, weight, ew) -> np.ndarray:
    """``(D^-1/2 A_w D^-1/2 X) W`` in float64 (``reference_gcn_layer``'s
    formula: A_w symmetric with the content-hash weights, no self-loops,
    degrees clamped at 1)."""
    from scipy.sparse import coo_matrix
    u, v = g.as_numpy()
    n = g.n_vertices
    deg = np.maximum(np.bincount(np.concatenate([u, v]), minlength=n), 1)
    inv = 1.0 / np.sqrt(deg.astype(np.float64))
    a = coo_matrix((ew.astype(np.float64), (v, u)), shape=(n, n)).tocsr()
    agg = (a + a.T) @ (x.astype(np.float64) * inv[:, None])
    return (agg * inv[:, None]) @ weight.astype(np.float64)


def kge_oracle(g, entity, relation) -> np.ndarray:
    """DistMult mass per vertex in float64 (``reference_kge_score``'s
    formula): each live edge e = (u, v) scores sum_f ent_u·rel_e·ent_v onto
    both endpoints; relation rows are graph edge slots."""
    slots = np.flatnonzero(g.edge_mask.cpu().numpy())
    u = g.src.cpu().numpy()[slots]
    v = g.dst.cpu().numpy()[slots]
    ent = entity.astype(np.float64)
    score = np.sum(ent[u] * relation[slots].astype(np.float64) * ent[v], 1)
    n = g.n_vertices
    return np.bincount(u, score, n) + np.bincount(v, score, n)


def kcore_oracle(g, k_core: int) -> np.ndarray:
    """The k-core by peeling on the host: drop vertices of live degree
    below k until none is left to drop."""
    u, v = g.as_numpy()
    n = g.n_vertices
    active = np.bincount(np.concatenate([u, v]), minlength=n) > 0
    while True:
        live = active[u] & active[v]
        deg = (np.bincount(u[live], minlength=n)
               + np.bincount(v[live], minlength=n))
        new = active & (deg >= k_core)
        if np.array_equal(new, active):
            return active
        active = new


def is_mis_oracle(csr, in_set: np.ndarray) -> bool:
    """``in_set`` is a maximal independent set of the graph ``csr``: no
    edge inside it, and every vertex with an edge is in it or next to it."""
    coo = csr.tocoo()
    independent = not (in_set[coo.row] & in_set[coo.col]).any()
    nbr_in = np.zeros(len(in_set), bool)
    nbr_in[coo.row[in_set[coo.col]]] = True
    has_edge = np.diff(csr.indptr) > 0
    return independent and bool((in_set | nbr_in | ~has_edge).all())


def max_rel(a: torch.Tensor, b) -> float:
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    return float(((a.double() - b).abs() / b.abs()).max())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_analysis() -> dict:
    """Phase 0, on the host: the port's static analyzer
    (``repro_torch.analysis``) over ``src/repro_torch`` with the port's
    suppressions, found by the walk up from the root, as ``python -m
    repro_torch.analysis src/repro_torch`` runs it. Any unsuppressed
    finding or unused suppression fails the phase."""
    require(torch.cuda.is_available(), "no CUDA device: chip_smoke.py "
            "drives the port on the GPU")
    from repro_torch import analysis as A
    from repro_torch.analysis import suppressions as S
    from repro_torch.analysis.runner import iter_sources, render_text

    root = str(ROOT / "src" / "repro_torch")
    t0 = time.perf_counter()
    supp_path = S.discover(root)
    require(supp_path is not None, f"no {S.FILENAME} above {root}")
    with open(supp_path, encoding="utf-8") as f:
        supps = S.parse(f.read(), A.all_rules(), supp_path)
    files = iter_sources([root])
    findings = A.scan(files)
    kept, silenced = S.apply(findings, supps)
    out = {"rules": len(A.all_rules()), "files": len(files),
           "findings": len(findings), "suppressed": len(silenced),
           "unsuppressed": len(kept),
           "suppressions": os.path.relpath(supp_path, ROOT),
           "unused_suppressions": [f"{s.rule} {s.path_glob} {s.symbol_glob}"
                                   for s in supps if not s.used],
           "host_s": time.perf_counter() - t0}
    log({"phase": "analysis", **out})
    require(not kept, "unsuppressed analyzer findings:\n" + render_text(kept))
    require(not out["unused_suppressions"],
            f"unused suppressions: {out['unused_suppressions']}")
    return out


def _sync_free(name: str, fn) -> dict:
    """``fn()`` (a forward and backward through one trace root) under
    ``torch.cuda.set_sync_debug_mode("error")``: any synchronising call
    raises out of here, so a return means none was made. The kernels'
    launches during the call and its host seconds are returned."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    before, prev = dict(ops.LAUNCHES), torch.cuda.get_sync_debug_mode()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = fn()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    require(finite, f"{name}: a gradient is not finite")
    return {"root": name, "syncs": 0, "host_s": host_s,
            "launches": {k: v - before[k] for k, v in ops.LAUNCHES.items()
                         if v != before[k]}}


def phase_analysis_sync() -> list:
    """The analysis phase on the card, once the kernels are built: TS002's
    cross-check where it matters. The ``_SelectiveScan`` root
    (``ops.selective_scan`` at ANALYSIS_SCAN_SHAPE, float32, with h0:
    the forward kernel with chunk states, then ``selective_scan_bwd``) and
    the ``_FlashFA2`` root (``flash_fa2`` at ANALYSIS_FA2_SHAPE, bfloat16,
    causal) each run forward and backward once under
    ``set_sync_debug_mode("error")``: neither may synchronise, and the
    scan must launch each of its two kernels once."""
    from repro_torch.kernels import ops
    from repro_torch.models.flash_vjp import flash_fa2

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    b, s, d, n = ANALYSIS_SCAN_SHAPE
    scan_in = [randn(b, s, d), torch.nn.functional.softplus(randn(b, s, d)),
               randn(b, s, n, scale=0.5), randn(b, s, n, scale=0.5),
               torch.exp(randn(d, n, scale=0.3)), randn(d), randn(b, d, n)]
    dy, dh = randn(b, s, d), randn(b, d, n)
    scan_in = [t.requires_grad_(True) for t in scan_in]

    def scan():
        y, h_last = ops.selective_scan(*scan_in)
        return torch.autograd.grad((y * dy).sum() + (h_last * dh).sum(),
                                   scan_in)

    fb, fh, fs, fd = ANALYSIS_FA2_SHAPE
    qkv = [randn(fb, fh, fs, fd, dtype=torch.bfloat16).requires_grad_(True)
           for _ in range(3)]
    dout = randn(fb, fh, fs, fd, dtype=torch.bfloat16)

    def fa2():
        out = flash_fa2(*qkv, True, ANALYSIS_FA2_BLOCK)
        return torch.autograd.grad(out, qkv, dout)

    rows = [dict(_sync_free("_SelectiveScan", scan),
                 shape=list(ANALYSIS_SCAN_SHAPE), dtype="float32"),
            dict(_sync_free("_FlashFA2", fa2), shape=list(ANALYSIS_FA2_SHAPE),
                 dtype="bfloat16", block=ANALYSIS_FA2_BLOCK)]
    log({"phase": "analysis.sync", "mode": "error", "roots": rows})
    require(rows[0]["launches"] == {"selective_scan": 1,
                                    "selective_scan_bwd": 1},
            f"the scan root's launches: {rows[0]['launches']}")
    return rows


def phase_device():
    require(torch.cuda.is_available(), "no CUDA device: chip_smoke.py "
            "drives the port on the GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    from repro_torch import cuda_build
    t0 = time.perf_counter()
    per_lib = cuda_build.build()
    log({"phase": "device", "card": card,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": time.perf_counter() - t0, "build_s_per_source": per_lib})
    for name in cuda_build.SIGNATURES:
        regs = [ln.strip() for ln in cuda_build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        log({"phase": "device", "ptxas": name, "info": regs})
    return card


def _one_exchange_a_superstep(launches: dict, results, path: str) -> None:
    """The engine's exchange is one ``exchange`` launch a superstep and
    never the glob-form ``masked_update``."""
    steps = sum(r.supersteps for r in results)
    require(launches["exchange"] == steps and launches["masked_update"] == 0,
            f"{path}: {launches['exchange']} exchange and "
            f"{launches['masked_update']} masked_update launches for "
            f"{steps} supersteps")


def phase_main():
    from repro_torch.core import dfep, graph
    from repro_torch import engine as E
    from repro_torch.engine import kernels
    from repro_torch.kernels import ops

    kernels.reset_launches()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    g, t = wall(lambda: graph.load_dataset("dblp", scale=DBLP_SCALE,
                                           seed=SEED))
    log({"phase": "main.load_dataset", "wall_s": t, "n_vertices": g.n_vertices,
         "n_edges": g.n_edges, "e_pad": g.e_pad,
         "max_degree": int(g.degrees().max()), "peak_mib": peak_mib()})

    torch.cuda.reset_peak_memory_stats()
    (owner, info), t = wall(lambda: dfep.partition(
        g, k=K, seed=SEED, max_rounds=4000, stall_rounds=64))
    dfep_launches = dict(ops.LAUNCHES)
    log({"phase": "main.dfep", "wall_s": t, "rounds": info["rounds"],
         "unsold_at_stop": info["unsold_at_stop"],
         "finalized": info["finalized"], "starts": info["starts"],
         "ms_per_round": 1e3 * t / max(info["rounds"], 1),
         "launches": dfep_launches, "peak_mib": peak_mib()})
    require(dfep_launches["lane_cumsum"] > 0,
            "kernel lane_cumsum was not launched by DFEP")
    own = owner.cpu().numpy()
    em = g.edge_mask.cpu().numpy()
    require(((own[em] >= 0) & (own[em] < K)).all() and (own[~em] == -2).all(),
            "DFEP owner array is not a valid K-partition")

    torch.cuda.reset_peak_memory_stats()
    plan, t = wall(lambda: E.compile_plan(g, owner, K))
    log({"phase": "main.compile_plan", "wall_s": t, "v_max": plan.v_max,
         "e_max": plan.e_max,
         "replication_factor": plan.replication_factor(),
         "exchange_volume": plan.exchange_volume, "peak_mib": peak_mib()})

    eng = E.Engine(plan)
    results = {}
    for name, run in (("sssp", lambda: E.engine_sssp(eng, 0)),
                      ("wcc", lambda: E.engine_wcc(eng)),
                      ("pagerank", lambda: E.engine_pagerank(
                          eng, g.degrees(), iters=30))):
        torch.cuda.reset_peak_memory_stats()
        before = dict(kernels.LAUNCHES)
        r, t = wall(run)
        results[name] = r
        log({"phase": f"main.{name}", "wall_s": t, **r.row(),
             "launches": {k: kernels.LAUNCHES[k] - before[k]
                          for k in kernels.LAUNCHES},
             "peak_mib": peak_mib()})
    launches = dict(kernels.LAUNCHES)
    for name in MAIN_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} was not launched on the main path")
    _one_exchange_a_superstep(launches, results.values(), "main")

    csr = csr_of(g)
    sssp = results["sssp"].state.cpu().numpy()
    require(np.array_equal(sssp, sssp_oracle(csr, 0)),
            "SSSP differs from the scipy oracle")
    wcc = results["wcc"].state.cpu().numpy()
    require(np.array_equal(wcc, wcc_oracle(csr)),
            "WCC differs from the scipy oracle")
    require(all(results[n].converged for n in ("sssp", "wcc")),
            "SSSP/WCC did not converge")
    plain_eng = E.Engine(plan, use_kernels=False)
    for name, run in (("sssp", E.engine_sssp), ("wcc", E.engine_wcc)):
        ref = run(plain_eng, *((0,) if name == "sssp" else ()))
        require(torch.equal(results[name].state, ref.state)
                and results[name].row() == ref.row(),
                f"{name}: kernel path differs from the plain path")
    pr = results["pagerank"].state
    pr_plain, t = wall(lambda: E.engine_pagerank(plain_eng, g.degrees(),
                                                 iters=30))
    rel_plain = max_rel(pr, pr_plain.state)
    rel_oracle = max_rel(pr, pagerank_oracle(g))
    require(results["pagerank"].row() == pr_plain.row(),
            "PageRank counters differ from the plain path")
    log({"phase": "main.check", "sssp_equal_oracle": True,
         "wcc_equal_oracle": True, "sssp_wcc_equal_plain": True,
         "pagerank_max_rel_vs_plain": rel_plain,
         "pagerank_plain_wall_s": t, "pagerank_max_rel_vs_f64_oracle":
             rel_oracle, "launches": launches})
    require(rel_plain <= PR_PLAIN_RTOL, f"PageRank kernel vs plain path: "
            f"max rel {rel_plain} > {PR_PLAIN_RTOL}")
    require(rel_oracle <= PR_ORACLE_RTOL, f"PageRank vs float64 oracle: "
            f"max rel {rel_oracle} > {PR_ORACLE_RTOL}")
    launches.update(dfep_launches)
    return g, owner, plan, launches, results


def phase_gnn(g, plan):
    """The GNN path and the remaining programs on the main phase's plan."""
    from repro_torch import engine as E
    from repro_torch.core.graph import edge_weights
    from repro_torch.engine import kernels

    rng = np.random.default_rng(SEED)
    n = g.n_vertices
    x = rng.normal(size=(n, E.GCN_F_IN)).astype(np.float32)
    weight = rng.normal(size=(E.GCN_F_IN, E.GCN_F_OUT)).astype(np.float32)
    entity = rng.normal(size=(n, E.KGE_F)).astype(np.float32)
    relation = rng.normal(size=(g.e_pad, E.KGE_F)).astype(np.float32)
    labels = rng.permutation(n).astype(np.float32)
    p = rng.random(n)
    p = (p / p.sum()).astype(np.float32)
    deg = g.degrees()
    runs = {
        "gcn_layer": lambda e: E.engine_gcn_layer(e, deg, x, weight),
        "kge_score": lambda e: E.engine_kge_score(e, entity, relation),
        "wsssp": lambda e: E.engine_weighted_sssp(e, 0),
        "bfs": lambda e: E.engine_bfs(e, 0),
        "labelprop": lambda e: E.engine_label_propagation(e, labels),
        "ppr": lambda e: E.engine_personalized_pagerank(e, deg, p, 30),
    }
    eng = E.Engine(plan)
    results = {}
    kernels.reset_launches()
    for name, run in runs.items():
        torch.cuda.reset_peak_memory_stats()
        before = dict(kernels.LAUNCHES)
        r, t = wall(lambda: run(eng))
        results[name] = r
        got = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        log({"phase": f"gnn.{name}", "wall_s": t, **r.row(),
             "launches": got, "peak_mib": peak_mib()})
        if name in ("gcn_layer", "kge_score"):
            require(got["gspmm"] > 0, f"{name} did not launch gspmm")
    launches = dict(kernels.LAUNCHES)
    for name in GNN_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} was not launched on the gnn path")
    _one_exchange_a_superstep(launches, results.values(), "gnn")
    # the first calls above include one-off set-up (library loads, cuBLAS
    # for gcn_layer's matmul); a second call of each is the warm query
    log({"phase": "gnn.warm", "wall_s": {name: wall(lambda: run(eng))[1]
                                         for name, run in runs.items()}})

    plain_eng = E.Engine(plan, use_kernels=False)
    plain, plain_s = {}, {}
    for name in ("gcn_layer", "kge_score", "ppr"):
        r, plain_s[name] = wall(lambda: runs[name](plain_eng))
        plain[name] = r.state

    t0 = time.perf_counter()
    csr = csr_of(g)
    u, v = g.as_numpy()
    ew = edge_weights(u, v)
    bfs = sssp_oracle(csr, 0)
    oracle = {
        "wsssp": wsssp_oracle(g, 0, ew),
        "bfs": np.where(np.isinf(bfs), np.float32(-1.0), bfs),
        "labelprop": labelprop_oracle(csr, labels),
        "ppr": pagerank_oracle(g, 30, personalization=p),
        "gcn_layer": gcn_oracle(g, x, weight, ew),
        "kge_score": kge_oracle(g, entity, relation),
    }
    oracle_s = time.perf_counter() - t0
    for name in ("wsssp", "bfs", "labelprop"):
        got = results[name].state.cpu().numpy()
        require(got.dtype == np.float32 and got.shape == (n,),
                f"{name}: result is {got.dtype} {got.shape}")
        require(np.array_equal(got, oracle[name]),
                f"{name} differs from its host oracle")
        require(results[name].converged, f"{name} did not converge")
    check = {}
    for name in ("ppr", "gcn_layer", "kge_score"):
        got = results[name].state
        want = torch.from_numpy(oracle[name]).to(got.device)
        require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                f"{name}: result {tuple(got.shape)} is not finite and of "
                f"shape {tuple(want.shape)}")
        if name == "ppr":
            rel_p, rel_o = max_rel(got, plain[name]), max_rel(got, want)
            check[name] = {"max_rel_vs_plain": rel_p,
                           "max_rel_vs_f64_oracle": rel_o,
                           "plain_wall_s": plain_s[name]}
            require(rel_p <= PR_PLAIN_RTOL, f"ppr kernel vs plain path: max "
                    f"rel {rel_p} > {PR_PLAIN_RTOL}")
            require(rel_o <= PR_ORACLE_RTOL, f"ppr vs float64 oracle: max "
                    f"rel {rel_o} > {PR_ORACLE_RTOL}")
            continue
        scale_p = float(plain[name].abs().max())
        err_p = float((got - plain[name]).abs().max())
        scale_o = float(want.abs().max())
        err_o = float((got.double() - want).abs().max())
        check[name] = {"max_abs_vs_plain": err_p, "max_abs_plain": scale_p,
                       "max_abs_vs_f64_oracle": err_o,
                       "max_abs_oracle": scale_o,
                       "plain_wall_s": plain_s[name]}
        require(err_p <= GNN_PLAIN_REL * scale_p, f"{name} kernel vs plain "
                f"path: max abs {err_p} > {GNN_PLAIN_REL} x {scale_p}")
        require(err_o <= GNN_ORACLE_REL * scale_o, f"{name} vs float64 "
                f"oracle: max abs {err_o} > {GNN_ORACLE_REL} x {scale_o}")
    log({"phase": "gnn.check",
         "bit_equal_oracle": ["wsssp", "bfs", "labelprop"],
         "oracle_s": oracle_s, **check, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# The serve phase
# ---------------------------------------------------------------------------

def _lane_counts(r, i: int) -> tuple:
    return (int(r.supersteps[i]), int(r.local_iters[i]),
            bool(r.converged[i]))


def _solo_equal(r, i: int, solo, what: str) -> None:
    """Lane ``i`` of the batched result ``r`` is the solo run ``solo``:
    the same state bit for bit and the same counters."""
    require(torch.equal(r.state[i], solo.state),
            f"{what}: lane {i} differs from its solo run")
    require(_lane_counts(r, i) == (solo.supersteps, solo.local_iters,
                                   solo.converged),
            f"{what}: lane {i} counters {_lane_counts(r, i)} vs solo "
            f"{(solo.supersteps, solo.local_iters, solo.converged)}")


def _serve_plan_cache(g, owner):
    """compile_plan_cached: a miss, then a hit that returns the same plan
    with its three kernel layouts built."""
    from repro_torch import engine as E
    E.plan_cache_clear(reset_counters=True)
    plan, t_miss = wall(lambda: E.compile_plan_cached(g, owner, K))
    hit, t_hit = wall(lambda: E.compile_plan_cached(g, owner, K))
    stats = E.plan_cache_stats()
    built = [key for key in ("_segment_layout", "_gspmm_layout",
                             "_exchange_layout") if key in hit.__dict__]
    log({"phase": "serve.plan_cache", "miss_s": t_miss, "hit_s": t_hit,
         "stats": stats, "layouts_built": built})
    require(hit is plan, "compile_plan_cached: the hit is another object")
    require(len(built) == 3, f"compile_plan_cached: layouts built {built}")
    require((stats["misses"], stats["hits"]) == (1, 1),
            f"plan cache counters {stats}")
    return plan, {"miss_s": t_miss, "hit_s": t_hit}


def _serve_multi_source(eng, sources) -> dict:
    """multi_source_sssp over SERVE_LANES sources against one solo
    engine_sssp per source: each lane bit-identical with equal counters;
    one segment_reduce launch a sweep and one exchange a superstep of the
    batch, so the launches follow the longest lane, not the sum."""
    from repro_torch import engine as E
    from repro_torch.engine import kernels
    kernels.reset_launches()
    r, t_first = wall(lambda: E.multi_source_sssp(eng, sources))
    batched = dict(kernels.LAUNCHES)
    _, t_warm = wall(lambda: E.multi_source_sssp(eng, sources))
    for s in sources[:2]:                 # warm the solo path
        E.engine_sssp(eng, int(s))
    kernels.reset_launches()
    solo, t_solo = wall(lambda: [E.engine_sssp(eng, int(s))
                                 for s in sources])
    solo_launches = dict(kernels.LAUNCHES)
    for i, one in enumerate(solo):
        _solo_equal(r, i, one, "multi_source_sssp")
    steps = [one.supersteps for one in solo]
    sweeps = [one.local_iters for one in solo]
    out = {"lanes": len(sources), "batched_first_s": t_first,
           "batched_warm_s": t_warm, "solo_warm_s": t_solo,
           "solo_over_batched": t_solo / t_warm,
           "supersteps": {"max": max(steps), "sum": sum(steps)},
           "local_iters": {"max": max(sweeps), "sum": sum(sweeps)},
           "launches_batched": batched, "launches_solo": solo_launches}
    log({"phase": "serve.multi_source_sssp", **out})
    require(batched["exchange"] == max(steps),
            f"batched exchange launches {batched['exchange']} != the "
            f"longest lane's {max(steps)} supersteps")
    require(max(sweeps) <= batched["segment_reduce"] < sum(sweeps),
            f"batched segment_reduce launches {batched['segment_reduce']}"
            f" not in [{max(sweeps)}, {sum(sweeps)})")
    require(solo_launches["exchange"] == sum(steps)
            and solo_launches["segment_reduce"] == sum(sweeps),
            f"solo launches {solo_launches}")
    return out


def _serve_run_batched(eng, rng, n) -> dict:
    """run_batched for bfs and wsssp at SERVE_SMALL lanes, cold and warm
    (the block of a one-superstep batched run, two rows +inf), each lane
    against its solo run."""
    from repro_torch import engine as E
    out = {}
    for prog in (E.BFS, E.WEIGHTED_SSSP):
        src = rng.choice(n, SERVE_SMALL, replace=False)
        bkw = {"source": src}
        r, t = wall(lambda: eng.run_batched(prog, bkw))
        for i, s in enumerate(src):
            _solo_equal(r, i, eng.run(prog, source=int(s)), prog.name)
        block = eng.run_batched(prog, bkw, max_supersteps=1).state.clone()
        block[list(SERVE_COLD_ROWS)] = float("inf")
        w, t_warm = wall(lambda: eng.run_batched(prog, bkw,
                                                 warm_state=block))
        for i, s in enumerate(src):
            solo = eng.run(prog, source=int(s)) if i in SERVE_COLD_ROWS \
                else eng.run(prog, source=int(s), warm_state=block[i])
            _solo_equal(w, i, solo, f"{prog.name} warm")
        out[prog.name] = {"cold_s": t, "warm_s": t_warm,
                          "supersteps_cold": r.supersteps.tolist(),
                          "supersteps_warm": w.supersteps.tolist()}
    log({"phase": "serve.run_batched", "lanes": SERVE_SMALL,
         "cold_rows": list(SERVE_COLD_ROWS), **out})
    return out


def _serve_gspmm_lanes(eng, g, rng) -> dict:
    """run_batched of gcn_layer (batched x [SERVE_SMALL, V, 8]) and of
    kge_score (batched entity [SERVE_SMALL, V, 8] and relation
    [SERVE_SMALL, e_pad, 8]): the lanes ride gspmm's feature axis, so the
    batch must launch gspmm once a sweep (one sweep: once) against one a
    lane for the solo runs; every lane within SERVE_ADD_ATOL of its solo
    run, relative to the largest |value| where that exceeds 1 (kge_score's
    unnormalised hub sums: at F = GSPMM_LANE_WIDTH the kernel sums a run's
    slots over other lane groups than at F = 8); the batch timed first and
    warm against the solo runs, warm (host wall and, from the dispatches'
    events, device seconds)."""
    from repro_torch import engine as E
    from repro_torch.engine import kernels
    n, e_pad = g.n_vertices, g.e_pad

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    deg = g.degrees()
    cases = {
        "gcn_layer": (E.GCN_LAYER, {"x": normal(SERVE_SMALL, n, E.GCN_F_IN)},
                      {"weight": normal(E.GCN_F_IN, E.GCN_F_OUT),
                       "degrees": deg}),
        "kge_score": (E.KGE_SCORE,
                      {"entity": normal(SERVE_SMALL, n, E.KGE_F),
                       "relation": normal(SERVE_SMALL, e_pad, E.KGE_F)}, {})}
    out = {}
    for name, (prog, bkw, kw) in cases.items():
        kernels.reset_launches()
        r, t_first = wall(lambda: eng.run_batched(prog, bkw, **kw))
        batched = dict(kernels.LAUNCHES)
        pending, t_warm = wall(lambda: eng.dispatch_batched(prog, bkw, **kw))

        def solo_runs():
            return [eng.dispatch(prog, **{k: v[i] for k, v in bkw.items()},
                                 **kw) for i in range(SERVE_SMALL)]
        solo_runs()                       # warm the solo path
        kernels.reset_launches()
        solo, t_solo = wall(solo_runs)
        solo_launches = dict(kernels.LAUNCHES)
        solo_device_s = sum(one.device_s() for one in solo)
        solo = [one.result() for one in solo]
        errs, scales = [], []
        for i, one in enumerate(solo):
            require(r.state[i].shape == one.state.shape,
                    f"{name}: lane {i} of shape {tuple(r.state[i].shape)}")
            errs.append(float((r.state[i] - one.state).abs().max()))
            scales.append(max(1.0, float(one.state.abs().max())))
        steps = int(r.supersteps.max())
        row = {"lanes": SERVE_SMALL, "gspmm_width": GSPMM_LANE_WIDTH,
               "batched_first_s": t_first, "batched_warm_s": t_warm,
               "solo_warm_s": t_solo, "solo_over_batched": t_solo / t_warm,
               "batched_warm_device_s": pending.device_s(),
               "solo_warm_device_s": solo_device_s,
               "supersteps": steps, "launches_batched": batched,
               "launches_solo": solo_launches, "max_abs_vs_solo": max(errs),
               "max_rel_vs_solo": max(e / s for e, s in zip(errs, scales)),
               "bound": SERVE_ADD_ATOL}
        out[name] = row
        log({"phase": f"serve.lanes.{name}", **row})
        for i, (e, sc) in enumerate(zip(errs, scales)):
            require(e <= SERVE_ADD_ATOL * sc, f"{name}: lane {i} max abs "
                    f"{e} vs its solo run > {SERVE_ADD_ATOL} x {sc}")
        require(batched["gspmm"] == steps,
                f"{name}: the batch launched gspmm {batched['gspmm']} "
                f"times in {steps} sweeps")
        require(solo_launches["gspmm"] == SERVE_SMALL * steps,
                f"{name}: solo gspmm launches {solo_launches['gspmm']}")
    return out


def _serve_requests(G, rng, n, planes, count: int) -> list:
    """A seeded stream of ``count`` requests from SERVE_TENANTS tenants,
    in a seeded order: 27/32 of them sssp, bfs and wsssp, a quarter of
    whose sources repeat an earlier request of the same program (cache
    hits, or lanes shared in one micro-batch); the rest wcc, pagerank
    (iters 20 and 30), ppr and labelprop on seeded planes, and one
    gcn_layer."""
    kinds, seen = [], {"sssp": [], "bfs": [], "wsssp": []}
    for i in range(count * 27 // 32):
        kind = ("sssp", "bfs", "wsssp")[i % 3]
        if seen[kind] and rng.random() < 0.25:
            s = seen[kind][int(rng.integers(len(seen[kind])))]
        else:
            s = int(rng.integers(n))
            seen[kind].append(s)
        kinds.append((kind, {"source": s}))
    kinds.append(("gcn_layer", {"x": planes["x"], "weight": planes["w"]}))
    others = [("wcc", {}), ("pagerank", {"iters": 20}),
              ("pagerank", {"iters": 30}),
              ("ppr", {"personalization": planes["p"]}),
              ("labelprop", {"labels": planes["labels"]})]
    while len(kinds) < count:
        kinds.append(others[len(kinds) % len(others)])
    return [G.QueryRequest(kinds[j][0], tenant=f"t{i % SERVE_TENANTS}",
                           params=kinds[j][1])
            for i, j in enumerate(rng.permutation(count))]


def _solo_value(E, eng, g, req):
    """The solo Engine run of one served query, as a host array."""
    prm = req.params
    deg = g.degrees()
    run = {"sssp": lambda: eng.run(E.SSSP, source=prm.get("source")),
           "bfs": lambda: eng.run(E.BFS, source=prm.get("source")),
           "wsssp": lambda: eng.run(E.WEIGHTED_SSSP,
                                    source=prm.get("source")),
           "wcc": lambda: E.engine_wcc(eng),
           "pagerank": lambda: E.engine_pagerank(eng, deg,
                                                 prm.get("iters")),
           "ppr": lambda: E.engine_personalized_pagerank(
               eng, deg, np.array(prm.get("personalization")),
               prm.get("iters")),
           "labelprop": lambda: E.engine_label_propagation(
               eng, np.array(prm.get("labels"))),
           "gcn_layer": lambda: E.engine_gcn_layer(
               eng, deg, np.array(prm.get("x")),
               np.array(prm.get("weight"))),
           "kge_score": lambda: E.engine_kge_score(
               eng, np.array(prm.get("entity")),
               np.array(prm.get("relation")))}[req.kind]
    return run().state.cpu().numpy()


def phase_serve(g, owner):
    """The serving path on the main phase's graph and DFEP owner: the plan
    cache, batched multi-source SSSP against solo runs, warm-started
    batches, then a GraphServer on the card answering a seeded request
    stream from several tenants, every answer against a solo run."""
    from repro_torch import engine as E
    from repro_torch import gserve as G
    from repro_torch.engine import kernels

    plan, cache_t = _serve_plan_cache(g, owner)
    n = g.n_vertices
    rng = np.random.default_rng(SEED)
    ms = _serve_multi_source(E.Engine(plan),
                             rng.choice(n, SERVE_LANES, replace=False))
    rb = _serve_run_batched(E.Engine(plan), rng, n)
    gl = _serve_gspmm_lanes(E.Engine(plan), g,
                            np.random.default_rng(SEED + 2))

    dispatches = []

    def counted(prog, lanes: int, fn):
        before = dict(kernels.LAUNCHES)
        out = fn()
        dispatches.append({"program": prog.name, "bucket": lanes,
                           "launches": _delta(before, kernels.LAUNCHES)})
        return out

    class Counted(E.Engine):
        """The engine, with the kernel launches of each dispatch logged."""
        def dispatch(self, prog, *args, **kw):
            return counted(prog, 1, lambda: E.Engine.dispatch(
                self, prog, *args, **kw))

        def dispatch_batched(self, prog, batched_kw, *args, **kw):
            lanes = len(next(iter(batched_kw.values())))
            return counted(prog, lanes, lambda: E.Engine.dispatch_batched(
                self, prog, batched_kw, *args, **kw))

    p = rng.random(n)
    planes = {"x": E.ChannelValue(rng.normal(size=(n, E.GCN_F_IN))),
              "w": E.ChannelValue(rng.normal(size=(E.GCN_F_IN,
                                                   E.GCN_F_OUT))),
              "p": E.ChannelValue(p / p.sum()),
              "labels": E.ChannelValue(rng.permutation(n))}
    reqs = _serve_requests(G, rng, n, planes, SERVE_REQUESTS)
    srv = G.GraphServer(Counted(plan), g)
    kernels.reset_launches()
    out, t_serve = wall(lambda: srv.serve(reqs))
    serve_launches = dict(kernels.LAUNCHES)
    stats = srv.stats()
    served = list(dispatches)
    for name in SERVE_KERNELS:
        require(serve_launches[name] > 0,
                f"kernel {name} was not launched on the serve path")
    for d in served:
        ls = d["launches"]
        require(ls["exchange"] > 0 and ls["segment_reduce"] + ls["gspmm"]
                > 0 and ls["masked_update"] == 0,
                f"a {d['program']} micro-batch of {d['bucket']} lanes ran "
                f"no kernel: {ls}")
    require([r.request.id for r in out] == [r.id for r in reqs]
            and all(r.error is None for r in out), "serve: results")

    t0 = time.perf_counter()
    eng = E.Engine(plan)
    solo, worst = {}, 0.0
    for r in out:
        key = r.request.cache_key()
        if key not in solo:
            solo[key] = _solo_value(E, eng, g, r.request)
        want = solo[key]
        require(r.value.shape == want.shape and r.value.dtype == want.dtype,
                f"serve {r.request.kind}: {r.value.shape} vs {want.shape}")
        if r.request.entry.oracle_atol:         # add programs
            err = float(np.abs(r.value - want).max())
            worst = max(worst, err)
            require(err <= SERVE_ADD_ATOL, f"serve {r.request.kind}: max "
                    f"abs {err} vs its solo run > {SERVE_ADD_ATOL}")
        else:
            require(np.array_equal(r.value, want),
                    f"serve {r.request.kind} {r.request.params}: differs "
                    "from its solo run")
    solo_s = time.perf_counter() - t0

    by_bucket, per = {}, {}
    for d in served:
        b = str(d["bucket"])
        by_bucket[b] = by_bucket.get(b, 0) + 1
        for k in ("segment_reduce", "exchange", "gspmm"):
            per.setdefault(k, []).append(d["launches"][k])
    drain_reqs = _serve_requests(G, np.random.default_rng(SEED + 1), n,
                                 planes, SERVE_DRAIN)
    for r in drain_reqs:
        srv.submit(r)
    drained, t_drain = wall(srv.drain)
    require(len(drained) == SERVE_DRAIN
            and all(r.error is None for r in drained), "drain: results")
    srv.close()
    ledger = _serve_ledger(G, E, plan, g, reqs, out)
    result = {
        "requests": SERVE_REQUESTS, "tenants": SERVE_TENANTS,
        "serve_s": t_serve, "qps": SERVE_REQUESTS / t_serve,
        "latency_p50_s": stats["latency_p50_s"],
        "latency_p99_s": stats["latency_p99_s"],
        "micro_batches": len(served), "micro_batches_by_bucket":
            dict(sorted(by_bucket.items(), key=lambda kv: int(kv[0]))),
        "cache_hits": stats["result_cache_hits"],
        "launches_per_micro_batch": {k: {"mean": float(np.mean(v)),
                                         "max": int(max(v))}
                                     for k, v in per.items()},
        "launches": serve_launches,
        "add_max_abs_vs_solo": worst, "solo_checks": len(solo),
        "solo_check_s": solo_s, "drain_requests": SERVE_DRAIN,
        "drain_s": t_drain, "drain_qps": SERVE_DRAIN / t_drain}
    log({"phase": "serve.server", **result})
    return {"plan_cache": cache_t, "multi_source": ms, "run_batched": rb,
            "gspmm_lanes": gl, "server": result, "ledger": ledger,
            "launches": serve_launches}


def _serve_ledger(G, E, plan, g, reqs, first) -> dict:
    """A GraphServer with a CostLedger answers the serve phase's requests
    again: each answer equal to the ledger-less server's (min programs bit
    for bit, add within SERVE_ADD_ATOL), the ledger's device seconds
    within LEDGER_DEVICE_RTOL of the server's device_time_s, one request
    in it per completed one, each dispatched batch's utilization in
    (0, LEDGER_UTIL_MAX]. Then the same stream's q/s without and with a
    ledger in LEDGER_QPS_PAIRS turns (plain, ledger, ledger, plain; the
    cost models already made; medians compared), and a traced run of SERVE_TRACED requests whose
    monitor cannot meet its objective: the armed flight recorder's bundle
    and a Chrome trace, rendered by ``report`` and ``usage``."""
    import tempfile

    from repro_torch import obs
    from repro_torch.engine import kernels
    from repro_torch.obs import profile, report, usage

    batches = []

    class Priced(G.GraphServer):
        """The server, with each dispatched batch's bucket kept beside the
        samples its completion posts."""
        def _complete(self, fl):
            n0 = len(self.ledger.samples)
            done = G.GraphServer._complete(self, fl)
            posted = [x for x in self.ledger.samples[n0:]
                      if not x.from_cache]
            if posted:
                batches.append({"program": posted[0].program,
                                "bucket": fl.bucket,
                                "device_s": sum(x.device_s for x in posted),
                                "utilization": posted[0].utilization})
            return done

    class Kept(obs.CostLedger):
        """The ledger, keeping every posted sample for the checks."""
        def __init__(self):
            super().__init__()
            self.samples = []

        def post(self, sample):
            self.samples.append(sample)
            super().post(sample)

    profile.reset_models()
    led = Kept()
    srv = Priced(E.Engine(plan), g, ledger=led)
    before = dict(kernels.LAUNCHES)
    out, t_serve = wall(lambda: srv.serve(reqs))
    launches = _delta(before, kernels.LAUNCHES)
    for name in SERVE_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} was not launched by the ledger's server")
    worst = 0.0
    for a, b in zip(first, out):
        require(b.error is None and b.request is a.request,
                "ledger serve: results")
        if a.request.entry.oracle_atol:
            err = float(np.abs(b.value - a.value).max())
            worst = max(worst, err)
            require(err <= SERVE_ADD_ATOL, f"ledger serve {a.request.kind}:"
                    f" max abs {err} vs the ledger-less server's")
        else:
            require(np.array_equal(b.value, a.value),
                    f"ledger serve {a.request.kind} {a.request.params}: "
                    "differs from the ledger-less server's")
    tot = led.totals()
    dev = srv.metrics.device_time_s
    require(dev > 0 and abs(tot["device_s"] - dev)
            <= LEDGER_DEVICE_RTOL * dev,
            f"ledger device_s {tot['device_s']} vs device_time_s {dev}")
    require(tot["requests"] == srv.metrics.n_completed == len(reqs),
            f"ledger requests {tot['requests']} vs completed "
            f"{srv.metrics.n_completed} of {len(reqs)}")
    utils = [x.utilization for x in led.samples if not x.from_cache]
    require(all(0.0 < u <= LEDGER_UTIL_MAX for u in utils),
            f"ledger utilization outside (0, {LEDGER_UTIL_MAX}]: "
            f"{min(utils)}..{max(utils)}")
    models = list(profile._MODELS.values())
    require(all(m.error is None and m.unmodeled_ops == 0 for m in models),
            f"cost models: {[m for m in models if m.error]}")
    stats = profile.profile_stats()
    snap = led.snapshot()
    by_key = {}
    for b in batches:
        key = f"{b['program']}@{b['bucket']}"
        by_key.setdefault(key, []).append(b["utilization"])
    srv.close()
    result = {
        "requests": len(reqs), "serve_s": t_serve,
        "qps": len(reqs) / t_serve, "device_s": tot["device_s"],
        "device_time_s": dev, "cached": tot["cached"],
        "dispatched": tot["dispatched"], "batches": len(batches),
        "add_max_abs_vs_ledgerless": worst,
        "tenants": {t: {"device_s": a["device_s"],
                        "utilization": a["utilization"],
                        "requests": a["requests"]}
                    for t, a in snap["tenants"].items()},
        "utilization": {"min": min(utils), "max": max(utils),
                        "by_program_bucket": {
                            k: {"n": len(v), "min": min(v), "max": max(v)}
                            for k, v in sorted(by_key.items())}},
        "cost_models": {**stats, "compile_ms": {
            f"{m.program}@{m.bucket}": 1e3 * m.compile_s for m in models}},
        "launches": launches}
    log({"phase": "serve.ledger", **result})

    qps = {"plain": [], "ledger": []}
    for name in ("plain", "ledger", "ledger", "plain") * LEDGER_QPS_PAIRS:
        one = G.GraphServer(E.Engine(plan), g,
                            ledger=obs.CostLedger() if name == "ledger"
                            else None)
        _, t = wall(lambda: one.serve(reqs))
        one.close()
        qps[name].append(len(reqs) / t)
    overhead = {"qps": qps, "ledger_over_plain": float(
        np.median(qps["ledger"]) / np.median(qps["plain"]))}
    log({"phase": "serve.ledger.qps", **overhead})

    glob = obs.get_ledger()
    glob.reset()
    rec = obs.get()
    rec.reset()
    rec.enable()
    mon = obs.Monitor([obs.SLOPolicy(name="forced", tenant=reqs[0].tenant,
                                     program=reqs[0].kind,
                                     latency_objective_s=1e-9,
                                     min_samples=1, fast_window_s=60.0,
                                     slow_window_s=60.0)],
                      eval_interval_s=0.0)
    with tempfile.TemporaryDirectory() as tmp:
        fr = obs.FlightRecorder(tmp, max_bundles=4)
        disarm = fr.arm(mon)
        traced = G.GraphServer(E.Engine(plan), g, ledger=glob, monitor=mon)
        traced.serve(reqs[:SERVE_TRACED])
        traced.close()
        disarm()
        end = fr.dump("serve.end")
        n_events = obs.export_chrome_trace(f"{tmp}/trace.json")
        rec.disable()
        bundles = fr.bundles()
        alerts = [json.loads(b.read_text())["reason"] for b in bundles
                  if b != end]
        require(alerts == ["alert.burn_rate"],
                f"forced alert bundles: {alerts}")
        texts = {"report_alert": report.render(report.load(str(
                     bundles[0]))),
                 "report_trace": report.render(report.load(
                     f"{tmp}/trace.json")),
                 "usage_end": usage.render(usage.load(str(end)))}
    mon.close()
    rec.reset()
    tenants = sorted({r.tenant for r in reqs[:SERVE_TRACED]})
    require("INCIDENT  alert.burn_rate" in texts["report_alert"]
            and "serve.dispatch" in texts["report_trace"]
            and all(t in texts["usage_end"] for t in tenants),
            "report/usage renders")
    require(glob.totals()["requests"] == SERVE_TRACED,
            f"traced ledger requests {glob.totals()['requests']}")
    glob.reset()
    for name, text in texts.items():
        print(f"--- {name} ---\n{text}", flush=True)
    return {**result, "qps_overhead": overhead,
            "traced": {"requests": SERVE_TRACED, "chrome_events": n_events,
                       "alert_bundles": len(alerts)}}


# ---------------------------------------------------------------------------
# The stream phase
# ---------------------------------------------------------------------------

def _launch_counts() -> dict:
    """Every kernel's launch count so far (engine kernels and ops)."""
    from repro_torch.engine import kernels
    from repro_torch.kernels import ops
    return {**kernels.LAUNCHES, **ops.LAUNCHES}


class _PathLaunches:
    """Launches made by the path itself: ``run(fn)`` adds the launches
    made inside ``fn``; checks against a plain version run outside it."""

    def __init__(self):
        self.total: dict = {}

    def run(self, fn):
        before = _launch_counts()
        out = fn()
        for k, n in _delta(before, _launch_counts()).items():
            self.total[k] = self.total.get(k, 0) + n
        return out


def _stream_updates(sess, rng, n: int) -> tuple[np.ndarray, np.ndarray]:
    """One batch as benchmarks/fig_stream.py makes it: ``n`` deletes of
    live edges and ``n`` inserts of seeded vertex pairs."""
    u, v = sess.graph().as_numpy()
    idx = rng.choice(len(u), size=n, replace=False)
    dels = np.stack([u[idx], v[idx]], 1)
    ins = rng.integers(0, sess.sg.n_vertices, size=(n, 2))
    return ins, dels


def _stream_oracles(g) -> dict:
    """The host oracles of one graph snapshot: SSSP(0), WCC, PageRank(30)."""
    csr = csr_of(g)
    return {"sssp": sssp_oracle(csr, 0), "wcc": wcc_oracle(csr),
            "pagerank": pagerank_oracle(g)}


def _stream_queries(E, eng, g, want: dict, path, what: str) -> dict:
    """SSSP(0) and WCC bit-identical to scipy, PageRank(30) within
    STREAM_PR_ATOL and PR_ORACLE_RTOL of its float64 oracle (``want``:
    :func:`_stream_oracles`), each query launching segment_reduce and one
    exchange a superstep; first and warm SSSP timed."""
    from repro_torch.engine import kernels
    out = {}
    for name, run in (("sssp", lambda: E.engine_sssp(eng, 0)),
                      ("sssp_warm", lambda: E.engine_sssp(eng, 0)),
                      ("wcc", lambda: E.engine_wcc(eng)),
                      ("pagerank", lambda: E.engine_pagerank(
                          eng, g.degrees(), iters=30))):
        before = dict(kernels.LAUNCHES)
        r, t = wall(lambda: path.run(run))
        ls = _delta(before, kernels.LAUNCHES)
        require(ls["segment_reduce"] > 0 and ls["exchange"] == r.supersteps
                and ls["masked_update"] == 0,
                f"{what} {name}: launches {ls}")
        out[name] = {"wall_s": t, "supersteps": r.supersteps,
                     "local_iters": r.local_iters, "state": r.state}
    require(np.array_equal(out["sssp"]["state"].cpu().numpy(),
                           want["sssp"]), f"{what}: SSSP != scipy")
    require(np.array_equal(out["wcc"]["state"].cpu().numpy(),
                           want["wcc"]), f"{what}: WCC != scipy")
    pr = out["pagerank"]["state"]
    err = float(np.abs(pr.cpu().numpy() - want["pagerank"]).max())
    rel = max_rel(pr, want["pagerank"])
    require(err <= STREAM_PR_ATOL and rel <= PR_ORACLE_RTOL,
            f"{what}: PageRank vs float64 oracle abs {err}, rel {rel}")
    for r in out.values():
        r.pop("state")
    out["pagerank"].update(max_abs_vs_oracle=err, max_rel_vs_oracle=rel)
    return out


def _stream_kernel_checks(Kn, E, plan, g, gen, x, w) -> dict:
    """The kernels on a patched plan against their plain versions on it:
    segment_reduce min exact and add within SEG_ADD_RTOL, the exchange
    min exact, gcn_layer (gspmm) within GNN_PLAIN_REL of its largest
    value; none may fall back (each call must launch)."""
    msgs = torch.rand(plan.emask.shape, generator=gen, device=plan.device)
    vals = torch.rand((plan.k, plan.v_max), generator=gen,
                      device=plan.device)
    before = dict(Kn.LAUNCHES)
    got = Kn.segment_reduce(plan, msgs * 30, "min")
    require(torch.equal(got, Kn.segment_reduce_ref(plan, msgs * 30, "min")),
            "stream: segment_reduce min on the patched plan is not exact")
    add = Kn.segment_reduce(plan, msgs, "add")
    ref = Kn.segment_reduce_ref(plan, msgs, "add")
    rel = float(((add - ref).abs() / ref.abs().clamp(min=1e-30)).max())
    require(rel <= SEG_ADD_RTOL, f"stream: segment_reduce add rel {rel}")
    ex = Kn.exchange(plan, vals, "min")
    require(torch.equal(ex, Kn.exchange_ref(plan, vals, "min")),
            "stream: exchange min on the patched plan is not exact")
    kern = E.engine_gcn_layer(E.Engine(plan), g.degrees(), x, w).state
    plain = E.engine_gcn_layer(E.Engine(plan, use_kernels=False),
                               g.degrees(), x, w).state
    scale = float(plain.abs().max())
    gerr = float((kern - plain).abs().max())
    require(gerr <= GNN_PLAIN_REL * scale,
            f"stream: gcn_layer kernel vs plain {gerr} > {GNN_PLAIN_REL} x "
            f"{scale}")
    ls = _delta(before, Kn.LAUNCHES)
    require(ls["segment_reduce"] >= 2 and ls["exchange"] >= 1
            and ls["gspmm"] >= 1, f"stream: kernel checks launched {ls}")
    return {"segment_reduce_add_rel": rel, "gcn_layer_max_abs": gerr,
            "gcn_layer_scale": scale}


def _stream_server(G, E, sess, rng, ins, dels, entity, path) -> dict:
    """A GraphServer.from_session answering a seeded request stream across
    a patch: a micro-batch pumped on the old plan, the batch applied, the
    rest drained on the new one; each answer bit for bit a solo run on the
    plan it was served from (add programs too: the same kernels on the
    same plan sum in the same order, and a PageRank from the other plan
    differs by far less than any tolerance would let through)."""
    engines = {sess.version: (sess.engine, sess.graph())}
    unsubscribe = sess.subscribe(lambda s, event: engines.setdefault(
        s.version, (s.engine, s.graph())))
    srv = G.GraphServer.from_session(sess)
    n = sess.sg.n_vertices
    reqs = []
    for i in range(STREAM_REQUESTS):
        kind = ("sssp", "bfs", "wsssp", "sssp", "wcc", "pagerank",
                "kge_score")[i % 7]
        params = {"source": int(rng.integers(n))} \
            if kind in ("sssp", "bfs", "wsssp") else {}
        if kind == "pagerank":
            params["iters"] = 20
        if kind == "kge_score":      # relation: the session-bound plane
            params["entity"] = entity
        reqs.append(G.QueryRequest(kind, tenant=f"t{i % SERVE_TENANTS}",
                                   params=params))
    for r in reqs:
        srv.submit(r)
    before = _launch_counts()
    first, t_pump = wall(lambda: path.run(srv.pump))
    stats, t_apply = wall(lambda: path.run(lambda: sess.apply(
        inserts=ins, deletes=dels)))
    rest, t_drain = wall(lambda: path.run(srv.drain))
    launches = _delta(before, _launch_counts())
    out = first + rest
    unsubscribe()
    srv.close()
    require(len(out) == len(reqs) and all(r.error is None for r in out),
            "stream server: results")
    versions = sorted({r.version for r in out})
    require(len(versions) == 2, f"stream server: served versions {versions}")
    solo = {}
    for r in out:
        eng, g = engines[r.version]
        key = (r.version, r.request.cache_key())
        if key not in solo:
            solo[key] = _solo_value(E, eng, g, r.request)
        if not np.array_equal(r.value, solo[key]):
            require(False, f"stream server {r.request.kind} "
                    f"{r.request.params} (version {r.version}): differs from"
                    " its solo run")
    return stats, t_apply, {
        "requests": len(reqs), "pumped_old_plan": len(first),
        "versions": versions, "pump_s": t_pump, "drain_s": t_drain,
        "launches": launches, "solo_checks": len(solo),
        "plan_buffer_swaps": srv.stats()["plan_buffer_swaps"]}


def _spans(name: str) -> list:
    """The recorder's spans of one name since its last reset, oldest
    first, as (ms, args)."""
    from repro_torch import obs
    return [(e["dur"] / 1e3, e["args"]) for e in obs.get().events()
            if e["name"] == name and e["ph"] == "X"]


def phase_stream(g, owner):
    """Streaming maintenance on the card: a session over the main phase's
    graph and DFEP owner, STREAM_BATCHES update batches patched in (the
    first served across by a GraphServer, the last firing a re-auction of
    the default radius), a trickle whose radius-0 re-auction must come
    out as a patch of moves, one idle compaction epoch; queries exact and
    kernels held against their plain versions after each step."""
    import dataclasses as dc
    from repro_torch import engine as E
    from repro_torch import gserve as G
    from repro_torch import obs
    from repro_torch import stream as S
    from repro_torch.engine import kernels as Kn
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    Kn.reset_launches()
    ops.reset_launches()
    path = _PathLaunches()
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n = g.n_vertices
    # the session's default slack, for a recompiled plan of equal shape
    slack = (max(2 * 256, g.n_edges // (4 * K)), max(256, n // (2 * K)))
    policy = S.AdaptiveCompactionPolicy(headroom_batches=3.0)
    sess, t_init = wall(lambda: path.run(lambda: S.StreamSession(
        g, S.StreamConfig(k=K, chunk_size=256), owner=owner,
        policy=policy)))
    rel = rng.random((g.e_pad, E.KGE_F)).astype(np.float32)
    entity = rng.random((n, E.KGE_F)).astype(np.float32)
    sess.bind_channel("kge_score", "relation", rel,
                      fill=lambda a, b: np.full(E.KGE_F, 0.5, np.float32))
    x = rng.normal(size=(n, E.GCN_F_IN)).astype(np.float32)
    w = rng.normal(size=(E.GCN_F_IN, E.GCN_F_OUT)).astype(np.float32)
    log({"phase": "stream.init", "wall_s": t_init, "slack": list(slack),
         "e_max": sess.plan.e_max, "v_max": sess.plan.v_max,
         "rf_base": sess.rf_base, "free_graph_slots": sess.sg.free_slots()})

    batches = []
    obs.reset()
    obs.enable()       # the patch spans time patch_plan and the layouts
    try:
        for b in range(STREAM_BATCHES + 1):
            trickle = b == STREAM_BATCHES
            ins, dels = _stream_updates(
                sess, rng, STREAM_TRICKLE if trickle
                else int(STREAM_FRAC * g.n_edges))
            cfg = sess.cfg
            if b >= STREAM_BATCHES - 1:
                # a threshold below any drift: this step's check fires (the
                # trickle's over the touched vertices alone)
                sess.cfg = dc.replace(cfg, drift_threshold=-1.0,
                                      hops=0 if trickle else cfg.hops)
            hops = sess.cfg.hops
            recompiles = sess.n_recompiles
            lc0 = ops.LAUNCHES["lane_cumsum"]
            obs.reset()
            if b == 0:
                stats, t_apply, served = _stream_server(
                    G, E, sess, rng, ins, dels, entity, path)
            else:
                served = None
                stats, t_apply = wall(lambda: path.run(
                    lambda: sess.apply(inserts=ins, deletes=dels)))
            sess.cfg = cfg
            require(obs.get().stats()["dropped"] == 0,
                    f"stream step {b}: the recorder dropped events")
            patches = _spans("stream.patch_plan")
            plan = sess.plan
            lay = Kn.segment_layout(plan)
            row = {"batch": b, "trickle": trickle,
                   "updates": len(ins) + len(dels), "apply_s": t_apply,
                   "patched": sess.n_recompiles == recompiles,
                   "patch_changes": [a["changes"] for _, a in patches],
                   "patch_plan_ms": [t for t, _ in patches],
                   "layouts_ms": [t for t, _ in _spans("stream.layouts")],
                   "layout": lay.stats(), "rf": stats["rf"],
                   "rf_base": stats["rf_base"],
                   "recompiles": stats["recompiles"],
                   "forced_recompiles": stats["forced_recompiles"],
                   "e_max": plan.e_max, "v_max": plan.v_max}
            if stats["reauction"] is not None:
                info = stats["reauction"]
                row["reauction"] = dict(
                    info, batch=b, hops=hops, patched=row["patched"],
                    ms_per_round=1e3 * info["region_s"]
                    / max(info["rounds"], 1),
                    lane_cumsum=ops.LAUNCHES["lane_cumsum"] - lc0)
            if b >= STREAM_BATCHES - 1:
                require("reauction" in row,
                        f"stream step {b}: the forced re-auction did not run")
            if trickle:
                moved = row["reauction"]["moved_edges"]
                require(row["patched"] and moved > 0
                        and sess.last_change["event"] == "patch"
                        and sess.last_change["moves"] == moved,
                        f"stream trickle: re-auction {row['reauction']}, "
                        f"last change {sess.last_change}, want a patch of "
                        "moves")
            g_now = sess.graph()
            want = _stream_oracles(g_now)
            row["queries"] = _stream_queries(E, sess.engine, g_now, want,
                                             path, f"stream step {b}")
            recompiled, t_rc = wall(lambda: E.compile_plan(
                g_now, sess.owner, K, edge_slack=slack[0],
                vertex_slack=slack[1], epoch=sess.epoch + 1))
            row["recompiled"] = {"compile_s": t_rc,
                                 "e_max": recompiled.e_max,
                                 "queries": _stream_queries(
                                     E, E.Engine(recompiled), g_now, want,
                                     _PathLaunches(), f"recompiled {b}")}
            for p, key in ((plan, "patched"), (recompiled, "recompiled")):
                m = torch.rand(p.emask.shape, generator=gen,
                               device=p.device) * 30
                row[f"segment_reduce_{key}_ms"] = device_ms(
                    lambda: Kn.segment_reduce(p, m, "min"))
                row[f"segment_reduce_{key}_bound_ms"] = _seg_bound(p)[0]
            row["kernel_checks"] = _stream_kernel_checks(Kn, E, plan, g_now,
                                                         gen, x, w)
            row["gcn_layer_s"] = wall(lambda: path.run(
                lambda: E.engine_gcn_layer(sess.engine, g_now.degrees(), x,
                                           w)))[1]
            if served is not None:
                row["server"] = served
            log({"phase": "stream.batch", **row})
            batches.append(row)

        epoch0 = sess.epoch
        compacted, t_idle = wall(lambda: path.run(sess.idle_tick))
    finally:
        obs.disable()
        obs.reset()
    require(compacted and sess.epoch == epoch0 + 1,
            f"stream: idle_tick compacted={compacted}, epoch {sess.epoch}")
    reauctions = [r["reauction"] for r in batches if "reauction" in r]
    require(all(r["lane_cumsum"] > 0 for r in reauctions),
            "stream: a re-auction launched no lane_cumsum")
    g_now = sess.graph()
    after = _stream_queries(E, sess.engine, g_now, _stream_oracles(g_now),
                            path, "stream compaction")
    compaction = {"wall_s": t_idle, "epoch": sess.epoch,
                  "e_pad": sess.sg.e_pad, "e_max": sess.plan.e_max,
                  "v_max": sess.plan.v_max,
                  "idle_compactions": sess.n_idle_compactions,
                  "queries": after}
    log({"phase": "stream.compaction", **compaction})
    sess.unbind_channel("kge_score", "relation")
    policy.close()
    launches = path.total
    for name in STREAM_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the stream path")
    require(launches.get("masked_update", 0) == 0,
            "stream: masked_update launched")
    summary = {"launches": {k: launches.get(k, 0) for k in
                            (*STREAM_KERNELS, "masked_update")},
               "patches": sess.n_patches, "recompiles": sess.n_recompiles,
               "forced_recompiles": sess.n_forced_recompiles,
               "reauctions": sess.n_reauctions, "version": sess.version,
               "phase_s": time.perf_counter() - t_phase}
    log({"phase": "stream.summary", **summary})
    return {"batches": batches, "reauction_rows": reauctions,
            "compaction": compaction, **summary}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _minplus_rows_since(before: dict) -> dict:
    """minplus_sweep launches by state rows since ``before`` (a copy of
    ``ops.MINPLUS_LAUNCHES_BY_ROWS``), as a loggable dict."""
    from repro_torch.kernels import ops
    got = _delta(before, ops.MINPLUS_LAUNCHES_BY_ROWS)
    return {str(rows): n for rows, n in sorted(got.items()) if n}


def _road_gain():
    """The paper's gain where it shows: on a large-diameter graph. The
    small-world dblp stand-in is a few hops across, so an ETSCH superstep
    there moves about one hop, as a vertex-centric round does, and the gain
    is 0. The road-network stand-in (USROADS, full scale) is partitioned
    by DFEP as the main phase partitions dblp; ETSCH SSSP from vertex 0 must
    equal scipy, and its gain must be > 0 and equal to 1 - supersteps /
    (eccentricity + 1)."""
    from repro_torch.core import algorithms as A
    from repro_torch.core import dfep, etsch, graph, metrics

    road, t_load = wall(lambda: graph.load_dataset("usroads", scale=1.0,
                                                   seed=SEED))
    (owner, info), t_dfep = wall(lambda: dfep.partition(
        road, k=K, seed=SEED, max_rounds=4000, stall_rounds=64))
    part = etsch.compile_partitioning(road, owner, K)
    m, t = wall(lambda: metrics.evaluate(road, owner, K, part=part))
    res = A.etsch_sssp(part, 0)
    dist = sssp_oracle(csr_of(road), 0)
    ecc = int(dist[np.isfinite(dist)].max())
    log({"phase": "etsch.road_gain", "dataset": "usroads",
         "n_vertices": road.n_vertices, "n_edges": road.n_edges,
         "load_wall_s": t_load, "dfep_wall_s": t_dfep,
         "dfep_rounds": info["rounds"], "evaluate_wall_s": t, **m.row(),
         "etsch_supersteps": res.supersteps,
         "etsch_local_sweeps": res.local_iters, "eccentricity_of_0": ecc})
    require(np.array_equal(res.state.cpu().numpy(), dist),
            "etsch_sssp on usroads differs from the scipy oracle")
    require(m.gain == 1.0 - res.supersteps / (ecc + 1),
            f"usroads gain {m.gain} != 1 - {res.supersteps} / ({ecc} + 1)")
    require(m.gain > 0, f"usroads gain {m.gain} is not > 0")
    return part


def phase_etsch(g, owner, plan, engine_sssp_state):
    """The paper's dense ETSCH framework, its metrics and the baseline
    partitioners on the main phase's graph and DFEP owner."""
    from repro_torch.core import algorithms as A
    from repro_torch.core import baselines as B
    from repro_torch.core import etsch, metrics
    from repro_torch.kernels import ops

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    part, t = wall(lambda: etsch.compile_partitioning(g, owner, K))
    log({"phase": "etsch.compile_partitioning", "wall_s": t,
         "e_max": part.e_max, "state_slots": part.k * part.n_vertices,
         "peak_mib": peak_mib()})

    rng = np.random.default_rng(SEED)
    n = g.n_vertices
    ids = rng.permutation(n)
    sources = rng.choice(n, N_SOURCES, replace=False)
    prio = rng.uniform(1e-6, 1.0, n).astype(np.float32)
    problems = {
        "sssp": lambda: A.etsch_sssp(part, 0),
        "cc": lambda: A.etsch_cc(part, ids=ids),
        "multi_sssp": lambda: A.etsch_multi_sssp(part, sources),
        "pagerank": lambda: A.etsch_pagerank(part, g.degrees(), iters=30),
        "mis": lambda: A.etsch_mis(part, prio=prio),
        "kcore": lambda: A.etsch_kcore(part, K_CORE),
    }
    results = {}
    for name, run in problems.items():
        torch.cuda.reset_peak_memory_stats()
        before = dict(ops.LAUNCHES)
        before_rows = dict(ops.MINPLUS_LAUNCHES_BY_ROWS)
        r, t = wall(run)
        got = _delta(before, ops.LAUNCHES)
        by_rows = _minplus_rows_since(before_rows)
        results[name] = r
        _, t_warm = wall(run)
        # sweeps of the local phase: counted by run_etsch for SSSP/CC, one
        # minplus_sweep each for multi-SSSP, one pass per superstep for the
        # plain-torch problems (PageRank, MIS, k-core)
        sweeps = (r.local_iters if hasattr(r, "local_iters")
                  else got["minplus_sweep"] if name == "multi_sssp"
                  else r.supersteps)
        log({"phase": f"etsch.{name}", "wall_s": t, "warm_wall_s": t_warm,
             "supersteps": r.supersteps, "local_sweeps": sweeps,
             "launches": got, "minplus_by_rows": by_rows,
             "peak_mib": peak_mib()})
        if name == "sssp":
            for k in ETSCH_KERNELS:
                require(got[k] > 0, f"etsch_sssp did not launch {k}")

    t0 = time.perf_counter()
    csr = csr_of(g)
    sssp = results["sssp"].state.cpu().numpy()
    dist0 = sssp_oracle(csr, 0)
    require(np.array_equal(sssp, dist0),
            "etsch_sssp differs from the scipy oracle")
    require(torch.equal(results["sssp"].state, engine_sssp_state),
            "etsch_sssp differs from the engine's SSSP")
    cc = results["cc"].state.cpu().numpy()
    require(np.array_equal(cc, labelprop_oracle(csr, ids.astype(np.float32))),
            "etsch_cc is not the min id of each component")
    multi = results["multi_sssp"].dist
    require(tuple(multi.shape) == (N_SOURCES, n), f"etsch_multi_sssp: "
            f"shape {tuple(multi.shape)}")
    require(np.array_equal(multi.cpu().numpy(),
                           sssp_oracle(csr, sources)),
            "etsch_multi_sssp differs from scipy BFS")
    rank = results["pagerank"].rank
    pr_rel = max_rel(rank, pagerank_oracle(g))
    require(pr_rel <= PR_ORACLE_RTOL, f"etsch_pagerank vs float64 oracle: "
            f"max rel {pr_rel} > {PR_ORACLE_RTOL}")
    in_set = results["mis"].in_set.cpu().numpy()
    require(is_mis_oracle(csr, in_set) and A.is_maximal_independent_set(
        g, results["mis"].in_set), "etsch_mis is not a maximal independent "
        "set")
    core = results["kcore"].in_core.cpu().numpy()
    require(np.array_equal(core, kcore_oracle(g, K_CORE)),
            "etsch_kcore differs from the peeling oracle")
    log({"phase": "etsch.check", "oracle_s": time.perf_counter() - t0,
         "equal_oracle": ["sssp", "cc", "multi_sssp", "kcore"],
         "sssp_equal_engine": True, "pagerank_max_rel_vs_f64_oracle": pr_rel,
         "mis_size": int(in_set.sum()), "kcore_size": int(core.sum()),
         "multi_sssp_state_mib": 4 * K * N_SOURCES * n / 2**20})

    # The gain compares ETSCH supersteps with vertex-centric rounds, which
    # are the source's eccentricity + 1 (the last round changes nothing);
    # it is held to that formula with scipy's eccentricity.
    before = dict(ops.LAUNCHES)
    before_rows = dict(ops.MINPLUS_LAUNCHES_BY_ROWS)
    m, t = wall(lambda: metrics.evaluate(g, owner, K, part=part))
    got = _delta(before, ops.LAUNCHES)
    by_rows = _minplus_rows_since(before_rows)
    ecc = int(dist0.max())
    steps = results["sssp"].supersteps
    log({"phase": "etsch.evaluate", "partitioner": "dfep", "wall_s": t,
         **m.row(), "eccentricity_of_0": ecc, "launches": got,
         "minplus_by_rows": by_rows})
    require(got["minplus_sweep"] > 0, "evaluate did not launch minplus_sweep")
    require(m.messages == plan.exchange_volume, f"MESSAGES {m.messages} != "
            f"the plan's exchange volume {plan.exchange_volume}")
    require(m.replication_factor == plan.replication_factor(),
            "replication factor differs from the plan's")
    require(m.gain == 1.0 - steps / (ecc + 1), f"gain {m.gain} != 1 - "
            f"{steps} / ({ecc} + 1)")
    road_part = _road_gain()

    baselines = {
        "hash": lambda: B.hash_partition(g, K),
        "random": lambda: B.random_partition(g, K, seed=SEED),
        "greedy": lambda: B.greedy_partition(g, K, seed=SEED),
        "jabeja": lambda: B.jabeja_partition(g, K, seed=SEED)[0],
    }
    fig7 = {"dfep": m.row()}
    for name, make in baselines.items():
        own, t_part = wall(make)
        mb, t_eval = wall(lambda: metrics.evaluate(g, own, K))
        fig7[name] = mb.row()
        log({"phase": "etsch.fig7", "partitioner": name,
             "partition_wall_s": t_part, "evaluate_wall_s": t_eval,
             **mb.row()})
    launches = dict(ops.LAUNCHES)
    for name in ETSCH_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} was not launched on the etsch path")
    launches["minplus_by_rows"] = _minplus_rows_since({})
    log({"phase": "etsch.summary", "launches": launches,
         "fig7": {p: {k: r[k] for k in ("largest_norm", "nstdev", "messages",
                                         "connected_frac", "gain")}
                  for p, r in fig7.items()}})
    return part, road_part, launches


# ---------------------------------------------------------------------------
# The multi-device path (torch.distributed): ranks spawned from here
# ---------------------------------------------------------------------------

class _CollectiveTimer:
    """While installed, every ``collectives.all_reduce_`` is bracketed by
    CUDA events on the current stream (no host sync is added): ``ms()`` is
    the device time spent in the collectives since ``install``."""

    def __init__(self):
        from repro_torch.core import collectives
        self.module = collectives
        self.plain = collectives.all_reduce_
        self.pairs: list = []
        self.calls = self.bytes = 0

    def install(self):
        self.pairs, self.calls, self.bytes = [], 0, 0

        def timed(t, op, group=None):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.plain(t, op, group)
            end.record()
            self.pairs.append((start, end))
            self.calls += 1
            self.bytes += t.numel() * t.element_size()
            return out

        self.module.all_reduce_ = timed

    def uninstall(self) -> dict:
        self.module.all_reduce_ = self.plain
        torch.cuda.synchronize()
        return {"collective_ms": sum(s.elapsed_time(e) for s, e in self.pairs),
                "collectives": self.calls, "collective_bytes": self.bytes}


def _dist_item(timer, fn) -> tuple:
    """(first call's result, its launches, row): ``fn`` run first with the
    launch counters zeroed just before it and read just after, then warm
    with the collectives timed."""
    from repro_torch.engine import kernels
    from repro_torch.kernels import ops
    kernels.reset_launches()
    ops.reset_launches()
    out, first = wall(fn)
    launches = _launch_counts()
    timer.install()
    try:
        _, warm = wall(fn)
    finally:
        row = timer.uninstall()
    row.update(first_s=first, warm_s=warm)
    return out, launches, row


def _dist_work(rank: int, world: int, inp) -> tuple[dict, dict]:
    """What one rank of the dist phase runs and checks: sharded DFEP, the
    sharded ETSCH problems and the sharded engine. Returns (rows to log,
    arrays for the parent's checks)."""
    import types
    import torch.distributed as dist
    from repro_torch import engine as E
    from repro_torch.core import dfep, dfep_distributed, etsch
    from repro_torch.core import etsch_distributed, graph

    group = dist.group.WORLD
    g = graph.graph_from_numpy(types.SimpleNamespace(
        n_vertices=int(inp["n_vertices"]), n_edges=int(inp["n_edges"]),
        src=inp["src"], dst=inp["dst"], edge_mask=inp["edge_mask"]))
    owner = inp["owner"]
    timer = _CollectiveTimer()
    rows, arrays = {}, {}

    cfg = dfep.DfepConfig(k=K, max_rounds=DIST_DFEP_ROUNDS,
                          stall_rounds=DIST_DFEP_ROUNDS)
    (own, info), launches, row = _dist_item(
        timer, lambda: dfep_distributed.run_dfep_sharded(g, cfg,
                                                         inp["starts"]))
    own = own.cpu().numpy()
    em = inp["edge_mask"]
    sizes = np.bincount(own[em], minlength=K)
    require(((own[em] >= 0) & (own[em] < K)).all() and (own[~em] == -2).all()
            and sizes.sum() == g.n_edges,
            f"dist DFEP (world {world}) owner is not a valid K-partition")
    require(launches["lane_cumsum"] == 2 * info["rounds"],
            f"dist DFEP: {launches['lane_cumsum']} lane_cumsum launches for "
            f"{info['rounds']} rounds (two a round)")
    rows["dfep"] = dict(row, **info, launches=launches,
                        largest_norm=float(sizes.max() * K / g.n_edges),
                        ms_per_round=1e3 * row["first_s"]
                        / max(info["rounds"], 1),
                        warm_ms_per_round=1e3 * row["warm_s"]
                        / max(info["rounds"], 1))
    arrays["dfep_owner"] = own

    part = etsch.compile_partitioning(g, owner, K)
    (d, steps), launches, row = _dist_item(
        timer, lambda: etsch_distributed.sssp_sharded(part, 0))
    rows["etsch_sssp"] = dict(row, supersteps=steps, launches=launches)
    arrays["etsch_sssp"] = d.cpu().numpy()
    pr, launches, row = _dist_item(
        timer, lambda: etsch_distributed.pagerank_sharded(
            part, g.degrees(), iters=30))
    rows["etsch_pagerank"] = dict(row, launches=launches)
    arrays["etsch_pagerank"] = pr.cpu().numpy()
    del part

    plan = E.compile_plan(g, owner, K)
    eng = E.Engine(plan, group=group)
    for name, run in (("sssp", lambda: E.engine_sssp(eng, 0)),
                      ("wcc", lambda: E.engine_wcc(eng)),
                      ("pagerank", lambda: E.engine_pagerank(
                          eng, g.degrees(), iters=30))):
        r, launches, row = _dist_item(timer, run)
        require(launches["exchange"] == 0
                and launches["masked_update"] == r.supersteps,
                f"dist {name}: {launches['exchange']} exchange and "
                f"{launches['masked_update']} masked_update launches for "
                f"{r.supersteps} supersteps")
        rows[name] = dict(row, **r.row(), launches=launches)
        arrays[name] = r.state.cpu().numpy()

    sources = inp["sources"]
    r, launches, row = _dist_item(timer,
                                  lambda: E.multi_source_sssp(eng, sources))
    steps = int(r.supersteps.max())
    require(launches["exchange"] == 0
            and launches["masked_update"] == steps
            and launches["segment_reduce"] > 0,
            f"dist multi_source_sssp: launches {launches} for {steps} "
            "supersteps of the longest lane")
    (solo, solo_s) = wall(lambda: [E.engine_sssp(eng, int(s))
                                   for s in sources])
    for i, s in enumerate(solo):
        require(torch.equal(r.state[i], s.state)
                and (int(r.supersteps[i]), int(r.local_iters[i]),
                     bool(r.converged[i]))
                == (s.supersteps, s.local_iters, s.converged),
                f"dist multi_source_sssp lane {i} differs from its solo run")
    rows["multi_source_sssp"] = dict(row, **r.row(), lanes=len(sources),
                                     launches=launches, solo_s=solo_s)
    return rows, arrays


def _join_group(backend: str, rdzv: str, world: int, rank: int) -> None:
    """Join this spawned rank to its process group (file rendezvous
    ``rdzv``), on card 0; a collective that waits longer than
    DIST_TIMEOUT_S raises."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method="file://" + rdzv,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))


def _dist_rank(rank: int, world: int, backend: str, rdzv: str, inputs: str,
               out_dir: str) -> None:
    """One rank of the dist phase (a process of its own, spawned by
    ``phase_dist``): joins the group, runs ``_dist_work`` and writes its
    rows and arrays to ``out_dir``."""
    import torch.distributed as dist
    _join_group(backend, rdzv, world, rank)
    try:
        rows, arrays = _dist_work(rank, world, np.load(inputs))
        np.savez(f"{out_dir}/rank_{world}_{rank}.npz", **arrays)
        Path(f"{out_dir}/rank_{world}_{rank}.json").write_text(
            json.dumps(rows))
    finally:
        dist.destroy_process_group()


def _dist_outputs(out_dir: str, world: int) -> tuple[list, dict]:
    """The ranks' rows, and their arrays after checking that every rank
    returned the same."""
    rows = [json.loads(Path(f"{out_dir}/rank_{world}_{r}.json").read_text())
            for r in range(world)]
    arrays = [dict(np.load(f"{out_dir}/rank_{world}_{r}.npz"))
              for r in range(world)]
    for r, other in enumerate(arrays[1:], 1):
        for key, value in other.items():
            require(np.array_equal(value, arrays[0][key]),
                    f"dist world {world}: rank {r} returned another {key}")
    return rows, arrays[0]


def phase_dist(g, owner, main_results):
    """The multi-device path on the main phase's graph, DFEP owner and plan,
    at each world size of DIST_WORLDS, every rank a process on card 0."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.core import dfep

    n = g.n_vertices
    csr = csr_of(g)
    sssp_want = sssp_oracle(csr, 0)
    pr_want = pagerank_oracle(g)
    launches, etsch_steps = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = f"{tmp}/inputs.npz"
        np.savez(inputs, n_vertices=n, n_edges=g.n_edges,
                 src=g.src.cpu().numpy(), dst=g.dst.cpu().numpy(),
                 edge_mask=g.edge_mask.cpu().numpy(),
                 owner=owner.cpu().numpy(),
                 starts=np.asarray(dfep.draw_starts(n, K, SEED)),
                 sources=np.random.default_rng(SEED).choice(
                     n, SERVE_LANES, replace=False))
        for world, backend in DIST_WORLDS:
            _, t = wall(lambda: mp.spawn(
                _dist_rank, args=(world, backend, f"{tmp}/rdzv_{world}",
                                  inputs, tmp), nprocs=world))
            rows, arrays = _dist_outputs(tmp, world)
            for r, rank_rows in enumerate(rows):
                for name, row in rank_rows.items():
                    log({"phase": f"dist.{name}", "world": world,
                         "backend": backend, "rank": r, **row})
            # the engine: min programs bit for bit, PageRank as the main
            # phase holds it; the same supersteps and convergence, and the
            # critical path's sweeps no more than one device's
            rel_engine = None
            for name in ("sssp", "wcc", "pagerank"):
                want = main_results[name]
                got = rows[0][name]
                state = torch.from_numpy(arrays[name]).to(want.state.device)
                if name == "pagerank":
                    rel_engine = max_rel(state, want.state)
                    require(rel_engine <= PR_PLAIN_RTOL, f"dist pagerank: "
                            f"max rel {rel_engine} to the main phase's")
                else:
                    require(torch.equal(state, want.state),
                            f"dist {name} differs from the main phase's")
                require(got["supersteps"] == want.supersteps
                        and got["converged"] == want.converged
                        and (got["local_iters"] == want.local_iters
                             if world == 1
                             else got["local_iters"] <= want.local_iters),
                        f"dist {name} counters {got} against {want.row()}")
                sweeps = max(rr[name]["launches"]["segment_reduce"]
                             for rr in rows)
                require(sweeps == got["local_iters"], f"dist {name}: "
                        f"{sweeps} segment_reduce launches on the busiest "
                        f"rank for {got['local_iters']} sweeps")
            require(np.array_equal(arrays["etsch_sssp"], sssp_want),
                    "dist sssp_sharded differs from the scipy oracle")
            rel = max_rel(torch.from_numpy(arrays["etsch_pagerank"]),
                          pr_want)
            require(rel <= PR_ORACLE_RTOL, f"dist pagerank_sharded: max rel "
                    f"{rel} to the float64 oracle")
            etsch_steps[world] = rows[0]["etsch_sssp"]["supersteps"]
            launches[world] = {k: sum(rr[item]["launches"][k] for rr in rows
                                      for item in rr)
                               for k in rows[0]["sssp"]["launches"]}
            log({"phase": "dist.world", "world": world, "backend": backend,
                 "wall_s": t, "pagerank_sharded_max_rel_vs_f64_oracle": rel,
                 "engine_pagerank_max_rel_vs_main": rel_engine,
                 "launches": launches[world]})
    require(len(set(etsch_steps.values())) == 1,
            f"sssp_sharded supersteps differ across worlds: {etsch_steps}")
    for name in DIST_KERNELS:
        require(all(launches[w][name] > 0 for w in launches),
                f"kernel {name} was not launched on the dist path")
    require(all(launches[w]["exchange"] == 0 for w in launches),
            "the single-device exchange ran on the dist path")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _cross_and_offset(cfg, params, modality: dict) -> tuple:
    """(the encdec decode's cross k/v or None, the image tokens that
    precede the text: the decode offset), from a phase's modality
    inputs."""
    from repro_torch.models import lm
    cross = None
    if "enc_frames" in modality:
        cross = lm.cross_kvs_from_memory(
            cfg, params, lm._encode(cfg, params, modality["enc_frames"]))
    n_img = modality["img_embeds"].shape[1] if "img_embeds" in modality \
        else 0
    return cross, n_img


def _logits_along(cfg, params, prompts, tokens, modality=None):
    """Prefill ``prompts`` (with the family's ``modality`` inputs), then
    decode fed ``tokens`` [B, n] (the caches grown to hold them, each step
    after the image tokens): each step's logits over the real vocabulary,
    float32 [B, n, V]."""
    from repro_torch.serve import serve_step as SS
    modality = modality or {}
    cross, n_img = _cross_and_offset(cfg, params, modality)
    lg, caches = SS.prefill(cfg, params, prompts, **modality)
    b, s = prompts.shape
    caches = SS.grow_caches(cfg, caches, b, n_img + s + tokens.shape[1])
    out = [lg[:, -1]]
    for k in range(tokens.shape[1] - 1):
        lg, caches = SS.decode(cfg, params, tokens[:, k:k + 1], caches,
                               n_img + s + k, cross)
        out.append(lg[:, -1])
    return torch.stack(out, 1)[..., :cfg.vocab].float()


def _greedy_agrees(tokens, logits, rel: float) -> tuple[bool, int]:
    """(every token within ``rel`` · max |logit| of its step's largest
    logit and equal to the argmax where the top two are further apart,
    the number of steps where they are)."""
    tol = rel * float(logits.abs().max())
    chosen = logits.gather(-1, tokens.long()[..., None])[..., 0]
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol
    ok = bool((chosen >= top2[..., 0] - tol).all()) and torch.equal(
        tokens.long()[clear], logits.argmax(-1)[clear])
    return ok, int(clear.sum())


def phase_lm(cfg=None, dev: str = "cuda"):
    """Mamba serving at full width and depth on the card (module docstring,
    phase 8). Returns (the kernels' launches in ``generate``, the scan's
    inputs at the first and last layer of the prompt's prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.serve import serve_step as SS

    cfg = cfg or get_config(LM_ARCH)
    layers = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params, t_init = wall(lambda: lm.init_params(cfg, gen, dev))
    leaves = _leaves(params)
    n_params = sum(t.numel() for t in leaves)
    _, d_in, dt_rank = ssm_dims(cfg)
    log({"phase": "lm.init", "arch": cfg.name, "n_layers": layers,
         "d_model": cfg.d_model, "d_inner": d_in, "d_state":
             cfg.ssm.d_state, "dt_rank": dt_rank, "vocab_pad":
             lm.vocab_pad(cfg), "params": n_params, "param_count":
             cfg.param_count(), "param_bytes": sum(
                 t.numel() * t.element_size() for t in leaves),
         "wall_s": t_init, "peak_mib": peak_mib()})

    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev)
    ops.reset_launches()
    (logits, caches), t_first = wall(lambda: SS.prefill(cfg, params,
                                                        prompts))
    require(ops.LAUNCHES["selective_scan"] == layers,
            f"prefill launched selective_scan "
            f"{ops.LAUNCHES['selective_scan']} times, not {layers}")
    require(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    require(tuple(logits.shape) == (LM_BATCH, LM_PROMPT, lm.vocab_pad(cfg)),
            f"prefill logits of shape {tuple(logits.shape)}")
    t_warm = wall(lambda: SS.prefill(cfg, params, prompts))[1]
    tok = SS.greedy_token(logits[:, -1:], cfg.vocab)

    def decode_run():
        c, t, lg = caches, tok, None
        for n in range(LM_PROMPT, LM_PROMPT + LM_NEW - 1):
            lg, c = SS.decode(cfg, params, t, c, n)
            t = SS.greedy_token(lg[:, -1:], cfg.vocab)
        return lg

    before = ops.LAUNCHES["selective_scan"]
    last, t_dec_first = wall(decode_run)
    require(ops.LAUNCHES["selective_scan"] - before == layers * (LM_NEW - 1),
            "decode did not launch selective_scan once per layer and step")
    require(bool(torch.isfinite(last).all()), "decode logits not finite")
    t_dec = wall(decode_run)[1]
    log({"phase": "lm.prefill_decode", "batch": LM_BATCH,
         "prompt_len": LM_PROMPT, "prefill_first_s": t_first,
         "prefill_warm_s": t_warm,
         "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / t_warm,
         "decode_steps": LM_NEW - 1,
         "decode_ms_per_step_first": 1e3 * t_dec_first / (LM_NEW - 1),
         "decode_ms_per_step": 1e3 * t_dec / (LM_NEW - 1),
         "decode_tokens_per_s": LM_BATCH * (LM_NEW - 1) / t_dec,
         "peak_mib": peak_mib()})

    # the main path: the counters from 0, one generate, read just after
    engine = SS.Engine(cfg, params, s_max=LM_PROMPT + LM_NEW)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out, t_gen = wall(lambda: engine.generate(prompts, LM_NEW))
    launches = dict(ops.LAUNCHES)
    gen_peak = peak_mib()
    require(launches["selective_scan"] == layers * LM_NEW,
            f"generate launched selective_scan {launches['selective_scan']} "
            f"times, not {layers} x {LM_NEW}")
    require(tuple(out.shape) == (LM_BATCH, LM_NEW)
            and bool(((out >= 0) & (out < cfg.vocab)).all()),
            "generate's tokens are not [B, n_new] ids of the vocabulary")

    # decode for token s against a prefill of s + 1 tokens; and, to show
    # the bound tells a right cache from a wrong one, decode from the conv
    # window padded as the reference's Engine.generate pads it at a prompt
    # of d_conv - 1 tokens, and from a zeroed SSM state
    full, _, _ = lm.forward_lm(cfg, params, torch.cat([prompts, tok], 1))
    want = full[:, -1].float()
    scale = float(want.abs().max())
    require(bool(torch.isfinite(full).all()), "prefill logits not finite")
    conv, h = caches["l0"]
    rel = {}
    for name, c in (("right", caches),
                    ("conv_padded", {"l0": (torch.nn.functional.pad(
                        conv, (0, 0, 0, LM_NEW)), h)}),
                    ("state_zeroed", {"l0": (conv, torch.zeros_like(h))})):
        dec, _ = SS.decode(cfg, params, tok, c, LM_PROMPT)
        require(bool(torch.isfinite(dec).all()), "decode logits not finite")
        rel[name] = float((dec[:, 0].float() - want).abs().max()) / scale
    bound = bf16_rel(layers)
    log({"phase": "lm.generate", "new_tokens": LM_NEW, "wall_s": t_gen,
         "tokens_per_s": LM_BATCH * LM_NEW / t_gen, "launches": launches,
         "peak_mib": gen_peak, "first_token_equals_prefill_argmax":
             torch.equal(out[:, :1], tok), "max_abs_logit": scale,
         "decode_vs_prefill_rel": rel, "bound_rel": bound})
    require(rel["right"] <= bound, f"decode vs prefill of s + 1 tokens: "
            f"max abs {rel['right']} x {scale} > {bound} x {scale}")
    require(min(rel["conv_padded"], rel["state_zeroed"]) > bound,
            f"a wrong cache passes the decode-vs-prefill bound: {rel}")

    # the scan's real inputs at the first and the last layer
    captured = _scan_inputs(lambda: SS.prefill(cfg, params, prompts),
                            (0, layers - 1))
    del params, leaves, engine, logits, caches, conv, h, last, dec, full
    torch.cuda.empty_cache()
    return launches, captured


def _lm_cpu_equal(arch: str = LM_ARCH):
    """``arch``'s SMOKE model with the same parameters on the card and on
    the CPU (encdec and vlm with the same audio frames or image embeddings
    from ``SyntheticPipeline``): the card's greedy tokens, and every
    step's logits along them."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import lm
    from repro_torch.serve.serve_step import Engine

    cfg = get_config(arch, smoke=True)
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    card = lm.params_from_reference(cfg, lm.params_to_numpy(cpu), "cuda")
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, 16),
                            generator=torch.Generator().manual_seed(SEED))
    batch = SyntheticPipeline(cfg, DataConfig(LM_BATCH, 16, SEED),
                              "cpu").batch_at(0)
    modality = {k: batch[k] for k in ("img_embeds", "enc_frames")
                if k in batch}
    on = {"cuda": {k: t.cuda() for k, t in modality.items()},
          "cpu": modality}
    toks = {dev: Engine(cfg, p, s_max=32).generate(
                prompts.to(dev), 8, **on[dev]).cpu()
            for dev, p in (("cuda", card), ("cpu", cpu))}
    lg_card = _logits_along(cfg, card, prompts.cuda(), toks["cuda"].cuda(),
                            on["cuda"])
    lg_cpu = _logits_along(cfg, cpu, prompts, toks["cuda"], modality)
    err = float((lg_card.cpu() - lg_cpu).abs().max())
    scale = float(lg_cpu.abs().max())
    bound = bf16_rel(cfg.n_layers + cfg.n_enc_layers)
    ok, clear = _greedy_agrees(toks["cuda"], lg_cpu, bound)
    log({"phase": "cpu_equal.lm", "arch": cfg.name,
         "modality": sorted(modality), "tokens_equal":
         torch.equal(toks["cuda"], toks["cpu"]), "clear_steps": clear,
         "steps": toks["cuda"].numel(), "logits_max_abs": err,
         "max_abs_logit": scale, "logits_rel": err / scale,
         "bound_rel": bound})
    require(err <= bound * scale, f"SMOKE logits card vs CPU: max abs {err} "
            f"> {bound} x {scale}")
    require(ok, "the card's greedy tokens are not the CPU's")


def _dropped(routes, batch: int) -> tuple[list, np.ndarray]:
    """(the (token, expert) pairs each MoE call dropped, [B] bool: the
    sequences some call dropped a token of), from
    ``layers.record_routing``'s records. Reads the device."""
    per_call = [int((~r.keep).sum()) for r in routes]
    seq = np.zeros(batch, bool)
    for r in routes:
        seq |= (~r.keep).any(dim=1).reshape(batch, -1).any(dim=1) \
            .cpu().numpy()
    return per_call, seq


def _device_profile(fn) -> dict:
    """One warm call of ``fn`` under ``torch.profiler``: its host wall ms
    without the profiler (best of three), the kernels it launched, their
    summed device ms and the device's busy share of that wall time, and
    the device ms of the weight casts and other copies (``aten::copy_``)
    and of the products (``aten::mm``, ``aten::bmm``)."""
    fn()
    wall_ms = min(1e3 * wall(fn)[1] for _ in range(3))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall(fn)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    ops = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()}
    return {"wall_ms": wall_ms, "kernels": len(kernels),
            "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            **{f"{op}_ms": ops.get(f"aten::{op}", 0.0)
               for op in ("copy_", "mm", "bmm")}}


@contextlib.contextmanager
def _compute_dtype(dtype):
    """Run the port's models with ``layers.COMPUTE_DTYPE`` (and the SSM
    block's copy of it) set to ``dtype`` (the weights are float32, so
    float32 casts none)."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    real = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = S.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        L.COMPUTE_DTYPE = S.COMPUTE_DTYPE = real


def _decode_vs_prefill(cfg, params, prompts, modality=None,
                       compute=None) -> dict:
    """Decode for token s from a prefill of the s prompt tokens against the
    last logits of a prefill of s + 1, on the sequences neither prefill
    dropped a token of (a token's capacity slot is its rank among every
    token routed to its expert, so the two prefills drop differently), and
    from a zeroed KV cache, which must fall outside the bound. With the
    family's ``modality`` inputs: decode after the image tokens (and, as a
    wrong offset that must fall outside the bound, at the text's length,
    where the reference's ``Engine.generate`` decodes), or with the
    encoder's cross k/v (and, zeroed, outside the bound). With
    ``compute``, the whole check runs with that compute dtype. Returns the
    drops, the sequences checked and, if any, ``rel`` (max |Δ| over the
    largest logit of those sequences) and ``prefill_floor``: the same
    measure between the two prefills' logits at their last shared
    position, the model's own noise at this dtype."""
    if compute is not None:
        with _compute_dtype(compute):
            out = _decode_vs_prefill(cfg, params, prompts, modality)
        return {**out, "compute": str(compute).removeprefix("torch.")}
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serve import serve_step as SS

    modality = modality or {}
    b, s = prompts.shape
    cross, n_img = _cross_and_offset(cfg, params, modality)
    with L.record_routing() as r0:
        logits, _, caches = lm.forward_lm(cfg, params, prompts,
                                          collect_cache=True, **modality)
    tok = SS.greedy_token(logits[:, -1:], cfg.vocab)
    last = logits[:, -1].float()
    del logits
    grown = SS.grow_caches(cfg, caches, b, n_img + s + 1)
    del caches
    with L.record_routing() as r1:
        full, _, _ = lm.forward_lm(cfg, params, torch.cat([prompts, tok], 1),
                                   **modality)
    require(bool(torch.isfinite(full).all()), "prefill logits not finite")
    (d0, q0), (d1, q1) = _dropped(r0, b), _dropped(r1, b)
    ok = ~(q0 | q1)
    out = {"prompts": [b, s], "drops": [sum(d0), sum(d1)],
           "checked_sequences": np.flatnonzero(ok).tolist()}
    if not ok.any():
        return out
    rows = torch.from_numpy(np.flatnonzero(ok)).to(prompts.device)
    want = full[rows, -1].float()
    prev = full[rows, -2].float()
    del full
    scale = float(want.abs().max())
    out["prefill_floor"] = float((last[rows] - prev).abs().max()
                                 / prev.abs().max())

    def zeros(tree):
        return {n: tuple(torch.zeros_like(t) for t in c)
                for n, c in tree.items()}

    cases = [("right", grown, n_img + s, cross),
             ("kv_zeroed", zeros(grown), n_img + s, cross)]
    if cross is not None:
        cases.append(("cross_zeroed", grown, n_img + s, zeros(cross)))
    if n_img:
        cases.append(("text_offset", grown, s, cross))
    out["rel"] = {}
    for label, c, at, x in cases:
        dec, _ = SS.decode(cfg, params, tok, c, at, x)
        require(bool(torch.isfinite(dec).all()), "decode logits not finite")
        out["rel"][label] = float((dec[rows, 0].float() - want).abs().max()
                                  ) / scale
    out["max_abs_logit"] = scale
    if n_img:
        out["image_tokens"] = n_img
    return out


def _with_first_moe_input(fn):
    """(``fn()``, a copy of the input of the first ``layers.moe`` call
    made inside it, or None)."""
    from repro_torch.models import layers as L
    captured, real = [], L.moe

    def capture(cfg, p, x):
        if not captured:
            captured.append(x.clone())
        return real(cfg, p, x)

    L.moe = capture
    try:
        out = fn()
    finally:
        L.moe = real
    return out, captured[0] if captured else None


def _sdpa_yardstick(cfg, gen, batch: int = LM_BATCH, sq: int = LM_PROMPT,
                    sk: int | None = None, causal: bool = True) -> dict:
    """The port's flash scan against ``scaled_dot_product_attention`` at
    one of the prefill's attention shapes (bf16 q [B, H, Sq, dh], k
    [B, KV, Sk, dh], v [B, KV, Sk, dv]; Sk = Sq unless given; MLA: dh =
    nope + rope, dv = v_head_dim, KV = H): device ms of each and their
    largest difference. SDPA is timed here only; the path never calls
    it."""
    from repro_torch.models import layers as L
    h, kv = L.pad_heads(cfg.n_heads, cfg.n_kv)
    dh = dv = cfg.head_dim
    if cfg.mla is not None:
        h = kv = cfg.n_heads
        dh = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
        dv = cfg.mla.v_head_dim

    def draw(heads, seq, width=dh):
        return torch.randn((batch, heads, seq, width),
                           generator=gen, device=gen.device).to(
                               torch.bfloat16)

    sk = sq if sk is None else sk
    q, k, v = draw(h, sq), draw(kv, sk), draw(kv, sk, dv)
    # SDPA's GQA: the kv heads repeated once, outside the timed call
    k_rep, v_rep = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))

    def port():
        return L.flash_attention(q, k, v, causal)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k_rep, v_rep, is_causal=causal)

    a, b = port(), sdpa()
    torch.cuda.synchronize()
    rel = float((a.float() - b.float()).abs().max()
                / b.float().abs().max())
    require(rel <= SDPA_REL, f"flash scan vs SDPA: max rel {rel}")
    return {"q_shape": list(q.shape), "kv_shape": list(k.shape),
            "v_shape": list(v.shape), "causal": causal,
            "flash_scan_ms": device_ms(port), "sdpa_ms": device_ms(sdpa),
            "max_rel_diff": rel, "bound_rel": SDPA_REL}


def phase_moe_dfep(cfg, params, first_route, x0) -> dict:
    """DFEP expert placement on the card (module docstring, phase 10):
    ``place_experts`` on the expert ids the first MoE layer routed in the
    prefill, then that layer with its experts renamed by the placement's
    permutation against itself on the same input. Returns the path's
    launches."""
    from repro_torch.core import moe_dfep as MD
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    e, k = cfg.moe.n_experts, MOE_DFEP_SHARDS
    eidx = first_route.expert_idx.cpu().numpy()
    loads = np.bincount(eidx.reshape(-1), minlength=e).astype(float)
    # the path: the counters from 0, one placement, read just after
    before = _launch_counts()
    place, t = wall(lambda: MD.place_experts(eidx, n_experts=e, k=k,
                                             seed=SEED, device=x0.device))
    launches = _delta(before, _launch_counts())
    rounds = place.info["rounds"]
    require(launches.get("lane_cumsum", 0) > 0,
            "place_experts launched no lane_cumsum")
    require(sorted(place.permutation.tolist()) == list(range(e)),
            "the placement's permutation is not one of the experts")
    require(np.bincount(place.expert_to_shard, minlength=k).max()
            <= -(-e // k), "a shard holds more than E/K experts")
    naive = MD.naive_imbalance(loads, k)

    # the first MoE layer, its experts renamed, on its prefill input
    p0 = lm._index(params["blocks"]["l0"]["ffn"], 0)
    p1 = MD.permute_expert_params(p0, place.permutation)
    with L.record_routing() as rr:
        y0, aux0 = L.moe(cfg, p0, x0)
        y1, aux1 = L.moe(cfg, p1, x0)
    r0, r1 = rr
    perm = torch.as_tensor(place.permutation, device=y0.device)
    renamed = perm[r1.expert_idx]               # back to the old names
    o0, o1 = r0.expert_idx.argsort(1), renamed.argsort(1)
    same_set = (r0.expert_idx.gather(1, o0) == renamed.gather(1, o1)).all(1)
    same = same_set & (r0.keep.gather(1, o0) == r1.keep.gather(1, o1)).all(1)
    # a top-k boundary tie (the k-th and (k+1)-th router logits equal) is
    # broken lower index first, so renaming may pick the other expert
    logits = (x0.reshape(-1, cfg.d_model).to(torch.bfloat16)
              @ p0["router"].to(torch.bfloat16)).float()
    srt = logits.sort(dim=1, descending=True).values
    top = cfg.moe.top_k
    tie = srt[:, top - 1] == srt[:, top]
    require(bool((same_set | tie).all()),
            "renaming the experts changed a token's experts without a tie")
    f0, f1 = (y.reshape(-1, cfg.d_model).float() for y in (y0, y1))
    scale = float(f0[same].abs().max())
    err = float((f1[same] - f0[same]).abs().max())
    log({"phase": "moe_dfep", "experts": e, "shards": k,
         "tokens": int(eidx.shape[0]), "top_k": int(eidx.shape[1]),
         "rounds": rounds, "finalized": place.info["finalized"],
         "wall_s": t, "ms_per_round": 1e3 * t / max(rounds, 1),
         "launches": launches, "imbalance": place.imbalance,
         "naive_imbalance": naive,
         "shard_load": place.shard_load.tolist(),
         "permuted_layer": {
             "tokens_same_route": int(same.sum()),
             "tokens_other_experts": int((~same_set).sum()),
             "tokens_other_drops": int((same_set & ~same).sum()),
             "boundary_ties": int(tie.sum()),
             "drops": [int((~r.keep).sum()) for r in (r0, r1)],
             "max_abs_err": err, "max_abs_y": scale,
             "rel": err / scale, "bound_rel": MOE_PERM_REL,
             "aux": [float(aux0), float(aux1)]}})
    require(err <= MOE_PERM_REL * scale, f"the renamed layer differs: max "
            f"abs {err} > {MOE_PERM_REL} x {scale}")
    return launches


def _lm_phase_name(cfg) -> str:
    if cfg.family in ("hybrid", "encdec", "vlm"):
        return f"lm.{cfg.family}"
    if cfg.mla is not None:
        return "lm.mla"
    return "lm.moe" if cfg.moe is not None else "lm.dense"


def _scan_inputs(fn, calls: tuple) -> dict:
    """Run ``fn()``; copies of the arguments of its ``ops.selective_scan``
    calls number ``calls`` (0 the first), as {"layer{i}": args}."""
    from repro_torch.kernels import ops
    captured, count, real = {}, [0], ops.selective_scan

    def capture(*args):
        if count[0] in calls:
            captured[f"layer{count[0]}"] = tuple(
                None if t is None else t.clone() for t in args)
        count[0] += 1
        return real(*args)

    ops.selective_scan = capture
    try:
        fn()
    finally:
        ops.selective_scan = real
    return captured


def phase_lm_attn(arch: str, dev: str = "cuda",
                  n_layers: int | None = None, batch: int = LM_BATCH,
                  prompt: int = LM_PROMPT, cut_reason: str | None = None):
    """Attention serving at full width (module docstring, phases 9–15):
    qwen2-moe-a2.7b (``lm.moe``, then ``moe_dfep`` on its routing
    before it is freed), qwen3-4b (``lm.dense``) and whisper-small
    (``lm.encdec``) at full depth, jamba-v0.1-52b (``lm.hybrid``),
    deepseek-v2-236b (``lm.mla``) and llava-next-34b (``lm.vlm``) at
    ``n_layers``; ``batch`` prompts of ``prompt`` text tokens, LM_NEW new
    ones. encdec and vlm take their audio frames or image embeddings from
    ``SyntheticPipeline`` (seed SEED). Returns {"launches": generate's
    launches, "moe_dfep": the moe_dfep path's launches (qwen2-moe only),
    "scan_inputs": the first SSM layer's scan arguments in a prefill
    (hybrid only)}."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serve import serve_step as SS

    full = get_config(arch)
    cfg = full if n_layers is None else dataclasses.replace(
        full, n_layers=n_layers)
    name = _lm_phase_name(cfg)
    layers, s_max = cfg.n_layers, prompt + LM_NEW
    modal = cfg.family in ("encdec", "vlm")
    pattern = cfg.layer_pattern
    kinds = [pattern[i % len(pattern)] for i in range(layers)]
    n_ssm = kinds.count("ssm")
    n_moe = sum(cfg.moe_at(i % len(pattern)) for i in range(layers))
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params, t_init = wall(lambda: lm.init_params(cfg, gen, dev))
    leaves = _leaves(params)
    h, kv = L.pad_heads(cfg.n_heads, cfg.n_kv)
    cut = None if n_layers is None else {
        "n_layers": [full.n_layers, layers],
        "param_count_full": full.param_count()}
    if cut_reason is not None:
        cut.update(batch=batch, reason=cut_reason)
    log({"phase": f"{name}.init", "arch": cfg.name, "family": cfg.family,
         "n_layers": layers, "layer_pattern": list(pattern), "cut": cut,
         "n_enc_layers": cfg.n_enc_layers,
         "enc_seq": cfg.enc_seq if cfg.family == "encdec" else None,
         "n_img_tokens": cfg.n_img_tokens,
         "d_model": cfg.d_model, "heads": h, "kv_heads": kv,
         "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
         "qkv_bias": cfg.qkv_bias, "qk_norm": cfg.qk_norm,
         "mla": None if cfg.mla is None else dataclasses.asdict(cfg.mla),
         "ssm_layers": n_ssm, "moe_layers": n_moe,
         "moe": None if cfg.moe is None else {
             "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
             "d_ff_expert": cfg.moe.d_ff_expert,
             "n_shared": cfg.moe.n_shared, "every": cfg.moe.every,
             "capacity_prefill": L.moe_capacity(cfg, batch * prompt),
             "capacity_decode": L.moe_capacity(cfg, batch)},
         "vocab_pad": lm.vocab_pad(cfg), "params": sum(
             t.numel() for t in leaves), "param_count": cfg.param_count(),
         "param_bytes": sum(t.numel() * t.element_size() for t in leaves),
         "wall_s": t_init, "peak_mib": peak_mib()})

    modality, n_img = {}, 0
    if modal:   # the text, and the frames or image embeddings, of step 0
        data = SyntheticPipeline(cfg, DataConfig(batch, prompt, SEED),
                                 dev).batch_at(0)
        prompts = data["tokens"]
        modality = {k: data[k] for k in ("img_embeds", "enc_frames")
                    if k in data}
        n_img = cfg.n_img_tokens if "img_embeds" in modality else 0
    else:
        prompts = torch.randint(0, cfg.vocab, (batch, prompt),
                                generator=gen, device=dev)

    def prefill():
        with L.record_routing() as routes:
            out = lm.forward_lm(cfg, params, prompts, collect_cache=True,
                                **modality)
        return out, routes

    (((logits, aux, caches), routes), x0), t_first = wall(
        lambda: _with_first_moe_input(prefill))
    require(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    require(tuple(logits.shape) == (batch, n_img + prompt,
                                    lm.vocab_pad(cfg)),
            f"prefill logits of shape {tuple(logits.shape)}")
    aux = float(aux)
    if cfg.moe is not None:
        require(np.isfinite(aux) and aux > 0, f"MoE aux {aux} is not "
                "finite and positive")
    require(len(routes) == n_moe, f"{len(routes)} MoE calls in a prefill "
            f"of {layers} layers, {n_moe} of them MoE")
    t_warm = wall(lambda: SS.prefill(cfg, params, prompts, **modality))[1]
    drops_prefill, seq_drop = _dropped(routes, batch)
    encoder, cross = None, None
    if "enc_frames" in modality:   # the encoder apart from the decoder
        frames = modality["enc_frames"]
        memory, t_enc_first = wall(lambda: lm._encode(cfg, params, frames))
        t_enc = wall(lambda: lm._encode(cfg, params, frames))[1]
        cross, t_cross = wall(
            lambda: lm.cross_kvs_from_memory(cfg, params, memory))
        t_dec_prefill = wall(lambda: SS.prefill(cfg, params, prompts,
                                                memory=memory))[1]
        require(bool(torch.isfinite(memory).all()),
                "encoder output not finite")
        encoder = {"frames": list(frames.shape), "first_s": t_enc_first,
                   "warm_s": t_enc, "cross_kvs_s": t_cross,
                   "decoder_prefill_warm_s": t_dec_prefill}
        del memory

    grown = SS.grow_caches(cfg, caches, batch, n_img + s_max)
    tok = SS.greedy_token(logits[:, -1:], cfg.vocab)
    start = n_img + prompt

    def decode_run():
        c, t, lg = grown, tok, None
        for n in range(start, start + LM_NEW - 1):
            lg, c = SS.decode(cfg, params, t, c, n, cross)
            t = SS.greedy_token(lg[:, -1:], cfg.vocab)
        return lg

    with L.record_routing() as dec_routes:
        last, t_dec_first = wall(decode_run)
    require(bool(torch.isfinite(last).all()), "decode logits not finite")
    t_dec = wall(decode_run)[1]
    line = {"phase": f"{name}.prefill_decode", "batch": batch,
            "prompt_len": prompt}
    if modal:
        line.update(image_tokens=n_img, positions=n_img + prompt,
                    encoder=encoder)
    log({**line, "prefill_first_s": t_first,
         "prefill_warm_s": t_warm,
         "prefill_tokens_per_s": batch * (n_img + prompt) / t_warm,
         "aux": aux, "drops_per_layer": drops_prefill,
         "drops": sum(drops_prefill), "sequences_dropped": seq_drop.tolist(),
         "decode_steps": LM_NEW - 1,
         "decode_drops": sum(_dropped(dec_routes, batch)[0]),
         "decode_ms_per_step_first": 1e3 * t_dec_first / (LM_NEW - 1),
         "decode_ms_per_step": 1e3 * t_dec / (LM_NEW - 1),
         "decode_tokens_per_s": batch * (LM_NEW - 1) / t_dec,
         "peak_mib": peak_mib()})

    # the main path: the counters from 0, one generate, read just after
    engine = SS.Engine(cfg, params, s_max=s_max)
    torch.cuda.reset_peak_memory_stats()
    before = _launch_counts()
    with L.record_routing() as gen_routes:
        out, t_gen = wall(lambda: engine.generate(prompts, LM_NEW,
                                                  **modality))
    launches = _delta(before, _launch_counts())
    gen_peak = peak_mib()
    require(tuple(out.shape) == (batch, LM_NEW)
            and bool(((out >= 0) & (out < cfg.vocab)).all()),
            "generate's tokens are not [B, n_new] ids of the vocabulary")
    require(len(gen_routes) == n_moe * LM_NEW,
            f"generate made {len(gen_routes)} MoE calls")
    # the SSM layers' scan: once per layer and forward (prefill + decode)
    require(launches.get("selective_scan", 0) == n_ssm * LM_NEW,
            f"generate launched selective_scan "
            f"{launches.get('selective_scan', 0)} times, not {n_ssm} x "
            f"{LM_NEW}")
    # no layer of the encdec and vlm families reaches a kernel
    require(not modal or not any(launches.values()),
            f"{cfg.family}'s generate launched kernels: {launches}")

    # decode for token s against a prefill of s + 1 tokens where no token
    # was dropped: on the prompts' sequences that neither prefill dropped a
    # token of, and, for the MoE model, on LM_DROPFREE prompts, too few
    # tokens for any expert to overflow
    checks = {"prompts": _decode_vs_prefill(cfg, params, prompts,
                                            modality)}
    if modal:   # the same check with float32 compute: the logic, exactly
        checks["float32"] = _decode_vs_prefill(cfg, params, prompts,
                                               modality, torch.float32)
    if cfg.moe is not None:
        short = torch.randint(0, cfg.vocab, LM_DROPFREE, generator=gen,
                              device=dev)
        checks["drop_free"] = _decode_vs_prefill(cfg, params, short)
        require(checks["drop_free"]["drops"] == [0, 0],
                f"the drop-free prompts dropped: {checks['drop_free']}")
    bound = bf16_rel(layers + cfg.n_enc_layers)   # encdec: both stacks
    for c in checks.values():
        if "rel" not in c:
            continue
        # bf16: bf16_rel, unless the model's own two prefills already
        # disagree at a shared position by more than that (then bf16 noise
        # cannot tell decode from prefill at bf16_rel: their disagreement
        # plus bf16_rel); float32: F32_DECODE_REL
        c["held_to"] = (F32_DECODE_REL if "compute" in c
                        else bound if c["prefill_floor"] <= bound
                        else c["prefill_floor"] + bound)
    log({"phase": f"{name}.generate", "new_tokens": LM_NEW, "wall_s": t_gen,
         "tokens_per_s": batch * LM_NEW / t_gen, "launches": launches,
         "drops": sum(_dropped(gen_routes, batch)[0]),
         "peak_mib": gen_peak, "first_token_equals_prefill_argmax":
             torch.equal(out[:, :1], tok), "decode_vs_prefill": checks,
         "bound_rel": bound})
    applied = [c for c in checks.values() if "rel" in c]
    require(bool(applied), "no sequence free of drops: nothing held decode "
            "against a prefill of one more token")
    for c in applied:
        rel, held = c["rel"], c["held_to"]
        require(rel["right"] <= held, f"decode vs prefill of s + 1 tokens "
                f"({c['prompts']}, {c.get('compute', 'bfloat16')}): max "
                f"rel {rel['right']} > {held}")
        wrong = {k: v for k, v in rel.items() if k != "right"}
        require(min(wrong.values()) > max(held, bound), f"a zeroed cache "
                f"or a wrong offset passes the decode-vs-prefill bound "
                f"({c['prompts']}): {rel}")

    log({"phase": f"{name}.profile", "prefill": _device_profile(
        lambda: lm.forward_lm(cfg, params, prompts, collect_cache=True,
                              **modality)),
         "decode": _device_profile(
             lambda: SS.decode(cfg, params, tok, grown, start, cross))})
    # the flash scan against SDPA at each of the prefill's attention
    # shapes: whisper's decoder self-attention, its cross-attention over
    # the frames and its encoder; the others' (image and) text positions
    shapes = [("self", prompt, None, True)]
    if "enc_frames" in modality:
        shapes += [("cross", prompt, cfg.enc_seq, False),
                   ("encoder", cfg.enc_seq, None, False)]
    elif n_img:
        shapes = [("self", n_img + prompt, None, True)]
    for label, sq, sk, causal in shapes:
        log({"phase": f"{name}.sdpa_yardstick", "attention": label,
             **_sdpa_yardstick(cfg, gen, batch, sq, sk, causal)})
    result = {"launches": launches, "moe_dfep": None, "scan_inputs": None}
    if arch == LM_MOE_ARCH:
        result["moe_dfep"] = phase_moe_dfep(cfg, params, routes[0], x0)
    if n_ssm:   # the first SSM layer's scan, for the kernels phase
        result["scan_inputs"] = _scan_inputs(
            lambda: SS.prefill(cfg, params, prompts), (0,))["layer0"]
    log({"phase": f"{name}.peak", "peak_mib": peak_mib()})
    del params, leaves, engine, logits, caches, grown, last, cross
    del routes, gen_routes, dec_routes, modality
    torch.cuda.empty_cache()
    return result


def _patched_like(plan, gen, arrivals: int = 32):
    """A seeded plan-shaped input, as the streaming patch path leaves a
    plan: ~5% of CSR prefix slots deleted; ``arrivals`` vertex slots past
    each partition's ``n_local`` made live (their ``last_slot`` is the
    identity pad slot); about half of the free append slots
    ``[csr_fill, e_max-1)`` live, each its own segment, with random
    targets among the old and the arrived vertices."""
    dev = plan.device
    slot = torch.arange(plan.e_max, device=dev)[None, :]
    fill = plan.csr_fill.long()[:, None]
    rnd = torch.rand(plan.emask.shape, generator=gen, device=dev)
    dele = (slot < fill) & plan.emask & (rnd < 0.05)
    region = (slot >= fill) & (slot < plan.e_max - 1) & (rnd < 0.5)
    n_live = (plan.n_local + arrivals).clamp(max=plan.v_max)
    vslot = torch.arange(plan.v_max, device=dev)[None, :]
    tgt = (torch.rand(plan.emask.shape, generator=gen, device=dev)
           * n_live[:, None]).to(torch.int32)
    return dataclasses.replace(
        plan, vmask=plan.vmask | (vslot < n_live[:, None]),
        emask=(plan.emask & ~dele) | region,
        seg_start=plan.seg_start | region,
        edge_tgt=torch.where(region, tgt, plan.edge_tgt))


def _seg_bound(plan, f: int = 1) -> tuple[float, str]:
    """Least time for segment_reduce on this plan, from its work count
    (``kernels.segment_reduce_work``, which the cost model prices too)."""
    from repro_torch.engine import kernels
    return _work_bound(kernels.segment_reduce_work(plan, f))


def _mu_bound(plan, f: int = 1) -> tuple[float, str]:
    """Least time for the fused masked_update on this plan
    (``kernels.masked_update_work``)."""
    from repro_torch.engine import kernels
    return _work_bound(kernels.masked_update_work(plan, f))


def _exchange_bound(plan, f: int = 1) -> tuple[float, str]:
    """Least time for the exchange on this plan
    (``kernels.exchange_work``)."""
    from repro_torch.engine import kernels
    return _work_bound(kernels.exchange_work(plan, f))


def _exchange_plans(g, owner, plan, patched) -> dict:
    """The exchange's plans: the main path's, the patched one, a hub in
    all K partitions (a star of EXCHANGE_HUB_LEAVES leaves on a path, each
    edge owned by ``dst % K``; each leaf in two or three partitions), and
    the main path's graph and owner compiled for K + 1 partitions (the
    last one empty)."""
    from repro_torch import engine as E
    from repro_torch.core import graph
    n = EXCHANGE_HUB_LEAVES
    star = np.stack([np.zeros(n, np.int64), np.arange(1, n + 1)], 1)
    path = np.stack([np.arange(1, n), np.arange(2, n + 1)], 1)
    hub_g = graph.from_edge_array(n + 1, np.concatenate([star, path]))
    hub = E.compile_plan(hub_g, torch.where(hub_g.edge_mask, hub_g.dst % K,
                                            -2), K)
    return {"plan": plan, "patched": patched, "hub": hub,
            "empty_part": E.compile_plan(g, owner, K + 1)}


def _exchange_checks(Kn, plans, gen) -> float:
    """exchange against its plain versions on each of ``plans`` at F = 1
    and 8: bit for bit against the layout's plain walk
    (``exchange_layout_ref``) for min, add and max; against the reference
    chain (``exchange_ref``) min and max exact, add within
    EXCHANGE_ADD_ATOL, and two add calls the same bits. Returns the
    largest |kernel - chain|."""
    errs, stats = {}, {}
    for pname, p in plans.items():
        lay = Kn.exchange_layout(p)
        stats[pname] = dict(lay.stats(), build_s=wall(
            lambda: Kn.build_exchange_layout(p))[1])
        for f in (1, 8):
            shape = (p.k, p.v_max) + ((f,) if f > 1 else ())
            x = torch.rand(shape, generator=gen, device=p.device)
            inf = torch.rand(shape, generator=gen, device=p.device) < 0.2
            for combine in ("min", "add", "max"):
                key = f"{pname}.f{f}.{combine}"
                vals = torch.where(inf, float("inf"), x * 30) \
                    if combine == "min" else x
                got = Kn.exchange(p, vals, combine)
                require(torch.equal(got, Kn.exchange_layout_ref(
                    p, vals, combine)), f"exchange {key}: not its layout "
                    "walk, bit for bit")
                want = Kn.exchange_ref(p, vals, combine)
                torch.cuda.synchronize()
                errs[key] = _max_abs(got, want)
                if combine == "add":
                    require(errs[key] <= EXCHANGE_ADD_ATOL,
                            f"exchange {key}: max abs {errs[key]}")
                    require(torch.equal(Kn.exchange(p, vals, combine), got),
                            f"exchange {key}: two calls differ")
                else:
                    require(torch.equal(got, want),
                            f"exchange {key} is not exact")
            del x, inf
    log({"phase": "kernels.exchange.check", "max_abs_err": errs,
         "layout_walk_identical": True, "add_repeat_identical": True,
         "layouts": stats})
    return max(errs.values())


def _exchange_values(plan, gen, f: int, combine: str) -> torch.Tensor:
    """[K, Vmax(, F)] exchange values: in [0, 30) with ~20% +inf
    (unreached) for min, in [0, 1) for add and max."""
    shape = (plan.k, plan.v_max) + ((f,) if f > 1 else ())
    x = torch.rand(shape, generator=gen, device=plan.device)
    if combine != "min":
        return x
    return torch.where(torch.rand(shape, generator=gen, device=plan.device)
                       < 0.2, float("inf"), x * 30)


def _exchange_timing(Kn, plan, gen, times) -> dict:
    """exchange on the main path's plan at EXCHANGE_CASES: the kernel, its
    plain version and the parent's chain (``exchange_ref`` closed by the
    ``masked_update`` kernel, as the engine ran it before), device and
    eager ms; the kernel and the chain also in turns (chain, kernel,
    kernel, chain); the bound."""
    out = {}
    for label, f, combine in EXCHANGE_CASES:
        vals = _exchange_values(plan, gen, f, combine)

        def kernel():
            return Kn.exchange(plan, vals, combine)

        def chain():
            return Kn.exchange_ref(plan, vals, combine,
                                   update=Kn.masked_update)
        t = times(kernel=kernel, plain=lambda: Kn.exchange_ref(
            plan, vals, combine), library=chain)
        c1, k1 = device_ms(chain), device_ms(kernel)
        k2, c2 = device_ms(kernel), device_ms(chain)
        t["turns"] = {"library_ms": [c1, c2], "kernel_ms": [k1, k2]}
        t["bound_ms"], t["bound_by"] = _exchange_bound(plan, f)
        out[label] = t
        del vals
    log({"phase": "kernels.exchange.timing", **out})
    return out


def _lane_timing(Kn, plan, gen, times) -> dict:
    """segment_reduce and exchange (min) at the serve path's lane widths
    (SERVE_WIDTHS): [K, Emax, S] messages and [K, Vmax, S] states, each
    held exact against its plain version and timed beside its bound and a
    library call (``scatter_reduce`` amin; the parent's exchange chain)."""
    dev = plan.device
    inf = float("inf")
    rows = torch.arange(plan.k, device=dev)[:, None] * plan.v_max
    out = {"segment_reduce": {}, "exchange": {}}
    for s in SERVE_WIDTHS:
        shape = (plan.k, plan.e_max, s)
        msgs = torch.where(torch.rand(shape, generator=gen, device=dev)
                           < 0.2, inf, torch.rand(shape, generator=gen,
                                                  device=dev) * 30)
        idx = (rows + plan.edge_tgt.long()).reshape(-1, 1).expand(-1, s)
        masked = torch.where(plan.emask[:, :, None], msgs, inf).reshape(-1, s)
        ident = torch.full((plan.k * plan.v_max, s), inf, device=dev)
        require(torch.equal(Kn.segment_reduce(plan, msgs, "min"),
                            Kn.segment_reduce_ref(plan, msgs, "min")),
                f"segment_reduce min at F={s} is not exact")
        t = times(iters=10,
                  kernel=lambda: Kn.segment_reduce(plan, msgs, "min"),
                  plain=lambda: Kn.segment_reduce_ref(plan, msgs, "min"),
                  library=lambda: torch.scatter_reduce(ident, 0, idx, masked,
                                                       "amin"))
        t["bound_ms"], t["bound_by"] = _seg_bound(plan, s)
        out["segment_reduce"][f"s{s}"] = t
        del msgs, idx, masked, ident
        vals = _exchange_values(plan, gen, s, "min")
        got = Kn.exchange(plan, vals, "min")
        require(torch.equal(got, Kn.exchange_layout_ref(plan, vals, "min"))
                and torch.equal(got, Kn.exchange_ref(plan, vals, "min")),
                f"exchange min at F={s} is not exact")
        t = times(iters=10, kernel=lambda: Kn.exchange(plan, vals, "min"),
                  plain=lambda: Kn.exchange_ref(plan, vals, "min"),
                  library=lambda: Kn.exchange_ref(plan, vals, "min",
                                                  update=Kn.masked_update))
        t["bound_ms"], t["bound_by"] = _exchange_bound(plan, s)
        out["exchange"][f"s{s}"] = t
        del vals, got
    log({"phase": "kernels.lanes.timing", **out})
    return out


def _gspmm_bound(plan, f: int, per_feature: bool = False
                 ) -> tuple[float, str]:
    """Least time for gspmm on this plan (``kernels.gspmm_work``)."""
    from repro_torch.engine import kernels
    return _work_bound(kernels.gspmm_work(plan, f, per_feature))


def _spmm_matrix(plan):
    """The yardstick's operand: the live half-edges as one block-diagonal
    CSR matrix [K·Vmax, K·Vmax] (row: target, column: neighbour, value:
    ``edge_w``), so ``torch.sparse.mm(a, feats.view(K·Vmax, F))`` computes
    gspmm's add on a fresh plan."""
    base = torch.arange(plan.k, device=plan.device)[:, None] * plan.v_max
    idx = torch.stack([(base + plan.edge_tgt.long())[plan.emask],
                       (base + plan.edge_nbr.long())[plan.emask]])
    n = plan.k * plan.v_max
    return torch.sparse_coo_tensor(idx, plan.edge_w[plan.emask], (n, n),
                                   check_invariants=False) \
        .coalesce().to_sparse_csr()


def _hub_split(plan):
    """(the target with the longest run, the plan with only that run live,
    the plan with no live slot). The two plans are ``dataclasses.replace``d,
    so each builds its kernels' layouts at its first call, which must not be
    inside a CUDA-graph capture: ``device_ms`` makes that call while it
    warms up, on a side stream, before it captures."""
    base = torch.arange(plan.k, device=plan.device)[:, None] * plan.v_max
    tgt = base + plan.edge_tgt.long()
    runs = torch.zeros(plan.k * plan.v_max, device=plan.device)
    runs.index_add_(0, tgt[plan.emask],
                    torch.ones(int(plan.emask.sum()), device=plan.device))
    hub = int(runs.argmax())
    mask = plan.emask & (tgt == hub)
    return ({"target": hub, "partition": hub // plan.v_max,
             "run_slots": int(runs[hub])},
            dataclasses.replace(plan, emask=mask),
            dataclasses.replace(plan, emask=torch.zeros_like(mask)))


def _gspmm_checks(Kn, plan, patched, gen):
    """gspmm against gspmm_ref: both plans, F = 1 (rank-2 feats), 8, 128,
    scalar and per-feature weights, add/max/mean. max is exact; add and mean
    within GSPMM_ADD_RTOL on non-negative inputs."""
    dev = plan.device
    errs, rels = {}, {}
    for f in (1,) + GSPMM_WIDTHS + (GSPMM_LANE_WIDTH,):
        feats = torch.rand((plan.k, plan.v_max, f), generator=gen,
                           device=dev)
        if f == 1:
            feats = feats[:, :, 0]
        wide = torch.rand(tuple(plan.emask.shape) + (f,), generator=gen,
                          device=dev)
        for pname, p in (("plan", plan), ("patched", patched)):
            for wname, w in (("scalar", p.edge_w), ("feature", wide)):
                for combine in ("add", "max", "mean"):
                    key = f"{pname}.f{f}.{wname}.{combine}"
                    got = Kn.gspmm(p, feats, w, combine)
                    want = Kn.gspmm_ref(p, feats, w, combine)
                    torch.cuda.synchronize()
                    require(got.shape == (p.k, p.v_max, f),
                            f"gspmm {key}: shape {tuple(got.shape)}")
                    if combine == "max":
                        require(torch.equal(got, want),
                                f"gspmm {key} is not exact")
                    fin = torch.isfinite(want)
                    diff = (got[fin] - want[fin]).abs()
                    errs[key] = float(diff.max())
                    rels[key] = float((diff / want[fin].abs().clamp(
                        min=1e-30)).max())
                    if combine != "max":
                        require(rels[key] <= GSPMM_ADD_RTOL,
                                f"gspmm {key}: max rel {rels[key]}")
                    if combine == "add":
                        require(torch.equal(Kn.gspmm(p, feats, w, combine),
                                            got),
                                f"gspmm {key}: two calls differ")
        del feats, wide
    log({"phase": "kernels.gspmm.check", "max_abs_err": errs,
         "max_rel_err": rels, "add_repeat_identical": True})
    return errs


def _gspmm_timing(Kn, plan, gen, times):
    """gspmm with add at the widths in GSPMM_WIDTHS with scalar weights,
    and at kge_score's F = 8 with per-feature weights (``feature_f8``):
    kernel, plain and (scalar weights) ``torch.sparse.mm`` device and eager
    times, the bound, and the largest hub run's own time: the kernel with
    only that run live less the kernel with no live slot (both still walk
    every target), measured HUB_REPEATS times interleaved, the median of
    the differences kept and the spread reported."""
    dev = plan.device
    a = _spmm_matrix(plan)
    hub, hub_only, empty = _hub_split(plan)
    out = {"largest_hub": hub}
    cases = [(f"f{f}", f, False) for f in GSPMM_WIDTHS] + \
        [("feature_f8", 8, True)]
    lane_cases = [(f"lanes_f{GSPMM_LANE_WIDTH}", GSPMM_LANE_WIDTH, False),
                  (f"lanes_feature_f{GSPMM_LANE_WIDTH}", GSPMM_LANE_WIDTH,
                   True)]
    for name, f, per_feature in cases + lane_cases:
        feats = torch.rand((plan.k, plan.v_max, f), generator=gen,
                           device=dev)
        wide = torch.rand(tuple(plan.emask.shape) + (f,), generator=gen,
                          device=dev) if per_feature else None

        def call(p, fn=Kn.gspmm):
            w = wide if per_feature else p.edge_w
            return lambda: fn(p, feats, w, "add")
        fns = {"kernel": call(plan), "plain": call(plan, Kn.gspmm_ref)}
        t = {}
        if not per_feature:
            dense = feats.view(plan.k * plan.v_max, f)
            lib = torch.sparse.mm(a, dense).view(plan.k, plan.v_max, f)
            got = Kn.gspmm(plan, feats, plan.edge_w, "add")
            t["library_max_rel_vs_kernel"] = float(
                ((lib - got).abs() / got.abs().clamp(min=1e-30)).max())
            fns["library"] = lambda: torch.sparse.mm(a, dense)
            del lib, got
        iters = 20 if f <= 8 else 5
        t.update(times(iters=iters, **fns))
        t["bound_ms"], t["bound_by"] = _gspmm_bound(plan, f, per_feature)
        out[name] = t
        if name.startswith("lanes"):    # the batched GNN runs' widths
            del feats, fns, wide
            continue
        pairs = [(device_ms(call(hub_only)), device_ms(call(empty)))
                 for _ in range(HUB_REPEATS)]
        t["hub_only_ms"] = [h for h, _ in pairs]
        t["empty_ms"] = [e for _, e in pairs]
        t["hub_run_ms"] = float(np.median([h - e for h, e in pairs]))
        del feats, fns, wide
    lay = Kn.gspmm_layout(plan)
    out["layout"] = {"chunk_slots": lay.chunk_slots, "chunks": lay.n_chunks,
                     "units": lay.seg.n_units,
                     "split_units": int(torch.unique(
                         lay.chunks[lay.chunks[:, 5] > 1, 3]).numel()),
                     "build_s": wall(lambda: Kn.build_gspmm_layout(
                         plan, lay.seg))[1]}
    log({"phase": "kernels.gspmm.timing", **out})
    return out


def _work_bound(work: tuple[int, int]) -> tuple[float, str]:
    """``_bound`` of a kernel's ``(operations, bytes)`` work count."""
    flops, nbytes = work
    return _bound(nbytes, flops)


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the entries where ``want`` is finite
    (0.0 if none); infinities must match exactly, which the callers check
    with ``torch.equal``."""
    fin = torch.isfinite(want.double())
    if not bool(fin.any()):
        return 0.0
    return float((got.double()[fin] - want.double()[fin]).abs().max())


def slow_ms(fn, iters: int = 2) -> float:
    """Mean ms of ``fn`` over ``iters`` eager calls after one warm call
    (CUDA events), for calls of hundreds of ms, where a CUDA graph's saving
    (the host launch cost) is noise."""
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


def _flat_scan_cumsum(x: torch.Tensor) -> torch.Tensor:
    """The yardstick DFEP's rank cumsum used before lane_cumsum: the K
    columns of an [N, K] int32 array laid end to end and scanned as one flat
    array (one device-wide scan), then each column's offset, the total of
    the columns before it, taken off."""
    n, k = x.shape
    flat = torch.cumsum(x.t().reshape(-1), 0, dtype=torch.int32).view(k, n)
    before = torch.zeros(k, dtype=torch.int32, device=x.device)
    before[1:] = flat[:-1, -1]
    return (flat - before[:, None]).t()


def _dfep_rank_inputs(g, owner):
    """DFEP's two rank-cumsum inputs on its final state: [2·e_pad, K] 0/1
    eligibility of each slot's edge for each partition (an owned edge is
    eligible for its owner only), in slot order, and [V, K] 0/1 presence of
    each vertex in each partition."""
    from repro_torch.core import dfep
    slots = dfep.build_slots(g)
    part_ids = torch.arange(K, device=g.device)
    elig = ((owner.long()[:, None] == part_ids[None, :])
            & g.edge_mask[:, None]).to(torch.int32)
    pres = torch.zeros((g.n_vertices, K), dtype=torch.int32, device=g.device)
    pres.index_add_(0, g.src.long(), elig)
    pres.index_add_(0, g.dst.long(), elig)
    return elig[slots.edge].contiguous(), (pres > 0).to(torch.int32)


def _replay_check(name: str, static_in, other, plain):
    """A device_ms ``check``: copy ``other`` into the graph's input
    ``static_in``, replay once more, and require the last call's output to
    equal ``plain(static_in)``. A new input makes look-back flags left over
    from the replays before show."""
    def check(replay, out):
        static_in.copy_(other)
        replay()
        torch.cuda.synchronize()
        require(torch.equal(out, plain(static_in)), f"{name} differs from "
                "the plain version after a graph replay")
    return check


def _lane_cumsum_section(g, owner, gen, times) -> dict:
    """lane_cumsum on DFEP's rank inputs (int32, exact against the plain
    version and the flat scan) and on float32 values in [0, 1) (within
    FLOAT_CUMSUM_RTOL of a float64 cumsum); timed on the [2·e_pad, K]
    input, each timing graph replayed once more on the input shifted by a
    row and held against the plain version."""
    from repro_torch.kernels import ops, ref
    x_slot, x_pres = _dfep_rank_inputs(g, owner)
    shapes, err = {}, 0.0
    for name, x in (("slots", x_slot), ("presence", x_pres)):
        got = ops.lane_cumsum(x)
        want = ref.cumsum_lanes(x)
        torch.cuda.synchronize()
        err = max(err, _max_abs(got, want))
        require(torch.equal(got, want), f"lane_cumsum {name} is not exact")
        require(torch.equal(got, _flat_scan_cumsum(x)),
                f"lane_cumsum {name} differs from the flat scan")
        shapes[name] = list(x.shape)
    xf = torch.rand(x_slot.shape, generator=gen, device=x_slot.device)
    gotf = ops.lane_cumsum(xf).double()
    wantf = torch.cumsum(xf.double(), 0)
    rel_f = float(((gotf - wantf).abs() / wantf.clamp(min=1.0)).max())
    plain_rel_f = float(((ref.cumsum_lanes(xf).double() - wantf).abs()
                         / wantf.clamp(min=1.0)).max())
    require(rel_f <= FLOAT_CUMSUM_RTOL, f"lane_cumsum float32: max rel "
            f"{rel_f} > {FLOAT_CUMSUM_RTOL}")
    del xf, gotf, wantf
    s, k = x_slot.shape
    static = {"slots": x_slot.clone(), "presence": x_pres.clone()}
    checks = {n: _replay_check(f"lane_cumsum {n}", x, torch.roll(x, 1, 0),
                               ref.cumsum_lanes) for n, x in static.items()}
    t = times(kernel=lambda: ops.lane_cumsum(static["slots"]),
              flat_scan=lambda: _flat_scan_cumsum(x_slot),
              check=checks["slots"])
    t["presence_kernel_ms"] = device_ms(
        lambda: ops.lane_cumsum(static["presence"]),
        check=checks["presence"])
    # torch.cumsum down dim 0 runs K serial scans (~0.7 s a call here)
    t["plain_ms"] = slow_ms(lambda: ref.cumsum_lanes(x_slot))
    t["library_ms"] = slow_ms(lambda: torch.cumsum(x_slot, 0))
    t["bound_ms"], t["bound_by"] = _bound(8 * s * k, s * k)
    out = {"shapes": shapes, "max_abs_err": err, "graph_replay_exact": True,
           "float32_max_rel_vs_f64": rel_f,
           "plain_float32_max_rel_vs_f64": plain_rel_f, **t}
    log({"phase": "kernels.lane_cumsum", **out})
    return out


def _frontier_min_timing(state, member, times, name: str) -> dict:
    """Device and eager ms of frontier_min, its plain version and
    ``torch.amin`` of the pre-masked state, the timing graph replayed once
    more on the state reversed along V and held against the plain version;
    with the bound: the member mask read, the state read where a member
    needs it (the kernel skips the rest) and the output written."""
    from repro_torch.kernels import ops, ref
    k, v = state.shape
    static = state.clone()
    masked = torch.where(member, state, float("inf"))
    t = times(kernel=lambda: ops.frontier_min(static, member),
              plain=lambda: ref.kreduce_min(state, member),
              library=lambda: torch.amin(masked, 0),
              check=_replay_check(f"frontier_min {name}", static,
                                  state.flip(1),
                                  lambda st: ref.kreduce_min(st, member)))
    members = int(member.sum())
    t["bound_ms"], t["bound_by"] = _bound(k * v + 4 * members + 4 * v,
                                          members)
    return t


def _frontier_min_section(part, gen, times) -> dict:
    """frontier_min on a [K, V] state with ~20% +inf, the real member mask,
    and the same with vertex 0 in no partition; float32 and bfloat16;
    exact against the plain version. Timed there and at multi-source
    SSSP's [K, N_SOURCES·V] with its member mask (each row's mask repeated
    per source), which is checked exact too."""
    from repro_torch.kernels import ops, ref
    dev = part.device
    k, v = part.k, part.n_vertices
    state = torch.rand((k, v), generator=gen, device=dev) * 30
    state = torch.where(torch.rand((k, v), generator=gen, device=dev) < 0.2,
                        float("inf"), state)
    lonely = part.member.clone()
    lonely[:, 0] = False
    err = 0.0
    for name, member in (("member", part.member), ("no_member_col0", lonely)):
        for dtype in (torch.float32, torch.bfloat16):
            st = state.to(dtype)
            got = ops.frontier_min(st, member)
            want = ref.kreduce_min(st, member)
            torch.cuda.synchronize()
            err = max(err, _max_abs(got, want))
            require(torch.equal(got, want),
                    f"frontier_min {name} {dtype} is not exact")
    require(bool(torch.isinf(ops.frontier_min(state, lonely)[0])),
            "frontier_min: a column with no member is not +inf")
    t = _frontier_min_timing(state, part.member, times, "[K, V]")
    member_sv = (part.member[:, None, :].expand(k, N_SOURCES, v)
                 .reshape(k, N_SOURCES * v))
    state_sv = torch.rand((k, N_SOURCES * v), generator=gen, device=dev) * 30
    state_sv = torch.where(member_sv, state_sv, float("inf"))
    got = ops.frontier_min(state_sv, member_sv)
    require(torch.equal(got, ref.kreduce_min(state_sv, member_sv)),
            "frontier_min at the multi-source shape is not exact")
    t_sv = _frontier_min_timing(state_sv, member_sv, times, "[K, S·V]")
    out = {"shape": [k, v], "max_abs_err": err, "graph_replay_exact": True,
           **t, "multi_source": {"shape": [k, N_SOURCES * v], **t_sv}}
    log({"phase": "kernels.frontier_min", **out})
    return out


def _minplus_bound(mask: torch.Tensor, rows: int,
                   replicas: int = 1) -> tuple[float, str]:
    """minplus_sweep's bound: the state read and written once, every mask
    byte and each live edge's two endpoints (int32) read once (the
    replicas share one edge list), and two candidates per live edge and
    replica."""
    live = int(mask.sum())
    return _bound(8 * rows + int(mask.numel()) + 8 * live,
                  2 * live * replicas)


def _minplus_section(g, part, road_part, gen, times, sssp_state) -> dict:
    """minplus_sweep at its four shapes: ETSCH's flat [K·V] state over its
    K·e_max edge slots (the table's), the whole graph's [V], multi-source
    SSSP's [K·N_SOURCES·V] under the flat layout with N_SOURCES replicas,
    and usroads' flat [K·V]; costs 1 and 0, ~5% of the live edges masked
    out, ~20% of the values +inf; exact against the plain version with the
    memoised layout and, at one replica, without one (the wrapper builds
    it). The layouts' build time is logged as set-up. Timed at cost 1 on
    each shape, each timing graph replayed once more on a new state and
    held exact, and on SSSP's fixed point (``sssp_state`` on every
    member), where no candidate wins."""
    from repro_torch.core import algorithms as A
    from repro_torch.kernels import ops, ref
    dev = part.device
    kv = part.k * part.n_vertices

    def state(n, member=None):
        x = torch.rand(n, generator=gen, device=dev) * 30
        x = torch.where(torch.rand(n, generator=gen, device=dev) < 0.2,
                        float("inf"), x)
        return x if member is None else torch.where(member, x, float("inf"))

    def thin(mask):
        return mask & (torch.rand(mask.shape, generator=gen, device=dev)
                       >= 0.05)

    build = {}
    for name, make in (
            ("etsch", lambda: ops.minplus_layout(
                part.flat_src, part.flat_dst, kv, groups=part.k)),
            ("graph", lambda: ops.minplus_layout(g.src, g.dst,
                                                 g.n_vertices)),
            ("usroads", lambda: ops.minplus_layout(
                road_part.flat_src, road_part.flat_dst,
                road_part.k * road_part.n_vertices, groups=road_part.k))):
        lay, t = wall(make)
        build[name] = {"wall_s": t, "tile_rows": lay.tile_rows,
                       "half_edges": int(lay.half_edges.shape[0]),
                       "short_rows": int(lay.entries.shape[0])
                       - sum(lay.counts),
                       "units": list(lay.counts)}
    log({"phase": "kernels.minplus_sweep.layout", **build})
    member_sv = part.member[:, None, :].expand(part.k, N_SOURCES,
                                               part.n_vertices).reshape(-1)
    cases = {
        "etsch": (state(kv, part.member.reshape(-1)), part.flat_src,
                  part.flat_dst, thin(part.flat_mask), part.minplus_layout),
        "graph": (state(g.n_vertices), g.src, g.dst, thin(g.edge_mask),
                  A._graph_layout(g)),
        "multi_source": (state(kv * N_SOURCES, member_sv), part.flat_src,
                         part.flat_dst, thin(part.flat_mask),
                         part.minplus_layout.with_replicas(N_SOURCES)),
        "usroads": (state(road_part.k * road_part.n_vertices,
                          road_part.member.reshape(-1)), road_part.flat_src,
                    road_part.flat_dst, thin(road_part.flat_mask),
                    road_part.minplus_layout),
    }

    def plain(dist, src, dst, mask, lay, cost=1.0):
        return ref.minplus_relax(dist, *lay.replicate(src, dst, mask), cost)

    err = 0.0
    for name, (dist, src, dst, mask, lay) in cases.items():
        for cost in (1.0, 0.0):
            want = plain(dist, src, dst, mask, lay, cost)
            got = [ops.minplus_sweep(dist, src, dst, mask, cost, layout=lay)]
            if lay.replicas == 1:
                got.append(ops.minplus_sweep(dist, src, dst, mask, cost))
            torch.cuda.synchronize()
            for out in got:
                err = max(err, _max_abs(out, want))
                require(torch.equal(out, want),
                        f"minplus_sweep {name} cost {cost} is not exact")
    out = {}
    for name, (dist, src, dst, mask, lay) in cases.items():
        static = dist.clone()
        check = _replay_check(
            f"minplus_sweep {name}", static, state(dist.numel()),
            lambda d: plain(d, src, dst, mask, lay))
        kernel = lambda: ops.minplus_sweep(static, src, dst, mask,
                                           layout=lay)
        if name == "etsch":
            s64, d64 = src.long(), dst.long()
            cu = torch.where(mask, dist[s64] + 1.0, float("inf"))
            cv = torch.where(mask, dist[d64] + 1.0, float("inf"))
            t = times(kernel=kernel,
                      plain=lambda: plain(dist, src, dst, mask, lay),
                      library=lambda: dist.scatter_reduce(
                          0, d64, cu, "amin").scatter_reduce_(
                              0, s64, cv, "amin"), check=check)
        else:
            t = {"kernel_ms": device_ms(kernel, check=check)}
        t["bound_ms"], t["bound_by"] = _minplus_bound(
            mask, lay.n_rows * lay.replicas, lay.replicas)
        out[name] = {"rows": lay.n_rows * lay.replicas,
                     "edge_slots": int(mask.numel()) * lay.replicas,
                     "live_edges": int(mask.sum()) * lay.replicas, **t}
    dist, src, dst, mask, lay = cases["etsch"]
    fixed = torch.where(part.member, sssp_state[None, :],
                        float("inf")).reshape(-1)
    require(torch.equal(ops.minplus_sweep(fixed, src, dst, part.flat_mask,
                                          layout=lay), fixed),
            "SSSP's fixed point moved under a sweep")
    out["etsch"]["fixpoint_kernel_ms"] = device_ms(lambda: ops.minplus_sweep(
        fixed, src, dst, part.flat_mask, layout=lay))
    res = {"max_abs_err": err, "graph_replay_exact": True, **out}
    log({"phase": "kernels.minplus_sweep", **res})
    return res


#: Hopper's SFU rate for ex2: results per clock per SM (CUDA C++
#: Programming Guide, arithmetic instruction throughput, compute
#: capability 9.0).
EX2_PER_CLOCK_PER_SM = 16


def _sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return 1e6 * float(out.strip().splitlines()[0])


def _scan_bound(b: int, s: int, d: int, n: int, h0: bool):
    """selective_scan's bound terms in ms, as ``(ms, by, terms)`` with
    ``by`` "bytes" or "operations": the bytes and float32 operations of
    ``ops.selective_scan_work`` (inputs and outputs once; 6 operations per
    state element and step), and one exp per state element and step at
    EX2_PER_CLOCK_PER_SM on every SM at the maximum SM clock (exps). The
    larger of flops and exps is the operations term."""
    from repro_torch.kernels import ops
    elems = b * s * d * n
    flops, nbytes = ops.selective_scan_work(b, s, d, n, h0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    terms = {"bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
             "flops_ms": 1e3 * flops / FP32_FLOPS,
             "exps_ms": 1e3 * elems / (EX2_PER_CLOCK_PER_SM * sms
                                       * _sm_clock_hz()),
             "exps": elems, "sms": sms}
    ops_ms = max(terms["flops_ms"], terms["exps_ms"])
    terms["binding"] = ("bytes" if terms["bytes_ms"] >= ops_ms else
                        "exps" if terms["exps_ms"] >= terms["flops_ms"]
                        else "flops")
    if terms["bytes_ms"] >= ops_ms:
        return terms["bytes_ms"], "bytes", terms
    return ops_ms, "operations", terms


def _selective_scan_section(captured, hybrid, gen, times) -> dict:
    """selective_scan against its plain loop, y and h_last within SCAN_REL
    of their largest |value|: seeded inputs at the prefill shape (the
    captured layers' [B, S, Di] and N; the JAX
    kernel tests' distributions) from a zero and a random h0, S = 1 from a
    random h0 (decode), the lm phase's captured layer inputs and the
    lm.hybrid phase's (``hybrid``: jamba's first SSM layer); timed at
    the prefill shape from a zero state, as prefill calls it, at S = 1
    from h0, as decode calls it, and on jamba's inputs; bounds from
    :func:`_scan_bound`."""
    from repro_torch import cuda_build
    from repro_torch.kernels import ops, ref
    x0, a0 = captured["layer0"][0], captured["layer0"][4]
    (b, s, d), n, dev = x0.shape, a0.shape[1], x0.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x, bb, cc = randn(b, s, d), randn(b, s, n, scale=0.5), \
        randn(b, s, n, scale=0.5)
    dt = torch.nn.functional.softplus(randn(b, s, d))
    a = torch.exp(randn(d, n, scale=0.3))
    dsk, h0 = randn(d), randn(b, d, n)
    cases = {"prefill": (x, dt, bb, cc, a, dsk, None),
             "prefill_h0": (x, dt, bb, cc, a, dsk, h0),
             "decode": (x[:, :1].contiguous(), dt[:, :1].contiguous(),
                        bb[:, :1].contiguous(), cc[:, :1].contiguous(), a,
                        dsk, h0), **captured, "jamba.layer0": hybrid}
    err, rel = {}, {}
    for name, args in cases.items():
        got = ops.selective_scan(*args)
        want = ref.selective_scan_ref(*args)
        torch.cuda.synchronize()
        for part, g, w in zip(("y", "h_last"), got, want):
            e = float((g - w).abs().max())
            err[f"{name}.{part}"] = e
            rel[f"{name}.{part}"] = e / float(w.abs().max())
            require(bool(torch.isfinite(g).all()) and e <= SCAN_REL * float(
                w.abs().max()), f"selective_scan {name} {part}: max abs {e}"
                f" > {SCAN_REL} x {float(w.abs().max())}")
    log({"phase": "kernels.selective_scan.check", "max_abs_err": err,
         "max_rel_err": rel, "captured_shapes": {
             k: list(v[0].shape) for k, v in captured.items()}})
    prefill = cases["prefill"]
    t = times(kernel=lambda: ops.selective_scan(*prefill))
    t["plain_ms"] = slow_ms(lambda: ref.selective_scan_ref(*prefill))
    t["decode_kernel_ms"] = device_ms(lambda: ops.selective_scan(
        *cases["decode"]))
    t["decode_plain_ms"] = device_ms(lambda: ref.selective_scan_ref(
        *cases["decode"]))
    hb, hs, hd = hybrid[0].shape
    hn = hybrid[4].shape[1]
    t["hybrid_ms"] = device_ms(lambda: ops.selective_scan(*hybrid))
    terms = {"prefill": _scan_bound(b, s, d, n, h0=False),
             "decode": _scan_bound(b, 1, d, n, h0=True),
             "hybrid": _scan_bound(hb, hs, hd, hn, h0=hybrid[6] is not None)}
    t["bound_ms"], t["bound_by"] = terms["prefill"][:2]
    t["decode_bound_ms"], t["decode_bound_by"] = terms["decode"][:2]
    t["hybrid_bound_ms"], t["hybrid_bound_by"] = terms["hybrid"][:2]
    out = {"shape": [b, s, d, n], "hybrid_shape": [hb, hs, hd, hn],
           "max_abs_err": max(err.values()),
           "lanes_per_channel": cuda_build.query("selective_scan_lanes")(n),
           "bound_terms": {k: v[2] for k, v in terms.items()}, **t}
    log({"phase": "kernels.selective_scan", **out})
    return out


def _masked_update_block(Kn, block, gen, times) -> dict:
    """masked_update at a rank's block of the main plan, the dist path's
    shapes: [K/w, Vmax] against a [V] frontier and [K/w, Vmax,
    SERVE_LANES] against [V, SERVE_LANES], and at F = 3 (scalar rows) and
    F = 8 (the GNN programs' width) between them (min, some states +inf),
    each exact against the plain version, timed beside its bound; then at
    F = 1, 3 and 8 on an odd slot count with the state not 16-byte
    aligned, exact (the kernel's scalar forms)."""
    dev = block.device
    out = {}
    for label, tail in (("f1", ()), ("f3", (3,)), ("f8", (8,)),
                        ("lanes", (SERVE_LANES,))):
        shape = (block.k, block.v_max) + tail
        state = torch.rand(shape, generator=gen, device=dev) * 30
        state = torch.where(torch.rand(shape, generator=gen, device=dev)
                            < 0.2, float("inf"), state)
        glob = torch.rand((block.n_vertices,) + tail, generator=gen,
                          device=dev) * 30
        args = (state, glob, block.local2global, block.vmask,
                block.replicated, "min")
        got, want = Kn.masked_update(*args), Kn.masked_update_ref(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"masked_update at the block's {list(shape)} not exact")
        t = times(kernel=lambda: Kn.masked_update(*args),
                  plain=lambda: Kn.masked_update_ref(*args))
        t["bound_ms"], t["bound_by"] = _mu_bound(block, tail[0] if tail
                                                 else 1)
        out[label] = dict(t, shape=list(shape), max_abs_err=_max_abs(got,
                                                                     want))
    # where the vector forms do not apply: up to three partitions of an
    # odd number of slots (a ragged F = 1 tail), the state one float into
    # its buffer
    k, v = min(3, block.k), block.v_max - 1 - block.v_max % 2
    idx = (block.local2global[:k, :v].contiguous(),
           block.vmask[:k, :v].contiguous(),
           block.replicated[:k, :v].contiguous())
    for f in (1, 3, 8):
        tail = (f,) if f > 1 else ()
        buf = torch.rand(k * v * f + 1, generator=gen, device=dev) * 30
        state = buf[1:].view((k, v) + tail)
        glob = torch.rand((block.n_vertices,) + tail, generator=gen,
                          device=dev) * 30
        got = Kn.masked_update(state, glob, *idx, "min")
        torch.cuda.synchronize()
        require(torch.equal(got, Kn.masked_update_ref(state, glob, *idx,
                                                      "min")),
                f"masked_update at an unaligned [{k}, {v}] F={f} not exact")
    log({"phase": "kernels.masked_update.block", "world": DIST_BLOCK_WORLD,
         "ragged_unaligned_exact": [1, 3, 8], **out})
    return out


def phase_kernels(plan, launches, gnn_launches, g, owner, part, road_part,
                  etsch_launches, sssp_state, lm_launches, lm_inputs,
                  serve, stream, dist_launches, moe_dfep_launches,
                  hybrid):
    from repro_torch.engine import kernels as Kn
    from repro_torch.engine.plan import shard_plan

    serve_launches = serve["launches"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = plan.device
    rows = torch.arange(plan.k, device=dev)[:, None] * plan.v_max
    flat_tgt = (rows + plan.edge_tgt.long()).reshape(-1)

    def check_seg(p, msgs, combine):
        got = Kn.segment_reduce(p, msgs, combine)
        want = Kn.segment_reduce_ref(p, msgs, combine)
        torch.cuda.synchronize()
        require(torch.equal(torch.isinf(got), torch.isinf(want)),
                f"segment_reduce {combine}: infinities differ")
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
        rel = float(((got[fin] - want[fin]).abs()
                     / want[fin].abs().clamp(min=1e-30)).max()) \
            if fin.any() else 0.0
        if combine == "add":
            require(rel <= SEG_ADD_RTOL, f"segment_reduce add: max rel {rel}")
            again = Kn.segment_reduce(p, msgs, combine)
            require(torch.equal(again, got),
                    "segment_reduce add: two calls differ")
        else:
            require(torch.equal(got, want), f"segment_reduce {combine} is "
                    "not exact")
        return err, rel

    # messages at the main path's shape: SSSP-like, with unreached (+inf)
    # slots; non-negative finite values for add and max
    dist = torch.rand(plan.emask.shape, generator=gen, device=dev) * 30
    dist = torch.where(torch.rand(plan.emask.shape, generator=gen,
                                  device=dev) < 0.2, float("inf"), dist)
    finite = torch.where(torch.isinf(dist), 1.0, dist) / 30
    patched = _patched_like(plan, gen)
    errs, rels, layouts = {}, {}, {}
    for name, p in (("plan", plan), ("patched", patched)):
        for combine, msgs in (("min", dist), ("max", finite),
                              ("add", finite)):
            key = f"{name}.{combine}"
            errs[key], rels[key] = check_seg(p, msgs, combine)
        # the layout (built with the plan, or at the patched plan's first
        # call above), built again to time it
        lay, secs = wall(lambda: Kn.build_segment_layout(p))
        layouts[name] = dict(lay.stats(), build_s=secs)
    log({"phase": "kernels.segment_reduce.check", "max_abs_err": errs,
         "max_rel_err": rels, "add_repeat_identical": True,
         "layout": layouts,
         "append_live_slots": int((patched.emask & ~plan.emask).sum()),
         "arrived_vertices": int((patched.vmask & ~plan.vmask).sum())})

    # replica states at the main path's shape, some unreached (+inf)
    state = torch.rand((plan.k, plan.v_max), generator=gen, device=dev) * 30
    state = torch.where(torch.rand(state.shape, generator=gen, device=dev)
                        < 0.2, float("inf"), state)
    glob = torch.rand(plan.n_vertices, generator=gen, device=dev) * 30
    mu_args = (state, glob, plan.local2global, plan.vmask, plan.replicated)
    mu_err = 0.0
    for combine in ("min", "add"):
        got = Kn.masked_update(*mu_args, combine)
        want = Kn.masked_update_ref(*mu_args, combine)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"masked_update {combine} not exact")
        fin = torch.isfinite(want)
        mu_err = max(mu_err, float((got[fin] - want[fin]).abs().max()))
    # ... and at the GNN programs' [K, Vmax, 8] loop state against a [V, 8]
    # global plane (every gcn_layer / kge_score exchange), F-strided
    state8 = torch.rand((plan.k, plan.v_max, 8), generator=gen, device=dev)
    state8 = torch.where(torch.rand(state8.shape, generator=gen, device=dev)
                         < 0.2, float("inf"), state8 * 30)
    glob8 = torch.rand((plan.n_vertices, 8), generator=gen, device=dev) * 30
    mu8_args = (state8, glob8, plan.local2global, plan.vmask,
                plan.replicated)
    for combine in ("min", "add"):
        got = Kn.masked_update(*mu8_args, combine)
        want = Kn.masked_update_ref(*mu8_args, combine)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"masked_update {combine} at F=8 not exact")
        fin = torch.isfinite(want)
        mu_err = max(mu_err, float((got[fin] - want[fin]).abs().max()))
    log({"phase": "kernels.masked_update.check", "exact": True,
         "shapes": [list(state.shape), list(state8.shape)],
         "max_abs_err": mu_err})
    ex_err = _exchange_checks(Kn, _exchange_plans(g, owner, plan, patched),
                              gen)

    # timing at the main path's shapes
    masked = {c: torch.where(plan.emask, m, Kn._IDENTITY[c]).reshape(-1)
              for c, m in (("min", dist), ("add", finite))}
    ident = {c: torch.full((plan.k * plan.v_max,), Kn._IDENTITY[c],
                           device=dev) for c in masked}
    def times(iters: int = 20, check=None, **fns):
        """Device ms (CUDA graph) and eager ms (with host launch cost);
        ``check`` goes to the kernel's device_ms."""
        out = {f"{k}_ms": device_ms(f, iters=iters,
                                    check=check if k == "kernel" else None)
               for k, f in fns.items()}
        out.update({f"{k}_eager_ms": eager_ms(f) for k, f in fns.items()})
        return out

    seg_t = {}
    for c in ("min", "add"):
        m = dist if c == "min" else finite
        seg_t[c] = times(
            kernel=lambda: Kn.segment_reduce(plan, m, c),
            plain=lambda: Kn.segment_reduce_ref(plan, m, c),
            library=lambda: torch.scatter_reduce(
                ident[c], 0, flat_tgt, masked[c], Kn._SCATTER[c]))
    mu_t = times(kernel=lambda: Kn.masked_update(*mu_args, "min"),
                 plain=lambda: Kn.masked_update_ref(*mu_args, "min"))
    mu8_t = times(kernel=lambda: Kn.masked_update(*mu8_args, "add"),
                  plain=lambda: Kn.masked_update_ref(*mu8_args, "add"))
    mu8_t["bound_ms"], mu8_t["bound_by"] = _mu_bound(plan, 8)
    log({"phase": "kernels.timing", "segment_reduce": seg_t,
         "masked_update": mu_t, "masked_update_f8": mu8_t})
    mu_block = _masked_update_block(
        Kn, shard_plan(plan, 0, DIST_BLOCK_WORLD), gen, times)
    ex_t = _exchange_timing(Kn, plan, gen, times)
    lanes_t = _lane_timing(Kn, plan, gen, times)
    gs_err = _gspmm_checks(Kn, plan, patched, gen)
    gs_t = _gspmm_timing(Kn, plan, gen, times)
    lc = _lane_cumsum_section(g, owner, gen, times)
    fm = _frontier_min_section(part, gen, times)
    mp = _minplus_section(g, part, road_part, gen, times, sssp_state)
    ss = _selective_scan_section(lm_inputs, hybrid["scan_inputs"], gen,
                                 times)

    seg_bound, seg_by = _seg_bound(plan)
    mu_bound, mu_by = _mu_bound(plan)
    stream_launches = stream["launches"]

    def dist(name):
        """A kernel's launches on the dist path, summed over the ranks of
        each world."""
        return {str(w): n[name] for w, n in dist_launches.items()}

    stream_seg = [{k: row[k] for k in (
        "batch", "trickle", "patched", "segment_reduce_patched_ms",
        "segment_reduce_patched_bound_ms", "segment_reduce_recompiled_ms",
        "segment_reduce_recompiled_bound_ms", "e_max")}
        for row in stream["batches"]]
    return {"kernels": [
        {"name": "segment_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_reduce.cu",
         "replaces": "src/repro/engine/kernels.py:82",
         "launches": launches["segment_reduce"],
         "launches_gnn": gnn_launches["segment_reduce"],
         "max_abs_err": errs["plan.min"],
         "ms": seg_t["min"]["kernel_ms"],
         "plain_ms": seg_t["min"]["plain_ms"],
         "bound_ms": seg_bound, "bound_by": seg_by,
         "library_ms": seg_t["min"]["library_ms"],
         "combine": "min", "shape": [plan.k, plan.e_max],
         "add_ms": seg_t["add"]["kernel_ms"],
         "add_plain_ms": seg_t["add"]["plain_ms"],
         "add_library_ms": seg_t["add"]["library_ms"],
         "layout": layouts["plan"],
         "serve_launches": serve_launches["segment_reduce"],
         "dist_launches": dist("segment_reduce"),
         "lanes": lanes_t["segment_reduce"],
         "stream_launches": stream_launches["segment_reduce"],
         "stream": stream_seg},
        {"name": "exchange", "route": "cuda",
         "source": "src/repro_torch/csrc/replica_exchange.cu",
         "replaces": "src/repro/engine/kernels.py:394",
         "launches": launches["exchange"],
         "launches_gnn": gnn_launches["exchange"], "max_abs_err": ex_err,
         "ms": ex_t["f1_min"]["kernel_ms"],
         "plain_ms": ex_t["f1_min"]["plain_ms"],
         "bound_ms": ex_t["f1_min"]["bound_ms"],
         "bound_by": ex_t["f1_min"]["bound_by"],
         "library_ms": ex_t["f1_min"]["library_ms"],
         "library": "the parent's exchange chain: where, full, "
                    "scatter_reduce_, masked_update",
         "combine": "min", "shape": [plan.k, plan.v_max],
         **{label: {k: ex_t[label][k] for k in (
             "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "kernel_eager_ms", "library_eager_ms", "turns")}
            for label, _, _ in EXCHANGE_CASES},
         "layout": dict(Kn.exchange_layout(plan).stats()),
         "serve_launches": serve_launches["exchange"],
         "stream_launches": stream_launches["exchange"],
         "lanes": lanes_t["exchange"]},
        # the glob-form update that closes every sharded exchange, at a
        # rank's block (no single-device path launches it)
        {"name": "masked_update", "route": "cuda",
         "source": "src/repro_torch/csrc/masked_update.cu",
         "replaces": "src/repro/engine/kernels.py:394",
         "launches": sum(dist("masked_update").values()),
         "dist_launches": dist("masked_update"),
         "launches_main": launches["masked_update"],
         "launches_gnn": gnn_launches["masked_update"],
         "max_abs_err": max(mu_err, *(r["max_abs_err"]
                                      for r in mu_block.values())),
         "ms": mu_block["f1"]["kernel_ms"],
         "plain_ms": mu_block["f1"]["plain_ms"],
         "bound_ms": mu_block["f1"]["bound_ms"],
         "bound_by": mu_block["f1"]["bound_by"], "library_ms": None,
         "combine": "min", "shape": mu_block["f1"]["shape"],
         "lanes": {k: mu_block["lanes"][k] for k in (
             "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by")},
         "plan": {"shape": [plan.k, plan.v_max], "ms": mu_t["kernel_ms"],
                  "plain_ms": mu_t["plain_ms"], "bound_ms": mu_bound,
                  "bound_by": mu_by,
                  "f8": {k: mu8_t[k] for k in (
                      "kernel_ms", "plain_ms", "bound_ms", "bound_by")}}},
        {"name": "gspmm", "route": "cuda",
         "source": "src/repro_torch/csrc/gspmm.cu",
         "replaces": "src/repro/engine/kernels.py:233",
         "launches": gnn_launches["gspmm"],
         "serve_launches": serve_launches["gspmm"],
         "stream_launches": stream_launches["gspmm"],
         "max_abs_err": gs_err["plan.f8.scalar.add"],
         "ms": gs_t["f8"]["kernel_ms"], "plain_ms": gs_t["f8"]["plain_ms"],
         "bound_ms": gs_t["f8"]["bound_ms"],
         "bound_by": gs_t["f8"]["bound_by"],
         "library_ms": gs_t["f8"]["library_ms"],
         "combine": "add", "shape": [plan.k, plan.e_max, 8],
         "serve_lanes_launches": {
             name: row["launches_batched"]["gspmm"]
             for name, row in serve["gspmm_lanes"].items()},
         "lanes": {name: dict({k: gs_t[name][k] for k in (
             "kernel_ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=gs_t[name].get("library_ms"))
             for name in (f"lanes_f{GSPMM_LANE_WIDTH}",
                          f"lanes_feature_f{GSPMM_LANE_WIDTH}")},
         "empty_ms": float(np.median(gs_t["f8"]["empty_ms"])),
         "hub_run_ms": gs_t["f8"]["hub_run_ms"],
         **{name: dict({k: gs_t[name][k] for k in (
             "kernel_ms", "plain_ms", "bound_ms", "bound_by", "hub_run_ms")},
             library_ms=gs_t[name].get("library_ms"),
             empty_ms=float(np.median(gs_t[name]["empty_ms"])))
            for name in ("f128", "feature_f8")},
         "layout": gs_t["layout"]},
        {"name": "lane_cumsum", "route": "cuda",
         "source": "src/repro_torch/csrc/lane_cumsum.cu",
         "replaces": "src/repro/kernels/lane_cumsum.py:24",
         "launches": launches["lane_cumsum"], "max_abs_err": lc["max_abs_err"],
         "stream_launches": stream_launches["lane_cumsum"],
         "dist_launches": dist("lane_cumsum"),
         "moe_dfep_launches": moe_dfep_launches["lane_cumsum"],
         "reauction": [{k: r[k] for k in (
             "batch", "hops", "rounds", "ms_per_round", "lane_cumsum",
             "active_edges", "moved_edges", "patched")}
             for r in stream["reauction_rows"]],
         "ms": lc["kernel_ms"], "plain_ms": lc["plain_ms"],
         "bound_ms": lc["bound_ms"], "bound_by": lc["bound_by"],
         "library_ms": lc["library_ms"], "flat_scan_ms": lc["flat_scan_ms"],
         "shape": lc["shapes"]["slots"],
         "presence_ms": lc["presence_kernel_ms"]},
        {"name": "frontier_min", "route": "cuda",
         "source": "src/repro_torch/csrc/frontier_min.cu",
         "replaces": "src/repro/kernels/frontier_min.py:20",
         "launches": etsch_launches["frontier_min"],
         "dist_launches": dist("frontier_min"),
         "max_abs_err": fm["max_abs_err"],
         "ms": fm["kernel_ms"], "plain_ms": fm["plain_ms"],
         "bound_ms": fm["bound_ms"], "bound_by": fm["bound_by"],
         "library_ms": fm["library_ms"], "shape": fm["shape"],
         "multi_source": {key: fm["multi_source"][key] for key in (
             "shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by")}},
        {"name": "minplus_sweep", "route": "cuda",
         "source": "src/repro_torch/csrc/minplus_sweep.cu",
         "replaces": "src/repro/kernels/minplus_sweep.py:28",
         "launches": etsch_launches["minplus_sweep"],
         "launches_by_rows": etsch_launches["minplus_by_rows"],
         "dist_launches": dist("minplus_sweep"),
         "max_abs_err": mp["max_abs_err"],
         "ms": mp["etsch"]["kernel_ms"], "plain_ms": mp["etsch"]["plain_ms"],
         "bound_ms": mp["etsch"]["bound_ms"],
         "bound_by": mp["etsch"]["bound_by"],
         "library_ms": mp["etsch"]["library_ms"],
         "shape": [mp["etsch"]["rows"], mp["etsch"]["edge_slots"]],
         "fixpoint_ms": mp["etsch"]["fixpoint_kernel_ms"],
         **{name: {k: mp[name][k] for k in (
             "rows", "edge_slots", "kernel_ms", "bound_ms", "bound_by")}
            for name in ("graph", "multi_source", "usroads")}},
        {"name": "selective_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/selective_scan.cu",
         "replaces": "src/repro/kernels/selective_scan.py:28",
         "launches": lm_launches["selective_scan"],
         "launches_hybrid": hybrid["launches"]["selective_scan"],
         "max_abs_err": ss["max_abs_err"],
         "ms": ss["kernel_ms"], "plain_ms": ss["plain_ms"],
         "bound_ms": ss["bound_ms"], "bound_by": ss["bound_by"],
         "library_ms": None, "eager_ms": ss["kernel_eager_ms"],
         "shape": ss["shape"], "decode_ms": ss["decode_kernel_ms"],
         "decode_plain_ms": ss["decode_plain_ms"],
         "decode_bound_ms": ss["decode_bound_ms"],
         "decode_bound_by": ss["decode_bound_by"],
         "lanes_per_channel": ss["lanes_per_channel"],
         "hybrid": {"shape": ss["hybrid_shape"], "ms": ss["hybrid_ms"],
                    "bound_ms": ss["hybrid_bound_ms"],
                    "bound_by": ss["hybrid_bound_by"]},
         "bound_terms": ss["bound_terms"]},
    ]}


def phase_cpu_equal():
    from repro_torch.core import algorithms as A
    from repro_torch.core import dfep, etsch, graph, metrics
    from repro_torch import engine as E

    out, starts, ids = {}, None, None
    for dev in ("cuda", "cpu"):
        g = graph.load_dataset("dblp", scale=CPU_CHECK_SCALE, seed=SEED,
                               device=dev)
        if starts is None:   # the same start vertices on both devices
            starts = dfep.draw_starts(g.n_vertices, K, SEED)
        t0 = time.perf_counter()
        owner, info = dfep.partition(g, k=K, starts=starts, max_rounds=4000,
                                     stall_rounds=64, device=dev)
        plan = E.compile_plan(g, owner, K, device=dev)
        r = E.engine_sssp(E.Engine(plan), 0)
        if ids is None:      # the same CC ids on both devices
            ids = np.random.default_rng(SEED).permutation(g.n_vertices)
        part = etsch.compile_partitioning(g, owner, K, device=dev)
        es = A.etsch_sssp(part, 0)
        ec = A.etsch_cc(part, ids=ids)
        m = metrics.evaluate(g, owner, K, part=part)
        out[dev] = (owner.cpu(), info["rounds"], r.state.cpu(), r.row(),
                    time.perf_counter() - t0,
                    {"sssp": (es.state.cpu(), es.supersteps, es.local_iters),
                     "cc": (ec.state.cpu(), ec.supersteps, ec.local_iters)},
                    m.row())
    require(torch.equal(out["cuda"][0], out["cpu"][0]),
            "DFEP owner differs between card and CPU")
    require(out["cuda"][1] == out["cpu"][1], "DFEP rounds differ")
    require(torch.equal(out["cuda"][2], out["cpu"][2]), "SSSP differs")
    require(out["cuda"][3] == out["cpu"][3], "SSSP counters differ")
    for name in ("sssp", "cc"):
        (sa, *ca), (sb, *cb) = out["cuda"][5][name], out["cpu"][5][name]
        require(torch.equal(sa, sb), f"etsch_{name} differs")
        require(ca == cb, f"etsch_{name} counters differ: {ca} vs {cb}")
    require(out["cuda"][6] == out["cpu"][6], f"metrics differ: "
            f"{out['cuda'][6]} vs {out['cpu'][6]}")
    log({"phase": "cpu_equal", "scale": CPU_CHECK_SCALE, "rounds":
         out["cuda"][1], "sssp": out["cuda"][3],
         "etsch": {n: c[1:] for n, c in out["cuda"][5].items()},
         "metrics": out["cuda"][6], "wall_s_cuda": out["cuda"][4],
         "wall_s_cpu": out["cpu"][4]})


def _dist_cpu_rank(rank: int, world: int, rdzv: str, out_dir: str) -> None:
    """One rank of the cpu phase's sharded check (a process of its own):
    sharded DFEP and the sharded engine's SSSP, over one gloo group, on
    the card and on the CPU; raises unless both give the same owner,
    rounds, state and counters."""
    import torch.distributed as dist
    from repro_torch import engine as E
    from repro_torch.core import dfep, dfep_distributed, graph
    # the ranks share the host's cores for their CPU run
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    _join_group("gloo", rdzv, world, rank)
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            g = graph.load_dataset("dblp", scale=CPU_CHECK_SCALE, seed=SEED,
                                   device=dev)
            cfg = dfep.DfepConfig(k=K, max_rounds=4000, stall_rounds=64)
            t0 = time.perf_counter()
            owner, info = dfep_distributed.run_dfep_sharded(
                g, cfg, dfep.draw_starts(g.n_vertices, K, SEED), device=dev)
            plan = E.compile_plan(g, owner, K, device=dev)
            r = E.engine_sssp(E.Engine(plan, group=dist.group.WORLD), 0)
            out[dev] = (owner.cpu(), info, r.state.cpu(), r.row(),
                        time.perf_counter() - t0)
        (oa, ia, sa, ra, ta), (ob, ib, sb, rb, tb) = out["cuda"], out["cpu"]
        require(torch.equal(oa, ob),
                "sharded DFEP owner differs between card and CPU")
        require(ia == ib, f"sharded DFEP info differs: {ia} vs {ib}")
        require(torch.equal(sa, sb) and ra == rb,
                f"sharded SSSP differs between card and CPU: {ra} vs {rb}")
        Path(f"{out_dir}/cpu_{rank}.json").write_text(json.dumps(
            {"dfep": ia, "sssp": ra, "wall_s_cuda": ta, "wall_s_cpu": tb}))
    finally:
        dist.destroy_process_group()


def _dist_cpu_equal() -> None:
    """The cpu phase's world-2 check: two gloo ranks on card 0 and on the
    CPU give the same sharded DFEP and engine SSSP."""
    import tempfile
    import torch.multiprocessing as mp
    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        _, t = wall(lambda: mp.spawn(_dist_cpu_rank,
                                     args=(world, f"{tmp}/rdzv", tmp),
                                     nprocs=world))
        rows = [json.loads(Path(f"{tmp}/cpu_{r}.json").read_text())
                for r in range(world)]
    for r, row in enumerate(rows):
        log({"phase": "cpu_equal.dist", "scale": CPU_CHECK_SCALE,
             "world": world, "backend": "gloo", "rank": r, **row})
    log({"phase": "cpu_equal.dist", "world": world, "wall_s": t})


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

#: The train phase: qwen3-0.6b whole under the TUNED profile, TRAIN_STEPS
#: steps of TRAIN_BATCH × TRAIN_SEQ tokens from SyntheticPipeline (seed
#: SEED) with a checkpoint every TRAIN_CKPT_EVERY, then TRAIN_REPEAT_STEPS
#: steps on one repeated batch; falcon-mamba-7b at full width cut to
#: TRAIN_SSM_LAYERS of its 64 layers (2,217,345,024 parameters: 33.0 GiB
#: of float32 parameters, gradients and moments, where 64 layers would
#: need 7.3 B and 109 GiB), TRAIN_SSM_STEPS steps of TRAIN_SSM_BATCH ×
#: TRAIN_SSM_SEQ.
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "qwen3-0.6b", 10, 4, 1024
TRAIN_CKPT_EVERY, TRAIN_REPEAT_STEPS = 5, 5
TRAIN_SSM_ARCH, TRAIN_SSM_LAYERS = "falcon-mamba-7b", 16
TRAIN_SSM_STEPS, TRAIN_SSM_BATCH, TRAIN_SSM_SEQ = 3, 2, 512
#: selective_scan_bwd held and timed at [B, S, Di, N]: falcon-mamba's
#: width at the SSM training batch.
TRAIN_SCAN_SHAPE = (2, 512, 8192, 16)
#: selective_scan_bwd also held at ragged [B, S, Di, N], with dh_last or
#: None: S not a multiple of the 16-step chunk, chunk counts that are not a
#: multiple of the kernel's span of 64 / N chunks (one, three, 63 and 34
#: chunks over spans of 4, 8, 2 and 16), Di not a multiple of its
#: 8-channel group, and every N it takes.
SCAN_BWD_RAGGED = (((1, 1, 37, 16), True), ((2, 37, 133, 8), False),
                   ((1, 1000, 64, 32), False), ((3, 529, 99, 4), True))
#: flash_fa2 held against autograd through the plain flash scan at
#: [B, H, S, dh] over TRAIN_FLASH_KV kv heads (qwen3-0.6b's attention at
#: the training batch), causal, in key blocks of TRAIN_FLASH_BLOCK.
TRAIN_FLASH_SHAPE, TRAIN_FLASH_KV = (4, 16, 1024, 128), 8
TRAIN_FLASH_BLOCK = 256
#: Card against CPU: one train step in float32 compute of each arch cut
#: to its depth here, on [B, S] tokens.
TRAIN_CPU_LAYERS = (("falcon-mamba-7b", 1), ("qwen3-0.6b", 2))
TRAIN_CPU_TOKENS = (1, 64)
# Tolerances, each with its reason:
#  * the scan's backward kernel against its plain version (on the same
#    chunk states) and against autograd through the plain loop, each
#    gradient relative to its largest |value|: float32 on both sides; the
#    kernel's decay is ex2.approx (2 ulp); its carry into each chunk is a
#    reverse scan of the chunks' affine maps (products of a span's decays
#    in a tree, not one step at a time), its dB/dC sums run over a warp's
#    channels in registers, then the block's warps and the blocks'
#    atomics, dx and ddt over per-state-group partial sums and dA/dD over
#    lanes, warps and the batch, all in other orders than the plain
#    loop's.
SCAN_GRAD_REL = 1e-4
#  * flash_fa2's output and gradients against autograd through the plain
#    scan, float32 inputs, relative to each one's largest |value|: the same
#    sums in another order (the scores scaled after the product, not q
#    before; the probabilities recomputed from the log-sum-exp).
FLASH_GRAD_REL = 1e-4
#  * a float32-compute train step on the card against the CPU: the loss
#    relative; gradients relative to each leaf's largest |value| (cuBLAS
#    against the CPU's GEMMs, the scan's ex2 against exp); AdamW on the
#    card from the CPU's gradients against the CPU step, relative to each
#    leaf's largest |value| (the same elementwise float32 arithmetic).
TRAIN_CPU_LOSS_REL, TRAIN_CPU_REL = 1e-5, 1e-4


def _bad_grads(grads) -> list:
    """The paths of a gradient tree's leaves that are not finite or are all
    zero."""
    bad = []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif not bool(torch.isfinite(t).all()) or not bool((t != 0).any()):
            bad.append(path)
    walk(grads, "")
    return bad


def _trees_equal(a, b) -> bool:
    """Bit for bit equal trees of dicts and (named) tuples of tensors."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_trees_equal, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _rel_errs(got, want) -> dict:
    """max |got - want| / max |want| of each pair of leaves, by path (the
    trees nested dicts, tuples or tensors)."""
    out = {}

    def walk(g, w, path):
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, (tuple, list)):
            for i, (gi, wi) in enumerate(zip(g, w)):
                walk(gi, wi, f"{path}/{i}")
        else:
            g, w = g.detach().float().cpu(), w.detach().float().cpu()
            out[path] = float((g - w).abs().max()) / max(
                float(w.abs().max()), 1e-30)
    walk(got, want, "")
    return out


def _train_dense(tmp: str, dev: str = "cuda") -> dict:
    """qwen3-0.6b whole under TUNED through ``Trainer``: every leaf's
    gradient finite and non-zero on the first batch; TRAIN_STEPS steps
    with a checkpoint every TRAIN_CKPT_EVERY (warm median step, tokens/s,
    peak, losses); a Trainer restarted from a directory holding only step
    TRAIN_CKPT_EVERY's checkpoint restores the state the first one saved
    there bit for bit and reaches TRAIN_STEPS; one step and one AdamW
    update under torch.profiler; then TRAIN_REPEAT_STEPS steps on one
    batch must lower its loss."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.perf import BASELINE, TUNED, set_perf
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(TRAIN_ARCH)
    ocfg = O.AdamWConfig(warmup_steps=5, total_steps=TRAIN_STEPS)
    dcfg = DataConfig(TRAIN_BATCH, TRAIN_SEQ, SEED)

    def tcfg(d):
        return TrainerConfig(steps=TRAIN_STEPS, ckpt_dir=d,
                             ckpt_every=TRAIN_CKPT_EVERY,
                             log_every=TRAIN_CKPT_EVERY)

    set_perf(TUNED)
    try:
        tr = Trainer(cfg, ocfg, dcfg, tcfg(f"{tmp}/run"), device=dev)
        batch = tr.pipeline.batch_at(0)
        n_params = sum(t.numel() for t in O.tree_leaves(tr.params))
        _, _, grads = TS.value_and_grad(cfg, tr.params, batch)
        bad = _bad_grads(grads)
        del grads
        require(not bad, f"{TRAIN_ARCH}: gradients not finite or all zero: "
                f"{bad}")
        kept, save = {}, tr.ckpt.save

        def keep(step, tree, blocking=False):
            if step == TRAIN_CKPT_EVERY:    # the state that checkpoint holds
                kept["tree"] = tree
            save(step, tree, blocking)
        tr.ckpt.save = keep
        torch.cuda.reset_peak_memory_stats()
        res, run_s = wall(tr.run)
        peak = peak_mib()
        warm = float(np.median(res["step_s"][1:]))
        # a restart from a directory holding only the mid-run checkpoint
        step_dir = f"step-{TRAIN_CKPT_EVERY:09d}"
        shutil.copytree(f"{tmp}/run/{step_dir}", f"{tmp}/resume/{step_dir}",
                        copy_function=os.link)
        del tr
        tr2 = Trainer(cfg, ocfg, dcfg, tcfg(f"{tmp}/resume"), device=dev)
        restored = tr2.step == TRAIN_CKPT_EVERY and _trees_equal(
            {"params": tr2.params, "opt": tr2.opt_state}, kept.pop("tree"))
        require(restored, f"a Trainer restarted at step {TRAIN_CKPT_EVERY} "
                "did not restore the saved state bit for bit")
        res2 = tr2.run()
        require(tr2.step == TRAIN_STEPS and bool(np.isfinite(
            res2["losses"]).all()), "the restarted Trainer did not reach "
            f"step {TRAIN_STEPS} with finite losses")
        params, opt = tr2.params, tr2.opt_state
        del tr2
        prof = _device_profile(lambda: TS.train_step(cfg, ocfg, params, opt,
                                                     batch))
        _, _, grads = TS.value_and_grad(cfg, params, batch)
        adamw = _device_profile(lambda: O.apply_updates(ocfg, params, grads,
                                                        opt))
        del grads
        rcfg = O.AdamWConfig(warmup_steps=1, total_steps=TRAIN_REPEAT_STEPS)
        opt = O.init_opt_state(params)
        with torch.no_grad():
            before = float(TS.lm_loss(cfg, params, batch)[1]["loss"])
        for _ in range(TRAIN_REPEAT_STEPS):
            params, opt, _ = TS.train_step(cfg, rcfg, params, opt, batch)
        with torch.no_grad():
            after = float(TS.lm_loss(cfg, params, batch)[1]["loss"])
        del params, opt
        require(after < before, f"{TRAIN_REPEAT_STEPS} steps on one batch "
                f"did not lower its loss: {before} -> {after}")
    finally:
        set_perf(BASELINE)
    out = {"arch": cfg.name, "params": n_params, "perf": "TUNED",
           "steps": TRAIN_STEPS, "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "run_s": run_s, "step_s": res["step_s"],
           "warm_median_step_s": warm,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / warm,
           "peak_mib": peak, "first_loss": res["losses"][0],
           "last_loss": res["losses"][-1], "losses": res["losses"],
           "grad_norm": res["final_metrics"]["grad_norm"],
           "resumed_at": TRAIN_CKPT_EVERY, "restored_bit_for_bit": restored,
           "resumed_losses": res2["losses"],
           "step_profile": prof, "adamw_profile": adamw,
           "cast_share": prof["copy__ms"] / prof["device_ms"],
           "adamw_share": adamw["device_ms"] / prof["device_ms"],
           "repeat_batch_loss": [before, after]}
    log({"phase": "train.dense", **out})
    return out


def _train_flash(dev: str = "cuda") -> dict:
    """flash_fa2 against autograd through the plain flash scan (BASELINE)
    at TRAIN_FLASH_SHAPE, float32 inputs: the output and dq, dk, dv each
    within FLASH_GRAD_REL of its largest |value|; forward plus backward
    timed for both."""
    from repro_torch.models import layers as L
    from repro_torch.models.flash_vjp import flash_fa2

    b, h, s, d = TRAIN_FLASH_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((b, h, s, d), generator=gen, device=dev)
    k, v = (torch.randn((b, TRAIN_FLASH_KV, s, d), generator=gen,
                        device=dev) for _ in range(2))
    dout = torch.randn((b, h, s, d), generator=gen, device=dev)

    def run(fn):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = fn(qq, kk, vv)
        return {"out": out.detach(), **dict(zip(
            ("dq", "dk", "dv"), torch.autograd.grad(out, (qq, kk, vv),
                                                    dout)))}

    def fa2(*a):
        return flash_fa2(*a, True, TRAIN_FLASH_BLOCK)

    def plain(*a):
        return L.flash_attention(*a, causal=True, block=TRAIN_FLASH_BLOCK)

    rel = _rel_errs(run(fa2), run(plain))
    out = {"shape": list(TRAIN_FLASH_SHAPE), "kv_heads": TRAIN_FLASH_KV,
           "block": TRAIN_FLASH_BLOCK, "rel_err": rel,
           "fa2_fwd_bwd_ms": slow_ms(lambda: run(fa2), iters=5),
           "plain_fwd_bwd_ms": slow_ms(lambda: run(plain), iters=5)}
    log({"phase": "train.flash", **out})
    require(all(e <= FLASH_GRAD_REL for e in rel.values()),
            f"flash_fa2 against autograd through the plain scan: {rel}")
    return out


def _scan_bwd_bound(b: int, s: int, d: int, n: int):
    """selective_scan_bwd's bound in ms, as ``(ms, by, terms)``: the bytes
    and float32 operations of ``ops.selective_scan_bwd_work`` (x, dt, B,
    C, dy, A, D, the chunk states and dh_last read once, the seven
    gradients written once; the recompute's and the walk's operations),
    against the recompute's B·S·Di·N exps at EX2_PER_CLOCK_PER_SM on every
    SM at the maximum SM clock. The larger of flops and exps is the
    operations term."""
    from repro_torch.kernels import ops
    flops, nbytes = ops.selective_scan_bwd_work(b, s, d, n)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    elems = b * s * d * n
    terms = {"bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
             "flops_ms": 1e3 * flops / FP32_FLOPS,
             "exps_ms": 1e3 * elems / (EX2_PER_CLOCK_PER_SM * sms
                                       * _sm_clock_hz()),
             "bytes": nbytes, "exps": elems}
    ops_ms = max(terms["flops_ms"], terms["exps_ms"])
    if terms["bytes_ms"] >= ops_ms:
        return terms["bytes_ms"], "bytes", terms
    return ops_ms, "operations", terms


def _scan_bwd_section(dev: str = "cuda") -> dict:
    """The scan's forward with chunk states and ``selective_scan_bwd`` at
    TRAIN_SCAN_SHAPE with a random h0 and dh_last (the JAX kernel tests'
    distributions): the kernel's y, h_last and chunk states against
    ``selective_scan_fwd_ref`` within SCAN_REL; the backward kernel
    against ``selective_scan_bwd_ref`` on the plain chunk states, there
    and at SCAN_BWD_RAGGED, and autograd through ``ops.selective_scan``
    (both kernels) against autograd through ``selective_scan_ref``, each
    of the seven gradients within SCAN_GRAD_REL of its largest |value|;
    timed beside its bound, the plain backward, and the forward with and
    without the states."""
    from repro_torch.kernels import ops, ref

    b, s, d, n = TRAIN_SCAN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x, bb, cc = randn(b, s, d), randn(b, s, n, scale=0.5), \
        randn(b, s, n, scale=0.5)
    dt = torch.nn.functional.softplus(randn(b, s, d))
    a = torch.exp(randn(d, n, scale=0.3))
    dsk, h0 = randn(d), randn(b, d, n)
    dy, dhl = randn(b, s, d), randn(b, d, n)
    ins = (x, dt, bb, cc, a, dsk, h0)
    names = ("dx", "ddt", "db", "dc", "da", "dd", "dh0")

    got_f = ops._scan_forward(*ins, True)
    want_f = ref.selective_scan_fwd_ref(*ins, ops.SCAN_CHUNK)
    torch.cuda.synchronize()
    fwd_rel = _rel_errs(dict(zip(("y", "h_last", "hc"), got_f)),
                        dict(zip(("y", "h_last", "hc"), want_f)))
    hc = want_f[2]
    got = ops.selective_scan_bwd(*ins[:6], hc, dy, dhl)
    want = ref.selective_scan_bwd_ref(*ins[:6], hc, dy, dhl, ops.SCAN_CHUNK)
    torch.cuda.synchronize()
    plain_rel = _rel_errs(dict(zip(names, got)), dict(zip(names, want)))
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))

    def grads(fn):
        live = [t.clone().requires_grad_(True) for t in ins]
        y, h_last = fn(*live)
        return dict(zip(names, torch.autograd.grad(
            (y * dy).sum() + (h_last * dhl).sum(), live)))

    auto_rel = _rel_errs(grads(ops.selective_scan),
                         grads(ref.selective_scan_ref))
    ragged = {}
    for (rb, rs, rd, rn), with_dhl in SCAN_BWD_RAGGED:
        r_ins = (randn(rb, rs, rd), torch.nn.functional.softplus(
            randn(rb, rs, rd)), randn(rb, rs, rn, scale=0.5),
            randn(rb, rs, rn, scale=0.5), torch.exp(randn(rd, rn,
                                                          scale=0.3)),
            randn(rd), randn(rb, rd, rn))
        r_dy, r_dhl = randn(rb, rs, rd), \
            randn(rb, rd, rn) if with_dhl else None
        r_hc = ref.selective_scan_fwd_ref(*r_ins, ops.SCAN_CHUNK)[2]
        r_got = ops.selective_scan_bwd(*r_ins[:6], r_hc, r_dy, r_dhl)
        r_want = ref.selective_scan_bwd_ref(*r_ins[:6], r_hc, r_dy, r_dhl,
                                            ops.SCAN_CHUNK)
        torch.cuda.synchronize()
        ragged[f"{rb}x{rs}x{rd}x{rn}" + ("" if with_dhl else "_no_dh")] = \
            _rel_errs(dict(zip(names, r_got)), dict(zip(names, r_want)))
        max_abs = max(max_abs, *(float((g - w).abs().max())
                                 for g, w in zip(r_got, r_want)))
    log({"phase": "kernels.selective_scan_bwd.check", "shape":
         list(TRAIN_SCAN_SHAPE), "forward_rel": fwd_rel,
         "vs_plain_rel": plain_rel, "vs_autograd_rel": auto_rel,
         "ragged_vs_plain_rel": ragged})
    require(all(e <= SCAN_REL for e in fwd_rel.values()),
            f"selective_scan with chunk states against the plain loop: "
            f"{fwd_rel}")
    require(all(e <= SCAN_GRAD_REL for e in plain_rel.values()),
            f"selective_scan_bwd against its plain version: {plain_rel}")
    require(all(e <= SCAN_GRAD_REL for e in auto_rel.values()),
            f"autograd through selective_scan against the plain loop's: "
            f"{auto_rel}")
    require(all(e <= SCAN_GRAD_REL for r in ragged.values()
                for e in r.values()),
            f"selective_scan_bwd against its plain version at ragged "
            f"shapes: {ragged}")
    bound, by, terms = _scan_bwd_bound(b, s, d, n)
    out = {"shape": list(TRAIN_SCAN_SHAPE), "max_abs_err": max_abs,
           "kernel_ms": device_ms(lambda: ops.selective_scan_bwd(
               *ins[:6], hc, dy, dhl)),
           "plain_ms": slow_ms(lambda: ref.selective_scan_bwd_ref(
               *ins[:6], hc, dy, dhl, ops.SCAN_CHUNK)),
           "forward_states_ms": device_ms(lambda: ops._scan_forward(
               *ins, True)),
           "forward_ms": device_ms(lambda: ops._scan_forward(*ins, False)),
           "bound_ms": bound, "bound_by": by, "bound_terms": terms}
    log({"phase": "kernels.selective_scan_bwd", **out})
    return out


def _train_ssm(dev: str = "cuda") -> dict:
    """falcon-mamba-7b at full width cut to TRAIN_SSM_LAYERS: every leaf's
    gradient finite and non-zero on the first batch (the SSM layers' only
    through the scan's backward kernel); TRAIN_SSM_STEPS train steps with
    the launch counters zeroed just before and read just after (the scan
    and its backward must have run, the backward once a layer a step);
    then the scan's kernels held and timed (``_scan_bwd_section``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(get_config(TRAIN_SSM_ARCH),
                              n_layers=TRAIN_SSM_LAYERS)
    params = lm.init_params(cfg, torch.Generator(device=dev)
                            .manual_seed(SEED), dev)
    n_params = sum(t.numel() for t in O.tree_leaves(params))
    pipe = SyntheticPipeline(cfg, DataConfig(TRAIN_SSM_BATCH, TRAIN_SSM_SEQ,
                                             SEED), dev)
    _, _, grads = TS.value_and_grad(cfg, params, pipe.batch_at(0))
    bad = _bad_grads(grads)
    del grads
    require(not bad, f"{cfg.name} at {TRAIN_SSM_LAYERS} layers: gradients "
            f"not finite or all zero: {bad}")
    ocfg = O.AdamWConfig(warmup_steps=1, total_steps=TRAIN_SSM_STEPS)
    opt = O.init_opt_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    ops.reset_launches()
    for step in range(TRAIN_SSM_STEPS):
        (params, opt, m), t = wall(lambda: TS.train_step(
            cfg, ocfg, params, opt, pipe.batch_at(step)))
        step_s.append(t)
        losses.append(float(m["loss"]))
    launches = dict(ops.LAUNCHES)
    peak = peak_mib()
    del params, opt
    torch.cuda.empty_cache()
    require(launches["selective_scan_bwd"] == TRAIN_SSM_LAYERS
            * TRAIN_SSM_STEPS and launches["selective_scan"] > 0,
            f"the SSM train steps launched {launches}")
    require(bool(np.isfinite(losses).all()), f"SSM losses {losses}")
    out = {"arch": cfg.name, "layers": TRAIN_SSM_LAYERS, "params": n_params,
           "batch": [TRAIN_SSM_BATCH, TRAIN_SSM_SEQ], "step_s": step_s,
           "warm_median_step_s": float(np.median(step_s[1:])),
           "tokens_per_s": TRAIN_SSM_BATCH * TRAIN_SSM_SEQ
           / float(np.median(step_s[1:])), "losses": losses,
           "peak_mib": peak, "launches": launches,
           "selective_scan_bwd_per_step": launches["selective_scan_bwd"]
           / TRAIN_SSM_STEPS}
    log({"phase": "train.ssm", **out})
    out["scan_bwd"] = _scan_bwd_section(dev)
    return out


def _train_cpu_equal(arch: str, n_layers: int, dev: str = "cuda") -> dict:
    """One ``train_step`` of ``arch`` at full width cut to ``n_layers``, in
    float32 compute, on TRAIN_CPU_TOKENS tokens from SyntheticPipeline,
    with the same parameters on the card and on the CPU: the loss within
    TRAIN_CPU_LOSS_REL and the gradients (``value_and_grad``) within
    TRAIN_CPU_REL of each leaf's largest |value|; the card's
    ``apply_updates`` on the CPU's gradients within TRAIN_CPU_REL of the
    CPU step's parameters. The two steps' parameters are compared too and
    logged: AdamW's first step is m̂ / (√v̂ + eps), so where a gradient
    element is of the order of eps (1e-8) its last bits move the update,
    and a leaf that starts at zero holds nothing but that update."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import lm
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    card = lm.params_from_reference(cfg, lm.params_to_numpy(cpu), dev)
    batch = SyntheticPipeline(cfg, DataConfig(*TRAIN_CPU_TOKENS, SEED),
                              "cpu").batch_at(0)
    ocfg = O.AdamWConfig()
    res = {}
    with _compute_dtype(torch.float32):
        for side, where, p in (("card", dev, card), ("cpu", "cpu", cpu)):
            bt = {k: t.to(where) for k, t in batch.items()}
            t0 = time.perf_counter()
            new_p, _, m = TS.train_step(cfg, ocfg, p, O.init_opt_state(p), bt)
            _, _, grads = TS.value_and_grad(cfg, p, bt)
            torch.cuda.synchronize()
            res[side] = (float(m["loss"]), grads, new_p,
                         time.perf_counter() - t0)
    (l_card, g_card, p_card, t_card), (l_cpu, g_cpu, p_cpu, t_cpu) = \
        res["card"], res["cpu"]
    on_cpu_grads = O.apply_updates(
        ocfg, card, O.tree_map(lambda g: g.to(dev), g_cpu),
        O.init_opt_state(card))[0]
    g_rel, u_rel = _rel_errs(g_card, g_cpu), _rel_errs(on_cpu_grads, p_cpu)
    p_rel = _rel_errs(p_card, p_cpu)
    out = {"arch": cfg.name, "layers": n_layers,
           "tokens": list(TRAIN_CPU_TOKENS), "loss_card": l_card,
           "loss_cpu": l_cpu, "loss_rel": abs(l_card - l_cpu) / abs(l_cpu),
           "grad_rel_max": max(g_rel.values()),
           "grad_rel_worst": max(g_rel, key=g_rel.get),
           "update_rel_max": max(u_rel.values()),
           "update_rel_worst": max(u_rel, key=u_rel.get),
           "step_param_rel": {k: v for k, v in p_rel.items()
                              if v > TRAIN_CPU_REL},
           "step_param_rel_max_elsewhere": max(
               [v for v in p_rel.values() if v <= TRAIN_CPU_REL],
               default=0.0),
           "wall_s_cuda": t_card, "wall_s_cpu": t_cpu}
    log({"phase": "train.cpu_equal", **out})
    require(out["loss_rel"] <= TRAIN_CPU_LOSS_REL,
            f"{arch}: train-step loss card {l_card} vs CPU {l_cpu}")
    require(out["grad_rel_max"] <= TRAIN_CPU_REL,
            f"{arch}: gradients card vs CPU: {g_rel}")
    require(out["update_rel_max"] <= TRAIN_CPU_REL,
            f"{arch}: AdamW on the card vs the CPU step: {u_rel}")
    return out


def phase_train(dev: str = "cuda") -> dict:
    """The training path (phase 18): ``_train_dense``, ``_train_flash``,
    ``_train_ssm`` (with the scan's backward kernel) and
    ``_train_cpu_equal`` for each of TRAIN_CPU_LAYERS. Returns the
    selective_scan_bwd row of the kernels line and the SSM path's
    selective_scan launches."""
    import tempfile
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        _, t_dense = wall(lambda: _train_dense(tmp, dev))
    torch.cuda.empty_cache()
    _, t_flash = wall(lambda: _train_flash(dev))
    ssm, t_ssm = wall(lambda: _train_ssm(dev))
    torch.cuda.empty_cache()
    _, t_cpu = wall(lambda: [_train_cpu_equal(arch, n, dev)
                             for arch, n in TRAIN_CPU_LAYERS])
    log({"phase": "train", "wall_s": {"dense": t_dense, "flash": t_flash,
                                      "ssm": t_ssm, "cpu_equal": t_cpu}})
    sb = ssm["scan_bwd"]
    row = {"name": "selective_scan_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/selective_scan_bwd.cu",
           "replaces": "src/repro/models/ssm.py:82",
           "replaces_note": "no TPU kernel: the reference differentiates "
           "_selective_scan_chunked with JAX; its Pallas scan is "
           "forward-only",
           "launches": ssm["launches"]["selective_scan_bwd"],
           "launches_per_step": ssm["selective_scan_bwd_per_step"],
           "max_abs_err": sb["max_abs_err"], "ms": sb["kernel_ms"],
           "plain_ms": sb["plain_ms"], "bound_ms": sb["bound_ms"],
           "bound_by": sb["bound_by"], "library_ms": None,
           "shape": sb["shape"], "forward_states_ms":
           sb["forward_states_ms"], "forward_ms": sb["forward_ms"]}
    return {"row": row,
            "selective_scan_launches": ssm["launches"]["selective_scan"]}


#: (a): the four cells of tests/test_dryrun_small.py on the 16×16 mesh,
#: then qwen3-0.6b × train_4k on 2×16×16 (the flag is ``multi_pod``).
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", False),
                ("qwen2-moe-a2.7b", "decode_32k", False),
                ("whisper-small", "decode_32k", False),
                ("falcon-mamba-7b", "long_500k", False),
                ("qwen3-0.6b", "train_4k", True))
#: (b): (arch, layers or None for all, TUNED?, kind, batch, sequence).
DRYRUN_CARD_CELLS = (
    (TRAIN_ARCH, None, True, "train", TRAIN_BATCH, TRAIN_SEQ),
    (TRAIN_SSM_ARCH, TRAIN_SSM_LAYERS, False, "train", TRAIN_SSM_BATCH,
     TRAIN_SSM_SEQ),
    (LM_DENSE_ARCH, None, False, "decode", LM_BATCH, LM_PROMPT))
DRYRUN_WARM = 3


def _tensor_bytes(tree, counter=None) -> int:
    """The bytes of the tensors of a tree of dicts and tuples; with a
    ``roofline.count.Counter``, of those the counted step read."""
    from torch.utils._pytree import tree_flatten
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor)
               and (counter is None or counter.reads(t)))


def _dryrun_real_inputs(cfg, shape, dev: str) -> tuple[dict, int | None]:
    """Real inputs of ``launch.dryrun.run_step`` for ``shape`` on ``dev``
    (seeded random weights): for a train step the parameters, zero AdamW
    state and ``SyntheticPipeline``'s first batch; for a decode step the
    parameters, the prompt's greedy next token and the caches of a real
    prefill of the prompt grown to ``shape.seq_len``, with the position
    after the prompt. Returns (inputs, decode position or None)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import lm
    from repro_torch.serve import serve_step
    from repro_torch.train import optimizer as O
    params = lm.init_params(cfg, torch.Generator(device=dev)
                            .manual_seed(SEED), dev)
    if shape.kind == "train":
        batch = SyntheticPipeline(cfg, DataConfig(
            shape.global_batch, shape.seq_len, SEED), dev).batch_at(0)
        return {"params": params, "opt": O.init_opt_state(params),
                "batch": batch}, None
    prompt = SyntheticPipeline(cfg, DataConfig(
        shape.global_batch, LM_PROMPT, SEED), dev).batch_at(0)["tokens"]
    with torch.inference_mode():
        logits, caches = serve_step.prefill(cfg, params, prompt)
        caches = serve_step.grow_caches(cfg, caches, shape.global_batch,
                                        shape.seq_len)
        token = serve_step.greedy_token(logits[:, -1:, :], cfg.vocab)
    del logits
    return {"params": params, "token": token, "caches": caches}, LM_PROMPT


def _dryrun_card_cell(arch, layers, tuned, kind, batch, seq,
                      dev: str = "cuda") -> dict:
    """One 1×1 cell: the dry run's record on ``meta``, then the same step
    once on the card under a ``Counter("cuda")`` and DRYRUN_WARM times
    without; the equalities of phase 19 (b) required."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as DR
    from repro_torch.models.perf import BASELINE, TUNED, set_perf
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    # decode: one token against caches of the prompt and 16 new tokens
    shape = ShapeConfig(f"{kind}_{batch}x{seq}",
                        seq + LM_NEW if kind == "decode" else seq, batch,
                        kind)
    rec = DR.run_cell(arch, shape.name, perf=tuned, cfg=cfg, shape=shape,
                      mesh=MESH.make_mesh((1, 1), ("data", "model")))
    require(rec["status"] == "ok", f"dryrun {arch} {shape}: {rec}")
    raw = rec["roofline"]["raw_cost_analysis"]
    dry_launches = {k: v["launches"] for k, v in raw["kernels"].items()}

    set_perf(TUNED if tuned else BASELINE)
    try:
        torch.cuda.empty_cache()
        inputs, cache_len = _dryrun_real_inputs(cfg, shape, dev)
        real_args = {k: _tensor_bytes(v) for k, v in inputs.items()}
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        counter, out, _ = DR.count_step(cfg, shape, inputs, dev,
                                        cache_len)
        torch.cuda.synchronize()
        temp = torch.cuda.max_memory_allocated() - before
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        counts = counter.counts
        read_args = {k: _tensor_bytes(v, counter) for k, v in inputs.items()}
        del out
        warm = []
        for _ in range(DRYRUN_WARM):
            out, t = wall(lambda: DR.run_step(cfg, shape, inputs, cache_len))
            del out
            warm.append(t)
    finally:
        set_perf(BASELINE)
    del inputs
    torch.cuda.empty_cache()
    dry_args = {k: v for k, v in rec["argument_bytes"].items()
                if k != "cache_len"}
    roof = rec["roofline"]
    out = {"arch": arch, "layers": cfg.n_layers, "perf":
           "TUNED" if tuned else "BASELINE", "shape": dataclasses.asdict(
               shape), "count_s": rec["count_s"],
           "flops": raw["flops"], "bytes": raw["bytes"],
           "card_flops": counts.flops, "card_bytes": counts.bytes,
           "ops": raw["ops"], "card_ops": counts.ops,
           "card_other_device_ops": counts.other_device_ops,
           "launches_dry": dry_launches, "launches_card": counts.launches(),
           "launches_ops": launches, "argument_bytes_dry": dry_args,
           "argument_bytes_card": real_args,
           "argument_bytes_card_read": read_args,
           "cache_len_bytes_dry": rec["argument_bytes"].get("cache_len"),
           "roofline_s": max(roof["compute_s"], roof["memory_s"],
                             roof["collective_s"]),
           "compute_s": roof["compute_s"], "memory_s": roof["memory_s"],
           "dominant": roof["dominant"], "warm_step_s": warm,
           "warm_median_step_s": float(np.median(warm)),
           "temp_bytes_dry": rec["memory_analysis"]["temp_size_in_bytes"],
           "temp_bytes_card": temp, "card_peak_live_bytes":
           counts.peak_live_bytes}
    log({"phase": "dryrun.card", **out})
    require(dry_args == real_args,
            f"{arch}: dry-run argument bytes {dry_args} against the card "
            f"step's {real_args}")
    require((raw["flops"], raw["bytes"]) == (counts.flops, counts.bytes),
            f"{arch}: dry-run FLOPs/bytes {raw['flops']}/{raw['bytes']} "
            f"against the card count's {counts.flops}/{counts.bytes}")
    require(dry_launches == counts.launches() == launches,
            f"{arch}: launches priced {dry_launches}, counted on the card "
            f"{counts.launches()}, made {launches}")
    return out


def phase_dryrun() -> dict:
    """The launch tooling (phase 19): ``run_cell`` on DRYRUN_CELLS, then
    ``_dryrun_card_cell`` for each of DRYRUN_CARD_CELLS."""
    from repro_torch.launch import dryrun as DR
    for arch, shape, multi_pod in DRYRUN_CELLS:
        rec = DR.run_cell(arch, shape, multi_pod)
        ro = rec.get("roofline", {})
        log({"phase": "dryrun.cell", "arch": arch, "shape": shape,
             "mesh": rec.get("mesh"), "status": rec["status"],
             "count_s": rec.get("count_s"),
             "memory_analysis": rec.get("memory_analysis"),
             **{k: ro.get(k) for k in ("compute_s", "memory_s",
                                       "collective_s", "dominant",
                                       "useful_ratio", "flops",
                                       "bytes_hbm", "coll_bytes")}})
        require(rec["status"] in ("ok", "skipped"),
                f"dryrun {arch} {shape}: {rec}")
    cells = [_dryrun_card_cell(*c) for c in DRYRUN_CARD_CELLS]
    return {"cells": cells}


#: The shard phase: sharded execution over torch.distributed, every rank a
#: process on card 0 (NCCL refuses two ranks on one card, so world 2 runs
#: over gloo with CUDA tensors). qwen3-0.6b whole under TUNED at the train
#: phase's TRAIN_BATCH x TRAIN_SEQ: world 1 over NCCL at 1 x 1 (one-device
#: steps first, in the same rank), then world 2 over gloo at each of
#: SHARD_MESHES, SHARD_STEPS steps each; qwen2-moe-a2.7b whole served at
#: SHARD_MOE_MESH; falcon-mamba-7b at full width cut to SHARD_SSM_LAYERS,
#: one train step at SHARD_MOE_MESH's shape.
SHARD_MESHES = ((2, 1), (1, 2))
SHARD_STEPS = 3
SHARD_MOE_MESH = (1, 2)
SHARD_DECODE_STEPS = 8
SHARD_SSM_LAYERS = 8
#: tests/test_torch_train_families.py's bounds: the loss relative LOSS_REL
#: (bfloat16 logits, float32 sums in another order) and grad_norm GRAD_REL.
SHARD_LOSS_REL, SHARD_GRAD_REL = 1e-4, 3e-2
#: The served MoE at SHARD_MOE_MESH with the one-device experts replayed,
#: against the one-device prefill: bf16_rel counts one output a layer
#: that may round the other way; at tp = 2 a layer's two bfloat16 regions
#: (attention and the shared expert) each round both ranks' parts and
#: then their sum, so two a layer: bf16_rel(2 x 24 layers).
SHARD_MOE_REL = bf16_rel(2 * 24)


def _rule_bytes(cfg, dims, kind: str, batch: int, seq: int) -> dict:
    """``roofline.analysis.collective_bytes`` of one step of ``kind`` on the
    (data, model) mesh ``dims``: the dry run's rule at these shapes."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import input_specs
    from repro_torch.roofline.analysis import collective_bytes
    from repro_torch.sharding.env import Mesh, use_mesh
    mesh = Mesh(tuple(dims), ("data", "model"))
    shape = ShapeConfig("shard", seq, batch, kind)
    with use_mesh(mesh):
        spec = input_specs(cfg.name, "shard", cfg=cfg, shape=shape)
        return collective_bytes(cfg, shape, mesh, spec["params"])


def _timed_collectives(fn):
    """(fn's result, seconds, {kind: bytes}, {kind: device ms}): ``fn`` run
    with the collectives' byte counter zeroed and CUDA events around each
    collective (``collectives.record_events``)."""
    from repro_torch.core import collectives as C
    C.reset_bytes()
    events: list = []
    with C.record_events(events):
        out, t = wall(fn)
    ms = dict.fromkeys(C.KINDS, 0.0)
    for kind, start, end in events:
        ms[kind] += start.elapsed_time(end)
    return out, t, dict(C.BYTES), ms


def _shard_dense(rank: int, task: dict) -> dict:
    """qwen3-0.6b: one-device steps first where ``task`` asks (world 1),
    then SHARD_STEPS steps at each live mesh of ``task``, every rank
    drawing the same weights from the seeded generator and keeping its
    shard; loss and grad_norm per step, warm step s, peak MiB, each kind's
    bytes and device ms against the dry run's rule."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import lm
    from repro_torch.models.perf import BASELINE, TUNED, set_perf
    from repro_torch.sharding.env import Mesh, use_mesh
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    dev = task["dev"]
    cfg = get_config(task["arch"], smoke=task["smoke"])
    ocfg = O.AdamWConfig(warmup_steps=5, total_steps=TRAIN_STEPS)
    pipe = SyntheticPipeline(cfg, DataConfig(task["batch"], task["seq"],
                                             SEED), dev)
    out = {}

    def steps(params):
        opt = O.init_opt_state(params)
        rows = []
        for step in range(task["steps"]):
            (params, opt, m), t, nbytes, ms = _timed_collectives(
                lambda: TS.train_step(cfg, ocfg, params, opt,
                                      pipe.batch_at(step)))
            rows.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]), "step_s": t,
                         "bytes": nbytes, "collective_ms": ms})
        return rows

    set_perf(TUNED)
    try:
        if task["one_device"]:
            torch.cuda.reset_peak_memory_stats()
            params = lm.init_params(cfg, torch.Generator(device=dev)
                                    .manual_seed(SEED), dev)
            out["one_device"] = {"steps": steps(params),
                                 "peak_mib": peak_mib()}
            del params
            torch.cuda.empty_cache()
        for dims in task["meshes"]:
            mesh = Mesh(tuple(dims), ("data", "model"))
            with use_mesh(mesh, mesh.connect("cuda")):
                torch.cuda.reset_peak_memory_stats()
                params = lm.init_params(cfg, torch.Generator(device=dev)
                                        .manual_seed(SEED), dev)
                rows = steps(params)
                del params
            torch.cuda.empty_cache()
            out["x".join(map(str, dims))] = {
                "steps": rows, "peak_mib": peak_mib(),
                "warm_step_s": float(np.median([r["step_s"]
                                                for r in rows[1:]])),
                "rule_bytes": _rule_bytes(cfg, dims, "train",
                                          task["batch"], task["seq"])}
    finally:
        set_perf(BASELINE)
    return out


def _route_sets(routes) -> list[dict]:
    """Each MoE call's routing on the host, as ``_route_diff`` reads it:
    the experts each token chose, sorted, and the router's logits."""
    return [{"experts": r.expert_idx.sort(-1)[0].cpu(),
             "logits": r.logits.cpu()} for r in routes]


def _bf16_ulp(v: float) -> float:
    """One bfloat16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(v))) - 7) if v else 0.0


def _route_diff(one: list, got: list, top_k: int) -> dict:
    """Two prefills' routing of the same prompts (``_route_sets``), layer
    by layer: how many tokens chose other experts, and, at the first layer
    where any did, whose inputs differ by rounding alone (no token was
    routed otherwise before it), each such token's gap between its k-th
    and (k+1)-th router logit in either run beside one bfloat16 ulp of
    the larger."""
    flips, first = [], None
    for layer, (a, g) in enumerate(zip(one, got)):
        same = (a["experts"] == g["experts"]).all(-1)
        flips.append(int((~same).sum()))
        if first is None and flips[-1]:
            rows = []
            for t in torch.nonzero(~same).flatten().tolist():
                row = {"token": t}
                for name, r in (("one_device", a), ("sharded", g)):
                    v = r["logits"][t].sort(descending=True)[0]
                    kth, nxt = float(v[top_k - 1]), float(v[top_k])
                    row[name] = {"kth": kth, "gap": kth - nxt,
                                 "ulp": _bf16_ulp(max(abs(kth), abs(nxt)))}
                rows.append(row)
            first = {"layer": layer, "tokens": rows}
    return {"flips": flips, "first_flip": first}


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the largest |want|, in float32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def _shard_moe(rank: int, task: dict) -> dict:
    """qwen2-moe-a2.7b served at ``task``'s mesh: the ranks draw the
    weights one after another (each keeps its experts; two at once would
    hold two whole expert leaves beside both shards), then the prefill of
    LM_DROPFREE prompts, which no capacity can drop, in bfloat16 and in
    float32, and of the lm phase's prompts: the capacity, at dp = 1 the
    one-device call's, and the drops per layer. Each bfloat16 prefill's
    routing is compared with the one-device run's (``_route_diff``): the
    tp all-reduces round partial sums in another order, so a token whose
    top-k holds a bfloat16 near-tie may choose another expert, which
    changes its output and, through attention and the experts' capacity
    slots, later tokens'. The lm phase's prompts are prefilled once more
    with the one-device run's experts replayed (``replay_routing``),
    which leaves rounding as the only difference. Then
    SHARD_DECODE_STEPS decode steps and ``Engine.generate`` (the tokens
    that agree with the one-device run's)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serve import serve_step as SS
    from repro_torch.sharding.env import Mesh, use_mesh

    dev = task["dev"]
    cfg = get_config(task["arch"], smoke=task["smoke"])
    ref = torch.load(task["reference"])        # on the host until compared
    prompts = ref["prompts"].to(dev)
    mesh = Mesh(tuple(task["mesh"]), ("data", "model"))
    with use_mesh(mesh, mesh.connect("cuda")):
        torch.cuda.reset_peak_memory_stats()
        for r in range(dist.get_world_size()):
            if r == rank:
                params, t_init = wall(lambda: lm.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(SEED),
                    dev))
                torch.cuda.empty_cache()
            dist.barrier()
        init_peak = peak_mib()
        torch.cuda.reset_peak_memory_stats()
        free_in = ref["dropfree_prompts"].to(dev)
        with torch.no_grad(), L.record_routing() as free_routes:
            free = lm.gather_vocab(SS.prefill(cfg, params, free_in)[0])
        free_diff = _route_diff(ref["dropfree_routes"],
                                _route_sets(free_routes), cfg.moe.top_k)
        free_diff["max_rel_vs_one_device"] = _max_rel(
            free, ref.pop("dropfree_logits").to(dev))
        with torch.no_grad(), _compute_dtype(torch.float32):
            free32 = lm.gather_vocab(SS.prefill(cfg, params, free_in)[0])
        rel_f32 = _max_rel(free32, ref.pop("dropfree_f32").to(dev))
        del free, free32, free_routes
        # the one-device run's experts replayed: rounding alone apart
        with torch.no_grad(), L.replay_routing(
                [r["experts"] for r in ref["routes"]]), \
                L.record_routing() as replayed:
            full = lm.gather_vocab(SS.prefill(cfg, params, prompts)[0])
        replay = {"drops": [int((~r.keep).sum()) for r in replayed],
                  "max_rel_vs_one_device": _max_rel(full, ref["logits"]
                                                    .to(dev)),
                  "one_device_bf16_vs_f32": ref["bf16_floor"]}
        del full, replayed
        with torch.no_grad(), L.record_routing() as routes:
            ((logits, caches), t_prefill, nbytes, coll_ms) = \
                _timed_collectives(lambda: SS.prefill(cfg, params, prompts))
        drops = [int((~r.keep).sum()) for r in routes]
        capacity = routes[0].capacity
        diff = _route_diff(ref.pop("routes"), _route_sets(routes),
                           cfg.moe.top_k)
        del routes
        full = lm.gather_vocab(logits)
        diff["max_rel_vs_one_device"] = _max_rel(full, ref.pop("logits")
                                                 .to(dev))
        b, s = prompts.shape
        with torch.no_grad():
            tok = SS.greedy_token(logits[:, -1:, :], cfg.vocab)
            caches = SS.grow_caches(cfg, caches, b, s + LM_NEW)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(SHARD_DECODE_STEPS):
                lg, caches = SS.decode(cfg, params, tok, caches, s + i)
                tok = SS.greedy_token(lg[:, -1:, :], cfg.vocab)
            torch.cuda.synchronize()
            decode_ms = 1e3 * (time.perf_counter() - t0) / SHARD_DECODE_STEPS
        del caches, logits, full
        tokens, t_gen = wall(lambda: SS.Engine(cfg, params, s + LM_NEW)
                             .generate(prompts, LM_NEW))
        agree = int((tokens.cpu() == ref["tokens"]).sum())
        del params
    torch.cuda.empty_cache()
    return {"init_s": t_init, "prefill_s": t_prefill,
            "prefill_bytes": nbytes, "prefill_collective_ms": coll_ms,
            "prefill_rule_bytes": _rule_bytes(cfg, task["mesh"], "prefill",
                                              b, s),
            "prefill_routes": diff, "prefill_replayed": replay,
            "dropfree_prompts": list(ref["dropfree_prompts"].shape),
            "dropfree_routes": free_diff,
            "dropfree_f32_max_rel_vs_one_device": rel_f32, "drops": drops,
            "drops_one_device": ref["drops"], "capacity": capacity,
            "capacity_one_device": ref["capacity"], "decode_ms": decode_ms,
            "generate_s": t_gen, "tokens_agree": agree,
            "tokens": int(tokens.numel()), "init_peak_mib": init_peak,
            "serve_peak_mib": peak_mib()}


def _shard_ssm(rank: int, task: dict) -> dict:
    """falcon-mamba-7b at full width cut to ``task["layers"]``: one train
    step at ``task``'s mesh with the launch counters zeroed just before and
    read just after, its first scan call's arguments (this rank's d_inner
    / tp channels) kept and the kernel held against its plain version on
    them; the loss against the one-device step's."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    from repro_torch.sharding.env import Mesh, use_mesh
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    dev = task["dev"]
    cfg = dataclasses.replace(get_config(task["arch"], smoke=task["smoke"]),
                              n_layers=task["layers"])
    pipe = SyntheticPipeline(cfg, DataConfig(task["batch"], task["seq"],
                                             SEED), dev)
    ocfg = O.AdamWConfig(warmup_steps=1, total_steps=TRAIN_SSM_STEPS)
    mesh = Mesh(tuple(task["mesh"]), ("data", "model"))
    captured, real = [], ops.selective_scan

    def capture(*args):
        if not captured:
            captured.append(tuple(None if t is None else t.detach().clone()
                                  for t in args))
        return real(*args)

    with use_mesh(mesh, mesh.connect("cuda")):
        torch.cuda.reset_peak_memory_stats()
        params = lm.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(SEED), dev)
        opt = O.init_opt_state(params)
        ops.reset_launches()
        ops.selective_scan = capture
        try:
            (_, _, m), t, nbytes, ms = _timed_collectives(
                lambda: TS.train_step(cfg, ocfg, params, opt,
                                      pipe.batch_at(0)))
        finally:
            ops.selective_scan = real
        launches = dict(ops.LAUNCHES)
        del params, opt
    torch.cuda.empty_cache()
    got = ops.selective_scan(*captured[0])
    want = ref.selective_scan_ref(*captured[0])
    err = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "step_s": t, "bytes": nbytes, "collective_ms": ms,
            "launches": launches, "scan_shape": list(captured[0][0].shape)
            + [captured[0][4].shape[1]], "scan_max_rel_err": err,
            "peak_mib": peak_mib()}


_SHARD_TASKS = {"dense": _shard_dense, "moe": _shard_moe, "ssm": _shard_ssm}


def _shard_rank(rank: int, world: int, backend: str, rdzv: str, job: str,
                out_prefix: str) -> None:
    """One rank of the shard phase (a process of its own): joins the
    group, runs the job's tasks in order and writes its rows."""
    import gc
    import torch.distributed as dist
    # before CUDA starts here: free pages go back to the card at
    # empty_cache, so a rank that drew a whole leaf and kept its shard
    # holds only the shard while the next rank draws
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    _join_group(backend, rdzv, world, rank)
    try:
        tasks = json.loads(Path(job).read_text())
        rows = {}
        for task in tasks:
            rows[task["name"]] = _SHARD_TASKS[task["kind"]](rank, task)
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        Path(f"{out_prefix}_{rank}.json").write_text(json.dumps(rows))
    finally:
        dist.destroy_process_group()


def _shard_spawn(tmp: str, world: int, backend: str, tasks: list,
                 tag: str = "") -> list:
    """Run ``tasks`` on ``world`` fresh ranks of ``backend``; their rows."""
    import torch.multiprocessing as mp
    name = f"{world}{tag}"
    job = f"{tmp}/job_{name}.json"
    Path(job).write_text(json.dumps(tasks))
    mp.spawn(_shard_rank, args=(world, backend, f"{tmp}/rdzv_{name}", job,
                                f"{tmp}/{name}"), nprocs=world)
    return [json.loads(Path(f"{tmp}/{name}_{r}.json").read_text())
            for r in range(world)]


def _shard_references(tmp: str, dev: str = "cuda", smoke: bool = False
                      ) -> dict:
    """In this process, before any rank: qwen2-moe-a2.7b's one-device
    prefill logits, drops and generated tokens on seeded prompts (saved
    for the ranks), and the one-device loss of the cut falcon-mamba's
    first train step; each model freed after."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serve import serve_step as SS
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    cfg = get_config(LM_MOE_ARCH, smoke=smoke)
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(dev)
    params = lm.init_params(cfg, torch.Generator(device=dev)
                            .manual_seed(SEED), dev)
    with torch.no_grad(), L.record_routing() as routes:
        logits = SS.prefill(cfg, params, prompts)[0]
    # the model's own bfloat16 error: against float32 compute on the same
    # experts (the replay keeps a near-tie from routing float32 otherwise)
    with torch.no_grad(), _compute_dtype(torch.float32), L.replay_routing(
            [r.expert_idx for r in routes]):
        bf16_floor = _max_rel(logits, SS.prefill(cfg, params, prompts)[0])
    logits = logits.cpu()
    free = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, LM_DROPFREE))
    with torch.no_grad(), L.record_routing() as free_routes:
        free_logits = SS.prefill(cfg, params, free.to(dev))[0].cpu()
    with torch.no_grad(), _compute_dtype(torch.float32):
        free_f32 = SS.prefill(cfg, params, free.to(dev))[0].cpu()
    tokens = SS.Engine(cfg, params, LM_PROMPT + LM_NEW).generate(prompts,
                                                                 LM_NEW)
    torch.save({"prompts": prompts.cpu(), "logits": logits,
                "routes": _route_sets(routes),
                "dropfree_prompts": free, "dropfree_logits": free_logits,
                "dropfree_f32": free_f32,
                "dropfree_routes": _route_sets(free_routes),
                "tokens": tokens.cpu(), "capacity": routes[0].capacity,
                "drops": [int((~r.keep).sum()) for r in routes],
                "bf16_floor": bf16_floor},
               f"{tmp}/moe_reference.pt")
    del params, logits, routes, tokens, free_routes
    torch.cuda.empty_cache()
    scfg = dataclasses.replace(get_config(TRAIN_SSM_ARCH, smoke=smoke),
                               n_layers=SHARD_SSM_LAYERS)
    params = lm.init_params(scfg, torch.Generator(device=dev)
                            .manual_seed(SEED), dev)
    pipe = SyntheticPipeline(scfg, DataConfig(TRAIN_SSM_BATCH, TRAIN_SSM_SEQ,
                                              SEED), dev)
    m = TS.train_step(scfg, O.AdamWConfig(
        warmup_steps=1, total_steps=TRAIN_SSM_STEPS), params,
        O.init_opt_state(params), pipe.batch_at(0))[2]
    out = {"moe": f"{tmp}/moe_reference.pt", "ssm_loss": float(m["loss"]),
           "ssm_grad_norm": float(m["grad_norm"])}
    del params, m
    torch.cuda.empty_cache()
    return out


def _shard_dense_log(w1, w2) -> None:
    """The dense runs of worlds 1 and 2 against world 1's one-device
    steps, logged and held."""
    one = [r["loss"] for r in w1[0]["dense"]["one_device"]["steps"]]
    one_gn = [r["grad_norm"] for r in w1[0]["dense"]["one_device"]["steps"]]
    runs = {"1x1 nccl": (w1[0]["dense"]["1x1"],
                         [w1[0]["dense"]["1x1"]["peak_mib"]])}
    for dims in SHARD_MESHES:
        m = "x".join(map(str, dims))
        for r, rows in enumerate(w2):
            require([x["loss"] for x in rows["dense"][m]["steps"]]
                    == [x["loss"] for x in w2[0]["dense"][m]["steps"]],
                    f"shard {m}: rank {r} reports another loss")
        runs[f"{m} gloo"] = (w2[0]["dense"][m],
                             [rows["dense"][m]["peak_mib"] for rows in w2])
    for name, (run, peaks) in runs.items():
        losses = [r["loss"] for r in run["steps"]]
        gns = [r["grad_norm"] for r in run["steps"]]
        rel = [abs(a - b) / b for a, b in zip(losses, one)]
        gn_rel = [abs(a - b) / b for a, b in zip(gns, one_gn)]
        # the first step is held: the same weights and batch. After one
        # update the runs part: at step 1 AdamW moves every element by
        # ±lr, so a gradient whose sign a last-bit difference flips moves
        # its weight the other way (even at 1 x 1, whose cross-entropy
        # rounds otherwise), and those moves compound; later steps print
        log({"phase": "shard.dense", "arch": TRAIN_ARCH, "mesh": name,
             "batch": [TRAIN_BATCH, TRAIN_SEQ], "losses": losses,
             "one_device_losses": one, "loss_rel": rel,
             "grad_norms": gns, "one_device_grad_norms": one_gn,
             "grad_norm_rel": gn_rel, "warm_step_s": run["warm_step_s"],
             "step_s": [r["step_s"] for r in run["steps"]],
             "one_device_step_s": [r["step_s"] for r in
                                   w1[0]["dense"]["one_device"]["steps"]],
             "peak_mib_ranks": peaks,
             "one_device_peak_mib": w1[0]["dense"]["one_device"]["peak_mib"],
             "bytes": run["steps"][-1]["bytes"],
             "collective_ms": run["steps"][-1]["collective_ms"],
             "rule_bytes": run["rule_bytes"]})
        require(rel[0] <= SHARD_LOSS_REL and gn_rel[0] <= SHARD_GRAD_REL,
                f"shard {name}: first loss {losses[0]} / grad norm {gns[0]} "
                f"against the one-device step's {one[0]} / {one_gn[0]}")


def _shard_ssm_log(w2, refs) -> None:
    ssm = w2[0]["ssm"]
    ssm_rel = abs(ssm["loss"] - refs["ssm_loss"]) / refs["ssm_loss"]
    log({"phase": "shard.ssm", "arch": TRAIN_SSM_ARCH,
         "layers": SHARD_SSM_LAYERS, "mesh": list(SHARD_MOE_MESH),
         "batch": [TRAIN_SSM_BATCH, TRAIN_SSM_SEQ],
         "one_device_loss": refs["ssm_loss"], "loss_rel": ssm_rel,
         "one_device_grad_norm": refs["ssm_grad_norm"],
         "ranks": [rows["ssm"] for rows in w2]})
    require(ssm_rel <= SHARD_LOSS_REL and abs(
        ssm["grad_norm"] - refs["ssm_grad_norm"])
        <= SHARD_GRAD_REL * refs["ssm_grad_norm"],
        f"shard ssm: loss {ssm['loss']} / grad norm {ssm['grad_norm']} "
        f"against {refs['ssm_loss']} / {refs['ssm_grad_norm']}")
    for rows in w2:
        s = rows["ssm"]
        # the forward and the remat recompute scan once a layer each
        require(s["launches"]["selective_scan_bwd"] == SHARD_SSM_LAYERS
                and s["launches"]["selective_scan"] == 2 * SHARD_SSM_LAYERS
                and s["scan_max_rel_err"] <= SCAN_REL,
                f"shard ssm rank: launches {s['launches']}, the scan on "
                f"{s['scan_shape']} within {s['scan_max_rel_err']}")


def _shard_moe_log(w2m) -> None:
    """The MoE served at SHARD_MOE_MESH against one device, logged and
    held: float32 compute on the drop-free prompts within F32_DECODE_REL;
    in bfloat16, the prefill with the one-device run's experts replayed
    within SHARD_MOE_REL of the largest one-device logit, with the
    one-device drops (the one-device prefill's own bfloat16 error against
    float32 compute printed beside); and,
    with each run routing on its own, on both prompt sets, each token that
    chose other experts at the first layer where any did sat on a near-tie
    that rounding broke the other way: its two runs' top-k gaps add to at
    most their two bfloat16 ulps (each logit moved by an ulp at most)."""
    moe = [rows["moe"] for rows in w2m]
    log({"phase": "shard.moe", "arch": LM_MOE_ARCH,
         "mesh": list(SHARD_MOE_MESH), "prompts": [LM_BATCH, LM_PROMPT],
         "bound": SHARD_MOE_REL, "one_region_bound": bf16_rel(24),
         "ranks": moe})
    for r in moe:
        require(r["dropfree_f32_max_rel_vs_one_device"] <= F32_DECODE_REL,
                f"shard moe: the float32 drop-free prefill "
                f"{r['dropfree_f32_max_rel_vs_one_device']} of the largest "
                "logit from the one-device prefill")
        rep = r["prefill_replayed"]
        require(rep["max_rel_vs_one_device"] <= SHARD_MOE_REL
                and rep["drops"] == r["drops_one_device"],
                f"shard moe: the prefill with the one-device routing "
                f"replayed {rep['max_rel_vs_one_device']} of the largest "
                f"logit from the one-device prefill (held to "
                f"{SHARD_MOE_REL}), drops {rep['drops']}")
        for key in ("prefill_routes", "dropfree_routes"):
            first = r[key]["first_flip"]
            for row in (first["tokens"] if first else []):
                one, mine = row["one_device"], row["sharded"]
                require(one["gap"] + mine["gap"] <= one["ulp"] + mine["ulp"],
                        f"shard moe {key}: token {row['token']} chose "
                        f"other experts at layer {first['layer']} with "
                        f"top-k gaps wider than a near-tie: {row}")
        require(r["capacity"] == r["capacity_one_device"],
                f"shard moe at dp = 1: capacity {r['capacity']}, one "
                f"device {r['capacity_one_device']}")


def phase_shard(dev: str = "cuda", smoke: bool = False) -> dict:
    """Sharded execution (phase 20; ``smoke`` runs the SMOKE configs).
    Each world's results are logged and held as soon as its ranks end.
    Returns the sharded SSM step's scan launches and local shape for the
    kernels line."""
    import tempfile
    torch.cuda.empty_cache()
    base = {"dev": dev, "smoke": smoke}
    dense = dict(base, kind="dense", arch=TRAIN_ARCH, batch=TRAIN_BATCH,
                 seq=TRAIN_SEQ, steps=SHARD_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        refs, t_ref = wall(lambda: _shard_references(tmp, dev, smoke))
        w1, t_w1 = wall(lambda: _shard_spawn(tmp, 1, "nccl", [dict(
            dense, name="dense", one_device=True, meshes=[[1, 1]])]))
        w2, t_w2 = wall(lambda: _shard_spawn(tmp, 2, "gloo", [
            dict(dense, name="dense", one_device=False,
                 meshes=[list(m) for m in SHARD_MESHES]),
            dict(base, name="ssm", kind="ssm", arch=TRAIN_SSM_ARCH,
                 layers=SHARD_SSM_LAYERS, batch=TRAIN_SSM_BATCH,
                 seq=TRAIN_SSM_SEQ, mesh=list(SHARD_MOE_MESH))]))
        _shard_dense_log(w1, w2)
        _shard_ssm_log(w2, refs)
        # fresh processes: the experts' shards leave room for one whole
        # expert leaf and its shard while a rank draws them, no more
        w2m, t_w2m = wall(lambda: _shard_spawn(tmp, 2, "gloo", [
            dict(base, name="moe", kind="moe", arch=LM_MOE_ARCH,
                 mesh=list(SHARD_MOE_MESH), reference=refs["moe"])],
            tag="moe"))
        _shard_moe_log(w2m)
    log({"phase": "shard", "wall_s": {"references": t_ref, "world1": t_w1,
                                      "world2": t_w2, "world2_moe": t_w2m}})
    ssm = w2[0]["ssm"]
    return {"scan_launches": ssm["launches"],
            "scan_shape": ssm["scan_shape"]}

def main() -> int:
    phase_analysis()
    card = phase_device()
    phase_analysis_sync()
    g, owner, plan, launches, main_results = phase_main()
    sssp_state = main_results["sssp"].state
    gnn_launches = phase_gnn(g, plan)
    serve = phase_serve(g, owner)
    stream = phase_stream(g, owner)
    part, road_part, etsch_launches = phase_etsch(g, owner, plan,
                                                  sssp_state)
    dist_launches = phase_dist(g, owner, main_results)
    lm_launches, lm_inputs = phase_lm()
    moe_dfep_launches = phase_lm_attn(LM_MOE_ARCH)["moe_dfep"]
    phase_lm_attn(LM_DENSE_ARCH)
    hybrid = phase_lm_attn(LM_HYBRID_ARCH, n_layers=LM_HYBRID_LAYERS)
    phase_lm_attn(LM_MLA_ARCH, n_layers=LM_MLA_LAYERS)
    phase_lm_attn(LM_ENCDEC_ARCH, batch=LM_ENCDEC_BATCH,
                  prompt=LM_ENCDEC_PROMPT)
    phase_lm_attn(LM_VLM_ARCH, n_layers=LM_VLM_LAYERS, batch=LM_VLM_BATCH,
                  prompt=LM_VLM_PROMPT, cut_reason=LM_VLM_CUT)
    kernel_line = phase_kernels(plan, launches, gnn_launches, g, owner, part,
                                road_part, etsch_launches, sssp_state,
                                lm_launches, lm_inputs, serve, stream,
                                dist_launches, moe_dfep_launches, hybrid)
    del lm_inputs, hybrid
    train = phase_train()
    for row in kernel_line["kernels"]:
        if row["name"] == "selective_scan":
            row["train_launches"] = train["selective_scan_launches"]
    kernel_line["kernels"].append(train["row"])
    phase_dryrun()
    shard = phase_shard()
    for row in kernel_line["kernels"]:
        if row["name"] in ("selective_scan", "selective_scan_bwd"):
            row["shard_launches"] = shard["scan_launches"][row["name"]]
            row["shard_shape"] = shard["scan_shape"]
    phase_cpu_equal()
    _dist_cpu_equal()
    for arch in (LM_ARCH, LM_MOE_ARCH, LM_DENSE_ARCH, LM_HYBRID_ARCH,
                 LM_MLA_ARCH, LM_ENCDEC_ARCH, LM_VLM_ARCH):
        _lm_cpu_equal(arch)
    print(card, flush=True)
    print(json.dumps(kernel_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
