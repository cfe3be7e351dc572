#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from prcv2025reid_tpu_torch/csrc
     (one nvcc per source, in parallel), print ptxas' resource report and
     count the Hopper instructions in the SASS of each kernel on the GEMM
     core (cuobjdump): the tiled matmul's bf16 and int8 kernels, the fused
     MLP's two, the bf16 block kernels' four (the LN1 + QKV GEMM with its
     bias; the out-projection with the f32 residual, fc1, fc2 with the
     residual) and the int8 block kernels' four (the QKV GEMM with its
     dequantizing bias epilogue; #6's out-projection with the dequantizing
     residual epilogue; the MLP tail's fc1 with the GELU and row max, fc2
     with the residual), failing unless each library holds its expected
     number of them and each has warpgroup MMAs (HGMMA for bf16; the integer
     wgmma's mnemonic is read from the int8 kernels' dump and printed), TMA
     loads (UTMALDG) and TMA stores (UTMASTG), and if either block kernels'
     library holds any mma.sync (HMMA for bf16, IMMA for int8);
  3. hold each kernel against its plain PyTorch version at the gallery-embed
     shapes (B=128 images of 197 tokens, ViT-B/16 widths) on the same bf16
     inputs: relative Frobenius error <= REL_TOL and max-abs error <= ABS_TOL
     (the int8 kernels: INT8_REL_TOL, INT8_ABS_TOL, for rounding flips);
     attention also with causal=True, with kernel_version=1 and at the text
     tower's causal shape (128 captions, S = 77, H = 8), the fused MLP, the
     two LN1 + QKV block kernels (bf16, int8) and the three out-projection +
     MLP block kernels (bf16, int8, mixed) also with G=3 groups of 32 images
     (the MM-3 query: 6,304 rows a group, not a multiple of any tile);
     the three int8 block kernels on weights quantized as the model does
     (quantize_weight) and the splash core on [B, S, H, Dh] views of one QKV
     projection; the microbenchmark's tiled matmul in both modes at its
     M = 25,344 rows and at a ragged 6,304, for every row tile (block_rows),
     bf16 within REL_TOL / ABS_TOL and int8 bit for bit; at token
     reduction's shapes (phase 4e: S_RED tokens after the reduction, 128
     images of them = 12,288 rows) attention at S_RED and S_RED - 1 ('prune')
     and the LN1 + QKV (bf16, int8), out-projection + MLP (bf16, int8) and
     fused MLP kernels at 12,288 rows; at tensor parallelism's shapes (phase
     4i (d): a process's H / TP_MODEL heads and F / TP_MODEL MLP columns)
     attention at 6 heads and the fused MLP at F = 1,536 with a zero b2;
     then the gradients: each bf16 wrapper (fused_mha also causal, the
     splash core, fused_ln_qkv, fused_out_mlp, fused_mlp at G=1,
     fused_residual_ln) at the same shapes with every input requiring grad,
     its kernel forward and its autograd.Function's backward, against
     autograd through its plain version on the same values: every input
     must get a finite gradient within GRAD_REL_TOL; at phase 4j's presets
     (checked before the gradients): attention at B/32's 50 tokens and past
     256 at L/14's 16 heads (257, and 577 at 336 px), causal and not,
     through the kernel's register-held path, at that path's longest
     length REG_MAX_SEQ and one past it (the two-pass path), and its
     gradient at 257; the splash core at 257; #3-#9 at L/14's widths (D =
     1,024, F = 4,096) on BATCH images of 257 tokens and on three groups of
     32, and #5 there on unit-variance residual and attention operands,
     its largest error in bf16 ulps of the output element printed, and
     held to UNIT_MAX_ULPS at outputs of magnitude UNIT_GATE_MIN and up;
     #1 at every head width and length the TPU kernel takes: HEAD_WIDTHS
     (every padded width 64, 128, 192, 256; the zero-padded 20; ViT-H's 80)
     x ROUTE_EDGES (each route's edge lengths, causal at 77) on ATT_GRID_BH
     pairs, and LONG_SEQS (4,097, 16,385) at LONG_SEQ_DH with B*H = 2,
     causal and not; at phase 4k's ViT-H/14 widths #1 at BATCH images of
     257 tokens, 16 heads of 80, the splash core there, and #3-#9 at D =
     1,280, F = 5,120 on BATCH images' rows (#7 only here); the row passes
     past 1,024 columns: #3-#9 at each of ROW_WIDTHS on ROW_ROWS rows (the
     int8 plans at the multiples of 16);
  4. build the full-width ViT-B/16 model (fusion_dim 512, 400 classes, bf16
     compute) from init_params(seed=0, perturb=True) and embed one seeded
     uint8 batch through the entry points (build_model,
     make_combo_embed_step) under thirteen paths: block_impl="xla" (plain),
     block_impl="fused", use_pallas_attention=True, use_fused_mlp=True, the
     fused-stream trunk (use_fused_resln=True with use_fused_mlp and
     use_pallas_attention), the same trunk with the plain MLP
     (use_fused_resln and use_pallas_attention), block_impl="fused_qkv",
     attn_backend="splash", block_impl="fused_int8",
     block_impl="fused_int8_mlp", and the serving formulations
     attn_backend="onesaug", gelu_impl="tanh" and gelu_impl="poly" (plain
     PyTorch: no kernel launch).  Each exact kernel path must reach
     min-cosine >= 0.999 against the plain path, each int8 plan and serving
     formulation >= 0.99 (JAX's own bar for the int8 plans through the trunk;
     the reading against the 0.999 promotion gate is printed, not required),
     and the launch counters,
     zeroed just before each run, must read exactly EXPECTED (one launch per
     block 0..L-2 where the
     last block is CLS-only; the fused-stream trunk runs all L blocks with two
     residual+LN launches each).  The fused-stream trunk is also held against
     the plain path on the MM-3 query combo (nir, sk, cp: three groups).
     Every path must also agree with an f32 embedding of the same images
     computed by the port on the CPU.
     Then the ranking gate (bench.py's structured probe set: RANK_IDS ids x
     RANK_PER_ID f32-normal gallery images, RANK_QUERIES queries, seed 0) for
     every path against the plain one with the port's ranking_equivalence on
     the card: top-100 overlap >= RANK_MIN_OVERLAP and |dmAP| <=
     RANK_MAX_MAP_DELTA, required of the exact kernel paths, read and printed
     for the int8 plans and the serving formulations.  Then the MM-1..4
     protocol on a synthetic set (a uint8 vis gallery of MM_IDS ids x
     MM_GALLERY_PER_ID images; MM_QUERY_PER_ID queries an id, each with nir,
     sk and cp images and one caption): every one of the 15 query plans
     embedded through make_combo_embed_step under the plain path, the
     fused-stream trunk and the int8 plan (launch counts read per query
     step), ranked on the card by compute_retrieval_metrics (mAP, top-1,
     CMC@1/5/10 per plan, also held against the same call on the CPU); the
     fused-stream trunk must reach min-cosine >= 0.999 on every combo and
     |dmAP| <= RANK_MAX_MAP_DELTA on every plan, the int8 plan's readings are
     printed; and the device ms and idle share of one text-only query step
     (BATCH captions of 77 tokens);
  4b. train at full width through the entry points (build_model,
     init_train_state, make_train_step): the 8x4 recipe (TRAIN_P ids x
     TRAIN_K instances, one seeded uint8 batch, TrainingConfig defaults:
     bf16, frozen backbone, stored GELU and attention residuals, the
     adaptive clip, no accumulation), steps_per_epoch 1, sdm weight 0.1,
     tau 0.18, on two paths, xla (plain) and pallas_attention (the fused
     attention kernel in the forward).  Per path: one step with the launch
     counters zeroed just before it (fused_mha L-1 on pallas_attention,
     every counter 0 on xla) and no host synchronisation inside it
     (torch.cuda's sync debug mode); TRAIN_STEPS finite, unskipped steps
     with a falling loss, frozen parameters bit for bit unchanged, every
     trainable group and the BN statistics moved; a poisoned step (one NaN
     pixel in a float batch) skipped with params, optimizer state and BN
     statistics bit for bit; it/s and samples/s (median of TRAIN_ROUNDS
     rounds of TRAIN_ITERS steps), device ms (CUDA events), idle share and
     the top device ops of one step (torch.profiler), peak memory.  Step 1 of
     pallas_attention against xla (losses within TRAIN_LOSS_REL, each
     trainable group's gradient cosine >= TRAIN_GRAD_COS, the global norm
     within TRAIN_GNORM_REL); remat_blocks on pallas_attention (fused_mha
     2L launches a step; step-1 gradients within TRAIN_REMAT_REL of the
     same trunk run without recomputation, and at the cross-path bars
     against the plain trunk); step 1 at P x K = 2 x 2 with no dropout: the
     card in f32 against the CPU in f32 (losses within TRAIN_F32_LOSS_REL,
     gradient cosine >= TRAIN_F32_GRAD_COS), and the card in bf16 against
     the CPU in f32 (losses within TRAIN_CPU_LOSS_REL, each group's gradient
     cosine within TRAIN_BF16_COS_SLACK of the CPU's own bf16 run's);
  4c. (from here to 4g each evaluation dataset of this process decodes an
     image file once, decode_once: the evaluations read one val split again
     and again)
     the dataset path at full width through the entry points a user calls:
     a synthetic ORBench tree (make_synthetic_orbench: DATA_IDS ids x
     DATA_ANCHORS anchors, DATA_IMG px JPEGs, in a temporary directory that
     phase 4d trains on too)
     split id-disjoint (val_ratio 0.2); the native image decode and BPE
     tokenizer built with g++ (a failed build fails the run, except a
     missing jpeglib.h, which is printed and leaves the host on PIL); the
     native BPE equal to the Python BPE on a vocab this script writes; the
     8x4 PKBatchSampler -> HostPipeline (num_workers=-1; the worker and
     core counts printed) alone, batches/s over PIPE_BATCHES batches after
     its workers are warm, with PIL and with native decode; the pipeline
     feeding FEED_STEPS train steps through prefetch_to_device on xla and
     pallas_attention, with no host synchronisation (sync debug mode
     'error' around each fetch and step), fused_mha L-1 launches a step on
     pallas_attention (every counter 0 on xla), finite unskipped steps whose
     last five losses average below the first five, it/s after FEED_WARMUP,
     device ms of one profiled fed step, idle share, beside phase 4b's
     figures for a resident batch; evaluate_protocol over the val split (all
     15 plans, make_combo_embed_step per plan) under xla (the trained model)
     and the fused-stream trunk built from its weights, with launch counts
     per embed batch with a vision tower (trunk: fused_mha L, fused_mlp L,
     fused_residual_ln 2L), gallery min-cosine >= MIN_COSINE and |dmAP| <=
     RANK_MAX_MAP_DELTA on every plan; a second call with the GalleryCache
     that skips the gallery embed and reads the first call's features bit
     for bit; gallery embeds/s and idle share of embed_samples (host decode
     in the calling process) over the whole tree; and
     export_submission_csv: one row a query, each row's top-k gallery ids
     valid and unique;
  4d. the trainer through its command line, tools_torch/train.py's
     main(argv), on 4c's tree at full width (TrainingConfig(): ViT-B/16,
     TRAIN_P x TRAIN_K, 7 decode workers) with use_pallas_attention,
     use_fused_mlp and use_fused_resln, warmup_epochs 1 (the second epoch
     trains at the full LR), each train step under the sync debug mode
     'error' (no host synchronisation in any).  Run A: 2 epochs of
     TRAINER_STEPS steps, the eval (all 15 plans, the whole val split) at
     epoch 2 and the final one, async checkpoints (save_freq 1: epoch_1/ is
     the checkpoint phase 4f reloads): the histories (two train
     rows), latest/ and best/ with their sidecars, training.log; the launch
     counts of the whole run, zeroed just before it (fused_mha L-1 a train
     step; fused_mha L, fused_mlp L, fused_residual_ln 2L a vision forward:
     each vision embed batch of each evaluate and the smoke test's); finite
     losses and a falling CE (the mean of the last five steps below the first
     five; the SDM term joins at epoch 2).  Run B (blocking checkpoints, no
     eval, which changes nothing of the training before epoch 10): 1 epoch,
     then a new trainer resumes it to 2, held to run A: the per-epoch losses
     within TRAINER_LOSS_REL, each trainable group's parameters at cosine >=
     TRAINER_COS, the sampler state equal; whether the parameters are the
     same bits is printed.  Then steps/s by epoch beside 4c's fed
     pallas_attention it/s, device ms (CUDA events) and idle share of one
     step of each run's trainer, seconds per evaluate, the checkpoint's size, and
     the time the loop spent in save_checkpoint and finalize_pending_saves
     with async (A) and blocking (B) saves;
  4e. the evaluation command line, tools_torch/eval_mm_protocol.py's
     main(argv), at full width on 4c's tree, each run's launch counts zeroed
     just before it and read per vision embed batch (the fused-stream
     trunk: fused_mha L, fused_mlp L, fused_residual_ln 2L; the reduced
     trunk: fused_mha and fused_mlp L-1 each, the last block being CLS-only;
     its block kernels' plan: fused_ln_qkv and fused_out_mlp L-1 each).
     (a) tools_torch/train.py trains a token-reduced run (token_keep
     TOKEN_KEEP after block TOKEN_LAYER, token_reduce_train,
     use_pallas_attention, use_fused_mlp; 1 epoch of TRAINER_STEPS steps, no
     eval): fused_mha L-1 a step, no host synchronisation in any step,
     finite losses; one step of the same trunk under remat_blocks (fused_mha
     2L; step-1 gradients within TRAIN_REMAT_REL of the same trunk run
     without recomputation).  (b) The CLI on 4d's run A best/ (--eval_split
     val, --sample_ratio of the run, no same-image exclusion, as the
     trainer's evaluation): every aggregate within CLI_METRIC_TOL of epoch
     2's row of eval_history.csv; its --submission CSV one row a query of
     unique gallery ids of the split.  (c) --fusion_mode weighted (E_SAMPLE of
     each plan's queries): the cache
     tag is (b)'s with _w after the weights' fingerprint; one MM-3 batch
     through make_weighted_embed_step launches one stacked trunk and holds
     the weighted sum of the per-modality make_combo_embed_step features at
     MIN_COSINE.  (d) --rerank with the defaults on (b)'s gallery cache:
     every plan's mAP_plain equals (b)'s mAP bit for bit, and the CSV's rows
     are the re-ranked heads rerank_orders returned.  (e) The run of (a): at
     its token_keep, at --token_keep=0 and with --block_impl fused (E_SAMPLE
     of each plan's queries), three distinct cache tags; the block kernels'
     gallery against the default path at TOKEN_FUSED_MIN_COSINE (its 0.999
     reading printed) and how many rows' keep sets differ.  Then token
     reduction on a resident batch: embeds/s in turns and device ms against
     the same path without it.  (f) rerank_orders on RR_QUERIES queries
     against an RR_GALLERY x 512 clustered gallery
     (tools_torch/tune_rerank.make_clustered at RR_SIGMAS, RR_IDS ids, each
     query excluding one of its id's items): queries/s at each query_chunk of
     RR_CHUNKS (in turns, twice), one 512-query chunk's device ms; the card
     against the CPU on RR_CPU_QUERIES queries (RR_SAME_ROWS of the rows
     equal, |dmAP| <= RR_MAP_TOL); lam=1.0 equal to the plain cosine top-N;
     tune_rerank.py --quick on the card;
  4f. the serving path, tools_torch/serve_embed.py, on 4d's run A best/ (the
     fused-stream trunk) and 4c's tree, each launch count zeroed just before
     the call it reads.  (a) The command line: --images on the tree's vis
     files at the eval batch, equal bit for bit to embed_samples' features of
     the same records (or, naming the cause, min-cosine >= SERVE_MIN_COSINE),
     #1 L, #8 L, #9 2L a vision batch; --text on its captions equal to the
     text step's, no launch.  (b) Two servers in this process (make_server on
     127.0.0.1, port 0) over one engine: one on an RR_GALLERY x 512 gallery
     loaded as --serve_gallery loads it (phase 4e (f)'s clustered set), one
     on (a)'s npz; /embed of vis and nir images, captions and MM-2/3/4
     queries equal to direct engine calls bit for bit, with the launches of
     each served batch (a vision batch #1 L, #8 L, #9 2L, a text batch none);
     SERVE_CONCURRENT concurrent one-image requests equal to the sequential
     answers, the batcher's dispatches against its requests.  (c) The store
     on SERVE_QUERIES clustered queries: plain top-100 ids equal to
     stable_topk over similarity, re-ranked ids (SERVE_RR) equal to
     rerank_orders; /search equal to the store's search; the tree's vis files
     queried by their own bytes find their own id first.  (d) Enrollment on
     the tree's gallery: /gallery/add past a capacity doubling, an add in
     place, /gallery/remove, each step's buffer and /search (plain and
     re-ranked) equal to a store rebuilt from scratch; /gallery/save read
     back by load_gallery.  (e) /admin/reload to run A's epoch_1/: /embed
     equal to a fresh engine on those weights, no kernel build, the memory
     allocated on the card before and after.  (f) Latency p50 / p90 of
     SERVE_LATENCY_N sequential requests a route (/embed of one vis image,
     one caption, one MM-4 query; /search of one caption at top 10, plain
     and re-ranked) with the device ms of the calls a request makes;
     --benchmark at BATCH and at the serving batch (its launches counted);
     bench_query.py at BATCH on
     xla and on the fused-stream trunk; bench_search.py at its defaults;
  4g. training from CLIP weights at full width, on 4c's tree.  (a) A seeded
     checkpoint in HF CLIPModel's layout at openai/clip-vit-base-patch16's
     widths (tools/convert_clip.hf_clip_shapes), written as
     model.safetensors (the port's own writer), as pytorch_model.bin and as
     a hub cache entry.  (b) The three load paths (the snapshot directory,
     the .bin directory, clip_weights_path="hf" through HF_HUB_CACHE) give
     the written values bit for bit; every leaf the conversion copies equals
     the file's tensor (transposed) bit for bit; the vis embedding of
     CLIP_ORACLE_BATCH images on the fused-stream trunk (bf16, #1 L, #8 L,
     #9 2L) reaches MIN_COSINE against an f32 plain-PyTorch oracle built
     from the HF tensors (conv patchify, CLS + positions, blocks with SDPA
     and erf GELU, post-LN, projection).  (c) tools_torch/train.py with
     --clip_weights_path, the three eval-trunk flags, 1 epoch of
     TRAINER_STEPS steps and its evaluation of CLIP_EVAL_PLANS: the trainer
     started from the file's leaves, no host synchronisation in any step,
     #1 L-1 a train step and L, L, 2L a vision forward, the frozen backbone
     unchanged bit for bit, every trainable group moved, finite losses,
     best/.  (d) remat_policy "dots" against "full" and no remat on the 8x4
     step (pallas_attention, the CLIP weights): step-1 gradients of dots
     within TRAIN_REMAT_REL of full's, fused_mha 2L a step under both (L-1
     without remat), no host synchronisation; it/s, peak memory above the
     resident models and device ms (CUDA events) of each, CLIP_ROUNDS rounds
     of CLIP_ITERS steps in turns.  (e) export_params on (c)'s best/, loaded
     back through params.load_params: the vis embeddings equal bit for bit.
     (f) diagnose.py on best/ (no entry flagged as zero, none non-finite),
     diagnose_alignment.py on best/, probe_sdm_breaking.py at full width
     (CLIP_PROBE_STEPS steps, one lr, one tau) and dryrun_real_data.py
     --full-size --clip_weights_path (CLIP_DRYRUN_STEPS steps, the
     fused-stream trunk, exit code 0);
  4h. the measuring tools and the serving artifact, each tool in a
     subprocess of its own (sys.executable), on 4c-4g's files.  (a)
     trace_embed.py at BATCH under TRACE_PATHS (fused and splash; xla and
     fused_int8 are cut for time, phase 5 times them): each rollup sums to
     its kernel table within 1%, the launches a step are the path's, the
     pallas bucket holds the port's kernels of the path and matmul none of
     them, and its CUDA events lie within TOOL_DEVICE_SPREAD of phase 5's
     reading of the same path (checked after phase 5).  (d) bench_host_pipeline.py: the PIL rate, the native leg
     (unavailable without jpeglib.h), the budget against the card's rates,
     the overlap check.  (trace_train.py's traced run, train_ab.py and
     flagship_train_probe.py, (b), (c) and (e), are cut for time and run
     standalone.)  (f) toolchain_watch.py --fast (its train leg runs
     trace_train.py --no-trace): exit 0 or 2, no probe without a reading.  (g) export_serving.py on 4d's
     run A best/ (BUNDLE_GRAPHS at BUNDLE_BATCH; a --block_impl fused
     gallery_vis from a copy of it without the fused-stream trunk, the two
     exports at once): each graph's bytes, export seconds and prcv_reid ops (gallery_vis #1 L, #8 L,
     #9 2L; the fused one #3 L-1, #5 L-1); then a fresh process loads the
     bundle (serve_artifact.consumer_check): no model module in sys.modules,
     a vis batch's launches #1 L, #8 L, #9 2L, its features (vis, text,
     nir+text, quad) against the live serve_embed engine's on the same
     inputs (bit for bit, or BUNDLE_MIN_COSINE with the cause), its server's
     /embed and /search, the gallery's plain and re-ranked search, the
     p50 / p90 of BUNDLE_LATENCY_N sequential
     one-image /embed requests.  (h) The host us a call of
     fused_residual_ln through torch.ops.prcv_reid against the direct
     launch (the eager paths keep the direct launch);
  4i. data parallel over a process group, DP_PROCS processes sharing the
     card over gloo (NCCL refuses two ranks on one device), on 4c's tree.
     (a) tools_torch/dp_dryrun.py's step leg: its 3 global-batch train
     steps at full width (the 8x4 recipe, use_pallas_attention, drop-path
     0.1, every process its contiguous slice of each seeded batch)
     against the one-process step on the whole batch in this process, from
     the same init_params state: each step's losses on both sides and their
     largest relative difference (<= DP_LOSS_REL), the processes'
     parameters and optimizer state the same bits, #1 L-1 launches a step on
     each process and in this process's reference steps (the counters
     zeroed before them, read after), each process's device ms a step (CUDA
     events) and the ms its all-reduces took.  (b) In the same processes, sharded_topk of
     1,024 queries against a 45,113 x 512 gallery split over them, top
     100, on small-integer features (every product exact, so the
     order is the arithmetic's, ties by index): the indices equal to
     stable_topk over the whole gallery.  (c) tools_torch/train.py launched
     as DP_PROCS processes (--distributed=on, a file:// rendezvous,
     --dist_backend=gloo) at full width: 1 epoch of DP_CLI_STEPS steps and
     the final evaluation on the fused-stream trunk of the config's plans;
     both exit 0, each process's launches (#1 L-1 a train step and L a
     vision forward, #8 L, #9 2L), training.log, the history and latest/
     from process 0 alone; then this process evaluates latest/ as the
     trainer does: every aggregate mAP within RANK_MAX_MAP_DELTA of the
     two-process final evaluation's.  (d) tensor parallelism in (a)'s
     processes (dp_dryrun.py's tp leg) on the (1, TP_MODEL) mesh: the same
     STEPS steps from the same state, the model sharded by
     parallel/tp.py::shard_state, against the one-process step: metrics
     within DP_LOSS_REL, the replicated leaves the same bits on both
     processes, the gathered sharded leaves against the one-process state
     (frozen ones bit for bit; the trained ones' update cosine printed
     beside a rounding control's), step 1's gradient cosine by LR group >=
     0.99 (4b's bar between two paths), each
     sharded leaf half of the whole, #1 L-1 a step a process at H /
     TP_MODEL heads, device ms, peak memory and the model all-reduces' count
     and ms printed; then the fused-stream embed (use_pallas_attention,
     use_fused_mlp, use_fused_resln) of a seeded uint8 batch of BATCH under
     (1, TP_MODEL) against one process: min-cosine >= 0.999, #1 L, #8 L
     and #9 2L a process;
  4j. the CLIP ViT-L/14 and ViT-B/32 presets at full width
     (apply_model_preset: L/14 24 blocks of 1,024, 16 heads, MLP 4,096,
     patch 14, 257 tokens at 224 px; text 768 x 12; fusion 768; the SDM
     module at the fusion width, 768, where the preset leaves 512: neither
     package trains the preset as it stands).  (a) The
     L/14 model from init_params(seed=0, perturb=True), bf16, embeds one
     seeded uint8 batch of BATCH vis images under PRESET_PATHS (xla,
     use_pallas_attention, the fused-stream trunk, block_impl fused, splash,
     fused_int8): min-cosine against xla >= 0.999 (fused_int8:
     APPROX_MIN_COSINE), exact launch counts (#1 23, on the fused-stream
     trunk 24; #8 24, #9 48; #3 and #5 23 under fused; splash 23 and #1 23;
     #4 and #6 23), the device ms of a step (CUDA events), embeds/s and peak
     memory a path.  (a') The same embed at 336 px (577 tokens; the position
     embeddings drawn anew at 577 rows) of a batch of PRESET_336_BATCH
     under PRESET_336_PATHS (xla, use_pallas_attention, the fused-stream
     trunk): min-cosine against xla >= 0.999, exact launch counts (#1 23,
     24), device ms and peak memory.  (b) Phase 4b's 8x4 step at L/14 under
     use_pallas_attention against xla: step-1 losses within TRAIN_LOSS_REL,
     each group's gradient cosine >= TRAIN_GRAD_COS, #1 23 launches at S =
     257 and no host synchronisation in a step; it/s, device ms and peak
     memory of each.  (c) An HF-layout checkpoint at L/14's widths
     (hf_clip_checkpoint) written as safetensors and loaded through
     clip_weights_path as the trainer loads it, embedded on the fused-stream
     trunk against clip_vision_oracle: min-cosine >= 0.999, #1 24, #8 24,
     #9 48.  (d) The B/32 model (50 tokens: #1's shortest branch) under
     B32_PATHS: min-cosine >= 0.999, exact launch counts;
  4k. OpenCLIP ViT-H/14's widths at full depth (VIT_H: TrainingConfig
     overrides, no preset: vision 32 blocks of 1,280, 16 heads of 80, MLP
     5,120, patch 14, 257 tokens; text 1,024 x 24; fusion and SDM 1,024),
     seeded weights from init_params(seed=0, perturb=True), bf16.  (a) The
     embed of one seeded uint8 batch of BATCH vis images under PRESET_PATHS:
     min-cosine against xla >= 0.999 (fused_int8: APPROX_MIN_COSINE), exact
     launch counts (#1 31, on the fused-stream trunk 32; #8 32, #9 64; #3
     and #5 31 under fused; splash 31 and #1 31; #4 and #6 31), device ms,
     embeds/s and peak memory a path.  (b) Phase 4b's 8x4 step under
     remat_blocks on VIT_H_TRAIN_PATHS (xla, pallas_attention): step 1's
     losses and gradients finite, pallas_attention against xla within
     TRAIN_LOSS_REL and TRAIN_GRAD_COS, #1 2L = 64 launches a step and no
     host synchronisation in it; it/s, device ms and peak memory;
  5. time every kernel, its plain version and (where one PyTorch call
     computes the same function) that call with CUDA events, median of
     TIMED_RUNS after warm-up queued behind a spin kernel (device time
     only), beside the least time the card could take (attention and the
     fused MLP also at token reduction's and tensor parallelism's shapes;
     #1, #11, #3, #5, #8 and #9 at the L/14 preset's, #1 also at 577
     tokens, the launches a forward of 4j (a) and (a') beside each; #1's
     register-held kernel at 257 and 577 tokens also in the kernels line;
     #1 (beside SDPA), #3, #5, #8 and #9 at ViT-H/14's widths with 4k (a)'s
     launches, #1 there also in the kernels line);
     time end-to-end embeds/s per configuration (in turns, median of
     E2E_ROUNDS rounds) and the device ms of one embed step of each from
     CUDA events, with torch.profiler's top kernels (its kernel sum, which
     reads low late in the process, printed beside the events' reading: so
     in every phase that reads device ms);
  6. run the roofline probes of tools_torch/perf_microbench.py that measure
     the card's own rates at the model's matmul shape: xla_bf16 (cuBLAS),
     xla_int8 (torch._int_mm), pallas_bf16, pallas_int8 and pallas_sweep (the
     port's tiled matmul), bw (copy bandwidth) and floor (the per-launch
     floor); a probe that raises fails the run.

Results go to standard output; the line before the last is the JSON
``{"kernels": [...]}``, the last line ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REL_TOL = 2e-3  # measured <= 3.5e-4 on an H100 (PERF.md)
ABS_TOL = 5e-2
# the int8 kernels against their plain versions: an f32 ulp of difference in an
# LN statistic flips one int8 rounding of a row's LN2 output, which moves h by a
# fraction of its quantization step in every column, re-rounds a share of that
# row's int8 h and moves its outputs by ~0.01-0.02 before the bf16 rounding
# (measured max-abs 0.047, rel <= 9.6e-4 on an H100, PERF.md)
INT8_REL_TOL = 5e-3
INT8_ABS_TOL = 0.125  # two bf16 ulps at |out| in [4, 8)
# the gradients against autograd through the plain versions: both f32
# backwards, but the plain versions' bf16 casts round the gradient flowing
# back through them (and the JAX backwards keep h and P in f32 with the
# exact erf): a few 1e-3 of relative Frobenius error
GRAD_REL_TOL = 1e-2
# #5 at L/14's widths with unit-variance operands (phase 3): its largest
# error in bf16 ulps of the output element, at outputs of magnitude
# UNIT_GATE_MIN and up (below, an output is a cancellation of order-1 terms)
UNIT_MAX_ULPS, UNIT_GATE_MIN = 2, 1.0
# the batch of the register-held attention kernel's edge lengths in phase 3
REG_EDGE_BATCH = 16
MIN_COSINE = 0.999
F32_MIN_COSINE = 0.99
TIMED_RUNS = 25
WARMUP_RUNS = 3
SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's clock: the host enqueues the runs meanwhile
E2E_ITERS = 5
E2E_ROUNDS = 3
TOP_KERNELS = 8
BATCH = 128
NUM_CLASSES = 400
APPROX_MIN_COSINE = 0.99  # int8 plans, serving formulations: JAX's int8 bar through the trunk
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
MM3_QUERY = ("nir", "sk", "cp")
# the ranking gate: bench.py's structured probe set and its promotion bars
RANK_IDS, RANK_PER_ID, RANK_QUERIES = 64, 18, 128
RANK_MIN_OVERLAP, RANK_MAX_MAP_DELTA = 0.97, 0.005
# f32 products of unit 512-vectors summed in another order differ by ~1e-7;
# TF32 (10-bit mantissas) would move them by ~1e-4
SIM_TOL = 1e-5
# the MM-1..4 protocol's synthetic set: uint8 images of one base per id plus
# seeded noise (MM_NOISE grey levels), captions in the CLIP tokenizer's layout
MM_IDS, MM_GALLERY_PER_ID, MM_QUERY_PER_ID = 32, 8, 4
MM_NOISE = 20.0
MM_PATHS = ("xla", "fused_trunk", "fused_int8")
BOS, EOT = 49406, 49407  # CLIP's start and end tokens (EOT: the highest id)
# the training phase: the 8x4 recipe (P ids x K instances, batch 32, no
# accumulation), TRAIN_STEPS steps on one seeded batch; timing: TRAIN_ROUNDS
# rounds of TRAIN_ITERS steps after TRAIN_WARMUP
TRAIN_P, TRAIN_K, TRAIN_STEPS = 8, 4, 10
TRAIN_ROUNDS, TRAIN_ITERS, TRAIN_WARMUP = 2, 5, 2
SDM_WEIGHT, SDM_TAU = 0.1, 0.18
# step 1 of the kernel path against the plain one (the same bf16 model, the
# same dropout masks): the losses, each trainable group's gradient, the norm
TRAIN_LOSS_REL, TRAIN_GRAD_COS, TRAIN_GNORM_REL = 1e-2, 0.99, 0.02
# step 1 at P x K = 2 x 2, no dropout: the card against the CPU in f32 (the
# same arithmetic summed in another order), and the card in bf16 against the
# CPU in f32: the losses within TRAIN_CPU_LOSS_REL, each group's gradient
# cosine no more than TRAIN_BF16_COS_SLACK under the CPU's own bf16 run's
# (bf16 rounding through 12 blocks turns a 4-sample gradient by as much on
# either device: the CPU's reads 0.964 for the LoRA group, PERF.md)
TRAIN_CPU_LOSS_REL, TRAIN_F32_LOSS_REL, TRAIN_F32_GRAD_COS = 2e-2, 1e-4, 0.9999
TRAIN_BF16_COS_SLACK = 0.01
# remat_blocks: its step-1 gradients against the same trunk (every block in
# full) run without recomputation; against the plain trunk (whose last block
# is CLS-only, with folded weights: another bf16 rounding) the cross-path bars
TRAIN_REMAT_REL = 1e-3
NO_RANDOMNESS = dict(drop_path=0.0, dropout_rate=0.0, fusion_dropout=0.0, sdm_dropout=0.0,
                     modality_dropout=0.0)
# the dataset phase: a synthetic ORBench tree (DATA_IDS ids x DATA_ANCHORS
# anchors, DATA_IMG px JPEGs, the host pipeline probe's image size).  Its val
# split (a fifth of the ids) must hold enough queries that bf16 rounding alone
# moves no plan's mAP past RANK_MAX_MAP_DELTA: at 64 ids (52 val records) the
# xla path against the same weights in f32 read |dmAP| up to 0.0114, at 256
# ids (204 records) up to 0.0013 (tools_torch/eval_noise.py, PERF.md).  The
# pipeline alone times PIPE_BATCHES batches after its workers are warm; the
# fed train step runs FEED_STEPS steps, timed after FEED_WARMUP
DATA_IDS, DATA_ANCHORS, DATA_IMG = 256, 4, 256
PIPE_BATCHES, FEED_STEPS, FEED_WARMUP = 8, 10, 2
# the trainer phase: 2 epochs of TRAINER_STEPS steps through the command
# line; the resumed run against the uninterrupted one: the per-epoch losses
# within TRAINER_LOSS_REL, each trainable group's parameters at cosine >=
# TRAINER_COS
TRAINER_STEPS = 10
TRAINER_LOSS_REL, TRAINER_COS = 1e-4, 0.9999
# the eval command line phase: token reduction as docs/training_guide.md's
# recipe sets it (94 patch tokens kept after block 6, merged: blocks 6-10 run
# at S_RED tokens, 95 with 'prune'); the reduced runs' query plans sampled at
# E_SAMPLE; the CLI's aggregates against the trainer's within CLI_METRIC_TOL;
# the block kernels' plan on the reduced trunk against the default path at
# TOKEN_FUSED_MIN_COSINE (a keep set is a discrete choice that bf16 rounding
# can flip; the 0.999 reading is printed).  Re-ranking at the competition's
# scale: RR_GALLERY x 512 f32 (the ORBench RGB count) of RR_IDS ids,
# RR_QUERIES queries, each query chunk size of RR_CHUNKS; the card against
# the CPU on RR_CPU_QUERIES queries: RR_SAME_ROWS of the rows equal, |dmAP|
# <= RR_MAP_TOL
TOKEN_KEEP, TOKEN_LAYER = 94, 6
S_RED = TOKEN_KEEP + 2
E_SAMPLE = 0.25
CLI_METRIC_TOL = 1e-5
TOKEN_FUSED_MIN_COSINE = 0.99
RR_GALLERY, RR_IDS, RR_QUERIES, RR_CPU_QUERIES = 45113, 1000, 4096, 256
# tune_rerank's difficulties are set for 64-d features; at 512-d its "mid"
# sigmas put plain mAP at 1.0 (nothing for re-ranking to do, and 45 items an
# id packed so tight that f32 distance ties decide the k-reciprocal sets:
# PERF.md §6).  These put plain mAP in the mid band (0.62 on 256 queries)
RR_SIGMAS = dict(sigma_g=2.2, sigma_q=2.4)
RR_CHUNKS = (128, 256, 512, 1024)
RR_SAME_ROWS, RR_MAP_TOL = 0.99, 1e-4
# the serving phase: the server's re-ranking parameters (the CLI's defaults);
# SERVE_QUERIES clustered queries against phase 4e (f)'s RR_GALLERY x 512 set;
# SERVE_CONCURRENT one-image requests at once; SERVE_LATENCY_N requests a route
# for the latency percentiles; the MM-2/3/4 combos served as /embed queries;
# bench_query.py's calls a timed round; --images against embed_samples: bit
# for bit, or SERVE_MIN_COSINE with the cause found
SERVE_RR = dict(top_n=100, k1=20, k2=6, lam=0.3)
SERVE_QUERIES, SERVE_CONCURRENT, SERVE_LATENCY_N, SERVE_BQ_ITERS = 256, 32, 25, 5
MM_SERVE_COMBOS = (("nir", "text"), ("sk", "cp", "text"), ("nir", "sk", "cp"),
                   ("nir", "sk", "cp", "text"))
SERVE_MIN_COSINE = 0.9999
# phase 4g, training from CLIP weights: the oracle's batch, the trainer's
# evaluated plans, CLIP_ROUNDS rounds of CLIP_ITERS steps a remat policy in
# turns, the probe's and the harness's step counts
CLIP_ORACLE_BATCH = 32
CLIP_EVAL_PLANS = ("single/nir", "quad/nir+sk+cp+text")
CLIP_ROUNDS, CLIP_ITERS = 1, 3
CLIP_PROBE_STEPS, CLIP_DRYRUN_STEPS = 10, 3
# phase 4h, the tools: trace_embed.py's paths at BATCH (their CUDA events held
# within TOOL_DEVICE_SPREAD of phase 5's reading of the same path), the host
# benchmark's samples, the bundle's graphs and batch (its features against
# the live engine: bit for bit, or BUNDLE_MIN_COSINE with the cause found),
# the ops' host cost a call over DISPATCH_CALLS calls.  trace_train.py's
# traced run, train_ab.py and flagship_train_probe.py are cut from the script
# for time (PERF.md: their card runs are standalone; toolchain_watch.py runs
# trace_train.py --no-trace here)
TRACE_PATHS = {"fused": ["--block-impl", "fused"], "splash": ["--attn-backend", "splash"]}
TRACE_ITERS, TOOL_DEVICE_SPREAD = 2, 0.10
HOST_SAMPLES = 25
BUNDLE_GRAPHS, BUNDLE_BATCH, BUNDLE_N = "gallery_vis,text,quad,combo_nir+text", 8, 64
BUNDLE_LATENCY_N = 25
BUNDLE_MIN_COSINE = 0.99999
DISPATCH_CALLS = 250
# phase 4i, data parallel: DP_PROCS processes share the one card over gloo
# (NCCL refuses two ranks on a device).  (a) tools_torch/dp_dryrun.py's
# global-batch steps of the 8x4 recipe (pallas_attention, drop-path 0.1)
# against the one-process step, the metrics within DP_LOSS_REL (bf16; the
# products' M differs between the runs); (b) its sharded_topk, 1,024
# queries against a 45,113 x 512 gallery split over the processes, top 100;
# (c) tools_torch/train.py as DP_PROCS processes, 1 epoch of DP_CLI_STEPS
# steps and the final evaluation, whose aggregate mAPs this process's
# evaluation of the saved checkpoint holds within RANK_MAX_MAP_DELTA; each
# group within DP_TIMEOUT seconds
DP_PROCS, DP_LOSS_REL, DP_CLI_STEPS, DP_TIMEOUT = 2, 2e-3, 2, 600
# (d) tensor parallelism on the (1, DP_PROCS) mesh, in (a)'s processes
# (tools_torch/dp_dryrun.py's tp leg): the model axis shards each block's
# heads and MLP in two, so #1 runs at H / TP_MODEL heads and #8 at F /
# TP_MODEL; phase 3 holds both kernels at those shapes, phase 5 times them
TP_MODEL = DP_PROCS
# a tools_torch/train.py process that prints its launch counts when it ends
DP_CLI = ("import json, runpy, sys; ns = runpy.run_path(sys.argv[1], run_name='train_cli'); "
          "ns['main'](sys.argv[2:]); "
          "from prcv2025reid_tpu_torch.ops.library import launch_counts; "
          "print('launches ' + json.dumps(launch_counts()))")
MATMUL_ROWS = (25344, 6304)  # the microbenchmark's M, and a multiple of no row tile
MICROBENCH = ("xla_bf16", "xla_int8", "pallas_bf16", "pallas_int8", "pallas_sweep", "bw",
              "floor")
# the embed paths of phase 4 (and those of 4j, by the same names): each one's
# config overrides
EMBED_PATHS = {
    "xla": {},
    "fused": dict(block_impl="fused"),
    "pallas_attention": dict(use_pallas_attention=True),
    "fused_mlp": dict(use_fused_mlp=True),
    "fused_trunk": dict(use_fused_resln=True, use_fused_mlp=True, use_pallas_attention=True),
    # the fused-stream trunk with the plain MLP: what the MLP kernel costs it
    "fused_resln": dict(use_fused_resln=True, use_pallas_attention=True),
    "fused_qkv": dict(block_impl="fused_qkv"),
    "splash": dict(attn_backend="splash"),
    "fused_int8": dict(block_impl="fused_int8"),
    "fused_int8_mlp": dict(block_impl="fused_int8_mlp"),
    "onesaug": dict(attn_backend="onesaug"),
    "gelu_tanh": dict(gelu_impl="tanh"),
    "gelu_poly": dict(gelu_impl="poly"),
}
# held at APPROX_MIN_COSINE, their 0.999 reading printed
APPROX_PATHS = ("fused_int8", "fused_int8_mlp", "onesaug", "gelu_tanh", "gelu_poly")
# phase 4j, the CLIP ViT-L/14 and ViT-B/32 presets at full width: (a) the L/14
# embed of BATCH images under PRESET_PATHS, PRESET_ITERS embeds a path for
# embeds/s; (b) phase 4b's 8x4 step at L/14, PRESET_TRAIN_ITERS timed steps a
# path; (c) an HF-layout checkpoint at L/14's widths through
# clip_weights_path; (d) the B/32 embed under B32_PATHS
PRESET_L14, PRESET_B32 = "clip-vit-large-patch14", "clip-vit-base-patch32"
PRESET_PATHS = ("xla", "pallas_attention", "fused_trunk", "fused", "splash", "fused_int8")
B32_PATHS = ("xla", "pallas_attention", "fused_trunk")
PRESET_ITERS, PRESET_TRAIN_ITERS = 3, 3
# (a') the L/14 embed at 336 px (577 tokens)
PRESET_336_PATHS, PRESET_336_BATCH = ("xla", "pallas_attention", "fused_trunk"), 32
# #1 past 256 tokens in phases 3 and 5: L/14 at 336 px beside 224 px's 257
S_L14_336 = (336 // 14) ** 2 + 1
# phase 4k: OpenCLIP ViT-H/14's widths (open_clip model_configs/ViT-H-14.json:
# vision 1,280 wide, 32 layers, heads of 80, MLP 5,120, patch 14 at 224 px;
# text 1,024 x 24, 16 heads; embed 1,024) as the TrainingConfig overrides a
# user passes as flags, the SDM module at the fusion width so that it trains.
# (a) the embed of BATCH vis images under PRESET_PATHS; (b) phase 4b's 8x4
# step under remat_blocks on VIT_H_TRAIN_PATHS, VIT_H_TRAIN_ITERS timed
# steps a path
VIT_H = dict(vision_hidden_dim=1280, vision_layers=32, vision_heads=16, vision_mlp_dim=5120,
             patch_size=14, image_size=224, text_hidden_dim=1024, text_layers=24,
             text_heads=16, text_mlp_dim=4096, fusion_dim=1024, sdm_semantic_dim=1024)
VIT_H_TRAIN_PATHS = ("xla", "pallas_attention")
VIT_H_TRAIN_ITERS = 2
# phase 3's grid of #1: every padded head width (64, 128, 192, 256), the
# zero-padded widths (20: no multiple of 8), ViT-H/14's 80, ViT-bigG's 104;
# each route's edge lengths (causal at the text tower's 77) on ATT_GRID_BH
# (batch, head) pairs, and past 4,096 tokens at LONG_SEQ_DH
HEAD_WIDTHS = (8, 16, 20, 40, 72, 80, 96, 104, 128, 200, 256)
ROUTE_EDGES = ((1, False), (77, True), (197, False), (256, False), (257, False), (577, False),
               (656, False), (657, False))
ATT_GRID_BH = (2, 3)
LONG_SEQS, LONG_SEQ_DH = (4097, 16385), (64, 128)
# the row passes past 1,024 columns (#3-#9 on ROW_ROWS rows): a lane's 8
# chunks (1,040 .. 2,048) and a block's row (2,056, 8,192); the int8 plans
# take multiples of 16 only
ROW_WIDTHS, ROW_ROWS = (1040, 1280, 1664, 2048, 2056, 8192), 300


def fail(msg: str) -> "NoReturn":  # noqa: F821
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def load_tool(name: str):
    """tools_torch/<name>.py as a module, loaded by path under a name of its
    own (the JAX package's tools/ holds modules of the same names)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"tools_torch_{name}", Path(__file__).resolve().parent / "tools_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bound_ms(work, nbytes: float):
    """The least time for ``work``, [(operations, peak rate of their type),
    ...], and ``nbytes`` of traffic: the larger of the two times."""
    t_ops, t_bytes = sum(n / peak for n, peak in work), nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def path_launches(L: int):
    """Each embed path's kernel launches in one forward of an L-block trunk:
    blocks 0 .. L - 2 in full, the CLS-only last block on the plain path;
    the fused-stream trunk runs all L in full."""
    return {
        "xla": {},
        "fused": {"fused_ln_qkv": L - 1, "fused_out_mlp": L - 1},
        "pallas_attention": {"fused_mha": L - 1},
        "fused_mlp": {"fused_mlp": L - 1},
        "fused_trunk": {"fused_mha": L, "fused_mlp": L, "fused_residual_ln": 2 * L},
        "fused_resln": {"fused_mha": L, "fused_residual_ln": 2 * L},
        "fused_qkv": {"fused_ln_qkv": L - 1},
        # the splash core launches the attention kernel once per call
        "splash": {"splash_attention_bshd": L - 1, "fused_mha": L - 1},
        "fused_int8": {"fused_ln_qkv_int8": L - 1, "fused_out_mlp_int8": L - 1},
        "fused_int8_mlp": {"fused_ln_qkv": L - 1, "fused_out_mlp_int8mlp": L - 1},
        # the serving formulations are plain PyTorch
        "onesaug": {},
        "gelu_tanh": {},
        "gelu_poly": {},
    }


def block_cases(torch, gen, dev, G, N, D, F):
    """(name, kernel, plain version, operands) of #3-#9 on G groups of N rows
    of width D, MLP width F: bf16 activations, weights scaled as the model's,
    f32 LayerNorm parameters and biases (bf16 for the fused MLP, as the
    model casts them), the int8 weights quantized as MERBlock does; the
    residual+LN pass on the first group's rows.  The residual stream and the
    attention output have std 0.5, so the outputs are of order 1, where
    ABS_TOL is a few bf16 ulps: with unit inputs #5's output x + out-proj +
    MLP has std 1.6 and, over 33.7M values, passes 8, where one bf16 ulp
    (0.0625) is above ABS_TOL (an H100 read one such one-ulp flip, PERF.md)."""
    from prcv2025reid_tpu_torch.ops import fused_block as fb
    from prcv2025reid_tpu_torch.ops.fused_mlp import fused_mlp, mlp_plain
    from prcv2025reid_tpu_torch.ops.fused_resln import fused_residual_ln, resln_plain

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    x, attn = randn(G, N, D, scale=0.5).bfloat16(), randn(G, N, D, scale=0.5).bfloat16()
    lns, lnb = 1 + 0.1 * randn(D), 0.1 * randn(D)
    wqkv, bqkv = randn(G, D, 3 * D, scale=D**-0.5).bfloat16(), 0.1 * randn(G, 3 * D)
    wo, bo = randn(G, D, D, scale=D**-0.5).bfloat16(), 0.1 * randn(G, D)
    w1, b1 = randn(G, D, F, scale=D**-0.5).bfloat16(), 0.1 * randn(G, F)
    w2, b2 = randn(G, F, D, scale=F**-0.5).bfloat16(), 0.1 * randn(G, D)
    q_wqkv, q_wo, q_w1, q_w2 = (fb.quantize_weight(w) for w in (wqkv, wo, w1, w2))
    tail8 = (lns, lnb, *q_w1, b1, *q_w2, b2)
    at = f"D={D} F={F}" + (f" G={G}" if G > 1 else f" T={N}")
    cases = [
        (f"fused_ln_qkv {at}", fb.fused_ln_qkv, fb.ln_qkv_plain, (x, lns, lnb, wqkv, bqkv)),
        (f"fused_out_mlp {at}", fb.fused_out_mlp, fb.out_mlp_plain,
         (attn, x, wo, bo, lns, lnb, w1, b1, w2, b2)),
        (f"fused_mlp {at}", fused_mlp, mlp_plain, (x, w1, b1.bfloat16(), w2, b2.bfloat16())),
        (f"fused_ln_qkv_int8 {at}", fb.fused_ln_qkv_int8, fb.ln_qkv_int8_plain,
         (x, lns, lnb, *q_wqkv, bqkv)),
        (f"fused_out_mlp_int8 {at}", fb.fused_out_mlp_int8, fb.out_mlp_int8_plain,
         (attn, x, *q_wo, bo, *tail8)),
        (f"fused_out_mlp_int8mlp {at}", fb.fused_out_mlp_int8mlp, fb.out_mlp_int8mlp_plain,
         (attn, x, wo, bo, *tail8)),
    ]
    if G == 1:
        resln = (x[0], attn[0], lns, lnb)
        cases += [(f"fused_residual_ln xn {at}", lambda *a: fused_residual_ln(*a)[0],
                   lambda *a: resln_plain(*a)[0], resln),
                  (f"fused_residual_ln y {at}", lambda *a: fused_residual_ln(*a)[1],
                   lambda *a: resln_plain(*a)[1], resln)]
    return cases


def time_ms(torch, fn, runs=TIMED_RUNS):
    """Median device time of ``fn()`` over ``runs`` launches (CUDA events
    around each).  A spin kernel queued first keeps the card busy while the
    host enqueues the runs, so the host's time between launches (longer
    than a 60 us kernel) is not timed."""
    for _ in range(WARMUP_RUNS):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    pairs = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_time(event) -> float:
    """Device (CUDA) self time of a profiler row in microseconds."""
    t = getattr(event, "self_device_time_total", None)
    return t if t is not None else event.self_cuda_time_total


def device_reading(torch, fn, label: str):
    """The device ms of one ``fn()`` from CUDA events
    (``utils/timing.device_ms``: queued behind a spin kernel, so the span is
    the device's), and torch.profiler's rows of another call, kept for their
    lists of the top kernels: their kernel sum reads low late in this
    process.  Both readings are printed.  ``fn`` runs three times; one that
    synchronises the host inside reads its span, host gaps included.
    Returns (events ms, profiler kernel-sum ms, kernel rows, all rows)."""
    from torch.profiler import ProfilerActivity, profile

    from prcv2025reid_tpu_torch.utils.timing import device_ms

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    kernels = [e for e in rows
               if e.device_type == torch.autograd.DeviceType.CUDA and device_time(e) > 0]
    prof_ms = sum(device_time(e) for e in kernels) / 1e3
    events_ms = device_ms(fn)
    print(f"device ms {label}: CUDA events {events_ms:.4f}, torch.profiler's kernel sum "
          f"{prof_ms:.4f} ({len(kernels)} kernels)")
    return events_ms, prof_ms, kernels, rows


def bf16_ulps(torch, got, want):
    """|got - want| in bf16 ulps of each element of ``want`` (a bf16 tensor):
    the spacing of bf16 values at |want|, 2^(e - 8) for |want| in
    [2^(e - 1), 2^e) (2^-8 where want is 0)."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), (e - 8).clamp(min=-133))
    return (got.float() - w).abs() / ulp


def errors(torch, got, want, rel_tol=REL_TOL, abs_tol=ABS_TOL):
    d = got.float() - want.float()
    rel = (d.norm() / want.float().norm()).item()
    mx = d.abs().max().item()
    if not (torch.isfinite(got.float()).all() and rel <= rel_tol and mx <= abs_tol):
        return mx, rel, False
    return mx, rel, True


def rank_probe_images(size: int):
    """bench.py's structured retrieval set, built as bench.py builds it: one
    f32-normal base image per id plus 0.15-scaled noise per instance (fed
    as already-normalised images)."""
    import numpy as np

    rng = np.random.default_rng(0)
    base = rng.normal(0, 1, (RANK_IDS, size, size, 3)).astype(np.float32)
    g_pids = np.repeat(np.arange(RANK_IDS), RANK_PER_ID)
    gallery = base[g_pids] + 0.15 * rng.normal(0, 1, (len(g_pids), size, size, 3)).astype(
        np.float32)
    q_pids = rng.integers(0, RANK_IDS, RANK_QUERIES)
    queries = base[q_pids] + 0.15 * rng.normal(0, 1, (RANK_QUERIES, size, size, 3)).astype(
        np.float32)
    return gallery, g_pids, queries, q_pids


def mm_query_set(torch, cfg, dev):
    """The MM protocol's synthetic set on the card: a vis gallery [MM_IDS *
    MM_GALLERY_PER_ID] and MM_IDS * MM_QUERY_PER_ID queries with nir, sk and
    cp images (vis masked) and one caption each: BOS, a per-id caption with
    a fifth of its words redrawn per query, EOT, zero padding."""
    gen = torch.Generator(device=dev).manual_seed(7)
    size, Mv = cfg.image_size, len(cfg.vision_modalities)
    base = torch.randint(0, 256, (MM_IDS, size, size, 3), generator=gen, device=dev,
                         dtype=torch.uint8)

    def noisy(pids):
        n = torch.randn(len(pids), size, size, 3, generator=gen, device=dev) * MM_NOISE
        return (base[pids].float() + n).round().clamp(0, 255).to(torch.uint8)

    g_pids = torch.arange(MM_IDS, device=dev).repeat_interleave(MM_GALLERY_PER_ID)
    q_pids = torch.arange(MM_IDS, device=dev).repeat_interleave(MM_QUERY_PER_ID)
    nq, ctx = len(q_pids), cfg.text_context_length
    q_images = torch.zeros(nq, Mv, size, size, 3, dtype=torch.uint8, device=dev)
    for slot in range(1, Mv):  # nir, sk, cp
        q_images[:, slot] = noisy(q_pids)
    q_mask = torch.ones(nq, Mv, device=dev)
    q_mask[:, 0] = 0.0
    lengths = torch.randint(8, ctx + 1, (MM_IDS,), generator=gen, device=dev)
    words = torch.randint(1, BOS, (MM_IDS, ctx), generator=gen, device=dev)
    redraw = torch.rand(nq, ctx, generator=gen, device=dev) < 0.2
    tokens = torch.where(redraw, torch.randint(1, BOS, (nq, ctx), generator=gen, device=dev),
                         words[q_pids])
    pos = torch.arange(ctx, device=dev)[None]
    length = lengths[q_pids][:, None]
    tokens = torch.where(pos == 0, BOS, torch.where(pos == length - 1, EOT, tokens))
    tokens = torch.where(pos >= length, 0, tokens)
    return dict(g_images=noisy(g_pids), g_pids=g_pids, q_images=q_images, q_mask=q_mask,
                tokens=tokens, text_mask=torch.ones(nq, device=dev), q_pids=q_pids)


def train_batch(torch, cfg, dev, P, K, seed):
    """P ids x K instances on the card: four uint8 images a sample (one base
    image per id and modality plus MM_NOISE grey levels of noise), all masks
    1, one caption a sample (a per-id token row with a fifth of its words
    redrawn; BOS ... EOT, zero padding), labels = pids = each id K times."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    size, Mv, ctx = cfg.image_size, len(cfg.vision_modalities), cfg.text_context_length
    pids = torch.arange(P, device=dev).repeat_interleave(K)
    base = torch.randint(0, 256, (P, Mv, size, size, 3), generator=gen, device=dev,
                         dtype=torch.uint8)
    noise = torch.randn(P * K, Mv, size, size, 3, generator=gen, device=dev) * MM_NOISE
    images = (base[pids].float() + noise).round().clamp(0, 255).to(torch.uint8)
    lengths = torch.randint(8, ctx + 1, (P,), generator=gen, device=dev)[pids][:, None]
    words = torch.randint(1, BOS, (P, ctx), generator=gen, device=dev)[pids]
    redraw = torch.rand(P * K, ctx, generator=gen, device=dev) < 0.2
    tokens = torch.where(redraw, torch.randint(1, BOS, (P * K, ctx), generator=gen, device=dev),
                         words)
    pos = torch.arange(ctx, device=dev)[None]
    tokens = torch.where(pos == 0, BOS, torch.where(pos == lengths - 1, EOT, tokens))
    tokens = torch.where(pos >= lengths, 0, tokens)
    B = P * K
    return dict(images=images, image_mask=torch.ones(B, Mv, device=dev), text_tokens=tokens,
                text_mask=torch.ones(B, device=dev), labels=pids, pids=pids)


def group_grads(torch, model, cfg, batch):
    """Step 1's losses and its gradient per trainable group (the step's own
    generators: seed 0, step 0): ({loss: float}, {group: flat f32 tensor})."""
    from prcv2025reid_tpu_torch.training.param_groups import freeze, label_params
    from prcv2025reid_tpu_torch.training.train_step import loss_and_grads, step_generators

    trainable = freeze(model, cfg)
    labels = label_params(model, cfg)
    dev = model.null_tokens.device
    losses, _, _, grads = loss_and_grads(model, cfg, [p for _, p in trainable], batch,
                                         SDM_WEIGHT, SDM_TAU,
                                         generators=step_generators(0, 0, dev))
    by_group = {}
    for (name, _), g in zip(trainable, grads):
        by_group.setdefault(labels[name], []).append(g.detach().float().flatten().cpu())
    return ({k: float(losses[k].detach()) for k in ("total_loss", "ce_loss", "sdm_loss")},
            {k: torch.cat(v) for k, v in by_group.items()})


def readings_ops(events):
    return {e.key: round(device_time(e) / 1e3, 3) for e in events}


def compare_grads(torch, got, want):
    """(per-group cosine, per-group relative error, global-norm ratio), in
    f64 (an f32 dot over millions of entries can read a cosine above 1)."""
    got = {g: t.double() for g, t in got.items()}
    want = {g: t.double() for g, t in want.items()}
    cos = {g: float(got[g] @ want[g] / (got[g].norm() * want[g].norm())) for g in want}
    rel = {g: float((got[g] - want[g]).norm() / want[g].norm()) for g in want}
    norm = float(torch.cat(list(got.values())).norm() / torch.cat(list(want.values())).norm())
    return cos, rel, norm


def counted_step(torch, counters, label, step, state, b, want):
    """One train step with every counter zeroed just before it; fails unless
    the counts read ``want`` and no host synchronisation happened in it."""
    import warnings

    for counter in counters.values():
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state, m = step(state, b, SDM_WEIGHT, SDM_TAU)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message).lower()]
    if syncs:
        fail(f"train step {label}: {len(syncs)} host synchronisations inside the step: "
             f"{syncs[:3]}")
    got = {n: f.launches for n, f in counters.items()}
    want = {n: want.get(n, 0) for n in counters}
    print(f"train {label}: launches in one step {got} (expected {want}); "
          f"no host synchronisation inside the step")
    if got != want:
        fail(f"train {label}: launch counts {got} != {want}")
    return state, m


def train_phase(torch, cfg, params, counters, dev, card):
    """The training step at full width on the card (see the module
    docstring, phase 4b); fails the run on any failed check and returns
    the readings."""
    from prcv2025reid_tpu_torch import build_model, init_train_state, make_train_step
    from prcv2025reid_tpu_torch.data.device_feed import normalize_images_device
    from prcv2025reid_tpu_torch.training.param_groups import label_params

    L = cfg.vision_layers
    tcfg = cfg.replace(num_ids_per_batch=TRAIN_P, instances_per_id=TRAIN_K)
    if tcfg.accum_steps != 1 or tcfg.compute_dtype != "bfloat16" or not tcfg.freeze_backbone:
        fail(f"the 8x4 recipe is bf16, frozen backbone, no accumulation: {tcfg}")
    batch = train_batch(torch, cfg, dev, TRAIN_P, TRAIN_K, seed=11)
    paths = {"xla": tcfg, "pallas_attention": tcfg.replace(use_pallas_attention=True)}
    expected = {"xla": {}, "pallas_attention": {"fused_mha": L - 1}}

    readings, first = {}, {}
    for name, pcfg in paths.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()  # the eval models of phase 4
        model = build_model(pcfg, params, device=dev)
        first[name] = group_grads(torch, model, pcfg, batch)
        state = init_train_state(model, pcfg, 1, seed=0)
        step = make_train_step(model, pcfg, 1)
        trainable = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
        frozen = {n: p.detach().clone() for n, p in model.named_parameters()
                  if not p.requires_grad}
        bn0 = [model.bn_neck.bn.mean.clone(), model.bn_neck.bn.var.clone()]
        state, m = counted_step(torch, counters, name, step, state, batch,
                                expected[name])
        history = [m]
        for _ in range(TRAIN_STEPS - 1):
            state, m = step(state, batch, SDM_WEIGHT, SDM_TAU)
            history.append(m)
        hist = {k: torch.stack([h[k] for h in history]).tolist() for k in m}
        print(f"train {name}: {TRAIN_STEPS} steps, total_loss "
              + " ".join(f"{v:.4f}" for v in hist["total_loss"]))
        finite = all(torch.isfinite(torch.tensor(hist[k])).all()
                     for k in ("total_loss", "ce_loss", "sdm_loss", "grad_norm"))
        if not finite or any(hist["skipped"]):
            fail(f"train {name}: a non-finite loss or a skipped step: {hist}")
        if not hist["total_loss"][-1] < hist["total_loss"][0]:
            fail(f"train {name}: the loss did not fall in {TRAIN_STEPS} steps: {hist['total_loss']}")
        named = dict(model.named_parameters())
        moved_frozen = [n for n, p in frozen.items() if not torch.equal(named[n], p)]
        if moved_frozen:
            fail(f"train {name}: frozen parameters moved: {moved_frozen[:5]}")
        labels = label_params(model, pcfg)
        moved = {}
        for n, p0 in trainable.items():
            moved[labels[n]] = moved.get(labels[n], False) or not torch.equal(named[n], p0)
        bn_moved = not (torch.equal(model.bn_neck.bn.mean, bn0[0]) and
                        torch.equal(model.bn_neck.bn.var, bn0[1]))
        print(f"train {name}: frozen parameters unchanged ({len(frozen)} tensors); groups moved "
              f"{moved}; BN running statistics moved {bn_moved}")
        if not all(moved.values()) or not bn_moved:
            fail(f"train {name}: a trainable group or the BN statistics did not move")

        # a poisoned step: one NaN pixel in a float batch skips everything
        bad = dict(batch)
        bad["images"] = normalize_images_device(batch["images"]).clone()
        bad["images"][0, 0, 0, 0, 0] = float("nan")
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt_before = [t.clone() for t in state.opt_state.tensors()]
        skipped_before = int(state.skipped_total)
        state, m = step(state, bad, SDM_WEIGHT, SDM_TAU)
        kept = all(torch.equal(v, before[k]) for k, v in model.state_dict().items()) and all(
            torch.equal(a, c) for a, c in zip(state.opt_state.tensors(), opt_before))
        print(f"train {name}: poisoned step skipped {float(m['skipped'])}, skipped_total "
              f"{skipped_before} -> {int(state.skipped_total)}, params, optimizer state and BN "
              f"statistics bit for bit {kept}")
        if float(m["skipped"]) != 1.0 or not kept or int(state.skipped_total) != skipped_before + 1:
            fail(f"train {name}: the poisoned step was not skipped cleanly")

        # timing: median of TRAIN_ROUNDS rounds of TRAIN_ITERS steps
        for _ in range(TRAIN_WARMUP):
            state, m = step(state, batch, SDM_WEIGHT, SDM_TAU)
        rates = []
        for _ in range(TRAIN_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_ITERS):
                state, m = step(state, batch, SDM_WEIGHT, SDM_TAU)
            torch.cuda.synchronize()
            rates.append(TRAIN_ITERS / (time.perf_counter() - t0))
        it_s = statistics.median(rates)
        held = [state]

        def one_step():
            held[0], _ = step(held[0], batch, SDM_WEIGHT, SDM_TAU)

        device_ms, prof_ms, events, prof_rows = device_reading(torch, one_step, f"train {name}")
        state = held[0]
        wall_ms = 1e3 / it_s
        top = sorted(events, key=device_time, reverse=True)[:TOP_KERNELS]
        # the profiler's device time by the PyTorch op that launched it
        ops = [e for e in prof_rows if e.device_type == torch.autograd.DeviceType.CPU
               and e.key.startswith("aten::") and device_time(e) > 0]
        top_ops = sorted(ops, key=device_time, reverse=True)[:2 * TOP_KERNELS]
        peak_gb = (torch.cuda.max_memory_allocated() - resident) / 1e9
        readings[name] = dict(
            it_per_s=it_s, samples_per_s=it_s * TRAIN_P * TRAIN_K, rounds_it_per_s=rates,
            device_ms=device_ms, profiler_ms=prof_ms, wall_ms=wall_ms,
            idle_share=1 - device_ms / wall_ms,
            peak_mem_gb=peak_gb, launches_per_step=expected[name].get("fused_mha", 0),
            top_ops_ms=readings_ops(top_ops),
            total_loss=hist["total_loss"], step1=first[name][0])
        print(f"train {name} ({card}): {it_s:.3f} it/s, {it_s * TRAIN_P * TRAIN_K:.1f} samples/s "
              f"(rounds {[round(r, 3) for r in rates]}); device {device_ms:.3f} ms of "
              f"{wall_ms:.3f} ms a step (idle share {1 - device_ms / wall_ms:.3f}) in "
              f"{len(events)} kernels; peak memory {peak_gb:.2f} GB over {resident / 1e9:.2f} GB "
              f"resident; top ops (device ms): {json.dumps(readings_ops(top_ops))}; top kernels: "
              + json.dumps(
                  [[e.key[:60], e.count, round(device_time(e) / 1e3, 4)] for e in top]))
        del model, state, step, trainable, frozen, before, opt_before
        torch.cuda.empty_cache()

    # step 1 of the kernel path against the plain path
    (l_x, g_x), (l_p, g_p) = first["xla"], first["pallas_attention"]
    loss_rel = {k: abs(l_p[k] - l_x[k]) / abs(l_x[k]) for k in l_x}
    cos, rel, norm = compare_grads(torch, g_p, g_x)
    print(f"train step 1 pallas_attention vs xla: loss rel {json.dumps(loss_rel)} "
          f"(<= {TRAIN_LOSS_REL}); gradient cosine by group {json.dumps(cos)} "
          f"(>= {TRAIN_GRAD_COS}); global norm ratio {norm:.5f} (within {TRAIN_GNORM_REL})")
    if max(loss_rel.values()) > TRAIN_LOSS_REL or min(cos.values()) < TRAIN_GRAD_COS or \
            abs(norm - 1) > TRAIN_GNORM_REL:
        fail("train step 1: pallas_attention disagrees with xla")
    readings["pallas_vs_xla"] = dict(loss_rel=loss_rel, grad_cos=cos, grad_rel=rel,
                                     norm_ratio=norm)

    # remat_blocks on pallas_attention: every block in full, each recomputed
    from prcv2025reid_tpu_torch.models import vit

    rcfg = paths["pallas_attention"].replace(remat_blocks=True)
    model = build_model(rcfg, params, device=dev)
    l_r, g_r = group_grads(torch, model, rcfg, batch)
    recompute = vit.checkpoint
    vit.checkpoint = lambda fn, *args, **kw: fn(*args)  # the same trunk, no recomputation
    try:
        _, g_n = group_grads(torch, model, rcfg, batch)
    finally:
        vit.checkpoint = recompute
    grel = float(torch.cat([g_r[g] - g_n[g] for g in g_n]).norm() /
                 torch.cat(list(g_n.values())).norm())
    cos_r, rel_r, norm_r = compare_grads(torch, g_r, g_p)
    print(f"train remat_blocks, step 1: gradients against the same trunk without "
          f"recomputation: relative error {grel:.3e} (<= {TRAIN_REMAT_REL}); against the plain "
          f"trunk (CLS-only last block): cosine by group {json.dumps(cos_r)} (>= "
          f"{TRAIN_GRAD_COS}), relative error by group {json.dumps(rel_r)}, norm ratio "
          f"{norm_r:.5f} (within {TRAIN_GNORM_REL}); loss {l_r['total_loss']:.6f} vs "
          f"{l_p['total_loss']:.6f}")
    state = init_train_state(model, rcfg, 1, seed=0)
    counted_step(torch, counters, "pallas_attention remat_blocks",
                 make_train_step(model, rcfg, 1), state, batch,
                 {"fused_mha": 2 * L})
    if grel > TRAIN_REMAT_REL or min(cos_r.values()) < TRAIN_GRAD_COS or \
            abs(norm_r - 1) > TRAIN_GNORM_REL:
        fail("remat_blocks: step-1 gradients disagree")
    readings["remat"] = dict(grad_rel_vs_no_recompute=grel, grad_cos_vs_plain=cos_r,
                             grad_rel_vs_plain=rel_r, norm_ratio_vs_plain=norm_r,
                             launches_per_step=2 * L)
    del model, state

    # step 1 at 2 x 2, no dropout: the card against the CPU
    ccfg = tcfg.replace(num_ids_per_batch=2, instances_per_id=2,
                        gradient_accumulation_steps=1, **NO_RANDOMNESS)
    f32 = ccfg.replace(compute_dtype="float32")
    small = train_batch(torch, cfg, dev, 2, 2, seed=12)
    small_cpu = {k: v.cpu() for k, v in small.items()}
    t0 = time.perf_counter()
    runs = {(d, dt): group_grads(torch, build_model(c, params, device=d), c,
                                 small if d == dev else small_cpu)
            for d, dt, c in ((dev, "f32", f32), ("cpu", "f32", f32), (dev, "bf16", ccfg),
                             ("cpu", "bf16", ccfg))}
    (l_cf, g_cf), (l_f, g_f) = runs[dev, "f32"], runs["cpu", "f32"]
    (l_cb, g_cb), (l_pb, g_pb) = runs[dev, "bf16"], runs["cpu", "bf16"]
    f32_loss = {k: abs(l_cf[k] - l_f[k]) / abs(l_f[k]) for k in l_f}
    f32_cos = compare_grads(torch, g_cf, g_f)[0]
    bf16_loss = {k: abs(l_cb[k] - l_f[k]) / abs(l_f[k]) for k in l_f}
    bf16_cos, _, bf16_norm = compare_grads(torch, g_cb, g_f)
    cpu_bf16_cos = compare_grads(torch, g_pb, g_f)[0]
    print(f"train step 1, 2x2 ({time.perf_counter() - t0:.1f} s): card f32 vs CPU f32: loss rel "
          f"{json.dumps(f32_loss)} (<= {TRAIN_F32_LOSS_REL}), gradient cosine by group "
          f"{json.dumps(f32_cos)} (>= {TRAIN_F32_GRAD_COS}); card bf16 vs CPU f32: loss rel "
          f"{json.dumps(bf16_loss)} (<= {TRAIN_CPU_LOSS_REL}), gradient cosine by group "
          f"{json.dumps(bf16_cos)} (the CPU's bf16 run: {json.dumps(cpu_bf16_cos)}, slack "
          f"{TRAIN_BF16_COS_SLACK}), norm ratio {bf16_norm:.5f}")
    if max(f32_loss.values()) > TRAIN_F32_LOSS_REL or min(f32_cos.values()) < TRAIN_F32_GRAD_COS:
        fail("train step 1: the card in f32 disagrees with the CPU in f32")
    if max(bf16_loss.values()) > TRAIN_CPU_LOSS_REL or any(
            bf16_cos[g] < cpu_bf16_cos[g] - TRAIN_BF16_COS_SLACK for g in bf16_cos):
        fail("train step 1: the card in bf16 drifts from the CPU in f32 more than bf16 does")
    readings["card_vs_cpu"] = dict(f32_loss_rel=f32_loss, f32_grad_cos=f32_cos,
                                   bf16_loss_rel=bf16_loss, bf16_grad_cos=bf16_cos,
                                   cpu_bf16_grad_cos=cpu_bf16_cos, bf16_norm_ratio=bf16_norm)
    torch.cuda.empty_cache()
    return readings


def write_bpe_vocab(directory: str) -> None:
    """A small vocab in CLIP's layout (vocab.json + merges.txt), written as
    tests/test_native_tokenizer.py writes one: the byte alphabet and its
    end-of-word forms, merges that build the synthetic captions' words, BOS
    and EOT (no download)."""
    from prcv2025reid_tpu_torch.data.tokenizer import _bytes_to_unicode

    base = list(_bytes_to_unicode().values())
    vocab = {tok: i for i, tok in enumerate(base + [t + "</w>" for t in base])}
    merges = ["p e", "pe r", "per s", "pers o", "perso n</w>", "w e", "we a", "wea r",
              "i n", "in g</w>", "wear ing</w>", "o u", "ou t", "out f", "outf i", "outfi t</w>",
              "w a", "wa l", "wal k", "walk ing</w>"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("#version\n" + "\n".join(merges) + "\n")


def dataset_phase(torch, cfg, params, counters, dev, card, resident, tmp):
    """The host data path and the dataset evaluation at full width on the
    card (see the module docstring, phase 4c); fails the run on any failed
    check and returns the readings.  ``resident``: phase 4b's readings by
    path (the same step on one batch that stays on the card); ``tmp``: a
    scratch directory, where the tree is written to ``tmp/orbench`` (phase
    4d trains on it)."""
    import numpy as np

    from prcv2025reid_tpu_torch import build_model, init_train_state, make_combo_embed_step
    from prcv2025reid_tpu_torch import make_train_step
    from prcv2025reid_tpu_torch.data import native_build, native_image, native_tokenizer
    from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset
    from prcv2025reid_tpu_torch.data.device_feed import prefetch_to_device
    from prcv2025reid_tpu_torch.data.pipeline import HostPipeline, resolve_num_workers
    from prcv2025reid_tpu_torch.data.sampler import PKBatchSampler
    from prcv2025reid_tpu_torch.data.split import create_split_datasets, verify_split_integrity
    from prcv2025reid_tpu_torch.data.tokenizer import ClipBPETokenizer, build_tokenizer
    from prcv2025reid_tpu_torch.evaluation.protocol import (
        GalleryCache,
        build_query_plans,
        checkpoint_cache_tag,
        embed_samples,
        evaluate_protocol,
        export_submission_csv,
    )
    from prcv2025reid_tpu_torch.utils.synthetic import make_synthetic_orbench

    L = cfg.vision_layers
    readings = {}
    # the tree and its split
    t0 = time.perf_counter()
    root = make_synthetic_orbench(os.path.join(tmp, "orbench"), num_ids=DATA_IDS,
                                  anchors_per_id=DATA_ANCHORS, img_size=DATA_IMG)
    n_files = sum(len(files) for _, _, files in os.walk(root))
    dcfg = cfg.replace(data_root=root, json_file=os.path.join(root, "text_annos.json"),
                       num_ids_per_batch=TRAIN_P, instances_per_id=TRAIN_K)
    decoders = {"pil": create_split_datasets(dcfg)}
    train_ds, val_ds, pid2label = decoders["pil"]
    verify_split_integrity(train_ds, val_ds)
    print(f"data: {n_files} files ({DATA_IDS} ids x {DATA_ANCHORS} anchors, {DATA_IMG} px "
          f"JPEG) written in {time.perf_counter() - t0:.1f} s; split val_ratio "
          f"{dcfg.val_ratio}: train {len(train_ds)} records of {len(train_ds.person_ids)} ids, "
          f"val {len(val_ds)} records of {len(val_ds.person_ids)} ids, {len(pid2label)} labels")

    # the native libraries: a failed build fails the run, except a
    # machine without jpeglib.h, where the host decodes with PIL.  A library
    # that is built but does not load (a _build/ copied from another host)
    # is rebuilt once by the load; that rebuild's error is the one read
    img_lib, bpe_lib = native_image.build_library(), native_tokenizer.build_library()
    img_ok = img_lib is not None and native_image.available()
    img_err = native_build.build_errors.get("libimage_decode.so", "")
    print(f"native: image decode {img_lib or 'NOT built'} ({'loads' if img_ok else 'NOT loaded'});"
          f" BPE tokenizer {bpe_lib or 'NOT built'} (g++ into {native_build.cache_dir()})")
    if bpe_lib is None:
        fail(f"the native BPE tokenizer did not build: "
             f"{native_build.build_errors.get('libclip_bpe.so')}")
    if not img_ok and "jpeglib.h" not in img_err:
        fail(f"the native image decode did not build or load: {img_lib}: {img_err}")
    if not img_ok:
        print("native: jpeglib.h is missing on this machine: the host decodes with PIL "
              "only (a fallback on the host, as the JAX package's; the device path is the "
              "same)")
    else:
        decoders["native"] = create_split_datasets(dcfg.replace(use_native_decode=True))

    # the tokenizers: the native BPE against the Python BPE on a written
    # vocab; the hash tokenizer feeds the model (its ids span the vocab)
    vocab_dir = os.path.join(tmp, "vocab")
    write_bpe_vocab(vocab_dir)
    captions = [r.caption for r in train_ds.records + val_ds.records]
    native_bpe = native_tokenizer.NativeClipBPETokenizer(vocab_dir, dcfg.text_context_length)
    ids = native_bpe(captions)
    same = np.array_equal(ids, ClipBPETokenizer(vocab_dir, dcfg.text_context_length)(captions))
    print(f"tokenizer: native BPE on {len(captions)} captions equals the Python BPE: {same} "
          f"(row 0: {ids[0][:12].tolist()})")
    if not same:
        fail("the native BPE disagrees with the Python BPE")
    tok = build_tokenizer(None, dcfg.text_vocab_size, dcfg.text_context_length)

    def pipeline_for(ds, steps):
        sampler = PKBatchSampler(
            ds, TRAIN_P, TRAIN_K, allow_id_reuse=dcfg.allow_id_reuse, seed=dcfg.seed,
            steps_per_epoch=steps, force_modal_pairs=dcfg.force_modal_pairs,
            sampling_fallback=dcfg.sampling_fallback,
            min_modal_coverage=dcfg.min_modal_coverage)
        return HostPipeline(ds, sampler, tok, num_workers=dcfg.num_workers,
                            prefetch=dcfg.prefetch_batches, seed=dcfg.seed)

    # the pipeline alone: batches/s after the workers are warm
    workers, cores = resolve_num_workers(dcfg.num_workers), len(os.sched_getaffinity(0))
    warm = workers + dcfg.prefetch_batches  # the batches in flight at once
    print(f"pipeline: num_workers={dcfg.num_workers} -> {workers} worker processes, "
          f"{cores} cores available (os.sched_getaffinity)")
    shape = (TRAIN_P * TRAIN_K, len(cfg.vision_modalities), cfg.image_size, cfg.image_size, 3)
    readings["pipeline"] = {"workers": workers, "cores": cores}
    for decode, (ds, _, _) in decoders.items():
        pipe = pipeline_for(ds, warm + PIPE_BATCHES)
        try:
            it = iter(pipe)
            for _ in range(warm):
                next(it)
            t0 = time.perf_counter()
            n = 0
            for b in it:
                n += 1
                if b["images"].shape != shape or b["images"].dtype != np.uint8:
                    fail(f"pipeline {decode}: a batch of {b['images'].shape} "
                         f"{b['images'].dtype}, expected {shape} uint8")
            dt = time.perf_counter() - t0
        finally:
            pipe.close()
        readings["pipeline"][decode] = {"batches_per_s": n / dt,
                                        "samples_per_s": n * TRAIN_P * TRAIN_K / dt}
        print(f"pipeline {decode} ({workers} workers): {n / dt:.2f} batches/s, "
              f"{n * TRAIN_P * TRAIN_K / dt:.1f} samples/s of {TRAIN_P}x{TRAIN_K} "
              f"({n} batches after {warm} warm-up)")

    # the pipeline feeding the train step through the device feed
    feed_ds = decoders.get("native", decoders["pil"])[0]
    feed_decode = "native" if "native" in decoders else "pil"
    tcfg = dcfg.replace(num_ids_per_batch=TRAIN_P, instances_per_id=TRAIN_K)
    trained = None
    readings["fed"] = {}
    for name, pcfg in (("xla", tcfg), ("pallas_attention", tcfg.replace(use_pallas_attention=True))):
        model = build_model(pcfg, params, device=dev)
        state = init_train_state(model, pcfg, 1, seed=0)
        step = make_train_step(model, pcfg, 1)
        pipe = pipeline_for(feed_ds, FEED_STEPS + 1)
        want = {n: 0 for n in counters}
        if name == "pallas_attention":
            want["fused_mha"] = (L - 1) * FEED_STEPS
        history, fetch_s = [], 0.0
        try:
            feed = prefetch_to_device(pipe, size=dcfg.prefetch_batches, device=dev)
            for counter in counters.values():
                counter.launches = 0
            torch.cuda.synchronize()
            for i in range(FEED_STEPS):
                if i == FEED_WARMUP:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    t_fetch = time.perf_counter()
                    batch = next(feed)
                    if i >= FEED_WARMUP:  # the host's share of a fed step
                        fetch_s += time.perf_counter() - t_fetch
                    state, m = step(state, batch, SDM_WEIGHT, SDM_TAU)
                except RuntimeError as e:  # sync debug mode raises on a host synchronisation
                    fail(f"fed train {name}, step {i}: {e}")
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                history.append(m)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {n: f.launches for n, f in counters.items()}
            fed_batch, held = next(feed), [state]

            def one_step():
                held[0], _ = step(held[0], fed_batch, SDM_WEIGHT, SDM_TAU)

            device_ms, prof_ms, _, _ = device_reading(torch, one_step, f"fed train {name}")
            state = held[0]
        finally:
            pipe.close()
        hist = {k: torch.stack([h[k] for h in history]).tolist() for k in history[0]}
        loss = hist["total_loss"]
        print(f"fed train {name}: launches over {FEED_STEPS} steps {got} (expected {want}); "
              f"no host synchronisation in any step (sync debug mode 'error'); total_loss "
              + " ".join(f"{v:.4f}" for v in loss))
        if got != want:
            fail(f"fed train {name}: launch counts {got} != {want}")
        finite = all(np.isfinite(hist[k]).all() for k in ("total_loss", "ce_loss", "sdm_loss",
                                                           "grad_norm"))
        if not finite or any(hist["skipped"]):
            fail(f"fed train {name}: a non-finite loss or a skipped step: {hist}")
        head, tail = statistics.mean(loss[:5]), statistics.mean(loss[-5:])
        if not tail < head:
            fail(f"fed train {name}: the loss did not fall (mean of the first five {head}, "
                 f"of the last five {tail})")
        it_s = (FEED_STEPS - FEED_WARMUP) / wall
        idle = 1 - device_ms / (1e3 / it_s)
        r = resident[name]
        fetch_ms = fetch_s / (FEED_STEPS - FEED_WARMUP) * 1e3
        readings["fed"][name] = dict(it_per_s=it_s, samples_per_s=it_s * TRAIN_P * TRAIN_K,
                                     device_ms=device_ms, profiler_ms=prof_ms,
                                     wall_ms=1e3 / it_s, idle_share=idle,
                                     fetch_ms=fetch_ms, loss_first5=head, loss_last5=tail,
                                     decode=feed_decode, launches=got)
        print(f"fed train {name} ({card}; {feed_decode} decode, {workers} workers): "
              f"{it_s:.3f} it/s, {it_s * TRAIN_P * TRAIN_K:.1f} samples/s; device "
              f"{device_ms:.3f} ms of {1e3 / it_s:.3f} ms a step (idle share {idle:.3f}), "
              f"{fetch_ms:.1f} ms of it in the feed's next() on the host; "
              f"phase 4b's resident batch: {r['it_per_s']:.3f} it/s, device "
              f"{r['device_ms']:.3f} ms, idle share {r['idle_share']:.3f}; loss mean "
              f"{head:.4f} -> {tail:.4f}")
        if name == "xla":
            trained = model
        del model, state, step
        torch.cuda.empty_cache()

    # evaluate_protocol on the val split: xla and the fused-stream trunk
    # built from the trained weights; the same weights in f32 read how far
    # bf16 rounding alone moves each plan's mAP (printed, not a gate)
    trunk_cfg = tcfg.replace(use_fused_resln=True, use_fused_mlp=True,
                             use_pallas_attention=True)
    trunk = build_model(trunk_cfg, params, device=dev)
    trunk.load_state_dict(trained.state_dict())
    f32 = build_model(tcfg.replace(compute_dtype="float32"), params, device=dev)
    f32.load_state_dict(trained.state_dict())
    per_forward = {"xla": {}, "f32": {}, "fused_trunk": {"fused_mha": L, "fused_mlp": L,
                                                         "fused_residual_ln": 2 * L}}
    cache = GalleryCache(os.path.join(tmp, "eval_cache"), checkpoint_cache_tag(
        trunk, dcfg.eval_cache_tag, step=FEED_STEPS, config=trunk_cfg))

    def recording(model, log):
        """make_combo_embed_step, each call's features kept by combo."""
        def factory(mods):
            step = make_combo_embed_step(model, mods)

            def run(*args):
                out = step(*args)
                log.setdefault(mods, []).append(out)
                return out
            return run
        return factory

    results, logs = {}, {}
    for name, model in (("xla", trained), ("fused_trunk", trunk), ("f32", f32)):
        logs[name] = {}
        for counter in counters.values():
            counter.launches = 0
        t0 = time.perf_counter()
        results[name] = evaluate_protocol(
            None, val_ds, tok, batch_size=dcfg.eval_batch_size, device=dev,
            embed_factory=recording(model, logs[name]),
            cache=cache if name == "fused_trunk" else None)
        torch.cuda.synchronize()
        got = {n: f.launches for n, f in counters.items()}
        n_vision = sum(len(v) for mods, v in logs[name].items() if mods != ("text",))
        want = {n: per_forward[name].get(n, 0) * n_vision for n in counters}
        print(f"eval {name}: evaluate_protocol over {len(val_ds)} val records, "
              f"{len(results[name]['detail'])} plans in {time.perf_counter() - t0:.1f} s; "
              f"launches {got} (expected {want}: {n_vision} embed batches with a vision "
              f"tower)")
        if got != want:
            fail(f"eval {name}: launch counts {got} != {want}")
    plans = [p for p, _ in build_query_plans()]
    if any(sorted(r["detail"]) != sorted(plans) for r in results.values()):
        fail(f"evaluate_protocol: not all 15 plans: {[sorted(r['detail']) for r in results.values()]}")

    def min_cos(mods):
        a, b = (torch.cat(logs[n][mods]) for n in ("fused_trunk", "xla"))
        return (a * b).sum(dim=1).min().item()

    g_cos = min_cos(("vis",))
    table = {}
    for plan, mods in build_query_plans():
        ref, got = results["xla"]["detail"][plan], results["fused_trunk"]["detail"][plan]
        table[plan] = dict(map_xla=ref["mAP"], map_fused_trunk=got["mAP"],
                           map_delta=abs(got["mAP"] - ref["mAP"]), query_min_cosine=min_cos(mods),
                           cmc1=got["cmc1"], num_queries=got["num_queries"],
                           map_f32=results["f32"]["detail"][plan]["mAP"])
        t = table[plan]
        print(f"eval {plan:26s} mAP xla {t['map_xla']:.4f} fused_trunk "
              f"{t['map_fused_trunk']:.4f} |dmAP| {t['map_delta']:.6f} (<= "
              f"{RANK_MAX_MAP_DELTA}); query min-cosine {t['query_min_cosine']:.6f}; gallery "
              f"min-cosine {g_cos:.6f} (>= {MIN_COSINE}); f32 {t['map_f32']:.4f}")
        if t["map_delta"] > RANK_MAX_MAP_DELTA or g_cos < MIN_COSINE:
            fail(f"eval {plan}: fused_trunk disagrees with xla: {t}, gallery {g_cos}")
    floor = {p: max(abs(t["map_xla"] - t["map_f32"]), abs(t["map_fused_trunk"] - t["map_f32"]))
             for p, t in table.items()}
    summary = {k: v for k, v in results["fused_trunk"].items() if k != "detail"}
    print(f"eval: max |dmAP| fused_trunk vs xla {max(t['map_delta'] for t in table.values()):.6f}; "
          f"against the f32 model: xla {max(abs(t['map_xla'] - t['map_f32']) for t in table.values()):.6f}, "
          f"fused_trunk {max(abs(t['map_fused_trunk'] - t['map_f32']) for t in table.values()):.6f}; "
          "fused_trunk summary " + json.dumps(summary))

    # a second call hits the gallery cache: no gallery embed, the same bits
    gallery = [i for i, r in enumerate(val_ds.records) if r.vis]
    first = torch.cat(logs["fused_trunk"][("vis",)])[:len(gallery)].cpu().numpy()
    hit = cache.load(gallery)
    log2 = {}
    again = evaluate_protocol(None, val_ds, tok, batch_size=dcfg.eval_batch_size, device=dev,
                              embed_factory=recording(trunk, log2), cache=cache,
                              include_patterns=["single/nir"])
    cache_ok = hit is not None and ("vis",) not in log2 and np.array_equal(hit[0], first)
    print(f"eval cache: the second call embedded {sorted(log2)}, the cached gallery features "
          f"equal the first call's bit for bit: {cache_ok}; single/nir mAP "
          f"{again['detail']['single/nir']['mAP']:.6f} (first call "
          f"{results['fused_trunk']['detail']['single/nir']['mAP']:.6f})")
    if not cache_ok:
        fail("the gallery cache did not hit on the second call, or its features differ")

    # gallery embeds/s through embed_samples: the host decodes in the
    # calling process, one record after another, as JAX's
    full = {d: MultiModalDataset(dcfg.replace(use_native_decode=d == "native"), split="val")
            for d in decoders}
    load = getattr(MultiModalDataset._load_image, "original", MultiModalDataset._load_image)
    for ds in full.values():  # every read decodes (decode_once serves the evaluations)
        ds._load_image = load.__get__(ds)
    step = make_combo_embed_step(trunk, ("vis",))
    readings["gallery_embed"] = {}
    for decode, ds in full.items():
        idx = list(range(len(ds)))
        embed_samples(step, ds, idx[:dcfg.eval_batch_size], tok, dcfg.eval_batch_size)
        torch.cuda.synchronize()
        calls = []

        def recorded(*args):
            calls.append(args)
            return step(*args)

        t0 = time.perf_counter()
        feats, _ = embed_samples(recorded, ds, idx, tok, dcfg.eval_batch_size)
        wall = time.perf_counter() - t0
        # the device time of the same embed steps on their inputs, resident
        resident_args = [tuple(torch.as_tensor(a, device=dev) if a is not None else None
                               for a in args) for args in calls]
        dev_ms, prof_ms, _, _ = device_reading(
            torch, lambda: [step(*a) for a in resident_args],
            f"gallery embed_samples {decode} ({len(calls)} embed steps)")
        del resident_args, calls
        if feats.shape != (len(idx), cfg.fusion_dim) or not np.isfinite(feats).all():
            fail(f"embed_samples: features {feats.shape}, expected {(len(idx), cfg.fusion_dim)}")
        rate = len(idx) / wall
        readings["gallery_embed"][decode] = dict(
            embeds_per_s=rate, wall_ms=wall * 1e3, device_ms=dev_ms, profiler_ms=prof_ms,
            idle_share=1 - dev_ms / (wall * 1e3), records=len(idx),
            batch=dcfg.eval_batch_size)
        print(f"gallery embed_samples fused_trunk ({card}; {decode} decode in the calling "
              f"process, batch {dcfg.eval_batch_size}): {rate:.1f} embeds/s over {len(idx)} "
              f"records; device {dev_ms:.3f} ms of {wall * 1e3:.1f} ms (idle share "
              f"{1 - dev_ms / (wall * 1e3):.3f})")

    # the submission CSV on the val split
    path = os.path.join(tmp, "submission.csv")
    n_rows = export_submission_csv(None, val_ds, tok, path, batch_size=dcfg.eval_batch_size,
                                   embed_factory=lambda m: make_combo_embed_step(trunk, m),
                                   device=dev)
    stems = {os.path.splitext(os.path.basename(val_ds.records[i].anchor_vis))[0]
             for i in gallery}
    with open(path) as f:
        lines = f.read().splitlines()
    k_eff = min(100, len(gallery))
    bad = [ln for ln in lines[1:] if len(ln.split(",")) != 2
           or len(ln.split(",")[0].split("|")) != 3
           or len(set(ln.split(",")[1].split())) != k_eff
           or not set(ln.split(",")[1].split()) <= stems]
    n_queries = sum(r["num_queries"] for r in results["fused_trunk"]["detail"].values())
    print(f"submission: {n_rows} rows ({n_queries} queries over 15 plans), top {k_eff} of "
          f"{len(gallery)} gallery ids each, unique and valid; malformed rows {len(bad)}")
    if lines[0] != "query_key,ranked_gallery_ids" or n_rows != len(lines) - 1 or \
            n_rows != n_queries or bad:
        fail(f"submission CSV: {n_rows} rows for {n_queries} queries, bad rows {bad[:3]}")
    readings["eval"] = dict(plans=table, gallery_min_cosine=g_cos, summary=summary,
                            bf16_vs_f32_max_map_delta=max(floor.values()), cache_hit=cache_ok,
                            submission_rows=n_rows, val_records=len(val_ds))
    del trained, trunk, f32, step
    torch.cuda.empty_cache()
    return readings


def probe_trainer(torch, trainer_module):
    """The trainer class as the command line builds it, with its train step
    run under the sync debug mode 'error' (a host synchronisation fails the
    run) and its evaluations, vision embed batches and step losses recorded;
    ``Probe.made`` lists the trainers made."""

    class Probe(trainer_module.Trainer):
        made = []

        def __init__(self, config, device="cuda"):
            super().__init__(config, device)
            Probe.made.append(self)
            self.losses, self.evals, self.vision_batches = [], [], 0
            step = self.raw_step = self.train_step

            def checked(state, batch, *args, **kw):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    state, m = step(state, batch, *args, **kw)
                except RuntimeError as e:  # sync debug mode raises on a host synchronisation
                    fail(f"trainer step {state.step}: {e}")
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                self.losses.append(torch.stack([m["total_loss"], m["ce_loss"], m["sdm_loss"]]))
                return state, m

            self.train_step = checked

        def embed_factory(self, modalities):
            step = super().embed_factory(modalities)
            if tuple(modalities) == ("text",):
                return step

            def counted(*args):
                self.vision_batches += 1
                return step(*args)
            return counted

        def evaluate(self, epoch=None, sample_ratio=None):
            t0 = time.perf_counter()
            result = super().evaluate(epoch, sample_ratio)
            torch.cuda.synchronize()
            self.evals.append(dict(seconds=time.perf_counter() - t0, plans=sorted(result["detail"]),
                                   map_avg2=result["map_avg2"]))
            return result

    return Probe


def decode_once(dataset_cls):
    """Make every evaluation dataset of this process decode each image file
    once: a later read of a path returns the first decode's array (the eval
    transform has no randomness, and the callers copy the array).  Training
    datasets (random augmentation) decode every time.  Phases 4c-4g evaluate
    one val split many times, 15 query plans a pass, each reading the same
    few hundred files again.  Returns the class's own loader."""
    load = dataset_cls._load_image
    cache = {}

    def _load_image(self, path, rng):
        if self.is_training:
            return load(self, path, rng)
        key = (path, self.config.image_size, self.config.use_native_decode)
        if key not in cache:
            cache[key] = load(self, path, rng)
        return cache[key]

    _load_image.original = load
    dataset_cls._load_image = _load_image
    return load


def trainer_argv(cfg, tmp, run, **over):
    """tools_torch/train.py's flags for a run on ``tmp/orbench`` (phase 4c's
    tree): cfg's widths and settings (TrainingConfig() in main: none), the
    8x4 recipe, TRAINER_STEPS steps an epoch, 2 epochs with the eval (all 15
    plans, the whole val split) at epoch 2, the three eval-trunk flags, and
    ``tmp/<run>/{ckpt,logs,cache}``; then ``over``."""
    from prcv2025reid_tpu_torch import TrainingConfig

    default_cfg = TrainingConfig()
    root = os.path.join(tmp, "orbench")
    flags = {f.name: ",".join(map(str, v)) if isinstance(v, tuple) else v
             for f in dataclasses.fields(cfg)
             if (v := getattr(cfg, f.name)) != getattr(default_cfg, f.name)}
    flags.update(
        data_root=root, json_file=os.path.join(root, "text_annos.json"),
        num_ids_per_batch=TRAIN_P, instances_per_id=TRAIN_K, steps_per_epoch=TRAINER_STEPS,
        num_epochs=2, warmup_epochs=1, eval_every_n_epoch=2, eval_sample_ratio=1.0,
        eval_include_patterns="", use_pallas_attention="true", use_fused_mlp="true",
        use_fused_resln="true", save_dir=os.path.join(tmp, run, "ckpt"),
        log_dir=os.path.join(tmp, run, "logs"), eval_cache_dir=os.path.join(tmp, run, "cache"))
    flags.update(over)
    return [f"--{k}={v}" for k, v in flags.items()]


def trainer_phase(torch, cfg, counters, dev, card, fed, tmp):
    """The trainer at full width on the card through its command line (see
    the module docstring, phase 4d); fails the run on any failed check and
    returns the readings.  ``fed``: phase 4c's fed-step readings by path;
    ``tmp``: the scratch directory whose ``orbench`` tree phase 4c wrote."""
    import numpy as np

    from prcv2025reid_tpu_torch.data.pipeline import collate
    from prcv2025reid_tpu_torch.evaluation.protocol import build_query_plans
    from prcv2025reid_tpu_torch.training import trainer as trainer_module
    from prcv2025reid_tpu_torch.training.param_groups import label_params

    cli = load_tool("train")
    L = cfg.vision_layers
    plans = sorted(p for p, _ in build_query_plans())
    saves = []  # (run, kind, seconds) of each save_checkpoint / finalize_pending_saves call

    Probe = probe_trainer(torch, trainer_module)

    def timed(run, kind, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                saves.append((run, kind, time.perf_counter() - t0))
        return call

    def argv(run, **over):
        return trainer_argv(cfg, tmp, run, **over)

    def drive(run, flags):
        """tools_torch/train.py's main(flags) with the counters zeroed just
        before it: (the trainer, its result, the launch counts)."""
        for counter in counters.values():
            counter.launches = 0
        torch.cuda.synchronize()
        result = cli.main(flags)
        torch.cuda.synchronize()
        return Probe.made[-1], result, {n: f.launches for n, f in counters.items()}

    saved = (trainer_module.Trainer, trainer_module.save_checkpoint,
             trainer_module.finalize_pending_saves)
    runs = {}
    try:
        trainer_module.Trainer = Probe
        # run A: 2 epochs with the eval at epoch 2 and the final one, async saves
        trainer_module.save_checkpoint = timed("A", "save", saved[1])
        trainer_module.finalize_pending_saves = timed("A", "finalize", saved[2])
        t0 = time.perf_counter()
        runs["A"] = drive("A", argv("A", save_freq=1))  # epoch_1/: phase 4f reloads it
        wall_a = time.perf_counter() - t0
        # run B: 1 epoch, then a new trainer resumes it to 2; blocking saves,
        # no eval (it changes nothing of the training before epoch 10)
        trainer_module.save_checkpoint = timed("B", "save", saved[1])
        trainer_module.finalize_pending_saves = timed("B", "finalize", saved[2])
        t0 = time.perf_counter()
        b_flags = argv("B", async_checkpoint="false", do_eval="false")
        first = drive("B", b_flags + ["--num_epochs=1"])
        runs["B"] = drive("B", b_flags)
        wall_b = time.perf_counter() - t0
    finally:
        trainer_module.Trainer, trainer_module.save_checkpoint, \
            trainer_module.finalize_pending_saves = saved

    (ta, ra, got_a), (tb, rb, got_b) = runs["A"], runs["B"]
    # run A's artifacts, launches, losses
    logs, ckpt = os.path.join(tmp, "A", "logs"), os.path.join(tmp, "A", "ckpt")
    rows = ta.train_history.rows
    have = {n: os.path.exists(os.path.join(d, n)) for d, names in (
        (logs, ("train_history.csv", "eval_history.csv", "training.log")),
        (ckpt, ("latest/state.pt", "latest/host_state.json", "best/state.pt",
                "best/host_state.json"))) for n in names}
    print(f"trainer A (tools_torch/train.py, {TRAIN_P}x{TRAIN_K}, 2 epochs x {TRAINER_STEPS} "
          f"steps, {wall_a:.1f} s): artifacts {have}; train_history rows "
          f"{len(rows)}, eval_history rows {len(ta.eval_history.rows)}; evaluations "
          + json.dumps([dict(e, plans=len(e["plans"])) for e in ta.evals]))
    if not all(have.values()) or len(rows) != 2 or len(ta.eval_history.rows) < 1 \
            or os.path.getsize(os.path.join(logs, "training.log")) == 0:
        fail(f"trainer A: missing artifacts {have}, or {len(rows)} train rows")
    if len(ta.evals) != 2 or any(e["plans"] != plans for e in ta.evals):
        fail(f"trainer A: expected 2 evaluations of all 15 plans: {ta.evals}")
    steps = 2 * TRAINER_STEPS
    for name, trainer, got, vision_batches in (("A", ta, got_a, ta.vision_batches + 1),
                                               ("B", tb, got_b, 0)):
        # + 1: the smoke test's forward (run A; run B's resumed half has none)
        want = {n: 0 for n in counters}
        want.update(fused_mha=(L - 1) * TRAINER_STEPS * (2 if name == "A" else 1) + L * vision_batches,
                    fused_mlp=L * vision_batches, fused_residual_ln=2 * L * vision_batches)
        print(f"trainer {name}: launches {got} (expected {want}: #1 {L - 1} a train step, "
              f"#1 {L}, #8 {L}, #9 {2 * L} a vision forward, {vision_batches} of them)")
        if got != want:
            fail(f"trainer {name}: launch counts {got} != {want}")
    losses = torch.stack(ta.losses).tolist()
    ce = [l[1] for l in losses]
    if len(losses) != steps or not np.isfinite(losses).all():
        fail(f"trainer A: {len(losses)} steps, or a non-finite loss: {losses}")
    head, tail = statistics.mean(ce[:5]), statistics.mean(ce[-5:])
    print(f"trainer A: no host synchronisation in any of {steps} steps (sync debug mode "
          f"'error'); ce_loss " + " ".join(f"{v:.4f}" for v in ce)
          + f"; mean of the first five {head:.4f}, of the last five {tail:.4f}")
    if not tail < head:
        fail(f"trainer A: the CE loss did not fall ({head} -> {tail})")

    # run B against run A
    b_rows = tb.train_history.rows
    loss_rel = {f"{k}@{r['epoch']}": abs(rb_[k] - r[k]) / max(abs(r[k]), 1e-12)
                for r, rb_ in zip(rows, b_rows) for k in ("total_loss", "ce_loss", "sdm_loss")}
    labels = label_params(ta.model, ta.config)
    pa, pb = dict(ta.model.named_parameters()), dict(tb.model.named_parameters())
    cos, bitwise = {}, True
    for group in sorted(set(labels.values()) - {"frozen"}):
        a = torch.cat([pa[n].detach().flatten() for n, g in labels.items() if g == group])
        b = torch.cat([pb[n].detach().flatten() for n, g in labels.items() if g == group])
        cos[group] = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    differ = [n for n in pa if not torch.equal(pa[n], pb[n])]
    buffers = [n for n, t in ta.model.named_buffers()
               if not torch.equal(t, dict(tb.model.named_buffers())[n])]
    same_sampler = ta.sampler.state_dict() == tb.sampler.state_dict()
    print(f"trainer B (1 epoch, then resumed to 2; {wall_b:.1f} s): start epoch "
          f"{tb.start_epoch}; per-epoch losses against A, relative: {json.dumps(loss_rel)}; "
          f"per-group parameter cosine {json.dumps(cos)}; sampler state equal: {same_sampler}; "
          f"bit for bit: {not differ and not buffers} ({len(differ)} parameters and "
          f"{len(buffers)} buffers differ{': ' + ', '.join((differ + buffers)[:4]) if differ or buffers else ''})")
    if len(b_rows) != 2 or tb.start_epoch != 2 or first[0].state.step != TRAINER_STEPS:
        fail(f"trainer B: {len(b_rows)} rows, start epoch {tb.start_epoch}")
    if max(loss_rel.values()) > TRAINER_LOSS_REL or min(cos.values()) < TRAINER_COS \
            or not same_sampler:
        fail(f"trainer B disagrees with A: losses {loss_rel}, cosine {cos}, sampler "
             f"{same_sampler}")

    # speed, one step's device ms, evaluate, checkpoints
    per_epoch = [r["steps_per_sec"] for r in rows]
    size = sum(os.path.getsize(os.path.join(ckpt, "latest", f))
               for f in os.listdir(os.path.join(ckpt, "latest")))
    save_s = {run: {kind: [round(t, 4) for r, k, t in saves if r == run and k == kind]
                    for kind in ("save", "finalize")} for run in ("A", "B")}
    blocked = {run: sum(t for r, _, t in saves if r == run) for run in ("A", "B")}
    profiled = {}
    for name, trainer in (("A", ta), ("B", tb)):
        snap = trainer.sampler.state_dict()
        indices = trainer.sampler.sample_batch()
        trainer.sampler.load_state_dict(snap)
        rng = np.random.default_rng(0)
        batch = collate([trainer.train_ds.get_sample(i, rng, modality_dropout=0.0)
                         for i in indices], trainer.tokenizer)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        held = [trainer.raw_step(trainer.state, batch, 0.1, 0.18)[0]]  # warm
        torch.cuda.synchronize()

        def one_step():
            held[0], _ = trainer.raw_step(held[0], batch, 0.1, 0.18)

        device_ms, prof_ms, _, _ = device_reading(torch, one_step, f"trainer {name} step")
        wall_ms = 1e3 / trainer.train_history.rows[-1]["steps_per_sec"]
        profiled[name] = dict(device_ms=device_ms, profiler_ms=prof_ms, wall_ms=wall_ms,
                              idle_share=1 - device_ms / wall_ms)
    f = fed["pallas_attention"]
    readings = dict(
        steps_per_sec=per_epoch, steps_per_sec_b=[r["steps_per_sec"] for r in b_rows],
        fed_pallas_it_per_s=f["it_per_s"], profiled_step=profiled,
        evaluate_s=[e["seconds"] for e in ta.evals], checkpoint_bytes=size, save_s=save_s,
        blocked_s=blocked, losses=loss_rel, cosine=cos, bitwise=not differ and not buffers,
        launches_a=got_a, vision_batches_a=ta.vision_batches, ce_first5=head, ce_last5=tail,
        best_map=ra["best_map"], final=ra["final"])
    print(f"trainer ({card}): steps_per_sec by epoch A {[round(v, 3) for v in per_epoch]}, B "
          f"{[round(r['steps_per_sec'], 3) for r in b_rows]} (epoch 1 includes the decode "
          f"workers' start) beside phase 4c's fed pallas_attention {f['it_per_s']:.3f} it/s; one "
          f"step: A device {profiled['A']['device_ms']:.3f} ms of "
          f"{profiled['A']['wall_ms']:.3f} ms (idle share {profiled['A']['idle_share']:.3f}), B "
          f"{profiled['B']['device_ms']:.3f} of {profiled['B']['wall_ms']:.3f} "
          f"({profiled['B']['idle_share']:.3f}); evaluate "
          f"{[round(e['seconds'], 2) for e in ta.evals]} s over {len(ta.val_ds)} val records "
          f"(15 plans; the second hits the gallery cache); checkpoint {size / 1e9:.3f} GB; "
          f"time in save_checkpoint / finalize_pending_saves: A async {json.dumps(save_s['A'])} "
          f"= {blocked['A']:.3f} s, B blocking {json.dumps(save_s['B'])} = {blocked['B']:.3f} s; "
          f"final eval " + json.dumps(ra["final"]))
    del ta, tb, runs, first
    Probe.made.clear()
    torch.cuda.empty_cache()
    return readings


def rerank_phase(torch, dev, card):
    """Re-ranking at the competition's scale on the card (phase 4e (f), see
    the module docstring); fails the run on any failed check and returns the
    readings."""
    import contextlib
    import io

    import numpy as np

    from prcv2025reid_tpu_torch.evaluation import protocol, rerank

    tune = load_tool("tune_rerank")
    per_id = RR_GALLERY // RR_IDS
    q, qp, g, gp = tune.make_clustered(n_ids=RR_IDS, per_id_g=per_id, n_distract=3,
                                       n_q=RR_QUERIES, dim=512, **RR_SIGMAS)
    g, gp = g[:RR_GALLERY], gp[:RR_GALLERY]
    excl = (qp * per_id).astype(np.int32)  # each query drops its id's first gallery item
    qd, gd = torch.from_numpy(q).to(dev), torch.from_numpy(g).to(dev)
    rerank.rerank_orders(qd[:512], gd, excl_idx=excl[:512], device=dev)  # warm
    qps, orders = {}, {}
    for rnd in range(2):
        for chunk in (RR_CHUNKS if rnd == 0 else RR_CHUNKS[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orders[chunk] = rerank.rerank_orders(qd, gd, excl_idx=excl, query_chunk=chunk,
                                                 device=dev)
            qps.setdefault(chunk, []).append(RR_QUERIES / (time.perf_counter() - t0))
    # rerank_orders returns host arrays: the events read the chunk's span
    chunk_ms, chunk_prof_ms, events, _ = device_reading(
        torch, lambda: rerank.rerank_orders(qd[:512], gd, excl_idx=excl[:512], device=dev),
        "re-ranking one 512-query chunk (its span: the call synchronises the host)")
    top = sorted(events, key=device_time, reverse=True)[:TOP_KERNELS]
    same_chunks = all(np.array_equal(orders[c], orders[512]) for c in RR_CHUNKS)
    n = RR_CPU_QUERIES
    on_cpu = rerank.rerank_orders(q[:n], g, excl_idx=excl[:n], device="cpu")
    rows_same = float((on_cpu == orders[512][:n]).all(axis=1).mean())
    m = {k: protocol.compute_retrieval_metrics(q[:n], qp[:n], g, gp, excl[:n], boost_idx=o,
                                               device=dev)["mAP"]
         for k, o in (("card", orders[512][:n]), ("cpu", on_cpu), ("plain", None))}
    lam1 = rerank.rerank_orders(qd[:512], gd, lam=1.0, device=dev)
    plain = torch.argsort(-protocol.similarity(qd[:512], gd), dim=1,
                          stable=True)[:, :lam1.shape[1]].cpu().numpy()
    lam1_ok = np.array_equal(lam1, plain)
    print(f"eval cli (f) re-ranking {RR_QUERIES} queries against {RR_GALLERY} x 512 ({card}; "
          f"{RR_IDS} ids, {RR_SIGMAS}, exclusion on): queries/s by query_chunk " + json.dumps(
              {c: [round(v, 1) for v in r] for c, r in qps.items()})
          + f"; the same orders at every chunk size {same_chunks}; one 512-query chunk "
          f"{chunk_ms:.3f} ms on the device (span), its top kernels: " + json.dumps(
              [[e.key[:50], e.count, round(device_time(e) / 1e3, 4)] for e in top])
          + f"; the card against the CPU on {n} queries: rows equal {rows_same:.4f} (>= "
          f"{RR_SAME_ROWS}), mAP {m['card']:.6f} / {m['cpu']:.6f} (|d| <= {RR_MAP_TOL}), plain "
          f"{m['plain']:.6f}; lambda 1.0 gives the plain cosine top-{lam1.shape[1]}: {lam1_ok}")
    if rows_same < RR_SAME_ROWS or abs(m["card"] - m["cpu"]) > RR_MAP_TOL or not lam1_ok:
        fail(f"re-ranking at scale: rows {rows_same}, mAP {m}, lambda 1.0 {lam1_ok}")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sweep = tune.main(["--quick"])
    best = [ln for ln in buf.getvalue().splitlines() if "BEST" in ln]
    print(f"eval cli (f) tune_rerank.py --quick on the card: {len(sweep)} rows in "
          f"{time.perf_counter() - t0:.1f} s; {best}")
    if len(sweep) != 9 or not best:
        fail(f"tune_rerank.py --quick: {len(sweep)} rows")
    del qd, gd
    torch.cuda.empty_cache()
    return dict(queries_per_s=qps, chunk_512_device_ms=chunk_ms,
                chunk_512_profiler_ms=chunk_prof_ms, rows_equal_cpu=rows_same,
                map=m, lam1_plain=lam1_ok, top_kernels=readings_ops(top))


def eval_cli_phase(torch, cfg, params, counters, dev, card, tmp):
    """The evaluation command line at full width on the card (see the module
    docstring, phase 4e): a token-reduced run trained through
    tools_torch/train.py, then tools_torch/eval_mm_protocol.py's main on
    phase 4d's run A and on that run, and re-ranking at the competition's
    scale; fails the run on any failed check and returns the readings.
    ``params``: phase 4's weights; ``tmp``: the scratch directory of phases
    4c and 4d."""
    import contextlib
    import csv
    import io

    import numpy as np

    from prcv2025reid_tpu_torch import (
        TrainingConfig,
        build_model,
        engine,
        init_train_state,
        make_train_step,
    )
    from prcv2025reid_tpu_torch.data.pipeline import collate
    from prcv2025reid_tpu_torch.data.split import create_split_datasets
    from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer
    from prcv2025reid_tpu_torch.evaluation import protocol, rerank
    from prcv2025reid_tpu_torch.models import vit
    from prcv2025reid_tpu_torch.training import trainer as trainer_module

    L = cfg.vision_layers
    root, out = os.path.join(tmp, "orbench"), os.path.join(tmp, "E")
    os.makedirs(out)
    readings = {}

    def counts():
        return {n: f.launches for n, f in counters.items()}

    def zero():
        for counter in counters.values():
            counter.launches = 0
        torch.cuda.synchronize()

    # ---- (a) a token-reduced training run through tools_torch/train.py
    Probe = probe_trainer(torch, trainer_module)
    flags = trainer_argv(cfg, tmp, "TR", num_epochs=1, do_eval="false", use_fused_resln="false",
                         token_keep=TOKEN_KEEP, token_reduce_layer=TOKEN_LAYER,
                         token_reduce_train="true")
    saved = trainer_module.Trainer
    zero()
    t0 = time.perf_counter()
    try:
        trainer_module.Trainer = Probe
        load_tool("train").main(flags)
    finally:
        trainer_module.Trainer = saved
    torch.cuda.synchronize()
    tr = Probe.made[-1]
    got = counts()
    # L - 1 a train step, and L - 1 of #1 and #8 in the smoke test's eval forward
    want = {n: 0 for n in counters}
    want.update(fused_mha=(L - 1) * (TRAINER_STEPS + 1), fused_mlp=L - 1)
    losses = torch.stack(tr.losses).tolist()
    print(f"eval cli (a) token-reduced training (token_keep {TOKEN_KEEP} after block "
          f"{TOKEN_LAYER}, token_reduce_train, {TRAINER_STEPS} steps, "
          f"{time.perf_counter() - t0:.1f} s): launches {got} (expected {want}: #1 {L - 1} a "
          f"step, #1 and #8 {L - 1} in the smoke test); no host synchronisation in any step; "
          f"total_loss " + " ".join(f"{v[0]:.4f}" for v in losses))
    if got != want:
        fail(f"token-reduced training: launch counts {got} != {want}")
    if len(losses) != TRAINER_STEPS or not np.isfinite(losses).all():
        fail(f"token-reduced training: {len(losses)} steps or a non-finite loss: {losses}")
    readings["train"] = dict(launches=got, total_loss=[v[0] for v in losses])
    tr_config = tr.config
    del tr
    Probe.made.clear()

    # one step of the same trunk under remat_blocks: every block in full and
    # recomputed, the reduction stored between them
    rcfg = tr_config.replace(remat_blocks=True)
    model = build_model(rcfg, params, device=dev)
    batch = train_batch(torch, cfg, dev, TRAIN_P, TRAIN_K, seed=11)
    _, g_r = group_grads(torch, model, rcfg, batch)
    recompute = vit.checkpoint
    vit.checkpoint = lambda fn, *args, **kw: fn(*args)  # the same trunk, no recomputation
    try:
        _, g_n = group_grads(torch, model, rcfg, batch)
    finally:
        vit.checkpoint = recompute
    grel = float(torch.cat([g_r[g] - g_n[g] for g in g_n]).norm() /
                 torch.cat(list(g_n.values())).norm())
    print(f"eval cli (a) token-reduced remat_blocks, step 1: gradients against the same trunk "
          f"without recomputation: relative error {grel:.3e} (<= {TRAIN_REMAT_REL})")
    counted_step(torch, counters, "token-reduced remat_blocks", make_train_step(model, rcfg, 1),
                 init_train_state(model, rcfg, 1, seed=0), batch, {"fused_mha": 2 * L})
    if grel > TRAIN_REMAT_REL:
        fail(f"token-reduced remat_blocks: step-1 gradients {grel} from the same trunk")
    readings["remat_grad_rel"] = grel
    del model, batch, g_r, g_n
    torch.cuda.empty_cache()

    # ---- the command line, its embed steps counted
    cli = load_tool("eval_mm_protocol")
    factories = (engine.make_combo_embed_step, engine.make_weighted_embed_step)
    seen = {"model": None, "vision_batches": 0}

    def counting(factory):
        def make(model, active, *args, **kw):
            seen["model"] = model
            step = factory(model, active, *args, **kw)
            if tuple(active) == ("text",):
                return step

            def counted(*a):
                seen["vision_batches"] += 1
                return step(*a)
            return counted
        return make

    def drive(name, flags, per_batch):
        """eval_mm_protocol.main(flags) with the counters zeroed just before
        it: fails unless each kernel launched ``per_batch`` times a vision
        embed batch and nothing else launched; -> (result, readings)."""
        zero()
        seen["vision_batches"] = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        engine.make_combo_embed_step, engine.make_weighted_embed_step = map(counting, factories)
        try:
            with contextlib.redirect_stdout(buf):
                result = cli.main(flags)
        finally:
            engine.make_combo_embed_step, engine.make_weighted_embed_step = factories
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got, vb = counts(), seen["vision_batches"]
        want = {n: per_batch.get(n, 0) * vb for n in counters}
        print(f"eval cli {name} ({seconds:.1f} s): launches {got} (expected {want}: "
              f"{per_batch} a vision embed batch, {vb} of them)")
        if got != want or not vb:
            fail(f"eval cli {name}: launch counts {got} != {want}")
        if json.loads(buf.getvalue()) != json.loads(json.dumps(result, default=float)):
            fail(f"eval cli {name}: the printed JSON is not the result")
        return result, dict(seconds=seconds, launches=got, vision_batches=vb)

    def cache_file(name):
        files = [f for f in os.listdir(os.path.join(out, name)) if f.endswith(".npz")]
        if len(files) != 1:
            fail(f"eval cli: {len(files)} gallery files in {name}, expected 1")
        return os.path.join(out, name, files[0])

    # ---- (b) run A's best checkpoint (the fused-stream trunk) against its own evaluation
    a_ckpt = os.path.join(tmp, "A", "ckpt", "best")
    with open(os.path.join(a_ckpt, "host_state.json")) as f:
        cfg_a = TrainingConfig.from_json(json.load(f)["config"])
    with open(os.path.join(tmp, "A", "logs", "eval_history.csv")) as f:
        row = next(r for r in csv.DictReader(f) if int(float(r["epoch"])) == 2)
    base = [f"--dataset_root={root}", f"--model_path={a_ckpt}", "--eval_split=val",
            f"--sample_ratio={cfg_a.eval_sample_ratio}", "--no-exclude_same_image"]
    trunk = {"fused_mha": L, "fused_mlp": L, "fused_residual_ln": 2 * L}
    b_csv = os.path.join(out, "b.csv")
    res_b, readings["b"] = drive("(b) run A's best/", base + [
        f"--cache_dir={out}/cache_a", f"--submission={b_csv}"], trunk)
    keys = ["map_single", "map_quad", "map_avg2", "map_mm_avg", "mm1_map", "mm2_map", "mm3_map",
            "mm4_map", "cmc1", "cmc5", "cmc10"]
    diff = {k: abs(res_b[k] - float(row[k])) for k in keys}
    print(f"eval cli (b) aggregates against epoch 2 of run A's eval_history.csv: max |diff| "
          f"{max(diff.values()):.3e} (<= {CLI_METRIC_TOL}); "
          + json.dumps({k: round(res_b[k], 6) for k in keys}))
    if max(diff.values()) > CLI_METRIC_TOL:
        fail(f"eval cli (b): the aggregates differ from the trainer's evaluation: {diff}")
    _, val_ds, _ = create_split_datasets(cfg_a)
    g_list = [os.path.splitext(os.path.basename(r.anchor_vis))[0] for r in val_ds.records if r.vis]
    with open(b_csv) as f:
        b_rows = f.read().splitlines()
    n_queries = sum(d["num_queries"] for d in res_b["detail"].values())
    depth = min(cfg_a.rank_topk, len(g_list))
    bad = [r for r in b_rows[1:] if not (len(set(r.split(",")[1].split())) == depth
                                          and set(r.split(",")[1].split()) <= set(g_list))]
    print(f"eval cli (b) submission: {len(b_rows) - 1} rows for {n_queries} queries, each "
          f"{depth} unique gallery ids of the split's {len(g_list)}: {not bad}")
    if b_rows[0] != "query_key,ranked_gallery_ids" or len(b_rows) - 1 != n_queries or bad:
        fail(f"eval cli (b): submission rows {len(b_rows) - 1} for {n_queries} queries, "
             f"{len(bad)} rows with invalid or repeated ids")

    # ---- (c) the weighted fusion: one stacked trunk, its own cache tag
    res_c, readings["c"] = drive("(c) --fusion_mode weighted", base + [
        f"--cache_dir={out}/cache_c", "--fusion_mode=weighted", f"--sample_ratio={E_SAMPLE}"],
        trunk)
    name_a, name_c = (os.path.basename(cache_file(d)) for d in ("cache_a", "cache_c"))
    fp = re.search(r"_st\d+_([0-9a-f]{10})", name_a).group(1)
    tag_ok = name_c == name_a.replace(f"_{fp}", f"_{fp}_w", 1)
    model = seen["model"]
    tokenizer = build_tokenizer(cfg_a.tokenizer_vocab_path, cfg_a.text_vocab_size,
                                cfg_a.text_context_length)
    mm3_idx = [i for i, r in enumerate(val_ds.records)
               if all(m in r.modalities() for m in MM3_QUERY)][:cfg_a.eval_batch_size]
    rng = np.random.default_rng(0)
    mb = collate([val_ds.get_query_sample(i, MM3_QUERY, rng) for i in mm3_idx], tokenizer)
    args = tuple(torch.as_tensor(mb[k], device=dev)
                 for k in ("images", "image_mask", "text_tokens", "text_mask"))
    zero()
    weighted = factories[1](model, MM3_QUERY)(*args)
    torch.cuda.synchronize()
    one_batch = counts()
    composed = sum(factories[0](model, (m,))(*args) for m in MM3_QUERY)
    composed = composed / composed.norm(dim=1, keepdim=True)
    w_cos = (weighted * composed).sum(dim=1).min().item()
    print(f"eval cli (c) cache files {name_a} -> {name_c}: weighted tag {tag_ok}; one MM-3 "
          f"batch of {len(mm3_idx)}: launches {one_batch} (one stacked trunk: #1 {L}, #8 {L}); "
          f"encode_weighted against the weighted sum of encode_subset((m,)): min-cosine "
          f"{w_cos:.6f} (>= {MIN_COSINE}); map_avg2 weighted {res_c['map_avg2']:.6f} (on "
          f"{E_SAMPLE} of the queries), model fusion {res_b['map_avg2']:.6f}")
    if not tag_ok or w_cos < MIN_COSINE or one_batch != {n: trunk.get(n, 0) for n in counters}:
        fail(f"eval cli (c): tag {tag_ok}, min-cosine {w_cos}, launches {one_batch}")
    readings["c"].update(min_cosine=w_cos, one_batch_launches=one_batch)
    del model, weighted, composed, args
    seen["model"] = None

    # ---- (d) re-ranking with the defaults, the gallery from (b)'s cache
    recorded = []
    orders_fn = rerank.rerank_orders

    def recording(*a, **kw):
        recorded.append(orders_fn(*a, **kw))
        return recorded[-1]

    d_csv = os.path.join(out, "d.csv")
    rerank.rerank_orders = recording
    try:
        res_d, readings["d"] = drive("(d) --rerank", base + [
            f"--cache_dir={out}/cache_a", "--rerank", f"--submission={d_csv}"], trunk)
    finally:
        rerank.rerank_orders = orders_fn
    plain_equal = all(res_d["detail"][p]["mAP_plain"] == res_b["detail"][p]["mAP"]
                      for p in res_b["detail"])
    with open(d_csv) as f:
        d_rows = f.read().splitlines()[1:]
    heads = [" ".join(g_list[j] for j in row) for order in recorded[-len(res_b["detail"]):]
             for row in order[:, :depth]]
    csv_ok = [r.split(",")[1] for r in d_rows] == heads
    moved = sum(a != b for a, b in zip(d_rows, b_rows[1:]))
    print(f"eval cli (d) re-ranking (top_n 100, k1 20, k2 6, lambda 0.3): mAP_plain equal to "
          f"(b)'s mAP bit for bit on every plan {plain_equal} ({readings['d']['vision_batches']} "
          f"vision embed batches: the gallery came from (b)'s cache); map_avg2 re-ranked "
          f"{res_d['map_avg2']:.6f} against plain {res_b['map_avg2']:.6f}; by plan (re-ranked / "
          f"plain) " + json.dumps({p: [round(d["mAP"], 4), round(d["mAP_plain"], 4)]
                                   for p, d in res_d["detail"].items()})
          + f"; the CSV's rows are the re-ranked heads {csv_ok} ({moved} of {len(d_rows)} rows "
          "differ from (b)'s)")
    if not plain_equal or not csv_ok or readings["d"]["vision_batches"] >= \
            readings["b"]["vision_batches"]:
        fail(f"eval cli (d): mAP_plain {plain_equal}, CSV {csv_ok}")
    readings["d"].update(map_avg2=res_d["map_avg2"], map_avg2_plain=res_b["map_avg2"],
                         rows_moved=moved)

    # ---- (e) the token-reduced checkpoint: its own token_keep, 0, the block kernels
    tr_ckpt = os.path.join(tmp, "TR", "ckpt", "latest")
    ebase = [f"--dataset_root={root}", f"--model_path={tr_ckpt}", "--eval_split=val",
             f"--sample_ratio={E_SAMPLE}"]
    reduced = {"fused_mha": L - 1, "fused_mlp": L - 1}
    keeps = {}
    keep_fn = vit.MERVisionTransformer.keep_indices
    for i, (name, extra, per_batch) in enumerate((
            ("token_keep", [], reduced), ("token_keep=0", ["--token_keep=0"], reduced),
            ("block_impl=fused", ["--block_impl=fused"],
             {"fused_ln_qkv": L - 1, "fused_out_mlp": L - 1}))):
        log = keeps.setdefault(name, [])

        def keep(self, x, log=log):
            idx = keep_fn(self, x)
            log.append(idx.sort(dim=-1).values.cpu())
            return idx

        vit.MERVisionTransformer.keep_indices = keep
        try:
            _, readings[f"e {name}"] = drive(f"(e) {name}", ebase + [
                f"--cache_dir={out}/cache_e{i}"] + extra, per_batch)
        finally:
            vit.MERVisionTransformer.keep_indices = keep_fn
    names_e = [os.path.basename(cache_file(f"cache_e{i}")) for i in range(3)]
    with np.load(cache_file("cache_e0")) as z0, np.load(cache_file("cache_e2")) as z2:
        e_cos = float((z0["feats"] * z2["feats"]).sum(axis=1).min())
    rows = [(a != b).any(dim=-1) for a, b in zip(keeps["token_keep"], keeps["block_impl=fused"])]
    flipped, total = sum(int(r.sum()) for r in rows), sum(r.numel() for r in rows)
    print(f"eval cli (e) token-reduced checkpoint: cache tags {names_e} (distinct: "
          f"{len(set(names_e)) == 3}); keep sets recorded {[len(v) for v in keeps.values()]} "
          f"batches; the block kernels' plan against the default path: gallery min-cosine "
          f"{e_cos:.6f} (>= {TOKEN_FUSED_MIN_COSINE}; the promotion gate {MIN_COSINE}: "
          f"{'met' if e_cos >= MIN_COSINE else 'missed'}), keep sets differ in {flipped} of "
          f"{total} rows")
    if len(set(names_e)) != 3 or keeps["token_keep=0"] or not keeps["token_keep"] or len(
            keeps["token_keep"]) != len(keeps["block_impl=fused"]) or e_cos < TOKEN_FUSED_MIN_COSINE:
        fail(f"eval cli (e): tags {names_e}, min-cosine {e_cos}, keep sets "
             f"{[len(v) for v in keeps.values()]}")
    readings["e"] = dict(min_cosine_fused=e_cos, keep_rows_differ=flipped, keep_rows=total)

    # ---- token reduction on a resident batch of BATCH
    gen = torch.Generator(device=dev).manual_seed(13)
    Mv = len(cfg.vision_modalities)
    images = torch.randint(0, 256, (BATCH, Mv, cfg.image_size, cfg.image_size, 3),
                           generator=gen, device=dev, dtype=torch.uint8)
    image_mask = torch.ones(BATCH, Mv, device=dev)
    full_cfg = cfg.replace(use_pallas_attention=True, use_fused_mlp=True)
    paths = {"full": full_cfg, "reduced": full_cfg.replace(token_keep=TOKEN_KEEP,
                                                           token_reduce_layer=TOKEN_LAYER)}
    steps = {n: factories[0](build_model(c, params, device=dev), ("vis",))
             for n, c in paths.items()}
    rates, device_ms = {n: [] for n in steps}, {}
    for name, step in steps.items():
        zero()
        step(images, image_mask)
        torch.cuda.synchronize()
        if counts() != {n: reduced.get(n, 0) for n in counters}:
            fail(f"resident {name}: launch counts {counts()}")
    for rnd in range(E2E_ROUNDS):
        for name in (list(steps) if rnd % 2 == 0 else list(steps)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(E2E_ITERS):
                steps[name](images, image_mask)
            torch.cuda.synchronize()
            rates[name].append(BATCH * E2E_ITERS / (time.perf_counter() - t0))
    profiler_ms = {}
    for name, step in steps.items():
        device_ms[name], profiler_ms[name], _, _ = device_reading(
            torch, lambda: step(images, image_mask), f"token reduction resident {name}")
    eps = {n: statistics.median(r) for n, r in rates.items()}
    work = (TOKEN_LAYER * (cfg.num_patches + 1) + (L - 1 - TOKEN_LAYER) * S_RED) / (
        (L - 1) * (cfg.num_patches + 1))
    print(f"eval cli token reduction on a resident batch of {BATCH} ({card}; pallas_attention + "
          f"fused_mlp): {eps['reduced']:.1f} embeds/s against {eps['full']:.1f} without "
          f"({eps['reduced'] / eps['full']:.3f}x; rounds {json.dumps(rates)}); device ms a step "
          f"{device_ms['reduced']:.3f} against {device_ms['full']:.3f} "
          f"({device_ms['reduced'] / max(device_ms['full'], 1e-9):.3f}; the blocks' per-token work "
          f"{work:.3f})")
    readings["resident"] = dict(embeds_per_s=eps, rounds=rates, device_ms=device_ms,
                                profiler_ms=profiler_ms, block_token_work=work)
    del steps, images
    torch.cuda.empty_cache()

    readings["rerank"] = rerank_phase(torch, dev, card)
    return readings


def serving_phase(torch, cfg, counters, dev, card, tmp):
    """The serving path at full width on the card (phase 4f, see the module
    docstring): tools_torch/serve_embed.py's command line and its server on
    phase 4d's run A and phase 4c's tree, then the search-side benchmarks;
    fails the run on any failed check and returns the readings."""
    import base64
    import contextlib
    import gc
    import glob
    import io
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    from PIL import Image

    from prcv2025reid_tpu_torch import TrainingConfig
    from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset
    from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer
    from prcv2025reid_tpu_torch.engine import make_combo_embed_step
    from prcv2025reid_tpu_torch.evaluation.protocol import embed_samples, similarity
    from prcv2025reid_tpu_torch.evaluation.rerank import _rerank_full, rerank_orders, stable_topk
    from prcv2025reid_tpu_torch.ops import _kernels
    from prcv2025reid_tpu_torch.utils.timing import device_ms
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    serve = load_tool("serve_embed")
    L = cfg.vision_layers
    trunk = {"fused_mha": L, "fused_mlp": L, "fused_residual_ln": 2 * L}
    root, out = os.path.join(tmp, "orbench"), os.path.join(tmp, "F")
    os.makedirs(out)
    a_ckpt, e1_ckpt = (os.path.join(tmp, "A", "ckpt", n) for n in ("best", "epoch_1"))
    readings = {}

    def counts():
        return {n: f.launches for n, f in counters.items()}

    def zero():
        torch.cuda.synchronize()
        for counter in counters.values():
            counter.launches = 0

    def times(per, n):
        return {k: v * n for k, v in per.items()}

    def expect(label, per_batch):
        torch.cuda.synchronize()
        got, want = counts(), {n: per_batch.get(n, 0) for n in counters}
        if got != want:
            fail(f"serving {label}: launch counts {got} != {want}")
        return got

    def quiet(fn, *args, **kw):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = fn(*args, **kw)
        return result, buf.getvalue()

    # ---- (a) the command line: the tree's vis files and captions to npz files
    with open(os.path.join(a_ckpt, "host_state.json")) as f:
        cfg_a = TrainingConfig.from_json(json.load(f)["config"])
    B = cfg_a.eval_batch_size
    config, model = serve._load_model(a_ckpt, device=dev)
    ds = MultiModalDataset(cfg_a, split="val")  # every record of the tree, as --eval_split all
    idx = [i for i, r in enumerate(ds.records) if r.vis]
    tok = build_tokenizer(cfg_a.tokenizer_vocab_path, cfg_a.text_vocab_size,
                          cfg_a.text_context_length)
    vis_step = make_combo_embed_step(model, ("vis",))
    t0 = time.perf_counter()
    want_vis, _ = embed_samples(vis_step, ds, idx, tok, B)
    samples_s = time.perf_counter() - t0
    vis_files = sorted(glob.glob(os.path.join(root, "vis", "*", "*.jpg")))
    pos = {os.path.abspath(ds.records[i].anchor_vis): j for j, i in enumerate(idx)}
    tree_npz = os.path.join(out, "tree_gallery.npz")
    zero()
    t0 = time.perf_counter()
    (feats, ids), _ = quiet(serve.main, [f"--model_path={a_ckpt}", f"--images={root}/vis/*/*.jpg",
                                         "--modality=vis", f"--out={tree_npz}",
                                         f"--batch_size={B}"])
    cli_vis_s = time.perf_counter() - t0
    n_batches = -(-len(vis_files) // B)
    got_a = expect("(a) --images", times(trunk, n_batches))
    want = want_vis[[pos[os.path.abspath(p)] for p in vis_files]]
    bits = feats.shape == want.shape and np.array_equal(feats, want)
    cos_a = float((feats * want).sum(axis=1).min()) if feats.shape == want.shape else -1.0
    ids_ok = ids == [os.path.splitext(os.path.basename(p))[0] for p in vis_files]
    with open(os.path.join(root, "text_annos.json")) as f:
        captions = [a["caption"] for a in json.load(f)]
    cap_txt = os.path.join(out, "captions.txt")
    with open(cap_txt, "w") as f:
        f.write("\n".join(captions) + "\n")
    zero()
    t0 = time.perf_counter()
    (t_feats, _), _ = quiet(serve.main, [f"--model_path={a_ckpt}", f"--text={cap_txt}",
                                         f"--out={os.path.join(out, 'text.npz')}",
                                         f"--batch_size={B}"])
    cli_text_s = time.perf_counter() - t0
    expect("(a) --text", {})
    text_step = make_combo_embed_step(model, ("text",))
    Mv, S = len(cfg_a.vision_modalities), cfg_a.image_size
    no_images = torch.zeros((B, Mv, S, S, 3), dtype=torch.uint8, device=dev)
    want_t = []
    for start in range(0, len(captions), B):
        chunk = captions[start:start + B]
        mask = np.zeros((B,), np.float32)
        mask[:len(chunk)] = 1.0
        want_t.append(text_step(no_images, torch.zeros((B, Mv), device=dev),
                                tok(chunk + [""] * (B - len(chunk))).astype(np.int32),
                                mask).cpu().numpy()[:len(chunk)])
    text_bits = np.array_equal(t_feats, np.concatenate(want_t))
    print(f"serving (a) serve_embed.py --images on the tree's {len(vis_files)} vis files, batch "
          f"{B} ({cli_vis_s:.1f} s, the checkpoint's load included; embed_samples {samples_s:.1f} "
          f"s): launches {got_a} ({n_batches} vision batches); features equal embed_samples' bit "
          f"for bit {bits} (min-cosine {cos_a:.7f}), ids the files' stems {ids_ok}; --text on the "
          f"tree's {len(captions)} captions ({cli_text_s:.1f} s): launches 0, features equal the "
          f"text step's bit for bit {text_bits}")
    if not ids_ok or not text_bits or not (bits or cos_a >= SERVE_MIN_COSINE):
        fail(f"serving (a): vis bits {bits} (min-cosine {cos_a}), ids {ids_ok}, text {text_bits}")
    readings["a"] = dict(vis_bit_for_bit=bits, vis_min_cosine=cos_a, text_bit_for_bit=text_bits,
                         cli_vis_s=cli_vis_s, cli_text_s=cli_text_s,
                         embed_samples_s=samples_s, launches=got_a, vision_batches=n_batches)
    del vis_step, text_step, want_vis, want, want_t, t_feats

    # ---- (b) the server, in this process on 127.0.0.1: one on the 45k gallery
    # (--serve_gallery, phase 4e (f)'s clustered set), one on the tree's gallery
    tune = load_tool("tune_rerank")
    per_id = RR_GALLERY // RR_IDS
    q_cl, _, g_cl, _ = tune.make_clustered(n_ids=RR_IDS, per_id_g=per_id, n_distract=3,
                                           n_q=SERVE_QUERIES, dim=512, **RR_SIGMAS)
    big_npz = os.path.join(out, "gallery_45k.npz")
    np.savez(big_npz, features=g_cl[:RR_GALLERY],
             ids=np.asarray([str(i) for i in range(RR_GALLERY)]))
    del g_cl
    Bs = config.inference_batch_size
    engine = serve.make_engine(config, model, Bs)
    del model  # the engine holds it: a reload frees it
    t0 = time.perf_counter()
    serve.warmup_engine(config, engine)
    warm_s = time.perf_counter() - t0
    big, tree = serve.open_gallery(config, big_npz, dev), serve.open_gallery(config, tree_npz, dev)
    rr = dict(SERVE_RR, default=False)
    target = [e1_ckpt]
    servers = [serve.make_server(0, "127.0.0.1", config, engine, gallery=big, rerank=rr,
                                 reloader=lambda: serve._load_model(target[0], device=dev)[1]),
               serve.make_server(0, "127.0.0.1", config, engine, gallery=tree, rerank=rr)]
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    url, tree_url = (f"http://127.0.0.1:{s.server_address[1]}" for s in servers)

    def post(base, route, obj):
        req = urllib.request.Request(base + route, data=json.dumps(obj).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def ok(base, route, obj):
        code, body = post(base, route, obj)
        if code != 200:
            fail(f"serving: POST {route} -> {code} {body}")
        return body

    def b64(path):
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()

    def pil(path):
        with Image.open(path) as im:
            im.load()
            return im.copy()

    files = {m: sorted(glob.glob(os.path.join(root, m, "*", "*.jpg")))
             for m in ("vis", "nir", "sk", "cp")}

    def query(i, mods):
        q = {m: files[m][i] for m in mods if m != "text"}
        if "text" in mods:
            q["text"] = captions[i]
        return q

    def as_http(q):
        return {m: (v if m == "text" else b64(v)) for m, v in q.items()}

    def as_pil(q):
        return {m: (v if m == "text" else pil(v)) for m, v in q.items()}

    def embedded(body):
        return np.asarray(body["embeddings"], np.float32)

    checks, per_batch = {}, {}
    for label, obj, direct, n_vision in (
            ("vis", {"images_b64": [b64(p) for p in files["vis"][:Bs]], "modality": "vis"},
             lambda: engine.embed_pils([pil(p) for p in files["vis"][:Bs]], "vis"), 1),
            ("nir", {"images_b64": [b64(p) for p in files["nir"][:5]], "modality": "nir"},
             lambda: engine.embed_pils([pil(p) for p in files["nir"][:5]], "nir"), 1),
            ("texts", {"texts": captions[:Bs]}, lambda: engine.embed_texts(captions[:Bs]), 0),
            ("MM-2/3/4 queries", {"queries": [as_http(query(i, m)) for i, m in enumerate(
                MM_SERVE_COMBOS)]}, lambda: engine.embed_queries([as_pil(query(i, m)) for i, m in
                                                                  enumerate(MM_SERVE_COMBOS)]),
             len(set(MM_SERVE_COMBOS)))):
        zero()
        body = ok(url, "/embed", obj)
        per_batch[label] = expect(f"(b) /embed {label}", times(trunk, n_vision))
        checks[label] = np.array_equal(embedded(body), direct())
    print(f"serving (b) /embed against direct engine calls, bit for bit: {checks}; launches: "
          + json.dumps(per_batch) + f" (a vision batch: {trunk}; a text batch: none; the "
          f"queries: one batch a combo, {len(set(MM_SERVE_COMBOS))} combos); warm-up "
          f"{warm_s:.1f} s")
    if not all(checks.values()):
        fail(f"serving (b): /embed differs from the engine: {checks}")

    # 32 concurrent one-image requests against the sequential answers
    conc = files["vis"][Bs:Bs + SERVE_CONCURRENT]
    sequential = [engine.embed_pils([pil(p)], "vis")[0] for p in conc]
    d0, r0 = servers[0].batcher.dispatches, servers[0].batcher.requests
    answers, gate = [None] * len(conc), threading.Barrier(len(conc))

    def one(i):
        gate.wait()
        answers[i] = post(url, "/embed", {"images_b64": [b64(conc[i])], "modality": "vis"})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(conc))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    conc_ok = all(a is not None and a[0] == 200 and np.array_equal(embedded(a[1])[0], s)
                  for a, s in zip(answers, sequential))
    dispatches = servers[0].batcher.dispatches - d0
    requests = servers[0].batcher.requests - r0
    print(f"serving (b) {len(conc)} concurrent one-image requests equal the sequential answers "
          f"bit for bit: {conc_ok}; the batcher: {dispatches} dispatches for {requests} requests")
    if not conc_ok or requests != len(conc):
        fail(f"serving (b): concurrent answers {conc_ok}, {requests} requests")
    readings["b"] = dict(bit_for_bit=checks, launches=per_batch, concurrent_equal=conc_ok,
                         dispatches=dispatches, requests=requests, warmup_s=warm_s)

    # ---- (c) search: the store against stable_topk / rerank_orders on its features
    n = big.size
    g_ref = torch.from_numpy(big._feats.copy()).to(dev)
    qd = torch.from_numpy(q_cl).to(dev)
    got = big.search(q_cl, SERVE_RR["top_n"])
    ref_s, ref_i = stable_topk(similarity(qd, g_ref), SERVE_RR["top_n"])
    plain_ids = np.array_equal(np.asarray([[int(e["id"]) for e in r] for r in got]),
                               ref_i.cpu().numpy())
    plain_s = float(np.abs(np.asarray([[e["score"] for e in r] for r in got])
                           - ref_s.cpu().numpy()).max())
    got = big.search(q_cl, SERVE_RR["top_n"], rerank=SERVE_RR)
    ref = rerank_orders(qd, g_ref, **SERVE_RR, device=dev)
    rr_ids = np.array_equal(np.asarray([[int(e["id"]) for e in r] for r in got]), ref)
    texts = captions[:4]
    http = {lbl: ok(url, "/search", {"texts": texts, "top_k": 10, "rerank": flag})["results"]
            for lbl, flag in (("plain", False), ("rerank", True))}
    tf = engine.embed_texts(texts)
    http_ok = (http["plain"] == big.search(tf, 10)
               and http["rerank"] == big.search(tf, 10, rerank=SERVE_RR))
    selfq = files["vis"][::len(files["vis"]) // 16][:16]
    res = ok(tree_url, "/search", {"images_b64": [b64(p) for p in selfq], "modality": "vis",
                                   "top_k": 5})["results"]
    own = sum(r[0]["id"] == os.path.splitext(os.path.basename(p))[0] for r, p in zip(res, selfq))
    print(f"serving (c) {SERVE_QUERIES} clustered queries against the {n} x 512 gallery "
          f"(--serve_gallery, capacity {big.capacity}): plain top-{SERVE_RR['top_n']} ids equal "
          f"stable_topk over similarity {plain_ids} (scores max |d| {plain_s:.2e}); re-ranked "
          f"(top_n {SERVE_RR['top_n']}, k1 {SERVE_RR['k1']}, k2 {SERVE_RR['k2']}, lambda "
          f"{SERVE_RR['lam']}) ids equal rerank_orders {rr_ids}; /search of 4 captions equals "
          f"the store's search, plain and re-ranked: {http_ok}; the tree's gallery ({tree.size} "
          f"rows): {own} of {len(selfq)} vis files queried by their own bytes return their own "
          f"id first")
    if not (plain_ids and plain_s == 0.0 and rr_ids and http_ok and own == len(selfq)):
        fail(f"serving (c): plain {plain_ids} ({plain_s}), rerank {rr_ids}, http {http_ok}, "
             f"self {own}/{len(selfq)}")
    readings["c"] = dict(plain_ids_equal=plain_ids, rerank_ids_equal=rr_ids, http_equal=http_ok,
                         self_top1=own, gallery=n, capacity=big.capacity)
    del g_ref, qd

    # ---- (d) enrollment on the tree's gallery: grow past a doubling, append in
    # place, remove, save; each step against a store rebuilt from scratch
    probe = [query(i, ("text",))["text"] for i in range(0, 64, 8)]
    pf = engine.embed_texts(probe)
    nir = files["nir"]
    # a store rebuilt from scratch takes the rows from where the live one took
    # them: the tree's npz and the engine's features of the enrolled images
    base_f, base_ids = serve.load_gallery(tree_npz)
    enr_f = np.concatenate([engine.embed_pils([pil(p) for p in nir[:6]], "nir"),
                            engine.embed_pils([pil(p) for p in nir[6:9]], "nir")])
    enr_ids = [f"enr{i}" for i in range(9)]

    def rebuilt_agrees(rows, keep=None):
        feats = np.concatenate([base_f, enr_f[:rows]])
        ids = base_ids + enr_ids[:rows]
        if keep is not None:
            feats, ids = feats[[i for i, x in enumerate(ids) if x not in keep]], \
                [x for x in ids if x not in keep]
        fresh = serve.GalleryStore(config.fusion_dim, feats, ids, device=dev)
        same_buf = tree.capacity == fresh.capacity and torch.equal(tree._snap[0], fresh._snap[0])
        http_plain = ok(tree_url, "/search", {"texts": probe, "top_k": 10})["results"]
        http_rr = ok(tree_url, "/search", {"texts": probe, "top_k": 10, "rerank": True})["results"]
        return same_buf and list(tree._ids) == ids and http_plain == fresh.search(pf, 10) \
            and http_rr == fresh.search(pf, 10, rerank=SERVE_RR)

    steps_d = []
    n_tree, cap0, buf0 = tree.size, tree.capacity, tree._snap[0]
    body = ok(tree_url, "/gallery/add", {"images_b64": [b64(p) for p in nir[:6]],
                                          "modality": "nir", "ids": enr_ids[:6]})
    steps_d.append(("add 6", body["gallery_size"], tree.capacity, tree._snap[0] is buf0,
                    rebuilt_agrees(6)))
    buf1 = tree._snap[0]
    body = ok(tree_url, "/gallery/add", {"images_b64": [b64(p) for p in nir[6:9]],
                                          "modality": "nir", "ids": enr_ids[6:9]})
    steps_d.append(("add 3", body["gallery_size"], tree.capacity, tree._snap[0] is buf1,
                    rebuilt_agrees(9)))
    drop = [tree._ids[0], tree._ids[5], "enr1"]
    body = ok(tree_url, "/gallery/remove", {"ids": drop})
    steps_d.append((f"remove {body['removed']}", body["gallery_size"], tree.capacity,
                    tree._snap[0] is buf1, rebuilt_agrees(9, keep=set(drop))))
    saved = ok(tree_url, "/gallery/save", {})
    s_feats, s_ids = serve.load_gallery(saved["saved"])
    file_ok = s_ids == list(tree._ids) and float(np.abs(s_feats - tree._feats).max()) <= 1e-6
    print(f"serving (d) enrollment on {n_tree} rows at capacity {cap0}: (step, size, capacity, "
          f"buffer kept in place, search and buffer equal to a store rebuilt from scratch) "
          + json.dumps(steps_d) + f"; /gallery/save -> load_gallery equals the live state "
          f"{file_ok}")
    def capacity(rows):
        c = 128  # GalleryStore's min_capacity
        while c < rows:
            c *= 2
        return c

    n0 = n_tree
    want_d = [(n0 + 6, capacity(n0 + 6), capacity(n0 + 6) == cap0),
              (n0 + 9, capacity(n0 + 9), capacity(n0 + 9) == capacity(n0 + 6)),
              (n0 + 6, capacity(n0 + 6), False)]
    if [s[1:4] for s in steps_d] != want_d or not all(s[4] for s in steps_d) or not file_ok \
            or capacity(n0 + 6) == cap0:
        fail(f"serving (d): {steps_d} (expected {want_d}), file {file_ok}")
    readings["d"] = dict(steps=steps_d, file_equal=file_ok)

    # ---- (e) hot reload to epoch 1 of the same run
    libs = dict(_kernels._libs)
    n_logs = len(_kernels.build_logs)
    vis8 = files["vis"][:Bs]
    mm = [as_http(query(i, m)) for i, m in enumerate(MM_SERVE_COMBOS)]
    before = embedded(ok(url, "/embed", {"images_b64": [b64(p) for p in vis8],
                                         "modality": "vis"}))
    gc.collect()
    torch.cuda.synchronize()
    mem = [torch.cuda.memory_allocated()]
    t0 = time.perf_counter()
    body = ok(url, "/admin/reload", {})
    reload_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    mem.append(torch.cuda.memory_allocated())
    after = {"vis": embedded(ok(url, "/embed", {"images_b64": [b64(p) for p in vis8],
                                                "modality": "vis"})),
             "texts": embedded(ok(url, "/embed", {"texts": captions[:Bs]})),
             "queries": embedded(ok(url, "/embed", {"queries": mm}))}
    fresh = serve.make_engine(config, serve._load_model(e1_ckpt, device=dev)[1], Bs)
    direct = {"vis": fresh.embed_pils([pil(p) for p in vis8], "vis"),
              "texts": fresh.embed_texts(captions[:Bs]),
              "queries": fresh.embed_queries([as_pil(query(i, m))
                                              for i, m in enumerate(MM_SERVE_COMBOS)])}
    reload_ok = {k: np.array_equal(after[k], direct[k]) for k in after}
    moved = not np.array_equal(before, after["vis"])
    del fresh
    gc.collect()
    torch.cuda.synchronize()
    mem.append(torch.cuda.memory_allocated())
    no_build = _kernels._libs == libs and len(_kernels.build_logs) == n_logs
    print(f"serving (e) /admin/reload to {os.path.basename(e1_ckpt)}/ ({reload_s:.2f} s, "
          f"fingerprint {body['weights_fingerprint']}): /embed equals a fresh engine on those "
          f"weights bit for bit {reload_ok}; the features moved {moved}; no kernel build "
          f"{no_build}; memory allocated on the card {[round(m / 1e9, 3) for m in mem]} GB "
          f"(before, after the reload, after the fresh engine went)")
    if not all(reload_ok.values()) or not moved or not no_build:
        fail(f"serving (e): reload {reload_ok}, moved {moved}, no build {no_build}")
    readings["e"] = dict(equal=reload_ok, moved=moved, no_build=no_build, reload_s=reload_s,
                         memory_gb=[m / 1e9 for m in mem])

    # ---- (f) readings: request latency, --benchmark, bench_query, bench_search
    cap1 = captions[:SERVE_LATENCY_N]
    quad = [as_http(query(i, ("nir", "sk", "cp", "text"))) for i in range(SERVE_LATENCY_N)]
    routes = {
        "embed_vis": ("/embed", [{"images_b64": [b64(p)], "modality": "vis"}
                                 for p in files["vis"][:SERVE_LATENCY_N]]),
        "embed_text": ("/embed", [{"texts": [c]} for c in cap1]),
        "embed_mm4": ("/embed", [{"queries": [q]} for q in quad]),
        "search_plain": ("/search", [{"texts": [c], "top_k": 10} for c in cap1]),
        "search_rerank": ("/search", [{"texts": [c], "top_k": 10, "rerank": True} for c in cap1]),
    }
    latency = {}
    for name, (route, bodies) in routes.items():
        ms = []
        for obj in bodies:
            t0 = time.perf_counter()
            ok(url, route, obj)
            ms.append((time.perf_counter() - t0) * 1e3)
        latency[name] = dict(p50=float(np.percentile(ms, 50)), p90=float(np.percentile(ms, 90)),
                             n=len(ms))
    # the device's share of a request: the device ms (utils/timing.py) of the
    # device work one request makes, on resident inputs (a pageable copy in
    # the timed call would stall the host behind the spin kernel), against
    # its p50; the weights do not change the time
    vis_slots = {m: i for i, m in enumerate(config.vision_modalities)}
    gen = torch.Generator(device=dev).manual_seed(5)
    img8 = torch.randint(0, 256, (Bs, len(vis_slots), S, S, 3), generator=gen, device=dev,
                         dtype=torch.uint8)
    masks = {c: torch.tensor([[1.0 if m in c else 0.0 for m in vis_slots]] * Bs, device=dev)
             for c in (("vis",), ("nir", "sk", "cp"))}
    tok8 = torch.from_numpy(tok(captions[:Bs]).astype(np.int32)).to(dev)
    tmask = torch.ones(Bs, device=dev)
    f_model = serve._load_model(a_ckpt, device=dev)[1]
    steps_f = {c: make_combo_embed_step(f_model, c)
               for c in (("vis",), ("text",), ("nir", "sk", "cp", "text"))}
    q1 = torch.from_numpy(engine.embed_texts(captions[:1])).to(dev)
    live = big._snap[0][:n]
    parts = {"embed_vis": lambda: steps_f[("vis",)](img8, masks[("vis",)]),
             "embed_text": lambda: steps_f[("text",)](img8, masks[("vis",)] * 0, tok8, tmask),
             "embed_mm4": lambda: steps_f[("nir", "sk", "cp", "text")](
                 img8, masks[("nir", "sk", "cp")], tok8, tmask),
             "search_plain": lambda: stable_topk(similarity(q1, live), 10),
             "search_rerank": lambda: _rerank_full(q1, live, None, None, SERVE_RR["lam"],
                                                   SERVE_RR["k1"], SERVE_RR["k2"],
                                                   SERVE_RR["top_n"])}
    dms = {k: device_ms(fn) for k, fn in parts.items()}
    del steps_f, f_model
    for k, v in latency.items():
        v["device_ms"] = dms[k] + (dms["embed_text"] if k.startswith("search") else 0.0)
        v["device_share"] = v["device_ms"] / v["p50"]
    # torch.profiler's kernel sum against CUDA events on one ranking call this
    # late in the process (utils/timing.py uses events: the sums drop kernels)
    q_rank = torch.from_numpy(q_cl).to(dev)

    def rank():
        return stable_topk(similarity(q_rank, big._snap[0][:n]), SERVE_RR["top_n"])

    rank()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rank()
        torch.cuda.synchronize()
    rank_prof = sum(device_time(e) for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    rank_events = device_ms(rank)
    rank_bound, _ = bound_ms([(2 * len(q_cl) * n * 512, PEAK_F32_FLOPS)], 0)
    readings["profiler_check"] = dict(profiler_ms=rank_prof, events_ms=rank_events,
                                      product_bound_ms=rank_bound)
    print(f"serving (f) one ranking call ({len(q_cl)} x {n} x 512, top {SERVE_RR['top_n']}): "
          f"torch.profiler's kernel sum {rank_prof:.4f} ms, CUDA events {rank_events:.4f} ms, "
          f"the f32 product's bound alone {rank_bound:.4f} ms")
    print(f"serving (f) request latency ({card}; one client, sequential, {SERVE_LATENCY_N} "
          f"requests a route, batch {Bs}, the {n}-row gallery) ms: " + json.dumps(
              {k: [round(v["p50"], 3), round(v["p90"], 3)] for k, v in latency.items()})
          + " (p50, p90); device ms of a request's device work on resident inputs (the "
          "search's include its caption's embed) and its share of p50: " + json.dumps({k: [round(v["device_ms"], 3),
                                                 round(v["device_share"], 3)]
                                             for k, v in latency.items()}))
    for srv in servers:
        srv.shutdown()
        srv.server_close()
    del engine, servers, big, tree
    gc.collect()
    torch.cuda.empty_cache()

    bench = {}
    for b in (BATCH, Bs):  # the gallery batch and the serving batch
        zero()
        bench[b], _ = quiet(serve.main, [f"--model_path={a_ckpt}", "--benchmark",
                                         f"--batch_size={b}"])
        got_bench = expect("--benchmark", times(trunk, 32))  # 2 warm + 10 + 10 x 2 calls
        print(f"serving (f) serve_embed.py --benchmark at batch {b} ({card}): "
              f"{json.dumps(bench[b])}; launches {got_bench}; wall ms a call (one host "
              f"call a batch) {b / bench[b]['embeds_per_sec_serving'] * 1e3:.3f}, device ms "
              f"{b / bench[b]['embeds_per_sec'] * 1e3:.3f}")
    bq = load_tool("bench_query")
    queries_s = {}
    for name, extra in (("xla", []), ("fused_trunk", ["--set=use_fused_resln=true",
                                                     "--set=use_fused_mlp=true",
                                                     "--set=use_pallas_attention=true"])):
        queries_s[name], _ = quiet(bq.main, [f"--batch={BATCH}", f"--iters={SERVE_BQ_ITERS}",
                                             *extra])
        print(f"serving (f) bench_query.py {name} at batch {BATCH} ({card}): queries/s and "
              f"device ms " + json.dumps({p: [r["queries_per_sec"], r["device_ms"]]
                                          for p, r in queries_s[name]["paths"].items()}))
    bs = load_tool("bench_search")
    search, _ = quiet(bs.main, [])
    print(f"serving (f) bench_search.py at its defaults ({card}): {json.dumps(search['paths'])}")
    gc.collect()
    torch.cuda.empty_cache()
    readings["f"] = dict(latency_ms=latency, benchmark=bench, bench_query=queries_s,
                         bench_search=search["paths"], seconds=time.perf_counter() - t_phase)
    return readings


def hf_clip_checkpoint(cfg, seed: int):
    """A seeded state dict in HF ``CLIPModel``'s layout at ``cfg``'s widths
    (``tools/convert_clip.hf_clip_shapes``): f32 weights of std 0.02, biases
    of std 0.01, LayerNorm scales 1 + 0.02 noise, the position ids as HF
    stores them; numpy, on the host."""
    import numpy as np

    from prcv2025reid_tpu_torch.tools.convert_clip import hf_clip_shapes

    rng = np.random.default_rng(seed)
    out = {}
    for key, (shape, dtype) in hf_clip_shapes(cfg).items():
        if key.endswith("position_ids"):
            out[key] = np.arange(shape[1], dtype=dtype)[None]
        elif key == "logit_scale":
            out[key] = np.array(np.log(1 / 0.07), dtype)
        elif "norm" in key and key.endswith(".weight"):
            out[key] = 1.0 + 0.02 * rng.standard_normal(shape, np.float32)
        elif key.endswith(".bias"):
            out[key] = 0.01 * rng.standard_normal(shape, np.float32)
        else:
            out[key] = 0.02 * rng.standard_normal(shape, np.float32)
    return out


def clip_leaf_pairs(cfg):
    """(port key under params/encoder/, HF key, the layout change) for every
    leaf the conversion copies from the file (the noisy patch-embed copies
    aside): the reference's composition, written out from the published
    layouts (torch Linear [out, in] -> [in, out], conv [D, C, P, P] ->
    [P, P, C, D])."""
    def same(a):
        return a

    def t(a):
        return a.T

    pairs = [("vision/cls_token", "vision_model.embeddings.class_embedding",
              lambda a: a.reshape(1, 1, -1)),
             ("vision/pos_embed", "vision_model.embeddings.position_embedding.weight", same),
             ("vision/patch_embed_vis/kernel", "vision_model.embeddings.patch_embedding.weight",
              lambda a: a.transpose(2, 3, 1, 0)),
             ("vision/ln_final/scale", "vision_model.post_layernorm.weight", same),
             ("vision/ln_final/bias", "vision_model.post_layernorm.bias", same),
             ("vision/proj/kernel", "visual_projection.weight", t),
             ("text/token_embedding/embedding", "text_model.embeddings.token_embedding.weight",
              same),
             ("text/pos_embed", "text_model.embeddings.position_embedding.weight", same),
             ("text/ln_final/scale", "text_model.final_layer_norm.weight", same),
             ("text/ln_final/bias", "text_model.final_layer_norm.bias", same),
             ("text_proj/kernel", "text_projection.weight", t)]
    for tower, layers, attn, mlp in (("vision", cfg.vision_layers, "attn/", "mlp/"),
                                     ("text", cfg.text_layers, "", "")):
        hf_tower = f"{tower}_model.encoder.layers"
        shared = "/shared" if tower == "vision" else ""
        for i in range(layers):
            at, p = f"{tower}/block_{i}/", f"{hf_tower}.{i}."
            for n in ("1", "2"):
                pairs += [(f"{at}ln{n}/scale", f"{p}layer_norm{n}.weight", same),
                          (f"{at}ln{n}/bias", f"{p}layer_norm{n}.bias", same)]
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                pairs += [(f"{at}{attn}{proj}{shared}/kernel", f"{p}self_attn.{proj}.weight", t),
                          (f"{at}{attn}{proj}{shared}/bias", f"{p}self_attn.{proj}.bias", same)]
            for fc in ("fc1", "fc2"):
                pairs += [(f"{at}{mlp}{fc}{shared}/kernel", f"{p}mlp.{fc}.weight", t),
                          (f"{at}{mlp}{fc}{shared}/bias", f"{p}mlp.{fc}.bias", same)]
    return pairs


def clip_vision_oracle(torch, hf, images, cfg, dev):
    """The reference's vision composition on the HF tensors in plain PyTorch,
    f32, independent of the port's modules: conv patchify, CLS + positions,
    blocks of LN1 -> MHA (SDPA) -> residual and LN2 -> fc1 -> erf GELU ->
    fc2 -> residual, the post-LN of the CLS row, the projection.  The
    vision tower's GELU is erf, not CLIP's quick_gelu (the reference's
    composition, JAX ``models/mer.py:373``).  ``images``: normalized f32
    [B, H, W, 3]."""
    import torch.nn.functional as Fn

    w = {k: torch.from_numpy(v).to(dev) for k, v in hf.items()
         if k.startswith("vision_model.") or k == "visual_projection.weight"}
    D, H = cfg.vision_hidden_dim, cfg.vision_heads
    with torch.no_grad():
        x = Fn.conv2d(images.permute(0, 3, 1, 2),
                      w["vision_model.embeddings.patch_embedding.weight"], stride=cfg.patch_size)
        B = x.shape[0]
        x = x.flatten(2).transpose(1, 2)
        cls = w["vision_model.embeddings.class_embedding"].reshape(1, 1, D).expand(B, 1, D)
        x = torch.cat([cls, x], dim=1) + w["vision_model.embeddings.position_embedding.weight"]
        S = x.shape[1]
        for i in range(cfg.vision_layers):
            p = f"vision_model.encoder.layers.{i}."

            def lin(h, name):
                return Fn.linear(h, w[p + name + ".weight"], w[p + name + ".bias"])

            def heads(t):
                return t.reshape(B, S, H, D // H).transpose(1, 2)

            h = Fn.layer_norm(x, (D,), w[p + "layer_norm1.weight"], w[p + "layer_norm1.bias"], 1e-5)
            a = Fn.scaled_dot_product_attention(*(heads(lin(h, f"self_attn.{n}_proj"))
                                                  for n in "qkv"))
            x = x + lin(a.transpose(1, 2).reshape(B, S, D), "self_attn.out_proj")
            h = Fn.layer_norm(x, (D,), w[p + "layer_norm2.weight"], w[p + "layer_norm2.bias"], 1e-5)
            x = x + lin(Fn.gelu(lin(h, "mlp.fc1")), "mlp.fc2")
        x = Fn.layer_norm(x[:, 0], (D,), w["vision_model.post_layernorm.weight"],
                          w["vision_model.post_layernorm.bias"], 1e-5)
        return Fn.linear(x, w["visual_projection.weight"])


def clip_phase(torch, cfg, counters, dev, card, tmp):
    """Training from CLIP weights at full width on the card (see the module
    docstring, phase 4g); fails the run on any failed check and returns the
    readings.  ``tmp``: the scratch directory whose ``orbench`` tree phase
    4c wrote."""
    import contextlib
    import io

    import numpy as np

    from prcv2025reid_tpu_torch import (
        TrainingConfig,
        build_model,
        engine,
        init_train_state,
        make_combo_embed_step,
        make_train_step,
    )
    from prcv2025reid_tpu_torch.params import init_params
    from prcv2025reid_tpu_torch.tools import convert_clip, diagnose, export_params
    from prcv2025reid_tpu_torch.training import trainer as trainer_module
    from prcv2025reid_tpu_torch.training.param_groups import label_params

    L = cfg.vision_layers
    root = os.path.join(tmp, "orbench")
    readings, t_phase = {}, time.perf_counter()

    def counts():
        return {n: f.launches for n, f in counters.items()}

    def zero():
        for counter in counters.values():
            counter.launches = 0
        torch.cuda.synchronize()

    # ---- (a) the checkpoint: HF's layout at ViT-B/16's widths, three ways
    t0 = time.perf_counter()
    hf = hf_clip_checkpoint(cfg, seed=15)
    st_dir, bin_dir = os.path.join(tmp, "clip"), os.path.join(tmp, "clip_bin")
    os.makedirs(st_dir)
    os.makedirs(bin_dir)
    st_file = os.path.join(st_dir, "model.safetensors")
    convert_clip.write_safetensors(st_file, hf)
    torch.save({k: torch.from_numpy(v) for k, v in hf.items()},
               os.path.join(bin_dir, "pytorch_model.bin"))
    # the hub cache's layout: refs/main names the snapshot, whose file links
    # to a blob
    repo = os.path.join(tmp, "hub", "models--" + cfg.clip_model_name.replace("/", "--"))
    rev = "0" * 40
    os.makedirs(os.path.join(repo, "snapshots", rev))
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(rev)
    os.symlink(st_file, os.path.join(repo, "snapshots", rev, "model.safetensors"))
    n_values = sum(v.size for v in hf.values())
    readings["checkpoint"] = dict(values=n_values, bytes=os.path.getsize(st_file),
                                  seconds=time.perf_counter() - t0)
    print(f"clip (a) an HF-layout checkpoint at {cfg.clip_model_name}'s widths: {len(hf)} "
          f"tensors, {n_values} values, {os.path.getsize(st_file) / 1e6:.1f} MB safetensors "
          f"(+ pytorch_model.bin, + a hub cache entry) in {time.perf_counter() - t0:.1f} s")

    # ---- (b) every path loads the same values; the converted leaves are the
    # file's; the kernels' embedding against the plain oracle
    t0 = time.perf_counter()
    hub_env = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = os.path.join(tmp, "hub")
    try:
        loads = {"snapshot dir": convert_clip.load_hf_state_dict(st_dir),
                 ".bin dir": convert_clip.load_hf_state_dict(bin_dir),
                 '"hf" (hub cache)': convert_clip.load_hf_state_dict(
                     convert_clip.clip_source(TrainingConfig(clip_weights_path="hf")))}
    finally:
        if hub_env is None:
            os.environ.pop("HF_HUB_CACHE")
        else:
            os.environ["HF_HUB_CACHE"] = hub_env
    same = {name: set(sd) == set(hf) and all(np.array_equal(sd[k], hf[k]) for k in hf)
            for name, sd in loads.items()}
    del loads
    flat = convert_clip.convert_clip_params(hf, init_params(cfg, NUM_CLASSES, perturb=False),
                                            seed=cfg.seed)
    pairs = clip_leaf_pairs(cfg)
    off = [pk for pk, hk, fn in pairs if not np.array_equal(flat["params/encoder/" + pk],
                                                            fn(hf[hk]))]
    print(f"clip (b) loads equal to the written values: {same}; {len(pairs)} converted leaves "
          f"equal the file's tensors (transposed) bit for bit, {len(off)} differ "
          f"({time.perf_counter() - t0:.1f} s)")
    if not all(same.values()) or off:
        fail(f"clip load: paths {same}, leaves differ {off[:5]}")
    trunk_cfg = cfg.replace(use_pallas_attention=True, use_fused_mlp=True, use_fused_resln=True)
    model = build_model(trunk_cfg, flat, device=dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    imgs = torch.randn(CLIP_ORACLE_BATCH, cfg.image_size, cfg.image_size, 3, generator=gen,
                       device=dev)
    zero()
    with torch.inference_mode():
        got = model.encoder.encode_vision(imgs, 0).float()
    torch.cuda.synchronize()
    launched = counts()
    want = {n: 0 for n in counters}
    want.update(fused_mha=L, fused_mlp=L, fused_residual_ln=2 * L)
    oracle = clip_vision_oracle(torch, hf, imgs, cfg, dev)
    cos = torch.nn.functional.cosine_similarity(got, oracle, dim=1)
    readings["oracle_min_cosine"] = cos.min().item()
    print(f"clip (b) the vis embedding of {CLIP_ORACLE_BATCH} images on the fused-stream trunk "
          f"(bf16, the kernels) against the f32 oracle built from the HF tensors (erf GELU): "
          f"min-cosine {cos.min().item():.6f} (>= {MIN_COSINE}); launches {launched} (expected "
          f"{want})")
    if cos.min().item() < MIN_COSINE or not torch.isfinite(got).all():
        fail(f"clip: the loaded model's vis embedding against the oracle: {cos.min().item()}")
    if launched != want:
        fail(f"clip oracle embed: launch counts {launched} != {want}")
    del model, oracle, got

    # ---- (c) training from the file through tools_torch/train.py
    Probe = probe_trainer(torch, trainer_module)

    class Snapshot(Probe):
        def __init__(self, config, device="cuda"):
            super().__init__(config, device)
            self.initial = {n: p.detach().clone() for n, p in self.model.named_parameters()}

    flags = trainer_argv(cfg, tmp, "CLIP", num_epochs=1, eval_every_n_epoch=1,
                         eval_include_patterns=",".join(CLIP_EVAL_PLANS),
                         clip_weights_path=st_dir)
    saved = trainer_module.Trainer
    zero()
    t0 = time.perf_counter()
    try:
        trainer_module.Trainer = Snapshot
        result = load_tool("train").main(flags)
    finally:
        trainer_module.Trainer = saved
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tr = Probe.made[-1]
    got = counts()
    vision_batches = tr.vision_batches + 1  # + the smoke test's forward
    want = {n: 0 for n in counters}
    want.update(fused_mha=(L - 1) * TRAINER_STEPS + L * vision_batches,
                fused_mlp=L * vision_batches, fused_residual_ln=2 * L * vision_batches)
    losses = torch.stack(tr.losses).tolist()
    named = dict(tr.model.named_parameters())
    start_off = [pk for pk, hk, fn in pairs
                 if not np.array_equal(tr.initial["encoder." + pk.replace("/", ".")]
                                       .cpu().numpy(), fn(hf[hk]))]
    frozen_moved = [n for n, p in named.items()
                    if not p.requires_grad and not torch.equal(p, tr.initial[n])]
    labels = label_params(tr.model, tr.config)
    moved = {}
    for n, p in named.items():
        if p.requires_grad:
            moved[labels[n]] = moved.get(labels[n], False) or not torch.equal(p, tr.initial[n])
    best = os.path.join(tmp, "CLIP", "ckpt", "best")
    print(f"clip (c) tools_torch/train.py --clip_weights_path={st_dir} ({TRAINER_STEPS} steps, "
          f"{len(tr.evals)} evaluations of {list(CLIP_EVAL_PLANS)}, {wall:.1f} s): the trainer "
          f"started from the file ({len(pairs)} leaves, {len(start_off)} differ); launches "
          f"{got} (expected {want}: #1 {L - 1} a train step, {vision_batches} vision forwards); "
          f"no host synchronisation in any step; frozen parameters unchanged: "
          f"{not frozen_moved}; trainable groups moved {moved}; total_loss "
          + " ".join(f"{v[0]:.4f}" for v in losses) + f"; best/ {os.path.isdir(best)}")
    if start_off or frozen_moved or not moved or not all(moved.values()):
        fail(f"clip training: leaves off the file {start_off[:5]}, frozen moved "
             f"{frozen_moved[:5]}, groups moved {moved}")
    if got != want:
        fail(f"clip training: launch counts {got} != {want}")
    if len(losses) != TRAINER_STEPS or not np.isfinite(losses).all() or not os.path.isdir(best):
        fail(f"clip training: {len(losses)} steps, a non-finite loss or no best/: {losses}")
    readings["train"] = dict(seconds=wall, launches=got, total_loss=[v[0] for v in losses],
                             groups_moved=moved, best_map=result["best_map"])
    del tr, named
    Probe.made.clear()
    torch.cuda.empty_cache()

    # ---- (d) remat_policy="dots" against "full" and no remat on the 8x4 step
    tcfg = cfg.replace(num_ids_per_batch=TRAIN_P, instances_per_id=TRAIN_K,
                       use_pallas_attention=True)
    variants = {"none": tcfg, "full": tcfg.replace(remat_blocks=True),
                "dots": tcfg.replace(remat_blocks=True, remat_policy="dots")}
    batch = train_batch(torch, cfg, dev, TRAIN_P, TRAIN_K, seed=11)
    grads, models, steps, states = {}, {}, {}, {}
    for name, vcfg in variants.items():
        models[name] = build_model(vcfg, flat, device=dev)
        grads[name] = group_grads(torch, models[name], vcfg, batch)[1]
    g_rel = {name: float(torch.cat([grads[name][g] - grads["full"][g] for g in grads["full"]])
                         .norm() / torch.cat(list(grads["full"].values())).norm())
             for name in ("dots", "none")}
    del grads
    for name, vcfg in variants.items():
        steps[name] = make_train_step(models[name], vcfg, 1)
        states[name] = counted_step(torch, counters, f"clip {name}", steps[name],
                                    init_train_state(models[name], vcfg, 1, seed=0), batch,
                                    {"fused_mha": L - 1 if name == "none" else 2 * L})[0]
    rates, peaks = {n: [] for n in variants}, {n: [] for n in variants}
    for rnd in range(CLIP_ROUNDS):
        for name in (list(variants) if rnd % 2 == 0 else list(variants)[::-1]):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(CLIP_ITERS):
                states[name], _ = steps[name](states[name], batch, SDM_WEIGHT, SDM_TAU)
            torch.cuda.synchronize()
            rates[name].append(CLIP_ITERS / (time.perf_counter() - t0))
            peaks[name].append((torch.cuda.max_memory_allocated() - base) / 1e9)
    remat = {}
    for name in variants:
        held = [states[name]]

        def one_step(name=name, held=held):
            held[0], _ = steps[name](held[0], batch, SDM_WEIGHT, SDM_TAU)

        dev_ms, prof_ms, _, _ = device_reading(torch, one_step, f"clip train step {name}")
        it_s = statistics.median(rates[name])
        remat[name] = dict(it_per_s=it_s, rounds_it_per_s=rates[name], device_ms=dev_ms,
                           profiler_ms=prof_ms, idle_share=1 - dev_ms / (1e3 / it_s),
                           peak_mem_gb=max(peaks[name]),
                           grad_rel_vs_full=g_rel.get(name, 0.0),
                           launches_per_step=L - 1 if name == "none" else 2 * L)
    print(f"clip (d) remat_policy on the 8x4 step, pallas_attention ({card}; CLIP weights, "
          f"{CLIP_ROUNDS} rounds of {CLIP_ITERS} steps in turns): step-1 gradients of dots "
          f"against full: relative error {g_rel['dots']:.3e} (<= {TRAIN_REMAT_REL}); no remat "
          f"against full {g_rel['none']:.3e} (CLS-only last block: another rounding); "
          + json.dumps({n: {k: (round(v, 4) if isinstance(v, float) else v)
                            for k, v in r.items() if k != "rounds_it_per_s"}
                        for n, r in remat.items()}))
    if g_rel["dots"] > TRAIN_REMAT_REL:
        fail(f"remat_policy='dots': step-1 gradients {g_rel['dots']} from full's")
    readings["remat"] = remat
    del models, steps, states, batch
    torch.cuda.empty_cache()

    # ---- (e) the exporter: (c)'s best/ -> npz -> params.load_params
    t0 = time.perf_counter()
    npz = os.path.join(tmp, "CLIP", "export.npz")
    export_params.main(["--model_path", best, "--out", npz])
    config, ref_model, _, _ = engine.load_checkpoint_model(best, dev)
    loaded = build_model(config, npz, device=dev)
    e_images = torch.randint(0, 256, (BATCH, len(cfg.vision_modalities), cfg.image_size,
                                      cfg.image_size, 3), generator=gen, device=dev,
                             dtype=torch.uint8)
    e_mask = torch.ones(BATCH, len(cfg.vision_modalities), device=dev)
    a = make_combo_embed_step(ref_model, ("vis",))(e_images, e_mask)
    b = make_combo_embed_step(loaded, ("vis",))(e_images, e_mask)
    exported_equal = torch.equal(a, b)
    print(f"clip (e) export_params on best/: {os.path.getsize(npz) / 1e9:.3f} GB; loaded back "
          f"through params.load_params, the vis embeddings of {BATCH} images equal bit for bit: "
          f"{exported_equal} ({time.perf_counter() - t0:.1f} s)")
    if not exported_equal:
        fail("the exported npz does not give the checkpoint's embeddings bit for bit")
    readings["export"] = dict(bytes=os.path.getsize(npz), seconds=time.perf_counter() - t0)
    del ref_model, loaded, a, b

    # ---- (f) the tools on (c)'s run
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = diagnose.main(["--model_path", best, "--dataset_root", root])
    zeros = [k for k, e in report.items() if e["zero_fraction"] > 0.99]
    nonfinite = [k for k, e in report.items() if e["nonfinite"]]
    flagged = [k for k, e in report.items() if e["flagged"]]
    print(f"clip (f) diagnose.py on best/: {len(report)} entries, {len(zeros)} flagged as zero, "
          f"{len(nonfinite)} non-finite, {len(flagged)} flagged in all "
          f"{flagged[:4]} ({time.perf_counter() - t0:.1f} s)")
    if zeros or nonfinite:
        fail(f"diagnose: entries flagged as zero {zeros[:5]} or non-finite {nonfinite[:5]}")
    t0 = time.perf_counter()
    panel = load_tool("diagnose_alignment").main(["--model_path", best, "--dataset_root", root])
    if len(panel) != 15 or not all(np.isfinite(list(e.values())).all() for e in panel.values()):
        fail(f"diagnose_alignment: {panel}")
    print(f"clip (f) diagnose_alignment.py: {len(panel)} modality pairs "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    probe_out = os.path.join(tmp, "CLIP", "probe.json")
    probe = load_tool("probe_sdm_breaking").main(
        ["--steps", str(CLIP_PROBE_STEPS), "--every", "5", "--lrs", "1e-4", "--taus", "0.18",
         "--out", probe_out])
    cell = probe["cells"][0]
    print(f"clip (f) probe_sdm_breaking.py --steps {CLIP_PROBE_STEPS} at full width "
          f"({time.perf_counter() - t0:.1f} s): " + json.dumps(cell))
    if len(probe["cells"]) != 1 or not np.isfinite([v for _, s, c in cell["trajectory"]
                                                    for v in (s, c)]).all():
        fail(f"probe_sdm_breaking: {probe}")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = load_tool("dryrun_real_data").main(
            ["--data_root", root, "--work_dir", os.path.join(tmp, "dryrun"), "--full-size",
             f"--clip_weights_path={st_dir}", "--steps_per_epoch", str(CLIP_DRYRUN_STEPS),
             "--set", f"num_ids_per_batch={TRAIN_P}", "--set", f"instances_per_id={TRAIN_K}",
             "--set", "use_pallas_attention=true", "--set", "use_fused_mlp=true",
             "--set", "use_fused_resln=true", "--set", "do_eval=false"])
    checks = [ln.strip() for ln in buf.getvalue().splitlines()
              if ln.strip().startswith(("[OK]", "[FAIL]", "=="))]
    print(f"clip (f) dryrun_real_data.py --full-size --clip_weights_path ({CLIP_DRYRUN_STEPS} "
          f"steps, {time.perf_counter() - t0:.1f} s): exit code {rc}; " + " | ".join(checks))
    if rc != 0:
        fail(f"dryrun_real_data: exit code {rc}: {checks}")
    readings["tools"] = dict(diagnose_entries=len(report), diagnose_flagged=len(flagged),
                             alignment_pairs=len(panel), probe_cell=cell, dryrun_rc=rc)
    readings["seconds"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    return readings


# the bundle's consumer in a fresh process: serve_artifact.consumer_check on
# argv[2:5] (the bundle, a JSON of image paths and captions, the features'
# npz) with argv[5] sequential one-image /embed requests
BUNDLE_CONSUMER = ("import sys; sys.path.insert(0, sys.argv[1]); "
                   "from tools_torch.serve_artifact import consumer_check; "
                   "consumer_check(*sys.argv[2:5], latency_n=int(sys.argv[5]))")


def run_tools(calls, timeout=900, ok_codes=(0,)):
    """Each (name, args) of ``calls`` as tools_torch/<name>.py in a subprocess
    of its own (sys.executable, the repo root as the working directory), all
    started together; fails the run on another exit code, after stopping
    the others; -> [(rc, stdout)] in the order of ``calls``."""
    import tempfile

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    running = []
    try:
        for name, args in calls:
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            running.append((name, args, out, err, subprocess.Popen(
                [sys.executable, str(root / "tools_torch" / f"{name}.py"), *args],
                stdout=out, stderr=err, text=True, cwd=root)))
        results = []
        for name, args, out, err, proc in running:
            rc = proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            out.seek(0)
            err.seek(0)
            stdout, stderr = out.read(), err.read()
            if rc not in ok_codes:
                tail = "\n".join(stdout.splitlines()[-20:] + stderr.splitlines()[-30:])
                fail(f"tools {name} {' '.join(args)}: exit code {rc}\n{tail}")
            print(f"tools {name} ({time.perf_counter() - t0:.1f} s, exit {rc})")
            results.append((rc, stdout))
        return results
    finally:
        for *_, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_tool(name, args, timeout=900, ok_codes=(0,)):
    """tools_torch/<name>.py in a subprocess (``run_tools``); -> (rc, stdout)."""
    return run_tools([(name, args)], timeout, ok_codes)[0]


def json_line(stdout: str, key: str):
    """The payload of the last stdout line that is a JSON object {key: ...}."""
    for line in reversed(stdout.splitlines()):
        if line.startswith("{") and f'"{key}"' in line:
            return json.loads(line)[key]
    fail(f"no {key!r} JSON line in the tool's output:\n{stdout[-2000:]}")


def tools_phase(torch, cfg, counters, dev, card, tmp, live_p50):
    """The measuring tools and the serving artifact at full width on the
    card (phase 4h, see the module docstring), each tool in a subprocess of
    its own, as a user runs it; fails the run on any failed check and
    returns the readings (4h (a)'s device ms are held against phase 5 in
    main).  ``tmp``: the scratch directory of phases 4c-4g; ``live_p50``: phase
    4f's p50 of one served image (ms), printed beside the bundle's."""
    import glob

    import numpy as np

    from prcv2025reid_tpu_torch.ops import library  # noqa: F401 (registers the ops)
    from prcv2025reid_tpu_torch.ops.kernel_math import LN_EPS
    from prcv2025reid_tpu_torch.utils.trace_table import PORT_KERNELS

    t_phase = time.perf_counter()
    out = os.path.join(tmp, "H")
    os.makedirs(out)
    L = cfg.vision_layers
    readings = {}

    # ---- (a) trace_embed.py at BATCH under TRACE_PATHS
    expect_launches = {"fused": {"fused_ln_qkv": L - 1, "fused_out_mlp": L - 1},
                       "splash": {"fused_mha": L - 1, "splash_attention_bshd": L - 1}}
    expect_pallas = {"fused": ("ln_rows_kernel", "hgemm::gemm_kernel"),
                     "splash": ("attn_fwd_kernel",)}
    traced = {}
    for name, flags in TRACE_PATHS.items():
        _, stdout = run_tool("trace_embed", ["--batch", str(BATCH), "--iters", str(TRACE_ITERS),
                                             "--out", os.path.join(out, f"te_{name}"), *flags])
        r = json_line(stdout, "trace_embed")
        total, table = sum(r["rollup"].values()), r["table_ms"]
        pallas = r["kernels_by_bucket"].get("pallas", [])
        port_in_matmul = [n for n in r["kernels_by_bucket"].get("matmul", [])
                          if any(k in n for k in PORT_KERNELS)]
        launches = {k: round(v) for k, v in r["launches_per_step"].items()}
        print(f"tools (a) trace_embed {name} ({card}): rollup "
              + json.dumps({k: round(v, 3) for k, v in r["rollup"].items()})
              + f" = {total:.3f} ms of the table's {table:.3f}; CUDA events {r['device_ms']:.3f} ms; "
              f"launches a step {launches}; pallas kernels {len(pallas)}")
        if abs(total - table) > 0.01 * table or table <= 0:
            fail(f"trace_embed {name}: rollup {total} != table {table} within 1%")
        if launches != expect_launches[name]:
            fail(f"trace_embed {name}: launches a step {launches} != {expect_launches[name]}")
        missing = [k for k in expect_pallas[name] if not any(k in n for n in pallas)]
        if missing or port_in_matmul:
            fail(f"trace_embed {name}: pallas bucket {pallas} lacks {missing}, or the port's "
                 f"kernels in matmul: {port_in_matmul}")
        traced[name] = r
    readings["trace_embed"] = {n: dict(device_ms=r["device_ms"], profiler_ms=r["profiler_ms"],
                                       rollup=r["rollup"]) for n, r in traced.items()}

    # ---- (g) the serving artifact from 4d's best/ (a fused-stream checkpoint)
    a_ckpt = os.path.join(tmp, "A", "ckpt", "best")
    # the same weights under block_impl="fused": the fused-stream trunk refuses
    # the block plans, so its copy's config takes use_fused_resln off
    f_ckpt = os.path.join(out, "ckpt_fused_block", "best")
    os.makedirs(f_ckpt)
    os.symlink(os.path.join(a_ckpt, "state.pt"), os.path.join(f_ckpt, "state.pt"))
    with open(os.path.join(a_ckpt, "host_state.json")) as f:
        host = json.load(f)
    host["config"] = json.dumps({**json.loads(host["config"]), "use_fused_resln": False}) \
        if isinstance(host["config"], str) else {**host["config"], "use_fused_resln": False}
    with open(os.path.join(f_ckpt, "host_state.json"), "w") as f:
        json.dump(host, f)
    bundle, fbundle = os.path.join(out, "bundle"), os.path.join(out, "bundle_fused")
    # both exports, (d) and (f) at once: the exports are host work (tracing,
    # writing the file) and nothing of them is timed against the card; (d)
    # and (f) read rates that the others' host work can lower (their checks
    # are the lines they print and (f)'s exit code, 0 or 2)
    labels = {"fused_stream": (a_ckpt, bundle, ["--graphs", BUNDLE_GRAPHS]),
              "block_fused": (f_ckpt, fbundle, ["--graphs", "gallery_vis", "--block_impl",
                                                 "fused"])}
    (rc_d, stdout), (rc, watch), *ran = run_tools(
        [("bench_host_pipeline", ["--samples", str(HOST_SAMPLES)]),
         ("toolchain_watch", ["--fast"])]
        + [("export_serving", ["--model_path", ckpt, "--out_dir", bdir,
                               "--batch_size", str(BUNDLE_BATCH), *extra])
           for ckpt, bdir, extra in labels.values()], ok_codes=(0, 2))
    if rc_d != 0 or any(r != 0 for r, _ in ran):
        fail(f"tools: bench_host_pipeline or export_serving exited {rc_d}, {[r for r, _ in ran]}")

    # ---- (d) bench_host_pipeline.py
    lines = [ln for ln in stdout.splitlines() if ln.startswith(
        ("host:", "get_sample rate", "native=True failed", "gallery get_query_sample", "budget:",
         "overlap:"))]
    print("tools (d) bench_host_pipeline: " + " | ".join(lines))
    for prefix in ("get_sample rate (native_decode=False)", "budget:", "overlap:"):
        if not any(ln.startswith(prefix) for ln in lines):
            fail(f"bench_host_pipeline: no {prefix!r} line: {stdout[-2000:]}")
    if not any(ln.startswith(("native=True failed: unavailable",
                              "get_sample rate (native_decode=True)")) for ln in lines):
        fail(f"bench_host_pipeline: no native leg line: {stdout[-2000:]}")
    readings["host_pipeline"] = lines

    # ---- (f) toolchain_watch.py --fast: 0 (unchanged) or 2 (changed)
    report = watch[watch.find("== train-step probe"):]
    print(f"tools (f) toolchain_watch --fast: exit {rc}\n{report}")
    diff = watch[watch.find("== probe diff"):]
    if "FAILED" in diff or "train_8x4: FAILED" in watch:
        fail(f"toolchain_watch: a probe read None:\n{diff}")
    readings["toolchain_watch"] = dict(rc=rc, report=report.strip().splitlines())

    exports = {}
    for label, (_, stdout) in zip(labels, ran):
        for line in stdout.splitlines():
            if line.startswith('{"exported"'):
                e = json.loads(line)
                exports[f"{label}/{e['exported']}"] = e
    print(f"tools (g) export_serving ({card}): " + json.dumps(
        {k: [e["bytes"], e["seconds"], e["ops"]] for k, e in exports.items()})
          + " (bytes, export s, prcv_reid ops)")
    trunk = {"fused_mha": L, "fused_mlp": L, "fused_residual_ln": 2 * L}
    want_ops = {"fused_stream/gallery_vis": trunk, "fused_stream/text": {},
                "block_fused/gallery_vis": {"fused_ln_qkv": L - 1, "fused_out_mlp": L - 1}}
    for key, ops in want_ops.items():
        if exports.get(key, {}).get("ops") != ops:
            fail(f"export_serving {key}: graph ops {exports.get(key)} != {ops}")
    for key in ("fused_stream/quad", "fused_stream/combo_nir+text"):
        if not all(exports[key]["ops"].get(k, 0) >= n for k, n in trunk.items()):
            fail(f"export_serving {key}: graph ops {exports[key]['ops']} lack the trunk's {trunk}")

    root = os.path.join(tmp, "orbench")
    with open(os.path.join(root, "text_annos.json")) as f:
        captions = [a["caption"] for a in json.load(f)][:BUNDLE_N]
    files = {m: sorted(glob.glob(os.path.join(root, m, "*", "*.jpg")))[:BUNDLE_N]
             for m in ("vis", "nir")}
    inputs = os.path.join(out, "inputs.json")
    with open(inputs, "w") as f:
        json.dump({**files, "captions": captions}, f)
    feats_npz = os.path.join(out, "bundle_feats.npz")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", BUNDLE_CONSUMER,
                           str(Path(__file__).resolve().parent), bundle, inputs, feats_npz,
                           str(BUNDLE_LATENCY_N)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"the bundle's consumer: exit code {proc.returncode}\n{proc.stderr[-4000:]}")
    consumer = json_line(proc.stdout, "bundle_consumer")
    consumer_s = time.perf_counter() - t0

    # the live engine on the same inputs
    from PIL import Image

    serve = load_tool("serve_embed")
    config, model = serve._load_model(a_ckpt, device=dev)
    live = serve.make_engine(config, model, BUNDLE_BATCH)

    def pil(path):
        with Image.open(path) as im:
            im.load()
            return im.copy()

    vis, nir = [pil(p) for p in files["vis"]], [pil(p) for p in files["nir"]]
    want = {"vis": live.embed_pils(vis, "vis"), "text": live.embed_texts(captions),
            "nir_text": live.embed_queries([{"nir": a, "text": c} for a, c in zip(nir, captions)]),
            "quad": live.embed_queries([{"vis": v, "nir": a, "sk": a, "cp": a, "text": c}
                                        for v, a, c in zip(vis, nir, captions)])}
    with np.load(feats_npz) as z:
        got = {k: z[k] for k in z.files}
    agree = {k: dict(bits=bool(np.array_equal(got[k], want[k])),
                     min_cos=float((got[k] * want[k]).sum(axis=1).min()),
                     max_abs=float(np.abs(got[k] - want[k]).max())) for k in want}
    del model, live
    torch.cuda.empty_cache()
    print(f"tools (g) bundle consumer ({consumer_s:.1f} s, load + warm {consumer['load_s']:.1f} s; "
          f"{card}): model modules loaded {consumer['model_modules']}; one vis batch of "
          f"{BUNDLE_BATCH} launches {consumer['one_vis_batch']}; against the live engine "
          + json.dumps(agree) + f"; /embed one image p50 {consumer['p50_ms']:.3f} ms, p90 "
          f"{consumer['p90_ms']:.3f} ms over {consumer['n']} sequential requests (the live "
          f"server's in phase 4f: p50 {live_p50:.3f} ms); /search hits {consumer['search_hits']}")
    if consumer["model_modules"]:
        fail(f"the bundle's consumer loaded the model code: {consumer['model_modules']}")
    if consumer["one_vis_batch"] != trunk:
        fail(f"the bundle's vis batch launched {consumer['one_vis_batch']} != {trunk}")
    if not consumer["embed_equals_engine"] or consumer["search_hits"] != 5 or \
            consumer["store_hits"] != [5, 5] or consumer["embed_dim"] != config.fusion_dim:
        fail(f"the bundle's server: {consumer}")
    not_bits = [k for k, a in agree.items() if not a["bits"]]
    if not_bits:
        # the exported graph runs the same kernels on the same operands; where
        # a graph re-orders an f32 reduction outside them the bits may move
        print(f"tools (g) bundle features not bit for bit on {not_bits}: held at min-cosine "
              f">= {BUNDLE_MIN_COSINE}")
        if min(agree[k]["min_cos"] for k in not_bits) < BUNDLE_MIN_COSINE:
            fail(f"the bundle's features against the live engine: {agree}")
    readings["artifact"] = dict(exports=exports, consumer=consumer, agree=agree,
                                consumer_s=consumer_s, live_p50_ms=live_p50)

    # ---- (h) the ops' host cost a call against the direct launch
    from prcv2025reid_tpu_torch.ops.fused_resln import fused_residual_ln

    gen = torch.Generator(device=dev).manual_seed(5)
    n_rows, D = BUNDLE_BATCH * (cfg.num_patches + 1), cfg.vision_hidden_dim
    x = torch.randn(n_rows, D, generator=gen, device=dev).bfloat16()
    br = torch.randn(n_rows, D, generator=gen, device=dev).bfloat16()
    sc, bi = torch.ones(D, device=dev), torch.zeros(D, device=dev)

    def host_us(fn):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn()
        t = (time.perf_counter() - t0) / DISPATCH_CALLS * 1e6
        torch.cuda.synchronize()
        return t

    with torch.no_grad():
        ways = {"direct": lambda: fused_residual_ln(x, br, sc, bi),
                "op": lambda: torch.ops.prcv_reid.fused_residual_ln(x, br, sc, bi, LN_EPS)}
        same = all(torch.equal(a, b) for a, b in zip(ways["direct"](), ways["op"]()))
        dispatch = {}
        for rnd in range(3):
            for name in (list(ways) if rnd % 2 == 0 else list(ways)[::-1]):
                dispatch.setdefault(name, []).append(host_us(ways[name]))
    dispatch = {k: statistics.median(v) for k, v in dispatch.items()}
    for counter in counters.values():
        counter.launches = 0
    print(f"tools (h) fused_residual_ln [{n_rows}, {D}] host us a call ({card}; median of 3 "
          f"rounds of {DISPATCH_CALLS}): direct {dispatch['direct']:.2f}, through "
          f"torch.ops.prcv_reid {dispatch['op']:.2f}; same output {same}")
    if not same:
        fail("the fused_residual_ln op's output differs from the direct launch's")
    readings["dispatch_us"] = dispatch
    readings["seconds"] = time.perf_counter() - t_phase
    return readings


def parallel_phase(torch, cfg, counters, dev, card, tmp):
    """Data parallel over a process group on the one card (see the module
    docstring, phase 4i); fails the run on any failed check and returns the
    readings.  ``tmp``: the scratch directory whose ``orbench`` tree phase 4c
    wrote."""
    from prcv2025reid_tpu_torch import engine
    from prcv2025reid_tpu_torch.data.split import create_split_datasets
    from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer
    from prcv2025reid_tpu_torch.evaluation.protocol import evaluate_protocol

    L = cfg.vision_layers
    out = {}
    # (a) the global-batch step, (b) the sharded ranking and (d) tensor
    # parallelism, in the same DP_PROCS processes; the one-process step and
    # embed run first, in this process
    dry = load_tool("dp_dryrun")
    for counter in counters.values():
        counter.launches = 0
    t0 = time.perf_counter()
    dp = dry.launch(["--legs", "step,ranking,tp", "--out", os.path.join(tmp, "dp_dryrun")])
    print(f"dp (a)+(b)+(d) {time.perf_counter() - t0:.1f} s (one process "
          f"{dp.get('single_s', 0):.1f} s, {DP_PROCS} processes {dp.get('children_s', 0):.1f} s)")
    if not dp["ok"]:
        fail("data / tensor parallel (a)/(b)/(d): " + "; ".join(dp["failures"]))
    for row in dp["steps"]:
        print(f"dp (a) step {row['step']} ({card}): one process {json.dumps(row['single'])}, "
              f"{DP_PROCS} processes {json.dumps(row['multi'])}, max rel {row['max_rel']:.3e} "
              f"(<= {DP_LOSS_REL}); #1 launches a rank {row['fused_mha']} (one process "
              f"{row['single_fused_mha']}); device ms a rank "
              f"{[round(x, 3) for x in row['device_ms']]} (one process "
              f"{row['single_device_ms']:.3f}); collectives ms a rank "
              f"{[round(x, 3) for x in row['collective_ms']]} in {row['collective_calls']} "
              "all-reduces")
        if any(n != L - 1 for n in row["fused_mha"] + [row["single_fused_mha"]]) \
                or row["max_rel"] > DP_LOSS_REL:
            fail(f"dp (a) step {row['step']}: #1 launches a rank {row['fused_mha']}, one process "
                 f"{row['single_fused_mha']} (expected {L - 1}), max rel {row['max_rel']} "
                 f"(<= {DP_LOSS_REL})")
    print(f"dp (a) ranks bit-identical: {dp['ranks_bit_identical']}")
    rk = dp["ranking"]
    print(f"dp (b) sharded_topk {rk['queries']} x {rk['gallery']} x {rk['dim']} top {rk['topk']} "
          f"(small-integer features: exact products, ties by index) over {DP_PROCS} processes: "
          f"indices equal to stable_topk over the whole gallery {rk['indices_equal']}; ms a rank "
          f"{[round(x, 1) for x in rk['ms']]}")
    tp = dp["tp"]
    for row in tp["steps"]:
        print(f"dp (d) tp step {row['step']} on the (1, {TP_MODEL}) mesh ({card}): max rel "
              f"{row['max_rel']:.3e} from one process (<= {DP_LOSS_REL}); #1 launches a rank "
              f"{row['fused_mha']} at heads {row['heads']}; device ms a rank "
              f"{[round(x, 3) for x in row['device_ms']]} (one process "
              f"{row['single_device_ms']:.3f}); model all-reduces a rank {row['model_calls']}, "
              f"ms {[round(x, 3) for x in row['model_ms']]}")
    lo, wh = tp["proj_numel"]
    print(f"dp (d) tp ({card}): {tp['plan_leaves']} sharded leaves, each 1/{TP_MODEL} of the "
          f"whole ({tp['sharded_numel'][0]} of {tp['sharded_numel'][1]} elements); projection "
          f"parameters a process {lo} of one process's {wh} ({lo / wh:.4f}: the row biases, "
          f"the column layers' lora_A and the row layers' lora_B stay whole); replicated "
          f"leaves the same bits on both processes; gathered sharded leaves: frozen ones "
          f"differing {tp['frozen_differ']}, the {tp['trained_leaves']} trained ones' update "
          f"cosine to one process's {tp['update_cos']:.6f} (the rounding control, the one "
          f"process on the einsum core: {tp['control_update_cos']:.6f}); step 1's gradient "
          f"cosine by group {json.dumps(tp['grad_cos'])} (>= 0.99); peak GB a rank above "
          f"what was allocated before the model {[round(x, 3) for x in tp['peak_gb']]} (one "
          f"process {dp['single_peak_gb']:.3f})")
    e = tp["embed"]
    print(f"dp (d) tp fused-stream embed of {e['batch']} ({card}): min-cosine against one "
          f"process {[round(x, 6) for x in e['min_cosine']]} (>= 0.999), the processes' "
          f"features equal {e['ranks_equal']}; launches a rank {json.dumps(e['launches'])}, "
          f"one process {json.dumps(e['single_launches'])}")
    # this process's one-process references launched too: the steps, step
    # 1's gradients, the control's steps on the einsum core (none) and the
    # fused-stream embed
    here = {n: f.launches for n, f in counters.items()}
    print(f"dp (a)+(d) one-process reference, {len(dp['steps'])} steps, step 1's gradients, "
          "the control's steps and one fused-stream embed in this process: launches "
          + json.dumps(here))
    want = {"fused_mha": (L - 1) * (len(dp["steps"]) + 1) + L, "fused_mlp": L,
            "fused_residual_ln": 2 * L}
    if here != {n: want.get(n, 0) for n in counters}:
        fail(f"dp (a)+(d): the one-process references launched {here}, expected {want}")
    out["step"], out["ranking"], out["reference_launches"] = dp["steps"], rk, here
    out["tp"] = tp

    # (c) tools_torch/train.py as DP_PROCS processes on 4c's tree
    run = os.path.join(tmp, "DP")
    rdv = os.path.join(run, "rdv")
    os.makedirs(run, exist_ok=True)
    # the evaluation of the config's plans only (JAX's default whitelist), for time
    base = trainer_argv(cfg, tmp, "DP", num_epochs=1, steps_per_epoch=DP_CLI_STEPS,
                        eval_every_n_epoch=2, num_workers=2,
                        eval_include_patterns=",".join(cfg.eval_include_patterns))
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    procs = []
    try:
        for r in range(DP_PROCS):
            argv = base + ["--distributed=on", f"--num_processes={DP_PROCS}", f"--process_id={r}",
                           f"--coordinator_address=file://{rdv}", "--dist_backend=gloo"]
            procs.append(subprocess.Popen(
                [sys.executable, "-c", DP_CLI, str(root / "tools_torch" / "train.py"), *argv],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=root))
        logs_out = [p.communicate(timeout=DP_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    print(f"dp (c) tools_torch/train.py x {DP_PROCS} ({TRAIN_P}x{TRAIN_K}, 1 epoch x "
          f"{DP_CLI_STEPS} steps, the final evaluation): {wall:.1f} s, exit codes {codes}")
    if any(codes):
        fail("dp (c): a train.py process failed:\n" + "\n".join(
            o[-3000:] for o, c in zip(logs_out, codes) if c))
    launches = [json.loads(next(line for line in o.splitlines()
                                if line.startswith("launches "))[len("launches "):])
                for o in logs_out]
    for r, n in enumerate(launches):
        mha, mlp, resln = n["fused_mha"], n["fused_mlp"], n["fused_residual_ln"]
        vision = mlp // L  # vision forwards on the fused-stream trunk: the smoke test + eval
        print(f"dp (c) process {r} launches: {json.dumps(n)} (#1 {L - 1} a train step x "
              f"{DP_CLI_STEPS} + {L} a vision forward x {vision}; #8 {L}, #9 {2 * L} a forward)")
        if mlp % L or vision < 2 or resln != 2 * mlp or mha != (L - 1) * DP_CLI_STEPS + mlp:
            fail(f"dp (c) process {r}: launches {n} are not {DP_CLI_STEPS} train steps and "
                 "whole fused-stream forwards")
    logs, ckpt = os.path.join(run, "logs"), os.path.join(run, "ckpt")
    log_text = Path(logs, "training.log").read_text()
    have = {n: os.path.exists(os.path.join(d, n)) for d, names in (
        (logs, ("train_history.csv", "training.log")),
        (ckpt, ("latest/state.pt", "latest/host_state.json"))) for n in names}
    only0 = ("process 0 of 2" in log_text and "process 1 of 2" not in log_text
             and log_text.count("training done") == 1)
    print(f"dp (c) artifacts {have}; training.log holds process 0 only: {only0}; "
          f"{sorted(os.listdir(ckpt))}")
    if not all(have.values()) or not only0 or sorted(os.listdir(ckpt)) != ["latest"]:
        fail("dp (c): the artifacts are not process 0's alone")
    final = json.loads(log_text.split("training done: ", 1)[1].splitlines()[0])["final"]

    # this process evaluates the saved checkpoint as the trainer's final eval does
    t0 = time.perf_counter()
    config, model, state, _ = engine.load_checkpoint_model(os.path.join(ckpt, "latest"), dev)
    _, val_ds, _ = create_split_datasets(config)
    tok = build_tokenizer(config.tokenizer_vocab_path, config.text_vocab_size,
                          config.text_context_length)
    steps = {}

    def factory(mods):
        if mods not in steps:
            steps[mods] = engine.make_combo_embed_step(model, mods)
        return steps[mods]

    single = evaluate_protocol(
        None, val_ds, tok, batch_size=config.eval_batch_size,
        include_patterns=config.eval_include_patterns, sample_ratio=1.0, seed=config.seed,
        embed_factory=factory, device=dev)
    keys = sorted(k for k in final if k.startswith(("map", "mm")))
    delta = {k: abs(single[k] - final[k]) for k in keys}
    worst = max(delta.values())
    print(f"dp (c) one-process evaluation of latest/ ({time.perf_counter() - t0:.1f} s) against "
          f"the {DP_PROCS}-process final evaluation: "
          + ", ".join(f"{k} {single[k]:.4f} / {final[k]:.4f}" for k in keys)
          + f"; largest |dmAP| {worst:.6f} (<= {RANK_MAX_MAP_DELTA})")
    if worst > RANK_MAX_MAP_DELTA:
        fail(f"dp (c): |dmAP| {worst} between one process and {DP_PROCS} (> "
             f"{RANK_MAX_MAP_DELTA})")
    out["cli"] = {"wall_s": wall, "launches": launches, "final": final,
                  "single": {k: single[k] for k in keys}, "max_map_delta": worst}
    del model, state
    torch.cuda.empty_cache()
    return out


def zero_counts(torch, counters):
    """Every launch counter to 0, the card idle."""
    for counter in counters.values():
        counter.launches = 0
    torch.cuda.synchronize()


def read_counts(counters, want):
    """(the counters' readings, ``want`` over every counter)."""
    got = {n: f.launches for n, f in counters.items()}
    return got, {n: want.get(n, 0) for n in counters}


def embed_paths(torch, counters, dev, card, preset, cfg, params, names, batch=BATCH):
    """Each path's model in turn from ``params``: one counted embed of a
    seeded uint8 batch of ``batch`` vis images, its device ms (CUDA
    events), embeds/s over PRESET_ITERS steps and peak memory above what
    was allocated before the model; min-cosine against the first path
    (phases 4j and 4k)."""
    from prcv2025reid_tpu_torch import build_model, make_combo_embed_step

    expected = path_launches(cfg.vision_layers)
    gen = torch.Generator(device=dev).manual_seed(20)
    Mv = len(cfg.vision_modalities)
    images = torch.randint(0, 256, (batch, Mv, cfg.image_size, cfg.image_size, 3),
                           generator=gen, device=dev, dtype=torch.uint8)
    mask = torch.ones(batch, Mv, device=dev)
    out, ref = {}, None
    for name in names:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        model = build_model(cfg.replace(**EMBED_PATHS[name]), params, device=dev)
        step = make_combo_embed_step(model, ("vis",))
        zero_counts(torch, counters)
        e = step(images, mask)
        torch.cuda.synchronize()
        got, want = read_counts(counters, expected[name])
        if e.shape != (batch, cfg.fusion_dim) or not torch.isfinite(e).all() or \
                (e.norm(dim=1) - 1).abs().max().item() > 1e-3:
            fail(f"{preset} {name}: embedding not finite/unit-norm of shape "
                 f"{(batch, cfg.fusion_dim)}")
        if got != want:
            fail(f"{preset} {name}: launch counts {got} != {want}")
        device_ms = device_reading(torch, lambda: step(images, mask), f"{preset} {name}")[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(PRESET_ITERS):
            step(images, mask)
        torch.cuda.synchronize()
        rate = batch * PRESET_ITERS / (time.perf_counter() - t1)
        ref = e if ref is None else ref
        cos = (e * ref).sum(dim=1).min().item()
        bar = APPROX_MIN_COSINE if name in APPROX_PATHS else MIN_COSINE
        peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
        out[name] = dict(launches={n: c for n, c in got.items() if c}, min_cosine=cos,
                         device_ms=device_ms, embeds_per_s=rate, peak_mem_gb=peak)
        print(f"{preset} (a) {name} ({card}): launches {out[name]['launches']}; min-cosine "
              f"vs {names[0]} {cos:.6f} (>= {bar}); device {device_ms:.3f} ms a step of "
              f"{batch} at {cfg.image_size} px, {rate:.1f} embeds/s, peak memory "
              f"{peak:.2f} GB")
        if cos < bar:
            fail(f"{preset} {name}: min-cosine {cos} < {bar}")
        del model, step, e
    return out


def preset_phase(torch, counters, dev, card, tmp):
    """The CLIP ViT-L/14 and ViT-B/32 presets at full width on the card
    (phase 4j, see the module docstring); fails the run on any failed check
    and returns the readings.  ``tmp``: a scratch directory."""
    from prcv2025reid_tpu_torch import TrainingConfig, build_model, init_train_state, make_train_step
    from prcv2025reid_tpu_torch.configs import apply_model_preset
    import numpy as np

    from prcv2025reid_tpu_torch.params import init_params, param_shapes
    from prcv2025reid_tpu_torch.tools import convert_clip

    readings, t_phase = {}, time.perf_counter()

    # ---- (a) the L/14 embed at full width under PRESET_PATHS.  The SDM
    # features feed the fusion in training, so they take its width: the
    # preset keeps the default sdm_semantic_dim 512 against fusion_dim 768,
    # with which the JAX package's train forward raises (flax's
    # ScopeParamShapeError at fusion/q_proj) and make_train_step refuses.  The
    # phase sets it to 768 throughout; no eval path reads the SDM module
    l14 = apply_model_preset(TrainingConfig(), PRESET_L14)
    l14 = l14.replace(sdm_semantic_dim=l14.fusion_dim)
    L = l14.vision_layers
    t0 = time.perf_counter()
    params = init_params(l14, NUM_CLASSES, seed=0, perturb=True)
    print(f"{PRESET_L14}: {L} blocks of {l14.vision_hidden_dim}, {l14.vision_heads} heads, MLP "
          f"{l14.vision_mlp_dim}, {l14.num_patches + 1} tokens; text {l14.text_hidden_dim} x "
          f"{l14.text_layers}; fusion {l14.fusion_dim}; init_params "
          f"{time.perf_counter() - t0:.1f} s, {sum(a.size for a in params.values())} values")
    readings["l14_embed"] = embed_paths(torch, counters, dev, card, PRESET_L14, l14, params,
                                         PRESET_PATHS)

    print(f"{PRESET_L14} (a): {time.perf_counter() - t_phase:.1f} s")

    # ---- (a') the L/14 embed at 336 px (577 tokens: #1's register-held
    # kernel at the preset's longer length) of a batch of PRESET_336_BATCH
    # under PRESET_336_PATHS, from the same weights but the position
    # embeddings, drawn anew at 577 rows as init_params draws them
    t0 = time.perf_counter()
    l14_336 = l14.replace(image_size=336)
    shapes = param_shapes(l14_336, NUM_CLASSES)
    rng = np.random.default_rng(23)
    redrawn = sorted(k for k, v in params.items() if v.shape != shapes[k])
    if not redrawn or any(not k.endswith("/pos_embed") for k in redrawn):
        fail(f"{PRESET_L14} at 336 px: the leaves that change shape are {redrawn}")
    params_336 = {k: rng.normal(0.0, 0.02, shapes[k]).astype(np.float32) if k in redrawn else v
                  for k, v in params.items()}
    readings["l14_336_embed"] = embed_paths(torch, counters, dev, card, f"{PRESET_L14} 336 px",
                                            l14_336, params_336, PRESET_336_PATHS,
                                            batch=PRESET_336_BATCH)
    del params_336
    print(f"{PRESET_L14} (a') 336 px: {time.perf_counter() - t0:.1f} s")

    # ---- (b) phase 4b's 8x4 step at L/14: pallas_attention against xla
    t0 = time.perf_counter()
    tcfg = l14.replace(num_ids_per_batch=TRAIN_P, instances_per_id=TRAIN_K)
    batch = train_batch(torch, tcfg, dev, TRAIN_P, TRAIN_K, seed=21)
    first, train = {}, {}
    for name, over in (("xla", {}), ("pallas_attention", EMBED_PATHS["pallas_attention"])):
        pcfg = tcfg.replace(**over)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        model = build_model(pcfg, params, device=dev)
        first[name] = group_grads(torch, model, pcfg, batch)
        state = init_train_state(model, pcfg, 1, seed=0)
        step = make_train_step(model, pcfg, 1)
        state, _ = counted_step(torch, counters, f"{PRESET_L14} {name}", step, state, batch,
                                path_launches(L)[name])
        held = [state]

        def one_step():
            held[0], _ = step(held[0], batch, SDM_WEIGHT, SDM_TAU)

        device_ms = device_reading(torch, one_step, f"{PRESET_L14} train {name}")[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(PRESET_TRAIN_ITERS):
            one_step()
        torch.cuda.synchronize()
        it_s = PRESET_TRAIN_ITERS / (time.perf_counter() - t1)
        peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
        train[name] = dict(it_per_s=it_s, device_ms=device_ms, peak_mem_gb=peak,
                           remat_blocks=pcfg.remat_blocks, step1=first[name][0])
        print(f"{PRESET_L14} (b) train {name} ({card}): {it_s:.3f} it/s, device {device_ms:.3f} "
              f"ms a step, peak memory {peak:.2f} GB (remat_blocks {pcfg.remat_blocks}), step-1 "
              f"losses {json.dumps(first[name][0])}")
        if not all(math.isfinite(v) for v in first[name][0].values()):
            fail(f"{PRESET_L14} train {name}: a non-finite step-1 loss")
        del model, state, step, held
    (l_x, g_x), (l_p, g_p) = first["xla"], first["pallas_attention"]
    loss_rel = {k: abs(l_p[k] - l_x[k]) / abs(l_x[k]) for k in l_x}
    cos, rel, norm = compare_grads(torch, g_p, g_x)
    print(f"{PRESET_L14} (b) train step 1 pallas_attention vs xla: loss rel "
          f"{json.dumps(loss_rel)} (<= {TRAIN_LOSS_REL}); gradient cosine by group "
          f"{json.dumps(cos)} (>= {TRAIN_GRAD_COS}); global norm ratio {norm:.5f}")
    if max(loss_rel.values()) > TRAIN_LOSS_REL or min(cos.values()) < TRAIN_GRAD_COS:
        fail(f"{PRESET_L14} train step 1: pallas_attention disagrees with xla")
    train["pallas_vs_xla"] = dict(loss_rel=loss_rel, grad_cos=cos, grad_rel=rel, norm_ratio=norm)
    readings["l14_train"] = train
    del params, first, batch
    torch.cuda.empty_cache()
    print(f"{PRESET_L14} (b): {time.perf_counter() - t0:.1f} s")

    # ---- (c) CLIP weights at L/14's widths through clip_weights_path, as the
    # trainer loads them: the file's leaves into init_params(perturb=False)
    t0 = time.perf_counter()
    hf = hf_clip_checkpoint(l14, seed=22)
    st_dir = os.path.join(tmp, "clip_l14")
    os.makedirs(st_dir)
    convert_clip.write_safetensors(os.path.join(st_dir, "model.safetensors"), hf)
    ccfg = l14.replace(clip_weights_path=st_dir, **EMBED_PATHS["fused_trunk"])
    flat = convert_clip.convert_clip_params(
        convert_clip.load_hf_state_dict(convert_clip.clip_source(ccfg)),
        init_params(ccfg, NUM_CLASSES, ccfg.seed, perturb=False), seed=ccfg.seed)
    load_s = time.perf_counter() - t0
    model = build_model(ccfg, flat, device=dev)
    del flat
    gen = torch.Generator(device=dev).manual_seed(22)
    imgs = torch.randn(CLIP_ORACLE_BATCH, l14.image_size, l14.image_size, 3, generator=gen,
                       device=dev)
    zero_counts(torch, counters)
    with torch.inference_mode():
        got = model.encoder.encode_vision(imgs, 0).float()
    torch.cuda.synchronize()
    launched, want = read_counts(counters, dict(fused_mha=L, fused_mlp=L, fused_residual_ln=2 * L))
    oracle = clip_vision_oracle(torch, hf, imgs, l14, dev)
    cos = torch.nn.functional.cosine_similarity(got, oracle, dim=1).min().item()
    readings["l14_clip"] = dict(values=sum(v.size for v in hf.values()), load_s=load_s,
                                oracle_min_cosine=cos,
                                launches={n: k for n, k in launched.items() if k})
    print(f"{PRESET_L14} (c) an HF-layout checkpoint at its widths ({readings['l14_clip']['values']} "
          f"values) written, loaded through clip_weights_path and converted in {load_s:.1f} s; "
          f"the vis embedding of {CLIP_ORACLE_BATCH} images on the fused-stream trunk against the "
          f"f32 oracle: min-cosine {cos:.6f} (>= {MIN_COSINE}); launches {launched} (expected "
          f"{want})")
    if cos < MIN_COSINE or not torch.isfinite(got).all():
        fail(f"{PRESET_L14} clip: the loaded model's vis embedding against the oracle: {cos}")
    if launched != want:
        fail(f"{PRESET_L14} clip embed: launch counts {launched} != {want}")
    del model, oracle, got, hf
    torch.cuda.empty_cache()
    print(f"{PRESET_L14} (c): {time.perf_counter() - t0:.1f} s")

    # ---- (d) the B/32 embed (50 tokens: #1's 4-chunk branch)
    t0 = time.perf_counter()
    b32 = apply_model_preset(TrainingConfig(), PRESET_B32)
    readings["b32_embed"] = embed_paths(torch, counters, dev, card, PRESET_B32, b32,
                                        init_params(b32, NUM_CLASSES, seed=0, perturb=True),
                                        B32_PATHS)
    torch.cuda.empty_cache()
    print(f"{PRESET_B32} (d): {time.perf_counter() - t0:.1f} s")
    readings["seconds"] = time.perf_counter() - t_phase
    return readings


def vit_h_phase(torch, counters, dev, card):
    """OpenCLIP ViT-H/14's widths at full depth on the card (phase 4k, see
    the module docstring); fails the run on any failed check and returns
    the readings."""
    from prcv2025reid_tpu_torch import TrainingConfig, build_model, init_train_state, make_train_step
    from prcv2025reid_tpu_torch.params import init_params

    readings, t_phase = {}, time.perf_counter()
    cfg = TrainingConfig().replace(**VIT_H)
    L = cfg.vision_layers
    t0 = time.perf_counter()
    params = init_params(cfg, NUM_CLASSES, seed=0, perturb=True)
    print(f"ViT-H/14 widths: {L} blocks of {cfg.vision_hidden_dim}, {cfg.vision_heads} heads of "
          f"{cfg.vision_hidden_dim // cfg.vision_heads}, MLP {cfg.vision_mlp_dim}, "
          f"{cfg.num_patches + 1} tokens; text {cfg.text_hidden_dim} x {cfg.text_layers}; fusion "
          f"{cfg.fusion_dim}; init_params {time.perf_counter() - t0:.1f} s, "
          f"{sum(a.size for a in params.values())} values")

    # ---- (a) the embed under PRESET_PATHS: #1 at Dh = 80, S = 257, the row
    # passes at D = 1,280
    readings["embed"] = embed_paths(torch, counters, dev, card, "ViT-H/14 widths", cfg, params,
                                    PRESET_PATHS)
    print(f"ViT-H/14 widths (a): {time.perf_counter() - t_phase:.1f} s")

    # ---- (b) phase 4b's 8x4 step under remat_blocks (every block in full and
    # recomputed: #1 2L a step on pallas_attention): step 1 against xla
    t0 = time.perf_counter()
    tcfg = cfg.replace(num_ids_per_batch=TRAIN_P, instances_per_id=TRAIN_K, remat_blocks=True)
    batch = train_batch(torch, tcfg, dev, TRAIN_P, TRAIN_K, seed=24)
    first, train = {}, {}
    for name in VIT_H_TRAIN_PATHS:
        pcfg = tcfg.replace(**EMBED_PATHS[name])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        model = build_model(pcfg, params, device=dev)
        first[name] = group_grads(torch, model, pcfg, batch)
        finite = all(math.isfinite(v) for v in first[name][0].values()) and all(
            bool(torch.isfinite(g).all()) for g in first[name][1].values())
        if not finite:
            fail(f"ViT-H/14 widths train {name}: a non-finite step-1 loss or gradient")
        state = init_train_state(model, pcfg, 1, seed=0)
        step = make_train_step(model, pcfg, 1)
        want = {"fused_mha": 2 * L} if name == "pallas_attention" else {}
        state, _ = counted_step(torch, counters, f"ViT-H/14 widths {name} remat_blocks", step,
                                state, batch, want)
        held = [state]

        def one_step():
            held[0], _ = step(held[0], batch, SDM_WEIGHT, SDM_TAU)

        device_ms = device_reading(torch, one_step, f"ViT-H/14 widths train {name}")[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(VIT_H_TRAIN_ITERS):
            one_step()
        torch.cuda.synchronize()
        it_s = VIT_H_TRAIN_ITERS / (time.perf_counter() - t1)
        peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
        train[name] = dict(it_per_s=it_s, device_ms=device_ms, peak_mem_gb=peak,
                           launches=want, step1=first[name][0])
        print(f"ViT-H/14 widths (b) train {name} ({card}): {it_s:.3f} it/s, device "
              f"{device_ms:.3f} ms a step, peak memory {peak:.2f} GB (remat_blocks), launches "
              f"{want} a step, step-1 losses {json.dumps(first[name][0])}, gradients finite")
        del model, state, step, held
    (l_x, g_x), (l_p, g_p) = first["xla"], first["pallas_attention"]
    loss_rel = {k: abs(l_p[k] - l_x[k]) / abs(l_x[k]) for k in l_x}
    cos, rel, norm = compare_grads(torch, g_p, g_x)
    print(f"ViT-H/14 widths (b) train step 1 pallas_attention vs xla: loss rel "
          f"{json.dumps(loss_rel)} (<= {TRAIN_LOSS_REL}); gradient cosine by group "
          f"{json.dumps(cos)} (>= {TRAIN_GRAD_COS}); global norm ratio {norm:.5f}")
    if max(loss_rel.values()) > TRAIN_LOSS_REL or min(cos.values()) < TRAIN_GRAD_COS:
        fail("ViT-H/14 widths train step 1: pallas_attention disagrees with xla")
    train["pallas_vs_xla"] = dict(loss_rel=loss_rel, grad_cos=cos, grad_rel=rel, norm_ratio=norm)
    readings["train"] = train
    del params, first, batch
    torch.cuda.empty_cache()
    print(f"ViT-H/14 widths (b): {time.perf_counter() - t0:.1f} s")
    readings["seconds"] = time.perf_counter() - t_phase
    return readings


def block_kernel_rows(torch, fns, launch, T, D, F, block_checks):
    """Phase 5's rows of #3, #5, #8 and #9 on T rows of width D, MLP width F
    (``fns``: block_cases' name -> (kernel, plain, operands); ``launch``: a
    path's launches a forward), each beside its bound."""
    O, at = 3 * D, f"D={D} F={F} T={T}"
    rows = []
    for name, path, work, nbytes in (
            ("fused_ln_qkv", "fused", [(2 * T * D * O, PEAK_BF16_FLOPS)],
             T * D * 2 + D * O * 2 + O * 4 + 2 * D * 4 + T * O * 2),
            ("fused_out_mlp", "fused", [(2 * T * D * (D + 2 * F), PEAK_BF16_FLOPS)],
             3 * T * D * 2 + (D * D + 2 * D * F) * 2 + (2 * D + F) * 4 + 2 * D * 4),
            ("fused_mlp", "fused_trunk", [(4 * T * D * F, PEAK_BF16_FLOPS)],
             2 * T * D * 2 + 2 * D * F * 2 + (F + D) * 2),
            ("fused_residual_ln", "fused_trunk", [(8 * T * D, PEAK_F32_FLOPS)],
             4 * T * D * 2 + 2 * D * 4)):
        kern, plain, args = fns[f"{name} y {at}" if name == "fused_residual_ln"
                                else f"{name} {at}"]
        b_ms, b_by = bound_ms(work, nbytes)
        rows.append(dict(
            name=name, shape=f"T={T} D={D} F={F}",
            launches=launch[path].get(name, 0),
            max_abs_err=max(v[0] for n, v in block_checks.items()
                            if n.startswith(name + " ") and f"D={D}" in n),
            ms=time_ms(torch, lambda k=kern, a=args: k(*a)),
            plain_ms=time_ms(torch, lambda p=plain, a=args: p(*a), runs=10),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    root = Path(__file__).resolve().parent
    if not (root / "prcv2025reid_tpu_torch" / "csrc").is_dir():
        fail(f"{root} is not a checkout of the repository (no prcv2025reid_tpu_torch/csrc)")
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from prcv2025reid_tpu_torch import TrainingConfig, build_model, make_combo_embed_step
    from prcv2025reid_tpu_torch.configs import apply_model_preset
    from prcv2025reid_tpu_torch.evaluation.protocol import (
        build_query_plans,
        compute_retrieval_metrics,
        ranking_equivalence,
        similarity,
    )
    from prcv2025reid_tpu_torch.ops import _kernels
    from prcv2025reid_tpu_torch.ops import attention as att
    from prcv2025reid_tpu_torch.ops import fused_block as fb
    from prcv2025reid_tpu_torch.ops.fused_attention import (
        REG_MAX_SEQ,
        attention_route,
        fused_mha,
        mha_plain,
    )
    from prcv2025reid_tpu_torch.ops.fused_mlp import fused_mlp, mlp_plain
    from prcv2025reid_tpu_torch.ops.fused_resln import fused_residual_ln, resln_plain
    from prcv2025reid_tpu_torch.ops.matmul import BLOCK_ROWS, matmul_plain, tiled_matmul
    from prcv2025reid_tpu_torch.params import init_params

    # ---- 2. build
    t0 = time.perf_counter()
    _kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, {len(_kernels.SOURCES)} sources in parallel)")
    for name, log in _kernels.build_logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  ptxas[{name}] {line.strip()}")
    # the kernels on the GEMM core are wgmma fed by TMA and drained by TMA
    # stores: all three must be in each one's SASS
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        fail("cuobjdump not found: the SASS check of the GEMM core's kernels needs it")
    for lib_name, kinds, n_core in (("matmul", ("Bf16Op", "S8Op"), 6),
                                    ("fused_mlp", ("Bf16Op",), 2),
                                    ("fused_block", ("Bf16Op",), 4),
                                    ("fused_block_int8", ("S8Op",), 4)):
        so = _kernels.lib(lib_name)._name
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                              timeout=120).stdout
        # the block kernels run every product on the wgmma core: no mma.sync
        if lib_name in ("fused_block", "fused_block_int8"):
            mma_sync = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HMMA", "IMMA")}
            print(f"sass {lib_name}: mma.sync instructions {mma_sync}")
            if any(mma_sync.values()):
                fail(f"lib{lib_name}: mma.sync instructions in its SASS, expected none: {mma_sync}")
        on_core = [sec for sec in sass.split("Function : ")[1:]
                   if any(k in sec.split(None, 1)[0] for k in kinds)]
        if len(on_core) != n_core:
            fail(f"lib{lib_name}: {len(on_core)} kernels on the GEMM core in its SASS, "
                 f"expected {n_core}")
        for section in on_core:
            fname = section.split(None, 1)[0]
            kind = next(k for k in kinds if k in fname)
            mma = {op: section.count(op) for op in sorted(set(re.findall(r"\b[A-Z]*GMMA\b", section)))}
            counts = {**mma, "UTMALDG": section.count("UTMALDG"), "UTMASTG": section.count("UTMASTG")}
            print(f"sass {lib_name} {kind} {fname[:90]}: {counts}")
            if not mma or not counts["UTMALDG"] or not counts["UTMASTG"] or (
                    kind == "Bf16Op" and "HGMMA" not in mma):
                fail(f"{lib_name} {fname}: no warpgroup MMA, TMA load or TMA store in its SASS: "
                     f"{counts}")

    # ---- 3. kernels against their plain versions at the slice's shapes
    cfg = TrainingConfig()
    D, H, F = cfg.vision_hidden_dim, cfg.vision_heads, cfg.vision_mlp_dim
    S = cfg.num_patches + 1
    Dh, T = D // H, BATCH * S
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    failures = []
    # attention operands as the model hands them over: views of one QKV projection
    qkv = randn(BATCH, S, 3, H, Dh).bfloat16()
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    att_checks = {}
    for causal, version in ((False, 2), (True, 2), (False, 1)):
        got = fused_mha(q, k, v, causal=causal, kernel_version=version)
        torch.cuda.synchronize()
        mx, rel, ok = errors(torch, got, mha_plain(q, k, v, causal))
        att_checks[(causal, version)] = (mx, rel)
        print(f"check fused_mha causal={causal} v{version}: max_abs {mx:.3e} rel {rel:.3e}"
              f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"fused_mha causal={causal} v{version}")
    # token reduction: the blocks after the reduction attend over S_RED
    # tokens (S_RED - 1 with 'prune')
    for s_red in (S_RED, S_RED - 1):
        qkv_r = randn(BATCH, s_red, 3, H, Dh).bfloat16()
        q_r, k_r, v_r = (qkv_r[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        got = fused_mha(q_r, k_r, v_r)
        torch.cuda.synchronize()
        mx, rel, ok = errors(torch, got, mha_plain(q_r, k_r, v_r))
        att_checks[f"S={s_red}"] = (mx, rel)
        print(f"check fused_mha S={s_red}: max_abs {mx:.3e} rel {rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"fused_mha S={s_red}")
        if s_red == S_RED:
            red_qkv = (q_r, k_r, v_r)  # timed in phase 5
    # tensor parallelism (phase 4i (d)): each process's H / TP_MODEL heads,
    # strided views of its [..., 3 D / TP_MODEL] projection
    H_TP = H // TP_MODEL
    qkv_t = randn(BATCH, S, 3, H_TP, Dh).bfloat16()
    tp_qkv = tuple(qkv_t[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    got = fused_mha(*tp_qkv)
    torch.cuda.synchronize()
    mx, rel, ok = errors(torch, got, mha_plain(*tp_qkv))
    att_checks[f"H={H_TP}"] = (mx, rel)
    print(f"check fused_mha H={H_TP}: max_abs {mx:.3e} rel {rel:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"fused_mha H={H_TP}")

    x = randn(1, T, D).bfloat16()
    attn = randn(1, T, D).bfloat16()
    G3, N3 = len(MM3_QUERY), 32 * S  # the MM-3 query batch: 6,304 rows per group
    lns, lnb = 1 + 0.1 * randn(D), 0.1 * randn(D)
    wqkv, bqkv = randn(1, D, 3 * D, scale=D**-0.5).bfloat16(), 0.1 * randn(1, 3 * D)
    wo, bo = randn(1, D, D, scale=D**-0.5).bfloat16(), 0.1 * randn(1, D)
    w1, b1 = randn(1, D, F, scale=D**-0.5).bfloat16(), 0.1 * randn(1, F)
    w2, b2 = randn(1, F, D, scale=F**-0.5).bfloat16(), 0.1 * randn(1, D)
    qkv_args = (x, lns, lnb, wqkv, bqkv)
    # the LN1 + QKV block kernels on the MM-3 query's three groups, from a
    # generator of their own (the other inputs stay as they were)
    gen3 = torch.Generator(device=dev).manual_seed(3)
    wqkv3 = (torch.randn(G3, D, 3 * D, generator=gen3, device=dev) * D**-0.5).bfloat16()
    qkv3_args = (torch.randn(G3, N3, D, generator=gen3, device=dev).bfloat16(), lns, lnb, wqkv3,
                 0.1 * torch.randn(G3, 3 * D, generator=gen3, device=dev))
    mlp_args = (attn, x, wo, bo, lns, lnb, w1, b1, w2, b2)
    # the fused MLP takes bf16 biases (the model casts them to the compute dtype)
    fmlp_args = (x, w1, b1.bfloat16(), w2, b2.bfloat16())
    fmlp3_args = (randn(G3, N3, D).bfloat16(), randn(G3, D, F, scale=D**-0.5).bfloat16(),
                  (0.1 * randn(G3, F)).bfloat16(), randn(G3, F, D, scale=F**-0.5).bfloat16(),
                  (0.1 * randn(G3, D)).bfloat16())
    resln_args = (x[0], attn[0], lns, lnb)
    # the int8 plans: the weights quantized as MERBlock does, on the card
    q_wqkv, q_wo, q_w1, q_w2 = (fb.quantize_weight(w) for w in (wqkv, wo, w1, w2))
    qkv8_args = (x, lns, lnb, *q_wqkv, bqkv)
    qkv8_3_args = (*qkv3_args[:3], *fb.quantize_weight(wqkv3), qkv3_args[4])
    mlp8_args = (attn, x, *q_wo, bo, lns, lnb, *q_w1, b1, *q_w2, b2)
    mlp8m_args = (attn, x, wo, bo, lns, lnb, *q_w1, b1, *q_w2, b2)
    # the out-projection + MLP block kernels on the MM-3 query's three groups
    g3 = dict(attn=randn(G3, N3, D).bfloat16(), x=randn(G3, N3, D).bfloat16(),
              wo=randn(G3, D, D, scale=D**-0.5).bfloat16(), bo=0.1 * randn(G3, D),
              w1=fmlp3_args[1], b1=0.1 * randn(G3, F), w2=fmlp3_args[3], b2=0.1 * randn(G3, D))
    q3 = {k: fb.quantize_weight(g3[k]) for k in ("wo", "w1", "w2")}
    mlp3_args = (g3["attn"], g3["x"], g3["wo"], g3["bo"], lns, lnb, g3["w1"], g3["b1"],
                 g3["w2"], g3["b2"])
    tail3 = (lns, lnb, *q3["w1"], g3["b1"], *q3["w2"], g3["b2"])
    mlp8_3_args = (g3["attn"], g3["x"], *q3["wo"], g3["bo"], *tail3)
    mlp8m_3_args = (g3["attn"], g3["x"], g3["wo"], g3["bo"], *tail3)
    splash_args = tuple(qkv[:, :, i] for i in range(3))  # [B, S, H, Dh] views
    # token reduction's rows: BATCH images of S_RED tokens
    T_RED = BATCH * S_RED
    x_r, attn_r = randn(1, T_RED, D).bfloat16(), randn(1, T_RED, D).bfloat16()
    tail_r = (lns, lnb, *q_w1, b1, *q_w2, b2)
    fmlp_r_args = (x_r, w1, b1.bfloat16(), w2, b2.bfloat16())
    # tensor parallelism: fc1's F / TP_MODEL columns, fc2's rows; the
    # kernel adds no bias to the partial sum (MERMlp adds b2 after the sum)
    F_TP = F // TP_MODEL
    fmlp_tp_args = (x, w1[:, :, :F_TP].contiguous(), b1[:, :F_TP].bfloat16(),
                    w2[:, :F_TP].contiguous(), torch.zeros_like(b2).bfloat16())
    block_checks = {}

    def check(name, kern, plain, args):
        """The kernel against its plain version on the same operands."""
        got = kern(*args)
        torch.cuda.synchronize()
        tols = (INT8_REL_TOL, INT8_ABS_TOL) if "int8" in name else (REL_TOL, ABS_TOL)
        mx, rel, ok = errors(torch, got, plain(*args), *tols)
        block_checks[name] = (mx, rel)
        print(f"check {name}: max_abs {mx:.3e} rel {rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)

    for name, kern, plain, args in (
        ("fused_ln_qkv", fb.fused_ln_qkv, fb.ln_qkv_plain, qkv_args),
        ("fused_ln_qkv G=3", fb.fused_ln_qkv, fb.ln_qkv_plain, qkv3_args),
        ("fused_out_mlp", fb.fused_out_mlp, fb.out_mlp_plain, mlp_args),
        ("fused_out_mlp G=3", fb.fused_out_mlp, fb.out_mlp_plain, mlp3_args),
        ("fused_mlp", fused_mlp, mlp_plain, fmlp_args),
        ("fused_mlp G=3", fused_mlp, mlp_plain, fmlp3_args),
        ("fused_residual_ln xn", lambda *a: fused_residual_ln(*a)[0],
         lambda *a: resln_plain(*a)[0], resln_args),
        ("fused_residual_ln y", lambda *a: fused_residual_ln(*a)[1],
         lambda *a: resln_plain(*a)[1], resln_args),
        ("fused_ln_qkv_int8", fb.fused_ln_qkv_int8, fb.ln_qkv_int8_plain, qkv8_args),
        ("fused_ln_qkv_int8 G=3", fb.fused_ln_qkv_int8, fb.ln_qkv_int8_plain, qkv8_3_args),
        ("fused_out_mlp_int8", fb.fused_out_mlp_int8, fb.out_mlp_int8_plain, mlp8_args),
        ("fused_out_mlp_int8mlp", fb.fused_out_mlp_int8mlp, fb.out_mlp_int8mlp_plain,
         mlp8m_args),
        ("fused_out_mlp_int8 G=3", fb.fused_out_mlp_int8, fb.out_mlp_int8_plain, mlp8_3_args),
        ("fused_out_mlp_int8mlp G=3", fb.fused_out_mlp_int8mlp, fb.out_mlp_int8mlp_plain,
         mlp8m_3_args),
        ("splash_attention_bshd", att.splash_attention_bshd, att.splash_plain, splash_args),
        (f"fused_ln_qkv T={T_RED}", fb.fused_ln_qkv, fb.ln_qkv_plain,
         (x_r, lns, lnb, wqkv, bqkv)),
        (f"fused_ln_qkv_int8 T={T_RED}", fb.fused_ln_qkv_int8, fb.ln_qkv_int8_plain,
         (x_r, lns, lnb, *q_wqkv, bqkv)),
        (f"fused_out_mlp T={T_RED}", fb.fused_out_mlp, fb.out_mlp_plain,
         (attn_r, x_r, wo, bo, lns, lnb, w1, b1, w2, b2)),
        (f"fused_out_mlp_int8 T={T_RED}", fb.fused_out_mlp_int8, fb.out_mlp_int8_plain,
         (attn_r, x_r, *q_wo, bo, *tail_r)),
        (f"fused_mlp T={T_RED}", fused_mlp, mlp_plain, fmlp_r_args),
        (f"fused_mlp F={F_TP}", fused_mlp, mlp_plain, fmlp_tp_args),
    ):
        check(name, kern, plain, args)
    # the microbenchmark's tiled matmul: x [M, 768] @ w [768, 3072]; the bf16
    # weight scaled as the model's (outputs of order 1, where ABS_TOL is a few
    # bf16 ulps), the int8 weight K-major, as the kernel takes it
    mm_args, mm_err = {}, {"bf16": 0.0, "int8": 0}
    for rows in MATMUL_ROWS:
        wq = torch.randint(-127, 127, (F, D), generator=gen, device=dev, dtype=torch.int8).t()
        xq = torch.randint(-127, 127, (rows, D), generator=gen, device=dev, dtype=torch.int8)
        bf16_args = (randn(rows, D).bfloat16(), randn(D, F, scale=D**-0.5).bfloat16())
        for mode, args in (("bf16", bf16_args), ("int8", (xq, wq))):
            want = matmul_plain(*args)
            for block_rows in BLOCK_ROWS:
                got = tiled_matmul(*args, block_rows)
                torch.cuda.synchronize()
                if mode == "int8":  # exact s32 sums: bit for bit
                    ok = got.dtype == torch.int32 and torch.equal(got, want)
                    mx, rel = (got.double() - want.double()).abs().max().item(), 0.0
                else:
                    mx, rel, ok = errors(torch, got, want)
                mm_err[mode] = max(mm_err[mode], mx)
                name = f"tiled_matmul {mode} M={rows} block_rows={block_rows}"
                print(f"check {name}: max_abs {mx:.3e} rel {rel:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(name)
            if rows == MATMUL_ROWS[0]:
                mm_args[mode] = args
    # the text tower's causal attention: 128 captions of 77 tokens, 8 heads
    tqkv = randn(BATCH, 77, 3, 8, Dh).bfloat16()
    tq, tk, tv = (tqkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    got = fused_mha(tq, tk, tv, causal=True)
    torch.cuda.synchronize()
    mx, rel, ok = errors(torch, got, mha_plain(tq, tk, tv, True))
    att_checks["text"] = (mx, rel)
    print(f"check fused_mha causal=True text S=77 H=8: max_abs {mx:.3e} rel {rel:.3e}"
          f" {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("fused_mha text S=77 H=8 causal")

    # the presets of phase 4j: #1 at ViT-B/32's 50 tokens (12 heads) and past
    # 256 at L/14's 16 heads (257 tokens at 224 px, 577 at 336 px), causal and
    # not; #11 at 257; the block kernels at L/14's widths (D = 1,024, F =
    # 4,096: the 192-column tiles end in a ragged 64 at N = 1,024) on BATCH
    # images of 257 tokens and on the MM-3 query's three groups of 32
    l14 = apply_model_preset(TrainingConfig(), PRESET_L14)
    b32 = apply_model_preset(TrainingConfig(), PRESET_B32)
    D14, H14, F14 = l14.vision_hidden_dim, l14.vision_heads, l14.vision_mlp_dim
    S14 = l14.num_patches + 1
    T14, N14 = BATCH * S14, 32 * S14
    l14_qkv = {}
    for s_len, heads in ((b32.num_patches + 1, b32.vision_heads), (S14, H14),
                         (S_L14_336, H14)):
        qkv_p = randn(BATCH, s_len, 3, heads, Dh).bfloat16()
        views = tuple(qkv_p[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        for causal in (False, True):
            got = fused_mha(*views, causal=causal)
            torch.cuda.synchronize()
            mx, rel, ok = errors(torch, got, mha_plain(*views, causal))
            att_checks[f"S={s_len} H={heads} causal={causal}"] = (mx, rel)
            print(f"check fused_mha S={s_len} H={heads} causal={causal}: max_abs {mx:.3e} "
                  f"rel {rel:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"fused_mha S={s_len} H={heads} causal={causal}")
        l14_qkv[s_len] = (qkv_p, views)
    # the register-held kernel's longest sequence and the two-pass kernel's
    # shortest, one call each at L/14's heads
    for s_len in (REG_MAX_SEQ, REG_MAX_SEQ + 1):
        qkv_p = randn(REG_EDGE_BATCH, s_len, 3, H14, Dh).bfloat16()
        views = tuple(qkv_p[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        got = fused_mha(*views)
        torch.cuda.synchronize()
        mx, rel, ok = errors(torch, got, mha_plain(*views))
        att_checks[f"S={s_len} H={H14} causal=False"] = (mx, rel)
        print(f"check fused_mha S={s_len} H={H14} B={REG_EDGE_BATCH}: max_abs {mx:.3e} "
              f"rel {rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"fused_mha S={s_len} H={H14}")
    del got, qkv_p, views
    l14_views = l14_qkv[S14][1]
    l14_splash = tuple(l14_qkv[S14][0][:, :, i] for i in range(3))  # [B, S, H, Dh] views
    l14_cases = (block_cases(torch, gen, dev, 1, T14, D14, F14)
                 + block_cases(torch, gen, dev, 3, N14, D14, F14))
    for name, kern, plain, args in l14_cases + [
            (f"splash_attention_bshd S={S14} H={H14}", att.splash_attention_bshd,
             att.splash_plain, l14_splash)]:
        check(name, kern, plain, args)
    l14_fns = {name: (kern, plain, args) for name, kern, plain, args in l14_cases}
    # #5 at L/14's widths with unit-variance residual and attention operands
    # (block_cases takes std 0.5): its outputs pass 8, where one bf16 ulp is
    # above ABS_TOL, so the reading is in ulps of each output element.  An
    # output near 0 is the difference of a residual and an MLP output of
    # order 1 whose bf16 intermediates (LN2, h) round in either version, so
    # there its error is of their ulp, many of its own: the gate holds the
    # outputs of magnitude UNIT_GATE_MIN and up to UNIT_MAX_ULPS
    wo14 = l14_fns[f"fused_out_mlp D={D14} F={F14} T={T14}"][2][2:]
    unit = (randn(1, T14, D14).bfloat16(), randn(1, T14, D14).bfloat16(), *wo14)
    got = fb.fused_out_mlp(*unit)
    torch.cuda.synchronize()
    want = fb.out_mlp_plain(*unit)
    ulps = bf16_ulps(torch, got, want)
    gated = ulps[want.float().abs() >= UNIT_GATE_MIN]
    unit_ulps = dict(max=ulps.max().item(), over_1=int((ulps > 1).sum().item()),
                     elements=ulps.numel(), max_abs=(got.float() - want.float()).abs().max().item(),
                     gated_max=gated.max().item(), gated_over_1=int((gated > 1).sum().item()),
                     gated_elements=gated.numel())
    ok = unit_ulps["gated_max"] <= UNIT_MAX_ULPS
    print(f"check fused_out_mlp D={D14} F={F14} T={T14} unit-variance operands: max "
          f"{unit_ulps['max']:.2f} bf16 ulps of the output element, {unit_ulps['over_1']} of "
          f"{unit_ulps['elements']} elements more than 1 ulp off, max_abs "
          f"{unit_ulps['max_abs']:.3e}; at |out| >= {UNIT_GATE_MIN}: max "
          f"{unit_ulps['gated_max']:.2f} ulps, {unit_ulps['gated_over_1']} of "
          f"{unit_ulps['gated_elements']} more than 1 ulp off (<= {UNIT_MAX_ULPS}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"fused_out_mlp D={D14} unit-variance operands")
    del got, want, ulps, gated, unit

    # #1 at every head width and length the TPU kernel takes: each padded
    # width's route edges (HEAD_WIDTHS x ROUTE_EDGES) on ATT_GRID_BH pairs,
    # then past 4,096 tokens; views of one [B, S, 3, H, Dh] projection
    gb, gh = ATT_GRID_BH
    for dh in HEAD_WIDTHS:
        for s_len, causal in ROUTE_EDGES:
            qkv_p = randn(gb, s_len, 3, gh, dh).bfloat16()
            views = tuple(qkv_p[:, :, i].permute(0, 2, 1, 3) for i in range(3))
            got = fused_mha(*views, causal=causal)
            torch.cuda.synchronize()
            mx, rel, ok = errors(torch, got, mha_plain(*views, causal))
            route = "/".join(map(str, attention_route(dh, s_len)))
            att_checks[f"Dh={dh} S={s_len} causal={causal}"] = (mx, rel)
            print(f"check fused_mha Dh={dh} S={s_len} causal={causal} ({route}): max_abs "
                  f"{mx:.3e} rel {rel:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"fused_mha Dh={dh} S={s_len} causal={causal}")
    for dh in LONG_SEQ_DH:
        for s_len in LONG_SEQS:
            for causal in (False, True):
                views = tuple(randn(1, 2, s_len, dh).bfloat16() for _ in range(3))
                got = fused_mha(*views, causal=causal)
                torch.cuda.synchronize()
                mx, rel, ok = errors(torch, got, mha_plain(*views, causal))
                att_checks[f"Dh={dh} S={s_len} causal={causal}"] = (mx, rel)
                print(f"check fused_mha Dh={dh} S={s_len} causal={causal} B*H=2: max_abs "
                      f"{mx:.3e} rel {rel:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"fused_mha Dh={dh} S={s_len} causal={causal}")
    del got, views, qkv_p
    # phase 4k's ViT-H/14 widths: #1 at BATCH images of 257 tokens, 16 heads
    # of 80 (attn_long_kernel at 128) and the splash core there (q pre-scaled:
    # 80**-0.5 is no power of two); #3-#9 on BATCH images' rows of 1,280, MLP
    # 5,120 (#7 only here: no path of 4k runs it)
    vh = TrainingConfig().replace(**VIT_H)
    DH, HH, FH = vh.vision_hidden_dim, vh.vision_heads, vh.vision_mlp_dim
    DhH, SH = DH // HH, vh.num_patches + 1
    TH = BATCH * SH
    qkv_h = randn(BATCH, SH, 3, HH, DhH).bfloat16()
    vit_h_views = tuple(qkv_h[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    got = fused_mha(*vit_h_views)
    torch.cuda.synchronize()
    mx, rel, ok = errors(torch, got, mha_plain(*vit_h_views))
    att_checks[f"S={SH} H={HH} Dh={DhH}"] = (mx, rel)
    print(f"check fused_mha S={SH} H={HH} Dh={DhH} B={BATCH}: max_abs {mx:.3e} rel {rel:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"fused_mha S={SH} H={HH} Dh={DhH}")
    vit_h_cases = block_cases(torch, gen, dev, 1, TH, DH, FH)
    vit_h_splash = tuple(qkv_h[:, :, i] for i in range(3))
    for name, kern, plain, args in vit_h_cases + [
            (f"splash_attention_bshd S={SH} H={HH} Dh={DhH}", att.splash_attention_bshd,
             att.splash_plain, vit_h_splash)]:
        check(name, kern, plain, args)
    vit_h_fns = {name: (kern, plain, args) for name, kern, plain, args in vit_h_cases}
    # the row passes past 1,024 columns on ROW_ROWS rows (MLP 4D, 2D at 8,192)
    for width in ROW_WIDTHS:
        for name, kern, plain, args in block_cases(torch, gen, dev, 1, ROW_ROWS, width,
                                                   (2 if width > 4096 else 4) * width):
            if "int8" in name and width % 16:
                continue
            check(name, kern, plain, args)
    del got
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")

    # the gradients: the kernel forward + the Function's backward against
    # autograd through the plain version, every input requiring grad
    def grads(fn, inputs, cot):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        if any(o.grad_fn is None for o in outs):
            return None
        torch.autograd.backward(outs, list(cot) if isinstance(cot, tuple) else [cot])
        return [t.grad for t in leaves]

    def cotangent(like):
        return randn(*like.shape).to(like.dtype)

    resln_cot = (cotangent(x[0]), cotangent(x[0]))
    grad_err = {}
    for name, kern, plain, args, cot in (
        ("fused_mha", fused_mha, mha_plain, (q, k, v), cotangent(q)),
        ("fused_mha causal", lambda *a: fused_mha(*a, causal=True),
         lambda *a: mha_plain(*a, True), (q, k, v), cotangent(q)),
        (f"fused_mha S={S14} H={H14}", fused_mha, mha_plain, l14_views,
         cotangent(l14_views[0])),
        ("splash_attention_bshd", att.splash_attention_bshd, att.splash_plain, splash_args,
         cotangent(splash_args[0])),
        ("fused_ln_qkv", fb.fused_ln_qkv, fb.ln_qkv_plain, qkv_args,
         randn(1, T, 3 * D).bfloat16()),
        ("fused_out_mlp", fb.fused_out_mlp, fb.out_mlp_plain, mlp_args, cotangent(x)),
        ("fused_mlp", fused_mlp, mlp_plain, fmlp_args, cotangent(x)),
        ("fused_residual_ln", fused_residual_ln, resln_plain, resln_args, resln_cot),
    ):
        got, want = grads(kern, args, cot), grads(plain, args, cot)
        if got is None or any(gr is None for gr in got):
            fail(f"{name}: an input got no gradient through the kernel wrapper")
        rels = [((a.float() - b.float()).norm() / b.float().norm()).item()
                for a, b in zip(got, want)]
        ok = all(torch.isfinite(a.float()).all() for a in got) and max(rels) <= GRAD_REL_TOL
        grad_err[name] = max(rels)
        print(f"grad {name}: {len(got)} inputs, max rel {max(rels):.3e} vs plain autograd "
              f"(<= {GRAD_REL_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"grad {name}")
    del got, want
    if failures:
        fail(f"gradients disagree with the plain versions' autograd: {failures}")

    # ---- 4. the main path at full ViT-B/16 width
    t0 = time.perf_counter()
    params = init_params(cfg, NUM_CLASSES, seed=0, perturb=True)
    print(f"init_params: {time.perf_counter() - t0:.1f} s, {sum(a.size for a in params.values())} values")
    L = cfg.vision_layers
    configs = {name: cfg.replace(**over) for name, over in EMBED_PATHS.items()}
    counters = {"fused_mha": fused_mha, "fused_ln_qkv": fb.fused_ln_qkv,
                "fused_out_mlp": fb.fused_out_mlp, "fused_mlp": fused_mlp,
                "fused_residual_ln": fused_residual_ln,
                "fused_ln_qkv_int8": fb.fused_ln_qkv_int8,
                "fused_out_mlp_int8": fb.fused_out_mlp_int8,
                "fused_out_mlp_int8mlp": fb.fused_out_mlp_int8mlp,
                "splash_attention_bshd": att.splash_attention_bshd,
                "tiled_matmul": tiled_matmul}
    expected = path_launches(L)  # launches per forward
    Mv = len(cfg.vision_modalities)
    images = torch.randint(0, 256, (BATCH, Mv, cfg.image_size, cfg.image_size, 3),
                           generator=gen, device=dev, dtype=torch.uint8)
    image_mask = torch.ones(BATCH, Mv, device=dev)
    models, steps, embeds, launches = {}, {}, {}, {}

    def run_counted(name, step, active, args=None, launches_expected=None):
        """One embed (of ``args``, default the gallery batch) with every
        counter zeroed just before it; fails unless the counts read
        ``launches_expected`` (default EXPECTED for the path) and the
        embedding is finite and unit-norm."""
        for counter in counters.values():
            counter.launches = 0
        e = step(*(args or (images, image_mask)))
        torch.cuda.synchronize()
        got = {n: f.launches for n, f in counters.items()}
        norms = e.norm(dim=1)
        if e.shape != (BATCH, cfg.fusion_dim) or not torch.isfinite(e).all() or \
                (norms - 1).abs().max().item() > 1e-3:
            fail(f"{name} {active}: embedding not finite/unit-norm of shape "
                 f"{(BATCH, cfg.fusion_dim)}")
        if launches_expected is None:
            launches_expected = expected[name]
        want = {n: launches_expected.get(n, 0) for n in counters}
        print(f"main path {name} {active}: launches {got} (expected {want})")
        if got != want:
            fail(f"{name} {active}: launch counts {got} != {want}")
        return e, got

    for name, c in configs.items():
        models[name] = build_model(c, params, device="cuda")
        steps[name] = make_combo_embed_step(models[name], ("vis",))
        embeds[name], launches[name] = run_counted(name, steps[name], ("vis",))
    gate = {}
    for name in configs:
        if name == "xla":
            continue
        gate[name] = (embeds[name] * embeds["xla"]).sum(dim=1).min().item()
        bar = APPROX_MIN_COSINE if name in APPROX_PATHS else MIN_COSINE
        promo = (f"; promotion gate {MIN_COSINE}: "
                 f"{'met' if gate[name] >= MIN_COSINE else 'missed'}") if name in APPROX_PATHS else ""
        print(f"gate {name} vs xla: min-cosine {gate[name]:.6f} (>= {bar}){promo}")
        if gate[name] < bar:
            fail(f"{name}: min-cosine {gate[name]} < {bar}")
    print(f"gate fused_int8_mlp >= fused_int8 (JAX tests/test_fused_block.py:273): "
          f"{gate['fused_int8_mlp'] >= gate['fused_int8']} "
          f"({gate['fused_int8_mlp']:.6f} vs {gate['fused_int8']:.6f})")
    # the MM-3 query combo: three vision groups in one trunk call
    mm3 = {name: run_counted(name, make_combo_embed_step(models[name], MM3_QUERY), MM3_QUERY)[0]
           for name in ("xla", "fused_trunk")}
    gate["fused_trunk " + "+".join(MM3_QUERY)] = g3 = \
        (mm3["fused_trunk"] * mm3["xla"]).sum(dim=1).min().item()
    print(f"gate fused_trunk {MM3_QUERY} vs xla: min-cosine {g3:.6f} (>= {MIN_COSINE})")
    if g3 < MIN_COSINE:
        fail(f"fused_trunk {MM3_QUERY}: min-cosine {g3} < {MIN_COSINE}")
    del mm3

    # the ranking gate: bench.py's probe set through every path, against xla
    t0 = time.perf_counter()
    g_img, g_pids, q_img, q_pids = rank_probe_images(cfg.image_size)

    def embed_probe(step, imgs):
        out = []
        for start in range(0, len(imgs), BATCH):
            x = torch.from_numpy(imgs[start:start + BATCH]).to(dev)
            out.append(step(x[:, None].expand(-1, Mv, -1, -1, -1), image_mask[:len(x)]))
        return torch.cat(out)

    probe = {name: (embed_probe(steps[name], g_img), embed_probe(steps[name], q_img))
             for name in configs}
    del g_img, q_img
    rank_cache, rank_gate = {}, {}
    for name in configs:
        if name == "xla":
            continue
        r = ranking_equivalence(probe["xla"][1], probe["xla"][0], probe[name][1],
                                probe[name][0], q_pids, g_pids, topk=100, ref_cache=rank_cache,
                                device=dev)
        ok = r["top_overlap"] >= RANK_MIN_OVERLAP and r["map_delta"] <= RANK_MAX_MAP_DELTA
        rank_gate[name] = {**r, "pass": ok}
        print(f"rank gate {name} vs xla: top-100 overlap {r['top_overlap']:.4f} "
              f"(>= {RANK_MIN_OVERLAP}), |dmAP| {r['map_delta']:.6f} (<= {RANK_MAX_MAP_DELTA}), "
              f"mAP {r['map_ref']:.6f} -> {r['map_test']:.6f}: {'PASS' if ok else 'FAIL'}"
              f"{'' if name not in APPROX_PATHS else ' (read, not required)'}")
        if not ok and name not in APPROX_PATHS:
            fail(f"{name}: fails the ranking gate against xla: {r}")
    del probe
    print(f"rank gate: {RANK_IDS} ids x {RANK_PER_ID} gallery, {RANK_QUERIES} queries, "
          f"{len(configs)} paths in {time.perf_counter() - t0:.1f} s")

    # the MM-1..4 protocol: every query plan against a vis gallery, ranked on the card
    t0 = time.perf_counter()
    mm = mm_query_set(torch, cfg, dev)
    plans = build_query_plans()
    mm_metrics, mm_feats = {}, {}
    for name in MM_PATHS:
        gal = torch.cat([steps[name](x[:, None].expand(-1, Mv, -1, -1, -1), image_mask[:len(x)])
                         for x in mm["g_images"].split(BATCH)])
        for plan, combo in plans:
            step = make_combo_embed_step(models[name], combo)
            has_vision = any(m != "text" for m in combo)
            mm_feats[name, plan], _ = run_counted(
                name, step, combo, (mm["q_images"], mm["q_mask"], mm["tokens"], mm["text_mask"]),
                expected[name] if has_vision else {})
            mm_metrics[name, plan] = compute_retrieval_metrics(
                mm_feats[name, plan], mm["q_pids"], gal, mm["g_pids"], device=dev)
        if name == "xla":  # the ranking on the card against the same call on the CPU
            plan = plans[-1][0]
            q_cpu, g_cpu = mm_feats[name, plan].cpu(), gal.cpu()
            on_cpu = compute_retrieval_metrics(q_cpu, mm["q_pids"].cpu(), g_cpu,
                                               mm["g_pids"].cpu(), device="cpu")
            diff = max(abs(on_cpu[k] - mm_metrics[name, plan][k]) for k in on_cpu)
            # the similarities: full f32 on both (TF32 would be ~1e-4 off); the
            # metrics may still differ where two lie within that rounding
            sim_card = similarity(mm_feats[name, plan], gal).cpu()
            sim_diff = (sim_card - q_cpu @ g_cpu.T).abs().max().item()
            print(f"mm {plan} on the card vs the CPU: similarities max difference "
                  f"{sim_diff:.3e} (<= {SIM_TOL}), metrics max difference {diff:.3e}")
            if sim_diff > SIM_TOL:
                fail(f"the ranking similarities on the card differ from the CPU's: {sim_diff}")
    mm_table = {}
    for plan, _ in plans:
        ref = mm_metrics["xla", plan]
        row = {"xla": {k: ref[k] for k in ("mAP", "top1", "cmc1", "cmc5", "cmc10")}}
        for name in MM_PATHS[1:]:
            m = mm_metrics[name, plan]
            cos = (mm_feats[name, plan] * mm_feats["xla", plan]).sum(dim=1).min().item()
            row[name] = {"mAP": m["mAP"], "top1": m["top1"], "cmc1": m["cmc1"],
                         "cmc5": m["cmc5"], "cmc10": m["cmc10"], "min_cosine": cos,
                         "map_delta": abs(m["mAP"] - ref["mAP"])}
        mm_table[plan] = row
        t, i8 = row["fused_trunk"], row["fused_int8"]
        print(f"mm {plan:26s} mAP xla {ref['mAP']:.4f} fused_trunk {t['mAP']:.4f} "
              f"fused_int8 {i8['mAP']:.4f} | cmc1/5/10 xla {ref['cmc1']:.3f}/{ref['cmc5']:.3f}/"
              f"{ref['cmc10']:.3f} | min-cosine fused_trunk {t['min_cosine']:.6f} "
              f"fused_int8 {i8['min_cosine']:.6f} | |dmAP| {t['map_delta']:.6f} {i8['map_delta']:.6f}")
        if t["min_cosine"] < MIN_COSINE or t["map_delta"] > RANK_MAX_MAP_DELTA:
            fail(f"fused_trunk {plan}: min-cosine {t['min_cosine']} (>= {MIN_COSINE}) or "
                 f"|dmAP| {t['map_delta']} (<= {RANK_MAX_MAP_DELTA}) against xla")
    print(f"mm protocol: {len(plans)} plans x {len(MM_PATHS)} paths, {MM_IDS} ids x "
          f"{MM_GALLERY_PER_ID} gallery, {len(mm['q_pids'])} queries in "
          f"{time.perf_counter() - t0:.1f} s")
    print("mm_protocol: " + json.dumps(mm_table))

    # one text-only query step: its device time against its wall time
    text_args = (mm["q_images"], mm["q_mask"], mm["tokens"], mm["text_mask"])
    text_step = make_combo_embed_step(models["xla"], ("text",))
    for _ in range(WARMUP_RUNS):
        text_step(*text_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(E2E_ITERS):
        text_step(*text_args)
    torch.cuda.synchronize()
    text_wall_ms = (time.perf_counter() - t0) / E2E_ITERS * 1e3
    text_device_ms, text_prof_ms, events, _ = device_reading(
        torch, lambda: text_step(*text_args), "text query step")
    top = sorted(events, key=device_time, reverse=True)[:TOP_KERNELS]
    print(f"text query step (B={BATCH}, S={cfg.text_context_length}): device "
          f"{text_device_ms:.3f} ms of {text_wall_ms:.3f} ms (idle share "
          f"{1 - text_device_ms / text_wall_ms:.3f}) in {len(events)} kernels; top: "
          + json.dumps([[e.key[:60], e.count, round(device_time(e) / 1e3, 4)] for e in top]))
    del models, mm, mm_feats

    # reference on a small input: the port in f32 on the CPU, same images
    n_ref = 4
    ref_model = build_model(cfg.replace(compute_dtype="float32"), params, device="cpu")
    ref = make_combo_embed_step(ref_model, ("vis",))(images[:n_ref].cpu(), image_mask[:n_ref].cpu())
    for name, e in embeds.items():
        cos = (e[:n_ref].cpu() * ref).sum(dim=1).min().item()
        print(f"reference {name} (bf16, card) vs f32 CPU: min-cosine {cos:.6f} (>= {F32_MIN_COSINE})")
        if cos < F32_MIN_COSINE:
            fail(f"{name}: min-cosine {cos} against the f32 CPU reference < {F32_MIN_COSINE}")
    del ref_model

    # ---- 4b. the training step at full width: the 8x4 recipe
    t0 = time.perf_counter()
    train = train_phase(torch, cfg, params, counters, dev, card)
    print(f"train phase: {time.perf_counter() - t0:.1f} s")

    import tempfile

    from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset

    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        # 4c-4g: each evaluation dataset of this process decodes a file once
        # (their evaluate and CLI seconds then hold no repeated decode; 4c's
        # gallery embeds/s keeps datasets that decode every read)
        own_loader = decode_once(MultiModalDataset)
        # ---- 4c. the host data path and the dataset evaluation at full width
        t0 = time.perf_counter()
        data = dataset_phase(torch, cfg, params, counters, dev, card, train, tmp)
        print(f"dataset phase: {time.perf_counter() - t0:.1f} s")

        # ---- 4d. the trainer through its command line, on 4c's tree
        t0 = time.perf_counter()
        trainer = trainer_phase(torch, cfg, counters, dev, card, data["fed"], tmp)
        print(f"trainer phase: {time.perf_counter() - t0:.1f} s")

        # ---- 4e. the evaluation command line, on 4d's run A and a token-reduced run
        t0 = time.perf_counter()
        eval_cli = eval_cli_phase(torch, cfg, params, counters, dev, card, tmp)
        print(f"eval cli phase: {time.perf_counter() - t0:.1f} s")

        # ---- 4f. the serving path, on 4d's run A and 4c's tree
        t0 = time.perf_counter()
        serving = serving_phase(torch, cfg, counters, dev, card, tmp)
        print(f"serving phase: {time.perf_counter() - t0:.1f} s")

        # ---- 4g. training from CLIP weights, on 4c's tree
        t0 = time.perf_counter()
        clip = clip_phase(torch, cfg, counters, dev, card, tmp)
        print(f"clip phase: {time.perf_counter() - t0:.1f} s")
        MultiModalDataset._load_image = own_loader

        # ---- 4h. the measuring tools and the serving artifact, on 4c-4g's files
        t0 = time.perf_counter()
        tools = tools_phase(torch, cfg, counters, dev, card, tmp,
                            serving["f"]["latency_ms"]["embed_vis"]["p50"])
        print(f"tools phase: {time.perf_counter() - t0:.1f} s")

        # ---- 4i. data parallel over a process group, on 4c's tree
        t0 = time.perf_counter()
        parallel = parallel_phase(torch, cfg, counters, dev, card, tmp)
        print(f"parallel phase: {time.perf_counter() - t0:.1f} s")

        # ---- 4j. the CLIP ViT-L/14 and ViT-B/32 presets at full width
        t0 = time.perf_counter()
        presets = preset_phase(torch, counters, dev, card, tmp)
        print(f"preset phase: {time.perf_counter() - t0:.1f} s")

    # ---- 4k. OpenCLIP ViT-H/14's widths at full depth
    t0 = time.perf_counter()
    vit_h = vit_h_phase(torch, counters, dev, card)
    print(f"vit-h phase: {time.perf_counter() - t0:.1f} s")

    # ---- 5. timing
    import torch.nn.functional as Fn

    rows = []
    att_bytes = 4 * BATCH * H * S * Dh * 2
    att_flops = 4 * BATCH * H * S * S * Dh
    b_ms, b_by = bound_ms([(att_flops, PEAK_BF16_FLOPS)], att_bytes)
    sdpa_ms = time_ms(torch, lambda: Fn.scaled_dot_product_attention(q, k, v))
    rows.append(dict(
        name="fused_mha", route="cuda", source="prcv2025reid_tpu_torch/csrc/attention.cu",
        replaces="prcv2025reid_tpu/ops/pallas_attention.py:115",
        launches=launches["pallas_attention"]["fused_mha"],
        max_abs_err=max(mx for mx, _ in att_checks.values()),
        ms=time_ms(torch, lambda: fused_mha(q, k, v)),
        plain_ms=time_ms(torch, lambda: mha_plain(q, k, v)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=sdpa_ms,
    ))
    O = 3 * D
    qkv_bytes = T * D * 2 + D * O * 2 + O * 4 + 2 * D * 4 + T * O * 2
    b_ms, b_by = bound_ms([(2 * T * D * O, PEAK_BF16_FLOPS)], qkv_bytes)
    rows.append(dict(
        name="fused_ln_qkv", route="cuda", source="prcv2025reid_tpu_torch/csrc/fused_block.cu",
        replaces="prcv2025reid_tpu/ops/fused_block.py:97",
        launches=launches["fused"]["fused_ln_qkv"],
        max_abs_err=max(block_checks["fused_ln_qkv"][0], block_checks["fused_ln_qkv G=3"][0],
                        block_checks[f"fused_ln_qkv T={T_RED}"][0]),
        ms=time_ms(torch, lambda: fb.fused_ln_qkv(*qkv_args)),
        plain_ms=time_ms(torch, lambda: fb.ln_qkv_plain(*qkv_args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    mlp_bytes = 3 * T * D * 2 + (D * D + 2 * D * F) * 2 + (2 * D + F) * 4 + 2 * D * 4
    b_ms, b_by = bound_ms([(2 * T * D * (D + 2 * F), PEAK_BF16_FLOPS)], mlp_bytes)
    rows.append(dict(
        name="fused_out_mlp", route="cuda", source="prcv2025reid_tpu_torch/csrc/fused_block.cu",
        replaces="prcv2025reid_tpu/ops/fused_block.py:233",
        launches=launches["fused"]["fused_out_mlp"],
        max_abs_err=max(block_checks["fused_out_mlp"][0], block_checks["fused_out_mlp G=3"][0],
                        block_checks[f"fused_out_mlp T={T_RED}"][0]),
        ms=time_ms(torch, lambda: fb.fused_out_mlp(*mlp_args)),
        plain_ms=time_ms(torch, lambda: fb.out_mlp_plain(*mlp_args), runs=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    fmlp_bytes = 2 * T * D * 2 + 2 * D * F * 2 + (F + D) * 2
    b_ms, b_by = bound_ms([(4 * T * D * F, PEAK_BF16_FLOPS)], fmlp_bytes)
    rows.append(dict(
        name="fused_mlp", route="cuda", source="prcv2025reid_tpu_torch/csrc/fused_mlp.cu",
        replaces="prcv2025reid_tpu/ops/fused_mlp.py:43",
        launches=launches["fused_trunk"]["fused_mlp"],
        max_abs_err=max(block_checks["fused_mlp"][0], block_checks[f"fused_mlp T={T_RED}"][0],
                        block_checks[f"fused_mlp F={F_TP}"][0]),
        ms=time_ms(torch, lambda: fused_mlp(*fmlp_args)),
        plain_ms=time_ms(torch, lambda: mlp_plain(*fmlp_args), runs=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    b_ms, b_by = bound_ms([(8 * T * D, PEAK_F32_FLOPS)], 4 * T * D * 2 + 2 * D * 4)
    rows.append(dict(
        name="fused_residual_ln", route="cuda",
        source="prcv2025reid_tpu_torch/csrc/fused_resln.cu",
        replaces="prcv2025reid_tpu/ops/fused_resln.py:33",
        launches=launches["fused_trunk"]["fused_residual_ln"],
        max_abs_err=max(block_checks["fused_residual_ln xn"][0],
                        block_checks["fused_residual_ln y"][0]),
        ms=time_ms(torch, lambda: fused_residual_ln(*resln_args)),
        plain_ms=time_ms(torch, lambda: resln_plain(*resln_args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    # the int8 block kernels: int8 operations at the int8 rate, the bf16
    # out-projection of the mixed plan at the bf16 rate; each input read once
    # (int8 weights and their f32 column scales), each output written once
    i8_qkv_bytes = T * D * 2 + D * O + O * 4 * 2 + 2 * D * 4 + T * O * 2
    b_ms, b_by = bound_ms([(2 * T * D * O, PEAK_INT8_OPS)], i8_qkv_bytes)
    rows.append(dict(
        name="fused_ln_qkv_int8", route="cuda",
        source="prcv2025reid_tpu_torch/csrc/fused_block_int8.cu",
        replaces="prcv2025reid_tpu/ops/fused_block.py:103",
        launches=launches["fused_int8"]["fused_ln_qkv_int8"],
        max_abs_err=max(block_checks["fused_ln_qkv_int8"][0],
                        block_checks["fused_ln_qkv_int8 G=3"][0],
                        block_checks[f"fused_ln_qkv_int8 T={T_RED}"][0]),
        ms=time_ms(torch, lambda: fb.fused_ln_qkv_int8(*qkv8_args)),
        plain_ms=time_ms(torch, lambda: fb.ln_qkv_int8_plain(*qkv8_args), runs=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    i8_mlp_bytes = 3 * T * D * 2 + (2 * D + F) * 4 * 2 + 2 * D * 4
    b_ms, b_by = bound_ms([(2 * T * D * (D + 2 * F), PEAK_INT8_OPS)],
                          i8_mlp_bytes + D * D + 2 * D * F)
    rows.append(dict(
        name="fused_out_mlp_int8", route="cuda",
        source="prcv2025reid_tpu_torch/csrc/fused_block_int8.cu",
        replaces="prcv2025reid_tpu/ops/fused_block.py:247",
        launches=launches["fused_int8"]["fused_out_mlp_int8"],
        max_abs_err=max(block_checks["fused_out_mlp_int8"][0],
                        block_checks["fused_out_mlp_int8 G=3"][0],
                        block_checks[f"fused_out_mlp_int8 T={T_RED}"][0]),
        ms=time_ms(torch, lambda: fb.fused_out_mlp_int8(*mlp8_args)),
        plain_ms=time_ms(torch, lambda: fb.out_mlp_int8_plain(*mlp8_args), runs=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    b_ms, b_by = bound_ms([(2 * T * D * D, PEAK_BF16_FLOPS), (4 * T * D * F, PEAK_INT8_OPS)],
                          i8_mlp_bytes + D * D * 2 + 2 * D * F - D * 4)
    rows.append(dict(
        name="fused_out_mlp_int8mlp", route="cuda",
        source="prcv2025reid_tpu_torch/csrc/fused_block_int8.cu",
        replaces="prcv2025reid_tpu/ops/fused_block.py:263",
        launches=launches["fused_int8_mlp"]["fused_out_mlp_int8mlp"],
        max_abs_err=max(block_checks["fused_out_mlp_int8mlp"][0], block_checks["fused_out_mlp_int8mlp G=3"][0]),
        ms=time_ms(torch, lambda: fb.fused_out_mlp_int8mlp(*mlp8m_args)),
        plain_ms=time_ms(torch, lambda: fb.out_mlp_int8mlp_plain(*mlp8m_args), runs=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    b_ms, b_by = bound_ms([(att_flops, PEAK_BF16_FLOPS)], att_bytes)
    rows.append(dict(
        name="splash_attention_bshd", route="cuda",
        source="prcv2025reid_tpu_torch/csrc/attention.cu",
        replaces="prcv2025reid_tpu/ops/attention.py:119",
        launches=launches["splash"]["splash_attention_bshd"],
        max_abs_err=block_checks["splash_attention_bshd"][0],
        ms=time_ms(torch, lambda: att.splash_attention_bshd(*splash_args)),
        plain_ms=time_ms(torch, lambda: att.splash_plain(*splash_args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=sdpa_ms,
    ))
    # #1 and #8 at token reduction's shapes (phase 4e's paths), beside their bounds
    q_r, k_r, v_r = red_qkv
    att_r_bytes = 4 * BATCH * H * S_RED * Dh * 2
    b_ms, b_by = bound_ms([(4 * BATCH * H * S_RED * S_RED * Dh, PEAK_BF16_FLOPS)], att_r_bytes)
    reduced_rows = [dict(
        name="fused_mha", shape=f"B={BATCH} S={S_RED} H={H} Dh={Dh}",
        max_abs_err=att_checks[f"S={S_RED}"][0],
        ms=time_ms(torch, lambda: fused_mha(q_r, k_r, v_r)),
        plain_ms=time_ms(torch, lambda: mha_plain(q_r, k_r, v_r)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: Fn.scaled_dot_product_attention(q_r, k_r, v_r)))]
    b_ms, b_by = bound_ms([(4 * T_RED * D * F, PEAK_BF16_FLOPS)],
                          2 * T_RED * D * 2 + 2 * D * F * 2 + (F + D) * 2)
    reduced_rows.append(dict(
        name="fused_mlp", shape=f"T={T_RED} D={D} F={F}",
        max_abs_err=block_checks[f"fused_mlp T={T_RED}"][0],
        ms=time_ms(torch, lambda: fused_mlp(*fmlp_r_args)),
        plain_ms=time_ms(torch, lambda: mlp_plain(*fmlp_r_args), runs=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for r in reduced_rows:
        print(f"kernel {r['name']} at token reduction's shape {r['shape']} ({card}): "
              f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']})")
    # #1 and #8 at tensor parallelism's shapes (phase 4i (d): each process's
    # H / TP_MODEL heads and F / TP_MODEL), beside their bounds
    b_ms, b_by = bound_ms([(4 * BATCH * H_TP * S * S * Dh, PEAK_BF16_FLOPS)],
                          4 * BATCH * H_TP * S * Dh * 2)
    tp_rows = [dict(
        name="fused_mha", shape=f"B={BATCH} S={S} H={H_TP} Dh={Dh}",
        max_abs_err=att_checks[f"H={H_TP}"][0],
        ms=time_ms(torch, lambda: fused_mha(*tp_qkv)),
        plain_ms=time_ms(torch, lambda: mha_plain(*tp_qkv)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: Fn.scaled_dot_product_attention(*tp_qkv)))]
    b_ms, b_by = bound_ms([(4 * T * D * F_TP, PEAK_BF16_FLOPS)],
                          2 * T * D * 2 + 2 * D * F_TP * 2 + (F_TP + D) * 2)
    tp_rows.append(dict(
        name="fused_mlp", shape=f"T={T} D={D} F={F_TP}",
        max_abs_err=block_checks[f"fused_mlp F={F_TP}"][0],
        ms=time_ms(torch, lambda: fused_mlp(*fmlp_tp_args)),
        plain_ms=time_ms(torch, lambda: mlp_plain(*fmlp_tp_args), runs=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for r in tp_rows:
        print(f"kernel {r['name']} at tensor parallelism's shape {r['shape']} ({card}): "
              f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']})")
    # #1, #11, #3, #5, #8 and #9 at the L/14 preset's shapes (phase 4j (a): B =
    # BATCH images of S14 tokens, T14 rows of D14, F14; #1 also at 336 px's
    # S_L14_336 tokens), beside their bounds; launches: per forward in 4j (a)
    # (at S_L14_336: in 4j (a'))
    l14_launch = {n: r["launches"] for n, r in presets["l14_embed"].items()}
    l14_336_launch = {n: r["launches"] for n, r in presets["l14_336_embed"].items()}
    l14_rows = []
    for s_len in (S14, S_L14_336):
        views = l14_qkv[s_len][1]
        b_ms, b_by = bound_ms([(4 * BATCH * H14 * s_len * s_len * Dh, PEAK_BF16_FLOPS)],
                              4 * BATCH * H14 * s_len * Dh * 2)
        l14_rows.append(dict(
            name="fused_mha", shape=f"B={BATCH} S={s_len} H={H14} Dh={Dh}",
            launches=(l14_launch if s_len == S14 else l14_336_launch)["pallas_attention"].get(
                "fused_mha", 0),
            max_abs_err=att_checks[f"S={s_len} H={H14} causal=False"][0],
            ms=time_ms(torch, lambda v=views: fused_mha(*v)),
            plain_ms=time_ms(torch, lambda v=views: mha_plain(*v), runs=10),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(torch, lambda v=views: Fn.scaled_dot_product_attention(*v))))
    b_ms, b_by = bound_ms([(4 * BATCH * H14 * S14 * S14 * Dh, PEAK_BF16_FLOPS)],
                          4 * BATCH * H14 * S14 * Dh * 2)
    l14_rows.append(dict(
        name="splash_attention_bshd", shape=f"B={BATCH} S={S14} H={H14} Dh={Dh}",
        launches=l14_launch["splash"].get("splash_attention_bshd", 0),
        max_abs_err=block_checks[f"splash_attention_bshd S={S14} H={H14}"][0],
        ms=time_ms(torch, lambda: att.splash_attention_bshd(*l14_splash)),
        plain_ms=time_ms(torch, lambda: att.splash_plain(*l14_splash), runs=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=l14_rows[0]["library_ms"]))
    l14_rows += block_kernel_rows(torch, l14_fns, l14_launch, T14, D14, F14, block_checks)
    for r in l14_rows:
        print(f"kernel {r['name']} at the L/14 preset's shape {r['shape']} ({card}): "
              f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}); {r['launches']} a forward")
    # #1, #3, #5, #8 and #9 at ViT-H/14's widths (phase 4k (a): B = BATCH
    # images of SH tokens, 16 heads of 80; TH rows of DH, FH), beside their
    # bounds and SDPA; launches: per forward in 4k (a)
    vit_h_launch = {n: r["launches"] for n, r in vit_h["embed"].items()}
    b_ms, b_by = bound_ms([(4 * BATCH * HH * SH * SH * DhH, PEAK_BF16_FLOPS)],
                          4 * BATCH * HH * SH * DhH * 2)
    vit_h_rows = [dict(
        name="fused_mha", shape=f"B={BATCH} S={SH} H={HH} Dh={DhH}",
        launches=vit_h_launch["pallas_attention"].get("fused_mha", 0),
        max_abs_err=att_checks[f"S={SH} H={HH} Dh={DhH}"][0],
        ms=time_ms(torch, lambda: fused_mha(*vit_h_views)),
        plain_ms=time_ms(torch, lambda: mha_plain(*vit_h_views), runs=10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: Fn.scaled_dot_product_attention(*vit_h_views)))]
    vit_h_rows += block_kernel_rows(torch, vit_h_fns, vit_h_launch, TH, DH, FH, block_checks)
    for r in vit_h_rows:
        print(f"kernel {r['name']} at ViT-H/14's widths {r['shape']} ({card}): "
              f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}); {r['launches']} a forward")
    # #1 at a padded head width of 128 (attn_long_kernel) in the kernels line,
    # at the shape 4k's embeds run it at
    rows.append(dict(
        name=f"fused_mha attn_long_kernel {vit_h_rows[0]['shape']}", route="cuda",
        source="prcv2025reid_tpu_torch/csrc/attention.cu",
        replaces="prcv2025reid_tpu/ops/pallas_attention.py:115",
        **{k: vit_h_rows[0][k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}))
    # the register-held kernel (#1 past 256 tokens) in the kernels line, at
    # the two lengths the L/14 preset's embeds of 4j run it at
    for r in l14_rows[:2]:
        rows.append(dict(
            name=f"fused_mha attn_reg_kernel {r['shape']}", route="cuda",
            source="prcv2025reid_tpu_torch/csrc/attention.cu",
            replaces="prcv2025reid_tpu/ops/pallas_attention.py:115",
            **{k: r[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}))
    # the microbenchmark's tiled matmul at M = 25,344, K = 768, N = 3072: each
    # input read once, the output written once; no model path launches it
    Mm = MATMUL_ROWS[0]
    mm_launches = sum(n["tiled_matmul"] for n in launches.values())
    for mode, peak, out_bytes, library in (
            ("bf16", PEAK_BF16_FLOPS, 2, torch.matmul), ("int8", PEAK_INT8_OPS, 4, torch._int_mm)):
        a, w = mm_args[mode]
        b_ms, b_by = bound_ms([(2 * Mm * D * F, peak)],
                              (Mm * D + D * F) * a.element_size() + Mm * F * out_bytes)
        rows.append(dict(
            name=f"tiled_matmul_{mode}", route="cuda",
            source="prcv2025reid_tpu_torch/csrc/matmul.cu",
            replaces="tools/perf_microbench.py:98",
            launches=mm_launches, max_abs_err=mm_err[mode],
            ms=time_ms(torch, lambda a=a, w=w: tiled_matmul(a, w)),
            plain_ms=time_ms(torch, lambda a=a, w=w: matmul_plain(a, w), runs=20),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(torch, lambda a=a, w=w, f=library: f(a, w)),
        ))
    # yardsticks outside the contract: cuBLAS on the bare products of the MLP and
    # block kernels (torch._int_mm on the int8 ones), PyTorch's add + layer_norm
    # beside the residual+LN pass
    x2d, a2d = x[0], attn[0]
    h2d = torch.empty(T, F, device=dev, dtype=torch.bfloat16).normal_(generator=gen)
    fc1_ms, fc2_ms = time_ms(torch, lambda: x2d @ w1[0]), time_ms(torch, lambda: h2d @ w2[0])
    xq, hq = fb.quant_rows(x2d.float())[0], fb.quant_rows(h2d.float())[0]
    i8 = {n: time_ms(torch, lambda w=w, a=a: torch._int_mm(a, w[0][0]))
          for n, a, w in (("qkv", xq, q_wqkv), ("out", xq, q_wo), ("fc1", xq, q_w1),
                          ("fc2", hq, q_w2))}
    out_ms = time_ms(torch, lambda: a2d @ wo[0])
    yard = {
        "cublas_qkv_gemm_ms": time_ms(torch, lambda: x2d @ wqkv[0]),
        "cublas_out_mlp_gemms_ms": out_ms + fc1_ms + fc2_ms,
        "int_mm_qkv_gemm_ms": i8["qkv"],
        "int_mm_out_mlp_gemms_ms": i8["out"] + i8["fc1"] + i8["fc2"],
        "cublas_out_plus_int_mm_mlp_gemms_ms": out_ms + i8["fc1"] + i8["fc2"],
        "cublas_mlp_gemms_ms": fc1_ms + fc2_ms,
        "torch_add_layer_norm_ms": time_ms(torch, lambda: Fn.layer_norm(
            x2d + a2d, (D,), lns.bfloat16(), lnb.bfloat16(), 1e-5)),
        "fused_mlp_g3_rel_err": block_checks["fused_mlp G=3"][1],
        "grad_rel_err_vs_plain_autograd": grad_err,
        "attention_causal_v2_rel_err": att_checks[(True, 2)][1],
        "attention_v1_rel_err": att_checks[(False, 1)][1],
        "attention_text_causal_rel_err": att_checks["text"][1],
        "rel_err": {"fused_mha": att_checks[(False, 2)][1],
                    **{n: v[1] for n, v in block_checks.items()}},
        "launches_by_path": launches,
    }
    print("yardsticks: " + json.dumps(yard))

    # end to end: the configurations in turns, E2E_ROUNDS rounds, median rate
    rates = {name: [] for name in steps}
    for name, step in steps.items():
        step(images, image_mask)
    for rnd in range(E2E_ROUNDS):
        for name in (list(steps) if rnd % 2 == 0 else list(steps)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(E2E_ITERS):
                steps[name](images, image_mask)
            torch.cuda.synchronize()
            rates[name].append(BATCH * E2E_ITERS / (time.perf_counter() - t0))
    e2e = {name: statistics.median(r) for name, r in rates.items()}
    print("end_to_end_rounds: " + json.dumps(rates))
    print(f"dataset path vs resident batches ({card}): gallery embed_samples on fused_trunk "
          + ", ".join(f"{d} decode {g['embeds_per_s']:.1f} embeds/s (idle share "
                      f"{g['idle_share']:.3f}, batch {g['batch']})"
                      for d, g in data["gallery_embed"].items())
          + f" against {e2e['fused_trunk']:.1f} embeds/s for a resident batch of {BATCH}; the "
          "pipeline " + ", ".join(f"{d} {data['pipeline'][d]['batches_per_s']:.2f} batches/s"
                                  for d in data["gallery_embed"])
          + "; the fed train step " + ", ".join(
              f"{n} {f['it_per_s']:.3f} it/s (resident {train[n]['it_per_s']:.3f})"
              for n, f in data["fed"].items()))

    # where one embed step's device time goes, per configuration
    device_ms, profiler_ms = {}, {}
    for name, step in steps.items():
        device_ms[name], profiler_ms[name], events, _ = device_reading(
            torch, lambda: step(images, image_mask), f"embed step {name}")
        top = sorted(events, key=device_time, reverse=True)[:TOP_KERNELS]
        wall_ms = BATCH / e2e[name] * 1e3
        print(f"profile {name}: device {device_ms[name]:.3f} ms of {wall_ms:.3f} ms per step "
              f"(idle share {1 - device_ms[name] / wall_ms:.3f}); top of the profiler's "
              f"{len(events)} kernels: "
              + json.dumps([[e.key[:60], e.count, round(device_time(e) / 1e3, 4)] for e in top]))

    # 4h (a): trace_embed.py's CUDA events against this process's reading
    for name, r in tools["trace_embed"].items():
        ref = device_ms[name]
        print(f"tools (a) trace_embed {name}: CUDA events {r['device_ms']:.3f} ms in its own "
              f"process against phase 5's {ref:.3f} ms")
        if not abs(r["device_ms"] - ref) <= TOOL_DEVICE_SPREAD * ref:
            fail(f"trace_embed {name}: device ms {r['device_ms']} outside "
                 f"{TOOL_DEVICE_SPREAD:.0%} of phase 5's {ref}")

    # ---- 6. the microbenchmark's entry point: the card's own rates
    pmb = load_tool("perf_microbench")
    bench = pmb.Bench("cuda")
    probe_rates = {}
    t0 = time.perf_counter()
    for name in MICROBENCH:
        probe_rates.update(pmb.PROBES[name](bench))
    print(f"microbench ({time.perf_counter() - t0:.1f} s, rates / 1e12): " + json.dumps(
        {label: rate / 1e12 for label, rate in probe_rates.items()}))

    print("end_to_end: " + json.dumps({
        "card": card, "batch": BATCH, "embeds_per_sec": e2e, "device_ms_per_step": device_ms,
        "profiler_ms_per_step": profiler_ms,
        "min_cosine_vs_xla": gate, "rank_gate_vs_xla": rank_gate,
        "text_query_step": {"device_ms": text_device_ms, "profiler_ms": text_prof_ms,
                            "wall_ms": text_wall_ms,
                            "idle_share": 1 - text_device_ms / text_wall_ms},
        "train_step_8x4": train,
        "dataset_phase": data,
        "trainer_phase": trainer,
        "eval_cli_phase": eval_cli,
        "serving_phase": serving,
        "clip_phase": clip,
        "tools_phase": tools,
        "parallel_phase": parallel,
        "preset_phase": presets,
        "vit_h_phase": vit_h,
        "kernels_at_token_reduced_shapes": reduced_rows,
        "kernels_at_tensor_parallel_shapes": tp_rows,
        "kernels_at_l14_shapes": l14_rows,
        "kernels_at_vit_h_shapes": vit_h_rows,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    for r in rows:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms, library {r['library_ms']})")
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
