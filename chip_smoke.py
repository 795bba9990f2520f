#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mmlspark_tpu_torch``) on one H100.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``); it imports
nothing of JAX or of the JAX package. With ``--ab PARENT`` (a checkout
of another commit, its sources beside this tree's) it only times calls
through that tree's kernel library and this one's in turns: K4's verify,
K4's f32 training variant, K6's f32 dh and dW, K7's and K8's f32
forward, dq and dk/dv, and the speculative round's device time. With
``--ab-moe-slots`` it only times phase 24's MoE train step with the
capacity slots' cumsum along the tokens' dim and along the innermost dim,
in turns. With ``--ab-gbdt PARENT`` it only times the GBDT fits of
phases 13 and 29 (the adult cell on one device and on the four learners'
hosted mesh, the Higgs-shape cell) and K9 at phase 12's uint8 Higgs
cases through that tree's package and this one's, a process a turn.
Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the kernels from ``mmlspark_tpu_torch/csrc`` (nvcc,
   ``sm_90a``) and print the build seconds and register use; the eleven
   bf16 tensor-core instances (K7's forward for both output types, dq,
   dk/dv; K4's forward with and without the logits store, K6's dh and
   dW; K8's ring-block forward, dq and dk/dv) must report 0 spill bytes,
   and, where the toolkit has ``cuobjdump``, contain ``HGMMA`` (wgmma)
   instructions; K7's and the CE's registers are printed beside their
   recorded counts (``KNOWN_REGISTERS``); the 3xTF32 instances, K2's
   two (``flash_prefill_tf32``, head dims padded to 32 and 64), K3's
   four (``paged_prefix_tf32``, the same with 16- and 32-row query
   tiles), K4's f32 ten (``ce_fwd_stream_tf32`` for 1 to 8 n8 token
   tiles, ``ce_fwd_tf32`` with and without the logits store), K6's
   f32 two (``ce_dh_tf32``, ``ce_dw_tf32``) and the f32 training
   attention's twelve (``attn_fwd_tf32``, ``attn_dq_tf32``,
   ``attn_dkdv_tf32`` from ``csrc/attention_tf32.cuh``, each with K7's
   and K8's mask at head dims padded to 32 and 64) must report 0 spill
   bytes and contain ``HMMA`` (mma.sync) instructions where ``cuobjdump``
   exists; K9's instances (uint8 and int32 bins, and the merge) and the
   f32 CUDA-core kernels (K1's split kernel and the split merge it
   shares with K3, K4's merge) print their registers and spills;
3. hold K1/K2/K3/K4 against their plain PyTorch versions at the
   slices' full-width shapes (max abs error <= 1e-4, f32; K1 at page
   edges, the lane's ends, every split boundary of its plan and beside
   free slots; K2 at S in
   {1, 15, 16, 17, 63, 64, 65, 128, 129, 1000, 1024} and the prompt
   bucket; K3 at (hit_len, S) in {(0, 16), (16, 5), (256, 64),
   (512, 33), (1008, 64), (256, 768), (16, 1008)} and the path's; two
   launches bitwise equal for K2 at the bucket, K1 at the path's
   positions, K3 at the path's hit and K4 at the verify's T and at T
   100; K4 at T in {1, 7, 24, 64, 65, 100} x V in {32768, 32000} with
   labels that match no column: its few-token kernel up to T 64, its
   many-token one past) and time the kernel, the plain version and the
   library call where one computes the same function:
   ``scaled_dot_product_attention`` for K2 (at the prompt bucket and
   again at the decoder's max_len, each beside both bounds: 3xTF32 at
   the TF32 tensor-core rate, the route it takes and its ``bound_ms``,
   and f32 operations on the CUDA cores), the lane gathered through the
   table then ``scaled_dot_product_attention`` under the position mask
   for K1 and K3 (each also at a second shape: K1 at pos 1000-1021, K3
   at hit 256, S 768 beside K2 at S 1024; each call's device time parted
   into its split and merge kernels), ``h @ w`` then ``cross_entropy`` (two
   calls) for K4, beside the 3xTF32 bound and the CUDA cores', its call
   parted into its partials kernel and the merge, and one read of W's
   bytes alone (``sum``) under the same protocol (cold L2: a 256 MiB
   write between launches; an empty launch's reading under the same
   protocol is printed as the floor);
4. serve traffic through ``DecodeScheduler`` -> ``TransformerDecoder`` at
   the width of the repo's transformer LM (``bench.py`` train bench:
   vocab 32768, d_model 512, 8 heads x 64, d_ff 2048, 8 layers; f32 as
   the decode path runs it; random weights from a seed): 8 requests on
   two shared 256-token preambles (7 greedy, 1 seeded-sampled), then the
   same 8 again, which hit the prefix cache, then one cold and one warm
   request alone (time to first token). Every reply must be 200 with
   its full token budget, no step may fault, each kernel's launch count
   must equal 8 layers x its calls, the prefix cache must hit, the page
   ledger must be clean at idle and the pool must not move;
5. profile 8 full-batch decode steps (``torch.profiler``): step wall
   time, device busy time, the top kernels by device time and K1's
   share of the device time (its split and merge kernels);
6. replay pass 1 through a ``cuda`` and a ``dense`` decoder in lockstep,
   teacher-forced with the served tokens: every prefill's and step's
   logits must agree within 1e-3;
7. speculative decode (slice 2): ``make_spec_model_pair`` on the same
   tree (``wo``/``w2`` scaled by RESID_SCALE, a 2-layer truncated draft
   whose teacher-forced greedy agreement with the target is printed
   beside the default scale's), ``spec_k=4``, the verify's scores
   through K4. Pass 1's payloads (the
   sampled one opting in with ``"speculative": true``) served twice,
   cold then through the prefix cache: every reply 200 with its full
   budget, no fault, speculative rounds > 0, K4 launched once per
   round, K1/K2/K3 per their formulas (the draft's prefills run K2 too),
   a clean page ledger and neither the KV pool nor the draft pool
   moving; the 7 greedy requests' tokens equal a non-speculative
   decoder's on the same tree (a divergence passes only where that
   decoder's top-2 logit gap is below 1e-3, and is printed);
8. teacher-force 4 verify rounds through a ``verify_ce_impl="cuda"``
   and a ``"dense"`` decoder: logits and scores within 1e-3; profile one
   speculative round (propose + verify) beside the step profile;
9. the train step's kernels (slice 3) against their plain versions, in
   f32 and bf16: attention forward with lse, dq and dk/dv (K7, and K5
   through the same kernels) at (B, S) in {(1, 1), (1, 17), (2, 128),
   (1, 384), (8, 1024), (2, 4096)} x 8 heads x 64; K4's training
   variant and K6 dh / dW at T in {7, 512, 8192} x V in {32768, 32000}
   with labels that match no column. In f32 the max abs error <= 1e-4 x
   max(1, max |ref|), and every kernel's scaled error (each element's
   error over its own magnitude plus the output's RMS) <= F32_SCALED_TOL;
   in bf16 the scaled error <= the kernel's BF16_LIMITS entry; the
   attention kernels <= ONE_TILE_TOL where S fits one key tile. Each
   kernel, its plain version and a library call timed at the bench
   shape in bf16 (cold L2), with its TFLOP/s, and K4's no-store bf16
   forward beside its training variant (the logits store's cost); K4's
   training variant and K6's dh and dW again in f32 (3xTF32) at T 2048,
   the f32 parity step's tokens, and K7's forward, dq and dk/dv in f32
   (3xTF32) at its B 2 x S 1024, each twice bitwise equal, beside both
   bounds, the library calls in f32 with TF32 off (f32
   ``scaled_dot_product_attention`` for K7, the backend that serves it
   printed) and the time of its three tf32 products at the rate this
   card runs mma.sync (``csrc/mma_probe.cu``, a probe, not a kernel of
   the port); the
   train loss through both engines, forward and backward, at T = 256
   (below the auto gate's 512) and 8192;
10. train engine parity at the bench width in f32: 3 steps (lr 0.01,
   momentum 0.9) of ``attention_impl="folded", ce_impl="cuda"`` against
   ``"dense"/"dense"`` on one ``make_batch`` batch at B = 2, S = 1024:
   every loss within 1e-4 relative, every parameter leaf within 1e-4
   after step 3; the kernel engines' launches read around their 3 steps
   (K7's f32 kernels 8 each a step, K4's training variant and K6's dh
   and dW 1 each, all in 3xTF32: the f32 records' ``launches``) and the
   dense engines' (none);
11. the train path at the bench config (``bench.py``'s
   ``bench_transformer_train``: bf16, B = 8, S = 1024, lr 0.01, momentum
   0.9) on one fixed batch for 20 steps through ``build_train_step``
   with the auto engines: finite losses, step 20 below step 1, params
   and velocity keep their ``data_ptr``s, exact per-step launch counts
   (attention forward, dq, dk/dv 8 each; K4's training variant, K6 dh,
   K6 dW 1 each; the verify's K4 0); ms per step, tokens/s, the
   analytic FLOPs per step (``bench.py``'s formula), achieved TFLOP/s
   and MFU against the bf16 peak, a ``torch.profiler`` trace of 3
   steps, and in the same call the rates of the dense/dense,
   folded/dense and dense/auto engines (attention/CE), which part the
   attention engine's gap from the CE engines', and auto/auto minus
   folded/dense (what the fused CE costs over the dense loss);
12. K9, the GBDT histogram build (slice 4), against its plain version
   at (rows, features, bins) in {(777, 11, 37), (4096, 100, 255),
   (32768, 14, 255), (2^20, 28, 255)} with in-leaf densities 0.7, 0 and
   one row, with bins in uint8 and in int32: the int64 fixed-point
   output equal bit for bit to the plain version's on the card and on
   the CPU, and two launches equal; the kernel and ``index_add_`` (of
   the fixed-point values) timed at 2^20 x 28 x 255
   for the root histogram and for leaves of 1/8 and 1/64 scattered
   rows, each in uint8 (the GBDT path's layout; the root with the plain
   version) and in int32, each beside its bytes bound (the function's
   bytes: mask, the live rows' bins, grad and hess, the output) and,
   apart, the bytes of the clusters' partials the design writes and
   reads back;
13. the GBDT path through ``Booster.train`` on the card, K9's launches
   read around all of its fits and equal to iterations x outputs x
   leaves in each: ``bench.py``'s ``bench_gbdt_quantile`` and
   ``bench_adult_census`` configs (a warm fit, then ``GBDT_TIMED_FITS``
   timed ones: their median),
   each against the same fit on the CPU — every iteration's trees,
   leaf values and predictions equal bit for bit (``same_trees``; where
   they would part, the leaf's gradients, histogram and each step of
   the split search are compared bit for bit between card and CPU,
   ``parting_cause``, and the phase fails); every split and leaf of the
   card fit replayed with the CPU's arithmetic, each the CPU's pick and
   value bit for bit (``replay_on_cpu``); the final train AUC within
   1e-3 and pinball loss within 1e-2 relative (``GBDT_METRIC_TOL``); and
   the card booster's ``predict`` equal to its CPU ``predict`` bit for
   bit;
14. the Higgs-shape cell (2^20 rows x 28 features, 255 leaves, binary):
   a warm 2-iteration fit, two ``HIGGS_ITERS``-iteration fits whose
   trees must be
   identical, a train loss that falls every iteration, the fused loop
   timed alone (seconds per iteration, rows x iterations per second)
   and a ``torch.profiler`` trace of one iteration (device busy share,
   K9's device ms per iteration and its share of device time, the top
   kernels);
15. K8, the ring-attention block step (slice 5; bf16 on the tensor
   cores, with each block's live tiles listed from the positions),
   against its plain versions: forward partials (o, m, l),
   dq and dk/dv at (B, S_local) in {(1, 1), (1, 17), (2, 128), (1, 384),
   (2, 1024), (8, 1024), (1, 4096)} x 8 heads x 64, f32 and bf16, for
   the diagonal, full, no-visibility and padded-key block pairs
   (causal), the diagonal, padded and all-padded ones bidirectional,
   seeded permutations of the keys' positions with an eighth of the keys
   padded inside tiles (both), and at (8, 1024) the four steps of a
   hosted ``{"seq": 4}`` ring (each rank's rows with its own positions);
   then Sq != Sk (1024 x 384 and 384 x 1024) and Dh 16 and 36 (rows
   not 16-byte aligned) at B 2 (``K8_EXTRA``): limits as phase 9's,
   the bf16 ones in ``K8_BF16_LIMITS``; every row that sees no key must
   come out exactly l = 0, o = 0, m = -1e30, dq = 0, and a launch in
   which no row sees a key exactly dk = dv = 0. Each kernel, its plain
   version and a masked ``scaled_dot_product_attention`` (boolean mask
   from the positions; forward, and its backward for dq and dk/dv)
   timed at B 2, S_local 1024, bf16, cold L2, for a full and a diagonal
   block, and again in f32 (3xTF32; each kernel twice bitwise equal, the
   f32 SDPA's backend printed) beside phase 9's three f32 bounds;
16. ring parity in f32 at B 2 x S 4096: ``ring_attention`` on a hosted
   ``{"seq": 4}`` mesh (folded, K8) against ``dense_attention`` over the
   whole sequence, output and the grads of q, k, v under a seeded
   cotangent, within 1e-4 x max(1, |ref|); then 3 steps (lr 0.01,
   momentum 0.9) of ``build_spmd_train_step`` on ``{"seq": 4}`` and on
   ``{"seq": 1}`` against ``build_train_step`` with
   ``attention_impl="folded"`` (K7): losses within 1e-4 relative,
   every parameter leaf within 1e-4 after step 3, and exact launch
   counts around the ``{"seq": 4}`` steps (K8's f32 kernels 32 each a
   step: the K8 f32 records' ``launches``) and the K7 steps;
17. the sequence-parallel train path at ``bench.py``'s
   ``transformer_train_long_v1`` (the bench width, bf16, B 2 x S 4096,
   lr 0.01, momentum 0.9) through ``build_spmd_train_step`` on a hosted
   ``{"seq": 4}`` mesh: a warm step, then 10 steps on one batch with
   finite losses, step 10 below step 1, params and velocity keeping
   their ``data_ptr``s and exact per-step launch counts (the hosted
   ranks of a ring step share one launch: K8 forward, dq and dk/dv
   8 layers x 4 ring steps each; K4's training variant, K6 dh and dW 1
   each; every other kernel, K7's included, 0); ms per step, tokens/s,
   the analytic FLOPs (``bench.py``'s formula) and MFU, a
   ``torch.profiler`` trace of 3 steps with K8's device ms by kernel
   name and its share of the step's device time, and in the same call
   the rates of the ``{"seq": 1}`` ring and of ``build_train_step`` (K7)
   with a trace of each, which parts their device time into the
   attention kernels (K8 or K7) and the rest;
18. the observability plane: phase 4's two passes and
   phase 7's two speculative passes again, each scheduler bound to a
   ``MetricsRegistry`` and a ``Tracer``, a ``tsdb.Recorder`` scraping
   each registry every 0.25 s, a ``SamplingProfiler`` sampling the
   host at 50 Hz and one ``DeviceProfiler`` window of 2 s open over
   paged pass 1 (closed, its trace written, before pass 2, so pass 2
   reads the metrics' and spans' cost alone), with a bare scheduler
   serving the same passes on the same decoder just before and just
   after: greedy tokens equal the bare runs', launches per the
   formulas of phases 4 and 7, the decode counters equal ``stats()``
   (prefix hits, spec rounds, proposed and accepted, the KV pool's
   bytes), one TTFT observation a request, tokens per request summing
   to the tokens, the prefill, step and spec-round histograms counting
   prefills, steps and rounds, the device time charged to tenants equal
   to those histograms' sums (1e-6 relative), every request's span tree
   holding queue_wait, prefill, first_token and decode, the spec_round
   spans adding up to the counters, the TSDB's instant
   ``serving_decode_tokens_total`` equal to the counter and a non-empty
   ``rate(...[2s])``, the window's Chrome trace naming K1's split
   kernel, a second window refused while it is open, and the card's
   vitals (``device_memory_stats`` at least the pool, ``build_info``
   naming the card, ``MfuMeter``'s peak for it); prints tokens/s bare,
   instrumented and bare again, each pass's step and spec-round
   medians, the sampler's own cost a sample, the
   Recorder's ingest time and the scheduler thread's samples by where
   the innermost Python frame was (torch, the port, the rest) with its
   ten hottest frames;
19. the ``/generate`` serving stack: phase 4's model behind a
   ``ServingServer(Identity(), decoder=...)``, each server with a fresh
   ``DecodeScheduler`` over one warmed decoder, talked to with the
   standard library only (``http.client``, raw sockets for SSE): phase
   4's 8 requests sent at once as ``POST /generate``, twice (cold, then
   prefix hits), on the event loop and on the threaded edge, tokens and
   finish reasons equal to phase 4's direct replies and K1-K3's launches
   per phase 4's formulas; on the event loop the same 8 streamed as SSE
   (token events equal to the final event and to the direct replies), a
   plain request on a stream's kept socket, a replayed
   ``X-Request-Id`` (``X-Replayed: 1``, no kernel launched), a
   mid-stream disconnect (released as ``disconnected``, every slot
   free, the page ledger clean), a 429 with ``Retry-After`` at
   ``max_waiting = 0``, ``serving_decode_tokens_total`` equal to
   ``stats()``, ``serving_build_info`` naming the card and
   ``/decode/stats`` at 0 slots in use; phase 7's pass 1 through
   ``/generate`` on a speculative decoder (tokens equal to phase 7's,
   K4's launches equal to the rounds); only this script's thread and
   the scheduler's launch kernels or synchronize the card; prints
   tokens/s direct, event loop, threaded, direct again, TTFT on the wire
   (send to the first SSE event) beside the scheduler's histogram, cold
   and with a 256-token hit, and the phase's seconds;
20. the dense slot-lane pool: phase 4's model at full width through
   ``TransformerDecoder(paged=False)`` (8 slots, max_len 1024) and a
   dense ``DecodeScheduler``, phase 4's 8 requests twice: greedy tokens
   equal to phase 4's paged replies under phase 7's rule (exact but for
   top-2 gaps below 1e-3), no kernel launched (K1-K3 0: the dense pool
   runs plain PyTorch attention, as JAX runs no Pallas kernel there),
   the lanes' ``data_ptr`` stable, every slot free at the end; prints
   its tokens/s beside phase 4's paged passes;
21. the frame plane: the three zoo models fetched from ``zoo/`` with
   their hashes verified, their golden logits on the card at 1e-4;
   ``bench_cifar10_scoring``'s shape (ResNet-20 bf16, batch 1024, 10 240
   seeded images, fresh frames, a warm pass then the median of 3):
   images/s, device-only images/s from CUDA events over the forwards,
   the host's stack, bf16 cast and upload times and host->device MB/s,
   1024 rows against the port's CPU ``NNModel`` within 3e-2 (bf16);
   the uint8 wire (rows within 3e-2 of the normalized-float path, and a
   ``ServingServer``'s ``serving_wire_bytes_total{dtype="uint8"}`` equal
   to the frames' bytes); int8 compute quantization on bench.py's
   ``quantized_compute_v1`` MLP (``quant_parity_report`` passes, a x7
   scale fails); the worker entry (``python -m
   mmlspark_tpu_torch.serving worker``) on the card serving a saved
   ``NNModel`` pipeline and a saved ``GBDTRegressor`` (fit on the card,
   K9 = iterations x leaves), rows equal to the direct transform at
   1e-5, ``/stats`` naming the card in ``placement``; each part's
   seconds;
22. frame training: ``bench_distributed_sgd``'s shape (ResNet-20 bf16,
   batch 256, ``make_optimizer("momentum", 0.1)`` and
   ``NNLearner.build_train_step``, a warm step then 20 on one batch, at
   rate 0.01: bench.py's 0.1 diverges on one batch):
   ms a step of wall, CUDA events' ms a step, device ms and launches a
   step (``torch.profiler``), steps/s, MFU from the printed conv and
   dense shapes (3 x the forward's FLOPs against 989 TFLOP/s); the loss
   finite and falling, every parameter's ``data_ptr`` kept;
   ``NNLearner.fit`` on 4096 seeded images, batch 256, 2 epochs, on
   the host loop (f32) and device-resident (uint8, ``flip_crop``):
   examples/s and the loss per epoch, each model scoring on ``cuda:0``;
   3 f32 steps card (TF32 off) against CPU, losses and parameters
   within 1e-4; K1-K9 launch 0 times;
23. features: ``bench_transfer_learning``'s shape (a ResNet-14 bf16
   backbone, 2048 seeded separable images, ``ImageFeaturizer(
   cut_output_layers=1)`` then ``TrainClassifier(GBDTClassifier(20
   iterations, 7 leaves))``; two warm runs, then the median of 2, split
   into featurize and fit): K9 = iterations x outputs x leaves a fit,
   no other kernel; train accuracy at least 0.9; card features within
   3e-2 of the CPU's; an ``ImageTransformer`` chain (resize 64 -> 32 ->
   48, blur, threshold, normalize) within 1e-5 of the CPU's; an
   ``ImageFeaturizer`` with ``input_shape`` resizing on the card;
24. MoE training (slice 17): ``bench_moe_train``'s shape (the train
   bench's width in bf16, 8 experts, top-2, capacity 1.25, aux 0.01,
   z-loss 1e-3, the sort engine, B 8 x S 1024) through
   ``build_spmd_train_step`` on a hosted ``{"data": 1}`` mesh at rate
   0.01, momentum 0.9: 2 warm steps, then 10 on one batch with finite
   losses, the last below the first, params and velocity keeping their
   ``data_ptr``s and exact launch counts around all 12 (K7's three 8
   each a step, K4's training variant and K6's two once; K1-K3, K4's
   verify, K8 and K9 0); ms a step of wall and between CUDA events, a
   ``torch.profiler`` trace of 3 (device busy share, device ops a step),
   tokens/s, MFU from ``bench.py``'s count of the executed expert slots
   against 989 TFLOP/s, each layer's share of routings dropped over
   capacity; then one step each from the same weights of the scatter
   engine (loss and parameters equal to the sort engine's within 1e-5),
   dense dispatch and the expert-choice router (a second step of each
   timed); then f32 (TF32 off) card against CPU at 2 layers, B 2 x S
   256 on the same weights, 3 steps on ``{"data": 1}`` and one on a
   hosted ``{"data": 2, "expert": 2}``: losses (relative) and
   parameters within 1e-4, the smallest top-2 router gap met printed;
25. MoE and int8 decode (slice 17): phase 4's width with 8 experts,
   top-2, f32, on the paged decoder with the prefix cache, phase 4's 8
   requests cold then with prefix hits: K1-K3 per phase 4's formulas,
   greedy tokens equal to the argmax of the port's teacher-forced
   ``reference_logits`` (but where its top-2 gap is below 1e-5), tokens/s
   beside phase 4's and the expert bytes read a step; one speculative
   pass with the 2-layer truncated draft (tokens per phase 7's rule, K4
   once a round); an expert-choice decoder refused; then phase 4's
   model through ``quantized_ffn=True``: tokens equal to the int8
   decoder with ``attn_impl="dense"`` (but where its top-2 gap is below
   1e-3: the activation's bf16 rounding, ``INT8_TIE_GAP``), the card's
   ``_q_matmul`` within 1e-5 of its f32-widened form, the largest
   teacher-forced logit gap between the int8 and f32 trees, the FFN
   weight bytes in f32 and in int8 with scales, tokens/s beside phase
   4's, and ``/decode/stats`` reading ``quantized_ffn: true``; each
   phase's seconds;
26. tensor and pipeline parallelism (slice 18): (a) ``bench_transformer_
   train``'s width and batch (bf16, B 8 x S 1024, rate 0.01, momentum
   0.9) with its 8 layers as 2 pipe stages of 4 in 4 microbatches,
   through ``build_spmd_train_step`` on a hosted ``{"model": 2, "pipe":
   2}``: 2 warm steps then 10 on one batch, finite losses, the last
   below the first, params and velocity keeping their ``data_ptr``s,
   exact launch counts (K7's three once a block a tick, 5 ticks x 4
   blocks: the model and pipe ranks fold into one launch; K4's training
   variant and K6's two once; K1-K3, K4's verify, K8, K9 0); ms a step
   of wall and between CUDA events, a ``torch.profiler`` trace of 3,
   tokens/s and MFU (``bench.py``'s count, 989 TFLOP/s), the bubble's
   block work (ticks / microbatches), beside phase 11's step; then f32
   with TF32 off, card against CPU at 2 layers, B 2 x S 256, 2 steps on
   ``{"model": 2}``, ``{"pipe": 2}`` and the 5-axis ``{"data": 1, "seq":
   2, "model": 2, "expert": 1, "pipe": 2}`` with 2 experts: losses
   (relative) and parameters within 1e-4; (b) tensor-parallel decode of
   phase 4's model and cell on a hosted ``{"data": 1, "model": 2}``,
   cold then with prefix hits: greedy tokens equal to phase 4's under
   phase 7's rule, K1 and K2 a launch a layer (every rank's heads), K3
   one a rank, each rank's pool half of phase 4's, ``/decode/stats``
   placement ``tensor_parallel`` with label ``data=1,model=2``,
   tokens/s beside phase 4's; phase 25's MoE and int8 trees one pass
   each, tokens equal to their single-device decoders' under phase 25's
   rules; a draft with a mesh refused; (c) K7's three at B 8 x S 1024 x
   4 heads in f32 and bf16, K1 at 4 heads of phase 4's pool and K8's
   three at the 5-axis launch (B 8 x S 128 x 4 heads) against their
   plain versions at phases 3's, 9's and 15's limits; each part's
   seconds;
27. the model and pipe axes on the frame plane and the pjit step: (a)
   phase 21's cell with ``tensor_parallel=2`` (a hosted
   ``{"data": 1, "model": 2}``), ``pipeline_parallel=2`` (two stages,
   4 micro-batches, a CUDA stream a stage) and both, beside
   single-device passes before and after them: images/s, the stage
   plan, each stage's service ms, the bubble and each rank's state
   bytes, every mode's scores within phase 21's bf16 limit of the
   single-device card scores; a ``ServingServer`` over the pipelined
   model answers 12 ``/predict`` requests within that limit, with no
   recompile after warmup and its ``/stats`` pipeline block and
   placement; (b) phase 22's cell through ``NNLearner``'s step on a
   hosted ``{"data": 1, "model": 2}`` (steps/s beside phase 22's), then
   3 f32 steps (TF32 off) of ``NNLearner`` on that mesh on the card,
   on the CPU and on ``{"data": 1}``: losses (relative) and parameters
   within 1e-4; no kernel launched in (a) and (b); (c) the bench step
   (bf16, B 8 x S 1024) through ``impl="shard_map"`` and ``"pjit"`` on
   a hosted ``{"data": 2, "model": 2}``, 2 warm steps then 10: ms a
   step, device busy (3 profiled), tokens/s and MFU beside phase 11's,
   the pjit step launching no kernel; pjit against shard_map in f32
   (TF32 off), 2 layers, B 2 x S 256, 3 steps on that mesh and phase
   26's 5-axis MoE mesh: the last loss within 2e-5, parameters within
   2e-4, and on ``{"data": 2, "model": 2}`` pjit with ``ce_impl="cuda"``
   against pjit's plain CE at the same limits; the bench step through
   pjit with ``ce_impl="cuda"`` on ``{"data": 1}`` and ``{"data": 2,
   "model": 2}``: K4's training variant and K6's dh and dW once a step
   over the global batch, every other kernel 0; each part's seconds;
28. checkpoints and the retrain loop: (a) the bench step's
   state (bf16 step, f32 params and velocity, about 470 MB): 3 steps,
   ``save_train_state``, 3 more, ``restore_train_state`` onto the card
   and the same 3 steps from it: every restored leaf equal to the saved
   one, the resumed losses within 1e-6 relative of the uninterrupted
   ones (and whether they are bit-equal), phase 11's launches a step;
   save and restore ms, bytes on disk and GB/s; in f32 (TF32 off), 2
   layers, B 2 x S 256, saved on a hosted ``{"data": 2, "model": 2}``
   and resumed there and on ``{"data": 1}``: the losses within 2e-5;
   (b) phase 22's ResNet-20 cell through ``NNLearner`` (4096 images x 2
   epochs, a checkpoint every 4 steps) with a ``FaultPlan`` step fault
   at step 10 and clean, both under deterministic algorithms: the
   parameters bit-equal, one restart, the trainer's save and restore
   ms; (c) the retrain loop: two ``ServingServer``s of that network
   behind a coordinator, one capturing, background uint8 traffic
   throughout, ``fit_stream`` over the capture on the card,
   ``RetrainLoop`` through the canary rollout: zero bad replies, the
   served scores within 1e-5 (scaled) of the export's, and a crash
   between the sink and the commit replayed and skipped once; no
   kernel launched in (b) and (c);
29. distributed GBDT (slice 21): ``bench_adult_census``'s cell (32768 x
   14, categorical 10 and 11, ``ADULT_ITERS`` iterations, 31 leaves,
   binary) on a hosted ``{"data": 4}`` mesh on the card, once a learner,
   beside the single-device fit: K9 counted exactly around each fit
   (data iterations x leaves; feature iterations x (1 + splits); voting
   iterations x 4 x (1 + 2 x splits)), no other kernel, the plain
   histogram never called; the data and feature learners' trees, leaf
   values and predictions equal the single-device fit's bit for bit in
   every iteration (phase 13's rule), voting
   with ``top_k`` 7 (every feature voted) within
   ``tests/test_gbdt.py``'s near-equality (fewer than 5% of rows off by
   more than 0.05), voting with ``top_k`` 2 within 0.02 of the
   single-device train AUC; each fit's seconds and a 2-iteration fit's
   device-busy share;
30. the load drivers (slice 21): ``run_static`` then ``run_continuous``
   over phase 4's decoder on ``make_workload(n_requests=48, seed=0,
   mean_gap_ms=3.0, max_new=(4, 12, 40))``: every token, 0 recompiles,
   the pool in place, ``live_array_growth`` 0, K1 once a layer a step
   and K2 once a layer a prefill; ``run_scheduler_sessions`` on a paged
   scheduler over that decoder and on phase 7's speculative one, half
   the requests on shared prefixes: 0 errors, slots, pool and page
   ledger clean, K1-K4 per phases 4 and 7's formulas; ``drive_keepalive``
   at 8 and 64 connections for 2 s each against a ``ServingServer`` of
   ``bench.py``'s trivial model on both socket edges (0 errors, 0
   recompiles after warmup), then 8 connections x 4 ``POST /generate``
   over phase 4's decoder (0 errors, every slot free after); tokens/s
   and req/s printed;
31. the long tail: (a) SAR at MovieLens 1M's shape (6040
   users, 3706 movies, 1,000,209 ratings synthesized from the seed,
   Zipf popularity) through string ids, ``RecommendationIndexer``,
   ``SAR`` on the card (jaccard, a 30-day half-life, support 4) and
   ``recommend_for_all_users(10)``, against the port's CPU ``SAR``: the
   similarity within 1e-6 relative, the scores within 1e-5, every top-10
   equal but at ties (two scores within 1e-5 relative, counted); then
   ``per_user_split(0.75)``, ``RankingAdapter`` and ``RankingEvaluator``
   (ndcg@10, map@10); (b) ``TabularLIME`` over a ``GBDTClassifier`` (20
   x 31) fitted on the card on ``bench_adult_census``'s frame, 64 rows at
   512 samples, 8 rows a model call, and ``ImageLIME`` over ResNet-20 in
   f32 on 16 CIFAR-shape images at 512 samples, each against the same
   stages on the CPU (coefficients within 1e-4 x max(1, |ref|); SLIC
   labels equal) and the card's batched solve against the CPU's within
   1e-4; seconds a row parted into model calls, solves and host work;
   (c) ``TuneHyperparameters`` over
   ``TrainClassifier(GBDTClassifier)`` on the adult frame, grid
   ``num_leaves`` {15, 31} x ``num_iterations`` {10, 20}, 2 folds, AUC,
   2 trial threads on the card: K9 exactly the sum of iterations x
   leaves over the 9 fits (the ``tune`` path), the history equal to the
   one at 1 thread (run before it, after a warm fit),
   ``best_params`` the CPU's and each trial's AUC
   within 1e-3 of it; ``FindBestModel`` over the four refitted
   candidates and the evaluators on the winner's scores; (d) the adult
   frame with 5% of its values blanked and two columns as strings
   through ``CleanMissingData``, two ``ValueIndexer``s,
   ``DataConversion``, ``ClassBalancer`` and ``SummarizeData``, equal
   to a second run;
32. the I/O tail: (a) ``examples/opencv_image_pipeline.py``'s path at
   1024 PNGs of its two classes (sides 48-96, half of them in a zip,
   written by the port's ``encode_image``): ``read_binary_files`` with
   the host C++ reader (``engine="native"``) equal to the Python read,
   paths and bytes, and ``read_images`` (``auto``, the C++ reader) equal
   to those bytes decoded; the example's
   ``ImageTransformer`` chain (resize 40, center crop 32, Gaussian 3 /
   1.0, flip, normalize) on the card within 1e-5 of the CPU's;
   ``UnrollImage`` and ``TrainClassifier(GBDTClassifier(20 iterations,
   7 leaves, min_data_in_leaf 3))`` on the card: K9 exactly iterations x
   leaves (the ``io tail`` path), the first 2 trees a CPU fit's bit for
   bit, train accuracy above 0.9; ``UnrollBinaryImage(32,
   32)`` over the bytes column on the card within 1e-5 of the CPU's; the C++ reader's
   build, the read seconds of both engines, the decode and the device
   seconds printed; (b)
   ``zoo/cifar10s_resnet20`` behind ``ServingServer`` on the card (the
   uint8 wire), 512 seeded uint8 images through
   ``SimpleHTTPTransformer(JSONInputParser -> /predict,
   JSONOutputParser("scores"))`` at concurrency 8 (and 128 at 1), and
   once more through ``HTTPTransformer(handler="policy", budget=...)``:
   the scores (f32) within 1e-4 of ``NNModel.transform`` on the card; a
   frame of 8 rows of which 2 name no ``image`` sent at concurrency 1 to
   the card's server and to one on the CPU: those rows in the error
   column with status 500 and their reason, None in the output, equal on
   both, the other rows' scores within 1e-4; rows/s printed;
   (c) ``TextSentiment``, ``DetectAnomalies``, ``PowerBIWriter`` and
   ``AzureSearchWriter`` against a localhost stub: the requests it
   receives and the shaped outputs as ``tests/test_torch_services.py``
   asserts;
33. the examples and the tools: (a) each of the fifteen
   ``mmlspark_tpu_torch.examples`` as ``python -m ... --json`` in its
   own process on the card at the JAX script's sizes, three at a time:
   exit 0 (the JAX
   script's asserts), its result lines and wall seconds printed, K9
   launched in every GBDT example's process, K4's training variant and
   K6's dh and dW exactly once a step (400) in ``sequence_tagging``'s,
   and no kernel wrapper's plain version called on a CUDA tensor;
   (b) ``tools.trace_dump``'s read-only modes against a port worker
   process serving a GBDT on the card; (c) ``tools.gen_docs`` and
   ``tools.train_zoo_models digits`` (on the card, over JAX's 0.95
   gate) into temp directories, the published model fetched back and
   held to its CPU golden within 1e-4; (d) ``multiclass_image_transfer``
   once more in this process on the card, its GBDT fitted on the CPU
   too from the card's embeddings: the unseen-class gate (> 0.75) and
   the card's trees, leaf values and predictions against the CPU's, bit
   for bit through all 15 iterations (``same_trees``); (e)
   ``tools.chaos_streaming`` at
   its defaults, three
   workers on the card; (f) ``tools.chaos_serving``'s kill/restart,
   keep-alive, rollout and prefix-cache drills at its default counts,
   the decode worker on the card: every reply right, zero wrong tokens,
   a clean page ledger, and K1-K3 launched in the decode worker. The
   examples' processes, (d) and (e) run beside (b), (c) and (f). The four
   drills that pass on latency windows (tenancy, SLO, regression,
   postmortem) are not run here (PERF.md says why);
34. the model, expert and pipe axes over processes, two processes on
   the one card meeting over gloo (``testing.process_world``; the
   card's compute mode must not be ``EXCLUSIVE_PROCESS``), beside phase
   33: (a) greedy decode of three prompts (a prefix hit each after the
   first) on the main path's model, tensor-parallel over ``{"data": 1,
   "model": 2}`` one rank per process: its tokens equal to the hosted
   tensor-parallel decoder's and the single-device decoder's in this
   process, K1-K3 launched in each process on its half of the heads;
   (b) ``tools.launch_multiprocess --smoke`` on the card: two processes
   of four hosted ranks each, psum, the ``{"data": 8}`` fit within 1e-6
   of the single-process fit, the pjit step on ``{"pipe": 2, "data":
   4}`` with the pipe axis as the process boundary within 1e-6 of the
   hosted run, the mixed checkpoint restored bit for bit;
   (c) ``NNModel(tensor_parallel=2)`` scoring phase 27's bf16 ResNet-20
   one rank per process, within ``FRAME_BF16_TOL`` of the same
   process's single-device scores. No kernel wrapper's plain version
   runs on a CUDA tensor in either process. Two processes on one card
   show correctness, not the speed of one rank per card;
35. print decode tokens/s, TTFT, acceptance, the decode metrics', the
   train metrics', the GBDT metrics', the ring train metrics', the
   frame plane's, frame training's, the features', MoE training's, MoE
   and int8 decode's, tensor and pipeline parallelism's, the model
   axes', the checkpoints', distributed GBDT's, the load drivers', the
   long tail's, the I/O tail's, the examples' and tools', the axes over
   processes' and the kernels' JSON lines and, last, ``{"ok": true,
   "device": {...}}``.

Any failed check raises: a nonzero exit and no ``ok`` line. Without
CUDA it exits nonzero before printing any result.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import http.client
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: no CUDA device; this script runs on the "
                     "card only")

from mmlspark_tpu_torch.core import profiler as PPF  # noqa: E402
from mmlspark_tpu_torch.core import profiling as PPG  # noqa: E402
from mmlspark_tpu_torch.core import telemetry as PTM  # noqa: E402
from mmlspark_tpu_torch.core import tracing as PTR  # noqa: E402
from mmlspark_tpu_torch.core import tsdb as PTS  # noqa: E402
from mmlspark_tpu_torch.core.dataframe import (  # noqa: E402
    DataFrame, obj_col,
)
from mmlspark_tpu_torch.core.stage import (  # noqa: E402
    PipelineStage, Transformer,
)
from mmlspark_tpu_torch.explain import ImageLIME, TabularLIME  # noqa: E402
from mmlspark_tpu_torch.explain import lime as LIME  # noqa: E402
from mmlspark_tpu_torch.native import cuda_build  # noqa: E402
from mmlspark_tpu_torch.native import native_available  # noqa: E402
from mmlspark_tpu_torch.native import launch as NL  # noqa: E402
from mmlspark_tpu_torch.gbdt import Booster, BoosterParams  # noqa: E402
from mmlspark_tpu_torch.gbdt import cuda_hist as CH  # noqa: E402
from mmlspark_tpu_torch.gbdt import tree as GT  # noqa: E402
from mmlspark_tpu_torch.automl import (  # noqa: E402
    ComputeModelStatistics, ComputePerInstanceStatistics, DiscreteHyperParam,
    FindBestModel, TrainClassifier, TuneHyperparameters,
)
from mmlspark_tpu_torch.automl import tune as PTUNE  # noqa: E402
from mmlspark_tpu_torch.gbdt.stages import (  # noqa: E402
    GBDTClassifier, GBDTRegressor,
)
from mmlspark_tpu_torch.io.binary import read_binary_files  # noqa: E402
from mmlspark_tpu_torch.io.http import (  # noqa: E402
    HTTPTransformer, JSONInputParser, JSONOutputParser, SimpleHTTPTransformer,
)
from mmlspark_tpu_torch.io.images import (  # noqa: E402
    decode_image, encode_image, read_images,
)
from mmlspark_tpu_torch.io.services import (  # noqa: E402
    AzureSearchWriter, DetectAnomalies, PowerBIWriter, TextSentiment,
)
from mmlspark_tpu_torch.models import nn as NN  # noqa: E402
from mmlspark_tpu_torch.models import transformer as T  # noqa: E402
from mmlspark_tpu_torch.models.featurizer import (  # noqa: E402
    ImageFeaturizer,
)
from mmlspark_tpu_torch.models.function import (  # noqa: E402
    NNFunction, ieee_f32,
)
from mmlspark_tpu_torch.models.nn import NNModel  # noqa: E402
from mmlspark_tpu_torch.models.trainer import (  # noqa: E402
    NNLearner, make_loss, make_optimizer, _metrics as trainer_metrics,
)
from mmlspark_tpu_torch.models.zoo import (  # noqa: E402
    ModelDownloader, _dir_sha256 as ZOO_DIR_SHA,
)
from mmlspark_tpu_torch.ops import fused_ce as FC  # noqa: E402
from mmlspark_tpu_torch.parallel import cuda_attention as CA  # noqa: E402
from mmlspark_tpu_torch.parallel import dist as PDIST  # noqa: E402
from mmlspark_tpu_torch.parallel import ring_attention as RA  # noqa: E402
from mmlspark_tpu_torch.parallel.sharding import bucket_target  # noqa: E402
from mmlspark_tpu_torch.parallel.topology import (  # noqa: E402
    MeshSpec, build_mesh,
)
from mmlspark_tpu_torch.serving.decode import (  # noqa: E402
    _MAX_TIMELINE_SPANS, DecodeScheduler, TransformerDecoder,
)
from mmlspark_tpu_torch.serving.server import ServingServer  # noqa: E402
from mmlspark_tpu_torch.recommend import (  # noqa: E402
    RankingAdapter, RankingEvaluator, RecommendationIndexer, SAR,
    per_user_split,
)
from mmlspark_tpu_torch.recommend import sar as SARM  # noqa: E402
from mmlspark_tpu_torch.stages import (  # noqa: E402
    ClassBalancer, CleanMissingData, DataConversion, ImageTransformer,
    SummarizeData, UnrollBinaryImage, UnrollImage, ValueIndexer,
)
from mmlspark_tpu_torch.testing.decode_load import (  # noqa: E402
    make_spec_model_pair, make_workload, run_continuous,
    run_scheduler_sessions, run_static,
)
from mmlspark_tpu_torch.testing.load import drive_keepalive  # noqa: E402
from mmlspark_tpu_torch.examples import (  # noqa: E402
    EXAMPLES, GBDT_EXAMPLES,
)
from mmlspark_tpu_torch.examples import (  # noqa: E402
    multiclass_image_transfer as MULTICLASS,
)
from mmlspark_tpu_torch.testing import process_world as PWORLD  # noqa: E402
from mmlspark_tpu_torch.tools import chaos_serving as CHAOS  # noqa: E402
from mmlspark_tpu_torch.tools import chaos_streaming as CHAOS_ST  # noqa: E402
from mmlspark_tpu_torch.tools import gen_docs as GEN_DOCS  # noqa: E402
from mmlspark_tpu_torch.tools import (  # noqa: E402
    launch_multiprocess as LAUNCH_MP,
)
from mmlspark_tpu_torch.tools import trace_dump as TRACE_DUMP  # noqa: E402
from mmlspark_tpu_torch.tools import (  # noqa: E402
    train_zoo_models as ZOO_TRAIN,
)

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# bench.py's transformer LM width (the SPMD train bench), decoded in f32
CFG = T.TransformerConfig(vocab=32768, d_model=512, n_heads=8, d_head=64,
                          d_ff=2048, n_stages=1, layers_per_stage=8)
N_SLOTS, MAX_LEN, PAGE = 8, 1024, 16
PPS = MAX_LEN // PAGE
PREAMBLE, MAX_NEW = 256, 48
SPEC_K, DRAFT_LAYERS = 4, 2
# make_spec_model_pair's residual scale. Its default, 0.05, leaves a
# 2-of-8-layer draft at this width agreeing with the target on 2.4% of
# greedy tokens (teacher-forced over pass 1's prompts, H100 run of
# draft_agreement); 0.002 gives 83%, the trained-pair regime the pair
# stands for. Both rates are printed on every run.
RESID_SCALE = 0.002
TIE_GAP = 1e-5         # greedy divergence allowed only below this top-2 gap
KERNEL_TOL = 1e-4      # f32 kernel vs plain: reassociation only
ENGINE_TOL = 1e-3      # whole-model logits, cuda vs dense engine
# H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the tensor cores,
# dense (no sparsity) bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
# The train kernels' scaled error: max over elements of |kernel - plain| /
# (|plain| + RMS(plain)), the RMS at least RMS_FLOOR (dq and dk are zero in
# exact arithmetic at S = 1: rounding noise on both sides). Each element is
# held to its own magnitude plus the output's typical one, so an error as
# large as a typical value reads as about 1 whatever the output's scale.
RMS_FLOOR = 1e-3
# f32: reassociation only. About 4x the largest H100 reading, 5.0e-4:
# dq's rounding noise at S = 1 (5e-7) over the RMS floor; every other
# f32 reading is under 3e-5.
F32_SCALED_TOL = 2e-3
# bf16, per kernel: the kernels round p relative to a running max (over
# K7's and K8's 64-key tiles on the tensor cores; the limits were set
# when K7 ran 32-key tiles) where the plain versions round it
# relative to the row's max, and sum in another order before each bf16
# rounding (logits, d_l, ds, the grads), so an output rounded to bf16 may
# land an ulp or two (2^-7 relative each) away. Each limit is about 4x
# the largest scaled error of the H100 runs (PERF.md, section 2): forward
# 1.35e-2 (S = 4096), dq 4.7e-3, dk/dv 6.7e-3, K4's training variant
# 4.1e-3, dh 6.3e-3, dW 6.7e-3. A zero or wrong output reads near 1.
BF16_LIMITS = {"attention_fwd": 0.05, "attention_bwd_dq": 0.02,
               "attention_bwd_dkdv": 0.025, "fused_softmax_xent_train": 0.015,
               "fused_ce_dh": 0.025, "fused_ce_dw": 0.025}
# Where S fits one 32-key tile, the kernels' running max is the row's
# max, so kernel and plain version round p and ds at the same values and
# differ only in sum order: the attention kernels are held to this there,
# in both dtypes (H100: at most 1.5e-4, dq's noise at S = 1 over the RMS
# floor). Leaving out one bf16 rounding (of p before p.v or p^T.do, or
# of ds) reads above it at S = 17 (tests/test_torch_attention_train.py
# holds the plain version so).
ATTN_KEY_TILE = 32
ONE_TILE_TOL = 1e-3

# the train slice: bench.py's transformer train bench (bench_transformer_
# train: bf16 mixed precision, b8 x s1024, momentum SGD at lr 0.01)
TRAIN_CFG = dataclasses.replace(CFG, dtype="bfloat16")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 20
TRAIN_LR, TRAIN_MOMENTUM = 0.01, 0.9
ATTN_SHAPES = [(1, 1), (1, 17), (2, 128), (1, 384), (8, 1024), (2, 4096)]
CE_SHAPES = [(t, v) for t in (7, 512, 8192) for v in (CFG.vocab, 32000)]
#: per train step (8 layers): kernel -> launches (0: kernels of other paths)
TRAIN_LAUNCHES = {"attention_fwd": CFG.n_layers,
                  "attention_bwd_dq": CFG.n_layers,
                  "attention_bwd_dkdv": CFG.n_layers,
                  "fused_softmax_xent_train": 1, "fused_ce_dh": 1,
                  "fused_ce_dw": 1, "fused_softmax_xent": 0,
                  "gbdt_histogram": 0, "ring_block_fwd": 0,
                  "ring_block_bwd_dq": 0, "ring_block_bwd_dkdv": 0}

DEV = torch.device("cuda")

#: the PyTorch call timed as each kernel's ``library_ms`` (never used by
#: the port)
LIBRARY_CALL = {
    "flash_prefill_attention": "scaled_dot_product_attention(is_causal)",
    "fused_softmax_xent": "h @ w, then cross_entropy(reduction='none') "
                          "(two calls)",
    "attention_fwd": "scaled_dot_product_attention(is_causal), bf16",
    "attention_bwd_dq": "the backward of scaled_dot_product_attention("
                        "is_causal) alone (dq, dk and dv together)",
    "attention_bwd_dkdv": "the backward of scaled_dot_product_attention("
                          "is_causal) alone (dq, dk and dv together)",
    "fused_softmax_xent_train": "h @ w, then cross_entropy(reduction="
                                "'none') (two calls), bf16",
    "fused_ce_dh": "autograd backward of h @ w -> cross_entropy (several "
                   "calls: the softmax grad, dh and dW together)",
    "fused_ce_dw": "autograd backward of h @ w -> cross_entropy (several "
                   "calls: the softmax grad, dh and dW together)",
    "fused_softmax_xent_train_f32": "h @ w, then cross_entropy(reduction="
                                    "'none') (two calls), f32, TF32 off",
    "fused_ce_dh_f32": "autograd backward of h @ w -> cross_entropy, f32, "
                       "TF32 off (dh and dW together)",
    "fused_ce_dw_f32": "autograd backward of h @ w -> cross_entropy, f32, "
                       "TF32 off (dh and dW together)",
    "attention_fwd_f32": "scaled_dot_product_attention(is_causal), f32",
    "attention_bwd_dq_f32": "the backward of scaled_dot_product_attention("
                            "is_causal), f32, alone (dq, dk and dv together)",
    "attention_bwd_dkdv_f32": "the backward of scaled_dot_product_attention("
                              "is_causal), f32, alone (dq, dk and dv "
                              "together)"}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def reset_launch_counts() -> None:
    CA.reset_launch_counts()
    FC.reset_launch_counts()
    CH.reset_launch_counts()


def read_launch_counts() -> dict:
    return {**CA.LAUNCHES, **FC.LAUNCHES, **CH.LAUNCHES}


# ---------------------------------------------------------------------------
# phase 2: what the compiler made of the bf16 tensor-core kernels

#: the bf16 kernels on the tensor cores, as named in csrc: K7's (attention
#: forward, dq, dk/dv), the fused CE's (K4's forward, K6's dh and dW) and
#: K8's (the ring block's forward, dq, dk/dv)
K7_WGMMA = ("attn_fwd_wgmma", "attn_dq_wgmma", "attn_dkdv_wgmma")
CE_WGMMA = ("ce_fwd_wgmma", "ce_dh_wgmma", "ce_dw_wgmma")
K8_WGMMA = ("ring_fwd_wgmma", "ring_dq_wgmma", "ring_dkdv_wgmma")
#: the bf16 tensor-core kernels together
WGMMA_KERNELS = K7_WGMMA + CE_WGMMA + K8_WGMMA
#: mangled template arguments -> instance labels (K7's and K8's 3xTF32
#: kernels before the CE's <store> / <no store>, which share their start)
_TEMPLATE_ARGS = {**{f"ILb{r}ELi{d}EE": f"<{k}, Dh {d}>"
                     for r, k in ((0, "K7"), (1, "K8")) for d in (32, 64)},
                  "IfE": "<out f32>", "I13__nv_bfloat16E": "<out bf16>",
                  "ILb1E": "<store>", "ILb0E": "<no store>",
                  "ILi32ELi2EE": "<Dh 32, 32 rows>",
                  "ILi32ELi4EE": "<Dh 32, 16 rows>",
                  "ILi64ELi2EE": "<Dh 64, 32 rows>",
                  "ILi64ELi4EE": "<Dh 64, 16 rows>",
                  "ILi32E": "<Dh 32>", "ILi64E": "<Dh 64>",
                  "IhE": "<uint8>", "IiE": "<int32>",
                  **{f"ILi{n}E": f"<NT {n}>" for n in range(1, 9)}}
#: the instances the build must hold: K7's forward for both output types,
#: dq, dk/dv; K4's forward with and without the logits store, dh, dW;
#: K8's forward, dq, dk/dv
WGMMA_INSTANCES = 11
#: K7's and the CE's registers as recorded in PERF.md (ptxas 12.9)
KNOWN_REGISTERS = {
    "attn_fwd_wgmma<out f32>": 92, "attn_fwd_wgmma<out bf16>": 92,
    "attn_dq_wgmma": 128, "attn_dkdv_wgmma": 168,
    "ce_fwd_wgmma<store>": 127, "ce_fwd_wgmma<no store>": 127,
    "ce_dh_wgmma": 198, "ce_dw_wgmma": 208}
#: the 3xTF32 kernels (mma.sync), as named in csrc, and their instances:
#: K2's (head dims padded to 32 and 64), K3's (the same, each with query
#: tiles of 16 and 32 rows), K4's f32 forward (the few-token kernel for 1
#: to 8 n8 token tiles, the many-token one with and without the logits
#: store), K6's f32 dh and dW, and the f32 training attention's forward,
#: dq and dk/dv (csrc/attention_tf32.cuh), each with K7's and K8's mask at
#: head dims padded to 32 and 64; K9's instances (uint8 and int32 bins,
#: and the merge); the f32 kernels on the CUDA cores (K1's split kernel
#: and the split merge it shares with K3, and K4's merge), whose registers
#: are printed so a reader can see them unchanged
TF32_KERNELS = {"flash_prefill_tf32": 2, "paged_prefix_tf32": 4,
                "ce_fwd_stream_tf32": 8, "ce_fwd_tf32": 2, "ce_dh_tf32": 1,
                "ce_dw_tf32": 1, "attn_fwd_tf32": 4, "attn_dq_tf32": 4,
                "attn_dkdv_tf32": 4}
K9_KERNELS = ("hist_kernel", "hist_merge_kernel")
F32_KERNELS = ("paged_decode_split", "paged_merge_kernel", "ce_merge_kernel")


def _kernel_label(mangled: str, names):
    """``attn_fwd_wgmma<out bf16>``, ``flash_prefill_tf32<Dh 64>`` etc.
    for an instance of a kernel in ``names`` (other template arguments
    as mangled), None for any other kernel."""
    for name in names:
        tag = f"{len(name)}{name}"
        at = mangled.find(tag)
        if at >= 0:
            rest = mangled[at + len(tag):]
            arg = next((lbl for a, lbl in _TEMPLATE_ARGS.items()
                        if rest.startswith(a)), None)
            if arg is None and rest.startswith("I"):
                arg = f"<{rest[1:rest.find('E')]}>"
            return name + (arg or "")
    return None


def build_log_facts(lib, names) -> dict:
    """ptxas's registers and spill bytes for every instance of the
    kernels in ``names`` (from the build log), and any "wgmma ...
    serialized" warning ptxas gave one."""
    facts, label = {}, None
    for line in (lib.parent / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            label = _kernel_label(m.group(1), names)
            if label:
                while label in facts:  # another instance, args cut short
                    label += "'"
                facts[label] = {}
            continue
        if "serialized" in line:
            lbl = _kernel_label(line, names)
            if lbl in facts:
                facts[lbl]["serialized"] = line.strip()
        if label is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            facts[label]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            facts[label]["registers"] = int(m.group(1))
    return facts


def sass_counts(lib, names, opcode: str):
    """``opcode``'s count in the SASS (``cuobjdump -sass``) of every
    instance of the kernels in ``names``, or None where the toolkit has
    no ``cuobjdump``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cuobjdump = (shutil.which("cuobjdump", path=os.path.join(home, "bin"))
                 or shutil.which("cuobjdump"))
    if cuobjdump is None:
        print(f"cuobjdump: not in this toolkit; the {opcode} check is "
              f"skipped")
        return None
    sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        lbl = _kernel_label(body.split("\n", 1)[0], names)
        if lbl:
            counts[lbl] = body.count(opcode)
    return counts


def wgmma_build_facts(lib) -> dict:
    """Registers, spill bytes and any serialization warning of every bf16
    tensor-core instance, and the HGMMA (wgmma) instructions in each.
    Fails on a missing instance, a spill, or an instance without
    HGMMA."""
    facts = build_log_facts(lib, WGMMA_KERNELS)
    check(len(facts) == WGMMA_INSTANCES, f"bf16 tensor-core instances in "
                                         f"the build log: {sorted(facts)}")
    hgmma = sass_counts(lib, WGMMA_KERNELS, "HGMMA")
    for lbl, n in (hgmma or {}).items():
        facts[lbl]["hgmma"] = n
    print("K7's and the CE's registers against their recorded counts: "
          + ", ".join(f"{lbl} {facts[lbl].get('registers')} (recorded {n})"
                      for lbl, n in KNOWN_REGISTERS.items() if lbl in facts))
    for lbl, f in sorted(facts.items()):
        print(f"bf16 {lbl}: {f.get('registers')} registers, "
              f"{f.get('spill_bytes')} spill bytes"
              + (f", {f['hgmma']} HGMMA" if "hgmma" in f else "")
              + (f"; {f['serialized']}" if "serialized" in f else ""))
        check(f.get("spill_bytes") == 0, f"{lbl} spills: {f}")
        check(hgmma is None or f.get("hgmma", 0) > 0,
              f"{lbl} has no HGMMA instruction: {f}")
    return facts


def cuda_core_build_facts(lib) -> dict:
    """Registers and spill bytes of the 3xTF32 instances (K2's, K3's,
    the f32 CE's and the f32 training attention's), K9's and the f32
    CUDA-core kernels, and the HMMA (tensor-core
    mma.sync) instructions in the 3xTF32 ones. Fails on a missing 3xTF32
    instance, a spill in one, or one without HMMA."""
    facts = build_log_facts(lib, (*TF32_KERNELS, *K9_KERNELS, *F32_KERNELS))
    tf32 = sorted(lbl for lbl in facts if lbl.startswith(tuple(TF32_KERNELS)))
    for name, n in TF32_KERNELS.items():
        got = [lbl for lbl in tf32 if lbl.startswith(name)]
        check(len(got) == n, f"{name} instances in the build log: {got}")
    hmma = sass_counts(lib, tuple(TF32_KERNELS), "HMMA")
    for lbl, n in (hmma or {}).items():
        facts[lbl]["hmma"] = n
    for lbl in sorted(facts):
        f = facts[lbl]
        kind = ("3xTF32" if lbl in tf32 else
                "K9" if lbl.startswith(K9_KERNELS) else "f32 CUDA cores")
        print(f"{kind} {lbl}: {f.get('registers')} registers, "
              f"{f.get('spill_bytes')} spill bytes"
              + (f", {f['hmma']} HMMA" if "hmma" in f else ""))
    for lbl in tf32:
        check(facts[lbl].get("spill_bytes") == 0, f"{lbl} spills: "
                                                  f"{facts[lbl]}")
        check(hmma is None or facts[lbl].get("hmma", 0) > 0,
              f"{lbl} has no HMMA instruction: {facts[lbl]}")
    return facts


# ---------------------------------------------------------------------------
# timing


_FLUSH = None


def flush_l2() -> None:
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    _FLUSH.zero_()


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each started
    with a cold L2 (CUDA events around the launch only)."""
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        flush_l2()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def kernel_parts(fn, names, n: int = 10) -> dict:
    """Device ms per call of each kernel of ``fn`` whose name holds one of
    ``names`` (``torch.profiler``; a cold L2 before each call, as
    ``time_ms`` has it): where a wrapper call that launches several kernels
    spends its device time. What ``time_ms`` reads beyond their sum is the
    launches' and the kernels' boundaries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush_l2()
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        hit = next((k for k in names if k in e.key), None)
        if hit and e.device_type == DeviceType.CUDA:
            parts[hit] = parts.get(hit, 0.0) + e.device_time_total / 1e3 / n
    return parts


def bound(bytes_moved: float, flops: float, peak: float = PEAK_F32_FLOPS):
    """The least time for the work: bytes at the HBM rate or operations
    at ``peak`` (the inputs' type: f32 CUDA cores or bf16 tensor
    cores), whichever is larger."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def rnd(gen, *shape):
    return torch.randn(*shape, generator=gen).to(DEV)


def max_err(kernel, plain) -> float:
    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    check(torch.isfinite(out).all().item(), "kernel output not finite")
    return float((out - ref).abs().max().item())


def k1_case(gen, pos, free=(), h=CFG.n_heads):
    """K1 over a batch of len(pos) slots of ``h`` heads; slots in ``free``
    ride at pos 0 on an all-scratch table, as the decoder's free slots
    do. The library call gathers each lane through its table (K and V),
    then runs ``scaled_dot_product_attention`` under the position mask
    (built outside the timed call)."""
    d = CFG.d_head
    n = len(pos)
    n_pages = 1 + n * PPS
    kp, vp = rnd(gen, n_pages, PAGE, h, d), rnd(gen, n_pages, PAGE, h, d)
    q = rnd(gen, n, h, d)
    tables = (1 + torch.randperm(n * PPS, generator=gen)).reshape(n, PPS)
    pos = list(pos)
    for i in free:
        tables[i], pos[i] = 0, 0
    tables = tables.to(torch.int32).to(DEV)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
    args = (q, kp, vp, tables, pos_t, d ** -0.5, PAGE)
    kern = lambda: CA.paged_decode_attention(*args)  # noqa: E731
    plain = lambda: CA.paged_decode_attention_plain(*args)  # noqa: E731
    lane = PPS * PAGE
    mask = (torch.arange(lane, device=DEV)[None, :]
            <= pos_t[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def lib():
        lk = lane_gather(kp, tables, n, lane, h)
        lv = lane_gather(vp, tables, n, lane, h)
        return torch.nn.functional.scaled_dot_product_attention(
            q4, lk, lv, attn_mask=mask, scale=d ** -0.5)

    rows = sum(min(p, lane - 1) + 1 for p in pos)
    nbytes = 4 * (2 * n * h * d + 2 * rows * h * d) + 4 * n * (PPS + 1)
    flops = 4 * rows * h * d
    return kern, plain, lib, nbytes, flops


def lane_gather(pool, tables, n, lane, h=CFG.n_heads):
    """Each row of ``tables``' lane gathered from the pool, as SDPA's
    (N, H, lane, Dh) (a view of the gather)."""
    return pool[tables].reshape(n, lane, h, CFG.d_head).transpose(1, 2)


def k2_case(gen, s, h=CFG.n_heads, b=1):
    """K2 over a batch of ``b`` prompts of ``s`` rows and ``h`` heads; the
    library call is SDPA's causal one."""
    d = CFG.d_head
    q, k, v = (rnd(gen, b, s, h, d) for _ in range(3))
    kern = lambda: CA.flash_prefill_attention(q, k, v)  # noqa: E731
    plain = lambda: CA.flash_prefill_attention_plain(q, k, v)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        qt, kt, vt, is_causal=True)
    return kern, plain, lib, 4 * 4 * b * s * h * d, b * k2_flops(s, h)


def k2_flops(s: int, h: int = CFG.n_heads) -> int:
    """Causal attention's FLOPs at B 1, S s, ``h`` heads of the bench
    width."""
    return 4 * h * CFG.d_head * s * (s + 1) // 2


def k3_case(gen, hit, s, h=CFG.n_heads, off=0):
    """K3 at one hit depth and suffix over ``h`` heads; the slot's table
    lies ``off`` pages into the pool (a model rank's pages in the
    tensor-parallel pool); the library call as K1's, over the slot's one
    lane."""
    d = CFG.d_head
    n_pages = off + 1 + PPS
    kp, vp = rnd(gen, n_pages, PAGE, h, d), rnd(gen, n_pages, PAGE, h, d)
    q = rnd(gen, s, h, d)
    table = (off + 1 + torch.randperm(PPS, generator=gen)).to(
        torch.int32).to(DEV)
    args = (q, kp, vp, table, hit, d ** -0.5, PAGE)
    kern = lambda: CA.paged_prefix_prefill_attention(*args)  # noqa: E731
    plain = lambda: CA.paged_prefix_prefill_attention_plain(*args)  # noqa
    lane = PPS * PAGE
    mask = (torch.arange(lane, device=DEV)[None, :]
            <= hit + torch.arange(s, device=DEV)[:, None])[None, None]
    q4 = q.transpose(0, 1)[None]

    def lib():
        lk = lane_gather(kp, table[None], 1, lane, h)
        lv = lane_gather(vp, table[None], 1, lane, h)
        return torch.nn.functional.scaled_dot_product_attention(
            q4, lk, lv, attn_mask=mask, scale=d ** -0.5)

    keys = min(lane, hit + s)
    seen = sum(min(lane, hit + r + 1) for r in range(s))
    nbytes = 4 * (2 * s * h * d + 2 * keys * h * d) + 4 * PPS
    flops = 4 * seen * h * d
    return kern, plain, lib, nbytes, flops


def k4_case(gen, t, v, miss_label: bool):
    """K4 at the verify's D: ``h`` at unit scale (RMS-normed hidden
    states), ``w`` at the head's init scale; with ``miss_label`` the
    first label is -1 and the last V (no column matches: gold 0)."""
    d = CFG.d_model
    h = rnd(gen, t, d)
    w = 0.02 * rnd(gen, d, v)
    labels = torch.randint(0, v, (t,), generator=gen, dtype=torch.int32)
    if miss_label:
        labels[0], labels[-1] = -1, v
    labels = labels.to(DEV)
    kern = lambda: FC.fused_softmax_xent(h, w, labels)  # noqa: E731
    plain = lambda: FC.fused_softmax_xent_plain(h, w, labels)  # noqa: E731
    lbl64 = labels.long()
    lib = lambda: torch.nn.functional.cross_entropy(  # noqa: E731
        h @ w, lbl64, reduction="none")
    nbytes = 4 * (t * d + d * v + 2 * t)
    flops = 2 * t * d * v
    return kern, plain, lib, nbytes, flops


def kernel_phase(plan) -> dict:
    """Correctness at many shapes, timing at the main paths' shapes
    (``plan``: K1 positions, K2 prompt bucket, K3 hit depth + suffix
    bucket, K4 tokens per verify). Returns per-kernel records for the
    JSON line."""
    gen = torch.Generator().manual_seed(SEED)
    worst = {}
    # K1: page edges, the lane's ends, the path's positions, every split
    # boundary of its plan (a split's first row and the row before it), 8
    # at a time, and a batch whose even slots are free
    per, n_splits = CA.paged_decode_plan(N_SLOTS, PPS)
    edges = sorted({0, PPS * PAGE - 1}
                   | {j * per * PAGE + k for j in range(1, n_splits)
                      for k in (-1, 0)})
    batches = [[0, 1, 15, 16, 300, 511, 1000, 1023], plan["k1_pos"]]
    batches += [(edges[i:i + N_SLOTS] + [0] * N_SLOTS)[:N_SLOTS]
                for i in range(0, len(edges), N_SLOTS)]
    for pos in batches:
        e = max_err(*k1_case(gen, pos)[:2])
        worst["k1"] = max(worst.get("k1", 0.0), e)
        print(f"K1 pos={pos} max_abs_err={e:.3e}")
    e = max_err(*k1_case(gen, plan["k1_pos"], free=range(0, N_SLOTS, 2))[:2])
    worst["k1"] = max(worst["k1"], e)
    print(f"K1 plan: {per} page(s) a split, {n_splits} splits a slot; "
          f"{len(edges)} boundary positions checked; free slots 0, 2, 4, 6 "
          f"beside live ones max_abs_err={e:.3e}")
    # K2: around its 32-row tiles (15, 16, 63-65, 129), past any tile
    # (1000), the prompt bucket and the decoder's max_len
    for s in sorted({1, 15, 16, 17, 63, 64, 65, 128, 129, 1000, MAX_LEN,
                     plan["k2_s"]}):
        e = max_err(*k2_case(gen, s)[:2])
        worst["k2"] = max(worst.get("k2", 0.0), e)
        print(f"K2 S={s} max_abs_err={e:.3e}")
    kern = k2_case(gen, plan["k2_s"])[0]
    first, second = kern(), kern()
    torch.cuda.synchronize()
    check(torch.equal(first, second), f"K2 not bitwise repeatable at "
                                      f"S={plan['k2_s']}")
    print(f"K2 S={plan['k2_s']}: two launches bitwise equal")
    for hit, s in sorted({(0, 16), (16, 5), (256, 64), (512, 33),
                          (1008, 64), (256, 768), (16, 1008),
                          (plan["k3_hit"], plan["k3_s"])}):
        e = max_err(*k3_case(gen, hit, s)[:2])
        worst["k3"] = max(worst.get("k3", 0.0), e)
        rows, per_split, splits = CA.paged_prefix_plan(
            s, hit, CFG.n_heads, PPS * PAGE)
        print(f"K3 hit_len={hit} S={s} ({rows}-row tiles, {splits} "
              f"split(s) of {per_split} keys) max_abs_err={e:.3e}")
    for name, kern in (
            (f"K1 pos={plan['k1_pos']}", k1_case(gen, plan["k1_pos"])[0]),
            (f"K3 hit_len={plan['k3_hit']} S={plan['k3_s']}",
             k3_case(gen, plan["k3_hit"], plan["k3_s"])[0])):
        first, second = kern(), kern()
        torch.cuda.synchronize()
        check(torch.equal(first, second), f"{name}: not bitwise repeatable")
        print(f"{name}: two launches bitwise equal")
    # K4 in f32: the few-token kernel up to T 64, the many-token one past
    for t in (1, 7, 24, 64, 65, 100):
        for v in (CFG.vocab, 32000):
            e = max_err(*k4_case(gen, t, v, miss_label=True)[:2])
            worst["k4"] = max(worst.get("k4", 0.0), e)
            print(f"K4 T={t} D={CFG.d_model} V={v} max_abs_err={e:.3e}")
    for t in (plan["k4_t"], 100):
        kern = k4_case(gen, t, CFG.vocab, miss_label=False)[0]
        first, second = kern(), kern()
        torch.cuda.synchronize()
        check(torch.equal(first, second), f"K4 not bitwise repeatable at "
                                          f"T={t}")
        print(f"K4 T={t}: two launches bitwise equal")
    for key, err in worst.items():
        check(err <= KERNEL_TOL, f"{key} disagrees with its plain version: "
                                 f"{err:.3e} > {KERNEL_TOL}")
    print(f"kernels agree with their plain versions within {KERNEL_TOL} "
          f"(f32)")

    timed = {
        "paged_decode_attention": ("k1", k1_case(gen, plan["k1_pos"]),
                                   f"N={N_SLOTS} H=8 Dh=64 page=16 "
                                   f"pps={PPS} pos={plan['k1_pos']}",
                                   "paged_decode_attention.cu",
                                   "parallel/pallas_attention.py:1078"),
        "flash_prefill_attention": ("k2", k2_case(gen, plan["k2_s"]),
                                    f"B=1 S={plan['k2_s']} H=8 Dh=64",
                                    "flash_prefill_attention.cu",
                                    "parallel/pallas_attention.py:1156"),
        "paged_prefix_prefill_attention": (
            "k3", k3_case(gen, plan["k3_hit"], plan["k3_s"]),
            f"hit_len={plan['k3_hit']} S={plan['k3_s']} H=8 Dh=64 "
            f"page=16 pps={PPS}", "paged_prefix_prefill_attention.cu",
            "parallel/pallas_attention.py:1231"),
        "fused_softmax_xent": (
            "k4", k4_case(gen, plan["k4_t"], CFG.vocab, miss_label=False),
            f"T={plan['k4_t']} D={CFG.d_model} V={CFG.vocab}",
            "fused_ce_forward.cu", "ops/fused_ce.py:305"),
    }
    # what the protocol reads for a launch that does nothing: the floor
    # under every kernel time here (the cold L2's write-back, the launch)
    one = torch.zeros(1, device=DEV)
    floor_ms = time_ms(lambda: one.add_(1))
    print(f"an empty launch (a one-element add) reads {floor_ms:.4f} ms "
          f"under the same protocol (cold L2)")
    records = {}
    for name, (key, (kern, plain, lib, nbytes, flops), shape, src,
               tpu) in timed.items():
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        lib_ms = time_ms(lib) if lib is not None else None
        b_ms, b_by = (k2_bound(nbytes, flops) if name in TF32_ROUTE
                      else bound(nbytes, flops))
        parts = None
        if name in SECOND_SHAPE:  # the yardstick computes the function
            got = lib().squeeze(2) if key == "k1" else \
                lib()[0].transpose(0, 1)
            e = float((got - plain()).abs().max().item())
            check(e <= ENGINE_TOL, f"{name}'s library route disagrees: {e}")
            parts = kernel_parts(kern, PAGED_KERNELS[name])
        records[name] = {
            "name": name, "route": "cuda",
            "source": f"mmlspark_tpu_torch/csrc/{src}",
            "replaces": f"mmlspark_tpu/{tpu}",
            "launches": 0, "max_abs_err": worst[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_f32_cuda_ms": bound(nbytes, flops)[0],
            "library_ms": lib_ms, "timing_floor_ms": floor_ms,
            "shape": shape,
            "library": LIBRARY_CALL.get(name)}
        if parts is not None:
            records[name]["parts_ms"] = parts
        print(f"{name} [{shape}]: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
              f"bound {b_ms:.4f} ms ({b_by})"
              + (f"; device ms by kernel {parts}" if parts else ""))
    records["flash_prefill_attention"].update(k2_at_max_len(gen, plan))
    for name, rec in SECOND_SHAPE.items():
        records[name].update(second_shape(gen, name, *rec))
    probe = latency_probe(gen, plan, one)
    records["paged_decode_attention"]["probe"] = probe
    k3_ms = records["paged_prefix_prefill_attention"]["second"]["ms"]
    k2_ms = records["flash_prefill_attention"]["at_max_len"]["ms"]
    print(f"K3 at hit_len 256, S 768 over K2 at S {MAX_LEN}: "
          f"{k3_ms / k2_ms:.2f}x")
    records["fused_softmax_xent"].update(k4_probe(gen, plan))
    return records


#: the kernels of K4's verify call, as named in csrc (the few-token
#: partials kernel and the merge)
K4_KERNELS = ("ce_fwd_stream_tf32", "ce_merge_kernel")


def k4_probe(gen, plan) -> dict:
    """Where K4's verify call spends its device time (its partials kernel
    and the merge, ``torch.profiler``), beside one read of W's bytes alone
    under the same protocol (``sum`` of a (D, V) f32 tensor): the least a
    kernel that must read W takes with the cold L2's write-back in its
    way."""
    kern = k4_case(gen, plan["k4_t"], CFG.vocab, miss_label=False)[0]
    parts = kernel_parts(kern, K4_KERNELS)
    w = rnd(gen, CFG.d_model, CFG.vocab)
    read_ms = time_ms(lambda: w.sum())
    print(f"fused_softmax_xent [T={plan['k4_t']}]: device ms by kernel "
          f"{parts}; reading W's {4 * w.numel() / 1e6:.1f} MB alone "
          f"(sum) {read_ms:.4f} ms under the same protocol")
    return {"parts_ms": parts, "read_w_ms": read_ms}


#: the kernels that take the 3xTF32 route (their bound is the larger of
#: its bytes and its operations)
TF32_ROUTE = ("flash_prefill_attention", "paged_prefix_prefill_attention",
              "fused_softmax_xent")
#: the kernels each of K1's and K3's calls launches, as named in csrc
PAGED_KERNELS = {
    "paged_decode_attention": ("paged_decode_split", "paged_merge_kernel"),
    "paged_prefix_prefill_attention": ("paged_prefix_tf32",
                                       "paged_merge_kernel")}
#: K1's and K3's second timed shape: (case key, its arguments, label)
SECOND_SHAPE = {
    "paged_decode_attention": (
        "k1", (list(range(MAX_LEN - N_SLOTS * 3, MAX_LEN, 3)),),
        f"N={N_SLOTS} H=8 Dh=64 page=16 pps={PPS} pos=1000..1021"),
    "paged_prefix_prefill_attention": (
        "k3", (256, 768), f"hit_len=256 S=768 H=8 Dh=64 page=16 pps={PPS}"),
}


def latency_probe(gen, plan, one) -> dict:
    """Whether K1 is bound by latency or by bytes: K1 over one slot of the
    path's positions against all eight (a time that does not grow with 8x
    the bytes is latency), beside the empty launch, in one call."""
    cases = {"empty launch": lambda: one.add_(1),
             "K1 8 slots": k1_case(gen, plan["k1_pos"])[0],
             "K1 1 slot": k1_case(gen, plan["k1_pos"][:1])[0]}
    out = {name: time_ms(fn) for name, fn in cases.items()}
    print("latency probe (ms, cold L2): " + "; ".join(
        f"{name} {t:.4f}" for name, t in out.items()))
    return out


def second_shape(gen, name, key, args, shape) -> dict:
    """A kernel's second timed shape beside its library route, with both
    bounds: the route's (bytes, or 3xTF32 operations at the TF32 rate for
    K3) as ``bound_ms``, and f32 operations on the CUDA cores."""
    kern, _, lib, nbytes, flops = (k1_case if key == "k1" else k3_case)(
        gen, *args)
    ms, lib_ms = time_ms(kern), time_ms(lib)
    b_ms, b_by = (k2_bound(nbytes, flops) if name in TF32_ROUTE
                  else bound(nbytes, flops))
    out = {"shape": shape, "ms": ms, "library_ms": lib_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bound_f32_cuda_ms": bound(nbytes, flops)[0],
           "parts_ms": kernel_parts(kern, PAGED_KERNELS[name])}
    print(f"{name} [{shape}]: kernel {ms:.4f} ms, library {lib_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), f32 CUDA-core bound "
          f"{out['bound_f32_cuda_ms']:.4f} ms; device ms by kernel "
          f"{out['parts_ms']}")
    return {"second": out}


def k2_bound(nbytes: float, flops: float):
    """K2's bound on the route it takes: its bytes, or its operations in
    3xTF32 (three tf32 products per f32 one) at the dense TF32
    tensor-core rate, whichever is larger."""
    return bound(nbytes, 3 * flops, PEAK_TF32_FLOPS)


def k2_at_max_len(gen, plan) -> dict:
    """K2's second timed shape, the decoder's max_len, beside SDPA; and
    beside the 3xTF32 bound (``bound_ms``) at each shape the bound of the
    same work in f32 on the CUDA cores (``bound_f32_cuda_ms``)."""
    s = plan["k2_s"]
    out = {"bound_f32_cuda_ms": bound(4 * 4 * s * CFG.n_heads * CFG.d_head,
                                      k2_flops(s))[0]}
    kern, _, lib, nbytes, flops = k2_case(gen, MAX_LEN)
    ms, lib_ms = time_ms(kern), time_ms(lib)
    b_ms, b_by = k2_bound(nbytes, flops)
    out["at_max_len"] = {
        "shape": f"B=1 S={MAX_LEN} H=8 Dh=64", "ms": ms, "library_ms": lib_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_f32_cuda_ms": bound(nbytes, flops)[0]}
    print(f"flash_prefill_attention: f32 CUDA-core bound "
          f"{out['bound_f32_cuda_ms']:.4f} ms at S={s}; "
          f"[B=1 S={MAX_LEN} H=8 Dh=64]: kernel {ms:.4f} ms, library "
          f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, 3xTF32), f32 "
          f"CUDA-core bound {out['at_max_len']['bound_f32_cuda_ms']:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 9: the train step's kernels against their plain versions


def err_ratio(got, ref):
    """``(max |got - ref|, that over max(1, max |ref|), the scaled
    error)``: the error, the f32 limit's measure and the measure every
    train kernel's scaled limit bounds (see RMS_FLOOR)."""
    got, ref = got.float(), ref.float()
    check(torch.isfinite(got).all().item(), "kernel output not finite")
    diff = (got - ref).abs()
    err = float(diff.max().item())
    mag = ref.abs()
    rms = max(float(ref.square().mean().sqrt().item()), RMS_FLOOR)
    scaled = float((diff / (mag + rms)).max().item())
    return err, err / max(1.0, float(mag.max().item())), scaled


def worse(*errs):
    """The element-wise worst of several ``err_ratio`` readings (one
    kernel's outputs, or its shapes)."""
    return tuple(max(e[i] for e in errs) for i in range(3))


def attn_inputs(gen, b, s, dtype, h=CFG.n_heads):
    return tuple(rnd(gen, b, s, h, CFG.d_head).to(dtype) for _ in range(4))


def attn_errors(gen, b, s, dtype, h=CFG.n_heads) -> dict:
    """The forward (as the folded engine calls it: output in the input
    dtype) and the two backward kernels against their plain versions on
    the same inputs (``h`` heads)."""
    q, k, v, do = attn_inputs(gen, b, s, dtype, h)
    scale = CFG.d_head ** -0.5
    out, lse = CA.attention_fwd(q, k, v, True)
    ref_out, ref_lse = CA.attention_fwd_plain(q, k, v, True, scale)
    errs = {"attention_fwd": worse(err_ratio(out, ref_out.to(dtype)),
                                   err_ratio(lse, ref_lse))}
    del ref_out, ref_lse
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = CA.attention_bwd_dq(q, k, v, do, lse, delta, True)
    dk, dv = CA.attention_bwd_dkdv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    rq, rk, rv = CA.attention_bwd_plain(q, k, v, do, lse, delta, True, scale)
    errs["attention_bwd_dq"] = err_ratio(dq, rq)
    errs["attention_bwd_dkdv"] = worse(err_ratio(dk, rk), err_ratio(dv, rv))
    return errs


def ce_inputs(gen, t, v, dtype):
    """K6's inputs at the head's width: RMS-normed-scale ``h``, the
    head's init scale for ``w``, labels -1 and V (no column matches), a
    unit-scale per-token cotangent."""
    h = rnd(gen, t, CFG.d_model).to(dtype)
    w = (0.02 * rnd(gen, CFG.d_model, v)).to(dtype)
    labels = torch.randint(0, v, (t,), generator=gen, dtype=torch.int32)
    labels[0], labels[-1] = -1, v
    g = torch.rand(t, generator=gen).to(DEV)
    return h, w, labels.to(DEV), g


def ce_errors(gen, t, v, dtype) -> dict:
    h, w, labels, g = ce_inputs(gen, t, v, dtype)
    ce, logits, lse = FC._forward(h, w, labels, store=True)
    torch.cuda.synchronize()
    ref_ce, ref_logits, ref_lse = FC._forward_plain(h, w, labels)
    errs = {"fused_softmax_xent_train": worse(
        err_ratio(ce, ref_ce), err_ratio(lse, ref_lse),
        err_ratio(logits, ref_logits.to(dtype)))}
    del ref_logits
    args = (h, w, labels, g, logits, lse)
    dh, dw = FC.fused_ce_dh(*args), FC.fused_ce_dw(*args)
    torch.cuda.synchronize()
    errs["fused_ce_dh"] = err_ratio(dh, FC.fused_ce_dh_plain(*args))
    errs["fused_ce_dw"] = err_ratio(dw, FC.fused_ce_dw_plain(*args))
    return errs


def sdpa_layout(*xs):
    return tuple(x.transpose(1, 2).contiguous() for x in xs)


def train_timed_cases(gen) -> dict:
    """Each train kernel, its plain version and its library call at the
    bench shape in bf16 (attention B 8 x S 1024 x 8 heads x 64; CE
    T 8192 x D 512 x V 32768): name -> (kernel, plain, library, bytes,
    FLOPs, shape), K4's training variant also its no-store forward."""
    dt, esz = torch.bfloat16, 2
    b, s, h, d = TRAIN_B, TRAIN_S, CFG.n_heads, CFG.d_head
    scale = d ** -0.5
    q, k, v, do = attn_inputs(gen, b, s, dt)
    out, lse = CA.attention_fwd(q, k, v, True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta, True)
    qt, kt, vt, dot = sdpa_layout(q, k, v, do)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, is_causal=True)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        sdpa_out, (qg, kg, vg), dot, retain_graph=True)
    pairs = b * h * s * (s + 1) // 2
    elems = b * s * h * d
    stats = 4 * b * h * s
    attn_shape = f"B={b} S={s} H={h} Dh={d} causal bf16"
    cases = {
        "attention_fwd": (
            lambda: CA.attention_fwd(q, k, v, True),
            lambda: CA.attention_fwd_plain(q, k, v, True, scale),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True),
            esz * 4 * elems + stats, 4 * d * pairs, attn_shape),
        "attention_bwd_dq": (
            lambda: CA.attention_bwd_dq(*bwd),
            lambda: CA.attention_bwd_plain(*bwd, scale), sdpa_bwd,
            esz * 4 * elems + 2 * stats + 4 * elems, 6 * d * pairs,
            attn_shape),
        "attention_bwd_dkdv": (
            lambda: CA.attention_bwd_dkdv(*bwd),
            lambda: CA.attention_bwd_plain(*bwd, scale), sdpa_bwd,
            esz * 4 * elems + 2 * stats + 8 * elems, 8 * d * pairs,
            attn_shape)}
    t, dm, vocab = TRAIN_B * TRAIN_S, CFG.d_model, CFG.vocab
    hh, ww, labels, g = ce_inputs(gen, t, vocab, dt)
    _, logits, lse_ce = FC._forward(hh, ww, labels, store=True)
    args = (hh, ww, labels, g, logits, lse_ce)
    lbl64 = labels.long().clamp(0, vocab - 1)
    hg, wg = hh.detach().requires_grad_(), ww.detach().requires_grad_()
    lib_loss = torch.nn.functional.cross_entropy(hg @ wg, lbl64,
                                                 reduction="sum")
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        lib_loss, (hg, wg), retain_graph=True)
    ce_shape = f"T={t} D={dm} V={vocab} bf16"
    flops = 2 * t * dm * vocab
    operands = esz * (t * dm + dm * vocab + t * vocab)
    cases.update({
        "fused_softmax_xent_train": (
            lambda: FC._forward(hh, ww, labels, store=True),
            lambda: FC._forward_plain(hh, ww, labels),
            lambda: torch.nn.functional.cross_entropy(
                hh @ ww, lbl64, reduction="none"),
            operands + 12 * t, flops, ce_shape,
            lambda: FC._forward(hh, ww, labels, store=False)),
        "fused_ce_dh": (lambda: FC.fused_ce_dh(*args),
                        lambda: FC.fused_ce_dh_plain(*args), lib_bwd,
                        operands + 12 * t, flops, ce_shape),
        "fused_ce_dw": (lambda: FC.fused_ce_dw(*args),
                        lambda: FC.fused_ce_dw_plain(*args), lib_bwd,
                        operands + 12 * t, flops, ce_shape)})
    return cases


TRAIN_SOURCES = {
    "attention_fwd": ("attention_train.cu",
                      "parallel/pallas_attention.py:708"),
    "attention_bwd_dq": ("attention_train.cu",
                         "parallel/pallas_attention.py:664"),
    "attention_bwd_dkdv": ("attention_train.cu",
                           "parallel/pallas_attention.py:680"),
    "fused_softmax_xent_train": ("fused_ce_forward.cu", "ops/fused_ce.py:305"),
    "fused_ce_dh": ("fused_ce_backward.cu", "ops/fused_ce.py:231"),
    "fused_ce_dw": ("fused_ce_backward.cu", "ops/fused_ce.py:247"),
}


#: the f32 train kernels' records -> the kernel each times (the f32
#: routes, 3xTF32), at the f32 train parity step's shape (T 2048; B 2 x
#: S 1024 for K7)
F32_TRAIN = {"fused_softmax_xent_train_f32": "fused_softmax_xent_train",
             "fused_ce_dh_f32": "fused_ce_dh", "fused_ce_dw_f32": "fused_ce_dw",
             "attention_fwd_f32": "attention_fwd",
             "attention_bwd_dq_f32": "attention_bwd_dq",
             "attention_bwd_dkdv_f32": "attention_bwd_dkdv"}


def train_f32_timed_cases(gen) -> dict:
    """K4's training variant and K6's dh and dW in f32 at the f32 train
    parity step's T (B 2 x S 1024 = 2048 tokens), D 512, V 32768: name ->
    (kernel, plain, library, bytes, FLOPs, shape). Two launches of each
    must give the same bits. The library calls run in f32 with TF32 off."""
    t, dm, vocab = 2 * TRAIN_S, CFG.d_model, CFG.vocab
    h, w, labels, g = ce_inputs(gen, t, vocab, torch.float32)
    _, logits, lse = FC._forward(h, w, labels, store=True)
    args = (h, w, labels, g, logits, lse)
    repeats = {"forward": lambda: FC._forward(h, w, labels, store=True),
               "dh": lambda: FC.fused_ce_dh(*args),
               "dw": lambda: FC.fused_ce_dw(*args)}
    for name, fn in repeats.items():
        check(repeats_bitwise(fn),
              f"f32 CE {name} at T={t} not bitwise repeatable")
    print(f"f32 CE forward (training), dh and dW at T={t}: two launches "
          f"bitwise equal")
    lbl64 = labels.long().clamp(0, vocab - 1)
    hg, wg = h.detach().requires_grad_(), w.detach().requires_grad_()
    lib_loss = torch.nn.functional.cross_entropy(hg @ wg, lbl64,
                                                 reduction="sum")
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        lib_loss, (hg, wg), retain_graph=True)
    shape = f"T={t} D={dm} V={vocab} f32"
    flops = 2 * t * dm * vocab
    nbytes = 4 * (t * dm + dm * vocab + t * vocab) + 12 * t
    return {
        "fused_softmax_xent_train_f32": (
            repeats["forward"], lambda: FC._forward_plain(h, w, labels),
            lambda: torch.nn.functional.cross_entropy(
                h @ w, lbl64, reduction="none"), nbytes, flops, shape),
        "fused_ce_dh_f32": (repeats["dh"],
                            lambda: FC.fused_ce_dh_plain(*args), lib_bwd,
                            nbytes, flops, shape),
        "fused_ce_dw_f32": (repeats["dw"],
                            lambda: FC.fused_ce_dw_plain(*args), lib_bwd,
                            nbytes, flops, shape)}


def device_kernels(fn, n: int = 3) -> list:
    """The names of the CUDA kernels that ``n`` calls of ``fn`` launch
    (``torch.profiler``): which backend served a library call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def sdpa_backend(names) -> str:
    """The ``scaled_dot_product_attention`` backend that launched the
    kernels ``names``: flash, efficient (the CUTLASS fmha kernels), cudnn,
    or math (matmuls and a softmax); "not captured" when the profiler
    recorded no kernel."""
    if not names:
        return "not captured"
    low = " ".join(names).lower()
    for key, backend in (("flash", "flash"), ("fmha", "efficient"),
                         ("efficient", "efficient"), ("cudnn", "cudnn")):
        if key in low:
            return backend
    return "math"


def repeats_bitwise(fn) -> bool:
    """Two launches of ``fn`` on the same inputs give the same bits."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    if isinstance(first, tuple):
        return all(torch.equal(a, b) for a, b in zip(first, second))
    return torch.equal(first, second)


def attn_f32_timed_cases(gen) -> dict:
    """K7's forward, dq and dk/dv in f32 (3xTF32) at the f32 train parity
    step's shape (B 2, S 1024, 8 heads x 64, causal): name -> (kernel,
    plain, library, bytes, FLOPs, shape). Two launches of each must give
    the same bits. The library call is ``scaled_dot_product_attention``
    on the f32 inputs (``is_causal``), forward and autograd backward;
    which backend serves it is printed."""
    b, s, h, d = 2, TRAIN_S, CFG.n_heads, CFG.d_head
    scale = d ** -0.5
    q, k, v, do = attn_inputs(gen, b, s, torch.float32)
    out, lse = CA.attention_fwd(q, k, v, True)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta, True)
    kern = {"attention_fwd_f32": lambda: CA.attention_fwd(q, k, v, True),
            "attention_bwd_dq_f32": lambda: CA.attention_bwd_dq(*bwd),
            "attention_bwd_dkdv_f32": lambda: CA.attention_bwd_dkdv(*bwd)}
    for name, fn in kern.items():
        check(repeats_bitwise(fn), f"{name} not bitwise repeatable")
    qt, kt, vt, dot = sdpa_layout(q, k, v, do)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    sdpa_fwd = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, is_causal=True)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        sdpa_out, (qg, kg, vg), dot, retain_graph=True)
    for what, fn in (("forward", sdpa_fwd), ("backward", sdpa_bwd)):
        names = device_kernels(fn)
        print(f"f32 SDPA {what} (B={b} S={s}, is_causal): "
              f"backend {sdpa_backend(names)}, kernels "
              f"{[n[:60] for n in names]}")
    print(f"K7 f32 forward, dq and dk/dv at B={b} S={s}: two launches "
          f"bitwise equal")
    pairs = b * h * s * (s + 1) // 2
    elems, stats = b * s * h * d, 4 * b * h * s
    shape = f"B={b} S={s} H={h} Dh={d} causal f32"
    return {
        "attention_fwd_f32": (
            kern["attention_fwd_f32"],
            lambda: CA.attention_fwd_plain(q, k, v, True, scale), sdpa_fwd,
            4 * 4 * elems + stats, 4 * d * pairs, shape),
        "attention_bwd_dq_f32": (
            kern["attention_bwd_dq_f32"],
            lambda: CA.attention_bwd_plain(*bwd, scale), sdpa_bwd,
            4 * 5 * elems + 2 * stats, 6 * d * pairs, shape),
        "attention_bwd_dkdv_f32": (
            kern["attention_bwd_dkdv_f32"],
            lambda: CA.attention_bwd_plain(*bwd, scale), sdpa_bwd,
            4 * 6 * elems + 2 * stats, 8 * d * pairs, shape)}


def f32_record(name, case, peak, src, tpu, err) -> dict:
    """The timed record of an f32 (3xTF32) kernel: ``case`` = (kernel,
    plain, library, bytes, FLOPs, shape); its time, its plain version's
    and the library call's (cold L2), beside three bounds: 3xTF32 at the
    TF32 rate (``bound_ms``, the route's), f32 on the CUDA cores, and the
    three tf32 products at ``peak``, the rate this card runs mma.sync;
    ``err`` the kernel's (max abs, scaled) error from the checks."""
    kern, plain, lib, nbytes, flops, shape = case
    ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(lib)
    b_ms, b_by = k2_bound(nbytes, flops)
    rec = {"name": name, "route": "cuda",
           "source": f"mmlspark_tpu_torch/csrc/{src}",
           "replaces": f"mmlspark_tpu/{tpu}", "launches": 0,
           "max_abs_err": err[0], "scaled_err": err[1],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bound_f32_cuda_ms": bound(nbytes, flops)[0],
           "library_ms": lib_ms, "shape": shape,
           "library": LIBRARY_CALL[name],
           "tflops": flops / (ms / 1e3) / 1e12,
           "mma_sync_tf32_tflops": peak,
           "mma_sync_floor_ms": 3 * flops / (peak * 1e12) * 1e3}
    print(f"{name} [{shape}]: kernel {ms:.4f} ms ({rec['tflops']:.1f} "
          f"TFLOP/s), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}, 3xTF32), f32 CUDA-core bound "
          f"{rec['bound_f32_cuda_ms']:.4f} ms, three tf32 products at "
          f"mma.sync's rate {rec['mma_sync_floor_ms']:.4f} ms")
    return rec


def mma_tf32_peak() -> float:
    """TFLOP/s of mma.sync m16n8k8 tf32 on this card, the instruction of
    every 3xTF32 kernel (``csrc/mma_probe.cu``: 8 blocks an SM, 16
    independent products a warp)."""
    blocks = 8 * torch.cuda.get_device_properties(DEV).multi_processor_count
    iters = 4096
    out = torch.empty(blocks * 256, device=DEV)
    ms = time_ms(lambda: NL.launch("mmt_mma_tf32_probe", [NL.P, NL.I, NL.I],
                                   DEV, out.data_ptr(), blocks, iters), 5)
    return blocks * 8 * iters * 16 * 2048 / (ms / 1e3) / 1e12


def train_kernel_phase() -> dict:
    """Correctness of the six train kernels at many shapes, in f32 and
    bf16; timing at the bench shape. Returns per-kernel records."""
    gen = torch.Generator().manual_seed(SEED + 3)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        cases = [(f"attention B={b} S={s} H=8 Dh=64", s <= ATTN_KEY_TILE,
                  lambda b=b, s=s: attn_errors(gen, b, s, dtype))
                 for b, s in ATTN_SHAPES]
        cases += [(f"CE train T={t} D={CFG.d_model} V={v}", False,
                   lambda t=t, v=v: ce_errors(gen, t, v, dtype))
                  for t, v in CE_SHAPES]
        for label, one_tile, run in cases:
            errs = run()
            print(f"{label} {tag}: " + ", ".join(
                f"{n} {e[0]:.3e} ({e[2]:.3e} scaled)"
                for n, e in errs.items()))
            for n, e in errs.items():
                worst[(n, tag)] = worse(worst.get((n, tag), (0.0,) * 3), e)
                check(not one_tile or e[2] <= ONE_TILE_TOL,
                      f"{n} ({tag}, {label}, one key tile) scaled error "
                      f"{e[2]:.3e} > {ONE_TILE_TOL}")
            torch.cuda.empty_cache()
        for (n, t_), (_, rel, scaled) in worst.items():
            if t_ != tag:
                continue
            if dtype == torch.float32:
                check(rel <= KERNEL_TOL, f"{n} (f32) disagrees with its plain "
                                         f"version: {rel:.3e} > {KERNEL_TOL} "
                                         f"x max(1, |ref|)")
                check(scaled <= F32_SCALED_TOL,
                      f"{n} (f32) scaled error {scaled:.3e} > "
                      f"{F32_SCALED_TOL}")
            else:
                check(scaled <= BF16_LIMITS[n], f"{n} (bf16) scaled error "
                                                f"{scaled:.3e} > "
                                                f"{BF16_LIMITS[n]}")
        print(f"train kernels agree with their plain versions ({tag}): "
              + ", ".join(f"{n} {worst[(n, tag)][2]:.3e}" for n in
                          BF16_LIMITS) + " scaled"
              + (f", within {KERNEL_TOL} x max(1, max |ref|) and "
                 f"{F32_SCALED_TOL} scaled" if dtype == torch.float32 else
                 f", within their limits {BF16_LIMITS}")
              + f"; attention within {ONE_TILE_TOL} scaled at S <= "
                f"{ATTN_KEY_TILE}")

    records = {}
    cases = train_timed_cases(gen)
    for name, (kern, plain, lib, nbytes, flops, shape, *_) in cases.items():
        ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(lib)
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        src, tpu = TRAIN_SOURCES[name]
        records[name] = {
            "name": name, "route": "cuda",
            "source": f"mmlspark_tpu_torch/csrc/{src}",
            "replaces": f"mmlspark_tpu/{tpu}", "launches": 0,
            "max_abs_err": worst[(name, "float32")][0],
            "max_abs_err_bf16": worst[(name, "bfloat16")][0],
            "scaled_err": worst[(name, "float32")][2],
            "scaled_err_bf16": worst[(name, "bfloat16")][2],
            "bf16_limit": BF16_LIMITS[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "shape": shape,
            "library": LIBRARY_CALL[name],
            "tflops": flops / (ms / 1e3) / 1e12}
        print(f"{name} [{shape}]: kernel {ms:.4f} ms "
              f"({records[name]['tflops']:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
        torch.cuda.empty_cache()
    # the f32 routes (3xTF32) at the f32 parity step's T, beside both
    # bounds: 3xTF32 operations at the TF32 rate (the route's) and f32
    # operations on the CUDA cores
    torch.backends.cuda.matmul.allow_tf32 = False
    peak = mma_tf32_peak()
    print(f"mma.sync m16n8k8 tf32 on this card: {peak:.1f} TFLOP/s "
          f"(wgmma's data-sheet rate {PEAK_TF32_FLOPS / 1e12:.0f})")
    f32_cases = {**train_f32_timed_cases(gen), **attn_f32_timed_cases(gen)}
    for name, case in f32_cases.items():
        base = F32_TRAIN[name]
        src, tpu = TRAIN_SOURCES[base]
        if base.startswith("attention"):
            src = "attention_tf32.cuh"
        records[name] = f32_record(
            name, case, peak, src, tpu,
            (worst[(base, "float32")][0], worst[(base, "float32")][2]))
        torch.cuda.empty_cache()
    # what K4's training variant pays for storing the logits: the same
    # kernel without the store (the no-store bf16 forward), same inputs
    train = records["fused_softmax_xent_train"]
    train["no_store_ms"] = time_ms(cases["fused_softmax_xent_train"][6])
    print(f"fused_softmax_xent_train: the logits store costs "
          f"{train['ms'] - train['no_store_ms']:.4f} ms (no-store forward "
          f"{train['no_store_ms']:.4f} ms); K6 dh + dW "
          f"{records['fused_ce_dh']['ms'] + records['fused_ce_dw']['ms']:.4f}"
          f" ms against the library backward's "
          f"{records['fused_ce_dh']['library_ms']:.4f} ms")
    return records


def ce_engine_times() -> dict:
    """The train loss through each engine (``T._token_ce``), forward and
    backward to ``h`` and ``w``, bf16 compute on f32 ``h`` and master
    head as the train step runs it: at T = 256, below the auto gate's 512
    tokens, where "auto" picks dense, and at the bench's 8192."""
    gen = torch.Generator().manual_seed(SEED + 5)
    out = {}
    for t in (256, TRAIN_B * TRAIN_S):
        h = rnd(gen, t, CFG.d_model).requires_grad_()
        w = (0.02 * rnd(gen, CFG.d_model, CFG.vocab)).requires_grad_()
        lbl = torch.randint(0, CFG.vocab, (t,), generator=gen,
                            dtype=torch.int32).to(DEV)
        for engine in ("cuda", "dense"):
            out[f"T{t}_{engine}_ms"] = time_ms(
                lambda e=engine: torch.autograd.grad(
                    T._token_ce(h, w, lbl, TRAIN_CFG, e).sum(), (h, w)))
        print(f"train loss fwd+bwd, T={t} D={CFG.d_model} V={CFG.vocab} "
              f"bf16: cuda engine {out[f'T{t}_cuda_ms']:.4f} ms, dense "
              f"engine {out[f'T{t}_dense_ms']:.4f} ms; auto picks "
              f"{T.train_ce_engine(TRAIN_CFG, t, DEV)}")
        del h, w
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4: the served main path


class Pending:
    """What the standalone scheduler touches of a pending request."""

    def __init__(self, payload, rid, span=None):
        self.payload = payload
        self.rid = rid
        self.deadline = None
        self.event = threading.Event()
        self.callbacks = []
        self.reply = None
        self.status = None
        self.span = span


def make_requests(rng):
    vocab = CFG.vocab
    pre = [rng.integers(1, vocab, size=PREAMBLE).tolist() for _ in range(2)]
    reqs = []
    for i in range(8):
        suffix = rng.integers(1, vocab, size=16 + 5 * i).tolist()
        payload = {"prompt": pre[i % 2] + suffix, "max_new_tokens": MAX_NEW}
        if i == 5:
            payload.update(temperature=0.8, top_k=50, seed=1234)
        reqs.append(payload)
    return pre, reqs


def main_path_shapes(payloads) -> dict:
    """The kernels' shapes on the main path: K1 at every slot's position
    half way through its decode, K2 at request 0's prompt bucket, K3 at
    request 0's pass-2 hit depth and suffix bucket."""
    len0 = len(payloads[0]["prompt"])
    hit0 = ((len0 - 1) // PAGE) * PAGE
    return {"k1_pos": [len(p["prompt"]) + MAX_NEW // 2 for p in payloads],
            "k2_s": bucket_target(len0, MAX_LEN),
            "k3_hit": hit0, "k3_s": bucket_target(len0 - hit0, MAX_LEN),
            "k4_t": N_SLOTS * (SPEC_K - 1)}


def serve(sched, payloads, tag, tracer=None):
    """Submit ``payloads`` and wait for every reply; with ``tracer``,
    each request gets a root span (trace id = its rid), finished once
    its reply is in."""
    pend = [Pending(p, f"{tag}-{i}", None if tracer is None else
                    tracer.start("request", trace_id=f"{tag}-{i}"))
            for i, p in enumerate(payloads)]
    t0 = time.perf_counter()
    for p in pend:
        sched.submit(p)
    for p in pend:
        check(p.event.wait(600), f"{p.rid} timed out")
    wall = time.perf_counter() - t0
    if tracer is not None:
        for p in pend:
            tracer.finish(p.span)
    replies = [json.loads(p.reply) for p in pend]
    for p, r in zip(pend, replies):
        check(p.status == 200, f"{p.rid} replied {p.status}: {r}")
        check(r["n_tokens"] == p.payload["max_new_tokens"],
              f"{p.rid} produced {r['n_tokens']} tokens")
    return replies, wall


def ledger_clean(sched) -> bool:
    return (sched.pages.n_free + sched.prefix.n_cached
            == sched.pages.n_pages - 1 and sched.prefix.ledger_clean())


def paged_launches(stats) -> dict:
    """Each kernel's launches on the paged path, from the scheduler's
    ledger: K1 once a layer a step, K2 once a layer a cold prefill, K3
    once a layer a prefix hit, no verify, no train kernel."""
    hits = stats["prefix_cache"]["hits"]
    return {"paged_decode_attention": CFG.n_layers * stats["n_steps"],
            "flash_prefill_attention":
                CFG.n_layers * (stats["n_prefills"] - hits),
            "paged_prefix_prefill_attention": CFG.n_layers * hits,
            "fused_softmax_xent": 0,
            **{n: 0 for n in TRAIN_LAUNCHES if n != "fused_softmax_xent"}}


def spec_launches(stats, dcfg) -> dict:
    """As :func:`paged_launches` on the speculative path, where every
    request is spec-capable (greedy, or opted in): each admission
    prefills the draft too (K2 over its layers), and K4 scores each
    round's verify once."""
    want = paged_launches(stats)
    want["flash_prefill_attention"] += dcfg.n_layers * stats["n_prefills"]
    want["fused_softmax_xent"] = stats["speculative"]["rounds"]
    return want


def check_launches(launches, want, label) -> None:
    for name, n in want.items():
        check(launches[name] == n,
              f"{label}: {name} launched {launches[name]} times, "
              f"expected {n}")


def main_path(params, pre, payloads, card_line):
    dec = TransformerDecoder(params, CFG, n_slots=N_SLOTS, max_len=MAX_LEN,
                             page_size=PAGE)
    check(dec.device.type == "cuda" and dec.attn_impl == "cuda",
          f"decoder resolved to {dec.device}/{dec.attn_impl}")
    dec.warmup()
    sched = DecodeScheduler(dec, max_new_tokens_default=MAX_NEW).start()
    ptr = dec.cache["k"].data_ptr(), dec.cache["v"].data_ptr()
    rng = np.random.default_rng(SEED + 1)
    cold_probe = {"prompt": rng.integers(1, CFG.vocab, size=280).tolist(),
                  "max_new_tokens": 1}
    warm_probe = {"prompt": pre[0] + rng.integers(1, CFG.vocab,
                                                  size=24).tolist(),
                  "max_new_tokens": 1}
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        r1, wall1 = serve(sched, payloads, "pass1")
        hits_1 = sched.prefix.stats()["hits"]
        r2, wall2 = serve(sched, payloads, "pass2")
        _, ttft_cold = serve(sched, [cold_probe], "cold")
        _, ttft_warm = serve(sched, [warm_probe], "warm")
        torch.cuda.synchronize()
        launches = read_launch_counts()
        stats = sched.stats()
    finally:
        sched.stop()
    pstats = stats["prefix_cache"]
    print(f"served {stats['n_requests']} requests, {stats['n_steps']} "
          f"steps, {stats['n_prefills']} prefills "
          f"({pstats['hits']} prefix hits, {pstats['hit_tokens']} hit "
          f"tokens); launches {launches}")
    check(stats["n_step_faults"] == 0, "a decode step faulted")
    check(hits_1 == 0, "pass 1 should be all cold prefills")
    check(pstats["hits"] > 0, "pass 2 did not hit the prefix cache")
    want = paged_launches(stats)
    for name, n in want.items():
        check(launches[name] > 0 or n == 0, f"{name} never launched")
    check_launches(launches, want, "paged path")
    check(ledger_clean(sched), "page ledger not clean at idle")
    check((dec.cache["k"].data_ptr(), dec.cache["v"].data_ptr()) == ptr,
          "the KV pool moved")
    same = sum(a["tokens"] == b["tokens"] for a, b in zip(r1, r2))
    metrics = {
        "pass1_tokens_per_s": sum(r["n_tokens"] for r in r1) / wall1,
        "pass2_tokens_per_s": sum(r["n_tokens"] for r in r2) / wall2,
        "ttft_cold_ms": ttft_cold * 1e3, "ttft_warm_ms": ttft_warm * 1e3,
        "pass2_repeats_pass1": same}
    print(f"[{card_line}] decode tokens/s, 8 requests x {MAX_NEW} tokens: "
          f"pass 1 (cold prefills) {metrics['pass1_tokens_per_s']:.1f}, "
          f"pass 2 (prefix hits) {metrics['pass2_tokens_per_s']:.1f}; "
          f"{same}/8 requests repeat pass 1's tokens exactly")
    print(f"[{card_line}] TTFT on an idle decoder: cold 280-token prompt "
          f"{metrics['ttft_cold_ms']:.2f} ms, 280-token prompt with a "
          f"256-token prefix hit {metrics['ttft_warm_ms']:.2f} ms")
    return r1, r2, launches, metrics


def device_profile(run, n: int, label: str, card_line: str,
                   pick=()) -> dict:
    """Where ``run()``'s time goes: the host wall clock over ``n`` calls
    (after 3 warm ones), then ``torch.profiler`` over ``n`` more: device
    time by kernel, and under ``picked`` the device ms per call of the
    kernels whose names hold each string of ``pick``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    # device-side rows only (kernels, copies): host ops would count their
    # kernels twice
    rows = [(e.key, e.device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    dev_ms = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    print(f"[{card_line}] {label}: wall {wall_ms:.3f} ms, device busy "
          f"{dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}% of wall)")
    for key, ms, count in rows[:10]:
        print(f"  {ms:8.4f} ms  x{count:<4d} {key[:90]}")
    picked = {p: sum(ms for k, ms, _ in rows if p in k) for p in pick}
    if picked:
        print("  of which " + ", ".join(f"{p} {ms:.4f} ms"
                                        for p, ms in picked.items()))
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "top": [(k[:60], ms) for k, ms, _ in rows[:6]],
            "picked": picked,
            "device_ops": sum(count for _, _, count in rows)}


def profile_positions(payloads) -> np.ndarray:
    return np.array([len(p["prompt"]) + MAX_NEW // 2 for p in payloads],
                    np.int32)


def step_profile(params, payloads, card_line) -> dict:
    """A full-batch decode step: 8 live slots at the main path's
    positions half way through their decode."""
    dec = TransformerDecoder(params, CFG, n_slots=N_SLOTS, max_len=MAX_LEN,
                             page_size=PAGE)
    tables = 1 + np.arange(N_SLOTS * PPS, dtype=np.int32).reshape(
        N_SLOTS, PPS)
    pos = profile_positions(payloads)
    toks = np.ones(N_SLOTS, np.int32)
    got = device_profile(lambda: dec.step_logits(toks, pos, tables), 8,
                         f"decode step (8 slots, pos ~{int(pos.mean())})",
                         card_line, pick=K1_KERNELS)
    k1_ms = sum(got["picked"].values())
    # the merge starts early (a programmatic dependent launch) and waits
    # for the split kernel inside its own duration: the sum overstates K1
    print(f"[{card_line}] K1 (split and merge kernels) {k1_ms:.4f} ms of "
          f"the step's {got['device_ms']:.4f} ms of device time "
          f"({100 * k1_ms / got['device_ms']:.1f}%; the split kernel alone "
          f"{got['picked'][K1_KERNELS[0]]:.4f} ms, the merge's time "
          f"includes its wait behind it)")
    return {"step_wall_ms": got["wall_ms"],
            "step_device_ms": got["device_ms"], "step_k1_device_ms": k1_ms,
            "step_k1_share": k1_ms / got["device_ms"], "top": got["top"]}


#: K1's kernels as the profiler names them (the split kernel and the merge)
K1_KERNELS = ("paged_decode_split", "paged_merge_kernel")


# ---------------------------------------------------------------------------
# phase 5: cuda vs dense engines in lockstep


def engine_parity(params, payloads, replies) -> float:
    decs = {impl: TransformerDecoder(params, CFG, n_slots=N_SLOTS,
                                     max_len=MAX_LEN, page_size=PAGE,
                                     attn_impl=impl)
            for impl in ("cuda", "dense")}
    ident = 1 + np.arange(N_SLOTS * PPS, dtype=np.int32).reshape(
        N_SLOTS, PPS)
    tables = ident.copy()
    worst = 0.0

    def diff(a, b):
        return float((a - b).abs().max().item())

    first_of = {}
    for i, p in enumerate(payloads):
        prompt = np.asarray(p["prompt"], np.int32)
        key = tuple(p["prompt"][:PREAMBLE])
        outs = []
        if key in first_of:
            # attach the earlier slot's preamble pages: a prefix hit
            tables[i, :PREAMBLE // PAGE] = tables[first_of[key],
                                                  :PREAMBLE // PAGE]
            for dec in decs.values():
                outs.append(dec.prefill_prefix_logits(
                    i, prompt, PREAMBLE, tables[i])[1])
        else:
            first_of[key] = i
            for dec in decs.values():
                outs.append(dec.prefill_logits(i, prompt, tables[i])[1])
        worst = max(worst, diff(*outs))
    lens = np.array([len(p["prompt"]) for p in payloads], np.int32)
    for t in range(MAX_NEW - 1):
        toks = np.array([r["tokens"][t] for r in replies], np.int32)
        pos = lens + t
        outs = [dec.step_logits(toks, pos, tables)[1]
                for dec in decs.values()]
        check(all(torch.isfinite(o).all().item() for o in outs),
              "non-finite step logits")
        worst = max(worst, diff(*outs))
    print(f"cuda vs dense engine, {len(payloads)} prefills + "
          f"{MAX_NEW - 1} teacher-forced steps: max |logit diff| = "
          f"{worst:.3e} (tolerance {ENGINE_TOL})")
    check(worst <= ENGINE_TOL, f"engines disagree: {worst:.3e}")
    return worst


# ---------------------------------------------------------------------------
# phase 7: speculative decode (slice 2)


def spec_decoder(tree, dtree, dcfg, **kw):
    return TransformerDecoder(tree, CFG, n_slots=N_SLOTS, max_len=MAX_LEN,
                              page_size=PAGE, draft_params=dtree,
                              draft_cfg=dcfg, spec_k=SPEC_K, **kw)


def first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def greedy_parity(params, payloads, replies, plain_replies, tag,
                  cfg=CFG, tie_gap=TIE_GAP) -> int:
    """The greedy requests' speculative tokens against a non-speculative
    decoder's. A divergence passes only where that decoder's top-2 logit
    gap at the first differing position is below ``tie_gap`` (a near tie
    that reassociated sums may flip); returns the number of such
    ties."""
    ties = 0
    for i, (p, r, ref) in enumerate(zip(payloads, replies, plain_replies)):
        if "temperature" in p:
            continue
        at = first_divergence(r["tokens"], ref["tokens"])
        if at is None:
            continue
        ctx = torch.tensor([p["prompt"] + ref["tokens"][:at]], device=DEV)
        top2 = torch.topk(T.reference_logits(params, ctx, cfg)[0, -1], 2)
        gap = float(top2.values[0] - top2.values[1])
        print(f"{tag} request {i}: diverges from the non-speculative "
              f"tokens at token {at}; top-2 logit gap there {gap:.3e}")
        check(gap < tie_gap, f"{tag} request {i} diverges at token {at} "
                             f"with a top-2 gap of {gap:.3e}")
        ties += 1
    return ties


def draft_agreement(payloads, scales) -> dict:
    """Teacher-forced greedy agreement of the truncated draft with its
    target over every position of pass 1's prompts (full-context
    forwards, no cache), for each ``resid_scale`` of
    ``make_spec_model_pair``: the per-token rate a speculative round's
    acceptance follows."""
    out = {}
    for scale in scales:
        tree, dtree, dcfg = make_spec_model_pair(
            CFG, draft_layers=DRAFT_LAYERS, resid_scale=scale, seed=SEED)
        memo = {}
        target = T.params_from_jax(tree, DEV, memo)
        draft = T.params_from_jax(dtree, DEV, memo)
        same = total = 0
        for p in payloads:
            ctx = torch.tensor([p["prompt"]], device=DEV)
            a = T.reference_logits(target, ctx, CFG)[0].argmax(-1)
            b = T.reference_logits(draft, ctx, dcfg)[0].argmax(-1)
            same += int((a == b).sum().item())
            total += a.numel()
        out[scale] = same / total
    print("draft-target greedy agreement by resid_scale (teacher-forced, "
          f"{DRAFT_LAYERS} of {CFG.n_layers} layers): "
          + ", ".join(f"{s}: {a:.4f}" for s, a in out.items()))
    return out


def speculative_payloads(payloads):
    """Pass 1's payloads with the sampled one opting in to speculation."""
    out = [dict(p) for p in payloads]
    out[5]["speculative"] = True
    return out


def spec_path(tree, dtree, dcfg, payloads, card_line):
    """Serve pass 1's payloads twice through a speculative decoder, cold
    then through the prefix cache, with every kernel's count read around
    exactly this run."""
    dec = spec_decoder(tree, dtree, dcfg)
    check(dec.attn_impl == "cuda" and dec.verify_ce_impl == "cuda",
          f"speculative decoder resolved to {dec.attn_impl}/"
          f"{dec.verify_ce_impl}")
    dec.warmup()
    sched = DecodeScheduler(dec, max_new_tokens_default=MAX_NEW).start()
    ptrs = [t.data_ptr() for t in (*dec.cache.values(),
                                   *dec.draft_cache.values())]
    spec_payloads = speculative_payloads(payloads)
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        r1, wall1 = serve(sched, spec_payloads, "spec1")
        hits_1 = sched.prefix.stats()["hits"]
        r2, wall2 = serve(sched, spec_payloads, "spec2")
        torch.cuda.synchronize()
        launches = read_launch_counts()
        stats = sched.stats()
    finally:
        sched.stop()
    spec, pstats = stats["speculative"], stats["prefix_cache"]
    print(f"speculative: {stats['n_requests']} requests, {spec['rounds']} "
          f"rounds, {stats['n_steps']} plain steps, {stats['n_prefills']} "
          f"prefills ({pstats['hits']} prefix hits); launches {launches}")
    check(stats["n_step_faults"] == 0, "a speculative round faulted")
    check(spec["rounds"] > 0, "no speculative round ran")
    check(hits_1 == 0 and pstats["hits"] > 0,
          f"prefix hits: {hits_1} in pass 1, {pstats['hits']} in all")
    check_launches(launches, spec_launches(stats, dcfg), "speculative path")
    for name in ("flash_prefill_attention", "paged_prefix_prefill_attention",
                 "fused_softmax_xent"):
        check(launches[name] > 0, f"{name} never launched")
    check(ledger_clean(sched), "page ledger not clean at idle")
    check([t.data_ptr() for t in (*dec.cache.values(),
                                  *dec.draft_cache.values())] == ptrs,
          "the KV pool or the draft pool moved")
    metrics = {"spec_pass1_tokens_per_s":
               sum(r["n_tokens"] for r in r1) / wall1,
               "spec_pass2_tokens_per_s":
               sum(r["n_tokens"] for r in r2) / wall2,
               "spec_rounds": spec["rounds"],
               "spec_plain_steps": stats["n_steps"],
               "acceptance_rate": spec["acceptance_rate"],
               "proposal_logp_ewma": spec["proposal_logp_ewma"]}
    print(f"[{card_line}] speculative acceptance rate "
          f"{spec['acceptance_rate']} ({spec['accepted']}/"
          f"{spec['proposed']}), proposal log-prob EWMA "
          f"{spec['proposal_logp_ewma']}")
    print(f"[{card_line}] speculative decode tokens/s, 8 requests x "
          f"{MAX_NEW} tokens: pass 1 (cold prefills) "
          f"{metrics['spec_pass1_tokens_per_s']:.1f}, pass 2 (prefix hits) "
          f"{metrics['spec_pass2_tokens_per_s']:.1f}")
    return r1, r2, launches, metrics


def plain_replies(tree, payloads):
    """Pass 1 through a non-speculative decoder over the same tree."""
    dec = TransformerDecoder(tree, CFG, n_slots=N_SLOTS, max_len=MAX_LEN,
                             page_size=PAGE)
    sched = DecodeScheduler(dec, max_new_tokens_default=MAX_NEW).start()
    try:
        replies, _ = serve(sched, payloads, "plain")
    finally:
        sched.stop()
    return dec.params, replies


def verify_parity(tree, dtree, dcfg, payloads, replies, rounds=4) -> float:
    """Teacher-force ``rounds`` verify rounds (the served tokens as the
    proposals) through a ``verify_ce_impl="cuda"`` and a ``"dense"``
    decoder: logits and scores must agree within ENGINE_TOL."""
    decs = [spec_decoder(tree, dtree, dcfg, verify_ce_impl=impl)
            for impl in ("cuda", "dense")]
    tables = 1 + np.arange(N_SLOTS * PPS, dtype=np.int32).reshape(
        N_SLOTS, PPS)
    lens = np.array([len(p["prompt"]) for p in payloads], np.int32)
    for i, p in enumerate(payloads):
        for dec in decs:
            dec.prefill_logits(i, np.asarray(p["prompt"], np.int32),
                               tables[i])
    worst = {"logits": 0.0, "scores": 0.0}
    for r in range(rounds):
        toks = np.array([rep["tokens"][r * SPEC_K:(r + 1) * SPEC_K]
                         for rep in replies], np.int32)
        outs = [dec.verify_logits(toks, lens + r * SPEC_K, tables)
                for dec in decs]
        (g0, l0, s0), (g1, l1, s1) = outs
        check(torch.isfinite(l0).all().item() and np.isfinite(s0).all(),
              "non-finite verify output")
        worst["logits"] = max(worst["logits"],
                              float((l0 - l1).abs().max().item()))
        worst["scores"] = max(worst["scores"], float(np.abs(s0 - s1).max()))
    print(f"verify engines cuda (K4) vs dense, {rounds} teacher-forced "
          f"rounds x {N_SLOTS} slots x width {SPEC_K}: max |logit diff| "
          f"{worst['logits']:.3e}, max |score diff| {worst['scores']:.3e} "
          f"(tolerance {ENGINE_TOL})")
    check(max(worst.values()) <= ENGINE_TOL,
          f"verify engines disagree: {worst}")
    return max(worst.values())


def spec_round_profile(tree, dtree, dcfg, payloads, card_line) -> dict:
    """One speculative round as the scheduler runs it, 8 slots at the
    step profile's positions: propose, then verify."""
    dec = spec_decoder(tree, dtree, dcfg)
    tables = 1 + np.arange(N_SLOTS * PPS, dtype=np.int32).reshape(
        N_SLOTS, PPS)
    pos = profile_positions(payloads)
    toks = np.ones(N_SLOTS, np.int32)

    def round_():
        props = dec.propose(toks, pos)
        ver_in = np.concatenate([toks[:, None], props[:, :SPEC_K - 1]],
                                axis=1).astype(np.int32)
        dec.verify_logits(ver_in, pos, tables)

    got = device_profile(round_, 8, f"speculative round (propose + verify, "
                         f"8 slots, pos ~{int(pos.mean())})", card_line)
    return {"spec_round_wall_ms": got["wall_ms"],
            "spec_round_device_ms": got["device_ms"],
            "spec_round_top": got["top"]}


# ---------------------------------------------------------------------------
# phases 10 and 11: the train step (slice 3)


def train_state(cfg):
    params = T.params_from_jax(T.init_params_np(cfg, seed=SEED), DEV)
    return params, T.init_velocity(params)


def train_parity() -> dict:
    """3 f32 steps at the bench width, B 2 x S 1024: the kernel engines
    (folded attention, fused CE) against the dense ones, step by step."""
    cfg = dataclasses.replace(CFG, dtype="float32")
    batch = T.make_batch(np.random.default_rng(SEED), cfg, 2, TRAIN_S, DEV)
    runs = {}
    for attn, ce in (("folded", "cuda"), ("dense", "dense")):
        c = dataclasses.replace(cfg, attention_impl=attn, ce_impl=ce)
        params, vel = train_state(c)
        step = T.build_train_step(c, TRAIN_LR, TRAIN_MOMENTUM)
        torch.cuda.synchronize()
        reset_launch_counts()
        losses = [float(step(params, vel, *batch)[2]) for _ in range(3)]
        runs[attn] = (losses, params, read_launch_counts())
        torch.cuda.empty_cache()
    # the kernel engines' 3 f32 steps launch the train kernels' f32 routes
    # (K7's f32 kernels, K4's training variant and K6 in 3xTF32) per step
    # as the bf16 path does, and the dense engines launch none
    launches = runs["folded"][2]
    print(f"train parity, kernel engines, 3 f32 steps: launches {launches}")
    for name, per_step in TRAIN_LAUNCHES.items():
        check(launches[name] == 3 * per_step,
              f"{name}: {launches[name]} launches in the f32 parity steps, "
              f"expected {3 * per_step}")
    check(not any(runs["dense"][2].values()),
          f"the dense engines launched kernels: {runs['dense'][2]}")
    (lk, pk, _), (ld, pd, _) = runs["folded"], runs["dense"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, ld))
    leaf = max(float((a - b).abs().max().item())
               for a, b in zip(T._leaves(pk), T._leaves(pd)))
    print(f"train engines folded/cuda vs dense/dense, f32, B=2 S={TRAIN_S}, "
          f"3 steps: losses {lk} vs {ld} (max rel diff {loss_rel:.3e}), "
          f"max |param diff| after step 3 {leaf:.3e} (tolerance 1e-4)")
    check(all(np.isfinite(lk + ld)), "non-finite parity loss")
    check(loss_rel <= 1e-4, f"train losses disagree: {loss_rel:.3e}")
    check(leaf <= 1e-4, f"train params disagree: {leaf:.3e}")
    return ({"train_parity_loss_rel": loss_rel, "train_parity_param": leaf},
            launches)


def train_flops_per_step(cfg) -> float:
    """bench.py's analytic train FLOPs (_transformer_train_bench): 6 x
    matmul params x tokens + 12 x L x b x s^2 x d_attn."""
    d_attn = cfg.n_heads * cfg.d_head
    n_matmul = (cfg.d_model * cfg.vocab
                + cfg.n_layers * (4 * cfg.d_model * d_attn
                                  + 2 * cfg.d_model * cfg.d_ff))
    return (6.0 * n_matmul * TRAIN_B * TRAIN_S
            + 12.0 * cfg.n_layers * TRAIN_B * TRAIN_S * TRAIN_S * d_attn)


def timed_steps(step, params, vel, batch, n):
    """``n`` steps after one warm step: the losses (host floats, read at
    the end) and the wall ms per step."""
    losses = [step(params, vel, *batch)[2]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n - 1):
        losses.append(step(params, vel, *batch)[2])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
    return [float(x) for x in losses], ms


def train_path(card_line):
    """The bench config through build_train_step with the auto engines,
    20 steps on one batch, launch counts read around exactly these
    steps; then its profile and the dense engines' rate."""
    cfg = TRAIN_CFG
    n_tok = TRAIN_B * TRAIN_S
    engines = (T.attention_engine(cfg, TRAIN_S, DEV),
               T.train_ce_engine(cfg, n_tok, DEV))
    check(engines == ("folded", "cuda"), f"auto engines resolved to "
                                         f"{engines}")
    batch = T.make_batch(np.random.default_rng(SEED), cfg, TRAIN_B, TRAIN_S,
                         DEV)
    params, vel = train_state(cfg)
    ptrs = [t.data_ptr() for t in T._leaves(params) + T._leaves(vel)]
    step = T.build_train_step(cfg, TRAIN_LR, TRAIN_MOMENTUM)
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, ms = timed_steps(step, params, vel, batch, TRAIN_STEPS)
    launches = read_launch_counts()
    print(f"train: {TRAIN_STEPS} steps, losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; launches {launches}")
    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check([t.data_ptr() for t in T._leaves(params) + T._leaves(vel)]
          == ptrs, "params or velocity moved")
    for name, per_step in TRAIN_LAUNCHES.items():
        check(launches[name] == per_step * TRAIN_STEPS,
              f"{name}: {launches[name]} launches, expected "
              f"{per_step * TRAIN_STEPS}")
    flops = train_flops_per_step(cfg)
    tflops = flops / (ms / 1e3) / 1e12
    prof = device_profile(lambda: step(params, vel, *batch), 3,
                          f"train step (bf16, B={TRAIN_B} S={TRAIN_S})",
                          card_line,
                          pick=K7_WGMMA + CE_WGMMA + ("ce_merge_kernel",))
    del params, vel
    torch.cuda.empty_cache()
    # the other engine pairs (attention/CE), 4 steps each: dense/dense
    # against the kernels; folded/dense and dense/auto part the attention
    # engine's gap from the CE engines'
    engine_ms = {"auto/auto": ms}
    for attn, ce in (("dense", "dense"), ("folded", "dense"),
                     ("dense", "auto")):
        ecfg = dataclasses.replace(cfg, attention_impl=attn, ce_impl=ce)
        eparams, evel = train_state(ecfg)
        estep = T.build_train_step(ecfg, TRAIN_LR, TRAIN_MOMENTUM)
        elosses, engine_ms[f"{attn}/{ce}"] = timed_steps(
            estep, eparams, evel, batch, 4)
        check(all(np.isfinite(elosses)),
              f"non-finite {attn}/{ce} loss: {elosses}")
        del eparams, evel
        torch.cuda.empty_cache()
    dense_ms = engine_ms["dense/dense"]
    metrics = {
        "train_losses": losses, "train_ms_per_step": ms,
        "train_tokens_per_s": n_tok / (ms / 1e3),
        "train_flops_per_step": flops, "train_achieved_tflops": tflops,
        "train_mfu": tflops * 1e12 / PEAK_BF16_FLOPS,
        "train_device_busy_ms": prof["device_ms"],
        "train_profile_wall_ms": prof["wall_ms"],
        "train_top": prof["top"],
        "train_k7_device_ms": {k: prof["picked"][k] for k in K7_WGMMA},
        "train_ce_device_ms": {k: v for k, v in prof["picked"].items()
                               if k not in K7_WGMMA},
        "dense_train_ms_per_step": dense_ms,
        "dense_train_tokens_per_s": n_tok / (dense_ms / 1e3),
        "engine_ms_per_step": engine_ms,
        "engine_tokens_per_s": {k: n_tok / (v / 1e3)
                                for k, v in engine_ms.items()},
        "auto_minus_folded_dense_ms": ms - engine_ms["folded/dense"]}
    print(f"[{card_line}] train step (bf16, B={TRAIN_B} S={TRAIN_S}, "
          f"folded/cuda): {ms:.2f} ms/step, "
          f"{metrics['train_tokens_per_s']:.1f} tokens/s, "
          f"{flops / 1e12:.3f} TFLOP/step (analytic), {tflops:.2f} TFLOP/s, "
          f"MFU {metrics['train_mfu']:.4f} (bf16 peak 989 TFLOP/s); "
          f"dense/dense {dense_ms:.2f} ms/step, "
          f"{metrics['dense_train_tokens_per_s']:.1f} tokens/s")
    print(f"[{card_line}] train step by engines (attention/CE), ms/step: "
          + ", ".join(f"{k} {v:.2f}" for k, v in engine_ms.items())
          + f"; auto/auto - folded/dense "
            f"{metrics['auto_minus_folded_dense_ms']:+.2f} ms (the fused "
            f"CE's cost over the dense loss)")
    return launches, metrics


# ---------------------------------------------------------------------------
# phases 12-14: GBDT (slice 4)


# K9 against its plain version: (rows, features, bins), each at three
# in-leaf densities (0.7, none, one row)
HIST_SHAPES = [(777, 11, 37), (4096, 100, 255), (32768, 14, 255),
               (1 << 20, 28, 255)]
# K9 must equal its plain version bit for bit (int64 fixed point: exact
# sums), and every card fit of an unsampled config the CPU fit: every
# iteration's trees, leaf values and predictions (same_trees)
# final train metric, card fit against CPU fit: AUC within 1e-3; the
# pinball loss within 1e-2 relative (the limits from before the fits were
# exact, when ties parted them: the JAX package and the port on the CPU,
# the same config, differ by 5.5e-3,
# tests/test_torch_gbdt_model.py::test_tie_broken_quantile_fits_spread).
# Equal fits meet them with a gap of 0.
GBDT_METRIC_TOL = {"gbdt_quantile": 1e-2, "gbdt_adult": 1e-3}
GBDT_PREDICT_TOL = 0.0     # card predict vs the same booster's CPU predict
#: 5 iterations a fit (once 10: cut for the script's time limit)
HIGGS_ROWS, HIGGS_FEATURES, HIGGS_ITERS = 1 << 20, 28, 5


def hist_case(gen, n, f, b, density, layout="int32"):
    """K9's inputs: (n, f) bins in [0, b) laid out as ``layout`` (uint8
    as prepare_bins_t makes it for b <= 256 bins), grad, hess and an
    in-leaf mask at ``density`` (0.7, 1/8 ...: scattered rows; "one row")."""
    bins = torch.from_numpy(gen.integers(0, b, size=(n, f)).astype(np.int32))
    bins_t = CH.prepare_bins_t(bins, b if layout == "uint8" else None
                               ).to(DEV)
    check(bins_t.dtype == getattr(torch, layout), f"bins laid out as "
                                                  f"{bins_t.dtype}")
    grad = torch.from_numpy(gen.normal(size=n).astype(np.float32)).to(DEV)
    hess = torch.from_numpy(gen.uniform(0.1, 1, size=n).astype(np.float32)
                            ).to(DEV)
    if density == "one row":
        mask = torch.zeros(n, dtype=torch.bool)
        mask[n // 3] = True
    else:
        mask = torch.from_numpy(gen.uniform(size=n) < density)
    return bins_t, grad, hess, mask.to(DEV), f, b


def hist_errors(args) -> tuple:
    """(max |K9 - plain| in f32, K9 equal to the plain version on the
    card, equal to the plain version on the CPU, two launches equal), all
    in the fixed point of these gradients (``cuda_hist.fixed_scale``)."""
    bins_t, grad, hess, mask, f, b = args
    scale = CH.fixed_scale(grad, hess, grad.shape[0])
    k1 = CH.build_histogram_cuda(*args, scale)
    k2 = CH.build_histogram_cuda(*args, scale)
    torch.cuda.synchronize()
    check(k1.dtype == torch.int64 and k1.shape == (f, b, 3),
          f"K9 gave {k1.dtype} {tuple(k1.shape)}")
    plain = CH.build_histogram_plain(*args, scale)
    cpu = CH.build_histogram_plain(*(a.cpu() for a in args[:4]), f, b,
                                   scale.cpu())
    err = (CH.fixed_to_float(k1, scale) - CH.fixed_to_float(plain, scale)
           ).abs()
    return (float(err.max()), bool(torch.equal(k1, plain)),
            bool(torch.equal(k1.cpu(), cpu)), bool(torch.equal(k1, k2)))


#: K9's timed cases at the Higgs shape: (bin layout, in-leaf density). The
#: root (every row in the leaf) in the GBDT path's uint8 layout is the
#: record's headline; scattered leaves at 1/8 and 1/64, where most of a
#: fit's launches are; each in int32 beside it
HIST_TIMED = [(layout, density) for density in (1.0, 1 / 8, 1 / 64)
              for layout in ("uint8", "int32")]


def hist_timed(gen, layout, density, with_plain) -> dict:
    """One timed K9 case at the Higgs shape beside ``index_add_`` and its
    bytes bound: the function's bytes, the mask, the live rows' bins (the
    layout's bytes), grad and hess, and the output. The clusters' partials
    that the design writes and reads back are the design's cost, not the
    function's: reported apart (``partial_bytes``), not in the bound."""
    n, f, b = HIGGS_ROWS, HIGGS_FEATURES, 255
    args = hist_case(gen, n, f, b, density, layout)
    bins_t, grad, hess, mask = args[:4]
    scale = CH.fixed_scale(grad, hess, n)
    flat_idx = (bins_t.long() + torch.arange(f, device=DEV)[:, None] * b
                ).reshape(-1)
    m = mask.long()
    vals = torch.stack([CH.to_fixed(grad, scale[0]) * m,
                        CH.to_fixed(hess, scale[1]) * m, m], 1)[None].expand(
        f, -1, -1).reshape(-1, 3).contiguous()
    ms = time_ms(lambda: CH.build_histogram_cuda(*args, scale))
    plain_ms = (time_ms(lambda: CH.build_histogram_plain(*args, scale))
                if with_plain else None)
    lib_ms = time_ms(lambda: torch.zeros(
        f * b, 3, dtype=torch.int64, device=DEV).index_add_(0, flat_idx,
                                                            vals))
    plan = CH.plan_for(DEV, bins_t, f, b)
    rows = int(mask.sum())
    partials = plan.partial_bytes(f, b)
    # the scale's 16 bytes beside the int64 output cells
    nbytes = (n + rows * (f * bins_t.element_size() + 8)
              + f * b * CH.CELL_BYTES + 16)
    b_ms, b_by = bound(nbytes, 3 * rows * f)
    shape = (f"n={n} F={f} B={b} {layout}, "
             + ("every row in the leaf (a root histogram)" if density == 1.0
                else f"{rows} scattered rows in the leaf ({density:.4g})"))
    print(f"gbdt_histogram [{shape}]: kernel {ms:.4f} ms, "
          + (f"plain {plain_ms:.4f} ms, " if with_plain else "")
          + f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
          f"{nbytes / 1e6:.1f} MB; the design's partials {partials / 1e6:.2f}"
          f" MB more); "
          f"grid {plan}")
    del flat_idx, vals
    torch.cuda.empty_cache()
    return {"shape": shape, "layout": layout, "density": density,
            "rows_in_leaf": rows, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "partial_bytes": partials,
            "plan": dataclasses.asdict(plan)}


def histogram_phase() -> dict:
    """K9 against its plain version at the slice's shapes and densities in
    both bin layouts, bit for bit; timed at the Higgs shape's root
    histogram (every row in the leaf: the main path's largest) and at two
    scattered leaves, each in uint8 and int32 beside its byte bound and
    ``index_add_``."""
    gen = np.random.default_rng(SEED + 4)
    worst = 0.0
    for layout in ("uint8", "int32"):
        for n, f, b in HIST_SHAPES:
            for density in (0.7, 0.0, "one row"):
                err, equal, equal_cpu, same = hist_errors(hist_case(
                    gen, n, f, b, density, layout))
                print(f"K9 {layout} n={n} F={f} B={b} in-leaf {density}: "
                      f"max_abs_err {err:.3e}, equal to the plain version "
                      f"on the card {equal} and on the CPU {equal_cpu}, "
                      f"two launches equal {same}")
                where = f"{layout} n={n} F={f} B={b} in-leaf {density}"
                check(equal and equal_cpu,
                      f"K9 differs from its plain version at {where}")
                check(same, f"K9 not deterministic at {where}")
                worst = max(worst, err)
            torch.cuda.empty_cache()
    cases = [hist_timed(gen, layout, density, i == 0)
             for i, (layout, density) in enumerate(HIST_TIMED)]
    root = cases[0]
    return {"gbdt_histogram": {
        "name": "gbdt_histogram", "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/gbdt_histogram.cu",
        "replaces": "mmlspark_tpu/gbdt/pallas_hist.py:99",
        "launches": 0, "max_abs_err": worst, "ms": root["ms"],
        "plain_ms": root["plain_ms"], "bound_ms": root["bound_ms"],
        "bound_by": root["bound_by"], "library_ms": root["library_ms"],
        "shape": root["shape"], "cases": cases,
        "library": "torch.zeros(F*B, 3).index_add_(0, flat_idx, vals), "
                   "flat_idx and vals made outside the timing"}}


def quantile_cell():
    """bench.py's bench_gbdt_quantile (bench.py:156-177), exactly."""
    rng = np.random.default_rng(0)
    n, f = 4096, 100
    X = rng.normal(size=(n, f))
    y = X[:, :5].sum(axis=1) + 0.3 * rng.normal(size=n) + 5.0
    p = BoosterParams(objective="quantile", alpha=0.9, num_iterations=40,
                      num_leaves=15)
    return X, y, p, {}


#: the adult cell's iterations: bench.py's 100 cut to 50 for the
#: script's time limit (phases 13 and 29 fit it 8 times on the card and
#: once on the CPU, all host-bound)
ADULT_ITERS = 50


def adult_cell():
    """bench.py's bench_adult_census (bench.py:181-213) on one device, but
    ``ADULT_ITERS`` iterations."""
    rng = np.random.default_rng(0)
    n, f = 32768, 14
    X = rng.normal(size=(n, f))
    X[:, 10] = rng.integers(0, 16, n)   # categorical-ish columns
    X[:, 11] = rng.integers(0, 14, n)
    logit = X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] + 0.2 * (X[:, 10] > 8)
    y = (logit + rng.logistic(size=n) > 0).astype(np.float64)
    p = BoosterParams(objective="binary", num_iterations=ADULT_ITERS,
                      num_leaves=31)
    return X, y, p, {"categorical_features": [10, 11]}


def higgs_cell():
    """The width of LightGBM's GPU benchmark data set, Higgs: 28 dense
    numeric features, 255 leaves, learning rate 0.1, binary; rows cut
    from 10.5M to 2^20. Features are normal draws; the label is a
    logistic draw over a fixed combination of five features and one
    pairwise product."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(HIGGS_ROWS, HIGGS_FEATURES)).astype(np.float32)
    coef = rng.normal(size=5)
    logit = X[:, :5] @ coef + 0.8 * X[:, 5] * X[:, 6]
    y = (logit + rng.logistic(size=HIGGS_ROWS) > 0).astype(np.float64)
    p = BoosterParams(objective="binary", num_iterations=HIGGS_ITERS,
                      num_leaves=255, learning_rate=0.1)
    return X.astype(np.float64), y, p, {}


def _bodies(tree):
    """Each body's split in creation order (body j splits the parent of
    nodes 2j+1, 2j+2) and its gain."""
    parent = {int(tree.left[i]): i for i in range(tree.n_nodes)
              if tree.feature[i] >= 0}
    out = []
    for j in range((tree.n_nodes - 1) // 2):
        q = parent[2 * j + 1]
        out.append(((q, int(tree.feature[q]), int(tree.threshold_bin[q]),
                     bool(tree.missing_left[q]),
                     tuple(np.flatnonzero(tree.cat_mask[q]))),
                    float(tree.gain[q])))
    return out


#: the Tree arrays that ``same_trees`` holds equal
TREE_FIELDS = ("feature", "threshold", "threshold_bin", "missing_left",
               "categorical", "cat_mask", "left", "right", "value", "gain")


def same_trees(card_b, cpu_b, n_iters, labels=("card", "CPU"),
               X=None) -> dict:
    """The first ``n_iters`` iterations of a card fit against the CPU
    fit's (or any two fits, named by ``labels``), split by split: every
    tree array equal bit for bit (``TREE_FIELDS``: splits, thresholds,
    leaf values, gains), and with ``X`` both boosters' predictions. The
    record names the first split that differs (``first_part``) or the
    first iteration whose arrays differ; ``require_same`` fails on
    either."""
    out = {"equal_iters": n_iters}
    for it in range(n_iters):
        for k, (a, b) in enumerate(zip(card_b.trees[it], cpu_b.trees[it])):
            ba, bb = _bodies(a), _bodies(b)
            for j in range(max(len(ba), len(bb))):
                ka, ga = ba[j] if j < len(ba) else (None, 0.0)
                kb, gb = bb[j] if j < len(bb) else (None, 0.0)
                if ka != kb:
                    print(f"  split differs: iteration {it} output {k} "
                          f"body {j}: {labels[0]} {ka} gain {ga!r}, "
                          f"{labels[1]} {kb} gain {gb!r}")
                    out.update(equal_iters=it,
                               first_part={"iteration": it, "output": k,
                                           "body": j,
                                           "card": split_json(ka),
                                           "cpu": split_json(kb)})
                    return out
            differ = [f for f in TREE_FIELDS
                      if not np.array_equal(getattr(a, f), getattr(b, f))]
            if differ or a.n_nodes != b.n_nodes:
                print(f"  trees differ: iteration {it} output {k}: "
                      f"{differ or ['n_nodes']}")
                out.update(equal_iters=it, first_diff={
                    "iteration": it, "output": k, "fields": differ})
                return out
    if X is not None:
        pa, pb = card_b.predict(X), cpu_b.predict(X)
        out["predict_equal"] = bool(np.array_equal(pa, pb))
        out["predict_max_abs_diff"] = float(np.abs(pa - pb).max())
    return out


def require_same(same, what, n_iters) -> None:
    """Fail unless ``same_trees`` found every one of ``n_iters``
    iterations equal and, where it compared them, the predictions."""
    check(same["equal_iters"] == n_iters,
          f"{what}: trees equal through {same['equal_iters']} of {n_iters}"
          f" iterations ({same.get('first_part') or same.get('first_diff')})")
    check(same.get("predict_equal", True),
          f"{what}: predictions differ by up to "
          f"{same.get('predict_max_abs_diff')}")


def split_json(split):
    """A ``_bodies`` split key (node, feature, threshold bin, missing
    left, categorical bins) as JSON values; None stays None."""
    if split is None:
        return None
    q, f, thr, miss_left, cat = split
    return [q, f, thr, miss_left, [int(c) for c in cat]]


def parting_cause(b, X, y, part) -> dict:
    """Where a card fit and the CPU fit first part (``same_trees``'
    ``first_part``: the leaf both split at that body, on the card and on
    the CPU): that leaf's inputs rebuilt from card booster ``b``'s trees on
    each device, as ``grow_tree_device`` holds them (the root and each
    left child built by K9 or its plain version in the iteration's fixed
    point, each right child its parent's less its left sibling's), then
    each step of ``tree._gains`` compared bit for bit between the
    devices: the gradients, the histogram, its sum over bins, the
    cumulative sums and the gains. The first step that differs is where
    the fits part; the two chosen splits' gains on each device show
    what it moved. No feature mask (the bench configs sample no
    features). The raw scores are the trees' values summed as the fit
    sums them."""
    it, body = part["iteration"], part["body"]
    tree = b.trees[it][part["output"]]
    node = (part["card"] or part["cpu"])[0]
    bins = b.mapper.transform(X)
    n, F = bins.shape
    B = b.mapper.max_bins_total
    gp = b.params.growth()
    seen = members_by_node(tree, bins)
    raw = torch.full((n,), float(b.init_score[0]), dtype=torch.float32)
    for (t,) in b.trees[:it]:
        raw = raw + torch.from_numpy(t.value)[torch.from_numpy(np.argmax(
            members_by_node(t, bins) & (t.feature < 0)[:, None], axis=0))]
    parent = {int(c): i for i in range(tree.n_nodes) if tree.feature[i] >= 0
              for c in (tree.left[i], tree.right[i])}
    cats = (torch.tensor(b.mapper.categorical)
            if any(b.mapper.categorical) else None)
    steps = {}
    for side, dev in (("card", DEV), ("cpu", torch.device("cpu"))):
        bins_t = CH.prepare_bins_t(torch.from_numpy(bins), B).to(dev)
        g, h = b.obj.grad_hess(raw.to(dev), torch.tensor(
            y, dtype=torch.float32, device=dev), torch.ones(n, device=dev))
        scale = CH.fixed_scale(g, h, n)

        def hist(q):
            if q == 0 or q % 2:
                return CH.build_histogram_cuda(bins_t, g, h, torch.from_numpy(
                    seen[q]).to(dev), F, B, scale)
            return hist(parent[q]) - hist(q - 1)
        # the grower evaluates the root alone and each child beside its
        # sibling (left first)
        pair = ([node] if node == 0 else
                [node, node + 1] if node % 2 else [node - 1, node])
        hs = torch.stack([hist(q) for q in pair])
        first = (torch.arange(B, device=dev) == 0)[:, None]
        both = torch.stack([hs, torch.where(first, 0, hs)], dim=1)
        gains = GT._gains(hs, scale, None if cats is None else cats.to(dev),
                          gp)[0]
        steps[side] = {
            "gradients": torch.stack([g, h]), "histogram": hs,
            "sum over bins": torch.sum(hs, dim=2),
            "cumulative sums": torch.cumsum(both, dim=3), "gains": gains}
    card, cpu = steps["card"], steps["cpu"]
    equal = {k: bool(torch.equal(card[k].cpu(), cpu[k])) for k in card}
    differs = [k for k in card if not equal[k]]
    diff = {k: float((card[k].cpu() - cpu[k]).abs().max()) for k in differs
            if k != "gains"}
    at = pair.index(node)

    def gain_of(split, side):
        # a numeric split cuts at its threshold bin (bin order)
        _, f, thr, miss_left, cat = split
        return (None if cat else
                float(side["gains"][at, 0 if miss_left else 1, f, thr]))
    picks = {who: {"split": part[who], "gain_card": gain_of(part[who], card),
                   "gain_cpu": gain_of(part[who], cpu)}
             for who in ("card", "cpu") if part[who] is not None}
    out = {"iteration": it, "body": body, "node": node, "equal": equal,
           "first_difference": differs[0] if differs else None,
           "max_abs_difference": diff, "picks": picks}
    print(f"  where the fits part (iteration {it}, body {body}, node {node}):"
          f" equal on card and CPU: "
          + ", ".join(f"{k} {v}" for k, v in equal.items())
          + f"; first difference: {out['first_difference']}"
          + "".join(f"; {k} max |card - CPU| {v:.3e}"
                    for k, v in diff.items())
          + "".join(f"; the {who}'s split {p['split'][1:3]}: gain on the "
                    f"card {p['gain_card']!r}, on the CPU {p['gain_cpu']!r}"
                    for who, p in picks.items()))
    return out


def members_by_node(tree, bins) -> np.ndarray:
    """(n_nodes, n) bool: the rows that pass through each node, routed
    in bin space as the grower routes them."""
    n = bins.shape[0]
    rows = np.arange(n)
    node = np.zeros(n, np.int64)
    seen = np.zeros((tree.n_nodes, n), bool)
    width = tree.cat_mask.shape[1]
    for _ in range(tree.max_depth() + 1):
        seen[node, rows] = True
        f = np.maximum(tree.feature[node], 0)
        bv = bins[rows, f]
        num_left = np.where(bv == 0, tree.missing_left[node],
                            bv <= tree.threshold_bin[node])
        cat_left = tree.cat_mask[node, np.minimum(bv, width - 1)]
        go_left = np.where(tree.categorical[node], cat_left, num_left)
        nxt = np.where(go_left, tree.left[node], tree.right[node])
        node = np.where(tree.feature[node] < 0, node, nxt)
    return seen


def replay_on_cpu(b, X, y) -> dict:
    """Rebuild every split of card booster ``b``'s fit with the CPU's
    arithmetic (the plain histogram in each iteration's fixed point,
    split finding and leaf renewal of the port on CPU tensors), from the
    card's own earlier trees, as the fused loop grows them: each node's
    best split on the CPU must be the card's split (feature, threshold
    bin or categorical bins, missing side) with the same gain bit for
    bit, and each leaf value the CPU's times the learning rate, bit for
    bit. Holds the whole card fit."""
    p, gp = b.params, b.params.growth()
    bins = b.mapper.transform(X)
    bins_t = CH.prepare_bins_t(torch.from_numpy(bins))
    n, F = bins.shape
    B = b.mapper.max_bins_total
    cats = (torch.tensor(b.mapper.categorical)
            if any(b.mapper.categorical) else None)
    yt = torch.tensor(y, dtype=torch.float32)
    w = torch.ones(n)
    raw = torch.full((n,), float(b.init_score[0]), dtype=torch.float32)
    n_splits = n_leaves = 0

    def shrunk(v) -> float:
        # the loop's shrinkage: an f32 tensor times the rate
        return float((torch.as_tensor(v, dtype=torch.float32).reshape(1)
                      * p.learning_rate)[0])
    for it, (tree,) in enumerate(b.trees):
        g, h = b.obj.grad_hess(raw, yt, w)
        scale = CH.fixed_scale(g, h, n)
        seen = members_by_node(tree, bins)
        for q in range(tree.n_nodes):
            rows = torch.from_numpy(np.flatnonzero(seen[q]))
            hist = CH.build_histogram_plain(
                bins_t[:, rows].contiguous(), g[rows], h[rows],
                torch.ones(len(rows), dtype=torch.bool), F, B, scale)
            packed, order = (x[0] for x in GT.eval_leaves(
                hist[None], scale, cats, gp))
            packed = packed.numpy()
            where = f"iteration {it} node {q}"
            if tree.feature[q] < 0:
                if b.obj.renew_quantile is None:
                    n_leaves += 1
                    want = shrunk(packed[GT.EV_VALUE])
                    check(float(tree.value[q]) == want,
                          f"{where}: the card's leaf value "
                          f"{float(tree.value[q])!r}, the CPU's {want!r}")
                continue
            f = int(packed[GT.EV_FEATURE])
            cut = int(packed[GT.EV_CUT_POS])
            if tree.categorical[q]:
                cpu_split = (f, tuple(sorted(order[f][:cut + 1].tolist())))
                card_split = (int(tree.feature[q]),
                              tuple(np.flatnonzero(tree.cat_mask[q])))
            else:
                cpu_split = (f, int(packed[GT.EV_THRESHOLD_BIN]),
                             bool(packed[GT.EV_MISSING_LEFT]))
                card_split = (int(tree.feature[q]),
                              int(tree.threshold_bin[q]),
                              bool(tree.missing_left[q]))
            n_splits += 1
            check(card_split == cpu_split
                  and float(tree.gain[q]) == float(packed[GT.EV_GAIN]),
                  f"{where}: the card split {card_split} with gain "
                  f"{float(tree.gain[q])!r}, the CPU's best {cpu_split} "
                  f"with {float(packed[GT.EV_GAIN])!r}")
        leaf = torch.from_numpy(np.argmax(
            seen & (tree.feature < 0)[:, None], axis=0))
        if b.obj.renew_quantile is not None:
            rv, rc = GT.renew_leaf_values(leaf, yt - raw, w, torch.ones(
                n, dtype=torch.bool), tree.n_nodes, b.obj.renew_quantile)
            for q in np.flatnonzero((tree.feature < 0) & (rc.numpy() > 0)):
                n_leaves += 1
                want = shrunk(rv[q])
                check(float(tree.value[q]) == want,
                      f"iteration {it} node {q}: the card's renewed leaf "
                      f"value {float(tree.value[q])!r}, the CPU's {want!r}")
        raw = raw + torch.from_numpy(tree.value)[leaf]
    return {"replay_splits": n_splits, "replay_leaves": n_leaves}


def train_metric(name, booster, X, y) -> float:
    pred = booster.predict(X)
    if name == "gbdt_quantile":
        a, d = booster.params.alpha, y - pred
        return float(np.mean(np.where(d >= 0, a * d, (a - 1) * d)))
    from mmlspark_tpu_torch.gbdt.booster import eval_metric
    return eval_metric("auc", y, pred, booster.obj)[0]


def fit_counted(p, X, y, kw, expect) -> tuple:
    """One card fit with K9's launches read around it: exactly ``expect``."""
    before = CH.LAUNCHES["gbdt_histogram"]
    t0 = time.perf_counter()
    b = Booster.train(p, X, y, **kw)
    secs = time.perf_counter() - t0
    got = CH.LAUNCHES["gbdt_histogram"] - before
    check(got == expect, f"K9 launched {got} times in a fit, expected "
                         f"iterations x outputs x leaves = {expect}")
    return b, secs


#: each bench cell's card booster and median fit seconds (phase 13), for
#: phase 29's single-device baseline
CARD_FITS = {}


#: the timed fits after a GBDT cell's warm one (bench.py's
#: ``_timed_passes`` takes 3, as this script once did: cut to 1 for its
#: time limit)
GBDT_TIMED_FITS = 1


def bench_cell(name, cell, card_line) -> dict:
    """A bench config on the card against the same fit on the CPU: fit
    seconds after a warm fit, the median of ``GBDT_TIMED_FITS`` (bench.py
    takes 3)."""
    X, y, p, kw = cell()
    per_fit = p.num_iterations * 1 * p.num_leaves
    card, _ = fit_counted(p, X, y, kw, per_fit)
    secs = [fit_counted(p, X, y, kw, per_fit)[1]
            for _ in range(GBDT_TIMED_FITS)]
    t0 = time.perf_counter()
    cpu = Booster.train(p, X, y, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    same = same_trees(card, cpu, p.num_iterations, X=X)
    if "first_part" in same:
        # its K9 launches compare the card with the CPU: not the path's
        counted = CH.LAUNCHES["gbdt_histogram"]
        same["parting"] = parting_cause(card, X, y, same["first_part"])
        CH.LAUNCHES["gbdt_histogram"] = counted
    require_same(same, f"{name}: card against CPU", p.num_iterations)
    replay = replay_on_cpu(card, X, y)
    m_card, m_cpu = (train_metric(name, card, X, y),
                     train_metric(name, cpu, X, y))
    rel = abs(m_card - m_cpu) / (1.0 if name == "gbdt_adult" else abs(m_cpu))
    check(rel <= GBDT_METRIC_TOL[name], f"{name}: train metric {m_card} on "
                                        f"the card, {m_cpu} on the CPU")
    as_cpu = Booster.from_string(card.model_to_string(), device="cpu")
    pdiff = float(np.abs(card.predict(X) - as_cpu.predict(X)).max())
    check(pdiff <= GBDT_PREDICT_TOL, f"{name}: card predict differs from "
                                     f"its CPU predict by {pdiff}")
    out = {"fit_s_median": float(np.median(secs)), "fit_s_best": min(secs),
           "fits_on_card": 1 + len(secs),
           "cpu_fit_s": cpu_s, "train_metric_card": m_card,
           "train_metric_cpu": m_cpu, "metric_diff": rel,
           "predict_card_vs_cpu": pdiff, "k9_launches_per_fit": per_fit,
           **same, **replay}
    CARD_FITS[name] = (card, out["fit_s_median"])
    print(f"[{card_line}] {name}: fit {out['fit_s_median']:.3f} s median of "
          f"{GBDT_TIMED_FITS} (best {out['fit_s_best']:.3f}), CPU "
          f"{cpu_s:.2f} s; "
          f"train {'pinball' if name == 'gbdt_quantile' else 'AUC'} card "
          f"{m_card:.6f} CPU {m_cpu:.6f}; all {same['equal_iters']} "
          f"iterations' trees and the predictions equal bit for bit; CPU "
          f"replay: {replay['replay_splits']} splits and "
          f"{replay['replay_leaves']} leaf values the CPU's bit for bit; "
          f"predict card vs CPU {pdiff:.2e}; "
          f"K9 {per_fit} launches per fit")
    return out


def logloss_by_iteration(b, X, y) -> list:
    out = []
    for i in range(1, b.num_total_iterations + 1):
        p = np.clip(b.predict(X, num_iteration=i).astype(np.float64),
                    1e-15, 1 - 1e-15)
        out.append(float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p))))
    return out


def boost_inputs(b, X, y):
    """The fused loop's inputs for a fit of ``b``'s config on X, y, bins
    laid out as ``Booster.train`` lays them out (uint8 at <= 256 bins)."""
    bins_t = CH.prepare_bins_t(torch.from_numpy(b.mapper.transform(X)),
                               b.mapper.max_bins_total).to(DEV)
    n = len(y)
    raw = torch.full((n, 1), float(b.init_score[0]), device=DEV)
    return (bins_t, torch.tensor(y, dtype=torch.float32, device=DEV),
            torch.ones(n, device=DEV),
            torch.ones(n, dtype=torch.bool, device=DEV), raw,
            b.obj.grad_hess)


def run_loop(b, inputs, iters) -> None:
    """``iters`` iterations of the fused loop on ``inputs``, read back
    once, as ``Booster.train`` runs them."""
    p = b.params
    cats = (torch.tensor(b.mapper.categorical, device=DEV)
            if any(b.mapper.categorical) else None)
    before = CH.LAUNCHES["gbdt_histogram"]
    _, stacked = GT.boost_loop_device(
        *inputs, iters, 1, p.growth(), cats, None, b.mapper.n_features,
        b.mapper.max_bins_total, p.learning_rate, None)
    GT.to_host(stacked)
    check(CH.LAUNCHES["gbdt_histogram"] - before == iters * p.num_leaves,
          "K9 launches of the fused loop")


def higgs_phase(card_line) -> dict:
    """The Higgs-shape cell: a warm 2-iteration fit, then two
    ``HIGGS_ITERS``-iteration fits that must give identical trees, a falling train loss, the fused
    loop timed alone for seconds per iteration, and a profile of one
    iteration."""
    X, y, p, _ = higgs_cell()
    L = p.num_leaves
    fit_counted(dataclasses.replace(p, num_iterations=2), X, y, {}, 2 * L)
    b1, s1 = fit_counted(p, X, y, {}, HIGGS_ITERS * L)
    b2, s2 = fit_counted(p, X, y, {}, HIGGS_ITERS * L)
    check(b1.model_to_string() == b2.model_to_string(),
          "two Higgs-shape fits gave different trees")
    losses = logloss_by_iteration(b1, X, y)
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"the Higgs-shape train loss did not fall every iteration: "
          f"{losses}")
    inputs = boost_inputs(b1, X, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_loop(b1, inputs, HIGGS_ITERS)
    loop_s = time.perf_counter() - t0
    metrics = {"fit_s": [s1, s2], "loop_s": loop_s,
               "s_per_iteration": loop_s / HIGGS_ITERS,
               "rows_iters_per_s": HIGGS_ROWS * HIGGS_ITERS / loop_s,
               "train_logloss": losses, "identical_trees": True,
               "leaves_per_tree": [t[0].n_nodes // 2 + 1 for t in b1.trees]}
    print(f"[{card_line}] gbdt_higgs_shape ({HIGGS_ROWS} x "
          f"{HIGGS_FEATURES}, {p.num_leaves} leaves): "
          f"fit {s1:.2f} / {s2:.2f} s (binning included), boosting loop "
          f"{metrics['s_per_iteration']:.3f} s/iteration = "
          f"{metrics['rows_iters_per_s']:.4g} rows x iterations/s; logloss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; two fits identical")
    return metrics, inputs, b1


def higgs_profile(b, inputs, card_line) -> dict:
    """One boosting iteration under torch.profiler: device busy share,
    K9's share of device time, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_loop(b, inputs, 1)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    dev_ms = sum(ms for _, ms, _ in rows)
    k9_ms = sum(ms for k, ms, _ in rows if "hist_" in k)
    rows.sort(key=lambda r: -r[1])
    print(f"[{card_line}] one Higgs-shape iteration: wall {wall_ms:.1f} ms, "
          f"device busy {dev_ms:.1f} ms ({100 * dev_ms / wall_ms:.1f}% of "
          f"wall); K9 {k9_ms:.2f} ms of device time per Higgs iteration "
          f"({100 * k9_ms / max(dev_ms, 1e-9):.1f}% of the device time, "
          f"{100 * k9_ms / wall_ms:.1f}% of wall; bins "
          f"{inputs[0].dtype})")
    for key, ms, count in rows[:10]:
        print(f"  {ms:8.3f} ms  x{count:<5d} {key[:90]}")
    return {"iteration_wall_ms": wall_ms, "device_ms": dev_ms,
            "k9_ms": k9_ms, "top": [(k[:60], ms) for k, ms, _ in rows[:6]]}


def gbdt_path(card_line):
    """The GBDT cells through Booster.train on the card, K9's launches
    counted around all of their fits."""
    torch.cuda.synchronize()
    reset_launch_counts()
    metrics = {"gbdt_quantile": bench_cell("gbdt_quantile", quantile_cell,
                                           card_line),
               "gbdt_adult": bench_cell("gbdt_adult", adult_cell,
                                        card_line)}
    higgs, inputs, b = higgs_phase(card_line)
    launches = read_launch_counts()
    expect = sum(m["fits_on_card"] * m["k9_launches_per_fit"]
                 for m in metrics.values())
    expect += (2 + 3 * HIGGS_ITERS) * b.params.num_leaves
    check(launches["gbdt_histogram"] == expect,
          f"K9 launched {launches['gbdt_histogram']} times on the GBDT "
          f"path, expected {expect}")
    for name in launches:
        if name != "gbdt_histogram":
            check(launches[name] == 0, f"{name} launched on the GBDT path")
    higgs.update(higgs_profile(b, inputs, card_line))
    metrics["gbdt_higgs_shape"] = higgs
    return launches, metrics


# ---------------------------------------------------------------------------
# phases 15-17: the sequence-parallel train step (slice 5)

# K8 against its plain version: (B, S_local) x 8 heads x 64. (8, 1024) is
# the ring's launch on a hosted {"seq": 4} mesh at B 2: four ranks' rows
# in one launch, each row with its rank's positions.
RING_SHAPES = [(1, 1), (1, 17), (2, 128), (1, 384), (2, 1024), (8, 1024),
               (1, 4096)]
# Beyond the ring's own blocks, (B, Sq, Sk, Dh) x 8 heads with their
# (case, causal) pairs: Sq != Sk both ways, and Dh 16 and 36 (36: rows not
# 16-byte aligned, staged by element loads on the bf16 route)
K8_EXTRA = [((2, 1024, 384, 64), (("diagonal", True), ("shuffled", True),
                                  ("shuffled", False))),
            ((2, 384, 1024, 64), (("diagonal", True), ("shuffled", True))),
            ((2, 1024, 1024, 16), (("diagonal", True), ("shuffled", True),
                                   ("none", True))),
            ((2, 1024, 1024, 36), (("diagonal", True), ("shuffled", True),
                                   ("padded", False)))]
RING_N = 4
# bench.py's transformer_train_long_v1 (bench.py:1170-1180 over
# _transformer_train_bench): the bench width in bf16 at B 2 x S 4096
RING_B, RING_S, RING_STEPS = 2, 4096, 10
# K8's bf16 limits on the scaled error (see RMS_FLOOR), set as BF16_LIMITS
# were: about 4x the largest readings of the first H100 run (PERF.md,
# section 6), forward 2.49e-2 (S = 4096; o unnormalized, p rounded
# against a 32-key running max), dq 5.9e-3, dk/dv 1.17e-2. The tensor-core
# kernels (64-key tiles) read at most 2.0e-2, 9.2e-3 and 2.2e-2 (the
# padded case) in their first H100 run
K8_BF16_LIMITS = {"ring_block_fwd": 0.1, "ring_block_bwd_dq": 0.025,
                  "ring_block_bwd_dkdv": 0.05}
K8_SOURCES = {"ring_block_fwd": "parallel/pallas_attention.py:831",
              "ring_block_bwd_dq": "parallel/pallas_attention.py:971",
              "ring_block_bwd_dkdv": "parallel/pallas_attention.py:987"}
#: per train step on the hosted {"seq": 4} mesh: the ranks of a ring step
#: share one launch, so each K8 kernel runs once per layer and ring step
RING_LAUNCHES = {**{n: CFG.n_layers * RING_N for n in K8_SOURCES},
                 "fused_softmax_xent_train": 1, "fused_ce_dh": 1,
                 "fused_ce_dw": 1}
LIBRARY_CALL.update({
    "ring_block_fwd": "scaled_dot_product_attention with a boolean "
                      "attn_mask from the positions, bf16 (the normalized "
                      "output)",
    "ring_block_bwd_dq": "the backward of that masked "
                         "scaled_dot_product_attention alone (dq, dk and dv "
                         "together)",
    "ring_block_bwd_dkdv": "the backward of that masked "
                           "scaled_dot_product_attention alone (dq, dk and "
                           "dv together)",
    "ring_block_fwd_f32": "scaled_dot_product_attention with a boolean "
                          "attn_mask from the positions, f32 (the normalized "
                          "output)",
    "ring_block_bwd_dq_f32": "the backward of that masked f32 "
                             "scaled_dot_product_attention alone (dq, dk and "
                             "dv together)",
    "ring_block_bwd_dkdv_f32": "the backward of that masked f32 "
                               "scaled_dot_product_attention alone (dq, dk "
                               "and dv together)"})


def ring_positions(b, s, case, sk=None):
    """``(q_pos [b, s], k_pos [b, sk])`` int32 (sk defaults to s) for a
    visibility case: the block pair of ring neighbours (``diagonal``,
    ``full``: keys one block earlier, ``none``: one block later),
    ``padded`` (the last third of the keys the pad sentinel), ``all
    padded`` (every key), ``shuffled`` (each row's diagonal key positions
    in a seeded permutation, an eighth of the keys the pad sentinel at
    seeded rows, inside tiles), or ``ring t`` (b = RING_N x rows: rank
    r's rows at ring step t, keys from rank (r - t) mod RING_N). With
    sk != s the diagonal keys start (s - sk) // 2 into the queries'
    positions."""
    sk = s if sk is None else sk
    ar, ark = (torch.arange(n, dtype=torch.int32) for n in (s, sk))
    if case.startswith("ring"):
        t, per = int(case.split()[1]), b // RING_N
        rank = torch.arange(RING_N, dtype=torch.int32).repeat_interleave(per)
        q_pos = rank[:, None] * s + ar
        k_pos = ((rank - t) % RING_N)[:, None] * s + ar
    else:
        mid = (s - sk) // 2
        qo, ko = {"full": (sk, 0), "none": (0, s)}.get(case, (0, mid))
        q_pos = (ar + qo).expand(b, -1).clone()
        k_pos = (ark + ko).expand(b, -1).clone()
        if case == "padded":
            k_pos[:, sk - sk // 3:] = CA.PAD_POS
        elif case == "all padded":
            k_pos[:] = CA.PAD_POS
        elif case == "shuffled":
            g = torch.Generator().manual_seed(SEED + 11)
            k_pos = torch.stack([row[torch.randperm(sk, generator=g)]
                                 for row in k_pos])
            k_pos[torch.rand(b, sk, generator=g) < 0.125] = CA.PAD_POS
    return q_pos.to(DEV), k_pos.to(DEV)


def ring_lse_delta(o, m, l, do):
    """The ring's saved lse (+1e30 where no key is visible) and delta over
    the f32 normalized output, from one block's partials."""
    l_safe = l.clamp(min=1e-30)
    lse = torch.where(l > 0, m + torch.log(l_safe), 1e30)
    out = o / l_safe.transpose(1, 2)[..., None]
    delta = (do.float() * out).sum(-1).transpose(1, 2).contiguous()
    return lse, delta


def k8_errors(gen, b, s, dtype, case, causal, sk=None, d=None,
              h=CFG.n_heads) -> dict:
    """K8's three kernels against their plain versions on the same
    inputs (Sk and Dh default to S and the bench's 64). The forward's m
    is compared on rows that see a key; a row that sees none must give
    l = 0, o = 0, m = -1e30 and dq = 0 exactly, and a launch in which no
    row sees a key also dk = dv = 0 exactly."""
    sk, d = s if sk is None else sk, CFG.d_head if d is None else d
    q, do = (rnd(gen, b, s, h, d).to(dtype) for _ in range(2))
    k, v = (rnd(gen, b, sk, h, d).to(dtype) for _ in range(2))
    q_pos, k_pos = ring_positions(b, s, case, sk)
    scale = d ** -0.5
    o, m, l = CA.ring_block_fwd(q, k, v, q_pos, k_pos, causal)
    torch.cuda.synchronize()
    ro, rm, rl = CA.ring_block_fwd_plain(q, k, v, q_pos, k_pos, causal,
                                         scale)
    dead = rl == 0
    check(bool((l[dead] == 0).all()) and bool((m[dead] == -1e30).all())
          and bool((o.transpose(1, 2)[dead] == 0).all()),
          f"K8 rows without a visible key are not exactly empty ({case})")
    errs = {"ring_block_fwd": worse(
        err_ratio(o, ro), err_ratio(l, rl),
        err_ratio(torch.where(dead, 0.0, m), torch.where(dead, 0.0, rm)))}
    lse, delta = ring_lse_delta(o, m, l, do)
    del ro, rm, rl
    args = (q, k, v, do, lse, delta, q_pos, k_pos, causal)
    dq = CA.ring_block_bwd_dq(*args)
    dk, dv = CA.ring_block_bwd_dkdv(*args)
    torch.cuda.synchronize()
    rq, rk, rv = CA.ring_block_bwd_plain(*args, scale)
    check(bool((dq.transpose(1, 2)[dead] == 0).all()),
          f"K8 dq rows without a visible key are not exactly 0 ({case})")
    if bool(dead.all()):
        check(not (dq.any() or dk.any() or dv.any()),
              f"K8 grads of a launch without a visible pair are not "
              f"exactly 0 ({case})")
    errs["ring_block_bwd_dq"] = err_ratio(dq, rq)
    errs["ring_block_bwd_dkdv"] = worse(err_ratio(dk, rk), err_ratio(dv, rv))
    return errs, int(dead.sum())


def k8_cases(b, s):
    """(case, causal) pairs at (B, S_local); ``none`` and ``all padded``
    are launches in which no row sees a key."""
    shuffled = [("shuffled", True), ("shuffled", False)]
    if (b, s) == (RING_N * 2, 1024):
        return [(f"ring {t}", True) for t in range(RING_N)] + [
            ("padded", True), ("padded", False)] + shuffled
    return [(c, True) for c in ("diagonal", "full", "none", "padded")] + [
        ("diagonal", False), ("padded", False),
        ("all padded", False)] + shuffled


def k8_timed_cases(gen, dt=torch.bfloat16) -> dict:
    """K8's kernels, their plain versions and the masked SDPA at B 2,
    S_local 1024, in ``dt``, for a full and a diagonal block: (case,
    name) -> (kernel, plain, library, bytes, FLOPs). In f32 two launches
    of each kernel must give the same bits, and the SDPA backend that
    serves the library call is printed."""
    esz = dt.itemsize
    b, s, h, d = 2, 1024, CFG.n_heads, CFG.d_head
    scale = d ** -0.5
    q, k, v, do = attn_inputs(gen, b, s, dt)
    qt, kt, vt, dot = sdpa_layout(q, k, v, do)
    elems, stats, pos_bytes = b * s * h * d, 4 * b * h * s, 2 * 4 * b * s
    cases = {}
    for case in ("full", "diagonal"):
        q_pos, k_pos = ring_positions(b, s, case)
        o, m, l = CA.ring_block_fwd(q, k, v, q_pos, k_pos, True)
        lse, delta = ring_lse_delta(o, m, l, do)
        args = (q, k, v, do, lse, delta, q_pos, k_pos, True)
        mask = (k_pos[:, None, None, :] <= q_pos[:, None, :, None])
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=mask)
        sdpa_bwd = lambda o_=sdpa_out, g_=(qg, kg, vg): (  # noqa: E731
            torch.autograd.grad(o_, g_, dot, retain_graph=True))
        if dt == torch.float32:
            for fn in (lambda a=args[:3] + args[6:8]: CA.ring_block_fwd(
                           *a, True),
                       lambda a=args: CA.ring_block_bwd_dq(*a),
                       lambda a=args: CA.ring_block_bwd_dkdv(*a)):
                check(repeats_bitwise(fn),
                      f"K8 f32 ({case} block) not bitwise repeatable")
            for what, fn in (("forward", lambda m_=mask: torch.nn.functional
                              .scaled_dot_product_attention(
                                  qt, kt, vt, attn_mask=m_)),
                             ("backward", sdpa_bwd)):
                names = device_kernels(fn)
                print(f"f32 SDPA {what} (B={b} S={s}, {case} block, boolean "
                      f"mask): backend {sdpa_backend(names)}, kernels "
                      f"{[n[:60] for n in names]}")
        pairs = int(mask.sum()) * h
        cases[(case, "ring_block_fwd")] = (
            lambda a=args[:3] + args[6:8]: CA.ring_block_fwd(*a, True),
            lambda a=args[:3] + args[6:8]: CA.ring_block_fwd_plain(
                *a, True, scale),
            lambda m_=mask: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=m_),
            esz * 3 * elems + 4 * elems + 2 * stats + pos_bytes,
            4 * d * pairs)
        cases[(case, "ring_block_bwd_dq")] = (
            lambda a=args: CA.ring_block_bwd_dq(*a),
            lambda a=args: CA.ring_block_bwd_plain(*a, scale), sdpa_bwd,
            esz * 4 * elems + 2 * stats + pos_bytes + 4 * elems,
            6 * d * pairs)
        cases[(case, "ring_block_bwd_dkdv")] = (
            lambda a=args: CA.ring_block_bwd_dkdv(*a),
            lambda a=args: CA.ring_block_bwd_plain(*a, scale), sdpa_bwd,
            esz * 4 * elems + 2 * stats + pos_bytes + 8 * elems,
            8 * d * pairs)
    return cases


def k8_phase() -> dict:
    """Phase 15: K8 at every visibility in f32 and bf16, then timed."""
    gen = torch.Generator().manual_seed(SEED + 7)
    worst = {}
    shapes = [((b, s, s, CFG.d_head), k8_cases(b, s)) for b, s in RING_SHAPES]
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        for (b, s, sk, d), cases in shapes + K8_EXTRA:
            for case, causal in cases:
                errs, dead = k8_errors(gen, b, s, dtype, case, causal, sk, d)
                print(f"K8 B={b} S={s}" + (f" Sk={sk}" if sk != s else "")
                      + f" H=8 Dh={d} {case}"
                      f"{'' if causal else ' bidirectional'} {tag}: "
                      + ", ".join(f"{n} {e[0]:.3e} ({e[2]:.3e} scaled)"
                                  for n, e in errs.items())
                      + f"; {dead} empty rows exact")
                for n, e in errs.items():
                    worst[(n, tag)] = worse(worst.get((n, tag), (0.0,) * 3),
                                            e)
                    check(max(s, sk) > ATTN_KEY_TILE or e[2] <= ONE_TILE_TOL,
                          f"{n} ({tag}, S={s}, {case}, one key tile) "
                          f"scaled error {e[2]:.3e} > {ONE_TILE_TOL}")
            torch.cuda.empty_cache()
        for n in K8_SOURCES:
            _, rel, scaled = worst[(n, tag)]
            if dtype == torch.float32:
                check(rel <= KERNEL_TOL, f"{n} (f32) disagrees with its "
                                         f"plain version: {rel:.3e}")
                check(scaled <= F32_SCALED_TOL,
                      f"{n} (f32) scaled error {scaled:.3e} > "
                      f"{F32_SCALED_TOL}")
            else:
                check(scaled <= K8_BF16_LIMITS[n],
                      f"{n} (bf16) scaled error {scaled:.3e} > "
                      f"{K8_BF16_LIMITS[n]}")
        print(f"K8 agrees with its plain version ({tag}): "
              + ", ".join(f"{n} {worst[(n, tag)][2]:.3e}" for n in K8_SOURCES)
              + " scaled" + (f", within {KERNEL_TOL} x max(1, max |ref|) "
                             f"and {F32_SCALED_TOL} scaled"
                             if dtype == torch.float32 else
                             f", within {K8_BF16_LIMITS}"))
    times = {}
    for (case, name), (kern, plain, lib, nbytes, flops) in \
            k8_timed_cases(gen).items():
        ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(lib)
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        times[(case, name)] = (ms, plain_ms, lib_ms, b_ms, b_by)
        print(f"{name} [B=2 S=1024 H=8 Dh=64 causal bf16, {case} block]: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        torch.cuda.empty_cache()
    records = {}
    for name, tpu in K8_SOURCES.items():
        ms, plain_ms, lib_ms, b_ms, b_by = times[("full", name)]
        dms, dplain, dlib, db_ms, _ = times[("diagonal", name)]
        records[name] = {
            "name": name, "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/ring_block_attention.cu",
            "replaces": f"mmlspark_tpu/{tpu}", "launches": 0,
            "max_abs_err": worst[(name, "float32")][0],
            "max_abs_err_bf16": worst[(name, "bfloat16")][0],
            "scaled_err": worst[(name, "float32")][2],
            "scaled_err_bf16": worst[(name, "bfloat16")][2],
            "bf16_limit": K8_BF16_LIMITS[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "diagonal_ms": dms, "diagonal_plain_ms": dplain,
            "diagonal_library_ms": dlib, "diagonal_bound_ms": db_ms,
            "shape": "B=2 S_local=1024 H=8 Dh=64 causal bf16, full block "
                     "(diagonal_*: the diagonal block)",
            "library": LIBRARY_CALL[name]}
    # the f32 route (3xTF32) at the same shapes, beside its three bounds
    peak = mma_tf32_peak()
    f32 = {key: case + (f"B=2 S_local=1024 H=8 Dh=64 causal f32, {key[0]} "
                        f"block",)
           for key, case in k8_timed_cases(gen, torch.float32).items()}
    for name, tpu in K8_SOURCES.items():
        rec = f32_record(f"{name}_f32", f32[("full", name)], peak,
                         "attention_tf32.cuh", tpu,
                         (worst[(name, "float32")][0],
                          worst[(name, "float32")][2]))
        diag = f32_record(f"{name}_f32", f32[("diagonal", name)], peak,
                          "attention_tf32.cuh", tpu, (0.0, 0.0))
        rec.update({f"diagonal_{k}": diag[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_f32_cuda_ms",
            "mma_sync_floor_ms")})
        rec["shape"] += " (diagonal_*: the diagonal block)"
        records[f"{name}_f32"] = rec
        torch.cuda.empty_cache()
    return records


def ring_parity() -> tuple:
    """Phase 16, in f32: the folded ring on a hosted {"seq": 4} mesh
    against dense attention over the whole sequence (output and grads),
    then 3 steps of build_spmd_train_step on {"seq": 4} and {"seq": 1}
    against build_train_step with K7, at B 2 x S 4096, with exact launch
    counts around the {"seq": 4} and K7 runs. Returns the metrics and the
    {"seq": 4} run's launches."""
    gen = torch.Generator().manual_seed(SEED + 8)
    mesh4 = build_mesh(MeshSpec.from_dict({"seq": RING_N}))
    shape = (RING_B, RING_S, CFG.n_heads, CFG.d_head)
    q, k, v, w = (rnd(gen, *shape).requires_grad_() for _ in range(4))
    out = RA.ring_attention(q, k, v, mesh4, block_impl="folded")
    grads = torch.autograd.grad(out, (q, k, v), w.detach())
    ref = CA.dense_attention(q, k, v, True)
    ref_grads = torch.autograd.grad(ref, (q, k, v), w.detach())
    attn = {}
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               (out, *grads), (ref, *ref_grads)):
        got, want = got.detach(), want.detach()
        err = float((got - want).abs().max())
        attn[name] = err / max(1.0, float(want.abs().max()))
    del q, k, v, w, out, grads, ref, ref_grads
    torch.cuda.empty_cache()
    print(f"ring attention, hosted seq={RING_N}, folded (K8), f32, "
          f"B={RING_B} S={RING_S}, against dense attention on the whole "
          f"sequence: " + ", ".join(f"{n} {e:.3e}" for n, e in attn.items())
          + " x max(1, |ref|) (tolerance 1e-4)")
    check(max(attn.values()) <= 1e-4, f"ring attention disagrees: {attn}")

    cfg = dataclasses.replace(CFG, dtype="float32", attention_impl="folded",
                              ce_impl="cuda")
    batch = T.make_batch(np.random.default_rng(SEED), cfg, RING_B, RING_S,
                         DEV)
    runs = {}
    for label in ("seq4", "seq1", "k7"):
        params, vel = train_state(cfg)
        if label == "k7":
            step = T.build_train_step(cfg, TRAIN_LR, TRAIN_MOMENTUM)
        else:
            n = RING_N if label == "seq4" else 1
            step = T.build_spmd_train_step(
                cfg, build_mesh(MeshSpec.from_dict({"seq": n})), TRAIN_LR,
                TRAIN_MOMENTUM)
        torch.cuda.synchronize()
        reset_launch_counts()
        runs[label] = ([float(step(params, vel, *batch)[2])
                        for _ in range(3)], params, read_launch_counts())
        torch.cuda.empty_cache()
    # the f32 routes: K8's on the {"seq": 4} ring (its ranks share a
    # launch), K7's in build_train_step, K4's training variant and K6 in
    # both, 3 steps each
    for label, per_step in (("seq4", RING_LAUNCHES), ("k7", TRAIN_LAUNCHES)):
        launches = runs[label][2]
        print(f"ring parity, {label}, 3 f32 steps: launches {launches}")
        for name, count in launches.items():
            want = 3 * per_step.get(name, 0)
            check(count == want, f"{name}: {count} launches in the f32 "
                                 f"{label} steps, expected {want}")
    lk, pk, _ = runs["k7"]
    out = {"ring_attention_" + n: e for n, e in attn.items()}
    for label in ("seq4", "seq1"):
        ls, ps, _ = runs[label]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ls, lk))
        leaf = max(float((a - b).abs().max().item())
                   for a, b in zip(T._leaves(ps), T._leaves(pk)))
        print(f"build_spmd_train_step {label} (K8) against build_train_step "
              f"(K7), f32, B={RING_B} S={RING_S}, 3 steps: losses {ls} vs "
              f"{lk} (max rel diff {loss_rel:.3e}), max |param diff| after "
              f"step 3 {leaf:.3e} (tolerance 1e-4)")
        check(all(np.isfinite(ls)), f"non-finite {label} loss")
        check(loss_rel <= 1e-4, f"{label} losses disagree: {loss_rel:.3e}")
        check(leaf <= 1e-4, f"{label} params disagree: {leaf:.3e}")
        out[f"{label}_loss_rel"], out[f"{label}_param"] = loss_rel, leaf
    return out, runs["seq4"][2]


def ring_path(card_line):
    """Phase 17: transformer_train_long_v1 through build_spmd_train_step
    on a hosted {"seq": 4} mesh, a warm step then RING_STEPS steps on one
    batch, launch counts read around exactly those steps; its profile;
    then the {"seq": 1} ring's and K7's build_train_step's rates."""
    cfg = TRAIN_CFG
    n_tok = RING_B * RING_S
    mesh = build_mesh(MeshSpec.from_dict({"seq": RING_N}))
    check(RA._resolve_block_impl(RING_S // RING_N, CFG.d_head, True,
                                 CFG.n_heads, DEV) == "folded",
          "auto_train does not resolve to the folded ring")
    batch = T.make_batch(np.random.default_rng(SEED), cfg, RING_B, RING_S,
                         DEV)
    params, vel = train_state(cfg)
    ptrs = [t.data_ptr() for t in T._leaves(params) + T._leaves(vel)]
    step = T.build_spmd_train_step(cfg, mesh, TRAIN_LR, TRAIN_MOMENTUM)
    warm = float(step(params, vel, *batch)[2])
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step(params, vel, *batch)[2] for _ in range(RING_STEPS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / RING_STEPS
    launches = read_launch_counts()
    losses = [float(x) for x in losses]
    print(f"ring train (hosted seq={RING_N}): warm step {warm:.4f}, then "
          f"{RING_STEPS} steps, losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"launches {launches}")
    check(all(np.isfinite(losses)), f"non-finite ring loss: {losses}")
    check(losses[-1] < losses[0], f"ring loss did not fall: {losses}")
    check([t.data_ptr() for t in T._leaves(params) + T._leaves(vel)]
          == ptrs, "params or velocity moved")
    for name, count in launches.items():
        want = RING_LAUNCHES.get(name, 0) * RING_STEPS
        check(count == want, f"{name}: {count} launches on the ring path, "
                             f"expected {want}")
    d_attn = cfg.n_heads * cfg.d_head
    n_matmul = (cfg.d_model * cfg.vocab
                + cfg.n_layers * (4 * cfg.d_model * d_attn
                                  + 2 * cfg.d_model * cfg.d_ff))
    flops = (6.0 * n_matmul * n_tok
             + 12.0 * cfg.n_layers * RING_B * RING_S * RING_S * d_attn)
    tflops = flops / (ms / 1e3) / 1e12
    prof = device_profile(lambda: step(params, vel, *batch), 3,
                          f"ring train step (bf16, hosted seq={RING_N}, "
                          f"B={RING_B} S={RING_S})", card_line,
                          pick=K8_WGMMA)
    k8_ms = sum(prof["picked"].values())
    k8_share = k8_ms / prof["device_ms"]
    print(f"[{card_line}] K8 {k8_ms:.3f} ms of the ring step's "
          f"{prof['device_ms']:.3f} ms of device work ({100 * k8_share:.1f}%)")
    del params, vel
    torch.cuda.empty_cache()
    # the {"seq": 1} ring (K8 on the whole sequence, f32 partials merged)
    # against build_train_step (K7) on the same batch: wall, and device
    # time in the attention kernels and elsewhere
    rates, attn_ms, other_ms = {}, {}, {}
    for label in ("seq1", "k7"):
        p, v = train_state(cfg)
        if label == "k7":
            check(T.attention_engine(cfg, RING_S, DEV) == "folded",
                  "auto does not resolve to K7 at S 4096")
            s = T.build_train_step(cfg, TRAIN_LR, TRAIN_MOMENTUM)
        else:
            s = T.build_spmd_train_step(
                cfg, build_mesh(MeshSpec.from_dict({"seq": 1})), TRAIN_LR,
                TRAIN_MOMENTUM)
        ls, rates[label] = timed_steps(s, p, v, batch, 5)
        check(all(np.isfinite(ls)), f"non-finite {label} loss: {ls}")
        lp = device_profile(lambda: s(p, v, *batch), 3,
                            f"{label} train step (bf16, B={RING_B} "
                            f"S={RING_S})", card_line,
                            pick=K8_WGMMA + K7_WGMMA)
        attn_ms[label] = sum(lp["picked"].values())
        other_ms[label] = lp["device_ms"] - attn_ms[label]
        del p, v
        torch.cuda.empty_cache()
    print(f"[{card_line}] seq=1 ring against K7's step: wall "
          f"{rates['seq1']:.2f} vs {rates['k7']:.2f} ms/step "
          f"({rates['seq1'] / rates['k7']:.3f}x); attention kernels "
          f"{attn_ms['seq1']:.3f} vs {attn_ms['k7']:.3f} ms, other device "
          f"work {other_ms['seq1']:.3f} vs {other_ms['k7']:.3f} ms")
    metrics = {
        "ring_losses": losses, "ring_warm_loss": warm,
        "ring_ms_per_step": ms, "ring_tokens_per_s": n_tok / (ms / 1e3),
        "ring_flops_per_step": flops, "ring_achieved_tflops": tflops,
        "ring_mfu": tflops * 1e12 / PEAK_BF16_FLOPS,
        "ring_device_busy_ms": prof["device_ms"],
        "ring_profile_wall_ms": prof["wall_ms"], "ring_top": prof["top"],
        "ring_k8_device_ms": prof["picked"], "ring_k8_share": k8_share,
        "seq1_attention_device_ms": attn_ms["seq1"],
        "seq1_other_device_ms": other_ms["seq1"],
        "k7_attention_device_ms": attn_ms["k7"],
        "k7_other_device_ms": other_ms["k7"],
        "seq1_ms_per_step": rates["seq1"],
        "seq1_tokens_per_s": n_tok / (rates["seq1"] / 1e3),
        "k7_ms_per_step": rates["k7"],
        "k7_tokens_per_s": n_tok / (rates["k7"] / 1e3)}
    print(f"[{card_line}] transformer_train_long_v1 (bf16, B={RING_B} "
          f"S={RING_S}), hosted seq={RING_N} ring (K8): {ms:.2f} ms/step, "
          f"{metrics['ring_tokens_per_s']:.1f} tokens/s, "
          f"{flops / 1e12:.3f} TFLOP/step (analytic), {tflops:.2f} TFLOP/s, "
          f"MFU {metrics['ring_mfu']:.4f} (bf16 peak 989 TFLOP/s); seq=1 "
          f"ring {rates['seq1']:.2f} ms/step "
          f"({metrics['seq1_tokens_per_s']:.1f} tokens/s); "
          f"build_train_step (K7) {rates['k7']:.2f} ms/step "
          f"({metrics['k7_tokens_per_s']:.1f} tokens/s)")
    return launches, metrics


# ---------------------------------------------------------------------------
# phase 18: the observability plane on the decode path


#: K1's split kernel as the profiler names it: the Chrome trace of the
#: device profiler's window must name it
K1_TRACE_NAME = K1_KERNELS[0]
RECORDER_INTERVAL_S = 0.25
#: the device window over paged pass 1, counted from when the profiler
#: session records (pass 1 is submitted only then): several times the
#: pass's 1.1-1.3 s under the profiler, so the window holds all of it,
#: its decode steps (K1) behind the 8 cold prefills included; pass 1
#: ending after the window closes is a failure of its own. A window
#: timed from the request alone (1 s, then 2 s) once closed on a trace
#: of prefills alone (69033, then 70425 events, no K1)
PROFILE_WINDOW_S = 6.0
SAMPLER_HZ = 50.0
#: the spans every request's tree must hold
REQUEST_SPANS = ("queue_wait", "prefill", "first_token", "decode")


def family(registry, name):
    fams = [f for f in registry.families() if f.name == name]
    check(len(fams) == 1, f"metric family {name} is not registered")
    return fams[0]


def metric_value(registry, name, *labels) -> float:
    return family(registry, name).labels(*labels).value


def hist_stats(registry, name) -> dict:
    """One histogram family's children merged: count, sum, buckets."""
    fam = family(registry, name)
    out = {"count": 0, "sum": 0.0, "buckets": [0] * (len(fam.buckets) + 1),
           "edges": fam.buckets}
    for _, child in fam.children():
        st = child.stats()
        out["count"] += st["count"]
        out["sum"] += st["sum"]
        out["buckets"] = [a + b for a, b in zip(out["buckets"],
                                                  st["buckets"])]
    return out


def hist_p50(h) -> float:
    return PTM.quantile_from_buckets(h["edges"], h["buckets"], 0.5)


def per_pass(hists) -> list:
    """Cumulative histogram snapshots, one after each pass -> each
    pass's own count, mean and median (ms)."""
    out = []
    prev = {"count": 0, "sum": 0.0,
            "buckets": [0] * len(hists[0]["buckets"])}
    for h in hists:
        own = {"count": h["count"] - prev["count"],
               "sum": h["sum"] - prev["sum"], "edges": h["edges"],
               "buckets": [a - b for a, b in zip(h["buckets"],
                                                 prev["buckets"])]}
        out.append({"count": own["count"],
                    "mean_ms": own["sum"] / own["count"],
                    "p50_ms": hist_p50(own)})
        prev = h
    return out


def frame_groups() -> dict:
    """The sampler's frame label (the last two path components) ->
    ``torch``, ``port`` or ``other``, from the files of the modules this
    process imported; a label two groups share is ``ambiguous``."""
    out = {}
    for mod in list(sys.modules.values()):
        path = getattr(mod, "__file__", None)
        if not path:
            continue
        path = path.replace("\\", "/")
        short = "/".join(path.rsplit("/", 2)[-2:])
        group = ("port" if "/mmlspark_tpu_torch/" in path
                 else "torch" if "/torch/" in path else "other")
        if out.get(short, group) != group:
            group = "ambiguous"
        out[short] = group
    return out


def host_time_split(sampler, intervals) -> dict:
    """The scheduler thread's samples over ``intervals`` (``[(t0, t1),
    ...]`` on the sampler's clock): the share idle (waiting in its loop
    for work), and of the busy ones, where the innermost Python frame
    was (torch's own Python, the port's, the rest), with the ten hottest
    frames."""
    groups = frame_groups()
    leaves, counts = {}, {}
    n = idle = 0
    for t0, t1 in intervals:
        for stack, count in sampler.collapsed_between(t0, t1).items():
            counts[stack] = counts.get(stack, 0) + count
    for stack, count in counts.items():
        stage, _, rest = stack.partition(";")
        if stage != "decode-step":
            continue
        frames = rest.split(";")
        n += count
        # idle: the loop itself waiting on its work event
        caller = len(frames)
        while caller and "threading.py:" in frames[caller - 1]:
            caller -= 1
        if 0 < caller < len(frames) and ":_loop:" in frames[caller - 1]:
            idle += count
            continue
        leaves[frames[-1]] = leaves.get(frames[-1], 0) + count
    busy = n - idle
    check(busy > 0, "the sampling profiler saw no busy scheduler sample")
    by_group = {"torch": 0, "port": 0, "other": 0, "ambiguous": 0}
    for leaf, count in leaves.items():
        by_group[groups.get(leaf.split(":", 1)[0], "other")] += count
    top = sorted(leaves.items(), key=lambda kv: -kv[1])[:10]
    return {"samples": n, "idle_share": idle / n,
            "busy_samples": busy,
            "share": {g: c / busy for g, c in by_group.items()},
            "top": [{"frame": f, "group": groups.get(f.split(":", 1)[0],
                                                     "other"),
                     "share": c / busy} for f, c in top]}


def check_decode_registry(registry, sched, label) -> dict:
    """The registry against the scheduler's ledger: counters, the
    histograms' counts and sums, and the device time charged."""
    st = sched.stats()
    for name, key in (("requests", "n_requests"), ("steps", "n_steps"),
                      ("tokens", "n_tokens"), ("prefills", "n_prefills")):
        got = metric_value(registry, f"serving_decode_{name}_total")
        check(got == st[key], f"{label}: serving_decode_{name}_total "
                              f"{got} != stats() {st[key]}")
    hits = metric_value(registry, "serving_decode_prefix_lookups_total",
                        "hit")
    check(hits == st["prefix_cache"]["hits"],
          f"{label}: prefix hits {hits} != {st['prefix_cache']['hits']}")
    pool = metric_value(registry, "serving_decode_kv_pool_bytes")
    check(pool == sched.decoder.pool_bytes(),
          f"{label}: kv_pool_bytes {pool} != {sched.decoder.pool_bytes()}")
    spec = st["speculative"]
    if spec is not None:
        for key in ("rounds", "proposed", "accepted"):
            got = metric_value(registry, f"serving_decode_spec_{key}_total")
            check(got == spec[key], f"{label}: spec {key} {got} != "
                                    f"{spec[key]}")
    ttft = hist_stats(registry, "serving_decode_ttft_ms")
    check(ttft["count"] == st["n_requests"],
          f"{label}: {ttft['count']} TTFT observations for "
          f"{st['n_requests']} requests (each produced tokens)")
    tpr = hist_stats(registry, "serving_decode_tokens_per_request")
    check(tpr["sum"] == st["n_tokens"],
          f"{label}: tokens_per_request sums to {tpr['sum']}, "
          f"n_tokens {st['n_tokens']}")
    hists = {"prefill": hist_stats(registry, "serving_prefill_latency_ms"),
             "step": hist_stats(registry, "serving_decode_step_latency_ms"),
             "spec_round": hist_stats(
                 registry, "serving_decode_spec_round_latency_ms")}
    for key, want in (("prefill", st["n_prefills"]),
                      ("step", st["n_steps"]),
                      ("spec_round", spec["rounds"] if spec else 0)):
        check(hists[key]["count"] == want,
              f"{label}: {key} histogram counts {hists[key]['count']}, "
              f"expected {want}")
    charged = sum(c.value for _, c in family(
        registry, "serving_tenant_device_ms_total").children())
    spent = sum(h["sum"] for h in hists.values())
    check(abs(charged - spent) <= 1e-6 * spent,
          f"{label}: {charged} device ms charged to tenants, {spent} ms "
          f"in the prefill, step and spec-round histograms")
    return {"stats": st, "hists": hists, "ttft": ttft}


def check_spans(tracer, rids, sched, label) -> None:
    """Every request's tree holds its spans; the spec_round spans'
    proposed and accepted add up to the counters (at most them where a
    request hit the per-request span cap)."""
    proposed = accepted = 0
    capped = False
    for rid in rids:
        trace = tracer.get_trace(rid)
        check(trace is not None, f"{label}: no trace captured for {rid}")
        tree = PTR.span_tree(trace)
        names = [c["name"] for c in tree["children"]]
        for want in REQUEST_SPANS:
            check(want in names, f"{label}: {rid}'s tree lacks {want}: "
                                 f"{sorted(set(names))}")
        rounds = [c for c in tree["children"] if c["name"] == "spec_round"]
        # first_token and spec_round spans share the per-request cap
        capped |= len(rounds) + 1 >= _MAX_TIMELINE_SPANS
        proposed += sum(c["attrs"]["proposed"] for c in rounds)
        accepted += sum(c["attrs"]["accepted"] for c in rounds)
    if sched.decoder.has_draft:
        want = (sched.n_spec_proposed, sched.n_spec_accepted)
        ok = (proposed <= want[0] and accepted <= want[1]) if capped \
            else (proposed, accepted) == want
        check(ok, f"{label}: spec_round spans propose/accept "
                  f"{(proposed, accepted)}, counters {want}")


def check_tsdb(recorder, sched, label) -> None:
    store = recorder.store
    got = store.query("serving_decode_tokens_total")["results"]
    check(len(got) == 1 and got[0]["value"] == sched.n_tokens,
          f"{label}: the TSDB reads {got} for serving_decode_tokens_total, "
          f"the counter {sched.n_tokens}")
    rng = store.query_range("rate(serving_decode_tokens_total[2s])",
                            start=-30.0, step=0.5)["series"]
    check(rng and rng[0]["points"],
          f"{label}: rate(serving_decode_tokens_total[2s]) is empty")


def instrumented(decoder, payloads, label, sampler, between=None):
    """Serve ``payloads`` twice (cold, then through the prefix cache)
    through a scheduler bound to a fresh registry and tracer, with a
    Recorder scraping the registry every 0.25 s; ``between()`` runs
    after the first pass. Returns the replies, walls, the passes'
    intervals on the sampler's clock, the step or spec-round histogram
    after each pass, the scheduler, registry, tracer, recorder and the
    rids served."""
    registry = PTM.MetricsRegistry()
    tracer = PTR.Tracer(default_slow_ms=None)
    tracer.set_threshold("request", 0.0)
    sched = DecodeScheduler(decoder, max_new_tokens_default=MAX_NEW,
                            registry=registry, tracer=tracer).start()
    recorder = PTS.Recorder([registry], interval_s=RECORDER_INTERVAL_S)
    replies, walls, spans, hists, rids = [], [], [], [], []
    lat = ("serving_decode_spec_round_latency_ms" if decoder.has_draft
           else "serving_decode_step_latency_ms")
    recorder.start()
    try:
        for i in range(2):
            if i and between is not None:
                between()
            tag = f"{label}{i + 1}"
            t0 = sampler.clock.now()
            r, wall = serve(sched, payloads, tag, tracer=tracer)
            spans.append((t0, sampler.clock.now()))
            hists.append(hist_stats(registry, lat))
            replies.append(r)
            walls.append(wall)
            rids += [f"{tag}-{j}" for j in range(len(payloads))]
    finally:
        sched.stop()
        recorder.stop()
    return (replies, walls, spans, hists, sched, registry, tracer,
            recorder, rids)


def bare_passes(decoder, payloads, label):
    """The same two passes through a scheduler bound to nothing: the
    yardstick served beside the instrumented passes in this phase."""
    sched = DecodeScheduler(decoder, max_new_tokens_default=MAX_NEW).start()
    try:
        return [serve(sched, payloads, f"{label}{i + 1}") for i in range(2)]
    finally:
        sched.stop()


def tokens_per_s(passes) -> list:
    return [sum(r["n_tokens"] for r in replies) / wall
            for replies, wall in passes]


def wait_for_recording(profiler) -> float:
    """Wait until the open window's profiler session records; its
    ``recording_unix``."""
    for _ in range(1200):
        active = profiler.status()["active"]
        check(active is not None,
              "the device profiler's window closed before it recorded")
        if "recording_unix" in active:
            return active["recording_unix"]
        time.sleep(0.01)
    check(False, "the device profiler's session did not start in 12 s")


def wait_for_window(profiler) -> None:
    for _ in range(1200):
        if not profiler.busy:
            return
        time.sleep(0.05)
    check(False, "the device profiler's window did not close in 60 s")


def observability_phase(params, payloads, bare, tree, dtree, dcfg,
                        card_line) -> dict:
    """Phase 4's two passes and phase 7's two speculative passes again,
    each scheduler bound to a MetricsRegistry and a Tracer, a Recorder
    scraping each registry, a SamplingProfiler on the host and one
    DeviceProfiler window open over paged pass 1; on each path a bare
    scheduler serves the same passes just before and just after, on the
    same decoder. Tokens and launches must equal the bare runs'; the
    registry, spans, TSDB, the device trace and the card's vitals are
    checked."""
    dec = TransformerDecoder(params, CFG, n_slots=N_SLOTS, max_len=MAX_LEN,
                             page_size=PAGE)
    dec.warmup()
    sdec = spec_decoder(tree, dtree, dcfg)
    sdec.warmup()
    spec_payloads = speculative_payloads(payloads)
    sampler = PPF.SamplingProfiler(hz=SAMPLER_HZ)
    profiler = PPG.DeviceProfiler()
    with tempfile.TemporaryDirectory() as tmp:
        bare_before = bare_passes(dec, payloads, "bare-a")
        torch.cuda.synchronize()
        sampler.start()
        reset_launch_counts()
        # the window opens over paged pass 1 and closes (its trace
        # written) before pass 2, so pass 2 reads the metrics' and
        # spans' cost without the window's
        profiler.start_window(PROFILE_WINDOW_S,
                              log_dir=os.path.join(tmp, "window"))
        try:
            profiler.start_window(0.1, log_dir=os.path.join(tmp, "second"))
            check(False, "a second window opened while one was open")
        except PPG.ProfilerBusy:
            pass
        recording = wait_for_recording(profiler)
        pass1_end = []

        def between():
            pass1_end.append(time.time())
            wait_for_window(profiler)

        replies, walls, intervals, steps, sched, reg, tracer, rec, rids = \
            instrumented(dec, payloads, "obs", sampler, between=between)
        torch.cuda.synchronize()
        launches = read_launch_counts()
        # read before later threads exist: the sampler names a thread by
        # its ident, which a later thread may take over
        split = host_time_split(sampler, intervals)
        sampler.stop()
        sample_ms = [sampler.status()["ewma_sample_ms"]]
        bare_after = bare_passes(dec, payloads, "bare-b")
        s_bare_before = bare_passes(sdec, spec_payloads, "sbare-a")
        torch.cuda.synchronize()
        sampler.start()
        reset_launch_counts()
        s_replies, s_walls, s_intervals, rounds, s_sched, s_reg, s_tracer, \
            s_rec, s_rids = instrumented(sdec, spec_payloads, "sobs",
                                         sampler)
        torch.cuda.synchronize()
        s_launches = read_launch_counts()
        s_split = host_time_split(sampler, s_intervals)
        sampler.stop()
        sample_ms.append(sampler.status()["ewma_sample_ms"])
        s_bare_after = bare_passes(sdec, spec_payloads, "sbare-b")
        pstatus = profiler.status()
        check(not pstatus["busy"] and pstatus["n_captures"] == 1
              and pstatus["n_errors"] == 0,
              f"the device profiler's window: {pstatus}")
        with open(pstatus["last"]["trace"]) as f:
            events = json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(pstatus["last"]["trace"])
    over = pass1_end[0] - (recording + PROFILE_WINDOW_S)
    check(over <= 0, f"paged pass 1 ended {over:.2f} s after the "
                     f"{PROFILE_WINDOW_S} s device window closed")
    names = {e.get("name", "") for e in events}
    k1_events = sum(1 for e in events
                    if K1_TRACE_NAME in e.get("name", ""))
    kernels = collections.Counter(e.get("name", "")[:40] for e in events
                                  if e.get("cat") == "kernel")
    check(k1_events > 0, f"the device profiler's trace names no "
                         f"{K1_TRACE_NAME} kernel ({len(events)} events, "
                         f"{sum(kernels.values())} of them kernels; the "
                         f"most launched: {kernels.most_common(6)})")
    checks = []
    for i in range(2):
        checks += [(f"paged pass {i + 1}", replies[i], want)
                   for want in (bare["paged"][i], bare_before[i][0],
                                bare_after[i][0])]
        checks += [(f"speculative pass {i + 1}", s_replies[i], want)
                   for want in (bare["spec"][i], s_bare_before[i][0],
                                s_bare_after[i][0])]
    for label, got, want_replies in checks:
        for i, (p, a, b) in enumerate(zip(payloads, got, want_replies)):
            if "temperature" not in p:
                check(a["tokens"] == b["tokens"],
                      f"{label} request {i}: instrumented tokens differ "
                      f"from the bare run's")
    check_launches(launches, paged_launches(sched.stats()),
                   "instrumented paged path")
    check_launches(s_launches, spec_launches(s_sched.stats(), dcfg),
                   "instrumented speculative path")
    paged = check_decode_registry(reg, sched, "paged")
    spec = check_decode_registry(s_reg, s_sched, "speculative")
    check(spec["stats"]["speculative"]["rounds"] > 0,
          "the instrumented speculative passes ran no round")
    check_spans(tracer, rids, sched, "paged")
    check_spans(s_tracer, s_rids, s_sched, "speculative")
    check_tsdb(rec, sched, "paged")
    check_tsdb(s_rec, s_sched, "speculative")
    mem = PPG.device_memory_stats()
    check(bool(mem) and mem["bytes_in_use"] >= dec.pool_bytes(),
          f"device_memory_stats() {mem} against the pool's "
          f"{dec.pool_bytes()} bytes")
    kind = torch.cuda.get_device_name()
    check(PTM.build_info()["device_kind"] == kind,
          f"build_info() names {PTM.build_info()['device_kind']!r}, "
          f"the card is {kind!r}")
    peak = PPG.MfuMeter().snapshot()["peak_tflops"]
    if kind in PPG._PEAK_BF16_TFLOPS:
        check(peak == PPG._PEAK_BF16_TFLOPS[kind],
              f"MfuMeter's peak {peak} for {kind!r}")
    else:
        print(f"MfuMeter has no peak for {kind!r}: its check is left out")
    out = {
        "paged_tokens_per_s": {
            "bare_before": tokens_per_s(bare_before),
            "instrumented": tokens_per_s(zip(replies, walls)),
            "bare_after": tokens_per_s(bare_after)},
        "spec_tokens_per_s": {
            "bare_before": tokens_per_s(s_bare_before),
            "instrumented": tokens_per_s(zip(s_replies, s_walls)),
            "bare_after": tokens_per_s(s_bare_after)},
        "step_ms": per_pass(steps),
        "spec_round_ms": per_pass(rounds),
        "recorder_last_ingest_ms": rec.status()["last_ingest_ms"],
        "recorder_ewma_ingest_ms": rec.status()["ewma_ingest_ms"],
        "recorder_scrapes": rec.n_scrapes + s_rec.n_scrapes,
        "sampler_ewma_sample_ms": sample_ms,
        "device_trace_events": len(events),
        "device_trace_k1_events": k1_events,
        "device_trace_bytes": trace_bytes,
        "device_trace_names": len(names),
        "device_window_s": pstatus["last"]["finished_unix"]
        - pstatus["last"]["started_unix"],
        "device_window_start_s": recording - pstatus["last"]["started_unix"],
        "device_window_pass1_margin_s": -over,
        "device_memory": mem,
        "build_info": PTM.build_info(),
        "host_time_split": {"paged": split, "speculative": s_split}}
    bm = bare["metrics"]
    print(f"[{card_line}] observability plane: 2 paged passes + 2 "
          f"speculative passes bound to a registry and a tracer, a "
          f"Recorder every {RECORDER_INTERVAL_S} s ({out['recorder_scrapes']}"
          f" scrapes, last ingest {out['recorder_last_ingest_ms']:.3f} ms, "
          f"EWMA {out['recorder_ewma_ingest_ms']:.3f} ms), a "
          f"{SAMPLER_HZ:.0f} Hz sampler (EWMA {sample_ms[0]:.3f} and "
          f"{sample_ms[1]:.3f} ms a sample), a {PROFILE_WINDOW_S} s device "
          f"window over paged pass 1 ({out['device_window_start_s']:.2f} s "
          f"from open to recording, pass 1 ended {-over:.2f} s before the "
          f"window closed, {out['device_window_s']:.2f} s from "
          f"open to trace written; {len(events)} trace events, "
          f"{trace_bytes / 2**20:.1f} MiB, {k1_events} of {K1_TRACE_NAME}); "
          f"tokens and launches equal the bare runs'")
    for path, key, first, note in (
            ("decode", "paged_tokens_per_s", "pass1_tokens_per_s",
             "pass 1 instrumented with the device window open; "),
            ("speculative", "spec_tokens_per_s", "spec_pass1_tokens_per_s",
             "")):
        t = out[key]
        print(f"[{card_line}] {path} tokens/s, bare / instrumented / bare "
              f"in turns on one decoder: pass 1 "
              + " / ".join(f"{t[k][0]:.1f}" for k in t)
              + ", pass 2 " + " / ".join(f"{t[k][1]:.1f}" for k in t)
              + f" ({note}the earlier phase's bare pass 1 "
              f"{bm[first]:.1f})")
    for label, hists, profiled in (
            ("step", out["step_ms"], bm["step_wall_ms"]),
            ("spec-round", out["spec_round_ms"], bm["spec_round_wall_ms"])):
        print(f"[{card_line}] the {label} histogram: " + "; ".join(
            f"pass {i + 1} {h['count']}, median {h['p50_ms']:.3f} ms, mean "
            f"{h['mean_ms']:.3f} ms" for i, h in enumerate(hists))
            + f" (the bare path keeps none; its profiled {label} "
              f"{profiled:.3f} ms)")
    for label, sp in (("paged", split), ("speculative", s_split)):
        print(f"[{card_line}] decode-scheduler thread, {label} passes, "
              f"{sp['samples']} samples at {SAMPLER_HZ:.0f} Hz, "
              f"{100 * sp['idle_share']:.1f}% idle in its loop; of the "
              f"{sp['busy_samples']} busy ones, the innermost Python frame "
              f"under torch/ {100 * sp['share']['torch']:.1f}%, under "
              f"mmlspark_tpu_torch/ {100 * sp['share']['port']:.1f}%, "
              f"elsewhere {100 * sp['share']['other']:.1f}% (ambiguous "
              f"{100 * sp['share']['ambiguous']:.1f}%); top 10 frames:")
        for row in sp["top"]:
            print(f"  {100 * row['share']:5.1f}%  [{row['group']}] "
                  f"{row['frame']}")
    return out


# ---------------------------------------------------------------------------
# phase 19: POST /generate through the port's ServingServer


class Identity(Transformer):
    """The frame plane's model beside the decoder: rows pass through."""

    def transform(self, df):
        return df


#: the threads that may launch a kernel or synchronize the card while a
#: server runs: this script's and the scheduler's, never an HTTP thread
CARD_THREADS = {"MainThread", "decode-scheduler"}


class LaunchThreads(dict):
    """A kernel-launch count dict that also notes each thread that
    counted a launch (a wrapper adds one where it launches)."""

    def __init__(self, counts):
        super().__init__(counts)
        self.threads = set()

    def __setitem__(self, key, value):
        if value:
            self.threads.add(threading.current_thread().name)
        super().__setitem__(key, value)


class CardThreads:
    """For the ``with`` block: swap the paged and CE wrappers' launch
    counts for :class:`LaunchThreads` and wrap ``torch.cuda.synchronize``,
    so the phase can name every thread that touched the card."""

    def __enter__(self):
        self.saved = CA.LAUNCHES, FC.LAUNCHES, torch.cuda.synchronize
        CA.LAUNCHES = LaunchThreads(CA.LAUNCHES)
        FC.LAUNCHES = LaunchThreads(FC.LAUNCHES)
        self.sync_threads = set()
        sync = self.saved[2]

        def noting_sync(*args, **kw):
            self.sync_threads.add(threading.current_thread().name)
            return sync(*args, **kw)

        torch.cuda.synchronize = noting_sync
        return self

    def threads(self) -> set:
        return (CA.LAUNCHES.threads | FC.LAUNCHES.threads
                | self.sync_threads)

    def __exit__(self, *exc):
        ca, fc, torch.cuda.synchronize = self.saved
        ca.update(CA.LAUNCHES)
        fc.update(FC.LAUNCHES)
        CA.LAUNCHES, FC.LAUNCHES = ca, fc


def http_call(srv, method, path, payload=None, headers=None):
    """One request over ``http.client``: ``(status, headers, body)``
    (header names lower-cased)."""
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
    try:
        body = None if payload is None else json.dumps(payload).encode()
        h = {"Content-Type": "application/json"}
        h.update(headers or {})
        conn.request(method, path, body=body, headers=h)
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, \
            r.read()
    finally:
        conn.close()


def http_generate(srv, payloads, tag):
    """``payloads`` sent at once, one thread each, as ``POST /generate``
    with request ids ``tag-i``: replies in order, and the wall time."""
    out = [None] * len(payloads)

    def one(i):
        out[i] = http_call(srv, "POST", "/generate", payloads[i],
                           {"X-Request-Id": f"{tag}-{i}"})

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(payloads))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    replies = []
    for i, res in enumerate(out):
        check(res is not None, f"{tag}-{i}: no reply")
        status, _, body = res
        check(status == 200, f"{tag}-{i} answered {status}: {body[:200]}")
        replies.append(json.loads(body))
    return replies, wall


def sse_open(srv, payload):
    """Send ``payload`` to ``/generate?stream=1`` over a raw socket;
    returns the socket and the send time."""
    sock = socket.create_connection((srv.host, srv.port), timeout=600)
    body = json.dumps(payload).encode()
    t0 = time.perf_counter()
    sock.sendall(b"POST /generate?stream=1 HTTP/1.1\r\nHost: card\r\n"
                 b"Content-Type: application/json\r\n"
                 b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
    return sock, t0


def sse_read(sock, t0):
    """One chunked SSE response off ``sock``: ``(status line, events,
    seconds from ``t0`` to the first event)``."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        check(bool(chunk), "the stream closed before its head")
        buf += chunk
    head, _, data = buf.partition(b"\r\n\r\n")
    t_first = None
    body = b""
    while True:
        while b"\r\n" not in data:
            chunk = sock.recv(65536)
            check(bool(chunk), "the stream closed mid-chunk")
            data += chunk
        line, _, rest = data.partition(b"\r\n")
        n = int(line, 16)
        while len(rest) < n + 2:
            chunk = sock.recv(65536)
            check(bool(chunk), "the stream closed mid-chunk")
            rest += chunk
        if n == 0:
            break
        if t_first is None:
            t_first = time.perf_counter() - t0
        body += rest[:n]
        data = rest[n + 2:]
    events = [json.loads(e.split(b"data: ", 1)[1])
              for e in body.split(b"\n\n") if e.strip()]
    return head.split(b"\r\n")[0], events, t_first


def http_stream(srv, payloads):
    """``payloads`` streamed at once, one socket each: per request the
    token events' tokens and the final event."""
    out = [None] * len(payloads)

    def one(i):
        sock, t0 = sse_open(srv, payloads[i])
        try:
            out[i] = sse_read(sock, t0)
        finally:
            sock.close()

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    res = []
    for i, r in enumerate(out):
        check(r is not None, f"stream {i}: no reply")
        line, events, _ = r
        check(b" 200 " in line, f"stream {i}: {line!r}")
        final = [e for e in events if e.get("done")]
        check(len(final) == 1, f"stream {i}: {len(final)} final events")
        toks = [e["token"] for e in events if "done" not in e]
        check([e["i"] for e in events if "done" not in e]
              == list(range(len(toks))), f"stream {i}: events out of order")
        res.append((toks, final[0]))
    return res


def same_replies(got, want, label) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        check(g["tokens"] == w["tokens"]
              and g["finish_reason"] == w["finish_reason"],
              f"{label}: request {i} differs from the direct reply at "
              f"token {first_divergence(g['tokens'], w['tokens'])}")


def serve_http(dec, frontend, **kw):
    """A fresh scheduler over ``dec`` behind a started ServingServer."""
    sched = DecodeScheduler(dec, max_new_tokens_default=MAX_NEW)
    return ServingServer(Identity(), port=0, decoder=sched,
                         frontend=frontend, max_latency_ms=1.0,
                         verify_checkpoints=False, **kw).start()


def http_passes(srv, payloads, replies, label):
    """Pass 1 (cold) and pass 2 (prefix hits) over HTTP, with the kernel
    counts read around exactly these two passes."""
    sched = srv.decoder
    torch.cuda.synchronize()
    reset_launch_counts()
    r1, wall1 = http_generate(srv, payloads, f"{label}1")
    hits_1 = sched.prefix.stats()["hits"]
    r2, wall2 = http_generate(srv, payloads, f"{label}2")
    torch.cuda.synchronize()
    launches = read_launch_counts()
    stats = sched.stats()
    check(hits_1 == 0 and stats["prefix_cache"]["hits"] > 0,
          f"{label}: prefix hits {hits_1} in pass 1, "
          f"{stats['prefix_cache']['hits']} in all")
    same_replies(r1, replies[0], f"{label} pass 1")
    same_replies(r2, replies[1], f"{label} pass 2")
    check_launches(launches, paged_launches(stats), f"{label} passes")
    n = sum(r["n_tokens"] for r in r1 + r2)
    return n / (wall1 + wall2), launches


def direct_passes(dec, payloads, replies, label) -> float:
    """Phase 4's two passes through a fresh scheduler on ``dec``: the
    yardstick beside the HTTP passes."""
    sched = DecodeScheduler(dec, max_new_tokens_default=MAX_NEW).start()
    try:
        r1, wall1 = serve(sched, payloads, f"{label}1")
        r2, wall2 = serve(sched, payloads, f"{label}2")
    finally:
        sched.stop()
    same_replies(r1, replies[0], f"{label} pass 1")
    same_replies(r2, replies[1], f"{label} pass 2")
    return sum(r["n_tokens"] for r in r1 + r2) / (wall1 + wall2)


def idle_clean(sched) -> bool:
    return (sched.pool.n_free == N_SLOTS and ledger_clean(sched)
            and sched.stats()["slots_in_use"] == 0)


def wait_for(cond, what, timeout=60.0) -> None:
    t_end = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < t_end, f"timed out waiting for {what}")
        time.sleep(0.01)


def eventloop_checks(srv, pre, payloads, replies, card_line) -> dict:
    """On the event loop after its passes: the streamed passes, a plain
    request on the stream's socket, replay, a mid-stream disconnect,
    shedding, wire TTFT beside the scheduler's, /metrics and
    /decode/stats."""
    sched = srv.decoder
    out = {}
    # streaming: the same 8 requests as SSE; the prefix cache is warm,
    # so they equal pass 2's direct replies
    streamed = http_stream(srv, payloads)
    for i, ((toks, final), want) in enumerate(zip(streamed, replies[1])):
        check(toks == final["tokens"],
              f"stream {i}: token events differ from the final event")
        check(final["tokens"] == want["tokens"]
              and final["finish_reason"] == want["finish_reason"],
              f"stream {i}: tokens differ from the direct reply")
    # keep-alive: a plain request on a stream's socket after its end
    sock, t0 = sse_open(srv, payloads[0])
    try:
        line, events, _ = sse_read(sock, t0)
        check(b" 200 " in line, f"stream on the kept socket: {line!r}")
        body = json.dumps(dict(payloads[1], max_new_tokens=4)).encode()
        sock.sendall(b"POST /generate HTTP/1.1\r\nHost: card\r\n"
                     b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        buf = b""
        while b"\r\n\r\n" not in buf or not buf.rstrip().endswith(b"}"):
            chunk = sock.recv(65536)
            check(bool(chunk), "the kept socket closed")
            buf += chunk
        head, _, rest = buf.partition(b"\r\n\r\n")
        check(b" 200 " in head.split(b"\r\n")[0],
              f"plain request after a stream: {head[:40]!r}")
        check(json.loads(rest)["tokens"] == replies[1][1]["tokens"][:4],
              "the plain request after a stream differs")
    finally:
        sock.close()
    # replay: the same X-Request-Id again launches no kernel
    torch.cuda.synchronize()
    reset_launch_counts()
    status, hdrs, body = http_call(srv, "POST", "/generate", payloads[0],
                                   {"X-Request-Id": "http1-0"})
    torch.cuda.synchronize()
    check(status == 200 and hdrs.get("x-replayed") == "1",
          f"replay answered {status} with {hdrs}")
    check(json.loads(body)["tokens"] == replies[0][0]["tokens"],
          "the replay's tokens differ from pass 1's")
    check(sum(read_launch_counts().values()) == 0,
          f"the replay launched kernels: {read_launch_counts()}")
    # a mid-stream disconnect releases the slot and the pages
    before = sched.stats()["releases"].get("disconnected", 0)
    long = {"prompt": pre[1] + [7] * 16, "max_new_tokens": 600}
    sock, t0 = sse_open(srv, long)
    head = sock.recv(4096)
    check(b" 200 " in head[:20], f"the long stream answered {head[:40]!r}")
    sock.close()
    wait_for(lambda: sched.stats()["releases"].get("disconnected", 0)
             > before, "the disconnect release")
    wait_for(lambda: idle_clean(sched), "slots and pages after the "
             "disconnect")
    # shedding: no room in the waiting queue -> 429 with Retry-After
    sched.max_waiting = 0
    try:
        status, hdrs, _ = http_call(srv, "POST", "/generate",
                                    {"prompt": [1, 2, 3]})
    finally:
        sched.max_waiting = 256
    check(status == 429 and "retry-after" in hdrs,
          f"shedding answered {status} with {sorted(hdrs)}")
    # TTFT on the wire (send to the first SSE event) beside the
    # scheduler's own TTFT histogram, cold and with a 256-token hit
    rng = np.random.default_rng(SEED + 19)
    probes = {"cold": rng.integers(1, CFG.vocab, size=280).tolist(),
              "warm": pre[0] + rng.integers(1, CFG.vocab, size=24).tolist()}
    for name, prompt in probes.items():
        h0 = hist_stats(srv.registry, "serving_decode_ttft_ms")
        sock, t0 = sse_open(srv, {"prompt": prompt, "max_new_tokens": 2})
        try:
            line, events, t_first = sse_read(sock, t0)
        finally:
            sock.close()
        h1 = hist_stats(srv.registry, "serving_decode_ttft_ms")
        check(h1["count"] == h0["count"] + 1,
              f"TTFT histogram counted {h1['count'] - h0['count']}")
        out[f"wire_ttft_{name}_ms"] = t_first * 1e3
        out[f"scheduler_ttft_{name}_ms"] = h1["sum"] - h0["sum"]
    wait_for(lambda: idle_clean(sched), "an idle scheduler")
    # the metrics and stats surfaces
    status, _, text = http_call(srv, "GET", "/metrics?scope=server")
    check(status == 200, f"/metrics answered {status}")
    samples = PTM.parse_prometheus(text.decode())
    tokens = [v for name, _, v in samples
              if name == "serving_decode_tokens_total"]
    check(tokens == [float(sched.stats()["n_tokens"])],
          f"serving_decode_tokens_total {tokens} against stats() "
          f"{sched.stats()['n_tokens']}")
    build = [dict(lbl) for name, lbl, _ in samples
             if name == "serving_build_info"]
    check(len(build) == 1 and build[0]["device_kind"]
          == torch.cuda.get_device_name(0),
          f"serving_build_info names {build}")
    status, _, body = http_call(srv, "GET", "/decode/stats")
    check(status == 200 and json.loads(body)["slots_in_use"] == 0,
          f"/decode/stats answered {status}: {body[:200]}")
    print(f"[{card_line}] TTFT on the wire (send to the first SSE event) "
          f"against the scheduler's histogram: cold 280-token prompt "
          f"{out['wire_ttft_cold_ms']:.2f} / "
          f"{out['scheduler_ttft_cold_ms']:.2f} ms, with a 256-token "
          f"prefix hit {out['wire_ttft_warm_ms']:.2f} / "
          f"{out['scheduler_ttft_warm_ms']:.2f} ms")
    return out


def http_phase(params, pre, payloads, replies, tree, dtree, dcfg,
               spec_replies, card_line) -> dict:
    """Phase 4's traffic through ``POST /generate`` on both socket
    edges, and phase 7's through a speculative decoder, each server
    with a fresh scheduler over one warmed decoder; the direct
    scheduler's passes on the same decoder before and after."""
    t_phase = time.perf_counter()
    dec = TransformerDecoder(params, CFG, n_slots=N_SLOTS, max_len=MAX_LEN,
                             page_size=PAGE)
    dec.warmup()
    ptr = dec.cache["k"].data_ptr(), dec.cache["v"].data_ptr()
    out = {"direct_tokens_per_s": [direct_passes(dec, payloads, replies,
                                                 "direct-a")]}
    with CardThreads() as seen:
        srv = serve_http(dec, "eventloop")
        try:
            rate, launches = http_passes(srv, payloads, replies, "http")
            out["http_eventloop_tokens_per_s"] = rate
            out["http_launches"] = launches
            out.update(eventloop_checks(srv, pre, payloads, replies,
                                        card_line))
        finally:
            srv.stop()
        srv = serve_http(dec, "threaded")
        try:
            out["http_threaded_tokens_per_s"], _ = http_passes(
                srv, payloads, replies, "threaded")
            check(idle_clean(srv.decoder), "threaded: not idle at the end")
        finally:
            srv.stop()
        out["direct_tokens_per_s"].append(
            direct_passes(dec, payloads, replies, "direct-b"))
        # speculation: phase 7's pass 1 through /generate
        sdec = spec_decoder(tree, dtree, dcfg)
        sdec.warmup()
        srv = serve_http(sdec, "eventloop")
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            s1, _ = http_generate(srv, speculative_payloads(payloads),
                                  "spec")
            torch.cuda.synchronize()
            launches = read_launch_counts()
            stats = srv.decoder.stats()
        finally:
            srv.stop()
        same_replies(s1, spec_replies, "speculative /generate")
        check(stats["speculative"]["rounds"] > 0, "no speculative round")
        check_launches(launches, spec_launches(stats, dcfg),
                       "speculative /generate")
        check(launches["fused_softmax_xent"]
              == stats["speculative"]["rounds"],
              "K4's launches are not the speculative rounds")
        out["http_spec_rounds"] = stats["speculative"]["rounds"]
        threads = seen.threads()
    check(threads <= CARD_THREADS,
          f"threads other than the scheduler's touched the card: "
          f"{sorted(threads - CARD_THREADS)}")
    check((dec.cache["k"].data_ptr(), dec.cache["v"].data_ptr()) == ptr,
          "the KV pool moved")
    out["card_threads"] = sorted(threads)
    out["seconds"] = time.perf_counter() - t_phase
    d = out["direct_tokens_per_s"]
    print(f"[{card_line}] /generate tokens/s, 8 requests x {MAX_NEW} "
          f"tokens x 2 passes: direct {d[0]:.1f}, event loop "
          f"{out['http_eventloop_tokens_per_s']:.1f}, threaded "
          f"{out['http_threaded_tokens_per_s']:.1f}, direct {d[1]:.1f}; "
          f"the phase took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: the dense slot-lane pool (paged=False)

#: the paged kernels, which the dense pool must never launch
PAGED_PATH_KERNELS = ("paged_decode_attention", "flash_prefill_attention",
                      "paged_prefix_prefill_attention")


def dense_phase(params, payloads, replies, metrics, card_line) -> dict:
    """Phase 4's 8 requests through a dense scheduler at the same width
    (8 slots, max_len 1024): plain PyTorch attention, no page, no
    kernel. Greedy tokens must equal phase 4's paged replies under phase
    7's rule; K1-K3 (and every other kernel) launch 0 times; the lanes
    stay in place; every slot is free at the end."""
    t_phase = time.perf_counter()
    dec = TransformerDecoder(params, CFG, n_slots=N_SLOTS, max_len=MAX_LEN,
                             paged=False)
    check(dec.device.type == "cuda" and dec.attn_impl == "dense"
          and not dec.paged, f"dense decoder resolved to {dec.device}/"
          f"{dec.attn_impl}/paged={dec.paged}")
    dec.warmup()
    ptr = dec.cache["k"].data_ptr(), dec.cache["v"].data_ptr()
    sched = DecodeScheduler(dec, max_new_tokens_default=MAX_NEW).start()
    walls = []
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        dense, wall = serve(sched, payloads, "dense1")
        walls.append(wall)
        torch.cuda.synchronize()
        launches = read_launch_counts()
        _, wall = serve(sched, payloads, "dense2")
        walls.append(wall)
        stats = sched.stats()
    finally:
        sched.stop()
    for name in PAGED_PATH_KERNELS:
        check(launches[name] == 0,
              f"the dense pool launched {name} {launches[name]} times")
    check(sum(launches.values()) == 0,
          f"the dense pool launched kernels: {launches}")
    check(stats["paged"] is False and stats["pages"] is None
          and stats["prefix_cache"] is None,
          f"dense stats report pages: {stats['paged']}/{stats['pages']}")
    check(stats["slots_free"] == N_SLOTS and stats["slots_in_use"] == 0,
          f"dense pool ends with {stats['slots_free']} free slots")
    check(stats["n_step_faults"] == 0, "a dense decode step faulted")
    check((dec.cache["k"].data_ptr(), dec.cache["v"].data_ptr()) == ptr,
          "the dense KV lanes moved")
    ties = greedy_parity(params, payloads, dense, replies, "dense pool")
    n_tok = sum(r["n_tokens"] for r in dense)
    out = {"dense_tokens_per_s": [n_tok / w for w in walls],
           "paged_tokens_per_s": [metrics["pass1_tokens_per_s"],
                                  metrics["pass2_tokens_per_s"]],
           "greedy_ties": ties, "n_steps": stats["n_steps"],
           "launches": launches,
           "seconds": time.perf_counter() - t_phase}
    print(f"[{card_line}] dense slot-lane pool, 8 requests x {MAX_NEW} "
          f"tokens: {out['dense_tokens_per_s'][0]:.1f} and "
          f"{out['dense_tokens_per_s'][1]:.1f} tokens/s against the paged "
          f"decoder's {metrics['pass1_tokens_per_s']:.1f} (cold) and "
          f"{metrics['pass2_tokens_per_s']:.1f} (prefix hits) in phase 4; "
          f"greedy tokens equal the paged replies ({ties} near ties); "
          f"0 kernel launches; phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 21: the frame plane's scoring path

FRAME_BATCH, FRAME_IMAGES = 1024, 10_240
#: bf16 rows, card against the CPU: cuDNN's bf16 convs and the CPU's
#: round their sums in other orders (one bf16 ulp, 2^-8, carried on)
FRAME_BF16_TOL = 3e-2
ZOO_TOL = 1e-4
WORKER_TOL = 1e-5
#: bench.py's quantized_compute_v1 model: an MLP over 512 features
QUANT_D_IN = 512


def frame_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    check(got.shape == ref.shape, f"shapes {got.shape} != {ref.shape}")
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def zoo_check(cache_dir) -> dict:
    """The three zoo models, fetched from ``zoo/`` with their hashes
    verified, score their golden inputs on the card at 1e-4."""
    out = {}
    dl = ModelDownloader(cache_dir, repo=os.path.join(REPO_ROOT, "zoo"))
    for name in ("digits_resnet8", "digits32_resnet14", "cifar10s_resnet20"):
        meta = dl.download_by_name(name)
        check(ZOO_DIR_SHA(meta.uri) == meta.hash, f"{name}: hash")
        fn = NNFunction.load(meta.uri)
        g = np.load(os.path.join(REPO_ROOT, "tests", "resources",
                                 f"golden_{name}.npz"))
        x = g["x"].astype(np.float32)
        if meta.input_dtype == "uint8":
            x = x / 255.0
        got = fn.apply(x, device=DEV).float().cpu().numpy()
        err = float(np.abs(got - g["logits"]).max())
        check(np.allclose(got, g["logits"], rtol=ZOO_TOL, atol=ZOO_TOL),
              f"{name}: card logits off the golden by {err:.3e}")
        out[name] = err
    return out


class ForwardEvents:
    """Swap ``NNModel._run`` for one that brackets each minibatch's
    forward in CUDA events: the device time of the forwards alone."""

    def __init__(self, model):
        self.model, self.pairs = model, []

    def __enter__(self):
        run = self.model._run

        def timed(module, x):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            y = run(module, x)
            b.record()
            self.pairs.append((a, b))
            return y
        self.model._run = timed
        return self

    def __exit__(self, *exc):
        del self.model._run

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3


def forward_profile(scorer, x, n: int = 3) -> dict:
    """One minibatch's forward under ``torch.profiler``: device ms and
    kernel launches per forward, and the six costliest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev, module = scorer._device_setup()
    scorer._run(module, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            scorer._run(module, x)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": sum(r[1] for r in rows),
            "launches": sum(r[2] for r in rows),
            "top": [{"kernel": k[:80], "ms": ms, "launches": c}
                    for k, ms, c in rows[:6]]}


def scoring_cell(card_line) -> dict:
    """``bench_cifar10_scoring`` (``bench.py:216-272``): ResNet-20 in
    bf16, batch 1024, 10 240 seeded images, ``cache_inputs=False``, one
    warm pass then the median of 3; device-only images/s from CUDA
    events over the forwards, the host's share parted (stack, bf16
    cast, upload), and 1024 rows against the port's CPU ``NNModel``."""
    arch = {"builder": "cifar_resnet", "depth": 20, "dtype": "bfloat16"}
    fn = NNFunction.init(arch, input_shape=(32, 32, 3), seed=0)
    images = np.random.default_rng(0).uniform(
        0, 1, size=(FRAME_IMAGES, 32, 32, 3)).astype(np.float32)
    df = DataFrame({"image": images})
    scorer = NNModel(model=fn, input_col="image", output_col="scores",
                     batch_size=FRAME_BATCH, cache_inputs=False)
    scorer.transform(df.head(FRAME_BATCH))           # warm
    walls, device_s, scores = [], [], None
    for _ in range(3):
        with ForwardEvents(scorer) as ev:
            t0 = time.perf_counter()
            scores = scorer.transform(df)["scores"]
            walls.append(time.perf_counter() - t0)
        device_s.append(ev.seconds())
    check(scores.shape == (FRAME_IMAGES, 10) and np.isfinite(scores).all(),
          f"scores {scores.shape}, finite {np.isfinite(scores).all()}")
    # the host's share of one pass, parted
    t0 = time.perf_counter()
    stacked = NN._stack_column(df["image"])
    t_stack = time.perf_counter() - t0
    t0 = time.perf_counter()
    wire = NN._host_cast(stacked, "bfloat16")
    t_cast = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, FRAME_IMAGES, FRAME_BATCH):
        NN._device_put(wire[s:s + FRAME_BATCH], DEV, "bfloat16")
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    prof = forward_profile(scorer, NN._device_put(
        wire[:FRAME_BATCH], DEV, "bfloat16"))
    cpu = NNModel(model=fn, input_col="image", batch_size=FRAME_BATCH,
                  device="cpu").transform(df.head(FRAME_BATCH))["scores"]
    err = frame_err(scores[:FRAME_BATCH], cpu)
    check(err <= FRAME_BF16_TOL, f"card scores off the CPU's by {err:.3e}")
    median = float(np.median(walls))
    out = {"images_per_s": FRAME_IMAGES / median,
           "images_per_s_passes": [FRAME_IMAGES / w for w in walls],
           "device_only_images_per_s": FRAME_IMAGES / float(
               np.median(device_s)),
           "device_s_passes": device_s,
           "h2d_mb_per_s": wire.nbytes / t_upload / 1e6,
           "host_split_s": {"stack": t_stack, "bf16_cast": t_cast,
                            "upload": t_upload},
           "wall_s_passes": walls, "card_vs_cpu_err": err,
           "forward_profile": prof}
    print(f"[{card_line}] cifar10 scoring (ResNet-20 bf16, batch "
          f"{FRAME_BATCH}, {FRAME_IMAGES} images, fresh frames): "
          f"{out['images_per_s']:.1f} images/s (median of 3; passes "
          + ", ".join(f"{v:.1f}" for v in out["images_per_s_passes"])
          + f"), device-only {out['device_only_images_per_s']:.1f} "
          f"images/s; host: stack {t_stack * 1e3:.2f} ms, bf16 cast of "
          f"{stacked.size / 1e6:.1f} M floats {t_cast * 1e3:.2f} ms, "
          f"upload {t_upload * 1e3:.2f} ms ({out['h2d_mb_per_s']:.1f} "
          f"MB/s); card vs CPU scores {err:.3e}")
    print(f"[{card_line}] one {FRAME_BATCH}-image forward: "
          f"{prof['device_ms']:.3f} ms of device time in "
          f"{prof['launches']:.0f} kernel launches; costliest: "
          + "; ".join(f"{t['kernel']} {t['ms']:.3f} ms x{t['launches']:.0f}"
                      for t in prof["top"]))
    return out


def uint8_wire_cell(card_line) -> dict:
    """``bench_cifar10_scoring_uint8`` (``bench.py:301``): the same
    network fed uint8 images, dequantized on the card; rows equal the
    normalized-float path within bf16's step, and a ``ServingServer``
    with the uint8 wire counts the frame's own bytes in
    ``serving_wire_bytes_total{dtype="uint8"}``."""
    arch = {"builder": "cifar_resnet", "depth": 20, "dtype": "bfloat16"}
    fn = NNFunction.init(arch, input_shape=(32, 32, 3), seed=0)
    u8 = np.random.default_rng(0).integers(0, 256, (2048, 32, 32, 3),
                                           dtype=np.uint8)
    a = NNModel(model=fn, input_col="image", batch_size=FRAME_BATCH,
                input_dtype="uint8", cache_inputs=False).transform(
                    DataFrame({"image": u8}))["scores"]
    b = NNModel(model=fn, input_col="image", batch_size=FRAME_BATCH,
                cache_inputs=False).transform(
                    DataFrame({"image": u8.astype(np.float32) / 255.0})
                )["scores"]
    err = frame_err(a, b)
    check(err <= FRAME_BF16_TOL, f"uint8 wire off the float path by {err}")
    n_req = 16
    srv = ServingServer(NNModel(model=fn, input_col="image",
                                batch_size=64), port=0,
                        max_batch_size=64, max_latency_ms=2,
                        bucket_batches=False,
                        quantization={"wire_dtype": "uint8",
                                      "scale": 1.0 / 255.0}).start()
    try:
        rows = []
        for x in u8[:n_req]:
            status, _, body = http_call(srv, "POST", "/predict",
                                        {"image": x.tolist()})
            check(status == 200, f"/predict replied {status}: {body[:200]}")
            rows.append(json.loads(body)["scores"])
        _, _, text = http_call(srv, "GET", "/metrics")
    finally:
        srv.stop()
    line = [ln for ln in text.decode().splitlines() if ln.startswith(
        'serving_wire_bytes_total{dtype="uint8"}')]
    wire_bytes = float(line[0].split()[-1]) if line else -1.0
    check(wire_bytes == u8[:n_req].nbytes,
          f"uint8 wire bytes {wire_bytes} != {u8[:n_req].nbytes}")
    served = frame_err(rows, a[:n_req])
    check(served <= FRAME_BF16_TOL, f"served uint8 rows off by {served}")
    print(f"[{card_line}] uint8 wire: rows {err:.3e} from the float path, "
          f"served rows {served:.3e}; serving_wire_bytes_total{{uint8}} "
          f"{wire_bytes:.0f} = the frames' {u8[:n_req].nbytes} bytes")
    return {"u8_vs_float_err": err, "served_err": served,
            "wire_bytes": wire_bytes}


def quant_cell(card_line) -> dict:
    """Compute quantization on bench.py's ``quantized_compute_v1`` model
    (an MLP 512 -> 128 -> 128 -> 8, bf16 activations, tolerance 5e-2):
    ``quant_parity_report`` passes on the card, and a corrupted scale
    fails it."""
    from mmlspark_tpu_torch.serving.quant import QuantizationConfig
    fn = NNFunction.init({"builder": "mlp", "hidden": [128, 128],
                          "num_outputs": 8}, input_shape=(QUANT_D_IN,),
                         seed=0)
    rows = np.random.default_rng(0).standard_normal(
        (256, QUANT_D_IN)).astype(np.float32) * 0.5
    df = DataFrame({"x": rows})

    def cfg(mult):
        return QuantizationConfig.from_value({
            "wire_dtype": "none", "compute": {
                "weight_dtype": "int8", "activation_dtype": "bfloat16",
                "tolerance": 5e-2, "scale_multiplier": mult}})
    m = NNModel(model=fn, input_col="x", batch_size=256,
                input_dtype="float32", quantization=cfg(1.0))
    report = m.quant_parity_report(df)
    check(report["passed"], f"int8 compute parity failed: {report}")
    scores = m.transform(df)["scores"]
    check(scores.shape == (256, 8) and np.isfinite(scores).all(),
          "int8 scores")
    broken = NNModel(model=fn, input_col="x", batch_size=256,
                     input_dtype="float32", quantization=cfg(7.0))
    bad = broken.quant_parity_report(df)
    check(not bad["passed"], f"a corrupted scale passed parity: {bad}")
    print(f"[{card_line}] int8 compute: parity {report['rows']} rows, "
          f"max_rel {report['max_rel']:.3e} (tolerance 5e-2); a x7 scale "
          f"fails with {bad['bad_rows']} bad rows")
    return {"report": report, "corrupted": bad}


class _Addr:
    def __init__(self, port):
        self.host, self.port = "127.0.0.1", port


def spawn_worker(model_uri, **extra_env):
    """``python -m mmlspark_tpu_torch.serving worker`` on the card (no
    CPU request): the process and its address once it serves.
    ``extra_env``: more of the worker's environment knobs."""
    env = dict(os.environ, PORT="0", MODEL_URI=model_uri,
               MAX_LATENCY_MS="1", PYTHONPATH=REPO_ROOT, **extra_env)
    env.pop("MMLSPARK_TPU_SERVING_CPU", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.serving", "worker"],
        env=env, cwd=REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    while True:
        line = proc.stdout.readline()
        if not line:
            err = proc.stderr.read()
            raise SystemExit(f"worker exited rc={proc.poll()}: {err[-2000:]}")
        if "worker serving" in line:
            return proc, _Addr(int(line.strip().rsplit(":", 1)[1]))


def stop_worker(proc) -> None:
    proc.send_signal(signal.SIGTERM)
    try:
        check(proc.wait(timeout=60) == 0, f"worker rc {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def worker_cell(tmp, card_line) -> dict:
    """The worker entry on the card: a saved ``NNModel`` (the zoo's
    cifar10s_resnet20, f32, uint8 wire) and a saved
    ``GBDTRegressor`` (fit on the card: K9 launches counted), each
    served by ``python -m mmlspark_tpu_torch.serving worker``; rows
    equal the direct transform at 1e-5, and ``/stats`` names the card
    in ``placement``."""
    out = {}
    fn = NNFunction.load(os.path.join(REPO_ROOT, "zoo", "cifar10s_resnet20"))
    model = NNModel(model=fn, input_col="image", input_dtype="uint8",
                    batch_size=64)
    path = os.path.join(tmp, "nn_model")
    model.save(path)
    u8 = np.random.default_rng(1).integers(0, 256, (8, 32, 32, 3),
                                           dtype=np.uint8)
    direct = model.transform(DataFrame({"image": u8}))["scores"]
    t0 = time.perf_counter()
    proc, addr = spawn_worker(path)
    try:
        out["nn_worker_start_s"] = time.perf_counter() - t0
        rows = []
        for x in u8:
            status, _, body = http_call(addr, "POST", "/predict",
                                        {"image": x.tolist()})
            check(status == 200, f"worker /predict {status}: {body[:200]}")
            rows.append(json.loads(body)["scores"])
        _, _, body = http_call(addr, "GET", "/stats")
        placement = json.loads(body)["placement"]
    finally:
        stop_worker(proc)
    out["nn_err"] = frame_err(rows, direct)
    check(out["nn_err"] <= WORKER_TOL, f"worker rows off by {out['nn_err']}")
    check(placement.get("mode") == "single_device"
          and placement.get("devices") == ["cuda:0"]
          and placement.get("device_kind") == torch.cuda.get_device_name(0),
          f"worker placement {placement}")
    out["placement"] = placement

    rng = np.random.default_rng(2)
    X = rng.normal(size=(4096, 8))
    y = X[:, 0] * 2.0 - X[:, 1] + 0.1 * rng.normal(size=len(X))
    df = DataFrame({"features": X, "label": y})
    iters, leaves = 5, 7
    before = CH.LAUNCHES["gbdt_histogram"]
    gbdt = GBDTRegressor(num_iterations=iters, num_leaves=leaves,
                         min_data_in_leaf=20).fit(df)
    k9 = CH.LAUNCHES["gbdt_histogram"] - before
    check(k9 == iters * leaves, f"K9 launched {k9} times in the stage's "
                                f"fit, expected {iters * leaves}")
    check(gbdt.booster.device.type == "cuda", "the stage fit off the card")
    gpath = os.path.join(tmp, "gbdt")
    gbdt.save(gpath)
    direct = gbdt.transform(DataFrame({"features": X[:8]}))["prediction"]
    t0 = time.perf_counter()
    proc, addr = spawn_worker(gpath)
    try:
        out["gbdt_worker_start_s"] = time.perf_counter() - t0
        preds = []
        for x in X[:8]:
            status, _, body = http_call(addr, "POST", "/predict",
                                        {"features": x.tolist()})
            check(status == 200, f"gbdt /predict {status}: {body[:200]}")
            preds.append(json.loads(body)["prediction"])
    finally:
        stop_worker(proc)
    out["gbdt_err"] = frame_err(preds, direct)
    out["k9_launches"] = k9
    check(out["gbdt_err"] <= WORKER_TOL, f"gbdt rows off by {out['gbdt_err']}")
    print(f"[{card_line}] worker entry on the card: NNModel rows "
          f"{out['nn_err']:.3e} from direct (started in "
          f"{out['nn_worker_start_s']:.1f} s; placement "
          f"{placement['devices']} {placement['device_kind']}), "
          f"GBDTRegressor rows {out['gbdt_err']:.3e} (started in "
          f"{out['gbdt_worker_start_s']:.1f} s; K9 {k9} launches in its fit)")
    return out


def frame_phase(card_line) -> dict:
    """Phase 21: the zoo on the card, the scoring cells, compute
    quantization and the worker entry; each part's seconds printed."""
    out, secs = {}, {}
    with tempfile.TemporaryDirectory(dir=REPO_ROOT,
                                     prefix="_frame_phase_") as tmp:
        for name, run in (
                ("zoo", lambda: zoo_check(os.path.join(tmp, "zoo"))),
                ("cifar10_scoring", lambda: scoring_cell(card_line)),
                ("uint8_wire", lambda: uint8_wire_cell(card_line)),
                ("int8_compute", lambda: quant_cell(card_line)),
                ("worker", lambda: worker_cell(tmp, card_line))):
            t0 = time.perf_counter()
            out[name] = run()
            secs[name] = time.perf_counter() - t0
    out["seconds"] = secs
    print(f"[{card_line}] zoo goldens on the card (max abs error): "
          + ", ".join(f"{k} {v:.2e}" for k, v in out["zoo"].items()))
    print(f"[{card_line}] frame plane seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return out


# ---------------------------------------------------------------------------
# phases 22-23: frame training and features

#: where the phases' stages run: None is the card, every entry point's
#: default (a CPU rehearsal sets "cpu")
STAGE_DEVICE = None
SGD_ARCH = {"builder": "cifar_resnet", "depth": 20, "dtype": "bfloat16"}
SGD_BATCH, SGD_STEPS = 256, 20
# bench.py's rate, 0.1 (with momentum 0.9), diverges on one fixed batch
# of random labels, the port as JAX (optax's update rules, held by
# tests/test_torch_trainer.py): the loss leaves every bound within a
# few steps. A step's work does not depend on the rate, so the cells
# train at 0.01, where the loss falls, and the timing is bench.py's.
SGD_LR = 0.01
FIT_IMAGES, FIT_BATCH, FIT_EPOCHS = 4096, 256, 2
PARITY_BATCH, PARITY_STEPS = 32, 3
# card against CPU after 3 f32 steps of ResNet-20 at SGD_LR, TF32 off:
# cuDNN's and the CPU's convolutions sum in other orders, nothing else
TRAIN_PARITY_TOL = 1e-4
FEAT_IMAGES, FEAT_CPU_ROWS = 2048, 256
FEAT_GBDT = {"num_iterations": 20, "num_leaves": 7}
IMAGE_CHAIN_TOL = 1e-5


def conv_dense_flops(module, x) -> tuple:
    """One forward's FLOPs from the conv and dense shapes it runs
    (2 x multiply-adds), and the shapes by count."""
    from collections import Counter
    from mmlspark_tpu_torch.models.function import Conv, Dense
    seen, hooks = [], []

    def record(mod, _, out):
        o, i = int(mod.weight.shape[0]), int(mod.weight.shape[1])
        if isinstance(mod, Conv):
            kh, kw = mod.kernel_size
            n, ho, wo = out.shape[0], out.shape[1], out.shape[2]
            seen.append((f"conv {kh}x{kw}/{mod.strides[0]} {i}->{o} out "
                         f"{ho}x{wo}", 2 * n * ho * wo * o * i * kh * kw))
        else:
            seen.append((f"dense {i}->{o}", 2 * out.shape[0] * i * o))
    for mod in module.modules():
        if isinstance(mod, (Conv, Dense)):
            hooks.append(mod.register_forward_hook(record))
    try:
        with torch.no_grad():
            module(x)
    finally:
        for h in hooks:
            h.remove()
    counts = Counter(name for name, _ in seen)
    return float(sum(f for _, f in seen)), dict(counts)


def train_step_profile(step, x, y, w, n: int = 3) -> dict:
    """``n`` train steps under ``torch.profiler``: device ms and kernel
    launches a step, and the eight costliest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step(x, y, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(x, y, w)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": sum(r[1] for r in rows),
            "launches": sum(r[2] for r in rows),
            "top": [{"kernel": k[:80], "ms": ms, "launches": c}
                    for k, ms, c in rows[:8]]}


def sgd_cell(card_line) -> dict:
    """``bench_distributed_sgd``'s shape (``bench.py:391-470``):
    ResNet-20 in bf16, batch 256, seeded uniform images, labels 0-9,
    weights 1, ``make_optimizer("momentum", SGD_LR)`` and the step of
    ``NNLearner.build_train_step``; a warm step, then 20 steps on the one
    batch. MFU counts three times the forward's conv and dense FLOPs
    against the bf16 peak."""
    fn = NNFunction.init(SGD_ARCH, (32, 32, 3), seed=0)
    dev = torch.device("cpu") if STAGE_DEVICE == "cpu" else DEV
    module = fn.to_module(dev)
    step = NNLearner(arch=fn.arch, learning_rate=SGD_LR).build_train_step(
        module, make_optimizer("momentum", SGD_LR),
        make_loss("softmax_cross_entropy"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (SGD_BATCH, 32, 32, 3)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 10, SGD_BATCH)).to(dev)
    w = torch.ones(SGD_BATCH, device=dev)
    fwd_flops, shapes = conv_dense_flops(module, x)
    ptrs = [p.data_ptr() for p in step.params]
    first = float(step(x, y, w))                       # warm
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    pairs, losses = [], []
    t0 = time.perf_counter()
    for _ in range(SGD_STEPS):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            losses.append(step(x, y, w))
            b.record()
            pairs.append((a, b))
        else:
            losses.append(step(x, y, w))
    sync()
    wall = (time.perf_counter() - t0) / SGD_STEPS
    losses = [float(v) for v in losses]
    event_ms = (sum(a.elapsed_time(b) for a, b in pairs) / SGD_STEPS
                if pairs else float("nan"))
    check(np.isfinite([first, *losses]).all(), f"losses {losses}")
    check(losses[-1] < first, f"loss did not fall: {first} -> {losses[-1]}")
    check([p.data_ptr() for p in step.params] == ptrs,
          "a parameter left its storage")
    prof = train_step_profile(step, x, y, w) if dev.type == "cuda" else {}
    flops = 3.0 * fwd_flops
    out = {"ms_per_step": wall * 1e3, "steps_per_s": 1.0 / wall,
           "event_ms_per_step": event_ms,
           "flops_per_step": flops, "forward_shapes": shapes,
           "mfu": flops / wall / PEAK_BF16_FLOPS,
           "first_loss": first, "last_loss": losses[-1],
           "profile": prof}
    if prof:
        out["device_ms_per_step"] = prof["device_ms"]
        out["mfu_device"] = flops / (prof["device_ms"] / 1e3) \
            / PEAK_BF16_FLOPS
    print(f"[{card_line}] bench_distributed_sgd shape (ResNet-20 bf16, "
          f"batch {SGD_BATCH}, momentum at {SGD_LR}, {SGD_STEPS} steps after "
          f"a warm one): {out['ms_per_step']:.2f} ms a step of wall, "
          f"{out['steps_per_s']:.2f} steps/s, CUDA events "
          f"{event_ms:.2f} ms a step, device {prof.get('device_ms', 0):.2f} "
          f"ms in {prof.get('launches', 0):.0f} launches; "
          f"{flops / 1e9:.1f} GFLOP a step (3 x the forward's convs and "
          f"dense), MFU {out['mfu']:.4f} of {PEAK_BF16_FLOPS / 1e12:.0f} "
          f"TFLOP/s; loss {first:.4f} -> {losses[-1]:.4f}")
    print(f"[{card_line}] forward shapes: "
          + "; ".join(f"{k} x{v}" for k, v in shapes.items()))
    if prof:
        print(f"[{card_line}] a train step's costliest kernels: "
              + "; ".join(f"{t['kernel']} {t['ms']:.3f} ms "
                          f"x{t['launches']:.0f}" for t in prof["top"]))
    return out


def fit_cell(card_line) -> dict:
    """``NNLearner.fit`` end to end on 4096 seeded 32x32x3 images,
    batch 256, 2 epochs: the host loop on f32 images, then the
    device-resident loop on uint8 images with ``flip_crop``; each
    fitted model scores on the card."""
    rng = np.random.default_rng(0)
    xf = rng.uniform(0, 1, (FIT_IMAGES, 32, 32, 3)).astype(np.float32)
    xu = rng.integers(0, 256, (FIT_IMAGES, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, FIT_IMAGES)
    out = {}
    for name, x, kw in (("host_f32", xf, {}),
                        ("resident_uint8_flip_crop", xu,
                         {"device_resident": True, "augment": "flip_crop"})):
        learner = NNLearner(arch=SGD_ARCH, epochs=FIT_EPOCHS,
                            batch_size=FIT_BATCH, learning_rate=SGD_LR,
                            log_every=0, device=STAGE_DEVICE, **kw)
        t0 = time.perf_counter()
        model = learner.fit(DataFrame({"features": x, "label": y}))
        secs = time.perf_counter() - t0
        epoch_loss = [float(np.mean(v)) for v in learner.losses]
        check(np.isfinite(np.concatenate(learner.losses)).all(),
              f"{name}: losses {epoch_loss}")
        scores = model.transform(DataFrame({"features": x[:FIT_BATCH]}))[
            "scores"]
        check(scores.shape == (FIT_BATCH, 10) and np.isfinite(scores).all(),
              f"{name}: scores {scores.shape}")
        place = model.placement()
        if STAGE_DEVICE is None:
            check(place.get("devices") == ["cuda:0"],
                  f"{name}: placement {place}")
        out[name] = {"examples_per_s": FIT_IMAGES * FIT_EPOCHS / secs,
                     "seconds": secs, "epoch_loss": epoch_loss,
                     "steps": int(sum(len(v) for v in learner.losses)),
                     "input_dtype": model.input_dtype,
                     "placement": place.get("devices")}
        print(f"[{card_line}] NNLearner.fit {name}: {FIT_IMAGES} images x "
              f"{FIT_EPOCHS} epochs in {secs:.2f} s "
              f"({out[name]['examples_per_s']:.0f} examples/s), loss per "
              f"epoch " + ", ".join(f"{v:.4f}" for v in epoch_loss)
              + f"; scores on {place.get('devices')}")
    return out


def train_parity_cell(card_line) -> dict:
    """3 f32 steps of one ``NNLearner`` (ResNet-20, no augmentation, the
    same initial weights) on the card (TF32 off) and on the CPU: every
    step's loss and the parameters."""
    from mmlspark_tpu_torch.models.function import flatten_params
    arch = {"builder": "cifar_resnet", "depth": 20}
    fn = NNFunction.init(arch, (32, 32, 3), seed=1)
    rng = np.random.default_rng(1)
    n = PARITY_BATCH * PARITY_STEPS
    df = DataFrame({"features": rng.uniform(0, 1, (n, 32, 32, 3)).astype(
        np.float32), "label": rng.integers(0, 10, n)})
    runs = {}
    for name, device in (("card", STAGE_DEVICE), ("cpu", "cpu")):
        learner = NNLearner(model=fn, epochs=1, batch_size=PARITY_BATCH,
                            learning_rate=SGD_LR, cosine_decay=False,
                            log_every=0, device=device)
        model = learner.fit(df)
        runs[name] = (learner.losses[0], flatten_params(model.model.params))
    (lc, pc), (lr, pr) = runs["card"], runs["cpu"]
    loss_err = float(np.abs(lc - lr).max() / np.abs(lr).max())
    param_err = max(frame_err(pc[k], pr[k]) for k in pr)
    print(f"[{card_line}] {PARITY_STEPS} f32 steps, card (TF32 off) against "
          f"CPU: losses {', '.join(f'{v:.6f}' for v in lc)} vs "
          f"{', '.join(f'{v:.6f}' for v in lr)}, relative {loss_err:.3e}; "
          f"params {param_err:.3e} (tolerance {TRAIN_PARITY_TOL})")
    check(loss_err <= TRAIN_PARITY_TOL, f"train losses off by {loss_err}")
    check(param_err <= TRAIN_PARITY_TOL, f"train params off by {param_err}")
    return {"loss_rel_err": loss_err, "param_err": param_err,
            "card_losses": lc.tolist(), "cpu_losses": lr.tolist()}


def frame_train_phase(card_line) -> tuple:
    """Phase 22: ``bench_distributed_sgd``'s shape, ``NNLearner.fit`` on
    both loops, and 3 f32 steps card against CPU; no kernel launched."""
    out, secs = {}, {}
    reset_launch_counts()
    for name, run in (("distributed_sgd", lambda: sgd_cell(card_line)),
                      ("fit", lambda: fit_cell(card_line)),
                      ("card_vs_cpu", lambda: train_parity_cell(card_line))):
        t0 = time.perf_counter()
        out[name] = run()
        secs[name] = time.perf_counter() - t0
    launches = read_launch_counts()
    check(not any(launches.values()),
          f"frame training launched kernels: {launches}")
    out["seconds"] = secs
    print(f"[{card_line}] frame training seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
          + "; K1-K9 launches 0")
    return launches, out


def image_chain_cell(card_line) -> dict:
    """An ``ImageTransformer`` chain on the card (resize 64 -> 32 and
    32 -> 48, box blur, threshold, normalize) against the CPU's."""
    x = np.random.default_rng(3).uniform(0, 255, (64, 64, 64, 3)).astype(
        np.float32)

    def chain(device):
        # THRESH_TOZERO: the values above the threshold pass on, with
        # whatever rounding the resizes and the blur gave them
        return ImageTransformer(output_col="o", device=device).resize(
            32, 32).resize(48, 48).blur(3, 3).threshold(
            60.0, 255.0, 3).normalize([120.0, 110.0, 100.0],
                                      [60.0, 55.0, 50.0])
    df = DataFrame({"image": x})
    got = chain(STAGE_DEVICE).transform(df)["o"]
    err = frame_err(got, chain("cpu").transform(df)["o"])
    check(got.shape == (64, 48, 48, 3), f"chain shape {got.shape}")
    check(err <= IMAGE_CHAIN_TOL, f"image chain off the CPU by {err}")
    return {"err": err}


def features_phase(card_line) -> tuple:
    """Phase 23: ``bench_transfer_learning``'s shape (``bench.py:346-388``):
    a ResNet-14 bf16 backbone from ``NNFunction.init(seed=0)``, 2048
    seeded separable images, ``ImageFeaturizer(cut_output_layers=1)``
    then ``TrainClassifier(GBDTClassifier(20 iterations, 7 leaves))``;
    two warm runs, then the median of 2, split into featurize and fit."""
    from mmlspark_tpu_torch.ops import image as OPS
    backbone = NNFunction.init(
        {"builder": "cifar_resnet", "depth": 14, "dtype": "bfloat16"},
        input_shape=(32, 32, 3), seed=0)
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, FEAT_IMAGES)
    images = (rng.uniform(0, 1, (FEAT_IMAGES, 32, 32, 3)) * 0.5
              + y[:, None, None, None] * 0.45).astype(np.float32)
    df = DataFrame({"image": images, "label": y})
    featurizer = ImageFeaturizer(model=backbone, input_col="image",
                                 output_col="embedding", cut_output_layers=1,
                                 device=STAGE_DEVICE)

    def run():
        t0 = time.perf_counter()
        feats = featurizer.transform(df)
        t1 = time.perf_counter()
        model = TrainClassifier(
            model=GBDTClassifier(device=STAGE_DEVICE, **FEAT_GBDT),
            label_col="label").fit(feats.select(["embedding", "label"]))
        return feats, model, (t1 - t0, time.perf_counter() - t1)
    n_runs = 4
    reset_launch_counts()
    passes = [run() for _ in range(n_runs)]
    launches = read_launch_counts()
    per_fit = FEAT_GBDT["num_iterations"] * 1 * FEAT_GBDT["num_leaves"]
    if STAGE_DEVICE is None:
        check(launches["gbdt_histogram"] == n_runs * per_fit,
              f"K9 launched {launches['gbdt_histogram']} times in "
              f"{n_runs} fits, expected {n_runs} x {per_fit}")
    check(not any(v for k, v in launches.items() if k != "gbdt_histogram"),
          f"the features path launched {launches}")
    timed = [p[2] for p in passes[2:]]
    totals = [a + b for a, b in timed]
    feats, model = passes[-1][0], passes[-1][1]
    emb = feats["embedding"]
    check(emb.shape == (FEAT_IMAGES, 64) and np.isfinite(emb).all(),
          f"features {emb.shape}")
    pred = model.transform(feats.select(["embedding", "label"]))["prediction"]
    acc = float(np.mean(np.asarray(pred) == y))
    check(acc >= 0.9, f"train accuracy {acc}")
    cpu = ImageFeaturizer(model=backbone, input_col="image",
                          output_col="embedding", cut_output_layers=1,
                          device="cpu").transform(df.head(FEAT_CPU_ROWS))
    feat_err = frame_err(emb[:FEAT_CPU_ROWS], cpu["embedding"])
    check(feat_err <= FRAME_BF16_TOL, f"card features off the CPU's by "
                                      f"{feat_err}")
    chain = image_chain_cell(card_line)
    # ImageFeaturizer with input_shape resizes where it scores
    seen = []
    resize = OPS.resize

    def spy(images, *a, **k):
        seen.append(images.device.type)
        return resize(images, *a, **k)
    OPS.resize = spy
    try:
        big = np.random.default_rng(4).uniform(0, 1, (256, 64, 64, 3)) \
            .astype(np.float32)
        out64 = ImageFeaturizer(model=backbone, input_col="image",
                                input_shape=[32, 32, 3],
                                device=STAGE_DEVICE).transform(
            DataFrame({"image": big}))["features"]
    finally:
        OPS.resize = resize
    want = "cpu" if STAGE_DEVICE == "cpu" else "cuda"
    check(seen == [want] and out64.shape == (256, 64),
          f"input_shape resize ran on {seen}, out {out64.shape}")
    out = {"seconds_median": float(np.median(totals)),
           "seconds_passes": totals,
           "featurize_s_median": float(np.median([a for a, _ in timed])),
           "fit_s_median": float(np.median([b for _, b in timed])),
           "warm_passes_s": [sum(p[2]) for p in passes[:2]],
           "k9_launches": launches["gbdt_histogram"],
           "k9_per_fit": per_fit, "train_accuracy": acc,
           "card_vs_cpu_features_err": feat_err,
           "image_chain_err": chain["err"], "resize_device": seen}
    print(f"[{card_line}] bench_transfer_learning shape (ResNet-14 bf16 "
          f"features of {FEAT_IMAGES} images, then TrainClassifier("
          f"GBDTClassifier 20 x 7)): {out['seconds_median']:.3f} s median "
          f"of 2 (featurize {out['featurize_s_median']:.3f}, fit "
          f"{out['fit_s_median']:.3f}; passes "
          + ", ".join(f"{v:.3f}" for v in totals) + "); K9 "
          f"{out['k9_launches']} = {n_runs} fits x {per_fit}; train accuracy "
          f"{acc:.3f}; card vs CPU features {feat_err:.3e} (3e-2); image "
          f"chain {chain['err']:.3e} (1e-5); input_shape resize on {seen}")
    return launches, out


# ---------------------------------------------------------------------------
# phase 24: MoE training (slice 17)

#: bench.py's bench_moe_train (bench.py:1184-1247): the train bench's
#: width in bf16, 8 experts, top-2, capacity 1.25, the Switch aux and the
#: router z-loss, the sort engine, B 8 x S 1024, rate 0.01, momentum 0.9
MOE_TRAIN_CFG = dataclasses.replace(
    TRAIN_CFG, n_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
    moe_aux_weight=0.01, moe_zloss_weight=1e-3, moe_dispatch="sort")
MOE_WARM, MOE_STEPS = 2, 10
#: the MoE step's kernels a step: the dense train step's (K7's three once a
#: layer, K4's training variant and K6's two once), no decode kernel
MOE_TRAIN_LAUNCHES = {**TRAIN_LAUNCHES,
                      **{n: 0 for n in PAGED_PATH_KERNELS}}
#: sort against scatter, one bf16 step from the same weights: the same
#: routings drop and the same rows reach the same products; what may
#: differ is the order of CUDA's atomic adds (the embedding's and the
#: gathers' backward). Loss relative, parameters absolute.
MOE_ENGINE_TOL = 1e-5
#: card against CPU, f32 (TF32 off; the card's attention and CE kernels
#: run 3xTF32), 2 layers, B 2 x S 256: the losses relative, the
#: parameters absolute after the steps
MOE_PARITY_LAYERS, MOE_PARITY_B, MOE_PARITY_S = 2, 2, 256
MOE_PARITY_TOL = 1e-4


def moe_flops_per_step(cfg, b, s) -> float:
    """bench.py's analytic MoE train FLOPs (bench_moe_train): the executed
    expert slots (factor x k a token) and the router, 6 x matmul params x
    tokens + 12 x L x b x s^2 x d_attn."""
    d_attn = cfg.n_heads * cfg.d_head
    expert_macs = (cfg.moe_capacity_factor * cfg.moe_top_k
                   * 2 * cfg.d_model * cfg.d_ff)
    n_matmul = (cfg.d_model * cfg.vocab
                + cfg.n_layers * (4 * cfg.d_model * d_attn
                                  + cfg.d_model * cfg.n_experts
                                  + expert_macs))
    return 6.0 * n_matmul * b * s + 12.0 * cfg.n_layers * b * s * s * d_attn


def moe_drop_shares(params, cfg, batch) -> list:
    """Each layer's share of routings dropped over capacity on ``batch``:
    one forward without gradients, the sort engine watched (its calls
    come in layer order)."""
    seen = []
    engine = T._sorted_capacity_queues

    def watched(h_rep, top, wf, E, C, dt):
        slot, _ = T._queue_slots(top, E)
        seen.append(float((slot >= C).float().mean()))
        return engine(h_rep, top, wf, E, C, dt)

    T._sorted_capacity_queues = watched
    try:
        with torch.no_grad():
            T.local_loss(params, *batch, cfg)
    finally:
        T._sorted_capacity_queues = engine
    check(len(seen) == cfg.n_layers, f"{len(seen)} capacity dispatches")
    return seen


def moe_route_steps(cfg, tree, mesh, batch) -> dict:
    """Each route at the bench shape, from the same initial weights: one
    step (its loss and parameters), then a second step timed."""
    out = {}
    for name, kw in (("sort", {}), ("scatter", {"moe_dispatch": "scatter"}),
                     ("dense", {"moe_capacity_factor": 0.0}),
                     ("expert_choice", {"moe_router": "expert_choice"})):
        c = dataclasses.replace(cfg, **kw)
        params = T.shard_params(tree, c, mesh)
        vel = T.init_velocity(params)
        step = T.build_spmd_train_step(c, mesh, TRAIN_LR, TRAIN_MOMENTUM)
        loss = float(step(params, vel, *batch)[2])
        first = T.params_to_numpy(params) if name in ("sort", "scatter") \
            else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss2 = float(step(params, vel, *batch)[2])
        ms = (time.perf_counter() - t0) * 1e3
        check(np.isfinite([loss, loss2]).all(),
              f"{name}: non-finite loss {loss}, {loss2}")
        out[name] = {"loss": loss, "ms": ms, "params": first}
        del params, vel
        torch.cuda.empty_cache()
    return out


def min_topk_gap(run):
    """``run()``'s result and the smallest gap between the k-th and the
    (k+1)-th router probability that any of its routings met (the
    margin a rounding would need to flip an expert)."""
    gaps = []
    route = T._route_top_k

    def watched(probs, k):
        top = torch.topk(probs.detach(), k + 1, dim=-1).values
        gaps.append(float((top[..., k - 1] - top[..., k]).min()))
        return route(probs, k)

    T._route_top_k = watched
    try:
        return run(), min(gaps)
    finally:
        T._route_top_k = route


def moe_card_vs_cpu(card_line) -> dict:
    """f32 with TF32 off, 2 layers, B 2 x S 256, the same bridged
    weights on both sides: 3 steps of the ``{"data": 1}`` step and one
    step on a hosted ``{"data": 2, "expert": 2}`` mesh."""
    cfg = dataclasses.replace(MOE_TRAIN_CFG, dtype="float32",
                              layers_per_stage=MOE_PARITY_LAYERS)
    tree = T.init_params_np(cfg, seed=SEED)
    batch = T.make_batch(np.random.default_rng(SEED), cfg, MOE_PARITY_B,
                         MOE_PARITY_S, "cpu")
    out = {}
    for shape, n in (({"data": 1}, 3), ({"data": 2, "expert": 2}, 1)):
        runs = {}
        for where in ("card", "cpu"):
            device = DEV if where == "card" else "cpu"
            mesh = build_mesh(MeshSpec.from_dict(shape), device)
            params = T.shard_params(tree, cfg, mesh)
            vel = T.init_velocity(params)
            step = T.build_spmd_train_step(cfg, mesh, TRAIN_LR,
                                           TRAIN_MOMENTUM)
            b = [t.to(device) for t in batch]

            def run():
                with ieee_f32():
                    return [float(step(params, vel, *b)[2])
                            for _ in range(n)]
            losses, gap = min_topk_gap(run)
            runs[where] = (losses, T.params_to_numpy(params), gap)
        (lc, pc, gc), (lr, pr, gr) = runs["card"], runs["cpu"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lr))
        param = max(float(np.abs(a - b).max())
                    for a, b in zip(T._leaves(pc), T._leaves(pr)))
        key = "data1" if len(shape) == 1 else "data2_expert2"
        out[key] = {"card_losses": lc, "cpu_losses": lr,
                    "loss_rel_err": loss_rel, "param_err": param,
                    "min_topk_gap": min(gc, gr)}
        print(f"[{card_line}] MoE f32 card (TF32 off) against CPU on "
              f"{shape}, {n} step(s), B {MOE_PARITY_B} x S {MOE_PARITY_S}, "
              f"{MOE_PARITY_LAYERS} layers: losses "
              + ", ".join(f"{v:.6f}" for v in lc) + " vs "
              + ", ".join(f"{v:.6f}" for v in lr)
              + f", relative {loss_rel:.3e}; params {param:.3e} (tolerance "
              f"{MOE_PARITY_TOL}); smallest top-2 gap met {min(gc, gr):.3e}")
        check(loss_rel <= MOE_PARITY_TOL, f"{shape}: losses off by "
                                          f"{loss_rel:.3e}")
        check(param <= MOE_PARITY_TOL, f"{shape}: params off by {param:.3e}")
    return out


def moe_train_phase(card_line) -> tuple:
    """Phase 24: ``bench_moe_train``'s shape through
    ``build_spmd_train_step`` on a hosted ``{"data": 1}`` mesh, 2 warm
    steps then 10 on one batch with the launches read around all 12; a
    profile of 3; the other routes; card against CPU in f32."""
    t_phase = time.perf_counter()
    cfg = MOE_TRAIN_CFG
    n_tok = TRAIN_B * TRAIN_S
    check((T.attention_engine(cfg, TRAIN_S, DEV),
           T.train_ce_engine(cfg, n_tok, DEV)) == ("folded", "cuda"),
          "the MoE step's auto engines are not K7 and the fused CE")
    mesh = build_mesh(MeshSpec.from_dict({"data": 1}), DEV)
    batch = T.make_batch(np.random.default_rng(SEED), cfg, TRAIN_B, TRAIN_S,
                         DEV)
    tree = T.init_params_np(cfg, seed=SEED)
    params = T.shard_params(tree, cfg, mesh)
    vel = T.init_velocity(params)
    ptrs = [t.data_ptr() for t in T._leaves(params) + T._leaves(vel)]
    step = T.build_spmd_train_step(cfg, mesh, TRAIN_LR, TRAIN_MOMENTUM)
    torch.cuda.synchronize()
    reset_launch_counts()
    losses = [step(params, vel, *batch)[2] for _ in range(MOE_WARM)]
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    ev0.record()
    for _ in range(MOE_STEPS):
        losses.append(step(params, vel, *batch)[2])
    ev1.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / MOE_STEPS
    event_ms = ev0.elapsed_time(ev1) / MOE_STEPS
    launches = read_launch_counts()
    losses = [float(x) for x in losses]
    n = MOE_WARM + MOE_STEPS
    print(f"MoE train: {n} steps, losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; launches {launches} (expected "
          + ", ".join(f"{k} {v * n}" for k, v in MOE_TRAIN_LAUNCHES.items()
                      if v) + ", every other 0)")
    check(all(np.isfinite(losses)), f"non-finite MoE loss: {losses}")
    check(losses[-1] < losses[0], f"MoE loss did not fall: {losses}")
    check([t.data_ptr() for t in T._leaves(params) + T._leaves(vel)]
          == ptrs, "MoE params or velocity moved")
    check_launches(launches, {k: v * n for k, v in MOE_TRAIN_LAUNCHES.items()},
                   "MoE train path")
    prof = device_profile(lambda: step(params, vel, *batch), 3,
                          f"MoE train step (bf16, B={TRAIN_B} S={TRAIN_S}, "
                          f"8 experts top-2, sort)", card_line,
                          pick=K7_WGMMA + CE_WGMMA)
    drops = moe_drop_shares(params, cfg, batch)
    flops = moe_flops_per_step(cfg, TRAIN_B, TRAIN_S)
    tflops = flops / (wall_ms / 1e3) / 1e12
    del params, vel
    torch.cuda.empty_cache()
    parts = {"steps_and_profile": time.perf_counter() - t_phase}
    routes = moe_route_steps(cfg, tree, mesh, batch)
    parts["routes"] = time.perf_counter() - t_phase - sum(parts.values())
    s, c = routes["sort"], routes["scatter"]
    engine_loss = abs(s["loss"] - c["loss"]) / abs(s["loss"])
    engine_param = max(float(np.abs(a - b).max()) for a, b in
                       zip(T._leaves(s["params"]), T._leaves(c["params"])))
    print(f"[{card_line}] MoE sort vs scatter after one bf16 step: loss "
          f"{s['loss']:.6f} vs {c['loss']:.6f} (relative {engine_loss:.3e}),"
          f" params {engine_param:.3e} (tolerance {MOE_ENGINE_TOL})")
    check(engine_loss <= MOE_ENGINE_TOL and engine_param <= MOE_ENGINE_TOL,
          "the sort and scatter engines disagree")
    parity = moe_card_vs_cpu(card_line)
    parts["card_vs_cpu"] = (time.perf_counter() - t_phase
                            - sum(parts.values()))
    metrics = {
        "losses": losses, "ms_per_step": wall_ms,
        "event_ms_per_step": event_ms,
        "device_busy_ms": prof["device_ms"],
        "busy_share": prof["device_ms"] / prof["wall_ms"],
        "profile_wall_ms": prof["wall_ms"],
        "device_ops_per_step": prof["device_ops"],
        "tokens_per_s": n_tok / (wall_ms / 1e3),
        "flops_per_step": flops, "achieved_tflops": tflops,
        "mfu": tflops * 1e12 / PEAK_BF16_FLOPS,
        "launches_per_step": {k: launches[k] // n for k in
                              MOE_TRAIN_LAUNCHES if launches[k]},
        "drop_share_by_layer": drops, "top": prof["top"],
        "route_ms": {k: v["ms"] for k, v in routes.items()},
        "route_first_loss": {k: v["loss"] for k, v in routes.items()},
        "sort_vs_scatter": {"loss_rel": engine_loss,
                            "param": engine_param},
        "card_vs_cpu": parity, "part_seconds": parts,
        "seconds": time.perf_counter() - t_phase}
    print(f"[{card_line}] MoE train step (bench_moe_train: bf16, B="
          f"{TRAIN_B} S={TRAIN_S}, 8 experts top-2, capacity 1.25, sort): "
          f"{wall_ms:.2f} ms/step of wall, {event_ms:.2f} ms between CUDA "
          f"events, device busy {prof['device_ms']:.2f} ms of a profiled "
          f"{prof['wall_ms']:.2f} ms ({100 * metrics['busy_share']:.1f}%); "
          f"{metrics['tokens_per_s']:.1f} tokens/s, {flops / 1e12:.3f} "
          f"TFLOP/step (bench.py's count), {tflops:.2f} TFLOP/s, MFU "
          f"{metrics['mfu']:.4f} (bf16 peak 989 TFLOP/s); "
          f"{prof['device_ops']} device ops a step")
    print(f"[{card_line}] MoE routings dropped over capacity, by layer: "
          + ", ".join(f"{d:.4f}" for d in drops))
    print(f"[{card_line}] MoE routes, one step each from the same weights "
          "(second step's ms): " + ", ".join(
              f"{k} {v['ms']:.2f} ms (first loss {v['loss']:.5f})"
              for k, v in routes.items())
          + f"; the phase took {metrics['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    return launches, metrics


# ---------------------------------------------------------------------------
# phase 25: MoE and int8 decode (slice 17)

#: phase 4's width with 8 experts, top-2 (f32, dense dispatch)
MOE_DECODE_CFG = dataclasses.replace(CFG, n_experts=8, moe_top_k=2)
#: the card's _q_matmul route against its f32-widened form: exact products,
#: f32 sums in another order; relative to the output's largest magnitude
Q_ROUTE_TOL = 1e-5
#: int8 decode's kernel engine against its dense engine: the two engines'
#: attention outputs differ by f32 reassociation (about 1e-6), and where
#: that moves an FFN input across a bf16 rounding boundary (_q_matmul
#: rounds its activation to bf16) the input changes by one bf16 ulp, which
#: moves the logits by up to a few 1e-4 (near ties met at 1.7e-4, 2.2e-4
#: and 5.4e-4 of the top-2 gap on the H100): greedy divergence is allowed
#: only below this top-2 gap
INT8_TIE_GAP = 1e-3


def reference_ties(params, cfg, payloads, replies, tag) -> tuple:
    """The greedy requests' tokens against the argmax of the port's
    teacher-forced ``reference_logits`` over prompt and tokens: a token
    may differ only where the reference's top-2 gap is below TIE_GAP.
    Returns the number of such ties and the smallest gap met at one."""
    ties, smallest = 0, None
    for i, (p, r) in enumerate(zip(payloads, replies)):
        if "temperature" in p:
            continue
        ctx = torch.tensor([p["prompt"] + r["tokens"][:-1]], device=DEV)
        with torch.no_grad():
            logits = T.reference_logits(params, ctx, cfg)[0,
                                                           len(p["prompt"])
                                                           - 1:]
        want = logits.argmax(-1).tolist()
        for j in (j for j, (a, b) in enumerate(zip(r["tokens"], want))
                  if a != b):
            top2 = torch.topk(logits[j], 2).values
            gap = float(top2[0] - top2[1])
            print(f"{tag} request {i}: token {j} differs from the "
                  f"reference's argmax; top-2 gap there {gap:.3e}")
            check(gap < TIE_GAP, f"{tag} request {i} token {j} differs "
                                 f"with a top-2 gap of {gap:.3e}")
            ties += 1
            smallest = gap if smallest is None else min(smallest, gap)
    return ties, smallest


def served_passes(dec, payloads, tags):
    """``payloads`` once a tag through a fresh scheduler over ``dec``,
    the kernel counts read around exactly these passes."""
    sched = DecodeScheduler(dec, max_new_tokens_default=MAX_NEW).start()
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        passes = [serve(sched, payloads, tag) for tag in tags]
        torch.cuda.synchronize()
        launches = read_launch_counts()
        stats = sched.stats()
    finally:
        sched.stop()
    check(stats["n_step_faults"] == 0, f"{tags[0]}: a step faulted")
    check(ledger_clean(sched), f"{tags[0]}: page ledger not clean at idle")
    return passes, launches, stats


def rate(replies_wall) -> float:
    replies, wall = replies_wall
    return sum(r["n_tokens"] for r in replies) / wall


def moe_decode(payloads, main_metrics, card_line) -> tuple:
    """The MoE target through the paged decoder with the prefix cache
    (cold, then hits), a speculative pass with its truncated draft, and
    the expert-choice refusal."""
    cfg = MOE_DECODE_CFG
    dec = TransformerDecoder(T.init_params_np(cfg, seed=SEED), cfg,
                             n_slots=N_SLOTS, max_len=MAX_LEN, page_size=PAGE)
    check(dec.attn_impl == "cuda", f"MoE decoder took {dec.attn_impl}")
    dec.warmup()
    ptr = dec.cache["k"].data_ptr()
    (p1, p2), launches, stats = served_passes(dec, payloads,
                                              ("moe1", "moe2"))
    pstats = stats["prefix_cache"]
    print(f"MoE decode: {stats['n_requests']} requests, {stats['n_steps']} "
          f"steps, {stats['n_prefills']} prefills ({pstats['hits']} prefix "
          f"hits); launches {launches}")
    check(pstats["hits"] > 0, "MoE pass 2 did not hit the prefix cache")
    check_launches(launches, paged_launches(stats), "MoE paged path")
    check(dec.cache["k"].data_ptr() == ptr, "the MoE KV pool moved")
    ties = [reference_ties(dec.params, cfg, payloads, r[0], tag)
            for r, tag in ((p1, "MoE pass 1"), (p2, "MoE pass 2"))]
    # dense dispatch reads every expert's weights every step (f32)
    expert_bytes = cfg.n_layers * 4 * (cfg.d_model * cfg.n_experts
                                       + 2 * cfg.n_experts * cfg.d_model
                                       * cfg.d_ff)
    dtree, dcfg = T.layer_truncated_draft(dec.params, cfg, DRAFT_LAYERS)
    sdec = TransformerDecoder(dec.params, cfg, n_slots=N_SLOTS,
                              max_len=MAX_LEN, page_size=PAGE,
                              draft_params=dtree, draft_cfg=dcfg,
                              spec_k=SPEC_K)
    del dec
    torch.cuda.empty_cache()
    sdec.warmup()
    (s1,), slaunches, sstats = served_passes(
        sdec, speculative_payloads(payloads), ("moe-spec",))
    rounds = sstats["speculative"]["rounds"]
    check(rounds > 0, "no MoE speculative round ran")
    check_launches(slaunches, spec_launches(sstats, dcfg),
                   "MoE speculative path")
    check(slaunches["fused_softmax_xent"] == rounds,
          "K4's launches are not the MoE speculative rounds")
    spec_ties = greedy_parity(sdec.params, payloads, s1[0], p1[0],
                              "MoE spec", cfg=cfg)
    del sdec
    torch.cuda.empty_cache()
    ec = dataclasses.replace(cfg, moe_router="expert_choice",
                             moe_capacity_factor=1.0)
    try:
        TransformerDecoder(dtree, ec, n_slots=N_SLOTS, max_len=MAX_LEN,
                           page_size=PAGE)
    except NotImplementedError as e:
        check("expert-choice" in str(e), f"expert choice refused as {e}")
    else:
        raise AssertionError("an expert-choice decoder was built")
    out = {"pass1_tokens_per_s": rate(p1), "pass2_tokens_per_s": rate(p2),
           "dense_mlp_pass1_tokens_per_s": main_metrics["pass1_tokens_per_s"],
           "dense_mlp_pass2_tokens_per_s": main_metrics["pass2_tokens_per_s"],
           "steps": stats["n_steps"], "prefix_hits": pstats["hits"],
           "expert_bytes_per_step": expert_bytes,
           "reference_ties": [t[0] for t in ties],
           "reference_smallest_tie_gap": [t[1] for t in ties],
           "spec_tokens_per_s": rate(s1), "spec_rounds": rounds,
           "spec_acceptance_rate": sstats["speculative"]["acceptance_rate"],
           "spec_ties": spec_ties}
    print(f"[{card_line}] MoE decode tokens/s (8 experts top-2, dense "
          f"dispatch), 8 requests x {MAX_NEW} tokens: pass 1 "
          f"{out['pass1_tokens_per_s']:.1f}, pass 2 "
          f"{out['pass2_tokens_per_s']:.1f} (phase 4's dense MLP "
          f"{out['dense_mlp_pass1_tokens_per_s']:.1f}, "
          f"{out['dense_mlp_pass2_tokens_per_s']:.1f}); expert weights read "
          f"a step {expert_bytes / 1e6:.1f} MB; greedy tokens equal the "
          f"reference's argmax but {out['reference_ties']} near ties; "
          f"speculative {out['spec_tokens_per_s']:.1f} tokens/s, {rounds} "
          f"rounds, acceptance {out['spec_acceptance_rate']}, "
          f"{spec_ties} near ties")
    return launches, out, p1[0]


def int8_decode(params, payloads, main_metrics, card_line) -> tuple:
    """Phase 4's model and weights through ``quantized_ffn=True``: the
    kernel engine against the dense one, the card's int8 product against
    its f32-widened form, the quantization error, ``/decode/stats``."""
    qdec = TransformerDecoder(params, CFG, n_slots=N_SLOTS, max_len=MAX_LEN,
                              page_size=PAGE, quantized_ffn=True)
    qdec.warmup()
    (q1,), launches, stats = served_passes(qdec, payloads, ("int8",))
    check_launches(launches, paged_launches(stats), "int8 paged path")
    ddec = TransformerDecoder(params, CFG, n_slots=N_SLOTS, max_len=MAX_LEN,
                              page_size=PAGE, quantized_ffn=True,
                              attn_impl="dense")
    (d1,), _, _ = served_passes(ddec, payloads, ("int8-dense",))
    del ddec
    ties = greedy_parity(qdec.params, payloads, q1[0], d1[0], "int8",
                         cfg=CFG, tie_gap=INT8_TIE_GAP)
    bp = qdec.params["blocks"][0]
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    x = torch.randn(N_SLOTS, CFG.d_model, device=DEV, generator=gen)
    z = torch.relu(torch.randn(N_SLOTS, CFG.d_ff, device=DEV,
                               generator=gen))
    q_err = 0.0
    for a, wq, ws in ((x, bp["w1_q"][0], bp["w1_s"][0]),
                      (z, bp["w2_q"][0], bp["w2_s"][0])):
        got = T._q_matmul(a, wq, ws)
        ref = a.bfloat16().float() @ wq.float() * ws
        check(got.dtype == torch.float32, f"_q_matmul gave {got.dtype}")
        q_err = max(q_err, float((got - ref).abs().max()
                                 / ref.abs().max()))
    print(f"[{card_line}] _q_matmul on the card (one bf16 product into an "
          f"f32 output) against the f32-widened form {q_err:.3e} of the "
          f"largest output (tolerance {Q_ROUTE_TOL})")
    check(q_err <= Q_ROUTE_TOL, f"_q_matmul routes disagree: {q_err:.3e}")
    gap = 0.0
    with torch.no_grad():
        for p, r in zip(payloads, q1[0]):
            ctx = torch.tensor([p["prompt"] + r["tokens"]], device=DEV)
            gap = max(gap, float((T.reference_logits(qdec.params, ctx, CFG)
                                  - T.reference_logits(params, ctx, CFG))
                                 .abs().max()))
    f32_bytes = sum(b[k].numel() * b[k].element_size()
                    for b in params["blocks"] for k in ("w1", "w2"))
    int8_bytes = sum(b[k].numel() * b[k].element_size()
                     for b in qdec.params["blocks"]
                     for k in ("w1_q", "w2_q", "w1_s", "w2_s"))
    srv = serve_http(qdec, "threaded")
    try:
        status, _, body = http_call(srv, "GET", "/decode/stats")
    finally:
        srv.stop()
    check(status == 200 and json.loads(body)["quantized_ffn"] is True,
          f"/decode/stats: {status} {body[:200]!r}")
    out = {"tokens_per_s": rate(q1), "dense_engine_tokens_per_s": rate(d1),
           "f32_pass1_tokens_per_s": main_metrics["pass1_tokens_per_s"],
           "q_matmul_err": q_err,
           "teacher_forced_logit_gap": gap, "ffn_bytes_f32": f32_bytes,
           "ffn_bytes_int8": int8_bytes, "ties": ties,
           "decode_stats_quantized_ffn": True}
    print(f"[{card_line}] int8 FFN decode tokens/s, 8 requests x {MAX_NEW} "
          f"tokens: {out['tokens_per_s']:.1f} (dense attention engine "
          f"{out['dense_engine_tokens_per_s']:.1f}; phase 4's f32 pass 1 "
          f"{out['f32_pass1_tokens_per_s']:.1f}); largest teacher-forced "
          f"logit gap int8 - f32 {gap:.4e} (the quantization error); FFN "
          f"weights {f32_bytes / 1e6:.2f} MB f32, {int8_bytes / 1e6:.2f} MB "
          f"int8 with scales; {ties} near ties below {INT8_TIE_GAP}; "
          f"/decode/stats quantized_ffn true")
    return launches, out, q1[0]


def moe_decode_phase(params, payloads, main_metrics, card_line) -> tuple:
    """Phase 25: MoE decode and int8 decode. Returns the launches of each,
    the metrics and each decoder's first-pass replies."""
    t_phase = time.perf_counter()
    launches, out, moe_replies = moe_decode(payloads, main_metrics,
                                            card_line)
    t_moe = time.perf_counter() - t_phase
    int8_launches, out["int8"], int8_replies = int8_decode(
        params, payloads, main_metrics, card_line)
    out["seconds"] = time.perf_counter() - t_phase
    out["part_seconds"] = {"moe": t_moe, "int8": out["seconds"] - t_moe}
    print(f"[{card_line}] MoE and int8 decode took {out['seconds']:.1f} s "
          f"(MoE {t_moe:.1f}, int8 {out['seconds'] - t_moe:.1f})")
    return launches, int8_launches, out, {"moe": moe_replies,
                                          "int8": int8_replies}


# ---------------------------------------------------------------------------
# phase 26: tensor and pipeline parallelism (slice 18)

#: bench_transformer_train's width and batch (bf16, B 8 x S 1024, rate 0.01,
#: momentum 0.9) with its 8 layers as 2 pipe stages of 4, in 4
#: microbatches, on a hosted {"model": 2, "pipe": 2}
TP_MESH = {"model": 2, "pipe": 2}
TP_TRAIN_CFG = dataclasses.replace(TRAIN_CFG, n_stages=2, layers_per_stage=4,
                                   microbatches=4)
#: the GPipe schedule's ticks a step: every stage runs its blocks each tick
TP_TICKS = TP_TRAIN_CFG.microbatches + TP_TRAIN_CFG.n_stages - 1
TP_WARM, TP_STEPS = 2, 10
#: a step's kernels: K7's three once a block a tick (the model and pipe
#: ranks' heads fold into one launch), the fused CE once over the last
#: stage's outputs; no decode, ring or GBDT kernel
TP_TRAIN_LAUNCHES = {**TRAIN_LAUNCHES,
                     **{n: TP_TICKS * TP_TRAIN_CFG.layers_per_stage
                        for n in ("attention_fwd", "attention_bwd_dq",
                                  "attention_bwd_dkdv")},
                     **{n: 0 for n in PAGED_PATH_KERNELS}}
FIVE_AXIS = {"data": 1, "seq": 2, "model": 2, "expert": 1, "pipe": 2}
#: card against CPU in f32 (TF32 off) at the bench width, 2 layers, B 2 x
#: S 256, 2 steps from the same bridged weights: (mesh, config changes)
TP_PARITY = (
    ("model2", {"model": 2}, dict(n_stages=1, layers_per_stage=2,
                                  microbatches=1)),
    ("pipe2", {"pipe": 2}, dict(n_stages=2, layers_per_stage=1,
                                microbatches=2)),
    ("five_axis_moe", FIVE_AXIS, dict(n_stages=2, layers_per_stage=1,
                                      microbatches=2, n_experts=2,
                                      moe_aux_weight=0.01,
                                      moe_zloss_weight=1e-3)))
TP_PARITY_B, TP_PARITY_S, TP_PARITY_STEPS = 2, 256, 2
TP_PARITY_TOL = 1e-4
TP_DECODE_MESH = {"data": 1, "model": 2}
#: the kernels at the model ranks' head slices: 8 heads over model 2
TP_HEADS = CFG.n_heads // 2
#: K8 at the 5-axis parity mesh's launch: 4 ranks off the model axis x 2
#: model ranks x 1 microbatch row, S_local 128
TP_K8_B, TP_K8_S = 8, TP_PARITY_S // 2


def tp_paged_launches(stats, tp: int) -> dict:
    """Phase 4's formulas over ``tp`` model ranks: K1 and K2 take every
    rank's head slice in one launch a layer, K3 one launch a rank."""
    want = paged_launches(stats)
    want["paged_prefix_prefill_attention"] *= tp
    return want


def tp_train_path(dense, card_line) -> tuple:
    """(a) The bench step on a hosted ``{"model": 2, "pipe": 2}``: 2 warm
    steps then 10 on one batch, the launches read around all 12, a
    profile of 3, beside phase 11's ``build_train_step`` rate."""
    cfg = TP_TRAIN_CFG
    n_tok = TRAIN_B * TRAIN_S
    engines = (T.attention_engine(cfg, TRAIN_S, DEV, heads=TP_HEADS),
               T.train_ce_engine(cfg, n_tok, DEV))
    check(engines == ("folded", "cuda"), f"the TP/PP step's auto engines "
                                         f"resolved to {engines}")
    mesh = build_mesh(MeshSpec.from_dict(TP_MESH), DEV)
    batch = T.make_batch(np.random.default_rng(SEED), cfg, TRAIN_B, TRAIN_S,
                         DEV)
    params = T.shard_params(T.init_params_np(cfg, seed=SEED), cfg, mesh)
    vel = T.init_velocity(params)
    ptrs = [t.data_ptr() for t in T._leaves(params) + T._leaves(vel)]
    step = T.build_spmd_train_step(cfg, mesh, TRAIN_LR, TRAIN_MOMENTUM)
    torch.cuda.synchronize()
    reset_launch_counts()
    losses = [step(params, vel, *batch)[2] for _ in range(TP_WARM)]
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    ev0.record()
    for _ in range(TP_STEPS):
        losses.append(step(params, vel, *batch)[2])
    ev1.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TP_STEPS
    event_ms = ev0.elapsed_time(ev1) / TP_STEPS
    launches = read_launch_counts()
    losses = [float(x) for x in losses]
    n = TP_WARM + TP_STEPS
    print(f"TP/PP train on {TP_MESH}: {n} steps, losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; launches {launches} (expected "
          + ", ".join(f"{k} {v * n}" for k, v in TP_TRAIN_LAUNCHES.items()
                      if v) + ", every other 0)")
    check(all(np.isfinite(losses)), f"non-finite TP/PP loss: {losses}")
    check(losses[-1] < losses[0], f"TP/PP loss did not fall: {losses}")
    check([t.data_ptr() for t in T._leaves(params) + T._leaves(vel)]
          == ptrs, "TP/PP params or velocity moved")
    check_launches(launches, {k: v * n for k, v in TP_TRAIN_LAUNCHES.items()},
                   "TP/PP train path")
    prof = device_profile(lambda: step(params, vel, *batch), 3,
                          f"TP/PP train step (bf16, B={TRAIN_B} "
                          f"S={TRAIN_S}, {TP_MESH}, {cfg.microbatches} "
                          f"microbatches)", card_line,
                          pick=K7_WGMMA + CE_WGMMA)
    flops = train_flops_per_step(cfg)
    tflops = flops / (wall_ms / 1e3) / 1e12
    del params, vel
    torch.cuda.empty_cache()
    out = {"losses": losses, "ms_per_step": wall_ms,
           "event_ms_per_step": event_ms,
           "device_busy_ms": prof["device_ms"],
           "busy_share": prof["device_ms"] / prof["wall_ms"],
           "profile_wall_ms": prof["wall_ms"],
           "device_ops_per_step": prof["device_ops"],
           "tokens_per_s": n_tok / (wall_ms / 1e3),
           "flops_per_step": flops, "achieved_tflops": tflops,
           "mfu": tflops * 1e12 / PEAK_BF16_FLOPS,
           "bubble_block_work": TP_TICKS / cfg.microbatches,
           "k7_device_ms": {k: prof["picked"][k] for k in K7_WGMMA},
           "launches_per_step": {k: launches[k] // n for k in
                                 TP_TRAIN_LAUNCHES if launches[k]},
           "phase11_ms_per_step": dense["train_ms_per_step"],
           "phase11_tokens_per_s": dense["train_tokens_per_s"],
           "phase11_mfu": dense["train_mfu"],
           "phase11_device_busy_ms": dense["train_device_busy_ms"],
           "top": prof["top"]}
    print(f"[{card_line}] TP/PP train step (bench width, bf16, B={TRAIN_B} "
          f"S={TRAIN_S}, {TP_MESH}, {cfg.microbatches} microbatches, "
          f"{TP_TICKS} ticks: block work x{out['bubble_block_work']:.2f}): "
          f"{wall_ms:.2f} ms/step of wall, {event_ms:.2f} ms between CUDA "
          f"events, device busy {prof['device_ms']:.2f} ms of a profiled "
          f"{prof['wall_ms']:.2f} ms ({100 * out['busy_share']:.1f}%), "
          f"{prof['device_ops']} device ops a step; "
          f"{out['tokens_per_s']:.1f} tokens/s, MFU {out['mfu']:.4f} "
          f"(bench.py's count, 989 TFLOP/s); phase 11's single-device step "
          f"{dense['train_ms_per_step']:.2f} ms, "
          f"{dense['train_tokens_per_s']:.1f} tokens/s, device busy "
          f"{dense['train_device_busy_ms']:.2f} ms, MFU "
          f"{dense['train_mfu']:.4f}")
    return launches, out


def tp_card_vs_cpu(card_line) -> dict:
    """(a) f32 with TF32 off, the bench width at 2 layers, B 2 x S 256:
    2 steps on the card and on the CPU from the same bridged weights, on
    ``{"model": 2}``, ``{"pipe": 2}`` and the 5-axis mesh with 2
    experts."""
    out = {}
    for key, shape, kw in TP_PARITY:
        cfg = dataclasses.replace(TP_TRAIN_CFG, dtype="float32", **kw)
        tree = T.init_params_np(cfg, seed=SEED)
        batch = T.make_batch(np.random.default_rng(SEED), cfg, TP_PARITY_B,
                             TP_PARITY_S, "cpu")
        runs = {}
        for where in ("card", "cpu"):
            device = DEV if where == "card" else "cpu"
            mesh = build_mesh(MeshSpec.from_dict(shape), device)
            params = T.shard_params(tree, cfg, mesh)
            vel = T.init_velocity(params)
            step = T.build_spmd_train_step(cfg, mesh, TRAIN_LR,
                                           TRAIN_MOMENTUM)
            b = [t.to(device) for t in batch]
            with ieee_f32():
                losses = [float(step(params, vel, *b)[2])
                          for _ in range(TP_PARITY_STEPS)]
            runs[where] = (losses, T.params_to_numpy(params))
        (lc, pc), (lr, pr) = runs["card"], runs["cpu"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lr))
        param = max(float(np.abs(a - b).max())
                    for a, b in zip(T._leaves(pc), T._leaves(pr)))
        out[key] = {"card_losses": lc, "cpu_losses": lr,
                    "loss_rel_err": loss_rel, "param_err": param}
        print(f"[{card_line}] TP/PP f32 card (TF32 off) against CPU on "
              f"{shape}, {TP_PARITY_STEPS} steps, B {TP_PARITY_B} x S "
              f"{TP_PARITY_S}: losses "
              + ", ".join(f"{v:.6f}" for v in lc) + " vs "
              + ", ".join(f"{v:.6f}" for v in lr)
              + f", relative {loss_rel:.3e}; params {param:.3e} (tolerance "
              f"{TP_PARITY_TOL})")
        check(loss_rel <= TP_PARITY_TOL, f"{shape}: losses off by "
                                         f"{loss_rel:.3e}")
        check(param <= TP_PARITY_TOL, f"{shape}: params off by {param:.3e}")
    return out


def tp_decoder(tree, cfg, **kw):
    return TransformerDecoder(tree, cfg, n_slots=N_SLOTS, max_len=MAX_LEN,
                              page_size=PAGE,
                              mesh=PDIST.train_mesh(TP_DECODE_MESH, DEV),
                              **kw)


def tp_decode_path(params, payloads, phase4, metrics, tree_replies,
                   card_line) -> tuple:
    """(b) Phase 4's model and cell on a hosted ``{"data": 1, "model":
    2}``: cold then with prefix hits; then phase 25's MoE and int8 trees
    one pass each; a draft with a mesh refused."""
    tp = TP_DECODE_MESH["model"]
    dec = tp_decoder(params, CFG)
    check(dec.attn_impl == "cuda" and dec.tp == tp,
          f"TP decoder took {dec.attn_impl}, tp {dec.tp}")
    dec.warmup()
    ptr = dec.cache["k"].data_ptr()
    (p1, p2), launches, stats = served_passes(dec, payloads, ("tp1", "tp2"))
    print(f"TP decode: {stats['n_requests']} requests, {stats['n_steps']} "
          f"steps, {stats['n_prefills']} prefills "
          f"({stats['prefix_cache']['hits']} prefix hits); launches "
          f"{launches}")
    check(stats["prefix_cache"]["hits"] > 0, "TP pass 2 did not hit the "
                                             "prefix cache")
    check_launches(launches, tp_paged_launches(stats, tp), "TP paged path")
    check(dec.cache["k"].data_ptr() == ptr, "the TP KV pool moved")
    ties = sum(greedy_parity(dec.params, payloads, r[0], ref, tag)
               for r, ref, tag in ((p1, phase4[0], "TP pass 1"),
                                   (p2, phase4[1], "TP pass 2")))
    # phase 4's pool: 8 layers x (1 + 8 slots x 64 pages) pages of 16 rows
    # x 8 heads x 64, K and V in f32
    phase4_bytes = (2 * 4 * CFG.n_layers * (1 + N_SLOTS * PPS) * PAGE
                    * CFG.n_heads * CFG.d_head)
    check(dec.pool_bytes() == phase4_bytes
          and 2 * dec.pool_bytes_per_rank() == phase4_bytes,
          f"the TP pool holds {dec.pool_bytes()} bytes, "
          f"{dec.pool_bytes_per_rank()} a rank (phase 4's {phase4_bytes})")
    srv = serve_http(dec, "threaded")
    try:
        status, _, body = http_call(srv, "GET", "/decode/stats")
    finally:
        srv.stop()
    placement = json.loads(body)["placement"] if status == 200 else {}
    check(status == 200 and placement.get("mode") == "tensor_parallel"
          and placement.get("label") == "data=1,model=2",
          f"/decode/stats: {status} {body[:300]!r}")
    dtree, dcfg = T.layer_truncated_draft(dec.params, CFG, DRAFT_LAYERS)
    try:
        tp_decoder(dec.params, CFG, draft_params=dtree, draft_cfg=dcfg)
    except ValueError as e:
        check("speculative decoding with a mesh" in str(e),
              f"a draft with a mesh refused as {e}")
    else:
        raise AssertionError("a draft with a mesh was served")
    del dec, srv
    torch.cuda.empty_cache()
    out = {"pass1_tokens_per_s": rate(p1), "pass2_tokens_per_s": rate(p2),
           "phase4_pass1_tokens_per_s": metrics["pass1_tokens_per_s"],
           "phase4_pass2_tokens_per_s": metrics["pass2_tokens_per_s"],
           "ties": ties, "pool_bytes": phase4_bytes,
           "pool_bytes_per_rank": phase4_bytes // tp,
           "placement": placement}
    all_launches = dict(launches)
    for name, cfg, kw, ref, gap in (
            ("moe", MOE_DECODE_CFG, {}, tree_replies["moe"], TIE_GAP),
            ("int8", CFG, {"quantized_ffn": True}, tree_replies["int8"],
             INT8_TIE_GAP)):
        tree = (T.init_params_np(MOE_DECODE_CFG, seed=SEED)
                if name == "moe" else params)
        d2 = tp_decoder(tree, cfg, **kw)
        d2.warmup()
        (r1,), l2, s2 = served_passes(d2, payloads, (f"tp-{name}",))
        check_launches(l2, tp_paged_launches(s2, tp), f"TP {name} path")
        out[f"{name}_ties"] = greedy_parity(d2.params, payloads, r1[0], ref,
                                            f"TP {name}", cfg=cfg,
                                            tie_gap=gap)
        out[f"{name}_tokens_per_s"] = rate(r1)
        all_launches = {k: all_launches[k] + l2[k] for k in all_launches}
        del d2
        torch.cuda.empty_cache()
    print(f"[{card_line}] TP decode on {TP_DECODE_MESH} tokens/s, 8 "
          f"requests x {MAX_NEW} tokens: pass 1 "
          f"{out['pass1_tokens_per_s']:.1f}, pass 2 "
          f"{out['pass2_tokens_per_s']:.1f} (phase 4's "
          f"{out['phase4_pass1_tokens_per_s']:.1f}, "
          f"{out['phase4_pass2_tokens_per_s']:.1f}); {ties} near ties "
          f"against phase 4's replies; pool {phase4_bytes / 1e6:.1f} MB, "
          f"{phase4_bytes / tp / 1e6:.1f} MB a rank; MoE "
          f"{out['moe_tokens_per_s']:.1f} tokens/s ({out['moe_ties']} "
          f"ties), int8 {out['int8_tokens_per_s']:.1f} ({out['int8_ties']} "
          f"ties); a draft with a mesh refused")
    return all_launches, out


def tp_kernels(plan, card_line) -> dict:
    """(c) The kernels at the sharded shapes against their plain versions:
    K7's three at B 8 x S 1024 x H 4 in f32 and bf16, K8's three at the
    5-axis launch (ring neighbours' block pairs), with phases 3's and 9's
    limits; K1 at the tensor-parallel step's tp x 8 rows of 4 heads,
    K2 at the ranks' batch of 4 heads, K3 at 4 heads on each rank's
    pages, at phase 3's."""
    gen = torch.Generator().manual_seed(SEED + 26)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        errs = attn_errors(gen, TRAIN_B, TRAIN_S, dtype, h=TP_HEADS)
        for b, s, case in ((TP_K8_B, TP_K8_S, "diagonal"),
                           (TP_K8_B, TP_K8_S, "full"),
                           (TP_K8_B, TP_K8_S, "none")):
            k8, _ = k8_errors(gen, b, s, dtype, case, True, h=TP_HEADS)
            for n, e in k8.items():
                errs[n] = worse(errs.get(n, (0.0,) * 3), e)
        for n, (err, rel, scaled) in errs.items():
            out[f"{n}_{tag}"] = {"max_abs_err": err, "scaled_err": scaled}
            if dtype == torch.float32:
                check(rel <= KERNEL_TOL and scaled <= F32_SCALED_TOL,
                      f"{n} (f32) at {TP_HEADS} heads: {rel:.3e} x max(1, "
                      f"|ref|), {scaled:.3e} scaled")
            else:
                limit = {**BF16_LIMITS, **K8_BF16_LIMITS}[n]
                check(scaled <= limit, f"{n} (bf16) at {TP_HEADS} heads: "
                                       f"scaled {scaled:.3e} > {limit}")
        print(f"[{card_line}] at {TP_HEADS} heads ({tag}): K7 B {TRAIN_B} x "
              f"S {TRAIN_S}, K8 B {TP_K8_B} x S {TP_K8_S}: "
              + ", ".join(f"{n} {e[0]:.3e} ({e[2]:.3e} scaled)"
                          for n, e in errs.items()))
        torch.cuda.empty_cache()
    out.update(tp_decode_kernels(gen, plan, card_line))
    return out


def tp_decode_kernels(gen, plan, card_line) -> dict:
    """K1-K3 at the tensor-parallel decoder's launches: K1 over tp x 8
    rows of 4 heads (phase 4's positions once a model rank, then every
    boundary of the split that ``paged_decode_plan`` gives tp x 8 rows,
    then with the even rows free), K2 at a batch of tp prompts of 4
    heads, K3 at 4 heads with each rank's table offset into its pages;
    each against its plain version at ``KERNEL_TOL``."""
    tp = TP_DECODE_MESH["model"]
    n = tp * N_SLOTS
    worst = {}
    per, n_splits = CA.paged_decode_plan(n, PPS)
    edges = sorted({0, PPS * PAGE - 1}
                   | {j * per * PAGE + k for j in range(1, n_splits)
                      for k in (-1, 0)})
    batches = [list(plan["k1_pos"]) * tp]
    batches += [(edges[i:i + n] + [0] * n)[:n]
                for i in range(0, len(edges), n)]
    for pos in batches:
        e = max_err(*k1_case(gen, pos, h=TP_HEADS)[:2])
        worst["paged_decode_attention"] = max(
            worst.get("paged_decode_attention", 0.0), e)
    e = max_err(*k1_case(gen, batches[0], free=range(0, n, 2),
                         h=TP_HEADS)[:2])
    worst["paged_decode_attention"] = max(worst["paged_decode_attention"], e)
    print(f"[{card_line}] K1 at {n} rows x {TP_HEADS} heads: {per} page(s) "
          f"a split, {n_splits} splits a row; phase 4's positions once a "
          f"rank, {len(edges)} boundary positions, even rows free: "
          f"max_abs_err {worst['paged_decode_attention']:.3e}")
    for s in sorted({1, 15, 16, 17, 63, 64, 65, 128, 129, MAX_LEN,
                     plan["k2_s"]}):
        e = max_err(*k2_case(gen, s, h=TP_HEADS, b=tp)[:2])
        worst["flash_prefill_attention"] = max(
            worst.get("flash_prefill_attention", 0.0), e)
    print(f"[{card_line}] K2 at B {tp} x H {TP_HEADS}, S 1 to {MAX_LEN} "
          f"and the bucket {plan['k2_s']}: max_abs_err "
          f"{worst['flash_prefill_attention']:.3e}")
    plans = set()
    for hit, s in sorted({(0, 16), (16, 5), (256, 64), (1008, 64),
                          (256, 768), (plan["k3_hit"], plan["k3_s"])}):
        for r in range(tp):
            e = max_err(*k3_case(gen, hit, s, h=TP_HEADS,
                                 off=r * (1 + PPS))[:2])
            worst["paged_prefix_prefill_attention"] = max(
                worst.get("paged_prefix_prefill_attention", 0.0), e)
        plans.add((hit, s) + CA.paged_prefix_plan(s, hit, TP_HEADS,
                                                  PPS * PAGE))
    print(f"[{card_line}] K3 at {TP_HEADS} heads on each of {tp} ranks' "
          f"pages, (hit, S, rows a tile, keys a split, splits) "
          f"{sorted(plans)}: max_abs_err "
          f"{worst['paged_prefix_prefill_attention']:.3e}")
    for name, err in worst.items():
        check(err <= KERNEL_TOL, f"{name} at {TP_HEADS} heads disagrees "
                                 f"with its plain version: {err:.3e} > "
                                 f"{KERNEL_TOL}")
    print(f"[{card_line}] K1-K3 at the tensor-parallel shapes agree with "
          f"their plain versions within {KERNEL_TOL} (f32)")
    return {name: {"max_abs_err": err} for name, err in worst.items()}


def tensor_pipe_phase(params, payloads, phase4, metrics, train_metrics,
                      tree_replies, plan, card_line) -> tuple:
    """Phase 26: (a) the TP/PP train step and its card-against-CPU parity,
    (b) tensor-parallel decode, (c) the kernels at the sharded shapes.
    Returns each path's launches and the metrics."""
    t_phase = time.perf_counter()
    parts = {}
    train_launches, out = tp_train_path(train_metrics, card_line)
    parts["train"] = time.perf_counter() - t_phase
    out["card_vs_cpu"] = tp_card_vs_cpu(card_line)
    parts["card_vs_cpu"] = time.perf_counter() - t_phase - sum(parts.values())
    decode_launches, out["decode"] = tp_decode_path(
        params, payloads, phase4, metrics, tree_replies, card_line)
    parts["decode"] = time.perf_counter() - t_phase - sum(parts.values())
    out["kernels"] = tp_kernels(plan, card_line)
    parts["kernels"] = time.perf_counter() - t_phase - sum(parts.values())
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card_line}] tensor and pipeline parallelism took "
          f"{out['seconds']:.1f} s (" + ", ".join(
              f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    return {"train": train_launches, "decode": decode_launches}, out


# ---------------------------------------------------------------------------
# phase 27: the model and pipe axes on the frame plane, and the pjit train
# step

#: phase 21's cell in each parallel mode, on the hosted mesh of the card
FRAME_MODES = (("tensor_parallel", {"tensor_parallel": 2}),
               ("pipeline_parallel", {"pipeline_parallel": 2}),
               ("tp_and_pp", {"tensor_parallel": 2, "pipeline_parallel": 2}))
FRAME_PP_REQUESTS = 12
#: phase 22's cell on a hosted model axis
FRAME_TP_MESH = {"data": 1, "model": 2}
#: the pjit step: bench_transformer_train's width and batch (bf16, B 8 x S
#: 1024) on a hosted {"data": 2, "model": 2}, 10 steps after 2 warm ones,
#: beside the shard_map step on the same mesh
PJIT_MESH = {"data": 2, "model": 2}
PJIT_WARM, PJIT_STEPS = 2, 10
#: pjit against shard_map in f32 (TF32 off), 2 layers, B 2 x S 256, 3 steps
#: from the same weights, at tests/test_transformer.py's limits
PJIT_PARITY = (
    ("data2_model2", PJIT_MESH, dict(n_stages=1, layers_per_stage=2,
                                     microbatches=1)),
    ("five_axis_moe", FIVE_AXIS, dict(n_stages=2, layers_per_stage=1,
                                      microbatches=2, n_experts=2,
                                      moe_aux_weight=0.01,
                                      moe_zloss_weight=1e-3)))
PJIT_PARITY_B, PJIT_PARITY_S, PJIT_PARITY_STEPS = 2, 256, 3
PJIT_LOSS_TOL, PJIT_PARAM_TOL = 2e-5, 2e-4
#: ce_impl="cuda" on one rank and on PJIT_MESH: K4's training variant and
#: K6's dh and dW once a step over the global batch, every other kernel (K7
#: too: pjit's attention is the dense engine) 0; in f32 on PJIT_MESH the
#: fused step is held against the plain-CE pjit step at the parity limits
PJIT_CE_MESHES = ({"data": 1}, PJIT_MESH)
PJIT_CE_STEPS = 3
PJIT_CE_LAUNCHES = {"fused_softmax_xent_train": 1, "fused_ce_dh": 1,
                    "fused_ce_dw": 1}


def frame_mode_passes(scorer, df) -> tuple:
    """A warm pass of one minibatch, then 3 timed passes of the frame:
    ``(scores, [wall s])``."""
    scorer.transform(df.head(FRAME_BATCH))
    walls, scores = [], None
    for _ in range(3):
        t0 = time.perf_counter()
        scores = scorer.transform(df)["scores"]
        walls.append(time.perf_counter() - t0)
    return scores, walls


def frame_parallel_scoring(frame_metrics, card_line) -> dict:
    """(a) Phase 21's cell (ResNet-20 bf16, 10 240 fresh images, batch
    1024) single-device, then with ``tensor_parallel=2``,
    ``pipeline_parallel=2`` and both, then single-device again: images/s,
    the stage plan and each stage's service ms, the bubble, each rank's
    state bytes; every mode's scores within phase 21's bf16 limit of the
    single-device card scores."""
    arch = {"builder": "cifar_resnet", "depth": 20, "dtype": "bfloat16"}
    fn = NNFunction.init(arch, input_shape=(32, 32, 3), seed=0)
    images = np.random.default_rng(0).uniform(
        0, 1, size=(FRAME_IMAGES, 32, 32, 3)).astype(np.float32)
    df = DataFrame({"image": images})

    def scorer(**kw):
        return NNModel(model=fn, input_col="image", output_col="scores",
                       batch_size=FRAME_BATCH, cache_inputs=False, **kw)

    single = scorer()
    ref, walls = frame_mode_passes(single, df)
    out = {"single_device": {"images_per_s_passes":
                             [FRAME_IMAGES / w for w in walls]}}
    for name, kw in FRAME_MODES:
        m = scorer(**kw)
        scores, walls = frame_mode_passes(m, df)
        err = frame_err(scores, ref)
        check(np.isfinite(scores).all() and err <= FRAME_BF16_TOL,
              f"{name}: scores off the single-device card scores by "
              f"{err:.3e}")
        entry = {"images_per_s": FRAME_IMAGES / float(np.median(walls)),
                 "images_per_s_passes": [FRAME_IMAGES / w for w in walls],
                 "err_vs_single": err, "placement_label": m.placement_label}
        pl = m.placement()
        check(pl["mode"] == ("tensor_parallel" if name == "tensor_parallel"
                             else "pipeline_parallel"),
              f"{name}: placement {pl}")
        if name == "tensor_parallel":
            entry.update({k: pl[k] for k in (
                "mesh", "sharded_leaves", "replicated_leaves", "state_bytes",
                "state_bytes_per_device")})
        else:
            rep = m.pipeline_report()
            runner, _ = m._setup_pipeline
            check(rep["stage_probe_valid"] and rep["n_stages"] == 2,
                  f"{name}: pipeline report {rep}")
            entry["stages"] = [
                {"layers": s["layers"], "param_bytes": s["param_bytes"],
                 "devices": s["devices"], "service_ms": s["service_ms"],
                 "state_bytes_per_rank": PDIST.placement_report(
                     placed.state, placed.mesh)["state_bytes_per_device"]}
                for s, (_, placed, _, _) in zip(rep["stages"],
                                                runner.stages)]
            entry["bubble_ratio"] = rep["bubble_ratio"]
            entry["microbatches"] = rep["last_n_micro"]
        out[name] = entry
    _, walls = frame_mode_passes(single, df)
    out["single_device"]["images_per_s_passes"] += [FRAME_IMAGES / w
                                                    for w in walls]
    out["single_device"]["images_per_s"] = float(np.median(
        out["single_device"]["images_per_s_passes"]))
    out["phase21_images_per_s"] = frame_metrics["cifar10_scoring"][
        "images_per_s"]
    print(f"[{card_line}] phase 21's cell by mode, images/s (median of 3): "
          f"single {out['single_device']['images_per_s']:.1f} (passes "
          + ", ".join(f"{v:.1f}" for v in
                      out["single_device"]["images_per_s_passes"])
          + f"; phase 21 {out['phase21_images_per_s']:.1f}), "
          + ", ".join(f"{n} {out[n]['images_per_s']:.1f} (err "
                      f"{out[n]['err_vs_single']:.2e})"
                      for n, _ in FRAME_MODES))
    tp = out["tensor_parallel"]
    print(f"[{card_line}] tensor_parallel=2 on {tp['mesh']}: "
          f"{tp['sharded_leaves']} sharded, {tp['replicated_leaves']} "
          f"replicated leaves, {tp['state_bytes']} bytes, "
          f"{tp['state_bytes_per_device']} a rank")
    for name in ("pipeline_parallel", "tp_and_pp"):
        e = out[name]
        print(f"[{card_line}] {name}: bubble {e['bubble_ratio']}, "
              f"{e['microbatches']} micro-batches, stages "
              + "; ".join(f"layers {s['layers']} on {s['devices']}: "
                          f"{s['param_bytes']} param bytes, "
                          f"{s['state_bytes_per_rank']} bytes a rank, "
                          f"{s['service_ms']} ms"
                          for s in e["stages"]))
    return out


def frame_pipelined_serving(card_line) -> dict:
    """(a) A ``ServingServer`` over ResNet-20 bf16 with
    ``pipeline_parallel=2`` answers 12 ``/predict`` requests: rows
    within phase 21's limit of the single-device model's, no recompile
    after warmup, the ``/stats`` ``pipeline_parallel`` block and
    placement."""
    arch = {"builder": "cifar_resnet", "depth": 20, "dtype": "bfloat16"}
    fn = NNFunction.init(arch, input_shape=(32, 32, 3), seed=0)
    x = np.random.default_rng(3).uniform(
        0, 1, (FRAME_PP_REQUESTS, 32, 32, 3)).astype(np.float32)
    direct = NNModel(model=fn, input_col="image").transform(
        DataFrame({"image": x}))["scores"]
    model = NNModel(model=fn, input_col="image", pipeline_parallel=2,
                    pipeline_microbatches=2, batch_size=64)
    srv = ServingServer(model, port=0, max_batch_size=8, max_latency_ms=2)
    srv.warmup({"image": np.zeros((32, 32, 3)).tolist()})
    srv.start()
    try:
        rec0 = srv.n_recompiles
        rows = []
        for row in x:
            status, _, body = http_call(srv, "POST", "/predict",
                                        {"image": row.tolist()})
            check(status == 200, f"/predict replied {status}: {body[:200]}")
            rows.append(json.loads(body)["scores"])
        recompiles = srv.n_recompiles - rec0
        _, _, body = http_call(srv, "GET", "/stats")
        stats = json.loads(body)
    finally:
        srv.stop()
    err = frame_err(rows, direct)
    block = stats.get("pipeline_parallel") or {}
    placement = stats.get("placement") or {}
    check(err <= FRAME_BF16_TOL, f"pipelined /predict rows off by {err}")
    check(recompiles == 0, f"the pipelined server recompiled {recompiles} "
                           f"times after warmup")
    check(block.get("n_stages") == 2 and block.get("stage_probe_valid")
          and block.get("bubble_ratio") is not None
          and block.get("n_frames", 0) >= 1,
          f"/stats pipeline_parallel block: {block}")
    check(placement.get("mode") == "pipeline_parallel"
          and placement.get("n_stages") == 2, f"/stats placement: "
                                              f"{placement}")
    print(f"[{card_line}] pipelined /predict: {FRAME_PP_REQUESTS} requests, "
          f"rows {err:.3e} from the single-device model, {recompiles} "
          f"recompiles after warmup; /stats pipeline block: "
          f"{block['n_frames']} frames, bubble {block['bubble_ratio']}, "
          f"stage service ms "
          + ", ".join(str(s["service_ms"]) for s in block["stages"]))
    return {"err": err, "recompiles": recompiles, "block": block,
            "placement": placement}


def frame_model_axis_train(frame_train_metrics, card_line) -> dict:
    """(b) Phase 22's cell (ResNet-20 bf16, batch 256, momentum at
    SGD_LR) through ``NNLearner``'s step over a hosted ``{"data": 1,
    "model": 2}``: the state laid out by ``state_shardings``, a warm step
    then 20; then 3 f32 steps (TF32 off) of ``NNLearner`` on that mesh on
    the card, on the CPU, and on ``{"data": 1}`` on the card."""
    from mmlspark_tpu_torch.models.function import (
        PlacedModule, flatten_params)
    fn = NNFunction.init(SGD_ARCH, (32, 32, 3), seed=0)
    mesh = PDIST.train_mesh(FRAME_TP_MESH, DEV)
    placed = PlacedModule(fn.module(), fn.params, mesh)
    step = NNLearner(arch=fn.arch, learning_rate=SGD_LR).build_train_step(
        placed, make_optimizer("momentum", SGD_LR),
        make_loss("softmax_cross_entropy"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (SGD_BATCH, 32, 32, 3)).astype(
        np.float32)).to(DEV)
    y = torch.from_numpy(rng.integers(0, 10, SGD_BATCH)).to(DEV)
    w = torch.ones(SGD_BATCH, device=DEV)
    ptrs = [p.data_ptr() for p in step.params]
    first = float(step(x, y, w))
    torch.cuda.synchronize()
    pairs, losses = [], []
    t0 = time.perf_counter()
    for _ in range(SGD_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(step(x, y, w))
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / SGD_STEPS
    losses = [float(v) for v in losses]
    check(np.isfinite([first, *losses]).all(), f"losses {losses}")
    check(losses[-1] < first, f"loss did not fall: {first} -> {losses[-1]}")
    check([p.data_ptr() for p in step.params] == ptrs,
          "a parameter slice left its storage")
    prof = train_step_profile(step, x, y, w)
    rep = PDIST.placement_report(placed.state, mesh)
    sgd = frame_train_metrics["distributed_sgd"]
    out = {"ms_per_step": wall * 1e3, "steps_per_s": 1.0 / wall,
           "event_ms_per_step": sum(a.elapsed_time(b) for a, b in pairs)
           / SGD_STEPS,
           "device_ms_per_step": prof["device_ms"],
           "launches_per_step": prof["launches"], "top": prof["top"],
           "first_loss": first, "last_loss": losses[-1],
           "state_bytes": rep["state_bytes"],
           "state_bytes_per_rank": rep["state_bytes_per_device"],
           "sharded_leaves": rep["sharded_leaves"],
           "replicated_leaves": rep["replicated_leaves"],
           "phase22_steps_per_s": sgd["steps_per_s"],
           "phase22_ms_per_step": sgd["ms_per_step"],
           "phase22_device_ms_per_step": sgd.get("device_ms_per_step")}
    print(f"[{card_line}] bench_distributed_sgd's cell on {FRAME_TP_MESH}: "
          f"{out['ms_per_step']:.2f} ms a step of wall, "
          f"{out['steps_per_s']:.2f} steps/s (phase 22's "
          f"{sgd['steps_per_s']:.2f}), CUDA events "
          f"{out['event_ms_per_step']:.2f} ms, device {prof['device_ms']:.2f}"
          f" ms in {prof['launches']:.0f} launches; loss {first:.4f} -> "
          f"{losses[-1]:.4f}; state {rep['state_bytes']} bytes, "
          f"{rep['state_bytes_per_device']} a rank ({rep['sharded_leaves']} "
          f"sharded, {rep['replicated_leaves']} replicated leaves)")
    parity_fn = NNFunction.init({"builder": "cifar_resnet", "depth": 20},
                                (32, 32, 3), seed=1)
    prng = np.random.default_rng(1)
    n = PARITY_BATCH * PARITY_STEPS
    df = DataFrame({"features": prng.uniform(0, 1, (n, 32, 32, 3)).astype(
        np.float32), "label": prng.integers(0, 10, n)})
    runs = {}
    for name, device, shape in (("card", STAGE_DEVICE, FRAME_TP_MESH),
                                ("cpu", "cpu", FRAME_TP_MESH),
                                ("card_data1", STAGE_DEVICE, {"data": 1})):
        learner = NNLearner(model=parity_fn, epochs=1,
                            batch_size=PARITY_BATCH, learning_rate=SGD_LR,
                            cosine_decay=False, log_every=0, device=device,
                            mesh_shape=shape)
        model = learner.fit(df)
        runs[name] = (learner.losses[0], flatten_params(model.model.params))
    for other in ("cpu", "card_data1"):
        (lc, pc), (lr, pr) = runs["card"], runs[other]
        loss_err = float(np.abs(lc - lr).max() / np.abs(lr).max())
        param_err = max(frame_err(pc[k], pr[k]) for k in pr)
        out[f"vs_{other}"] = {"loss_rel_err": loss_err,
                              "param_err": param_err,
                              "losses": lc.tolist(),
                              "other_losses": lr.tolist()}
        print(f"[{card_line}] {PARITY_STEPS} f32 steps on {FRAME_TP_MESH}, "
              f"card (TF32 off) against {other}: losses "
              f"{', '.join(f'{v:.6f}' for v in lc)} vs "
              f"{', '.join(f'{v:.6f}' for v in lr)}, relative "
              f"{loss_err:.3e}; params {param_err:.3e} (tolerance "
              f"{TRAIN_PARITY_TOL})")
        check(loss_err <= TRAIN_PARITY_TOL,
              f"model-axis losses off {other}'s by {loss_err}")
        check(param_err <= TRAIN_PARITY_TOL,
              f"model-axis params off {other}'s by {param_err}")
    return out


def pjit_train_path(train_metrics, card_line) -> dict:
    """(c) The bench step through ``impl="shard_map"`` then ``"pjit"`` on
    a hosted ``{"data": 2, "model": 2}``: 2 warm steps then 10 on one
    batch, a profile of 3, beside phase 11's step. The pjit step
    launches no kernel (dense attention, the dense CE on 4 ranks)."""
    cfg = TRAIN_CFG
    n_tok = TRAIN_B * TRAIN_S
    mesh = build_mesh(MeshSpec.from_dict(PJIT_MESH), DEV)
    batch = T.make_batch(np.random.default_rng(SEED), cfg, TRAIN_B, TRAIN_S,
                         DEV)
    flops = train_flops_per_step(cfg)
    out = {}
    for impl in ("shard_map", "pjit"):
        params = T.shard_params(T.init_params_np(cfg, seed=SEED), cfg, mesh)
        vel = T.init_velocity(params)
        ptrs = [t.data_ptr() for t in T._leaves(params) + T._leaves(vel)]
        step = T.build_spmd_train_step(cfg, mesh, TRAIN_LR, TRAIN_MOMENTUM,
                                       impl=impl)
        torch.cuda.synchronize()
        reset_launch_counts()
        losses = [step(params, vel, *batch)[2] for _ in range(PJIT_WARM)]
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        ev0.record()
        for _ in range(PJIT_STEPS):
            losses.append(step(params, vel, *batch)[2])
        ev1.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PJIT_STEPS
        event_ms = ev0.elapsed_time(ev1) / PJIT_STEPS
        launches = read_launch_counts()
        losses = [float(v) for v in losses]
        check(all(np.isfinite(losses)), f"{impl}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"{impl}: loss did not fall {losses}")
        check([t.data_ptr() for t in T._leaves(params) + T._leaves(vel)]
              == ptrs, f"{impl}: params or velocity moved")
        if impl == "pjit":
            check(not any(launches.values()),
                  f"the pjit step on {PJIT_MESH} launched {launches}")
        prof = device_profile(lambda: step(params, vel, *batch), 3,
                              f"{impl} train step (bf16, B={TRAIN_B} "
                              f"S={TRAIN_S}, {PJIT_MESH})", card_line)
        tflops = flops / (wall_ms / 1e3) / 1e12
        n = PJIT_WARM + PJIT_STEPS
        out[impl] = {"losses": losses, "ms_per_step": wall_ms,
                     "event_ms_per_step": event_ms,
                     "device_busy_ms": prof["device_ms"],
                     "busy_share": prof["device_ms"] / prof["wall_ms"],
                     "profile_wall_ms": prof["wall_ms"],
                     "device_ops_per_step": prof["device_ops"],
                     "tokens_per_s": n_tok / (wall_ms / 1e3),
                     "mfu": tflops * 1e12 / PEAK_BF16_FLOPS,
                     "launches_per_step": {k: v // n for k, v in
                                           launches.items() if v},
                     "top": prof["top"]}
        del params, vel, step
        torch.cuda.empty_cache()
    out["phase11_ms_per_step"] = train_metrics["train_ms_per_step"]
    out["phase11_tokens_per_s"] = train_metrics["train_tokens_per_s"]
    out["phase11_mfu"] = train_metrics["train_mfu"]
    out["phase11_device_busy_ms"] = train_metrics["train_device_busy_ms"]
    print(f"[{card_line}] the bench step on {PJIT_MESH} (bf16, B={TRAIN_B} "
          f"S={TRAIN_S}): " + "; ".join(
              f"{impl} {o['ms_per_step']:.2f} ms/step of wall, "
              f"{o['event_ms_per_step']:.2f} ms between CUDA events, device "
              f"busy {o['device_busy_ms']:.2f} ms "
              f"({100 * o['busy_share']:.1f}%), {o['device_ops_per_step']} "
              f"device ops, {o['tokens_per_s']:.1f} tokens/s, MFU "
              f"{o['mfu']:.4f}" for impl, o in
              ((i, out[i]) for i in ("shard_map", "pjit")))
          + f"; phase 11 {out['phase11_ms_per_step']:.2f} ms, "
            f"{out['phase11_tokens_per_s']:.1f} tokens/s, MFU "
            f"{out['phase11_mfu']:.4f}")
    return out


def pjit_parity(card_line) -> dict:
    """(c) pjit against shard_map in f32 (TF32 off), 2 layers, B 2 x S
    256, 3 steps from the same weights, on ``{"data": 2, "model": 2}``
    and phase 26's 5-axis MoE mesh: the last loss within 2e-5, every
    parameter within 2e-4. On ``{"data": 2, "model": 2}`` pjit with
    ``ce_impl="cuda"`` (K4's training variant and K6 once a step) is held
    against pjit's plain CE at the same limits."""
    out = {}
    for key, shape, kw in PJIT_PARITY:
        cfg = dataclasses.replace(TRAIN_CFG, dtype="float32", **kw)
        tree = T.init_params_np(cfg, seed=SEED)
        batch = T.make_batch(np.random.default_rng(SEED), cfg,
                             PJIT_PARITY_B, PJIT_PARITY_S, DEV)
        runs = {}
        fused = shape == PJIT_MESH
        for impl, ce in (("shard_map", "auto"), ("pjit", "auto"),
                         *((("pjit", "cuda"),) if fused else ())):
            c = dataclasses.replace(cfg, ce_impl=ce)
            mesh = build_mesh(MeshSpec.from_dict(shape), DEV)
            params = T.shard_params(tree, c, mesh)
            vel = T.init_velocity(params)
            step = T.build_spmd_train_step(c, mesh, TRAIN_LR,
                                           TRAIN_MOMENTUM, impl=impl)
            reset_launch_counts()
            with ieee_f32():
                losses = [float(step(params, vel, *batch)[2])
                          for _ in range(PJIT_PARITY_STEPS)]
            runs[impl, ce] = (losses, T.params_to_numpy(params),
                              read_launch_counts())
        (ls, ps, _), (lp, pp, _) = runs["shard_map", "auto"], \
            runs["pjit", "auto"]

        def errs(la, pa, lb, pb):
            return abs(la[-1] - lb[-1]), max(
                float(np.abs(a - b).max())
                for a, b in zip(T._leaves(pa), T._leaves(pb)))
        loss_err, param_err = errs(lp, pp, ls, ps)
        out[key] = {"shard_map_losses": ls, "pjit_losses": lp,
                    "loss_err": loss_err, "param_err": param_err}
        if fused:
            lf, pf, fl = runs["pjit", "cuda"]
            f_loss, f_param = errs(lf, pf, lp, pp)
            out[key]["fused_ce"] = {"losses": lf, "loss_err": f_loss,
                                    "param_err": f_param}
            print(f"[{card_line}] pjit with ce_impl='cuda' against the "
                  f"plain CE, f32 (TF32 off) on {shape}: losses "
                  + ", ".join(f"{v:.7f}" for v in lf) + f", last "
                  f"{f_loss:.3e} (limit {PJIT_LOSS_TOL}); params "
                  f"{f_param:.3e} (limit {PJIT_PARAM_TOL}); launches {fl}")
            check(f_loss < PJIT_LOSS_TOL and f_param < PJIT_PARAM_TOL,
                  f"{shape}: pjit fused CE off the plain CE by "
                  f"{f_loss:.3e} / {f_param:.3e}")
            check_launches(fl, {k: PJIT_PARITY_STEPS
                                * PJIT_CE_LAUNCHES.get(k, 0) for k in fl},
                           f"pjit fused-CE f32 parity on {shape}")
        print(f"[{card_line}] pjit against shard_map, f32 (TF32 off) on "
              f"{shape}, {PJIT_PARITY_STEPS} steps, B {PJIT_PARITY_B} x S "
              f"{PJIT_PARITY_S}: losses " + ", ".join(f"{v:.7f}" for v in lp)
              + " vs " + ", ".join(f"{v:.7f}" for v in ls)
              + f", last {loss_err:.3e} (limit {PJIT_LOSS_TOL}); params "
              f"{param_err:.3e} (limit {PJIT_PARAM_TOL})")
        check(loss_err < PJIT_LOSS_TOL, f"{shape}: pjit loss off by "
                                        f"{loss_err:.3e}")
        check(param_err < PJIT_PARAM_TOL, f"{shape}: pjit params off by "
                                          f"{param_err:.3e}")
    return out


def pjit_ce_path(card_line) -> tuple:
    """(c) The bench step through ``impl="pjit"`` with ``ce_impl="cuda"``
    on ``{"data": 1}`` and on ``{"data": 2, "model": 2}``: K4's training
    variant and K6's dh and dW once a step over the global batch, K7 and
    every other kernel 0. Returns the launches of both meshes (the pjit
    path of the kernel table) and, by mesh, the step's wall ms."""
    cfg = dataclasses.replace(TRAIN_CFG, ce_impl="cuda")
    total, out = {}, {}
    for shape in PJIT_CE_MESHES:
        mesh = build_mesh(MeshSpec.from_dict(shape), DEV)
        batch = T.make_batch(np.random.default_rng(SEED), cfg, TRAIN_B,
                             TRAIN_S, DEV)
        params = T.shard_params(T.init_params_np(cfg, seed=SEED), cfg, mesh)
        vel = T.init_velocity(params)
        step = T.build_spmd_train_step(cfg, mesh, TRAIN_LR, TRAIN_MOMENTUM,
                                       impl="pjit")
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        losses = [step(params, vel, *batch)[2]
                  for _ in range(PJIT_CE_STEPS)]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PJIT_CE_STEPS
        launches = read_launch_counts()
        losses = [float(v) for v in losses]
        check(all(np.isfinite(losses)), f"pjit fused-CE losses on {shape} "
                                        f"{losses}")
        want = {k: PJIT_CE_STEPS * PJIT_CE_LAUNCHES.get(k, 0)
                for k in launches}
        print(f"[{card_line}] pjit on {shape}, ce_impl='cuda', "
              f"{PJIT_CE_STEPS} steps: {wall_ms:.2f} ms a step (the first "
              f"included), losses " + ", ".join(f"{v:.4f}" for v in losses)
              + f"; launches {launches}")
        check_launches(launches, want, f"pjit fused-CE path on {shape}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        out[PDIST.placement_label(mesh)] = {
            "ms_per_step_with_first": wall_ms, "losses": losses,
            "launches_per_step": {k: v // PJIT_CE_STEPS for k, v
                                  in launches.items() if v}}
        del params, vel
        torch.cuda.empty_cache()
    return total, out


def model_axes_phase(frame_metrics, frame_train_metrics, train_metrics,
                     card_line) -> tuple:
    """Phase 27: (a) frame scoring with TP and PP and the pipelined
    server, (b) frame training on the model axis, (c) the pjit step.
    Returns the pjit fused-CE path's launches and the metrics."""
    t_phase = time.perf_counter()
    parts, out = {}, {}
    reset_launch_counts()
    for name, run in (
            ("scoring", lambda: frame_parallel_scoring(frame_metrics,
                                                       card_line)),
            ("serving", lambda: frame_pipelined_serving(card_line)),
            ("training", lambda: frame_model_axis_train(frame_train_metrics,
                                                        card_line))):
        t0 = time.perf_counter()
        out[name] = run()
        parts[name] = time.perf_counter() - t0
    launches = read_launch_counts()
    check(not any(launches.values()),
          f"the frame plane's parallel modes launched kernels: {launches}")
    for name, run in (("pjit_train", lambda: pjit_train_path(train_metrics,
                                                             card_line)),
                      ("pjit_parity", lambda: pjit_parity(card_line))):
        t0 = time.perf_counter()
        out[name] = run()
        parts[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ce_launches, out["pjit_fused_ce"] = pjit_ce_path(card_line)
    parts["pjit_fused_ce"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card_line}] the model and pipe axes on the frame plane and the "
          f"pjit step took {out['seconds']:.1f} s (" + ", ".join(
              f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    return ce_launches, out


# ---------------------------------------------------------------------------
# phase 28: checkpoints and the retrain loop

CKPT_STEPS = 3
# the resumed bf16 steps against the uninterrupted ones: bit-equal where
# every kernel of the step is deterministic; 1e-6 relative otherwise
CKPT_LOSS_TOL = 1e-6
# saved on {"data": 2, "model": 2}, resumed there and on {"data": 1}:
# tests/test_transformer.py's cross-mesh limit on the loss
CKPT_MESH_TOL = 2e-5
CKPT_MESH_CFG = dataclasses.replace(CFG, dtype="float32", layers_per_stage=2)
CKPT_MESH_B, CKPT_MESH_S = 2, 256
CKPT_FAULT_STEP, CKPT_EVERY = 10, 4
LOOP_BATCH_ROWS = 16
LOOP_SCORE_TOL = 1e-5
LOOP_PROBES = 4


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def train_state_cell(tmp, card_line) -> dict:
    """(a) The bench step's state (bf16 step, f32 params and velocity):
    3 steps, ``save_train_state``, 3 more (the uninterrupted run), then
    ``restore_train_state`` onto the card and the same 3 steps from it:
    every restored leaf equal to the saved one, the resumed losses equal
    to the uninterrupted ones, phase 11's launches a step."""
    cfg = TRAIN_CFG
    batch = T.make_batch(np.random.default_rng(SEED), cfg, TRAIN_B, TRAIN_S,
                         DEV)
    params, vel = train_state(cfg)
    step = T.build_train_step(cfg, TRAIN_LR, TRAIN_MOMENTUM, device=DEV)
    for _ in range(CKPT_STEPS):
        step(params, vel, *batch)
    torch.cuda.synchronize()
    saved = [t.clone() for t in T._leaves(params) + T._leaves(vel)]
    path = os.path.join(tmp, "train_state")
    t0 = time.perf_counter()
    T.save_train_state(path, params, vel, step=CKPT_STEPS)
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(path)

    def run(p, v):
        torch.cuda.synchronize()
        reset_launch_counts()
        losses = [step(p, v, *batch)[2] for _ in range(CKPT_STEPS)]
        torch.cuda.synchronize()
        return [float(x) for x in losses], read_launch_counts()

    ref, ref_launches = run(params, vel)
    del params, vel
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rp, rv, at = T.restore_train_state(path, cfg, device=DEV)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(at == CKPT_STEPS, f"restored step {at}")
    restored = T._leaves(rp) + T._leaves(rv)
    check(len(restored) == len(saved) and all(
        a.device.type == DEV.type and torch.equal(a, b)
        for a, b in zip(restored, saved)),
        "a restored leaf differs from the saved one")
    del saved
    got, got_launches = run(rp, rv)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    for launches in (ref_launches, got_launches):
        for name, per_step in TRAIN_LAUNCHES.items():
            check(launches[name] == per_step * CKPT_STEPS,
                  f"{name}: {launches[name]} launches in {CKPT_STEPS} "
                  f"resumed steps, expected {per_step * CKPT_STEPS}")
    check(rel <= CKPT_LOSS_TOL, f"resumed losses {got} vs {ref}: {rel:.3e}")
    out = {"save_ms": save_s * 1e3, "restore_ms": restore_s * 1e3,
           "bytes_on_disk": nbytes, "save_gb_per_s": nbytes / save_s / 1e9,
           "restore_gb_per_s": nbytes / restore_s / 1e9,
           "losses_uninterrupted": ref, "losses_resumed": got,
           "loss_rel_diff": rel, "bit_equal": got == ref,
           "launches_per_step": {k: v // CKPT_STEPS
                                 for k, v in got_launches.items()}}
    print(f"[{card_line}] train state (bench width, {nbytes / 1e6:.1f} MB "
          f"on disk): save {out['save_ms']:.1f} ms "
          f"({out['save_gb_per_s']:.3f} GB/s), restore onto the card "
          f"{out['restore_ms']:.1f} ms ({out['restore_gb_per_s']:.3f} "
          f"GB/s, warm read); every leaf equal; {CKPT_STEPS} resumed steps "
          f"{got} vs uninterrupted {ref}: max rel {rel:.3e}, bit-equal "
          f"{out['bit_equal']}; launches a step as phase 11's")
    del rp, rv
    torch.cuda.empty_cache()
    out["cross_mesh"] = cross_mesh_cell(tmp, card_line)
    return out


def cross_mesh_cell(tmp, card_line) -> dict:
    """f32 (TF32 off), 2 layers, B 2 x S 256: 2 steps on a hosted
    ``{"data": 2, "model": 2}``, saved in that mesh's layout, 2 more;
    resumed on ``{"data": 1}`` and on the original mesh for the same 2
    steps."""
    cfg = CKPT_MESH_CFG
    tokens, labels, mask = T.make_batch(np.random.default_rng(SEED), cfg,
                                        CKPT_MESH_B, CKPT_MESH_S, DEV)

    def mesh_of(shape):
        return build_mesh(MeshSpec.from_dict(shape), DEV)

    def run(mesh, p, v, n):
        step = T.build_spmd_train_step(cfg, mesh, TRAIN_LR, TRAIN_MOMENTUM)
        loss = None
        for _ in range(n):
            p, v, loss = step(p, v, tokens, labels, mask)
        return p, v, float(loss)

    mesh_a = mesh_of({"data": 2, "model": 2})
    p = T.shard_params(T.init_params_np(cfg, seed=SEED), cfg, mesh_a)
    p, v, _ = run(mesh_a, p, T.init_velocity(p), 2)
    path = os.path.join(tmp, "mesh_state")
    T.save_train_state(path, p, v, step=2, cfg=cfg, mesh=mesh_a)
    _, _, ref = run(mesh_a, p, v, 2)
    out = {"uninterrupted": ref}
    for name, shape in (("data1", {"data": 1}),
                        ("data2_model2", {"data": 2, "model": 2})):
        mesh = mesh_of(shape)
        rp, rv, at = T.restore_train_state(path, cfg, mesh)
        check(at == 2, f"restored step {at}")
        _, _, out[name] = run(mesh, rp, rv, 2)
        check(abs(out[name] - ref) <= CKPT_MESH_TOL,
              f"resumed on {shape}: loss {out[name]} vs {ref}")
    out["max_abs_diff"] = max(abs(out[k] - ref)
                              for k in ("data1", "data2_model2"))
    print(f"[{card_line}] f32 train state saved on a hosted {{data 2, model "
          f"2}}, resumed on {{data 1}} and on the original mesh: losses "
          f"{out['data1']:.7f}, {out['data2_model2']:.7f} vs uninterrupted "
          f"{ref:.7f} (max |diff| {out['max_abs_diff']:.2e}, limit "
          f"{CKPT_MESH_TOL})")
    torch.cuda.empty_cache()
    return out


def hist_totals(name) -> tuple:
    """``(count, sum)`` of one of the trainer's histograms."""
    st = trainer_metrics()[name].stats()
    return st["count"], st["sum"]


def learner_chaos_cell(tmp, card_line) -> dict:
    """(b) Phase 22's cell through ``NNLearner``: ResNet-20 bf16, batch
    256, 4096 images x 2 epochs, a checkpoint every 4 steps, once with a
    ``FaultPlan`` step fault at step 10 and once clean, both under
    deterministic algorithms: the parameters bit-equal, one restart."""
    from mmlspark_tpu_torch.models.function import flatten_params
    from mmlspark_tpu_torch.testing.faults import FaultPlan
    rng = np.random.default_rng(0)
    df = DataFrame({"features": rng.uniform(0, 1, (FIT_IMAGES, 32, 32, 3))
                    .astype(np.float32),
                    "label": rng.integers(0, 10, FIT_IMAGES)})
    fn = NNFunction.init(SGD_ARCH, (32, 32, 3), seed=0)
    restarts = trainer_metrics()["restarts"]
    before = {"restarts": restarts.value,
              "save": hist_totals("ckpt_save_ms"),
              "restore": hist_totals("ckpt_restore_ms")}
    plan = FaultPlan(script={"train_step": ["ok"] * (CKPT_FAULT_STEP - 1)
                             + ["fail"]})
    runs, secs = {}, {}
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        for name, kw in (("faulted", dict(
                checkpoint_dir=os.path.join(tmp, "learner"),
                checkpoint_every=CKPT_EVERY,
                fault_injector=plan.step_fault())), ("clean", {})):
            learner = NNLearner(model=fn, epochs=FIT_EPOCHS,
                                batch_size=FIT_BATCH, learning_rate=SGD_LR,
                                log_every=0, device=STAGE_DEVICE, **kw)
            t0 = time.perf_counter()
            runs[name] = flatten_params(learner.fit(df).model.params)
            secs[name] = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    check(plan.summary()["injected"] == {"train_step": {"fail": 1}},
          f"the fault did not fire once: {plan.summary()}")
    check(restarts.value == before["restarts"] + 1,
          f"trainer_restarts_total {restarts.value}, before "
          f"{before['restarts']}")
    same = all(np.array_equal(runs["faulted"][k], runs["clean"][k])
               for k in runs["clean"])
    diff = max(float(np.abs(runs["faulted"][k] - runs["clean"][k]).max())
               for k in runs["clean"])
    check(same, f"the resumed fit's parameters differ by {diff:.3e}")
    (n_s, s_s), (n_r, s_r) = (hist_totals("ckpt_save_ms"),
                              hist_totals("ckpt_restore_ms"))
    saves = n_s - before["save"][0]
    # every 4th step once (the steps after the restored one re-run
    # after it), and the final save
    steps = FIT_IMAGES // FIT_BATCH * FIT_EPOCHS
    check(saves == steps // CKPT_EVERY + 1, f"{saves} checkpoint saves")
    out = {"seconds": secs, "bit_equal": same, "max_abs_diff": diff,
           "restarts": 1, "saves": saves,
           "save_ms_mean": (s_s - before["save"][1]) / max(saves, 1),
           "restores": n_r - before["restore"][0],
           "restore_ms_mean": (s_r - before["restore"][1])
           / max(n_r - before["restore"][0], 1)}
    check(out["restores"] == 1, f"{out['restores']} restores")
    print(f"[{card_line}] NNLearner (ResNet-20 bf16, {FIT_IMAGES} images x "
          f"{FIT_EPOCHS} epochs, batch {FIT_BATCH}, a checkpoint every "
          f"{CKPT_EVERY} steps, deterministic algorithms): a step fault at "
          f"step {CKPT_FAULT_STEP} restored step 8 and the fit reached the "
          f"clean fit's parameters bit for bit; {saves} saves "
          f"{out['save_ms_mean']:.1f} ms each, a restore "
          f"{out['restore_ms_mean']:.1f} ms; fits {secs['faulted']:.1f} s "
          f"(faulted) and {secs['clean']:.1f} s")
    return out


def uint8_rows(rng, n):
    x = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    return x, rng.integers(0, 10, n)


def as_uint8(df):
    """The stream's transform: JSON rows' integer images back to uint8."""
    from mmlspark_tpu_torch.models.nn import _stack_column
    return df.with_column("features", _stack_column(
        df["features"]).astype(np.uint8))


def loop_learner(tmp, fn, name):
    return NNLearner(model=fn, features_col="features", label_col="label",
                     learning_rate=SGD_LR, batch_size=256, log_every=0,
                     checkpoint_dir=os.path.join(tmp, name),
                     device=STAGE_DEVICE)


def retrain_loop_cell(tmp, card_line) -> dict:
    """(c) ``tests/test_streaming_engine.py``'s retrain loop on the card:
    phase 22's ResNet-20 served by two ``ServingServer``s behind a
    coordinator (one capturing), background traffic of uint8 32x32x3
    rows throughout, ``fit_stream`` over the capture training on the card
    and exporting, ``RetrainLoop`` pushing the export through the canary
    rollout; then a crash between the sink and the commit, replayed and
    skipped once."""
    from mmlspark_tpu_torch.core.stage import PipelineStage
    from mmlspark_tpu_torch.core.resilience import RetryPolicy
    from mmlspark_tpu_torch.serving import (
        ServingCoordinator, TrafficCapture)
    from mmlspark_tpu_torch.streaming import RetrainLoop, TrafficLogSource
    rng = np.random.default_rng(3)
    fn = NNFunction.init(SGD_ARCH, (32, 32, 3), seed=0)
    v1_dir = os.path.join(tmp, "v1")
    NNModel(model=fn, input_col="features", output_col="scores",
            input_dtype="uint8", device=STAGE_DEVICE).save(v1_dir)
    capdir, exp = os.path.join(tmp, "cap"), os.path.join(tmp, "exp")
    xw, _ = uint8_rows(rng, 1)
    warm = {"features": xw[0].tolist(), "label": 0}
    cap = TrafficCapture(capdir)
    coord = ServingCoordinator().start()
    workers, stop = [], threading.Event()
    results = {"ok": 0, "bad": []}
    t_phase = time.perf_counter()
    try:
        for i in range(2):
            srv = ServingServer(
                PipelineStage.load(v1_dir, device=STAGE_DEVICE),
                max_batch_size=4,
                max_latency_ms=1, model_version="v1",
                capture=cap if i == 0 else None, slow_trace_ms=None)
            srv.warmup(warm)
            srv.start()
            ServingCoordinator.register_worker(
                f"http://{coord.host}:{coord.port}", srv.host, srv.port)
            workers.append(srv)
        xs, ys = uint8_rows(rng, 256)

        def traffic():
            i = 0
            while not stop.is_set():
                srv = workers[i % 2]
                try:
                    status, _, body = http_call(
                        srv, "POST", "/predict",
                        {"features": xs[i % 256].tolist(),
                         "label": int(ys[i % 256])},
                        {"X-Request-Id": f"loop-{i}"})
                    reply = json.loads(body)
                    if status == 200 and len(reply.get("scores", [])) == 10:
                        results["ok"] += 1
                    else:
                        results["bad"].append((i, status, body[:200]))
                except Exception as e:  # noqa: BLE001 — counted as bad
                    results["bad"].append((i, "exc", str(e)))
                i += 1
                time.sleep(0.002)

        t = threading.Thread(target=traffic, daemon=True, name="traffic")
        t.start()
        fit = loop_learner(tmp, fn, "train").fit_stream(
            TrafficLogSource(capdir), export_dir=exp,
            export_every_batches=2, checkpoint_dir=os.path.join(tmp, "wal"),
            max_batch_rows=LOOP_BATCH_ROWS, transform=as_uint8)
        t_fit = time.perf_counter()
        # one batch a poll: under steady traffic the source is never
        # idle, so draining it would not return
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not fit.exports:
            fit.query.process_available(max_batches=1)
            time.sleep(0.05)
        fit_s = time.perf_counter() - t_fit
        check(bool(fit.exports), "fit_stream never exported")
        trained = fit.status()["trainer"]
        # the canary's p95 is read from at least 50 requests: over the 4
        # of tests/test_streaming_engine.py it is one request's latency,
        # and one host stall (90 ms against 24 on an H100) rolled the
        # export back
        loop = RetrainLoop(
            exp, f"http://{coord.host}:{coord.port}", warmup_payload=warm,
            poll_interval_s=0.1,
            rollout={"canary": True, "canary_min_requests": 50,
                     "canary_window_s": 15.0, "stage_timeout_s": 60.0})
        t_roll = time.perf_counter()
        loop.start()
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and loop.n_completed == 0 \
                and loop.n_failed == 0 and loop.n_rolled_back == 0:
            time.sleep(0.1)
        loop.stop()
        rollout_s = time.perf_counter() - t_roll
        stop.set()
        t.join(timeout=30)
        status = loop.status()
        check(loop.n_completed == 1, f"the retrain rollout did not "
                                     f"complete: {status['history']}")
        version = status["history"][-1]["version"]
        for srv in workers:
            _, _, body = http_call(srv, "GET", "/version")
            active = json.loads(body)["active"]
            check(active["version"] == version
                  and active["state"] == "active",
                  f"worker {srv.port} serves {active}")
        export = PipelineStage.load(os.path.join(exp, version),
                                    device=STAGE_DEVICE)
        probes, _ = uint8_rows(rng, LOOP_PROBES)
        score_err = 0.0
        for row in probes:
            want = np.asarray(export.transform(DataFrame(
                {"features": row[None]}))["scores"], np.float64)[0]
            for srv in workers:
                status_code, _, body = http_call(
                    srv, "POST", "/predict", {"features": row.tolist()})
                check(status_code == 200, f"probe status {status_code}")
                got = np.asarray(json.loads(body)["scores"], np.float64)
                score_err = max(score_err, float(
                    np.abs(got - want).max() / max(1.0, np.abs(want).max())))
        check(score_err <= LOOP_SCORE_TOL,
              f"served scores off the export's by {score_err:.3e}")
        check(not results["bad"], f"bad replies: {results['bad'][:5]}")
        check(results["ok"] > 0, "no traffic answered")
    finally:
        stop.set()
        for srv in workers:
            srv.stop()
        coord.stop()
        cap.stop()
    loop_s = time.perf_counter() - t_phase
    replay = replay_cell(tmp, fn, capdir)
    out = {"replies_ok": results["ok"], "replies_bad": len(results["bad"]),
           "fit_stream_s": fit_s, "rollout_s": rollout_s, "loop_s": loop_s,
           "trained": {k: trained[k] for k in (
               "n_batches_trained", "n_rows_trained", "n_exports",
               "last_loss")},
           "version": version, "decision": status["history"][-1].get(
               "decision"), "score_err": score_err, "replay": replay}
    print(f"[{card_line}] retrain loop: {results['ok']} replies, 0 bad; "
          f"fit_stream trained {trained['n_batches_trained']} batches "
          f"({trained['n_rows_trained']} rows) on the card and exported in "
          f"{fit_s:.1f} s; RetrainLoop rolled {version} out in "
          f"{rollout_s:.1f} s; served scores within {score_err:.2e} of the "
          f"export's; replay after a sink/commit crash skipped "
          f"{replay['n_replays_skipped']} batch ({replay['rows']} rows "
          f"trained once)")
    return out


def replay_cell(tmp, fn, capdir) -> dict:
    """A crash after the trainer sink and before the commit: the restarted
    query replays the batch and the sink skips it, every labeled row
    (the probes after the flip carry no label) trained once."""
    from mmlspark_tpu_torch.core.resilience import RetryPolicy
    from mmlspark_tpu_torch.streaming import TrafficLogSource
    total = TrafficLogSource(capdir, cursor_path=os.path.join(
        tmp, "count.json"))
    meta = total.plan()
    labels = total.read(meta)["label"] if meta else []
    n_rows = sum(v is not None for v in labels)
    per_batch = max(n_rows // 4, 1)        # a crash at batch 2 of 4 or 5
    check(n_rows >= 3, f"{n_rows} labeled rows captured")

    def make():
        return loop_learner(tmp, fn, "replay_train").fit_stream(
            TrafficLogSource(capdir,
                             cursor_path=os.path.join(tmp, "replay.json")),
            checkpoint_dir=os.path.join(tmp, "replay_wal"),
            max_batch_rows=per_batch, min_batch_rows=per_batch,
            transform=as_uint8, retry_policy=RetryPolicy(max_attempts=1))

    fit = make()
    inner = fit.query.sink

    class Crasher:
        def process(self, bid, df):
            inner.process(bid, df)
            if bid == 2:
                raise RuntimeError("injected kill between sink and commit")

    fit.query.sink = Crasher()
    try:
        fit.query.process_available()
        check(False, "the injected crash did not fire")
    except RuntimeError as e:
        check("injected kill" in str(e), f"unexpected error {e}")
    first = inner.status()
    fit2 = make()
    fit2.query.process_available()
    st = fit2.status()
    rows = first["n_rows_trained"] + st["trainer"]["n_rows_trained"]
    check(st["query"]["n_replayed_batches"] == 1
          and st["trainer"]["n_replays_skipped"] == 1,
          f"replay: {st['query']['n_replayed_batches']} replayed, "
          f"{st['trainer']['n_replays_skipped']} skipped")
    check(rows == n_rows, f"{rows} rows trained, {n_rows} captured")
    return {"n_replays_skipped": st["trainer"]["n_replays_skipped"],
            "rows": rows, "rows_per_batch": per_batch}


def checkpoint_phase(card_line) -> dict:
    """Phase 28: (a) the bench step's train state saved, restored and
    resumed, and across meshes, (b) ``NNLearner``'s bounded restart at
    phase 22's cell, (c) the retrain loop; (b) and (c) launch no kernel
    (the frame plane's network runs on cuDNN and cuBLAS)."""
    t_phase = time.perf_counter()
    parts, out = {}, {}
    tmp = tempfile.mkdtemp(prefix="phase28_")
    try:
        t0 = time.perf_counter()
        out["train_state"] = train_state_cell(tmp, card_line)
        parts["train_state"] = time.perf_counter() - t0
        reset_launch_counts()
        for name, run in (("learner", learner_chaos_cell),
                          ("retrain_loop", retrain_loop_cell)):
            t0 = time.perf_counter()
            out[name] = run(tmp, card_line)
            parts[name] = time.perf_counter() - t0
        launches = read_launch_counts()
        check(not any(launches.values()),
              f"the learner and the retrain loop launched kernels: "
              f"{launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card_line}] checkpoints and the retrain loop took "
          f"{out['seconds']:.1f} s (" + ", ".join(
              f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# phase 29: distributed GBDT on a hosted data mesh (slice 21)

#: the data axis the adult cell is sharded over, its ranks hosted on
#: the card
DIST_MESH = {"data": 4}
#: (label, tree_learner, top_k); 2 x 7 covers the cell's 14 features
DIST_LEARNERS = (("data", "data", 20), ("feature", "feature", 20),
                 ("voting_top7", "voting", 7), ("voting_top2", "voting", 2))
#: iterations of the profiled fit that gives each learner's busy share
DIST_PROFILE_ITERS = 2
#: tests/test_gbdt.py:278-280, voting with every feature voted against
#: the serial fit: fewer than 5% of the rows' predictions off by > 0.05
VOTE_NEAR, VOTE_NEAR_SHARE = 0.05, 0.05
#: voting with top_k 2 must stay usable: its train AUC at most this
#: below the single-device fit's (the cell's labels are logistic draws,
#: so no fit reaches an AUC of 0.9 on it: the CPU's single-device fit
#: reads 0.832 at 100 iterations, 0.802 at 50, voting top_k 2 0.798)
VOTE_SMALL_AUC_GAP = 0.02


def k9_per_fit(learner: str, b, ranks: int) -> int:
    """K9's launches in one fit of ``b`` (PERF.md's launches row): data
    iterations x leaves (the device grower's fixed bodies, the hosted
    ranks sharing a launch); feature iterations x (1 + splits a tree),
    the root and each split's left child over every feature in one
    launch; voting iterations x ranks x (1 + 2 x splits a tree), each
    rank's rows apart and both children built directly."""
    it = len(b.trees)
    splits = sum((t.n_nodes - 1) // 2 for ts in b.trees for t in ts)
    if learner == "data":
        return it * b.params.num_leaves
    if learner == "feature":
        return it + splits
    return ranks * (it + 2 * splits)


def gbdt_busy(p, X, y, kw, sharding) -> dict:
    """A fit of DIST_PROFILE_ITERS iterations under torch.profiler, the
    device's activity only (host ops would multiply the events a
    host-bound fit records): its wall, its device time, the busy share
    and K9's device ms (its launches are not the path's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_all = time.perf_counter()
    short = dataclasses.replace(p, num_iterations=DIST_PROFILE_ITERS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        Booster.train(short, X, y, sharding=sharding, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    dev_ms = sum(ms for _, ms in rows)
    return {"profiled_iterations": DIST_PROFILE_ITERS, "wall_ms": wall_ms,
            "device_ms": dev_ms, "busy_share": dev_ms / wall_ms,
            "k9_ms": sum(ms for k, ms in rows if "hist_" in k),
            "profile_s": time.perf_counter() - t_all}


def distributed_gbdt_phase(card_line) -> dict:
    """Phase 29: bench_adult_census's cell through ``Booster.train`` on a
    hosted {"data": 4} mesh on the card, once a learner, beside the
    single-device fit; K9 counted exactly around each fit, no other
    kernel, and the plain histogram never called."""
    from mmlspark_tpu_torch.gbdt.booster import eval_metric

    t_phase = time.perf_counter()
    X, y, p, kw = adult_cell()
    mesh = build_mesh(MeshSpec.from_dict(DIST_MESH), DEV)
    check(mesh.hosted and mesh.device.type == "cuda",
          f"the GBDT mesh is {mesh}")
    ranks = DIST_MESH["data"]
    plain_calls = []
    plain = CH.build_histogram_plain

    def counted_plain(*a, **k):
        plain_calls.append(1)
        return plain(*a, **k)

    def fit(params, sharding):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        b = Booster.train(params, X, y, sharding=sharding, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return b, secs, read_launch_counts()

    def auc(pred):
        return eval_metric("auc", y, pred, single.obj)[0]

    CH.build_histogram_plain = counted_plain
    try:
        if "gbdt_adult" in CARD_FITS:
            # phase 13's fit of this cell (its K9 launches checked there;
            # its seconds the median of GBDT_TIMED_FITS)
            single, single_s = CARD_FITS["gbdt_adult"]
        else:
            single, single_s, launches = fit(p, None)
            check(launches["gbdt_histogram"]
                  == k9_per_fit("data", single, 1),
                  f"single-device fit: K9 {launches['gbdt_histogram']}")
        single_pred = single.predict(X)
        out = {"mesh": DIST_MESH, "rows": len(X), "features": X.shape[1],
               "single": {"fit_s": single_s, "train_auc": auc(single_pred),
                          "k9_launches": k9_per_fit("data", single, 1),
                          **gbdt_busy(p, X, y, kw, None)}}
        sp = out["single"]
        print(f"[{card_line}] adult cell single-device fit {single_s:.3f} "
              f"s, train AUC {sp['train_auc']:.6f}; {DIST_PROFILE_ITERS}-"
              f"iteration fit {100 * sp['busy_share']:.1f}% device-busy")
        for label, learner, top_k in DIST_LEARNERS:
            lp = dataclasses.replace(p, tree_learner=learner, top_k=top_k)
            b, secs, launches = fit(lp, mesh)
            want = k9_per_fit(learner, b, ranks)
            check(launches["gbdt_histogram"] == want,
                  f"{label}: K9 launched {launches['gbdt_histogram']} "
                  f"times, expected {want}")
            for name, n in launches.items():
                check(name == "gbdt_histogram" or n == 0,
                      f"{label}: {name} launched {n} times")
            rec = {"tree_learner": learner, "top_k": top_k, "fit_s": secs,
                   "k9_launches": want,
                   "splits": sum((t.n_nodes - 1) // 2
                                 for ts in b.trees for t in ts),
                   **gbdt_busy(lp, X, y, kw, mesh)}
            if learner in ("data", "feature"):
                rec.update(same_trees(b, single, p.num_iterations,
                                      labels=(label, "single"), X=X))
                require_same(rec, f"{label} against the single-device fit",
                             p.num_iterations)
            pred = b.predict(X)
            rec["train_auc"] = auc(pred)
            off = float(np.mean(np.abs(pred - single_pred) > VOTE_NEAR))
            rec["share_off_single"] = off
            if label == "voting_top7":
                check(off < VOTE_NEAR_SHARE,
                      f"voting with every feature voted: {off:.4f} of "
                      f"the rows off the single-device fit by > "
                      f"{VOTE_NEAR}")
            if label == "voting_top2":
                check(rec["train_auc"] >= sp["train_auc"]
                      - VOTE_SMALL_AUC_GAP,
                      f"voting top_k 2: train AUC {rec['train_auc']:.4f} "
                      f"against the single-device fit's "
                      f"{sp['train_auc']:.4f}")
            out[label] = rec
            print(f"[{card_line}] {label} on hosted {DIST_MESH}: fit "
                  f"{secs:.3f} s ({secs / single_s:.2f}x the single-device "
                  f"fit), {DIST_PROFILE_ITERS}-iteration fit "
                  f"{100 * rec['busy_share']:.1f}% device-busy (single "
                  f"{100 * sp['busy_share']:.1f}%), K9 {want} launches "
                  f"({rec['splits']} splits), train AUC "
                  f"{rec['train_auc']:.6f}, {100 * off:.2f}% of rows off "
                  f"the single-device fit by > {VOTE_NEAR}"
                  + (f", first {rec['equal_iters']} iterations equal"
                     if "equal_iters" in rec else ""))
    finally:
        CH.build_histogram_plain = plain
    check(not plain_calls, f"the plain histogram ran {len(plain_calls)} "
                           f"times on the card")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card_line}] distributed GBDT took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 30: the load drivers (slice 21)

#: bench.py's decode_continuous_v1 shape, cut to 48 requests
LOAD_WORKLOAD = dict(n_requests=48, seed=0, mean_gap_ms=3.0,
                     max_new=(4, 12, 40))
LOAD_PREFIX_SHARE = 0.5
#: bench_serving_throughput's connection counts, each driven this long
LOAD_CONNECTIONS = (8, 64)
LOAD_DRIVE_S = 2.0
#: POST /generate over phase 4's decoder: connections x requests each
GENERATE_CONNS, GENERATE_PER_CONN, GENERATE_NEW = 8, 4, 16


class RowIdentity(Transformer):
    """bench.py's trivial serving model (``_identity_model``): the
    request's ``x`` back as ``y``, so a drive measures the stack."""

    def transform(self, df):
        return df.with_column("y", np.asarray(df["x"], dtype=np.float64))


def batching_run(dec, run, card_line) -> dict:
    """``run_static`` or ``run_continuous`` over LOAD_WORKLOAD on ``dec``,
    the decoder's steps counted: K1 once a layer a step, K2 once a layer
    a prefill (every request cold), nothing else."""
    jobs = make_workload(CFG.vocab, **LOAD_WORKLOAD)
    steps = [0]
    step = dec.step

    def counting(*a, **k):
        steps[0] += 1
        return step(*a, **k)

    ptr = dec.cache["k"].data_ptr()
    dec.step = counting
    torch.cuda.synchronize()
    reset_launch_counts()
    try:
        res = run(dec, jobs)
    finally:
        del dec.step
    torch.cuda.synchronize()
    launches = read_launch_counts()
    mode = res["mode"]
    check(res["post_warmup_recompiles"] == 0, f"{mode}: recompiles")
    check(res["tokens"] == sum(j.max_new for j in jobs),
          f"{mode}: {res['tokens']} tokens")
    check(dec.cache["k"].data_ptr() == ptr, f"{mode}: the KV pool moved")
    if mode == "continuous":
        check(res["cache_buffer_stable"], "continuous: the pool moved")
        check(res["live_array_growth"] == 0,
              f"continuous: live allocations grew by "
              f"{res['live_array_growth']}")
    want = {n: 0 for n in launches}
    want["paged_decode_attention"] = CFG.n_layers * steps[0]
    want["flash_prefill_attention"] = CFG.n_layers * len(jobs)
    check_launches(launches, want, mode)
    res["steps"] = steps[0]
    print(f"[{card_line}] run_{mode}: {res['tokens']} tokens in "
          f"{res['makespan_s']:.3f} s = {res['tokens_per_s']:.1f} tokens/s, "
          f"{steps[0]} steps, mean done {res['mean_done_s']:.3f} s")
    return res


def sessions_run(dec, label, launches_of, card_line) -> dict:
    """``run_scheduler_sessions`` over LOAD_WORKLOAD with prefix sharing
    on a fresh scheduler over ``dec``: every reply, the pool and the page
    ledger clean at the end, each kernel per ``launches_of(stats)``."""
    jobs = make_workload(CFG.vocab, **LOAD_WORKLOAD,
                         prefix_share=LOAD_PREFIX_SHARE)
    sched = DecodeScheduler(dec, max_new_tokens_default=MAX_NEW).start()
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        res = run_scheduler_sessions(sched, jobs, timeout_s=600,
                                     rid_prefix=label)
        torch.cuda.synchronize()
        launches = read_launch_counts()
        stats = sched.stats()
    finally:
        sched.stop()
    check(res["errors"] == 0, f"{label}: {res['errors']} errors")
    check(res["tokens"] == sum(j.max_new for j in jobs),
          f"{label}: {res['tokens']} tokens")
    for key in ("slots_all_freed", "pages_all_freed", "cache_buffer_stable"):
        check(res[key], f"{label}: {key} is false")
    check(res["post_warmup_recompiles"] == 0, f"{label}: recompiles")
    check(stats["n_step_faults"] == 0, f"{label}: a step faulted")
    check(res["prefix_cache"]["hits"] > 0, f"{label}: no prefix hit")
    check_launches(launches, launches_of(stats), label)
    res.pop("sequences")
    res["launches"] = {k: v for k, v in launches.items() if v}
    print(f"[{card_line}] run_scheduler_sessions {label}: {res['tokens']} "
          f"tokens in {res['makespan_s']:.3f} s = {res['tokens_per_s']:.1f} "
          f"tokens/s, peak {res['peak_concurrent_sessions']} sessions, "
          f"{res['prefix_cache']['hits']} prefix hits"
          + (f", acceptance {res['acceptance_rate']}"
             if "acceptance_rate" in res else "")
          + f"; launches {res['launches']}")
    return res


def load_phase(params, tree, dtree, dcfg, card_line) -> dict:
    """Phase 30: the decode drivers over phase 4's decoder and phase 7's
    speculative one, the keep-alive driver against ``ServingServer`` on
    both socket edges, and ``POST /generate`` through it."""
    t_phase = time.perf_counter()
    out = {}
    dec = TransformerDecoder(params, CFG, n_slots=N_SLOTS, max_len=MAX_LEN,
                             page_size=PAGE)
    dec.warmup()
    out["static"] = batching_run(dec, run_static, card_line)
    out["continuous"] = batching_run(dec, run_continuous, card_line)
    out["sessions_paged"] = sessions_run(dec, "paged", paged_launches,
                                         card_line)
    sdec = spec_decoder(tree, dtree, dcfg)
    sdec.warmup()
    out["sessions_speculative"] = sessions_run(
        sdec, "speculative", lambda st: spec_launches(st, dcfg), card_line)
    check(out["sessions_speculative"]["spec_rounds"] > 0,
          "no speculative round ran")
    del sdec
    drives = {}
    for fe in ("eventloop", "threaded"):
        with ServingServer(RowIdentity(), max_latency_ms=2,
                           max_batch_size=256, max_queue=4096, frontend=fe,
                           verify_checkpoints=False) as srv:
            srv.warmup({"x": 0.0})
            warm = srv.n_recompiles
            for conns in LOAD_CONNECTIONS:
                r = drive_keepalive(srv.host, srv.port, srv.api_path,
                                    b'{"x": 0.0}', n_connections=conns,
                                    duration_s=LOAD_DRIVE_S)
                r["recompiles_after_warmup"] = srv.n_recompiles - warm
                check(r["conn_errors"] == 0 and r["http_errors"] == 0
                      and r["requests"] > 0,
                      f"{fe} at {conns} connections: {r}")
                check(r["recompiles_after_warmup"] == 0,
                      f"{fe}: recompiles after warmup")
                drives[f"{fe}_{conns}"] = r
                print(f"[{card_line}] drive_keepalive {fe} x {conns}: "
                      f"{r['rps']} req/s, p50 {r['p50_ms']} ms, p99 "
                      f"{r['p99_ms']} ms, {r['requests']} requests, 0 "
                      f"errors, reuse {r['reuse_rate']}")
    out["keepalive"] = drives
    prompt = np.random.default_rng(SEED + 7).integers(
        1, CFG.vocab, size=24).tolist()
    payload = json.dumps({"prompt": prompt,
                          "max_new_tokens": GENERATE_NEW}).encode()
    srv = serve_http(dec, "eventloop")
    try:
        r = drive_keepalive(srv.host, srv.port, "/generate", payload,
                            n_connections=GENERATE_CONNS,
                            requests_per_conn=GENERATE_PER_CONN)
        wait_for(lambda: idle_clean(srv.decoder), "the /generate slots")
    finally:
        srv.stop()
    check(r["conn_errors"] == 0 and r["http_errors"] == 0
          and r["requests"] == GENERATE_CONNS * GENERATE_PER_CONN,
          f"/generate drive: {r}")
    out["generate"] = r
    print(f"[{card_line}] drive_keepalive POST /generate x "
          f"{GENERATE_CONNS}: {r['requests']} requests of {GENERATE_NEW} "
          f"tokens, {r['rps']} req/s, p50 {r['p50_ms']} ms, 0 errors")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card_line}] the load drivers took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 31: the long tail on the card: SAR, LIME, tuning and
# the data-prep stages

#: MovieLens 1M's public shape (GroupLens' README): users, rated movies,
#: ratings, the fewest ratings a user has, the most one has, and the
#: first and last timestamps (2000-04-25, 2003-02-28)
ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS = 6040, 3706, 1_000_209
ML1M_MIN_PER_USER, ML1M_MAX_PER_USER = 20, 2314
ML1M_T0, ML1M_T1 = 956_703_932, 1_046_454_590
#: the stars' shares in MovieLens 1M (1 to 5)
ML1M_STARS = (0.056, 0.108, 0.261, 0.349, 0.226)
#: item popularity ~ 1 / rank^ZIPF_S over a seeded order of the movies
ZIPF_S = 1.0
SAR_PARAMS = dict(timestamp_col="ts", time_decay_half_life=30.0,
                  similarity_function="jaccard", support_threshold=4)
SAR_K = 10
#: card against the port's CPU SAR: similarity (exact counts; 0 is
#: expected), scores (f32 products summed in another order), and the
#: relative gap below which two scores are a tie in the top-k
SAR_SIM_RTOL, SAR_SCORE_RTOL, SAR_TIE_RTOL = 1e-6, 1e-5, 1e-5
#: LIME: bench_adult_census's frame (not cut), a GBDT of 20 x 31, 64
#: rows at 512 samples, 8 rows a model call; 16 CIFAR-shape images
LIME_GBDT = dict(num_iterations=20, num_leaves=31)
LIME_ROWS, LIME_SAMPLES, LIME_BATCH = 64, 512, 8
LIME_IMAGES, LIME_CELL = 16, 8.0
#: coefficients, card against CPU, x max(1, |ref|): tabular and the
#: batched solve at 1e-4; images at 1e-4 too, 7x the 1.37e-5 an H100 reads
#: (the f32 convs sum in another order on each side; PERF.md)
LIME_TAB_TOL, LIME_SOLVE_TOL = 1e-4, 1e-4
LIME_IMAGE_TOL = 1e-4
#: the tune cell: grid, folds, trial threads, the CPU rule (phase 13's)
TUNE_GRID = {"num_leaves": [15, 31], "num_iterations": [10, 20]}
TUNE_FOLDS, TUNE_THREADS, TUNE_AUC_TOL = 2, 2, 1e-3
#: the stages cell: the share of values blanked, the columns as strings
STAGES_BLANK = 0.05
STAGES_STRING_COLS = (10, 11)


def movielens_events(seed: int) -> dict:
    """MovieLens 1M's shape from ``seed``: each user's count at least 20
    and at most 2314 (a log-normal spread, summing to exactly 1,000,209),
    the items of a user drawn without replacement by Zipf popularity
    (Gumbel top-k), stars by ML-1M's shares, timestamps uniform over its
    span. String ids, as the raw file has them."""
    rng = np.random.default_rng(seed)
    spread = rng.lognormal(0.0, 1.2, ML1M_USERS)
    room = ML1M_RATINGS - ML1M_MIN_PER_USER * ML1M_USERS
    counts = ML1M_MIN_PER_USER + np.floor(
        spread / spread.sum() * room).astype(np.int64)
    counts = np.minimum(counts, ML1M_MAX_PER_USER)
    while counts.sum() < ML1M_RATINGS:
        open_ = np.flatnonzero(counts < ML1M_MAX_PER_USER)
        add = rng.choice(open_, min(len(open_),
                                    ML1M_RATINGS - int(counts.sum())),
                         replace=False)
        counts[add] += 1
    popularity = np.empty(ML1M_ITEMS)
    popularity[rng.permutation(ML1M_ITEMS)] = \
        1.0 / np.arange(1, ML1M_ITEMS + 1) ** ZIPF_S
    keys = (np.log(popularity)[None, :].astype(np.float32)
            + rng.gumbel(size=(ML1M_USERS, ML1M_ITEMS)).astype(np.float32))
    order = np.argsort(-keys, axis=1)
    del keys
    take = np.arange(ML1M_ITEMS)[None, :] < counts[:, None]
    items = order[take]
    users = np.repeat(np.arange(ML1M_USERS), counts)
    n = len(users)
    return {"user": [f"u{u}" for u in users],
            "item": [f"m{i}" for i in items],
            "rating": rng.choice(np.arange(1, 6), n,
                                 p=np.asarray(ML1M_STARS) / sum(ML1M_STARS))
            .astype(np.float64),
            "ts": rng.integers(ML1M_T0, ML1M_T1 + 1, n).astype(np.float64)}


def rel_gap(got, ref) -> float:
    """max |got - ref| / |ref| over the finite entries (0 where both are
    0); the infinite entries must sit at the same places and agree."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    fin = np.isfinite(ref)
    check(np.array_equal(np.isfinite(got), fin)
          and np.array_equal(got[~fin], ref[~fin]),
          "the masked (seen) entries differ")
    d = np.abs(got[fin] - ref[fin])
    scale = np.abs(ref[fin])
    nz = d > 0
    return float((d[nz] / np.maximum(scale[nz], 1e-30)).max()) \
        if nz.any() else 0.0


def top_k_ties(got, ref, ref_scores) -> int:
    """Every user's top-k on the card against the CPU's, position by
    position; a differing item must score, in the CPU's scores, within
    ``SAR_TIE_RTOL`` of the CPU's item there (a tie). Returns the ties."""
    ties = 0
    for u, (g, r) in enumerate(zip(got, ref)):
        g, r = np.asarray(g, np.int64), np.asarray(r, np.int64)
        check(len(g) == len(r), f"user {u}: {len(g)} against {len(r)}")
        for a, b in zip(g[g != r], r[g != r]):
            sa, sb = ref_scores[u, a], ref_scores[u, b]
            check(sa == sb or abs(sa - sb) <= SAR_TIE_RTOL * max(
                abs(sa), abs(sb)),
                f"user {u}: item {a} ({sa}) on the card where the CPU "
                f"has {b} ({sb}): not a tie")
            ties += 1
    return ties


def events_ms(fn, n: int = 3) -> tuple:
    """(result, median device ms between CUDA events around ``fn``) over
    ``n`` calls after a warm one (the first call at a shape loads its
    GEMM kernel: 148 ms against 4 warm on an H100)."""
    out = fn()
    times = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return out, float(np.median(times))


def sar_cell(card_line) -> dict:
    """Phase 31(a): MovieLens 1M's shape through string ids ->
    ``RecommendationIndexer`` -> ``SAR`` on the card ->
    ``recommend_for_all_users(10)``, held against the port's CPU ``SAR``
    on the same events; then ``per_user_split`` -> ``RankingAdapter`` ->
    ``RankingEvaluator`` (ndcg@10, map@10)."""
    t_cell = time.perf_counter()
    t0 = time.perf_counter()
    events = DataFrame(movielens_events(SEED))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    indexer = RecommendationIndexer(user_input_col="user",
                                    item_input_col="item").fit(events)
    indexed = indexer.transform(events)
    index_s = time.perf_counter() - t0
    check(indexer.num_users == ML1M_USERS and indexer.num_items
          == ML1M_ITEMS and indexed.num_rows == ML1M_RATINGS,
          f"indexed {indexer.num_users} users, {indexer.num_items} items, "
          f"{indexed.num_rows} rows")
    per_user = np.bincount(indexed["user_idx"], minlength=ML1M_USERS)
    check(per_user.min() >= ML1M_MIN_PER_USER, "a user below 20 ratings")
    SAR(device=STAGE_DEVICE, **SAR_PARAMS).fit(indexed.head(1000))  # warm
    t0 = time.perf_counter()
    model = SAR(device=STAGE_DEVICE, **SAR_PARAMS).fit(indexed)
    fit_s = time.perf_counter() - t0
    # the fit's two parts again, apart: the host affinity, then the
    # similarity on the card between CUDA events
    users = np.asarray(indexed["user_idx"], np.int64)
    items = np.asarray(indexed["item_idx"], np.int64)
    t0 = time.perf_counter()
    aff = SARM._affinity_matrix(
        users, items, np.asarray(indexed["rating"], np.float32),
        np.asarray(indexed["ts"], np.float64), ML1M_USERS, ML1M_ITEMS, True,
        SAR_PARAMS["time_decay_half_life"])
    affinity_s = time.perf_counter() - t0
    aff_dev = torch.from_numpy(aff).to(DEV)
    with torch.no_grad():
        sim_dev, sim_ms = events_ms(lambda: SARM._build_similarity(
            aff_dev, "jaccard", SAR_PARAMS["support_threshold"]))
        sim_t = torch.from_numpy(model.similarity).to(DEV)
        _, score_ms = events_ms(lambda: SARM._score_users(aff_dev, sim_t,
                                                          True))
    check(np.array_equal(aff, model.affinity)
          and np.array_equal(sim_dev.cpu().numpy(), model.similarity),
          "the fit's parts apart differ from the fit")
    del aff_dev, sim_dev, sim_t
    t0 = time.perf_counter()
    scores = model._scores(np.arange(ML1M_USERS), True)
    scores_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs = model.recommend_for_all_users(SAR_K)
    recommend_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = SAR(device="cpu", **SAR_PARAMS).fit(indexed)
    cpu_fit_s = time.perf_counter() - t0
    sim_gap = float(np.abs(model.similarity.astype(np.float64)
                           - cpu.similarity).max())
    sim_rel = rel_gap(model.similarity, cpu.similarity)
    check(sim_rel <= SAR_SIM_RTOL,
          f"similarity off the CPU's by {sim_rel:.3e} relative")
    cpu_scores = cpu._scores(np.arange(ML1M_USERS), True)
    score_rel = rel_gap(scores, cpu_scores)
    check(score_rel <= SAR_SCORE_RTOL,
          f"scores off the CPU's by {score_rel:.3e} relative")
    cpu_recs = cpu.recommend_for_all_users(SAR_K)
    ties = top_k_ties(recs["recommendations"], cpu_recs["recommendations"],
                      cpu_scores)
    check(all(len(r) == SAR_K for r in recs["recommendations"]),
          "a user got fewer than 10 recommendations")
    nnz_sim = int((model.similarity > 0).sum())
    del scores, cpu_scores
    # the ranking path: a per-user split, the adapter, the evaluator
    t0 = time.perf_counter()
    train, valid = per_user_split(indexed, "user_idx", 0.75, seed=SEED)
    split_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    adapter = RankingAdapter(
        recommender=SAR(device=STAGE_DEVICE, **SAR_PARAMS), k=SAR_K,
        rating_col="rating").fit(train)
    ranked = adapter.transform(valid)
    ndcg = RankingEvaluator(k=SAR_K, metric_name="ndcgAt").evaluate(ranked)
    map_k = RankingEvaluator(k=SAR_K, metric_name="mapk").evaluate(ranked)
    rank_s = time.perf_counter() - t0
    check(ranked.num_rows == ML1M_USERS and 0 < ndcg <= 1 and 0 < map_k <= 1,
          f"ranking: {ranked.num_rows} users, ndcg@10 {ndcg}, map@10 "
          f"{map_k}")
    flops = 2.0 * ML1M_ITEMS * ML1M_USERS * ML1M_ITEMS
    out = {"users": ML1M_USERS, "items": ML1M_ITEMS,
           "ratings": ML1M_RATINGS, "generate_s": gen_s, "index_s": index_s,
           "fit_s": fit_s, "affinity_host_s": affinity_s,
           "similarity_device_ms": sim_ms, "similarity_tflops": flops / 1e12,
           "score_device_ms": score_ms, "scores_s": scores_s,
           "recommend_s": recommend_s, "cpu_fit_s": cpu_fit_s,
           "similarity_max_abs_diff": sim_gap,
           "similarity_rel_diff": sim_rel, "score_rel_diff": score_rel,
           "top10_ties": ties, "similarity_nonzeros": nnz_sim,
           "split_s": split_s, "ranking_s": rank_s,
           "train_rows": train.num_rows, "valid_rows": valid.num_rows,
           "ndcg_at_10": ndcg, "map_at_10": map_k,
           "seconds": time.perf_counter() - t_cell}
    print(f"[{card_line}] SAR at MovieLens 1M's shape ({ML1M_USERS} users x "
          f"{ML1M_ITEMS} items, {ML1M_RATINGS} ratings): fit {fit_s:.3f} s "
          f"(host affinity {affinity_s:.3f} s, similarity on the card "
          f"{sim_ms:.3f} ms for {flops / 1e12:.3f} TFLOP of B^T B), "
          f"scoring {score_ms:.3f} ms on the card ({scores_s:.3f} s with "
          f"transfers), recommend_for_all_users(10) {recommend_s:.3f} s; "
          f"CPU fit {cpu_fit_s:.3f} s; similarity off the CPU's by "
          f"{sim_gap:.3e} (max abs), scores {score_rel:.3e} relative, "
          f"top-10 equal but {ties} ties; ndcg@10 {ndcg:.6f}, map@10 "
          f"{map_k:.6f}; the cell took {out['seconds']:.1f} s")
    return out


class TimedCalls:
    """Wrap functions of a module for a scope: seconds and calls each."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.seconds = {n: 0.0 for n in names}
        self.calls = {n: 0 for n in names}
        self.last_args = {}

    def _wrap(self, name, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
                self.last_args[name] = (a, k)
        return timed

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            setattr(self.module, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def scaled_gap(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(got - ref) / np.maximum(1.0, np.abs(ref))).max())


def lime_split(tc, total_s, n) -> dict:
    """Seconds per explained row, parted: model calls, solves, host."""
    model_s = tc.seconds["_model_scores"]
    solve_s = tc.seconds["weighted_ridge_fits"]
    return {"s_per_row": total_s / n, "model_s_per_row": model_s / n,
            "solve_s_per_row": solve_s / n,
            "host_s_per_row": (total_s - model_s - solve_s) / n,
            "model_calls": tc.calls["_model_scores"],
            "solves": tc.calls["weighted_ridge_fits"]}


def lime_cell(tmp, card_line) -> dict:
    """Phase 31(b): ``TabularLIME`` over a ``GBDTClassifier`` fitted on
    the card on ``bench_adult_census``'s frame, and ``ImageLIME`` over
    phase 21's ResNet-20 in f32; both against the same stages on the CPU
    (the network in f32, TF32 off), and the card's batched solve against
    the CPU's on the same f32 inputs."""
    t_cell = time.perf_counter()
    X, y, _, kw = adult_cell()
    frame = DataFrame({"features": X, "label": y})
    gbdt = GBDTClassifier(device=STAGE_DEVICE, categorical_feature_indexes=
                          kw["categorical_features"], **LIME_GBDT).fit(frame)
    gbdt.save(os.path.join(tmp, "gbdt"))
    gbdt_cpu = PipelineStage.load(os.path.join(tmp, "gbdt"), device="cpu")
    lime_kw = dict(input_col="features", predict_col="probability",
                   class_index=1, n_samples=LIME_SAMPLES,
                   sample_batch=LIME_BATCH, seed=SEED)
    tab = TabularLIME(model=gbdt, device=STAGE_DEVICE, **lime_kw).fit(frame)
    rows = frame.head(LIME_ROWS)
    with TimedCalls(LIME, ("_model_scores", "weighted_ridge_fits")) as tc:
        t0 = time.perf_counter()
        coefs = np.stack(list(tab.transform(rows)["lime_weights"]))
        tab_s = time.perf_counter() - t0
    (z, scores, w, reg), solve_kw = tc.last_args["weighted_ridge_fits"]
    check(solve_kw.get("device") == STAGE_DEVICE and z.shape == (
        LIME_BATCH, LIME_SAMPLES, X.shape[1]),
        f"the last solve: {z.shape} on {solve_kw}")
    solve_gap = scaled_gap(
        LIME.weighted_ridge_fits(z, scores, w, reg, device=STAGE_DEVICE),
        LIME.weighted_ridge_fits(z, scores, w, reg, device="cpu"))
    check(solve_gap <= LIME_SOLVE_TOL,
          f"the card's batched solve off the CPU's by {solve_gap:.3e}")
    tab_cpu = tab.copy(model=gbdt_cpu, device="cpu")
    t0 = time.perf_counter()
    coefs_cpu = np.stack(list(tab_cpu.transform(rows)["lime_weights"]))
    tab_cpu_s = time.perf_counter() - t0
    tab_gap = scaled_gap(coefs, coefs_cpu)
    check(coefs.shape == (LIME_ROWS, X.shape[1]) and np.isfinite(coefs).all()
          and tab_gap <= LIME_TAB_TOL,
          f"tabular coefficients {coefs.shape}, off the CPU's by "
          f"{tab_gap:.3e}")
    tabular = {"rows": LIME_ROWS, "n_samples": LIME_SAMPLES,
               "rows_per_model_call": LIME_BATCH * LIME_SAMPLES,
               "seconds": tab_s, "cpu_seconds": tab_cpu_s,
               "coef_gap": tab_gap, "solve_gap": solve_gap,
               **lime_split(tc, tab_s, LIME_ROWS)}
    # images: ResNet-20 in f32 (phase 21's network at f32), 16 images
    fn = NNFunction.init({"builder": "cifar_resnet", "depth": 20},
                         input_shape=(32, 32, 3), seed=SEED)
    images = np.random.default_rng(SEED).uniform(
        0, 1, size=(LIME_IMAGES, 32, 32, 3)).astype(np.float32)
    idf = DataFrame({"image": images})
    img_kw = dict(input_col="image", predict_col="scores", class_index=3,
                  n_samples=LIME_SAMPLES, cell_size=LIME_CELL, seed=SEED)

    def image_lime(device):
        net = NNModel(model=fn, input_col="image", output_col="scores",
                      batch_size=LIME_SAMPLES, device=device)
        return ImageLIME(model=net, device=device, **img_kw).fit(idf)
    image_lime(STAGE_DEVICE).transform(idf.head(1))          # warm
    with TimedCalls(LIME, ("_model_scores", "weighted_ridge_fits",
                           "slic_segments", "apply_state")) as itc:
        t0 = time.perf_counter()
        iout = image_lime(STAGE_DEVICE).transform(idf)
        img_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    iref = image_lime("cpu").transform(idf)
    img_cpu_s = time.perf_counter() - t0
    labels_equal = all(np.array_equal(a, b) for a, b in
                       zip(iout["superpixels"], iref["superpixels"]))
    img_gap = max(scaled_gap(a, b) for a, b in
                  zip(iout["lime_weights"], iref["lime_weights"]))
    check(labels_equal, "SLIC labels differ between the runs")
    check(img_gap <= LIME_IMAGE_TOL,
          f"image coefficients off the CPU's by {img_gap:.3e}")
    image = {"images": LIME_IMAGES, "n_samples": LIME_SAMPLES,
             "superpixels": [int(np.max(s)) + 1
                             for s in iout["superpixels"]],
             "seconds": img_s, "cpu_seconds": img_cpu_s,
             "coef_gap": img_gap,
             "slic_s_per_image": itc.seconds["slic_segments"] / LIME_IMAGES,
             "masks_s_per_image": itc.seconds["apply_state"] / LIME_IMAGES,
             **lime_split(itc, img_s, LIME_IMAGES)}
    out = {"tabular": tabular, "image": image,
           "seconds": time.perf_counter() - t_cell}
    print(f"[{card_line}] TabularLIME over GBDT 20 x 31 (adult frame "
          f"{X.shape[0]} x {X.shape[1]}): {LIME_ROWS} rows x "
          f"{LIME_SAMPLES} samples in {tab_s:.3f} s = "
          f"{tabular['s_per_row'] * 1e3:.2f} ms a row (model "
          f"{tabular['model_s_per_row'] * 1e3:.2f}, solves "
          f"{tabular['solve_s_per_row'] * 1e3:.2f}, host "
          f"{tabular['host_s_per_row'] * 1e3:.2f}); CPU {tab_cpu_s:.3f} s; "
          f"coefficients off the CPU's by {tab_gap:.3e} "
          f"({LIME_TAB_TOL}), the batched solve {solve_gap:.3e}")
    print(f"[{card_line}] ImageLIME over ResNet-20 f32: {LIME_IMAGES} images "
          f"x {LIME_SAMPLES} samples in {img_s:.3f} s = "
          f"{image['s_per_row'] * 1e3:.2f} ms an image (model "
          f"{image['model_s_per_row'] * 1e3:.2f}, solves "
          f"{image['solve_s_per_row'] * 1e3:.2f}, host "
          f"{image['host_s_per_row'] * 1e3:.2f}: SLIC "
          f"{image['slic_s_per_image'] * 1e3:.2f}, masks "
          f"{image['masks_s_per_image'] * 1e3:.2f}); CPU {img_cpu_s:.3f} s; "
          f"SLIC labels equal, coefficients off the CPU's by {img_gap:.3e} "
          f"({LIME_IMAGE_TOL})")
    return out


def adult_frame() -> DataFrame:
    """bench_adult_census's rows as a frame of 14 named columns."""
    X, y, _, _ = adult_cell()
    return DataFrame({**{f"f{j}": X[:, j] for j in range(X.shape[1])},
                      "label": y})


class BoosterFits:
    """Every ``Booster.train`` in a scope: the booster and its seconds
    (trial threads append at once; ``list.append`` is atomic)."""

    def __enter__(self):
        self.fits = []
        self.saved = Booster.__dict__["train"]
        train = self.saved.__func__

        def recorded(*a, **k):
            t0 = time.perf_counter()
            b = train(*a, **k)
            self.fits.append((b, time.perf_counter() - t0))
            return b
        Booster.train = staticmethod(recorded)
        return self

    def __exit__(self, *exc):
        Booster.train = self.saved


def tune_cell(card_line) -> tuple:
    """Phase 31(c): ``TuneHyperparameters`` over
    ``TrainClassifier(GBDTClassifier)`` on the adult frame on the card,
    grid 2 x 2, 2 folds, AUC, 2 trial threads on one card: K9 exactly,
    the history equal at 1 and 2 threads, ``best_params`` the CPU's and
    each trial within 1e-3 of it; then ``FindBestModel`` over the four
    refitted candidates and the evaluators on the winner's scores."""
    t_cell = time.perf_counter()
    df = adult_frame()
    space = {k: DiscreteHyperParam(v) for k, v in TUNE_GRID.items()}

    def tune(device, threads):
        return TuneHyperparameters(
            models=[TrainClassifier(model=GBDTClassifier(device=device),
                                    label_col="label")],
            param_space=space, search_mode="grid", evaluation_metric="AUC",
            num_folds=TUNE_FOLDS, parallelism=threads, seed=SEED,
            label_col="label")
    # a warm fit first: the first fits at these shapes load their kernels
    TrainClassifier(model=GBDTClassifier(device=STAGE_DEVICE, num_leaves=15,
                                         num_iterations=2),
                    label_col="label").fit(df.head(len(df) // 2))
    serial_s = []
    t0 = time.perf_counter()
    serial = tune(STAGE_DEVICE, 1).fit(df)
    serial_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    reset_launch_counts()
    with BoosterFits() as fits:
        t0 = time.perf_counter()
        tuned = tune(STAGE_DEVICE, TUNE_THREADS).fit(df)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
    launches = read_launch_counts()
    # (the 1-thread search after the 2-thread one, a second timing of
    # it, went in PR 24 for the whole script's time)
    n_fits = len(TUNE_GRID["num_leaves"]) * len(
        TUNE_GRID["num_iterations"]) * TUNE_FOLDS + 1
    want = sum(k9_per_fit("data", b, 1) for b, _ in fits.fits)
    check(len(fits.fits) == n_fits, f"{len(fits.fits)} fits, expected "
                                    f"{n_fits}")
    if STAGE_DEVICE is None:
        check(launches["gbdt_histogram"] == want,
              f"the tune path launched K9 {launches['gbdt_histogram']} "
              f"times, expected {want}")
        check(all(b.device.type == "cuda" for b, _ in fits.fits),
              "a trial fitted off the card")
    check(not any(v for k, v in launches.items() if k != "gbdt_histogram"),
          f"the tune path launched {launches}")
    hist, hist1 = tuned.get_history(), serial.get_history()
    check(hist.to_dict().keys() == hist1.to_dict().keys() and all(
        np.array_equal(hist[c], hist1[c]) for c in hist.columns),
        "the history at 2 threads differs from the one at 1")
    t0 = time.perf_counter()
    ref = tune("cpu", TUNE_THREADS).fit(df)
    cpu_s = time.perf_counter() - t0
    auc_gap = float(np.abs(np.asarray(hist["AUC"])
                           - np.asarray(ref.get_history()["AUC"])).max())
    check(tuned.best_params == ref.best_params,
          f"best params {tuned.best_params} on the card, "
          f"{ref.best_params} on the CPU")
    check(auc_gap <= TUNE_AUC_TOL, f"trial AUC off the CPU's by {auc_gap}")
    # one fit's device-busy share (a fold's rows, the larger config)
    X = np.stack([df[f"f{j}"] for j in range(14)], axis=1)
    y = np.asarray(df["label"])
    busy = gbdt_busy(BoosterParams(objective="binary", num_iterations=20,
                                   num_leaves=31), X[: len(X) // 2],
                     y[: len(y) // 2], {}, None)
    # FindBestModel over the four configurations refitted on the frame
    candidates = [TrainClassifier(model=GBDTClassifier(
        device=STAGE_DEVICE, num_leaves=nl, num_iterations=ni),
        label_col="label").fit(df)
        for nl in TUNE_GRID["num_leaves"]
        for ni in TUNE_GRID["num_iterations"]]
    best = FindBestModel(models=candidates, label_col="label",
                         evaluation_metric="AUC").fit(df)
    scored = best.get_evaluated_data()
    stats = ComputeModelStatistics(label_col="label").evaluate(scored)
    per_row = ComputePerInstanceStatistics(label_col="label").evaluate(
        scored)
    loss = np.asarray(per_row["log_loss"], np.float64)
    check(np.isfinite(loss).all() and (loss >= 0).all()
          and 0.5 < float(stats["AUC"][0]) <= 1.0,
          f"best model: AUC {stats['AUC'][0]}, log loss finite "
          f"{np.isfinite(loss).all()}")
    fit_s = [s for _, s in fits.fits]
    out = {"grid": TUNE_GRID, "folds": TUNE_FOLDS, "threads": TUNE_THREADS,
           "search_s": search_s, "search_s_one_thread": serial_s,
           "cpu_search_s": cpu_s, "fits": len(fit_s), "fit_s": fit_s,
           "k9_launches": launches["gbdt_histogram"], "k9_expected": want,
           "trial_devices_auto": PTUNE.accelerator_count() > 1,
           "best_params": tuned.best_params,
           "best_auc": tuned.best_metric,
           "trial_auc": [float(v) for v in hist["AUC"]],
           "trial_auc_gap_cpu": auc_gap, "one_fit_busy": busy,
           "find_best_auc": float(stats["AUC"][0]),
           "find_best_accuracy": float(stats["accuracy"][0]),
           "mean_log_loss": float(loss.mean()),
           "seconds": time.perf_counter() - t_cell}
    print(f"[{card_line}] TuneHyperparameters (adult frame, TrainClassifier("
          f"GBDTClassifier), grid {TUNE_GRID}, {TUNE_FOLDS} folds, AUC, "
          f"{TUNE_THREADS} trial threads on one card): {search_s:.3f} s "
          f"(1 thread: "
          + ", ".join(f"{v:.3f}" for v in serial_s)
          + f" s; CPU {cpu_s:.3f} s); fits "
          + ", ".join(f"{s:.2f}" for s in fit_s) + " s; K9 "
          f"{launches['gbdt_histogram']} launches (expected {want}); best "
          f"{tuned.best_params} AUC {tuned.best_metric:.6f}, the CPU's the "
          f"same, trials within {auc_gap:.2e}; history equal at 1 and 2 "
          f"threads; one fit {100 * busy['busy_share']:.1f}% device-busy; "
          f"FindBestModel AUC {out['find_best_auc']:.6f}, mean log loss "
          f"{out['mean_log_loss']:.4f}")
    return launches, out


def stages_chain(df: DataFrame) -> DataFrame:
    """Phase 31(d)'s chain: impute, index two string columns, convert,
    weight the classes, summarize."""
    numeric = [f"f{j}" for j in range(14) if j not in STAGES_STRING_COLS]
    df = CleanMissingData(input_cols=numeric).fit(df).transform(df)
    for j in STAGES_STRING_COLS:
        df = ValueIndexer(input_col=f"f{j}", output_col=f"f{j}_idx").fit(
            df).transform(df)
    df = DataConversion(cols=[f"f{j}_idx" for j in STAGES_STRING_COLS],
                        convert_to="double").transform(df)
    df = ClassBalancer(input_col="label", output_col="weight").fit(
        df).transform(df)
    return df, SummarizeData().transform(df)


def stages_cell(card_line) -> dict:
    """Phase 31(d): the adult frame with 5% of its values blanked and two
    columns as strings through the host stages; the output must equal a
    second run's (the stages take no device)."""
    rng = np.random.default_rng(SEED + 31)
    base = adult_frame()
    cols = {}
    for j in range(14):
        v = np.asarray(base[f"f{j}"], np.float64)
        blank = rng.random(len(v)) < STAGES_BLANK
        if j in STAGES_STRING_COLS:
            cols[f"f{j}"] = np.array([None if b else f"c{int(x)}"
                                      for x, b in zip(v, blank)],
                                     dtype=object)
        else:
            cols[f"f{j}"] = np.where(blank, np.nan, v)
    cols["label"] = np.asarray(base["label"])
    t0 = time.perf_counter()
    out, summary = stages_chain(DataFrame(dict(cols)))
    secs = time.perf_counter() - t0
    out2, summary2 = stages_chain(DataFrame(dict(cols)))
    for a, b in ((out, out2), (summary, summary2)):
        check(a.columns == b.columns and all(
            np.array_equal(a[c], b[c], equal_nan=a[c].dtype.kind == "f")
            if a[c].dtype != np.dtype("O") else list(a[c]) == list(b[c])
            for c in a.columns), "the stages' output differs between runs")
    check(not any(np.isnan(out[f"f{j}"]).any() for j in range(14)
                  if j not in STAGES_STRING_COLS), "a blank survived")
    res = {"rows": out.num_rows, "blanked_share": STAGES_BLANK,
           "seconds": secs, "summary_rows": summary.num_rows,
           "levels": {f"f{j}": int(np.max(out[f"f{j}_idx"])) + 1
                      for j in STAGES_STRING_COLS}}
    print(f"[{card_line}] the stages (CleanMissingData, 2 ValueIndexers, "
          f"DataConversion, ClassBalancer, SummarizeData) over "
          f"{out.num_rows} rows with {STAGES_BLANK:.0%} blanked: "
          f"{secs:.3f} s, equal to a second run")
    return res


def long_tail_phase(card_line) -> tuple:
    """Phase 31: (a) SAR, (b) LIME, (c) tuning, (d) the stages."""
    t_phase = time.perf_counter()
    out = {}
    parts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in (("sar", lambda: sar_cell(card_line)),
                          ("lime", lambda: lime_cell(tmp, card_line)),
                          ("tune", lambda: tune_cell(card_line)),
                          ("stages", lambda: stages_cell(card_line))):
            t0 = time.perf_counter()
            out[name] = run()
            parts[name] = time.perf_counter() - t0
    launches, out["tune"] = out["tune"]
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card_line}] the long tail took {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    return launches, out


# ---------------------------------------------------------------------------
# phase 32: the I/O tail

#: examples/opencv_image_pipeline.py's path at a real size: 1024 PNGs of
#: its two classes at sides 48-96, half of them inside a zip (2048 until
#: PR 24 halved them for the whole script's time)
IO_IMAGES = 1024
IO_CHAIN_TOL = 1e-5
IO_GBDT = {"num_iterations": 20, "num_leaves": 7, "min_data_in_leaf": 3}
#: the CPU fit the card's trees are held against, bit for bit: its
#: iterations are the card fit's first at any total (2 for the script's
#: time)
IO_CPU_ITERS = 2
# cut from 1024 and 256 rows in PR 24, for the whole script's time
IO_SERVED_ROWS, IO_SERIAL_ROWS = 512, 128
IO_REFUSED = (2, 5)         # rows of the refusal frame the server refuses


def io_tail_image(rng, side: int, y: int) -> np.ndarray:
    """One image of the example's classes: a bright disk (1) or dark
    horizontal bars (0) on noise (``_write_sample_images``)."""
    img = rng.integers(0, 60, (side, side, 3))
    if y:
        yy, xx = np.mgrid[0:side, 0:side]
        m = (yy - side / 2) ** 2 + (xx - side / 2) ** 2 < (side / 3) ** 2
        img[m] = rng.integers(180, 255, 3)
    else:
        img[:: max(side // 6, 1)] = rng.integers(120, 200, 3)
    return img.astype(np.uint8)


def io_tail_write(root) -> None:
    """The PNGs, named ``img_<i>_<label>.png``: the odd ones in
    ``images.zip``, the even ones as files."""
    import zipfile
    rng = np.random.default_rng(SEED + 32)
    with zipfile.ZipFile(os.path.join(root, "images.zip"), "w") as zf:
        for i in range(IO_IMAGES):
            side = int(rng.integers(48, 96))
            name = f"img_{i:04d}_{i % 2}.png"
            data = encode_image(io_tail_image(rng, side, i % 2))
            if i % 2:
                zf.writestr(name, data)
            else:
                with open(os.path.join(root, name), "wb") as f:
                    f.write(data)


def io_labels(paths) -> np.ndarray:
    return np.array([int(str(p).rsplit("_", 1)[1][0]) for p in paths],
                    dtype=np.int64)


def io_chain(device) -> ImageTransformer:
    """The example's chain: resize 40, center crop 32, Gaussian 3 / 1.0,
    flip, normalize."""
    return (ImageTransformer(input_col="image", output_col="processed",
                             device=device)
            .resize(40, 40).center_crop(32, 32).gaussian_kernel(3, 1.0)
            .flip().normalize(mean=[127.5] * 3, std=[127.5] * 3))


def io_images_cell(root, card_line) -> tuple:
    """Phase 32(a): read, transform, unroll and fit, card against CPU."""
    t0 = time.perf_counter()
    io_tail_write(root)
    write_s = time.perf_counter() - t0
    # the C++ reader's first use builds it with g++: timed apart
    t0 = time.perf_counter()
    check(native_available(), "the native reader does not build")
    build_s = time.perf_counter() - t0
    reads = {}
    for engine in ("native", "python"):
        t0 = time.perf_counter()
        raw = read_binary_files(root, engine=engine)
        reads[engine] = (raw, time.perf_counter() - t0)
    (nat, nat_s), (py, py_s) = reads["native"], reads["python"]
    check(list(nat["path"]) == list(py["path"])
          and all(a == b for a, b in zip(nat["bytes"], py["bytes"])),
          "the native read differs from the Python read")
    check(nat.num_rows == IO_IMAGES,
          f"read {nat.num_rows} records of {IO_IMAGES}")
    t0 = time.perf_counter()
    images = [decode_image(b) for b in nat["bytes"]]
    decode_s = time.perf_counter() - t0
    # auto: the C++ reader, which native_available() built above
    df = read_images(root)
    check(list(df["path"]) == list(nat["path"])
          and all(np.array_equal(a, b) for a, b in zip(df["image"], images)),
          "read_images differs from the decoded native read")
    y = io_labels(df["path"])
    check(df.num_rows == IO_IMAGES and y.sum() == IO_IMAGES // 2,
          f"{df.num_rows} images, {y.sum()} of class 1")
    io_chain(STAGE_DEVICE).transform(df.head(64))        # warm
    t0 = time.perf_counter()
    out = io_chain(STAGE_DEVICE).transform(df)
    chain_s = time.perf_counter() - t0
    proc = out["processed"]
    cpu = io_chain("cpu").transform(df)["processed"]
    chain_err = frame_err(proc, cpu)
    check(proc.shape == (IO_IMAGES, 32, 32, 3) and chain_err <= IO_CHAIN_TOL,
          f"the chain {proc.shape} off the CPU by {chain_err:.3e}")
    unrolled = UnrollImage(input_col="processed", output_col="features",
                           device=STAGE_DEVICE).transform(out)
    cpu_unrolled = UnrollImage(input_col="processed", output_col="features",
                               device="cpu").transform(out)
    check(np.array_equal(unrolled["features"], cpu_unrolled["features"]),
          "UnrollImage on the card differs from the CPU's")
    train = DataFrame({"features": unrolled["features"], "label": y})

    def fit(device, **kw):
        with BoosterFits() as fits:
            t0 = time.perf_counter()
            model = TrainClassifier(
                model=GBDTClassifier(device=device, **{**IO_GBDT, **kw}),
                label_col="label").fit(train)
            secs = time.perf_counter() - t0
        return model, fits.fits[0][0], secs
    reset_launch_counts()
    model, booster, fit_s = fit(STAGE_DEVICE)
    launches = read_launch_counts()
    per_fit = IO_GBDT["num_iterations"] * 1 * IO_GBDT["num_leaves"]
    if STAGE_DEVICE is None:
        check(launches["gbdt_histogram"] == per_fit,
              f"K9 launched {launches['gbdt_histogram']} times in one fit, "
              f"expected {per_fit}")
    check(not any(v for k, v in launches.items() if k != "gbdt_histogram"),
          f"the I/O tail launched {launches}")
    _, cpu_booster, cpu_fit_s = fit("cpu", num_iterations=IO_CPU_ITERS)
    trees = same_trees(booster, cpu_booster, IO_CPU_ITERS)
    require_same(trees, "the I/O tail's card fit against the CPU's",
                 IO_CPU_ITERS)
    pred = model.transform(train)["prediction"]
    acc = float(np.mean(np.asarray(pred) == y))
    check(acc > 0.9, f"train accuracy {acc}")
    t0 = time.perf_counter()
    ub = UnrollBinaryImage(height=32, width=32, device=STAGE_DEVICE) \
        .transform(nat)["features"]
    unroll_s = time.perf_counter() - t0
    ub_cpu = UnrollBinaryImage(height=32, width=32, device="cpu") \
        .transform(nat)["features"]
    ub_err = frame_err(ub, ub_cpu)
    check(ub.shape == (IO_IMAGES, 32 * 32 * 3) and ub_err <= IO_CHAIN_TOL,
          f"UnrollBinaryImage {ub.shape} off the CPU by {ub_err:.3e}")
    res = {"images": IO_IMAGES, "zipped": IO_IMAGES // 2,
           "shapes": len({im.shape for im in df["image"]}),
           "write_s": write_s, "native_build_s": build_s,
           "read_native_s": nat_s, "read_python_s": py_s,
           "decode_s": decode_s, "chain_device_s": chain_s,
           "chain_err": chain_err, "fit_s": fit_s, "cpu_fit_s": cpu_fit_s,
           "cpu_fit_iterations": IO_CPU_ITERS,
           "k9_launches": launches["gbdt_histogram"], "k9_per_fit": per_fit,
           "trees": trees, "train_accuracy": acc,
           "unroll_binary_s": unroll_s, "unroll_binary_err": ub_err}
    print(f"[{card_line}] the image pipeline over {IO_IMAGES} PNGs "
          f"({IO_IMAGES // 2} in a zip, {res['shapes']} shapes): native "
          f"reader built in {build_s:.3f} s; read native {nat_s:.3f} s, "
          f"Python {py_s:.3f} s (equal); decode {decode_s:.3f}"
          f" s; chain on the card {chain_s:.3f} s ({chain_err:.3e} off the "
          f"CPU); fit {fit_s:.3f} s (CPU {cpu_fit_s:.3f} s for "
          f"{IO_CPU_ITERS} iterations), K9 {launches['gbdt_histogram']} = "
          f"{per_fit}, trees equal for {trees['equal_iters']} of "
          f"{IO_CPU_ITERS} iterations; train accuracy {acc:.3f}; "
          f"UnrollBinaryImage "
          f"{unroll_s:.3f} s ({ub_err:.3e} off the CPU)")
    return launches, res


def io_served(url, rows, concurrency, handler="advanced") -> tuple:
    """The rows through ``SimpleHTTPTransformer`` to ``url``: the frame
    out and its seconds."""
    stage = SimpleHTTPTransformer(
        input_parser=JSONInputParser(url=url),
        output_parser=JSONOutputParser(data_field="scores"),
        concurrency=concurrency, handler=handler)
    t0 = time.perf_counter()
    out = stage.transform(DataFrame({"value": obj_col(rows)}))
    return out, time.perf_counter() - t0


def io_server(fn, device):
    return ServingServer(
        NNModel(model=fn, input_col="image", batch_size=64, device=device),
        port=0, max_batch_size=64, max_latency_ms=2, bucket_batches=False,
        quantization={"wire_dtype": "uint8", "scale": 1.0 / 255.0}).start()


def io_serving_cell(card_line) -> dict:
    """Phase 32(b): a pipeline calling the port's own ``/predict``:
    ``zoo/cifar10s_resnet20`` served on the card, 1024 uint8 images
    through ``SimpleHTTPTransformer`` and once more through
    ``HTTPTransformer(handler="policy")``, against ``NNModel.transform``;
    a frame with refused rows against the same server on the CPU."""
    fn = NNFunction.load(os.path.join(REPO_ROOT, "zoo", "cifar10s_resnet20"))
    u8 = np.random.default_rng(SEED + 33).integers(
        0, 256, (IO_SERVED_ROWS, 32, 32, 3), dtype=np.uint8)
    ref = NNModel(model=fn, input_col="image", batch_size=64,
                  input_dtype="uint8", device=STAGE_DEVICE).transform(
        DataFrame({"image": u8}))["scores"]
    rows = [{"image": x} for x in u8]
    # rows 2 and 5 name no "image": the server refuses each with a 500
    mixed = [{"pixels": u8[i]} if i in IO_REFUSED else {"image": u8[i]}
             for i in range(8)]
    srv = io_server(fn, STAGE_DEVICE)
    try:
        url = f"http://{srv.host}:{srv.port}/predict"
        io_served(url, rows[:16], 8)                      # warm
        out8, s8 = io_served(url, rows, 8)
        out1, s1 = io_served(url, rows[:IO_SERIAL_ROWS], 1)
        check(all(e is None for e in out8["error"]),
              f"served rows failed: {[e for e in out8['error'] if e][:3]}")
        err8 = frame_err(np.array(list(out8["parsed"])), ref)
        err1 = frame_err(np.array(list(out1["parsed"])),
                         ref[:IO_SERIAL_ROWS])
        check(max(err8, err1) <= ZOO_TOL,
              f"served scores off NNModel.transform by {max(err8, err1)}")
        reqs = JSONInputParser(url=url, input_col="value").transform(
            DataFrame({"value": obj_col(rows)}))
        t0 = time.perf_counter()
        resp = HTTPTransformer(handler="policy", budget=120.0,
                               concurrency=8).transform(reqs)
        policy_s = time.perf_counter() - t0
        parsed = JSONOutputParser(data_field="scores").transform(resp)
        check(all(r["status_code"] == 200 for r in resp["response"]),
              "a policy-handled request failed")
        err_p = frame_err(np.array(list(parsed["parsed"])), ref)
        check(err_p <= ZOO_TOL, f"policy-handled scores off by {err_p}")
        card_mixed, _ = io_served(url, mixed, 1, handler="basic")
    finally:
        srv.stop()
    cpu_srv = io_server(fn, "cpu")
    try:
        cpu_mixed, _ = io_served(
            f"http://{cpu_srv.host}:{cpu_srv.port}/predict", mixed, 1,
            handler="basic")
    finally:
        cpu_srv.stop()
    want_err = {"status_code": 500, "reason": "Internal Server Error"}
    for label, out in (("card", card_mixed), ("CPU", cpu_mixed)):
        errs, parsed = list(out["error"]), list(out["parsed"])
        check([i for i, e in enumerate(errs) if e is not None]
              == list(IO_REFUSED)
              and all(errs[i] == want_err for i in IO_REFUSED)
              and all(parsed[i] is None for i in IO_REFUSED),
              f"{label}: refused rows {errs}")
    check(list(card_mixed["error"]) == list(cpu_mixed["error"]),
          "the card's error column differs from the CPU's")
    good = [i for i in range(8) if i not in IO_REFUSED]
    mixed_err = frame_err(np.array([card_mixed["parsed"][i] for i in good]),
                          np.array([cpu_mixed["parsed"][i] for i in good]))
    check(mixed_err <= ZOO_TOL, f"card vs CPU served by {mixed_err}")
    res = {"rows": IO_SERVED_ROWS, "rows_per_s_c8": IO_SERVED_ROWS / s8,
           "rows_per_s_c1": IO_SERIAL_ROWS / s1, "c1_rows": IO_SERIAL_ROWS,
           "rows_per_s_policy_c8": IO_SERVED_ROWS / policy_s,
           "served_err": err8, "served_err_c1": err1, "policy_err": err_p,
           "refused": list(IO_REFUSED), "card_vs_cpu_err": mixed_err}
    print(f"[{card_line}] SimpleHTTPTransformer -> /predict "
          f"(cifar10s_resnet20, uint8 wire): {res['rows_per_s_c8']:.1f} "
          f"rows/s at concurrency 8 ({IO_SERVED_ROWS} rows), "
          f"{res['rows_per_s_c1']:.1f} at 1 ({IO_SERIAL_ROWS} rows), policy "
          f"handler {res['rows_per_s_policy_c8']:.1f}; scores {err8:.3e} "
          f"from NNModel.transform; refused rows {list(IO_REFUSED)} in the "
          f"error column as on the CPU")
    return res


class IoStub:
    """A localhost stub of the services' protocols: records every request
    (method, path, body, content type, key headers); a canned sentiment
    document under ``/text``, an echo of the JSON body elsewhere."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        stub = self
        self.received = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                raw = self.rfile.read(int(self.headers.get(
                    "Content-Length", 0)))
                stub.received.append({
                    "path": self.path, "body": raw,
                    "content_type": self.headers.get("Content-Type"),
                    "key": self.headers.get("Ocp-Apim-Subscription-Key"),
                    "api_key": self.headers.get("api-key")})
                payload = json.loads(raw or b"null")
                reply = ({"documents": [{"id": "0", "score": 0.93}],
                          "errors": []} if self.path.startswith("/text")
                         else {"echo": payload})
                data = json.dumps(reply).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def take(self, prefix) -> list:
        got = [r for r in self.received if r["path"].startswith(prefix)]
        return sorted(got, key=lambda r: r["body"])

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join()


def io_services_cell(card_line) -> dict:
    """Phase 32(c): ``TextSentiment``, ``DetectAnomalies``,
    ``AzureSearchWriter`` and ``PowerBIWriter`` against a localhost stub,
    with ``tests/test_torch_services.py``'s assertions."""
    t0 = time.perf_counter()
    stub = IoStub()
    try:
        out = TextSentiment(url=stub.url + "/text", subscription_key="k",
                            language="en").transform(
            DataFrame({"text": obj_col(["great product", None])}))
        sent = stub.take("/text")
        check(len(sent) == 1 and sent[0]["key"] == "k"
              and json.loads(sent[0]["body"]) == {"documents": [
                  {"id": "0", "text": "great product", "language": "en"}]},
              f"TextSentiment sent {sent}")
        check(list(out["result"]) == [0.93, None]
              and list(out["error"]) == [None, None],
              f"TextSentiment gave {list(out['result'])}")
        series = [{"timestamp": f"2020-01-0{d}", "value": float(d)}
                  for d in range(1, 5)]
        out = DetectAnomalies(url=stub.url + "/anomaly",
                              granularity="hourly").transform(
            DataFrame({"series": obj_col([series])}))
        sent = stub.take("/anomaly")
        want = {"series": series, "granularity": "hourly"}
        check(len(sent) == 1 and json.loads(sent[0]["body"]) == want
              and out["result"][0] == {"echo": want},
              f"DetectAnomalies sent {sent}, gave {out['result'][0]}")
        rows = DataFrame({"a": np.arange(250), "b": np.arange(250) * 1.5,
                          "s": obj_col([f"r{i}" for i in range(250)])})
        errs = PowerBIWriter(stub.url + "/pbi", batch_size=100).write(rows)
        batches = sorted((json.loads(r["body"]) for r in stub.take("/pbi")),
                         key=lambda b: b[0]["a"])
        check(errs == [] and [len(b) for b in batches] == [100, 100, 50]
              and batches[2][-1] == {"a": 249, "b": 373.5, "s": "r249"},
              f"PowerBIWriter: errors {errs}, batches "
              f"{[len(b) for b in batches]}")
        errs = AzureSearchWriter(stub.url + "/index", action="upload",
                                 key="k", batch_size=64).write(rows.head(130))
        sent = stub.take("/index")
        batches = sorted((json.loads(r["body"])["value"] for r in sent),
                         key=lambda b: b[0]["a"])
        check(errs == [] and all(r["api_key"] == "k" for r in sent)
              and [len(b) for b in batches] == [64, 64, 2]
              and batches[0][0] == {"a": 0, "b": 0.0, "s": "r0",
                                    "@search.action": "upload"},
              f"AzureSearchWriter: errors {errs}, batches "
              f"{[len(b) for b in batches]}")
        n_requests = len(stub.received)
    finally:
        stub.close()
    secs = time.perf_counter() - t0
    print(f"[{card_line}] the services against a localhost stub "
          f"(TextSentiment, DetectAnomalies, PowerBIWriter, "
          f"AzureSearchWriter): {n_requests} requests as expected, "
          f"{secs:.3f} s")
    return {"requests": n_requests, "seconds": secs}


def io_tail_phase(card_line) -> tuple:
    """Phase 32: (a) the image pipeline, (b) a pipeline calling the
    port's own server, (c) the services."""
    t_phase = time.perf_counter()
    out, parts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launches, out["images"] = io_images_cell(tmp, card_line)
        parts["images"] = time.perf_counter() - t0
    for name, run in (("serving", io_serving_cell),
                      ("services", io_services_cell)):
        t0 = time.perf_counter()
        out[name] = run(card_line)
        parts[name] = time.perf_counter() - t0
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card_line}] the I/O tail took {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    return launches, out

# ---------------------------------------------------------------------------
# phase 33: the examples and the tools (slice 24)

#: the kernels each example's path launches in its own process: K9 on
#: every GBDT fit; the tagger's T 4096 loss through K4's training variant
#: and K6, once a step (its S 64 attention is dense)
EXAMPLE_KERNELS = {**{n: ("gbdt_histogram",) for n in GBDT_EXAMPLES},
                   "sequence_tagging": ("fused_softmax_xent_train",
                                        "fused_ce_dh", "fused_ce_dw")}
TAGGER_STEPS = 400               # the JAX script's
EXAMPLE_TIMEOUT_S = 600
#: examples running at once: the card has room for several, and each
#: process's first 8-9 s are its start (10.1-14.4 s of process against
#: 1.0-5.2 s of main, one at a time on an H100); the longest start first
EXAMPLE_JOBS = 3
LONG_EXAMPLES = ("hyperparam_tuning", "serving_distributed")
#: the trace_dump modes run against a live port worker
TRACE_DUMP_MODES = (["--list"], ["--slowest"], ["--alerts"], ["--slo"],
                    ["--query", "serving_requests_total"],
                    ["--range", "serving_requests_total", "--window", "10",
                     "--step", "0.5"],
                    ["--incidents"], ["--profile", "--window", "5"])
#: chaos_serving's four drills whose pass does not rest on a latency
#: window (kill/restart, keep-alive burst, rollout, prefix cache), at the
#: tool's default counts
CHAOS_DETERMINISTIC = ["--tenancy-requests", "0", "--slo-alerts-requests",
                       "0", "--regression-requests", "0",
                       "--postmortem-requests", "0"]


def example_start(name):
    """Start ``python -m mmlspark_tpu_torch.examples.<name> --json`` on
    the card at the JAX script's sizes -> ``(process, start time)``."""
    return subprocess.Popen(
        [sys.executable, "-m", f"mmlspark_tpu_torch.examples.{name}",
         "--json"], cwd=REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO_ROOT)), time.perf_counter()


def example_finish(name, started, card_line) -> tuple:
    """Wait for an example's process: exit 0 (the JAX script's asserts
    hold), its kernels launched in its process, no plain version on the
    card -> (its JSON line with the process's seconds, the lines to
    print)."""
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    process_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"example {name} exited {proc.returncode}: "
          f"{stderr[-3000:]}")
    lines = stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    shown = [f"  {name}: {line[:240]}" for line in lines[:-1]]
    check(rec["example"] == name and rec["device"] == "cuda"
          and rec["card"] == torch.cuda.get_device_name(0),
          f"example {name} ran on {rec['device']} ({rec['card']})")
    check(rec["plain_on_card"] == {}, f"example {name} called plain "
          f"versions on the card: {rec['plain_on_card']}")
    for k in EXAMPLE_KERNELS.get(name, ()):
        check(rec["launches"].get(k, 0) > 0,
              f"example {name} launched no {k}: {rec['launches']}")
    if name == "sequence_tagging":
        for k in EXAMPLE_KERNELS[name]:
            check(rec["launches"][k] == TAGGER_STEPS,
                  f"the tagger's {k} launched {rec['launches'][k]} times "
                  f"in {TAGGER_STEPS} steps")
    rec["process_s"] = process_s
    shown.append(f"[{card_line}] example {name}: {rec['wall_s']:.2f} s in "
                 f"main, {process_s:.2f} s of process; launches "
                 f"{rec['launches']}")
    return rec, shown


def examples_cell(card_line) -> tuple:
    """(a) Every example in its own process on the card, ``EXAMPLE_JOBS``
    at a time (a process spends about 8 s reaching the card before its
    ``main``) -> (the launches summed over the processes, each example's
    record, the seconds, the lines to print: this runs beside cells that
    capture stdout)."""
    t0 = time.perf_counter()
    launches, out, shown = {}, {}, []
    pending = sorted(EXAMPLES, key=lambda n: n not in LONG_EXAMPLES)
    running = []
    while pending or running:
        while pending and len(running) < EXAMPLE_JOBS:
            name = pending.pop(0)
            running.append((name, example_start(name)))
        done = [r for r in running if r[1][0].poll() is not None]
        if not done:
            time.sleep(0.1)
            continue
        running.remove(done[0])
        name, started = done[0]
        rec, lines = example_finish(name, started, card_line)
        shown += lines
        for k, v in rec.pop("launches").items():
            launches[k] = launches.get(k, 0) + v
        out[name] = {k: v for k, v in rec.items()
                     if k not in ("example", "card", "device",
                                  "plain_on_card")}
    return launches, out, time.perf_counter() - t0, shown


class _Beside(threading.Thread):
    """``fn()`` on a thread of its own; ``result()`` joins it and raises
    what it raised."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self.fn, self.value, self.error = fn, None, None
        self.start()

    def run(self):
        try:
            self.value = self.fn()
        except BaseException as e:     # re-raised in result()
            self.error = e

    def result(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.value


def trace_dump_cell(tmp, card_line) -> dict:
    """(b) ``trace_dump`` against a live port worker on the card: a GBDT
    fitted on the card behind ``python -m mmlspark_tpu_torch.serving
    worker`` (every trace kept, a fast TSDB, incident capture on), 16
    requests, then every read-only mode."""
    import contextlib
    import io
    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(1024, 6))
    y = X @ np.arange(1, 7) + 0.1 * rng.normal(size=1024)
    model = GBDTRegressor(num_iterations=10, num_leaves=15).fit(
        DataFrame({"features": X, "label": y}))
    path = os.path.join(tmp, "trace_model")
    model.save(path)
    proc, addr = spawn_worker(path, SLOW_TRACE_MS="0",
                              TSDB='{"interval_s": 0.25}',
                              INCIDENTS_DIR=os.path.join(tmp, "incidents"))
    out = {}
    try:
        for i in range(16):
            status, _, _ = http_call(addr, "POST", "/predict",
                                     {"features": X[i].tolist()})
            check(status == 200, f"/predict {status}")
        time.sleep(1.5)          # TSDB ticks and profiler samples
        base = f"http://{addr.host}:{addr.port}"
        for argv in TRACE_DUMP_MODES:
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                TRACE_DUMP.main([base, *argv])
            out[" ".join(argv)] = {"lines": len(buf.getvalue().splitlines()),
                                   "s": time.perf_counter() - t0}
        n_listed = out["--list"]["lines"]
        check(n_listed >= 16, f"trace_dump --list showed {n_listed} traces")
        check(out["--slowest"]["lines"] >= 2, "no span tree printed")
        check(out["--query serving_requests_total"]["lines"] >= 1,
              "no query result")
    finally:
        stop_worker(proc)
    print(f"[{card_line}] trace_dump: {len(TRACE_DUMP_MODES)} modes against "
          f"a worker on the card, {n_listed} traces listed")
    return {"modes": out, "traces_listed": n_listed}


def docs_and_zoo_cell(tmp, card_line) -> dict:
    """(c) ``gen_docs`` and ``train_zoo_models digits`` into temp
    directories: the registry's pages, and a ResNet-8 trained on the card
    over JAX's gate, published, fetched back and scoring its golden."""
    docs = GEN_DOCS.write_docs(os.path.join(tmp, "docs"))
    check(docs["pages"] == 10 and docs["stages"] == 116,
          f"gen_docs wrote {docs}")
    t0 = time.perf_counter()
    zoo = ZOO_TRAIN.train("digits", os.path.join(tmp, "zoo_out"), "cuda")
    train_s = time.perf_counter() - t0
    check(zoo["accuracy"] >= ZOO_TRAIN.FLOOR, f"zoo digits {zoo}")
    fn = ModelDownloader(os.path.join(tmp, "zoo_cache"),
                         repo=os.path.join(tmp, "zoo_out", "zoo")).load(
        "digits_resnet8")
    g = np.load(zoo["golden"])
    err = frame_err(fn.apply(g["x"], device="cuda").cpu().numpy(),
                    g["logits"])
    check(err <= ZOO_TOL, f"published digits model on the card {err:.3e} "
          f"from its CPU golden")
    print(f"[{card_line}] gen_docs {docs['pages']} pages, "
          f"{docs['stages']} stages; train_zoo_models digits "
          f"{train_s:.1f} s, test accuracy {zoo['accuracy']:.4f}, card vs "
          f"CPU golden {err:.2e}")
    return {"docs": {k: docs[k] for k in ("pages", "stages")},
            "zoo": {"accuracy": zoo["accuracy"], "seconds": train_s,
                    "golden_err": err}}


def examples_tools_phase(card_line) -> tuple:
    """Phase 33: (a) every example on the card, (b) trace_dump, (c)
    gen_docs and train_zoo_models, (d) the multiclass transfer's card and
    CPU trees, (e) chaos_streaming, (f) chaos_serving's deterministic
    drills. The examples' processes, (d) and (e) run beside (b), (c) and
    (f), which keeps the phase to about its longest part. Returns (the
    launches summed
    over the example processes, chaos_serving's decode worker's, the
    metrics)."""
    t_phase = time.perf_counter()
    out, parts = {}, {}
    CHAOS.DEVICE = None
    examples = _Beside(lambda: examples_cell(card_line))
    trees = _Beside(lambda: multiclass_trees_cell(card_line))
    with tempfile.TemporaryDirectory() as tmp:
        stream = _Beside(lambda: streaming_cell(tmp))
        chaos_launches = tools_cells(out, parts, tmp, card_line)
        out["chaos_streaming"], parts["chaos_streaming"] = stream.result()
    print(f"[{card_line}] chaos_streaming: {out['chaos_streaming']}")
    out["multiclass_same_trees"], line, parts["multiclass_same_trees"] = \
        trees.result()
    print(line)
    launches, out["examples"], parts["examples"], shown = examples.result()
    print("\n".join(shown))
    out["launches"] = launches
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card_line}] the examples and tools took {out['seconds']:.1f} s "
          "(" + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) +
          "; the examples, the multiclass trees and chaos_streaming beside "
          "the rest)")
    return launches, chaos_launches, out


def streaming_cell(tmp) -> tuple:
    """(e) the retrain loop, three workers on the card -> (its record,
    seconds)."""
    t0 = time.perf_counter()
    stream = CHAOS_ST.retrain_loop_drill(os.path.join(tmp, "stream"), SEED,
                                         n_workers=3, device="cuda")
    check(stream["ok"], f"chaos_streaming: "
          f"{json.dumps(stream, default=str)[-2000:]}")
    return {"killed_during": stream["killed_during"],
            "fleet_versions": stream["fleet_versions"],
            "traffic": {k: stream["traffic"][k]
                        for k in ("n_ok", "n_wrong", "n_dropped")}}, \
        time.perf_counter() - t0


def multiclass_trees_cell(card_line) -> dict:
    """(d) ``multiclass_image_transfer`` in this process on the card at
    the JAX script's size (its gates hold), and its classifier fitted
    again on the CPU from the card's embeddings: the card's trees, leaf
    values and predictions against the CPU's, bit for bit through every
    iteration (``same_trees``, which prints a first parting before the
    cell fails). Runs beside other cells -> (its record, the line to
    print, seconds)."""
    t0 = time.perf_counter()
    out = MULTICLASS.run(device="cuda")
    cpu = MULTICLASS.classifier(device="cpu").fit(out["_train"])
    card_b, cpu_b = out["_booster"], cpu.fitted.booster
    n_iters = card_b.num_total_iterations
    frame = out["_train"]
    X = np.stack(list(cpu.featurizer.transform(frame)[
        cpu.features_col])).astype(np.float64)
    same = same_trees(card_b, cpu_b, n_iters, X=X)
    rec = {"accuracy": out["accuracy"],
           "accuracy_unseen": out["accuracy_unseen"],
           "accuracy_unseen_cpu_fit": float(
               (_unseen_accuracy(cpu, out))), "iterations": n_iters, **same}
    line = (f"[{card_line}] multiclass_image_transfer in this process: "
            f"accuracy {rec['accuracy']:.4f}, unseen classes "
            f"{rec['accuracy_unseen']:.4f} (JAX's gate 0.75; the CPU fit of "
            f"the card's embeddings {rec['accuracy_unseen_cpu_fit']:.4f}); "
            f"card and CPU trees equal through {same['equal_iters']} of "
            f"{n_iters} iterations, predictions equal "
            f"{same.get('predict_equal')}")
    require_same(same, f"multiclass_image_transfer's card fit against the "
                       f"CPU's ({line})", n_iters)
    return rec, line, time.perf_counter() - t0


def _unseen_accuracy(model, out) -> float:
    """Unseen-class (8, 9) accuracy of a fitted classifier on the
    example's held-out embeddings."""
    test = out["_test"]
    pred = np.asarray(model.transform(test)["prediction"])
    y = np.asarray(test["label"])
    return float((pred[y >= 8] == y[y >= 8]).mean())


def tools_cells(out, parts, tmp, card_line) -> dict:
    """(b), (c) and (f) into ``out`` and ``parts`` -> the launches of
    chaos_serving's decode worker."""
    import contextlib
    import io
    t0 = time.perf_counter()
    out["trace_dump"] = trace_dump_cell(tmp, card_line)
    parts["trace_dump"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["docs_zoo"] = docs_and_zoo_cell(tmp, card_line)
    parts["docs_zoo"] = time.perf_counter() - t0
    # (f) the deterministic drills; the decode worker on the card
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = CHAOS.main(CHAOS_DETERMINISTIC)
    text = buf.getvalue()
    report = json.loads(text[text.index("{"):text.rindex("}") + 1])
    check(rc == 0, f"chaos_serving failed: {text[-3000:]}")
    prefix = report["prefix"]
    check(prefix["device"] == "cuda" and prefix["wrong_tokens"] == 0
          and prefix["ledger_clean"], f"prefix drill {prefix}")
    chaos_launches = prefix["launches"]
    check(all(v > 0 for v in chaos_launches.values()),
          f"the decode worker launched {chaos_launches}")
    parts["chaos_serving"] = time.perf_counter() - t0
    out["chaos_serving"] = {
        "requests_ok": report["stats"]["n_ok"],
        "burst_failovers": report["burst"]["n_failovers"],
        "rollout": report["rollout"]["rollout"]["state"],
        "prefix": {k: prefix[k] for k in ("hit_rate", "hit_tokens",
                                          "wrong_tokens", "launches")},
        "wall_s": report["wall_s"]}
    print(f"[{card_line}] chaos_serving (kill/restart, keep-alive, "
          f"rollout, prefix): {out['chaos_serving']}")
    return chaos_launches


# ---------------------------------------------------------------------------
# phase 34: the model, expert and pipe axes over processes

#: two processes on the one card, each computing its ranks' part there
#: and meeting the other over gloo
PROC_WORLD = 2
PROC_TP_MESH = {"data": 1, "model": 2}
#: (a): the main path's model, three prompts sharing a prefix of 64
#: tokens (a prefix hit for each after the first), 16 greedy tokens each
PROC_DECODER = dict(n_slots=4, max_len=256, page_size=PAGE)
PROC_PROMPT, PROC_HIT, PROC_NEW = 96, 64, 16
#: (c): phase 27's bf16 ResNet-20 scorer
PROC_ARCH = {"builder": "cifar_resnet", "depth": 20, "dtype": "bfloat16"}
PROC_IMAGES, PROC_BATCH = 512, 256
PROC_TIMEOUT_S = 420
PROC_KERNELS = ("paged_decode_attention", "flash_prefill_attention",
                "paged_prefix_prefill_attention")


def compute_mode() -> str:
    """The card's compute mode as ``nvidia-smi`` names it."""
    p = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=30)
    return p.stdout.strip().splitlines()[0] if p.returncode == 0 else ""


def process_prompts() -> list:
    rng = np.random.default_rng(SEED + 34)
    head = rng.integers(1, CFG.vocab, size=PROC_HIT)
    return [np.concatenate([head, rng.integers(
        1, CFG.vocab, size=PROC_PROMPT - PROC_HIT)]).tolist()
        for _ in range(3)]


def process_axes_phase(card_line) -> tuple:
    """Phase 34: (a) tensor-parallel decode and (c) ``NNModel`` scoring
    one rank per process, in one world of two processes on the card;
    (b) ``tools.launch_multiprocess --smoke`` on the card. Runs beside
    phase 33, so it returns the lines to print -> (the K1-K3 launches
    summed over (a)'s processes, the metrics, the lines)."""
    t_phase = time.perf_counter()
    shown = []
    mode = compute_mode()
    check("exclusive" not in mode.lower(),
          f"the card's compute mode is {mode!r}: two processes cannot "
          f"share it, so the axes over processes cannot run here")
    prompts = process_prompts()
    tree = T.init_params_np(CFG, seed=SEED)
    t0 = time.perf_counter()
    world = PWORLD.spawn(
        "tp_decode+nn_tp", PROC_WORLD,
        {"tp_decode": {"cfg": dataclasses.asdict(CFG), "seed": SEED,
                       "mesh": PROC_TP_MESH, "decoder": PROC_DECODER,
                       "prompts": prompts, "max_new": PROC_NEW,
                       "hit_len": PROC_HIT},
         "nn_tp": {"arch": PROC_ARCH, "input_shape": [32, 32, 3],
                   "rows": PROC_IMAGES, "batch": PROC_BATCH, "seed": SEED,
                   "tensor_parallel": 2}},
        device="cuda:0", timeout=PROC_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    # (a)'s references in this process, on the card
    hosted = TransformerDecoder(tree, CFG, mesh=PDIST.train_mesh(
        PROC_TP_MESH, DEV), **PROC_DECODER)
    want_tp = PWORLD.greedy_lockstep(hosted, prompts, PROC_NEW, PROC_HIT)
    single = TransformerDecoder(tree, CFG, device=DEV, **PROC_DECODER)
    want_one = PWORLD.greedy_lockstep(single, prompts, PROC_NEW, PROC_HIT)
    del hosted, single, tree
    launches = {k: 0 for k in PROC_KERNELS}
    out = {"world_s": world_s, "compute_mode": mode, "decode": [],
           "scoring": []}
    for r, res in enumerate(world):
        check(res["plain_on_card"] == {}, f"process {r} called plain "
              f"versions on the card: {res['plain_on_card']}")
        dec = res["tp_decode"]
        check(dec["tokens"] == want_tp == want_one,
              f"process {r}'s tensor-parallel tokens {dec['tokens']} are not "
              f"the hosted decoder's {want_tp} and the single-device "
              f"decoder's {want_one}")
        check(dec["attn_impl"] == "cuda" and all(
            dec["launches"][k] > 0 for k in PROC_KERNELS),
              f"process {r} launched {dec['launches']} ({dec['attn_impl']})")
        check(dec["pool_heads"] == CFG.n_heads // 2,
              f"process {r}'s pool holds {dec['pool_heads']} heads")
        for k in PROC_KERNELS:
            launches[k] += dec["launches"][k]
        out["decode"].append({k: dec[k] for k in (
            "launches", "seconds", "pool_heads")})
        sc = res["nn_tp"]
        check(np.isfinite(np.asarray(sc["scores"])).all()
              and sc["max_abs_diff"] <= FRAME_BF16_TOL,
              f"process {r}'s tensor-parallel scores are off its "
              f"single-device scores by {sc['max_abs_diff']:.3e}")
        check(sc["placement"]["mesh"] == PROC_TP_MESH
              and sc["placement"]["mode"] == "tensor_parallel",
              f"process {r}'s scoring placement {sc['placement']}")
        out["scoring"].append({"err_vs_single": sc["max_abs_diff"],
                               "seconds": sc["seconds"],
                               "state_bytes_per_device": sc["placement"][
                                   "state_bytes_per_device"]})
    shown.append(
        f"[{card_line}] tensor-parallel decode over {PROC_WORLD} processes "
        f"on the card ({PROC_TP_MESH}, gloo): 3 prompts x {PROC_NEW} tokens "
        f"equal to the hosted and the single-device decoders'; K1-K3 a "
        f"process {[d['launches'] for d in out['decode']]}; "
        f"NNModel(tensor_parallel=2) over the processes: {PROC_IMAGES} "
        f"images within {max(d['err_vs_single'] for d in out['scoring']):.2e}"
        f" of single-device scoring; the world took {world_s:.1f} s")
    # (b)
    t0 = time.perf_counter()
    drill = LAUNCH_MP.run_drill(timeout=PROC_TIMEOUT_S, smoke=True)
    check(drill["passed"] and drill["device"] == "cuda",
          f"launch_multiprocess on the card: "
          f"{json.dumps(drill, default=str)[-2000:]}")
    ph = drill["phases"]
    out["launch_multiprocess"] = {
        "psum": ph["psum"]["value"], "hosted_ranks": drill["hosted_ranks"],
        "fit_diff": ph["fit"]["max_score_diff"],
        "pipe_diff": ph["pipe"]["max_loss_diff"],
        "restored_exact": drill["checkpoint_restore"]["restored_exact"],
        "seconds": time.perf_counter() - t0}
    shown.append(f"[{card_line}] launch_multiprocess --smoke on the card "
                 f"(2 processes x 4 hosted ranks): "
                 f"{out['launch_multiprocess']}")
    out["seconds"] = time.perf_counter() - t_phase
    return launches, out, shown


def main() -> None:
    card_line = card()
    print(card_line)
    t_start = time.perf_counter()

    def lap(what):
        print(f"[{time.perf_counter() - t_start:.1f} s] {what} done",
              flush=True)

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = cuda_build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib.name}")
    log = lib.parent / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith(
                    "=="):
                print("  " + line.strip())
    wgmma_facts = wgmma_build_facts(lib)
    core_facts = cuda_core_build_facts(lib)

    pre, payloads = make_requests(np.random.default_rng(SEED))
    plan = main_path_shapes(payloads)
    records = kernel_phase(plan)
    lap("the kernel phase")

    params = T.params_from_jax(T.init_params_np(CFG, seed=SEED), DEV)
    replies, replies2, launches, metrics = main_path(params, pre, payloads,
                                                     card_line)
    metrics.update(step_profile(params, payloads, card_line))
    engine_parity(params, payloads, replies)
    lap("the paged path")

    agreement = draft_agreement(payloads, (0.05, RESID_SCALE))
    tree, dtree, dcfg = make_spec_model_pair(
        CFG, draft_layers=DRAFT_LAYERS, resid_scale=RESID_SCALE, seed=SEED)
    s1, s2, spec_launches, spec_metrics = spec_path(tree, dtree, dcfg,
                                                    payloads, card_line)
    spec_metrics["draft_agreement"] = agreement[RESID_SCALE]
    target, ref = plain_replies(tree, payloads)
    spec_metrics["greedy_ties"] = sum(
        greedy_parity(target, payloads, r, ref, tag)
        for r, tag in ((s1, "spec pass 1"), (s2, "spec pass 2")))
    print(f"greedy speculative tokens equal the non-speculative decoder's "
          f"(7 requests x 2 passes; {spec_metrics['greedy_ties']} near "
          f"ties below {TIE_GAP})")
    verify_parity(tree, dtree, dcfg, payloads, s1)
    spec_metrics.update(spec_round_profile(tree, dtree, dcfg, payloads,
                                           card_line))
    metrics.update(spec_metrics)
    lap("the speculative path")
    records.update(train_kernel_phase())
    ce_times = ce_engine_times()
    parity, parity_launches = train_parity()
    train_launches, train_metrics = train_path(card_line)
    train_metrics.update(parity)
    train_metrics["ce_engine_ms"] = ce_times
    train_metrics["wgmma_bf16_build"] = wgmma_facts
    train_metrics["cuda_core_and_tf32_build"] = core_facts
    lap("the train path")
    records.update(histogram_phase())
    gbdt_launches, gbdt_metrics = gbdt_path(card_line)
    lap("the GBDT path")
    records.update(k8_phase())
    ring_metrics, ring_parity_launches = ring_parity()
    ring_launches, path_metrics = ring_path(card_line)
    ring_metrics.update(path_metrics)
    lap("the ring path")
    metrics["observability"] = observability_phase(
        params, payloads, {"paged": (replies, replies2), "spec": (s1, s2),
                           "metrics": metrics}, tree, dtree, dcfg,
        card_line)
    lap("the observability plane")
    metrics["http"] = http_phase(params, pre, payloads, (replies, replies2),
                                 tree, dtree, dcfg, s1, card_line)
    metrics["dense"] = dense_phase(params, payloads, replies, metrics,
                                   card_line)
    lap("the HTTP and dense phases")
    frame_metrics = frame_phase(card_line)
    frame_train_launches, frame_train_metrics = frame_train_phase(card_line)
    features_launches, features_metrics = features_phase(card_line)
    lap("the frame phases")
    moe_train_launches, moe_train_metrics = moe_train_phase(card_line)
    moe_decode_launches, int8_launches, moe_decode_metrics, moe_replies = \
        moe_decode_phase(params, payloads, metrics, card_line)
    lap("the MoE phases")
    tp_launches, tp_metrics = tensor_pipe_phase(
        params, payloads, (replies, replies2), metrics, train_metrics,
        moe_replies, plan, card_line)
    lap("tensor and pipeline parallelism")
    pjit_launches, axes_metrics = model_axes_phase(
        frame_metrics, frame_train_metrics, train_metrics, card_line)
    lap("the model axes")
    checkpoint_metrics = checkpoint_phase(card_line)
    lap("checkpoints")
    dist_gbdt_metrics = distributed_gbdt_phase(card_line)
    lap("distributed GBDT")
    load_metrics = load_phase(params, tree, dtree, dcfg, card_line)
    lap("the load drivers")
    tail_launches, tail_metrics = long_tail_phase(card_line)
    lap("the long tail")
    io_launches, io_metrics = io_tail_phase(card_line)
    lap("the I/O tail")
    axes_over_processes = _Beside(lambda: process_axes_phase(card_line))
    example_launches, chaos_launches, et_metrics = examples_tools_phase(
        card_line)
    lap("the examples and tools")
    proc_launches, proc_metrics, shown = axes_over_processes.result()
    print("\n".join(shown))
    lap("the axes over processes")
    # each kernel's launches come from its own main path: K1-K3 slice 1's
    # paged path, K4 the speculative path, the six train kernels the train
    # path, K9 the GBDT path, K8 the ring path; every path's counts stay
    # beside them
    # the f32 routes of K4's training variant, K6 and K7 on the f32 train
    # parity steps, K8's on the f32 {"seq": 4} ring parity steps
    main_of = {"fused_softmax_xent": "speculative",
               **{n: "train" for n in TRAIN_SOURCES},
               **{n: "f32 parity" for n in F32_TRAIN},
               "gbdt_histogram": "gbdt", **{n: "ring" for n in K8_SOURCES},
               **{f"{n}_f32": "f32 ring parity" for n in K8_SOURCES}}
    for name, rec in records.items():
        counted = F32_TRAIN.get(name, name.removesuffix("_f32"))
        by_path = {"paged": launches[counted],
                   "speculative": spec_launches[counted],
                   "train": train_launches[counted],
                   "f32 parity": parity_launches[counted],
                   "gbdt": gbdt_launches[counted],
                   "ring": ring_launches[counted],
                   "f32 ring parity": ring_parity_launches[counted],
                   "frame training": frame_train_launches[counted],
                   "features": features_launches[counted],
                   "moe train": moe_train_launches[counted],
                   "moe decode": moe_decode_launches[counted],
                   "int8 decode": int8_launches[counted],
                   "tp train": tp_launches["train"][counted],
                   "tp decode": tp_launches["decode"][counted],
                   "pjit train": pjit_launches[counted],
                   "tune": tail_launches[counted],
                   "io tail": io_launches[counted],
                   "examples": example_launches.get(counted, 0),
                   "chaos decode worker": chaos_launches.get(counted, 0),
                   "process tp decode": proc_launches.get(counted, 0)}
        rec["launches"] = by_path[main_of.get(name, "paged")]
        rec["launches_by_path"] = by_path
    check(records["fused_softmax_xent"]["launches"]
          == metrics["spec_rounds"] > 0,
          f"K4's launches {records['fused_softmax_xent']['launches']} are "
          f"not the speculative rounds {metrics['spec_rounds']}")

    print(card_line)
    print(json.dumps({"decode": metrics, "card": card_line}))
    print(json.dumps({"train": train_metrics, "card": card_line}))
    print(json.dumps({"gbdt": gbdt_metrics, "card": card_line}))
    print(json.dumps({"ring_train": ring_metrics, "card": card_line}))
    print(json.dumps({"frame": frame_metrics, "card": card_line}))
    print(json.dumps({"frame_train": frame_train_metrics,
                      "card": card_line}))
    print(json.dumps({"features": features_metrics, "card": card_line}))
    print(json.dumps({"moe_train": moe_train_metrics, "card": card_line}))
    print(json.dumps({"moe_int8_decode": moe_decode_metrics,
                      "card": card_line}))
    print(json.dumps({"tensor_pipe": tp_metrics, "card": card_line}))
    print(json.dumps({"model_axes": axes_metrics, "card": card_line}))
    print(json.dumps({"checkpoint": checkpoint_metrics, "card": card_line}))
    print(json.dumps({"distributed_gbdt": dist_gbdt_metrics,
                      "card": card_line}))
    print(json.dumps({"load_drivers": load_metrics, "card": card_line}))
    print(json.dumps({"long_tail": tail_metrics, "card": card_line}))
    print(json.dumps({"io_tail": io_metrics, "card": card_line}))
    print(json.dumps({"examples_tools": et_metrics, "card": card_line},
                     default=float))
    print(json.dumps({"axes_over_processes": proc_metrics,
                      "card": card_line}, default=float))
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# --ab PARENT: the f32 CE and f32 attention kernels of two trees in one
# process, in turns

#: the C entries whose library --ab switches: the fused CE's and the
#: attention's (K7, K8); every other kernel is this tree's
AB_ENTRIES = (FC._FWD, FC._DH, FC._DW, *(
    (e, CA._ARGTYPES[e]) for e in (
        "mmt_attention_fwd", "mmt_attention_bwd_dq", "mmt_attention_bwd_dkdv",
        "mmt_ring_block_fwd", "mmt_ring_block_bwd_dq",
        "mmt_ring_block_bwd_dkdv")))


def parent_library(parent: str) -> ctypes.CDLL:
    """The kernel library of the checkout at ``parent`` (another commit),
    built from its own sources by its own builder."""
    import importlib.util

    path = os.path.join(parent, "mmlspark_tpu_torch", "native",
                        "cuda_build.py")
    spec = importlib.util.spec_from_file_location("parent_cuda_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return ctypes.CDLL(str(mod.build()))


def ab_kernels(parent: str) -> None:
    """K4's verify (T 24), K4's f32 training variant, K6's f32 dh and dW
    (T 2048), K7's f32 forward, dq and dk/dv (B 2, S 1024, causal), K8's
    f32 ones (B 2, S_local 1024, a full and a diagonal block) and the
    speculative round's device time, each through the parent's kernels
    and this tree's in turns (parent, change, change, parent). The C
    entries (``AB_ENTRIES``) are the same in both, so only the library
    behind them changes."""
    card_line = card()
    print(card_line)
    libs = {"parent": parent_library(parent), "change": cuda_build.load()}

    def use(which):
        for entry, argtypes in AB_ENTRIES:
            NL.bind(entry, argtypes, libs[which])

    use("change")
    gen = torch.Generator().manual_seed(SEED)
    verify_t = N_SLOTS * (SPEC_K - 1)
    k4 = k4_case(gen, verify_t, CFG.vocab, miss_label=False)[0]
    t = 2 * TRAIN_S
    h, w, labels, g = ce_inputs(gen, t, CFG.vocab, torch.float32)
    _, logits, lse = FC._forward(h, w, labels, store=True)
    args = (h, w, labels, g, logits, lse)
    cases = {f"fused_softmax_xent T={verify_t}": k4,
             f"fused_softmax_xent_train T={t} f32":
                 lambda: FC._forward(h, w, labels, store=True),
             f"fused_ce_dh T={t} f32": lambda: FC.fused_ce_dh(*args),
             f"fused_ce_dw T={t} f32": lambda: FC.fused_ce_dw(*args)}
    cases.update({f"{name} B=2 S={TRAIN_S}": case[0] for name, case in
                  attn_f32_timed_cases(gen).items()})
    cases.update({f"{name}_f32 B=2 S_local=1024 {blk} block": case[0]
                  for (blk, name), case in
                  k8_timed_cases(gen, torch.float32).items()})
    order = ("parent", "change", "change", "parent")
    out = {}
    for name, fn in cases.items():
        out[name] = {"parent": [], "change": []}
        for which in order:
            use(which)
            out[name][which].append(time_ms(fn))
        print(f"[{card_line}] {name} (ms, cold L2): parent "
              f"{out[name]['parent']}, change {out[name]['change']}")
    del h, w, labels, g, logits, lse, args, cases
    torch.cuda.empty_cache()
    tree, dtree, dcfg = make_spec_model_pair(
        CFG, draft_layers=DRAFT_LAYERS, resid_scale=RESID_SCALE, seed=SEED)
    _, payloads = make_requests(np.random.default_rng(SEED))
    name = "speculative round device ms"
    out[name] = {"parent": [], "change": []}
    for which in order:
        use(which)
        prof = spec_round_profile(tree, dtree, dcfg, payloads, card_line)
        out[name][which].append(prof["spec_round_device_ms"])
    print(f"[{card_line}] {name}: parent {out[name]['parent']}, change "
          f"{out[name]['change']}")
    print(json.dumps({"ab": out, "card": card_line}))


# ---------------------------------------------------------------------------
# --ab-moe-slots: phase 24's step with the capacity slots' one-hot cumsum
# laid out two ways, in turns

#: --ab-moe-slots: rounds of 10-step turns (each round tokens, innermost,
#: innermost, tokens), then pairs of single steps
AB_ROUNDS, AB_PAIRS = 6, 48


def queue_slots_tokens_dim(top, E: int):
    """``T._queue_slots`` with the one-hot laid out [R, Tk, E] and its
    cumsum along the tokens' dim."""
    onehot = torch.nn.functional.one_hot(top, E)          # [R, Tk, E]
    arrived = torch.cumsum(onehot, dim=1)
    return torch.gather(arrived, 2, top[..., None])[..., 0] - 1, \
        onehot.sum(dim=1)


def ab_moe_slots() -> None:
    """Phase 24's MoE train step (``bench_moe_train``'s shape, the sort
    engine) with ``_queue_slots``'s cumsum along the tokens' dim of [R,
    Tk, E] and along the innermost dim of [R, E, Tk], in turns
    (``AB_ROUNDS`` rounds of tokens, innermost, innermost, tokens). Each
    turn: 2 warm steps, 10 timed (ms of wall a step, tokens/s), then
    ``device_profile`` over 3 (device busy ms, the profiled wall). Then
    ``AB_PAIRS`` pairs of single steps, the layouts alternating within a
    pair and the pair's order alternating, each step timed alone
    (synchronized before and after). The two layouts' slots and counts
    must be equal on random routings first."""
    card_line = card()
    print(card_line)
    cuda_build.build()
    cfg = MOE_TRAIN_CFG
    n_tok = TRAIN_B * TRAIN_S
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    top = torch.randint(0, cfg.n_experts, (1, n_tok * cfg.moe_top_k),
                        device=DEV, generator=gen)
    a, b = (f(top, cfg.n_experts) for f in (queue_slots_tokens_dim,
                                             T._queue_slots))
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "the two slot layouts disagree")
    mesh = build_mesh(MeshSpec.from_dict({"data": 1}), DEV)
    batch = T.make_batch(np.random.default_rng(SEED), cfg, TRAIN_B, TRAIN_S,
                         DEV)
    params = T.shard_params(T.init_params_np(cfg, seed=SEED), cfg, mesh)
    vel = T.init_velocity(params)
    step = T.build_spmd_train_step(cfg, mesh, TRAIN_LR, TRAIN_MOMENTUM)
    layouts = {"tokens_dim": queue_slots_tokens_dim,
               "innermost": T._queue_slots}
    out = {k: {"wall_ms": [], "tokens_per_s": [], "device_ms": [],
               "profile_wall_ms": [], "device_ops": []} for k in layouts}
    try:
        for which in ("tokens_dim", "innermost", "innermost",
                      "tokens_dim") * AB_ROUNDS:
            T._queue_slots = layouts[which]
            for _ in range(MOE_WARM):
                step(params, vel, *batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MOE_STEPS):
                loss = step(params, vel, *batch)[2]
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / MOE_STEPS
            check(np.isfinite(float(loss)), f"{which}: loss {loss}")
            prof = device_profile(lambda: step(params, vel, *batch), 3,
                                  f"MoE train step, slots {which}",
                                  card_line)
            row = out[which]
            row["wall_ms"].append(wall_ms)
            row["tokens_per_s"].append(n_tok / (wall_ms / 1e3))
            row["device_ms"].append(prof["device_ms"])
            row["profile_wall_ms"].append(prof["wall_ms"])
            row["device_ops"].append(prof["device_ops"])
            print(f"[{card_line}] slots {which}: {wall_ms:.2f} ms/step of "
                  f"wall, {n_tok / (wall_ms / 1e3):.1f} tokens/s; device "
                  f"busy {prof['device_ms']:.2f} ms of a profiled "
                  f"{prof['wall_ms']:.2f} ms")
        single = {k: [] for k in layouts}
        for i in range(AB_PAIRS):
            for which in (list(layouts) if i % 2 == 0
                          else list(layouts)[::-1]):
                T._queue_slots = layouts[which]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(params, vel, *batch)
                torch.cuda.synchronize()
                single[which].append((time.perf_counter() - t0) * 1e3)
    finally:
        T._queue_slots = layouts["innermost"]
    for which, ms in single.items():
        out[which]["single_step_ms"] = ms
        print(f"[{card_line}] slots {which}, {AB_PAIRS} single steps "
              f"alternating: median {np.median(ms):.2f} ms, mean "
              f"{np.mean(ms):.2f} ms, min {min(ms):.2f} ms")
    for which, row in out.items():
        print(f"[{card_line}] slots {which}, 10-step turns: wall median "
              f"{np.median(row['wall_ms']):.2f} ms (mean "
              f"{np.mean(row['wall_ms']):.2f}), device busy median "
              f"{np.median(row['device_ms']):.2f} ms")
    print(json.dumps({"ab_moe_slots": out, "card": card_line}))


# ---------------------------------------------------------------------------
# --ab-gbdt PARENT: the GBDT fits of phases 13 and 29 through two trees'
# packages, in turns


def gbdt_ab_turn() -> None:
    """One turn of ``--ab-gbdt``, in a process whose working directory is
    the tree under test (its ``mmlspark_tpu_torch``): after a 2-iteration
    warm fit, the wall seconds of phase 13's adult fit and Higgs-shape
    fit and of phase 29's four hosted ``DIST_MESH`` fits, each on the card
    and synchronized, and the CPU seconds of the fitting thread, then K9's
    device ms at phase 12's uint8 Higgs cases (``k9_ab_ms``); one JSON
    line."""
    X, y, p, kw = adult_cell()
    Booster.train(dataclasses.replace(p, num_iterations=2), X, y, **kw)
    out = {}

    def timed(name, params, X, y, kw, sharding=None):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        Booster.train(params, X, y, sharding=sharding, **kw)
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        # the host's own work, less what other tenants take of the cores
        out[f"{name} (main thread's CPU s)"] = time.thread_time() - c0
    timed("adult", p, X, y, kw)
    mesh = build_mesh(MeshSpec.from_dict(DIST_MESH), torch.device("cuda"))
    for label, learner, top_k in DIST_LEARNERS:
        timed(f"adult {label} {DIST_MESH}", dataclasses.replace(
            p, tree_learner=learner, top_k=top_k), X, y, kw, mesh)
    hx, hy, hp, hkw = higgs_cell()
    timed("higgs", hp, hx, hy, hkw)
    k9_ab_ms(out)
    print(json.dumps(out))


def k9_ab_ms(out) -> None:
    """K9 through the tree's own wrapper at phase 12's Higgs cases in
    uint8 (the root, leaves of 1/8 and 1/64 scattered rows): the mean
    device ms of 20 launches, each after a 256 MiB write (cold L2), CUDA
    events around the call, into ``out`` (in the fixed point where the
    tree's wrapper takes one)."""
    import inspect as _inspect
    gen = np.random.default_rng(0)
    n, f, b = HIGGS_ROWS, HIGGS_FEATURES, 255
    bins_t = CH.prepare_bins_t(torch.from_numpy(
        gen.integers(0, b, size=(n, f)).astype(np.int32)), b).cuda()
    grad = torch.from_numpy(gen.normal(size=n).astype(np.float32)).cuda()
    hess = torch.from_numpy(gen.uniform(0.1, 1, size=n).astype(
        np.float32)).cuda()
    extra = ()
    if "scale" in _inspect.signature(CH.build_histogram_cuda).parameters:
        extra = (CH.fixed_scale(grad, hess, n),)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for density in (1.0, 1 / 8, 1 / 64):
        mask = torch.from_numpy(gen.uniform(size=n) < density).cuda()
        args = (bins_t, grad, hess, mask, f, b) + extra
        for _ in range(3):
            CH.build_histogram_cuda(*args)
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(20)]
        for start, end in ev:
            flush.zero_()
            start.record()
            CH.build_histogram_cuda(*args)
            end.record()
        torch.cuda.synchronize()
        out[f"K9 ms, uint8, in-leaf {density:g}"] = sum(
            s.elapsed_time(e) for s, e in ev) / len(ev)


#: --ab-gbdt: rounds of turns (parent, change, change, parent)
AB_GBDT_ROUNDS = 3


def ab_gbdt(parent: str) -> None:
    """Phases 13's and 29's GBDT fits (``gbdt_ab_turn``) through the
    parent's package and this tree's, one process a turn
    (``AB_GBDT_ROUNDS`` rounds of parent, change, change, parent), each
    process started in its tree with the turn's source and the cells it
    fits (the trees' public API only). The kernels are this tree's
    build, copied into the parent's build directory (used there when
    the parent's sources are the same)."""
    import inspect

    card_line = card()
    print(card_line)
    built = cuda_build.build().parent
    shutil.copytree(built, os.path.join(
        parent, "mmlspark_tpu_torch", "_build", built.name),
        dirs_exist_ok=True)
    code = "\n".join([
        "import dataclasses, json, time", "import numpy as np",
        "import torch",
        "from mmlspark_tpu_torch.gbdt import Booster, BoosterParams",
        "from mmlspark_tpu_torch.gbdt import cuda_hist as CH",
        "from mmlspark_tpu_torch.parallel.topology import MeshSpec, "
        "build_mesh",
        f"ADULT_ITERS = {ADULT_ITERS!r}",
        f"HIGGS_ROWS, HIGGS_FEATURES, HIGGS_ITERS = {HIGGS_ROWS!r}, "
        f"{HIGGS_FEATURES!r}, {HIGGS_ITERS!r}",
        f"DIST_MESH = {DIST_MESH!r}", f"DIST_LEARNERS = {DIST_LEARNERS!r}",
        inspect.getsource(adult_cell), inspect.getsource(higgs_cell),
        inspect.getsource(gbdt_ab_turn), inspect.getsource(k9_ab_ms),
        "gbdt_ab_turn()"])
    trees = {"parent": os.path.abspath(parent), "change": REPO_ROOT}
    out = {}
    for which in ("parent", "change", "change", "parent") * AB_GBDT_ROUNDS:
        env = dict(os.environ, PYTHONPATH=trees[which])
        r = subprocess.run([sys.executable, "-c", code], cwd=trees[which],
                           env=env, capture_output=True, text=True,
                           timeout=900)
        check(r.returncode == 0, f"{which} turn failed:\n{r.stdout[-2000:]}"
                                 f"\n{r.stderr[-3000:]}")
        for name, secs in json.loads(r.stdout.strip().splitlines()[-1]
                                     ).items():
            out.setdefault(name, {"parent": [], "change": []})[which] \
                .append(secs)
        print(f"[{card_line}] {which} turn: {r.stdout.strip()}", flush=True)
    for name, row in out.items():
        unit = "ms" if name.startswith("K9") else "s"
        print(f"[{card_line}] {name}: parent median "
              f"{np.median(row['parent']):.4f} {unit} {row['parent']}, "
              f"change median {np.median(row['change']):.4f} {unit} "
              f"{row['change']}")
    print(json.dumps({"ab_gbdt": out, "card": card_line}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        ab_kernels(sys.argv[2])
    elif sys.argv[1:] == ["--ab-moe-slots"]:
        ab_moe_slots()
    elif len(sys.argv) == 3 and sys.argv[1] == "--ab-gbdt":
        ab_gbdt(sys.argv[2])
    else:
        main()
