#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mmlspark_tpu_torch``) on one H100.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``); it imports
nothing of JAX or of the JAX package. With ``--ab PARENT`` (a checkout
of another commit, its sources beside this tree's) it only times calls
through that tree's kernel library and this one's in turns: K4's verify,
K4's f32 training variant, K6's f32 dh and dW, K7's and K8's f32
forward, dq and dk/dv, and the speculative round's device time. Phases:

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
   one row, with bins in uint8 and in int32: counts exact, grad and
   hess within 1e-5 x (the bin's sum of |value|) + 1e-6, two launches
   bitwise equal; the kernel and ``index_add_`` timed at 2^20 x 28 x 255
   for the root histogram and for leaves of 1/8 and 1/64 scattered
   rows, each in uint8 (the GBDT path's layout; the root with the plain
   version) and in int32, each beside its bytes bound (the function's
   bytes: mask, the live rows' bins, grad and hess, the output) and,
   apart, the bytes of the clusters' partials the design writes and
   reads back;
13. the GBDT path through ``Booster.train`` on the card, K9's launches
   read around all of its fits and equal to iterations x outputs x
   leaves in each: ``bench.py``'s ``bench_gbdt_quantile`` and
   ``bench_adult_census`` configs (a warm fit, then the median of 3),
   each against the same fit on the CPU — the first 5 iterations' trees
   equal, or split apart only at a tie (the two gains within 1e-5 of
   the tree's root gain, printed), and where they part, the leaf's
   gradients, histogram and each step of the split search compared bit
   for bit between card and CPU (``parting_cause``); every split and
   leaf of the card fit replayed with the CPU's arithmetic
   (``replay_on_cpu``); the final
   train AUC within 1e-3 and pinball loss within 1e-2 relative
   (``GBDT_METRIC_TOL`` says why); and the card booster's ``predict``
   equal to its CPU ``predict`` within 1e-5;
14. the Higgs-shape cell (2^20 rows x 28 features, 255 leaves, binary):
   a warm 2-iteration fit, two 10-iteration fits whose trees must be
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
18. print decode tokens/s, TTFT, acceptance, the decode metrics', the
   train metrics', the GBDT metrics', the ring train metrics' and the
   kernels' JSON lines and, last, ``{"ok": true, "device": {...}}``.

Any failed check raises: a nonzero exit and no ``ok`` line. Without
CUDA it exits nonzero before printing any result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: no CUDA device; this script runs on the "
                     "card only")

from mmlspark_tpu_torch.native import cuda_build  # noqa: E402
from mmlspark_tpu_torch.native import launch as NL  # noqa: E402
from mmlspark_tpu_torch.gbdt import Booster, BoosterParams  # noqa: E402
from mmlspark_tpu_torch.gbdt import cuda_hist as CH  # noqa: E402
from mmlspark_tpu_torch.gbdt import tree as GT  # noqa: E402
from mmlspark_tpu_torch.models import transformer as T  # noqa: E402
from mmlspark_tpu_torch.ops import fused_ce as FC  # noqa: E402
from mmlspark_tpu_torch.parallel import cuda_attention as CA  # noqa: E402
from mmlspark_tpu_torch.parallel import ring_attention as RA  # noqa: E402
from mmlspark_tpu_torch.parallel.sharding import bucket_target  # noqa: E402
from mmlspark_tpu_torch.parallel.topology import (  # noqa: E402
    MeshSpec, build_mesh,
)
from mmlspark_tpu_torch.serving.decode import (  # noqa: E402
    DecodeScheduler, TransformerDecoder,
)
from mmlspark_tpu_torch.testing.decode_load import (  # noqa: E402
    make_spec_model_pair,
)

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
TIE_GAP = 1e-3         # greedy divergence allowed only below this top-2 gap
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


def k1_case(gen, pos, free=()):
    """K1 over a batch of len(pos) slots; slots in ``free`` ride at pos 0
    on an all-scratch table, as the decoder's free slots do. The library
    call gathers each lane through its table (K and V), then runs
    ``scaled_dot_product_attention`` under the position mask (built
    outside the timed call)."""
    h, d = CFG.n_heads, CFG.d_head
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
        lk = lane_gather(kp, tables, n, lane)
        lv = lane_gather(vp, tables, n, lane)
        return torch.nn.functional.scaled_dot_product_attention(
            q4, lk, lv, attn_mask=mask, scale=d ** -0.5)

    rows = sum(min(p, lane - 1) + 1 for p in pos)
    nbytes = 4 * (2 * n * h * d + 2 * rows * h * d) + 4 * n * (PPS + 1)
    flops = 4 * rows * h * d
    return kern, plain, lib, nbytes, flops


def lane_gather(pool, tables, n, lane):
    """Each row of ``tables``' lane gathered from the pool, as SDPA's
    (N, H, lane, Dh) (a view of the gather)."""
    return pool[tables].reshape(n, lane, CFG.n_heads, CFG.d_head
                                ).transpose(1, 2)


def k2_case(gen, s):
    h, d = CFG.n_heads, CFG.d_head
    q, k, v = (rnd(gen, 1, s, h, d) for _ in range(3))
    kern = lambda: CA.flash_prefill_attention(q, k, v)  # noqa: E731
    plain = lambda: CA.flash_prefill_attention_plain(q, k, v)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        qt, kt, vt, is_causal=True)
    return kern, plain, lib, 4 * 4 * s * h * d, k2_flops(s)


def k2_flops(s: int) -> int:
    """Causal attention's FLOPs at B 1, S s, the bench width."""
    return 4 * CFG.n_heads * CFG.d_head * s * (s + 1) // 2


def k3_case(gen, hit, s):
    """K3 at one hit depth and suffix; the library call as K1's, over the
    slot's one lane."""
    h, d = CFG.n_heads, CFG.d_head
    n_pages = 1 + PPS
    kp, vp = rnd(gen, n_pages, PAGE, h, d), rnd(gen, n_pages, PAGE, h, d)
    q = rnd(gen, s, h, d)
    table = (1 + torch.randperm(PPS, generator=gen)).to(torch.int32).to(DEV)
    args = (q, kp, vp, table, hit, d ** -0.5, PAGE)
    kern = lambda: CA.paged_prefix_prefill_attention(*args)  # noqa: E731
    plain = lambda: CA.paged_prefix_prefill_attention_plain(*args)  # noqa
    lane = PPS * PAGE
    mask = (torch.arange(lane, device=DEV)[None, :]
            <= hit + torch.arange(s, device=DEV)[:, None])[None, None]
    q4 = q.transpose(0, 1)[None]

    def lib():
        lk = lane_gather(kp, table[None], 1, lane)
        lv = lane_gather(vp, table[None], 1, lane)
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


def attn_inputs(gen, b, s, dtype):
    h, d = CFG.n_heads, CFG.d_head
    return tuple(rnd(gen, b, s, h, d).to(dtype) for _ in range(4))


def attn_errors(gen, b, s, dtype) -> dict:
    """The forward (as the folded engine calls it: output in the input
    dtype) and the two backward kernels against their plain versions on
    the same inputs."""
    q, k, v, do = attn_inputs(gen, b, s, dtype)
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

    def __init__(self, payload, rid):
        self.payload = payload
        self.rid = rid
        self.deadline = None
        self.event = threading.Event()
        self.callbacks = []
        self.reply = None
        self.status = None
        self.span = None


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


def serve(sched, payloads, tag):
    pend = [Pending(p, f"{tag}-{i}") for i, p in enumerate(payloads)]
    t0 = time.perf_counter()
    for p in pend:
        sched.submit(p)
    for p in pend:
        check(p.event.wait(600), f"{p.rid} timed out")
    wall = time.perf_counter() - t0
    replies = [json.loads(p.reply) for p in pend]
    for p, r in zip(pend, replies):
        check(p.status == 200, f"{p.rid} replied {p.status}: {r}")
        check(r["n_tokens"] == p.payload["max_new_tokens"],
              f"{p.rid} produced {r['n_tokens']} tokens")
    return replies, wall


def ledger_clean(sched) -> bool:
    return (sched.pages.n_free + sched.prefix.n_cached
            == sched.pages.n_pages - 1 and sched.prefix.ledger_clean())


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
    cold = stats["n_prefills"] - pstats["hits"]
    want = {"paged_decode_attention": CFG.n_layers * stats["n_steps"],
            "flash_prefill_attention": CFG.n_layers * cold,
            "paged_prefix_prefill_attention": CFG.n_layers * pstats["hits"],
            "fused_softmax_xent": 0,     # no draft, no verify
            **{n: 0 for n in TRAIN_LAUNCHES if n != "fused_softmax_xent"}}
    for name, n in want.items():
        check(launches[name] > 0 or n == 0, f"{name} never launched")
        check(launches[name] == n,
              f"{name}: {launches[name]} launches, expected {n}")
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
    return r1, launches, metrics


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
            "picked": picked}


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


def greedy_parity(params, payloads, replies, plain_replies, tag) -> int:
    """The greedy requests' speculative tokens against a non-speculative
    decoder's. A divergence passes only where that decoder's top-2 logit
    gap at the first differing position is below TIE_GAP (a near tie
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
        top2 = torch.topk(T.reference_logits(params, ctx, CFG)[0, -1], 2)
        gap = float(top2.values[0] - top2.values[1])
        print(f"{tag} request {i}: diverges from the non-speculative "
              f"tokens at token {at}; top-2 logit gap there {gap:.3e}")
        check(gap < TIE_GAP, f"{tag} request {i} diverges at token {at} "
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
    spec_payloads = [dict(p) for p in payloads]
    spec_payloads[5]["speculative"] = True
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
    # every request of this phase is spec-capable (greedy, or opted in),
    # so each admission prefills the draft too
    cold = stats["n_prefills"] - pstats["hits"]
    want = {"paged_decode_attention": CFG.n_layers * stats["n_steps"],
            "flash_prefill_attention": CFG.n_layers * cold
            + dcfg.n_layers * stats["n_prefills"],
            "paged_prefix_prefill_attention": CFG.n_layers * pstats["hits"],
            "fused_softmax_xent": spec["rounds"],
            **{n: 0 for n in TRAIN_LAUNCHES if n != "fused_softmax_xent"}}
    for name, n in want.items():
        check(launches[name] == n,
              f"{name}: {launches[name]} launches, expected {n}")
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
# K9's grad/hess limit: |kernel - plain| <= HIST_RTOL x (the sum of |value|
# over the bin's rows) + HIST_ATOL; f32 sums in another order, nothing else
HIST_RTOL, HIST_ATOL = 1e-5, 1e-6
# the first GBDT_SAME_ITERS trees of a card fit must equal the CPU fit's;
# where a split differs, the two splits' gains must tie within TIE_GAP of
# the tree's root gain (f32 rounding of sums of that scale)
GBDT_SAME_ITERS, TIE_GAP = 5, 1e-5
# final train metric, card fit against CPU fit: AUC within 1e-3; the
# pinball loss within 1e-2 relative. Ties part the fits (a quantile
# objective's gains depend on counts only, so ties are everywhere), and
# tie-broken fits differ this much: the JAX package and the port on the
# CPU, the same config, differ by 5.5e-3
# (tests/test_torch_gbdt_model.py::test_tie_broken_quantile_fits_spread;
# tests/test_torch_gbdt.py explains the ties). Every split and leaf of
# the card fit is held far tighter by replay_on_cpu.
GBDT_METRIC_TOL = {"gbdt_quantile": 1e-2, "gbdt_adult": 1e-3}
GBDT_PREDICT_TOL = 1e-5    # card predict vs the same booster's CPU predict
HIGGS_ROWS, HIGGS_FEATURES, HIGGS_ITERS = 1 << 20, 28, 10


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
    """(max abs error, whether counts are exact, the worst grad/hess error
    over its limit, whether two launches are bitwise equal)."""
    bins_t, grad, hess, mask, f, b = args
    k1 = CH.build_histogram_cuda(*args)
    k2 = CH.build_histogram_cuda(*args)
    torch.cuda.synchronize()
    plain = CH.build_histogram_plain(*args)
    scale = CH.build_histogram_plain(bins_t, grad.abs(), hess.abs(), mask,
                                     f, b)
    check(torch.isfinite(k1).all().item(), "K9 output not finite")
    err = (k1 - plain).abs()
    limit = HIST_RTOL * scale[..., :2] + HIST_ATOL
    return (float(err.max()), bool(torch.equal(k1[..., 2], plain[..., 2])),
            float((err[..., :2] / limit).max()), bool(torch.equal(k1, k2)))


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
    flat_idx = (bins_t.long() + torch.arange(f, device=DEV)[:, None] * b
                ).reshape(-1)
    m = mask.float()
    vals = torch.stack([grad * m, hess * m, m], 1)[None].expand(
        f, -1, -1).reshape(-1, 3).contiguous()
    ms = time_ms(lambda: CH.build_histogram_cuda(*args))
    plain_ms = (time_ms(lambda: CH.build_histogram_plain(*args))
                if with_plain else None)
    lib_ms = time_ms(lambda: torch.zeros(f * b, 3, device=DEV).index_add_(
        0, flat_idx, vals))
    plan = CH.plan_for(DEV, bins_t, f, b)
    rows = int(mask.sum())
    partials = plan.partial_bytes(f, b)
    nbytes = n + rows * (f * bins_t.element_size() + 8) + f * b * 12
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
    both bin layouts; timed at the Higgs shape's root histogram (every row
    in the leaf: the main path's largest) and at two scattered leaves, each
    in uint8 and int32 beside its byte bound and ``index_add_``."""
    gen = np.random.default_rng(SEED + 4)
    worst = 0.0
    for layout in ("uint8", "int32"):
        for n, f, b in HIST_SHAPES:
            for density in (0.7, 0.0, "one row"):
                err, exact, ratio, same = hist_errors(hist_case(
                    gen, n, f, b, density, layout))
                print(f"K9 {layout} n={n} F={f} B={b} in-leaf {density}: "
                      f"max_abs_err {err:.3e}, grad/hess error {ratio:.3f} "
                      f"of its limit, counts exact {exact}, two launches "
                      f"bitwise equal {same}")
                where = f"{layout} n={n} F={f} B={b} in-leaf {density}"
                check(exact, f"K9 counts differ at {where}")
                check(ratio <= 1.0, f"K9 grad/hess beyond {HIST_RTOL} x "
                                    f"sum|v| + {HIST_ATOL} at {where}")
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


def adult_cell():
    """bench.py's bench_adult_census (bench.py:181-213), exactly, on one
    device."""
    rng = np.random.default_rng(0)
    n, f = 32768, 14
    X = rng.normal(size=(n, f))
    X[:, 10] = rng.integers(0, 16, n)   # categorical-ish columns
    X[:, 11] = rng.integers(0, 14, n)
    logit = X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] + 0.2 * (X[:, 10] > 8)
    y = (logit + rng.logistic(size=n) > 0).astype(np.float64)
    p = BoosterParams(objective="binary", num_iterations=100, num_leaves=31)
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


def same_trees(card_b, cpu_b, n_iters) -> dict:
    """The first ``n_iters`` trees of a card fit against the CPU fit's,
    split by split. The first differing split must tie: the two chosen
    gains (the top two candidates of that leaf under the two summation
    orders) within TIE_GAP of the tree's root gain. Later trees are not
    compared once a split differed, nor, for a renewal objective (its
    gradients are signs of residuals, and renewal puts rows exactly at
    their leaf's value), once a leaf value differed by an ulp."""
    renewal = card_b.obj.renew_quantile is not None
    for it in range(n_iters):
        for k, (a, b) in enumerate(zip(card_b.trees[it], cpu_b.trees[it])):
            ba, bb = _bodies(a), _bodies(b)
            scale = max(abs(ba[0][1]) if ba else 0.0,
                        abs(bb[0][1]) if bb else 0.0, 1e-30)
            for j in range(max(len(ba), len(bb))):
                ka, ga = ba[j] if j < len(ba) else (None, 0.0)
                kb, gb = bb[j] if j < len(bb) else (None, 0.0)
                if ka != kb:
                    gap = abs(ga - gb) / scale
                    print(f"  split differs: iteration {it} output {k} "
                          f"body {j}: card {ka} gain {ga:.7g}, CPU {kb} "
                          f"gain {gb:.7g}; top-two gap {gap:.3e} of the "
                          f"root gain")
                    check(gap < TIE_GAP, f"card and CPU splits differ by "
                                         f"{gap:.3e} of the root gain")
                    return {"equal_iters": it, "first_tie_gap": gap,
                            "first_part": {"iteration": it, "output": k,
                                           "body": j, "card": split_json(ka),
                                           "cpu": split_json(kb)}}
            check(np.allclose(a.value, b.value, rtol=1e-4, atol=1e-6),
                  f"leaf values differ at iteration {it}")
            if renewal and not np.array_equal(a.value, b.value):
                # sign gradients: an ulp may flip a row's next gradient
                return {"equal_iters": it + 1, "first_tie_gap": None}
    return {"equal_iters": n_iters, "first_tie_gap": None}


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
    left child built by K9 or its plain version, each right child its
    parent's less its left sibling's), then each step of ``tree._gains``
    compared bit for bit between the devices: the gradients, the
    histogram, its sum over bins, the cumulative sums and the gains. The
    first step that differs is where the fits part; the two chosen
    splits' gains on each device show the tie it broke. No feature
    mask (the bench configs sample no features). Exact at iteration 0;
    later, the raw scores are the trees' values summed as
    ``replay_on_cpu`` sums them, which may differ from the fit's by an
    ulp."""
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

        def hist(q):
            if q == 0 or q % 2:
                return CH.build_histogram_cuda(bins_t, g, h, torch.from_numpy(
                    seen[q]).to(dev), F, B)
            return hist(parent[q]) - hist(q - 1)
        # the grower evaluates the root alone and each child beside its
        # sibling (left first)
        pair = ([node] if node == 0 else
                [node, node + 1] if node % 2 else [node - 1, node])
        hs = torch.stack([hist(q) for q in pair])
        first = (torch.arange(B, device=dev) == 0)[:, None]
        both = torch.stack([hs, torch.where(first, 0.0, hs)], dim=1)
        gains = GT._gains(hs, None if cats is None else cats.to(dev), gp)[0]
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
    arithmetic (the plain histogram, split finding and leaf renewal of
    the port on CPU tensors), from the card's own earlier trees: each
    chosen split's gain must be the CPU's best within TIE_GAP of the
    leaf's rounding scale, (sum |g|)^2 / sum h over its rows (the f32
    error of a gradient sum grows with sum |g|, not with the sum, which
    cancels late in a fit), and leave min_data_in_leaf rows on each
    side, and
    each leaf value must equal the CPU's within 1e-4 x |value| + 1e-6.
    Holds the whole card fit, ties and all."""
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
    worst_gap = worst_val = 0.0

    def value_err(got, cpu_value):
        want = float(cpu_value) * p.learning_rate
        return abs(float(got) - want) / (1e-4 * abs(want) + 1e-6)
    for it, (tree,) in enumerate(b.trees):
        g, h = b.obj.grad_hess(raw, yt, w)
        seen = members_by_node(tree, bins)
        for q in range(tree.n_nodes):
            rows = torch.from_numpy(np.flatnonzero(seen[q]))
            hist = CH.build_histogram_plain(
                bins_t[:, rows].contiguous(), g[rows], h[rows],
                torch.ones(len(rows), dtype=torch.bool), F, B)
            packed = GT.eval_leaf(hist, cats, gp)[0].numpy()
            if tree.feature[q] < 0:
                if b.obj.renew_quantile is None:
                    worst_val = max(worst_val, value_err(
                        tree.value[q], packed[GT.EV_VALUE]))
                continue
            f = int(tree.feature[q])
            if tree.categorical[q]:
                left = tree.cat_mask[q][:B].copy()
            else:
                left = np.arange(B) <= tree.threshold_bin[q]
                left[0] = tree.missing_left[q]
            hf = hist[f].double().numpy()
            tot, lsum = hf.sum(0), hf[left].sum(0)
            rsum = tot - lsum

            def score(s):
                return s[0] ** 2 / (s[1] + p.lambda_l2 + 1e-12)
            gain = score(lsum) + score(rsum) - score(tot)
            best = float(packed[GT.EV_GAIN])
            # the gain's f32 rounding scale: the leaf's score had no
            # gradient cancelled (a sum's rounding grows with sum |g|)
            scale = score((float(g[rows].abs().sum()),
                           float(h[rows].sum())))
            gap = abs(gain - best) / max(scale, 1e-30)
            worst_gap = max(worst_gap, gap)
            check(gap <= TIE_GAP and min(lsum[2], rsum[2]) >=
                  p.min_data_in_leaf,
                  f"iteration {it} node {q}: the card's split has gain "
                  f"{gain:.7g} on the CPU, its best is {best:.7g} (gap "
                  f"{gap:.2e} of the leaf's rounding scale)")
        if b.obj.renew_quantile is not None:
            leaf = torch.from_numpy(np.argmax(
                seen & (tree.feature < 0)[:, None], axis=0))
            rv, rc = GT.renew_leaf_values(leaf, yt - raw, w, torch.ones(
                n, dtype=torch.bool), tree.n_nodes, b.obj.renew_quantile)
            for q in np.flatnonzero((tree.feature < 0) & (rc.numpy() > 0)):
                worst_val = max(worst_val, value_err(tree.value[q], rv[q]))
        raw = raw + torch.from_numpy(tree.value)[torch.from_numpy(
            np.argmax(seen & (tree.feature < 0)[:, None], axis=0))]
    check(worst_val <= 1.0, f"a card leaf value is off by {worst_val:.3f} of "
                            f"its limit, 1e-4 x |CPU value| + 1e-6")
    return {"replay_worst_gap": worst_gap, "replay_worst_value": worst_val}


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


def bench_cell(name, cell, card_line) -> dict:
    """A bench config on the card against the same fit on the CPU: fit
    seconds as bench.py times them (a warm fit, then the median of 3)."""
    X, y, p, kw = cell()
    per_fit = p.num_iterations * 1 * p.num_leaves
    card, _ = fit_counted(p, X, y, kw, per_fit)
    secs = [fit_counted(p, X, y, kw, per_fit)[1] for _ in range(3)]
    t0 = time.perf_counter()
    cpu = Booster.train(p, X, y, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    same = same_trees(card, cpu, GBDT_SAME_ITERS)
    if "first_part" in same:
        # its K9 launches compare the card with the CPU: not the path's
        counted = CH.LAUNCHES["gbdt_histogram"]
        same["parting"] = parting_cause(card, X, y, same["first_part"])
        CH.LAUNCHES["gbdt_histogram"] = counted
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
    print(f"[{card_line}] {name}: fit {out['fit_s_median']:.3f} s median of "
          f"3 (best {out['fit_s_best']:.3f}), CPU {cpu_s:.2f} s; "
          f"train {'pinball' if name == 'gbdt_quantile' else 'AUC'} card "
          f"{m_card:.6f} CPU {m_cpu:.6f}; first {same['equal_iters']} "
          f"iterations equal; CPU replay of every split: worst gap "
          f"{replay['replay_worst_gap']:.2e} of its rounding scale, leaf values "
          f"{replay['replay_worst_value']:.3f} of their limit; predict card "
          f"vs CPU {pdiff:.2e}; "
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
    """The Higgs-shape cell: a warm 2-iteration fit, then two 10-iteration
    fits that must give identical trees, a falling train loss, the fused
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


def k8_errors(gen, b, s, dtype, case, causal, sk=None, d=None) -> dict:
    """K8's three kernels against their plain versions on the same
    inputs (Sk and Dh default to S and the bench's 64). The forward's m
    is compared on rows that see a key; a row that sees none must give
    l = 0, o = 0, m = -1e30 and dq = 0 exactly, and a launch in which no
    row sees a key also dk = dv = 0 exactly."""
    sk, d = s if sk is None else sk, CFG.d_head if d is None else d
    h = CFG.n_heads
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


def main() -> None:
    card_line = card()
    print(card_line)
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

    params = T.params_from_jax(T.init_params_np(CFG, seed=SEED), DEV)
    replies, launches, metrics = main_path(params, pre, payloads,
                                           card_line)
    metrics.update(step_profile(params, payloads, card_line))
    engine_parity(params, payloads, replies)

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
    records.update(train_kernel_phase())
    ce_times = ce_engine_times()
    parity, parity_launches = train_parity()
    train_launches, train_metrics = train_path(card_line)
    train_metrics.update(parity)
    train_metrics["ce_engine_ms"] = ce_times
    train_metrics["wgmma_bf16_build"] = wgmma_facts
    train_metrics["cuda_core_and_tf32_build"] = core_facts
    records.update(histogram_phase())
    gbdt_launches, gbdt_metrics = gbdt_path(card_line)
    records.update(k8_phase())
    ring_metrics, ring_parity_launches = ring_parity()
    ring_launches, path_metrics = ring_path(card_line)
    ring_metrics.update(path_metrics)
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
                   "f32 ring parity": ring_parity_launches[counted]}
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


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        ab_kernels(sys.argv[2])
    else:
        main()
