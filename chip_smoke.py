#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mmlspark_tpu_torch``) on one H100.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``); it imports
nothing of JAX or of the JAX package. Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the attention kernels from ``mmlspark_tpu_torch/csrc`` (nvcc,
   ``sm_90a``) and print the build seconds and register use;
3. hold K1/K2/K3/K4 against their plain PyTorch versions at the
   slices' full-width shapes (max abs error <= 1e-4, f32; K4 at T in
   {1, 7, 24, 100} x V in {32768, 32000} with labels that match no
   column) and time the kernel, the plain version and the library call
   where one computes the same function: ``scaled_dot_product_attention``
   for K2, ``h @ w`` then ``cross_entropy`` (two calls) for K4 (cold L2:
   a 256 MiB write between launches);
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
   time, device busy time and the top kernels by device time;
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
9. print decode tokens/s, TTFT, acceptance, the decode metrics' and
   the kernels' JSON lines and, last, ``{"ok": true, "device": {...}}``.

Any failed check raises: a nonzero exit and no ``ok`` line. Without
CUDA it exits nonzero before printing any result.
"""

from __future__ import annotations

import json
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
from mmlspark_tpu_torch.models import transformer as T  # noqa: E402
from mmlspark_tpu_torch.ops import fused_ce as FC  # noqa: E402
from mmlspark_tpu_torch.parallel import cuda_attention as CA  # noqa: E402
from mmlspark_tpu_torch.parallel.sharding import bucket_target  # noqa: E402
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
# H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

DEV = torch.device("cuda")

#: the PyTorch call timed as each kernel's ``library_ms`` (never used by
#: the port)
LIBRARY_CALL = {
    "flash_prefill_attention": "scaled_dot_product_attention(is_causal)",
    "fused_softmax_xent": "h @ w, then cross_entropy(reduction='none') "
                          "(two calls)"}


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


def read_launch_counts() -> dict:
    return {**CA.LAUNCHES, **FC.LAUNCHES}


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


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
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


def k1_case(gen, pos):
    h, d = CFG.n_heads, CFG.d_head
    n = len(pos)
    n_pages = 1 + n * PPS
    kp, vp = rnd(gen, n_pages, PAGE, h, d), rnd(gen, n_pages, PAGE, h, d)
    q = rnd(gen, n, h, d)
    tables = (1 + torch.randperm(n * PPS, generator=gen)).reshape(
        n, PPS).to(torch.int32).to(DEV)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
    args = (q, kp, vp, tables, pos_t, d ** -0.5, PAGE)
    kern = lambda: CA.paged_decode_attention(*args)  # noqa: E731
    plain = lambda: CA.paged_decode_attention_plain(*args)  # noqa: E731
    rows = sum(p + 1 for p in pos)
    nbytes = 4 * (2 * n * h * d + 2 * rows * h * d) + 4 * n * (PPS + 1)
    flops = 4 * rows * h * d
    return kern, plain, None, nbytes, flops


def k2_case(gen, s):
    h, d = CFG.n_heads, CFG.d_head
    q, k, v = (rnd(gen, 1, s, h, d) for _ in range(3))
    kern = lambda: CA.flash_prefill_attention(q, k, v)  # noqa: E731
    plain = lambda: CA.flash_prefill_attention_plain(q, k, v)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        qt, kt, vt, is_causal=True)
    nbytes = 4 * 4 * s * h * d
    flops = 4 * h * d * s * (s + 1) // 2
    return kern, plain, lib, nbytes, flops


def k3_case(gen, hit, s):
    h, d = CFG.n_heads, CFG.d_head
    n_pages = 1 + PPS
    kp, vp = rnd(gen, n_pages, PAGE, h, d), rnd(gen, n_pages, PAGE, h, d)
    q = rnd(gen, s, h, d)
    table = (1 + torch.randperm(PPS, generator=gen)).to(torch.int32).to(DEV)
    args = (q, kp, vp, table, hit, d ** -0.5, PAGE)
    kern = lambda: CA.paged_prefix_prefill_attention(*args)  # noqa: E731
    plain = lambda: CA.paged_prefix_prefill_attention_plain(*args)  # noqa
    lane = PPS * PAGE
    keys = min(lane, hit + s)
    seen = sum(min(lane, hit + r + 1) for r in range(s))
    nbytes = 4 * (2 * s * h * d + 2 * keys * h * d) + 4 * PPS
    flops = 4 * seen * h * d
    return kern, plain, None, nbytes, flops


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
    for pos in ([0, 1, 15, 16, 300, 511, 1000, 1023], plan["k1_pos"]):
        e = max_err(*k1_case(gen, pos)[:2])
        worst["k1"] = max(worst.get("k1", 0.0), e)
        print(f"K1 pos={pos} max_abs_err={e:.3e}")
    for s in sorted({1, 17, 128, 1024, plan["k2_s"]}):
        e = max_err(*k2_case(gen, s)[:2])
        worst["k2"] = max(worst.get("k2", 0.0), e)
        print(f"K2 S={s} max_abs_err={e:.3e}")
    for hit, s in sorted({(0, 16), (16, 5), (256, 64), (512, 33),
                          (1008, 64), (plan["k3_hit"], plan["k3_s"])}):
        e = max_err(*k3_case(gen, hit, s)[:2])
        worst["k3"] = max(worst.get("k3", 0.0), e)
        print(f"K3 hit_len={hit} S={s} max_abs_err={e:.3e}")
    for t in (1, 7, 24, 100):
        for v in (CFG.vocab, 32000):
            e = max_err(*k4_case(gen, t, v, miss_label=True)[:2])
            worst["k4"] = max(worst.get("k4", 0.0), e)
            print(f"K4 T={t} D={CFG.d_model} V={v} max_abs_err={e:.3e}")
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
    records = {}
    for name, (key, (kern, plain, lib, nbytes, flops), shape, src,
               tpu) in timed.items():
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        lib_ms = time_ms(lib) if lib is not None else None
        b_ms, b_by = bound(nbytes, flops)
        records[name] = {
            "name": name, "route": "cuda",
            "source": f"mmlspark_tpu_torch/csrc/{src}",
            "replaces": f"mmlspark_tpu/{tpu}",
            "launches": 0, "max_abs_err": worst[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "shape": shape,
            "library": LIBRARY_CALL.get(name)}
        print(f"{name} [{shape}]: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
              f"bound {b_ms:.4f} ms ({b_by})")
    return records


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
            "fused_softmax_xent": 0}     # no draft, no verify
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


def device_profile(run, n: int, label: str, card_line: str) -> dict:
    """Where ``run()``'s time goes: the host wall clock over ``n`` calls
    (after 3 warm ones), then ``torch.profiler`` over ``n`` more: device
    time by kernel."""
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
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "top": [(k[:60], ms) for k, ms, _ in rows[:6]]}


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
                         card_line)
    return {"step_wall_ms": got["wall_ms"],
            "step_device_ms": got["device_ms"], "top": got["top"]}


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
            "fused_softmax_xent": spec["rounds"]}
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
    # K1-K3 launches from slice 1's paged path, K4 from the speculative
    # path; both paths' counts stay beside them
    for name, rec in records.items():
        rec["launches"] = (spec_launches[name] if name == "fused_softmax_xent"
                           else launches[name])
        rec["launches_by_path"] = {"paged": launches[name],
                                   "speculative": spec_launches[name]}

    print(card_line)
    print(json.dumps({"decode": metrics, "card": card_line}))
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
