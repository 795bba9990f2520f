#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mmlspark_tpu_torch``) on one H100.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``); it imports
nothing of JAX or of the JAX package. Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the attention kernels from ``mmlspark_tpu_torch/csrc`` (nvcc,
   ``sm_90a``) and print the build seconds and register use;
3. hold K1/K2/K3 against their plain PyTorch versions at the slice's
   full-width shapes (max abs error <= 1e-4, f32) and time the kernel,
   the plain version and, for K2, ``scaled_dot_product_attention``
   (cold L2: a 256 MiB write between launches);
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
7. print decode tokens/s, TTFT, the decode metrics' and the kernels'
   JSON lines and, last, ``{"ok": true, "device": {...}}``.

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
from mmlspark_tpu_torch.parallel import cuda_attention as CA  # noqa: E402
from mmlspark_tpu_torch.parallel.sharding import bucket_target  # noqa: E402
from mmlspark_tpu_torch.serving.decode import (  # noqa: E402
    DecodeScheduler, TransformerDecoder,
)

SEED = 0
# bench.py's transformer LM width (the SPMD train bench), decoded in f32
CFG = T.TransformerConfig(vocab=32768, d_model=512, n_heads=8, d_head=64,
                          d_ff=2048, n_stages=1, layers_per_stage=8)
N_SLOTS, MAX_LEN, PAGE = 8, 1024, 16
PPS = MAX_LEN // PAGE
PREAMBLE, MAX_NEW = 256, 48
KERNEL_TOL = 1e-4      # f32 kernel vs plain: reassociation only
ENGINE_TOL = 1e-3      # whole-model logits, cuda vs dense engine
# H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

DEV = torch.device("cuda")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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


def kernel_phase(plan) -> dict:
    """Correctness at many shapes, timing at the main path's shapes
    (``plan``: K1 positions, K2 prompt bucket, K3 hit depth + suffix
    bucket). Returns per-kernel records for the JSON line."""
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
                                   "pallas_attention.py:1078"),
        "flash_prefill_attention": ("k2", k2_case(gen, plan["k2_s"]),
                                    f"B=1 S={plan['k2_s']} H=8 Dh=64",
                                    "flash_prefill_attention.cu",
                                    "pallas_attention.py:1156"),
        "paged_prefix_prefill_attention": (
            "k3", k3_case(gen, plan["k3_hit"], plan["k3_s"]),
            f"hit_len={plan['k3_hit']} S={plan['k3_s']} H=8 Dh=64 "
            f"page=16 pps={PPS}", "paged_prefix_prefill_attention.cu",
            "pallas_attention.py:1231"),
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
            "replaces": f"mmlspark_tpu/parallel/{tpu}",
            "launches": 0, "max_abs_err": worst[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "shape": shape}
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
            "k3_hit": hit0, "k3_s": bucket_target(len0 - hit0, MAX_LEN)}


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
        CA.reset_launch_counts()
        r1, wall1 = serve(sched, payloads, "pass1")
        hits_1 = sched.prefix.stats()["hits"]
        r2, wall2 = serve(sched, payloads, "pass2")
        _, ttft_cold = serve(sched, [cold_probe], "cold")
        _, ttft_warm = serve(sched, [warm_probe], "warm")
        torch.cuda.synchronize()
        launches = dict(CA.LAUNCHES)
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
            "paged_prefix_prefill_attention": CFG.n_layers * pstats["hits"]}
    for name, n in want.items():
        check(launches[name] > 0, f"{name} never launched")
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


def step_profile(params, payloads, card_line, n_steps: int = 8) -> dict:
    """Where a full-batch decode step's time goes: ``torch.profiler``
    over ``n_steps`` steps of 8 live slots (positions as on the main
    path), device time by kernel against the host wall clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dec = TransformerDecoder(params, CFG, n_slots=N_SLOTS, max_len=MAX_LEN,
                             page_size=PAGE)
    tables = 1 + np.arange(N_SLOTS * PPS, dtype=np.int32).reshape(
        N_SLOTS, PPS)
    pos = np.array([len(p["prompt"]) + MAX_NEW // 2 for p in payloads],
                   np.int32)
    toks = np.ones(N_SLOTS, np.int32)
    for _ in range(3):
        dec.step_logits(toks, pos, tables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        dec.step_logits(toks, pos, tables)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            dec.step_logits(toks, pos, tables)
        torch.cuda.synchronize()
    # device-side rows only (kernels, copies): host ops would count their
    # kernels twice
    rows = [(e.key, e.device_time_total / 1e3 / n_steps,
             e.count // n_steps) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    dev_ms = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    print(f"[{card_line}] decode step (8 slots, pos ~{int(pos.mean())}): "
          f"wall {wall_ms:.3f} ms, device busy {dev_ms:.3f} ms "
          f"({100 * dev_ms / wall_ms:.1f}% of wall)")
    for key, ms, count in rows[:10]:
        print(f"  {ms:8.4f} ms  x{count:<4d} {key[:90]}")
    return {"step_wall_ms": wall_ms, "step_device_ms": dev_ms,
            "top": [(k[:60], ms) for k, ms, _ in rows[:6]]}


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
    for name, n in launches.items():
        records[name]["launches"] = n
    metrics.update(step_profile(params, payloads, card_line))
    engine_parity(params, payloads, replies)

    print(card_line)
    print(json.dumps({"decode": metrics, "card": card_line}))
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
