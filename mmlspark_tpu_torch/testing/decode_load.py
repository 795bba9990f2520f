"""Decode-serving load harness: continuous against static whole-batch.

The port of ``mmlspark_tpu/testing/decode_load.py``, over the port's
:class:`~mmlspark_tpu_torch.serving.decode.TransformerDecoder` and
:class:`~mmlspark_tpu_torch.serving.decode.DecodeScheduler`. Both
disciplines drive the SAME decoder (the same prefill and step, the same
KV pool) over the same seeded workload of requests arriving at
staggered wall-clock offsets; only the batching differs:

* **continuous**: arrived requests claim free slots between steps,
  finished requests release them mid-batch, the fixed-shape step runs
  whenever any slot is live;
* **static**: the arrived requests form one batch, decoded until its
  longest member finishes (early finishers ride along as padding), and
  only then is the next group admitted.

Evidence beside tokens/s: the compile count's change (0: the port runs
eagerly, and its decoder reports 0, as ``/decode/stats`` does), the KV
pool's ``data_ptr`` across steps (the pool is written in place), and the
card's live allocations over the steady state
(``torch.cuda.memory_stats()["active.all.current"]``, where JAX counts
``jax.live_arrays()``; ``None`` on the CPU, which keeps no such count).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.models import transformer as T


@dataclass
class DecodeJob:
    arrival_s: float          # offset from window start
    prompt: np.ndarray
    max_new: int
    # filled by the runs
    t_done: float = 0.0
    n_tokens: int = 0


def make_workload(vocab: int, n_requests: int, seed: int = 0,
                  mean_gap_ms: float = 30.0,
                  prompt_lens=(3, 5, 8, 12),
                  max_new=(8, 16, 24),
                  prefix_share: float = 0.0,
                  prefix_len: int = 16,
                  prefix_pool: int = 2) -> List[DecodeJob]:
    """Seeded mixed-arrival workload, the reference's draws in its order:
    exponential inter-arrival gaps, cycled prompt lengths and token
    budgets, so requests join and leave mid-flight.

    ``prefix_share`` of the requests take their first ``prefix_len``
    tokens from a pool of ``prefix_pool`` shared prefixes (then a unique
    suffix); the rest get a unique random prefix of the same length, so
    both arms of a prefix-cache A/B see the same prompt lengths. The
    shared pool is drawn only when ``prefix_share > 0``: a workload
    without it keeps the same prompt stream at the same seed."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(mean_gap_ms / 1000.0, size=n_requests)
    arrivals = np.cumsum(gaps)
    shared = ([rng.integers(0, vocab, size=int(prefix_len))
               .astype(np.int32) for _ in range(max(prefix_pool, 1))]
              if prefix_share > 0.0 else [])
    jobs = []
    for i in range(n_requests):
        plen = prompt_lens[i % len(prompt_lens)]
        if prefix_share > 0.0:
            head = (shared[i % len(shared)]
                    if rng.random() < prefix_share
                    else rng.integers(0, vocab, size=int(prefix_len))
                    .astype(np.int32))
            prompt = np.concatenate(
                [head, rng.integers(0, vocab, size=plen)
                 .astype(np.int32)])
        else:
            prompt = rng.integers(0, vocab,
                                  size=plen).astype(np.int32)
        jobs.append(DecodeJob(
            arrival_s=float(arrivals[i]),
            prompt=prompt,
            max_new=int(max_new[i % len(max_new)])))
    return jobs


def _reset_jobs(jobs: List[DecodeJob]) -> None:
    for j in jobs:
        j.t_done = 0.0
        j.n_tokens = 0


def _pool_ptr(decoder) -> int:
    """Where the decoder's KV pool lives (its ``k`` tensor's address)."""
    return decoder.cache["k"].data_ptr()


def _live_allocations(decoder) -> Optional[int]:
    """The card's live allocation count on the decoder's device, or None
    off the card."""
    if decoder.device.type != "cuda":
        return None
    return torch.cuda.memory_stats(decoder.device)["active.all.current"]


def run_continuous(decoder, jobs: List[DecodeJob]) -> Dict[str, Any]:
    """The slot-level discipline, inline (no HTTP, no threads: the
    engine's own ceiling). Returns tokens/s and the pool and allocation
    evidence."""
    _reset_jobs(jobs)
    compiles_before = decoder.n_compiles()
    n_slots = decoder.n_slots
    tokens = np.zeros(n_slots, np.int32)
    pos = np.zeros(n_slots, np.int32)
    free = list(range(n_slots))
    active: Dict[int, DecodeJob] = {}
    queue = sorted(jobs, key=lambda j: j.arrival_s)
    total_tokens = 0
    ptr0 = _pool_ptr(decoder)
    live_counts: List[Optional[int]] = []
    t0 = time.perf_counter()
    while queue or active:
        now = time.perf_counter() - t0
        while queue and free and queue[0].arrival_s <= now:
            job = queue.pop(0)
            slot = free.pop()
            first = decoder.prefill(slot, job.prompt)
            job.n_tokens = 1
            total_tokens += 1
            tokens[slot] = first
            pos[slot] = len(job.prompt)
            active[slot] = job
            if job.n_tokens >= job.max_new:       # 1-token budgets
                job.t_done = time.perf_counter() - t0
                del active[slot]
                free.append(slot)
        if not active:
            if queue:
                time.sleep(max(min(queue[0].arrival_s - now, 0.002),
                               0.0))
            continue
        out = decoder.step(tokens, pos)
        live_counts.append(_live_allocations(decoder))
        for slot, job in list(active.items()):
            tok = int(out[slot])
            job.n_tokens += 1
            total_tokens += 1
            pos[slot] += 1
            tokens[slot] = tok
            if job.n_tokens >= job.max_new or \
                    int(pos[slot]) >= decoder.max_len - 1:
                job.t_done = time.perf_counter() - t0
                tokens[slot] = 0
                pos[slot] = 0
                del active[slot]
                free.append(slot)
    makespan = time.perf_counter() - t0
    half = len(live_counts) // 2
    if live_counts and live_counts[0] is None:
        growth = None
    else:
        growth = ((max(live_counts[half:]) - live_counts[0])
                  if half > 0 else 0)
    return {
        "mode": "continuous",
        "tokens": total_tokens,
        "makespan_s": round(makespan, 4),
        "tokens_per_s": round(total_tokens / makespan, 1),
        "mean_done_s": round(float(np.mean([j.t_done for j in jobs])),
                             4),
        "post_warmup_recompiles":
            decoder.n_compiles() - compiles_before,
        # the pool's storage never moved: every step wrote it in place
        "cache_buffer_stable": _pool_ptr(decoder) == ptr0,
        # steady-state allocation growth (the second half's peak against
        # the first sample): 0 = the warm loop keeps nothing alive
        "live_array_growth": growth,
    }


def run_static(decoder, jobs: List[DecodeJob]) -> Dict[str, Any]:
    """The whole-batch baseline: group the arrived requests, decode
    the whole group to its LONGEST member's budget, admit the next
    group only when the batch fully drains."""
    _reset_jobs(jobs)
    compiles_before = decoder.n_compiles()
    n_slots = decoder.n_slots
    tokens = np.zeros(n_slots, np.int32)
    pos = np.zeros(n_slots, np.int32)
    queue = sorted(jobs, key=lambda j: j.arrival_s)
    total_tokens = 0
    t0 = time.perf_counter()
    while queue:
        now = time.perf_counter() - t0
        if queue[0].arrival_s > now:
            time.sleep(min(queue[0].arrival_s - now, 0.002))
            continue
        batch: List[DecodeJob] = []
        while queue and len(batch) < n_slots and \
                queue[0].arrival_s <= time.perf_counter() - t0:
            batch.append(queue.pop(0))
        for slot, job in enumerate(batch):
            first = decoder.prefill(slot, job.prompt)
            job.n_tokens = 1
            total_tokens += 1
            tokens[slot] = first
            pos[slot] = len(job.prompt)
        # the whole batch runs to its longest member; early finishers
        # ride along as padding (their extra tokens are discarded)
        remaining = {slot: job for slot, job in enumerate(batch)
                     if job.n_tokens < job.max_new}
        for job in batch:
            if job.n_tokens >= job.max_new:
                job.t_done = time.perf_counter() - t0
        while remaining:
            out = decoder.step(tokens, pos)
            for slot, job in list(remaining.items()):
                job.n_tokens += 1
                total_tokens += 1
                pos[slot] += 1
                tokens[slot] = int(out[slot])
                if job.n_tokens >= job.max_new or \
                        int(pos[slot]) >= decoder.max_len - 1:
                    job.t_done = time.perf_counter() - t0
                    del remaining[slot]
        tokens[:] = 0
        pos[:] = 0
    makespan = time.perf_counter() - t0
    return {
        "mode": "static",
        "tokens": total_tokens,
        "makespan_s": round(makespan, 4),
        "tokens_per_s": round(total_tokens / makespan, 1),
        "mean_done_s": round(float(np.mean([j.t_done for j in jobs])),
                             4),
        "post_warmup_recompiles":
            decoder.n_compiles() - compiles_before,
    }


# ---------------------------------------------------------------------------
# scheduler-level session harness (paged + speculative A/B)
# ---------------------------------------------------------------------------


class _BenchPending:
    """The slice of a pending request a standalone DecodeScheduler
    touches (the same shim the direct-scheduler tests use)."""

    def __init__(self, payload, rid):
        self.payload = payload
        self.rid = rid
        self.deadline = None
        self.event = threading.Event()
        self.callbacks: list = []
        self.reply = None
        self.status = 200
        self.span = None
        self.trace = rid
        self.stream = None


def make_spec_model_pair(cfg: T.TransformerConfig, draft_layers: int = 1,
                         resid_scale: float = 0.05, seed: int = 0,
                         params: Optional[dict] = None):
    """A (target params, draft params, draft cfg) triple whose
    truncated-layer draft AGREES with the target at trained-pair rates.

    ``params`` is a tree in the ``init_params`` layout (numpy arrays, a
    JAX tree carried across as numpy, or the port's tensors); without
    it, :func:`~mmlspark_tpu_torch.models.transformer.init_params_np`
    draws one from ``seed``. Randomly initialized blocks drown the
    embedding stream in residual noise, so an early exit's argmax is
    uncorrelated with the full model's (about 0.1 acceptance). Scaling
    each block's output projections ``wo`` and ``w2`` by
    ``resid_scale`` restores the trained regime, where the residual
    refines rather than replaces the stream. The draft is
    :func:`~mmlspark_tpu_torch.models.transformer.layer_truncated_draft`
    of the scaled tree: its leaves are the target's objects."""
    if params is None:
        params = T.init_params_np(cfg, seed=seed)
    params = dict(params)
    params["blocks"] = [dict(b) for b in params["blocks"]]
    for b in params["blocks"]:
        b["wo"] = b["wo"] * resid_scale
        b["w2"] = b["w2"] * resid_scale
    draft_params, draft_cfg = T.layer_truncated_draft(params, cfg,
                                                      draft_layers)
    return params, draft_params, draft_cfg


def run_scheduler_sessions(scheduler, jobs: List[DecodeJob],
                           timeout_s: float = 300.0,
                           payload_extra: Optional[Dict[str, Any]]
                           = None,
                           rid_prefix: str = "bench"
                           ) -> Dict[str, Any]:
    """Drive a live :class:`DecodeScheduler` with the whole workload
    (every request queued up front, so concurrency is bounded by slots
    and pages, not arrival gaps) and collect the sessions-at-fixed-memory
    evidence: peak concurrent sessions, tokens/s, prefill tokens/s (the
    prefix-cache A/B metric), each request's tokens (the cross-layout
    parity probe), the compile count's change and the pool's address.
    ``payload_extra`` merges into every request's payload (sampling
    knobs for the seeded-parity probes)."""
    compiles_before = scheduler.decoder.n_compiles()
    prefill_s0 = scheduler.prefill_s
    prompt_tokens0 = scheduler.n_prompt_tokens
    prefills0 = scheduler.n_prefills
    ptr0 = _pool_ptr(scheduler.decoder)
    pendings = [_BenchPending(
        dict({"prompt": [int(t) for t in j.prompt],
              "max_new_tokens": int(j.max_new)},
             **(payload_extra or {})), f"{rid_prefix}-{i}")
        for i, j in enumerate(jobs)]
    t0 = time.perf_counter()
    for p in pendings:
        scheduler.submit(p)
    errors = 0
    sequences: List[List[int]] = []
    for p in pendings:
        if not p.event.wait(timeout_s):
            raise RuntimeError("bench request stranded")
        if p.status != 200:
            errors += 1
            sequences.append([])
        else:
            sequences.append(json.loads(p.reply)["tokens"])
    makespan = time.perf_counter() - t0
    total = sum(len(s) for s in sequences)
    out = {
        "n_requests": len(jobs),
        "tokens": total,
        "makespan_s": round(makespan, 4),
        "tokens_per_s": round(total / makespan, 1),
        "errors": errors,
        "sequences": sequences,
        "peak_concurrent_sessions": scheduler.slots_high_water,
        "post_warmup_recompiles":
            scheduler.decoder.n_compiles() - compiles_before,
        "cache_buffer_stable": _pool_ptr(scheduler.decoder) == ptr0,
        "slots_all_freed":
            scheduler.pool.n_free == scheduler.decoder.n_slots,
    }
    d_wall = scheduler.prefill_s - prefill_s0
    d_tokens = scheduler.n_prompt_tokens - prompt_tokens0
    out["prefill_tokens_per_s"] = (round(d_tokens / d_wall, 1)
                                   if d_wall > 0 else None)
    out["mean_prefill_ms"] = round(1000.0 * d_wall / max(
        scheduler.n_prefills - prefills0, 1), 3)
    if scheduler.pages is not None:
        # the refcounted idle invariant: free + index-cached covers the
        # claimable pool, every cached page held exactly once
        cached = (scheduler.prefix.n_cached
                  if scheduler.prefix is not None else 0)
        out["pages_all_freed"] = (
            scheduler.pages.n_free + cached
            == scheduler.pages.n_pages - 1
            and (scheduler.prefix is None
                 or scheduler.prefix.ledger_clean()))
        out["page_high_water"] = scheduler.pages.high_water
    if scheduler.prefix is not None:
        out["prefix_cache"] = scheduler.prefix.stats()
    spec = scheduler.stats().get("speculative")
    if spec is not None:
        out["acceptance_rate"] = spec["acceptance_rate"]
        out["spec_rounds"] = spec["rounds"]
    return out
