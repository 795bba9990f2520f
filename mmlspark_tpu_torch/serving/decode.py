"""Continuous batching for autoregressive decode, in PyTorch.

The port of ``mmlspark_tpu/serving/decode.py`` for paged decode with the
cross-request prefix cache and speculative decoding:

* a :class:`TransformerDecoder` owns ONE preallocated paged KV pool
  (``models/transformer.init_paged_kv_cache``) plus the prefill / prefix
  prefill / step functions built over it; the pool is updated in place,
  so its ``data_ptr`` never moves while requests churn;
* a :class:`DecodeScheduler` runs the step loop: between any two decode
  steps, waiting requests claim free slots and pages (one bucketed
  prefill each — an offset prefill of the uncached suffix when the
  :class:`PrefixCache` holds a prefix), finished requests (EOS / token
  budget / lane end / deadline / cancel / fault) release theirs, and the
  single-token step always runs over the full fixed ``[n_slots]`` batch;
* with a draft model configured, the scheduler runs speculative rounds
  instead of single steps: the draft proposes ``spec_k`` tokens per slot
  (chained greedy steps on the device), one width-``spec_k`` verify of
  the target scores them all (its proposal log-probs through K4 on the
  card), and each slot accepts its longest agreeing prefix — exact argmax
  match for greedy slots, Leviathan rejection sampling for sampled
  opt-ins — gated by :class:`~mmlspark_tpu_torch.serving.policy.
  SpeculationPolicy`.

The host-side pieces (:class:`Sampler`, :class:`SlotPool`,
:class:`PagePool`, :class:`PrefixCache`, the scheduler's admission and
release rules) are the JAX package's, unchanged: seeded sampling draws
from a per-request numpy PRNG, so equal logits give equal tokens.

Not ported yet (ROADMAP.md): the dense slot-lane pool for the target
(``paged=False``), MoE and int8 decode, tensor-parallel ``mesh=``, and
the metrics/``bind()`` wiring and token timelines of the HTTP stack. The
scheduler's ``tracer`` and ``fault_plan`` hooks are duck-typed and
``None`` by default.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.environment import DeviceLike, resolve_device
from mmlspark_tpu_torch.core.logs import get_logger
from mmlspark_tpu_torch.core.resilience import SYSTEM_CLOCK, Clock
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.parallel.sharding import bucket_ladder, bucket_target
from mmlspark_tpu_torch.serving.policy import SpeculationPolicy
from mmlspark_tpu_torch.serving.tenancy import (
    ANONYMOUS_ID, FairCycle, ReleaseRateEwma,
)

logger = get_logger("serving.decode")


class DecodeOverloaded(RuntimeError):
    """The waiting queue is full: new decode work must shed (429)."""


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class TransformerDecoder:
    """The model side of continuous batching: one paged KV pool + the
    prefill/step functions over it, with host-side bookkeeping.

    Not thread-safe by design — exactly one :class:`DecodeScheduler`
    loop thread drives it (the pool is updated in place). ``eos_id`` is
    the stop token (None = never stops early).

    The pool is a block-table layout: ``n_pages`` shared pages of
    ``page_size`` rows (page 0 is scratch) plus per-slot page tables.
    ``n_pages`` defaults to the dense equivalent (every slot can hold a
    full lane). Callers without a scheduler may omit page tables: an
    identity table (slot ``s`` -> pages ``[1 + s*pps, 1 + (s+1)*pps)``)
    stands in, which needs the full-size default pool.

    ``device=None`` runs on the card and raises without CUDA;
    ``device="cpu"`` is the only way onto the CPU. ``attn_impl``:
    ``"auto"`` resolves by device — ``"cuda"`` (the Hopper kernels) on
    the card, ``"dense"`` (the plain PyTorch attention) on the CPU;
    ``"cuda"`` on a CPU decoder raises.

    **Speculative decoding** (``draft_params``/``draft_cfg``): a small
    draft model with the target's vocab (e.g.
    :func:`~mmlspark_tpu_torch.models.transformer.layer_truncated_draft`)
    proposes ``spec_k`` greedy tokens per slot with the argmax kept on
    the device, and a width-``spec_k`` verify of the target scores them
    all at once. The draft keeps a dense slot-lane pool of its own (its
    layers are the cheap fraction; the target's paged pool is where the
    memory lives) and prefills with the decoder's ``attn_impl``, so on
    the card its prefill runs K2 as well. ``verify_ce_impl`` picks the
    verify's score engine: ``None`` resolves ``cfg.ce_impl`` through
    :func:`~mmlspark_tpu_torch.models.transformer.verify_ce_engine` —
    ``"cuda"`` (K4) on the card, ``"dense"`` on the CPU; ``"cuda"`` on a
    CPU decoder raises. A draft tree that aliases the target's leaves
    shares the target's tensors."""

    def __init__(self, params, cfg, n_slots: int = 8,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 draft_params=None, draft_cfg=None, spec_k: int = 4,
                 attn_impl: str = "auto",
                 verify_ce_impl: Optional[str] = None,
                 prefix_cache: bool = True,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.eos_id = eos_id
        if attn_impl == "auto":
            attn_impl = "cuda" if self.device.type == "cuda" else "dense"
        if attn_impl not in T.ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        if attn_impl == "cuda" and self.device.type != "cuda":
            raise ValueError("attn_impl='cuda' runs the Hopper kernels and "
                             "needs a CUDA device; the CPU takes 'dense'")
        self.attn_impl = attn_impl
        memo: dict = {}    # shared with the draft: aliased leaves stay so
        self.params = T.params_from_jax(params, self.device, memo)
        page_size = int(page_size)
        if page_size < 1 or page_size & (page_size - 1):
            # prompt buckets are powers of two: a pow2 page divides every
            # bucket >= itself (whole-chunk scatters) and bounds the rest
            # to the partial-page path
            raise ValueError(
                f"page_size={page_size} must be a power of two")
        if self.max_len % page_size:
            raise ValueError(f"page_size={page_size} must divide "
                             f"max_len={self.max_len}")
        self.page_size = page_size
        self.pages_per_slot = self.max_len // self.page_size
        self.n_pages = (int(n_pages) if n_pages is not None
                        else 1 + self.n_slots * self.pages_per_slot)
        if self.n_pages < 2:
            raise ValueError("paged cache needs n_pages >= 2 "
                             "(page 0 is the scratch page)")
        self.cache = T.init_paged_kv_cache(cfg, self.n_pages,
                                           self.page_size, self.device)
        self._prefill = T.build_paged_prefill(
            cfg, self.page_size, self.pages_per_slot, attn_impl=attn_impl)
        self._step = T.build_paged_decode_step(
            cfg, self.n_slots, self.page_size, self.pages_per_slot,
            attn_impl=attn_impl)
        # the prefix cache's compute half: the offset prefill of the
        # uncached suffix (prefix_cache=False is the A/B baseline)
        self._prefix_prefill = (
            T.build_paged_prefix_prefill(cfg, self.page_size,
                                         self.pages_per_slot,
                                         attn_impl=attn_impl)
            if prefix_cache else None)
        if 1 + self.n_slots * self.pages_per_slot <= self.n_pages:
            self._identity_tables = (
                1 + np.arange(self.n_slots * self.pages_per_slot,
                              dtype=np.int32)
            ).reshape(self.n_slots, self.pages_per_slot)
        else:
            self._identity_tables = None   # undersized on purpose:
            # tables must come from the scheduler's pool
        # -- speculative decoding (optional)
        self.spec_k = int(spec_k)
        self.draft_cfg = draft_cfg
        self.draft_params = self.draft_cache = None
        self._draft_prefill = self._draft_step = None
        self._propose = self._verify = None
        self.verify_ce_impl: Optional[str] = None
        if draft_params is not None:
            if draft_cfg is None:
                raise ValueError("draft_params needs draft_cfg")
            if draft_cfg.vocab != cfg.vocab:
                raise ValueError("draft and target must share a vocab")
            if not 2 <= self.spec_k < self.max_len:
                raise ValueError(f"spec_k={spec_k} must be in "
                                 f"[2, max_len)")
            ce_impl = (verify_ce_impl if verify_ce_impl is not None
                       else T.verify_ce_engine(cfg, self.n_slots,
                                               self.spec_k,
                                               device=self.device))
            if ce_impl not in T.CE_IMPLS:
                raise ValueError(f"unknown verify_ce_impl {ce_impl!r}")
            if ce_impl == "cuda" and self.device.type != "cuda":
                raise ValueError("verify_ce_impl='cuda' runs the Hopper "
                                 "kernel K4 and needs a CUDA device; the "
                                 "CPU takes 'dense'")
            self.verify_ce_impl = ce_impl
            self.draft_params = T.params_from_jax(draft_params,
                                                  self.device, memo)
            self.draft_cache = T.init_kv_cache(draft_cfg, self.n_slots,
                                               self.max_len, self.device)
            self._draft_prefill = T.build_prefill(draft_cfg,
                                                  attn_impl=attn_impl)
            self._draft_step = T.build_decode_step(
                draft_cfg, self.n_slots, self.max_len)
            self._propose = T.build_draft_propose(
                draft_cfg, self.n_slots, self.max_len, self.spec_k)
            self._verify = T.build_paged_verify_step(
                cfg, self.n_slots, self.spec_k, self.page_size,
                self.pages_per_slot, with_scores=True, ce_impl=ce_impl)

    @property
    def has_draft(self) -> bool:
        return self._verify is not None

    @property
    def has_prefix_prefill(self) -> bool:
        return self._prefix_prefill is not None

    def placement(self) -> Dict[str, Any]:
        return {"mode": "single_device", "n_devices": 1,
                "device": str(self.device)}

    def pool_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.cache.values())

    # -- shapes --------------------------------------------------------------

    def prompt_buckets(self) -> List[int]:
        """The prefill shape ladder: pow2 buckets clamped at
        ``max_len``."""
        return bucket_ladder(self.max_len)

    def pad_prompt(self, prompt: np.ndarray) -> np.ndarray:
        bucket = bucket_target(len(prompt), self.max_len)
        out = np.zeros(bucket, np.int32)
        out[:len(prompt)] = prompt
        return out

    # -- compute -------------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    def _table_for(self, slot: int, page_table) -> np.ndarray:
        if page_table is not None:
            table = np.asarray(page_table, np.int32)
        elif self._identity_tables is None:
            raise ValueError(
                "this paged pool is smaller than n_slots full lanes: "
                "page tables must come from the scheduler's PagePool")
        else:
            table = self._identity_tables[slot]
        return self._checked_tables(table)

    def _checked_tables(self, tables: np.ndarray) -> np.ndarray:
        # the kernels read table entries unchecked: validate on the host
        if tables.size and (tables.min() < 0
                            or tables.max() >= self.n_pages):
            raise ValueError(f"page table entries must lie in "
                             f"[0, {self.n_pages})")
        return tables

    def prefill_logits(self, slot: int, prompt: np.ndarray,
                       page_table=None, draft: bool = True
                       ) -> "tuple[int, torch.Tensor]":
        """Fill ``slot``'s claimed pages (``page_table``; identity table
        when omitted) from ``prompt``; returns the first generated greedy
        token AND the last-position logits (a device tensor — only a
        sampling caller pays the host fetch). With a draft configured,
        the draft's slot lane is prefilled too, unless ``draft=False``
        (a request that can never speculate)."""
        padded = self._dev(self.pad_prompt(prompt))
        _, nxt, logits = self._prefill(
            self.params, self.cache, padded,
            self._dev(self._table_for(slot, page_table)), len(prompt))
        if self.has_draft and draft:
            self._draft_prefill(self.draft_params, self.draft_cache,
                                padded, slot, len(prompt))
        return int(nxt), logits

    def prefill(self, slot: int, prompt: np.ndarray,
                page_table=None) -> int:
        """Greedy :meth:`prefill_logits` (compat surface)."""
        return self.prefill_logits(slot, prompt, page_table)[0]

    def prefill_prefix_logits(self, slot: int, prompt: np.ndarray,
                              hit_len: int, page_table, draft: bool = True
                              ) -> "tuple[int, torch.Tensor]":
        """Partial/offset prefill: the prompt's first ``hit_len`` tokens
        (page-aligned, ``< len(prompt)``) already live in the shared
        prefix pages at the head of ``page_table`` — compute K/V only for
        the suffix (padded to its own bucket) while attending over the
        whole virtual lane. Token-for-token :meth:`prefill_logits` (the
        shared pages ARE a previous cold prefill's rows). The draft's
        dense lane has no page plane, so the draft prefills the WHOLE
        prompt."""
        if hit_len <= 0:
            return self.prefill_logits(slot, prompt, page_table,
                                       draft=draft)
        if hit_len % self.page_size or hit_len >= len(prompt):
            raise ValueError(
                f"hit_len={hit_len} must be page-aligned and < "
                f"prompt length {len(prompt)}")
        padded = self.pad_prompt(prompt[hit_len:])
        _, nxt, logits = self._prefix_prefill(
            self.params, self.cache, self._dev(padded),
            self._dev(self._table_for(slot, page_table)), len(prompt),
            int(hit_len))
        if self.has_draft and draft:
            self._draft_prefill(self.draft_params, self.draft_cache,
                                self._dev(self.pad_prompt(prompt)), slot,
                                len(prompt))
        return int(nxt), logits

    def step_logits(self, tokens: np.ndarray, pos: np.ndarray,
                    page_tables=None) -> "tuple[np.ndarray, torch.Tensor]":
        """One token for every slot: ``tokens``/``pos`` are the full
        fixed ``[n_slots]`` arrays (free slots ride along at token 0 /
        pos 0 with an all-scratch table row). Returns greedy next tokens
        plus the full per-slot logits (device tensor; fetched only when
        a sampler needs it)."""
        if page_tables is None:
            if self._identity_tables is None:
                raise ValueError("undersized paged pool needs "
                                 "scheduler page tables")
            page_tables = self._identity_tables
        tables = self._checked_tables(np.asarray(page_tables, np.int32))
        _, nxt, logits = self._step(self.params, self.cache,
                                    self._dev(tokens), self._dev(pos),
                                    self._dev(tables))
        return _to_numpy(nxt), logits

    def step(self, tokens: np.ndarray, pos: np.ndarray,
             page_tables=None) -> np.ndarray:
        """Greedy :meth:`step_logits` (compat surface)."""
        return self.step_logits(tokens, pos, page_tables)[0]

    # -- speculative compute -------------------------------------------------

    def propose(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """``spec_k`` chained greedy draft steps, the argmax kept on the
        device -> proposals ``[n_slots, spec_k]`` (the draft pool
        advances in place)."""
        _, props = self._propose(self.draft_params, self.draft_cache,
                                 self._dev(tokens), self._dev(pos))
        return _to_numpy(props)

    def draft_step_logits(self, tokens: np.ndarray, pos: np.ndarray
                          ) -> "tuple[np.ndarray, torch.Tensor]":
        """One draft step with logits — the proposal path a sampled
        speculative slot needs (per-step draft distributions on the
        host for rejection sampling)."""
        _, nxt, logits = self._draft_step(self.draft_params,
                                          self.draft_cache,
                                          self._dev(tokens), self._dev(pos))
        return _to_numpy(nxt), logits

    def verify_logits(self, tokens: np.ndarray, pos: np.ndarray,
                      page_tables
                      ) -> "tuple[np.ndarray, torch.Tensor, np.ndarray]":
        """The target's width-``spec_k`` scoring pass: ``tokens`` is
        ``[n_slots, spec_k]`` (column 0 = each slot's current input
        token, columns 1.. = draft proposals). Returns the greedy argmax
        per position, the full logits (device tensor — fetched only when
        a sampled slot needs rejection sampling), and the per-proposal
        target log-probs ``[n_slots, spec_k - 1]`` (K4 or dense per
        ``verify_ce_impl``)."""
        tables = self._checked_tables(np.asarray(page_tables, np.int32))
        _, toks, logits, scores = self._verify(
            self.params, self.cache, self._dev(tokens), self._dev(pos),
            self._dev(tables))
        return _to_numpy(toks), logits, _to_numpy(scores)

    def n_compiles(self) -> int:
        """Compiled-executable count: 0 — the port runs eagerly (CUDA
        graph captures come later)."""
        return 0

    def warmup(self) -> int:
        """Run the step and every prefill bucket once before traffic, and
        with a draft the propose, the draft step and the verify (loads
        the kernels; the rows it writes land on the scratch page and on
        free draft lanes, which the next real prefill overwrites).
        Returns :meth:`n_compiles`."""
        zeros_t = np.zeros(self.n_slots, np.int32)
        zero_tables = np.zeros((self.n_slots, self.pages_per_slot),
                               np.int32)
        self.step(zeros_t, zeros_t.copy(), zero_tables)
        for bucket in self.prompt_buckets():
            self.prefill(0, np.zeros(min(bucket, self.max_len - 1),
                                     np.int32), zero_tables[0])
        if self._prefix_prefill is not None:
            for bucket in self.prompt_buckets():
                self._prefix_prefill(
                    self.params, self.cache,
                    self._dev(np.zeros(bucket, np.int32)),
                    self._dev(zero_tables[0]), 1, 0)
        if self.has_draft:
            self.propose(zeros_t, zeros_t.copy())
            self.draft_step_logits(zeros_t, zeros_t.copy())
            self.verify_logits(
                np.zeros((self.n_slots, self.spec_k), np.int32),
                zeros_t.copy(), zero_tables)
        return self.n_compiles()


class Sampler:
    """Per-request seeded token sampling over the step's full logits.

    Greedy decode stays the device-side argmax (no logits transfer); a
    request that asks for ``temperature > 0`` gets temperature / top-k /
    nucleus (top-p) sampling on host from its slot's logits row, driven
    by its own ``numpy`` PRNG — so one ``seed`` makes a sampled decode
    reproducible whatever other requests share the batch."""

    __slots__ = ("temperature", "top_k", "top_p", "seed", "_rng")

    def __init__(self, temperature: float, top_k: int = 0,
                 top_p: float = 1.0, seed: Optional[int] = None):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def probs(self, logits: np.ndarray) -> np.ndarray:
        """The transformed distribution (temperature, then top-k, then
        nucleus restriction, renormalized)."""
        l = logits.astype(np.float64) / max(self.temperature, 1e-6)
        if 0 < self.top_k < l.size:
            kth = np.partition(l, -self.top_k)[-self.top_k]
            l = np.where(l < kth, -np.inf, l)
        l = l - l.max()
        p = np.exp(l)
        p /= p.sum()
        if self.top_p < 1.0:
            order = np.argsort(-p, kind="stable")
            cum = np.cumsum(p[order])
            # smallest prefix whose mass reaches top_p (>= 1 token)
            keep = int(np.searchsorted(cum, self.top_p)) + 1
            mask = np.zeros(p.size, bool)
            mask[order[:keep]] = True
            p = np.where(mask, p, 0.0)
            p /= p.sum()
        return p

    def sample(self, logits: np.ndarray) -> int:
        return int(self._rng.choice(logits.size,
                                    p=self.probs(logits)))

    def draw(self, p: np.ndarray) -> int:
        """Draw from an explicit distribution with this request's own
        PRNG."""
        return int(self._rng.choice(p.size, p=p))

    def uniform(self) -> float:
        """One accept/reject draw from the request's PRNG."""
        return float(self._rng.random())

    def describe(self) -> Dict[str, Any]:
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed}


class SlotPool:
    """Free-slot index pool. Claim/release are O(1) under one lock;
    release checks the claimed SET, so a double or stray release
    raises."""

    def __init__(self, n_slots: int):
        self.n_slots = int(n_slots)
        self._free = list(range(self.n_slots - 1, -1, -1))
        self._claimed: set = set()
        self._lock = threading.Lock()

    def claim(self) -> Optional[int]:
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._claimed.add(slot)
            return slot

    def release(self, slot: int) -> None:
        with self._lock:
            if slot not in self._claimed:
                raise RuntimeError(f"slot {slot} double-released")
            self._claimed.discard(slot)
            self._free.append(slot)

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)


class PagePool:
    """Refcounted free-page index pool over the paged KV cache. Page 0
    is the scratch page and is never handed out, so a pool of
    ``n_pages`` holds ``n_pages - 1`` claimable pages.

    ``claim`` hands out fresh pages at refcount 1 (all-or-nothing),
    ``ref`` adds a reader to already-claimed pages (attaching a cached
    prefix; how the :class:`PrefixCache` pins what it publishes), and
    ``release`` drops a reference — a page frees only when its LAST
    holder releases it."""

    def __init__(self, n_pages: int):
        self.n_pages = int(n_pages)
        self._free = list(range(self.n_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.high_water = 0

    def claim(self, n: int = 1) -> Optional[List[int]]:
        with self._lock:
            if n > len(self._free):
                return None
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._ref[p] = 1
            if len(self._ref) > self.high_water:
                self.high_water = len(self._ref)
            return pages

    def ref(self, pages: List[int]) -> None:
        """Add one reader to each already-claimed page. Raises on a page
        nobody holds."""
        with self._lock:
            for p in pages:
                if p not in self._ref:
                    raise RuntimeError(
                        f"page {p} ref'd while unclaimed")
            for p in pages:
                self._ref[p] += 1

    def release(self, pages: List[int]) -> None:
        with self._lock:
            for p in pages:
                if p not in self._ref:
                    raise RuntimeError(f"page {p} double-released")
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    del self._ref[p]
                    self._free.append(p)

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._ref.get(page, 0)

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def n_claimed(self) -> int:
        with self._lock:
            return len(self._ref)


class _RadixNode:
    """One cached page, keyed in its parent by the ``page_size``-token
    chunk whose K/V rows the page holds."""

    __slots__ = ("children", "page", "last_used", "parent", "key",
                 "tenant")

    def __init__(self, page: int, now: float, parent=None, key=None,
                 tenant: str = ""):
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.page = page
        self.last_used = now
        self.parent = parent
        self.key = key
        self.tenant = tenant


class PrefixCache:
    """Content-addressed index over the paged KV pool: a radix tree keyed
    at page granularity (``page_size``-token chunks of prompt ids)
    mapping a new prompt to its longest cached prefix.

    The tree holds ONE reference on every published page, so a cached
    page with refcount 1 is unreferenced — evictable — and refcount > 1
    means live readers are attached. ``lookup`` refs the matched pages
    for the caller; ``publish`` inserts a finished request's fully
    written PROMPT pages; ``evict_for`` reclaims LRU unreferenced leaves
    under pressure; ``max_pages`` bounds the resident set. One lock over
    the tree; pool refcount changes for matched/published pages happen
    under it."""

    def __init__(self, pool: PagePool, page_size: int,
                 max_pages: Optional[int] = None,
                 clock: Clock = SYSTEM_CLOCK):
        self.pool = pool
        self.page_size = int(page_size)
        self.max_pages = (int(max_pages) if max_pages is not None
                          else pool.n_pages - 1)
        self.clock = clock
        self._root = _RadixNode(page=0, now=0.0)
        self._lock = threading.Lock()
        self.n_cached = 0
        self.n_lookups = 0
        self.n_hits = 0
        self.n_hit_tokens = 0
        self.n_published = 0
        self.n_evicted = 0
        # per-tenant residency and quotas (evict inside the over-quota
        # tenant first)
        self._quotas: Dict[str, int] = {}
        self._tenant_pages: Dict[str, int] = {}

    def set_quota(self, tenant_id: str,
                  max_pages: Optional[int]) -> None:
        """Bound ``tenant_id``'s resident cached pages (``None`` removes
        the bound), enforced at publish time."""
        with self._lock:
            if max_pages is None:
                self._quotas.pop(tenant_id, None)
            else:
                self._quotas[tenant_id] = int(max_pages)

    def _charge_locked(self, tenant: str, n: int) -> None:
        c = self._tenant_pages.get(tenant, 0) + n
        if c > 0:
            self._tenant_pages[tenant] = c
        else:
            self._tenant_pages.pop(tenant, None)

    def _chunks(self, tokens, n: int):
        ps = self.page_size
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(n)]

    def lookup(self, prompt) -> "tuple[int, List[int]]":
        """Longest cached prefix of ``prompt`` -> ``(hit_len, pages)``,
        with the pages ref'd for the caller. ``hit_len`` is page-aligned
        and capped at ``len(prompt) - 1`` (the last prompt position is
        always computed, for its logits). Does not count itself: see
        :meth:`count`."""
        max_chunks = (len(prompt) - 1) // self.page_size
        with self._lock:
            node, pages = self._root, []
            now = self.clock.now()
            for chunk in self._chunks(prompt, max_chunks):
                child = node.children.get(chunk)
                if child is None:
                    break
                child.last_used = now
                pages.append(child.page)
                node = child
            if not pages:
                return 0, []
            self.pool.ref(pages)
            return len(pages) * self.page_size, pages

    def count(self, hit_len: int) -> None:
        """Record one ADMITTED request's lookup outcome (monotonic)."""
        with self._lock:
            self.n_lookups += 1
            if hit_len > 0:
                self.n_hits += 1
                self.n_hit_tokens += hit_len

    def miss_count(self) -> int:
        with self._lock:
            return self.n_lookups - self.n_hits

    def publish(self, prompt, pages: List[int],
                tenant: Optional[str] = None) -> "set":
        """Insert a finished request's prompt-complete pages
        (``pages[i]`` holds prompt rows ``[i*ps, (i+1)*ps)``). Returns
        the pages newly ABSORBED (their reference transferred to the
        index); the caller releases everything else. Chunks already
        present keep the incumbent page. Absorption respects
        ``max_pages`` (LRU unreferenced pages are evicted to make room;
        when nothing is evictable the rest stay unpublished) and the
        tenant's quota (evicting only that tenant's pages)."""
        n_chunks = min(len(prompt) // self.page_size, len(pages))
        if n_chunks == 0:
            return set()
        owner = tenant or ""
        quota = self._quotas.get(owner) if owner else None
        absorbed: set = set()
        with self._lock:
            # size the eviction once: count the missing chunks, then one
            # heap-seeded eviction covers them all
            chunks = self._chunks(prompt, n_chunks)
            node, missing = self._root, 0
            for chunk in chunks:
                if node is not None:
                    node = node.children.get(chunk)
                if node is None:
                    missing += 1
            shortfall = self.n_cached + missing - self.max_pages
            if missing and shortfall > 0:
                self._evict_pressure_locked(shortfall)
            node = self._root
            now = self.clock.now()
            # every node on this publish's chain: a mid-publish eviction
            # of one would orphan the subtree being extended
            path: set = set()
            for i, chunk in enumerate(chunks):
                child = node.children.get(chunk)
                if child is None:
                    if quota is not None and \
                            self._tenant_pages.get(owner, 0) >= quota \
                            and not self._evict_locked(
                                1, exclude=path, tenant=owner):
                        break    # at quota, nothing of OURS evictable
                    if self.n_cached >= self.max_pages and \
                            not self._evict_locked(1, exclude=path):
                        break            # full and pinned: stop here
                    child = _RadixNode(pages[i], now, parent=node,
                                       key=chunk, tenant=owner)
                    node.children[chunk] = child
                    self.n_cached += 1
                    self.n_published += 1
                    self._charge_locked(owner, 1)
                    absorbed.add(pages[i])
                else:
                    child.last_used = now
                path.add(id(child))
                node = child
        return absorbed

    def _nodes_locked(self):
        stack = [self._root]
        while stack:
            nd = stack.pop()
            for child in nd.children.values():
                yield child
                stack.append(child)

    def _evict_locked(self, n: int, exclude=frozenset(),
                      tenant: Optional[str] = None) -> int:
        """Evict up to ``n`` LRU leaves whose page has no reader beyond
        the index (refcount 1). A parent joins the candidate heap when
        its last child goes. ``exclude`` holds node ids an in-flight
        publish is building under; ``tenant`` restricts victims to one
        tenant's pages."""
        import heapq
        heap = [(nd.last_used, i, nd)
                for i, nd in enumerate(self._nodes_locked())
                if not nd.children
                and (tenant is None or nd.tenant == tenant)]
        heapq.heapify(heap)
        seq = len(heap)
        evicted = 0
        while evicted < n and heap:
            _, _, nd = heapq.heappop(heap)
            if nd.children or nd.parent is None \
                    or nd.parent.children.get(nd.key) is not nd:
                continue                 # stale entry
            if id(nd) in exclude or \
                    self.pool.refcount(nd.page) != 1:
                continue                 # pinned or publish-in-flight
            nd.parent.children.pop(nd.key)
            self.pool.release([nd.page])
            self.n_cached -= 1
            self.n_evicted += 1
            self._charge_locked(nd.tenant, -1)
            evicted += 1
            parent = nd.parent
            if not parent.children and parent is not self._root \
                    and (tenant is None or parent.tenant == tenant):
                heapq.heappush(heap, (parent.last_used, seq, parent))
                seq += 1
        return evicted

    def _evict_pressure_locked(self, n: int,
                               exclude=frozenset()) -> int:
        """Claim-pressure eviction: over-quota tenants first (most over
        first), then global LRU."""
        evicted = 0
        if self._quotas:
            over = sorted(
                ((self._tenant_pages.get(t, 0) - q, t)
                 for t, q in self._quotas.items()
                 if self._tenant_pages.get(t, 0) > q),
                reverse=True)
            for surplus, t in over:
                if evicted >= n:
                    break
                evicted += self._evict_locked(
                    min(n - evicted, surplus), exclude=exclude,
                    tenant=t)
        if evicted < n:
            evicted += self._evict_locked(n - evicted,
                                          exclude=exclude)
        return evicted

    def evict_for(self, n_needed: int) -> int:
        """Reclaim LRU unreferenced cached pages until the pool can hand
        out ``n_needed`` pages (or nothing evictable remains)."""
        with self._lock:
            short = n_needed - self.pool.n_free
            return self._evict_pressure_locked(short) if short > 0 \
                else 0

    @property
    def n_evictable(self) -> int:
        """Cached pages no live request holds (O(n_cached); a stats
        surface, not a per-request path)."""
        with self._lock:
            return sum(1 for nd in self._nodes_locked()
                       if self.pool.refcount(nd.page) == 1)

    def ledger_clean(self) -> bool:
        """The IDLE refcount invariant: every cached page is held by
        exactly the index and free + cached covers the whole claimable
        pool. Meaningful only with no request live."""
        with self._lock:
            pages = [nd.page for nd in self._nodes_locked()]
            if len(pages) != self.n_cached:
                return False
        if any(self.pool.refcount(p) != 1 for p in pages):
            return False
        return (self.pool.n_free + len(pages)
                == self.pool.n_pages - 1)

    def clear(self) -> int:
        """Release every cached page back to the pool. Returns the
        number of entries dropped."""
        with self._lock:
            pages = [nd.page for nd in self._nodes_locked()]
            self._root.children.clear()
            dropped, self.n_cached = self.n_cached, 0
            self._tenant_pages.clear()
            if pages:
                self.pool.release(pages)
            return dropped

    def stats(self) -> Dict[str, Any]:
        return {"page_size": self.page_size,
                "max_pages": self.max_pages,
                "cached_pages": self.n_cached,
                "evictable_pages": self.n_evictable,
                "lookups": self.n_lookups,
                "hits": self.n_hits,
                "hit_rate": (round(self.n_hits / self.n_lookups, 4)
                             if self.n_lookups else None),
                "hit_tokens": self.n_hit_tokens,
                "published_pages": self.n_published,
                "evicted_pages": self.n_evicted,
                "tenant_pages": dict(self._tenant_pages),
                "tenant_quotas": dict(self._quotas),
                "ledger_clean": self.ledger_clean()}


class _DecodeRequest:
    """Per-request decode state, riding alongside the caller's pending
    request (``pending`` — payload/rid/deadline/event/callbacks/reply/
    status/span, duck-typed)."""

    __slots__ = ("pending", "prompt", "max_new", "produced", "slot",
                 "cancelled", "t_submit", "t_decode", "sampler", "spec",
                 "pages", "hit_len")

    def __init__(self, pending, prompt: np.ndarray, max_new: int,
                 sampler: Optional[Sampler] = None,
                 spec: Optional[bool] = None):
        self.pending = pending
        self.prompt = prompt
        self.max_new = int(max_new)
        self.sampler = sampler
        # speculative opt-in/out from the payload; None = default (greedy
        # slots speculate when a draft exists, sampled slots only on
        # explicit opt-in: rejection sampling changes PRNG consumption)
        self.spec = spec
        self.produced: List[int] = []       # incremental emission
        self.slot: Optional[int] = None
        self.pages: List[int] = []          # held KV pages: the first
        # hit_len // page_size are SHARED prefix pages (ref'd, read-only)
        self.hit_len = 0
        self.cancelled = False
        self.t_submit: float = 0.0
        self.t_decode: float = 0.0

    @property
    def stream(self):
        return getattr(self.pending, "stream", None)


class DecodeScheduler:
    """The continuous-batching step loop.

    ``submit()`` (any thread) parses and enqueues; the loop thread admits
    waiting requests into free slots between steps, runs the fixed-shape
    decode step while any slot is live, and resolves requests through
    the standalone commit (event + callbacks).

    Slot lifecycle: ``waiting -> prefill(slot claimed) -> stepping ->
    released`` on the first of EOS, ``max_new_tokens`` produced, lane
    full (``max_len``), deadline, cancel, pages exhausted, or a step
    fault. Every exit path funnels through ``_finish``, which releases
    the slot and the pages.

    With a draft on the decoder, rounds speculate: ``spec_policy="auto"``
    installs the default :class:`SpeculationPolicy`, ``None`` speculates
    unconditionally, and a policy instance is used as given."""

    def __init__(self, decoder: TransformerDecoder,
                 max_waiting: int = 256,
                 max_new_tokens_default: int = 64,
                 clock: Clock = SYSTEM_CLOCK,
                 fault_plan=None,
                 registry=None, tracer=None,
                 idle_wait_s: float = 0.02,
                 spec_policy="auto",
                 prefix_cache="auto",
                 prefix_cache_pages: Optional[int] = None):
        if registry is not None:
            raise NotImplementedError(
                "decode metrics need the serving stack's registry, which "
                "is not ported yet (ROADMAP queue 1: bind() and metrics)")
        self.decoder = decoder
        if spec_policy == "auto":
            spec_policy = (SpeculationPolicy() if decoder.has_draft
                           else None)
        self.spec_policy = spec_policy
        self.max_waiting = int(max_waiting)
        self.max_new_tokens_default = int(max_new_tokens_default)
        self.clock = clock
        self.fault_plan = fault_plan
        self.tracer = tracer
        self.idle_wait_s = float(idle_wait_s)
        self.pool = SlotPool(decoder.n_slots)
        # the page plane: the shared page pool plus the live
        # [n_slots, pages_per_slot] tables the step reads — unclaimed
        # entries stay 0 (the scratch page)
        self.pages = PagePool(decoder.n_pages)
        self._tables = np.zeros(
            (decoder.n_slots, decoder.pages_per_slot), np.int32)
        self.prefix: Optional[PrefixCache] = None
        if prefix_cache == "auto":
            prefix_cache = decoder.has_prefix_prefill
        if prefix_cache:
            if not decoder.has_prefix_prefill:
                raise ValueError(
                    "prefix_cache=True needs a decoder built with "
                    "prefix_cache=True (the offset-prefill machinery)")
            self.prefix = PrefixCache(
                self.pages, decoder.page_size,
                max_pages=prefix_cache_pages, clock=clock)
        self._waiting: deque = deque()
        self._by_rid: Dict[str, _DecodeRequest] = {}
        self._active: Dict[int, _DecodeRequest] = {}
        self._tokens = np.zeros(decoder.n_slots, np.int32)
        self._pos = np.zeros(decoder.n_slots, np.int32)
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._commit: Callable[[Any], None] = self._standalone_commit
        self.n_requests = 0
        self.n_steps = 0
        self.n_tokens = 0
        self.n_prefills = 0
        # prompt tokens SERVED (cached prefix included) over prefill
        # wall-clock: a hit shrinks the wall, not the numerator
        self.n_prompt_tokens = 0
        self.prefill_s = 0.0
        self.n_step_faults = 0
        self.slots_high_water = 0
        self.n_page_preempts = 0
        # speculative ledger: acceptance_rate = accepted / proposed
        self.n_spec_rounds = 0
        self.n_spec_proposed = 0
        self.n_spec_accepted = 0
        #: EWMA of the verify's per-proposal target log-probs (K4 or
        #: dense): acceptance quality, not just its rate
        self.spec_proposal_logp: Optional[float] = None
        self.releases: Dict[str, int] = {}   # finish_reason -> count
        # goodput: tokens delivered by CLEAN finishes (eos/length)
        self.n_goodput_tokens = 0
        # fair-share admission reads the serving stack's tenancy
        # registry once a server is attached (the HTTP slice's bind());
        # standalone, admission is FIFO
        self._server = None
        self.release_ewma = ReleaseRateEwma(clock=clock)
        self._fair = FairCycle()

    # -- admission (any thread) ----------------------------------------------

    def overloaded(self) -> bool:
        return len(self._waiting) >= self.max_waiting

    def queue_pressure(self) -> "tuple[int, int]":
        """``(depth, capacity)`` of the waiting queue."""
        return len(self._waiting), self.max_waiting

    def retry_after_hint(self) -> Optional[float]:
        """Honest decode-429 ``Retry-After`` from the slot-release EWMA
        scaled by the queue ahead; ``None`` while cold or stale."""
        return self.release_ewma.retry_after(len(self._waiting))

    def parse(self, payload: Any
              ) -> "tuple[np.ndarray, int, Optional[Sampler], Optional[bool]]":
        """Payload -> (prompt tokens, max_new, sampler, speculative).
        Raises ValueError on anything the decode plane cannot serve (the
        caller 400s)."""
        if not isinstance(payload, dict):
            raise ValueError("decode payload must be a JSON object")
        prompt = payload.get("prompt")
        if not isinstance(prompt, list) or not prompt or \
                not all(isinstance(t, int) and not isinstance(t, bool)
                        and 0 <= t for t in prompt):
            # bool is an int subclass: [true, false] must 400
            raise ValueError(
                'decode payload needs "prompt": [token ids] '
                '(non-empty list of non-negative ints)')
        if any(t >= self.decoder.cfg.vocab for t in prompt):
            raise ValueError(
                f"prompt token out of range (vocab "
                f"{self.decoder.cfg.vocab})")
        if len(prompt) >= self.decoder.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_len "
                f"{self.decoder.max_len} (no room to generate)")
        max_new = payload.get("max_new_tokens",
                              self.max_new_tokens_default)
        if not isinstance(max_new, int) or isinstance(max_new, bool) \
                or max_new < 1:
            raise ValueError('"max_new_tokens" must be a positive int')
        # the cache lane bounds the sequence: clamp the budget to it
        max_new = min(max_new, self.decoder.max_len - len(prompt))
        spec = payload.get("speculative")
        if spec is not None and not isinstance(spec, bool):
            raise ValueError('"speculative" must be a boolean')
        stream = payload.get("stream")
        if stream is not None and not isinstance(stream, bool):
            raise ValueError('"stream" must be a boolean')
        return np.asarray(prompt, np.int32), max_new, \
            self._parse_sampling(payload), spec

    @staticmethod
    def _parse_sampling(payload: dict) -> Optional[Sampler]:
        """``temperature`` (> 0 turns sampling on; 0/absent = greedy),
        ``top_k``, ``top_p``, ``seed``. Bad values 400."""
        temp = payload.get("temperature", 0)
        if isinstance(temp, bool) or not isinstance(temp, (int, float)) \
                or not np.isfinite(temp) or temp < 0:
            raise ValueError(
                '"temperature" must be a finite number >= 0 '
                '(0 = greedy)')
        top_k = payload.get("top_k", 0)
        if isinstance(top_k, bool) or not isinstance(top_k, int) \
                or top_k < 0:
            raise ValueError('"top_k" must be an int >= 0 (0 = off)')
        top_p = payload.get("top_p", 1.0)
        if isinstance(top_p, bool) or not isinstance(top_p, (int, float)) \
                or not 0.0 < float(top_p) <= 1.0:
            raise ValueError('"top_p" must be in (0, 1]')
        seed = payload.get("seed")
        if seed is not None and (isinstance(seed, bool)
                                 or not isinstance(seed, int)):
            raise ValueError('"seed" must be an int')
        if float(temp) == 0.0:
            if "temperature" not in payload and \
                    (int(top_k) > 0 or float(top_p) < 1.0):
                # effective knobs with temperature ABSENT: sample at
                # temperature 1; an EXPLICIT "temperature": 0 stays greedy
                return Sampler(1.0, int(top_k), float(top_p), seed)
            return None
        return Sampler(float(temp), int(top_k), float(top_p), seed)

    def _pages_for(self, rows: int) -> int:
        """Pages covering virtual rows ``[0, rows)``."""
        ps = self.decoder.page_size
        return max((int(rows) + ps - 1) // ps, 1)

    def _claim_pages(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` fresh pages, evicting LRU unreferenced cached
        pages first when the free list alone cannot cover it."""
        got = self.pages.claim(n)
        if got is None and self.prefix is not None:
            self.prefix.evict_for(n)
            got = self.pages.claim(n)
        return got

    def _release_pages(self, req: _DecodeRequest,
                       publish: bool) -> None:
        """Drop the request's page references. On a clean finish the
        prompt-complete pages are PUBLISHED into the prefix index;
        everything else is released. ``error`` finishes never publish: a
        faulted step's cache state is suspect."""
        pages, req.pages = req.pages, []
        absorbed = set()
        if self.prefix is not None and publish:
            absorbed = self.prefix.publish(
                req.prompt, pages,
                tenant=getattr(req.pending, "tenant", None))
        rest = [p for p in pages if p not in absorbed]
        if rest:
            self.pages.release(rest)

    def _spec_capable(self, req: _DecodeRequest) -> bool:
        """Whether this request may EVER enter a speculative cohort: an
        explicit payload opt-in/out wins; greedy defaults on, sampled
        off. Fixed for the request's life — it decides the draft prefill
        at admission and the draft catch-up on non-speculative
        rounds."""
        if not self.decoder.has_draft:
            return False
        return req.spec if req.spec is not None else req.sampler is None

    def submit(self, pending, parsed=None) -> None:
        """Enqueue one admitted request. Raises ValueError on a bad
        payload (caller 400s), DecodeOverloaded when the waiting queue
        is full OR the page pool cannot hold the prompt (caller 429s —
        page exhaustion is backpressure, never a mid-decode OOM).
        ``parsed`` passes an already computed :meth:`parse` tuple."""
        prompt, max_new, sampler, spec = (
            parsed if parsed is not None else self.parse(
                pending.payload))
        req = _DecodeRequest(pending, prompt, max_new, sampler, spec)
        req.t_submit = self.clock.now()
        # admission-time page check (advisory; _admit_waiting re-checks).
        # It sheds BEFORE touching shared state: cached pages count as
        # reclaimable headroom via the O(1) n_cached upper bound
        need = self._pages_for(len(prompt) + 1)
        avail = self.pages.n_free + (
            self.prefix.n_cached if self.prefix is not None else 0)
        if avail < need:
            raise DecodeOverloaded(
                f"decode page pool exhausted ({need} pages "
                f"needed, {avail} free or evictable)")
        with self._lock:
            if len(self._waiting) >= self.max_waiting:
                raise DecodeOverloaded("decode waiting queue full")
            self._waiting.append(req)
            self._by_rid[pending.rid] = req
            self.n_requests += 1
        self._work.set()

    def cancel(self, rid: str) -> bool:
        """Flag a waiting or in-slot request cancelled; it resolves
        (partial tokens, ``finish_reason: "cancelled"``) at the next loop
        pass. Returns False for unknown rids."""
        with self._lock:
            req = self._by_rid.get(rid)
            if req is None:
                return False
            req.cancelled = True
        self._work.set()
        return True

    # -- resolution ----------------------------------------------------------

    @staticmethod
    def _standalone_commit(p) -> None:
        p.event.set()
        for cb in p.callbacks:
            try:
                cb(p)
            except Exception:  # noqa: BLE001 — one bad callback must
                logger.warning(  # not strand the others
                    "reply callback failed", exc_info=True)

    def _now(self) -> float:
        return (self.tracer.clock.now() if self.tracer is not None
                else self.clock.now())

    def _add_span(self, req: _DecodeRequest, name: str, t0: float,
                  t1: float, status: str = "ok", **attrs) -> None:
        if self.tracer is not None and \
                getattr(req.pending, "span", None) is not None:
            self.tracer.add(name, t0, t1, parent=req.pending.span,
                            status=status, **attrs)

    def _finish(self, req: _DecodeRequest, reason: str,
                status: int = 200,
                error: Optional[str] = None) -> None:
        """Resolve a request and free whatever it held — slot AND pages;
        EVERY exit path funnels here, so neither can leak."""
        if req.slot is not None:
            with self._lock:
                self._active.pop(req.slot, None)
            self._tokens[req.slot] = 0
            self._pos[req.slot] = 0
            self._tables[req.slot, :] = 0
            self.pool.release(req.slot)
            self.release_ewma.note()
            self._add_span(req, "decode", req.t_decode, self._now(),
                           status="ok" if status == 200 else "error",
                           slot=req.slot, n_tokens=len(req.produced),
                           finish_reason=reason)
            req.slot = None
        if req.pages:
            self._release_pages(req, publish=reason != "error")
        with self._lock:
            self._by_rid.pop(req.pending.rid, None)
            self.releases[reason] = self.releases.get(reason, 0) + 1
        p = req.pending
        if reason in ("eos", "length"):
            self.n_goodput_tokens += len(req.produced)
        if status == 200:
            p.status = 200
            body = {"tokens": req.produced,
                    "n_tokens": len(req.produced),
                    "prompt_len": int(len(req.prompt)),
                    "finish_reason": reason}
        else:
            p.status = status
            body = {"error": error or reason,
                    "tokens": req.produced,
                    "n_tokens": len(req.produced),
                    "finish_reason": reason}
        p.reply = json.dumps(body).encode()
        stream = req.stream
        if stream is not None and not stream.closed:
            stream.finish(b"data: " + json.dumps(
                dict(body, done=True)).encode() + b"\n\n")
        self._commit(p)

    # -- the loop ------------------------------------------------------------

    def start(self) -> "DecodeScheduler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name="decode-scheduler")
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # the loop is stuck inside a prefill/step: finishing its
                # in-slot requests from HERE would race its own
                # retirement path — leave them to the daemon thread
                logger.warning(
                    "decode loop did not stop in %.1fs; leaving "
                    "in-flight slots to it", timeout)
                return
        # the loop is dead: resolve stragglers so no client hangs
        with self._lock:
            waiting = list(self._waiting)
            self._waiting.clear()
        for req in waiting:
            self._finish(req, "error", status=503,
                         error="decode scheduler stopping")
        for req in list(self._active.values()):
            self._finish(req, "error", status=503,
                         error="decode scheduler stopping")

    def _loop(self) -> None:
        while not self._stop.is_set():
            # dead waiters resolve EVERY pass, slots full or not
            self._reap_waiting()
            self._admit_waiting()
            if not self._active:
                # idle: block until submit()/cancel()/stop() wakes us;
                # with waiters held back the short timeout keeps their
                # deadlines honest
                self._work.wait(self.idle_wait_s
                                if self._waiting else None)
                self._work.clear()
                continue
            self._run_step()

    def _reap_waiting(self) -> None:
        with self._lock:
            if not self._waiting:
                return
            keep, dead = deque(), []
            for req in self._waiting:
                p = req.pending
                s = req.stream
                if req.cancelled or (p.deadline is not None
                                     and p.deadline.expired) \
                        or (s is not None and s.closed):
                    dead.append(req)
                else:
                    keep.append(req)
            self._waiting = keep
        for req in dead:
            if req.cancelled:
                self._finish(req, "cancelled")
            elif req.stream is not None and req.stream.closed:
                self._finish(req, "disconnected", status=500,
                             error="client disconnected")
            else:
                self._finish(req, "deadline", status=504,
                             error="deadline exceeded before decode")

    def _pop_waiting(self) -> Optional[_DecodeRequest]:
        """Next waiter to try for a slot: FIFO without tenancy; with
        fair share on, a deficit-weighted round-robin across the tenants
        present in the queue picks whose oldest request goes next."""
        with self._lock:
            if not self._waiting:
                return None
            ten = (getattr(self._server, "tenancy", None)
                   if self._server is not None else None)
            if ten is None or not ten.fair_share \
                    or len(self._waiting) == 1:
                return self._waiting.popleft()
            present: Dict[str, float] = {}
            for r in self._waiting:
                tid = getattr(r.pending, "tenant", None) or ANONYMOUS_ID
                if tid not in present:
                    present[tid] = ten.weight_of(tid)
            if len(present) == 1:
                return self._waiting.popleft()
            pick = self._fair.choose(present)
            for i, r in enumerate(self._waiting):
                if (getattr(r.pending, "tenant", None)
                        or ANONYMOUS_ID) == pick:
                    del self._waiting[i]
                    return r
            return self._waiting.popleft()

    def _admit_waiting(self) -> None:
        """Between steps: claim free slots and the prompt's pages for
        waiting requests — one prefill each. A head-of-queue request the
        page pool cannot hold yet WAITS (admission order preserved)."""
        while self.pool.n_free > 0:
            req = self._pop_waiting()
            if req is None:
                return
            p = req.pending
            if req.cancelled:
                self._finish(req, "cancelled")
                continue
            if p.deadline is not None and p.deadline.expired:
                self._finish(req, "deadline", status=504,
                             error="deadline exceeded before decode")
                continue
            s = req.stream
            if s is not None and s.closed:
                self._finish(req, "disconnected", status=500,
                             error="client disconnected")
                continue
            shared: List[int] = []
            hit_len = 0
            if self.prefix is not None:
                # matched pages arrive ref'd — released on any bail-out
                hit_len, shared = self.prefix.lookup(req.prompt)
            own = self._claim_pages(
                self._pages_for(len(req.prompt) + 1) - len(shared))
            if own is None:
                # not enough pages YET: head-of-line waits for running
                # requests to release theirs
                if shared:
                    self.pages.release(shared)
                with self._lock:
                    self._waiting.appendleft(req)
                return
            pages = shared + own
            slot = self.pool.claim()
            if slot is None:      # raced a concurrent release? retry
                self.pages.release(pages)
                with self._lock:
                    self._waiting.appendleft(req)
                return
            if self.prefix is not None:
                # one monotonic hit-ledger bump per ADMITTED request
                self.prefix.count(hit_len)
            t0 = self._now()
            self._add_span(req, "queue_wait", req.t_submit, t0)
            self._tables[slot, :] = 0
            self._tables[slot, :len(pages)] = pages
            table = self._tables[slot]
            try:
                if self.fault_plan is not None:
                    self.fault_plan.raise_at("decode_prefill",
                                             clock=self.clock)
                if hit_len > 0:
                    first, last_logits = \
                        self.decoder.prefill_prefix_logits(
                            slot, req.prompt, hit_len, table,
                            draft=self._spec_capable(req))
                else:
                    first, last_logits = self.decoder.prefill_logits(
                        slot, req.prompt, table,
                        draft=self._spec_capable(req))
                if req.sampler is not None:
                    # the request's own seeded PRNG picks the first
                    # generated token from the prompt's last logits
                    first = req.sampler.sample(_to_numpy(last_logits))
            except Exception as e:  # noqa: BLE001 — injected or real
                self.pool.release(slot)
                self.pages.release(pages)
                self._tables[slot, :] = 0
                self._add_span(req, "prefill", t0, self._now(),
                               status="error")
                self._finish(req, "error", status=500,
                             error=f"prefill failed: {e}")
                continue
            t1 = self._now()
            req.t_decode = t1
            self.n_prefills += 1
            self.n_prompt_tokens += len(req.prompt)
            self.prefill_s += t1 - t0
            self._add_span(req, "prefill", t0, t1, slot=slot,
                           prompt_len=len(req.prompt),
                           prefix_hit=hit_len)
            req.slot = slot
            req.pages = pages
            req.hit_len = hit_len
            req.produced.append(first)
            self.n_tokens += 1
            self._tokens[slot] = first
            self._pos[slot] = len(req.prompt)
            with self._lock:
                self._active[slot] = req
                if len(self._active) > self.slots_high_water:
                    self.slots_high_water = len(self._active)
            self._emit_stream(req, [first])
            self._retire_if_done(req, first)

    def _retire_if_done(self, req: _DecodeRequest, tok: int) -> bool:
        """Post-token finish checks, cheapest terminal first."""
        eos = self.decoder.eos_id
        if eos is not None and tok == eos:
            self._finish(req, "eos")
            return True
        if len(req.produced) >= req.max_new:
            self._finish(req, "length")
            return True
        if req.slot is not None and \
                int(self._pos[req.slot]) >= self.decoder.max_len - 1:
            self._finish(req, "length")   # cache lane exhausted
            return True
        if req.cancelled:
            self._finish(req, "cancelled")
            return True
        s = req.stream
        if s is not None and s.closed:
            self._finish(req, "disconnected", status=500,
                         error="client disconnected mid-stream")
            return True
        p = req.pending
        if p.deadline is not None and p.deadline.expired:
            self._finish(req, "deadline", status=504,
                         error="deadline exceeded mid-decode")
            return True
        return False

    def _emit_stream(self, req: _DecodeRequest, toks) -> None:
        """One SSE event per emitted token for a streaming request."""
        s = req.stream
        if s is None or s.closed:
            return
        base = len(req.produced) - len(toks)
        for off, tok in enumerate(toks):
            s.emit(b'data: {"token": %d, "i": %d}\n\n'
                   % (int(tok), base + off))

    def _ensure_pages(self, req: _DecodeRequest, upto_pos: int) -> bool:
        """Grow ``req``'s page table to cover virtual row ``upto_pos``;
        False when the pool cannot (growth evicts unreferenced cached
        pages first: live decodes outrank cache residency). The caller
        decides: preempt for the step's own row, degrade to a single
        step for lookahead rows."""
        need = self._pages_for(upto_pos + 1)
        have = len(req.pages)
        if need <= have:
            return True
        got = self._claim_pages(need - have)
        if got is None:
            return False
        self._tables[req.slot, have:need] = got
        req.pages.extend(got)
        return True

    def _prepare_round(self) -> Dict[int, _DecodeRequest]:
        """Pre-step upkeep: reap dead slots, grow pages for every live
        slot's next row (preempting — ``pages_exhausted`` — when the
        pool is dry), and pick the speculative cohort: spec-capable
        slots whose lookahead window fits their lane and the pool."""
        for req in list(self._active.values()):
            p = req.pending
            s = req.stream
            if req.cancelled:
                self._finish(req, "cancelled")
            elif s is not None and s.closed:
                self._finish(req, "disconnected", status=500,
                             error="client disconnected mid-stream")
            elif p.deadline is not None and p.deadline.expired:
                self._finish(req, "deadline", status=504,
                             error="deadline exceeded mid-decode")
        for slot, req in list(self._active.items()):
            if not self._ensure_pages(req, int(self._pos[slot])):
                # the pool cannot hold this slot's NEXT row: end with the
                # partial output rather than corrupt anyone
                self.n_page_preempts += 1
                self._finish(req, "pages_exhausted")
        spec: Dict[int, _DecodeRequest] = {}
        if self.decoder.has_draft:
            if self.spec_policy is not None \
                    and not self.spec_policy.should_speculate():
                # acceptance below break-even: single steps until a probe
                # round finds the workload draft-friendly again
                return spec
            k = self.decoder.spec_k
            for slot, req in self._active.items():
                if not self._spec_capable(req):
                    continue
                if int(self._pos[slot]) + k >= self.decoder.max_len:
                    continue          # lane end: single steps finish it
                if not self._ensure_pages(
                        req, int(self._pos[slot]) + k - 1):
                    continue          # pool tight: degrade, not block
                spec[slot] = req
        return spec

    def _run_step(self) -> None:
        spec = self._prepare_round()
        if not self._active:
            return
        if spec:
            self._run_spec_round(spec)
            return
        try:
            if self.fault_plan is not None:
                self.fault_plan.raise_at("decode_step", clock=self.clock)
            out, step_logits = self.decoder.step_logits(
                self._tokens, self._pos, self._tables)
        except Exception as e:  # noqa: BLE001 — injected or real
            # a failed step loses the affected requests (500) but NEVER
            # a slot or page
            self.n_step_faults += 1
            logger.warning("decode step failed; failing %d in-slot "
                           "requests", len(self._active), exc_info=True)
            for req in list(self._active.values()):
                self._finish(req, "error", status=500,
                             error=f"decode step failed: {e}")
            return
        self.n_steps += 1
        if self.decoder.has_draft and any(
                self._spec_capable(r) for r in self._active.values()):
            # draft catch-up: a spec-capable slot stepping WITHOUT the
            # draft (policy suppression, a tight pool, the lane end)
            # would leave holes in its draft lane, and a later round
            # would propose from garbage. One draft step per plain round,
            # at the target step's inputs, keeps both pools in lockstep;
            # its tokens are discarded.
            try:
                self.decoder.draft_step_logits(self._tokens, self._pos)
            except Exception:  # noqa: BLE001 — the draft is advisory:
                logger.warning(  # a broken draft must not fail decode
                    "draft catch-up step failed", exc_info=True)
        # one host fetch of the full [n_slots, vocab] logits per step,
        # paid ONLY while a sampling request is in a slot
        logits_np = None
        if any(r.sampler is not None for r in self._active.values()):
            logits_np = _to_numpy(step_logits)
        for slot, req in list(self._active.items()):
            tok = (int(out[slot]) if req.sampler is None
                   else req.sampler.sample(logits_np[slot]))
            req.produced.append(tok)
            self.n_tokens += 1
            self._pos[slot] += 1
            self._tokens[slot] = tok
            self._emit_stream(req, [tok])
            self._retire_if_done(req, tok)

    def _run_spec_round(self, spec: Dict[int, _DecodeRequest]) -> None:
        """One speculative round: the draft proposes ``spec_k`` tokens
        per slot, the target verifies them in ONE width-``spec_k`` pass,
        and each speculative slot accepts its longest agreeing prefix
        (exact argmax match for greedy slots, Leviathan rejection
        sampling for sampled opt-ins). Non-speculative slots ride the
        verify and consume only its first position — exactly a single
        step for them (their lookahead writes land on scratch or on rows
        the next round rewrites)."""
        k = self.decoder.spec_k
        n = self.decoder.n_slots
        sampled_spec = [s for s, r in spec.items() if r.sampler is not None]
        try:
            if self.fault_plan is not None:
                self.fault_plan.raise_at("decode_step", clock=self.clock)
            if not sampled_spec:
                # the fast path: k chained greedy draft steps with the
                # argmax on the device, one host fetch per round
                props = self.decoder.propose(self._tokens, self._pos)
                draft_probs = None
            else:
                # sampled proposals need each step's draft distribution
                # on the host: k separate draft steps, each sampled slot
                # drawing from its own transformed draft distribution
                # with its own PRNG
                props = np.zeros((n, k), np.int32)
                draft_probs: Dict[int, list] = {s: [] for s in sampled_spec}
                cur = self._tokens.copy()
                for j in range(k):
                    nxt, dlogits = self.decoder.draft_step_logits(
                        cur, self._pos + j)
                    dl_np = _to_numpy(dlogits)
                    for s in range(n):
                        if s in draft_probs:
                            q = spec[s].sampler.probs(dl_np[s])
                            draft_probs[s].append(q)
                            props[s, j] = spec[s].sampler.draw(q)
                        else:
                            props[s, j] = int(nxt[s])
                    cur = props[:, j].copy()
            ver_in = np.concatenate([self._tokens[:, None],
                                     props[:, :k - 1]],
                                    axis=1).astype(np.int32)
            out_tok, ver_logits, ver_scores = self.decoder.verify_logits(
                ver_in, self._pos, self._tables)
        except Exception as e:  # noqa: BLE001 — injected or real
            self.n_step_faults += 1
            logger.warning("speculative round failed; failing %d in-slot "
                           "requests", len(self._active), exc_info=True)
            for req in list(self._active.values()):
                self._finish(req, "error", status=500,
                             error=f"decode step failed: {e}")
            return
        self.n_spec_rounds += 1
        logits_np = None
        if any(r.sampler is not None for r in self._active.values()):
            logits_np = _to_numpy(ver_logits)
        # the verify's per-proposal target log-probs: how close the
        # misses were, beside how often the draft agreed
        mean_logp = float(np.mean(ver_scores[sorted(spec)]))
        prev = self.spec_proposal_logp
        self.spec_proposal_logp = (mean_logp if prev is None
                                   else 0.8 * prev + 0.2 * mean_logp)
        round_proposed = round_accepted = 0
        for slot, req in list(self._active.items()):
            if slot not in spec:
                # non-speculative rider: verify position 0 IS its step
                tok = (int(out_tok[slot, 0]) if req.sampler is None
                       else req.sampler.sample(logits_np[slot, 0]))
                self._accept_tokens(req, slot, [tok])
                continue
            self.n_spec_proposed += k
            round_proposed += k
            emitted: List[int] = []
            if req.sampler is None:
                for j in range(k):
                    tgt = int(out_tok[slot, j])
                    emitted.append(tgt)
                    if int(props[slot, j]) != tgt:
                        break
                    self.n_spec_accepted += 1
                    round_accepted += 1
            else:
                smp = req.sampler
                for j in range(k):
                    d = int(props[slot, j])
                    p_t = smp.probs(logits_np[slot, j])
                    q_d = draft_probs[slot][j]
                    accept = (q_d[d] > 0.0 and smp.uniform() <= min(
                        1.0, float(p_t[d] / q_d[d])))
                    if accept:
                        emitted.append(d)
                        self.n_spec_accepted += 1
                        round_accepted += 1
                        continue
                    resid = np.maximum(p_t - q_d, 0.0)
                    tot = resid.sum()
                    emitted.append(smp.draw(resid / tot) if tot > 0
                                   else smp.draw(p_t))
                    break
            self._accept_tokens(req, slot, emitted)
        if self.spec_policy is not None:
            self.spec_policy.note(round_proposed, round_accepted)

    def _accept_tokens(self, req: _DecodeRequest, slot: int,
                       toks: List[int]) -> None:
        """Fold a burst of emitted tokens into the slot's state, stopping
        at the first terminal condition (EOS / budget / lane end / cancel
        / deadline) — acceptances past a terminal are dropped, their
        cache rows repaired by later writes like any rejected
        proposal."""
        for tok in toks:
            tok = int(tok)
            req.produced.append(tok)
            self.n_tokens += 1
            self._pos[slot] += 1
            self._tokens[slot] = tok
            self._emit_stream(req, [tok])
            if self._retire_if_done(req, tok):
                break

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            waiting = len(self._waiting)
            active = sorted(self._active.items())
            releases = dict(self.releases)
        slots = [{"slot": s,
                  "rid": r.pending.rid,
                  "prompt_len": int(len(r.prompt)),
                  "n_tokens": len(r.produced),
                  "max_new_tokens": r.max_new,
                  "n_pages": len(r.pages),
                  "prefix_hit_tokens": r.hit_len,
                  "streaming": r.stream is not None,
                  "sampling": (r.sampler.describe()
                               if r.sampler is not None else None)}
                 for s, r in active]
        claimable = self.pages.n_pages - 1
        free = self.pages.n_free
        cached = self.prefix.n_cached if self.prefix is not None else 0
        spec = None
        if self.decoder.has_draft:
            proposed = self.n_spec_proposed
            spec = {"k": self.decoder.spec_k,
                    "draft_layers": self.decoder.draft_cfg.n_layers,
                    "rounds": self.n_spec_rounds,
                    "proposed": proposed,
                    "accepted": self.n_spec_accepted,
                    "acceptance_rate": (
                        round(self.n_spec_accepted / proposed, 4)
                        if proposed else None),
                    "proposal_logp_ewma": (
                        round(self.spec_proposal_logp, 4)
                        if self.spec_proposal_logp is not None else None),
                    "verify_ce_impl": self.decoder.verify_ce_impl,
                    "policy": (self.spec_policy.status()
                               if self.spec_policy is not None else None)}
        pages = {"page_size": self.decoder.page_size,
                 "n_pages": claimable,
                 "free": free,
                 "in_use": claimable - free - cached,
                 "cached": cached,
                 "high_water": self.pages.high_water,
                 "n_preempts": self.n_page_preempts,
                 "pool_bytes": self.decoder.pool_bytes(),
                 "per_slot": {str(s): len(r.pages) for s, r in active}}
        return {"n_slots": self.decoder.n_slots,
                "slots_in_use": len(slots),
                "slots_free": self.pool.n_free,
                "slots_high_water": self.slots_high_water,
                "max_len": self.decoder.max_len,
                "paged": True,
                "attn_impl": self.decoder.attn_impl,
                "device": str(self.decoder.device),
                "pages": pages,
                "prefix_cache": (self.prefix.stats()
                                 if self.prefix is not None else None),
                "speculative": spec,
                "placement": self.decoder.placement(),
                "waiting": waiting,
                "max_waiting": self.max_waiting,
                "n_requests": self.n_requests,
                "n_steps": self.n_steps,
                "n_tokens": self.n_tokens,
                "goodput": {
                    "tokens": self.n_goodput_tokens,
                    "total_tokens": self.n_tokens,
                    "ratio": (round(self.n_goodput_tokens
                                    / self.n_tokens, 4)
                              if self.n_tokens else None)},
                "n_prefills": self.n_prefills,
                "n_prompt_tokens": self.n_prompt_tokens,
                "prefill_s": round(self.prefill_s, 4),
                "prefill_tokens_per_s": (
                    round(self.n_prompt_tokens / self.prefill_s, 1)
                    if self.prefill_s > 0 else None),
                "n_step_faults": self.n_step_faults,
                "n_compiles": self.decoder.n_compiles(),
                "release_gap_s": self.release_ewma.gap_s(),
                "retry_after_hint": self.retry_after_hint(),
                "releases": releases,
                "active": slots}
