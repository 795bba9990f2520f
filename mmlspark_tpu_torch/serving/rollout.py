"""Zero-downtime model rollout: versioned hot-swap, canary + shadow
(the port's copy of ``mmlspark_tpu/serving/rollout.py``; it stages the
port's own persisted stages).

The worker-side primitive is :class:`ModelVersionManager` — every
:class:`~mmlspark_tpu_torch.serving.server.ServingServer` owns one. A model
version moves through a state machine::

    load -> verify -> warmup -> staged -> (flip) -> active
                                   \\-> aborted        \\-> previous
    any step may end in: error                          \\-> (rollback)

* **load** — the next version is constructed in the background from a
  checkpoint directory (any persisted stage, ``PipelineStage.load``)
  or handed in as an in-memory model (tests, in-process operators);
  live traffic keeps dispatching on the active version throughout.
* **verify** — checkpoint-path versions must pass **strict** digest
  verification (:func:`mmlspark_tpu_torch.io.checkpoint.verify_digest`)
  before anything else touches them: a truncated, bit-rotted, or
  digest-less checkpoint is never flip-eligible.
* **warmup** — every shape bucket the server dispatches is pushed
  through the NEW version's ``transform`` pre-flip (the same synthetic
  frames :meth:`ServingServer.warmup` builds), so a jitted model's
  compiles all land before the flip and steady-state traffic never
  retraces afterwards (``post_flip_recompiles`` stays 0).
* **flip** — one reference assignment under the manager lock. The
  executor snapshots the active version once per batch, so the flip
  lands exactly *between* batches: a batch dispatched on v1 commits on
  v1, the next batch dispatches on v2, and nothing is dropped, errored,
  or recompiled. Journaled replies are version-pinned by construction —
  a request journaled under v1 and retried after the flip returns the
  v1-committed reply verbatim (replay beats re-dispatch).
* **rollback** — the previous version is kept resident (weights and
  compiled executables both), so rolling back is another between-batch
  reference flip, not a reload.

**Shadow traffic**: while a version is staged, a sampled fraction of
live batches is mirrored through it on a dedicated shadow thread — the
client reply always comes from the active version; the staged version's
outputs are compared column-by-column and latency/mismatch counters
exported (``serving_shadow_*``). Backpressure-safe: shadowing drops
batches rather than ever delaying the live pipeline.

The fleet-side orchestration is :class:`RolloutOrchestrator`, driven by
``POST /rollout`` on the :class:`ServingCoordinator`: stage everywhere,
optionally observe shadow traffic, flip ONE canary worker, compare its
error-rate and dispatch-latency p95 deltas against the rest of the
fleet over the same window (from the workers' existing ``/status``
counters and ``/metrics`` histograms), then either flip the remainder
or auto-rollback the canary. Workers that die mid-rollout are skipped —
survivors finish the flip (the chaos drill in
``tools/chaos_serving.py`` proves it) — but a worker that *reports* a
staging error (corrupt checkpoint, failed warmup) fails the whole
rollout before any flip.

Fault points for chaos tests (``testing/faults``): a manager
constructed with a ``fault_plan`` consults the sites ``rollout_load``,
``rollout_verify``, ``rollout_quant_verify`` (the int8-compute parity
gate), ``rollout_warmup``, and ``rollout_flip``.

See docs/serving.md "Zero-downtime rollout".
"""

from __future__ import annotations

import threading
import time
from queue import Empty, Full, Queue
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.core.logs import get_logger
from mmlspark_tpu_torch.core.telemetry import quantile_from_buckets

logger = get_logger("serving.rollout")

__all__ = ["ModelVersion", "ModelVersionManager", "RolloutError",
           "RolloutOrchestrator"]


class RolloutError(RuntimeError):
    """An illegal rollout transition (flip without a staged version,
    rollback without a previous one, ...)."""


class ModelVersion:
    """One resident model version and its rollout lifecycle state."""

    __slots__ = ("version", "model", "source", "state", "error",
                 "digest_verified", "warmed_buckets", "shapes_seen",
                 "n_post_flip_recompiles", "created_unix", "flipped_unix",
                 "quantization", "quant_parity")

    def __init__(self, version: str, model: Any = None,
                 source: Optional[str] = None, state: str = "loading",
                 quantization=None):
        self.version = version
        self.model = model
        self.source = source
        self.state = state
        self.error: Optional[str] = None
        #: the version's quantized-wire config (serving/quant.py):
        #: the dispatch stage casts assembled frames to its wire dtype
        #: and the model dequantizes on device — carried on the
        #: VERSION so stage -> verify -> warmup -> flip keeps one
        #: coherent wire contract per model (None = the f32 plane)
        self.quantization = quantization
        #: True = strict digest verification passed; None = not
        #: applicable (in-memory model handed in by a trusted caller)
        self.digest_verified: Optional[bool] = None
        self.warmed_buckets: List[int] = []
        #: dispatch-shape keys THIS version has compiled (warmup,
        #: shadow, and live dispatch all record here)
        self.shapes_seen: set = set()
        #: shapes first seen on the live path AFTER this version went
        #: active — the hot-swap contract requires this to stay 0
        self.n_post_flip_recompiles = 0
        self.created_unix = time.time()
        self.flipped_unix: Optional[float] = None
        #: the int8-compute staging gate's evidence (None until a
        #: compute-quantized stage verifies): NNModel.
        #: quant_parity_report's row-wise parity dict
        self.quant_parity: Optional[Dict[str, Any]] = None

    def record_shape(self, key) -> None:
        """Count a dispatch shape against this version (GIL-atomic set
        add; dispatch is single-threaded per plane). A shape not warmed
        pre-flip that shows up on the live path after the flip is a
        post-flip recompile — the number the hot-swap bench gates on."""
        if key not in self.shapes_seen:
            self.shapes_seen.add(key)
            if self.flipped_unix is not None:
                self.n_post_flip_recompiles += 1

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "state": self.state,
            "source": self.source,
            "quantization": (self.quantization.to_dict()
                             if self.quantization is not None else None),
            "digest_verified": self.digest_verified,
            "warmed_buckets": list(self.warmed_buckets),
            "n_shapes": len(self.shapes_seen),
            "post_flip_recompiles": self.n_post_flip_recompiles,
            "quant_parity": self.quant_parity,
            "created_unix": round(self.created_unix, 3),
            "flipped_unix": (round(self.flipped_unix, 3)
                             if self.flipped_unix is not None else None),
            "error": self.error,
        }


class ModelVersionManager:
    """Versioned hot-swap for one :class:`ServingServer`.

    Owns the ``active`` version the dispatch stage reads (one attribute
    read per batch — the flip is a reference assignment, atomic under
    the GIL and taken under the manager lock), at most one ``staged``
    next version, and the ``previous`` version kept resident for
    instant rollback.
    """

    #: states from which a staged version may be replaced by a new stage
    _REPLACEABLE = ("error", "aborted")

    def __init__(self, server, model: Any, version: str = "v1",
                 verify_checkpoints: bool = True,
                 fault_plan=None,
                 shadow_queue_depth: int = 4,
                 quantization=None):
        self._server = server
        self.verify_checkpoints = bool(verify_checkpoints)
        self.fault_plan = fault_plan
        self._lock = threading.RLock()
        self._active = ModelVersion(version, model=model, state="active",
                                    quantization=quantization)
        self._staged: Optional[ModelVersion] = None
        self._previous: Optional[ModelVersion] = None
        self.n_flips = 0
        self.n_rollbacks = 0
        self.n_rollout_failures = 0
        # -- shadow traffic: a sampled fraction of live batches is
        # mirrored through the staged version on THIS thread, never the
        # pipeline's. The queue is shallow and non-blocking on purpose:
        # when the shadow can't keep up, batches are dropped (counted),
        # and the live path never waits.
        self.shadow_fraction = 0.0
        self._shadow_tick = 0
        self._shadow_q: "Queue[Tuple[ModelVersion, Any, Any]]" = \
            Queue(maxsize=max(int(shadow_queue_depth), 1))
        self._shadow_thread: Optional[threading.Thread] = None
        self._shadow_stop = threading.Event()
        self.n_shadow_batches = 0
        self.n_shadow_rows = 0
        self.n_shadow_mismatched_rows = 0
        self.n_shadow_errors = 0
        self.n_shadow_dropped = 0
        self._register_metrics(server.registry)

    # -- telemetry -----------------------------------------------------------

    def _register_metrics(self, registry) -> None:
        self._m_version = registry.gauge(
            "serving_model_version",
            "1 for the worker's active model version, 0 for any other "
            "version this process has served (flip/rollback history).",
            labels=("version",))
        self._m_version.labels(self._active.version).set(1)
        self._m_requests_by_version = registry.counter(
            "serving_requests_by_version_total",
            "Requests committed per model version (which version's "
            "transform produced each reply).", labels=("version",))
        for name, help_, attr in (
            ("serving_version_flips_total",
             "Model-version flips (staged -> active).", "n_flips"),
            ("serving_version_rollbacks_total",
             "Rollbacks to the previous resident version.",
             "n_rollbacks"),
            ("serving_rollout_failures_total",
             "Version stagings that ended in error (failed digest "
             "verification, load, or warmup).", "n_rollout_failures"),
            ("serving_shadow_batches_total",
             "Live batches mirrored through the staged version.",
             "n_shadow_batches"),
            ("serving_shadow_mismatched_rows_total",
             "Shadow rows whose staged-version output differed from "
             "the active version's.", "n_shadow_mismatched_rows"),
            ("serving_shadow_errors_total",
             "Shadow dispatches that raised (staged-model failures "
             "observed off the client path).", "n_shadow_errors"),
            ("serving_shadow_dropped_total",
             "Sampled batches dropped because the shadow thread was "
             "behind (shadowing never delays live traffic).",
             "n_shadow_dropped"),
        ):
            registry.counter(name, help_).set_function(
                lambda a=attr: getattr(self, a))
        self._m_shadow_latency = registry.histogram(
            "serving_shadow_dispatch_latency_ms",
            "Staged-version transform wall-clock for mirrored batches "
            "(compare against serving_dispatch_latency_ms pre-flip).")

    # -- read side (dispatch path) -------------------------------------------

    @property
    def active(self) -> ModelVersion:
        return self._active

    @property
    def staged(self) -> Optional[ModelVersion]:
        return self._staged

    @property
    def previous(self) -> Optional[ModelVersion]:
        return self._previous

    def count_committed(self, version: str, n: int) -> None:
        if n > 0:
            self._m_requests_by_version.labels(version).inc(n)

    # -- staging -------------------------------------------------------------

    def stage(self, source: Optional[str] = None, model: Any = None,
              version: Optional[str] = None,
              warmup_payload: Any = None,
              shadow_fraction: Optional[float] = None,
              quantization=None,
              sync: bool = False) -> Dict[str, Any]:
        """Begin staging the next version from a checkpoint ``source``
        (or an in-memory ``model``). Runs load -> verify -> warmup in
        the background (``sync=True`` runs it inline — tests and the
        serial callers); live traffic is untouched either way.
        ``quantization`` (a config or dict — see serving/quant.py)
        declares the staged version's wire contract: it is validated
        HERE (malformed -> ValueError -> 400 at the endpoint), rides
        the ModelVersion through verify/warmup/flip, and defaults to
        whatever config the loaded model itself carries. Returns the
        staged version's status snapshot."""
        if source is None and model is None:
            raise RolloutError("stage() needs a checkpoint source or "
                               "an in-memory model")
        from mmlspark_tpu_torch.serving.quant import QuantizationConfig
        quantization = QuantizationConfig.from_value(quantization)
        with self._lock:
            if self._staged is not None and \
                    self._staged.state not in self._REPLACEABLE and \
                    self._staged.state == "staged":
                # restaging over a healthy staged version is allowed
                # (a newer candidate supersedes it) but logged
                logger.info("replacing staged version %s with %s",
                            self._staged.version, version)
            if version is None:
                version = f"v{self.n_flips + 2}"
            if version == self._active.version:
                raise RolloutError(
                    f"version {version!r} is already active")
            mv = ModelVersion(version, model=model, source=source,
                              quantization=quantization)
            self._staged = mv
            if shadow_fraction is not None:
                self.shadow_fraction = max(float(shadow_fraction), 0.0)
        if sync:
            self._prepare(mv, warmup_payload)
        else:
            threading.Thread(target=self._prepare,
                             args=(mv, warmup_payload),
                             daemon=True,
                             name="rollout-stage").start()
        return mv.to_dict()

    def _fault(self, site: str) -> None:
        if self.fault_plan is not None:
            self.fault_plan.raise_at(site)

    def _prepare(self, mv: ModelVersion, warmup_payload: Any) -> None:
        try:
            self._fault("rollout_load")
            if mv.model is None:
                mv.state = "verifying"
                self._fault("rollout_verify")
                if self.verify_checkpoints:
                    from mmlspark_tpu_torch.io.checkpoint import verify_digest
                    ok, detail = verify_digest(mv.source, strict=True)
                    if not ok:
                        raise RolloutError(
                            f"checkpoint {mv.source} is not "
                            f"flip-eligible: {detail}")
                    mv.digest_verified = True
                # already verified strictly above (or verification is
                # explicitly off) — don't hash the tree twice
                from mmlspark_tpu_torch.core.serialize import load_stage
                mv.model = load_stage(mv.source, verify=False)
            if mv.quantization is None:
                # a persisted quantized checkpoint carries its own wire
                # contract (NNModel saves quantization.json) — adopt it
                from mmlspark_tpu_torch.serving.quant import QuantizationConfig
                mv.quantization = QuantizationConfig.from_value(
                    getattr(mv.model, "quantization", None))
            if mv.quantization is not None:
                # the model's on-device dequant must match the wire the
                # dispatch stage will cast to — one config drives both
                mv.quantization.configure_model(mv.model)
            if mv.quantization is not None \
                    and mv.quantization.compute is not None:
                # int8-compute staging gate: the quantized forward must
                # hold row-wise parity with the f32 reference within
                # the config's tolerance BEFORE any warmup work — a
                # broken scale config (or a model the quantization
                # genuinely hurts) dies here, state -> "error", and the
                # active version keeps serving: the automatic rollback
                mv.state = "verifying"
                self._fault("rollout_quant_verify")
                self._verify_compute_quant(mv, warmup_payload)
            mv.state = "warming"
            self._fault("rollout_warmup")
            self._warm(mv, warmup_payload)
            mv.state = "staged"
            logger.info(
                "model version %s staged (source=%s, verified=%s, "
                "warmed buckets %s)", mv.version, mv.source,
                mv.digest_verified, mv.warmed_buckets)
        except Exception as e:  # noqa: BLE001 — any staging failure is
            # terminal for THIS candidate; the active version serves on
            mv.state = "error"
            mv.error = str(e) or type(e).__name__
            self.n_rollout_failures += 1
            logger.warning("staging model version %s failed: %s",
                           mv.version, mv.error)

    def _verify_compute_quant(self, mv: ModelVersion,
                              warmup_payload: Any) -> None:
        """The int8-compute parity gate: score ONE reference frame
        (the warmup payload at the smallest bucket) through the staged
        model's quantized forward and its f32 reference, row-wise
        within the config's tolerance (``NNModel.quant_parity_report``
        — the same dequant math the served executable runs). Models
        without the surface (no ``quant_parity_report``) refuse: a
        compute section on a model that cannot honor it must not stage
        silently."""
        if not hasattr(mv.model, "quant_parity_report"):
            raise RolloutError(
                f"version {mv.version}: quantization.compute needs a "
                f"model with the int8-compute surface "
                f"(NNModel.quant_parity_report); "
                f"{type(mv.model).__name__} has none")
        srv = self._server
        payload = warmup_payload if warmup_payload is not None \
            else srv.warmup_payload
        if payload is None:
            raise RolloutError(
                f"version {mv.version}: quantization.compute needs a "
                "warmup payload to verify parity against (pass "
                "warmup_payload, or warm the server once)")
        if getattr(mv.model, "_compute_quant", None) is None:
            # configure_model should have attached the config — a model
            # that did not adopt it would pass a vacuous 0-row report
            # and then serve f32
            raise RolloutError(
                f"version {mv.version}: model did not adopt the "
                "compute quantization config (quantization.compute is "
                "unset on the model)")
        sizes = srv._bucket_sizes(model=mv.model)
        df = srv._warmup_frame(payload, sizes[0], qc=mv.quantization)
        report = mv.model.quant_parity_report(df)
        mv.quant_parity = report
        if not report["rows"]:
            raise RolloutError(
                f"version {mv.version}: int8-compute parity frame was "
                "empty — nothing verified")
        if not report["passed"]:
            raise RolloutError(
                f"version {mv.version}: int8-compute parity failed — "
                f"{report['bad_rows']}/{report['rows']} rows outside "
                f"rtol={report['rtol']} (max_rel={report['max_rel']:.4g})"
            )
        logger.info(
            "model version %s int8-compute parity verified: %s rows "
            "within rtol=%s (max_rel=%.4g)", mv.version,
            report["rows"], report["rtol"], report["max_rel"])

    def _warm(self, mv: ModelVersion, warmup_payload: Any) -> None:
        """Dispatch one synthetic batch per shape bucket through the
        STAGED version (never the live plane): the same frames
        ``ServingServer.warmup`` builds, so after the flip the live
        shape set is closed under every bucket the server can emit."""
        srv = self._server
        payload = warmup_payload if warmup_payload is not None \
            else srv.warmup_payload
        if payload is None:
            logger.warning(
                "no warmup payload for version %s (pass warmup_payload, "
                "or warm the server once so it remembers one): flipping "
                "without pre-flip warmup risks post-flip recompiles",
                mv.version)
            return
        # the STAGED version's ladder AND wire config, not the active
        # one's: a staged version with different sharding
        # (batch_multiple) or a different quantization contract must
        # warm exactly the bucket shapes + dtypes live traffic will
        # dispatch after ITS flip, or the flip retraces
        for n in srv._bucket_sizes(model=mv.model):
            df = srv._warmup_frame(payload, n, qc=mv.quantization)
            out = mv.model.transform(df)
            if out.num_rows != df.num_rows:
                raise RolloutError(
                    f"version {mv.version} returned {out.num_rows} rows "
                    f"for a {df.num_rows}-row warmup dispatch; serving "
                    f"models must preserve row count")
            mv.record_shape(srv._shape_key(df))
            mv.warmed_buckets.append(df.num_rows)

    # -- transitions ---------------------------------------------------------

    def flip(self, version: Optional[str] = None) -> Dict[str, Any]:
        """Atomically make the staged version active. The dispatch
        stage snapshots ``active`` once per batch, so the swap lands
        between batches: in-flight batches finish on the version that
        dispatched them. Raises :class:`RolloutError` unless a staged
        version (matching ``version``, when given) is fully prepared."""
        with self._lock:
            mv = self._staged
            if mv is None:
                raise RolloutError("no staged version to flip to")
            if version is not None and mv.version != version:
                raise RolloutError(
                    f"staged version is {mv.version!r}, not {version!r}")
            if mv.state != "staged":
                raise RolloutError(
                    f"version {mv.version!r} is not flip-eligible "
                    f"(state={mv.state!r}, error={mv.error!r})")
            self._fault("rollout_flip")
            prev = self._active
            mv.state = "active"
            mv.flipped_unix = time.time()
            # THE flip: one reference assignment — the next batch the
            # executor collects dispatches on the new version
            self._active = mv
            prev.state = "previous"
            self._previous = prev
            self._staged = None
            self.shadow_fraction = 0.0
            self.n_flips += 1
            self._m_version.labels(prev.version).set(0)
            self._m_version.labels(mv.version).set(1)
            logger.info("model version flipped: %s -> %s (warmed "
                        "buckets %s)", prev.version, mv.version,
                        mv.warmed_buckets)
            return self.status()

    def rollback(self) -> Dict[str, Any]:
        """Flip back to the previous resident version — the same
        between-batch swap, no reload, no warmup (its executables are
        still resident). One level deep by design: a rollback of a
        rollback is a no-op error."""
        with self._lock:
            prev = self._previous
            if prev is None:
                raise RolloutError("no previous version to roll back to")
            cur = self._active
            prev.state = "active"
            # re-activation keeps flipped_unix: its shape set is already
            # closed, and any genuinely new shape is still a recompile
            if prev.flipped_unix is None:
                prev.flipped_unix = time.time()
            self._active = prev
            cur.state = "retired"
            self._previous = None
            self.n_rollbacks += 1
            self._m_version.labels(cur.version).set(0)
            self._m_version.labels(prev.version).set(1)
            logger.warning("model version rolled back: %s -> %s",
                           cur.version, prev.version)
            return self.status()

    def abort(self) -> Dict[str, Any]:
        """Discard the staged version (if any) and stop shadowing."""
        with self._lock:
            if self._staged is not None:
                self._staged.state = "aborted"
                logger.info("staged version %s aborted",
                            self._staged.version)
                self._staged = None
            self.shadow_fraction = 0.0
            return self.status()

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "active": self._active.to_dict(),
                "staged": (self._staged.to_dict()
                           if self._staged is not None else None),
                "previous": (self._previous.to_dict()
                             if self._previous is not None else None),
                "n_flips": self.n_flips,
                "n_rollbacks": self.n_rollbacks,
                "n_rollout_failures": self.n_rollout_failures,
                "shadow": {
                    "fraction": self.shadow_fraction,
                    "batches": self.n_shadow_batches,
                    "rows": self.n_shadow_rows,
                    "mismatched_rows": self.n_shadow_mismatched_rows,
                    "errors": self.n_shadow_errors,
                    "dropped": self.n_shadow_dropped,
                },
            }

    # -- shadow traffic ------------------------------------------------------

    def maybe_shadow(self, df, out) -> None:
        """Called by the dispatch stage after a successful live
        dispatch: mirror this batch to the staged version if sampling
        selects it. Deterministic counter-based sampling (every
        round(1/fraction)-th batch), non-blocking enqueue — the live
        pipeline never waits on the shadow."""
        frac = self.shadow_fraction
        if frac <= 0.0:
            return
        staged = self._staged
        if staged is None or staged.state != "staged":
            return
        self._shadow_tick += 1
        if self._shadow_tick % max(int(round(1.0 / min(frac, 1.0))), 1):
            return
        if self._shadow_thread is None or \
                not self._shadow_thread.is_alive():
            self._shadow_stop.clear()
            self._shadow_thread = threading.Thread(
                target=self._shadow_loop, daemon=True,
                name="rollout-shadow")
            self._shadow_thread.start()
        try:
            self._shadow_q.put_nowait((staged, df, out))
        except Full:
            self.n_shadow_dropped += 1

    def _shadow_loop(self) -> None:
        while not self._shadow_stop.is_set():
            try:
                staged, df, out = self._shadow_q.get(timeout=0.2)
            except Empty:
                continue
            try:
                if staged.quantization is not None:
                    # mirror what the staged version would REALLY see
                    # post-flip: its own wire cast (a no-op when the
                    # live frame already rode the same wire)
                    df = staged.quantization.quantize_frame(df)
                t0 = time.perf_counter()
                shadow_out = staged.model.transform(df)
                self._m_shadow_latency.observe(
                    (time.perf_counter() - t0) * 1000.0)
                staged.record_shape(self._server._shape_key(df))
                comp = (staged.quantization.compute
                        if staged.quantization is not None else None)
                self._compare(df, out, shadow_out,
                              rtol=(comp.tolerance
                                    if comp is not None else None))
                self.n_shadow_batches += 1
                # shadow-output sampling: a
                # bounded slice of each mirrored batch — inputs, live
                # outputs, staged outputs side by side — lands in the
                # traffic-capture journal for offline diffing beyond
                # the in-process mismatch counters. Non-blocking.
                cap = getattr(self._server, "capture", None)
                if cap is not None:
                    cap.offer_shadow(self._active.version,
                                     staged.version, df, out,
                                     shadow_out)
            except Exception as e:  # noqa: BLE001 — a failing staged
                # model is exactly what shadowing exists to observe
                self.n_shadow_errors += 1
                logger.warning("shadow dispatch on version %s failed: "
                               "%s", staged.version, e)

    def _compare(self, df, live_out, shadow_out,
                 rtol: Optional[float] = None) -> None:
        """Row-wise comparison over the columns the live model ADDED
        (the reply surface): numeric columns compare with a small
        tolerance, everything else exactly. ``rtol`` widens the
        numeric tolerance when the STAGED version quantizes compute
        (its config's ``tolerance`` — int8-vs-f32 rows inside it are
        the expected quantization step, not a mismatch; rows outside
        it still count)."""
        cols = [c for c in live_out.columns
                if c not in df.columns and c in shadow_out.columns]
        n = live_out.num_rows
        if not cols or n == 0:
            self.n_shadow_rows += n
            return
        # under a compute-quantized staged version the tolerance bounds
        # BOTH relative and absolute error (int8 weight noise is
        # additive at logit scale — see NNModel.quant_parity_report)
        num_rtol = 1e-5 if rtol is None else float(rtol)
        num_atol = 1e-8 if rtol is None else float(rtol)
        mismatch = np.zeros(n, dtype=bool)
        for c in cols:
            a = np.asarray(live_out[c])
            b = np.asarray(shadow_out[c])
            if b.shape != a.shape:
                mismatch[:] = True
                break
            if a.dtype.kind in "fc" or b.dtype.kind in "fc":
                bad = ~np.isclose(a.astype(np.float64),
                                  b.astype(np.float64),
                                  rtol=num_rtol, atol=num_atol,
                                  equal_nan=True)
            else:
                bad = a != b
            mismatch |= bad.reshape(n, -1).any(axis=1)
        self.n_shadow_rows += n
        self.n_shadow_mismatched_rows += int(mismatch.sum())

    def close(self) -> None:
        self._shadow_stop.set()
        t = self._shadow_thread
        if t is not None and t.is_alive():
            t.join(timeout=2)


# ---------------------------------------------------------------------------
# Coordinator-side orchestration
# ---------------------------------------------------------------------------

class RolloutOrchestrator:
    """One fleet rollout, staged across every registered worker.

    Phases (reported live via :meth:`status` / the coordinator's
    ``GET /rollout``):

    ``staging``  POST ``/rollout/stage`` to every worker, poll each
                 worker's ``GET /version`` until its staged version is
                 ``staged`` or errored. A worker that *reports* an
                 error (failed digest verification, load, warmup) fails
                 the whole rollout — nothing flips anywhere. A worker
                 that is *unreachable* is skipped: survivors roll out
                 (the kill-mid-rollout contract).
    ``shadow``   (optional) observe mirrored-traffic stats for
                 ``shadow_window_s``; an aggregate mismatch rate above
                 ``max_shadow_mismatch_rate`` fails the rollout
                 pre-flip.
    ``canary``   flip ONE worker, wait until it has served
                 ``canary_min_requests`` more requests (or the window
                 expires), then compare its error-rate delta and
                 dispatch-latency p95 against the non-canary fleet over
                 the same window. Regression -> roll the canary back,
                 abort the staged version everywhere, end
                 ``rolled_back``.
    ``flipping`` flip the remaining workers; end ``completed``.

    With ``path=None`` the rollout is flip-only: workers must already
    hold ``version`` staged (in-process staging, pre-distributed
    checkpoints) — the orchestrator verifies and proceeds from the
    shadow/canary phase.
    """

    _RUNNING = ("staging", "shadow", "canary", "flipping",
                "rolling_back")

    def __init__(self, coordinator, version: str,
                 path: Optional[str] = None,
                 warmup_payload: Any = None,
                 canary: bool = True,
                 shadow_fraction: float = 0.0,
                 shadow_window_s: float = 0.0,
                 max_shadow_mismatch_rate: float = 0.01,
                 canary_window_s: float = 5.0,
                 canary_min_requests: int = 20,
                 max_error_rate_delta: float = 0.02,
                 max_p95_ratio: float = 3.0,
                 stage_timeout_s: float = 60.0,
                 poll_interval_s: float = 0.1,
                 http_timeout_s: float = 5.0,
                 quantization: Optional[Dict[str, Any]] = None):
        self.coordinator = coordinator
        self.version = str(version)
        self.path = path
        self.warmup_payload = warmup_payload
        # validated up front (ValueError -> 400 at POST /rollout), then
        # forwarded verbatim to every worker's stage body
        from mmlspark_tpu_torch.serving.quant import QuantizationConfig
        qc = QuantizationConfig.from_value(quantization)
        self.quantization = qc.to_dict() if qc is not None else None
        self.canary = bool(canary)
        self.shadow_fraction = float(shadow_fraction)
        self.shadow_window_s = float(shadow_window_s)
        self.max_shadow_mismatch_rate = float(max_shadow_mismatch_rate)
        self.canary_window_s = float(canary_window_s)
        self.canary_min_requests = int(canary_min_requests)
        self.max_error_rate_delta = float(max_error_rate_delta)
        self.max_p95_ratio = float(max_p95_ratio)
        self.stage_timeout_s = float(stage_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self.http_timeout_s = float(http_timeout_s)
        self.state = "pending"
        self.detail: Optional[str] = None
        self.workers: Dict[str, Dict[str, Any]] = {}
        self.canary_worker: Optional[str] = None
        self.decision: Optional[Dict[str, Any]] = None
        self.started_unix = time.time()
        self.finished_unix: Optional[float] = None
        self._thread: Optional[threading.Thread] = None

    # -- tiny HTTP helpers ---------------------------------------------------

    def _get(self, wk: str, path: str):
        import requests
        r = requests.get(f"http://{wk}{path}",
                         timeout=self.http_timeout_s)
        r.raise_for_status()
        return r.json() if "json" in r.headers.get(
            "Content-Type", "application/json") else r.text

    def _post(self, wk: str, path: str, body: Dict[str, Any]):
        import requests
        r = requests.post(f"http://{wk}{path}", json=body,
                          timeout=self.http_timeout_s)
        r.raise_for_status()
        return r.json()

    def _mark_unreachable(self, wk: str, err: Exception) -> None:
        self.workers[wk] = {"state": "unreachable", "error": str(err)}
        logger.warning("rollout: worker %s unreachable (%s); skipping",
                       wk, err)

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self.state in self._RUNNING

    def start(self) -> "RolloutOrchestrator":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rollout-orchestrator")
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def status(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "version": self.version,
            "path": self.path,
            "canary": self.canary,
            "canary_worker": self.canary_worker,
            "shadow_fraction": self.shadow_fraction,
            "quantization": self.quantization,
            # dict() copies are C-level, atomic under the GIL: the
            # orchestrator thread populates/mutates self.workers
            # concurrently with /rollout handlers calling this — a
            # comprehension over the live dict could raise "changed
            # size during iteration" mid-population
            "workers": {wk: dict(st)
                        for wk, st in dict(self.workers).items()},
            "decision": self.decision,
            "detail": self.detail,
            "started_unix": round(self.started_unix, 3),
            "finished_unix": (round(self.finished_unix, 3)
                              if self.finished_unix else None),
        }

    def _finish(self, state: str, detail: Optional[str] = None) -> None:
        self.state = state
        self.detail = detail
        self.finished_unix = time.time()
        (logger.warning if state in ("failed", "rolled_back")
         else logger.info)("rollout %s ended %s%s", self.version, state,
                           f": {detail}" if detail else "")

    def _run(self) -> None:
        try:
            self._run_phases()
        except Exception as e:  # noqa: BLE001 — an orchestration bug
            # must surface in /rollout, never kill the coordinator
            logger.error("rollout orchestration crashed", exc_info=True)
            self._finish("failed", f"orchestrator error: {e}")

    # -- phases --------------------------------------------------------------

    def _live_workers(self) -> List[str]:
        return [wk for wk, st in self.workers.items()
                if st.get("state") not in ("unreachable", "error")]

    def _run_phases(self) -> None:
        services = self.coordinator.services()
        targets = [f"{s.get('host')}:{s.get('port')}" for s in services]
        if not targets:
            self._finish("failed", "no workers registered")
            return
        for wk in targets:
            self.workers[wk] = {"state": "pending"}

        # -- phase: staging
        self.state = "staging"
        if not self._stage_all(targets):
            return
        live = self._live_workers()
        if not live:
            self._finish("failed", "no worker finished staging")
            return

        # -- phase: shadow observation (optional, pre-flip)
        if self.shadow_fraction > 0 and self.shadow_window_s > 0:
            self.state = "shadow"
            if not self._observe_shadow(live):
                return

        # -- phase: canary
        to_flip = list(live)
        if self.canary and len(live) >= 2:
            self.state = "canary"
            self.canary_worker = live[0]
            if not self._canary_phase(self.canary_worker, live[1:]):
                return
            self.workers[self.canary_worker]["state"] = "active"
            to_flip = [wk for wk in live if wk != self.canary_worker]

        # -- phase: flip the rest
        self.state = "flipping"
        for wk in to_flip:
            try:
                self._post(wk, "/rollout/flip",
                           {"version": self.version})
                self.workers[wk]["state"] = "active"
            except Exception as e:  # noqa: BLE001 — died mid-rollout:
                self._mark_unreachable(wk, e)   # survivors finish
        if not self._live_workers():
            self._finish("failed", "every worker died before the flip")
            return
        self._finish("completed")

    def _stage_all(self, targets: List[str]) -> bool:
        """Stage (or, path-less, confirm an existing staging) on every
        worker. Returns False (after aborting the healthy stagings)
        when any worker REPORTS a staging error."""
        for wk in targets:
            if self.path is not None:
                body = {"path": self.path, "version": self.version}
                if self.warmup_payload is not None:
                    body["warmup_payload"] = self.warmup_payload
                if self.shadow_fraction > 0:
                    body["shadow_fraction"] = self.shadow_fraction
                if self.quantization is not None:
                    body["quantization"] = self.quantization
                try:
                    self._post(wk, "/rollout/stage", body)
                    self.workers[wk]["state"] = "staging"
                except Exception as e:  # noqa: BLE001
                    self._mark_unreachable(wk, e)
            else:
                self.workers[wk]["state"] = "staging"
        deadline = time.monotonic() + self.stage_timeout_s
        failed: Optional[str] = None
        while time.monotonic() < deadline:
            pending = False
            for wk, st in self.workers.items():
                if st.get("state") != "staging":
                    continue
                try:
                    v = self._get(wk, "/version")
                except Exception as e:  # noqa: BLE001
                    self._mark_unreachable(wk, e)
                    continue
                staged = v.get("staged") or {}
                if staged.get("version") == self.version:
                    if staged.get("state") == "staged":
                        st["state"] = "staged"
                        st["digest_verified"] = \
                            staged.get("digest_verified")
                        continue
                    if staged.get("state") == "error":
                        st["state"] = "error"
                        st["error"] = staged.get("error")
                        failed = f"{wk}: {staged.get('error')}"
                        continue
                elif (v.get("active") or {}).get("version") == \
                        self.version:
                    # already active there (a resumed rollout)
                    st["state"] = "active"
                    continue
                elif self.path is None:
                    # flip-only rollout: the version simply isn't there
                    st["state"] = "error"
                    st["error"] = (f"version {self.version!r} not "
                                   f"staged on this worker")
                    failed = f"{wk}: {st['error']}"
                    continue
                pending = True
            if failed is not None:
                break
            if not pending:
                break
            time.sleep(self.poll_interval_s)
        else:
            failed = "staging timed out"
        for wk, st in self.workers.items():
            if st.get("state") == "staging":
                st["state"] = "error"
                st["error"] = "staging timed out"
                failed = failed or f"{wk}: staging timed out"
        if failed is not None:
            self._abort_staged()
            self._finish("failed", f"staging failed ({failed})")
            return False
        return True

    def _abort_staged(self) -> None:
        for wk, st in self.workers.items():
            if st.get("state") in ("staged", "staging"):
                try:
                    self._post(wk, "/rollout/abort", {})
                    st["state"] = "aborted"
                except Exception:  # noqa: BLE001 — best effort
                    pass

    def _shadow_counts(self, wk: str) -> Tuple[int, int, int]:
        sh = self._get(wk, "/version").get("shadow") or {}
        return (int(sh.get("rows") or 0),
                int(sh.get("mismatched_rows") or 0),
                int(sh.get("errors") or 0))

    def _observe_shadow(self, live: List[str]) -> bool:
        # window DELTAS, like the canary phase: the worker counters are
        # lifetime totals, so a failed shadow rollout's mismatches must
        # not poison every later rollout's gate
        before: Dict[str, Tuple[int, int, int]] = {}
        for wk in list(live):
            try:
                before[wk] = self._shadow_counts(wk)
            except Exception as e:  # noqa: BLE001
                self._mark_unreachable(wk, e)
        time.sleep(self.shadow_window_s)
        rows = mismatched = errors = 0
        for wk in list(live):
            if wk not in before:
                continue
            try:
                after = self._shadow_counts(wk)
            except Exception as e:  # noqa: BLE001
                self._mark_unreachable(wk, e)
                continue
            rows += max(after[0] - before[wk][0], 0)
            mismatched += max(after[1] - before[wk][1], 0)
            errors += max(after[2] - before[wk][2], 0)
        rate = (mismatched / rows) if rows else None
        self.decision = {"phase": "shadow", "shadow_rows": rows,
                         "shadow_mismatched_rows": mismatched,
                         "shadow_errors": errors,
                         "shadow_mismatch_rate": rate}
        if errors > 0 or (rate is not None
                          and rate > self.max_shadow_mismatch_rate):
            self._abort_staged()
            self._finish("failed",
                         f"shadow traffic regressed (mismatch rate "
                         f"{rate}, errors {errors})")
            return False
        return True

    # -- canary telemetry ----------------------------------------------------

    def _worker_counters(self, wk: str) -> Dict[str, Any]:
        """One comparison snapshot: request/error counters from
        ``/status``, cumulative dispatch-latency buckets (summed over
        shape buckets, per ``le`` edge) from the worker's own
        ``/metrics`` registry."""
        from mmlspark_tpu_torch.core.telemetry import parse_prometheus
        status = self._get(wk, "/status")
        text = self._get(wk, "/metrics?scope=server")
        if not isinstance(text, str):
            text = str(text)
        cum: Dict[float, float] = {}
        for name, labels, value in parse_prometheus(text):
            if name != "serving_dispatch_latency_ms_bucket":
                continue
            le = dict(labels).get("le")
            edge = float("inf") if le == "+Inf" else float(le)
            cum[edge] = cum.get(edge, 0.0) + value
        return {"requests": int(status.get("n_requests") or 0),
                "errors": int(status.get("n_errors") or 0),
                "buckets": cum}

    @staticmethod
    def _delta_p95(before: Dict[float, float],
                   after: Dict[float, float]) -> Optional[float]:
        edges = sorted(e for e in after if e != float("inf"))
        if not edges:
            return None
        cum_deltas = [max(after.get(e, 0.0) - before.get(e, 0.0), 0.0)
                      for e in edges]
        inf_delta = max(after.get(float("inf"), 0.0)
                        - before.get(float("inf"), 0.0), 0.0)
        counts = [cum_deltas[0]] + [
            max(b - a, 0.0)
            for a, b in zip(cum_deltas, cum_deltas[1:])]
        counts.append(max(inf_delta - cum_deltas[-1], 0.0))
        return quantile_from_buckets(tuple(edges),
                                     [int(c) for c in counts], 0.95)

    def _canary_phase(self, canary: str, rest: List[str]) -> bool:
        # baseline snapshot tolerates individual worker deaths — only
        # the CANARY's own failure may fail the phase (a non-canary
        # worker dying mid-rollout is exactly the case survivors must
        # roll through)
        before: Dict[str, Dict[str, Any]] = {}
        for wk in [canary] + rest:
            try:
                before[wk] = self._worker_counters(wk)
            except Exception as e:  # noqa: BLE001
                self._mark_unreachable(wk, e)
        rest = [wk for wk in rest if wk in before]
        if canary not in before:
            self._abort_staged()
            self._finish("failed",
                         f"canary {canary} died before the flip")
            return False
        try:
            self._post(canary, "/rollout/flip", {"version": self.version})
        except Exception as e:  # noqa: BLE001 — canary died at flip:
            # nothing new is live anywhere; fail safe
            self._abort_staged()
            self._finish("failed", f"canary {canary} failed to flip: "
                                   f"{e}")
            return False
        self.workers[canary]["state"] = "canary"
        deadline = time.monotonic() + self.canary_window_s
        while time.monotonic() < deadline:
            try:
                st = self._get(canary, "/status")
            except Exception as e:  # noqa: BLE001 — canary died while
                # canarying: roll the fleet's staging back, fail safe
                self._mark_unreachable(canary, e)
                self._abort_staged()
                self._finish("failed",
                             f"canary {canary} died mid-observation")
                return False
            if int(st.get("n_requests") or 0) - \
                    before[canary]["requests"] >= self.canary_min_requests:
                break
            time.sleep(self.poll_interval_s)
        after = {}
        for wk in [canary] + rest:
            try:
                after[wk] = self._worker_counters(wk)
            except Exception as e:  # noqa: BLE001
                self._mark_unreachable(wk, e)
        if canary not in after:
            self._abort_staged()
            self._finish("failed", f"canary {canary} died at evaluation")
            return False

        def rates(wks) -> Tuple[int, int]:
            req = sum(after[w]["requests"] - before[w]["requests"]
                      for w in wks if w in after)
            err = sum(after[w]["errors"] - before[w]["errors"]
                      for w in wks if w in after)
            return max(req, 0), max(err, 0)

        c_req, c_err = rates([canary])
        b_req, b_err = rates([w for w in rest if w in after])
        c_rate = (c_err / c_req) if c_req else 0.0
        b_rate = (b_err / b_req) if b_req else 0.0
        c_p95 = self._delta_p95(before[canary]["buckets"],
                                after[canary]["buckets"])
        b_p95s = [self._delta_p95(before[w]["buckets"],
                                  after[w]["buckets"])
                  for w in rest if w in after]
        b_p95s = [p for p in b_p95s if p is not None]
        b_p95 = max(b_p95s) if b_p95s else None
        err_regressed = (c_req > 0 and
                         c_rate > b_rate + self.max_error_rate_delta)
        lat_regressed = (c_p95 is not None and b_p95 is not None
                         and b_p95 > 0
                         and c_p95 > b_p95 * self.max_p95_ratio)
        self.decision = {
            "phase": "canary", "canary_worker": canary,
            "canary_requests": c_req, "canary_errors": c_err,
            "canary_error_rate": round(c_rate, 4),
            "baseline_requests": b_req, "baseline_errors": b_err,
            "baseline_error_rate": round(b_rate, 4),
            "canary_p95_ms": (round(c_p95, 3)
                              if c_p95 is not None else None),
            "baseline_p95_ms": (round(b_p95, 3)
                                if b_p95 is not None else None),
            "error_regressed": err_regressed,
            "latency_regressed": lat_regressed,
        }
        if err_regressed or lat_regressed:
            self.state = "rolling_back"
            try:
                self._post(canary, "/rollout/rollback", {})
                self.workers[canary]["state"] = "rolled_back"
            except Exception as e:  # noqa: BLE001 — a canary that
                # can't roll back is an operator page, not a silent pass
                self.workers[canary]["state"] = "rollback_failed"
                self.workers[canary]["error"] = str(e)
            self._abort_staged()
            self._finish(
                "rolled_back",
                "canary regressed "
                f"(errors: {c_rate:.3f} vs {b_rate:.3f}, p95: "
                f"{c_p95 if c_p95 is None else round(c_p95, 3)} vs "
                f"{b_p95 if b_p95 is None else round(b_p95, 3)} ms)")
            return False
        return True
