"""RetrainLoop: auto-redeploy freshly trained checkpoints through the
fleet rollout gates (the port of ``mmlspark_tpu/streaming/loop.py``).

The last arc of the retrain->redeploy loop: watch the directory where
``NNLearner.fit_stream`` exports its digest-manifested model
checkpoints, and push each new flip-eligible export through the
coordinator's ``POST /rollout`` — the SAME shadow/canary/auto-rollback
machinery every manual rollout rides (serving/rollout.py), so a bad
retrain can never take the fleet down: the canary gate rolls it back
and the loop simply waits for the next export.

Eligibility is the manifest-last contract: an export directory counts
only once ``checkpoint.sha256.json`` exists (an interrupted export is
invisible), and the rollout staging path re-verifies the digest
strictly on every worker before anything flips. When several exports
appear between polls, only the NEWEST is pushed — intermediate
checkpoints are superseded exactly like intermediate rollouts.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from mmlspark_tpu_torch.core.logs import get_logger
from mmlspark_tpu_torch.io.checkpoint import MANIFEST_FILE

logger = get_logger("streaming.loop")


class RetrainLoop:
    """Watch ``watch_dir`` for flip-eligible checkpoint exports and
    drive each through the coordinator's fleet rollout.

    ``rollout`` carries extra ``POST /rollout`` knobs (``canary``,
    ``shadow_fraction``, ``canary_window_s``, ...) merged into every
    push. One rollout at a time: while one is in flight the loop polls
    ``GET /rollout`` until it lands (``completed`` / ``rolled_back`` /
    ``failed``) before pushing the next candidate; a 409 from a
    concurrent manual rollout just retries next poll.
    """

    _TERMINAL = ("completed", "failed", "rolled_back")

    def __init__(self, watch_dir: str, coordinator_url: str,
                 warmup_payload: Any = None,
                 rollout: Optional[Dict[str, Any]] = None,
                 poll_interval_s: float = 0.5,
                 rollout_timeout_s: float = 120.0,
                 history: int = 32,
                 http_timeout_s: float = 5.0):
        self.watch_dir = os.path.abspath(watch_dir)
        self.coordinator_url = coordinator_url.rstrip("/")
        self.warmup_payload = warmup_payload
        self.rollout_kwargs = dict(rollout or {})
        self.poll_interval_s = float(poll_interval_s)
        self.rollout_timeout_s = float(rollout_timeout_s)
        self.http_timeout_s = float(http_timeout_s)
        self._stop = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._thread: Optional[threading.Thread] = None
        self._last_pushed: Optional[str] = None
        self.current: Optional[Dict[str, Any]] = None
        self.history: "deque[Dict[str, Any]]" = deque(
            maxlen=max(int(history), 1))
        self.n_pushed = 0
        self.n_completed = 0
        self.n_rolled_back = 0
        self.n_failed = 0

    # -- candidate discovery -------------------------------------------------

    def eligible_exports(self) -> List[str]:
        """Sorted export directory names that carry a digest manifest
        (the manifest is written LAST, so presence == complete)."""
        if not os.path.isdir(self.watch_dir):
            return []
        out = []
        for name in sorted(os.listdir(self.watch_dir)):
            d = os.path.join(self.watch_dir, name)
            if os.path.isdir(d) and \
                    os.path.exists(os.path.join(d, MANIFEST_FILE)):
                out.append(name)
        return out

    def _next_candidate(self) -> Optional[str]:
        exports = self.eligible_exports()
        if not exports:
            return None
        newest = exports[-1]
        if self._last_pushed is not None and newest <= self._last_pushed:
            return None
        return newest

    # -- HTTP ----------------------------------------------------------------

    def _post_rollout(self, body: Dict[str, Any]):
        import requests
        return requests.post(f"{self.coordinator_url}/rollout",
                             json=body, timeout=self.http_timeout_s)

    def _get_rollout(self) -> Dict[str, Any]:
        import requests
        r = requests.get(f"{self.coordinator_url}/rollout",
                         timeout=self.http_timeout_s)
        r.raise_for_status()
        return r.json()

    # -- the loop ------------------------------------------------------------

    def _push(self, name: str) -> None:
        body = {"version": name,
                "path": os.path.join(self.watch_dir, name),
                **self.rollout_kwargs}
        if self.warmup_payload is not None:
            body.setdefault("warmup_payload", self.warmup_payload)
        resp = self._post_rollout(body)
        if resp.status_code == 409:
            # a rollout (manual, or a previous push still landing) is
            # in flight: not ours to interrupt — retry next poll
            logger.info("retrain loop: rollout busy (409); will retry "
                        "%s", name)
            return
        resp.raise_for_status()
        self._last_pushed = name
        self.n_pushed += 1
        self._idle.clear()
        self.current = {"version": name, "state": "pushed",
                        "pushed_unix": round(time.time(), 3)}
        logger.info("retrain loop: pushed checkpoint %s into rollout",
                    name)
        self._await_rollout(name)

    def _await_rollout(self, name: str) -> None:
        deadline = time.monotonic() + self.rollout_timeout_s
        final: Dict[str, Any] = {"state": "timeout"}
        while time.monotonic() < deadline and not self._stop.is_set():
            try:
                st = self._get_rollout()
            except Exception as e:  # noqa: BLE001 — coordinator blip:
                logger.warning("retrain loop: rollout poll failed: %s", e)
                self._stop.wait(self.poll_interval_s)
                continue
            if st.get("version") == name:
                self.current = {"version": name, **st}
                if st.get("state") in self._TERMINAL:
                    final = st
                    break
            self._stop.wait(self.poll_interval_s)
        state = final.get("state")
        if state == "timeout" and self._stop.is_set():
            # stop() landed while a healthy rollout was in flight: the
            # coordinator finishes it on its own — recording a failure
            # the rollout never had would page someone for nothing
            state = "interrupted"
        if state == "completed":
            self.n_completed += 1
        elif state == "rolled_back":
            # auto-rollback did its job: the fleet is back on the old
            # version and the loop waits for a better export
            self.n_rolled_back += 1
        elif state != "interrupted":
            self.n_failed += 1
        entry = {"version": name, "state": state,
                 "decision": final.get("decision"),
                 "detail": final.get("detail"),
                 "finished_unix": round(time.time(), 3)}
        self.history.append(entry)
        self.current = None
        self._idle.set()
        (logger.info if state == "completed" else logger.warning)(
            "retrain loop: rollout of %s ended %s", name, state)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                name = self._next_candidate()
                if name is not None:
                    self._push(name)
            except Exception:  # noqa: BLE001 — the loop must survive a
                # transient coordinator/HTTP failure and keep watching
                logger.warning("retrain loop iteration failed",
                               exc_info=True)
                self._idle.set()
                self.current = None
            self._stop.wait(self.poll_interval_s)

    # -- lifecycle / surfaces ------------------------------------------------

    def start(self) -> "RetrainLoop":
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("retrain loop already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="retrain-loop")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5)

    def await_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until no push is in flight (True when idle)."""
        return self._idle.wait(timeout)

    def status(self) -> Dict[str, Any]:
        return {"watch_dir": self.watch_dir,
                "coordinator": self.coordinator_url,
                "last_pushed": self._last_pushed,
                "current": self.current,
                "n_pushed": self.n_pushed,
                "n_completed": self.n_completed,
                "n_rolled_back": self.n_rolled_back,
                "n_failed": self.n_failed,
                "eligible": self.eligible_exports(),
                "history": list(self.history)}

    def __enter__(self) -> "RetrainLoop":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
