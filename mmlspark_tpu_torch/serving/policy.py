"""Serving policies of the decode plane.

The port of ``mmlspark_tpu/serving/policy.py``'s
:class:`SpeculationPolicy` (framework-neutral host code, copied). The
module's batching policies come with the HTTP serving stack.
"""

from __future__ import annotations

from typing import Dict, Optional


class SpeculationPolicy:
    """Acceptance-gated speculation: keep speculative decoding on only
    while it pays.

    A speculative round costs one draft propose plus one width-k
    verify; it beats plain stepping only when the target accepts
    enough proposals. A drifting workload (or a draft that never
    agreed — the failure mode of a badly matched model pair) can push
    acceptance below break-even, at which point speculation is
    actively SLOWER than single-token decode. This policy tracks an
    acceptance EWMA fed by the scheduler after every round and turns
    speculation off below ``min_rate``; every ``reprobe_every``-th
    round while off, one PROBE round runs anyway so a workload that
    becomes draft-friendly again is rediscovered — the policy is
    hysteretic, never sticky-dead.

    ``warmup_rounds`` rounds always speculate (the EWMA needs
    evidence before it may veto)."""

    def __init__(self, min_rate: float = 0.3, alpha: float = 0.2,
                 warmup_rounds: int = 8, reprobe_every: int = 32):
        self.min_rate = float(min_rate)
        self.alpha = float(alpha)
        self.warmup_rounds = int(warmup_rounds)
        self.reprobe_every = max(int(reprobe_every), 1)
        self.rate: Optional[float] = None   # acceptance EWMA
        self.n_rounds = 0
        self.n_suppressed = 0
        self._since_probe = 0

    def should_speculate(self) -> bool:
        """Consulted once per scheduler round BEFORE the cohort is
        built; counts suppressed rounds toward the re-probe cadence."""
        if self.n_rounds < self.warmup_rounds or self.rate is None \
                or self.rate >= self.min_rate:
            return True
        self._since_probe += 1
        if self._since_probe >= self.reprobe_every:
            self._since_probe = 0
            return True                     # probe round
        self.n_suppressed += 1
        return False

    def note(self, proposed: int, accepted: int) -> None:
        """Fold one completed round's acceptance into the EWMA."""
        if proposed <= 0:
            return
        self.n_rounds += 1
        r = accepted / proposed
        self.rate = (r if self.rate is None
                     else (1 - self.alpha) * self.rate + self.alpha * r)

    def status(self) -> Dict[str, object]:
        return {"min_rate": self.min_rate,
                "acceptance_ewma": (round(self.rate, 4)
                                    if self.rate is not None else None),
                "n_rounds": self.n_rounds,
                "n_suppressed": self.n_suppressed,
                "speculating": (self.rate is None
                                or self.rate >= self.min_rate
                                or self.n_rounds < self.warmup_rounds)}
