"""Algorithm 1 — Throughput-Adaptive Interval Control Loop.

I_opt = (T̄_fwd + L_net) / N_active

T̄_fwd is a moving average over a sliding window of EndForward-reported
execution times; topology changes (auto-scaling, health-check) trigger an
immediate recompute.
"""
from __future__ import annotations

import collections
from typing import Deque


class AdaptiveIntervalController:
    def __init__(self, window_size: int = 32, l_net: float = 0.002,
                 t_default: float = 0.25, n_active: int = 1):
        if window_size <= 0:
            raise ValueError("window_size must be positive")
        self.window_size = window_size
        self.l_net = l_net
        self.t_default = t_default
        self._window: Deque[float] = collections.deque(maxlen=window_size)
        self._t_fwd = t_default
        self._n_active = max(n_active, 0)
        self._i_opt = self._compute()

    # -- Algorithm 1, RecomputeInterval --------------------------------
    def _compute(self) -> float:
        if self._n_active <= 0:
            return float("inf")      # no capacity: hold dispatch
        return (self._t_fwd + self.l_net) / self._n_active

    # -- Algorithm 1, OnEndForward --------------------------------------
    def on_end_forward(self, t_measured: float) -> float:
        """Feed one measured forward time; returns the new I_opt."""
        if t_measured < 0:
            raise ValueError("negative execution time")
        self._window.append(t_measured)   # deque evicts the oldest itself
        self._t_fwd = sum(self._window) / len(self._window)
        self._i_opt = self._compute()
        return self._i_opt

    # -- Algorithm 1, OnTopologyChange -----------------------------------
    def on_topology_change(self, n_new: int) -> float:
        self._n_active = max(n_new, 0)
        self._i_opt = self._compute()     # immediate adaptation
        return self._i_opt

    @property
    def interval(self) -> float:
        return self._i_opt

    @property
    def t_fwd(self) -> float:
        return self._t_fwd

    @property
    def n_active(self) -> int:
        return self._n_active

    @property
    def watchdog_timeout(self) -> float:
        """Safety-path timeout T = 5·T̄ (paper §4.1.2)."""
        return 5.0 * self._t_fwd
