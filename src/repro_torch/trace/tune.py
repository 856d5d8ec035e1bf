"""Configuration autotuner: sweep the replay simulator over a grid of
(batch size, device count) candidates and pick the config with the best
predicted throughput for a traced workload.

The point is the loop the ROADMAP's cost-model items need: fit a
:class:`~repro_torch.trace.sim.CostModel` once from a short calibration trace,
then answer "how should I deploy" without re-running the engine per cell.
``benchmarks/fig_trace.py`` cross-checks the choice against the
measured-best cell (must be within 10% of its throughput).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .sim import CostModel, SimConfig, SimResult, WorkloadProfile, simulate


@dataclass
class TuneResult:
    batch_size: int
    devices: int
    predicted: SimResult
    table: List[Dict] = field(default_factory=list)

    def to_dict(self) -> Dict:
        return {
            "batch_size": self.batch_size,
            "devices": self.devices,
            "predicted_txn_s": self.predicted.txn_s,
            "predicted_p99_commit_s": self.predicted.p99_commit,
            "table": self.table,
        }


def autotune(
    model: CostModel,
    profile: Optional[WorkloadProfile] = None,
    n_txn: int = 20_000,
    shards: int = 1,
    batch_grid: Sequence[int] = (64, 128, 256, 512, 1024),
    device_grid: Sequence[int] = (1, 2, 4),
    device_bw: Optional[float] = None,
    cross_ratio: float = 0.0,
    p99_budget: Optional[float] = None,
    io_unit: Optional[int] = None,
) -> TuneResult:
    """Pick ``(batch_size, devices)`` maximizing predicted txn/s.

    ``p99_budget`` (seconds), when given, filters out candidates whose
    predicted p99 commit latency blows the budget before ranking — the
    classic group-commit tradeoff (bigger batches amortize CPU but delay
    durability) made explicit.  Falls back to the unconstrained best if
    nothing fits the budget.
    """
    best: Optional[Tuple[float, int, int, SimResult]] = None
    best_any: Optional[Tuple[float, int, int, SimResult]] = None
    table: List[Dict] = []
    for devices in device_grid:
        for batch in batch_grid:
            cfg = SimConfig(
                shards=shards,
                devices=devices,
                batch_size=batch,
                n_txn=n_txn,
                device_bw=device_bw,
                cross_ratio=cross_ratio,
            )
            if io_unit is not None:
                cfg.io_unit = io_unit
            r = simulate(model, cfg, profile)
            table.append({
                "batch_size": batch,
                "devices": devices,
                "txn_s": r.txn_s,
                "p99_commit_s": r.p99_commit,
            })
            key = (r.txn_s, batch, devices, r)
            if best_any is None or key[0] > best_any[0]:
                best_any = key
            if p99_budget is not None and r.p99_commit > p99_budget:
                continue
            if best is None or key[0] > best[0]:
                best = key
    chosen = best or best_any
    assert chosen is not None, "empty tuning grid"
    _, batch, devices, res = chosen
    return TuneResult(
        batch_size=batch, devices=devices, predicted=res, table=table
    )
