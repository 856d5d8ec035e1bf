"""Constraint-level checkers (paper §3.1, Figure 1).

Given a recorded execution history — per-transaction sequence numbers, the
observed commit order, and the dependency graph — these predicates decide
whether a logging run satisfied:

* **Level 1, recoverability**: RAW ⇒ commit order; WAW ⇒ SSN order.
* **Level 2, rigorousness**:  every dependency (RAW, WAW, WAR) ⇒ both orders.
* **Level 3, sequentiality**: rigorous + totally ordered commits/SSNs for
  non-conflicting pairs.

They are used by the property tests (arbitrary interleavings through the
engines must stay at/above the engine's declared level) and by the crash
consistency oracle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple


class Dep(Enum):
    RAW = "raw"   # Tj wrote x, Ti read Tj's update:   Cj < Ci required (L1)
    WAW = "waw"   # Tj wrote x, Ti overwrote it:       Lj < Li required (L1)
    WAR = "war"   # Tj read x, Ti overwrote it:        nothing required (L1)


@dataclass
class TxnInfo:
    tid: int
    ssn: int
    commit_seq: Optional[int]  # position in the commit order; None = never committed
    # dependencies: (predecessor tid, kind) — the predecessor happened first
    deps: List[Tuple[int, Dep]] = field(default_factory=list)


def check_recoverability(txns: Dict[int, TxnInfo]) -> List[str]:
    """Return a list of violations (empty ⇒ Level 1 holds)."""
    errs: List[str] = []
    for t in txns.values():
        for pred_tid, kind in t.deps:
            pred = txns.get(pred_tid)
            if pred is None:
                continue
            if kind is Dep.RAW:
                # Ti reads Tj's write ⇒ Cj ≺ Ci  (a committed reader requires
                # its writer committed earlier)
                if t.commit_seq is not None:
                    if pred.commit_seq is None or pred.commit_seq > t.commit_seq:
                        errs.append(
                            f"RAW violated: T{t.tid} (commit {t.commit_seq}) read "
                            f"T{pred_tid} (commit {pred.commit_seq})"
                        )
            elif kind is Dep.WAW:
                if not (pred.ssn < t.ssn):
                    errs.append(
                        f"WAW violated: T{t.tid} (ssn {t.ssn}) overwrote "
                        f"T{pred_tid} (ssn {pred.ssn})"
                    )
    return errs


def check_rigorousness(txns: Dict[int, TxnInfo]) -> List[str]:
    errs = check_recoverability(txns)
    for t in txns.values():
        for pred_tid, kind in t.deps:
            pred = txns.get(pred_tid)
            if pred is None:
                continue
            # every dependency ⇒ both orders
            if not (pred.ssn < t.ssn or (kind is Dep.WAR and pred.ssn <= t.ssn)):
                # WAR allows equality in Poplar's SSN (Fig 3: T4 gets the same
                # SSN as its WAR predecessor T3) — that is precisely what
                # rigorousness forbids and recoverability allows.
                errs.append(
                    f"{kind.value.upper()} ssn order violated: T{t.tid} ssn {t.ssn} "
                    f"vs pred T{pred_tid} ssn {pred.ssn}"
                )
            if t.commit_seq is not None and (
                pred.commit_seq is None or pred.commit_seq > t.commit_seq
            ):
                errs.append(
                    f"{kind.value.upper()} commit order violated: T{t.tid} vs T{pred_tid}"
                )
    return errs


def check_sequentiality(txns: Dict[int, TxnInfo]) -> List[str]:
    errs = check_rigorousness(txns)
    infos = [t for t in txns.values() if t.commit_seq is not None]
    infos.sort(key=lambda t: t.commit_seq)  # type: ignore[arg-type]
    for a, b in zip(infos, infos[1:]):
        if not (a.ssn < b.ssn):
            errs.append(
                f"total order violated: commit order T{a.tid} (ssn {a.ssn}) "
                f"then T{b.tid} (ssn {b.ssn})"
            )
    return errs


# ---------------------------------------------------------------------------
# Dependency derivation from an operation trace (used by property tests)
# ---------------------------------------------------------------------------

@dataclass
class Op:
    tid: int
    kind: str   # 'r' | 'w'
    key: str
    seq: int    # global order of the operation in the schedule


def derive_deps(ops: Sequence[Op]) -> Dict[int, List[Tuple[int, Dep]]]:
    """Derive RAW/WAW/WAR dependencies from a single-version operation trace
    (each read observes the latest preceding write)."""
    deps: Dict[int, List[Tuple[int, Dep]]] = {}
    last_write: Dict[str, Tuple[int, int]] = {}      # key -> (tid, seq)
    readers_since_write: Dict[str, Set[int]] = {}    # key -> tids reading cur version

    for op in sorted(ops, key=lambda o: o.seq):
        d = deps.setdefault(op.tid, [])
        if op.kind == "r":
            lw = last_write.get(op.key)
            if lw is not None and lw[0] != op.tid:
                d.append((lw[0], Dep.RAW))
            readers_since_write.setdefault(op.key, set()).add(op.tid)
        else:  # write
            lw = last_write.get(op.key)
            if lw is not None and lw[0] != op.tid:
                d.append((lw[0], Dep.WAW))
            for rt in readers_since_write.get(op.key, set()):
                if rt != op.tid:
                    d.append((rt, Dep.WAR))
            last_write[op.key] = (op.tid, op.seq)
            readers_since_write[op.key] = set()
    return deps
