"""TPC-C subset (paper §6.2): 50% Payment + 50% NewOrder over W warehouses.

Composite keys encode the nine-table schema in the flat store:
  W:<w>                warehouse (ytd)
  D:<w>:<d>            district (ytd, next_o_id)
  C:<w>:<d>:<c>        customer (balance, ytd_payment)
  I:<i>                item (price)
  S:<w>:<i>            stock (quantity)
  O:<w>:<d>:<o>        order header
  OL:<w>:<d>:<o>:<n>   order line

Payment: update warehouse/district YTD + customer balance (read-modify-write
=> RAW-carrying txns).  NewOrder: read item prices, decrement stock, insert
order + order lines (mostly write-heavy with stock RMW).

Scaled: 20 warehouses (paper) with reduced customers/items per warehouse —
ratios between logging variants are the reproduction target.
"""

from __future__ import annotations

import random
import struct
from typing import Callable, List, Optional, Tuple

from .batch import TxnSpec
from .occ import OCCWorker
from .table import Table

# value-lookup hook for spec generation: key -> (value bytes, observed ssn).
# The dict-table adapter wraps TupleCell; ArrayTable.get_or_insert already
# has this exact signature, so batch generation runs against either store.
Lookup = Callable[[str], Tuple[bytes, int]]

DISTRICTS = 10
CUSTOMERS = 120        # per district (paper: 3000; scaled)
ITEMS = 2000           # (paper: 100k; scaled)


def _f(x: float) -> bytes:
    return struct.pack("<d", x)


def _fi(b: bytes) -> float:
    return struct.unpack("<d", b[:8])[0] if len(b) >= 8 else 0.0


def load(table: Table, warehouses: int = 20, seed: int = 11) -> None:
    rng = random.Random(seed)
    for i in range(ITEMS):
        table.insert(f"I:{i}", _f(rng.uniform(1, 100)))
    for w in range(warehouses):
        table.insert(f"W:{w}", _f(0.0))
        for d in range(DISTRICTS):
            table.insert(f"D:{w}:{d}", struct.pack("<dI", 0.0, 1))
            for c in range(CUSTOMERS):
                table.insert(f"C:{w}:{d}:{c}", _f(0.0))
        for i in range(ITEMS):
            table.insert(f"S:{w}:{i}", struct.pack("<I", rng.randrange(10, 100)))


class TPCC:
    def __init__(self, table: Table, warehouses: int = 20, seed: int = 0):
        self.table = table
        self.warehouses = warehouses
        self.rng = random.Random(seed)
        self._order_seq = 0

    def _dict_lookup(self, key: str) -> Tuple[bytes, int]:
        cell = self.table.get_or_insert(key)
        return cell.value, cell.ssn

    def next_txn(self, worker: OCCWorker):
        spec = self.next_spec(self._dict_lookup)
        return worker.execute(reads=spec.reads, writes=spec.writes)

    def next_spec(self, lookup: Optional[Lookup] = None) -> TxnSpec:
        """Generate one Payment/NewOrder intent; ``lookup`` supplies the
        values the read-modify-writes are computed from (and the observed
        SSNs the batched validator will re-check)."""
        lookup = lookup or self._dict_lookup
        if self.rng.random() < 0.5:
            return self._payment_spec(lookup)
        return self._new_order_spec(lookup)

    def next_batch(self, n: int, lookup: Optional[Lookup] = None) -> List[TxnSpec]:
        """``n`` specs for the batched executor.  Pass the columnar store's
        ``ArrayTable.get_or_insert`` as ``lookup`` to generate against it;
        losers must be *regenerated* (their values derive from the observed
        reads), which the batch drivers do by drawing fresh transactions."""
        return [self.next_spec(lookup) for _ in range(n)]

    def _payment_spec(self, lookup: Lookup) -> TxnSpec:
        rng = self.rng
        w = rng.randrange(self.warehouses)
        d = rng.randrange(DISTRICTS)
        c = rng.randrange(CUSTOMERS)
        amount = rng.uniform(1, 5000)
        wk, dk, ck = f"W:{w}", f"D:{w}:{d}", f"C:{w}:{d}:{c}"
        # read-modify-write of three rows
        (wv, wssn), (dv, dssn), (cv, cssn) = lookup(wk), lookup(dk), lookup(ck)
        writes = [
            (wk, _f(_fi(wv) + amount)),
            (dk, struct.pack("<dI", _fi(dv) + amount, 1)),
            (ck, _f(_fi(cv) - amount)),
        ]
        return TxnSpec(reads=[wk, dk, ck], writes=writes,
                       observed=[wssn, dssn, cssn])

    def _new_order_spec(self, lookup: Lookup) -> TxnSpec:
        rng = self.rng
        w = rng.randrange(self.warehouses)
        d = rng.randrange(DISTRICTS)
        n_lines = rng.randrange(5, 16)
        items = rng.sample(range(ITEMS), n_lines)
        self._order_seq += 1
        o = self._order_seq
        reads = [f"I:{i}" for i in items] + [f"D:{w}:{d}"]
        observed = [lookup(k)[1] for k in reads]
        writes: List[Tuple[str, bytes]] = [(f"O:{w}:{d}:{o}", struct.pack("<II", n_lines, w))]
        for n, i in enumerate(items):
            sk = f"S:{w}:{i}"
            reads.append(sk)
            sv, sssn = lookup(sk)
            observed.append(sssn)
            qty = struct.unpack("<I", sv[:4])[0] if len(sv) >= 4 else 50
            qty = qty - 1 if qty > 10 else qty + 91
            writes.append((sk, struct.pack("<I", qty)))
            writes.append((f"OL:{w}:{d}:{o}:{n}", struct.pack("<Id", i, rng.uniform(1, 100))))
        return TxnSpec(reads=reads, writes=writes, observed=observed)
