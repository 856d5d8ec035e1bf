"""In-memory DB substrate: tuple store, OCC (section 4.4), YCSB/TPC-C workloads.

Two execution substrates share the flat key space:

* scalar — dict :class:`Table` of :class:`TupleCell` + per-txn
  :class:`OCCWorker` (one transaction at a time, per-tuple locks);
* batched — columnar :class:`ArrayTable` + :class:`BatchOCC` (whole batches
  validated/sequenced/encoded with array ops; :class:`ScalarBatchOCC` is the
  equivalence oracle).
"""

from .array_table import ArrayTable
from .batch import BatchOCC, BatchResult, ScalarBatchOCC, TxnSpec
from .occ import OCCWorker, TidStripe, TID_STRIDE
from .table import Table, TupleCell

__all__ = [
    "ArrayTable",
    "BatchOCC",
    "BatchResult",
    "ScalarBatchOCC",
    "TxnSpec",
    "OCCWorker",
    "TidStripe",
    "TID_STRIDE",
    "Table",
    "TupleCell",
]
