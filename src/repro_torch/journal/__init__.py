"""Poplar-journaled training-state durability (the paper's technique as a
first-class framework feature).  See manager.py for the txn mapping."""

from .manager import PoplarCheckpointManager, SaveHandle, flatten_state
from .restore import JournalTails, load_lanes, load_lanes_columnar, restore_latest, to_pytree

__all__ = ["PoplarCheckpointManager", "SaveHandle", "flatten_state",
           "JournalTails", "load_lanes", "load_lanes_columnar", "restore_latest", "to_pytree"]
