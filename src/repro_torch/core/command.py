"""Deterministic command registry for adaptive (command-framed) logging.

A command-framed log record (``FLAG_COMMAND`` in :mod:`repro.core.txn`)
replaces each write's value payload with an op *parameter*; recovery
re-derives the value by re-executing the registered operator against the
write's pre-image::

    new_value = op.fn(old_value, param)

Determinism is the whole contract: the same ``(old_value, param)`` pair must
produce the same bytes on the forward path (where the executor computed the
value it applied to the table) and on every replay (single-shard recovery,
sharded recovery, replica promote), otherwise command framing breaks the
byte-identity the crash-equivalence tests pin.  Operators therefore must be
pure functions of their two arguments — no clocks, no randomness, no global
state.

``old_value`` is ``None`` when the key has no pre-image (blind insert); ops
that require a pre-image treat ``None`` as their documented identity value
(e.g. zero for the arithmetic ops) so replay of a command whose pre-image
was never durable still terminates deterministically.

The registry is intentionally tiny and append-only: op ids are stable wire
constants (they are serialized into log records), so renumbering or reusing
an id silently corrupts old logs.  The adaptive policy value-frames any
record whose op id is not registered *in the decoding process* — an old log
replayed by a binary missing an op is caught by recovery, which refuses the
record rather than guessing (see ``repro.core.recovery``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

_U64LE = struct.Struct("<Q")
_F64LE = struct.Struct("<d")

#: op signature: (pre-image bytes or None, param bytes) -> new value bytes
OpFn = Callable[[Optional[bytes], bytes], bytes]


@dataclass(frozen=True)
class CommandOp:
    """One registered operator: a stable wire id, a debug name, and the
    deterministic apply function."""

    op_id: int
    name: str
    fn: OpFn

    def apply(self, old: Optional[bytes], param: bytes) -> bytes:
        return self.fn(old, param)


class CommandRegistry:
    """Id -> operator table consulted by the adaptive policy (encode side)
    and by every replay path (decode side)."""

    def __init__(self) -> None:
        self._ops: Dict[int, CommandOp] = {}

    def register(self, op_id: int, name: str, fn: OpFn) -> CommandOp:
        if op_id in self._ops:
            raise ValueError(
                f"op id {op_id} already registered as "
                f"{self._ops[op_id].name!r} — ids are stable wire constants"
            )
        op = CommandOp(op_id, name, fn)
        self._ops[op_id] = op
        return op

    def get(self, op_id: int) -> CommandOp:
        return self._ops[op_id]

    def __contains__(self, op_id: int) -> bool:
        return op_id in self._ops

    def __iter__(self) -> Iterator[CommandOp]:
        return iter(self._ops.values())

    def __len__(self) -> int:
        return len(self._ops)


def _op_put(old: Optional[bytes], param: bytes) -> bytes:
    """Blind put: the param *is* the new value (no pre-image dependency).
    Never smaller than value framing — exists for tests and as the identity
    op of the wire format."""
    return param


def _op_add_u64(old: Optional[bytes], param: bytes) -> bytes:
    """u64 little-endian add modulo 2^64 (counter bump; missing or short
    pre-image reads as 0)."""
    base = _U64LE.unpack_from(old)[0] if old and len(old) >= 8 else 0
    (delta,) = _U64LE.unpack_from(param)
    return _U64LE.pack((base + delta) & 0xFFFFFFFFFFFFFFFF) + (
        old[8:] if old else b""
    )


def _op_add_f64(old: Optional[bytes], param: bytes) -> bytes:
    """float64 little-endian add (TPC-C YTD / balance deltas; missing or
    short pre-image reads as 0.0).  Bytes beyond the leading float ride
    along unchanged (the district tuple packs a counter after the float)."""
    base = _F64LE.unpack_from(old)[0] if old and len(old) >= 8 else 0.0
    (delta,) = _F64LE.unpack_from(param)
    return _F64LE.pack(base + delta) + (old[8:] if old else b"")


def _op_patch_prefix(old: Optional[bytes], param: bytes) -> bytes:
    """Overwrite the tuple's leading ``len(param)`` bytes, preserving the
    tail — the field-update shape of YCSB-style RMW over wide tuples, where
    the delta is one column of a 1 KB row.  A missing pre-image degenerates
    to a blind put of the param."""
    if not old:
        return param
    return param + old[len(param):]


#: process-wide registry with the builtin ops.  Ids are wire constants.
COMMANDS = CommandRegistry()
OP_PUT = COMMANDS.register(1, "put", _op_put).op_id
OP_ADD_U64 = COMMANDS.register(2, "add_u64", _op_add_u64).op_id
OP_ADD_F64 = COMMANDS.register(3, "add_f64", _op_add_f64).op_id
OP_PATCH_PREFIX = COMMANDS.register(4, "patch_prefix", _op_patch_prefix).op_id
