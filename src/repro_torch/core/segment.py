"""Segment index (paper Figure 4 / Algorithm 2).

Concurrent SSN allocation + record memcpy create *holes* in a log buffer:
slots that are reserved but not yet filled.  The segment index logically
divides the buffer into variable-size segments; a segment becomes flushable
only when it is ``CLOSED`` *and* every reserved byte has been buffered
(``allocated_bytes == buffered_bytes``).  Each flushed segment advances the
buffer's DSN to the segment's largest SSN.

Segments close in one of two ways (two "segment threads", §4.3):
  * a worker closes the generating segment when its cumulative allocation
    reaches the IO unit size;
  * the logger closes it when the group-commit flush timer expires.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

OPEN = 0
CLOSED = 1


@dataclass
class Segment:
    ssn: int = 0                # largest SSN of records in this segment
    allocated_bytes: int = 0
    buffered_bytes: int = 0
    start_offset: int = 0       # logical offset of the segment start
    stat: int = OPEN

    def reset(self) -> None:
        self.ssn = 0
        self.allocated_bytes = 0
        self.buffered_bytes = 0
        self.start_offset = 0
        self.stat = OPEN


class SegmentIndex:
    """Ring of segments for one log buffer.

    All mutation of ``allocated_bytes`` / ``stat`` / ``cur_generate_seg``
    happens under the owning buffer's latch (the paper uses atomics; under
    CPython we piggyback on the buffer latch which subsumes them).
    ``buffered_bytes`` is incremented after memcpy *outside* the latch and is
    protected by a dedicated fine-grained lock, mirroring FETCH_ADD.
    """

    def __init__(self, size: int = 64):
        self.size = size
        self.segments: List[Segment] = [Segment() for _ in range(size)]
        self.cur_generate_seg = 0
        self.cur_flush_seg = 0
        self._buffered_lock = threading.Lock()

    # --- producer (worker) side: called under buffer latch ----------------
    def generating(self) -> Segment:
        return self.segments[self.cur_generate_seg % self.size]

    def gen_index(self) -> int:
        return self.cur_generate_seg

    def allocate(self, nbytes: int) -> int:
        """Account ``nbytes`` of a freshly reserved record to the generating
        segment.  Returns the absolute segment index the record belongs to."""
        idx = self.cur_generate_seg
        self.segments[idx % self.size].allocated_bytes += nbytes
        return idx

    def try_establish(self, buffer_ssn: int, buffer_offset: int, io_unit: int) -> bool:
        """Algorithm 2, EstablishingSegment — close the generating segment if
        it has reached the IO unit size.  Called under the buffer latch."""
        seg = self.generating()
        if seg.allocated_bytes >= io_unit and seg.stat != CLOSED:
            self._establish(seg, buffer_ssn, buffer_offset)
            return True
        return False

    def force_establish(self, buffer_ssn: int, buffer_offset: int) -> bool:
        """Timer-triggered close by the logger thread (group commit).
        Called under the buffer latch.  Empty segments are not closed."""
        seg = self.generating()
        if seg.allocated_bytes > 0 and seg.stat != CLOSED:
            self._establish(seg, buffer_ssn, buffer_offset)
            return True
        return False

    def _establish(self, seg: Segment, buffer_ssn: int, buffer_offset: int) -> None:
        nxt = self.segments[(self.cur_generate_seg + 1) % self.size]
        if nxt.stat == CLOSED:
            # Ring full: the logger has fallen behind by `size` segments.
            # Workers will observe allocation back-pressure via buffer space
            # accounting; we simply refuse to close (flush timer will retry).
            return
        seg.ssn = buffer_ssn
        seg.stat = CLOSED
        nxt.start_offset = buffer_offset
        self.cur_generate_seg += 1

    # --- memcpy completion (outside latch) --------------------------------
    def add_buffered(self, seg_index: int, nbytes: int) -> None:
        with self._buffered_lock:
            self.segments[seg_index % self.size].buffered_bytes += nbytes

    # --- consumer (logger) side --------------------------------------------
    def flushable(self) -> Optional[Segment]:
        """Return the next segment ready to flush, else None."""
        seg = self.segments[self.cur_flush_seg % self.size]
        with self._buffered_lock:
            ready = seg.stat == CLOSED and seg.allocated_bytes == seg.buffered_bytes
        return seg if ready else None

    def pop_flushed(self) -> None:
        """Reset the just-flushed segment and advance cur_flush_seg."""
        seg = self.segments[self.cur_flush_seg % self.size]
        seg.reset()
        self.cur_flush_seg += 1
