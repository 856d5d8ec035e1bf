"""One shared thread fan-out for the per-device / per-lane / per-shard
parallel loops (decode, restore, shipping).

Every consumer used to hand-roll the same spawn/start/join block; keeping
one copy means the joining and fall-back-to-sequential behaviour is fixed
in exactly one place.  Workers run under the GIL — these loops parallelize
IO and zlib/numpy releases, not Python bytecode.

Worker exceptions propagate: a bare ``threading.Thread`` swallows them,
which let a failed checkpoint writer look like a successful one (the
metadata was published over a partial file set).  ``parallel_for`` joins
every worker first, then re-raises the lowest-index failure — so a caller
can never observe "done" when any worker died.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional


def parallel_for(n: int, fn: Callable[[int], None], parallel: bool = True) -> None:
    """Run ``fn(i)`` for ``i in range(n)`` — on one thread per index when
    ``parallel`` and ``n > 1``, else sequentially.  Joins all threads before
    returning; if any worker raised, re-raises the lowest-index exception
    (after every worker has finished, so no thread is left running)."""
    if parallel and n > 1:
        errs: List[Optional[BaseException]] = [None] * n

        def _run(i: int) -> None:
            try:
                fn(i)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errs[i] = e

        threads = [threading.Thread(target=_run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errs:
            if e is not None:
                raise e
    else:
        for i in range(n):
            fn(i)
