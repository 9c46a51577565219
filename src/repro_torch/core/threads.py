"""Join-bounded worker-thread lifecycle helpers.

Every runtime thread (pipeline stages, the storage I/O service thread, the
D2H retire thread) is created through :func:`spawn` and torn down through
:func:`join_bounded`, so a wedged worker can never hang shutdown: the join
times out, the leak is logged and counted as ``Counters.threads_leaked``,
and the caller carries on unwinding.  Lint rule R8 flags any raw
``threading.Thread(...)`` outside this module.
"""
from __future__ import annotations

import logging
import threading
from typing import Iterable, List, Optional, Union

log = logging.getLogger("repro_torch.runtime")


def spawn(
    name: str,
    target,
    *,
    args: tuple = (),
    daemon: bool = True,
    start: bool = True,
) -> threading.Thread:
    """Create (and by default start) a named daemon worker thread.

    The sole sanctioned Thread constructor in the tree — keeping creation
    funneled here is what lets ``join_bounded`` assume every worker is a
    daemon (a leaked-but-counted thread can't block interpreter exit).
    """
    t = threading.Thread(  # repro: allow[R8] -- the sanctioned constructor
        target=target, name=name, args=args, daemon=daemon
    )
    if start:
        t.start()
    return t


def join_bounded(
    threads: Union[threading.Thread, Iterable[threading.Thread]],
    timeout_s: float,
    counters=None,
    what: str = "worker thread",
) -> List[threading.Thread]:
    """Join each thread with a per-thread timeout; never hangs.

    Threads still alive after their timeout are logged as leaked, counted
    into ``counters.threads_leaked`` when a :class:`Counters` is supplied,
    and returned so callers can make further decisions (tests assert on the
    count; shutdown paths just proceed).
    """
    if isinstance(threads, threading.Thread):
        threads = [threads]
    threads = list(threads)
    for t in threads:
        t.join(timeout=timeout_s)
    leaked = [t for t in threads if t.is_alive()]
    for t in leaked:
        log.warning(
            "%s %r leaked: still alive %.1fs after join (wedged I/O op?)",
            what, t.name, timeout_s,
        )
        if counters is not None:
            counters.bump("threads_leaked")
    return leaked
