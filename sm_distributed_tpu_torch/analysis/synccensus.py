"""The runtime half of the ``host-sync`` rule: a census of the
device->host syncs a stretch of code makes on the card.

:class:`SyncCensus` turns on ``torch.cuda.set_sync_debug_mode("warn")`` and
hooks ``warnings.showwarning``: every "synchronizing CUDA operation"
warning torch raises (a blocking copy either way, ``.item()``, a
data-dependent shape such as ``nonzero``) is attributed to the innermost
frame of the calling thread's stack that lies in this package, as a
``path:line`` site (repository-relative), and counted.  A warning whose
stack never enters the package counts as unattributed.  Other warnings go
to the hook that was there before.  The debug mode, the hook and the
warning filters are restored on exit, whatever happens inside.

The debug mode flags implicit syncs only: an explicit
``torch.cuda.synchronize()`` or ``Event.synchronize()`` raises no warning,
so the census checks that the static rule has no blind spot on the path it
watches, not that the rule is complete.

:func:`blind_spots` holds the census to the static rule: a site in one of
the rule's hot modules must sit on a line the rule sees as annotated
(``# smlint: host-sync-ok[reason]``, see ``analysis/rules.py``
:func:`~.rules.sync_line_annotated`).
"""

from __future__ import annotations

import sys
import threading
import warnings
from collections import Counter
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
REPO_ROOT = PACKAGE_DIR.parent
# torch's wording (c10/cuda warn_or_error_on_sync)
SYNC_MESSAGE = "called a synchronizing CUDA operation"
UNATTRIBUTED = "<outside the package>"


def _set_mode(mode) -> None:
    import torch

    torch.cuda.set_sync_debug_mode(mode)


def _get_mode():
    import torch

    return torch.cuda.get_sync_debug_mode()


def port_site(frame) -> str:
    """``path:line`` of the innermost frame at or above ``frame`` whose file
    lies in this package (the path relative to the repository), or
    :data:`UNATTRIBUTED`."""
    while frame is not None:
        try:
            rel = Path(frame.f_code.co_filename).resolve().relative_to(
                REPO_ROOT)
        except ValueError:
            rel = None
        if rel is not None and rel.parts and rel.parts[0] == PACKAGE_DIR.name:
            return f"{rel.as_posix()}:{frame.f_lineno}"
        frame = frame.f_back
    return UNATTRIBUTED


class SyncCensus:
    """Context manager counting the card's sync warnings by site; any
    thread's warnings count (the hook runs in the thread that warns)."""

    _GUARDED_BY = {"_sites": "_lock"}

    def __init__(self, set_mode=_set_mode, get_mode=_get_mode):
        self._lock = threading.Lock()
        self._sites: Counter = Counter()
        self._set_mode = set_mode
        self._get_mode = get_mode
        self._saved = None

    def __enter__(self) -> "SyncCensus":
        prev_mode = self._get_mode()
        filters = warnings.catch_warnings()
        filters.__enter__()
        prev_show = warnings.showwarning
        self._saved = (prev_mode, filters, prev_show)
        try:
            warnings.filterwarnings("always", message=".*synchroniz")

            def show(message, category, filename, lineno, file=None,
                     line=None):
                if SYNC_MESSAGE in str(message):
                    self._count(port_site(sys._getframe(1)))
                else:
                    prev_show(message, category, filename, lineno, file,
                              line)

            warnings.showwarning = show
            self._set_mode("warn")
        except BaseException:
            self._restore()
            raise
        return self

    def __exit__(self, *exc) -> None:
        self._restore()

    def _restore(self) -> None:
        prev_mode, filters, _prev_show = self._saved
        try:
            self._set_mode(prev_mode)
        finally:
            filters.__exit__(None, None, None)   # filters and showwarning

    def _count(self, site: str) -> None:
        with self._lock:
            self._sites[site] += 1

    def sites(self) -> dict[str, int]:
        """{``path:line``: syncs} so far, most frequent first."""
        with self._lock:
            return dict(self._sites.most_common())


def blind_spots(sites, root=REPO_ROOT) -> list[str]:
    """The sites of ``sites`` (``path:line`` keys) that lie in a hot module
    of the ``host-sync`` rule on a line the rule does not see as
    annotated."""
    from .core import Module
    from .rules import is_hot_module, sync_line_annotated

    parsed: dict[str, Module] = {}
    out = []
    for site in sites:
        if site == UNATTRIBUTED:
            continue
        path, _, line = site.rpartition(":")
        if not is_hot_module(path):
            continue
        if path not in parsed:
            parsed[path] = Module(path, (Path(root) / path).read_text())
        if not sync_line_annotated(parsed[path], int(line)):
            out.append(site)
    return out
