"""Spans and counters that the benchmark records around the port's calls,
from its own files: wrappers of module attributes and forward hooks, put in
place for a run and taken away after it. Times are ``time.time_ns()``, the
profiler's clock."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple


class Recorder:
    def __init__(self, sync: Callable[[], None] = lambda: None):
        # called at the edges of a module's span (traced runs only), so
        # that its device work falls inside it
        self.sync = sync
        self.spans: List[Tuple[str, int, int]] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self._undo: List[Callable[[], None]] = []
        self.on = True

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def wrap(self, owner, attr: str, name: str,
             after: Callable = None) -> None:
        """Replace ``owner.attr`` by a call inside span ``name`` (when the
        recorder is on); ``after`` sees (args, kwargs, result) always."""
        orig = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            with self.span(name):
                out = orig(*args, **kwargs)
            if after is not None:
                after(args, kwargs, out)
            return out

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, orig))

    def hook_module(self, module, name: str) -> None:
        """A span around every forward of ``module``, with the recorder's
        ``sync`` at its edges."""
        starts: List[int] = []

        def pre(mod, args):
            if self.on:
                self.sync()
                starts.append(time.time_ns())

        def post(mod, args, out):
            if self.on and starts:
                self.sync()
                self.spans.append((name, starts.pop(), time.time_ns()))

        handles = [module.register_forward_pre_hook(pre),
                   module.register_forward_hook(post)]
        self._undo.append(lambda: [h.remove() for h in handles])

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()

    def total_s(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == name) / 1e9
