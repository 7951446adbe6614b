"""What one map of the program produced at the stage boundaries the check
reads, and the spans of a traced map.

The program's stages call each other through module attributes, so a
pass-through wrapper put in an attribute's place sees each call's
arguments and result.  The wrappers keep references only (no copy, no
device work, no read back to the host); :meth:`Capture.reset` at the
start of every map drops the last map's, so after the window the capture
holds the last map's.  Every embedder's map has

* ``knn``: the kNN graph (indices, distances) the embedder built;

and the embedder's stage module (``stages/<name>.py``) adds its own
through :meth:`Capture.wrap` in its ``install``.

With ``spans`` each wrapped stage also runs under a
``torch.profiler.record_function`` of its own name, which the trace's
idle gaps are labelled by."""
from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.core import neighbors, pipeline


class Capture:
    def __init__(self):
        self.got = {}
        self.spans = False
        self._saved = []

    def reset(self) -> None:
        self.got = {}

    def _span(self, name):
        if self.spans:
            return torch.profiler.record_function("sns:" + name)
        return contextlib.nullcontext()

    def wrap(self, mod, attr, record=None) -> None:
        """Put a pass-through wrapper in ``mod.attr``'s place: it runs the
        call under the span ``sns:<attr>`` and hands its result and
        arguments to ``record``."""
        orig = getattr(mod, attr)

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            with self._span(attr):
                out = orig(*args, **kwargs)
            if record is not None:
                record(out, *args, **kwargs)
            return out
        self._saved.append((mod, attr, orig))
        setattr(mod, attr, wrapper)

    def first_last(self, key, entry) -> None:
        """Keep ``entry`` as ``<key>_first`` once a map and as
        ``<key>_last`` every time."""
        self.got.setdefault(key + "_first", entry)
        self.got[key + "_last"] = entry

    def install(self, stage) -> "Capture":
        def knn(out, *a, **k):
            self.got["knn"] = out

        self.wrap(pipeline, "_sketch_stage_impl")
        self.wrap(pipeline, "_embed_stage_impl")
        self.wrap(neighbors, "knn_graph", knn)
        stage.install(self)
        return self

    def uninstall(self) -> None:
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []
