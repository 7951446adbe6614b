"""Streaming ingest: a bounded-memory, single-sort fold over chunks.

The paper's edge nodes compress a stream they never hold whole (§II):
logarithmic memory, one pass of I/O.  This module is the fold, on
tensors (the reference's ``repro.core.stream``):

    ``IngestState``      = CountSketch ⊕ key-sorted Candidates reservoir
                           ⊕ count ⊕ eviction watermark
    ``ingest_step``      : state × (chunk, mask) → state
    ``ingest_chunk``     : one fixed-shape chunk
    ``ingest_superbatch``: B stacked chunks already on the device, folded
                           in a loop (the reference's ``lax.scan``)
    ``ingest_all``       : host driver — packs a ragged host stream into
                           superbatches in pinned buffers and copies
                           superbatch b+1 to the card on a side stream
                           while b folds

``ingest_step`` sorts and run-length-encodes a chunk's keys ONCE
(``candidates.sorted_runs``) and feeds the runs to both consumers: the
sketch scatter (K7 on the card) and the reservoir merge
(``candidates.merge_runs``, a sorted merge against the key-sorted
reservoir, no second sort).

The fold owns its state: ``ingest_step`` adds into the state's sketch
table IN PLACE (``sketch.update_``), the counterpart of the reference's
donated state, so steady-state device memory is one state plus one
superbatch.  A state passed in is consumed; keep a ``clone`` of its
table if it is still needed.  The public ``sketch.update`` still returns
a new sketch.

The reservoir invariant: a key held by the reservoir accumulates its
exact count, so while the distinct keys seen stay ≤ L the reservoir
equals the one-shot exact top-L of the whole stream.  Beyond L it
degrades to a space-saving approximation; ``evict_max`` is the largest
count ever evicted (see :func:`space_saving_bound`).

``save_state`` / ``load_state`` checkpoint the fold mid-stream to one
``.npz`` in the reference's layout (the same keys and dtypes: uint32
limbs, ``hash_params`` (6, R)), so each package resumes the other's
checkpoints.  Writes are atomic (temp file + ``os.replace``) and carry a
crc32 that ``load_state`` checks, falling back to the ``.bak``
generation on request.  ``merge_states`` combines two folds built with
the same hashes.
"""
from __future__ import annotations

import os
import zlib
from typing import Callable, Iterable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import candidates as cand_mod
from repro_torch.core import quantize, sketch as sketch_mod
from repro_torch.core.candidates import Candidates
from repro_torch.core.device import resolve_device
from repro_torch.core.hashing import MulShiftParams
from repro_torch.core.quantize import GridSpec
from repro_torch.core.sketch import CountSketch


class IngestState(NamedTuple):
    """Everything the sketch stage carries between chunks.

    ``cands`` is kept KEY-SORTED (live keys ascending, padding last), the
    invariant ``candidates.merge_runs`` merges by.  ``evict_max`` is the
    largest exact count ever evicted from the reservoir (0 while the
    distinct keys fit in the pool)."""
    sketch: CountSketch        # (R, C) table + hash params
    cands: Candidates          # (L,) bounded reservoir, key-sorted
    count: torch.Tensor        # () float32, items ingested so far
    evict_max: torch.Tensor    # () float32, running max evicted count


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def init(params: MulShiftParams, log2_cols: int, pool: int) -> IngestState:
    """Fresh state on the params' device: zero sketch, empty reservoir of
    capacity ``pool``."""
    return from_sketch(sketch_mod.init(params, log2_cols), pool)


def from_sketch(sk: CountSketch, pool: int) -> IngestState:
    """Wrap an existing sketch with an empty reservoir."""
    dev = sk.table.device
    return IngestState(sketch=sk, cands=cand_mod.empty(pool, device=dev),
                       count=_zero(dev), evict_max=_zero(dev))


def space_saving_bound(state: IngestState) -> torch.Tensor:
    """Error bound on heavy-hitter recall from the reservoir: a key whose
    exact count exceeds ``evict_max`` at every eviction it suffered is
    still held; 0 means no eviction ever happened.  The reported counts
    come from the sketch and are not affected."""
    return state.evict_max


def ingest_step(state: IngestState, grid: GridSpec, points: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> IngestState:
    """Fold one chunk: quantize → pack → ONE sort + RLE → {sketch scatter
    into the state's own table, sorted-merge reservoir update}.

    The chunk's runs enter the reservoir merge whole, with no per-chunk
    top-L cut: eviction happens only at the reservoir's boundary, where it
    raises ``evict_max``."""
    key_hi, key_lo = quantize.points_to_keys(grid, points)
    runs = cand_mod.sorted_runs(
        key_hi, key_lo, mask=mask,
        assume_hi_zero=grid.dims * grid.bits_per_dim <= 32)
    sk = sketch_mod.update_(state.sketch, runs.key_hi, runs.key_lo,
                            values=runs.count, mask=runs.live)
    cands, evicted = cand_mod.merge_runs(state.cands, runs,
                                         state.cands.capacity)
    inc = torch.full((), points.shape[0], dtype=torch.float32,
                     device=points.device) if mask is None \
        else mask.to(torch.float32).sum()
    return IngestState(sketch=sk, cands=cands, count=state.count + inc,
                       evict_max=torch.maximum(state.evict_max, evicted))


def ingest_chunk(state: IngestState, points: torch.Tensor,
                 mask: torch.Tensor, *, grid: GridSpec) -> IngestState:
    """Fold one fixed-shape (points, mask) block (:func:`rechunk` makes
    them from any ragged stream)."""
    return ingest_step(state, grid, points, mask=mask)


def ingest_superbatch(state: IngestState, points: torch.Tensor,
                      mask: torch.Tensor, *, grid: GridSpec) -> IngestState:
    """Fold B stacked chunks, ``points`` (B, chunk, D) and ``mask``
    (B, chunk), in order.  Fully masked chunks are no-ops (the host
    driver pads the last superbatch with them)."""
    for b in range(points.shape[0]):
        state = ingest_step(state, grid, points[b], mask=mask[b])
    return state


def _host_array(c) -> np.ndarray:
    """A chunk as a 2-D float32 numpy array (a view where it can be)."""
    if isinstance(c, torch.Tensor):
        c = c.detach().cpu().numpy()
    c = np.asarray(c, np.float32)
    return c if c.ndim == 2 else c.reshape(-1, c.shape[-1])


def _superbatches(chunks: Iterable, rows: int,
                  buffer: Callable[[int], np.ndarray]
                  ) -> Iterator[Tuple[np.ndarray, int]]:
    """Pack a ragged stream of (n_i, D) arrays, in order, into (rows, D)
    float32 host buffers: ``buffer(D)`` hands out the next one.  Yields
    (buffer, valid rows); the last buffer's padding rows are zeroed.  Each
    point is copied once, from its chunk into the buffer, so the buffer
    can be the pinned memory the card copies from."""
    buf, have = None, 0
    for c in chunks:
        c = _host_array(c)
        start = 0
        while start < c.shape[0]:
            if buf is None:
                buf, have = buffer(c.shape[1]), 0
            take = min(rows - have, c.shape[0] - start)
            buf[have:have + take] = c[start:start + take]
            have += take
            start += take
            if have == rows:
                yield buf, rows
                buf = None
    if buf is not None:
        buf[have:] = 0.0
        yield buf, have


def rechunk(chunks: Iterable, size: int
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Repack a ragged stream of (n_i, D) arrays into fixed (size, D)
    blocks + boolean masks (padding rows are zeros, mask=False).  Order
    preserving; host-side; O(size) working memory."""
    for buf, n in _superbatches(
            chunks, size, lambda d: np.empty((size, d), np.float32)):
        yield buf, np.arange(size) < n


class _Staging:
    """Host→device staging of superbatches.  On the card: two pinned
    host buffers and two device buffers used in turn; superbatch i's
    copy runs on a side stream after the fold of i−2 has finished with
    its device buffer, and the fold waits on an event for the copy.  On
    the CPU: one host buffer the fold reads in place."""

    def __init__(self, rows: int, device: torch.device):
        self.rows, self.device = rows, device
        self.cuda = device.type == "cuda"
        self.host, self.dev = [], []
        self.copied = [None, None]
        self.folded = [None, None]
        self.i = 0
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def buffer(self, d: int) -> np.ndarray:
        """The host buffer for the next superbatch, once free."""
        j = self.i % 2 if self.cuda else 0
        if len(self.host) <= j:
            self.host.append(torch.empty((self.rows, d), dtype=torch.float32,
                                         pin_memory=self.cuda))
            if self.cuda:
                self.dev.append(torch.empty((self.rows, d),
                                            dtype=torch.float32,
                                            device=self.device))
        elif self.copied[j] is not None:
            self.copied[j].synchronize()   # its last copy has read it
        return self.host[j].numpy()

    def to_device(self) -> torch.Tensor:
        """This superbatch on the device: its copy is enqueued and the
        compute stream waits for it."""
        if not self.cuda:
            return self.host[0]
        j = self.i % 2
        with torch.cuda.stream(self.stream):
            if self.folded[j] is not None:
                self.stream.wait_event(self.folded[j])
            self.dev[j].copy_(self.host[j], non_blocking=True)
            self.copied[j] = torch.cuda.Event()
            self.copied[j].record(self.stream)
        torch.cuda.current_stream(self.device).wait_event(self.copied[j])
        return self.dev[j]

    def done(self) -> None:
        """The fold of this superbatch is enqueued."""
        if self.cuda:
            j = self.i % 2
            self.folded[j] = torch.cuda.Event()
            self.folded[j].record(torch.cuda.current_stream(self.device))
        self.i += 1


def ingest_all(state: IngestState, grid: GridSpec, chunks: Iterable,
               chunk_size: int, superbatch: int = 1) -> IngestState:
    """Drive the fold over a whole host-side chunk stream (numpy arrays
    or CPU tensors of any length).

    The stream is packed into superbatches of ``superbatch`` chunks of
    ``chunk_size`` rows (:func:`_superbatches`, one host copy a point,
    into pinned memory on the card), the last one padded with masked
    rows and fully masked chunks.  On the card the copy of superbatch
    b+1 to the device overlaps the fold of b (:class:`_Staging`).  Every
    chunk of every superbatch is folded, padding chunks included, as in
    the reference.  ``superbatch=1`` folds chunk by chunk."""
    b = max(1, superbatch)
    rows = b * chunk_size
    dev = state.sketch.table.device
    stage = _Staging(rows, dev)
    pos = torch.arange(rows, device=dev)
    for _, n_valid in _superbatches(chunks, rows, stage.buffer):
        pts = stage.to_device()
        state = ingest_superbatch(
            state, pts.view(b, chunk_size, pts.shape[1]),
            (pos < n_valid).view(b, chunk_size), grid=grid)
        stage.done()
    return state


def state_to(state: IngestState, device) -> IngestState:
    """The state with every tensor on ``device`` (a no-op where it lies
    there already)."""
    sk, c = state.sketch, state.cands
    return IngestState(
        sketch=CountSketch(table=sk.table.to(device),
                           params=sk.params.to(device)),
        cands=Candidates(*(t.to(device) for t in c)),
        count=state.count.to(device), evict_max=state.evict_max.to(device))


def merge_states(a: IngestState, b: IngestState) -> IngestState:
    """Linear merge of two folds built with IDENTICAL hash params (checked
    by table shape; equal values are the caller's contract, as in
    ``sketch.merge``): tables add, reservoirs combine through the sorted
    merge (``b``'s re-keyed as runs by
    ``candidates.runs_from_candidates``), counts add, and the watermarks
    max, including anything THIS merge evicts."""
    if a.sketch.table.shape != b.sketch.table.shape:
        raise ValueError(
            f"cannot merge sketches of different geometry: "
            f"{tuple(a.sketch.table.shape)} vs {tuple(b.sketch.table.shape)}")
    runs = cand_mod.runs_from_candidates(b.cands)
    cands, evicted = cand_mod.merge_runs(a.cands, runs, a.cands.capacity)
    return IngestState(
        sketch=sketch_mod.merge(a.sketch, b.sketch), cands=cands,
        count=a.count + b.count,
        evict_max=torch.maximum(torch.maximum(a.evict_max, b.evict_max),
                                evicted))


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed to parse or failed its checksum."""


def _npz_path(path) -> str:
    """np.savez appends '.npz' to suffix-less paths but np.load does not:
    normalize so save and load accept the same path string."""
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def backup_path(path) -> str:
    """The previous good generation ``save_state(keep_backup=True)``
    rotates to (``<path>.npz.bak``)."""
    return _npz_path(path) + ".bak"


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


def _arrays(state: IngestState) -> dict:
    """The state as numpy in the reference's checkpoint keys and dtypes
    (uint32 limbs), in the reference's pytree-leaf order."""
    sk, c = state.sketch, state.cands
    return dict(
        table=sk.table.cpu().numpy(),
        hash_params=np.stack([_u32(p) for p in sk.params]),
        cand_key_hi=_u32(c.key_hi), cand_key_lo=_u32(c.key_lo),
        cand_count=c.count.cpu().numpy(), cand_mask=c.mask.cpu().numpy(),
        count=state.count.cpu().numpy(),
        evict_max=state.evict_max.cpu().numpy())


def _payload_crc(payload: dict) -> int:
    """crc32 over (name, bytes) of every array in sorted-name order: the
    digest stored inside the checkpoint."""
    crc = 0
    for k in sorted(payload):
        if k == "checksum_crc32":
            continue
        crc = zlib.crc32(k.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(payload[k]).tobytes(), crc)
    return crc & 0xFFFFFFFF


def state_leaves(state: IngestState) -> list:
    """The fold's arrays as numpy, leaf by leaf in the reference's pytree
    order and dtypes: table, the six hash limbs (uint32), reservoir keys
    (uint32), counts and mask, count, watermark."""
    a = _arrays(state)
    return [a["table"], *a["hash_params"], a["cand_key_hi"],
            a["cand_key_lo"], a["cand_count"], a["cand_mask"], a["count"],
            a["evict_max"]]


def state_from_leaves(leaves, device) -> IngestState:
    """Inverse of :func:`state_leaves`, onto ``device``."""
    def t(x, dtype):
        return torch.from_numpy(np.asarray(x).astype(dtype)).to(device)
    table, *limbs = leaves[:7]
    hi, lo, cnt, mask, count, evict = leaves[7:]
    return IngestState(
        sketch=CountSketch(table=t(table, np.float32),
                           params=MulShiftParams(*(t(p, np.int64)
                                                   for p in limbs))),
        cands=Candidates(key_hi=t(hi, np.int64), key_lo=t(lo, np.int64),
                         count=t(cnt, np.float32), mask=t(mask, bool)),
        count=t(count, np.float32), evict_max=t(evict, np.float32))


def state_digest(state: IngestState) -> int:
    """crc32 fingerprint of a fold's arrays (:func:`state_leaves`): equal
    to the reference's ``state_digest`` of the same state."""
    crc = 0
    for leaf in state_leaves(state):
        crc = zlib.crc32(np.ascontiguousarray(leaf).tobytes(), crc)
    return crc & 0xFFFFFFFF


def save_state(state: IngestState, path, extra=None,
               keep_backup: bool = False) -> None:
    """Checkpoint the fold mid-stream to one ``.npz`` (a missing suffix is
    added).  Sketch table, hash params, reservoir, count and watermark
    round-trip exactly, so resuming gives bit-identical heavy hitters.

    The payload goes to a temp file in the target directory and moves
    into place with ``os.replace``: readers see the old or the new
    complete file, never a torn one.  A crc32 over every array rides in
    the payload.  ``keep_backup=True`` first rotates an existing
    checkpoint to :func:`backup_path`.  ``extra`` (str → array) rides
    along under ``extra_``-prefixed keys."""
    payload = _arrays(state)
    for k, v in (extra or {}).items():
        if not k or not isinstance(k, str):
            raise ValueError(f"extra keys must be non-empty strings; "
                             f"got {k!r}")
        payload["extra_" + k] = np.asarray(v)
    payload["checksum_crc32"] = np.uint32(_payload_crc(payload))
    target = _npz_path(path)
    tmp = target + f".tmp.{os.getpid()}"
    try:
        # savez on an open file object appends no suffix
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        if keep_backup and os.path.exists(target):
            os.replace(target, backup_path(path))
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_npz(p: str, with_extra: bool, device: torch.device):
    """One checkpoint file → state (+extras), checksum verified.  Raises
    :class:`CheckpointCorruptError` on any parse or digest failure."""
    try:
        with np.load(p) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception as e:                               # noqa: BLE001
        raise CheckpointCorruptError(
            f"checkpoint {p!r} unreadable: {type(e).__name__}: {e}") from e
    stored = arrays.pop("checksum_crc32", None)
    if stored is not None and int(stored) != _payload_crc(arrays):
        raise CheckpointCorruptError(
            f"checkpoint {p!r} failed its crc32 check (bit rot or a "
            f"partial overwrite)")
    try:
        hp = arrays["hash_params"]
        state = state_from_leaves(
            [arrays["table"], *(hp[i] for i in range(6)),
             *(arrays[k] for k in ("cand_key_hi", "cand_key_lo",
                                   "cand_count", "cand_mask", "count",
                                   "evict_max"))], device)
    except (KeyError, IndexError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {p!r} missing/malformed fields: {e}") from e
    if not with_extra:
        return state
    extras = {k[len("extra_"):]: arrays[k] for k in arrays
              if k.startswith("extra_")}
    return state, extras


def load_state(path, with_extra: bool = False, fallback: bool = False, *,
               device=None):
    """Inverse of :func:`save_state` (and of the reference's), onto
    ``device`` (None = the card).  With ``with_extra=True`` returns
    ``(state, extras)``.

    The stored crc32 is recomputed over every array; a mismatch, a torn
    file or a missing field raises :class:`CheckpointCorruptError`
    (checkpoints without a checksum load unverified).  ``fallback=True``
    then tries :func:`backup_path` before giving up."""
    dev = resolve_device(device)
    tried = [_npz_path(path)]
    if fallback:
        tried.append(backup_path(path))
    errors = []
    for p in tried:
        if not os.path.exists(p):
            errors.append(f"{p!r}: not found")
            continue
        try:
            return _load_npz(p, with_extra, dev)
        except CheckpointCorruptError as e:
            errors.append(str(e))
    raise CheckpointCorruptError(
        "no loadable checkpoint: " + "; ".join(errors))
