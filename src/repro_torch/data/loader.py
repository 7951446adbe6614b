"""Sharded input plan with over-decomposition (straggler mitigation): a
copy of the reference's ``repro.data.loader`` (plain Python).

Work is split into many more logical shards than hosts (default 16×).
Each host owns a deterministic *primary* slice; leftover shards from a
slow/failed host re-queue onto finishers — because assignment is a pure
function of (epoch, shard count, host count), every host computes the
same plan with zero coordination.  Resuming after a crash replays the
plan from the recorded (epoch, cursor).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    num_shards: int              # logical shards (≫ hosts)
    num_hosts: int
    epoch: int = 0

    def shards_for(self, host: int) -> List[int]:
        """Deterministic primary assignment: strided round-robin, rotated
        per epoch so hot shards move between hosts."""
        rot = (self.epoch * 7919) % self.num_shards
        return [(s + rot) % self.num_shards
                for s in range(host, self.num_shards, self.num_hosts)]

    def steal_order(self, host: int) -> List[int]:
        """Order in which a finished host picks up other hosts' leftovers
        (reverse order of the victim's own list — steal from the tail)."""
        order = []
        for other in range(1, self.num_hosts):
            victim = (host + other) % self.num_hosts
            order.extend(reversed(self.shards_for(victim)))
        return order


class ShardedLoader:
    """Iterates (shard_id, batch) pairs for one host.

    ``make_batch(shard_id, batch_idx)`` generates data purely from ids —
    works for synthetic generators and for file-backed shards alike.

    Fault handling: ``on_error(shard, exc) -> bool`` (optional) is
    consulted when ``make_batch`` raises.  Returning True SKIPS the shard
    — it is recorded in ``self.failed``, left out of ``completed`` (so a
    shared completion board lets another host's steal pass rescue it),
    and NONE of its batches are delivered: with a handler installed each
    shard's batches are buffered and yielded only once the whole shard
    materialized, so a mid-shard failure can never half-deliver (the
    streaming fold downstream cannot un-ingest).  Returning False/None
    re-raises (fail loud).  Without a handler, behavior is unchanged:
    batches stream unbuffered and errors propagate.
    """

    def __init__(self, plan: ShardPlan, host: int,
                 make_batch: Callable[[int, int], dict],
                 batches_per_shard: int = 1,
                 completed: Optional[Sequence[int]] = None,
                 on_error: Optional[Callable[[int, Exception], bool]] = None):
        self.plan = plan
        self.host = host
        self.make_batch = make_batch
        self.batches_per_shard = batches_per_shard
        self.completed = set(completed or ())
        self.on_error = on_error
        self.failed: set = set()

    def _shard_batches(self, shard: int) -> Iterator[tuple]:
        """All-or-nothing delivery of one shard (see class docstring).
        Yields nothing if the shard failed and the handler swallowed."""
        if self.on_error is None:
            for b in range(self.batches_per_shard):
                yield shard, self.make_batch(shard, b)
            return
        try:
            batches = [self.make_batch(shard, b)
                       for b in range(self.batches_per_shard)]
        except Exception as e:                           # noqa: BLE001
            if self.on_error(shard, e):
                self.failed.add(shard)
                return
            raise
        for batch in batches:
            yield shard, batch

    def __iter__(self) -> Iterator[tuple]:
        for shard in self.plan.shards_for(self.host):
            if shard in self.completed:
                continue
            delivered = False
            for pair in self._shard_batches(shard):
                delivered = True
                yield pair
            if delivered or shard not in self.failed:
                self.completed.add(shard)

    def steal(self, globally_completed: Sequence[int]) -> Iterator[tuple]:
        """After finishing the primary slice: process other hosts' leftovers
        that nobody has completed yet (straggler pickup).  Failed shards
        are skipped here too (and stay failed — this host's view of the
        shard is broken; a DIFFERENT host's steal pass may still get it)."""
        done = set(globally_completed) | self.completed | self.failed
        for shard in self.plan.steal_order(self.host):
            if shard in done:
                continue
            delivered = False
            for pair in self._shard_batches(shard):
                delivered = True
                yield pair
            done.add(shard)
            if delivered or shard not in self.failed:
                self.completed.add(shard)
