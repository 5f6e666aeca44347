"""Paged KV cache bookkeeping: a fixed pool of cache blocks, a free-list
allocator, and per-request block tables.

This module is pure host-side state — no tensors.  The device pools
(``(L, P, Hkv, BLOCK, hd)`` per layer, stacked) live in the engine and
are indexed *through* the tables built here: logical token position
``p`` of request ``r`` lives in pool block ``table[r][p // BLOCK]`` at
offset ``p % BLOCK``.  Because blocks are allocated on demand and freed
on EOS/eviction, ``cache_len`` is never pre-committed per wave (the
wave engine's core memory flaw) and a long-finished request's memory is
immediately reusable by the next admission.

Block 0 is reserved as the *null sink*: inactive decode slots carry an
all-zero table row, so their (masked, discarded) writes land in block 0
and can never alias a live request's cache.  The allocator therefore
hands out ids ``1 .. num_blocks-1`` only.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch import obs

__all__ = ["OutOfBlocks", "BlockAllocator", "BlockTable", "CacheMap",
           "SlotStateStore"]


class OutOfBlocks(RuntimeError):
    """Free list exhausted — the scheduler preempts and re-queues."""


class BlockAllocator:
    """Free-list allocator over a fixed pool of ``num_blocks`` blocks.

    Invariants (property-tested in tests/test_serve_paged.py):
      * no alias: a block id is held by at most one owner at a time;
      * no leak: free(everything allocated) restores full availability;
      * double-free and freeing the reserved null block raise.
    """

    NULL_BLOCK = 0

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null sink)")
        self.num_blocks = num_blocks
        self._free: collections.deque = collections.deque(
            range(1, num_blocks))
        self._held: set = set()

    @property
    def capacity(self) -> int:
        """Allocatable blocks (the null sink is never handed out)."""
        return self.num_blocks - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._held)

    def alloc(self) -> int:
        if not self._free:
            raise OutOfBlocks(
                f"all {self.capacity} cache blocks in use")
        b = self._free.popleft()
        self._held.add(b)
        return b

    def free(self, ids: Iterable[int]) -> None:
        for b in ids:
            if b == self.NULL_BLOCK:
                raise ValueError("block 0 is the reserved null sink")
            if b not in self._held:
                raise ValueError(f"double free / foreign block {b}")
            self._held.remove(b)
            self._free.append(b)


class BlockTable:
    """Logical-order pool block ids for one request."""

    __slots__ = ("block_size", "ids")

    def __init__(self, block_size: int) -> None:
        self.block_size = block_size
        self.ids: List[int] = []

    @property
    def capacity(self) -> int:
        """Token positions currently backed by allocated blocks."""
        return len(self.ids) * self.block_size

    def ensure(self, n_tokens: int, allocator: BlockAllocator) -> int:
        """Grow the table to cover ``n_tokens`` positions; returns the
        number of blocks newly allocated.  Raises :class:`OutOfBlocks`
        mid-growth — already-allocated blocks stay in the table, so the
        caller can release the whole table on preemption."""
        grew = 0
        while self.capacity < n_tokens:
            self.ids.append(allocator.alloc())
            grew += 1
        return grew

    def row(self, nmax: int) -> np.ndarray:
        """Fixed-width int32 row (padded with the null block) — the unit
        the device step consumes as one row of the (B, nmax) table."""
        if len(self.ids) > nmax:
            raise ValueError(f"request needs {len(self.ids)} blocks > "
                             f"table width {nmax}")
        out = np.zeros((nmax,), np.int32)
        out[:len(self.ids)] = self.ids
        return out


class SlotStateStore:
    """Host-side ledger for the per-slot recurrent-state rows.

    The device rows (conv carries + SSM state of the ssm/hybrid
    families, which the port does not serve yet; dense models keep none)
    live with the engine's pools; this class owns WHICH request
    each row belongs to, in lockstep with block-table release: the
    scheduler calls :meth:`bind` on admission and :meth:`release` on
    finish / EOS-eviction / preemption, right next to
    ``CacheMap.release``.  The zero-reset of a re-bound row happens
    inside the prefill step (``pos_start == 0``), so a bind here
    never races device work and there is no host-side reset to forget.

    Invariants (tested in tests/test_serve_state.py):
      * a slot is owned by at most one request, a request owns at most
        one slot;
      * binding an occupied slot, re-binding a bound request, and
        releasing a request that holds no slot all raise;
      * a released slot is immediately rebindable.
    """

    def __init__(self, slots: int) -> None:
        if slots < 1:
            raise ValueError("need >= 1 slot")
        self.n_slots = slots
        self._owner: List[Optional[int]] = [None] * slots
        self._slot_of: Dict[int, int] = {}
        self.binds = 0
        self.releases = 0

    @property
    def bound(self) -> int:
        return len(self._slot_of)

    def owner(self, slot: int) -> Optional[int]:
        return self._owner[slot]

    def slot_of(self, rid: int) -> Optional[int]:
        return self._slot_of.get(rid)

    def bind(self, slot: int, rid: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.n_slots})")
        if self._owner[slot] is not None:
            raise ValueError(f"slot {slot} already owned by request "
                             f"{self._owner[slot]}")
        if rid in self._slot_of:
            raise ValueError(f"request {rid} already bound to slot "
                             f"{self._slot_of[rid]}")
        self._owner[slot] = rid
        self._slot_of[rid] = slot
        self.binds += 1

    def release(self, rid: int) -> int:
        """Unbind ``rid``'s slot row; returns the freed slot."""
        slot = self._slot_of.pop(rid, None)
        if slot is None:
            raise ValueError(f"request {rid} holds no slot row")
        self._owner[slot] = None
        self.releases += 1
        return slot


class CacheMap:
    """Allocator + per-request block tables for one engine instance."""

    def __init__(self, num_blocks: int, block_size: int,
                 max_seq_len: int) -> None:
        self.allocator = BlockAllocator(num_blocks)
        self.block_size = block_size
        self.max_seq_len = max_seq_len
        # table width of every device step
        self.nmax = -(max_seq_len // -block_size)
        self._tables: Dict[int, BlockTable] = {}

    def blocks_needed(self, n_tokens: int) -> int:
        return -(n_tokens // -self.block_size)

    def fits_ever(self, n_tokens: int) -> bool:
        """Whether a request of ``n_tokens`` total (prompt + max_new)
        could run even with the whole pool to itself."""
        return (self.blocks_needed(n_tokens) <= self.allocator.capacity
                and n_tokens <= self.nmax * self.block_size)

    def ensure(self, rid: int, n_tokens: int) -> None:
        """Back positions [0, n_tokens) of request ``rid`` with blocks.
        Raises :class:`OutOfBlocks` when the pool is exhausted."""
        t = self._tables.get(rid)
        if t is None:
            t = self._tables[rid] = BlockTable(self.block_size)
        t.ensure(n_tokens, self.allocator)

    def release(self, rid: int) -> int:
        """Free every block of ``rid`` (EOS / eviction / preemption);
        returns the number of blocks reclaimed."""
        t = self._tables.pop(rid, None)
        if t is None:
            return 0
        self.allocator.free(t.ids)
        obs.TRACE.emit("EVICT", rid=rid, arg=len(t.ids))
        return len(t.ids)

    def row(self, rid: int) -> np.ndarray:
        t = self._tables.get(rid)
        if t is None:
            return np.zeros((self.nmax,), np.int32)
        return t.row(self.nmax)

    @property
    def blocks_in_use(self) -> int:
        return self.allocator.in_use
