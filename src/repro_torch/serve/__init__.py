"""Paged serving: block pool + slot scheduler (host) and the engine."""
from repro_torch.serve.engine import PagedEngine, Request, sample
from repro_torch.serve.paged import (BlockAllocator, BlockTable, CacheMap,
                                     OutOfBlocks, SlotStateStore)
from repro_torch.serve.sched import Seq, SlotScheduler

__all__ = ["PagedEngine", "Request", "sample", "BlockAllocator",
           "BlockTable", "CacheMap", "OutOfBlocks", "SlotStateStore", "Seq",
           "SlotScheduler"]
