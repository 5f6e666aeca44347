"""Serving: block pool + slot scheduler (host), the paged engine and the
wave-based reference batcher."""
from repro_torch.serve.engine import (ContinuousBatcher, PagedEngine,
                                      Request, sample)
from repro_torch.serve.paged import (BlockAllocator, BlockTable, CacheMap,
                                     OutOfBlocks, SlotStateStore)
from repro_torch.serve.sched import Seq, SlotScheduler

__all__ = ["ContinuousBatcher", "PagedEngine", "Request", "sample",
           "BlockAllocator", "BlockTable", "CacheMap", "OutOfBlocks",
           "SlotStateStore", "Seq", "SlotScheduler"]
