# Online count-serving subsystem: a versioned resident encoded DB answering
# micro-batched itemset-count queries (the paper's "count of a given large
# list of itemsets" contract as a serving workload), with an
# (itemset, version)-keyed LRU result cache, §5.2 incremental re-mining, a
# sharded store spanning a torch.distributed device mesh (exact all-reduced
# counts), a deadline/occupancy-triggered background flush loop and a
# background compactor, and MRA minority-rule serving (RuleServer:
# confidence from the per-class count rows, rule cache keyed on
# (antecedent, version, min_conf), version prefetch on append).  Every store
# counts on its ``device`` (default: the card).
from .async_loop import AsyncFlusher, CountFuture
from .compactor import AsyncCompactor
from .batcher import (BatchPlan, MicroBatcher, QueryRequest, build_masks,
                      canonical_itemset)
from .cache import CountCache
from .rules import RuleCache, RuleServer
from .service import (Answers, CountServer, MiningRefreshError,
                      versioned_mine_frequent)
from .shard import ShardedCountBackend, ShardedDB
from .store import VersionedCountBackend, VersionedDB, check_class_labels

__all__ = [
    "Answers", "AsyncCompactor", "AsyncFlusher", "BatchPlan", "CountFuture",
    "MicroBatcher",
    "QueryRequest", "build_masks", "canonical_itemset", "CountCache",
    "CountServer", "MiningRefreshError", "versioned_mine_frequent",
    "RuleCache", "RuleServer", "ShardedCountBackend", "ShardedDB",
    "VersionedCountBackend", "VersionedDB", "check_class_labels",
]
