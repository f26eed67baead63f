# The device mining engine: bitmap encoding, TIS level scheduling, the dense
# counting engine, the streaming out-of-core engine, the guided FP-growth
# device hybrid, the adaptive backend chooser, and the CountBackend protocol
# + unified level-wise driver they share.
from .encode import (ItemVocab, class_weights, dedup_rows, decode_row,
                     encode_bitmap, encode_targets, extend_vocab, pad_words,
                     project_columns)
from .backend import CountBackend, DenseBackend, StreamingBackend
from .checkpoint import MiningCheckpoint
from .chooser import (BackendChoice, DatasetTraits, backend_for_db,
                      choose_backend)
from .dense import (DenseDB, DenseMRAResult, dense_gfp_counts,
                    dense_mine_frequent, minority_report_dense, mra_encode)
from .driver import mine_frequent as mine_frequent_backend
from .gfp_backend import GFPBackend, gfp_mine_frequent, gfp_multitude_counts
from .plan import (TISSchedule, build_schedule, canonical_itemsets,
                   choose_chunk_rows, live_items, stream_chunks)
from .stream import StreamingDB, streaming_counts, streaming_mine_frequent
