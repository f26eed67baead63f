# The device mining engine: bitmap encoding, TIS level scheduling, the dense
# counting engine, the streaming out-of-core engine, and the CountBackend
# protocol + unified level-wise driver they share.
from .encode import (ItemVocab, class_weights, dedup_rows, decode_row,
                     encode_bitmap, encode_targets, extend_vocab, pad_words,
                     project_columns)
from .backend import CountBackend, DenseBackend, StreamingBackend
from .checkpoint import MiningCheckpoint
from .dense import (DenseDB, DenseMRAResult, dense_gfp_counts,
                    dense_mine_frequent, minority_report_dense, mra_encode)
from .driver import mine_frequent as mine_frequent_backend
from .plan import (TISSchedule, build_schedule, canonical_itemsets,
                   choose_chunk_rows, live_items, stream_chunks)
from .stream import StreamingDB, streaming_counts, streaming_mine_frequent
