from .ops import count_rows, gather_rows, pack_rows, row_heads
