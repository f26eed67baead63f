from .ops import (itemset_counts, itemset_counts_into, itemset_counts_ref,
                  itemset_counts_ref_blocked)
