"""§5.2 extension demo: incremental frequent-itemset mining with GFP-guided
recounts — a stream of transaction batches arrives; the miner keeps the exact
frequent-itemset set of everything seen so far without ever re-mining the full
history, by guided (targeted) recounts in the big historical tree.

The miner is the paper-faithful host engine; ``--device`` is resolved all
the same, so that the example runs where its siblings run (the card unless
``--device cpu``).

  PYTHONPATH=src python examples/torch/incremental_mining.py \
      [--device cuda|cpu]
"""
import argparse
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import mine_frequent
from repro_torch.core.incremental import IncrementalMiner
from repro_torch.data import bernoulli_db


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    resolve_device(ap.parse_args().device)
    theta = 0.05
    tx0, _ = bernoulli_db(4000, 40, p_x=0.15, p_y=0.0, seed=0)
    miner = IncrementalMiner(theta)
    t0 = time.time()
    freq = miner.fit(tx0)
    print(f"bootstrap: {len(tx0)} rows -> {len(freq)} frequent itemsets "
          f"({time.time() - t0:.2f}s)")

    history = list(tx0)
    for i in range(1, 4):
        batch, _ = bernoulli_db(500, 40, p_x=0.15 + 0.02 * i, p_y=0.0, seed=i)
        t0 = time.time()
        freq = miner.update(batch)
        t_inc = time.time() - t0
        history += batch

        t0 = time.time()
        full = mine_frequent(history, max(1, int(np.ceil(theta * len(history) - 1e-9))))
        t_full = time.time() - t0
        assert freq == full, (len(freq), len(full))
        print(f"batch {i}: +{len(batch)} rows -> {len(freq)} itemsets; "
              f"incremental {t_inc:.2f}s vs full re-mine {t_full:.2f}s "
              f"({t_full / max(t_inc, 1e-9):.1f}x) — exact match")
    print(f"guided-recount stats: {miner.state.stats}")


if __name__ == "__main__":
    main()
