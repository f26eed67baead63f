"""Framework integration: multitude-targeted mining over an LM training
corpus — the analytics service the mining engine provides inside the training
framework.

Documents (token sequences from the data pipeline) become transactions (their
token-id sets); the Minority-Report Algorithm mines which token combinations
are over-represented in a minority document class (e.g. a rare quality/label
bucket) — the same counting kernel the mesh runtime shards.

  PYTHONPATH=src python examples/torch/corpus_pattern_mining.py \
      [--device cuda|cpu]
"""
import argparse

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.data import TokenPipeline
from repro_torch.mining import minority_report_dense


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernel) or cpu (the plain "
                         "PyTorch version)")
    device = resolve_device(ap.parse_args().device)
    vocab = 512
    pipe = TokenPipeline(vocab_size=vocab, seq_len=64, global_batch=64, seed=7)
    rng = np.random.default_rng(7)

    docs, labels = [], []
    marker_tokens = [11, 23, 37]   # planted minority-class pattern
    for step in range(30):
        batch = pipe.batch_at(step)["tokens"]
        for row in batch:
            rare = rng.random() < 0.05
            toks = set(int(t) for t in row)
            if rare:
                toks |= set(marker_tokens)
            docs.append(sorted(toks))
            labels.append(int(rare))

    res = minority_report_dense(
        docs, labels, min_support=0.01, min_confidence=0.6, device=device)
    print(f"{len(docs)} documents, {sum(labels)} rare; "
          f"{len(res.rules)} minority-class token rules")
    planted = [r for r in res.rules
               if set(r.antecedent) & set(marker_tokens)]
    print(f"rules touching planted marker tokens: {len(planted)}")
    for r in sorted(planted, key=lambda r: -len(r.antecedent))[:5]:
        print("  ", r)
    got = {tuple(sorted(marker_tokens))} & {r.antecedent for r in res.rules}
    assert got, "planted pattern not recovered!"
    print("planted pattern recovered exactly:", got)


if __name__ == "__main__":
    main()
