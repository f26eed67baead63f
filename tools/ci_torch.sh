#!/usr/bin/env bash
# CI entry point of the PyTorch port (src/repro_torch), the twin of
# tools/ci.sh: the port's fast tier, its lint (self-test, gate, dead
# modules), the four serve_counts smokes with --verify, and the seven
# examples under examples/torch/.  DEVICE must be set to cpu or cuda; with
# cuda every step runs on the card and the run ends with chip_smoke.py.
#
#   DEVICE=cpu tools/ci_torch.sh
#   DEVICE=cuda tools/ci_torch.sh
#
# No perfgate step yet: the port has no BENCH files.  The gate arrives with
# the port's first benchmark records.
set -euo pipefail
cd "$(dirname "$0")/.."

case "${DEVICE:-}" in
    cpu|cuda) ;;
    *) echo "ci_torch.sh: set DEVICE=cpu or DEVICE=cuda" >&2; exit 2 ;;
esac

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

echo "=== port fast tier (pytest -m 'not slow' tests/test_torch_*.py) ==="
python -m pytest -x -q -m "not slow" tests/test_torch_*.py

echo "=== port static analysis (repro-lint: self-test, gate, dead modules) ==="
# self-test first: an analyzer that cannot catch an injected violation
# must not be allowed to greenlight the tree
python -m repro_torch.launch.analyze --self-test
python -m repro_torch.launch.analyze
# advisory only — import-graph report, never fails the build
python -m repro_torch.launch.analyze --dead-modules

echo "=== serving smoke (count server submit/flush/append + verify) ==="
python -m repro_torch.launch.serve_counts --rows 2000 --items 24 --rounds 4 \
    --batch 16 --appends 1 --append-rows 300 --pool 64 --theta 0.08 --verify \
    --device "$DEVICE"

echo "=== shard-serve smoke (sharded store + async flush loop + verify) ==="
python -m repro_torch.launch.serve_counts --rows 2000 --items 24 --rounds 4 \
    --batch 16 --appends 1 --append-rows 300 --pool 64 --shards 2 \
    --async-flush --max-delay-ms 25 --theta 0.08 --verify --device "$DEVICE"

echo "=== rule-serve smoke (minority rules over the count path + verify) ==="
python -m repro_torch.launch.serve_counts --rows 2000 --items 24 --rounds 4 \
    --batch 16 --appends 2 --append-rows 300 --pool 64 --p-y 0.2 \
    --theta 0.02 --rules --min-conf 0.1 --verify --device "$DEVICE"

echo "=== disk-tier smoke (spilled store + background compactor + verify) ==="
# a tiny spill budget forces REAL on-disk segments under the serving loop,
# with the background compactor folding appended deltas
SPILL_DIR="$(mktemp -d)"
python -m repro_torch.launch.serve_counts --rows 2000 --items 24 --rounds 4 \
    --batch 16 --appends 2 --append-rows 300 --pool 64 \
    --spill-dir "$SPILL_DIR" --spill-threshold-bytes 4096 --bg-compact \
    --min-compact-rows 64 --theta 0.08 --verify --device "$DEVICE"
rm -rf "$SPILL_DIR"

echo "=== examples (each asserts its own exactness) ==="
for example in quickstart incremental_mining corpus_pattern_mining \
        count_server rule_server streaming_bigdata minority_report_census; do
    echo "--- examples/torch/$example.py ---"
    python "examples/torch/$example.py" --device "$DEVICE"
done

if [ "$DEVICE" = cuda ]; then
    echo "=== chip smoke (every kernel against its plain version) ==="
    python3 chip_smoke.py
fi
