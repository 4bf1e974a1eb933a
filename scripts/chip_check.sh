#!/usr/bin/env bash
# The port's whole check on one GPU: chip_smoke.py, then the card-only
# tests, in the checkout that holds this script (so the kernels build
# once, for both).
#
#     bash scripts/chip_check.sh [OUT_DIR]
#
# Writes OUT_DIR/smoke.log (chip_smoke.py's output), OUT_DIR/cardtests.log
# (pytest -m cuda: the kernels' and the span recorder's card tests) and
# OUT_DIR/summary.txt (the card's name and power limit, each exit code);
# prints the summary and the
# last lines of each log.  OUT_DIR defaults to chiprun_out/check under the
# checkout.  Exits non-zero when either part fails.  To check that the
# committed files are enough, unpack `git archive` of the tree into a
# directory .gitignore lists and run this script from there.
set -u
cd "$(dirname "$0")/.."
out=${1:-chiprun_out/check}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    > "$out/summary.txt"
start=$(date +%s)
python3 chip_smoke.py > "$out/smoke.log" 2>&1
smoke=$?
echo "smoke seconds $(( $(date +%s) - start ))" >> "$out/summary.txt"
PYTHONPATH=src python3 -m pytest -q -p no:cacheprovider -m cuda \
    tests/test_torch_cuda.py tests/test_torch_spans.py \
    portbench/test_portbench_program_spans.py > "$out/cardtests.log" 2>&1
cards=$?
echo "smoke exit $smoke" >> "$out/summary.txt"
echo "cardtests exit $cards" >> "$out/summary.txt"
tail -n 40 "$out/smoke.log"
tail -n 3 "$out/cardtests.log"
cat "$out/summary.txt"
[ "$smoke" -eq 0 ] && [ "$cards" -eq 0 ]
