#!/usr/bin/env bash
# Plants one fault at a time in a copy of the checkout (probes/plant.py;
# never in the repo itself) and runs chip_smoke.py's fused_agg kernel
# phase on the card against each copy; every mutant must fail that phase,
# and an unchanged copy must pass it.  Exits 0 only if so.
#
#   bash probes/agg_mutants.sh              # on a machine with the card
#
# Mutants of src/repro_torch/kernels/csrc/fused_agg.cu (the segmented
# launch):
#   skip_last_block   the launch leaves out the last segment's last block
#   neighbour_stack   a segment reads its neighbour's w_stack (the one
#                     before it in the table)
set -u
REPO=$(cd "$(dirname "$0")/.." && pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
CU=src/repro_torch/kernels/csrc/fused_agg.cu
# each mutant: the line's text as it stands | what replaces it (literal)
declare -A OLD=(
  [skip_last_block]='const long long blocks = end.first_block + blocks_of(end);'
  [neighbour_stack]='const Segment& sg = tab.seg[g];
  const long long blk'
)
declare -A NEW=(
  [skip_last_block]='const long long blocks = end.first_block + blocks_of(end) - 1;'
  [neighbour_stack]='Segment sg = tab.seg[g];
  if (g > 0) sg.w_stack = tab.seg[g - 1].w_stack;
  const long long blk'
)
status=0
for name in clean skip_last_block neighbour_stack; do
  copy="$WORK/$name"
  if [ "$name" = clean ]; then
    python3 "$REPO/probes/plant.py" "$copy" || { status=1; continue; }
  elif ! python3 "$REPO/probes/plant.py" "$copy" "$CU" "${OLD[$name]}" \
         "${NEW[$name]}"; then
    echo "mutant $name: the edit did not apply"; status=1; continue
  fi
  (cd "$copy" && timeout 600 python3 -c "
import sys, torch
sys.path.insert(0, 'src')
import chip_smoke as c
from repro_torch.kernels import build, fused_agg as agg
build.build_all(['fused_agg'])
c.fused_agg_phase(torch, agg, 0)
" > "$WORK/$name.log" 2>&1)
  rc=$?
  if [ "$name" = clean ]; then
    if [ $rc -eq 0 ]; then
      echo "unchanged copy: passed"
      grep -E 'CNN tree|^fused_agg' "$WORK/$name.log"
    else
      echo "unchanged copy: FAILED (exit $rc)"; tail -5 "$WORK/$name.log"
      status=1
    fi
  elif [ $rc -eq 0 ]; then
    echo "mutant $name: NOT caught"; status=1
  else
    echo "mutant $name: caught (exit $rc): $(grep -m1 -E 'FAIL|Error' "$WORK/$name.log")"
  fi
done
exit $status
