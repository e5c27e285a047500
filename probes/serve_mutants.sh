#!/usr/bin/env bash
# Plants one fault at a time in a copy of the checkout (probes/plant.py;
# never in the repo itself) and runs chip_smoke.py's serve_step kernel
# phase on the card against each copy; every mutant must fail that phase,
# and an unchanged copy must pass it.  Exits 0 only if so.
#
#   bash probes/serve_mutants.sh            # on a machine with the card
#
# Mutants of src/repro_torch/kernels/csrc/serve_step.cu:
#   skip_last_row     the fold leaves the last block's row out
#   bounds            the bounds check drops the last client
#   missed_from_shed  deadline_missed summed from the shed buffer
#   drain_unfused     the serve drain rounded twice (no fused multiply-add)
#   hist_aggregation  a warp's count of a bin merged as one, not by the
#                     number of its lanes' clients in it
#   vector_tail       with aligned inputs, the clients past the last whole
#                     16-byte vector of a stream are read as 0
set -u
REPO=$(cd "$(dirname "$0")/.." && pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
CU=src/repro_torch/kernels/csrc/serve_step.cu
# each mutant: the line's text as it stands | what replaces it (literal)
declare -A OLD=(
  [skip_last_row]='for (int r = lane; r < a.grid; r += 32)'
  [bounds]='if (i < a.n) {'
  [missed_from_shed]='served_full, served_short, shed, missed,'
  [drain_unfused]='const float charge_serve = __fmaf_rn(-served, per_req, avail);'
  [hist_aggregation]='for (int w = 0; w < WARPS; ++w) c += hist[w * NBINS + b];'
  [vector_tail]='const int bytes = left >= 4 ? 16 : left > 0 ? (int)left * 4 : 0;'
)
declare -A NEW=(
  [skip_last_row]='for (int r = lane; r < a.grid - 1; r += 32)'
  [bounds]='if (i < a.n - 1) {'
  [missed_from_shed]='served_full, served_short, shed, shed,'
  [drain_unfused]='const float charge_serve = __fsub_rn(avail, cserve);'
  [hist_aggregation]='for (int w = 0; w < WARPS; ++w) c += hist[w * NBINS + b] != 0;'
  [vector_tail]='const int bytes = left >= 4 ? 16 : 0;'
)
status=0
for name in clean skip_last_row bounds missed_from_shed drain_unfused \
            hist_aggregation vector_tail; do
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
from repro_torch.kernels import build, fleet_step as fs
build.build_all(['serve_step'])
c.serve_step_phase(torch, fs, 0)
" > "$WORK/$name.log" 2>&1)
  rc=$?
  if [ "$name" = clean ]; then
    if [ $rc -eq 0 ]; then
      echo "unchanged copy: passed"
      grep -E 'kernel serve_step: |^serve_step' "$WORK/$name.log"
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
