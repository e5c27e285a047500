#!/usr/bin/env bash
# Plants one fault at a time in a copy of the checkout (never in the repo
# itself) and runs chip_smoke.py's serve_step kernel phase on the card
# against each copy; every mutant must fail that phase.  Exits 0 only if
# every mutant was caught.
#
#   bash probes/serve_mutants.sh            # on a machine with the card
#
# Mutants of src/repro_torch/kernels/csrc/serve_step.cu:
#   skip_last_block  the second pass leaves the last block's row out
#   bounds           the bounds check drops the last client
#   missed_from_shed deadline_missed summed from the shed buffer
#   drain_unfused    the serve drain rounded twice (no fused multiply-add)
set -u
REPO=$(cd "$(dirname "$0")/.." && pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
CU=src/repro_torch/kernels/csrc/serve_step.cu
declare -A EDIT=(
  [skip_last_block]='s/for (int r = lane; r < blocks; r += 32)/for (int r = lane; r < blocks - 1; r += 32)/'
  [bounds]='s/if (i >= a.n) continue;/if (i >= a.n - 1) continue;/'
  [missed_from_shed]='s/served_full, served_short, shed, missed,/served_full, served_short, shed, shed,/'
  [drain_unfused]='s/const float charge_serve = __fmaf_rn(-served, per_req, avail);/const float charge_serve = __fsub_rn(avail, cserve);/'
)
status=0
for name in skip_last_block bounds missed_from_shed drain_unfused; do
  copy="$WORK/$name"
  mkdir -p "$copy"
  (cd "$REPO" && tar --exclude=.git --exclude=src/repro_torch/kernels/_build \
       -cf - src chip_smoke.py) | tar -C "$copy" -xf -
  sed -i "${EDIT[$name]}" "$copy/$CU"
  if cmp -s "$REPO/$CU" "$copy/$CU"; then
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
  if [ $rc -eq 0 ]; then
    echo "mutant $name: NOT caught"; status=1
  else
    echo "mutant $name: caught (exit $rc): $(grep -m1 -E 'FAIL|Error' "$WORK/$name.log")"
  fi
done
exit $status
