#!/usr/bin/env bash
# Plants one fault at a time in a copy of the checkout (probes/plant.py;
# never in the repo itself) and runs chip_smoke.py's sharded fleet phase
# (phase 13) on the card against each copy; every mutant must fail that
# phase, and an unchanged copy must pass it.  Exits 0 only if so.
#
#   bash probes/sharded_mutants.sh [NAME...]   # on a machine with the card
#
# With NAMEs, the unchanged copy and those mutants only.
#
# Mutants:
#   drop_rank_row    fused_step_sharded skips the all-reduce: each rank
#                    finalizes its own row alone, the other rank's dropped
#                    (kernels/fleet_step.py)
#   counts_float32   the fleet kernel's row carries each bin count rounded
#                    to float32, as an all-reduce of float32 counts would
#                    (kernels/csrc/fleet_step.cu; seen above 2^24)
#   slab_from_zero   a slab draws its clients' randomness from index 0, not
#                    from its first global index (energy/arrivals.py)
#   finalize_rz      the fleet finalize rounds each all-reduced sum toward
#                    zero, not to nearest (kernels/csrc/fleet_step.cu; only
#                    a row no float32 holds tells them apart: the
#                    scenario's rows over two ranks, where the finalize is
#                    held bitwise against step_ops.row_stats)
set -u
REPO=$(cd "$(dirname "$0")/.." && pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
declare -A FILE=(
  [drop_rank_row]=src/repro_torch/kernels/fleet_step.py
  [counts_float32]=src/repro_torch/kernels/csrc/fleet_step.cu
  [slab_from_zero]=src/repro_torch/energy/arrivals.py
  [finalize_rz]=src/repro_torch/kernels/csrc/fleet_step.cu
)
# each mutant: the text as it stands | what replaces it (literal)
declare -A OLD=(
  [drop_rank_row]=$'    collectives.all_reduce_row(row, group)\n'
  [counts_float32]='if (t < H) row[F + t] = (double)csum[t];'
  [slab_from_zero]='torch.arange(first, first + n,'
  [finalize_rz]='if (t < F) fsum[t] = __double2float_rn(row[t]);'
)
declare -A NEW=(
  [drop_rank_row]=''
  [counts_float32]='if (t < H) row[F + t] = (double)(float)csum[t];'
  [slab_from_zero]='torch.arange(0, n,'
  [finalize_rz]='if (t < F) fsum[t] = __double2float_rz(row[t]);'
)
status=0
NAMES=("$@")
[ ${#NAMES[@]} -eq 0 ] && NAMES=(drop_rank_row counts_float32 slab_from_zero finalize_rz)
for name in clean "${NAMES[@]}"; do
  copy="$WORK/$name"
  if [ "$name" = clean ]; then
    python3 "$REPO/probes/plant.py" "$copy" || { status=1; continue; }
  elif ! python3 "$REPO/probes/plant.py" "$copy" "${FILE[$name]}" \
         "${OLD[$name]}" "${NEW[$name]}"; then
    echo "mutant $name: the edit did not apply"; status=1; continue
  fi
  (cd "$copy" && timeout 900 python3 -c "
import sys, torch
sys.path.insert(0, 'src')
import chip_smoke as c
from repro_torch.kernels import build, fleet_step as fs
build.build_all(['fleet_step', 'serve_step'])
c.sharded_phase(torch, fs, 0, c.nvidia_smi())
" > "$WORK/$name.log" 2>&1)
  rc=$?
  if [ "$name" = clean ]; then
    if [ $rc -eq 0 ]; then
      echo "unchanged copy: passed"
      grep -E '^sharded' "$WORK/$name.log"
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
