#!/usr/bin/env bash
# Plants one fault at a time in a copy of the checkout (never in the repo
# itself) and runs chip_smoke.py's flash_attention kernel phase on the card
# against each copy; every mutant must fail that phase, and an unchanged
# copy must pass it.  Exits 0 only if so.
#
#   bash probes/flash_mutants.sh            # on a machine with the card
#
# Mutants of src/repro_torch/kernels/csrc/flash_attention.cu:
#   diagonal      the causal mask is off by one: a row no longer sees its
#                 own key (col < row)
#   stale_stage   the consumer reads K from the other ring stage (the stage
#                 parity flipped): a stale tile, or one still landing
#   ragged_tail   the last, ragged KV tile is skipped (Skv / BK tiles)
#   gqa_mod       query head h reads KV head h % K instead of h / (H / K)
set -u
REPO=$(cd "$(dirname "$0")/.." && pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
CU=src/repro_torch/kernels/csrc/flash_attention.cu
declare -A EDIT=(
  [diagonal]='s/if (p.causal) ok = ok \&\& col <= row;/if (p.causal) ok = ok \&\& col < row;/'
  [stale_stage]='s/scores<D, BQ, BK>(sc, dq, dk, s);/scores<D, BQ, BK>(sc, dq, dk, s ^ 1);/'
  [ragged_tail]='s/const int nk = (p.Skv + bk - 1) \/ bk;/const int nk = p.Skv \/ bk;/'
  [gqa_mod]='s/const int kh = h \/ (p.H \/ p.K);/const int kh = h % p.K;/'
)
status=0
for name in clean diagonal stale_stage ragged_tail gqa_mod; do
  copy="$WORK/$name"
  mkdir -p "$copy"
  (cd "$REPO" && tar --exclude=.git --exclude=src/repro_torch/kernels/_build \
       -cf - src chip_smoke.py) | tar -C "$copy" -xf -
  if [ "$name" != clean ]; then
    sed -i "${EDIT[$name]}" "$copy/$CU"
    if cmp -s "$REPO/$CU" "$copy/$CU"; then
      echo "mutant $name: the edit did not apply"; status=1; continue
    fi
  fi
  (cd "$copy" && timeout 600 python3 -c "
import sys, torch
sys.path.insert(0, 'src')
import chip_smoke as c
from repro_torch.kernels import build, flash_attention as fa
build.build_all(['flash_attention'])
c.kernel_phase(torch, fa, 0)
" > "$WORK/$name.log" 2>&1)
  rc=$?
  if [ "$name" = clean ]; then
    if [ $rc -eq 0 ]; then
      echo "unchanged copy: passed"
      grep -E '^flash_attention ' "$WORK/$name.log"
      grep -E 'worst err/bound' "$WORK/$name.log" | sed 's/.*worst err\/bound=//' \
        | sort -g | tail -1 | sed 's/^/unchanged copy: largest err\/bound /'
    else
      echo "unchanged copy: FAILED (exit $rc)"; tail -5 "$WORK/$name.log"; status=1
    fi
  elif [ $rc -eq 0 ]; then
    echo "mutant $name: NOT caught"; status=1
  else
    echo "mutant $name: caught (exit $rc): $(grep -m1 -E 'FAIL|Error' "$WORK/$name.log")"
  fi
done
exit $status
