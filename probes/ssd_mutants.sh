#!/usr/bin/env bash
# Plants one fault at a time in a copy of the checkout (never in the repo
# itself) and runs chip_smoke.py's ssd_scan kernel phase on the card
# against each copy; every mutant must fail that phase, and an unchanged
# copy must pass it.  Exits 0 only if so.
#
#   bash probes/ssd_mutants.sh              # on a machine with the card
#
# Mutants of src/repro_torch/kernels/csrc/ssd_scan.cu:
#   drop_inter      y leaves out the inter-chunk term exp(cum_t) C_t . h^T
#   no_carry        the state is not carried: h' = the chunk's update only
#   mask_off_by_one the causal mask drops the diagonal (s < t)
#   state_row       the state update leaves the last row of each key tile out
#   m_bf16          the intra-chunk weights M are rounded to bf16 before M x
#   m_tf32          ... to TF32 (10 mantissa bits, nearest, ties away)
#   state_tf32      the state update's operand x dt exp(.) is rounded to TF32
set -u
REPO=$(cd "$(dirname "$0")/.." && pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
CU=src/repro_torch/kernels/csrc/ssd_scan.cu
declare -A EDIT=(
  [drop_inter]='s/row\[col\] = acc\[a\]\[c\] + e \* inter\[a\]\[c\];/row[col] = acc[a][c];/'
  [no_carry]='s/\*hv = decay \* \*hv + dh\[a\]\[c\];/*hv = dh[a][c];/'
  [mask_off_by_one]='s/if (s <= t \&\& t < Q)/if (s < t \&\& t < Q)/'
  [state_row]='s/for (int s = 0; s < kvalid; ++s) {/for (int s = 0; s < kvalid - 1; ++s) {/'
  [m_bf16]='s/\(Ms\[(ty + 16 \* a) \* LDM + tx + 16 \* c\]\) = m;/\1 = __bfloat162float(__float2bfloat16(m));/'
  [m_tf32]='s/\(Ms\[(ty + 16 \* a) \* LDM + tx + 16 \* c\]\) = m;/\1 = __uint_as_float((__float_as_uint(m) + 0x1000u) \& 0xffffe000u);/'
  [state_tf32]='s/xv\[a\] = \(xs\[s \* LDX + sx + 8 \* a\] \* w\);/xv[a] = __uint_as_float((__float_as_uint(\1) + 0x1000u) \& 0xffffe000u);/'
)
status=0
for name in clean drop_inter no_carry mask_off_by_one state_row m_bf16 m_tf32 \
            state_tf32; do
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
from repro_torch.kernels import build, ssd_scan as ssd
build.build_all(['ssd_scan'])
c.ssd_scan_phase(torch, ssd, 0)
" > "$WORK/$name.log" 2>&1)
  rc=$?
  if [ "$name" = clean ]; then
    if [ $rc -eq 0 ]; then
      echo "unchanged copy: passed"; grep 'kernel ssd_scan' "$WORK/$name.log"
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
