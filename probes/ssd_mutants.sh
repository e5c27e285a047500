#!/usr/bin/env bash
# Plants one fault at a time in a copy of the checkout (probes/plant.py;
# never in the repo itself) and runs chip_smoke.py's ssd_scan kernel phase
# on the card against each copy; every mutant must fail that phase, and an
# unchanged copy must pass it.  Exits 0 only if so.
#
#   bash probes/ssd_mutants.sh              # on a machine with the card
#
# Mutants of src/repro_torch/kernels/csrc/ssd_scan.cu (the bf16 path):
#   drop_inter        y leaves out the inter-chunk term exp(cum_t) C_t . h^T
#   no_carry          the state is not carried: h' = the chunk's update only
#   mask_off_by_one   the causal mask drops the diagonal (s < t)
#   state_row         the state update leaves the last row of each key tile out
#   m_bf16            the intra-chunk weights M are rounded to bf16 before the split
#   m_tf32            ... to TF32 (10 mantissa bits, nearest, ties away)
#   state_tf32        the state update's operand x dt exp(.) is rounded to TF32
#   drop_split_m      M x leaves out M's second bf16 term
#   drop_split_state  the state update leaves out its operand's second term
#   state_pass_off_by_one  the carried state h_prev[c] takes chunk c's own dBx
#   stale_stage       the scores read B from the other ring stage
set -u
REPO=$(cd "$(dirname "$0")/.." && pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
CU=src/repro_torch/kernels/csrc/ssd_scan.cu
TF32='__uint_as_float((__float_as_uint(VALUE) + 0x1000u) & 0xffffe000u)'
XW='w * __bfloat162float(xt[swizzled(k, pr)])'
# each mutant: the line's text as it stands | what replaces it (literal)
declare -A OLD=(
  [drop_inter]='const bool inter = c > 0;'
  [no_carry]='hv[i] = decay * hv[i] + dd[i];'
  [mask_off_by_one]='const bool live = col <= row && row < Q;'
  [state_row]='const float w = row < Q ? ws[min(row, Q - 1)] : 0.f;'
  [m_bf16]='sc[i] = m;'
  [m_tf32]='sc[i] = m;'
  [state_tf32]="v[kk][r][e] = $XW;"
  [drop_split_m]='for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, ml[kk], dx + ((s * BOX + kk * 16 * 128) >> 4));'
  [drop_split_state]='for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, al[kk], db + ((s * TILE + kk * 16 * 128) >> 4));'
  [state_pass_off_by_one]='store_split4(hs + 2 * cc * PN, hs + (2 * cc + 1) * PN, 4LL * i4, hp);'
  [stale_stage]='cb_scores<NCH>(sc, dc, db, s);'
)
declare -A NEW=(
  [drop_inter]='const bool inter = false;'
  [no_carry]='hv[i] = dd[i];'
  [mask_off_by_one]='const bool live = col < row && row < Q;'
  [state_row]='const float w = row < Q && k != TQ - 1 ? ws[min(row, Q - 1)] : 0.f;'
  [m_bf16]='sc[i] = __bfloat162float(__float2bfloat16(m));'
  [m_tf32]="sc[i] = ${TF32/VALUE/m};"
  [state_tf32]="v[kk][r][e] = ${TF32/VALUE/$XW};"
  [drop_split_m]=''
  [drop_split_state]=''
  [state_pass_off_by_one]='store_split4(hs + 2 * cc * PN, hs + (2 * cc + 1) * PN, 4LL * i4, hv);'
  [stale_stage]='cb_scores<NCH>(sc, dc, db, s ^ 1);'
)
status=0
for name in clean drop_inter no_carry mask_off_by_one state_row m_bf16 m_tf32 \
            state_tf32 drop_split_m drop_split_state state_pass_off_by_one \
            stale_stage; do
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
from repro_torch.kernels import build, ssd_scan as ssd
build.build_all(['ssd_scan'])
c.ssd_scan_phase(torch, ssd, 0)
" > "$WORK/$name.log" 2>&1)
  rc=$?
  if [ "$name" = clean ]; then
    if [ $rc -eq 0 ]; then
      echo "unchanged copy: passed"; grep -E 'kernel ssd_scan|^ssd_scan' "$WORK/$name.log"
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
