#!/usr/bin/env bash
# Run chip_smoke.py of two checkouts in turns on one CUDA card (old, new,
# new, old), so that two versions of the kernels are timed on the same card
# in one run (phase 2, the script's one timed phase). Each turn's output goes
# to OUT/turn<i>-<old|new>.log (OUT is scratch/turns by default); phase 2's
# timing lines and the build lines of every turn are printed at the end.
# Exits non-zero if any turn failed.
#
# From the repository root, with the old tree the parent commit and the new
# one the working tree as git would commit it (scratch/ is listed in
# .gitignore):
#
#   mkdir -p scratch/old scratch/new
#   git archive HEAD | tar -x -C scratch/old
#   git add -A && git archive "$(git write-tree)" | tar -x -C scratch/new
#   bash tools/smoke_turns.sh scratch/old scratch/new scratch/turns
set -u

old=$1
new=$2
out=${3:-scratch/turns}
mkdir -p "$out"
status=0
i=0
for side in old new new old; do
  i=$((i + 1))
  log="$out/turn$i-$side.log"
  if ! (cd "${!side}" && python3 chip_smoke.py) >"$log" 2>&1; then
    echo "turn $i ($side, ${!side}) failed; see $log"
    status=1
  fi
done
for log in "$out"/turn*.log; do
  echo "== $log"
  grep -E "NVIDIA|ptxas: .*(registers|spill)|flagship|complex64: kernel|\"ok\"" "$log"
done
exit $status
