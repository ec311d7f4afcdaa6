#!/usr/bin/env bash
# Everything the driver exercises, in one script (CLAUDE.md roadmap).
# Usage: bash tools/run_all_checks.sh [--fast]
#   --fast skips the accelerator steps (entry compile check and bench,
#   which needs a GPU).
set -uo pipefail
cd "$(dirname "$0")/.."

FAST=0
[ "${1:-}" = "--fast" ] && FAST=1
fail=0

step() { echo; echo "=== $1 ==="; }

step "pytest (CPU, 8-device virtual mesh via tests/conftest.py)"
python -m pytest tests/ -q -m "not slow" || fail=1

step "long-horizon slow suite (5+ virtual-second arcs)"
python -m pytest tests/ -q -m slow || fail=1

step "CLI error path (must exit 3)"
python main.py --config /nonexistent.json >/dev/null 2>&1
[ $? -eq 3 ] && echo "exit-code-3 OK" || { echo "FAIL: wrong exit code"; fail=1; }

step "CLI 2D end-to-end (gif)"
out=$(mktemp -d)
python main.py --config configs/default.json --seconds 0.1 --output "$out" \
  >/dev/null && [ -f "$out/video.gif" ] && echo "2D gif OK" || { echo "FAIL"; fail=1; }
rm -rf "$out"

step "multichip dry run (8 virtual CPU devices)"
python -c "import __graft_entry__ as g; g.dryrun_multichip(8)" || fail=1

if [ "$FAST" -eq 0 ]; then
  step "flagship entry compile check"
  python - <<'EOF' || fail=1
import jax, numpy as np, __graft_entry__ as g
fn, args = g.entry()
out = jax.jit(fn)(*args)
pos = np.asarray(out[0].pos)
assert np.isfinite(pos).all()
print("entry OK:", int(np.asarray(out[1].solver_iterations)), "CG iters")
EOF

  step "bench (one JSON line on stdout)"
  python bench.py || fail=1
fi

echo
[ "$fail" -eq 0 ] && echo "ALL CHECKS PASSED" || { echo "SOME CHECKS FAILED"; exit 1; }
