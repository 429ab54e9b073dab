#!/usr/bin/env bash
# Full verification recipe (see .claude/skills/verify/SKILL.md):
#   scripts/verify.sh          — CPU-side checks (suite, native build+tests, driver contract)
#   scripts/verify.sh --gpu    — additionally the GPU smoke test and bench (GPU host)
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== native build (lib + standalone binary + TSan race gate) =="
make -C native
make -C native cli
make -C native tsan

echo "== test suite (CPU backend, 8-device virtual mesh) =="
python -m pytest tests/ -q

echo "== driver contract: entry + dryrun_multichip on the virtual mesh =="
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu python - <<'PY'
import jax
jax.config.update("jax_platforms", "cpu")
import __graft_entry__ as g
fn, args = g.entry()
out = jax.jit(fn)(*args)
jax.block_until_ready(out)
print("entry ok:", [o.shape for o in out])
g.dryrun_multichip(8)
print("dryrun_multichip(8) ok")
PY

if [[ "${1:-}" == "--gpu" ]]; then
  echo "== GPU: smoke test (oracle-gated main paths), then the bench =="
  python chip_smoke.py
  python bench.py
fi

echo "ALL CHECKS PASSED"
