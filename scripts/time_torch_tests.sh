#!/usr/bin/env bash
# Time each of the port's test files alone, as the Tier-1 command runs them
# (6 xdist workers, --dist loadfile), each with an empty JAX compile cache.
#
#   scripts/time_torch_tests.sh [REPO_DIR] [OUT_TSV]
#
# Writes one line per file: file, pytest's own seconds, wall seconds, the
# pytest summary; then the sums.  Run it with nothing else on the machine.
set -u
repo=${1:-.}
out=${2:-/dev/stdout}
cd "$repo" || exit 1
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
printf 'file\tpytest_s\twall_s\tsummary\n' > "$out"
for f in tests/test_torch_*.py; do
    cache="$tmp/cache_$(basename "$f" .py)"
    mkdir -p "$cache"
    t0=$(date +%s.%N)
    summary=$(JAX_COMPILATION_CACHE_DIR="$cache" JAX_PLATFORMS=cpu \
        ALLOW_MULTIPLE_LIBTPU_LOAD=1 python -m pytest "$f" -q -m 'not slow' \
        -p no:cacheprovider -p xdist -n 6 --dist loadfile -p no:randomly 2>&1 \
        | grep -E '(passed|failed|skipped|error).* in [0-9.]+s' | tail -n 1)
    t1=$(date +%s.%N)
    py=$(echo "$summary" | sed -n 's/.* in \([0-9.]*\)s.*/\1/p')
    printf '%s\t%s\t%s\t%s\n' "$f" "${py:-0}" \
        "$(python3 -c "print(round($t1 - $t0, 1))")" "$summary" >> "$out"
    rm -rf "$cache"
done
python3 - "$out" <<'EOF' >> "$out"
import sys
rows = [l.split("\t") for l in open(sys.argv[1]).read().splitlines()[1:]]
print("SUM\t%.2f\t%.1f\t" % (sum(float(r[1]) for r in rows),
                             sum(float(r[2]) for r in rows)))
EOF
