#!/usr/bin/env bash
# Sanitizer pass over the native host library (reference Makefile:229-236
# ships ASAN/UBSAN build targets; its scripts then run the binary under
# them). Here: build the sanitized .so variants and drive them through the
# native test corpus (tests/test_native.py exercises the reader and the
# converter against their Python twins).
#
# Usage: scripts/native_sanitize.sh [asan|ubsan|all]
set -euo pipefail
cd "$(dirname "$0")/.."
what="${1:-all}"

run_ubsan() {
  make -C native ubsan
  echo "== UBSAN pass =="
  USPMV_NATIVE_LIB=libuspmv_host_ubsan.so \
  UBSAN_OPTIONS=halt_on_error=1:print_stacktrace=1 \
    python -m pytest tests/test_native.py -q
}

run_asan() {
  make -C native asan
  libasan="$(${CXX:-g++} -print-file-name=libasan.so)"
  if [ ! -e "$libasan" ]; then
    echo "libasan.so not found; skipping ASAN run" >&2
    return 0
  fi
  echo "== ASAN pass =="
  # leak detection off: the long-lived python interpreter holds plenty of
  # intentional allocations; we are after heap-buffer overflows/UAF in the
  # native reader/converter
  USPMV_NATIVE_LIB=libuspmv_host_asan.so \
  LD_PRELOAD="$libasan" ASAN_OPTIONS=detect_leaks=0:halt_on_error=1 \
    python -m pytest tests/test_native.py -q
}

case "$what" in
  asan) run_asan ;;
  ubsan) run_ubsan ;;
  all) run_ubsan; run_asan ;;
  *) echo "usage: $0 [asan|ubsan|all]" >&2; exit 2 ;;
esac
