# sregex-tpu build/test driver (analog of the reference Makefile).

PY ?= python

.PHONY: all native test conformance bench smoke clean

all: native

# native engines (csrc/*.cpp) into build/native/, keyed by source,
# flags and host; also built lazily on first use
native:
	$(PY) -m sregex_tpu.native_build

test:
	$(PY) -m pytest tests/ -q

# full byte-exact differential run against the reference binary (needs
# /tmp/refbuild/sregex-cli; dev-only)
conformance:
	$(PY) tests/diff_suite.py

bench:
	$(PY) bench.py

# on-GPU smoke run: the main path at bench size, the kernels against
# the plain reference, and one pattern per device tier vs host oracles
# (needs a GPU; exits non-zero without one)
smoke:
	$(PY) chip_smoke.py

clean:
	rm -rf build
	find . -name __pycache__ -type d -exec rm -rf {} +

# AddressSanitizer build of the native engines + differential stress
# run (the analog of the reference's `make valtest` valgrind mode)
asan:
	mkdir -p build/asan
	g++ -O1 -g -fsanitize=address -shared -fPIC -o build/asan/libsrepike_asan.so csrc/sre_pike.cpp
	g++ -O1 -g -fsanitize=address -shared -fPIC -o build/asan/libsrehost_asan.so csrc/sre_host.cpp
	g++ -O1 -g -fsanitize=address -shared -fPIC -o build/asan/libsretdfa_asan.so csrc/sre_tdfa.cpp
	LD_PRELOAD=$$(gcc -print-file-name=libasan.so) \
	LSAN_OPTIONS=suppressions=lsan.suppress $(PY) tests/asan_stress.py

releng:
	$(PY) util/releng.py
