# Build/test entry points (the reference's Makefile builds bin/smith_waterman
# and libalign.a; here the native pieces are the C++ fast-IO and traceback
# libraries plus the CUDA kernel, and the "binary" is the Python CLI). The
# package builds each of them at first use; these targets build ahead.

all: native

native:
	$(MAKE) -C native

# the CUDA kernel (needs nvcc; the package keys the output by a hash of the
# source, see seqalign/ops/swa_cuda.py)
cuda:
	python -c "from seqalign.ops import swa_cuda; swa_cuda.ensure_registered()"

test:
	python -m pytest tests/ -q

# per-commit tier (<60 s); `make test` runs the full differential matrix
test-fast:
	python -m pytest tests/ -q -m "not slow"

# on a GPU machine: the card-only tests and the end-to-end smoke run
test-gpu:
	JAX_PLATFORMS=cuda python -m pytest tests/ -q -m gpu

smoke:
	python chip_smoke.py

bench:
	python bench.py

clean:
	$(MAKE) -C native clean

.PHONY: all native cuda test test-fast test-gpu smoke bench clean
