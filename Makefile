# Build/test targets (the analog of the reference's feature-matrix Makefile).

.PHONY: test test-matrix bench bench-torch interop clean examples

test:
	python -m pytest tests/ -q

# Re-runs the suite under {planar on/off} x {x64 on/off} + a precision-dial
# pass — the analog of the reference's scalar/SSE2/AVX2 feature matrix.
test-matrix:
	python tests/run_matrix.py

bench:
	python bench.py

# The PyTorch port's benchmark programs on an H100 (each kernel wrapper
# builds its kernel at its first call): the flagship, unfused then
# fused, and the five configs with the overlap-save A/B, this session's
# captures merged into $(OUT)/BENCH_ALL_h100.json.
OUT ?= .
bench-torch:
	mkdir -p $(OUT)
	python3 bench_torch.py
	BENCH_FUSED=1 python3 bench_torch.py
	BDSP_BENCH_AB=1 python3 -m basic_dsp_tpu_torch.bench.bench_all \
	    --merge $(OUT)/BENCH_ALL_h100.json

interop:
	cmake -S interop -B interop/build -G Ninja
	cmake --build interop/build

examples:
	python examples/modulation.py /tmp
	python examples/bench_tables.py 5 /tmp/bench_tables.csv

clean:
	rm -rf interop/build
