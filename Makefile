# Quality gate: run before every commit you intend to keep.
# Mirrors the reference's CI (tests + lint + native build,
# reference .github/workflows/test.yml:8-51).

PY ?= python

.PHONY: check test slow lint native bench clean

check: native lint test

test:
	$(PY) -m pytest tests/ -q -x

slow:
	$(PY) -m pytest tests/ -q -m slow

lint:
	$(PY) -m compileall -q heif_tpu bench.py chip_smoke.py __graft_entry__.py
	$(PY) tools/lint.py

native:
	$(MAKE) -C heif_tpu/native

bench:
	$(PY) bench.py

clean:
	$(MAKE) -C heif_tpu/native clean
	find . -name __pycache__ -type d -exec rm -rf {} +
