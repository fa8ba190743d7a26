# Developer entry points for the static-analysis layer (docs/static_analysis.md)

PY ?= python

.PHONY: lint proto-drift verify-plans test shuffle-bench shuffle-bench-smoke \
	compile-bench compile-bench-smoke chaos-test chaos-smoke chaos-soak \
	chaos-microbench ici-test ici-smoke hbm-bench hbm-bench-smoke hbm-test \
	serving-bench serving-bench-smoke serving-test strings-bench \
	strings-bench-smoke strings-test elastic-test elastic-smoke elastic-bench \
	aqe-test aqe-bench aqe-bench-smoke exchange-cache-test pipeline-test \
	pipeline-bench pipeline-bench-smoke obs-test obs-bench obs-bench-smoke \
	concurrency-check concurrency-test megastage-test megastage-bench \
	megastage-bench-smoke

# Prong B gate: codebase linter against the checked-in baseline + proto drift,
# for the JAX package and for the PyTorch port (each with its own baseline)
lint:
	$(PY) -m ballista_tpu.analysis.lint ballista_tpu/
	$(PY) -m ballista_tpu.analysis.proto_drift
	$(PY) -m ballista_tpu_torch.analysis.lint ballista_tpu_torch/
	$(PY) -m ballista_tpu_torch.analysis.proto_drift

proto-drift:
	$(PY) -m ballista_tpu.analysis.proto_drift

# Prong A self-check: every verifier rule fires on its broken-plan fixture,
# EXPLAIN VERIFY works end-to-end, the linter is clean against the baseline
verify-plans:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_analysis.py -q -m 'not slow'

test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m 'not slow'

# Shuffle data-plane microbenchmark (docs/shuffle.md): prints Flight
# connections and MB/s, per-piece vs consolidated+pooled
shuffle-bench:
	JAX_PLATFORMS=cpu $(PY) benchmarks/shuffle_bench.py

shuffle-bench-smoke:
	JAX_PLATFORMS=cpu $(PY) benchmarks/shuffle_bench.py --smoke

# Two-tier shuffle (docs/shuffle.md): ICI exchange tests on the CPU-simulated
# 8-device mesh + the shuffle bench's ici mode (row-exact vs the Flight modes)
ici-test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m ici

# (the shuffle bench's ici mode rides `make shuffle-bench-smoke`, which CI
# runs as its own step — no second bench invocation here)
ici-smoke:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_ici_shuffle.py -q -m 'not chaos'

# Compile-pipeline benchmark (docs/compile_pipeline.md): background AOT
# precompile vs inline XLA compile on a multi-stage query
compile-bench:
	JAX_PLATFORMS=cpu $(PY) benchmarks/compile_bench.py

compile-bench-smoke:
	JAX_PLATFORMS=cpu $(PY) benchmarks/compile_bench.py --smoke

# HBM memory governor (docs/memory.md): trace-time estimator drift vs XLA's
# measured program peak on a q3-shaped join, governed-run byte-equality, and
# over-budget admission rejection with the PV007 hint
hbm-bench:
	JAX_PLATFORMS=cpu $(PY) benchmarks/hbm_bench.py

hbm-bench-smoke:
	JAX_PLATFORMS=cpu $(PY) benchmarks/hbm_bench.py --smoke

hbm-test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_memory_governor.py -q

# Serving layer (docs/serving.md): closed-loop multi-client QPS/p99 on the
# mixed q1/q6/point-lookup workload, caches ON vs OFF, plus cache hit rates
# and per-tenant fair-share error — the standing traffic benchmark
serving-bench:
	JAX_PLATFORMS=cpu $(PY) benchmarks/serving_bench.py

serving-bench-smoke:
	JAX_PLATFORMS=cpu $(PY) benchmarks/serving_bench.py --smoke

serving-test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m serving

# Cross-query exchange materialization cache (docs/serving.md): key/lifetime
# units, PV008, the orphan sweeper, and the e2e lifecycle edges (repeat jobs
# skipping producer stages byte-identically, loss-fallback recompute, HA
# restore, clean-job deferral); the repeated-subtree traffic gate rides
# `make serving-bench-smoke` (hit rate > 0.5, byte-identity, >= 1.3x QPS)
exchange-cache-test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m excache

# Device-resident strings (docs/strings.md): q13-shaped + string-key join/
# group timings, device-path integrity (no host-kernel fallback on string
# stages) and byte-exactness vs the numpy oracle; shared-dictionary encode
# counts expose the decline path
strings-bench:
	JAX_PLATFORMS=cpu $(PY) benchmarks/strings_bench.py

strings-bench-smoke:
	JAX_PLATFORMS=cpu $(PY) benchmarks/strings_bench.py --smoke

strings-test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m strings

# Elastic executors (docs/elasticity.md): scale signal/controller + drain
# state machine + speculation tests, and the tail-win/drain-cost benchmark
# (--smoke asserts >=1.3x speculation tail win + drain byte-identity)
elastic-test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m elastic

elastic-smoke:
	JAX_PLATFORMS=cpu $(PY) benchmarks/elastic_bench.py --smoke

elastic-bench:
	JAX_PLATFORMS=cpu $(PY) benchmarks/elastic_bench.py

# Adaptive query execution (docs/adaptive.md): coalesce/skew/reuse rule +
# serde/PV005 + e2e byte-identity tests, and the skew-join/tiny-partition
# benchmark (--smoke asserts the split fired, the reduce-task reduction and
# byte identity; >=1.3x skew wall win gated on multi-core hosts)
aqe-test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m aqe

aqe-bench-smoke:
	JAX_PLATFORMS=cpu $(PY) benchmarks/aqe_bench.py --smoke

aqe-bench:
	JAX_PLATFORMS=cpu $(PY) benchmarks/aqe_bench.py

# Pipelined shuffle (docs/shuffle.md): early-resolve/feed/freeze/fallback +
# e2e byte-identity tests, and the injected-slow-map benchmark (--smoke
# asserts byte identity + early resolve + measured overlap always; the
# >=1.2x wall win is gated on >=4-core hosts)
pipeline-test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m pipeline

pipeline-bench-smoke:
	JAX_PLATFORMS=cpu $(PY) benchmarks/pipeline_bench.py --smoke

pipeline-bench:
	JAX_PLATFORMS=cpu $(PY) benchmarks/pipeline_bench.py

# Megastage (docs/megastage.md): whole-query mesh compilation — promotion/
# serde/PV005 units, demotion re-split, knob-off + chaos byte-identity, and
# the staged-vs-megastage benchmark (--smoke asserts byte identity + the
# stage/dispatch-count reduction + donation always; the wall win is gated
# on >=4-core hosts)
megastage-test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m megastage

megastage-bench-smoke:
	JAX_PLATFORMS=cpu $(PY) benchmarks/megastage_bench.py --smoke

megastage-bench:
	JAX_PLATFORMS=cpu $(PY) benchmarks/megastage_bench.py

# Flight recorder observability (docs/metrics.md): histogram/timeseries/
# profiler/ledger unit tests + the e2e ledger-equals-task-metric-sums check,
# and the overhead benchmark (--smoke gates recorder-ON wall within 5% of
# OFF, profiler stacks naming pop_tasks, ledger field parity with bench.py)
obs-test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m obs

obs-bench-smoke:
	JAX_PLATFORMS=cpu $(PY) benchmarks/obs_bench.py --smoke

obs-bench:
	JAX_PLATFORMS=cpu $(PY) benchmarks/obs_bench.py

# Concurrency verifier (docs/static_analysis.md): the runtime lock-order +
# guarded-state suite (synthetic ABBA/guard fixtures, BL004/BL005, the
# 2-executor e2e under assert), and the full tier-1 sweep with assertions
# ON — any unbaselined lock-order edge, guarded map touched lock-free, or
# sleep under a traced lock fails the run at the offending site
concurrency-test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m concurrency

concurrency-check:
	BALLISTA_ANALYSIS_CONCURRENCY=assert JAX_PLATFORMS=cpu \
		$(PY) -m pytest tests/ -q -m 'not slow'

# Chaos layer (docs/fault_tolerance.md): fault-injection tests, the seeded
# soak (byte-identical results or clean named failures; per-seed logs in
# benchmarks/results/chaos_seed_*.json), and the zero-overhead microbench
chaos-test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m chaos

chaos-smoke:
	JAX_PLATFORMS=cpu $(PY) benchmarks/chaos_soak.py --smoke
	JAX_PLATFORMS=cpu $(PY) benchmarks/chaos_soak.py --microbench

chaos-soak:
	JAX_PLATFORMS=cpu $(PY) benchmarks/chaos_soak.py --seeds 20

chaos-microbench:
	JAX_PLATFORMS=cpu $(PY) benchmarks/chaos_soak.py --microbench
