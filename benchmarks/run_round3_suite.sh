#!/bin/bash
# Sequential benchmark suite: one process at a time holds the device.
cd "$(dirname "$0")/.."
set -x
timeout 900 python -u benchmarks/bench_hard.py
timeout 900 python -u benchmarks/bench_hard_pe.py
timeout 1200 python -u benchmarks/bench_fused.py 4
timeout 1200 python -u benchmarks/bench_config2_se.py 100000
timeout 1500 python -u benchmarks/bench_config3_pe.py 20000
timeout 1800 python -u benchmarks/bench_config4_metagenomic.py 100000 4 1.0
timeout 1800 python -u benchmarks/bench_config5_longreads.py 500 10 10
timeout 900 python -u bench.py
echo "SUITE DONE"
