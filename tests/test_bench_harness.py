"""bench.py error-handling tests: a failed backend or a crash in the
rmat20 scale section must still leave one parsable JSON record with
whatever WAS measured, and the run must then exit non-zero.

Runs bench.py as a subprocess (its own backend init path) on tiny
graphs via the GAB_BENCH_* test hooks, accepting the CPU with
GAB_BENCH_PLATFORM=cpu."""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")


def _run_bench(env_extra: dict, timeout=600):
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "GAB_BENCH_PLATFORM": "cpu",
        "GAB_BENCH_SCALE": "10",
        "GAB_BENCH_SCALE20": "11",
        **env_extra,
    })
    p = subprocess.run([sys.executable, BENCH], capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=REPO)
    # the LAST stdout line must always be the one JSON record
    lines = [ln for ln in p.stdout.strip().splitlines() if ln.strip()]
    assert lines, f"no stdout; stderr tail: {p.stderr[-800:]}"
    return json.loads(lines[-1]), p


def test_section_fault_preserves_earlier_numbers():
    """A forced crash in a scale section must not erase the rmat17
    record already computed, and the run exits non-zero."""
    rec, p = _run_bench({"GAB_BENCH_FAULT": "rmat20_gat_epoch"})
    assert p.returncode != 0
    assert rec["metric"] == "spmm_edges_per_s"
    assert rec["value"] is not None and rec["value"] > 0
    assert rec["vs_baseline"] is not None
    assert rec["extra"]["gcn_epoch_s"] > 0
    assert "rmat20_gat_epoch_s" not in rec["extra"]
    assert "injected fault" in rec["errors"]["rmat20_gat_epoch"]


def test_dead_backend_still_emits_record():
    """Backend init fails (once, no retries) -> value null, errors
    noted, still one parsable JSON record, and a non-zero exit."""
    rec, p = _run_bench({"JAX_PLATFORMS": "bogus-platform"}, timeout=300)
    assert p.returncode != 0
    assert rec["value"] is None and rec["vs_baseline"] is None
    assert "backend_init" in rec["errors"]


def test_record_streams_after_every_section():
    """The cumulative record prints after EVERY section, so a run cut
    at any point still leaves a parsed record with everything measured
    so far. The first section's line must already carry the headline,
    and every record names the device that ran."""
    rec, p = _run_bench({})
    assert p.returncode == 0, p.stderr[-800:]
    lines = [ln for ln in p.stdout.strip().splitlines() if ln.strip()]
    records = [json.loads(ln) for ln in lines]
    # 7 sections + the final emit
    assert len(records) >= 7, p.stdout
    assert records[0]["value"] is not None and records[0]["value"] > 0
    # cumulative: every later record keeps the headline
    assert all(r["value"] == records[0]["value"] for r in records)
    assert rec["extra"]["rmat20_gat_epoch_s"] > 0
    assert rec["extra"]["platform"] == "cpu"
    assert rec["extra"]["device_count"] >= 1


def test_budget_guard_skips_sections_and_exits_zero():
    """With an exhausted wall-clock budget every section is skipped,
    the run still exits 0 and prints a parsable (null-value) record
    listing what was skipped."""
    rec, p = _run_bench({"GAB_BENCH_BUDGET_S": "0"})
    assert p.returncode == 0
    assert rec["value"] is None
    assert "rmat17_spmm" in rec["extra"]["skipped_over_budget"]
    assert "rmat20_gat_epoch" in rec["extra"]["skipped_over_budget"]


def test_rmat20_gcn_fault_isolates_and_explains_gat():
    """A crash while building the rmat20 dataset must not cascade: the
    spmm section's numbers survive, and the gat section reports the
    explicit dataset-unavailable error instead of an opaque one."""
    rec, p = _run_bench({"GAB_BENCH_FAULT": "rmat20_gcn_epoch"})
    assert p.returncode != 0
    assert rec["value"] is not None
    assert rec["extra"]["rmat20_spmm_ms"] > 0
    assert "rmat20_gcn_epoch_s" not in rec["extra"]
    assert "injected fault" in rec["errors"]["rmat20_gcn_epoch"]
    assert "dataset unavailable" in rec["errors"]["rmat20_gat_epoch"]
