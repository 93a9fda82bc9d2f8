"""tpu_hnsw_torch.cli on the CPU (``--device cpu``): build, search and
eval for the block engine, the graph engine and 4 hash partitions; the
partitioned eval maps its ground truth through the partitions' global ids
(the counterpart of test_cli_eval_partitioned_gt_uses_global_ids); an
index the reference's CLI saved, searched by both CLIs, gives the same
ids; ``bench`` prints the root bench.py's keys; and the profiler ranges
(``utils/profiling.py``) land in a trace and nowhere else."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_hnsw_torch import bench as BN
from tpu_hnsw_torch import cli
from tpu_hnsw_torch.io import datasets as DS
from tpu_hnsw_torch.utils import evalharness as E
from tpu_hnsw_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
GRAPH_ARGS = ["--m", "8", "--efc", "32", "--wave-size", "128", "--seed", "3"]
BUILDS = {
    "block": ["--type", "block", "--block-size", "64"],
    "graph": GRAPH_ARGS,
    "hash4": ["--partitions", "4", *GRAPH_ARGS],
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    base, queries = DS.synthetic_clustered(1200, 12, n_queries=30, seed=7)
    paths = {"base": str(tmp / "base.fvecs"), "q": str(tmp / "q.fvecs"),
             "dir": tmp}
    DS.write_fvecs(paths["base"], base)
    DS.write_fvecs(paths["q"], queries)
    return base, queries, paths


SWEEP_EFS = (10, 40)
# runs ``python -m tpu_hnsw_torch.cli ARGS`` with one short QPS window a
# measurement (the CPU's QPS is no metric; the JSON line is what is held)
SHORT_RUNNER = (
    "import runpy, sys\n"
    "from tpu_hnsw_torch.utils import evalharness as E\n"
    "full = E.measure_qps\n"
    "E.measure_qps = lambda *a, **k: full(\n"
    "    *a, **{**k, 'repeats': 1, 'min_window_s': 0.0})\n"
    "sys.argv = ['tpu_hnsw_torch.cli', *sys.argv[1:]]\n"
    "runpy.run_module('tpu_hnsw_torch.cli', run_name='__main__',\n"
    "                 alter_sys=True)\n")


@pytest.fixture
def short_windows(monkeypatch):
    """eval's sweep at two ef points, one short QPS window each: its
    recall is what is held, and that does not depend on the window."""
    full, full_sweep = E.measure_qps, E.sweep
    monkeypatch.setattr(E, "measure_qps", lambda *a, **k: full(
        *a, **{**k, "repeats": 1, "min_window_s": 0.0}))
    monkeypatch.setattr(E, "sweep", lambda index, q, gt, k=10: full_sweep(
        index, q, gt, k=k, efs=SWEEP_EFS))


def _rows(text: str) -> list:
    return [ln.split() for ln in text.splitlines() if ":" in ln
            and not ln.startswith("{")]


def _parse(rows) -> tuple[np.ndarray, np.ndarray]:
    ids = np.array([[int(t.split(":")[0]) for t in r] for r in rows])
    dist = np.array([[float(t.split(":")[1]) for t in r] for r in rows])
    return ids, dist


@pytest.mark.parametrize("kind", list(BUILDS))
def test_build_search_eval(kind, files, capsys, short_windows):
    base, queries, paths = files
    out = str(paths["dir"] / kind)
    cli.main(["build", "--device", "cpu", "--input", paths["base"],
              "--out", out, *BUILDS[kind]])
    built = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert built["built"] == 1200 and built["out"] == out
    cli.main(["search", "--device", "cpu", "--index", out, "--queries",
              paths["q"], "--k", "10", "--ef", "64", "--print-rows", "4"])
    res = capsys.readouterr()
    ids, dist = _parse(_rows(res.out))
    assert ids.shape == (4, 10) and (ids >= 0).all()
    exact = np.sqrt(((queries[:4, None, :] - base[ids]) ** 2).sum(-1))
    np.testing.assert_allclose(dist, exact, atol=2e-4)
    assert json.loads(res.err.strip().splitlines()[-1])["queries"] == 30
    cli.main(["eval", "--device", "cpu", "--index", out, "--queries",
              paths["q"], "--k", "10"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert tuple(r["ef_search"] for r in rows) == SWEEP_EFS
    # ground truth made by eval itself (global ids for the partitions)
    assert max(r["recall"] for r in rows) >= 0.9


def test_eval_with_ground_truth_file(files, capsys, short_windows):
    base, queries, paths = files
    out = str(paths["dir"] / "block_gt")
    cli.main(["build", "--device", "cpu", "--input", paths["base"],
              "--out", out, *BUILDS["block"]])
    d = ((queries[:, None, :] - base[None]) ** 2).sum(-1)
    gt_path = str(paths["dir"] / "gt.ivecs")
    DS.write_ivecs(gt_path, np.argsort(d, axis=1)[:, :10].astype(np.int32))
    capsys.readouterr()
    cli.main(["eval", "--device", "cpu", "--index", out, "--queries",
              paths["q"], "--gt", gt_path, "--k", "10", "--limit", "20"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rows[-1]["recall"] >= 0.95


def test_unsupported_vector_file():
    with pytest.raises(SystemExit, match="unsupported vector file"):
        cli._load_vectors("x.csv")


def test_reference_saved_index_searched_by_both_clis(files, capsys):
    """An index the reference's CLI built and saved (block layout), read
    by the port's BlockHnswIndex.load: both CLIs print the same ids, and
    distances within 1e-4."""
    from tpu_hnsw import cli as ref_cli

    _, _, paths = files
    out = str(paths["dir"] / "ref_block")
    ref_cli.main(["build", "--input", paths["base"], "--out", out,
                  *BUILDS["block"]])
    capsys.readouterr()
    args = ["--index", out, "--queries", paths["q"], "--k", "10",
            "--print-rows", "30"]
    ref_cli.main(["search", *args])
    want = _parse(_rows(capsys.readouterr().out))
    cli.main(["search", "--device", "cpu", *args])
    got = _parse(_rows(capsys.readouterr().out))
    assert want[0].shape == (30, 10)
    np.testing.assert_array_equal(got[0], want[0])
    assert np.abs(got[1] - want[1]).max() <= 1e-4 + 1e-6


def test_bench_prints_the_reference_keys():
    """``bench --dataset sift10k --data-dir tests/fixtures --device cpu``
    as a subprocess (one QPS window a measurement): one JSON line with the
    root bench.py's keys."""
    with open(os.path.join(REPO, "bench.py")) as f:
        ref_src = f.read()
    # the port's key lists are the root bench.py's keys (bench.py:296-336)
    assert all(f'"{k}"' in ref_src
               for k in BN.RESULT_KEYS + BN.EXTRA_KEYS)
    env = dict(os.environ, TPU_HNSW_BENCH_Q="8", TPU_HNSW_BLOCK_SIZE="16",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", SHORT_RUNNER, "bench", "--dataset",
         "sift10k", "--data-dir", FIXTURES, "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert tuple(rec) == BN.RESULT_KEYS
    assert sorted(rec["extra"]) == sorted(BN.EXTRA_KEYS)
    assert rec["extra"]["dataset"] == "sift10k"
    assert rec["extra"]["n"] == 64 and rec["extra"]["recall_target_met"]
    assert "jax" not in proc.stderr


def test_trace_holds_the_ranges_and_annotate_is_off_outside(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from tpu_hnsw_torch import BlockHnswIndex, HnswConfig

    base, q = DS.synthetic_clustered(600, 8, n_queries=16, seed=1)
    idx = BlockHnswIndex(HnswConfig(dim=8), block_size=32,
                         device="cpu").build(base)
    with profiling.trace(str(tmp_path)):
        idx.search(q, k=5, probes=4)
        idx.search(q, k=5, probes=8)
    path = str(tmp_path / profiling.TRACE_FILE)
    with open(path) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"route", "expand"} <= names
    ranges = profiling.range_times(path, ("route", "expand"))
    assert ranges["route"]["count"] == ranges["expand"]["count"] == 2
    assert ranges["expand"]["host_ms"] > 0
    assert ranges["expand"]["device_ms"] == ranges["expand"]["span_ms"] == 0
    # outside trace(): a shared no-op context, nothing recorded
    assert profiling.annotate("route") is profiling.annotate("expand")
    with profile(activities=[ProfilerActivity.CPU]) as other:
        idx.search(q, k=5, probes=4)
    assert not {"route", "expand"} & {e.key for e in other.key_averages()}
