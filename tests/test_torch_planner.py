"""tpu_hnsw_torch.planner against tpu_hnsw.planner: with the reference's
HardwareModel values the estimators, choose_engine and
cluster_structure_score return the reference's numbers exactly; the
port's own defaults, measured on an NVIDIA H100 80GB HBM3 at 700 W, are
held as orderings and ratio bands; calibrate runs on the CPU."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from tpu_hnsw import planner as RP
from tpu_hnsw.io.datasets import synthetic_clustered, synthetic_uniform
from tpu_hnsw_torch import planner as P

torch.set_num_threads(1)

REF_HW = P.HardwareModel(**dataclasses.asdict(RP.HardwareModel()))
XC, _ = synthetic_clustered(4096, 64, n_queries=1, seed=0)
XU, _ = synthetic_uniform(4096, 64, n_queries=1, seed=0)
SHAPES = [(1_000, 128), (100_000, 128), (1_000_000, 128),
          (10_000_000, 96), (1_183_514, 100)]

# The chip_smoke.py run on an NVIDIA H100 80GB HBM3 at 700.00 W that the
# defaults were anchored on (PERF.md §6, the planner's findings): its
# bench's QPS at 1M x 128 and its calibrate() rates
MEASURED_QPS = {"flat": 13_202.6, "block": 2_958_911.0, "graph": 260_524.4}
CALIBRATED = P.HardwareModel(
    gather_rows_per_s=1233622887.2200305, f32_macs_per_s=13637808960795.21,
    expand_bytes_per_s=5173559855524.882, dispatch_s=1.3918299999697108e-05,
    step_overhead_s=0.0010049861249991445)


@pytest.mark.parametrize("n,dim", SHAPES)
def test_estimators_equal_the_reference(n, dim):
    ref_hw = RP.HardwareModel()
    for batch in (64, 4096):
        assert P.estimate_flat_qps(n, dim, batch=batch, hw=REF_HW) == \
            RP.estimate_flat_qps(n, dim, batch=batch, hw=ref_hw)
        assert P.estimate_flat_int8_qps(n, dim, batch=batch, hw=REF_HW) == \
            RP.estimate_flat_int8_qps(n, dim, batch=batch, hw=ref_hw)
        for probes in (1, 8, 64):
            assert P.estimate_block_qps(
                n, dim, probes=probes, batch=batch, hw=REF_HW) == \
                RP.estimate_block_qps(n, dim, probes=probes, batch=batch,
                                      hw=ref_hw)
        assert P.estimate_graph_qps(n, dim, batch=batch, steps=5,
                                    hw=REF_HW) == \
            RP.estimate_graph_qps(n, dim, batch=batch, steps=5, hw=ref_hw)


def test_structure_score_equals_the_reference():
    big = np.concatenate([XC, XC + 0.5, XC * 2.0])  # past the sample cap
    for x, kw in ((XC, {}), (XU, {}), (XC, {"k": 8, "iters": 3}),
                  (big, {"seed": 3})):
        assert P.cluster_structure_score(x, **kw) == \
            RP.cluster_structure_score(x, **kw)
    with pytest.raises(ValueError, match="at least 4\\*k rows"):
        P.cluster_structure_score(np.zeros((8, 4), np.float32))


@pytest.mark.parametrize("case", [
    dict(n=1_000_000, dim=128),
    dict(n=1_000_000, dim=128, sample="clustered"),
    dict(n=1_000_000, dim=128, sample="uniform"),
    dict(n=1_000_000, dim=128, sample="tiny"),
    dict(n=1_000_000, dim=128, recall_target=1.0),
    dict(n=1_000, dim=128),
    dict(n=10_000_000, dim=96, sample="clustered", batch=1024),
])
def test_choose_engine_equals_the_reference(case):
    case = dict(case)
    sample = {"clustered": XC, "uniform": XU, "tiny": XC[:7],
              None: None}[case.pop("sample", None)]
    got = P.choose_engine(sample=sample, hw=REF_HW, **case)
    want = RP.choose_engine(sample=sample, hw=RP.HardwareModel(), **case)
    assert (got.engine, got.est_qps, got.exact, got.params, got.reason) == \
        (want.engine, want.est_qps, want.exact, want.params, want.reason)


def test_h100_defaults_keep_the_measured_order_and_ratios():
    """Anchored on the H100 run named above: block and graph reproduce
    their measured QPS (the two solved constants), the flat estimate is
    4.0x its measured QPS (one f32 rate prices both the exact flat scan
    and the routing GEMMs; see HardwareModel), and the order is the
    measured one: block > graph > flat."""
    est = {"flat": P.estimate_flat_qps(1_000_000, 128),
           "block": P.estimate_block_qps(1_000_000, 128),
           "graph": P.estimate_graph_qps(1_000_000, 128)}
    assert est["block"] > est["graph"] > est["flat"]
    assert sorted(est, key=est.get) == sorted(MEASURED_QPS,
                                              key=MEASURED_QPS.get)
    for eng in ("block", "graph"):
        assert 0.98 < est[eng] / MEASURED_QPS[eng] < 1.02
    # the defaults are that run's calibrate() rates with expand and step
    # solved by anchor() for its bench (rounded to 5 figures)
    solved = P.anchor(CALIBRATED, 1_000_000, 128,
                      block_qps=MEASURED_QPS["block"],
                      graph_qps=MEASURED_QPS["graph"])
    for name, v in dataclasses.asdict(P.HardwareModel()).items():
        assert math.isclose(v, getattr(solved, name), rel_tol=1e-4), name
    assert 3.0 < est["flat"] / MEASURED_QPS["flat"] < 5.0
    meas_ratio = MEASURED_QPS["block"] / MEASURED_QPS["graph"]
    assert 0.8 < (est["block"] / est["graph"]) / meas_ratio < 1.25
    # the reference's sanity rules hold with the port's defaults
    q1 = P.estimate_flat_qps(100_000, 128)
    assert 5 < q1 / est["flat"] <= 10.5
    assert P.estimate_flat_qps(1_000, 128) > \
        2 * P.estimate_block_qps(1_000, 128)
    assert P.choose_engine(1_000, 128).engine == "flat"
    # on clustered data the plan is the engine that was fastest
    plan = P.choose_engine(1_000_000, 128, sample=XC)
    assert plan.engine == max(MEASURED_QPS, key=MEASURED_QPS.get) == "block"
    plan = P.choose_engine(1_000_000, 128, sample=XU)
    assert plan.engine == "flat" and "refused" in plan.reason
    assert P.INT8_SCAN_SPEEDUP == 1.0
    assert P.estimate_flat_int8_qps(1_000_000, 128) == est["flat"]


def test_calibrate_on_the_cpu():
    hw = P.calibrate(n=4096, dim=16, batch=64, device="cpu")
    assert isinstance(hw, P.HardwareModel)
    for name, v in dataclasses.asdict(hw).items():
        assert math.isfinite(v) and v > 0, name


def test_package_exports_the_planner():
    import tpu_hnsw_torch

    assert tpu_hnsw_torch.choose_engine is P.choose_engine
    assert tpu_hnsw_torch.EnginePlan is P.EnginePlan
    assert tpu_hnsw_torch.HardwareModel is P.HardwareModel


@pytest.mark.parametrize("n,dim", [(1_000_000, 128), (10_000_000, 96)])
def test_anchor_reproduces_the_qps_it_is_given(n, dim):
    """anchor solves expand_bytes_per_s and step_overhead_s so that the
    block and graph estimators return the given QPS; the other three
    constants stay as given, and a QPS the fixed terms already exceed is
    refused."""
    raw = REF_HW
    block = 0.5 * P.estimate_block_qps(n, dim, hw=raw)
    graph = 0.5 * P.estimate_graph_qps(n, dim, hw=raw)
    hw = P.anchor(raw, n, dim, block_qps=block, graph_qps=graph)
    assert math.isclose(P.estimate_block_qps(n, dim, hw=hw), block,
                        rel_tol=1e-9)
    assert math.isclose(P.estimate_graph_qps(n, dim, hw=hw), graph,
                        rel_tol=1e-9)
    for name in ("gather_rows_per_s", "f32_macs_per_s", "dispatch_s"):
        assert getattr(hw, name) == getattr(raw, name)
    with pytest.raises(ValueError, match="block_qps"):
        P.anchor(raw, n, dim, block_qps=1e15, graph_qps=graph)
    with pytest.raises(ValueError, match="graph_qps"):
        P.anchor(raw, n, dim, block_qps=block, graph_qps=1e15)


def test_stage1_case_is_the_call_calibrate_times():
    """stage1_case gives expand_topr's arguments at calibrate's shapes (n
    // 256 int8 blocks of 256 rows, 8 probes a query, r 40), the same
    tensors for the same seed, and the fused entry takes them."""
    from tpu_hnsw_torch.ops import expand as X

    args, kw, r = P.stage1_case(4096, 16, batch=64, device="cpu")
    blocks, blocks_sq, block_ids, q, q_sq, bids, _ = args
    assert blocks.dtype == torch.int8 and blocks.shape == (16, 256, 16)
    assert bids.shape == (64, 8) and q.shape == (64, 16) and r == 40
    assert int(bids.min()) >= 0 and int(bids.max()) < 16
    again, _, _ = P.stage1_case(4096, 16, batch=64, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(args[:6], again[:6]))
    d, pos = X.expand_topr(*args, r, **kw)
    assert d.shape == pos.shape == (64, r) and torch.isfinite(d).all()
