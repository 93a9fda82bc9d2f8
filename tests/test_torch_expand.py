"""The block-expansion scorer: tpu_hnsw_torch.ops.expand.

- the plain version (f32, bf16) against the reference Pallas kernel in
  interpret mode, as tests/test_pallas_kernels.py runs it;
- the int8 form against a numpy transcription of block.py:181-195;
- the CUDA kernel against the plain version (needs a card; skips here).

The JAX package is imported inside the tests that compare against it, so
the card's machine, which has no JAX, can collect this file and run the
card tests alone:
``python -m pytest --noconftest tests/test_torch_expand.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.index.block import _quantize_rows
from tpu_hnsw_torch.ops import expand as X

torch.set_num_threads(1)


def _case(seed=3, B=12, S=8, dp=128, Q=16, p=3):
    rng = np.random.default_rng(seed)
    blocks = rng.normal(size=(B, S, dp)).astype(np.float32)
    block_ids = rng.integers(-1, 50, size=(B, S)).astype(np.int32)
    q = rng.normal(size=(Q, dp)).astype(np.float32)
    bids = rng.integers(0, B, size=(Q, p)).astype(np.int32)
    return blocks, block_ids, q, bids


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_reference_matches_pallas_interpret(dtype, metric):
    """Tolerance rtol 2e-5, atol 1e-4, as test_pallas_kernels.py holds the
    Pallas kernel to the XLA math (f32 sums in different orders). bf16:
    the Pallas body multiplies in f32 with an unrounded query while the
    stage-1 form rounds the query to bf16, so the test feeds a query that
    is already bf16-representable; both then agree to f32 summation."""
    import jax.numpy as jnp

    from tpu_hnsw.config import Metric as JMetric
    from tpu_hnsw.ops.pallas_expand import expand_score as pallas_expand_score

    blocks, block_ids, q, bids = _case()
    jb = jnp.asarray(blocks).astype(dtype)
    q = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    blocks_f = np.asarray(jb.astype(jnp.float32))
    blocks_sq = (blocks_f * blocks_f).sum(-1).astype(np.float32)
    q_sq = (q * q).sum(1).astype(np.float32)
    want = np.asarray(pallas_expand_score(
        jb, jnp.asarray(blocks_sq), jnp.asarray(block_ids), jnp.asarray(q),
        jnp.asarray(q_sq), jnp.asarray(bids), metric=JMetric(metric), tq=4,
        interpret=True))
    tb = _t(blocks_f).to(getattr(torch, dtype))
    got = X.expand_score_reference(
        tb, _t(blocks_sq), _t(block_ids), _t(q), _t(q_sq), _t(bids),
        Metric(metric)).numpy()
    inf = ~np.isfinite(want)
    assert (inf == ~np.isfinite(got)).all()
    np.testing.assert_allclose(got[~inf], want[~inf], rtol=2e-5, atol=1e-4)


def _int8_case(seed=5, B=10, S=16, dp=32, Q=8, p=4):
    rng = np.random.default_rng(seed)
    blocks8 = rng.integers(-127, 128, size=(B, S, dp)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, size=B).astype(np.float32)
    block_ids = rng.integers(-1, 40, size=(B, S)).astype(np.int32)
    qp = rng.normal(size=(Q, dp)).astype(np.float32)
    bids = rng.integers(0, B, size=(Q, p)).astype(np.int32)
    blocks_sq = rng.uniform(1, 50, size=(B, S)).astype(np.float32)
    return blocks8, scale, block_ids, qp, bids, blocks_sq


def _numpy_q8(qp):
    """block.py:184-188 in numpy (np.round is half-to-even like jnp)."""
    q_amax = np.maximum(np.abs(qp).max(axis=1), np.float32(1e-30))
    q_scl = (q_amax / np.float32(127.0)).astype(np.float32)
    q8 = np.clip(np.round(qp / q_scl[:, None]), -127, 127).astype(np.int8)
    return q8, q_scl


def test_int8_quantisation_and_integer_dots_exact():
    """The query quantisation is bit-equal to the numpy form, and with unit
    scales the IP score is minus the integer dot, exactly (|dot| < 2^24)."""
    blocks8, _, block_ids, qp, bids, blocks_sq = _int8_case()
    q8_np, q_scl_np = _numpy_q8(qp)
    q8, q_scl = _quantize_rows(_t(qp))
    np.testing.assert_array_equal(q8.numpy(), q8_np)
    np.testing.assert_array_equal(q_scl.numpy(), q_scl_np)
    dots_i = np.einsum("qpsd,qd->qps", blocks8[bids].astype(np.int32),
                       q8_np.astype(np.int32))
    ones_q = torch.ones(qp.shape[0])
    ones_b = torch.ones(blocks8.shape[0])
    got = X.expand_score_reference(
        _t(blocks8), _t(blocks_sq), _t(block_ids), _t(qp),
        torch.zeros(qp.shape[0]), _t(bids), Metric.IP, q8=q8, q_scale=ones_q,
        score_scale=ones_b).numpy()
    live = block_ids[bids] >= 0
    np.testing.assert_array_equal(got[live], -dots_i[live].astype(np.float32))
    assert np.isinf(got[~live]).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_int8_scores_match_numpy_form(metric):
    """Scores equal block.py:189-204's f32 arithmetic to f32 rounding
    (rtol 1e-6: same integer dots, same operation order)."""
    blocks8, scale, block_ids, qp, bids, blocks_sq = _int8_case()
    q8_np, q_scl = _numpy_q8(qp)
    q_sq = (qp * qp).sum(1).astype(np.float32)
    dots_i = np.einsum("qpsd,qd->qps", blocks8[bids].astype(np.int32),
                       q8_np.astype(np.int32))
    dots = dots_i.astype(np.float32) * (q_scl[:, None, None]
                                        * scale[bids][:, :, None])
    if metric == "l2":
        want = np.maximum(q_sq[:, None, None] + blocks_sq[bids] - 2.0 * dots,
                          np.float32(0.0))
    else:
        want = -dots
    want = np.where(block_ids[bids] < 0, np.inf, want).astype(np.float32)
    got = X.expand_score(
        _t(blocks8), _t(blocks_sq), _t(block_ids), _t(qp), _t(q_sq),
        _t(bids), Metric(metric), q8=_t(q8_np), q_scale=_t(q_scl),
        score_scale=_t(scale)).numpy()
    inf = ~np.isfinite(want)
    assert (inf == ~np.isfinite(got)).all()
    np.testing.assert_allclose(got[~inf], want[~inf], rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version: no launch counted."""
    blocks, block_ids, q, bids = _case()
    before = X.LAUNCHES
    X.expand_score(_t(blocks), _t((blocks ** 2).sum(-1)), _t(block_ids),
                   _t(q), _t((q * q).sum(1)), _t(bids), Metric.L2)
    assert X.LAUNCHES == before


def test_allowed_mask_scores_disallowed_rows_inf():
    """The filter mask: a disallowed row scores +inf exactly as a dead row
    does; every other score is unchanged (bit-equal)."""
    blocks, block_ids, q, bids = _case()
    allowed = np.random.default_rng(4).random(block_ids.shape) < 0.5
    args = (_t(blocks), _t((blocks ** 2).sum(-1)), _t(block_ids), _t(q),
            _t((q * q).sum(1)), _t(bids), Metric.L2)
    plain = X.expand_score(*args).numpy()
    got = X.expand_score(*args, allowed=_t(allowed)).numpy()
    want = np.where(allowed[bids], plain, np.inf)
    np.testing.assert_array_equal(got, want)


def _rel_err(got, want, scale):
    """max |got - want| / (scale + |want|) over finite entries; scale is the
    cancellation scale max(q_sq + x_sq) of the L2 form."""
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    return ((got - want).abs()[fin] / (scale + want.abs()[fin])).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dp,rtol", [
    ("float32", 128, 1e-5), ("float32", 30, 1e-5),   # 16- and 4-byte loads
    ("bfloat16", 64, 1e-5), ("int8", 128, 1e-6), ("int8", 48, 1e-6),
    ("int8", 1536, 1e-6)])  # 96 16-byte chunks a row: 32 lanes
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_kernel_matches_reference_on_card(dtype, dp, rtol, metric):
    """The CUDA kernel against the plain version on the same card tensors.
    f32 and bf16 differ only in summation order (rtol 1e-5 of the
    cancellation scale); int8 dots are exact integers, so only the
    dequantising multiply can round (rtol 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    B, S, Q, p = 40, 64, 32, 5
    x = rng.normal(size=(B, S, dp)).astype(np.float32)
    block_ids = rng.integers(-1, 100, size=(B, S)).astype(np.int32)
    q = rng.normal(size=(Q, dp)).astype(np.float32)
    bids = rng.integers(0, B, size=(Q, p))
    blocks = _t(x).to(dev)
    kw = {}
    if dtype == "int8":
        scale = torch.clamp_min(blocks.abs().amax(dim=(1, 2)), 1e-30) / 127
        blocks = torch.round(blocks / scale[:, None, None]).to(torch.int8)
        q8, q_scl = _quantize_rows(_t(q).to(dev))
        kw = dict(q8=q8, q_scale=q_scl, score_scale=scale)
    else:
        blocks = blocks.to(getattr(torch, dtype))
    args = (blocks, (blocks.float() ** 2).sum(-1), _t(block_ids).to(dev),
            _t(q).to(dev), _t((q * q).sum(1)).to(dev), _t(bids).to(dev),
            Metric(metric))
    before = X.LAUNCHES
    got = X.expand_score(*args, **kw)
    torch.cuda.synchronize()
    assert X.LAUNCHES == before + 1
    want = X.expand_score_reference(*args, **kw)
    scale = (args[1].max() + args[4].max()).item()
    assert _rel_err(got, want, scale) <= rtol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dp", [("int8", 128), ("int8", 1536),
                                      ("bfloat16", 128)])
def test_kernel_allowed_mask_on_card(dtype, dp):
    """The kernel with a filter mask against the plain version with the same
    mask: the same +inf pattern (dead or disallowed rows), and the other
    scores within the tolerances above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(dp)
    B, S, Q, p = 30, 256, 16, 8
    x = _t(rng.normal(size=(B, S, dp)).astype(np.float32)).to(dev)
    block_ids = _t(rng.integers(-1, 100, size=(B, S)).astype(np.int32)).to(dev)
    allowed = _t(rng.random((B, S)) < 0.1).to(dev)
    q = _t(rng.normal(size=(Q, dp)).astype(np.float32)).to(dev)
    bids = _t(rng.integers(0, B, size=(Q, p))).to(dev)
    kw = {"allowed": allowed}
    if dtype == "int8":
        scale = torch.clamp_min(x.abs().amax(dim=(1, 2)), 1e-30) / 127
        blocks = torch.round(x / scale[:, None, None]).to(torch.int8)
        q8, q_scl = _quantize_rows(q)
        kw.update(q8=q8, q_scale=q_scl, score_scale=scale)
    else:
        blocks = x.to(torch.bfloat16)
    args = (blocks, (blocks.float() ** 2).sum(-1), block_ids, q,
            (q * q).sum(1), bids, Metric.L2)
    got = X.expand_score(*args, **kw)
    want = X.expand_score_reference(*args, **kw)
    torch.cuda.synchronize()
    dead = (block_ids < 0) | ~allowed
    assert torch.equal(torch.isinf(want), dead[bids])
    scale = (args[1].max() + args[4].max()).item()
    assert _rel_err(got, want, scale) <= (1e-6 if dtype == "int8" else 1e-5)
