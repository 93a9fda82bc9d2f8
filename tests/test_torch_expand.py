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
from tpu_hnsw_torch.ops import topk as T

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


# ---------------------------------------------------------------------------
# the fused stage-1 top-r: keys, plain version, and the kernel on the card
# ---------------------------------------------------------------------------


def _np_keys(scores, pos):
    """numpy transcription of the ordered key: the f32 score's bits with
    the magnitude flipped when negative (-0.0 as +0.0), above the
    position."""
    sc = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    b = sc.view(np.int32)
    b = b ^ ((b >> 31) & np.int32(0x7FFFFFFF))
    return b.astype(np.int64) * (1 << 32) + pos


def test_score_keys_order_and_round_trip():
    """Keys order by (score, position) across signs, -0.0, tiny and
    infinite scores, and decode back to the scores (-0.0 as +0.0)."""
    sc = np.array([3.0, -0.0, -2.5, 0.0, np.inf, -1e-30, 1e-30, -2.5, 7.0,
                   np.inf, -1e30], np.float32)
    pos = np.arange(sc.size, dtype=np.int64)
    keys = T.score_keys(_t(sc), _t(pos))
    np.testing.assert_array_equal(keys.numpy(), _np_keys(sc, pos))
    want = np.lexsort((pos, sc + np.float32(0)))  # -0.0 sorts as +0.0
    np.testing.assert_array_equal(np.argsort(keys.numpy()), want)
    d, p = T.decode_score_keys(keys)
    np.testing.assert_array_equal(p.numpy(), pos)
    np.testing.assert_array_equal(d.numpy().view(np.int32),
                                  (sc + np.float32(0)).view(np.int32))


def _tie_case(seed=9, B=10, S=16, dp=32, Q=9, p=4):
    """Tie-heavy int8 data: small integers, rows drawn from 5 patterns, so
    many scores tie at any r; dead rows, a mask, a zero query (IP scores
    -0.0) and out-of-range block ids (-1 and B)."""
    rng = np.random.default_rng(seed)
    pats = rng.integers(-2, 3, size=(5, dp)).astype(np.int8)
    blocks8 = pats[rng.integers(0, 5, size=(B, S))]
    scale = np.full(B, 0.5, np.float32)
    block_ids = np.where(rng.random((B, S)) < 0.15, -1,
                         np.arange(B * S).reshape(B, S)).astype(np.int32)
    allowed = rng.random((B, S)) < 0.8
    qp = rng.integers(-2, 3, size=(Q, dp)).astype(np.float32)
    qp[0] = 0.0
    bids = rng.integers(0, B, size=(Q, p)).astype(np.int64)
    bids[1, 0], bids[2, 3] = -1, B
    bf = blocks8.astype(np.float32) * scale[:, None, None]
    blocks_sq = (bf * bf).sum(-1).astype(np.float32)
    return blocks8, scale, block_ids, allowed, qp, bids, blocks_sq


def _np_topr(case, metric, r, masked):
    """numpy transcription of expand_topr_reference: the int8 scores of
    block.py:189-209 in f32, +inf where dead, masked or out of range, then
    every key, sorted (the smallest min(r, p*S) are the top-r)."""
    blocks8, scale, block_ids, allowed, qp, bids, blocks_sq = case
    B, S, _ = blocks8.shape
    Q, p = bids.shape
    q8, q_scl = _numpy_q8(qp)
    bad = (bids < 0) | (bids >= B)
    b = np.where(bad, 0, bids)
    dots_i = np.einsum("qpsd,qd->qps", blocks8[b].astype(np.int32),
                       q8.astype(np.int32))
    dots = dots_i.astype(np.float32) * (q_scl[:, None, None]
                                        * scale[b][:, :, None])
    q_sq = (qp * qp).sum(1).astype(np.float32)
    if metric == "l2":
        sc = np.maximum(q_sq[:, None, None] + blocks_sq[b] - np.float32(2)
                        * dots, np.float32(0))
    else:
        sc = -dots
    dead = (block_ids[b] < 0) | bad[:, :, None]
    if masked:
        dead |= ~allowed[b]
    sc = np.where(dead, np.float32(np.inf), sc).astype(np.float32)
    keys = _np_keys(sc.reshape(Q, p * S), np.arange(p * S, dtype=np.int64))
    return np.sort(keys, axis=1), q_sq


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("r", [1, 7, 40, 64, 69])  # p*S = 64: r >= p*S too
@pytest.mark.parametrize("masked", [False, True])
def test_topr_reference_matches_numpy_keys(metric, r, masked):
    """expand_topr_reference's keys equal the numpy transcription exactly,
    on tie-heavy int8 data: ties at the r-th place go to the lower
    position; dead, masked and out-of-range rows are +inf keys."""
    case = _tie_case()
    every, q_sq = _np_topr(case, metric, r, masked)
    want = every[:, :r]
    blocks8, scale, block_ids, allowed, qp, bids, blocks_sq = case
    q8, q_scl = _quantize_rows(_t(qp))
    kw = dict(q8=q8, q_scale=q_scl, score_scale=_t(scale))
    if masked:
        kw["allowed"] = _t(allowed)
    d, pos = X.expand_topr_reference(
        _t(blocks8), _t(blocks_sq), _t(block_ids), _t(qp), _t(q_sq),
        _t(bids), Metric(metric), r, **kw)
    assert d.shape == pos.shape == want.shape
    np.testing.assert_array_equal(T.score_keys(d, pos).numpy(), want)
    # the case ties across the r-th place and holds +inf rows
    sc, _ = T.decode_score_keys(_t(every))
    if r < sc.shape[1]:
        assert (sc[:, r - 1] == sc[:, r]).any()
    assert torch.isinf(sc).any()


def test_cpu_topr_takes_the_plain_version_and_checks_r():
    """On CPU tensors expand_topr runs its plain version (no launch), and
    r outside [1, TOPR_MAX_R] raises as it does on the card."""
    blocks8, scale, block_ids, _, qp, bids, blocks_sq = _tie_case()
    q8, q_scl = _quantize_rows(_t(qp))
    args = (_t(blocks8), _t(blocks_sq), _t(block_ids), _t(qp),
            _t((qp * qp).sum(1)), _t(bids), Metric.L2)
    kw = dict(q8=q8, q_scale=q_scl, score_scale=_t(scale))
    before = (X.LAUNCHES, X.TOPR_LAUNCHES)
    got = X.expand_topr(*args, 10, **kw)
    want = X.expand_topr_reference(*args, 10, **kw)
    assert (X.LAUNCHES, X.TOPR_LAUNCHES) == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for r in (0, X.TOPR_MAX_R + 1):
        with pytest.raises(ValueError, match="expand_topr"):
            X.expand_topr(*args, r, **kw)


@pytest.mark.parametrize("S,misfits", [
    (32, {"blocks_sq", "block_ids", "allowed"}),  # 16-byte copies
    (12, {"allowed"}),                            # 4-byte copies
    (6, set()),                                   # filter read in place
])
def test_row_info_alignment_matches_the_copy_width(S, misfits):
    """The scorer copies a run's row ids, norms and filter bytes 16 bytes
    at a time when S % 16 == 0, else 4 (filter bytes only when S % 4 ==
    0): a view starting one element off raises where its copy would
    fault, and passes where it would not."""
    B = 3

    def at(dtype, off):
        buf = torch.zeros(B * S + 16, dtype=dtype)
        assert buf.data_ptr() % 16 == 0
        return buf[off:off + B * S].view(B, S)

    names = ("blocks_sq", "block_ids", "allowed")
    dtypes = (torch.float32, torch.int32, torch.bool)
    aligned = [at(dt, 0) for dt in dtypes]
    X._check_row_info_aligned("expand_topr", S, *aligned)
    for i, name in enumerate(names):
        ops = list(aligned)
        ops[i] = at(dtypes[i], 1)
        if name in misfits:
            with pytest.raises(ValueError, match=name):
                X._check_row_info_aligned("expand_topr", S, *ops)
        else:
            X._check_row_info_aligned("expand_topr", S, *ops)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _int8_args(dev, seed, B, S, dp, Q, p, bids=None):
    """(args, kw) of an int8 call on the card: quantised normal rows with
    10% dead, normal queries, uniform bids unless given."""
    rng = np.random.default_rng(seed)
    x = _t(rng.normal(size=(B, S, dp)).astype(np.float32)).to(dev)
    scale = torch.clamp_min(x.abs().amax(dim=(1, 2)), 1e-30) / 127
    blocks = torch.round(x / scale[:, None, None]).to(torch.int8)
    ids = np.arange(B * S).reshape(B, S)
    block_ids = _t(np.where(rng.random((B, S)) < 0.1, -1, ids).astype(
        np.int32)).to(dev)
    q = _t(rng.normal(size=(Q, dp)).astype(np.float32)).to(dev)
    if bids is None:
        bids = rng.integers(0, B, size=(Q, p))
    q8, q_scl = _quantize_rows(q)
    args = [blocks, (x * x).sum(-1), block_ids, q, (q * q).sum(1),
            _t(np.asarray(bids, np.int64)).to(dev), Metric.L2]
    return args, dict(q8=q8, q_scale=q_scl, score_scale=scale)


def _assert_int8_exact(args, kw, rs=(1, 40)):
    """Both entries against their plain versions on the card: all scores
    bit-equal, top-r keys equal for each r (the fused entry counts one
    launch of each counter)."""
    plain = X.expand_score_reference(*args, **kw)
    got = X.expand_score(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    for r in rs:
        before = (X.LAUNCHES, X.TOPR_LAUNCHES)
        d, pos = X.expand_topr(*args, r, **kw)
        torch.cuda.synchronize()
        assert (X.LAUNCHES, X.TOPR_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
        wd, wpos = X.topr_of_scores(plain, r)
        assert torch.equal(T.score_keys(d, pos), T.score_keys(wd, wpos)), r


@pytest.mark.cuda
def test_misaligned_row_info_raises_on_card():
    """A block_ids, blocks_sq or allowed view one element off its 16-byte
    copy width (S = 32) raises ValueError in both entries before any
    launch, and the card still serves the aligned call after."""
    dev = _card()
    args, kw = _int8_args(dev, 40, B=6, S=32, dp=64, Q=8, p=2)
    allowed = torch.ones((6, 32), dtype=torch.bool, device=dev)

    def shifted(t):
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=dev)
        view = buf[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    for i, name in ((1, "blocks_sq"), (2, "block_ids"), (None, "allowed")):
        bad = list(args)
        kw2 = dict(kw, allowed=allowed)
        if i is None:
            kw2["allowed"] = shifted(allowed)
        else:
            bad[i] = shifted(args[i])
        before = (X.LAUNCHES, X.TOPR_LAUNCHES)
        with pytest.raises(ValueError, match=name):
            X.expand_score(*bad, **kw2)
        with pytest.raises(ValueError, match=name):
            X.expand_topr(*bad, 10, **kw2)
        assert (X.LAUNCHES, X.TOPR_LAUNCHES) == before
    _assert_int8_exact(args, kw)


@pytest.mark.cuda
def test_expand_one_hot_fragments_on_card():
    """Hand-computed scores pin the m16n8k32 s8 fragment layout: row s of
    block b is 1 at column (b*S + s) % dp, query i is i + 1 at column
    3i % dp, unit scales, IP: the score is -(i + 1) where the columns
    meet and -0 elsewhere. dp = 64 (two k-steps and both 16-byte halves),
    20 queries probing the same blocks (three n-fragments over both
    ldmatrix groups), S = 48 (three m-fragments; a warp's second one half
    past the rows)."""
    dev = _card()
    B, S, dp, Q, p = 5, 48, 64, 20, 3
    col = (np.arange(B * S) % dp).reshape(B, S)
    blocks = np.zeros((B, S, dp), np.int8)
    np.put_along_axis(blocks, col[..., None], 1, axis=2)
    qcol = (3 * np.arange(Q)) % dp
    q = np.zeros((Q, dp), np.float32)
    q[np.arange(Q), qcol] = np.arange(Q) + 1
    bids = np.tile(np.array([4, 0, 2]), (Q, 1))
    want = np.where(col[bids] == qcol[:, None, None],
                    -(np.arange(Q) + 1.0)[:, None, None], -0.0).astype(
        np.float32)
    args = [_t(blocks).to(dev), torch.zeros((B, S), device=dev),
            torch.zeros((B, S), dtype=torch.int32, device=dev),
            _t(q).to(dev), torch.zeros(Q, device=dev),
            _t(bids.astype(np.int64)).to(dev), Metric.IP]
    kw = dict(q8=_t(q.astype(np.int8)).to(dev),
              q_scale=torch.ones(Q, device=dev),
              score_scale=torch.ones(B, device=dev))
    got = X.expand_score(*args, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    for r in (1, 5, 48, 100):
        d, pos = X.expand_topr(*args, r, **kw)
        wd, wpos = X.topr_of_scores(_t(want), r)
        assert torch.equal(T.score_keys(d.cpu(), pos.cpu()),
                           T.score_keys(wd, wpos))


@pytest.mark.cuda
@pytest.mark.parametrize("Q,p", [(200, 1), (300, 2)])
def test_expand_one_block_probed_by_every_query_on_card(Q, p):
    """Every query probes block 3, so its run spans many CTAs (and, with a
    second random probe, runs of other blocks sit between): exact against
    the plain version."""
    dev = _card()
    rng = np.random.default_rng(Q)
    bids = np.concatenate([np.full((Q, 1), 3),
                           rng.integers(0, 9, size=(Q, p - 1))], axis=1)
    args, kw = _int8_args(dev, 5, 9, 256, 128, Q, p, bids=bids)
    _assert_int8_exact(args, kw, rs=(1, 40, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [8, 12])  # 12 x 100 keys: the torch.topk merge
def test_expand_routed_bids_with_invalid_on_card(p):
    """Duplicate-free per-query bids (as routing gives) with -1 and B
    entries: out-of-range pairs score +inf on every row, the rest exact."""
    dev = _card()
    rng = np.random.default_rng(8)
    B, Q = 40, 150
    bids = np.stack([rng.permutation(B)[:p] for _ in range(Q)])
    bids[rng.random((Q, p)) < 0.1] = -1
    bids[5, 7] = B
    args, kw = _int8_args(dev, 6, B, 256, 128, Q, p, bids=bids)
    plain = X.expand_score_reference(*args, **kw)
    assert torch.isinf(plain[torch.from_numpy(bids < 0).to(dev)]).all()
    _assert_int8_exact(args, kw, rs=(1, 40, 100))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [44, 30])  # 4-byte mask copies; mask unstaged
def test_expand_odd_block_sizes_masked_on_card(S):
    """Blocks whose size is not a multiple of 16 (the rows' ids, norms and
    filter bytes staged 4 bytes at a time) or of 4 (the filter read from
    device memory), with a filter mask: both entries exact."""
    dev = _card()
    rng = np.random.default_rng(S)
    args, kw = _int8_args(dev, S, 30, S, 128, 100, 6)
    kw["allowed"] = _t(rng.random((30, S)) < 0.5).to(dev)
    _assert_int8_exact(args, kw, rs=(1, 20, S))


@pytest.mark.cuda
def test_expand_blocks_larger_than_a_pass_on_card():
    """Blocks of 300 rows (two passes of 256 rows a run) with a mask: all
    scores bit-equal, and stage 1 (all scores and a keyed top-r above the
    fused entry's 256 rows) keys equal to the plain version's."""
    from tpu_hnsw_torch.index.block import _stage1

    dev = _card()
    rng = np.random.default_rng(300)
    args, kw = _int8_args(dev, 7, 20, 300, 128, 90, 5)
    kw["allowed"] = _t(rng.random((20, 300)) < 0.5).to(dev)
    plain = X.expand_score_reference(*args, **kw)
    assert torch.equal(X.expand_score(*args, **kw), plain)
    d, pos = _stage1(*args, 40, **kw)
    wd, wpos = X.topr_of_scores(plain, 40)
    assert torch.equal(T.score_keys(d, pos), T.score_keys(wd, wpos))


@pytest.mark.cuda
@pytest.mark.parametrize("dp", [36, 128, 1536])  # 36: 4-byte copies
@pytest.mark.parametrize("Q", [76, 2048])
def test_expand_topr_int8_exact_on_card(dp, Q):
    """Stage 1 as block.py runs it, r in {1, 40, 128} (the fused entry)
    and 129 (all scores and a keyed top-r): keys exactly equal to the
    plain version's; the all-scores entry bit-equal too."""
    from tpu_hnsw_torch.index.block import _stage1

    dev = _card()
    args, kw = _int8_args(dev, dp + Q, 300, 256, dp, Q, 8)
    plain = X.expand_score_reference(*args, **kw)
    assert torch.equal(X.expand_score(*args, **kw), plain)
    for r in (1, 40, 128, 129):
        before = (X.LAUNCHES, X.TOPR_LAUNCHES)
        d, pos = _stage1(*args, r, **kw)
        torch.cuda.synchronize()
        fused = r <= X.TOPR_MAX_R
        assert (X.LAUNCHES, X.TOPR_LAUNCHES) == (before[0] + 1,
                                                  before[1] + fused)
        wd, wpos = X.topr_of_scores(plain, r)
        assert torch.equal(T.score_keys(d, pos), T.score_keys(wd, wpos)), r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dp,rtol", [("float32", 128, 1e-5),
                                           ("float32", 30, 1e-5),
                                           ("bfloat16", 128, 1e-3)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_expand_topr_float_on_card(dtype, dp, rtol, metric):
    """f32 and bf16: the returned scores equal the plain scores at the
    returned positions within rtol of the cancellation scale, the r-th
    scores agree within the same bound, and every position the plain
    version scores below its r-th score minus the bound is returned."""
    dev = _card()
    rng = np.random.default_rng(dp)
    B, S, Q, p, r = 60, 256, 76, 8, 40
    x = _t(rng.normal(size=(B, S, dp)).astype(np.float32)).to(dev)
    blocks = x.to(getattr(torch, dtype))
    block_ids = _t(rng.integers(-1, 100, size=(B, S)).astype(
        np.int32)).to(dev)
    q = _t(rng.normal(size=(Q, dp)).astype(np.float32)).to(dev)
    args = (blocks, (blocks.float() ** 2).sum(-1), block_ids, q,
            (q * q).sum(1), _t(rng.integers(0, B, size=(Q, p))).to(dev),
            Metric(metric))
    plain = X.expand_score_reference(*args).reshape(Q, -1)
    d, pos = X.expand_topr(*args, r)
    cscale = (args[1].max() + args[4].max()).item()
    at = plain.gather(1, pos)
    fin = torch.isfinite(at)
    assert torch.equal(fin, torch.isfinite(d))
    assert ((d - at).abs()[fin] <= rtol * (cscale + at.abs()[fin])).all()
    wd, _ = X.topr_of_scores(plain, r)
    tol = rtol * (cscale + wd[:, -1].abs())
    assert ((d[:, -1] - wd[:, -1]).abs() <= tol).all()
    must = plain < (wd[:, -1] - tol)[:, None]
    got = torch.zeros_like(must).scatter_(1, pos, True)
    assert (got | ~must).all()
