"""The graph engine's level-0 serving beam in one kernel launch.

``index/search.py::search`` runs the ef-bounded beam at level 0 through
:func:`path`:

- ``"kernel"``: a CUDA tensor that the kernel of ``csrc/beam_search.cu``
  takes (:func:`kernel_takes`: f32 storage, expand 1, ``ef <=
  BEAM_MAX_EF``, a metric it scores, degree <= ``MAX_DEGREE``, not a
  resumable scan): :func:`beam_level0` runs every query's whole search in
  one launch, a warp a query, each stopping at its own termination test;
- ``"loop"``: any other call on a CUDA tensor: the lockstep torch loop
  (``_search_layer_body``);
- ``"plain"``: a CPU tensor: the loop, which is the kernel's plain version.

The kernel returns the loop's pools and counters (only the sum order of the
scores differs); its ring differs only where the ring wrapped, since the
loop's idle steps write the sentinel there. The build's beams, the
resumable scans and the sharded graph searcher call the loop directly.

The kernel library is built by ``ops/_nvcc.py`` at first use and loaded
with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.ops import _nvcc

#: serving beams so far by path: ``"kernel"`` launches of
#: ``beam_level0_launch``, ``"loop"`` beams on a CUDA tensor that
#: :func:`kernel_takes` sent to the torch loop, ``"plain"`` beams on a CPU
#: tensor (the loop); a run resets it to show the path
BEAM_LAUNCHES = {"kernel": 0, "loop": 0, "plain": 0}

NAME = "beam_search"
#: the widest pool the kernel takes (csrc: kMaxEF)
BEAM_MAX_EF = 256
#: the widest level-0 adjacency row the kernel takes (csrc: kMaxDeg)
MAX_DEGREE = 64
#: the kernel's metric codes (csrc: kL2, kL1, kIP; cosine is IP on
#: normalised rows)
METRICS = {Metric.L2: 0, Metric.L1: 1, Metric.IP: 2, Metric.COSINE: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_I, _I] + [_P] * 11 + [_I] * 8 + [_P]


def kernel_takes(dtype: torch.dtype, *, expand: int, ef: int,
                 metric: Metric, degree: int,
                 resumable: bool = False) -> bool:
    """Whether the kernel serves a level-0 beam with this storage dtype,
    expansion width, pool width, metric and level-0 degree; a resumable
    scan needs the loop's state (the expanded flags) and takes the loop."""
    return (dtype == torch.float32 and expand == 1
            and 1 <= ef <= BEAM_MAX_EF and metric in METRICS
            and 1 <= degree <= MAX_DEGREE and not resumable)


def path(g, q: torch.Tensor, *, expand: int, ef: int, metric: Metric,
         resumable: bool = False) -> str:
    """``"plain"`` for a CPU tensor, else ``"kernel"`` where
    :func:`kernel_takes`, else ``"loop"``."""
    if q.device.type == "cpu":
        return "plain"
    if kernel_takes(g.vectors.dtype, expand=expand, ef=ef, metric=metric,
                    degree=g.neighbors0.shape[1], resumable=resumable):
        return "kernel"
    return "loop"


def _library():
    return _nvcc.load_library(NAME, {"beam_level0_launch": _ARGS})


def beam_level0(g, q: torch.Tensor, seeds: torch.Tensor, *, ef: int,
                max_steps: int, metric: Metric, ring: int, allowed=None):
    """The level-0 beam of ``_search_layer_body(level0=True, expand=1,
    skip_deleted=True, mask_deleted_results=True)`` in one launch. ``q``
    ``[Q, d]`` f32 on the graph's card, ``seeds`` ``[Q, S]`` ids (the
    sentinel allowed), ``ring`` history slots, ``allowed`` ``[cap+1]`` bool
    or None. Returns (pool scores ``[Q, ef]`` f32 ascending, pool ids
    ``[Q, ef]`` int32, the sentinel past the results; the history ``[Q,
    ring]`` int32, the sentinel where a query did not step; each query's
    steps (hops) and fresh neighbours scored (evals), ``[Q]`` int32)."""
    dev = q.device
    cap1, d = g.vectors.shape
    deg = g.neighbors0.shape[1]
    Q = q.shape[0]
    if not kernel_takes(g.vectors.dtype, expand=1, ef=ef, metric=metric,
                        degree=deg):
        raise ValueError(
            f"beam_level0: the kernel takes f32 storage, ef in [1, "
            f"{BEAM_MAX_EF}], degree in [1, {MAX_DEGREE}] and the metrics "
            f"{[m.value for m in METRICS]}; got {g.vectors.dtype}, ef {ef}, "
            f"degree {deg}, {metric.value}")
    if cap1 >= 1 << 31 or ring < 1 or max_steps < 0:
        raise ValueError(f"beam_level0: needs fewer than 2^31 rows, ring "
                         f">= 1, max_steps >= 0 (got {cap1}, {ring}, "
                         f"{max_steps})")
    q = q.contiguous()
    seeds = seeds.to(torch.int32).contiguous()
    S = seeds.shape[1]
    _nvcc.check("q", q, torch.float32, (Q, d), dev)
    _nvcc.check("seeds", seeds, torch.int32, (Q, S), dev)
    _nvcc.check("vectors", g.vectors, torch.float32, (cap1, d), dev)
    _nvcc.check("neighbors0", g.neighbors0, torch.int32, (cap1, deg), dev)
    _nvcc.check("deleted", g.deleted, torch.bool, (cap1,), dev)
    if allowed is not None:
        allowed = allowed.contiguous()
        _nvcc.check("allowed", allowed, torch.bool, (cap1,), dev)
    out_d = torch.empty((Q, ef), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, ef), dtype=torch.int32, device=dev)
    hist = torch.empty((Q, ring), dtype=torch.int32, device=dev)
    hops = torch.empty(Q, dtype=torch.int32, device=dev)
    evals = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q == 0:
        return out_d, out_i, hist, hops, evals
    vec4 = int(d % 4 == 0 and q.data_ptr() % 16 == 0
               and g.vectors.data_ptr() % 16 == 0)
    _nvcc.launch(
        _library(), "beam_level0_launch", dev, METRICS[metric], vec4,
        q.data_ptr(), seeds.data_ptr(), g.vectors.data_ptr(),
        g.neighbors0.data_ptr(), g.deleted.data_ptr(),
        None if allowed is None else allowed.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), hist.data_ptr(), hops.data_ptr(), evals.data_ptr(),
        Q, S, d, deg, ef, ring, max_steps, cap1 - 1)
    BEAM_LAUNCHES["kernel"] += 1
    return out_d, out_i, hist, hops, evals
