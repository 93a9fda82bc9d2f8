"""SparseHnswIndex with the graph engine against the JAX package's: the
recall, exact-distance and cross-package save/load checks of
tests/test_torch_sparse_ann.py (same rows, sizes and wave_size 64 in both
packages), for the graph engine in L2 and cosine (IP is in that file)."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sparse_ann import (  # noqa: E402,F401
    check_recall_and_distances, check_save_load, waves_of_64)

torch.set_num_threads(1)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_graph_recall_and_exact_distances_match_reference(metric):
    check_recall_and_distances("graph", metric)


def test_graph_save_load_across_packages(tmp_path):
    check_save_load("graph", "cosine", tmp_path)
