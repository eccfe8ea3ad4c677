"""The yardstick's counts against hand-worked shapes, and its statistics."""

import pytest

from portbench import yardstick as Y


def test_spmm_counts():
    # 10 rows, 40 edges, width 8, bf16: x 10*8*2, out 10*8*2, indptr 11*4, 40*(4+4)
    assert Y.spmm_bytes(10, 10, 40, 8, "bf16") == 160 + 160 + 44 + 320
    assert Y.spmm_flops(40, 8) == 640
    assert Y.spmm_least_s(10, 40, 8, "bf16") == pytest.approx(684 / 3.35e12)


def test_attention_counts():
    n, m, d = 100, 4, 4
    b, f = Y.attention_reduce(n, m, d, "f32")
    assert b == 100 * 12 * 4 + (16 + 4 + 4) * 4 and f == 2 * 100 * 16 + 3 * 100 * 4
    b, f = Y.attention_apply(n, m, d, "bf16")
    assert b == 100 * 12 * 2 + (16 + 4 + 4) * 4 and f == 3200 + 800 + 1600
    b, f = Y.attention_bwd_reduce(n, m, d, "f32")
    assert b == 100 * 12 * 4 + (32 + 8 + 8) * 4 + 800 and f == 6400 + 2400 + 800
    b, f = Y.attention_bwd_apply(n, m, d, "f32")
    assert b == 100 * 16 * 4 + 800 + (32 + 8 + 8) * 4 + 100 * 12 * 4
    assert f == 9600 + 3200 + 1200


def test_least_time_takes_the_larger_bound():
    assert Y.least_time_s(3.35e12, 0, "bf16") == pytest.approx(1.0)
    assert Y.least_time_s(0, 989e12, "bf16") == pytest.approx(1.0)
    assert Y.least_time_s(0, 165e12, "f32") == pytest.approx(1.0)
    assert Y.least_time_s(3.35e12, 2 * 989e12, "bf16") == pytest.approx(2.0)


def test_arxiv_attention_bound_is_the_known_one():
    # the bf16 step's four attention kernels at arxiv's size: ~0.415 ms of bounds
    assert Y.attention_least_s(169343, 256, 256, "bf16", True) * 1e3 == pytest.approx(0.415,
                                                                                       abs=0.01)


def test_sgformer_flops_by_hand():
    model = dict(hidden_channels=4, out_channels=3, trans_num_layers=1, gnn_num_layers=2,
                 gnn_use_init=False)
    n, nnz, fin = 10, 30, 5
    want = (2 * n * fin * 4  # attention input layer
            + 3 * 2 * n * 4 * 4  # q, k, v
            + 2 * (2 * n * 4 * 4)  # k^T v, q @ kvs
            + 2 * n * fin * 4  # GNN input layer
            + 2 * (2 * nnz * 4 + 2 * n * 4 * 4)  # two aggregations and their layers
            + 2 * n * 4 * 3)  # head
    assert Y.sgformer_forward_flops(model, fin, n, nnz) == want
    assert Y.sgformer_train_flops(model, fin, n, nnz) == 3 * want
    init = dict(model, gnn_use_init=True)
    assert Y.sgformer_forward_flops(init, fin, n, nnz) == want + 2 * (2 * n * 4 * 4)


def test_percentile_is_of_all_samples():
    xs = list(range(1, 101))
    assert Y.percentile(xs, 50) == pytest.approx(50.5)
    assert Y.percentile(xs, 95) == pytest.approx(95.05)
    # not the mean of chunks' percentiles: one slow chunk moves the tail
    chunks = [[1.0] * 19 + [100.0]] + [[1.0] * 20] * 4
    flat = [x for c in chunks for x in c]
    assert Y.percentile(flat, 95) == pytest.approx(1.0)
    assert Y.percentile(flat, 99.5) > 1.0
    assert Y.percentile([3.0], 95) == 3.0

