"""The least-bytes functions against a hand count, and the peak table."""

from graphbench import costs


def test_bfs_least_bytes_by_hand():
    # 10 traversed edges at 4 B, 5 vertices at 8 B
    assert costs.bfs_least_bytes(10, 5) == 40 + 40


def test_pagerank_least_bytes_by_hand():
    # 3 rounds of (7 edges at 4 B + 2 vertices at 12 B)
    assert costs.pagerank_least_bytes(3, 2, 7) == 3 * (28 + 24)


def test_urand22_sizes():
    n, e = 1 << 22, 16 << 22
    assert costs.bfs_least_bytes(e, n) == 301_989_888
    assert costs.pagerank_least_bytes(1, n, e) == 318_767_104


def test_peak_of_the_h100_and_of_an_unknown_card():
    assert costs.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
    assert costs.peak("cpu", "hbm_bytes_per_s") is None
