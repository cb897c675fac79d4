"""The generators and the roots are a function of the seed."""

import pytest
import torch

from graphbench import generate
from graphbench.tests.helpers import one_thread  # noqa: F401

URAND = {"generator": "urand", "scale": 9, "edge_factor": 4, "parts": 4,
         "structure_seed": 1}
KRON = {"generator": "kron", "scale": 9, "edge_factor": 4, "a": 0.57,
        "b": 0.19, "c": 0.19, "permute": True, "parts": 4,
        "structure_seed": 2}
BIG_SEED = 2 ** 31 + 7


@pytest.mark.parametrize("cfg", [URAND, KRON], ids=["urand", "kron"])
def test_same_seed_same_edges(cfg):
    a = generate.make_edges(cfg, BIG_SEED, "cpu")
    b = generate.make_edges(cfg, BIG_SEED, "cpu")
    c = generate.make_edges(cfg, BIG_SEED + 1, "cpu")
    n, e = generate.sizes(cfg)
    assert a.shape == (e, 2) and a.dtype == torch.int64
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < n


@pytest.mark.parametrize("cfg", [URAND, KRON], ids=["urand", "kron"])
def test_every_seed_runs_the_same_parts_relabelled(cfg):
    n, _ = generate.sizes(cfg)
    block = n // cfg["parts"]
    a = generate.make_edges(cfg, 11, "cpu")
    b = generate.make_edges(cfg, 12, "cpu")
    assert not torch.equal(a, b)
    for col in (0, 1):
        da = torch.bincount(a[:, col], minlength=n).reshape(-1, block)
        db = torch.bincount(b[:, col], minlength=n).reshape(-1, block)
        # the same degrees in each part, under other ids
        assert torch.equal(da.sort(dim=1).values, db.sort(dim=1).values)
        assert not torch.equal(da, db)
    # the edges between each pair of parts are the same in number
    pair = torch.tensor([4, 1])
    pa = torch.bincount((a // block * pair).sum(1), minlength=16)
    pb = torch.bincount((b // block * pair).sum(1), minlength=16)
    assert torch.equal(pa, pb)
    # a structure seed of its own is another graph
    c = generate.make_edges({**cfg, "structure_seed": 99}, 11, "cpu")
    assert not torch.equal(
        torch.bincount(a[:, 0], minlength=n).sort().values,
        torch.bincount(c[:, 0], minlength=n).sort().values)


def test_relabel_keeps_each_block():
    perm = generate.relabel_within_parts(64, 4, 5, "cpu")
    assert sorted(perm.tolist()) == list(range(64))
    assert torch.equal(perm // 16, torch.arange(64) // 16)
    assert not torch.equal(perm, torch.arange(64))


def test_kron_is_skewed_and_urand_is_not():
    big = {"scale": 12, "edge_factor": 16}
    ku = generate.make_edges({**URAND, **big}, 3, "cpu")
    kk = generate.make_edges({**KRON, **big}, 3, "cpu")
    n = 1 << 12
    du = torch.bincount(ku[:, 0], minlength=n)
    dk = torch.bincount(kk[:, 0], minlength=n)
    assert int(du.max()) < 64
    assert int(dk.max()) > 500
    # Graph500's kron leaves many vertices with no out-edge
    assert int((dk == 0).sum()) > n // 4 > int((du == 0).sum())


def test_negative_and_huge_seeds_are_accepted():
    for seed in (-5, 2 ** 40 + 3):
        generate.make_edges(URAND, seed, "cpu")


def test_roots_have_out_edges_and_follow_the_seed():
    edges = generate.make_edges(KRON, BIG_SEED, "cpu")
    deg = torch.bincount(edges[:, 0], minlength=512)
    roots = generate.draw_roots(deg, 300, BIG_SEED)
    again = generate.draw_roots(deg, 300, BIG_SEED)
    other = generate.draw_roots(deg, 300, BIG_SEED + 1)
    assert torch.equal(roots, again) and not torch.equal(roots, other)
    assert bool((deg[roots] > 0).all())


@pytest.mark.parametrize("cfg", [URAND, KRON], ids=["urand", "kron"])
def test_symmetric_graph_is_undirected_without_loops_or_repeats(cfg):
    cfg = {**cfg, "symmetric": True}
    n, e = generate.sizes(cfg)
    edges = generate.make_edges(cfg, BIG_SEED, "cpu")
    assert torch.equal(edges, generate.make_edges(cfg, BIG_SEED, "cpu"))
    src, dst = edges[:, 0], edges[:, 1]
    assert bool((src != dst).all())
    key = src * n + dst
    assert key.unique().numel() == key.numel() <= 2 * e
    assert torch.equal(key.sort().values, (dst * n + src).sort().values)
    # every drawn edge that is no self-loop is there, both ways
    drawn = generate.make_edges({**cfg, "symmetric": False}, BIG_SEED, "cpu")
    drawn = drawn[drawn[:, 0] != drawn[:, 1]]
    both = set(key.tolist())
    assert all(s * n + d in both and d * n + s in both
               for s, d in drawn.tolist())


def test_generators_are_found_by_name():
    assert callable(generate.family("urand").make)
    assert callable(generate.family("kron").make)
    with pytest.raises(ModuleNotFoundError):
        generate.family("no-such-family")
