"""The incremental programs of the port against the JAX package's:
pagerank/warm, cc/incremental and kcore/incremental at parts {1, 2, 4}
x {urand, smallworld, rmat}, N=384, seed 5, each from its cold seed and
from a warm seed (the reference's pagerank/fast ranks, cc labels and
kcore cores, fed to both packages as the same numpy arrays):

  * ``incremental.cold_seed`` gives arrays byte-identical to the
    reference's;
  * every port run passes the NumPy oracle (tests/oracle.py);
  * rounds EQUAL the reference's; labels, cores and kmax are
    bit-identical; ranks are within the oracle's 1e-4 of the
    reference's.  pagerank/warm on rmat is the one exception for rounds:
    it halts on a residual at float32's noise floor, and the reference's
    row sums over ELL rows wider than 32 slots are not added left to
    right (tests/test_torch_async.py pins where the sums differ).

The reference runs in one multi-device subprocess per family."""

import json
import os

import numpy as np
import pytest
import torch

import oracle
from conftest import run_with_devices
from repro_torch.core import GraphEngine, incremental, partition_graph, \
    registry

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
PARTS = (1, 2, 4)
N, SEED, ROOT = 384, 5, 2
# incremental pair -> the program whose output is its warm seed
WARM_FROM = {("pagerank", "warm"): ("pagerank", "fast"),
             ("cc", "incremental"): ("cc", "default"),
             ("kcore", "incremental"): ("kcore", "default")}
INCREMENTAL = tuple(WARM_FROM)

_REFERENCE = """
import json, sys
sys.path.insert(0, {tests_dir!r})
import numpy as np
import oracle
from repro.core import GraphEngine, incremental, partition_graph, registry
from repro.launch.mesh import make_graph_mesh

edges, n = oracle.family_edges({family!r}, {n}, {seed})
meta, arrays = {{}}, {{}}
for parts in {parts!r}:
    g = partition_graph(edges, n, parts)
    eng = GraphEngine(g, make_graph_mesh(parts))
    garr = eng.device_graph()
    for (algo, variant), (w_algo, w_variant) in {warm_from!r}:
        spec = registry.get_spec(algo, variant)
        src = eng.program(w_algo, w_variant, **oracle.CONFORMANCE_PARAMS.get(
            (w_algo, w_variant), {{}}))
        warm = eng.gather_vertex_field(src(garr)[0])
        (cold,) = incremental.cold_seed(spec, g)
        dtype = incremental.KIND_DTYPES[spec.input_kinds[0]]
        params = oracle.CONFORMANCE_PARAMS.get((algo, variant), {{}})
        prog = eng.program(algo, variant, **params)
        for kind, seed_arr in (("cold", cold), ("warm", warm)):
            cell = f"{{algo}}_{{variant}}/{{kind}}/{{parts}}"
            arrays[cell + "/seed"] = np.asarray(seed_arr).astype(dtype)
            *outs, rounds = prog(garr, eng.scatter_vertex_field(seed_arr,
                                                                dtype))
            meta[cell] = {{"rounds": int(rounds)}}
            p = prog.program
            for name, o, is_v in zip(p.output_names, outs,
                                     p.output_is_vertex):
                if is_v:
                    arrays[f"{{cell}}/{{name}}"] = eng.gather_vertex_field(o)
                else:
                    meta[cell][name] = float(o)
np.savez({out!r} + ".npz", **arrays)
json.dump(meta, open({out!r} + ".json", "w"))
print("REFERENCE-OK")
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run many small tensor ops; one intra-op thread a
    worker keeps the test workers, which share the cores, from
    oversubscribing them (8 threads each thrash under load)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=["urand", "smallworld", "rmat"])
def family(request):
    return request.param


@pytest.fixture(scope="module")
def ref(family, tmp_path_factory):
    out = os.path.join(str(tmp_path_factory.mktemp("ref")), family)
    log = run_with_devices(_REFERENCE.format(
        tests_dir=TESTS_DIR, family=family, n=N, seed=SEED, parts=PARTS,
        warm_from=tuple(WARM_FROM.items()), out=out),
        devices=max(PARTS), timeout=900)
    assert "REFERENCE-OK" in log
    return json.load(open(out + ".json")), dict(np.load(out + ".npz"))


@pytest.fixture(scope="module")
def port(family):
    edges, n = oracle.family_edges(family, N, SEED)
    return edges, n, {parts: GraphEngine(partition_graph(edges, n, parts),
                                         device="cpu") for parts in PARTS}


def test_cold_seeds_match_reference(family, ref, port):
    _, arrays = ref
    _, _, engines = port
    for parts, eng in engines.items():
        for algo, variant in INCREMENTAL:
            spec = registry.get_spec(algo, variant)
            (got,) = incremental.cold_seed(spec, eng.g)
            want = arrays[f"{algo}_{variant}/cold/{parts}/seed"]
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), (algo, variant, parts)


@pytest.mark.parametrize("kind", ["cold", "warm"])
@pytest.mark.parametrize("algo,variant", INCREMENTAL)
def test_incremental_matches_reference_and_oracle(algo, variant, kind,
                                                  family, ref, port):
    meta, arrays = ref
    edges, n, engines = port
    params = oracle.CONFORMANCE_PARAMS.get((algo, variant), {})
    for parts, eng in engines.items():
        cell = f"{algo}_{variant}/{kind}/{parts}"
        what = f"{cell} family={family}"
        seed_arr = arrays[cell + "/seed"]
        prog = eng.program(algo, variant, **params)
        *outs, rounds = prog(eng.device_graph(),
                             eng.scatter_vertex_field(seed_arr))
        p = prog.program
        fields = {nm: (eng.gather_vertex_field(o) if isv else o)
                  for nm, o, isv in zip(p.output_names, outs,
                                        p.output_is_vertex)}
        oracle.check_conformance(algo, variant, fields, edges, n, ROOT)
        if not (algo == "pagerank" and family == "rmat"):
            assert rounds == meta[cell]["rounds"], what
        for name, got in fields.items():
            if name == "rank":
                want = arrays[f"{cell}/rank"]
                rel = np.abs(got - want).max() / want.max()
                assert rel < 1e-4, what
            elif name == "err":
                assert got <= params["tol"], what
            elif isinstance(got, np.ndarray):
                want = arrays[f"{cell}/{name}"]
                assert got.dtype == want.dtype, what
                np.testing.assert_array_equal(got, want, err_msg=what)
            else:
                assert got == meta[cell][name], what


def test_cold_seed_rejects_non_incremental():
    edges, n = oracle.family_edges("urand", N, SEED)
    g = partition_graph(edges, n, 2)
    with pytest.raises(ValueError, match="not incremental"):
        incremental.cold_seed(registry.get_spec("cc"), g)


def test_seed_tail_is_inert():
    """The seeded inits ignore the padded tail (identity labels, core 0,
    rank 0): a seed with garbage there gives the clean seed's
    outputs."""
    edges, n = oracle.family_edges("smallworld", N, SEED)
    eng = GraphEngine(partition_graph(edges, n, 4), device="cpu")
    g, garr = eng.g, eng.device_graph()
    assert g.n > g.n_orig
    tail = torch.zeros((g.parts, g.n_local), dtype=torch.bool)
    tail.view(-1)[g.n_orig:] = True
    for algo, variant in INCREMENTAL:
        spec = registry.get_spec(algo, variant)
        (seed_arr,) = incremental.cold_seed(spec, g)
        clean = eng.scatter_vertex_field(seed_arr)
        dirty = clean.clone()
        dirty[tail] = 7
        prog = eng.program(algo, variant)
        want, got = prog(garr, clean), prog(garr, dirty)
        assert torch.equal(want[0], got[0]) and want[-1] == got[-1]
