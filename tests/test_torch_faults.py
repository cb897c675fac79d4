"""The port's fault layer on its own and at the exchanges:

  * the in-process tests of tests/test_chaos.py against the port's
    engine at parts 1 (urand N=256, 2048 edges, seed 11, root 3): event
    validation, the schedule's parse round trip and hashability,
    ``as_schedule``, the guarded build's bit identity and cache
    identity, the four stamped kinds flagging ``ok == 0``, an event past
    halt staying clean, ``stale`` transport-silent on bfs/async, the
    NaN value guard with no schedule, guard/faults validation, and
    ``CheckpointRunner``'s bit identity and resume, recovery,
    ``max_recoveries`` and ``checkpoint_every`` contracts;
  * tap parity: seeded payloads (float32, bf16, int32 and bitmap words)
    through the reference's exchanges inside ``shard_map`` at parts 2
    and 4 (one subprocess) and through the port's ``StackedComm``
    exchanges, for every kind x op: the shipped payloads are equal bit
    for bit (bitmaps as int32 words against the reference's uint32);
  * with no schedule armed every exchange ships the very payload it was
    given, and an armed tap never writes into its caller's tensor;
  * a guarded round adds at most one host sync.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.core import CheckpointRunner, FaultEvent, FaultSchedule, \
    GraphEngine, RecoveryError, StackedComm, SuperstepProgram, faults, \
    partition_graph
from repro_torch.core.faults import as_schedule
from repro_torch.core.superstep import run_program
from repro_torch.graphs import urand_edges

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
N = 256
ROOT = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread a worker keeps the test
    workers, which share the cores, from oversubscribing them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def eng():
    g = partition_graph(urand_edges(N, 2048, seed=11), N, parts=1)
    return GraphEngine(g, device="cpu")


# -- schedule plumbing ---------------------------------------------------


def test_fault_event_validation():
    ev = FaultEvent(round=3, part=1, kind="stall", op="min", rounds=2)
    assert ev.spec() == "stall@r3p1:minx2"
    with pytest.raises(ValueError):
        FaultEvent(round=1, part=0, kind="fizzle")
    with pytest.raises(ValueError):
        FaultEvent(round=1, part=0, kind="drop", op="gossip")
    with pytest.raises(ValueError):
        FaultEvent(round=-1, part=0, kind="drop")
    with pytest.raises(ValueError):
        FaultEvent(round=1, part=0, kind="stall", rounds=0)


def test_fault_schedule_parse_roundtrip():
    text = "drop@r1p0 corrupt@r2p1:min stall@r3p0x2 seed=7"
    sched = FaultSchedule.parse(text)
    assert sched.seed == 7 and len(sched.events) == 3
    assert sched.spec() == text
    assert FaultSchedule.parse(sched.spec()) == sched
    assert hash(sched) == hash(FaultSchedule.parse(text))  # cache-keyable
    with pytest.raises(ValueError):
        FaultSchedule.parse("drop@round1part0")


def test_as_schedule_coercion():
    assert as_schedule(None) is None
    sched = FaultSchedule.parse("dup@r0p0 seed=1")
    assert as_schedule(sched) is sched
    assert as_schedule("dup@r0p0 seed=1") == sched
    with pytest.raises(TypeError):
        as_schedule(42)


# -- the guarded engine path ---------------------------------------------


def test_guarded_run_is_bit_identical_and_ok(eng):
    garr = eng.device_graph()
    plain = eng.program("bfs", "fast")
    parents, rounds = plain(garr, ROOT)
    guarded = eng.program("bfs", "fast", guard=True)
    gparents, grounds, ok = guarded(garr, ROOT)
    assert ok == 1 and grounds == rounds
    assert torch.equal(parents, gparents)
    # cache identity: (guard, faults) are part of the cache key
    assert eng.program("bfs", "fast", guard=True) is guarded
    assert eng.program("bfs", "fast") is plain and guarded is not plain


@pytest.mark.parametrize("spec", ["corrupt@r1p0:min seed=3",
                                  "drop@r1p0 seed=3",
                                  "stall@r1p0x2 seed=3",
                                  "dup@r1p0 seed=3"])
def test_engine_flags_stamped_faults(eng, spec):
    """Every stamped fault kind lands in the trailing ``ok``."""
    garr = eng.device_graph()
    prog = eng.program("bfs", "fast", guard=True, faults=spec)
    *_, ok = prog(garr, ROOT)
    assert ok == 0
    assert not faults.is_active()           # disarmed after the call


def test_clean_schedule_rounds_beyond_halt_stay_ok(eng):
    """An event addressed past the program's last round never fires and
    never taints the verdict."""
    garr = eng.device_graph()
    prog = eng.program("bfs", "fast", guard=True,
                       faults="corrupt@r500p0 seed=3")
    *_, ok = prog(garr, ROOT)
    assert ok == 1


def test_stale_is_transport_silent_on_async(eng):
    """``stale`` (partial delivery) is not stamped: the stale-tolerant
    async variants absorb it, same fixed point, clean verdict."""
    garr = eng.device_graph()
    clean = eng.program("bfs", "async")
    parents, _ = clean(garr, ROOT)
    prog = eng.program("bfs", "async", guard=True,
                       faults="stale@r1p0 seed=5")
    sparents, _, ok = prog(garr, ROOT)
    assert ok == 1
    assert torch.equal(parents, sparents)


def test_value_guard_catches_nan_without_fault_harness():
    """The value channel is independent of the fault taps: a program
    whose own step writes NaN into float state trips the default
    finite-state screen with no schedule armed at all."""
    comm = StackedComm(1, "cpu")

    def make(poison_round):
        def step(g, s):
            x = torch.full((1, 8), math.nan) if s[1] + 1 == poison_round \
                else s[0] + 1.0
            return x, s[1] + 1

        return SuperstepProgram(
            name="probe", variant="nan", inputs=(),
            init=lambda g: (torch.zeros((1, 8)), 0), step=step,
            halt=lambda s: s[1] >= 6, outputs=lambda s: (s[0],),
            output_names=("x",), output_is_vertex=(True,), comm=comm,
            max_rounds=8)

    (_,), rounds, ok = run_program(make(poison_round=99), {}, guard=True)
    assert ok and rounds == 6
    (_,), rounds, ok = run_program(make(poison_round=3), {}, guard=True)
    assert not ok and rounds == 3                  # stopped at detection


def test_guard_and_faults_validation(eng):
    with pytest.raises(ValueError):
        eng.program("pagerank", "bsp", guard=True, static_iters=4)
    with pytest.raises(ValueError):
        eng.program("bfs", "fast", guard=True, batch=4)
    with pytest.raises(ValueError):
        eng.program("bfs", "fast", faults="drop@r1p0", batch=4)


# -- checkpoint / resume / recovery (parts 1) ----------------------------


def test_checkpoint_runner_bit_identity_and_resume(eng):
    garr = eng.device_graph()
    parents, rounds = eng.program("bfs", "fast")(garr, ROOT)
    runner = CheckpointRunner(eng, "bfs", "fast", checkpoint_every=2,
                              keep_history=True)
    rep = runner.run(garr, ROOT)
    assert rep.recoveries == 0 and rep.rounds == rounds
    assert rep.checkpoints == len(rep.history) >= 2
    assert torch.equal(rep.outputs[0], parents)
    # the snapshots are copies: a later run leaves them as they were
    first = rep.history[0].carry[0][0].clone()
    runner.run(garr, ROOT)
    assert torch.equal(rep.history[0].carry[0][0], first)
    # resume from a mid-run snapshot: same bits as the full run
    mid = rep.history[len(rep.history) // 2]
    rep2 = runner.run(garr, ROOT, resume_from=mid)
    assert rep2.recoveries == 0
    assert torch.equal(rep.outputs[0], rep2.outputs[0])


def test_checkpoint_runner_recovers_to_clean_bits(eng):
    garr = eng.device_graph()
    parents, _ = eng.program("bfs", "fast")(garr, ROOT)
    runner = CheckpointRunner(eng, "bfs", "fast", checkpoint_every=2,
                              faults="corrupt@r2p0:min seed=7")
    rep = runner.run(garr, ROOT)
    assert rep.recoveries >= 1 and len(rep.detections) >= 1
    assert torch.equal(rep.outputs[0], parents)


def test_max_recoveries_bounds_the_rollback_loop(eng):
    garr = eng.device_graph()
    runner = CheckpointRunner(eng, "bfs", "fast", checkpoint_every=2,
                              faults="drop@r1p0 seed=1", max_recoveries=0)
    with pytest.raises(RecoveryError):
        runner.run(garr, ROOT)


def test_checkpoint_every_validation(eng):
    with pytest.raises(ValueError):
        CheckpointRunner(eng, "bfs", "fast", checkpoint_every=0)


# -- a guarded round's host syncs ----------------------------------------


@pytest.mark.parametrize("algo,variant", [("bfs", "fast"),
                                          ("pagerank", "async"),
                                          ("betweenness", "default")])
def test_guarded_round_adds_at_most_one_sync(eng, algo, variant,
                                             monkeypatch):
    """The verdict of a round reaches the host in one read: a guarded run
    makes at most one ``Tensor.item`` call a round (init included) more
    than the unguarded run."""
    garr = eng.device_graph()
    args = (ROOT,) if algo != "pagerank" else ()
    calls = []
    item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda t: calls.append(1) or item(t))
    *_, rounds = eng.program(algo, variant)(garr, *args)
    plain = len(calls)
    calls.clear()
    *_, grounds, ok = eng.program(algo, variant, guard=True)(garr, *args)
    phases = 2 if algo == "betweenness" else 1
    assert ok == 1 and grounds == rounds
    assert len(calls) - plain <= rounds + phases


# -- the tap at the exchanges, against the reference ---------------------
#
# Each site ships a seeded payload through one exchange; the reference
# side captures what its ``faults.tap`` returns inside ``shard_map`` (the
# per-shard payloads, stacked by out_specs), the port side what its
# ``faults.tap`` returns inside ``StackedComm``.  A site: (op, the
# exchange, payload dtype).

SITES = (("sum", "sum", "f32"), ("sum", "sum", "bf16"), ("sum", "sum", "i32"),
         ("sum", "sum_start", "f32"), ("min", "min", "i32"),
         ("min", "min", "f32"), ("min", "min_start", "i32"),
         ("min", "min_start", "f32"), ("or", "or", "words"),
         ("or", "or_start", "words"), ("bcast", "bcast", "f32"),
         ("bcast", "bcast", "i32"), ("bcast", "bcast", "words"),
         ("perm", "perm", "words"), ("perm", "perm", "f32"))
TAP_PARTS = (2, 4)
N_LOCAL = 64
TAP_SEED = 11


def _case_schedule(kind: str, op: str, parts: int) -> str:
    return f"{kind}@r0p{parts - 1}:{op}" + ("x2" if kind == "stall" else "") \
        + f" seed={TAP_SEED}"


def _site_inputs(rng, parts: int, exchange: str, dtype: str) -> dict:
    """Seeded numpy inputs of one site, stacked with the parts dim first
    (bf16 payloads as float32 values that bf16 holds exactly)."""
    n = parts * N_LOCAL
    if exchange in ("or", "or_start"):
        x = rng.random((parts, n)) < 0.3
    elif exchange == "bcast" and dtype == "words":
        x = rng.random((parts, N_LOCAL)) < 0.3
    elif exchange == "perm":
        w = n // 32
        x = rng.integers(-2 ** 31, 2 ** 31, (parts, N_LOCAL, w),
                         dtype=np.int64).astype(np.int32) if dtype == "words" \
            else rng.standard_normal((parts, N_LOCAL, w)).astype(np.float32)
    else:
        width = N_LOCAL if exchange == "bcast" else n
        if dtype == "i32":
            x = rng.integers(0, 1000, (parts, width)).astype(np.int32)
        else:
            x = rng.standard_normal((parts, width)).astype(np.float32)
            if dtype == "bf16":
                x = torch.from_numpy(x).bfloat16().float().numpy()
    inputs = {"x": x}
    if exchange.endswith("_start"):
        inputs["s"] = rng.integers(0, 50, parts).astype(
            np.float32 if dtype == "f32" else np.int32)
    return inputs


def _tap_cases():
    rng = np.random.default_rng(TAP_SEED)
    cases = []
    for parts in TAP_PARTS:
        for kind in faults.KINDS:
            for op, exchange, dtype in SITES:
                name = f"p{parts}-{kind}-{exchange}-{dtype}"
                cases.append((name, parts, kind, op, exchange, dtype,
                              _site_inputs(rng, parts, exchange, dtype)))
    return cases


_TAP_REFERENCE = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import faults, partitioned as pt
from repro.core.compat import shard_map

P = jax.sharding.PartitionSpec
cases = json.load(open({meta!r}))
data = np.load({data!r})
out = {{}}
real_tap = faults.tap
for name, parts, sched, exchange, dtype in cases:
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:parts]), ("parts",))
    x = data[name + "/x"]
    s = data[name + "/s"] if name + "/s" in data else None
    if dtype == "bf16":
        x = x.astype(jnp.bfloat16)
    seen = []

    def tap(op, payload, axis_name="parts"):
        res = real_tap(op, payload, axis_name)
        seen.append(res)
        return res

    def fn(x, s):
        x, s = x[0], s[0]
        seen.clear()
        with faults.active(faults.FaultSchedule.parse(sched), detect=True):
            faults.set_round(jnp.int32(0))
            if exchange == "sum":
                pt.exchange_sum(x)
            elif exchange == "sum_start":
                pt.exchange_sum_start(x, s)
            elif exchange == "min":
                pt.exchange_min_int(x)
            elif exchange == "min_start":
                pt.exchange_min_start(x, s)
            elif exchange == "or":
                pt.exchange_or(x)
            elif exchange == "or_start":
                pt.exchange_or_start(x, s)
            elif exchange == "bcast":
                pt.broadcast_global(pt.pack_bits(x) if dtype == "words"
                                    else x)
            else:
                block = x.astype(jnp.uint32) if dtype == "words" else x
                seen.append(real_tap("perm", block))
        assert len(seen) == 1, (name, len(seen))
        return seen[0][None]

    faults.tap = tap
    s_in = np.zeros(parts, np.int32) if s is None else s
    got = jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("parts"), P("parts")),
                            out_specs=P("parts"), check_vma=False))(x, s_in)
    faults.tap = real_tap
    got = np.asarray(got)
    if got.dtype == jnp.bfloat16:
        got = got.view(np.uint16)
    out[name] = got.view(np.uint8)
np.savez({out!r}, **out)
print("TAP-REFERENCE-OK")
"""


def _port_shipped(parts, sched, exchange, dtype, inputs):
    """The payload the port's exchange ships, as the fault tap returns
    it, in bytes laid out as the reference's stacked per-shard
    payloads."""
    comm = StackedComm(parts, "cpu")
    x = torch.from_numpy(inputs["x"])
    if dtype == "bf16":
        x = x.bfloat16()
    s = torch.from_numpy(inputs["s"]) if "s" in inputs else None
    x_before = x.clone()
    seen = []
    real_tap = faults.tap

    def tap(op, payload, parts_, words=False):
        res = real_tap(op, payload, parts_, words)
        seen.append(res)
        return res

    faults.tap = tap
    try:
        with faults.active(FaultSchedule.parse(sched), detect=True):
            faults.set_round(0)
            {"sum": lambda: comm.exchange_sum(x),
             "sum_start": lambda: comm.exchange_sum_start(x, s),
             "min": lambda: comm.exchange_min_int(x),
             "min_start": lambda: comm.exchange_min_start(x, s),
             "or": lambda: comm.exchange_or(x),
             "or_start": lambda: comm.exchange_or_start(x, s),
             "bcast": lambda: comm.broadcast_global(
                 comm_pack(x) if dtype == "words" else x,
                 words=dtype == "words"),
             "perm": lambda: comm.shift(x, words=dtype == "words")}[
                exchange]()
    finally:
        faults.tap = real_tap
    assert len(seen) == 1
    # the tap wrote into no tensor of its caller
    assert torch.equal(x, x_before)
    got = seen[0]
    got = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
    return got.contiguous().numpy().view(np.uint8).reshape(-1)


def comm_pack(x):
    from repro_torch.core.partitioned import pack_bits
    return pack_bits(x)


@pytest.fixture(scope="module")
def tap_reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tap")
    cases = _tap_cases()
    meta = [(name, parts, _case_schedule(kind, op, parts), exchange, dtype)
            for name, parts, kind, op, exchange, dtype, _ in cases]
    arrays = {f"{name}/{k}": v for name, *_, inputs in cases
              for k, v in inputs.items()}
    json.dump(meta, open(tmp / "cases.json", "w"))
    np.savez(tmp / "data.npz", **arrays)
    log = run_with_devices(_TAP_REFERENCE.format(
        meta=str(tmp / "cases.json"), data=str(tmp / "data.npz"),
        out=str(tmp / "out.npz")), devices=max(TAP_PARTS), timeout=600)
    assert "TAP-REFERENCE-OK" in log
    return cases, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("parts", TAP_PARTS)
def test_tap_matches_reference(parts, kind, tap_reference):
    """Every exchange site's shipped payload under a one-event schedule
    on the last part equals the reference's bit for bit (the corrupt
    element and value, the stale mask, the identities, the doubling)."""
    cases, want = tap_reference
    n = 0
    for name, p, k, op, exchange, dtype, inputs in cases:
        if (p, k) != (parts, kind):
            continue
        got = _port_shipped(parts, _case_schedule(kind, op, parts), exchange,
                            dtype, inputs)
        ref = want[name].reshape(-1)
        assert got.shape == ref.shape, name
        assert np.array_equal(got, ref), \
            f"{name}: {int((got != ref).sum())} bytes differ"
        n += 1
    assert n == len(SITES)


def test_unarmed_tap_ships_the_payload_itself():
    """No schedule: every exchange's tap returns the very tensor it was
    given (no copy).  Armed, an event of another op, another round or a
    part past P fires nothing, so the payload is shipped as it is."""
    comm = StackedComm(2, "cpu")
    x = torch.arange(2 * 128, dtype=torch.float32).reshape(2, 128)
    m = x.int() % 3 == 0
    s = torch.ones(2)
    pairs = []
    real_tap = faults.tap

    def tap(op, payload, parts_, words=False):
        res = real_tap(op, payload, parts_, words)
        pairs.append((payload, res))
        return res

    def every_exchange():
        comm.exchange_sum(x)
        comm.exchange_sum_start(x, s)
        comm.exchange_min_int(x)
        comm.exchange_min_start(x, s)
        comm.exchange_or(m)
        comm.exchange_or_start(m, s)
        comm.broadcast_global(x[:, :64])
        comm.shift(x)

    faults.tap = tap
    try:
        every_exchange()
        with faults.active(FaultSchedule.parse(
                "drop@r5p0 corrupt@r0p2 dup@r0p0:min seed=1"), detect=True):
            faults.set_round(0)
            every_exchange()
    finally:
        faults.tap = real_tap
    assert len(pairs) == 16
    assert all(res is payload for payload, res in pairs)
