"""Exchange layer of the port against the JAX package's: the bit helpers
against its uint32 words, each stacked exchange against its collective
under ``jax.vmap(axis_name="parts")`` (real cross-part semantics in one
process), the bf16 reduce-scatter against ``shard_map`` on real CPU
devices, and the wire bytes each exchange counts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import run_with_devices
from repro.core import partitioned as ref
from repro.obs import telemetry as ref_tel
from repro_torch.core import partitioned
from repro_torch.core.partitioned import StackedComm


def _words_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("nwords,seed", [(1, 0), (4, 1), (33, 2)])
def test_bit_helpers_match_reference_words(nwords, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, nwords * 32).astype(bool)
    bits[31::32] = True                       # bit 31 of every word
    want = np.asarray(ref.pack_bits(jnp.asarray(bits)))
    got = partitioned.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_words_u32(got), want)
    np.testing.assert_array_equal(
        partitioned.unpack_bits(got, nwords * 32).numpy(), bits)
    ids = rng.integers(0, nwords * 32, 257).astype(np.int32)
    ids[:nwords] = np.arange(nwords) * 32 + 31
    np.testing.assert_array_equal(
        partitioned.test_bit(got, torch.from_numpy(ids)).numpy(),
        np.asarray(ref.test_bit(jnp.asarray(want), jnp.asarray(ids))))


def test_pack_bits_batched_rows():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (3, 128)).astype(bool)
    got = partitioned.pack_bits(torch.from_numpy(bits))
    for p in range(3):
        np.testing.assert_array_equal(
            _words_u32(got[p]), np.asarray(ref.pack_bits(jnp.asarray(bits[p]))))


def _vmapped(fn, *arrays):
    """Run a reference exchange body over the leading parts axis, with
    the axis name bound so its collectives run for real, and record the
    bytes its wire taps see."""
    rec = ref_tel.WireRecord()
    with ref_tel.recording(rec):
        out = jax.vmap(fn, axis_name=ref.AXIS)(*arrays)
    return out, rec.bytes_by_op()


@pytest.mark.parametrize("parts", [2, 4])
def test_exchanges_match_reference_collectives(parts):
    rng = np.random.default_rng(parts)
    n_local = 64
    n = parts * n_local
    vals = rng.normal(size=(parts, n)).astype(np.float32)
    ints = rng.integers(0, 1000, (parts, n)).astype(np.int32)
    mask = rng.integers(0, 2, (parts, n)).astype(bool)
    local = rng.normal(size=(parts, n_local)).astype(np.float32)
    comm = StackedComm(parts, "cpu")

    want, wire_sum = _vmapped(ref.exchange_sum, jnp.asarray(vals))
    got = comm.exchange_sum(torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    want, wire_min = _vmapped(ref.exchange_min_int, jnp.asarray(ints))
    np.testing.assert_array_equal(
        comm.exchange_min_int(torch.from_numpy(ints)).numpy(),
        np.asarray(want))

    want, wire_or = _vmapped(ref.exchange_or, jnp.asarray(mask))
    np.testing.assert_array_equal(
        comm.exchange_or(torch.from_numpy(mask)).numpy(), np.asarray(want))

    want, wire_bc = _vmapped(ref.broadcast_global, jnp.asarray(local))
    np.testing.assert_array_equal(
        comm.broadcast_global(torch.from_numpy(local)).numpy(),
        np.asarray(want))

    want, _ = _vmapped(lambda v: ref.psum_scalar(v.sum()), jnp.asarray(local))
    assert comm.psum_scalar(torch.from_numpy(local).sum(dim=1)) \
        == pytest.approx(float(np.asarray(want)[0]), rel=1e-6)

    assert comm.wire_by_op() == {**wire_sum, **wire_min, **wire_or,
                                 **wire_bc}


@pytest.mark.parametrize("parts", [2, 4])
def test_own_slice_and_lo(parts):
    comm = StackedComm(parts, "cpu")
    n_local = 96
    np.testing.assert_array_equal(comm.lo(n_local).numpy()[:, 0],
                                  np.arange(parts) * n_local)
    x = torch.arange(parts * parts * n_local).reshape(parts, -1)
    own = comm.own_slice(x)
    for p in range(parts):
        np.testing.assert_array_equal(
            own[p].numpy(), x[p, p * n_local:(p + 1) * n_local].numpy())


_BF16_SHARD_MAP = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.core.compat import shard_map
from repro.core.partitioned import exchange_sum
P_ = jax.sharding.PartitionSpec
for parts in (2, 4):
    rng = np.random.default_rng(parts)
    n = parts * 512
    x = (rng.normal(size=(parts, n))
         * rng.choice([1e-3, 1.0, 1e3], size=(parts, n))).astype(np.float32)
    mesh = jax.make_mesh((parts,), ("parts",))
    f = jax.jit(shard_map(lambda a: exchange_sum(a[0])[None], mesh=mesh,
                          in_specs=(P_("parts", None),),
                          out_specs=P_("parts", None), check_vma=False))
    for dt in (jnp.bfloat16, jnp.float32):
        xin = jnp.asarray(x).astype(dt)
        out = np.asarray(f(xin).astype(jnp.float32)).reshape(parts, -1)
        np.save({out_dir!r} + f"/in_{{parts}}_{{jnp.dtype(dt).name}}.npy",
                np.asarray(xin.astype(jnp.float32)))
        np.save({out_dir!r} + f"/out_{{parts}}_{{jnp.dtype(dt).name}}.npy", out)
print("SAVED")
"""


def test_exchange_sum_matches_reference_across_devices(tmp_path):
    """The reference's psum_scatter on real CPU devices adds the parts in
    source order in float32 and rounds a bf16 payload once; the stacked
    exchange must give the same bits for both payload types."""
    out = run_with_devices(_BF16_SHARD_MAP.format(out_dir=str(tmp_path)),
                           devices=4, timeout=300)
    assert "SAVED" in out
    for parts in (2, 4):
        comm = StackedComm(parts, "cpu")
        for name, dt in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
            xin = torch.from_numpy(
                np.load(tmp_path / f"in_{parts}_{name}.npy")).to(dt)
            want = np.load(tmp_path / f"out_{parts}_{name}.npy")
            got = comm.exchange_sum(xin)
            assert got.dtype == dt
            np.testing.assert_array_equal(got.float().numpy(), want,
                                          err_msg=f"{name} parts={parts}")


@pytest.mark.parametrize("parts", [2, 4])
def test_int32_exchange_sum_is_exact_and_wraps(parts):
    """Integer payloads add in int32 like the reference's psum_scatter:
    exact above 2**24 (a float32 sum would round 2**24 + 1) and wrapping
    past 2**31."""
    rng = np.random.default_rng(parts)
    n = parts * 32
    ints = rng.integers(-2 ** 31, 2 ** 31, (parts, n)).astype(np.int32)
    ints[0, :4] = [2 ** 24 + 1, 2 ** 31 - 1, 2 ** 24 + 3, -2 ** 31]
    ints[1:, :4] = [0, 1, 2 ** 24, -1]
    want, _ = _vmapped(ref.exchange_sum, jnp.asarray(ints))
    got = StackedComm(parts, "cpu").exchange_sum(torch.from_numpy(ints))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 0]) == 2 ** 24 + 1


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_shift_matches_reference_ring(parts):
    """``shift`` is the reference's ppermute ring (part i to part
    (i + 1) mod P) and taps the same bytes under op ``perm``."""
    rng = np.random.default_rng(parts)
    x = rng.integers(-2 ** 31, 2 ** 31, (parts, 8, 5)).astype(np.int32)

    def ring(b):
        return jax.lax.ppermute(ref._tap("perm", b, ref.AXIS), ref.AXIS,
                                [(i, (i + 1) % parts) for i in range(parts)])

    want, wire = _vmapped(ring, jnp.asarray(x))
    comm = StackedComm(parts, "cpu")
    np.testing.assert_array_equal(comm.shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(want))
    assert comm.wire_by_op() == wire == {"perm": 8 * 5 * 4}


def _start_finish_inputs(parts, seed):
    rng = np.random.default_rng(seed)
    n = parts * 64
    return {
        "vals": rng.normal(size=(parts, n)).astype(np.float32),
        "ints": rng.integers(0, 1000, (parts, n)).astype(np.int32),
        "mask": rng.integers(0, 2, (parts, n)).astype(bool),
        # integer-valued per-part halt counts, and float residuals
        "count": rng.integers(0, 5000, parts).astype(np.int32),
        "resid": rng.random(parts).astype(np.float32),
    }


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_start_finish_match_reference(parts):
    """Each double-buffered pair against the reference's under the named
    vmap: the handles are the same received rows (the port's min and or
    handles are indexed source-first), the finishes the same values, and
    each start taps its blocking op's bytes with the scalar column."""
    x = _start_finish_inputs(parts, parts + 10)
    n_local = x["vals"].shape[1] // parts
    comm = StackedComm(parts, "cpu")
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    j = {k: jnp.asarray(v) for k, v in x.items()}
    finish_min = jax.vmap(ref.exchange_min_finish)
    finish_sum = jax.vmap(ref.exchange_sum_finish)
    finish_or = jax.vmap(lambda h: ref.exchange_or_finish(h, n_local))

    cases = (
        ("min", j["vals"], j["count"].astype(jnp.float32), t["vals"],
         t["count"], ref.exchange_min_start, comm.exchange_min_start,
         finish_min, comm.exchange_min_finish),
        ("min", j["ints"], j["count"], t["ints"], t["count"],
         ref.exchange_min_start, comm.exchange_min_start, finish_min,
         comm.exchange_min_finish),
        ("sum", j["vals"], j["resid"], t["vals"], t["resid"],
         ref.exchange_sum_start, comm.exchange_sum_start, finish_sum,
         comm.exchange_sum_finish),
        ("or", j["mask"], j["count"].astype(jnp.uint32), t["mask"],
         t["count"], ref.exchange_or_start, comm.exchange_or_start,
         finish_or, lambda h: comm.exchange_or_finish(h, n_local)),
    )
    for op, jv, js, tv, ts, rstart, pstart, rfinish, pfinish in cases:
        what = f"{op} {tv.dtype} parts={parts}"
        comm.reset_wire()
        want_h, wire = _vmapped(rstart, jv, js)
        got_h = pstart(tv, ts)
        assert comm.wire_by_op() == wire, what
        want_h = np.asarray(want_h)
        if op == "sum":
            np.testing.assert_array_equal(got_h.numpy(), want_h,
                                          err_msg=what)
        else:       # (P_dst, 1, P_src, w) -> (P_src, P_dst, w)
            got = got_h.numpy()
            if op == "or":
                got = got.view(np.uint32)
            np.testing.assert_array_equal(
                got, want_h[:, 0].transpose(1, 0, 2), err_msg=what)
        (want_v, want_s), (got_v, got_s) = rfinish(want_h), pfinish(got_h)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v),
                                      err_msg=what)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s),
                                      err_msg=what)


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_start_finish_equal_blocking_forms(parts):
    """A finished handle gives the blocking exchange's values, and its
    scalar is ``psum_scalar`` of the stamps on every part."""
    x = _start_finish_inputs(parts, parts + 20)
    n_local = x["vals"].shape[1] // parts
    comm = StackedComm(parts, "cpu")
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    count = comm.psum_scalar(t["count"])
    mine, total = comm.exchange_min_finish(
        comm.exchange_min_start(t["ints"], t["count"]))
    assert torch.equal(mine, comm.exchange_min_int(t["ints"]))
    assert total.tolist() == [count] * parts
    mine, total = comm.exchange_min_finish(
        comm.exchange_min_start(t["vals"], t["count"]))
    assert torch.equal(mine, comm.exchange_min_int(t["vals"]))
    assert total.tolist() == [float(count)] * parts
    sums, resid = comm.exchange_sum_finish(
        comm.exchange_sum_start(t["vals"], t["resid"]))
    assert torch.equal(sums, comm.exchange_sum(t["vals"]))
    assert resid.tolist() == [comm.psum_scalar(t["resid"])] * parts
    bits, total = comm.exchange_or_finish(
        comm.exchange_or_start(t["mask"], t["count"]), n_local)
    assert torch.equal(bits, comm.exchange_or(t["mask"]))
    assert total.dtype == torch.int32 and total.tolist() == [count] * parts


@pytest.mark.parametrize("parts", [2, 4])
def test_piggybacked_count_exact_to_2_24(parts):
    """Integer-valued stamps in a float32 column add exactly while the
    total stays within 2**24, as the reference's property suite pins."""
    stamps = torch.zeros(parts, dtype=torch.int32)
    stamps[0] = 2 ** 24 - (parts - 1)
    stamps[1:] = 1
    comm = StackedComm(parts, "cpu")
    zeros = torch.zeros((parts, parts * 32), dtype=torch.float32)
    _, total = comm.exchange_min_finish(comm.exchange_min_start(zeros,
                                                                stamps))
    assert total.tolist() == [2.0 ** 24] * parts
    _, total = comm.exchange_sum_finish(comm.exchange_sum_start(zeros,
                                                                stamps))
    assert total.tolist() == [2.0 ** 24] * parts
    big = torch.full((parts,), 2 ** 24 + 1, dtype=torch.int32)
    _, total = comm.exchange_min_finish(comm.exchange_min_start(
        zeros.int(), big))
    assert total.tolist() == [parts * (2 ** 24 + 1)] * parts
