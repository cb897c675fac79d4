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
