"""The port's configs and token pipeline against the JAX package's:
every architecture field for field, the smoke configs, the LM shapes,
and ``batch_at`` tokens byte for byte."""

import dataclasses

import numpy as np
import pytest

from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro.data import TokenStream as JaxTokenStream
from repro.data import batch_at as jax_batch_at

from repro_torch.configs import base
from repro_torch.configs import registry
from repro_torch.data import TokenStream, batch_at


@pytest.mark.parametrize("name", list(jax_registry.ARCHS))
def test_arch_config_matches(name):
    got, want = registry.get_arch(name), jax_registry.get_arch(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.params_total() == want.params_total()
    assert got.params_active() == want.params_active()


@pytest.mark.parametrize("name", list(jax_registry.ARCHS))
def test_smoke_config_matches(name):
    got, want = registry.smoke_config(name), jax_registry.smoke_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.params_total() == want.params_total()


def test_registry_and_shapes_match():
    assert list(registry.ARCHS) == list(jax_registry.ARCHS)
    assert [dataclasses.asdict(s) for s in base.LM_SHAPES] \
        == [dataclasses.asdict(s) for s in jax_base.LM_SHAPES]
    for name in registry.ARCHS:
        assert [s.name for s in base.shapes_for(registry.get_arch(name))] \
            == [s.name for s in jax_base.shapes_for(
                jax_registry.get_arch(name))]
    assert registry.all_cells() and len(registry.all_cells()) \
        == len(jax_registry.all_cells())
    assert registry.skipped_cells() == jax_registry.skipped_cells()
    with pytest.raises(KeyError):
        registry.get_arch("no-such-arch")


@pytest.mark.parametrize("step,batch,seq,vocab", [
    (0, 2, 64, 256), (0, 8, 1024, 32000), (3, 4, 49, 512),
    (17, 1, 300, 262144), (123456, 3, 77, 151655)])
def test_batch_at_tokens_byte_identical(step, batch, seq, vocab):
    got = batch_at(step, global_batch=batch, seq_len=seq, vocab_size=vocab)
    want = np.asarray(jax_batch_at(step, global_batch=batch, seq_len=seq,
                                   vocab_size=vocab))
    assert got.numpy().dtype == want.dtype == np.int32
    assert got.numpy().tobytes() == want.tobytes()


def test_token_stream_matches():
    got = TokenStream(global_batch=2, seq_len=16, vocab_size=300, seed=5)
    want = JaxTokenStream(global_batch=2, seq_len=16, vocab_size=300, seed=5)
    for _ in range(3):
        assert got.next()["tokens"].numpy().tobytes() \
            == np.asarray(want.next()["tokens"]).tobytes()
    got.restore(7)
    want.restore(7)
    assert got.next()["tokens"].numpy().tobytes() \
        == np.asarray(want.next()["tokens"]).tobytes()
