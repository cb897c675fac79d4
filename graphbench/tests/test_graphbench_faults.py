"""A run with its timed path broken underneath comes out not correct.

The harness is driven whole on the CPU at a tiny size (the look for a
card is the entry point's, and is skipped here); each fault is planted
in the program under the harness: a step that returns its state
unchanged, the exchange between the parts left out, an answer altered
where it is produced.  (The mixes run no batch, so no fault leaves half
of one out.)  The sound program comes out correct.
"""

import dataclasses

import pytest
import torch

from graphbench import harness
from graphbench.tests.helpers import SEED, one_thread, tiny_cell  # noqa: F401
from repro_torch.core import api, partitioned
from repro_torch.core.partitioned import pack_bits, unpack_bits


def _state_unchanged(monkeypatch):
    build = api.GraphEngine.program

    def program(self, *a, **k):
        compiled = build(self, *a, **k)
        compiled.program = dataclasses.replace(
            compiled.program, step=lambda g, state: state)
        return compiled

    monkeypatch.setattr(api.GraphEngine, "program", program)


def _exchange_left_out(monkeypatch):
    cls = partitioned.StackedComm

    def exchange_sum(self, acc):
        return self._blocks(acc)[self.own_index()]

    def exchange_or(self, mask):
        n_local = mask.shape[-1] // self.parts
        own = self._blocks(pack_bits(mask))[self.own_index()]
        return unpack_bits(own, n_local)

    def broadcast_global(self, vals, words=False):
        out = torch.zeros((self.parts, self.parts, vals.shape[-1]),
                          dtype=vals.dtype, device=vals.device)
        out[self.own_index()] = vals
        return out.reshape(self.parts, -1)

    monkeypatch.setattr(cls, "exchange_sum", exchange_sum)
    monkeypatch.setattr(cls, "exchange_or", exchange_or)
    monkeypatch.setattr(cls, "broadcast_global", broadcast_global)


def _answer_altered(monkeypatch):
    call = api.CompiledProgram.__call__

    def altered(self, garr, *inputs):
        out, *rest = call(self, garr, *inputs)
        out = out.clone()
        flat = out.view(-1)
        if out.dtype == torch.int32:      # parents: move one reached one
            j = int(torch.nonzero(flat < 2 ** 30)[-1])
            flat[j] = flat[j] + 1
        else:                             # ranks: one off by 1%
            flat[0] *= 1.01
        return (out, *rest)

    monkeypatch.setattr(api.CompiledProgram, "__call__", altered)


FAULTS = {"sound": None, "state_unchanged": _state_unchanged,
          "exchange_left_out": _exchange_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", ["urand22-bfs", "kron22-pagerank"])
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    result = harness.run_cell(tiny_cell(cell), SEED, 0.2, False,
                              device="cpu")
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["correct"] is (fault == "sound"), result["checks"]
    assert list(result)[-1] == "checks"
