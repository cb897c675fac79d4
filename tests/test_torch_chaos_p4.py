"""The chaos sweep of test_torch_chaos.py at parts 4: the same checks
against the reference's records, in a file of its own so that the test
workers run the two parts counts side by side."""

import pytest
import torch

from test_torch_chaos import PAIRS, VERDICT_PAIRS, VERDICT_SCHEDULES, \
    Port, check_pair, check_verdict, reference

PARTS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(PARTS, tmp_path_factory.mktemp("ref"))


@pytest.fixture(scope="module")
def port():
    return Port(PARTS)


@pytest.mark.chaos
@pytest.mark.parametrize("algo,variant", PAIRS)
def test_chaos_matches_reference(algo, variant, ref, port):
    check_pair(port, ref, algo, variant)


@pytest.mark.chaos
@pytest.mark.parametrize("schedule", VERDICT_SCHEDULES)
@pytest.mark.parametrize("algo,variant", VERDICT_PAIRS)
def test_guarded_verdicts_match_reference(algo, variant, schedule, ref,
                                          port):
    check_verdict(port, ref, algo, variant, schedule)
