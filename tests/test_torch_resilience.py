"""The port's failure detection and bounded retry
(``icp_tpu_torch.parallel.resilience``) against the contract of
tests/test_resilience.py: deterministic errors surface at once, transient
ones retry with backoff; the two packages classify every error alike."""

from __future__ import annotations

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import dataclasses

import pytest
import torch

from icp_tpu.parallel import resilience as JR
from icp_tpu_torch.parallel import resilience as TR
from icp_tpu_torch.parallel.resilience import device_healthy, is_transient, with_retries


class _FlakyFn:
    """Raises the given errors in order, then returns a value."""

    def __init__(self, errors, value=42.0):
        self.errors = list(errors)
        self.value = value
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.errors:
            raise self.errors.pop(0)
        return self.value


ERRORS = [
    OSError("connection reset by peer"),
    ConnectionResetError("peer hung up"),
    RuntimeError("UNAVAILABLE: socket closed"),
    RuntimeError("DEADLINE_EXCEEDED: 30s elapsed"),
    RuntimeError("relay returned HTTP 500"),
    RuntimeError("RESOURCE_EXHAUSTED: out of grant"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("nvcc failed to compile the kernel"),
    RuntimeError("Mosaic failed to compile TPU kernel: unsupported layout"),
    RuntimeError("INVALID_ARGUMENT: dot dimension mismatch"),
    TypeError("unhashable type"),
    ValueError("shapes (3,) and (4,) not aligned"),
]


def test_transient_classification():
    # Transport-layer error types are transient regardless of message.
    assert is_transient(OSError("connection reset by peer"))
    assert is_transient(ConnectionResetError("peer hung up"))
    assert is_transient(RuntimeError("UNAVAILABLE: socket closed"))
    assert is_transient(RuntimeError("DEADLINE_EXCEEDED: 30s elapsed"))
    assert is_transient(RuntimeError("relay returned HTTP 500"))
    assert is_transient(RuntimeError("RESOURCE_EXHAUSTED: out of grant"))
    # Deterministic compile / shape errors must NOT look transient.
    assert not is_transient(RuntimeError("nvcc failed to compile the kernel"))
    assert not is_transient(RuntimeError("INVALID_ARGUMENT: dot dimension mismatch"))
    assert not is_transient(TypeError("unhashable type"))
    assert not is_transient(ValueError("shapes (3,) and (4,) not aligned"))


@pytest.mark.parametrize("error", ERRORS, ids=lambda e: str(e)[:24])
def test_classification_matches_jax(error):
    assert TR.is_transient(error) == JR.is_transient(error)
    assert TR.TRANSIENT_ERRORS == JR.TRANSIENT_ERRORS
    assert TR.TRANSIENT_SIGNATURES == JR.TRANSIENT_SIGNATURES


def test_deterministic_error_fails_fast():
    fn = _FlakyFn([RuntimeError("nvcc failed to compile the kernel")])
    with pytest.raises(RuntimeError, match="nvcc"):
        with_retries(fn, retries=3, backoff_s=0.0)
    assert fn.calls == 1  # no retry burned on a compile error


def test_transient_error_retries_until_success():
    fn = _FlakyFn([RuntimeError("UNAVAILABLE: socket closed"),
                   OSError("connection reset")])
    assert with_retries(fn, retries=3, backoff_s=0.0) == 42.0
    assert fn.calls == 3


def test_transient_error_exhausts_budget():
    fn = _FlakyFn([RuntimeError("UNAVAILABLE: a")] * 4)
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        with_retries(fn, retries=3, backoff_s=0.0)
    assert fn.calls == 4  # initial attempt + 3 retries


def test_custom_retry_predicate():
    fn = _FlakyFn([ValueError("flaky-by-contract")])
    out = with_retries(fn, retries=1, backoff_s=0.0,
                       retry_on=lambda e: isinstance(e, ValueError))
    assert out == 42.0 and fn.calls == 2


def test_results_pass_through_with_their_tensors():
    """A result of tensors (a tensor, a tuple, a dataclass) comes back as
    it is, after its devices are synchronized."""
    @dataclasses.dataclass
    class State:
        q: torch.Tensor
        k: int

    st = State(torch.ones(4), 3)
    assert with_retries(lambda: st, retries=0) is st
    pair = (torch.zeros(2), [torch.ones(1)])
    assert with_retries(lambda: pair, retries=0) is pair


def test_device_healthy_smoke():
    assert device_healthy("cpu") is True
    # The default probes the card: False without one, never an exception.
    assert device_healthy() is torch.cuda.is_available()
