"""Failure detection and bounded retry for device dispatch (port of
``icp_tpu.parallel.resilience``).

A long-running mapping service sees transient dispatch failures (runtime
or transport hiccups, memory pressure from a neighbour); this module gives
a health probe and bounded-retry execution with backoff around whole pure
dispatches (retrying a pure function is always safe). Deterministic
errors (a kernel that does not build, a shape or type error) fail fast.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Tuple, Type, TypeVar

import torch

log = logging.getLogger("icp_tpu_torch.resilience")

T = TypeVar("T")

# Error TYPES that are transient regardless of message (transport layer).
TRANSIENT_ERRORS: Tuple[Type[BaseException], ...] = (OSError,)

# Message signatures of transient device / RPC failures. Runtimes raise
# transient faults and deterministic ones (a compile error, an invalid
# argument) as the same Python types, so the status words the runtime
# embeds classify them.
TRANSIENT_SIGNATURES: Tuple[str, ...] = (
    "unavailable",
    "deadline exceeded",
    "deadline_exceeded",
    "resource exhausted",
    "resource_exhausted",
    "aborted",
    "cancelled",
    "connection reset",
    "connection refused",
    "socket closed",
    "broken pipe",
    "timed out",
    "timeout",
    "http 500",
    "http/1.1 500",
    "internal server error",
    "temporarily",
    "try again",
    "rpc failed",
    "rpc error",
)


def is_transient(e: BaseException) -> bool:
    """True when ``e`` looks like a transient device or transport failure
    that a retry can plausibly fix; False for deterministic errors
    (compile failures, shape / type errors) that must surface at once."""
    if isinstance(e, TRANSIENT_ERRORS):
        return True
    msg = str(e).lower()
    return any(sig in msg for sig in TRANSIENT_SIGNATURES)


def _synchronize(x) -> None:
    """Wait for the devices of every tensor in ``x`` (a tensor, or a
    sequence, mapping or dataclass of them): an asynchronous launch failure
    surfaces here, as ``jax.block_until_ready`` makes it surface."""
    devices = set()

    def visit(v):
        if isinstance(v, torch.Tensor):
            devices.add(v.device)
        elif isinstance(v, (list, tuple)):
            for item in v:
                visit(item)
        elif isinstance(v, dict):
            for item in v.values():
                visit(item)
        elif hasattr(v, "__dataclass_fields__"):
            for name in v.__dataclass_fields__:
                visit(getattr(v, name))

    visit(x)
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def device_healthy(device="cuda") -> bool:
    """Cheap device heartbeat: one tiny op on ``device`` must complete."""
    try:
        x = torch.ones((8,), device=device) + 1.0
        _synchronize(x)
        return bool(x.shape == (8,))
    except Exception as e:  # noqa: BLE001 - a health probe must not raise
        log.warning("device heartbeat failed: %s", e)
        return False


def with_retries(fn: Callable[..., T], *args, retries: int = 3,
                 backoff_s: float = 1.0,
                 retry_on: Callable[[BaseException], bool] = is_transient,
                 **kwargs) -> T:
    """Run ``fn(*args, **kwargs)`` with bounded retries on transient device
    errors. The result's devices are synchronized before it counts as a
    success, so asynchronous launch failures surface inside the guarded
    region.

    ``retry_on`` is a predicate over the raised exception (default
    :func:`is_transient`); deterministic errors re-raise at once instead of
    burning the retry budget with backoff on a failure that cannot heal.

    Raises the last error after ``retries`` failed retries.
    """
    last: BaseException | None = None
    for attempt in range(retries + 1):
        try:
            out = fn(*args, **kwargs)
            _synchronize(out)
            return out
        except Exception as e:  # noqa: BLE001 - classified below
            if not retry_on(e):
                raise  # deterministic: fail fast, no backoff
            last = e
            if attempt == retries:
                break
            delay = backoff_s * (2.0 ** attempt)
            log.warning("dispatch failed (attempt %d/%d): %s - retrying in %.1fs",
                        attempt + 1, retries, e, delay)
            time.sleep(delay)
            device_healthy()
    if last is None:
        raise RuntimeError("with_retries: no attempt ran")
    raise last
