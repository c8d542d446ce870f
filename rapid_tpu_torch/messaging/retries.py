"""Async retry combinator (reference: messaging/impl/Retries.java:43-90).

A copy of ``rapid_tpu/messaging/retries.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

from typing import Awaitable, Callable, TypeVar

from rapid_tpu_torch.errors import ShuttingDownError

T = TypeVar("T")


async def call_with_retries(
    call: Callable[[], Awaitable[T]],
    retries: int,
) -> T:
    """Run ``call`` until it succeeds, for at most ``retries + 1`` attempts;
    re-raises the last failure. Terminal conditions — task cancellation
    (BaseException) and client shutdown — propagate immediately instead of
    burning further attempts."""
    last_exc: Exception | None = None
    for _ in range(retries + 1):
        try:
            return await call()
        except ShuttingDownError:
            raise
        except Exception as exc:  # noqa: BLE001 — transport failures vary by impl
            last_exc = exc
    assert last_exc is not None
    raise last_exc
