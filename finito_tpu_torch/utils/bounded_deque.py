"""BoundedDeque: fixed-capacity ring-buffer deque.

Faithful counterpart of the reference's monotone-queue container
(ref: include/BoundedDeque.hh:5-75): a preallocated
circular buffer with push/pop at both ends and, by design, no bounds or
emptiness checks beyond assertions (the reference has none at all). The
host oracles use it as the sliding-window-minimum queue; the device
engines replace it with closed-form candidates + sliding tuple-minima
(see query/replica.py), which is why capacity can be bounded by k there
(SURVEY.md Appendix A item 10).
"""

from __future__ import annotations

from typing import Generic, List, Optional, TypeVar

T = TypeVar("T")


class BoundedDeque(Generic[T]):
    def __init__(self, capacity: int):
        self._buf: List[Optional[T]] = [None] * max(1, capacity)
        self._cap = max(1, capacity)
        self._head = 0  # index of front element
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def clear(self) -> None:
        self._head = 0
        self._size = 0

    def push_back(self, x: T) -> None:
        assert self._size < self._cap, "BoundedDeque overflow"
        self._buf[(self._head + self._size) % self._cap] = x
        self._size += 1

    def push_front(self, x: T) -> None:
        assert self._size < self._cap, "BoundedDeque overflow"
        self._head = (self._head - 1) % self._cap
        self._buf[self._head] = x
        self._size += 1

    def pop_back(self) -> None:
        assert self._size > 0, "BoundedDeque underflow"
        self._size -= 1

    def pop_front(self) -> None:
        assert self._size > 0, "BoundedDeque underflow"
        self._head = (self._head + 1) % self._cap
        self._size -= 1

    def front(self) -> T:
        assert self._size > 0
        return self._buf[self._head]  # type: ignore[return-value]

    def back(self) -> T:
        assert self._size > 0
        return self._buf[(self._head + self._size - 1) % self._cap]  # type: ignore[return-value]
