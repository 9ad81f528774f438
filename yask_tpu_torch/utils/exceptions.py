"""Framework exception type.

Counterpart of ``yask_exception`` (reference
``include/yask_common_api.hpp:125-155``): a single exception class carrying an
accreting message, raised by both compiler and runtime for user-facing errors.
"""

from __future__ import annotations


class YaskException(Exception):
    """Exception raised by the framework for all user-facing error paths.

    Like the reference's ``yask_exception``, messages can be accreted after
    construction via :meth:`add_message`.
    """

    def __init__(self, message: str = ""):
        super().__init__(message)
        self._message = message

    def add_message(self, message: str) -> None:
        """Append to the error message (``yask_exception::add_message``)."""
        self._message += message
        self.args = (self._message,)

    def get_message(self) -> str:
        """Return the current message (``yask_exception::get_message``)."""
        return self._message

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self._message


def yask_assert(cond: bool, msg: str = "internal assertion failed") -> None:
    """Internal invariant check (counterpart of ``yask_assert.hpp``)."""
    if not cond:
        raise YaskException("YASK-TPU internal error: " + msg)
