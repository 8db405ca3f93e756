"""Action and Plugin interfaces (ref: pkg/scheduler/framework/interface.go)."""
from __future__ import annotations

import abc


class Action(abc.ABC):
    """A scheduling policy pass executed once per session
    (ref: interface.go:81-95)."""

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    def initialize(self) -> None:
        return None

    @abc.abstractmethod
    def execute(self, ssn) -> None: ...

    def uninitialize(self) -> None:
        return None


class Plugin(abc.ABC):
    """Installs policy callbacks into a Session (ref: interface.go:97-101).

    Device note: plugins additionally may implement tensor-term hooks consumed
    by the kernels (see kernels/terms.py) — a plugin can contribute a
    vectorized predicate mask / score matrix instead of (or in addition to)
    per-pair callbacks. The per-pair callbacks remain the semantic ground
    truth the kernels are tested against.
    """

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def on_session_open(self, ssn) -> None: ...

    def on_session_close(self, ssn) -> None:
        return None
