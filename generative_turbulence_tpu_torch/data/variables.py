"""Physical field variables and channel packing.

numpy copy of ``generative_turbulence_tpu/data/variables.py``: per-variable
channels are stacked into one trailing feature axis; dense grids are
channels-last ``(..., x, y, z, F)`` and per-cell data is ``(..., n_cells, F)``.
"""

from __future__ import annotations

import enum
from typing import Dict, Sequence, Tuple

import numpy as np


class Variable(enum.Enum):
    # Primary fields stored in data.h5
    U = "u"
    P = "p"
    K = "k"
    NUT = "nut"

    # Derived fields (computed, never stored in data.h5)
    CURL = "curl"
    ENSTROPHY = "enstrophy"
    DIVERGENCE = "divergence"
    GRAD = "grad"

    @property
    def dims(self) -> int:
        if self in (Variable.U, Variable.CURL):
            return 3
        if self is Variable.GRAD:
            return 9
        return 1

    @property
    def key(self) -> str:
        """Dataset / stats key, e.g. ``u`` for Variable.U."""
        return self.value

    @staticmethod
    def from_str(name: str) -> "Variable":
        try:
            return Variable(name.strip().lower())
        except ValueError:
            raise ValueError(f"Unknown variable {name!r}") from None

    @staticmethod
    def parse_tuple(spec) -> Tuple["Variable", ...]:
        """Parse ``"u,p"`` or an iterable of names/Variables into a tuple."""
        if isinstance(spec, str):
            spec = [s for s in spec.split(",") if s.strip()]
        return tuple(
            item if isinstance(item, Variable) else Variable.from_str(item)
            for item in spec
        )


def total_dims(variables: Sequence[Variable]) -> int:
    return sum(v.dims for v in variables)


def channel_slices(variables: Sequence[Variable]) -> Dict[Variable, slice]:
    """Slice of the stacked feature axis belonging to each variable."""
    out, start = {}, 0
    for v in variables:
        out[v] = slice(start, start + v.dims)
        start += v.dims
    return out


def split_channels(x, variables: Sequence[Variable], *, axis: int = -1):
    """Split a stacked feature axis into a dict of per-variable arrays."""
    out = {}
    for v, sl in channel_slices(variables).items():
        index = [slice(None)] * x.ndim
        index[axis] = sl
        out[v] = x[tuple(index)]
    return out


def stack_channels(fields: Dict[Variable, np.ndarray], variables: Sequence[Variable], *, axis: int = -1):
    """Concatenate per-variable arrays along the feature axis in variable order."""
    return np.concatenate([fields[v] for v in variables], axis=axis)
