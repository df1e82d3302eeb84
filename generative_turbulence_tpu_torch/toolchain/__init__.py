"""toolchain sub-package of the PyTorch port: the OpenFOAM data toolchain
(case generation, meshing, mock solve, conversion, grid embedding and the
per-case analyses) and the checkpoint importers."""

from .foam_dicts import (  # noqa: F401
    parse_foam,
    parse_foam_file,
    serialize_foam,
    edit_foam_file,
    FoamDict,
    Dimensioned,
    FoamList,
)
