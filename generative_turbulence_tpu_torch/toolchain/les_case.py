"""OpenFOAM LES case templating.

Generates a complete pimpleFoam LES case directory for the channel-flow
workload — same physics as the reference template (``scripts/les-template/``):
dynamic-k-equation SGS model, nu = 1e-5 m^2/s, PISO-style PIMPLE, backward
time scheme + LUST divergence, adjustable time step at maxCo = 0.4 — plus the
``Allrun`` solve script (blockMesh -> potentialFoam init -> pimpleFoam, with
optional MPI domain decomposition).  Configuration files are built from
Python dicts through the foam_dicts serializer, so they can be edited
programmatically (``edit_foam_file``) the way ``scripts/les-case.py:44-57``
does in the reference.

A copy of ``generative_turbulence_tpu/toolchain/les_case.py`` (host numpy,
no JAX): the same names, defaults and results.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .foam_dicts import Dimensioned, Field, FoamDict, serialize_foam


def _file(obj: str, cls: str = "dictionary") -> FoamDict:
    return FoamDict(
        FoamFile=FoamDict(version=2.0, format="ascii", **{"class": cls}, object=obj)
    )


def control_dict(
    end_time: float = 0.5,
    delta_t: float = 1e-5,
    write_interval: float = 1e-4,
    max_co: float = 0.4,
) -> FoamDict:
    d = _file("controlDict")
    d.update(
        application="pimpleFoam",
        startFrom="startTime",
        startTime=0,
        stopAt="endTime",
        endTime=end_time,
        deltaT=delta_t,
        writeControl="adjustableRunTime",
        writeInterval=write_interval,
        purgeWrite=0,
        writeFormat="ascii",
        writePrecision=7,
        writeCompression="off",
        timeFormat="general",
        timePrecision=7,
        runTimeModifiable="true",
        adjustTimeStep="yes",
        maxCo=max_co,
    )
    return d


def fv_schemes() -> FoamDict:
    d = _file("fvSchemes")
    d.update(
        ddtSchemes=FoamDict(default="backward"),
        gradSchemes=FoamDict(default="Gauss linear"),
        divSchemes=FoamDict(
            default="none",
            **{
                "div(phi,U)": "Gauss LUST grad(U)",
                "div(phi,k)": "Gauss limitedLinear 1",
                "div((nuEff*dev2(T(grad(U)))))": "Gauss linear",
            },
        ),
        laplacianSchemes=FoamDict(default="Gauss linear corrected"),
        interpolationSchemes=FoamDict(default="linear"),
        snGradSchemes=FoamDict(default="corrected"),
    )
    return d


def fv_solution() -> FoamDict:
    d = _file("fvSolution")
    d.update(
        solvers=FoamDict(
            p=FoamDict(solver="GAMG", smoother="GaussSeidel", tolerance=1e-6, relTol=0.01),
            pFinal=FoamDict(
                solver="GAMG", smoother="GaussSeidel", tolerance=1e-6, relTol=0
            ),
            **{
                '"(U|k|nuTilda)"': FoamDict(
                    solver="smoothSolver",
                    smoother="symGaussSeidel",
                    tolerance=1e-5,
                    relTol=0.1,
                ),
                '"(U|k|nuTilda)Final"': FoamDict(
                    solver="smoothSolver",
                    smoother="symGaussSeidel",
                    tolerance=1e-5,
                    relTol=0,
                ),
            },
        ),
        PIMPLE=FoamDict(
            nOuterCorrectors=1, nCorrectors=2, nNonOrthogonalCorrectors=0
        ),
    )
    return d


def physical_properties(nu: float = 1e-5) -> FoamDict:
    d = _file("physicalProperties")
    d.update(viscosityModel="constant", nu=Dimensioned((0, 2, -1, 0, 0, 0, 0), nu))
    return d


def momentum_transport() -> FoamDict:
    d = _file("momentumTransport")
    d.update(
        simulationType="LES",
        LES=FoamDict(
            model="dynamicKEqn",
            turbulence="on",
            printCoeffs="on",
            delta="cubeRootVol",
            cubeRootVolCoeffs=FoamDict(deltaCoeff=1),
        ),
    )
    return d


def decompose_par_dict(n: int = 1) -> FoamDict:
    d = _file("decomposeParDict")
    d.update(numberOfSubdomains=n, method="scotch")
    return d


def initial_fields(inflow: float, two_dimensional: bool = False) -> Dict[str, FoamDict]:
    """0/ field files with boundary conditions for U, p, k, nut."""

    def bf(**patches) -> FoamDict:
        out = FoamDict()
        for name, spec in patches.items():
            out[name] = FoamDict(spec)
        if two_dimensional:
            out["empties"] = FoamDict(type="empty")
        return out

    U = _file("U", "volVectorField")
    U.update(
        dimensions=Dimensioned((0, 1, -1, 0, 0, 0, 0)),
        internalField=Field(True, [inflow, 0, 0]),
        boundaryField=bf(
            inlets=dict(type="fixedValue", value=Field(True, [inflow, 0, 0])),
            outlets=dict(type="inletOutlet", inletValue=Field(True, [0, 0, 0])),
            walls=dict(type="noSlip"),
        ),
    )
    p = _file("p", "volScalarField")
    p.update(
        dimensions=Dimensioned((0, 2, -2, 0, 0, 0, 0)),
        internalField=Field(True, 0),
        boundaryField=bf(
            inlets=dict(type="zeroGradient"),
            outlets=dict(type="fixedValue", value=Field(True, 0)),
            walls=dict(type="zeroGradient"),
        ),
    )
    k_init = 1.5 * (0.05 * inflow) ** 2  # 5% turbulence intensity
    k = _file("k", "volScalarField")
    k.update(
        dimensions=Dimensioned((0, 2, -2, 0, 0, 0, 0)),
        internalField=Field(True, k_init),
        boundaryField=bf(
            inlets=dict(type="fixedValue", value=Field(True, k_init)),
            outlets=dict(type="zeroGradient"),
            walls=dict(type="fixedValue", value=Field(True, 0)),
        ),
    )
    nut = _file("nut", "volScalarField")
    nut.update(
        dimensions=Dimensioned((0, 2, -1, 0, 0, 0, 0)),
        internalField=Field(True, 0),
        boundaryField=bf(
            inlets=dict(type="calculated", value=Field(True, 0)),
            outlets=dict(type="calculated", value=Field(True, 0)),
            walls=dict(type="nutkWallFunction", value=Field(True, 0)),
        ),
    )
    return {"U": U, "p": p, "k": k, "nut": nut}


ALLRUN = """#!/bin/sh
cd "${0%/*}" || exit 1
. ${WM_PROJECT_DIR:?}/bin/tools/RunFunctions

runApplication blockMesh
runApplication potentialFoam -writephi

nproc=$(foamDictionary -entry numberOfSubdomains -value system/decomposeParDict)
if [ "$nproc" -gt 1 ]; then
    runApplication decomposePar
    runParallel $(getApplication)
    runApplication reconstructPar
else
    runApplication $(getApplication)
fi
"""


def write_case(
    case_dir: Path,
    *,
    inflow: float = 20.0,
    nu: float = 1e-5,
    end_time: float = 0.5,
    delta_t: float = 1e-5,
    write_interval: float = 1e-4,
    n_subdomains: int = 1,
    two_dimensional: bool = False,
) -> Path:
    """Write a complete LES case (system/, constant/, 0/, Allrun,
    entrypoint.sh)."""
    case_dir = Path(case_dir)
    (case_dir / "system").mkdir(parents=True, exist_ok=True)
    (case_dir / "constant").mkdir(parents=True, exist_ok=True)
    (case_dir / "0").mkdir(parents=True, exist_ok=True)

    files = {
        "system/controlDict": control_dict(end_time, delta_t, write_interval),
        "system/fvSchemes": fv_schemes(),
        "system/fvSolution": fv_solution(),
        "system/decomposeParDict": decompose_par_dict(n_subdomains),
        "constant/physicalProperties": physical_properties(nu),
        "constant/momentumTransport": momentum_transport(),
    }
    for rel, d in files.items():
        (case_dir / rel).write_text(serialize_foam(d))
    for name, d in initial_fields(inflow, two_dimensional).items():
        (case_dir / "0" / name).write_text(serialize_foam(d))

    allrun = case_dir / "Allrun"
    allrun.write_text(ALLRUN)
    allrun.chmod(0o755)
    entry = case_dir / "entrypoint.sh"
    entry.write_text("#!/bin/sh\ncd \"${0%/*}\" && ./Allrun\n")
    entry.chmod(0o755)
    return case_dir
