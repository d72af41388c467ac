"""swmhd_tpu — shallow-water magnetohydrodynamics framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the reference
SWMHD stack (writingindy/SWMHD + the Oceananigans.jl subset it stands on):
staggered C-grid operators, WENO5 advection, vector-invariant and
conservative shallow-water formulations, jacobian- and divergence-form
Lorentz forcing, RK3 time stepping, simulation driver with callbacks and
output writers, energy diagnostics — plus what the reference lacks: 2-D
domain decomposition over several GPUs with halo exchange, and
checkpoint/resume. It runs on an NVIDIA GPU through XLA.
"""

from .grid import Grid, PERIODIC, BOUNDED
from .models import State, Clock, ShallowWaterModel, VECTOR_INVARIANT, CONSERVATIVE
from .advection import Centered2, UpwindBiased3, WENO5, get_scheme
from .physics import (
    FPlane, LaplacianDiffusion, BiharmonicDiffusion,
    lorentz_force_jacobian, lorentz_force_divergence,
    magnetic_field_cc, magnetic_field_faces,
)
from .forcing import jacobian_lorentz_forcing, divergence_lorentz_forcing
from .simulation import (Simulation, IterationInterval, TimeInterval,
                         Callback, TimeStepWizard)
from . import diagnostics
from . import profiling

__version__ = "0.1.0"

__all__ = [
    "Grid", "PERIODIC", "BOUNDED",
    "State", "Clock", "ShallowWaterModel", "VECTOR_INVARIANT", "CONSERVATIVE",
    "Centered2", "UpwindBiased3", "WENO5", "get_scheme",
    "FPlane", "LaplacianDiffusion", "BiharmonicDiffusion",
    "lorentz_force_jacobian", "lorentz_force_divergence",
    "magnetic_field_cc", "magnetic_field_faces",
    "jacobian_lorentz_forcing", "divergence_lorentz_forcing",
    "Simulation", "IterationInterval", "TimeInterval", "Callback",
    "TimeStepWizard", "diagnostics", "profiling",
]
