"""The process-real MPI rank plane (``mpi_sim.py``)."""

from .mpi_sim import MPIProcessSimulator, run_mpi_simulation

__all__ = ["MPIProcessSimulator", "run_mpi_simulation"]
