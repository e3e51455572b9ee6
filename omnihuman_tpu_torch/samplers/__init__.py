from omnihuman_tpu_torch.samplers.fm_solvers import (
    FlowDPMSolver,
    FlowUniPCSolver,
    get_sampling_sigmas,
    get_solver,
    retrieve_timesteps,
)

__all__ = [
    "FlowUniPCSolver", "FlowDPMSolver", "get_solver",
    "get_sampling_sigmas", "retrieve_timesteps",
]
