from repro_torch.kernels.cifg_cell.ops import (LAUNCHES, cell_fwd,
                                               cifg_states, cifg_step)
from repro_torch.kernels.cifg_cell.ref import cifg_cell_ref

__all__ = ["LAUNCHES", "cell_fwd", "cifg_cell_ref", "cifg_states",
           "cifg_step"]
