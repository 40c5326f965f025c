from repro_torch.kernels.cifg_cell.ops import (LAUNCHES, cell_bwd,
                                               cell_bwd_seq, cell_fwd,
                                               cell_seq_fwd, cifg_sequence,
                                               cifg_states, cifg_step)
from repro_torch.kernels.cifg_cell.ref import (cell_bwd_ref, cell_bwd_seq_ref,
                                               cifg_cell_ref)

__all__ = ["LAUNCHES", "cell_bwd", "cell_bwd_ref", "cell_bwd_seq",
           "cell_bwd_seq_ref", "cell_fwd", "cell_seq_fwd", "cifg_cell_ref",
           "cifg_sequence", "cifg_states", "cifg_step"]
