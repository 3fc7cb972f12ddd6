"""repro_torch.roofline — the cost model (counterpart of
``repro.roofline``): one recorded eager call priced for an NVIDIA H100 in
three terms (compute by FLOP class, memory, collectives); see
:mod:`.analysis` and :mod:`.op_cost`."""
from repro_torch.roofline.analysis import (HW, RooflineReport,
                                           analyze_program,
                                           combine_train_steps)

__all__ = ["HW", "RooflineReport", "analyze_program", "combine_train_steps"]
