"""Loop ``batched``: Bt streams a step through `eval_step`
(`loops.batched`), in the eval mode (`modes/eval.py`)."""
from portbench import loops
from portbench.modes import eval as eval_mode

FAULTS = eval_mode.FAULTS
run = eval_mode.mode(loops.batched)
